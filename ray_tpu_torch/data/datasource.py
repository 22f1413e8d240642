"""Read tasks — lazy per-source block producers.

Analogue of the reference's datasource layer (reference:
python/ray/data/_internal/datasource/ — parquet/csv/json/range readers
produce ReadTasks; python/ray/data/datasource/datasource.py ReadTask).
Each read task is a zero-arg callable yielding blocks, executed inside one
streaming source task by the executor; file formats ride pyarrow.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

DEFAULT_ROWS_PER_BLOCK = 64 * 1024


def _is_url(p: str) -> bool:
    return "://" in p


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if _is_url(p):
            # Remote paths: fsspec expands globs on filesystem-like
            # protocols; http(s) URLs pass through verbatim — a '?'
            # there is a query string, not a glob (reference:
            # datasource paths ride pyarrow.fs/fsspec).
            proto = p.split("://", 1)[0].lower()
            if proto in ("http", "https"):
                out.append(p)  # a '?' here is a query string, not a glob
            elif any(ch in p for ch in "*?["):
                import fsspec
                fs, _ = fsspec.core.url_to_fs(p)
                out.extend(f"{proto}://{m}" for m in sorted(fs.glob(p)))
            elif p.endswith("/"):
                # Explicit remote directory prefix (s3://bucket/table/):
                # expand like the local os.walk branch. Only the trailing
                # slash triggers the remote listing — probing isdir on
                # every plain file URL would cost one network round-trip
                # per path at dataset-construction time.
                import fsspec
                fs, root = fsspec.core.url_to_fs(p)
                out.extend(f"{proto}://{m}" for m in sorted(fs.find(root)))
            else:
                out.append(p)
        elif os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith("."))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


def _open_any(path: str, mode: str = "rb"):
    """Open local paths with open(); URLs (s3://, gs://, http://, ...)
    through fsspec — every file-based reader accepts either."""
    if _is_url(path):
        import fsspec
        return fsspec.open(path, mode).open()
    if "b" in mode:
        return open(path, mode)
    return open(path, mode, encoding="utf-8")


def range_read_tasks(n: int, num_blocks: Optional[int] = None
                     ) -> List[Callable[[], Iterator[Any]]]:
    num_blocks = num_blocks or max(1, min(16, n // DEFAULT_ROWS_PER_BLOCK
                                          or 1))
    per = (n + num_blocks - 1) // num_blocks
    tasks = []
    for b in range(num_blocks):
        lo, hi = b * per, min(n, (b + 1) * per)
        if lo >= hi:
            break

        def read(lo=lo, hi=hi):
            yield {"id": np.arange(lo, hi, dtype=np.int64)}

        tasks.append(read)
    return tasks


def items_read_tasks(items: List[Any], num_blocks: int = 1):
    num_blocks = max(1, min(num_blocks, len(items) or 1))
    per = (len(items) + num_blocks - 1) // num_blocks
    tasks = []
    for b in range(num_blocks):
        chunk = items[b * per:(b + 1) * per]
        if not chunk:
            break

        def read(chunk=chunk):
            yield list(chunk)

        tasks.append(read)
    return tasks


def numpy_read_tasks(batch: Dict[str, np.ndarray],
                     num_blocks: int = 1):
    n = len(next(iter(batch.values())))
    num_blocks = max(1, min(num_blocks, n))
    per = (n + num_blocks - 1) // num_blocks
    tasks = []
    for b in range(num_blocks):
        lo, hi = b * per, min(n, (b + 1) * per)
        if lo >= hi:
            break
        chunk = {k: v[lo:hi] for k, v in batch.items()}

        def read(chunk=chunk):
            yield chunk

        tasks.append(read)
    return tasks


def parquet_read_tasks(paths, columns: Optional[List[str]] = None):
    """One read task per file; row groups stream as separate blocks
    (reference: _internal/datasource/parquet_datasource.py splits by row
    group for memory-bounded streaming)."""
    files = _expand_paths(paths)
    tasks = []
    for path in files:
        def read(path=path, columns=columns):
            import pyarrow.parquet as pq
            f = pq.ParquetFile(_open_any(path) if _is_url(path) else path)
            for rg in range(f.num_row_groups):
                yield f.read_row_group(rg, columns=columns)

        tasks.append(read)
    return tasks


def csv_read_tasks(paths, **read_options):
    files = _expand_paths(paths)
    tasks = []
    for path in files:
        def read(path=path):
            import pyarrow.csv as pacsv
            yield pacsv.read_csv(_open_any(path) if _is_url(path)
                                 else path)

        tasks.append(read)
    return tasks


def json_read_tasks(paths):
    files = _expand_paths(paths)
    tasks = []
    for path in files:
        def read(path=path):
            import pyarrow.json as pajson
            yield pajson.read_json(_open_any(path) if _is_url(path)
                                   else path)

        tasks.append(read)
    return tasks


def text_read_tasks(paths, *, encoding: str = "utf-8"):
    """One task per file; each block is {"text": lines} (reference:
    _internal/datasource/text_datasource.py)."""
    files = _expand_paths(paths)
    tasks = []
    for path in files:
        def read(path=path):
            with _open_any(path, "rb") as f:
                lines = f.read().decode(encoding).splitlines()
            yield {"text": np.asarray(lines, dtype=object)}

        tasks.append(read)
    return tasks


def binary_read_tasks(paths, *, include_paths: bool = False):
    """One task per file; blocks are {"bytes": [payload]} (+"path")
    (reference: _internal/datasource/binary_datasource.py)."""
    files = _expand_paths(paths)
    tasks = []
    for path in files:
        def read(path=path):
            with _open_any(path, "rb") as f:
                payload = f.read()
            block = {"bytes": np.asarray([payload], dtype=object)}
            if include_paths:
                block["path"] = np.asarray([path], dtype=object)
            yield block

        tasks.append(read)
    return tasks


def image_read_tasks(paths, *, size=None, mode: Optional[str] = None):
    """One task per image file; blocks are {"image": [H, W, C] uint8}
    (reference: _internal/datasource/image_datasource.py — PIL decode,
    optional resize/convert; decoding runs IN the read task, so it
    parallelizes across the executor's task budget)."""
    files = _expand_paths(paths)
    tasks = []
    for path in files:
        def read(path=path):
            from PIL import Image
            img = Image.open(_open_any(path) if _is_url(path) else path)
            if mode is not None:
                img = img.convert(mode)
            if size is not None:
                img = img.resize(tuple(size))
            yield {"image": np.asarray(img)[None]}

        tasks.append(read)
    return tasks


def _decode_wds_field(ext: str, payload: bytes):
    """Default webdataset field decoders by extension (reference:
    _internal/datasource/webdataset_datasource.py default_decoder)."""
    if ext in ("txt", "text"):
        return payload.decode("utf-8")
    if ext == "json":
        import json as _json
        return _json.loads(payload)
    if ext in ("cls", "cls2", "index"):
        return int(payload.decode("utf-8").strip())
    if ext in ("jpg", "jpeg", "png", "ppm", "pgm", "pbm", "bmp"):
        import io as _io

        from PIL import Image
        return np.asarray(Image.open(_io.BytesIO(payload)))
    if ext in ("npy",):
        import io as _io
        return np.load(_io.BytesIO(payload), allow_pickle=False)
    return payload  # unknown extension: raw bytes


def webdataset_read_tasks(paths, *, rows_per_block: int = 256,
                          decode: bool = True):
    """Stream samples out of webdataset-convention tar shards: files
    sharing a dotted key prefix form one sample ({"__key__", ext: value})
    (reference: _internal/datasource/webdataset_datasource.py). One task
    per shard; samples batch into blocks of `rows_per_block`."""
    files = _expand_paths(paths)
    tasks = []
    for path in files:
        def read(path=path):
            import tarfile

            def flush(rows):
                cols = sorted({k for r in rows for k in r})
                return {c: np.asarray([r.get(c) for r in rows],
                                      dtype=object) for c in cols}

            rows: List[dict] = []
            sample: dict = {}
            key = None
            with _open_any(path, "rb") as f, \
                    tarfile.open(fileobj=f, mode="r|*") as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    # Key on the FULL path minus extension: shards that
                    # bundle directories (train/0001.jpg, val/0001.jpg)
                    # must not merge same-basename samples.
                    name = member.name
                    base = os.path.basename(name)
                    _, _, ext = base.partition(".")
                    stem = name[: len(name) - len(ext) - 1] if ext \
                        else name
                    if key is not None and stem != key and sample:
                        rows.append(sample)
                        sample = {}
                        if len(rows) >= rows_per_block:
                            yield flush(rows)
                            rows = []
                    key = stem
                    payload = tar.extractfile(member).read()
                    sample["__key__"] = stem
                    sample[ext] = (_decode_wds_field(ext.lower(), payload)
                                   if decode else payload)
            if sample:
                rows.append(sample)
            if rows:
                yield flush(rows)

        tasks.append(read)
    return tasks


def lance_read_tasks(uri, columns: Optional[List[str]] = None):
    """Lance dataset fragments as read tasks (reference:
    _internal/datasource/lance_datasource.py). Gated on the optional
    `lance` package — the seam matches the reference; environments
    without lance get a clear error instead of a silent fallback."""
    try:
        import lance  # type: ignore
    except ImportError as e:
        raise ImportError(
            "read_lance requires the 'lance' package (pip install "
            "pylance); not bundled in this environment") from e
    ds = lance.dataset(uri)
    tasks = []
    for frag in ds.get_fragments():
        def read(frag=frag, columns=columns):
            for batch in frag.to_batches(columns=columns):
                import pyarrow as pa
                yield pa.Table.from_batches([batch])

        tasks.append(read)
    return tasks


# ---------------------------------------------------------------------------
# write tasks (reference: Dataset.write_parquet/_csv/_json ->
# _internal/datasource/*_datasink.py — one output file per block)
# ---------------------------------------------------------------------------

def write_block(block, path: str, file_format: str) -> str:
    """Write ONE block as one file (runs inside a task)."""
    from ray_tpu_torch.data.block import BlockAccessor

    acc = BlockAccessor(block)
    if file_format in ("parquet", "csv"):
        import pyarrow as pa
        table = acc.to_arrow() if not isinstance(block, pa.Table) \
            else block
        if file_format == "parquet":
            import pyarrow.parquet as pq
            pq.write_table(table, path)
        else:
            import pyarrow.csv as pacsv
            pacsv.write_csv(table, path)
    elif file_format == "json":
        import json as _json
        cols = acc.to_numpy_batch()
        names = list(cols)
        with open(path, "w") as f:
            for i in range(acc.num_rows()):
                row = {k: _to_jsonable(cols[k][i]) for k in names}
                f.write(_json.dumps(row) + "\n")
    else:
        raise ValueError(f"unknown write format {file_format!r}")
    return path


def _to_jsonable(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (bytes, bytearray)):
        import base64
        return base64.b64encode(bytes(v)).decode()  # JSON-safe binary
    return v
