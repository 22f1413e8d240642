"""Sharded checkpointing: per-rank block writes + commit barrier + top-K
manager (counterpart of ``ray_tpu/train/checkpointing.py``, with its
on-disk layout):

    {dir}/step-{N}/
        _METADATA.json          # leaf names, kinds, global shapes, numpy
                                # dtype names and each leaf's global block
                                # keys (written by rank 0)
        leaf{i}.{indexkey}.npy  # one file per UNIQUE block, keyed by its
                                # global slice ("0-64_32-64", or "scalar")
        COMMIT                  # written after the barrier — a checkpoint
                                # without it is incomplete

The state is a nested dict, flattened in sorted key order as
``jax.tree_util`` flattens a dict. Tensors are "array" leaves; anything else
numpy takes (a Python int, a numpy array) is a "host" leaf, written by rank
0. Leaf names are the JAX package's: dotted keys, with the AdamW state of
``default_optimizer()`` (``opt_state.{count,mu,nu}``) under the name the JAX
package gives optax's ``ScaleByAdamState`` (``opt_state[1][0].…``). So the
same state writes the same files in both packages, and a checkpoint of one
restores in the other (leaves are matched by position, as in the JAX
package). bf16 tensors are written as their raw 2-byte words under numpy's
``<V2`` descriptor, byte for byte as ``np.save`` writes a JAX bf16 array,
and read back by those words.

Under a ``ParallelContext`` each leaf of the state is this rank's block
under its spec (``state_shardings``). A rank writes a block when its
coordinate is 0 on every axis that does not split the leaf, so each block
is written once (as the JAX package writes ``replica_id == 0`` shards);
the manifest lists every block's key, and restore reads only this rank's
block and refuses a key that the manifest does not list. The sync path's
barriers are ``torch.distributed.barrier()`` over the context's world; the
async path's commit barrier is rank marker files. Without a context the
state is one process's, written whole. The layer stack under pp is split
by stage here (``param_specs``), where the JAX package keeps ``[L]`` whole,
so a pp checkpoint is this package's own.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import AXIS_NAMES
from ray_tpu_torch.parallel.sharding import axes_of, shard_index

# The JAX package's name of optax's ScaleByAdamState in
# chain(clip_by_global_norm, adamw): the first state of the chain's second
# link (``default_optimizer()``).
_ADAM_PREFIX = "opt_state[1][0]."
_BF16_DESCR = "<V2"  # what np.save writes for a JAX (ml_dtypes) bf16 array


def run_dir(storage_path: str, name: str) -> str:
    """Canonical checkpoint directory for a run — the ONE derivation shared
    by the controller's CheckpointManager and worker-side save_checkpoint
    (divergence would silently break auto-resume)."""
    return os.path.join(storage_path, name or "train_run")


class Checkpoint:
    """Handle to one committed checkpoint directory (reference:
    python/ray/train/_checkpoint.py Checkpoint)."""

    def __init__(self, path: str, step: int = 0,
                 metrics: Optional[Dict[str, Any]] = None):
        self.path = path
        self.step = step
        self.metrics = dict(metrics or {})

    def is_valid(self) -> bool:
        return os.path.exists(os.path.join(self.path, "COMMIT"))

    def __repr__(self):
        return f"Checkpoint(step={self.step}, path={self.path!r})"


def _recover_trashed(directory: str, step: int) -> None:
    """Crash recovery for the commit swap: a crash between the two renames
    in save_checkpoint leaves NO step-N while the previously committed
    checkpoint sits in _trash-step-N — rename it back so the guarantee
    (an existing committed step stays restorable until the new save is
    durable) holds across that microsecond window too."""
    final_dir = os.path.join(directory, f"step-{step}")
    trash = os.path.join(directory, f"_trash-step-{step}")
    if (not os.path.isdir(final_dir)
            and os.path.exists(os.path.join(trash, "COMMIT"))):
        os.rename(trash, final_dir)


def _recover_all_trashed(directory: str) -> None:
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if not name.startswith("_trash-step-"):
            continue
        try:
            step = int(name[len("_trash-step-"):])
        except ValueError:
            continue
        try:
            _recover_trashed(directory, step)
        except OSError:
            continue
        # Superseded trash (a crash landed after the final rename but
        # before the cleanup rmtree): step-N exists, so the trash copy is
        # garbage — delete it or it leaks a full checkpoint forever.
        trash = os.path.join(directory, name)
        if os.path.isdir(trash) and os.path.isdir(
                os.path.join(directory, f"step-{step}")):
            shutil.rmtree(trash, ignore_errors=True)


def _index_key(index: Tuple[slice, ...], shape: Tuple[int, ...]) -> str:
    """Stable filename key for one block's global slice tuple."""
    parts = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else sl.start
        stop = dim if sl.stop is None else sl.stop
        parts.append(f"{start}-{stop}")
    return "_".join(parts) or "scalar"


# ---------------------------------------------------------------------------
# Leaves: names, blocks, files
# ---------------------------------------------------------------------------

def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict in sorted key order."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    out = []
    for key in sorted(tree):
        out.extend(_flatten(tree[key], path + (key,)))
    return out


def _is_adam_state(tree: Any) -> bool:
    return (isinstance(tree, dict) and isinstance(tree.get("opt_state"), dict)
            and set(tree["opt_state"]) == {"count", "mu", "nu"})


def _leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(name, leaf) in the JAX package's order and with its names."""
    adam = _is_adam_state(tree)
    out = []
    for path, leaf in _flatten(tree):
        if adam and path[0] == "opt_state":
            name = _ADAM_PREFIX + ".".join(path[1:])
        else:
            name = ".".join(path)
        out.append((name, leaf))
    return out


def _port_name(name: str) -> str:
    """A leaf name as this package's state has it (the inverse of
    ``_leaf_paths``' naming of the AdamW state)."""
    if name.startswith(_ADAM_PREFIX):
        return "opt_state." + name[len(_ADAM_PREFIX):]
    return name


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """Inverse of ``_flatten`` for the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}
    return build(like)


def _procs(ctx) -> Tuple[int, int]:
    """(this process's index in the context's mesh, the mesh's size): the
    processes of a save. The barriers run on the default group, so a mesh
    that leaves out some of the world's ranks is refused."""
    if ctx is None or not dist.is_initialized():
        return 0, 1
    ranks = ctx.mesh.mesh.flatten().tolist()
    if len(ranks) != dist.get_world_size():
        raise ValueError(f"the context's mesh holds {len(ranks)} ranks and "
                         f"the process group {dist.get_world_size()}: a "
                         f"checkpoint is saved by every rank of the world")
    return ranks.index(dist.get_rank()), len(ranks)


def _barrier(ctx) -> None:
    """A barrier across the context's mesh (the whole world, as
    ``_procs`` checks)."""
    if _procs(ctx)[1] > 1:
        dist.barrier()


def _spec(spec: Any, ndim: int) -> Tuple[Any, ...]:
    spec = tuple(spec) if spec is not None else ()
    return spec + (None,) * (ndim - len(spec))


def _block(spec: Tuple[Any, ...], local: Tuple[int, ...], ctx
           ) -> Tuple[Tuple[int, ...], Tuple[slice, ...]]:
    """(global shape, this rank's global slice) of a local block."""
    gshape, index = [], []
    for size, entry in zip(local, spec):
        i, n = shard_index(entry, ctx) if ctx is not None else (0, 1)
        gshape.append(size * n)
        index.append(slice(i * size, (i + 1) * size))
    return tuple(gshape), tuple(index)


def _all_keys(spec: Tuple[Any, ...], gshape: Tuple[int, ...], ctx
              ) -> List[str]:
    """The manifest: every block's key under ``spec``."""
    keys = [()]
    for dim, entry in zip(gshape, spec):
        n = shard_index(entry, ctx)[1] if ctx is not None else 1
        size = dim // n
        keys = [k + (slice(i * size, (i + 1) * size),)
                for k in keys for i in range(n)]
    return sorted({_index_key(k, gshape) for k in keys})


def _writes_block(spec: Tuple[Any, ...], ctx) -> bool:
    """True on the one rank of each group holding the same block: the one
    at coordinate 0 on every axis that does not split the leaf."""
    if ctx is None:
        return True
    split = {a for entry in spec for a in axes_of(entry)}
    return all(ctx.rank(a) == 0 for a in AXIS_NAMES if a not in split)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")  # numpy's names


def _to_host(t: torch.Tensor, copy: bool) -> np.ndarray:
    """A tensor's data as a host array: a device->host copy on the card, a
    clone on the CPU when ``copy`` (a train step updates the state in
    place), a view otherwise. bf16 becomes its raw 2-byte words."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    elif copy:
        t = t.clone()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _save_npy(path: str, arr: np.ndarray) -> None:
    if arr.dtype.kind == "V":  # bf16 words, under JAX's descriptor
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": arr.shape})
            arr.tofile(f)
    else:
        np.save(path, arr, allow_pickle=False)


def _load_tensor(path: str, dtype: str) -> torch.Tensor:
    """One block file as a CPU tensor of the metadata's dtype; a ``<V2``
    file (bf16 words, from either package) is read by its words."""
    arr = np.asarray(np.load(path), order="C")  # keeps 0-d arrays 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=False))


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, state: Any, step: int,
                    metrics: Optional[Dict[str, Any]] = None, ctx=None,
                    specs: Any = None) -> Checkpoint:
    """Save a nested dict of tensors (or numpy/scalars). Under ``ctx``
    (with ``specs``, e.g. ``state_shardings(cfg, ctx)``) call from EVERY
    rank: each writes the blocks it is the writer of; the commit happens
    after the barrier. (The sync flavor: snapshot + write on this thread
    with process-group barriers; the async flavor below runs the same
    phases with a marker-file barrier.)"""
    _prepare_save(directory, step, ctx)
    # No copies of CPU tensors on the sync path: nothing overlaps the
    # write, so blocks stream without doubling host memory (async saves
    # must copy — see _snapshot).
    snap = _snapshot(state, step, metrics, copy=False, ctx=ctx, specs=specs)
    ckpt = _write_snapshot(directory, snap, process_barrier=True, ctx=ctx)
    _barrier(ctx)  # every rank sees the commit before it returns
    return ckpt


def _prepare_save(directory: str, step: int, ctx=None) -> None:
    """On-thread pre-save: recover any trashed commit, clear stale tmp
    state (rank 0), and line every rank up behind that clear."""
    ckpt_dir = os.path.join(directory, f"_tmp-step-{step}")
    if _procs(ctx)[0] == 0:
        _recover_trashed(directory, step)
        if os.path.isdir(ckpt_dir):
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    _barrier(ctx)


def _snapshot(state: Any, step: int, metrics: Optional[Dict[str, Any]],
              copy: bool = True, ctx=None, specs: Any = None) -> dict:
    """Device->host snapshot + metadata plan — the ONLY phase that must
    pause the training loop (the copies of this rank's blocks). With
    copy=True (the ASYNC path) CPU tensors are cloned: the next train step
    updates the state in place while the background writer still reads
    it. The sync path passes copy=False and streams them as they are."""
    proc, nprocs = _procs(ctx)
    flat = _leaf_paths(state)
    flat_specs = ([s for _, s in _flatten(specs)] if specs is not None
                  else [None] * len(flat))
    if len(flat_specs) != len(flat):
        raise ValueError(f"specs have {len(flat_specs)} leaves, the state "
                         f"{len(flat)}")
    meta: Dict[str, Any] = {"step": step, "leaves": [],
                            "metrics": dict(metrics or {})}
    writes: List[Tuple[str, np.ndarray]] = []  # (filename, host array)
    for li, ((name, leaf), spec) in enumerate(zip(flat, flat_specs)):
        if isinstance(leaf, torch.Tensor):
            spec = _spec(spec if ctx is not None else None, leaf.dim())
            shape, index = _block(spec, tuple(leaf.shape), ctx)
            if _writes_block(spec, ctx):
                writes.append((f"leaf{li}.{_index_key(index, shape)}.npy",
                               _to_host(leaf, copy)))
            # Manifest: the exact global block-key set — readers trust
            # only these files, so stale blocks from a crashed save are
            # never merged.
            meta["leaves"].append({"name": name, "kind": "array",
                                   "shape": shape,
                                   "dtype": _dtype_name(leaf),
                                   "files": _all_keys(spec, shape, ctx)})
        else:
            if proc == 0:
                writes.append((f"leaf{li}.host.npy",
                               np.array(leaf, copy=True) if copy
                               else np.asarray(leaf)))
            meta["leaves"].append({"name": name, "kind": "host",
                                   "shape": tuple(np.shape(leaf)),
                                   "dtype": str(np.asarray(leaf).dtype),
                                   "files": ["host"]})
    return {"meta": meta, "writes": writes, "step": step,
            "proc": proc, "nprocs": nprocs}


def _write_snapshot(directory: str, snap: dict,
                    barrier_timeout: float = 600.0,
                    process_barrier: bool = False, ctx=None) -> Checkpoint:
    """Write a snapshot's files and commit (the shared back half of sync
    AND async saves). Two barrier flavors:

      process_barrier=True  — sync path, runs ON the training thread:
        ``torch.distributed.barrier()`` between writes and commit.
      process_barrier=False — async path, runs on a background thread:
        rank MARKER FILES on the shared checkpoint storage (a collective
        off-thread would interleave with the training step's collectives).
        Every rank's Checkpoint resolves only once COMMIT is visible, so
        reporting a resolved future is always safe.

    All writes land in a TEMP dir; the committed dir is replaced by an
    atomic swap at the very end, so (a) a crashed save never mixes stale
    blocks into a later save of the same step and (b) an existing
    COMMITTED step-N stays restorable until the new save is durable.
    """
    step, proc, nprocs = snap["step"], snap["proc"], snap["nprocs"]
    final_dir = os.path.join(directory, f"step-{step}")
    ckpt_dir = os.path.join(directory, f"_tmp-step-{step}")
    os.makedirs(ckpt_dir, exist_ok=True)
    for fname, arr in snap["writes"]:
        _save_npy(os.path.join(ckpt_dir, fname), arr)

    # Commit barrier: every rank must have finished its writes before the
    # checkpoint becomes observable (reference: sync_actor.py barrier;
    # Orbax per-host write + commit).
    if nprocs > 1:
        if process_barrier:
            _barrier(ctx)
        else:
            with open(os.path.join(ckpt_dir, f"_rank-{proc}.done"),
                      "w") as f:
                f.write("ok")
    if proc != 0:
        if not process_barrier:
            _await_commit(final_dir, ckpt_dir, proc, barrier_timeout)
        return Checkpoint(final_dir, step, snap["meta"]["metrics"])
    if nprocs > 1 and not process_barrier:
        deadline = time.monotonic() + barrier_timeout
        want = {f"_rank-{r}.done" for r in range(nprocs)}
        while want - set(os.listdir(ckpt_dir)):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint commit barrier: missing "
                    f"{sorted(want - set(os.listdir(ckpt_dir)))}")
            time.sleep(0.05)
        for r in range(nprocs):
            try:
                os.unlink(os.path.join(ckpt_dir, f"_rank-{r}.done"))
            except OSError:
                pass
    with open(os.path.join(ckpt_dir, "_METADATA.json"), "w") as f:
        json.dump(snap["meta"], f)
    with open(os.path.join(ckpt_dir, "COMMIT"), "w") as f:
        f.write("ok")
    trash = os.path.join(directory, f"_trash-step-{step}")
    shutil.rmtree(trash, ignore_errors=True)
    if os.path.isdir(final_dir):
        os.rename(final_dir, trash)
    os.rename(ckpt_dir, final_dir)
    shutil.rmtree(trash, ignore_errors=True)
    return Checkpoint(final_dir, step, snap["meta"]["metrics"])


def _await_commit(final_dir: str, ckpt_dir: str, proc: int,
                  timeout: float) -> None:
    """Non-zero async ranks resolve only once THIS save committed — a
    resolved Checkpoint must always be restorable. A pre-existing
    committed step-N (re-save of an old step) must not satisfy the wait,
    so first wait for rank 0 to consume OUR marker file (it unlinks all
    markers immediately before writing COMMIT; the residual
    crash-between-unlink-and-commit window is microseconds vs the whole
    write window)."""
    marker = os.path.join(ckpt_dir, f"_rank-{proc}.done")
    deadline = time.monotonic() + timeout
    while os.path.exists(marker):
        if time.monotonic() > deadline:
            raise TimeoutError(f"commit barrier: rank-0 never consumed "
                               f"{marker} within {timeout}s")
        time.sleep(0.05)
    while not os.path.exists(os.path.join(final_dir, "COMMIT")):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no COMMIT at {final_dir} after "
                               f"{timeout}s (rank-0 writer lost?)")
        time.sleep(0.05)


class AsyncCheckpointer:
    """Orbax-style async saves (SURVEY §5.4): ``save`` pauses training only
    for the device->host snapshot, then writes + commits on a background
    thread; a kill mid-save leaves the previous committed step restorable
    (no COMMIT until every rank's blocks are durable).

        ckptr = AsyncCheckpointer()
        fut = ckptr.save(directory, state, step)   # returns after the copy
        ...keep training...
        ckpt = fut.result()                        # or ckptr.wait()
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="async-ckpt")
        self._inflight: Optional[Any] = None

    def save(self, directory: str, state: Any, step: int,
             metrics: Optional[Dict[str, Any]] = None, ctx=None,
             specs: Any = None):
        """Snapshot now; write+commit in the background. Returns a
        Future[Checkpoint]. Back-to-back saves serialize (one writer
        thread), so at most one step of training overlaps a save."""
        self.wait()  # surface a prior save's failure HERE, not silently
        # On-thread (training-thread) prepare: clear + barrier are safe
        # here, between steps.
        _prepare_save(directory, step, ctx)
        snap = _snapshot(state, step, metrics, ctx=ctx, specs=specs)
        self._inflight = self._pool.submit(_write_snapshot, directory,
                                           snap)
        return self._inflight

    def wait(self) -> Optional[Checkpoint]:
        """Block until the in-flight save (if any) committed."""
        fut, self._inflight = self._inflight, None
        return fut.result() if fut is not None else None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

def _committed_meta(ckpt: "Checkpoint | str", recover: bool
                    ) -> Tuple[str, dict]:
    path = ckpt.path if isinstance(ckpt, Checkpoint) else ckpt
    if recover and not os.path.exists(os.path.join(path, "COMMIT")):
        base, name = os.path.split(os.path.abspath(path))
        if name.startswith("step-"):
            try:
                _recover_trashed(base, int(name[len("step-"):]))
            except (ValueError, OSError):
                pass
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "_METADATA.json")) as f:
        return path, json.load(f)


def restore_checkpoint(ckpt: "Checkpoint | str", target: Any, ctx=None,
                       specs: Any = None) -> Any:
    """Restore into the structure of ``target`` (e.g. the freshly
    initialized train state): each tensor leaf comes back on the target
    leaf's device, in the checkpoint's dtype, with the target's
    requires_grad. Under ``ctx`` (with the ``specs`` the state was saved
    under) the target's leaves are this rank's blocks and each rank reads
    only its own block files."""
    path, meta = _committed_meta(ckpt, recover=True)
    flat_target = _leaf_paths(target)
    assert len(flat_target) == len(meta["leaves"]), \
        (len(flat_target), len(meta["leaves"]))
    flat_specs = ([s for _, s in _flatten(specs)] if specs is not None
                  else [None] * len(flat_target))
    new_leaves = []
    for li, ((name, leaf), lm, spec) in enumerate(zip(
            flat_target, meta["leaves"], flat_specs)):
        if lm["kind"] == "host" or not isinstance(leaf, torch.Tensor):
            arr = np.load(os.path.join(path, f"leaf{li}.host.npy"))
            new_leaves.append(arr if arr.shape else arr.item())
            continue
        shape = tuple(lm["shape"])
        spec = _spec(spec if ctx is not None else None, len(shape))
        local = []
        for dim, entry in zip(shape, spec):
            n = shard_index(entry, ctx)[1] if ctx is not None else 1
            local.append(dim // n)
        _, index = _block(spec, tuple(local), ctx)
        key = _index_key(index, shape)
        manifest = lm.get("files")
        if manifest is not None and key not in manifest:
            raise FileNotFoundError(
                f"checkpoint {path} leaf{li} has no shard {key!r} "
                f"(saved under a different sharding — use "
                f"load_checkpoint_host for cross-topology restore)")
        block = _load_tensor(os.path.join(path, f"leaf{li}.{key}.npy"),
                             lm["dtype"])
        if tuple(block.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint {path} leaf{li} ({name}) block "
                             f"{tuple(block.shape)} does not fit the "
                             f"target's {tuple(leaf.shape)}")
        new_leaves.append(block.to(leaf.device).requires_grad_(
            leaf.requires_grad))
    return _unflatten(target, new_leaves)


def load_checkpoint_host(ckpt: "Checkpoint | str") -> Dict[str, Any]:
    """Assemble the full (unsharded) leaves on the host as {leaf_name:
    CPU tensor} (host leaves as numpy arrays, as saved) — for inspection,
    serving, or cross-topology restore. Names are this package's: the
    JAX package's ``opt_state[1][0].…`` reads as ``opt_state.…``."""
    path, meta = _committed_meta(ckpt, recover=False)
    out: Dict[str, Any] = {}
    for li, lm in enumerate(meta["leaves"]):
        name = _port_name(lm["name"])
        if lm["kind"] == "host":
            out[name] = np.load(os.path.join(path, f"leaf{li}.host.npy"))
            continue
        shape = tuple(lm["shape"])
        full = torch.empty(shape, dtype=getattr(torch, lm["dtype"]))
        prefix = f"leaf{li}."
        # Read only manifest-listed blocks (never stray files from an
        # earlier crashed save); fall back to listdir for old checkpoints.
        if lm.get("files") is not None:
            fnames = [f"{prefix}{key}.npy" for key in lm["files"]]
        else:
            fnames = [f for f in os.listdir(path)
                      if f.startswith(prefix) and f.endswith(".npy")]
        for fname in fnames:
            key = fname[len(prefix):-4]
            data = _load_tensor(os.path.join(path, fname), lm["dtype"])
            if key == "scalar":
                full = data
                continue
            slices = tuple(slice(*map(int, part.split("-")))
                           for part in key.split("_"))
            full[slices] = data
        out[name] = full
    return out


class CheckpointManager:
    """Top-K checkpoint retention (reference:
    v2/_internal/execution/checkpoint/checkpoint_manager.py): registers
    committed checkpoints, keeps the best `max_to_keep` by `metric`
    (or most recent when metric is None), deletes the rest."""

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 2,
                 metric: Optional[str] = None, mode: str = "min"):
        """max_to_keep=None keeps everything (no pruning) — the reference's
        num_to_keep=None semantics."""
        assert mode in ("min", "max")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.metric = metric
        self.mode = mode
        self._ckpts: List[Checkpoint] = []
        self._discover()

    def _discover(self) -> None:
        """Pick up committed checkpoints already on disk (resume path)."""
        if not os.path.isdir(self.directory):
            return
        _recover_all_trashed(self.directory)
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith("step-"):
                continue
            path = os.path.join(self.directory, name)
            if os.path.exists(os.path.join(path, "COMMIT")):
                try:
                    with open(os.path.join(path, "_METADATA.json")) as f:
                        meta = json.load(f)
                except Exception:
                    continue
                self._ckpts.append(Checkpoint(path, meta.get("step", 0),
                                              meta.get("metrics")))
        self._ckpts.sort(key=lambda c: c.step)

    def register(self, ckpt: Checkpoint) -> None:
        self._ckpts.append(ckpt)
        self._prune()

    def _rank_key(self, c: Checkpoint):
        """Higher = better. A checkpoint missing the metric ranks WORST in
        both modes (it must never shadow a scored one as best())."""
        if self.metric is None:
            return c.step  # most recent wins
        v = c.metrics.get(self.metric)
        if v is None:
            return float("-inf")
        return -v if self.mode == "min" else v

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        while len(self._ckpts) > self.max_to_keep:
            # Never prune the newest checkpoint: crash-resume depends on
            # it even when its metric ranks worst.
            newest = max(self._ckpts, key=lambda c: c.step)
            candidates = [c for c in self._ckpts if c is not newest]
            if not candidates:
                return
            worst = min(candidates, key=self._rank_key)
            self._ckpts.remove(worst)
            shutil.rmtree(worst.path, ignore_errors=True)

    def latest(self) -> Optional[Checkpoint]:
        return max(self._ckpts, key=lambda c: c.step) if self._ckpts \
            else None

    def best(self) -> Optional[Checkpoint]:
        return max(self._ckpts, key=self._rank_key) if self._ckpts else None

    def checkpoints(self) -> List[Checkpoint]:
        return list(self._ckpts)
