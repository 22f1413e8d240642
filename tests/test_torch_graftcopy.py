"""graftcopy put plane: fused OP_PUT + O_TMPFILE staging + scatter
engine, and every fallback leg of the acceptance contract.

The port's counterpart of tests/test_graftcopy.py: every case, with the same
inputs and assertions, on ray_tpu_torch's runtime. It imports no JAX, so
it also runs on a GPU host without it. Where a case differs, its
comment says how and why.

The put pipeline has one hot path (stage via O_TMPFILE+linkat, one
sidecar OP_PUT) and a ladder of fallbacks: named-O_EXCL staging when
O_TMPFILE is unavailable, the loop path's store_ingest RPC, and the
create+seal leg whose admission evicts/spills before bytes land. The
tests here drive each rung and the legacy (graftcopy-off) plane, plus a
multi-threaded storm across the size ladder (inline / fast-put / big).
"""

import errno
import os
import threading

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.cluster_utils import Cluster

MB = 1024 * 1024


@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.utils.config import GlobalConfig
    GlobalConfig.initialize({
        "object_store_memory_bytes": 256 * MB,
    })
    c = Cluster(num_nodes=1, resources={"CPU": 4})
    c.connect()
    yield c
    c.shutdown()
    GlobalConfig.initialize({})
    GlobalConfig._overrides.clear()
    GlobalConfig._cache.clear()


def _cw():
    from ray_tpu_torch import api
    return api._cw()


def _roundtrip(arr):
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(arr, out)
    return ref


class _graftcopy_only:
    """Pin puts onto the graftcopy staging plane for a test's duration.

    Above graftshm_min_bytes the shm create/seal plane claims the put
    before graftcopy staging runs, so tests that drive a specific
    staging rung (O_TMPFILE, ENOSPC fallback, OP_PUT failure) must
    switch it off — tests/test_graftshm.py owns the shm-plane corners.
    """

    def __init__(self, cw):
        self._cw = cw

    def __enter__(self):
        self._cw._use_graftshm = lambda: False
        return self._cw

    def __exit__(self, *exc):
        del self._cw._use_graftshm  # uncover the class method
        return False


# ---------------------------------------------------------------------------
# seam units (no cluster)
# ---------------------------------------------------------------------------

def test_write_payload_matches_to_bytes(tmp_path):
    """write_payload (pwritev or scatter engine) must land the exact
    data section + meta that the contiguous to_bytes() layout defines,
    including alignment holes."""
    from ray_tpu_torch.core import serialization
    rng = np.random.RandomState(3)
    value = {"a": rng.rand(1000), "b": b"x" * 7, "c": rng.rand(33).
             astype(np.float32)}
    sv = serialization.serialize(value)
    meta = sv.meta()
    p = tmp_path / "payload"
    fd = os.open(p, os.O_CREAT | os.O_RDWR, 0o600)
    try:
        serialization.write_payload(fd, sv, meta)
    finally:
        os.close(fd)
    blob = p.read_bytes()
    assert blob[:sv.total_size] == sv.to_bytes()
    assert blob[sv.total_size:sv.total_size + len(meta)] == meta
    assert serialization.deserialize(blob[:sv.total_size], meta)["b"] \
        == b"x" * 7


def test_scatter_engine_roundtrip(tmp_path):
    """Force the native engine (when built) at a tiny threshold and
    check byte-exactness against the pwritev path."""
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.core._native import graftcopy
    if not graftcopy.available():
        pytest.skip("native library unavailable")
    value = np.arange(3 * MB // 8, dtype=np.float64)
    sv = serialization.serialize(value)
    meta = sv.meta()
    segs = sv.segments(meta)
    assert segs, "segments() returned nothing"
    p = tmp_path / "scatter"
    fd = os.open(p, os.O_CREAT | os.O_RDWR, 0o600)
    try:
        if graftcopy.engine_threads() > 0:
            graftcopy.write_scatter(fd, segs)
        else:  # 1-core host: engine runs sequentially via write_payload
            serialization.write_payload(fd, sv, meta)
    finally:
        os.close(fd)
    blob = p.read_bytes()
    out = serialization.deserialize(blob[:sv.total_size], meta)
    np.testing.assert_array_equal(value, out)


def test_linkat_publishes_tmpfile(tmp_path):
    from ray_tpu_torch.core._native import graftcopy
    if not graftcopy.available():
        pytest.skip("native library unavailable")
    tmp = getattr(os, "O_TMPFILE", 0)
    if not tmp:
        pytest.skip("no O_TMPFILE on this platform")
    try:
        fd = os.open(str(tmp_path), tmp | os.O_RDWR, 0o600)
    except OSError:
        pytest.skip("filesystem lacks O_TMPFILE")
    dst = str(tmp_path / "published")
    try:
        os.pwrite(fd, b"payload", 0)
        graftcopy.linkat(fd, dst)
        with pytest.raises(OSError) as ei:
            graftcopy.linkat(fd, dst)  # second link: EEXIST
        assert ei.value.errno == errno.EEXIST
    finally:
        os.close(fd)
    with open(dst, "rb") as f:
        assert f.read() == b"payload"


def test_graftcopy_env_flag_disables():
    """RAY_TPU_TORCH_GRAFTCOPY=0 must gate available() regardless of the
    native build."""
    from ray_tpu_torch.utils import config as config_mod
    old = os.environ.get("RAY_TPU_TORCH_GRAFTCOPY")
    os.environ["RAY_TPU_TORCH_GRAFTCOPY"] = "0"
    try:
        fresh = config_mod.Config()
        assert fresh.get("graftcopy") is False
    finally:
        if old is None:
            del os.environ["RAY_TPU_TORCH_GRAFTCOPY"]
        else:
            os.environ["RAY_TPU_TORCH_GRAFTCOPY"] = old


# ---------------------------------------------------------------------------
# put plane against a live cluster
# ---------------------------------------------------------------------------

def test_put_sizes_ladder(cluster):
    """Inline (<=100KiB), small fast-put, and above-offload sizes all
    roundtrip through whichever plane is active."""
    for n in (64, 100 * 1024 // 8, 1 * MB // 8, 8 * MB // 8):
        _roundtrip(np.arange(n, dtype=np.float64))


def test_put_storm_multithreaded(cluster):
    """Concurrent puts from many user threads across the size ladder:
    every object roundtrips exactly, and no staging file is left
    behind."""
    sizes = [1000, 100 * 1024 // 8, MB // 8, 4 * MB // 8]
    errors = []
    results = {}
    lock = threading.Lock()

    def worker(tid):
        rng = np.random.RandomState(tid)
        try:
            local = []
            for i in range(6):
                arr = rng.rand(sizes[(tid + i) % len(sizes)])
                local.append((arr, ray_tpu_torch.put(arr)))
            for arr, ref in local:
                np.testing.assert_array_equal(arr, ray_tpu_torch.get(ref))
            with lock:
                results[tid] = len(local)
        except Exception as e:  # pragma: no cover - failure reporting
            with lock:
                errors.append((tid, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert len(results) == 8
    cw = _cw()
    sdir = cw._store_dir_cache
    if sdir:
        leftovers = [n for n in os.listdir(sdir)
                     if n.startswith(("put-", "ingest-"))]
        assert leftovers == [], leftovers


def test_enospc_falls_back_to_create_seal(cluster):
    """A staging write failure (ENOSPC-class OSError) must not fail the
    put: the create+seal leg, whose admission can evict/spill first,
    takes over."""
    cw = _cw()
    orig = cw._write_put_file
    calls = []

    def failing(sdir, oid, sv, meta):
        calls.append(oid)
        raise OSError(errno.ENOSPC, "No space left on device")

    cw._write_put_file = failing
    try:
        with _graftcopy_only(cw):
            arr = np.arange(MB // 8, dtype=np.float64)
            ref = ray_tpu_torch.put(arr)
            np.testing.assert_array_equal(arr, ray_tpu_torch.get(ref))
    finally:
        cw._write_put_file = orig
    if cw._use_graftcopy():
        assert calls, "graftcopy staging was never attempted"
    _roundtrip(np.arange(MB // 8, dtype=np.float64))  # plane recovered


def test_sidecar_failure_mid_put_falls_back(cluster):
    """fp.put blowing up (sidecar death) must fall back to the loop
    path and leave no staging file; once the sidecar answers again the
    fast path resumes."""
    cw = _cw()
    fp = cw._get_fastpath()
    if fp is None or not cw._use_graftcopy():
        pytest.skip("fast path or graftcopy not active")
    orig_put = fp.put
    boom = []

    def dying(oid, name, data_size, meta_size):
        boom.append(name)
        raise OSError(errno.EPIPE, "sidecar gone")

    fp.put = dying
    try:
        with _graftcopy_only(cw):
            arr = np.arange(2 * MB // 8, dtype=np.float64)
            ref = ray_tpu_torch.put(arr)
            np.testing.assert_array_equal(arr, ray_tpu_torch.get(ref))
    finally:
        fp.put = orig_put
    assert boom, "OP_PUT was never attempted"
    sdir = cw._store_dir_cache
    leftovers = [n for n in os.listdir(sdir) if n.startswith("put-")]
    assert leftovers == [], leftovers
    _roundtrip(np.arange(2 * MB // 8, dtype=np.float64))  # reconnected


def test_o_tmpfile_unavailable_falls_back_to_named(cluster):
    """With the O_TMPFILE probe forced off, staging uses named O_EXCL
    files and puts still roundtrip."""
    cw = _cw()
    if not cw._use_graftcopy():
        pytest.skip("graftcopy not active")
    old = cw._o_tmpfile_ok
    cw._o_tmpfile_ok = False
    try:
        with _graftcopy_only(cw):
            _roundtrip(np.arange(MB // 8, dtype=np.float64))
            _roundtrip(np.arange(6 * MB // 8, dtype=np.float64))
    finally:
        cw._o_tmpfile_ok = old


def test_graftcopy_off_uses_legacy_plane(cluster):
    """The graftcopy-off contract: with the plane disabled the legacy
    pwritev + OP_INGEST path serves every size, and mixed puts still
    roundtrip."""
    cw = _cw()
    old = cw._graftcopy_put
    cw._graftcopy_put = False
    try:
        for n in (1000, MB // 8, 8 * MB // 8):
            _roundtrip(np.arange(n, dtype=np.float64))
    finally:
        cw._graftcopy_put = old


def test_put_phase_counters_advance(cluster):
    cw = _cw()
    before = cw.put_phase_snapshot()
    _roundtrip(np.arange(MB // 8, dtype=np.float64))
    after = cw.put_phase_snapshot()
    assert after["puts"] > before["puts"]
    assert after["serialize"] > before["serialize"]
