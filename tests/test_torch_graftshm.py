"""graftshm: store-owned shared-memory object plane.

The port's counterpart of tests/test_graftshm.py: every case, with the same
inputs and assertions, on ray_tpu_torch's runtime. It imports no JAX, so
it also runs on a GPU host without it. Where a case differs, its
comment says how and why.

Covers the put plane's lifecycle at every layer the C suite cannot:
in-place serialization through the SCM_RIGHTS slab fd, staged-entry
reclamation when a client dies holding a mapped write region, the
fallback ladder (arena exhaustion / seal failure -> graftcopy), the
RAY_TPU_TORCH_GRAFTSHM=0 parity contract, and the DLPack get side handing
torch a capsule over the read-only mapping with no intermediate host
bytes (reference: Ray's plasma Create/Seal client contract +
PlasmaClient mmap table; SURVEY object-plane section).
"""

import gc
import mmap
import os
import subprocess
import sys
import time

import numpy as np
import pytest


def _unit_harness(tmp_path, capacity=1 << 22):
    from ray_tpu_torch.core.object_store import (FastStoreClient,
                                           LocalObjectStore, StoreSidecar)
    store = LocalObjectStore(str(tmp_path / "shm"), capacity)
    sidecar = StoreSidecar(store, str(tmp_path / "fp.sock"))
    client = FastStoreClient(str(tmp_path / "fp.sock"))
    return store, sidecar, client


def test_create_seal_inplace_roundtrip(tmp_path):
    """CREATE -> map the SCM_RIGHTS fd -> serialize IN PLACE -> SEAL:
    the object is served from the very pages the worker wrote (no
    rename — the slab path IS the object path), journaled as an ingest,
    and the freed slab is reused warm by the next same-size create."""
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.core._native.graftshm import SlabMapCache
    from ray_tpu_torch.core.ids import ObjectID

    store, sidecar, client = _unit_harness(tmp_path)
    try:
        value = {"a": np.arange(4096, dtype=np.int64), "b": b"graftshm"}
        sv = serialization.serialize(value)
        meta = sv.meta()
        total = sv.total_size + len(meta)
        oid = ObjectID.random().binary()

        rc, path, fd, reused = client.create(oid, sv.total_size, len(meta))
        assert rc == 0 and fd >= 0 and reused == 0, (rc, fd, reused)
        assert os.path.basename(path).startswith("shmslab-"), path

        cache = SlabMapCache()
        m = cache.map_fd(fd, total)
        ds, ms = sv.write_into_mapped(memoryview(m)[:total], meta)
        assert (ds, ms) == (sv.total_size, len(meta))

        # Staged entries read as present-but-unsealed (contains == 2,
        # the in-flight answer seal-waiters key on); double-seal is -1.
        assert client.contains(oid) == 2
        assert client.seal(oid) == 0
        assert client.seal(oid) == -1
        assert client.contains(oid) == 1

        got = client.get(oid)
        assert got is not None
        gpath, gds, gms = got
        assert gpath == path and (gds, gms) == (ds, ms)
        with open(gpath, "rb") as f:
            buf = f.read(gds + gms)
        back = serialization.deserialize(memoryview(buf)[:gds],
                                         bytes(buf[gds:gds + gms]))
        assert np.array_equal(back["a"], value["a"])
        assert back["b"] == value["b"]
        client.release(oid)

        # CREATE journals its own record (origin 9), then the seal rides
        # as an ingest (op 1) whose origin byte pins the shm plane, so
        # agent bookkeeping stays op-agnostic; delete returns the slab to
        # the warm free list.
        events = sidecar.drain()
        assert (9, 9, oid, gds + gms) in events, events
        assert (1, 10, oid, gds + gms) in events, events
        assert client.delete(oid) == 0

        oid2 = ObjectID.random().binary()
        rc, path2, fd2, reused = client.create(oid2, sv.total_size,
                                               len(meta))
        assert rc == 0 and reused == 1 and path2 == path
        # Same inode + size: the cached writable mapping is reused
        # without an mmap/munmap pair.
        m2 = cache.map_fd(fd2, total)
        assert m2 is m and cache.hits == 1
        sv.write_into_mapped(memoryview(m2)[:total], meta)
        assert client.seal(oid2) == 0
        client.delete(oid2)
        cache.close()
    finally:
        client.close()
        sidecar.stop()
        store.close()


def test_client_death_holding_mapped_write_region(tmp_path):
    """A client that dies between CREATE and SEAL: the sidecar's
    disconnect sweep reclaims the staged entry (it never becomes
    visible), the slab returns to the arena, and the dead client's
    MAP_SHARED region stays valid — writes to it cannot SIGBUS even
    after reclamation (tmpfs pages live until munmap)."""
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_store import FastStoreClient

    store, sidecar, client = _unit_harness(tmp_path)
    try:
        dying = FastStoreClient(str(tmp_path / "fp.sock"))
        oid = ObjectID.random().binary()
        rc, path, fd, _ = dying.create(oid, 4096, 0)
        assert rc == 0 and fd >= 0
        m = mmap.mmap(fd, 4096)
        os.close(fd)
        m[:8] = b"halfdone"
        dying.close()  # dies holding the mapped write region

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if client.contains(oid) == 0:
                break
            time.sleep(0.05)
        assert client.contains(oid) == 0, "staged entry not reclaimed"

        # The orphaned mapping is still writable, harmlessly.
        m[:8] = b"too-late"
        m.close()

        # The reclaimed slab is back on the warm free list.
        oid2 = ObjectID.random().binary()
        rc, path2, fd2, reused = client.create(oid2, 4096, 0)
        assert rc == 0 and reused == 1 and path2 == path
        os.close(fd2)
        client.delete(oid2)
    finally:
        client.close()
        sidecar.stop()
        store.close()


def test_arena_exhaustion_falls_back_to_graftcopy():
    """When CREATE cannot be satisfied (rc -2: arena/tmpfs exhausted),
    the put must fall back to the graftcopy plane transparently — same
    ref, same bytes, copy phase engaged instead of inplace."""
    import ray_tpu_torch
    from ray_tpu_torch import api

    ray_tpu_torch.init()
    try:
        cw = api._cw()
        arr = np.arange(1 << 18, dtype=np.float64)  # 2 MiB
        ref0 = ray_tpu_torch.put(arr)  # primes the fastpath client
        assert np.array_equal(ray_tpu_torch.get(ref0), arr)
        fp = cw._get_fastpath()
        if fp is None:
            pytest.skip("fastpath sidecar did not engage")
        orig = fp.create
        fp.create = lambda oid, ds, ms: (-2, "", -1, 0)
        try:
            before = cw.put_phase_snapshot()
            ref = ray_tpu_torch.put(arr * 3)
            assert np.array_equal(ray_tpu_torch.get(ref), arr * 3)
            after = cw.put_phase_snapshot()
            assert after["copy"] > before["copy"], (before, after)
            assert after["inplace"] == before["inplace"]
        finally:
            fp.create = orig
    finally:
        ray_tpu_torch.shutdown()


def test_seal_failure_cleans_staged_and_falls_back():
    """Sidecar failure between CREATE and SEAL (seal raises OSError):
    _put_shm must un-stage the entry and the put must still succeed
    through the fallback ladder — and the oid must be VISIBLE (a
    staged leftover would make contains/get hang on an unsealed
    entry)."""
    import ray_tpu_torch
    from ray_tpu_torch import api

    ray_tpu_torch.init()
    try:
        cw = api._cw()
        arr = np.arange(1 << 18, dtype=np.float64)
        ref0 = ray_tpu_torch.put(arr)
        assert np.array_equal(ray_tpu_torch.get(ref0), arr)
        fp = cw._get_fastpath()
        if fp is None:
            pytest.skip("fastpath sidecar did not engage")
        calls = []

        def dying_seal(oid):
            calls.append(oid)
            raise OSError("sidecar died mid-seal")

        orig = fp.seal
        fp.seal = dying_seal
        try:
            ref = ray_tpu_torch.put(arr * 5)
            assert calls, "graftshm plane never engaged"
            assert np.array_equal(ray_tpu_torch.get(ref), arr * 5)
            # The failed create's staged entry was deleted: the store
            # answers for the oid (sealed via the fallback path).
            assert fp.contains(ref.binary()) == 1
        finally:
            fp.seal = orig
    finally:
        ray_tpu_torch.shutdown()


def test_graftshm_disabled_subprocess_parity():
    """RAY_TPU_TORCH_GRAFTSHM=0 contract: the exact same put/get program
    works with the plane off — bytes identical, inplace phase never
    engages, graftcopy carries the copy."""
    code = """
import numpy as np
import ray_tpu_torch
from ray_tpu_torch import api

ray_tpu_torch.init()
arr = np.arange(1 << 18, dtype=np.float64)
ref = ray_tpu_torch.put({"w": arr, "n": 3})
got = ray_tpu_torch.get(ref)
assert np.array_equal(got["w"], arr) and got["n"] == 3
cw = api._cw()
assert cw._use_graftshm() is False
ph = cw.put_phase_snapshot()
assert ph["inplace"] == 0, ph
assert ph["copy"] > 0, ph
ray_tpu_torch.shutdown()
print("PARITY-OK")
"""
    env = dict(os.environ, RAY_TPU_TORCH_GRAFTSHM="0")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "PARITY-OK" in out.stdout


def test_device_ingest_dlpack_torch_tensor():
    """The get side: a stored array comes back as a READ-ONLY zero-copy
    view into the mapping, and device_ingest hands torch a DLPack capsule
    over those pages — on the CPU the result is a tensor over the same
    mapped bytes (the capsule path, not the from_numpy copy), and
    consumed capsules are released once the tensors die."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.core._native import graftshm
    from ray_tpu_torch.device_objects import device_ingest

    ray_tpu_torch.init()
    try:
        arr = np.arange(1 << 17, dtype=np.float32).reshape(256, 512)
        ref = ray_tpu_torch.put({"w": arr, "tag": "step7"})

        # Host-side get is a view into the store mapping, not a copy:
        # read-only (PROT_READ) and buffer-backed.
        host = ray_tpu_torch.get(ref)
        assert host["w"].flags["WRITEABLE"] is False
        assert host["w"].base is not None

        base = graftshm.live_capsules()
        out = device_ingest(ref, device="cpu")
        assert isinstance(out["w"], torch.Tensor)
        assert out["w"].dtype == torch.float32
        assert out["w"].device.type == "cpu"
        assert tuple(out["w"].shape) == (256, 512)
        assert np.array_equal(out["w"].numpy(), arr)
        assert out["tag"] == "step7"
        # The DLPack capsule path was taken (a live capsule per leaf),
        # and the tensor reads the read-only mapped pages themselves.
        assert graftshm.live_capsules() > base
        assert out["w"].data_ptr() == host["w"].ctypes.data

        # The consumer owns the capsule while the tensor lives; its
        # deleter must fire once the tensor is gone (no registry leak).
        del out
        gc.collect()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if graftshm.live_capsules() <= base:
                break
            gc.collect()
            time.sleep(0.05)
        assert graftshm.live_capsules() <= base
    finally:
        ray_tpu_torch.shutdown()


def test_write_into_mapped_zeroes_gaps_on_dirty_slab():
    """A recycled slab still holds the previous object's bytes; the
    in-place serializer must zero every alignment gap so stale data
    cannot leak into (or corrupt) the new object."""
    from ray_tpu_torch.core import serialization

    value = {"a": np.arange(100, dtype=np.uint8),  # unaligned buffer
             "b": np.arange(7, dtype=np.float64)}
    sv = serialization.serialize(value)
    meta = sv.meta()
    total = sv.total_size + len(meta)

    dirty = bytearray(b"\xff" * (total + 64))
    mv = memoryview(dirty)[:total]
    ds, ms = sv.write_into_mapped(mv, meta)
    assert (ds, ms) == (sv.total_size, len(meta))

    back = serialization.deserialize(mv[:ds], bytes(mv[ds:ds + ms]))
    assert np.array_equal(back["a"], value["a"])
    assert np.array_equal(back["b"], value["b"])
    # Every alignment gap inside the data section is zero, and the
    # fresh-file write path produces byte-identical output.
    ref_bytes = sv.to_bytes()
    assert bytes(mv[:ds]) == ref_bytes
    # Tail guard beyond total untouched.
    assert dirty[total:] == b"\xff" * 64


def test_slab_map_cache_lru_and_close(tmp_path):
    """SlabMapCache: hit on same (inode, size), miss on new size, LRU
    eviction closes the oldest mapping, close() drops everything."""
    from ray_tpu_torch.core._native.graftshm import SlabMapCache

    cache = SlabMapCache(max_entries=2)
    paths = []
    for i in range(3):
        p = tmp_path / f"slab{i}"
        with open(p, "wb") as f:
            f.write(b"\0" * 4096)
        paths.append(p)

    def fd(i):
        return os.open(paths[i], os.O_RDWR)

    m0 = cache.map_fd(fd(0), 4096)
    assert cache.map_fd(fd(0), 4096) is m0 and cache.hits == 1
    m1 = cache.map_fd(fd(1), 4096)
    m2 = cache.map_fd(fd(2), 4096)  # evicts m0 (max_entries=2)
    assert m0.closed and not m1.closed and not m2.closed
    assert cache.map_fd(fd(0), 4096) is not m0  # re-mapped fresh
    cache.close()
    assert m1.closed and m2.closed
