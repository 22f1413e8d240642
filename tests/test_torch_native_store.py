"""The port's native C++ object-store unit suites, driven from pytest:
the counterpart of tests/test_native_store.py on ray_tpu_torch/csrc.

The gtest analogue the reference runs under Bazel (reference:
src/ray/object_manager/plasma/ unit tests; SURVEY §4.1): `make test`
in ray_tpu_torch/csrc builds the seven *_test.cc suites against the
library's translation units and exercises lifecycle, eviction-vs-pin-
vs-refcount, ingest adoption, and concurrent index mutation at the C++
layer, plus the reactor, copy, scope, shm, prof and log planes.
"""

import os
import subprocess

CSRC = os.path.join(os.path.dirname(__file__), "..", "ray_tpu_torch",
                    "csrc")
SUITES = ("object_store_test", "rpc_core_test", "copy_core_test",
          "scope_core_test", "shm_core_test", "prof_core_test",
          "log_core_test")


def test_native_object_store_unit_suite():
    out = subprocess.run(["make", "-s", "test"], cwd=os.path.abspath(CSRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ALL OK" in out.stdout, out.stdout
    for suite in SUITES:
        assert f"{suite}: ALL OK" in out.stdout, (suite, out.stdout)


def test_fastpath_sidecar_roundtrip(tmp_path):
    """StoreSidecar + FastStoreClient against a live LocalObjectStore:
    ingest/get/contains/delete over the C unix-socket path, with journal
    events carrying the lifecycle back to (what would be) the agent."""
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_store import (FastStoreClient,
                                           LocalObjectStore, StoreSidecar)

    store = LocalObjectStore(str(tmp_path / "shm"), 1 << 20)
    sidecar = StoreSidecar(store, str(tmp_path / "fp.sock"))
    client = FastStoreClient(str(tmp_path / "fp.sock"))
    try:
        oid = ObjectID.random()
        payload = b"fastpath-payload" * 100
        src = os.path.join(store.dir, "ingest-t-1")
        with open(src, "wb") as f:
            f.write(payload)
        assert client.ingest(oid.binary(), "ingest-t-1",
                             len(payload), 0) == 0
        assert client.contains(oid.binary()) == 1
        got = client.get(oid.binary())
        assert got is not None
        path, ds, ms = got
        assert ds == len(payload)
        with open(path, "rb") as f:
            assert f.read(ds) == payload
        client.release(oid.binary())
        # Pinned ingest is a primary: survives pressure (pin semantics
        # covered by the C suite); delete removes it.
        assert client.delete(oid.binary()) == 0
        assert client.contains(oid.binary()) == 0
        # Journal: ingest then delete, each tagged with its wire origin.
        events = sidecar.drain()
        assert (1, 1, oid.binary(), len(payload)) in events
        assert any(op == 4 and o == oid.binary()
                   for op, _origin, o, _ in events)
        # Path traversal refused at the C layer.
        assert client.ingest(oid.binary(), "../evil", 1, 0) == -4
    finally:
        client.close()
        sidecar.stop()
        store.close()


def test_fastpath_end_to_end_put_get_free():
    """Through the public API: puts ride the C sidecar (store path), a
    repeat get is sync, and dropping the last ref frees the store copy
    (ledger consistency via the journal)."""
    import gc
    import time

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import api

    ray_tpu_torch.init()
    try:
        arr = np.arange(60000, dtype=np.int64)  # > inline threshold
        ref = ray_tpu_torch.put(arr)
        assert np.array_equal(ray_tpu_torch.get(ref), arr)
        assert np.array_equal(ray_tpu_torch.get(ref), arr)  # cached path
        cw = api._cw()
        assert cw._fastpath is not None, "fast path did not engage"
        # Drop the ref: the store copy frees (C delete + journal).
        node = ray_tpu_torch.nodes()[0]
        del ref
        gc.collect()
        agent = cw._client_for_worker(tuple(node["addr"]))
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            stats = cw._run(agent.call("agent_stats")).result(30)
            if stats.get("store_pinned", 1) == 0:
                break
            time.sleep(0.2)
        assert stats.get("store_pinned") == 0, stats
    finally:
        ray_tpu_torch.shutdown()


def test_native_store_sanitizers():
    """The same C++ unit suite under ThreadSanitizer and
    AddressSanitizer (reference: C++ suites run sanitized in CI; SURVEY
    §5.2) — the sidecar's concurrent ingest/evict hammer runs clean.
    Opt-in (RAY_TPU_TORCH_SANITIZER_TESTS=1): hosts without
    libtsan/libasan or with incompatible ASLR settings would fail on
    environment, and the two extra builds cost minutes locally."""
    import pytest
    if os.environ.get("RAY_TPU_TORCH_SANITIZER_TESTS") != "1":
        pytest.skip("sanitizer builds are CI-gated "
                    "(RAY_TPU_TORCH_SANITIZER_TESTS=1)")
    for target in ("tsan", "asan"):
        out = subprocess.run(["make", "-s", target],
                             cwd=os.path.abspath(CSRC),
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, (target, out.stdout + out.stderr)
        # All seven native suites run sanitized: the store sidecar,
        # the graftrpc reactor, the graftcopy engine, the graftscope
        # ring buffers (whose drain-while-writing storm is the whole
        # point of running under TSAN), the graftshm arena
        # (concurrent acquire/recycle hammer), the graftprof
        # sampler (drain-while-sampling + stop/start races), AND the
        # graftlog crash-persistent ring (emit storm vs live drain)
        # each print their own ALL OK.
        assert out.stdout.count("ALL OK") >= 7, (target, out.stdout)
