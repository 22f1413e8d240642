"""graftrpc dispatch plane: codec units, native frame transport, failure
paths, and the pure-Python fallback.

The port's counterpart of tests/test_graftrpc.py: every case, with the same
inputs and assertions, on ray_tpu_torch's runtime. It imports no JAX, so
it also runs on a GPU host without it. Where a case differs, its
comment says how and why.

The compact codec and reply encoding are pure Python (always tested);
frame-transport tests drive the real C reactor
(ray_tpu_torch/csrc/rpc_core.cc via
the shared library) and skip when it can't be built. Cluster-level
tests assert the dispatch plane keeps actor-call semantics: ordering,
exceptions, peer crash surfacing ActorDiedError, and identical behavior
with the plane disabled (RAY_TPU_TORCH_GRAFTRPC=0).
"""

import asyncio
import os
from types import SimpleNamespace

import pytest

import ray_tpu_torch
from ray_tpu_torch.core._native import graftrpc
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.core.common import ActorDiedError, TaskSpec
from ray_tpu_torch.core.rpc import RpcConnectionLost

ADDR = ("127.0.0.1", 7777)


def _spec(seqno=0, args=(), task_id=None, **kw):
    fields = dict(
        task_id=task_id or os.urandom(16),
        name="A.inc",
        func_id=b"",
        args=list(args),
        num_returns=1,
        resources={},
        owner_addr=ADDR,
        owner_worker_id=b"w" * 16,
        actor_id=b"a" * 16,
        method_name="inc",
        seqno=seqno,
        caller_id=b"w" * 16,
    )
    fields.update(kw)
    s = TaskSpec(**fields)
    if not s.trace_id:
        s.trace_id = s.task_id
    return s


def _chan():
    return SimpleNamespace(interns={}, next_intern=0)


def _roundtrip(specs):
    chan = _chan()
    interns, payload = graftrpc.encode_call(chan, specs)
    table = {}
    for blob in interns:
        graftrpc.intern_frame_apply(blob, table)
    return graftrpc.decode_call(payload, table)


# ---------------------------------------------------------------------------
# codec units (no native library required)
# ---------------------------------------------------------------------------

def test_codec_compact_roundtrip_preserves_fields():
    specs = [_spec(seqno=i, args=[("p", "v", b"data%d" % i, b"meta")])
             for i in range(5)]
    out = _roundtrip(specs)
    assert len(out) == 5
    for src, got in zip(specs, out):
        for f in ("task_id", "name", "actor_id", "method_name", "seqno",
                  "num_returns", "args", "max_retries", "owner_addr",
                  "caller_id", "trace_id", "parent_span"):
            assert getattr(got, f) == getattr(src, f), f


def test_codec_one_intern_frame_per_method():
    chan = _chan()
    interns1, _ = graftrpc.encode_call(
        chan, [_spec(seqno=i) for i in range(10)])
    interns2, _ = graftrpc.encode_call(
        chan, [_spec(seqno=i) for i in range(10, 20)])
    assert len(interns1) == 1  # one (actor, method) template
    assert interns2 == []      # already interned on this channel


def test_codec_nondefault_trace_context_roundtrips():
    s = _spec(trace_id=b"t" * 16, parent_span=b"p" * 16)
    (got,) = _roundtrip([s])
    assert got.trace_id == b"t" * 16 and got.parent_span == b"p" * 16


def test_codec_ref_args_fall_back_to_pickle_records():
    # Ref args aren't ("p","v",data,meta) — the per-spec args must ride
    # the pickled-args branch and still round-trip exactly.
    s = _spec(args=[("r", b"o" * 20, ADDR)])
    (got,) = _roundtrip([s])
    assert got.args == s.args


def test_codec_unusual_specs_pickle_whole_spec():
    # A placement-group spec can't match the template; whole-spec pickle.
    s = _spec(placement_group=b"g" * 16, pg_bundle_index=2)
    chan = _chan()
    interns, payload = graftrpc.encode_call(chan, [s])
    assert interns == [] and chan.interns == {}
    (got,) = graftrpc.decode_call(payload, {})
    assert got.placement_group == s.placement_group
    assert got.pg_bundle_index == 2


def test_codec_mixed_batch_roundtrips_in_order():
    specs = [_spec(seqno=0),
             _spec(seqno=1, placement_group=b"g" * 16),
             _spec(seqno=2, args=[("p", "v", b"x" * 70_000, b"")])]
    out = _roundtrip(specs)
    assert [s.seqno for s in out] == [0, 1, 2]
    assert out[2].args[0][2] == b"x" * 70_000


def test_reply_codec_inline_and_error_shapes():
    replies = [
        {"error": None, "returns": [("inline", b"d", b"m", ())]},
        {"error": ("boom", b"err", b"emeta"), "returns": []},
        {"error": None,
         "returns": [("inline", b"d2", b"m2", ()),
                     ("inline", b"d3", b"m3", ())]},
    ]
    out = graftrpc.decode_replies(graftrpc.encode_replies(replies))
    assert out[0] == {"error": None, "returns": [("inline", b"d", b"m", ())]}
    assert out[1]["error"][0] == "boom"
    assert len(out[2]["returns"]) == 2


# ---------------------------------------------------------------------------
# native frame transport (skipped when the reactor can't load)
# ---------------------------------------------------------------------------

# Decided when a test runs, not at import, so every xdist worker
# collects the same tests.
@pytest.fixture
def native_reactor():
    if not graftrpc.available():
        pytest.skip("native reactor unavailable")


native = pytest.mark.usefixtures("native_reactor")


def _echo_endpoint(loop, path):
    """Endpoint that echoes every CALL payload back as a REPLY."""
    ep = graftrpc.GraftEndpoint(loop, path)

    def on_frame(conn, op, flags, chan, seq, payload):
        if op == graftrpc.OP_CALL:
            ep.send(conn, graftrpc.OP_REPLY, seq, payload)

    ep.on_frame = on_frame
    return ep


@native
def test_frame_roundtrip_small_and_large(tmp_path):
    async def scenario():
        loop = asyncio.get_running_loop()
        server = _echo_endpoint(loop, str(tmp_path / "s.sock"))
        client = graftrpc.GraftEndpoint(loop, str(tmp_path / "c.sock"))
        replies = {}
        got_all = asyncio.Event()
        want = {}

        def on_frame(conn, op, flags, chan, seq, payload):
            replies[seq] = payload
            if len(replies) == len(want):
                got_all.set()

        client.on_frame = on_frame
        conn = client.connect(server.listen_path)
        # small, >64KiB (forces split reads through the reactor), and
        # >256KiB (forces the Python drain buffer to grow mid-burst).
        want = {1: b"ping", 2: os.urandom(100_000), 3: os.urandom(1 << 20)}
        for seq, payload in want.items():
            assert client.send(conn, graftrpc.OP_CALL, seq, payload)
        await asyncio.wait_for(got_all.wait(), timeout=10)
        assert replies == want
        client.close()
        server.close()

    asyncio.run(scenario())


@native
def test_frame_concurrent_burst(tmp_path):
    async def scenario():
        loop = asyncio.get_running_loop()
        server = _echo_endpoint(loop, str(tmp_path / "s.sock"))
        client = graftrpc.GraftEndpoint(loop, str(tmp_path / "c.sock"))
        n = 200
        replies = {}
        got_all = asyncio.Event()

        def on_frame(conn, op, flags, chan, seq, payload):
            replies[seq] = payload
            if len(replies) == n:
                got_all.set()

        client.on_frame = on_frame
        conn = client.connect(server.listen_path)
        for seq in range(1, n + 1):
            assert client.send(conn, graftrpc.OP_CALL, seq,
                               b"p%d" % seq + b"x" * (seq % 997))
        await asyncio.wait_for(got_all.wait(), timeout=10)
        assert set(replies) == set(range(1, n + 1))
        assert replies[n] == b"p%d" % n + b"x" * (n % 997)
        client.close()
        server.close()

    asyncio.run(scenario())


@native
def test_channel_peer_crash_fails_pending_retriably(tmp_path):
    """Peer dies mid-call: the close record must fail the pending future
    with RpcConnectionLost (the retriable transport loss), and later
    sends on the dead conn must report not-written (False)."""
    async def scenario():
        loop = asyncio.get_running_loop()
        server = graftrpc.GraftEndpoint(loop, str(tmp_path / "s.sock"))
        server.on_frame = lambda *a: None  # swallow; never reply
        client = graftrpc.GraftEndpoint(loop, str(tmp_path / "c.sock"))
        conn = client.connect(server.listen_path)
        chan = graftrpc.GraftChannel(client, conn)
        client.on_close = lambda c: chan.fail(
            RpcConnectionLost("graftrpc connection lost"))
        fut = chan.call_batch([_spec()])
        await asyncio.sleep(0.05)
        server.close()  # peer "crash"
        with pytest.raises(RpcConnectionLost):
            await asyncio.wait_for(fut, timeout=10)
        assert chan.closed
        with pytest.raises(graftrpc.GraftSendError):
            chan.call_batch([_spec()])
        client.close()

    asyncio.run(scenario())


@native
def test_send_on_unknown_conn_reports_false(tmp_path):
    async def scenario():
        loop = asyncio.get_running_loop()
        ep = graftrpc.GraftEndpoint(loop, str(tmp_path / "e.sock"))
        assert ep.send(12345, graftrpc.OP_PING, 1, b"") is False
        ep.close()

    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# cluster-level: dispatch plane on (default) and off
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 4})
    c.connect()
    yield c
    c.shutdown()


def test_actor_calls_ride_dispatch_plane(cluster):
    from ray_tpu_torch.core.ref import get_core_worker

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.v = 0

        def inc(self):
            self.v += 1
            return self.v

        def boom(self):
            raise ValueError("kapow")

    a = Counter.remote()
    refs = [a.inc.remote() for _ in range(100)]
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(1, 101))
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(a.boom.remote(), timeout=60)
    assert "kapow" in str(ei.value)
    cw = get_core_worker()
    if graftrpc.available():
        assert cw._graft is not None  # plane actually active
        assert cw._graft_channels    # and calls dialed a channel


def test_actor_peer_crash_surfaces_actor_died(cluster):
    @ray_tpu_torch.remote
    class Bomb:
        def ping(self):
            return "ok"

        def die(self):
            os._exit(1)

    b = Bomb.remote()
    assert ray_tpu_torch.get(b.ping.remote(), timeout=60) == "ok"
    refs = [b.ping.remote() for _ in range(5)] + [b.die.remote()]
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(refs[-1], timeout=60)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(b.ping.remote(), timeout=60)


_DISABLED_SCRIPT = """
import ray_tpu_torch
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.core.ref import get_core_worker

c = Cluster(num_nodes=1, resources={"CPU": 4})
c.connect()

@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.v = 0
    def inc(self):
        self.v += 1
        return self.v

a = Counter.remote()
refs = [a.inc.remote() for _ in range(50)]
assert ray_tpu_torch.get(refs, timeout=60) == list(range(1, 51))
cw = get_core_worker()
assert cw._graft is None, "graft endpoint created despite RAY_TPU_TORCH_GRAFTRPC=0"
assert cw._graft_channels == {}
c.shutdown()
print("DISABLED-PLANE-OK")
"""


def test_fallback_when_plane_disabled():
    """RAY_TPU_TORCH_GRAFTRPC=0: the asyncio control plane carries actor calls
    end-to-end; no graft endpoint is created anywhere. Runs in a child
    process so the env-var override governs every worker from birth."""
    import subprocess
    import sys
    env = dict(os.environ, RAY_TPU_TORCH_GRAFTRPC="0")
    out = subprocess.run([sys.executable, "-c", _DISABLED_SCRIPT],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DISABLED-PLANE-OK" in out.stdout


def test_fallback_when_native_unavailable(monkeypatch, tmp_path):
    """available() returning False must route submission through the
    asyncio path transparently (per-process decision, no error)."""
    monkeypatch.setattr(graftrpc, "_lib", None)
    monkeypatch.setattr(graftrpc, "_lib_failed", True)
    assert graftrpc.available() is False
    with pytest.raises(graftrpc.GraftError):
        graftrpc._get_lib()
    # An endpoint can't be constructed; the core worker guards on
    # available() and leaves self._graft = None (asyncio path).
    with pytest.raises(graftrpc.GraftError):
        graftrpc.GraftEndpoint(asyncio.new_event_loop(),
                               str(tmp_path / "x.sock"))
