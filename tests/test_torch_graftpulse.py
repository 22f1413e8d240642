"""The port's graftpulse plane (``ray_tpu_torch/core/_native/
graftpulse.py``): the cases of ``tests/test_graftpulse.py`` with the same
inputs and assertions on the port's runtime — the wire round trip and
the controller's aggregation, the cadence health FSM under a SIGKILLed
node agent, the autoscaler scaling up on native p99 alone, parity with
``RAY_TPU_TORCH_GRAFTPULSE=0`` in a subprocess, and the dashboard's
``/api/cluster`` and ``/metrics/cluster``.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.core._native import graftpulse
from ray_tpu_torch.core.cluster_utils import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HIST0 = (0,) * graftpulse.PULSE_HIST_BUCKETS


def _hist(**buckets):
    h = [0] * graftpulse.PULSE_HIST_BUCKETS
    for k, v in buckets.items():
        h[int(k[1:])] = v
    return tuple(h)


def _pulse(seq=1, t_mono_ns=1_000_000_000, queue_depth=0, kinds=None,
           **kw):
    defaults = dict(t_wall_ns=1_700_000_000_000_000_000, store_used=1024,
                    store_capacity=1 << 30, store_objects=3,
                    shm_free_chunks=7, shm_arena_bytes=1 << 20,
                    num_workers=2, rss_bytes=5 << 20, scope_dropped=0,
                    events_dropped=0, prof_oncpu_permille=0,
                    prof_gil_permille=0)
    defaults.update(kw)
    return graftpulse.Pulse(seq=seq, t_mono_ns=t_mono_ns,
                            queue_depth=queue_depth, kinds=kinds or {},
                            **defaults)


# ---------------------------------------------------------------------------
# wire roundtrip + aggregation (no cluster)
# ---------------------------------------------------------------------------

def test_pulse_roundtrip():
    kinds = {"rpc_send": (10, 4096, 50_000, _hist(b0=8, b3=2)),
             "sc_end": (5, 0, 9_000_000, _hist(b5=4, b11=1))}
    p = _pulse(seq=42, queue_depth=6, kinds=kinds)
    blob = graftpulse.encode(p)
    assert len(blob) == graftpulse.PULSE_RECORD_SIZE + \
        11 * (3 + graftpulse.PULSE_HIST_BUCKETS) * 8
    q = graftpulse.decode(blob)
    assert q.seq == 42 and q.queue_depth == 6
    assert q.store_objects == 3 and q.shm_free_chunks == 7
    assert q.kinds == kinds  # all-zero rows are elided on decode


def test_pulse_decode_rejects_malformed():
    good = graftpulse.encode(_pulse())
    with pytest.raises(ValueError):
        graftpulse.decode(good[:40])  # truncated header
    with pytest.raises(ValueError):
        graftpulse.decode(b"\x00" * len(good))  # bad magic
    with pytest.raises(ValueError):
        # version skew
        graftpulse.decode(good[:4] + b"\xff\xff" + good[6:])


def test_pulse_u32_fields_clamp_instead_of_raising():
    p = _pulse(store_objects=1 << 40, queue_depth=1 << 36)
    q = graftpulse.decode(graftpulse.encode(p))
    assert q.store_objects == 0xFFFFFFFF
    assert q.queue_depth == 0xFFFFFFFF


def test_percentile_math():
    # All mass in bucket 3 -> representative 1.5 * 2^(10+3).
    assert graftpulse.percentile_ns(_hist(b3=100), 0.5) == 1.5 * (1 << 13)
    # 99 fast calls in b0, 1 slow in b11: p50 in b0, p99 in b11.
    h = _hist(b0=99, b11=1)
    assert graftpulse.percentile_ns(h, 0.50) == 1.5 * (1 << 10)
    assert graftpulse.percentile_ns(h, 0.999) == 1.5 * (1 << 21)
    assert graftpulse.percentile_ns(_HIST0, 0.99) == 0.0


def test_aggregator_folds_nodes_and_drops_garbage():
    agg = graftpulse.ClusterAggregator(history=10)
    assert agg.ingest("aaa", b"not a pulse") is None
    assert agg.series == {}
    k1 = {"rpc_send": (10, 1000, 5_000, _hist(b0=10))}
    k2 = {"rpc_send": (30, 3000, 90_000, _hist(b0=20, b11=10))}
    agg.ingest("aaa", graftpulse.encode(
        _pulse(seq=1, t_mono_ns=10**9, queue_depth=2, kinds=k1)))
    agg.ingest("aaa", graftpulse.encode(
        _pulse(seq=2, t_mono_ns=3 * 10**9, queue_depth=2, kinds=k1)))
    agg.ingest("bbb", graftpulse.encode(
        _pulse(seq=1, t_mono_ns=10**9, queue_depth=5, kinds=k2)))
    snap = agg.snapshot()
    op = snap["ops"]["rpc_send"]
    assert op["calls"] == 50 and op["bytes"] == 5000
    # 40 calls in b0, 10 in b11 -> p50 from b0, p99 from b11.
    assert op["p50_ns"] == 1.5 * (1 << 10)
    assert op["p99_ns"] == 1.5 * (1 << 21)
    assert snap["window_s"] == pytest.approx(2.0)
    assert op["calls_per_s"] == pytest.approx(25.0)
    assert snap["totals"]["queue_depth"] == 7
    assert snap["totals"]["store_objects"] == 6
    assert set(snap["nodes"]) == {"aaa", "bbb"}
    assert snap["nodes"]["aaa"]["seq"] == 2
    assert snap["nodes"]["aaa"]["health"] == "alive"
    assert agg.worst_p99_ns() == 1.5 * (1 << 21)
    assert agg.total_queue_depth() == 7
    agg.forget("bbb")
    assert agg.total_queue_depth() == 2


def test_aggregator_window_bounds_aggregates():
    """snapshot(window=N) folds only the last N pulses per node — the
    contract behind /api/cluster?window=N and the soak verdict's
    recent-window p99."""
    agg = graftpulse.ClusterAggregator(history=20)
    k = {"rpc_send": (1, 100, 1_000, _hist(b0=1))}
    for seq in range(1, 11):
        agg.ingest("aaa", graftpulse.encode(
            _pulse(seq=seq, t_mono_ns=seq * 10**9, kinds=k)))
    assert agg.snapshot(window=3)["ops"]["rpc_send"]["calls"] == 3
    assert agg.snapshot(window=10)["ops"]["rpc_send"]["calls"] == 10
    # window=0 means "everything retained" (bounded by history).
    assert agg.snapshot(window=0)["ops"]["rpc_send"]["calls"] == 10
    # An over-long window clamps to what exists, with the span to match.
    snap = agg.snapshot(window=500)
    assert snap["ops"]["rpc_send"]["calls"] == 10
    assert snap["window_s"] == pytest.approx(9.0)
    assert agg.snapshot(window=3)["window_s"] == pytest.approx(2.0)
    # A single-pulse window has no span and so no rates.
    one = agg.snapshot(window=1)
    assert one["window_s"] == 0.0
    assert one["ops"]["rpc_send"]["calls_per_s"] == 0.0


def test_mixed_version_fold_degrades_node_not_cluster():
    """Version skew: a v1-pulse node in a v2 cluster must degrade that
    NODE's row (wire_version + degraded marker, prof gauges zeroed) —
    its real data still folds, the cluster aggregates stay sound, and
    an unknown future version is dropped, never poisoning the fold."""
    from ray_tpu_torch.scale.simnode import SimNode
    agg = graftpulse.ClusterAggregator(history=10)
    k = {"rpc_send": (10, 1000, 5_000, _hist(b0=10))}
    for seq in (1, 2):
        agg.ingest("aaa", graftpulse.encode(
            _pulse(seq=seq, t_mono_ns=seq * 10**9, kinds=k,
                   prof_oncpu_permille=500)))
        agg.ingest("bbb", SimNode._encode_v1(
            _pulse(seq=seq, t_mono_ns=seq * 10**9, queue_depth=3,
                   kinds=k, prof_oncpu_permille=500)))
    # The v1 frame is exactly the registry's v1 size (96B header).
    blob = SimNode._encode_v1(_pulse(seq=3, kinds=k))
    assert len(blob) - 11 * (3 + graftpulse.PULSE_HIST_BUCKETS) * 8 \
        == graftpulse.PULSE_VERSION_SIZES[1]
    p = graftpulse.decode(blob)
    assert p.version == 1 and p.seq == 3
    assert p.prof_oncpu_permille == 0  # missing v1 fields zero-fill
    snap = agg.snapshot()
    assert snap["nodes"]["bbb"]["degraded"] is True
    assert snap["nodes"]["bbb"]["wire_version"] == 1
    assert "degraded" not in snap["nodes"]["aaa"]
    assert snap["nodes"]["aaa"]["wire_version"] == graftpulse.PULSE_VERSION
    # Both nodes' op deltas fold: the skewed node is degraded, not mute.
    assert snap["ops"]["rpc_send"]["calls"] == 40
    assert snap["totals"]["queue_depth"] == 3
    assert snap["nodes"]["bbb"]["health"] == "alive"
    # An unknown FUTURE version is a drop, not an exception or a fold.
    v3 = bytearray(graftpulse.encode(_pulse(seq=9, kinds=k)))
    v3[4:6] = (3).to_bytes(2, "little")
    assert agg.ingest("ccc", bytes(v3)) is None
    assert "ccc" not in agg.series


def test_assembler_emits_deltas_not_cumulatives(monkeypatch):
    from ray_tpu_torch.core._native import graftscope
    calls = {"n": 0}

    def fake_counters():
        calls["n"] += 1
        c = calls["n"]
        return {"rpc_send": (100 * c, 5000 * c, 77_000 * c)}

    def fake_hists():
        return {"rpc_send": _hist(b2=40 * calls["n"])}

    monkeypatch.setattr(graftscope, "counters", fake_counters)
    monkeypatch.setattr(graftscope, "histograms", fake_hists)
    asm = graftpulse.PulseAssembler()
    p1 = asm.assemble(queue_depth=1)
    p2 = asm.assemble(queue_depth=2)
    assert p1.seq == 1 and p2.seq == 2
    # Cumulative 100 -> 200 must arrive as a delta of 100 each tick.
    assert p1.kinds["rpc_send"][0] == 100
    assert p2.kinds["rpc_send"][0] == 100
    assert p2.kinds["rpc_send"][3] == _hist(b2=40)


def test_assembler_folds_worker_sources_per_process(monkeypatch):
    """Client-side kinds arrive as forwarded cumulative blocks keyed by
    worker; deltas are per-source, so a restarted worker (counters back
    to zero) contributes its fresh cumulative instead of a negative."""
    from ray_tpu_torch.core._native import graftscope
    monkeypatch.setattr(graftscope, "counters", lambda: {})
    monkeypatch.setattr(graftscope, "histograms", lambda: {})
    asm = graftpulse.PulseAssembler()

    def w(calls, b2):  # a worker's cumulative block, RPC-shaped (lists)
        return ({"rpc_send": [calls, calls * 10, calls * 1000]},
                {"rpc_send": list(_hist(b2=b2))})

    p1 = asm.assemble(extra_sources={"w:a": w(100, 4), "w:b": w(30, 2)})
    assert p1.kinds["rpc_send"][0] == 130
    assert p1.kinds["rpc_send"][3][2] == 6  # hists merged across sources
    # Tick 2: only w:a reports (w:b died) — its delta alone.
    p2 = asm.assemble(extra_sources={"w:a": w(150, 5)})
    assert p2.kinds["rpc_send"][0] == 50
    # Tick 3: w:b back under the same key with reset counters — its
    # whole fresh cumulative is the delta, never clamped to zero by the
    # dead predecessor's larger block.
    p3 = asm.assemble(extra_sources={"w:a": w(150, 5), "w:b": w(7, 1)})
    assert p3.kinds["rpc_send"][0] == 7


# ---------------------------------------------------------------------------
# autoscaler: native p99 alone triggers scale-up (request counts flat)
# ---------------------------------------------------------------------------

def _p99_scaler(provider, state):
    from ray_tpu_torch.autoscaler import Autoscaler

    class _FakeFut:
        def __init__(self, v):
            self._v = v

        def result(self, timeout=None):
            return self._v

    class _FakeCW:
        class controller:
            @staticmethod
            def call(method, *a):
                return method

        def _run(self, method):
            if method == "autoscaler_state":
                return _FakeFut(state)
            return _FakeFut([{"node_id": "head", "addr": ("h", 1)}])

    scaler = Autoscaler.__new__(Autoscaler)
    scaler._cw = _FakeCW()
    scaler._provider = provider
    scaler._node_resources = {"CPU": 4.0}
    scaler._min, scaler._max = 0, 4
    scaler._idle_timeout, scaler._period = 30.0, 1.0
    scaler._launched, scaler._idle_since = [], {}
    scaler._failure_backoff_s, scaler._next_launch_at = 0.0, 0.0
    scaler._p99_ms = 20.0
    return scaler


def test_autoscaler_scales_up_on_native_p99_alone():
    from ray_tpu_torch.autoscaler import NodeProvider

    class P(NodeProvider):
        def __init__(self):
            self.created = 0

        def create_node(self, resources):
            self.created += 1
            return {"name": f"n{self.created}"}

        def terminate_node(self, handle):
            pass

    # Request counts flat: zero pending demand, spare capacity on the
    # one node. Only the pulse-derived p99 + queue depth say "saturated".
    state = {
        "nodes": [{"node_id": "head", "state": "ALIVE",
                   "available": {"CPU": 4.0}, "total": {"CPU": 4.0}}],
        "pending_actors": [], "pending_pg_bundles": [], "infeasible": [],
        "native_p99_ms": 55.0, "queue_depth": 3,
    }
    provider = P()
    scaler = _p99_scaler(provider, state)
    assert scaler.update() == "up"
    assert provider.created == 1

    # Same state with the budget honored -> no action.
    calm = dict(state, native_p99_ms=5.0)
    assert _p99_scaler(P(), calm).update() is None
    # Latency over budget but nothing queued -> not saturation, no action.
    idle = dict(state, queue_depth=0)
    assert _p99_scaler(P(), idle).update() is None


# ---------------------------------------------------------------------------
# live cluster: pulses flow; SIGKILL -> suspect -> dead -> actor restart
# ---------------------------------------------------------------------------

@pytest.fixture()
def pulse_cluster():
    from ray_tpu_torch.utils.config import GlobalConfig
    GlobalConfig.initialize({"pulse_period_ms": 200,
                             "pulse_dead_ms": 2500,
                             "health_check_period_ms": 100})
    c = Cluster(num_nodes=1, resources={"CPU": 1})
    c.connect()
    yield c
    c.shutdown()
    GlobalConfig._overrides.clear()
    GlobalConfig._cache.clear()


def _telemetry():
    from ray_tpu_torch import state
    return state.cluster_telemetry()


def _node_hex_by_port(port):
    from ray_tpu_torch import state
    for n in state.list_nodes():
        if n["addr"].endswith(f":{port}"):
            return n["node_id"]
    return None


@pytest.mark.timeout(120)
def test_sigkilled_node_goes_suspect_then_dead_and_actor_restarts(
        pulse_cluster):
    c = pulse_cluster
    victim = c.add_node({"CPU": 4})

    @ray_tpu_torch.remote(num_cpus=4, max_restarts=2, max_task_retries=4)
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

    a = Counter.remote()  # only the 4-CPU victim node fits it
    assert ray_tpu_torch.get(a.bump.remote(), timeout=60) == 1

    victim_hex = _node_hex_by_port(victim.port)
    assert victim_hex is not None

    # Pulses flowing from both nodes before the kill.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        t = _telemetry()
        n = t["nodes"].get(victim_hex)
        if n and n.get("health") == "alive" and n.get("seq", 0) >= 2:
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"victim never pulsed: {t['nodes']}")
    assert t["cluster"]["pulse_enabled"] is True

    kill_mono = time.monotonic()
    c.kill_node(victim)

    # Suspect within the tick budget (2 ticks * 200ms), observed well
    # before the 2.5s dead deadline.
    from ray_tpu_torch import state
    saw_suspect = saw_dead = False
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not saw_dead:
        t = _telemetry()
        n = t["nodes"].get(victim_hex)
        if n is not None and n.get("health") == "suspect":
            saw_suspect = True
        nodes = {x["node_id"]: x["state"] for x in state.list_nodes()}
        if "DEAD" in str(nodes.get(victim_hex)):
            saw_dead = True
        time.sleep(0.05)
    assert saw_suspect, "node never surfaced as suspect"
    assert saw_dead, "node never marked dead from pulse silence"
    # Pulse silence (2.5s) beats the 10s heartbeat timeout.
    assert time.monotonic() - kill_mono < 9.0, \
        "dead transition too slow: heartbeat path won, not graftpulse"

    # The actor restarts once replacement capacity joins.
    c.add_node({"CPU": 4})
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            assert ray_tpu_torch.get(a.bump.remote(), timeout=10) >= 1
            break
        except Exception:
            time.sleep(0.5)
    else:
        pytest.fail("actor never restarted after pulse-detected death")


@pytest.mark.timeout(120)
def test_dashboard_cluster_surfaces(pulse_cluster):
    from ray_tpu_torch.dashboard import start_dashboard
    dash = start_dashboard(port=0)
    try:
        base = f"http://127.0.0.1:{dash.port}"
        # Wait for at least one pulse so totals are populated.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            t = json.load(urllib.request.urlopen(f"{base}/api/cluster",
                                                 timeout=10))
            if t["nodes"]:
                break
            time.sleep(0.2)
        assert set(t) >= {"ops", "nodes", "totals", "cluster", "window_s"}
        assert t["cluster"]["pulse_enabled"] is True
        assert t["cluster"]["nodes_alive"] >= 1
        for n in t["nodes"].values():
            assert n["health"] in ("alive", "suspect", "no-pulse")
        assert t["totals"]["num_workers"] >= 0
        # ?window=N reaches the aggregator: a 1-pulse window has no
        # span (and the handler reads its own consistent snapshot —
        # same shape, no partial dict under concurrent pulse ingest).
        t1 = json.load(urllib.request.urlopen(
            f"{base}/api/cluster?window=1", timeout=10))
        assert set(t1) == set(t)
        assert t1["window_s"] == 0.0
        text = urllib.request.urlopen(f"{base}/metrics/cluster",
                                      timeout=10).read().decode()
        assert "raytpu_cluster_store_objects" in text
        assert "raytpu_cluster_queue_depth" in text
    finally:
        dash.stop()


# ---------------------------------------------------------------------------
# RAY_TPU_TORCH_GRAFTPULSE=0 parity: everything works, no pulse plumbing
# ---------------------------------------------------------------------------

_PARITY_SCRIPT = """
import ray_tpu_torch
ray_tpu_torch.init(resources={"CPU": 2})

@ray_tpu_torch.remote
def sq(x):
    return x * x

assert ray_tpu_torch.get([sq.remote(i) for i in range(8)]) == \
    [i * i for i in range(8)]

from ray_tpu_torch import state
t = state.cluster_telemetry()
assert t["cluster"]["pulse_enabled"] is False, t["cluster"]
# No node ever pulses: all present entries are heartbeat-only.
for n in t["nodes"].values():
    assert n["health"] == "no-pulse", t["nodes"]
assert t["ops"] == {}, t["ops"]
ray_tpu_torch.shutdown()
print("PARITY-OK")
"""


@pytest.mark.timeout(120)
def test_graftpulse_disabled_subprocess_parity():
    env = dict(os.environ, RAY_TPU_TORCH_GRAFTPULSE="0", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PARITY_SCRIPT],
                         capture_output=True, text=True, timeout=180,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PARITY-OK" in out.stdout
