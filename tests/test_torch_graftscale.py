"""The port's scale harness (``ray_tpu_torch.scale``) and its graftmeta
plane: the cases of ``tests/test_graftscale.py`` with the same inputs and
assertions on the port's runtime — the meta plane as a unit, the stores'
cardinality bounds, the live surfaces (``/api/meta``, the
``raytpu_meta_*`` gauges, ``status --planes``) and the harness against a
real controller subprocess (``ray_tpu_torch.core.controller``): a ramp of
8 and 16 simulated nodes, two SIGKILLed, every verdict machine-checked.
"""

import json
import logging
import time
import urllib.request

import pytest

from ray_tpu_torch.core._native import graftmeta
from ray_tpu_torch.core._native.graftlog import LogStore, ShardedLogStore
from ray_tpu_torch.core._native.graftprof import ProfStore, ShardedProfStore
from ray_tpu_torch.core._native.grafttrail import TrailLedger
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.load.verdict import passed
from ray_tpu_torch.scale import ScaleSpec, run_scale


# ---------------------------------------------------------------------------
# MetaPlane unit: the meter itself
# ---------------------------------------------------------------------------

def test_meta_bucket_geometry():
    from ray_tpu_torch.core._native.graftpulse import (PULSE_HIST_BUCKETS,
                                                 PULSE_HIST_SHIFT)
    assert graftmeta._bucket(0) == 0
    assert graftmeta._bucket(1) == 0
    # Bucket b covers [2^(SHIFT+b), 2^(SHIFT+b+1)).
    assert graftmeta._bucket(1 << PULSE_HIST_SHIFT) == 0
    assert graftmeta._bucket(1 << (PULSE_HIST_SHIFT + 1)) == 1
    assert graftmeta._bucket(1 << 60) == PULSE_HIST_BUCKETS - 1
    prev = 0
    for ns in (10, 1_000, 100_000, 10_000_000, 1_000_000_000):
        b = graftmeta._bucket(ns)
        assert b >= prev
        prev = b


def test_meta_plane_windowed_snapshot():
    m = graftmeta.MetaPlane(history=10)
    # First tick is the window base; everything noted after it is rated.
    m.tick(rss_bytes=100 << 20)
    t0 = time.monotonic()
    for _ in range(10):
        m.note("pulse", records=19, nbytes=1700, dur_ns=50_000)
    m.note("log", records=3, nbytes=300, dur_ns=2_000_000)
    m.drop("log", 2)
    m.loop_lag(1_000_000)
    m.loop_lag(9_000_000)
    while time.monotonic() - t0 < 0.05:
        time.sleep(0.01)
    m.tick(rss_bytes=101 << 20)
    snap = m.snapshot(window=10, stores={"log": {"records": 3}})

    pulse = snap["planes"]["pulse"]
    assert pulse["records"] == 190
    assert pulse["batches"] == 10
    assert pulse["records_per_s"] > 0
    assert pulse["bytes_per_s"] > 0
    # All ten folds took 50us: p50 and p99 land in the same log2 bucket.
    assert pulse["fold_p50_ns"] == pulse["fold_p99_ns"] > 0

    log = snap["planes"]["log"]
    assert log["drops"] == 2
    # The 2ms fold dominates: p99 lands in its log2 bucket [2^20, 2^21)
    # (percentiles interpolate inside the bucket, so compare to its
    # lower bound, not the exact duration).
    assert log["fold_p99_ns"] >= 1 << 20

    lag = snap["loop_lag"]
    assert lag["samples"] == 2
    assert lag["max_ns"] == 9_000_000
    assert lag["p99_ns"] >= lag["p50_ns"] > 0

    assert snap["rss_bytes"] == 101 << 20
    assert snap["ticks"] == 2
    assert snap["window_s"] > 0
    assert snap["stores"] == {"log": {"records": 3}}
    # Untouched planes still present (display-order contract).
    assert set(snap["planes"]) == set(graftmeta.PLANES)

    series = m.rss_series()
    assert len(series) == 2 and series[0][1] == 100 << 20


# ---------------------------------------------------------------------------
# Cardinality: eviction fairness + bounded indexes (what the harness found)
# ---------------------------------------------------------------------------

def _log_rec(pid, level, msg, seq=0):
    return {"pid": pid, "level": level, "source": 1, "seq": seq,
            "t_ns": time.time_ns(), "task": "", "actor": "", "msg": msg}


def test_logstore_sub_warning_evicted_first():
    s = LogStore(cap=100, rate_per_s=1e9, dedup_window_s=0.0)
    s.ingest_batch("aaa", [_log_rec(1, logging.WARNING, f"w{i}")
                           for i in range(80)])
    s.ingest_batch("bbb", [_log_rec(2, logging.INFO, f"i{i}")
                           for i in range(40)])
    st = s.stats()
    assert st["records"] == 100 and st["evicted"] == 20
    # Routine chatter went first; every WARNING survived.
    assert st["by_level"]["WARNING"] == 80
    assert st["by_level"]["INFO"] == 20


def test_logstore_eviction_fairness_across_256_nodes():
    """One node's WARNING storm must reclaim its own space, not roll
    255 other nodes' errors out of the store."""
    s = LogStore(cap=400, rate_per_s=1e9, dedup_window_s=0.0)
    quiet = [f"node{i:03d}" for i in range(255)]
    for n in quiet:
        s.ingest_batch(n, [_log_rec(7, logging.ERROR, f"err from {n}")])
    s.ingest_batch("noisy", [_log_rec(9, logging.WARNING, f"storm {i}")
                             for i in range(400)])
    st = s.stats()
    assert st["records"] == 400 and st["evicted"] == 255
    # Every quiet node's single ERROR row survived the storm...
    errors = s.list(level=logging.ERROR, limit=1000)
    assert len(errors) == 255
    assert {r["node"] for r in errors} == set(quiet)
    # ...and all evictions came out of the noisy node's own rows.
    assert len(s.list(node="noisy", limit=1000)) == 400 - 255


def test_sharded_logstore_parity_and_merge_order():
    sh = ShardedLogStore(shards=4, cap=4000, rate_per_s=1e9,
                         dedup_window_s=0.0)
    msgs = []
    for i in range(300):
        node = f"node{i % 32:03d}"
        msg = f"m{i}"
        sh.ingest_batch(node, [_log_rec(100 + i % 32, logging.INFO, msg)])
        msgs.append(msg)
    st = sh.stats()
    assert st["shards"] == 4
    assert st["records"] == 300 == sum(st["shard_records"])
    assert st["nodes"] == 32
    # Merged list is globally id-ordered == ingest order (the shared
    # allocator invariant), even though rows live in four stores.
    rows = sh.list(limit=1000)
    ids = [r["id"] for r in rows]
    assert ids == sorted(ids) and len(set(ids)) == 300
    assert [r["msg"] for r in rows] == msgs
    # The default tail semantics survive the merge.
    assert [r["msg"] for r in sh.list(limit=10)] == msgs[-10:]
    # A node filter pins one shard and still returns only that node.
    one = sh.list(node="node005", limit=1000)
    assert one and all(r["node"] == "node005" for r in one)


def _prof_payload(task, samples):
    return {"pid": 4321, "hz": 29,
            "frames": ["worker.py:loop", "model.py:step"],
            "stacks": [(task, "", "train", [0, 1], samples)],
            "tasks": [(task, "", "train", samples,
                       samples * 1_000_000, samples * 100_000)],
            "threads": [("reactor", 5_000_000)]}


def test_sharded_profstore_merges_cross_shard_task():
    sp = ShardedProfStore(shards=4)
    # Two nodes that land in different shards (attempts of one task
    # ran on both — task_stats must sum the partial profiles back).
    a, b = "nodeaa", None
    for i in range(64):
        cand = f"node{i:02d}"
        if sp._shard(cand) is not sp._shard(a):
            b = cand
            break
    assert b is not None
    sp.ingest(a, _prof_payload("task_x", 10))
    sp.ingest(b, _prof_payload("task_x", 30))
    st = sp.stats()
    assert st["shards"] == 4 and st["nodes"] == 2 and st["ingested"] == 2
    ts = sp.task_stats("task_x")
    assert ts["samples"] == 40
    assert ts["oncpu_ns"] == 40 * 1_000_000
    top = sp.top()
    assert top["total_samples"] == 40
    # Query parity with the singleton store over the same ingest.
    single = ProfStore()
    single.ingest(a, _prof_payload("task_x", 10))
    single.ingest(b, _prof_payload("task_x", 30))
    assert sp.flame() == single.flame()
    assert sorted(sp.collapsed()) == sorted(single.collapsed())
    assert top["rows"] == single.top()["rows"]
    assert top["native_threads"] == single.top()["native_threads"]


def test_trail_index_bounded_under_churn():
    led = TrailLedger(task_cap=300, object_cap=300)
    now = time.time()
    for i in range(3000):
        tid = f"t{i:05d}"
        node = f"node{i % 64:03d}"
        led.fold_task((tid, 0, "SUBMITTED", now,
                       {"name": "churn", "node": node}))
        led.fold_task((tid, 0, "RUNNING", now, {"node": node}))
        led.fold_task((tid, 0, "FINISHED", now, {"node": node}))
        oid = f"o{i:05d}"
        led.fold_object((oid, "created", now, {"node": node, "size": 64}))
        led.fold_object((oid, "sealed", now, {"node": node}))
        led.fold_object((oid, "freed", now, {"node": node}))
    st = led.stats()
    assert st["tasks"] <= 300 and st["objects"] <= 300
    assert st["dropped_tasks"] == 3000 - st["tasks"]
    assert st["dropped_objects"] == 3000 - st["objects"]
    assert st["events_folded"] == 3000 * 6
    # Secondary indexes shed evicted ids — bounded by the caps, never
    # by the churn volume.
    assert sum(len(v) for v in led.by_state.values()) == st["tasks"]
    assert sum(len(v) for v in led.by_node.values()) <= st["tasks"]
    assert sum(len(v) for v in led.by_name.values()) <= st["tasks"]
    assert len(led.by_node) <= 64
    # The audit stays honest about what it can vouch for.
    assert led.audit(alive_nodes=set())["complete"] is False


# ---------------------------------------------------------------------------
# Live surfaces: /api/meta, raytpu_meta_* gauges, status --planes
# ---------------------------------------------------------------------------

@pytest.fixture()
def meta_cluster():
    from ray_tpu_torch.utils.config import GlobalConfig
    GlobalConfig.initialize({"meta_tick_ms": 200,
                             "pulse_period_ms": 200,
                             "health_check_period_ms": 100})
    c = Cluster(num_nodes=1, resources={"CPU": 1})
    c.connect()
    yield c
    c.shutdown()
    GlobalConfig._overrides.clear()
    GlobalConfig._cache.clear()


@pytest.mark.timeout(120)
def test_meta_surfaces(meta_cluster, capsys):
    from ray_tpu_torch import state
    from ray_tpu_torch.dashboard import start_dashboard

    # Wait until the meter has ticked and folded at least one pulse.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        snap = state.meta_snapshot(window=20)
        if snap.get("ticks", 0) >= 2 and \
                snap["planes"]["pulse"]["records"] > 0:
            break
        time.sleep(0.2)
    assert snap["planes"]["pulse"]["records"] > 0
    assert set(snap["planes"]) == set(graftmeta.PLANES)
    assert snap["rss_bytes"] > 0
    assert snap["loop_lag"]["samples"] > 0
    stores = snap["stores"]
    assert {"pulse", "trail", "prof", "log", "scope"} <= set(stores)
    assert stores["log"]["cap"] > 0

    dash = start_dashboard(port=0)
    try:
        base = f"http://127.0.0.1:{dash.port}"
        m = json.load(urllib.request.urlopen(f"{base}/api/meta",
                                             timeout=10))
        assert set(m["planes"]) == set(graftmeta.PLANES)
        assert m["planes"]["pulse"]["records"] > 0
        m1 = json.load(urllib.request.urlopen(
            f"{base}/api/meta?window=2", timeout=10))
        assert set(m1) == set(m)
        text = urllib.request.urlopen(f"{base}/metrics/cluster",
                                      timeout=10).read().decode()
        assert "raytpu_meta_rss_bytes" in text
        assert "raytpu_meta_loop_lag_p99_ns" in text
        assert 'raytpu_meta_records_per_s{plane="pulse"}' in text
        assert 'raytpu_meta_fold_p99_ns{plane="pulse"}' in text
    finally:
        dash.stop()

    # `ray_tpu_torch status --planes` renders the same snapshot.
    from ray_tpu_torch import cli
    assert cli._status_planes() == 0
    out = capsys.readouterr().out
    assert "controller" in out and "loop lag" in out
    for plane in ("pulse", "trail", "prof", "log"):
        assert plane in out
    assert "store occupancy:" in out


# ---------------------------------------------------------------------------
# The harness itself, end to end against a real controller subprocess
# ---------------------------------------------------------------------------

_FAST_CADENCE = {"pulse_period_ms": 500, "pulse_dead_ms": 3000,
                 "health_check_period_ms": 100, "meta_tick_ms": 250}


@pytest.mark.timeout(120)
def test_harness_reports_meta_disabled():
    spec = ScaleSpec(levels=(2,), hold_s=1.0, tick_s=0.5,
                     env={"graftmeta": "0", **_FAST_CADENCE})
    rows = run_scale(spec)
    # With the meter off the harness still runs; the level rows just
    # carry no fold percentiles (snapshot says disabled).
    levels = [r for r in rows if r["row"] == "level"]
    assert levels and levels[-1]["alive"] == 2
    assert levels[-1]["pulse_fold_p99_us"] == 0


@pytest.mark.timeout(160)
def test_scale_harness_ramp_kill_and_verdicts():
    """The bench ramp in miniature: ramp 8 -> 16 sim nodes
    (one of them speaking pulse v1), SIGKILL two, and machine-check
    every verdict the full bench asserts at 256."""
    spec = ScaleSpec(levels=(8, 16), hold_s=3.0, tick_s=0.5,
                     seed=42, kill_nodes=2, v1_nodes=1,
                     env=dict(_FAST_CADENCE))
    rows = run_scale(spec)
    by_check = {r["check"]: r for r in rows if r["row"] == "verdict"}
    levels = [r for r in rows if r["row"] == "level"]

    assert [r["nodes"] for r in levels] == [8, 16]
    # Every sim node registered distinctly and stayed alive through the
    # ramp — the v1 node degrades its own row, not its liveness.
    assert [r["alive"] for r in levels] == [8, 16]
    assert levels[-1]["pulse_records_per_s"] > 0
    assert levels[-1]["rss_bytes"] > 0

    assert by_check["pulse_fold_p99_bounded"]["ok"], by_check
    assert by_check["loop_lag_bounded"]["ok"], by_check
    assert by_check["no_unintended_deaths"]["ok"], by_check
    assert by_check["rss_per_node_bounded"]["ok"], by_check

    # The SIGKILL story: deaths detected by the cadence FSM, the
    # controller's own meter shows the ingest drop, and the trail audit
    # comes back clean (the node-death fold settled the open attempts).
    assert by_check["kill_detected"]["ok"], by_check
    assert by_check["kill_detected"]["detect_s"] < 30
    assert by_check["meta_ingest_drop"]["ok"], by_check
    assert by_check["audit_clean_after_kill"]["ok"], by_check
    assert by_check["audit_clean_after_kill"]["leaked_objects"] == 0

    # Per-plane ingest-ceiling rows exist for every plane that folded.
    plane_rows = {r["plane"] for r in rows if r["row"] == "plane"}
    assert {"pulse", "trail", "log", "prof"} <= plane_rows

    meta = [r for r in rows if r["row"] == "meta"][-1]
    assert meta["max_nodes_sustained"] == 16
    assert meta["passed"] is True
    assert passed(rows)
