"""grafttrail: the state-observability plane.

The port's counterpart of tests/test_grafttrail.py: every case, with the same
inputs and assertions, on ray_tpu_torch's runtime. It imports no JAX, so
it also runs on a GPU host without it. Where a case differs, its
comment says how and why.

Covers the ledger fold (per-attempt FSM, out-of-order + terminal-sticky
batches, indexes, eviction accounting), object provenance (plane /
freed-reason / resurrect-on-reput), the conservation audit against
seeded faults (lost terminal event, leaked free event, resident miss,
grace timeout — each finding must carry id + provenance), the live
list/summary/get/audit surfaces end to end, the SIGKILL chaos gate
(node death folds to a CLEAN audit: zero lost tasks, zero leaked
objects), and subprocess parity with RAY_TPU_TORCH_GRAFTTRAIL=0.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core._native.grafttrail import TrailLedger
from ray_tpu_torch.core.cluster_utils import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

T0 = 1_700_000_000.0


def _tev(tid, attempt, state, ts, **info):
    return (tid, attempt, state, ts, info or None)


def _oev(oid, op, ts, **info):
    return (oid, op, ts, info or None)


# ---------------------------------------------------------------------------
# ledger fold: per-attempt FSM (no cluster)
# ---------------------------------------------------------------------------

def test_fsm_walk_and_legacy_derivation():
    led = TrailLedger()
    rows = [led.fold_task(_tev("t1", 0, s, T0 + i, name="f",
                               node="n1", worker="w1"))
            for i, s in enumerate(
                ("SUBMITTED", "LEASED", "RUNNING", "FINISHED"))]
    # Only the states the legacy pipeline knew about derive a row.
    assert rows[0]["event"] == "submitted" and rows[3]["event"] == \
        "finished"
    assert rows[1] is None and rows[2] is None
    row = led.list_tasks()[0]
    assert row["state"] == "FINISHED" and row["name"] == "f"
    assert row["node"] == "n1" and row["attempts"] == 1
    det = led.get_task("t1")
    assert det["attempt_chain"][0]["transitions"] == {
        "SUBMITTED": T0, "LEASED": T0 + 1, "RUNNING": T0 + 2,
        "FINISHED": T0 + 3}
    assert det["attempt_chain"][0]["worker"] == "w1"


def test_out_of_order_fold_never_regresses():
    led = TrailLedger()
    # Owner's terminal lands before the executor's RUNNING (independent
    # flush ticks): state must stay terminal, provenance must still
    # absorb.
    led.fold_task(_tev("t1", 0, "SUBMITTED", T0, name="f"))
    led.fold_task(_tev("t1", 0, "FINISHED", T0 + 3))
    led.fold_task(_tev("t1", 0, "RUNNING", T0 + 1, node="n1",
                       worker="w7"))
    row = led.list_tasks()[0]
    assert row["state"] == "FINISHED"
    det = led.get_task("t1")
    att = det["attempt_chain"][0]
    assert att["node"] == "n1" and att["worker"] == "w7"
    # LEASED arriving after RUNNING: ts kept, state not regressed.
    led.fold_task(_tev("t2", 0, "RUNNING", T0 + 2, node="n1"))
    assert led.fold_task(_tev("t2", 0, "LEASED", T0 + 1)) is None
    det2 = led.get_task("t2")
    assert det2["state"] == "RUNNING"
    assert det2["attempt_chain"][0]["transitions"]["LEASED"] == T0 + 1
    # Terminal really is sticky — a later FAILED can't flip FINISHED.
    led.fold_task(_tev("t1", 0, "FAILED", T0 + 9, err="late"))
    assert led.get_task("t1")["state"] == "FINISHED"
    # A SUBMITTED that loses the race to the executor's RUNNING (or to
    # the owner's own terminal) still owes the legacy stream its row —
    # the old pipeline appended events in arrival order.
    row = led.fold_task(_tev("t2", 0, "SUBMITTED", T0, name="g"))
    assert row and row["event"] == "submitted"
    led.fold_task(_tev("t3", 0, "RUNNING", T0 + 1, node="n1"))
    row = led.fold_task(_tev("t3", 0, "SUBMITTED", T0, name="h"))
    assert row and row["event"] == "submitted" and row["ts"] == T0
    led.fold_task(_tev("t4", 0, "FINISHED", T0 + 2))
    row = led.fold_task(_tev("t4", 0, "SUBMITTED", T0))
    assert row and row["event"] == "submitted"
    # ...but a replayed terminal stays suppressed.
    assert led.fold_task(_tev("t4", 0, "FINISHED", T0 + 3)) is None


def test_retry_attempt_chain_and_root_cause():
    led = TrailLedger()
    led.fold_task(_tev("t1", 0, "SUBMITTED", T0, name="flaky"))
    led.fold_task(_tev("t1", 0, "RUNNING", T0 + 1, node="n1"))
    led.fold_task(_tev("t1", 0, "FAILED", T0 + 2,
                       err="ValueError('boom')"))
    led.fold_task(_tev("t1", 1, "SUBMITTED", T0 + 3))
    led.fold_task(_tev("t1", 1, "RUNNING", T0 + 4, node="n2"))
    led.fold_task(_tev("t1", 1, "FINISHED", T0 + 5))
    row = led.list_tasks()[0]
    assert row["state"] == "FINISHED" and row["attempt"] == 1
    assert row["attempts"] == 2
    det = led.get_task("t1")
    chain = det["attempt_chain"]
    assert [a["attempt"] for a in chain] == [0, 1]
    assert chain[0]["state"] == "FAILED" and chain[0]["node"] == "n1"
    assert chain[1]["state"] == "FINISHED" and chain[1]["node"] == "n2"
    # The first failing attempt explains the retries.
    assert det["root_cause"] == "ValueError('boom')"


def test_index_intersection_filters():
    led = TrailLedger()
    for i in range(4):
        led.fold_task(_tev(f"a{i}", 0, "RUNNING", T0 + i, name="f",
                           node="n1"))
    led.fold_task(_tev("b0", 0, "RUNNING", T0, name="g", node="n1"))
    led.fold_task(_tev("c0", 0, "FAILED", T0, name="f", node="n2",
                       err="x"))
    led.fold_task(_tev("d0", 0, "RUNNING", T0, name="f", node="n2",
                       actor="act1"))
    assert {r["task_id"] for r in led.list_tasks(state="RUNNING",
                                                 node="n1")} == \
        {"a0", "a1", "a2", "a3", "b0"}
    assert {r["task_id"] for r in led.list_tasks(name="f",
                                                 node="n2")} == \
        {"c0", "d0"}
    assert [r["task_id"] for r in led.list_tasks(state="failed")] == \
        ["c0"]  # case-insensitive state filter
    assert [r["task_id"] for r in led.list_tasks(actor="act1")] == ["d0"]
    assert led.list_tasks(state="CANCELLED") == []
    assert len(led.list_tasks(limit=2)) == 2
    # get by unique prefix, ambiguous prefix, miss
    assert led.get_task("b")["task_id"] == "b0"
    assert led.get_task("a") is None
    assert led.get_task("zz") is None


def test_summary_rollup():
    led = TrailLedger()
    for i in range(3):
        led.fold_task(_tev(f"t{i}", 0, "FINISHED", T0, name="f"))
    led.fold_task(_tev("t3", 0, "FAILED", T0, name="f", err="x"))
    led.fold_task(_tev("t3", 1, "FINISHED", T0 + 1))
    led.fold_task(_tev("u0", 0, "RUNNING", T0, name="g"))
    s = {r["name"]: r for r in led.summary()}
    assert s["f"]["total"] == 4 and s["f"]["FINISHED"] == 4
    assert s["f"]["attempts"] == 5  # t3 took two
    assert s["g"]["RUNNING"] == 1
    assert led.summary()[0]["name"] == "f"  # sorted by volume


def test_task_eviction_prefers_settled_and_counts():
    led = TrailLedger(task_cap=3)
    led.fold_task(_tev("live0", 0, "RUNNING", T0, node="n1"))
    led.fold_task(_tev("done0", 0, "FINISHED", T0, name="f"))
    led.fold_task(_tev("live1", 0, "RUNNING", T0, node="n1"))
    led.fold_task(_tev("live2", 0, "RUNNING", T0, node="n1"))
    # The terminal record went first, not the older live ones.
    assert "done0" not in led.tasks
    assert set(led.tasks) == {"live0", "live1", "live2"}
    assert led.dropped_tasks == 1
    assert "done0" not in led.by_name.get("f", set())
    # All live: oldest drops anyway, still counted.
    led.fold_task(_tev("live3", 0, "RUNNING", T0, node="n1"))
    assert "live0" not in led.tasks and led.dropped_tasks == 2
    assert "live0" not in led.by_node["n1"]
    # A lossy ledger can't vouch for completeness.
    assert led.audit({"n1"}, now=T0 + 1)["complete"] is False


# ---------------------------------------------------------------------------
# object provenance
# ---------------------------------------------------------------------------

def test_object_lifecycle_and_resurrect():
    led = TrailLedger()
    led.fold_object(_oev("o1", "created", T0, size=1024, plane="shm",
                         node="n1"))
    assert led.list_objects()[0]["state"] == "created"
    led.fold_object(_oev("o1", "sealed", T0 + 1))
    row = led.list_objects()[0]
    assert row["state"] == "sealed" and row["size"] == 1024
    assert row["plane"] == "shm" and row["node"] == "n1"
    led.fold_object(_oev("o1", "freed", T0 + 2, reason="drop"))
    row = led.list_objects()[0]
    assert row["state"] == "freed" and row["freed_reason"] == "drop"
    # A re-put of the same oid resurrects the record.
    led.fold_object(_oev("o1", "sealed", T0 + 3, plane="copy"))
    row = led.list_objects()[0]
    assert row["state"] == "sealed" and row["freed_reason"] == ""
    assert row["plane"] == "shm"  # first-writer provenance wins
    # Seal without create backfills created_ts (fallback plane path).
    led.fold_object(_oev("o2", "sealed", T0 + 4, size=10,
                         plane="fallback", node="n2",
                         owner="127.0.0.1:1"))
    row = led.list_objects(node="n2")[0]
    assert row["created_ts"] == T0 + 4 and row["owner"] == "127.0.0.1:1"
    assert [r["object_id"] for r in led.list_objects(plane="shm")] == \
        ["o1"]
    assert [r["object_id"] for r in led.list_objects(live=True)] == \
        ["o2", "o1"]


def test_object_eviction_prefers_freed():
    led = TrailLedger(object_cap=2)
    led.fold_object(_oev("gone", "sealed", T0, node="n1"))
    led.fold_object(_oev("gone", "freed", T0 + 1))
    led.fold_object(_oev("live0", "sealed", T0, node="n1"))
    led.fold_object(_oev("live1", "sealed", T0, node="n1"))
    assert set(led.objects) == {"live0", "live1"}
    assert led.dropped_objects == 1
    assert "gone" not in led.objects_by_node["n1"]


# ---------------------------------------------------------------------------
# node-death fold + conservation audit with seeded faults
# ---------------------------------------------------------------------------

def _seed_node(led, node, ntasks=2, nobjs=2):
    for i in range(ntasks):
        led.fold_task(_tev(f"{node}-t{i}", 0, "RUNNING", T0 + i,
                           name="f", node=node))
    for i in range(nobjs):
        led.fold_object(_oev(f"{node}-o{i}", "sealed", T0 + i,
                             size=64, plane="shm", node=node))


def test_node_dead_fold_balances_the_books():
    led = TrailLedger()
    _seed_node(led, "dead1")
    _seed_node(led, "n2", ntasks=1, nobjs=1)
    folded = led.node_dead("dead1", "pulse silence", ts=T0 + 10)
    assert sorted(t for t, _ in folded["tasks_failed"]) == \
        ["dead1-t0", "dead1-t1"]
    assert sorted(folded["objects_freed"]) == ["dead1-o0", "dead1-o1"]
    for i in range(2):
        det = led.get_task(f"dead1-t{i}")
        assert det["state"] == "FAILED"
        assert "node died: pulse silence" in det["root_cause"]
        row = led.list_objects(node="dead1")[0]
        assert "node died" in row["freed_reason"]
    # Survivors untouched; the fold leaves a clean audit.
    assert led.get_task("n2-t0")["state"] == "RUNNING"
    rep = led.audit({"n2"}, residents={"n2": {"n2-o0"}}, now=T0 + 11)
    assert rep["ok"] is True and rep["complete"] is True
    assert rep["lost_tasks"] == [] and rep["leaked_objects"] == []


def test_audit_detects_seeded_lost_task():
    led = TrailLedger()
    led.fold_task(_tev("lost1", 0, "RUNNING", T0, name="f",
                       node="deadnode"))
    rep = led.audit({"n1"}, now=T0 + 1)
    assert rep["ok"] is False and len(rep["lost_tasks"]) == 1
    f = rep["lost_tasks"][0]
    # The finding carries the id AND the provenance to act on it.
    assert f["task_id"] == "lost1" and f["name"] == "f"
    assert "deadnode" in f["audit_reason"]
    assert "terminal event lost" in f["audit_reason"]
    assert f["attempt_chain"][0]["state"] == "RUNNING"


def test_audit_detects_seeded_leaked_object():
    led = TrailLedger()
    led.fold_object(_oev("leak1", "sealed", T0, size=4096, plane="shm",
                         node="deadnode"))
    rep = led.audit({"n1"}, now=T0 + 1)
    assert rep["ok"] is False and len(rep["leaked_objects"]) == 1
    f = rep["leaked_objects"][0]
    assert f["object_id"] == "leak1" and f["size"] == 4096
    assert f["plane"] == "shm" and "deadnode" in f["audit_reason"]
    assert "free event lost" in f["audit_reason"]
    # created-but-never-sealed is not a leak (seal may be in flight).
    led2 = TrailLedger()
    led2.fold_object(_oev("c1", "created", T0, node="deadnode"))
    assert led2.audit({"n1"}, now=T0 + 1)["ok"] is True


def test_audit_detects_resident_miss_and_grace_timeout():
    led = TrailLedger()
    led.fold_object(_oev("o1", "sealed", T0, node="n1"))
    led.fold_object(_oev("o2", "sealed", T0, node="n1"))
    rep = led.audit({"n1"}, residents={"n1": {"o2"}}, now=T0 + 1)
    assert [f["object_id"] for f in rep["leaked_objects"]] == ["o1"]
    assert "no longer holds it" in rep["leaked_objects"][0][
        "audit_reason"]
    # Without resident sets the same ledger audits clean (node alive).
    assert led.audit({"n1"}, now=T0 + 1)["ok"] is True
    # A task silent past the grace window is lost even on a live node.
    led.fold_task(_tev("stuck1", 0, "RUNNING", T0, name="f", node="n1"))
    rep = led.audit({"n1"}, residents={"n1": {"o1", "o2"}},
                    grace_s=60.0, now=T0 + 120)
    assert [f["task_id"] for f in rep["lost_tasks"]] == ["stuck1"]
    assert "stuck in RUNNING" in rep["lost_tasks"][0]["audit_reason"]
    # ...and within grace it is not.
    rep = led.audit({"n1"}, residents={"n1": {"o1", "o2"}},
                    grace_s=60.0, now=T0 + 30)
    assert rep["lost_tasks"] == []


def test_malformed_events_are_dropped_not_fatal():
    led = TrailLedger()
    assert led.fold_task(("t1", "notanint", "SUBMITTED")) is None
    assert led.fold_task(_tev("t1", 0, "NOT_A_STATE", T0)) is None
    led.fold_object(("o1",))  # short tuple: ignored
    assert led.stats()["tasks"] == 0 and led.stats()["objects"] == 0


# ---------------------------------------------------------------------------
# live cluster: list/summary/get/audit end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trail_cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 4})
    c.connect()
    yield c
    c.shutdown()


def test_trail_end_to_end(trail_cluster):
    from ray_tpu_torch import state

    @ray_tpu_torch.remote
    def trailed(x):
        return x + 1

    @ray_tpu_torch.remote
    def trail_boom():
        raise ValueError("trail-boom")

    assert ray_tpu_torch.get([trailed.remote(i) for i in range(5)]) == \
        list(range(1, 6))
    with pytest.raises(Exception):
        ray_tpu_torch.get(trail_boom.remote(), timeout=60)

    from ray_tpu_torch import api
    api._cw()._flush_task_events()
    deadline = time.monotonic() + 30
    fin = failed = []
    while time.monotonic() < deadline:
        fin = state.list_tasks(state="FINISHED", name="trailed",
                               limit=1000)
        failed = state.list_tasks(state="FAILED", name="trail_boom")
        if len(fin) >= 5 and failed:
            break
        time.sleep(0.25)
    assert len(fin) >= 5, state.summary_tasks()
    assert failed and "trail-boom" in failed[0]["error"]
    assert failed[0]["node"], failed[0]  # provenance: where it ran

    # get <id> resolves by prefix and exposes the attempt chain. Task
    # ids share an 8-byte per-process prefix (ids.py _fast16), so a
    # disambiguating prefix needs chars past the first 16.
    det = state.get_task(failed[0]["task_id"][:24])
    assert det and det["root_cause"] and "trail-boom" in det["root_cause"]
    chain = det["attempt_chain"][-1]
    assert "SUBMITTED" in chain["transitions"]
    assert chain["transitions"].get("RUNNING") or chain["worker"] or \
        chain["node"]

    # summary rolls up per function with per-state columns.
    s = {r["name"]: r for r in state.summary_tasks()}
    assert s["trailed"]["FINISHED"] >= 5
    assert s["trail_boom"]["FAILED"] >= 1

    # node filter uses the same hex12 ids list_nodes reports.
    node_hex = state.list_nodes()[0]["node_id"]
    assert state.list_tasks(node=node_hex, name="trailed", limit=1000)

    # Object provenance: a put past the inline threshold (100KiB) hits
    # the store -> sealed record with plane + size.
    ref = ray_tpu_torch.put(b"x" * 200_000)
    assert ray_tpu_torch.get(ref) == b"x" * 200_000
    deadline = time.monotonic() + 20
    objs = []
    while time.monotonic() < deadline:
        objs = state.list_objects(limit=1000)
        if any(o["size"] >= 200_000 and o["state"] == "sealed"
               for o in objs):
            break
        time.sleep(0.25)
    big = [o for o in objs if o["size"] >= 200_000]
    assert big and big[0]["plane"] in ("shm", "copy", "fallback")
    assert big[0]["node"]

    # Quiet cluster, every node alive: the books balance. Poll — a
    # freed event may still be riding the agent tick when we ask.
    deadline = time.monotonic() + 20
    rep = state.audit()
    while time.monotonic() < deadline and not rep["ok"]:
        time.sleep(0.5)
        rep = state.audit()
    assert rep["complete"] is True
    assert rep["ok"] is True, (rep["lost_tasks"], rep["leaked_objects"])
    assert rep["stats"]["events_folded"] > 0


def test_trail_cli_surfaces(trail_cluster):
    from ray_tpu_torch import api
    host, port = api._cw().controller_addr
    addr = f"{host}:{port}"
    env = dict(os.environ)

    def cli(*args):
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.cli", *args,
             "--address", addr],
            capture_output=True, text=True, timeout=120, env=env)
        return out

    out = cli("list", "tasks", "--state", "FINISHED", "--limit", "5")
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout)
    assert rows and all(r["state"] == "FINISHED" for r in rows)

    out = cli("summary", "tasks")
    assert out.returncode == 0, out.stderr
    assert "trailed" in out.stdout and "FINISH" in out.stdout

    out = cli("get", "task", rows[0]["task_id"])
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["attempt_chain"]

    out = cli("get", "task", "ffffffffnotatask")
    assert out.returncode == 1

    out = cli("list", "objects", "--limit", "5")
    assert out.returncode == 0, out.stderr
    assert isinstance(json.loads(out.stdout), list)

    # One-shot audit can race an in-flight free from the previous test;
    # retry briefly before judging.
    deadline = time.monotonic() + 20
    while True:
        out = cli("audit")
        if out.returncode == 0 or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "audit OK: zero lost tasks, zero leaked objects" in out.stdout


# ---------------------------------------------------------------------------
# chaos: SIGKILL a node -> the death fold leaves a CLEAN audit
# ---------------------------------------------------------------------------

@pytest.fixture()
def chaos_cluster():
    # The module-scope trail_cluster may still be connected (its
    # finalizer runs at module end); init() is a no-op while connected,
    # so drop that session first to actually join the chaos cluster.
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    from ray_tpu_torch.utils.config import GlobalConfig
    GlobalConfig.initialize({"pulse_period_ms": 200,
                             "pulse_dead_ms": 2500,
                             "health_check_period_ms": 100,
                             "trail_flush_ms": 200})
    c = Cluster(num_nodes=1, resources={"CPU": 1})
    c.connect()
    yield c
    c.shutdown()
    GlobalConfig._overrides.clear()
    GlobalConfig._cache.clear()


def _victim_hex(port):
    from ray_tpu_torch import state
    for n in state.list_nodes():
        if n["addr"].endswith(f":{port}"):
            return n["node_id"]
    return None


def test_sigkill_chaos_audit_stays_clean(chaos_cluster):
    """The acceptance gate: kill a node mid-flight and the ledger must
    still balance — the node-death fold fails every open attempt and
    frees every resident object, so `audit` reports zero lost tasks and
    zero leaked objects (not silently, but because the books closed)."""
    from ray_tpu_torch import state
    c = chaos_cluster
    victim = c.add_node({"CPU": 4})

    @ray_tpu_torch.remote(num_cpus=4, max_restarts=0, max_task_retries=0)
    class Pinned:
        def __init__(self):
            self.held = []

        def hold(self, blob):
            self.held.append(blob)
            return len(self.held)

        def spin(self, n):
            return sum(range(n))

        def make(self):
            # A return past the inline threshold: the executing worker
            # seals it into the VICTIM's store — an object the death
            # fold must free for the audit to balance.
            return b"z" * 300_000

    a = Pinned.remote()  # only the 4-CPU victim fits it
    # Park objects + finish tasks on the victim so its trail has both
    # live tasks and sealed objects when the SIGKILL lands.
    assert ray_tpu_torch.get(a.hold.remote(b"y" * 50_000), timeout=60) == 1
    assert ray_tpu_torch.get(a.spin.remote(1000), timeout=60) == 499500
    held_ref = a.make.remote()  # noqa: F841 — keep the ref alive

    victim_hex = _victim_hex(victim.port)
    assert victim_hex is not None

    # Wait until the ledger has seen work on the victim, so the kill
    # actually exercises the death fold.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if state.list_tasks(node=victim_hex, limit=1000):
            break
        time.sleep(0.2)
    else:
        pytest.fail("no trail records for the victim node")

    # In-flight call at kill time: its attempt is open on the victim.
    inflight = a.spin.remote(10**8)  # noqa: F841 — keep it in flight

    c.kill_node(victim)

    # Wait for death detection + the fold, then the audit must close.
    deadline = time.monotonic() + 60
    rep = None
    while time.monotonic() < deadline:
        nodes = {x["node_id"]: x["state"] for x in state.list_nodes()}
        if "DEAD" in str(nodes.get(victim_hex)):
            rep = state.audit()
            if rep["ok"]:
                break
        time.sleep(0.25)
    assert rep is not None, "victim never marked dead"
    assert rep["complete"] is True
    assert rep["ok"] is True, json.dumps(
        {"lost": rep["lost_tasks"], "leaked": rep["leaked_objects"]},
        indent=2, default=str)[:4000]
    assert rep["lost_tasks"] == [] and rep["leaked_objects"] == []

    # The fold left provenance behind: the object the actor sealed into
    # the victim's store was freed BY the death fold, and says so.
    gone = state.list_objects(node=victim_hex, live=False, limit=1000)
    assert any(o["freed_reason"].startswith("node died")
               for o in gone), gone[:5]
    # And every record the ledger holds for the victim is settled — the
    # node filter still resolves after death.
    for r in state.list_tasks(node=victim_hex, limit=1000):
        assert r["state"] in ("FINISHED", "FAILED", "CANCELLED"), r


# ---------------------------------------------------------------------------
# RAY_TPU_TORCH_GRAFTTRAIL=0 parity: legacy event pipeline byte-identical
# ---------------------------------------------------------------------------

_PARITY_SCRIPT = """
import time
import ray_tpu_torch
ray_tpu_torch.init(resources={"CPU": 2})

@ray_tpu_torch.remote
def sq(x):
    return x * x

assert ray_tpu_torch.get([sq.remote(i) for i in range(4)]) == \
    [i * i for i in range(4)]

from ray_tpu_torch import api, state
api._cw()._flush_task_events()
deadline = time.monotonic() + 20
while time.monotonic() < deadline:
    events = [e for e in state.list_task_events(limit=1000)
              if e["name"] == "sq"]
    if sum(1 for e in events if e["event"] == "finished") >= 4:
        break
    time.sleep(0.2)
subs = [e for e in events if e["event"] == "submitted"]
fins = [e for e in events if e["event"] == "finished"]
assert len(subs) >= 4 and len(fins) >= 4, events
# The legacy dict shape is untouched: trace/span/owner all present.
for e in subs:
    assert e["trace_id"] and e["owner"] and "parent_span" in e, e
# Off means off: no LEASED/RUNNING rows sneak into the legacy stream.
assert all(e["event"] in ("submitted", "finished", "failed")
           for e in events), events
trace = state.timeline()
assert [s for s in trace if s["name"] == "sq" and s["ph"] == "X"]
ray_tpu_torch.shutdown()
print("PARITY-OK")
"""


def test_grafttrail_disabled_subprocess_parity():
    env = dict(os.environ, RAY_TPU_TORCH_GRAFTTRAIL="0")
    out = subprocess.run([sys.executable, "-c", _PARITY_SCRIPT],
                         capture_output=True, text=True, timeout=180,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PARITY-OK" in out.stdout
