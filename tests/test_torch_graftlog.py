"""graftlog: the crash-persistent cluster log plane.

The port's counterpart of tests/test_graftlog.py: every case, with the same
inputs and assertions, on ray_tpu_torch's runtime. It imports no JAX, so
it also runs on a GPU host without it. Where a case differs, its
comment says how and why.

Covers the per-process MAP_SHARED ring (roundtrip, truncation,
wraparound under a storm, salvage decode of a dead writer's file),
emit-side task attribution through the graftprof registry, the
controller LogStore (dedup, rate caps, severity-aware eviction, the
follow cursor, salvage/live-tail overlap), the driver log pump
(coalesced batches must not lose lines), the CLI/state surfaces, the
end-to-end SIGKILL forensics path (a dead worker's final lines land in
`get task` as the root cause), and RAY_TPU_TORCH_GRAFTLOG=0 parity.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core._native import graftlog
from ray_tpu_torch.core._native.graftlog import LogRec, LogStore, RingReader
from ray_tpu_torch.core.cluster_utils import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# in-process: ring roundtrip, truncation, wraparound, salvage
# ---------------------------------------------------------------------------

@pytest.fixture()
def ring(tmp_path):
    """This process's ring parked in a throwaway store dir. Works in
    both writer modes (native lib or the pure-Python mmap fallback)."""
    assert graftlog.open_ring(str(tmp_path))
    yield str(tmp_path)
    graftlog.close_ring()


def test_ring_roundtrip_and_truncation(ring):
    long = "x" * 300
    s1 = graftlog.emit(logging.INFO, graftlog.LOG_SRC_LOGGER, "hello",
                       task="ab" * 16, actor="cd" * 6)
    s2 = graftlog.emit(logging.ERROR, graftlog.LOG_SRC_STDERR, long,
                       task="", actor="")
    assert s2 == s1 + 1 > 0
    rd = RingReader(graftlog.ring_path(ring, os.getpid()))
    recs = rd.poll()
    assert [r.seq for r in recs] == [s1, s2]
    r1, r2 = recs
    assert (r1.level, r1.source, r1.msg) == \
        (logging.INFO, graftlog.LOG_SRC_LOGGER, "hello")
    assert r1.task == "ab" * 16 and r1.actor == "cd" * 6
    assert r1.line_len == 5
    # Oversized line: payload truncates at the cap, line_len keeps the
    # true length so the reader can say "... (300 bytes)".
    assert r2.line_len == 300
    assert r2.msg == "x" * graftlog.LOG_MSG_CAP
    assert abs(r1.t_ns - time.time_ns()) < 60 * 10**9
    # The cursor advanced: nothing to re-read.
    assert rd.poll() == []


def test_ring_wraparound_storm(ring):
    n = 2 * graftlog.LOG_RING_SLOTS + 50
    for i in range(n):
        graftlog.emit(logging.INFO, graftlog.LOG_SRC_STDOUT, f"line-{i}")
    rd = RingReader(graftlog.ring_path(ring, os.getpid()))
    recs = []
    while True:
        got = rd.poll(max_records=1024)
        if not got:
            break
        recs.extend(got)
    # A late reader keeps exactly the freshest window; everything it
    # missed is accounted, not silently gone.
    assert len(recs) == graftlog.LOG_RING_SLOTS
    assert rd.dropped == n - graftlog.LOG_RING_SLOTS
    assert recs[-1].msg == f"line-{n - 1}"
    seqs = [r.seq for r in recs]
    assert seqs == list(range(n - graftlog.LOG_RING_SLOTS + 1, n + 1))


def test_emit_attributes_from_graftprof_context(ring):
    from ray_tpu_torch.core._native import graftprof
    graftprof.set_task_context("77" * 16, "99" * 6, "attributed")
    try:
        graftlog.emit(logging.WARNING, graftlog.LOG_SRC_LOGGER, "tagged")
    finally:
        graftprof.clear_task_context()
    graftlog.emit(logging.WARNING, graftlog.LOG_SRC_LOGGER, "untagged")
    rd = RingReader(graftlog.ring_path(ring, os.getpid()))
    tagged, untagged = rd.poll()
    assert tagged.task == "77" * 16 and tagged.actor == "99" * 6
    assert untagged.task == "" and untagged.actor == ""


def test_logging_handler_routes_records(ring):
    lg = logging.getLogger("graftlog-test-logger")
    lg.setLevel(logging.DEBUG)
    h = graftlog.GraftlogHandler()
    lg.addHandler(h)
    try:
        lg.error("boom %d", 42)
    finally:
        lg.removeHandler(h)
    rd = RingReader(graftlog.ring_path(ring, os.getpid()))
    recs = [r for r in rd.poll() if r.msg == "boom 42"]
    assert recs and recs[0].level == logging.ERROR
    assert recs[0].source == graftlog.LOG_SRC_LOGGER


def test_salvage_ring_reads_dead_writers_tail(ring):
    for i in range(30):
        graftlog.emit(logging.INFO, graftlog.LOG_SRC_STDOUT, f"final-{i}")
    path = graftlog.ring_path(ring, os.getpid())
    graftlog.close_ring()  # the writer is gone; the FILE stays
    meta, recs = graftlog.salvage_ring(path, tail=10)
    assert meta["pid"] == os.getpid()
    assert meta["emitted"] >= 30
    assert len(recs) == 10
    assert recs[-1].msg == "final-29"
    # Garbage in, nothing out: salvage must not throw on junk files.
    junk = os.path.join(ring, "logring-99999")
    with open(junk, "wb") as f:
        f.write(b"not a ring at all")
    assert graftlog.salvage_ring(junk) == ({}, [])


def test_ring_reader_survives_writer_reopen(ring):
    graftlog.emit(logging.INFO, graftlog.LOG_SRC_STDOUT, "old-1")
    graftlog.emit(logging.INFO, graftlog.LOG_SRC_STDOUT, "old-2")
    rd = RingReader(graftlog.ring_path(ring, os.getpid()))
    assert [r.msg for r in rd.poll()] == ["old-1", "old-2"]
    # Re-open truncates the file and resets head; the reader's stale
    # cursor must snap back instead of waiting for head to catch up.
    assert graftlog.open_ring(ring)
    graftlog.emit(logging.INFO, graftlog.LOG_SRC_STDOUT, "new-1")
    assert [r.msg for r in rd.poll()] == ["new-1"]


# ---------------------------------------------------------------------------
# controller-side LogStore: dedup, rate caps, eviction, follow cursor
# ---------------------------------------------------------------------------

def _rec(msg, pid=7, level=logging.INFO, seq=0, task="", actor="",
         t_ns=None, source=0):
    return {"pid": pid, "level": level, "source": source, "seq": seq,
            "t_ns": t_ns if t_ns is not None else time.time_ns(),
            "task": task, "actor": actor, "msg": msg,
            "line_len": len(msg)}


def test_logstore_dedup_collapses_error_storms():
    st = LogStore(rate_per_s=10_000)
    st.ingest_batch("node-a", [_rec("same failure") for _ in range(10)])
    rows = st.list()
    assert len(rows) == 1
    assert rows[0]["repeats"] == 9
    assert st.deduped == 9
    # A different pid is a different storm.
    st.ingest_batch("node-a", [_rec("same failure", pid=8)])
    assert len(st.list()) == 2


def test_logstore_rate_cap_suppresses_floods():
    st = LogStore(rate_per_s=5.0, dedup_window_s=0.0)
    st.ingest_batch("node-a", [_rec(f"flood-{i}") for i in range(100)])
    s = st.stats()
    # Burst allowance is 2x the rate; the rest is suppressed but
    # counted — the operator sees "90 suppressed", not silence.
    assert s["records"] <= 11
    assert s["suppressed"] >= 89
    # Salvage is the forensics payload: it bypasses the cap entirely.
    st.ingest_batch("node-a", [_rec(f"last-words-{i}") for i in range(50)],
                    salvaged=True)
    assert st.stats()["salvaged"] == 50


def test_logstore_eviction_prefers_routine_chatter():
    st = LogStore(cap=100, rate_per_s=100_000, dedup_window_s=0.0)
    st.ingest_batch("n", [_rec(f"err-{i}", level=logging.ERROR)
                          for i in range(60)])
    st.ingest_batch("n", [_rec(f"info-{i}") for i in range(100)])
    rows = st.list(limit=1000)
    assert len(rows) == 100
    # Every ERROR survived; the oldest INFO rows paid for the overflow.
    assert sum(r["level"] >= logging.ERROR for r in rows) == 60
    assert st.evicted == 60
    assert not any(r["msg"] == "info-0" for r in rows)


def test_logstore_filters_and_follow_cursor():
    st = LogStore(rate_per_s=100_000, dedup_window_s=0.0)
    t1, t2 = "aa" * 16, "bb" * 16
    st.ingest_batch("node-a", [_rec("a-info", task=t1),
                               _rec("a-warn", task=t1,
                                    level=logging.WARNING)])
    st.ingest_batch("node-b", [_rec("b-info", task=t2, actor="cc" * 6)])
    # Prefix match on task/actor, exact on node, >= on level.
    assert [r["msg"] for r in st.list(task="aa")] == ["a-info", "a-warn"]
    assert [r["msg"] for r in st.list(actor="cc")] == ["b-info"]
    assert [r["msg"] for r in st.list(node="node-b")] == ["b-info"]
    assert [r["msg"] for r in st.list(level=logging.WARNING)] == ["a-warn"]
    # Follow cursor: only rows newer than after_id come back.
    last = st.list(limit=1000)[-1]["id"]
    assert st.list(after_id=last) == []
    st.ingest_batch("node-a", [_rec("fresh", task=t1)])
    new = st.list(after_id=last)
    assert [r["msg"] for r in new] == ["fresh"]
    assert new[0]["id"] > last


def test_logstore_seq_highwater_drops_salvage_overlap():
    st = LogStore(rate_per_s=100_000, dedup_window_s=0.0)
    # The live tail shipped seq 1..3 before the worker died...
    st.ingest_batch("n", [_rec(f"live-{i}", seq=i) for i in (1, 2, 3)])
    # ...then salvage re-reads the whole ring, overlapping those slots.
    st.ingest_batch("n", [_rec(f"salv-{i}", seq=i) for i in (2, 3, 4, 5)],
                    salvaged=True)
    msgs = [r["msg"] for r in st.list(limit=100)]
    assert msgs == ["live-1", "live-2", "live-3", "salv-4", "salv-5"]


# ---------------------------------------------------------------------------
# CLI plumbing (no cluster): level parsing + row formatting
# ---------------------------------------------------------------------------

def test_cli_level_parse_and_row_format():
    from ray_tpu_torch import cli
    assert cli._parse_level("WARNING") == logging.WARNING
    assert cli._parse_level("warning") == logging.WARNING
    assert cli._parse_level("30") == 30
    assert cli._parse_level("") == 0
    assert cli._parse_level("nonsense") == 0
    line = cli._fmt_log_row({
        "id": 1, "t_ns": time.time_ns(), "level": logging.ERROR,
        "source": 2, "pid": 1234, "node": "abcdef123456",
        "task": "99" * 16, "actor": "", "msg": "it broke",
        "line_len": 8, "repeats": 2, "salvaged": True})
    assert "E [err]" in line and "pid=1234" in line
    assert "task=99999999" in line
    assert "[salvaged]" in line and "it broke (x3)" in line


# ---------------------------------------------------------------------------
# live cluster: pump delivery, query surfaces, SIGKILL forensics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def log_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    from ray_tpu_torch.utils.config import GlobalConfig
    GlobalConfig.initialize({"log_flush_ms": 200, "trail_flush_ms": 200})
    c = Cluster(num_nodes=1, resources={"CPU": 2})
    c.connect()
    yield c
    c.shutdown()
    GlobalConfig._overrides.clear()
    GlobalConfig._cache.clear()


def _controller_addr():
    from ray_tpu_torch import api
    host, port = api._cw().controller_addr
    return f"{host}:{port}"


def test_worker_logs_reach_the_store(log_cluster):
    from ray_tpu_torch import state

    @ray_tpu_torch.remote
    def talker(i):
        print(f"stdout-line-{i}")
        logging.getLogger("ray_tpu_torch.user").warning("user-warning-%d", i)
        return i

    assert ray_tpu_torch.get([talker.remote(i) for i in range(2)]) == [0, 1]

    deadline = time.monotonic() + 30
    rows = []
    while time.monotonic() < deadline:
        rows = state.list_logs(limit=1000)
        msgs = [r["msg"] for r in rows]
        if any("stdout-line-0" in m for m in msgs) and \
                any("user-warning-1" in m for m in msgs):
            break
        time.sleep(0.25)
    msgs = [r["msg"] for r in rows]
    assert any("stdout-line-0" in m for m in msgs), msgs[-30:]
    assert any("user-warning-1" in m for m in msgs), msgs[-30:]

    # Attribution rode the emit path: the stdout line carries the
    # task's id, and the level/source survived the trip.
    out = [r for r in rows if "stdout-line-" in r["msg"]]
    assert all(len(r["task"]) == 32 for r in out), out
    assert all(r["source"] == graftlog.LOG_SRC_STDOUT for r in out)
    warn = [r for r in rows if "user-warning-" in r["msg"]]
    assert all(r["level"] == logging.WARNING for r in warn)
    assert all(r["source"] == graftlog.LOG_SRC_LOGGER for r in warn)

    # Level filter excludes the stdout chatter (INFO).
    lv = state.list_logs(level=logging.WARNING, limit=1000)
    assert all(r["level"] >= logging.WARNING for r in lv)
    # Task filter by prefix finds exactly that task's lines.
    tid = out[0]["task"]
    only = state.list_logs(task=tid[:12], limit=1000)
    assert only and all(r["task"].startswith(tid[:12]) for r in only)

    s = state.log_stats()
    assert s["ingested"] >= 4 and s["nodes"] >= 1


def test_driver_pump_delivers_rapid_burst(log_cluster, capfd):
    """Satellite check on the coalescing pump: a burst of lines printed
    faster than any per-line RPC could ship must still arrive complete,
    including the very last line (the trailing-flush path)."""

    from ray_tpu_torch import api

    @ray_tpu_torch.remote
    def burst(n):
        for i in range(n):
            print(f"burst-line-{i:03d}")
        return n

    # capfd.readouterr() reads its capture file, then truncates it: a
    # line the driver prints between the two is lost to the test (not
    # to the pump). So wait until the driver's log subscription has
    # handled the 200 events (its cursor moves after each batch is
    # printed) before reading; the reference reads while it prints.
    sub = api._cw()._log_sub
    deadline = time.monotonic() + 30
    while sub.next_seq < 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    start = sub.next_seq
    assert ray_tpu_torch.get(burst.remote(200)) == 200
    while sub.next_seq - start < 200 and time.monotonic() < deadline:
        time.sleep(0.1)
    deadline = time.monotonic() + 30
    seen = ""
    while time.monotonic() < deadline:
        seen += capfd.readouterr().out
        if "burst-line-199" in seen:
            break
        time.sleep(0.25)
    missing = [i for i in range(200)
               if f"burst-line-{i:03d}" not in seen]
    assert missing == [], f"pump lost {len(missing)} lines: {missing[:10]}"


def test_sigkill_forensics_end_to_end(log_cluster):
    """The acceptance demo: a worker SIGKILLs itself mid-task (model:
    the OOM killer). Its final printed lines must be queryable by task
    id and must surface as the root cause in `get task` — postmortem
    without a core dump."""
    from ray_tpu_torch import state

    @ray_tpu_torch.remote(max_task_retries=0)
    def die_loud(gun):
        print("about to touch the bad page")
        print(gun)
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # never reached

    # Two races can leave a demo with no salvaged row, and the reference
    # runs it once. (1) The agent's 200 ms live tail may read the ring
    # between the print and the death; the salvage's seq high-water then
    # drops the overlap. (2) The store's per-process rate cap (200 lines/s)
    # may still be drained by what this worker printed just before (the
    # previous case's 200-line burst): the live copy is suppressed, yet
    # its seq still raises the high-water, so the salvage drops it too.
    # So each demo starts 2 s after the last (the tail ships, the cap
    # refills), and a demo with no salvaged row in 15 s is followed by
    # another with a fresh marker, up to 5.
    for attempt in range(5):
        time.sleep(2.0)
        gun_line = f"THE-SMOKING-GUN-{attempt}"
        ref = die_loud.remote(gun_line)
        with pytest.raises(Exception):
            ray_tpu_torch.get(ref, timeout=90)

        # The agent salvages the dead ring on the death path; poll until
        # the salvaged rows land in the store.
        deadline = time.monotonic() + 15
        gun = []
        while time.monotonic() < deadline:
            rows = state.list_logs(limit=2000)
            gun = [r for r in rows if r["msg"] == gun_line]
            if gun and any(r["salvaged"] for r in gun):
                break
            time.sleep(0.3)
        if any(r["salvaged"] for r in gun):
            break
    assert gun, "dead worker's final lines never salvaged"
    salv = [r for r in gun if r["salvaged"]]
    assert salv, gun
    tid = salv[0]["task"]
    assert len(tid) == 32

    # Queryable by task id — the `ray_tpu logs --task <id>` path.
    by_task = state.list_logs(task=tid, limit=100)
    assert any(r["msg"] == gun_line for r in by_task), by_task

    # And joined into the ledger: `get task` shows the tail as the
    # attempt's last words, promoted into root_cause.
    detail = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        detail = state.get_task(tid)
        if detail and detail.get("log_tail"):
            break
        time.sleep(0.3)
    assert detail, f"no trail record for {tid}"
    assert any(gun_line in ln for ln in detail["log_tail"]), \
        detail["log_tail"]
    assert detail["root_cause"], detail

    # The CLI surface over the same store, via a real subprocess.
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "logs",
         "--address", _controller_addr(), "--task", tid],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert gun_line in out.stdout
    assert "[salvaged]" in out.stdout
    # `get task` through the CLI shows the same forensics.
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "get", "task", tid,
         "--address", _controller_addr()],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert gun_line in out.stdout


def test_follow_cursor_streams_new_rows_only(log_cluster):
    from ray_tpu_torch import state
    rows = state.list_logs(limit=2000)
    last = rows[-1]["id"] if rows else 0

    @ray_tpu_torch.remote
    def one_more():
        print("follow-me-now")
        return 1

    assert ray_tpu_torch.get(one_more.remote()) == 1
    deadline = time.monotonic() + 30
    new = []
    while time.monotonic() < deadline:
        new = state.list_logs(after_id=last, limit=1000)
        if any(r["msg"] == "follow-me-now" for r in new):
            break
        time.sleep(0.25)
    assert any(r["msg"] == "follow-me-now" for r in new), new[-10:]
    assert all(r["id"] > last for r in new)


def test_dashboard_api_logs(log_cluster):
    import urllib.request

    from ray_tpu_torch.dashboard import Dashboard
    d = Dashboard()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.port}/api/logs?tail=5") as r:
            rows = json.loads(r.read())
        assert isinstance(rows, list) and len(rows) <= 5
        assert all("msg" in row and "level" in row for row in rows)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.port}/api/logs?stats=1") as r:
            s = json.loads(r.read())
        assert s["ingested"] >= 1
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# RAY_TPU_TORCH_GRAFTLOG=0 parity: everything works, no log plumbing
# ---------------------------------------------------------------------------

_PARITY_SCRIPT = """
import time
import ray_tpu_torch
from ray_tpu_torch.core._native import graftlog

assert graftlog.enabled() is False
ray_tpu_torch.init(resources={"CPU": 2})
assert graftlog.ring_file() is None

@ray_tpu_torch.remote
def shout(i):
    print("disabled-but-printing-%d" % i)
    return i * i

assert ray_tpu_torch.get([shout.remote(i) for i in range(3)]) == [0, 1, 4]

time.sleep(2)  # a few flush ticks: nothing may arrive
from ray_tpu_torch import state
s = state.log_stats()
assert s["ingested"] == 0 and s["records"] == 0, s
assert state.list_logs(limit=10) == []
ray_tpu_torch.shutdown()
print("PARITY-OK")
"""


def test_graftlog_disabled_subprocess_parity():
    env = dict(os.environ, RAY_TPU_TORCH_GRAFTLOG="0")
    out = subprocess.run([sys.executable, "-c", _PARITY_SCRIPT],
                         capture_output=True, text=True, timeout=180,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PARITY-OK" in out.stdout
