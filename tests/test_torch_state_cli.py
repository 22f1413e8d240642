"""The port's state API, task events and timeline, metrics pipeline and
CLI (``python -m ray_tpu_torch.cli``): the cases of
``tests/test_state_cli.py`` with the same inputs and assertions on the
port's runtime, ``soak`` over ``ray_tpu_torch.load``, and the CLI on a
head of its own through ``chip_smoke.py``'s phase 16 (c).
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import state
from ray_tpu_torch.core.cluster_utils import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 4})
    c.connect()
    yield c
    c.shutdown()


def test_list_nodes_and_summary(cluster):
    nodes = state.list_nodes()
    assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"
    s = state.cluster_summary()
    assert s["nodes_alive"] == 1
    assert s["resources_total"]["CPU"] == 4.0


def test_list_actors(cluster):
    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    ray_tpu_torch.get(a.ping.remote())
    actors = state.list_actors()
    assert any(x["state"] == "ALIVE" for x in actors)


def test_task_events_and_timeline(cluster, tmp_path):
    @ray_tpu_torch.remote
    def traced_task(x):
        time.sleep(0.05)
        return x

    ray_tpu_torch.get([traced_task.remote(i) for i in range(5)])
    from ray_tpu_torch import api
    api._cw()._flush_task_events()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        tasks = state.list_task_events(limit=1000)
        names = [t["name"] for t in tasks]
        if names.count("traced_task") >= 10:  # submitted + finished
            break
        time.sleep(0.2)
    assert names.count("traced_task") >= 10

    out = str(tmp_path / "trace.json")
    trace = state.timeline(out)
    spans = [e for e in trace if e["name"] == "traced_task"]
    assert len(spans) >= 5
    assert all(e["ph"] == "X" and e["dur"] >= 0.05 * 1e6 * 0.5
               for e in spans)
    assert json.load(open(out))  # valid chrome-trace JSON


def test_timeline_chrome_format(cluster, tmp_path):
    """`timeline --native --format chrome` writes Chrome trace-event
    JSON Perfetto can open: a {"traceEvents": [...]} envelope, integer
    pid/tid, and process/thread name metadata carrying the original
    node/worker labels."""
    @ray_tpu_torch.remote
    def chrome_task(x):
        return x + 1

    ray_tpu_torch.get([chrome_task.remote(i) for i in range(3)])
    from ray_tpu_torch import api
    api._cw()._flush_task_events()

    out = str(tmp_path / "chrome.json")
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        state.timeline(out, native=True, fmt="chrome")
        doc = json.load(open(out))
        named = [e for e in doc["traceEvents"]
                 if e.get("name") == "chrome_task"]
        if len(named) >= 3:
            break
        time.sleep(0.3)
    assert isinstance(doc["traceEvents"], list)
    assert len(named) >= 3, "chrome_task slices missing from trace"
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {m["name"] for m in meta} >= {"process_name", "thread_name"}
    for ev in doc["traceEvents"]:
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)

    # Same through the CLI (the user-facing path).
    from ray_tpu_torch import api as _api
    host, port = _api._cw().controller_addr
    cli_out = str(tmp_path / "cli_chrome.json")
    r = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "timeline",
         "--address", f"{host}:{port}", "--native",
         "--format", "chrome", "--out", cli_out],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "chrome trace-event format" in r.stdout
    doc = json.load(open(cli_out))
    assert {e["ph"] for e in doc["traceEvents"]} >= {"M", "X"}


def test_metrics_pipeline(cluster):
    from ray_tpu_torch.utils.config import GlobalConfig
    deadline = time.monotonic() + 3 * (
        GlobalConfig.metrics_report_period_ms / 1000) + 10
    text = ""
    while time.monotonic() < deadline:
        text = state.metrics_text()
        if "raytpu_object_store_used_bytes" in text:
            break
        time.sleep(0.5)
    assert "raytpu_object_store_used_bytes" in text
    assert "# TYPE raytpu_workers gauge" in text


def test_worker_prints_stream_to_driver(cluster, capfd):
    @ray_tpu_torch.remote
    def chatty(i):
        print(f"hello-from-task-{i}")
        return i

    # capfd.readouterr() reads its capture file, then truncates it: a
    # line the driver prints between the two is lost to the test (not
    # to the driver). So wait until the driver's log subscription holds
    # its cursor (it starts from the latest event) and then has handled
    # the three lines (its cursor moves after each batch is printed)
    # before reading; the reference reads while it prints.
    from ray_tpu_torch import api
    sub = api._cw()._log_sub
    deadline = time.monotonic() + 30
    while sub.next_seq < 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    start = sub.next_seq
    assert ray_tpu_torch.get([chatty.remote(i) for i in range(3)]) == [0, 1, 2]
    while sub.next_seq - start < 3 and time.monotonic() < deadline:
        time.sleep(0.1)
    deadline = time.monotonic() + 20
    seen = ""
    while time.monotonic() < deadline:
        seen += capfd.readouterr().out
        if all(f"hello-from-task-{i}" in seen for i in range(3)):
            break
        time.sleep(0.25)
    for i in range(3):
        assert f"hello-from-task-{i}" in seen, seen[-2000:]
    assert "(pid=" in seen  # driver prefixes worker output


def test_cli_status_and_list(cluster):
    from ray_tpu_torch import api
    host, port = api._cw().controller_addr
    addr = f"{host}:{port}"
    import os
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "status",
         "--address", addr],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "nodes: 1/1 alive" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "list", "nodes",
         "--address", addr],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)[0]["state"] == "ALIVE"


def test_stack_dump_finds_hung_worker(cluster):
    """`ray_tpu_torch stack` analogue (reference: scripts.py:2706 py-spy
    stack): the dump must show the exact user frame a hung actor is
    stuck in — the io-loop RPC path answers even while the exec thread
    sleeps."""
    import time

    from ray_tpu_torch import state

    @ray_tpu_torch.remote
    class Stuck:
        def hang_here_forever(self):
            time.sleep(30)
            return "done"

        def ping(self):
            return "pong"

    a = Stuck.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    ref = a.hang_here_forever.remote()  # noqa: F841 — keep in flight
    time.sleep(1.0)  # the exec thread is now inside time.sleep

    dump = state.stack()
    assert dump, "no nodes in the stack dump"
    texts = []
    for workers in dump.values():
        for entry in workers.values():
            assert entry.get("via") in ("rpc", "signal"), entry
            texts.extend(entry.get("stacks", {}).values())
    joined = "\n".join(texts)
    assert "hang_here_forever" in joined, joined[-2000:]
    ray_tpu_torch.kill(a)


def test_trace_propagation_across_processes(cluster):
    """OTel-style span context rides the task spec (reference:
    util/tracing/tracing_helper.py): a driver-submitted task that
    submits a NESTED task and calls an actor produces events whose
    trace_id all match the root task's id, with parent_span pointing at
    the submitting task — the cross-process task tree is
    reconstructable from the event stream."""
    import time

    from ray_tpu_torch import state

    @ray_tpu_torch.remote
    def leaf(x):
        return x + 1

    @ray_tpu_torch.remote
    class Helper:
        async def assist(self):
            # async actor method: nested submit inherits via contextvar
            # (refs are awaitable; a blocking get would park the loop)
            return await leaf.remote(10)

    @ray_tpu_torch.remote
    def root_task():
        h = Helper.remote()
        a = ray_tpu_torch.get(leaf.remote(1))       # nested from exec thread
        b = ray_tpu_torch.get(h.assist.remote())    # actor call + its nested
        return a + b

    assert ray_tpu_torch.get(root_task.remote(), timeout=120) == 13

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        events = state.list_task_events(limit=1000)
        roots = [e for e in events if e["name"] == "root_task"
                 and e["event"] == "submitted"]
        leaves = [e for e in events if e["name"] == "leaf"
                  and e["event"] == "submitted"]
        assists = [e for e in events if e["name"].endswith(".assist")
                   and e["event"] == "submitted"]
        if roots and len(leaves) >= 2 and assists:
            break
        time.sleep(0.3)
    assert roots and len(leaves) >= 2 and assists, \
        (len(roots), len(leaves), len(assists))
    root = roots[-1]
    # Root task: its own id IS the trace id; no parent.
    assert root["trace_id"] == root["task_id"]
    assert root["parent_span"] == ""
    trace = root["trace_id"]
    tree_leaves = [e for e in leaves if e.get("trace_id") == trace]
    tree_assists = [e for e in assists if e.get("trace_id") == trace]
    assert tree_leaves and tree_assists
    # Direct children of the root task point their parent at it.
    assert any(e["parent_span"] == root["task_id"]
               for e in tree_leaves)
    assert all(e["parent_span"] == root["task_id"]
               for e in tree_assists)
    # The leaf submitted INSIDE the actor method parents to the actor
    # task's span, not the root — a 3-deep chain in one trace.
    assist_id = tree_assists[-1]["task_id"]
    assert any(e["parent_span"] == assist_id for e in tree_leaves), \
        [(e["task_id"][:8], e["parent_span"][:8]) for e in tree_leaves]


def test_list_workers_and_stack_surface_agent_errors(cluster,
                                                     monkeypatch):
    """An unreachable agent must not silently vanish from the listing:
    list_workers yields an {"node_id", "error"} row and stack() an
    {"error"} entry, both keyed by the node they describe."""
    from ray_tpu_torch import api

    cw = api._cw()

    def boom(addr):
        raise RuntimeError("agent-unreachable")

    monkeypatch.setattr(cw, "_client_for_worker", boom)
    rows = state.list_workers()
    assert rows, "ALIVE node produced no row at all"
    assert all(set(r) == {"node_id", "error"} for r in rows), rows
    assert "agent-unreachable" in rows[0]["error"]
    node_hex = state.list_nodes()[0]["node_id"]
    assert rows[0]["node_id"] == node_hex

    dump = state.stack()
    assert dump[node_hex].get("error"), dump
    assert "agent-unreachable" in dump[node_hex]["error"]


def test_timeline_atomic_write_under_concurrent_reader(cluster,
                                                       tmp_path):
    """timeline(filename) dumps via tmp + rename: a reader polling the
    path may see 'not there yet' but never a torn/partial JSON file."""
    import threading

    @ray_tpu_torch.remote
    def tick(x):
        return x

    ray_tpu_torch.get([tick.remote(i) for i in range(3)])
    from ray_tpu_torch import api
    api._cw()._flush_task_events()

    out = str(tmp_path / "trace.json")
    stop = threading.Event()
    torn: list = []

    def reader():
        while not stop.is_set():
            try:
                with open(out) as f:
                    json.load(f)
            except FileNotFoundError:
                pass  # writer hasn't produced the first dump yet
            except json.JSONDecodeError as e:
                torn.append(repr(e))
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        for _ in range(15):
            trace = state.timeline(out)
            assert isinstance(trace, list)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not torn, torn
    assert not os.path.exists(out + ".tmp")  # tmp never left behind
    assert json.load(open(out))  # final dump is whole


@pytest.mark.timeout(170)
def test_soak_smoke_profile_passes_every_verdict(tmp_path):
    """``cli.main(["soak", ...])`` (``python -m ray_tpu_torch.cli soak``)
    on the port's runtime: the smoke profile's load and worker kill on a
    cluster of its own (a separate process, as this module's cluster is
    connected here), exit 0, every verdict row ``ok``, and ``--out``
    holds the rows printed."""
    out = str(tmp_path / "soak.jsonl")
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "soak", "--profile",
         "smoke", "--duration", "6", "--out", out],
        capture_output=True, text=True, timeout=150, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert rows == [json.loads(line) for line in open(out)]
    verdicts = [r for r in rows if r.get("row") == "verdict"]
    assert verdicts and all(r["ok"] for r in verdicts), verdicts
    assert {r["workload"] for r in rows if r.get("row") == "workload"} \
        == {"serve", "data", "train"}
    (meta,) = [r for r in rows if r.get("row") == "meta"]
    assert meta["passed"] is True and meta["profile"] == "smoke"


def test_chip_smoke_cli_phase_on_the_cpu():
    """chip_smoke.py's phase 16 (c) at a small size on the CPU:
    ``python -m ray_tpu_torch.cli start --head`` (its agent told to
    advertise one GPU), ``status``, ``job submit`` of a driver whose
    ``num_gpus=1`` task holds the flash forward against its plain version,
    ``job logs``, the dashboard's nodes and jobs, and ``stop``, which
    leaves no process of the head's runtime (found by a marker in their
    environment, as other tests' clusters run beside it)."""
    import chip_smoke

    cli = chip_smoke._phase_cli("cpu", "cpu", (1, 2, 2, 64, 128),
                                {"RAY_TPU_TORCH_GPUS_PER_HOST": "1"})
    assert cli["task"]["launches"] == {} and cli["task"]["ok"]
