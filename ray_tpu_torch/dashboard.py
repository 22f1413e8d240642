"""Dashboard-lite: an HTTP view over the state API + metrics (counterpart of
``ray_tpu/dashboard.py``).

Analogue of the reference's dashboard head (reference: python/ray/
dashboard/ — aiohttp head serving /api/... + Prometheus metrics; the
React client is out of scope). Endpoints:

    GET /                -> minimal HTML overview
    GET /api/summary     -> cluster summary JSON
    GET /api/nodes|actors|tasks|workers|jobs|task_events
    GET /api/state/tasks?state=FAILED&node=ID&name=f&limit=N
                         -> grafttrail task records (indexed filters)
    GET /api/state/objects?node=ID&plane=shm&live=1
                         -> object provenance records
    GET /api/state/summary -> per-function task rollup
    GET /api/state/audit   -> conservation audit report
    GET /api/timeline    -> Chrome-trace JSON incl. graftscope native spans
    GET /api/native      -> native hot-path latency rollup (graftscope)
    GET /api/cluster?window=N
                         -> graftpulse SLO view (per-op p50/p99 over the
                            last N pulses per node, per-node occupancy +
                            pulse health, resident totals; a running
                            graftload soak's live status rides along)
    GET /api/logs?task=&actor=&node=&level=30&tail=N&after_id=&stats=1
                         -> graftlog cluster log records (crash-
                            persistent rings; salvaged tails included)
    GET /api/prof?view=top|flame|collapsed|stats&task=&actor=&node=
                 &seconds=&limit=
                         -> graftprof continuous-profiling queries
    GET /api/meta?window=N
                         -> graftmeta self-telemetry (per-plane ingest
                            rates + fold p50/p99 over the last N meta
                            ticks, controller loop lag + RSS, store
                            occupancy)
    GET /flame           -> self-contained flamegraph view over /api/prof
    GET /metrics         -> Prometheus text exposition
    GET /metrics/cluster -> federated exposition + raytpu_cluster_*
                            pulse aggregates

Run via `python -m ray_tpu_torch.cli dashboard --address H:P [--port 8265]`
or `start_dashboard(...)` in a driver.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><meta charset="utf-8">
<style>
 body{font-family:system-ui,sans-serif;margin:1.5em;color:#1a1a1a}
 h2{margin:.2em 0}h3{margin:1.2em 0 .4em;border-bottom:1px solid #ddd}
 table{border-collapse:collapse;width:100%;font-size:13px}
 th,td{text-align:left;padding:3px 10px;border-bottom:1px solid #eee;
       font-family:ui-monospace,monospace;white-space:nowrap}
 th{background:#fafafa;position:sticky;top:0}
 .bar{display:inline-block;height:9px;background:#4a7;border-radius:2px;
      vertical-align:middle;margin-right:4px}
 .barbg{display:inline-block;width:90px;height:9px;background:#eee;
        border-radius:2px;vertical-align:middle;margin-right:6px}
 .dead{color:#c33}.alive{color:#2a7}.muted{color:#888}
 #ts{font-size:12px;color:#888}
 a{color:#36c;text-decoration:none}
</style></head><body>
<h2>ray_tpu_torch cluster <span id="ts"></span></h2>
<div id="summary" class="muted">loading…</div>
<h3>Nodes</h3><table id="nodes"></table>
<h3>Actors</h3><table id="actors"></table>
<h3>Workers</h3><table id="workers"></table>
<h3>Task summary</h3><table id="tasks"></table>
<h3>Native hot paths (graftscope)</h3><table id="native"></table>
<h3>Cluster telemetry (graftpulse)</h3>
<div id="pulse" class="muted"></div>
<div id="soak" class="muted"></div><table id="cluster"></table>
<h3>Jobs</h3><table id="jobs"></table>
<p class="muted">raw: <a href="/api/summary">summary</a> ·
<a href="/api/nodes">nodes</a> · <a href="/api/actors">actors</a> ·
<a href="/api/tasks">tasks</a> · <a href="/api/workers">workers</a> ·
<a href="/api/jobs">jobs</a> · <a href="/api/native">native</a> ·
<a href="/api/cluster">cluster</a> · <a href="/api/meta">meta</a> ·
<a href="/api/prof?view=top">prof</a> · <a href="/flame">flame</a> ·
<a href="/api/logs?tail=100">logs</a> ·
<a href="/api/timeline">timeline</a> · <a href="/metrics">metrics</a> ·
<a href="/metrics/cluster">metrics/cluster</a></p>
<script>
const fmt = v => typeof v === "number" && !Number.isInteger(v)
    ? v.toFixed(2) : v;
function table(id, rows, cols, render) {
  const el = document.getElementById(id);
  if (!rows || !rows.length) { el.innerHTML =
      "<tr><td class=muted>(none)</td></tr>"; return; }
  let h = "<tr>" + cols.map(c => `<th>${c}</th>`).join("") + "</tr>";
  for (const r of rows) h += "<tr>" +
      cols.map(c => `<td>${render(r, c)}</td>`).join("") + "</tr>";
  el.innerHTML = h;
}
function usage(total, avail) {
  const out = [];
  for (const k of Object.keys(total || {})) {
    const t = total[k], a = (avail || {})[k] ?? t, used = t - a;
    const pct = t > 0 ? Math.round(100 * used / t) : 0;
    out.push(`${k} <span class=barbg><span class=bar style="width:${
        Math.round(pct * 0.9)}px"></span></span>${fmt(used)}/${fmt(t)}`);
  }
  return out.join(" &nbsp; ");
}
async function tick() {
  try {
    const [s, nodes, actors, tasks, workers, jobs, native, cluster] =
      await Promise.all(
      ["summary","nodes","actors","tasks","workers","jobs","native",
       "cluster"].map(
        p => fetch("/api/" + p).then(r => r.json())));
    document.getElementById("summary").textContent =
      `nodes ${s.nodes_alive}/${s.nodes_total} · actors ${s.actors} · ` +
      `resources ` + JSON.stringify(s.resources_available);
    table("nodes", nodes, ["node_id","state","addr","usage","labels"],
      (n, c) => c === "usage"
        ? usage(n.resources_total, n.resources_available)
        : c === "state" ? `<span class=${
            n.state === "ALIVE" ? "alive" : "dead"}>${n.state}</span>`
        : c === "labels" ? JSON.stringify(n.labels)
        : JSON.stringify(n[c]).replaceAll('"', ""));
    table("actors", actors,
      ["actor_id","name","state","node_id","restarts"],
      (a, c) => c === "state" ? `<span class=${
          a.state === "ALIVE" ? "alive" : "dead"}>${a.state}</span>`
        : a[c] ?? "");
    const byState = {};
    for (const t of tasks) byState[t.state] =
        (byState[t.state] || 0) + 1;
    table("tasks", Object.entries(byState).map(
        ([state, count]) => ({state, count})),
      ["state","count"], (t, c) => t[c]);
    table("workers", workers, Object.keys(workers[0] || {}),
      (w, c) => fmt(w[c]));
    table("native", native, ["name","count","mean_us","max_us"],
      (r, c) => fmt(r[c]));
    const tot = cluster.totals || {};
    document.getElementById("pulse").textContent =
      `objects ${tot.store_objects ?? 0} · queue ${
       tot.queue_depth ?? 0} · workers ${tot.num_workers ?? 0} · ` +
      `store ${fmt((tot.store_used ?? 0) / 1048576)}MiB · ` +
      `window ${fmt(cluster.window_s ?? 0)}s`;
    const soak = cluster.soak, soakEl = document.getElementById("soak");
    if (soak) {
      const wl = Object.entries(soak.workloads || {}).map(([k, v]) =>
        `${k} ${v.completed}/${v.submitted}` +
        (v.errors ? ` (${v.errors} err)` : "")).join(" · ");
      const chaos = (soak.chaos || []).map(c =>
        `${c.kind}@${c.at_s}s${c.ok ? "" : " FAILED"}`).join(", ");
      soakEl.innerHTML = `<b>soak ${soak.profile}</b> [${soak.phase}] ` +
        `${soak.elapsed_s}/${soak.duration_s}s · ${wl}` +
        (chaos ? ` · chaos: ${chaos}` : "");
    } else soakEl.textContent = "";
    table("cluster",
      Object.entries(cluster.ops || {}).map(([op, v]) => ({op, ...v})),
      ["op","calls","p50_ns","p99_ns","calls_per_s","bytes_per_s"],
      (r, c) => c === "p50_ns" || c === "p99_ns"
        ? fmt(r[c] / 1000) + "us" : fmt(r[c]));
    table("jobs", jobs, ["job_id","status","entrypoint"],
      (j, c) => j[c] ?? "");
    document.getElementById("ts").textContent =
      "refreshed " + new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("ts").textContent = "refresh failed: " + e;
  }
}
tick(); setInterval(tick, 2000);
</script></body></html>"""

# Self-contained flamegraph over /api/prof?view=flame — nested-div icicle
# layout from the d3-flamegraph-shaped JSON, zero external assets so it
# renders on an air-gapped cluster.
_FLAME_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch flamegraph</title><meta charset="utf-8">
<style>
 body{font-family:system-ui,sans-serif;margin:1.2em;color:#1a1a1a}
 #controls{margin-bottom:.8em;font-size:13px}
 #controls input{font-family:ui-monospace,monospace;font-size:12px;
   margin-right:.6em;padding:2px 4px;border:1px solid #ccc;
   border-radius:3px}
 #graph{font-size:11px;font-family:ui-monospace,monospace}
 .fr{box-sizing:border-box;height:17px;overflow:hidden;
   white-space:nowrap;border:1px solid #fff;border-radius:2px;
   padding:1px 3px;cursor:default;position:absolute}
 .fr:hover{border-color:#333}
 #graph{position:relative}
 #detail{margin-top:.6em;font-size:12px;color:#555;
   font-family:ui-monospace,monospace}
 .muted{color:#888}
 a{color:#36c;text-decoration:none}
</style></head><body>
<h2>graftprof flamegraph</h2>
<div id="controls">
 task <input id="task" size=18 placeholder="id prefix or name">
 actor <input id="actor" size=10> node <input id="node" size=10>
 seconds <input id="seconds" size=5>
 <button onclick="draw()">refresh</button>
 <span class=muted>(<a href="/">overview</a> ·
 <a href="/api/prof?view=top">top json</a>)</span>
</div>
<div id="graph"></div><div id="detail" class=muted></div>
<script>
function color(name) {
  let h = 0;
  for (const ch of name) h = (h * 31 + ch.charCodeAt(0)) >>> 0;
  return `hsl(${20 + h % 40},${60 + h % 30}%,${62 + h % 12}%)`;
}
function layout(node, x, w, depth, out, total) {
  out.push({node, x, w, depth});
  let cx = x;
  for (const c of node.children || []) {
    const cw = w * c.value / node.value;
    layout(c, cx, cw, depth + 1, out, total);
    cx += cw;
  }
  return out;
}
async function draw() {
  const q = new URLSearchParams({view: "flame"});
  for (const k of ["task","actor","node","seconds"]) {
    const v = document.getElementById(k).value.trim();
    if (v) q.set(k, v);
  }
  const root = await fetch("/api/prof?" + q).then(r => r.json());
  const g = document.getElementById("graph");
  if (!root.value) {
    g.innerHTML = "<span class=muted>no samples matched</span>";
    return;
  }
  const W = g.clientWidth || 960;
  const rows = layout(root, 0, W, 0, [], root.value);
  const maxd = Math.max(...rows.map(r => r.depth));
  g.style.height = (maxd + 1) * 17 + "px";
  g.innerHTML = "";
  for (const r of rows) {
    if (r.w < 1) continue;
    const d = document.createElement("div");
    d.className = "fr";
    d.style.left = r.x + "px";
    d.style.top = r.depth * 17 + "px";
    d.style.width = Math.max(1, r.w - 1) + "px";
    d.style.background = color(r.node.name);
    d.textContent = r.node.name;
    const pct = (100 * r.node.value / root.value).toFixed(1);
    d.title = `${r.node.name} — ${r.node.value} samples (${pct}%)`;
    d.onmouseenter = () => document.getElementById("detail")
        .textContent = d.title;
    g.appendChild(d);
  }
}
draw();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def _send(self, status: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib naming)
        from urllib.parse import parse_qs, urlsplit

        from ray_tpu_torch import state
        try:
            parts = urlsplit(self.path)
            path = parts.path
            q = {k: v[0] for k, v in parse_qs(parts.query).items()}
            if path == "/" or path == "/index.html":
                self._send(200, _PAGE.encode(), "text/html")
                return
            if path == "/metrics":
                self._send(200, state.metrics_text().encode(),
                           "text/plain; version=0.0.4")
                return
            if path == "/metrics/cluster":
                self._send(200, state.cluster_metrics_text().encode(),
                           "text/plain; version=0.0.4")
                return
            # grafttrail state API: the ledger-backed views, with query-
            # string filters riding the same index intersections the CLI
            # uses (reference: dashboard /api/v0/tasks etc.).
            if path == "/api/state/tasks" or path == "/api/tasks":
                self._send(200, json.dumps(state.list_tasks(
                    state=q.get("state"), node=q.get("node"),
                    name=q.get("name"), actor=q.get("actor"),
                    limit=int(q.get("limit", 100))),
                    default=str).encode())
                return
            if path == "/api/state/objects":
                live = q.get("live")
                self._send(200, json.dumps(state.list_objects(
                    node=q.get("node"), plane=q.get("plane"),
                    live=(None if live is None else live == "1"),
                    limit=int(q.get("limit", 100))),
                    default=str).encode())
                return
            if path == "/flame":
                self._send(200, _FLAME_PAGE.encode(), "text/html")
                return
            if path == "/api/prof":
                # graftprof: profiles already live on the controller —
                # the query is a pure read, no attach step.
                view = q.get("view", "top")
                filt = dict(task=q.get("task"), actor=q.get("actor"),
                            node=q.get("node"),
                            seconds=(float(q["seconds"])
                                     if q.get("seconds") else None))
                if view == "flame":
                    body = state.prof_flame(**filt)
                elif view == "collapsed":
                    body = state.prof_collapsed(**filt)
                elif view == "stats":
                    body = state.prof_stats()
                else:
                    body = state.prof_top(
                        limit=int(q.get("limit", 30)), **filt)
                self._send(200, json.dumps(body, default=str).encode())
                return
            if path == "/api/logs":
                # graftlog: indexed cluster log records, incl. salvaged
                # final lines of dead workers.  stats=1 -> store stats.
                if q.get("stats") == "1":
                    body = state.log_stats()
                else:
                    body = state.list_logs(
                        task=q.get("task"), actor=q.get("actor"),
                        node=q.get("node"),
                        level=int(q.get("level", 0) or 0),
                        after_id=int(q.get("after_id", 0) or 0),
                        limit=int(q.get("tail", q.get("limit", 100))))
                self._send(200, json.dumps(body, default=str).encode())
                return
            if path == "/api/state/summary":
                self._send(200, json.dumps(state.summary_tasks(),
                                           default=str).encode())
                return
            if path == "/api/state/audit":
                grace = q.get("grace")
                self._send(200, json.dumps(
                    state.audit(float(grace) if grace else None),
                    default=str).encode())
                return
            if path == "/api/meta":
                # graftmeta: the controller's self-telemetry — plane
                # ingest rates, fold-latency percentiles, loop lag,
                # RSS, store occupancy. ?window=N in meta ticks.
                self._send(200, json.dumps(state.meta_snapshot(
                    window=int(q.get("window", 60) or 60)),
                    default=str).encode())
                return
            if path == "/api/cluster":
                # graftpulse SLO view; ?window=N bounds how many recent
                # pulses per node feed the aggregates (verdict engines
                # want "p99 over the last N ticks", not all-time). The
                # soak status blob rides along while a soak runs.
                self._send(200, json.dumps(state.cluster_telemetry(
                    window=int(q.get("window", 30) or 30)),
                    default=str).encode())
                return
            routes = {
                "/api/summary": state.cluster_summary,
                "/api/nodes": state.list_nodes,
                "/api/actors": state.list_actors,
                "/api/task_events": state.list_task_events,
                "/api/workers": state.list_workers,
                "/api/timeline": state.timeline,
                "/api/native": state.native_latency,
            }
            if path == "/api/jobs":
                from ray_tpu_torch import job_submission
                self._send(200, json.dumps(job_submission.list_jobs(),
                                           default=str).encode())
                return
            fn = routes.get(path)
            if fn is None:
                self._send(404, b'{"error": "not found"}')
                return
            self._send(200, json.dumps(fn(), default=str).encode())
        except Exception as e:  # pragma: no cover - defensive
            self._send(500, json.dumps({"error": repr(e)}).encode())


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="dashboard")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._thread.join(timeout=5)


def start_dashboard(host: str = "127.0.0.1",
                    port: int = 8265) -> Dashboard:
    """Serve the dashboard over the CURRENT driver connection
    (ray_tpu_torch.init must have been called)."""
    return Dashboard(host, port)
