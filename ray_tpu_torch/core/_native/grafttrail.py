"""grafttrail — the state-observability plane: an indexed lifecycle
ledger with a per-attempt task FSM, object provenance, and
machine-checked conservation audits.

Analogue of the reference's task-event pipeline (reference: core_worker
task_event_buffer.cc -> gcs_task_manager.cc -> python/ray/util/state)
plus the object-lifecycle view behind `ray memory`
(object_manager/ + reference_count.cc), collapsed into ONE controller-
side ledger instead of a buffer/GCS/state-API relay.

Emission (core_worker / node_agent) produces compact tuples:

    task event:   (task_id, attempt, state, ts, info|None)
    object event: (oid, op, ts, info|None)     op: created|sealed|freed

Task states walk the per-attempt FSM SUBMITTED -> LEASED -> RUNNING ->
FINISHED | FAILED | CANCELLED. Folding is rank-ordered and terminal-
sticky, so batches arriving out of order (owner and executor flush on
independent ticks) can never regress a record. Object records carry
provenance: owner, size, plane (shm — graftshm slab CREATE/SEAL; copy —
staging-file ingest/put; fallback — the agent's Python RPC path), home
node, and created/sealed/freed timestamps with the freed reason.

Transport rides the existing planes — the worker's task-event flush
tick to its node agent, then the agent's fire-and-forget graftrpc batch
to the controller (like graftpulse) — not per-op round-trips.

The ledger is bounded (terminal/freed records evict first) with
explicit drop accounting, and `audit()` walks it asserting
conservation: every non-terminal task is live on an alive node, every
sealed object is either freed or resident on an alive node. Leaks and
losses come back with full provenance (ids, node, attempt chain,
reason) — the machine-checked "zero lost tasks, zero leaked objects"
gate chaos tests run under.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

# Per-attempt task FSM. Rank order makes folding idempotent under
# reordering; the three terminal states share "nothing after" semantics.
TASK_STATES = ("SUBMITTED", "LEASED", "RUNNING",
               "FINISHED", "FAILED", "CANCELLED")
TERMINAL_STATES = frozenset(("FINISHED", "FAILED", "CANCELLED"))
_RANK = {s: i for i, s in enumerate(TASK_STATES)}

# Store-journal origin (the wire op behind the folded journal op; see
# csrc/store_server.cc struct Event) -> object plane.
ORIGIN_PLANE = {1: "copy", 6: "copy", 9: "shm", 10: "shm"}
# Journal origin behind a delete -> freed reason.
ORIGIN_FREED = {4: "delete", 7: "drop", 9: "staged-reclaim"}

# Legacy task-event names (the pre-trail pipeline's vocabulary; the
# controller keeps deriving these rows for timeline()/list_task_events).
LEGACY_EVENT = {"SUBMITTED": "submitted", "FINISHED": "finished",
                "FAILED": "failed", "CANCELLED": "cancelled"}


def enabled() -> bool:
    """Trail emission/shipping on? (config flag; RAY_TPU_TORCH_GRAFTTRAIL=0
    reaches it through the normal env override path)."""
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        return bool(GlobalConfig.grafttrail)
    except Exception:
        return False


def task_event(task_id: str, attempt: int, state: str, ts: float,
               **info: Any) -> tuple:
    """Shape one task transition for the wire (info keys: name, parent,
    actor, trace, pspan, owner, node, worker, err)."""
    return (task_id, attempt, state, ts,
            {k: v for k, v in info.items() if v} or None)


def object_event(oid: str, op: str, ts: float, **info: Any) -> tuple:
    """Shape one object transition for the wire (op created|sealed|
    freed; info keys: size, plane, node, owner, reason)."""
    return (oid, op, ts,
            {k: v for k, v in info.items() if v or v == 0} or None)


class TaskRecord:
    __slots__ = ("task_id", "name", "actor", "parent", "trace", "pspan",
                 "owner", "attempts", "first_ts", "last_ts")

    def __init__(self, task_id: str):
        self.task_id = task_id
        self.name = ""
        self.actor = ""
        self.parent = ""      # parent task id ("" for driver roots)
        self.trace = ""
        self.pspan = ""
        self.owner = ""
        # attempt number -> {"state", "node", "worker", "err", "ts":
        # {state: wall_ts}} — the per-attempt FSM.
        self.attempts: Dict[int, dict] = {}
        self.first_ts = 0.0
        self.last_ts = 0.0

    def latest(self) -> Tuple[int, dict]:
        n = max(self.attempts)
        return n, self.attempts[n]

    @property
    def state(self) -> str:
        return self.latest()[1]["state"]

    def to_row(self) -> dict:
        n, att = self.latest()
        return {"task_id": self.task_id, "name": self.name,
                "state": att["state"], "attempt": n,
                "attempts": len(self.attempts),
                "node": att.get("node", ""), "actor_id": self.actor,
                "parent_task_id": self.parent,
                "error": att.get("err", ""),
                "start_ts": self.first_ts, "ts": self.last_ts}

    def to_detail(self) -> dict:
        row = self.to_row()
        chain = []
        for n in sorted(self.attempts):
            att = self.attempts[n]
            entry = {"attempt": n, "state": att["state"],
                     "node": att.get("node", ""),
                     "worker": att.get("worker", ""),
                     "error": att.get("err", ""),
                     "transitions": dict(att["ts"])}
            # graftlog salvage: the attempt's final log lines, attached
            # post-mortem when its worker died (attach_logs).
            if att.get("logs"):
                entry["log_tail"] = list(att["logs"])
            chain.append(entry)
        row["attempt_chain"] = chain
        # Root cause: the first attempt that failed explains every
        # retry after it; surface it once, not per-attempt.
        root = next((a for a in chain if a["error"]), None)
        row["root_cause"] = (root["error"] if root else "")
        # Forensics join: a dead worker's salvaged last words are the
        # best root-cause context a SIGKILL/OOM leaves behind. Surface
        # the newest attempt's tail at top level, and fold the final
        # line into root_cause when the FSM recorded no error string.
        tails = [a["log_tail"] for a in chain if a.get("log_tail")]
        row["log_tail"] = tails[-1] if tails else []
        if not row["root_cause"] and row["log_tail"]:
            row["root_cause"] = "last log: %s" % row["log_tail"][-1]
        row["trace_id"] = self.trace
        row["parent_span"] = self.pspan
        row["owner"] = self.owner
        return row


class ObjectRecord:
    __slots__ = ("oid", "size", "plane", "node", "owner", "created_ts",
                 "sealed_ts", "freed_ts", "freed_reason")

    def __init__(self, oid: str):
        self.oid = oid
        self.size = 0
        self.plane = ""
        self.node = ""
        self.owner = ""
        self.created_ts = 0.0
        self.sealed_ts = 0.0
        self.freed_ts = 0.0
        self.freed_reason = ""

    @property
    def live(self) -> bool:
        return not self.freed_ts

    def to_row(self) -> dict:
        return {"object_id": self.oid, "size": self.size,
                "plane": self.plane, "node": self.node,
                "owner": self.owner, "created_ts": self.created_ts,
                "sealed_ts": self.sealed_ts, "freed_ts": self.freed_ts,
                "freed_reason": self.freed_reason,
                "state": ("freed" if self.freed_ts
                          else "sealed" if self.sealed_ts
                          else "created")}


class TrailLedger:
    """Bounded, indexed fold of trail batches (controller-side).

    Indexes (state / node / function name / actor id -> task ids, plus
    node -> object ids) are maintained incrementally so `list tasks
    --state FAILED --node <id>` is a set intersection, not a scan.
    Eviction prefers settled records (terminal tasks, freed objects)
    and counts every drop — an audit over a ledger that dropped
    records says so instead of lying."""

    def __init__(self, task_cap: int = 20000, object_cap: int = 50000):
        self.task_cap = max(1, task_cap)
        self.object_cap = max(1, object_cap)
        self.tasks: "OrderedDict[str, TaskRecord]" = OrderedDict()
        self.objects: "OrderedDict[str, ObjectRecord]" = OrderedDict()
        self.by_state: Dict[str, Set[str]] = {s: set() for s in TASK_STATES}
        self.by_node: Dict[str, Set[str]] = {}
        self.by_name: Dict[str, Set[str]] = {}
        self.by_actor: Dict[str, Set[str]] = {}
        self.objects_by_node: Dict[str, Set[str]] = {}
        self.dropped_tasks = 0
        self.dropped_objects = 0
        self.events_folded = 0

    # -- folding -----------------------------------------------------------
    def fold_task(self, ev: tuple) -> Optional[dict]:
        """Fold one task transition. Returns a legacy-shaped event row
        for transitions the pre-trail pipeline knew about (submitted /
        finished / failed / cancelled) so the controller can keep its
        derived views, else None."""
        try:
            task_id, attempt, state, ts, info = ev
            attempt = int(attempt)
            state = str(state)
        except (ValueError, TypeError):
            return None
        if state not in _RANK:
            return None
        info = info or {}
        self.events_folded += 1
        rec = self.tasks.get(task_id)
        if rec is None:
            rec = TaskRecord(task_id)
            rec.first_ts = ts
            self.tasks[task_id] = rec
            self._evict_tasks()
        for field, key in (("name", "name"), ("actor", "actor"),
                           ("parent", "parent"), ("trace", "trace"),
                           ("pspan", "pspan"), ("owner", "owner")):
            v = info.get(key)
            if v and not getattr(rec, field):
                setattr(rec, field, str(v))
        old_state = rec.state if rec.attempts else None
        att = rec.attempts.get(attempt)
        if att is None:
            att = {"state": state, "ts": {state: ts}}
            rec.attempts[attempt] = att
        else:
            if att["state"] in TERMINAL_STATES:
                # Terminal is sticky: late events can't regress the
                # state — but the executor's slower flush tick may still
                # deliver provenance (node/worker, the RUNNING ts) the
                # owner-side terminal didn't carry. Absorb it.
                for key in ("node", "worker"):
                    v = info.get(key)
                    if v and not att.get(key):
                        att[key] = str(v)
                        if key == "node":
                            self.by_node.setdefault(
                                str(v), set()).add(task_id)
                att["ts"].setdefault(state, ts)
                # A late SUBMITTED still owes the legacy stream its row
                # (the old pipeline appended events in arrival order).
                return self._legacy_row(rec, att, attempt, state, ts)
            if _RANK[state] < _RANK[att["state"]]:
                # Out-of-order arrival (the executor's RUNNING can beat
                # the owner's SUBMITTED across flush ticks): keep the
                # info, not the regression — but still derive the
                # legacy row the old pipeline would have appended.
                att["ts"].setdefault(state, ts)
                self._merge_att(att, info)
                self._reindex(rec, old_state)
                return self._legacy_row(rec, att, attempt, state, ts)
            att["state"] = state
            att["ts"][state] = ts
        self._merge_att(att, info)
        rec.last_ts = max(rec.last_ts, ts)
        self._reindex(rec, old_state)
        if state in LEGACY_EVENT:
            return {"task_id": task_id, "name": rec.name,
                    "event": LEGACY_EVENT[state], "ts": ts,
                    "trace_id": rec.trace, "parent_span": rec.pspan,
                    "owner": rec.owner, "attempt": attempt,
                    "node": att.get("node", ""),
                    "error": att.get("err", "")}
        return None

    def _legacy_row(self, rec: TaskRecord, att: dict, attempt: int,
                    state: str, ts: float) -> Optional[dict]:
        """Row for a legacy-known transition folding out of order. Late
        terminals stay suppressed (one owner process emits at most one
        terminal per attempt; a second is a replay, not news)."""
        if state not in LEGACY_EVENT or state in TERMINAL_STATES:
            return None
        return {"task_id": rec.task_id, "name": rec.name,
                "event": LEGACY_EVENT[state], "ts": ts,
                "trace_id": rec.trace, "parent_span": rec.pspan,
                "owner": rec.owner, "attempt": attempt,
                "node": att.get("node", ""),
                "error": att.get("err", "")}

    @staticmethod
    def _merge_att(att: dict, info: dict) -> None:
        for key in ("node", "worker", "err"):
            v = info.get(key)
            if v:
                att[key] = str(v)

    def _reindex(self, rec: TaskRecord, old_state: Optional[str]) -> None:
        tid = rec.task_id
        if old_state and old_state != rec.state:
            self.by_state[old_state].discard(tid)
        self.by_state[rec.state].add(tid)
        _, att = rec.latest()
        node = att.get("node", "")
        if node:
            self.by_node.setdefault(node, set()).add(tid)
        if rec.name:
            self.by_name.setdefault(rec.name, set()).add(tid)
        if rec.actor:
            self.by_actor.setdefault(rec.actor, set()).add(tid)

    def _unindex_task(self, rec: TaskRecord) -> None:
        tid = rec.task_id
        for s in TASK_STATES:
            self.by_state[s].discard(tid)
        for att in rec.attempts.values():
            node = att.get("node", "")
            if node and node in self.by_node:
                self.by_node[node].discard(tid)
                if not self.by_node[node]:
                    del self.by_node[node]
        for index, key in ((self.by_name, rec.name),
                           (self.by_actor, rec.actor)):
            if key and key in index:
                index[key].discard(tid)
                if not index[key]:
                    del index[key]

    def _evict_tasks(self) -> None:
        while len(self.tasks) > self.task_cap:
            victim = None
            for tid, rec in self.tasks.items():
                # The newest record is attempt-less mid-fold: not settled.
                if rec.attempts and rec.state in TERMINAL_STATES:
                    victim = tid
                    break
            if victim is None:  # all live: drop the oldest anyway
                victim = next(iter(self.tasks))
            self._unindex_task(self.tasks.pop(victim))
            self.dropped_tasks += 1

    def fold_object(self, ev: tuple) -> None:
        try:
            oid, op, ts, info = ev
        except (ValueError, TypeError):
            return
        info = info or {}
        self.events_folded += 1
        rec = self.objects.get(oid)
        if rec is None:
            rec = ObjectRecord(oid)
            self.objects[oid] = rec
            self._evict_objects()
        size = info.get("size")
        if size:
            rec.size = int(size)
        for field in ("plane", "node", "owner"):
            v = info.get(field)
            if v and not getattr(rec, field):
                setattr(rec, field, str(v))
        if rec.node:
            self.objects_by_node.setdefault(rec.node, set()).add(oid)
        if op == "created":
            rec.created_ts = rec.created_ts or ts
        elif op == "sealed":
            rec.created_ts = rec.created_ts or ts
            rec.sealed_ts = rec.sealed_ts or ts
            # A re-put of a freed oid resurrects the record.
            rec.freed_ts, rec.freed_reason = 0.0, ""
        elif op == "freed":
            if not rec.freed_ts:
                rec.freed_ts = ts
                rec.freed_reason = str(info.get("reason", "")) or "delete"

    def _evict_objects(self) -> None:
        while len(self.objects) > self.object_cap:
            victim = None
            for oid, rec in self.objects.items():
                if rec.freed_ts:
                    victim = oid
                    break
            if victim is None:
                victim = next(iter(self.objects))
            rec = self.objects.pop(victim)
            if rec.node and rec.node in self.objects_by_node:
                self.objects_by_node[rec.node].discard(victim)
                if not self.objects_by_node[rec.node]:
                    del self.objects_by_node[rec.node]
            self.dropped_objects += 1

    # -- failure folding ---------------------------------------------------
    def node_dead(self, node_hex: str, reason: str,
                  ts: Optional[float] = None) -> dict:
        """Fold a node death: every attempt still open on that node
        fails (its retry — a NEW attempt — re-walks the FSM), and every
        live object homed there is freed with node-death provenance.
        Returns what was folded, for the controller's log line."""
        ts = ts if ts is not None else time.time()
        failed, freed = [], []
        for tid in list(self.by_node.get(node_hex, ())):
            rec = self.tasks.get(tid)
            if rec is None:
                continue
            for n, att in rec.attempts.items():
                if att.get("node") == node_hex \
                        and att["state"] not in TERMINAL_STATES:
                    self.fold_task((tid, n, "FAILED", ts,
                                    {"err": f"node died: {reason}",
                                     "node": node_hex}))
                    failed.append((tid, n))
        for oid in list(self.objects_by_node.get(node_hex, ())):
            rec = self.objects.get(oid)
            if rec is not None and rec.live:
                self.fold_object((oid, "freed", ts,
                                  {"reason": f"node died: {reason}"}))
                freed.append(oid)
        return {"tasks_failed": failed, "objects_freed": freed}

    # -- queries -----------------------------------------------------------
    def list_tasks(self, state: Optional[str] = None,
                   node: Optional[str] = None,
                   name: Optional[str] = None,
                   actor: Optional[str] = None,
                   limit: int = 100) -> List[dict]:
        ids: Optional[Set[str]] = None
        for index, key in ((self.by_state, state and state.upper()),
                           (self.by_node, node), (self.by_name, name),
                           (self.by_actor, actor)):
            if key is None:
                continue
            got = index.get(key, set())
            ids = set(got) if ids is None else ids & got
        if ids is None:
            recs = list(self.tasks.values())
        else:
            recs = [self.tasks[t] for t in ids if t in self.tasks]
        recs.sort(key=lambda r: r.last_ts, reverse=True)
        return [r.to_row() for r in recs[:max(0, limit)]]

    def get_task(self, task_id: str) -> Optional[dict]:
        rec = self._resolve(task_id)
        return rec.to_detail() if rec is not None else None

    def _resolve(self, task_id: str) -> Optional[TaskRecord]:
        rec = self.tasks.get(task_id)
        if rec is None:  # prefix lookup, CLI-friendly
            matches = [r for t, r in self.tasks.items()
                       if t.startswith(task_id)]
            if len(matches) != 1:
                return None
            rec = matches[0]
        return rec

    def attach_task_logs(self, task_id: str, lines: List[str],
                         attempt: Optional[int] = None,
                         cap: int = 20) -> bool:
        """graftlog join: pin a salvaged log tail onto an attempt
        record (the newest one unless given). Lines accumulate up to
        ``cap`` — a live tail shipped earlier and the post-mortem
        salvage both land here, newest kept."""
        rec = self._resolve(task_id)
        if rec is None or not rec.attempts or not lines:
            return False
        n = attempt if attempt in rec.attempts else rec.latest()[0]
        att = rec.attempts[n]
        att["logs"] = (att.get("logs", []) + [str(x) for x in lines])[-cap:]
        return True

    def summary(self) -> List[dict]:
        agg: Dict[str, dict] = {}
        for rec in self.tasks.values():
            row = agg.setdefault(rec.name or "(unnamed)", {
                "name": rec.name or "(unnamed)", "total": 0,
                "attempts": 0,
                **{s: 0 for s in TASK_STATES}})
            row["total"] += 1
            row["attempts"] += len(rec.attempts)
            row[rec.state] += 1
        return sorted(agg.values(), key=lambda r: -r["total"])

    def list_objects(self, node: Optional[str] = None,
                     plane: Optional[str] = None,
                     live: Optional[bool] = None,
                     limit: int = 100) -> List[dict]:
        out = []
        for rec in reversed(self.objects.values()):
            if node is not None and rec.node != node:
                continue
            if plane is not None and rec.plane != plane:
                continue
            if live is not None and rec.live != live:
                continue
            out.append(rec.to_row())
            if len(out) >= max(0, limit):
                break
        return out

    def stats(self) -> dict:
        return {
            "tasks": len(self.tasks),
            "objects": len(self.objects),
            "tasks_by_state": {s: len(ids)
                               for s, ids in self.by_state.items() if ids},
            "objects_live": sum(1 for r in self.objects.values() if r.live),
            "dropped_tasks": self.dropped_tasks,
            "dropped_objects": self.dropped_objects,
            "events_folded": self.events_folded,
        }

    # -- conservation audit ------------------------------------------------
    def audit(self, alive_nodes: Set[str],
              residents: Optional[Dict[str, Set[str]]] = None,
              grace_s: float = 300.0,
              now: Optional[float] = None) -> dict:
        """Walk the ledger asserting conservation. A task is LOST if its
        newest attempt is non-terminal and either sits on a node that is
        not alive (the node-death fold should have failed it — a lost
        terminal event) or has made no transition for `grace_s` seconds.
        An object is LEAKED if it is sealed-but-never-freed and either
        its home node is not alive, or `residents` (node -> resident oid
        set, from the agents) says the node no longer holds it. Every
        finding carries provenance; `complete` is False when the bounded
        ledger dropped records (the audit can then only vouch for what
        it saw)."""
        now = now if now is not None else time.time()
        lost: List[dict] = []
        leaked: List[dict] = []
        for rec in self.tasks.values():
            n, att = rec.latest()
            if att["state"] in TERMINAL_STATES:
                continue
            node = att.get("node", "")
            detail = rec.to_detail()
            if node and node not in alive_nodes:
                detail["audit_reason"] = (
                    f"attempt {n} {att['state']} on node {node} which is "
                    f"not alive — terminal event lost")
                lost.append(detail)
            elif now - rec.last_ts > grace_s:
                detail["audit_reason"] = (
                    f"attempt {n} stuck in {att['state']} for "
                    f"{now - rec.last_ts:.1f}s (grace {grace_s:.0f}s)")
                lost.append(detail)
        for rec in self.objects.values():
            if not rec.sealed_ts or rec.freed_ts:
                continue
            row = rec.to_row()
            if rec.node and rec.node not in alive_nodes:
                row["audit_reason"] = (
                    f"sealed on node {rec.node} which is not alive and "
                    f"never freed — free event lost")
                leaked.append(row)
            elif residents is not None and rec.plane != "inline" \
                    and rec.node in residents \
                    and rec.oid not in residents[rec.node]:
                # Inline-plane objects live in their OWNER's heap and
                # ride reply frames — the store never holds them, so the
                # agents' resident sets are not ground truth for them
                # (only the node-death fold and owner-attested frees
                # settle inline records).
                row["audit_reason"] = (
                    f"ledger says live on node {rec.node} but the node "
                    f"no longer holds it — free event lost")
                leaked.append(row)
        return {
            "ok": not lost and not leaked,
            "lost_tasks": lost,
            "leaked_objects": leaked,
            "complete": self.dropped_tasks == 0
            and self.dropped_objects == 0,
            "stats": self.stats(),
        }
