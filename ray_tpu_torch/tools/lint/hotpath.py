"""Pass 4d: whole-program hot-path round-trip analysis vs budgets.json.

Every sub-1.0x BENCH_CORE control-plane row has been the same defect:
a per-op awaited round-trip through the asyncio controller or the
store sidecar on a path the reference executes with zero cross-process
hops. The wire passes (3a-3h) prove the two sides of each plane agree
on shape, and pass 4a proves op *ordering* is legal — but nothing
detects when a hot path quietly grows another round-trip, which is
exactly how the observability planes eroded n:n dispatch from 0.81x
to 0.07x before their costs were re-batched.

This pass makes path *cost* a checked artifact, the same
artifact-plus-rederivation pattern as protocol.json. The committed
contract is tools/lint/budgets.json:

  * `ops` — every public hot-path entry point (task submit, actor
    call, put/get, owned-ref drop, placement-group create/remove) and
    every amortized flush plane (actor push flush, lease pump, free
    flush), each with its root function, a `derived` cost vector the
    real tree must re-derive EXACTLY (both directions: code that
    regresses fails, an artifact tightened below the tree fails), and
    a `budget` ceiling vector (headroom for planned work is visible
    as budget - derived).
  * `cold` — functions excluded from cost derivation, each with a
    reason (miss/fetch/retry/failover paths: they are correctness
    paths, not hot paths, and their retry loops are by design).

The analyzer builds the async call graph over the walked files
(name-resolved, same discipline as the other passes), computes
bottom-up per-function cost summaries (memoized, cycle-safe), and
classifies every reachable call as one of:

  controller_rt  awaited RPC on the controller client
  agent_rt       awaited RPC on the agent / a peer worker client
  sidecar_rt     blocking store-sidecar request that WAITS for its
                 reply frame (protocol.json reply:true)
  sidecar_send   fire-and-forget or deferred-ack sidecar op: the
                 write returns immediately and any ack rides a later
                 reply frame (OP_DROP, deferred OP_PUT)
  native_rt      graftrpc native-channel call (C reactor round-trip)
  executor_hop   loop -> thread-pool hop (run_in_executor)
  local          everything else

Join rules (documented so derived costs are reproducible by hand):
branches join component-wise max (the budget is a ceiling over every
plane, even when no single path takes both); loop bodies count ONCE
toward cost but any round-trip inside a loop is the batching
anti-pattern and flagged (`rpc-in-loop`); except handlers are error
paths and exempt from both cost and findings; calls into another
op's root function are that op's budget, not this one's, and stop
the walk (boundaries).

Path findings, beyond the budget/identity gates:

  rpc-in-loop           awaited per-item RPC / replying sidecar call
                        inside a loop body
  rt-under-lock         round-trip while holding a lock (any `with`
                        whose context expression names a *lock*)
  blocking-rt-on-loop   synchronous sidecar round-trip reachable on
                        the event loop (async def, or scheduled onto
                        the loop via call_soon); sends are exempt —
                        a socket write is microseconds, a blocking
                        reply read is a scheduler round-trip

All four rules honor inline `# lint: allow(<rule>: reason)` and the
committed allowlist (reasons + expiry, like every other pass).
"""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.lint.common import Finding, SourceFile, dotted_name
from ray_tpu_torch.tools.lint.protocol import _CLIENT_ATTRS, _CLIENT_PARAMS, \
    _CLIENT_SOURCE_RE, _METHOD_OPS

RULE_BUDGET = "hotpath-budget"
RULE_DRIFT = "hotpath-drift"
RULE_LOOP = "rpc-in-loop"
RULE_LOCK = "rt-under-lock"
RULE_BLOCKING = "blocking-rt-on-loop"

DEFAULT_BUDGETS = os.path.join(os.path.dirname(__file__), "budgets.json")

# Files whose call graph is walked. api.py holds the placement-group
# entry points; core_worker.py holds everything else.
WALK_FILES = ("ray_tpu_torch/core/core_worker.py", "ray_tpu_torch/api.py")

COST_KEYS = ("controller_rt", "agent_rt", "sidecar_rt", "sidecar_send",
             "native_rt", "executor_hop")

# Round-trip components (the ones that cost a scheduler wake cycle and
# feed the path findings); sends/hops are sub-RT classes.
_RT_KEYS = ("controller_rt", "agent_rt", "sidecar_rt")

# Client methods whose reply is consumed by a LATER op on the same
# connection (deferred ack): the call site itself is a send. drop_async
# is derived from protocol.json reply:false; put_deferred shares
# OP_PUT's replying wire slot but reads the reply on the next request.
_DEFERRED_SEND_METHODS = {"put_deferred"}

# Wrappers whose call-expression arguments are walked through (the
# inner Call is the real work; these add no cost of their own).
_TRANSPARENT_CALLS = {
    "spawn", "_spawn", "_run", "create_task", "ensure_future",
    "wait_for", "gather", "shield", "wrap_future", "run_coroutine_threadsafe",
}

# Loop-scheduling primitives: a function REFERENCE argument runs on the
# event loop later — edge into it with loop context.
_CALL_SOON = {"call_soon", "call_soon_threadsafe", "call_later", "call_at"}


def _terminates(body) -> bool:
    """A statement list that cannot fall through (ends in return/raise/
    continue/break — enough for the early-return join)."""
    if not body:
        return False
    last = body[-1]
    return isinstance(last, (ast.Return, ast.Raise, ast.Continue,
                             ast.Break))


def _failure_leg(body) -> bool:
    """A terminated branch that reports failure: `raise`, bare
    `return`, or `return False`/`return None`. Its round-trips are
    cleanup on an error path, not hot-path cost."""
    last = body[-1]
    if isinstance(last, ast.Raise):
        return True
    if isinstance(last, ast.Return):
        if last.value is None:
            return True
        return isinstance(last.value, ast.Constant) and \
            last.value.value in (False, None)
    return False


def _zero() -> Dict[str, int]:
    return {k: 0 for k in COST_KEYS}


def _vadd(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: a[k] + b[k] for k in COST_KEYS}


def _vmax(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: max(a[k], b[k]) for k in COST_KEYS}


def _is_rt(cost: Dict[str, int]) -> bool:
    return any(cost[k] for k in _RT_KEYS)


def load_budgets(path: str):
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data.get("ops"), dict) or not data["ops"]:
        raise ValueError("budgets.json has no 'ops' table")
    return data


def sidecar_method_costs(proto) -> Dict[str, str]:
    """Client-method -> cost key, derived from protocol.json's reply
    discipline: a method mapping to any reply:true op blocks on the
    reply frame (sidecar_rt); reply:false ops are sends."""
    out: Dict[str, str] = {}
    for meth, ops in _METHOD_OPS.items():
        reply = any(proto["ops"].get(op, {}).get("reply") for op in ops)
        out[meth] = "sidecar_rt" if reply else "sidecar_send"
    for meth in _DEFERRED_SEND_METHODS:
        out[meth] = "sidecar_send"
    return out


# --------------------------------------------------------------------------
# Function index: qualname -> (SourceFile, node); name-based resolution.
# --------------------------------------------------------------------------
class _Index:
    def __init__(self, files: List[SourceFile]):
        self.by_qual: Dict[str, Tuple[SourceFile, ast.AST]] = {}
        self.by_name: Dict[str, List[str]] = {}
        for sf in files:
            self._visit(sf, sf.tree, [])

    def _visit(self, sf: SourceFile, node: ast.AST, stack: List[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._visit(sf, child, stack + [child.name])
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(stack + [child.name])
                self.by_qual[qual] = (sf, child)
                self.by_name.setdefault(child.name, []).append(qual)
                # nested defs are indexed but never edge targets here
                self._visit(sf, child, stack + [child.name])

    def resolve(self, name: str, cls: Optional[str]) -> Optional[str]:
        """Resolve a called name to a unique qualname: same-class method
        first, then a unique global match. Ambiguity -> None (local)."""
        if cls:
            qual = f"{cls}.{name}"
            if qual in self.by_qual:
                return qual
        quals = self.by_name.get(name, ())
        if len(quals) == 1:
            return quals[0]
        return None


# --------------------------------------------------------------------------
# The walker: bottom-up memoized cost summaries + path findings.
# --------------------------------------------------------------------------
class Analyzer:
    def __init__(self, files: List[SourceFile], proto, budgets):
        self.index = _Index(files)
        self.sidecar_costs = sidecar_method_costs(proto)
        self.cold: Dict[str, str] = dict(budgets.get("cold", {}))
        self.boundaries: Set[str] = {
            spec["root"] for spec in budgets["ops"].values()}
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, int, str]] = set()
        # memo: (qual, on_loop) -> (cost, has_rt)
        self._memo: Dict[Tuple[str, bool], Tuple[Dict[str, int], bool]] = {}
        self._stack: Set[Tuple[str, bool]] = set()

    # -- public -------------------------------------------------------------
    def op_cost(self, root_qual: str, on_loop: bool) -> \
            Optional[Dict[str, int]]:
        if root_qual not in self.index.by_qual:
            return None
        cost, _ = self._summary(root_qual, on_loop, boundary_ok=True)
        return cost

    # -- summaries ----------------------------------------------------------
    def _summary(self, qual: str, on_loop: bool,
                 boundary_ok: bool = False) -> Tuple[Dict[str, int], bool]:
        """Worst-case cost vector of one call to `qual` (+ whether any
        round-trip is reachable). Boundaries/cold functions cost zero
        at call sites; a root op is walked with boundary_ok."""
        if not boundary_ok and (qual in self.boundaries or qual in self.cold):
            return _zero(), False
        key = (qual, on_loop)
        if key in self._memo:
            return self._memo[key]
        if key in self._stack:  # recursion: the cycle edge costs zero
            return _zero(), False
        entry = self.index.by_qual.get(qual)
        if entry is None:
            return _zero(), False
        sf, node = entry
        self._stack.add(key)
        w = _FnWalk(self, sf, node, qual,
                    on_loop or isinstance(node, ast.AsyncFunctionDef))
        cost = w.run()
        self._stack.discard(key)
        out = (cost, _is_rt(cost))
        self._memo[key] = out
        return out

    # -- findings -----------------------------------------------------------
    def flag(self, sf: SourceFile, line: int, rule: str, msg: str,
             qual: str) -> None:
        key = (sf.path, line, rule)
        if key in self._seen:
            return
        self._seen.add(key)
        if sf.annotations.allows(line, rule, False):
            return
        self.findings.append(
            Finding(sf.path, line, rule, "error", msg, qual))


class _FnWalk:
    """Walks ONE function body, summing statement costs branch-aware
    and emitting path findings with lexical context (loop depth, held
    locks, loop-thread context)."""

    def __init__(self, az: Analyzer, sf: SourceFile, node, qual: str,
                 on_loop: bool):
        self.az = az
        self.sf = sf
        self.node = node
        self.qual = qual
        self.on_loop = on_loop
        self.cls = qual.rsplit(".", 1)[0] if "." in qual else None
        self.loop_depth = 0
        self.lock_depth = 0
        self.client_vars: Set[str] = set(_CLIENT_PARAMS) | {
            a.arg for a in node.args.args if a.arg in _CLIENT_PARAMS}

    def run(self) -> Dict[str, int]:
        return self._body(self.node.body)

    # -- statements ---------------------------------------------------------
    def _body(self, stmts) -> Dict[str, int]:
        total = _zero()
        for i, st in enumerate(stmts):
            # Early-return dispatch (`if fast: return ...` chains, the
            # house style in _try_fast_put/_try_fast_get) is a branch
            # join, not a sum: the terminated body and the remaining
            # statements are alternatives. The test folds into the
            # TAKEN branch (a probe leg that fails falls through
            # without re-billing its cost to the fallback), and a
            # failure leg (`return False`/`return None`/`raise`) is an
            # error path like an except handler: its cleanup round-
            # trips count toward neither cost nor findings.
            if isinstance(st, ast.If) and not st.orelse and \
                    _terminates(st.body):
                cond = self._exprs(st.test)
                if _failure_leg(st.body):
                    total = _vadd(total, cond)
                    continue
                taken = _vadd(cond, self._body(st.body))
                rest = self._body(stmts[i + 1:])
                return _vadd(total, _vmax(taken, rest))
            total = _vadd(total, self._stmt(st))
        return total

    def _stmt(self, st) -> Dict[str, int]:
        if isinstance(st, ast.If):
            c = self._exprs(st.test)
            return _vadd(c, _vmax(self._body(st.body),
                                  self._body(st.orelse)))
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            c = self._exprs(st.iter if not isinstance(st, ast.While)
                            else st.test)
            self.loop_depth += 1
            body = self._body(st.body)
            self.loop_depth -= 1
            if st.orelse:
                body = _vadd(body, self._body(st.orelse))
            # Loop bodies count once toward cost; per-item round-trips
            # were already flagged as rpc-in-loop where they occurred.
            return _vadd(c, body)
        if isinstance(st, ast.Try):
            c = self._body(st.body)
            if st.orelse:
                c = _vadd(c, self._body(st.orelse))
            # Handlers are error paths: exempt from cost AND findings.
            if st.finalbody:
                c = _vadd(c, self._body(st.finalbody))
            return c
        if isinstance(st, (ast.With, ast.AsyncWith)):
            c = _zero()
            locked = 0
            for item in st.items:
                c = _vadd(c, self._exprs(item.context_expr))
                name = dotted_name(item.context_expr)
                if name is None and isinstance(item.context_expr, ast.Call):
                    name = dotted_name(item.context_expr.func)
                if name and "lock" in name.rsplit(".", 1)[-1].lower():
                    locked += 1
            self.lock_depth += locked
            c = _vadd(c, self._body(st.body))
            self.lock_depth -= locked
            return c
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return _zero()  # nested defs run on their own schedule
        if isinstance(st, ast.Assign):
            self._track_client_assign(st)
            return self._exprs(st.value)
        if isinstance(st, (ast.Return, ast.Expr)):
            return self._exprs(st.value) if st.value is not None else _zero()
        # Everything else: walk its expression children.
        c = _zero()
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                c = _vadd(c, self._exprs(child))
        return c

    def _track_client_assign(self, st: ast.Assign) -> None:
        if len(st.targets) != 1 or not isinstance(st.targets[0], ast.Name):
            return
        try:
            text = ast.unparse(st.value)
        except Exception:  # pragma: no cover
            return
        if _CLIENT_SOURCE_RE.search(text):
            self.client_vars.add(st.targets[0].id)

    # -- expressions --------------------------------------------------------
    def _exprs(self, node) -> Dict[str, int]:
        """Cost of every call in an expression tree (nested defs and
        lambdas excluded — they run on their own schedule)."""
        total = _zero()
        for call in self._calls(node):
            total = _vadd(total, self._call(call))
        return total

    def _calls(self, node) -> List[ast.Call]:
        out = [node] if isinstance(node, ast.Call) else []

        def walk(n):
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    out.append(child)
                walk(child)
        walk(node)
        out.sort(key=lambda n: (n.lineno, n.col_offset))
        return out

    def _call(self, call: ast.Call) -> Dict[str, int]:
        fn = call.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else None
        name = fn.id if isinstance(fn, ast.Name) else None

        # RPC clients: <recv>.call(...) / <recv>.call_batch(...)
        if attr in ("call", "call_batch"):
            recv = dotted_name(fn.value) or ""
            leaf = recv.rsplit(".", 1)[-1]
            if "chan" in leaf:
                return self._event("native_rt", call)
            if "controller" in leaf:
                return self._event("controller_rt", call)
            return self._event("agent_rt", call)

        # Sidecar client methods on an inferred client receiver.
        if attr in self.az.sidecar_costs and isinstance(
                fn.value, (ast.Name, ast.Attribute)):
            if self._is_client(fn.value):
                return self._event(self.az.sidecar_costs[attr], call)

        # Executor hop (+ edge into a `self.X` function reference arg).
        if attr == "run_in_executor":
            c = self._event("executor_hop", call)
            for a in call.args[1:2]:
                c = _vadd(c, self._ref_edge(a, call, on_loop=False))
            return c

        # call_soon & friends: function reference runs ON the loop.
        if attr in _CALL_SOON:
            c = _zero()
            for a in call.args[:1] if attr in ("call_soon",
                                               "call_soon_threadsafe") \
                    else call.args[1:2]:
                c = _vadd(c, self._ref_edge(a, call, on_loop=True))
            return c

        # Ordinary name-resolved edge. Wrapper calls (spawn/_run/...)
        # cost nothing themselves; their Call arguments were already
        # collected by _calls.
        target = None
        if attr is not None and isinstance(fn.value, ast.Name) and \
                fn.value.id in ("self", "cls"):
            target = self.az.index.resolve(attr, self.cls)
        elif name is not None and name not in _TRANSPARENT_CALLS:
            target = self.az.index.resolve(name, None)
        if target is None:
            return _zero()
        cost, has_rt = self.az._summary(target, self.on_loop)
        if has_rt:
            self._edge_findings(call, target, cost)
        return cost

    def _ref_edge(self, arg, call: ast.Call, on_loop: bool) \
            -> Dict[str, int]:
        """Edge through a function REFERENCE (call_soon(self._x),
        run_in_executor(None, self._x))."""
        target = None
        if isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name) and \
                arg.value.id in ("self", "cls"):
            target = self.az.index.resolve(arg.attr, self.cls)
        elif isinstance(arg, ast.Name):
            target = self.az.index.resolve(arg.id, None)
        if target is None:
            return _zero()
        cost, has_rt = self.az._summary(target, on_loop)
        if has_rt:
            self._edge_findings(call, target, cost)
        return cost

    def _is_client(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.client_vars
        return dotted_name(node) in _CLIENT_ATTRS

    # -- events + findings --------------------------------------------------
    def _event(self, kind: str, call: ast.Call) -> Dict[str, int]:
        cost = _zero()
        cost[kind] = 1
        if kind in _RT_KEYS:
            what = {"controller_rt": "controller round-trip",
                    "agent_rt": "agent/peer RPC round-trip",
                    "sidecar_rt": "blocking sidecar round-trip"}[kind]
            if self.loop_depth > 0:
                self.az.flag(
                    self.sf, call.lineno, RULE_LOOP,
                    f"awaited per-item {what} inside a loop — batch or "
                    f"coalesce (one RPC per item is the anti-pattern "
                    f"every sub-1.0x bench row shares)", self.qual)
            if self.lock_depth > 0:
                self.az.flag(
                    self.sf, call.lineno, RULE_LOCK,
                    f"{what} while holding a lock: every other user of "
                    f"the lock stalls for a scheduler wake cycle",
                    self.qual)
            if kind == "sidecar_rt" and self.on_loop:
                self.az.flag(
                    self.sf, call.lineno, RULE_BLOCKING,
                    "synchronous sidecar round-trip on the event loop: "
                    "the reply read blocks every coroutine behind it "
                    "(use the fire-and-forget/deferred-ack ops or an "
                    "executor)", self.qual)
        return cost

    def _edge_findings(self, call: ast.Call, target: str,
                       cost: Dict[str, int]) -> None:
        """A called helper reaches round-trips: the loop/lock context
        at THIS call site applies to them."""
        if self.loop_depth > 0:
            self.az.flag(
                self.sf, call.lineno, RULE_LOOP,
                f"call to {target} inside a loop reaches "
                f"{self._fmt_rt(cost)} per iteration — batch or coalesce",
                self.qual)
        if self.lock_depth > 0:
            self.az.flag(
                self.sf, call.lineno, RULE_LOCK,
                f"call to {target} while holding a lock reaches "
                f"{self._fmt_rt(cost)}", self.qual)
        if self.on_loop and cost["sidecar_rt"] > 0 and \
                target in self.az.index.by_qual and not isinstance(
                    self.az.index.by_qual[target][1],
                    ast.AsyncFunctionDef):
            self.az.flag(
                self.sf, call.lineno, RULE_BLOCKING,
                f"call to {target} on the event loop reaches a "
                f"synchronous sidecar round-trip", self.qual)

    @staticmethod
    def _fmt_rt(cost: Dict[str, int]) -> str:
        parts = [f"{cost[k]} {k}" for k in _RT_KEYS if cost[k]]
        return " + ".join(parts) if parts else "round-trips"


# --------------------------------------------------------------------------
# Artifact checks + entry points.
# --------------------------------------------------------------------------
def derive_costs(budgets, files: List[SourceFile], proto) \
        -> Tuple[Dict[str, Optional[Dict[str, int]]], List[Finding]]:
    az = Analyzer(files, proto, budgets)
    derived: Dict[str, Optional[Dict[str, int]]] = {}
    for op, spec in sorted(budgets["ops"].items()):
        derived[op] = az.op_cost(spec["root"], bool(spec.get("loop")))
    return derived, az.findings


def check(budgets_path: str, files: List[SourceFile], proto) \
        -> List[Finding]:
    try:
        budgets = load_budgets(budgets_path)
    except Exception as e:
        return [Finding("<hotpath>", 1, RULE_DRIFT, "error",
                        f"cannot load budgets artifact {budgets_path}: {e}")]
    rel = os.path.relpath(budgets_path).replace(os.sep, "/")
    derived, findings = derive_costs(budgets, files, proto)
    index_quals = Analyzer(files, proto, budgets).index.by_qual
    for qual in budgets.get("cold", {}):
        if qual not in index_quals:
            findings.append(Finding(
                rel, 1, RULE_DRIFT, "error",
                f"cold entry '{qual}' names no function in the walked "
                f"tree — stale artifact"))
    for op, spec in sorted(budgets["ops"].items()):
        got = derived[op]
        if got is None:
            findings.append(Finding(
                rel, 1, RULE_DRIFT, "error",
                f"op '{op}' root {spec['root']} not found in the walked "
                f"tree — stale artifact"))
            continue
        want = spec.get("derived", {})
        want_full = {k: int(want.get(k, 0)) for k in COST_KEYS}
        if want_full != got:
            diff = ", ".join(
                f"{k}: {want_full[k]} -> {got[k]}"
                for k in COST_KEYS if want_full[k] != got[k])
            findings.append(Finding(
                rel, 1, RULE_DRIFT, "error",
                f"op '{op}' derived cost drifted from the committed "
                f"artifact ({diff}): if the tree got cheaper, tighten "
                f"budgets.json; if it got dearer, that is a hot-path "
                f"regression — fix it or re-justify the artifact",
                spec["root"]))
        budget = spec.get("budget", {})
        for k in COST_KEYS:
            cap = budget.get(k)
            if cap is not None and got[k] > int(cap):
                findings.append(Finding(
                    rel, 1, RULE_BUDGET, "error",
                    f"op '{op}' breaches its {k} budget: derived "
                    f"{got[k]} > budget {cap} ({spec['root']})",
                    spec["root"]))
    return findings


def cost_table(budgets_path: str, files: List[SourceFile], proto) -> str:
    """The --costs table: op -> derived per-op cost components."""
    budgets = load_budgets(budgets_path)
    derived, _ = derive_costs(budgets, files, proto)
    header = f"{'op':<18}" + "".join(f"{k:>14}" for k in COST_KEYS)
    lines = [header, "-" * len(header)]
    for op in sorted(budgets["ops"]):
        got = derived[op]
        if got is None:
            lines.append(f"{op:<18}{'<root missing>':>14}")
            continue
        budget = budgets["ops"][op].get("budget", {})
        cells = []
        for k in COST_KEYS:
            cap = budget.get(k)
            cells.append(f"{got[k]}/{cap}" if cap is not None
                         else str(got[k]))
        lines.append(f"{op:<18}" + "".join(f"{c:>14}" for c in cells))
    lines.append("")
    lines.append("cells are derived[/budget]; derived must equal the "
                 "committed artifact (make lint enforces both directions)")
    return "\n".join(lines)
