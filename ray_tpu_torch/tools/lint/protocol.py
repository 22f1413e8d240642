"""Pass 4a: store-sidecar protocol state-machine verification.

graftlint's wire passes (3a/3c/3d/3e) check that the two sides of each
native plane agree on *shape* — opcodes, widths, field order. Nothing
checks *behavior over time*: a worker that GETs before the object is
sealed, RELEASEs a pin it never took, or double-DROPs an oid is
schema-clean and still corrupts the lifecycle bookkeeping (and, once
graftshm lands in-place OP_CREATE/OP_SEAL, corrupts shared memory
silently instead of failing cleanly — the exact class Ray's plasma
plane guards with create/seal state checks).

The contract lives in tools/lint/protocol.json, a committed artifact
this pass verifies BOTH sides against:

  * C side (ray_tpu_torch/csrc/store_server.cc): every kOp constant's value, whether
    its handler writes a reply frame (a case that ends in `continue;`
    is fire-and-forget), and which journal op it records, must match
    the artifact — and vice versa (an op added on one side only is
    drift, same discipline as the schema passes but for ordering).
  * Python constants: FastStoreClient.OP_* values must match.
  * Reply discipline: every store_client_send call site must carry a
    reply=false op and every store_client_request/_req site a
    reply=true op; mixing them desyncs the connection byte stream.
  * Call-site walk: every path through the canonical client files
    (object_store.py, core_worker.py, node_agent.py) is walked with a
    per-oid abstract state {absent, staged, sealed, pinned} + pin
    ledger; any transition not listed in the artifact's `from` sets is
    flagged (get-before-seal, release-without-get, double-drop,
    delete-while-pinned).

Walk semantics (tuned for zero false positives on real code):
  * An oid expression starts in UNKNOWN state — only ops on the same
    path establish state, so a bare `release(oid)` helper is clean.
  * Receivers are inferred conservatively: params named fp/store,
    attributes self.store/self._fastpath, and locals assigned from
    FastStoreClient(...)/LocalObjectStore(...)/self._get_fastpath().
  * One-level helper summaries: a function with a client param whose
    body performs client ops on its own params is treated as those ops
    at its call sites (e.g. _fp_release_quiet == release). A helper
    whose flattened op sequence is not self-consistent (ops on
    divergent branches — a fallback delete in an except handler next
    to the success-path seal) cannot be replayed as a sequence no
    single path executes; it poisons its oid params to UNKNOWN at call
    sites instead, and its body is still walked branch-aware directly.
  * Loop bodies are walked with a fresh state (no cross-iteration
    pairing), and all tracked state is forgotten after the loop.
  * except-handler entry poisons state to UNKNOWN (the body may have
    thrown anywhere).
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.tools.lint.common import Finding, SourceFile, dotted_name

RULE_DRIFT = "protocol-drift"
RULE_ORDER = "op-order"
RULE_REPLY = "reply-path"

DEFAULT_PROTOCOL = os.path.join(os.path.dirname(__file__), "protocol.json")

# Canonical repo-relative files whose call sites are walked by default.
WALK_FILES = ("ray_tpu_torch/core/object_store.py",
              "ray_tpu_torch/core/core_worker.py",
              "ray_tpu_torch/core/node_agent.py")

# Client-method name -> protocol op(s). put_bytes is the local-plane
# fused create+write+seal.
_METHOD_OPS: Dict[str, Tuple[str, ...]] = {
    "create": ("create",), "seal": ("seal",), "ingest": ("ingest",),
    "get": ("get",), "release": ("release",), "delete": ("delete",),
    "put": ("put",), "put_deferred": ("put",), "drop_async": ("drop",),
    "contains": ("contains",),
    "scope_drain": ("scope",), "put_bytes": ("create", "seal"),
}

_CLIENT_PARAMS = {"fp", "store"}
_CLIENT_ATTRS = {"self.store", "self._fastpath"}
_CLIENT_SOURCE_RE = re.compile(
    r"FastStoreClient\s*\(|LocalObjectStore\s*\(|self\._get_fastpath\s*\("
    r"|self\._fastpath\b|self\.store\b")

_MAX_ENVS = 48


# --------------------------------------------------------------------------
# protocol.json
# --------------------------------------------------------------------------
def load_protocol(path: str):
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    ops = data.get("ops")
    if not isinstance(ops, dict) or not ops:
        raise ValueError("protocol.json has no 'ops' table")
    return data


# --------------------------------------------------------------------------
# C side: kOp values + per-handler reply/journal behavior.
# --------------------------------------------------------------------------
def _balanced(text: str, open_pos: int) -> str:
    """Text inside the brace block opening at text[open_pos] == '{'."""
    depth = 0
    for i in range(open_pos, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[open_pos + 1:i]
    return text[open_pos + 1:]


def parse_c_handlers(cc_text: str):
    """-> (values: {op: int}, handlers: {op: {'reply': bool,
    'journal': Optional[str], 'line': int}})"""
    values = {m.group(1).lower(): int(m.group(2))
              for m in re.finditer(r"\bkOp(\w+)\s*=\s*(\d+)", cc_text)}
    handlers = {}
    sw = re.search(r"switch\s*\(\s*op\s*\)\s*\{", cc_text)
    if sw is None:
        return values, handlers
    body_open = sw.end() - 1
    body = _balanced(cc_text, body_open)
    base = body_open + 1
    labels = list(re.finditer(r"case\s+kOp(\w+)\s*:", body))
    regions: List[Tuple[str, str, int]] = []
    for i, lm in enumerate(labels):
        end = labels[i + 1].start() if i + 1 < len(labels) else len(body)
        regions.append((lm.group(1).lower(), body[lm.end():end],
                        cc_text.count("\n", 0, base + lm.start()) + 1))
    # Fall-through labels (empty region) share the next label's handler.
    for i in range(len(regions) - 2, -1, -1):
        name, text, line = regions[i]
        if not text.strip():
            regions[i] = (name, regions[i + 1][1], line)
    for name, text, line in regions:
        jm = re.search(r"\bJournal\s*\([^,]+,\s*kOp(\w+)", text)
        handlers[name] = {
            "reply": re.search(r"\bcontinue\s*;", text) is None,
            "journal": jm.group(1).lower() if jm else None,
            "line": line,
        }
    return values, handlers


def check_c(proto, cc_text: str, cc_rel: str) -> List[Finding]:
    out: List[Finding] = []
    ops = proto["ops"]
    wire = {n: s for n, s in ops.items() if s.get("value") is not None}
    values, handlers = parse_c_handlers(cc_text)

    def f(line, msg):
        out.append(Finding(cc_rel, line, RULE_DRIFT, "error", msg))

    for name, val in values.items():
        if name not in ops:
            f(1, f"C op kOp{name.title()}={val} has no entry in "
                 f"protocol.json (ops added on one side only)")
        elif wire.get(name, {}).get("value") != val:
            f(1, f"C op kOp{name.title()}={val} disagrees with "
                 f"protocol.json value {wire.get(name, {}).get('value')}")
    for name, spec in wire.items():
        if name not in values:
            f(1, f"protocol.json op '{name}' (value {spec['value']}) has "
                 f"no kOp constant in {cc_rel}")
            continue
        h = handlers.get(name)
        if h is None:
            f(1, f"protocol.json op '{name}' has no case kOp handler in "
                 f"the service switch of {cc_rel}")
            continue
        if bool(spec.get("reply")) != h["reply"]:
            want = "a reply frame" if spec.get("reply") else \
                "fire-and-forget (no reply frame)"
            f(h["line"], f"op '{name}' handler is "
              f"{'replying' if h['reply'] else 'fire-and-forget'} but "
              f"protocol.json says {want}")
        if spec.get("journal") != h["journal"]:
            f(h["line"], f"op '{name}' journals "
              f"{h['journal'] or 'nothing'} but protocol.json says "
              f"{spec.get('journal') or 'nothing'}")
    return out


# --------------------------------------------------------------------------
# Python side: OP_* table + send/request reply discipline.
# --------------------------------------------------------------------------
def _py_op_table(tree: ast.AST) -> Dict[str, Tuple[int, int]]:
    out: Dict[str, Tuple[int, int]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            pairs = []
            if isinstance(target, ast.Name):
                pairs = [(target, node.value)]
            elif isinstance(target, ast.Tuple) and \
                    isinstance(node.value, ast.Tuple) and \
                    len(target.elts) == len(node.value.elts):
                pairs = list(zip(target.elts, node.value.elts))
            for t, v in pairs:
                if isinstance(t, ast.Name) and t.id.startswith("OP_") and \
                        isinstance(v, ast.Constant) and \
                        isinstance(v.value, int):
                    out[t.id[3:].lower()] = (v.value, t.lineno)
    return out


def check_py_table(proto, sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    ops = proto["ops"]
    wire = {n: s for n, s in ops.items() if s.get("value") is not None}
    table = _py_op_table(sf.tree)
    if not table:
        return out
    for name, (val, line) in table.items():
        spec = wire.get(name)
        if spec is None:
            out.append(Finding(
                sf.path, line, RULE_DRIFT, "error",
                f"Python OP_{name.upper()}={val} has no entry in "
                f"protocol.json (ops added on one side only)"))
        elif spec["value"] != val:
            out.append(Finding(
                sf.path, line, RULE_DRIFT, "error",
                f"Python OP_{name.upper()}={val} disagrees with "
                f"protocol.json value {spec['value']}"))
    for name, spec in wire.items():
        if name not in table:
            out.append(Finding(
                sf.path, 1, RULE_DRIFT, "error",
                f"protocol.json op '{name}' (value {spec['value']}) has "
                f"no OP_{name.upper()} constant on the Python side"))
    return out


def _op_arg_name(call: ast.Call) -> Optional[str]:
    for arg in call.args:
        name = None
        if isinstance(arg, ast.Attribute):
            name = arg.attr
        elif isinstance(arg, ast.Name):
            name = arg.id
        if name and name.startswith("OP_"):
            return name[3:].lower()
    return None


def check_reply_paths(proto, sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    ops = proto["ops"]
    for call in ast.walk(sf.tree):
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        method = fn.attr if isinstance(fn, ast.Attribute) else \
            (fn.id if isinstance(fn, ast.Name) else None)
        if method in ("store_client_send", "_req_noreply"):
            fire = True
        elif method in ("store_client_request", "_req"):
            fire = False
        else:
            continue
        opname = _op_arg_name(call)
        spec = ops.get(opname) if opname else None
        if spec is None or spec.get("value") is None:
            continue
        if sf.annotations.allows(call.lineno, RULE_REPLY, False):
            continue
        if fire and spec.get("reply"):
            out.append(Finding(
                sf.path, call.lineno, RULE_REPLY, "error",
                f"reply-expected op OP_{opname.upper()} sent on the "
                f"fire-and-forget path ({method}): the next recv on this "
                f"connection desyncs"))
        elif not fire and not spec.get("reply"):
            out.append(Finding(
                sf.path, call.lineno, RULE_REPLY, "error",
                f"fire-and-forget op OP_{opname.upper()} sent on the "
                f"replied path ({method}): recv blocks forever waiting "
                f"for a frame the server never writes"))
    return out


# --------------------------------------------------------------------------
# Call-site state-machine walk.
# --------------------------------------------------------------------------
def _walk_no_defs(node: ast.AST):
    """Yield child expressions without descending into nested def/lambda
    bodies (they run on their own schedule)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _walk_no_defs(child)


def _calls_in(node: ast.AST) -> List[ast.Call]:
    calls = [node] if isinstance(node, ast.Call) else []
    calls += [n for n in _walk_no_defs(node) if isinstance(n, ast.Call)]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return calls


# Summary pseudo-op: the helper touches this oid param but its op
# sequence spans divergent branches, so state is unknowable afterward.
_POISON = "__poison__"


def _summary_consistent(proto, ops: List[Tuple[str, int]]) -> bool:
    """True when replaying the flattened op sequence per oid param is
    itself protocol-legal from UNKNOWN. A helper with a fallback delete
    in an except handler flattens to e.g. create,delete,seal — a
    sequence no single execution path takes; replaying it at call sites
    would manufacture violations, so such helpers poison instead."""
    state: Dict[int, Optional[str]] = {}
    for op, idx in ops:
        spec = proto["ops"].get(op)
        if spec is None:
            continue
        frm = spec.get("from", "*")
        st = state.get(idx)
        if st is not None and frm != "*" and st not in frm:
            return False
        to = spec.get("to")
        if to is not None:
            state[idx] = to
    return True


def collect_helper_summaries(proto, files: List[SourceFile]):
    """name -> [(op, oid_param_index)] for helpers that apply client ops
    directly to their own parameters (one level, no transitive chains).
    Helpers whose flattened sequence is branch-divergent get a _POISON
    entry per touched param instead of a replayable op list."""
    summaries: Dict[str, List[Tuple[str, int]]] = {}
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in node.args.args
                      if a.arg not in ("self", "cls")]
            if not (_CLIENT_PARAMS & set(params)):
                continue
            ops: List[Tuple[str, int]] = []
            for call in _calls_in(node):
                fn = call.func
                if not (isinstance(fn, ast.Attribute) and
                        isinstance(fn.value, ast.Name) and
                        fn.value.id in _CLIENT_PARAMS and
                        fn.value.id in params):
                    continue
                for op in _METHOD_OPS.get(fn.attr, ()):
                    if call.args and isinstance(call.args[0], ast.Name) \
                            and call.args[0].id in params:
                        ops.append((op, params.index(call.args[0].id)))
            if ops:
                if not _summary_consistent(proto, ops):
                    ops = [(_POISON, idx)
                           for idx in sorted({i for _, i in ops})]
                summaries[node.name] = ops
    return summaries


class _Walker:
    def __init__(self, sf: SourceFile, proto, summaries, findings, seen):
        self.sf = sf
        self.ops = proto["ops"]
        self.summaries = summaries
        self.findings = findings
        self.seen = seen
        self.client_vars: set = set()
        self.aliases: Dict[str, str] = {}
        self.qual = ""

    # -- entry -------------------------------------------------------------
    def run_function(self, fn, qualname: str) -> None:
        self.qual = qualname
        self.client_vars = {a.arg for a in fn.args.args
                            if a.arg in _CLIENT_PARAMS}
        self.aliases = {}
        self._body(fn.body, [{}])

    # -- helpers -----------------------------------------------------------
    def _flag(self, line: int, msg: str) -> None:
        key = (self.sf.path, line, msg)
        if key in self.seen:
            return
        self.seen.add(key)
        if self.sf.annotations.allows(line, RULE_ORDER, False):
            return
        self.findings.append(Finding(self.sf.path, line, RULE_ORDER,
                                     "error", msg, self.qual))

    def _is_client(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.client_vars
        dn = dotted_name(node)
        return dn in _CLIENT_ATTRS

    def _oid_key(self, node: ast.AST) -> str:
        while isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in ("ObjectID", "bytes") and \
                len(node.args) == 1:
            node = node.args[0]
        if isinstance(node, ast.Name) and node.id in self.aliases:
            return self.aliases[node.id]
        try:
            return ast.unparse(node)
        except Exception:  # pragma: no cover - unparse is total on 3.9+
            return "<expr>"

    # -- statements --------------------------------------------------------
    def _body(self, stmts, envs):
        for st in stmts:
            envs = self._stmt(st, envs)
            if not envs:
                break
        return envs

    def _stmt(self, st, envs):
        if isinstance(st, ast.If):
            self._expr(st.test, envs)
            a = self._body(st.body, [dict(e) for e in envs])
            b = self._body(st.orelse, [dict(e) for e in envs])
            return (a + b)[:_MAX_ENVS]
        if isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
            self._expr(st.test if isinstance(st, ast.While) else st.iter,
                       envs)
            # Fresh state per iteration: within-iteration sequences are
            # checked, cross-iteration pairing is not assumed.
            self._body(st.body, [{}])
            if st.orelse:
                self._body(st.orelse, envs)
            for e in envs:  # the loop may have run 0..n times: forget
                e.clear()
            return envs
        if isinstance(st, ast.Try):
            ok = self._body(st.body, [dict(e) for e in envs])
            if st.orelse:
                ok = self._body(st.orelse, ok)
            out = list(ok)
            for h in st.handlers:
                poisoned = [{k: (None, 0) for k in e} for e in envs]
                out += self._body(h.body, poisoned)
            out = out[:_MAX_ENVS]
            if st.finalbody:
                out = self._body(st.finalbody, out)
            return out
        if isinstance(st, ast.Return):
            if st.value is not None:
                self._expr(st.value, envs)
            return []
        if isinstance(st, ast.Raise):
            if st.exc is not None:
                self._expr(st.exc, envs)
            return []
        if isinstance(st, (ast.Break, ast.Continue)):
            return []
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr, envs)
            return self._body(st.body, envs)
        if isinstance(st, ast.Assign):
            self._expr(st.value, envs)
            self._track_assign(st)
            return envs
        if isinstance(st, (ast.AnnAssign, ast.AugAssign)):
            if st.value is not None:
                self._expr(st.value, envs)
            return envs
        if isinstance(st, ast.Expr):
            self._expr(st.value, envs)
            return envs
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return envs
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, envs)
        return envs

    def _track_assign(self, st: ast.Assign) -> None:
        if len(st.targets) != 1 or not isinstance(st.targets[0], ast.Name):
            return
        name = st.targets[0].id
        try:
            text = ast.unparse(st.value)
        except Exception:  # pragma: no cover
            return
        if _CLIENT_SOURCE_RE.search(text):
            self.client_vars.add(name)
            return
        v = st.value
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Name) and \
                v.func.id == "ObjectID" and len(v.args) == 1:
            self.aliases[name] = self._oid_key(v)

    # -- expressions / events ----------------------------------------------
    def _expr(self, node, envs) -> None:
        for call in _calls_in(node):
            self._event(call, envs)

    def _event(self, call: ast.Call, envs) -> None:
        fn = call.func
        if isinstance(fn, ast.Attribute) and self._is_client(fn.value):
            ops = _METHOD_OPS.get(fn.attr, ())
            if ops and call.args:
                key = self._oid_key(call.args[0])
                for op in ops:
                    self._apply(op, key, call.lineno, envs)
            return
        name = None
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in ("self", "cls"):
            name = fn.attr
        elif isinstance(fn, ast.Name):
            name = fn.id
        summary = self.summaries.get(name) if name else None
        if summary:
            for op, idx in summary:
                if idx < len(call.args):
                    key = self._oid_key(call.args[idx])
                    self._apply(op, key, call.lineno, envs)

    def _apply(self, op_name: str, key: str, line: int, envs) -> None:
        if op_name == _POISON:
            # Branch-divergent helper: it did SOMETHING to this oid, but
            # which path ran is unknowable here — forget state and pins
            # (its own body is walked branch-aware where it is defined).
            for env in envs:
                if key in env:
                    env[key] = (None, 0)
            return
        spec = self.ops.get(op_name)
        if spec is None:
            return
        frm = spec.get("from", "*")
        to = spec.get("to")
        pd = spec.get("pin_delta", 0) or 0
        if frm == "*" and to is None and pd == 0:
            return  # pure observer op (contains/scope)
        for env in envs:
            st, pins = env.get(key, (None, 0))
            violated = st is not None and frm != "*" and st not in frm
            if violated:
                if op_name == "get" and st == "staged":
                    msg = ("get-before-seal: get on a created-but-"
                           "unsealed object")
                elif op_name == "release":
                    msg = (f"release-without-get: release of an object "
                           f"this path never pinned (state '{st}')")
                elif st == "absent" and to == "absent":
                    msg = (f"double-drop: {op_name} of an object already "
                           f"deleted/dropped on this path")
                elif st == "absent":
                    msg = (f"{op_name} of an object already deleted on "
                           f"this path")
                else:
                    msg = (f"illegal op sequence: {op_name} from state "
                           f"'{st}' (protocol.json allows "
                           f"{list(frm)})")
                self._flag(line, msg)
            if to == "absent" and pins > 0:
                self._flag(line, f"{op_name} of an object while this "
                                 f"path still holds {pins} pin(s) on it")
                pins = 0
            if pd > 0:
                pins += 1
            elif pd < 0:
                pins = max(0, pins - 1)
            if to is not None:
                st = to
            elif pd < 0 and st == "pinned" and pins == 0:
                st = "sealed"
            env[key] = (st, pins)


def walk_call_sites(proto, files: List[SourceFile]) -> List[Finding]:
    summaries = collect_helper_summaries(proto, files)
    findings: List[Finding] = []
    seen: set = set()
    for sf in files:
        def visit(node, stack):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, stack + [child.name])
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = ".".join(stack + [child.name])
                    _Walker(sf, proto, summaries, findings,
                            seen).run_function(child, qual)
                    visit(child, stack + [child.name])
                else:
                    visit(child, stack)
        visit(sf.tree, [])
    return findings


# --------------------------------------------------------------------------
# Entry point.
# --------------------------------------------------------------------------
def run(protocol_path: str, cc_path: str, cc_rel: str,
        files: List[SourceFile]) -> List[Finding]:
    """Verify protocol.json against the C handlers and the Python call
    sites. `files` are the SourceFiles to table-check + walk."""
    try:
        proto = load_protocol(protocol_path)
    except Exception as e:
        return [Finding("<protocol>", 1, RULE_DRIFT, "error",
                        f"cannot load protocol artifact "
                        f"{protocol_path}: {e}")]
    findings: List[Finding] = []
    try:
        with open(cc_path, encoding="utf-8") as f:
            cc_text = f.read()
    except OSError as e:
        return [Finding("<protocol>", 1, RULE_DRIFT, "error",
                        f"cannot read {cc_path}: {e}")]
    findings += check_c(proto, cc_text, cc_rel)
    for sf in files:
        findings += check_py_table(proto, sf)
        findings += check_reply_paths(proto, sf)
    findings += walk_call_sites(proto, files)
    return findings
