"""Pass 2 — lock discipline.

Two analyses over ``with`` / ``async with`` blocks whose context looks
lock-like (asyncio.Lock/Semaphore/Condition, threading.Lock — matched by
identifier shape, e.g. ``self._spill_lock``, ``gc_lock``, ``self._sem``):

1. await-under-lock: an ``await`` of an RPC / pubsub / store call while
   a lock is held parks the lock across a network round-trip — every
   other coroutine queuing on that lock now waits on a remote peer (the
   streaming-batch completion deadlock class). Condition-variable waits
   on the *held* condition are exempt (``await cv.wait()`` releases it).

2. lock-order graph: per module, nested acquisitions add a directed
   edge A->B (B taken while A held, identity = source text of the lock
   expression). An A->B and B->A pair is an inversion — the classic
   two-coroutine deadlock (round-5 FIFO lease bug family).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.tools.lint.common import (Finding, SourceFile, dotted_name,
                                       iter_async_functions)

RULE_AWAIT = "await-under-lock"
RULE_ORDER = "lock-order"

# Awaited method names that cross a process boundary (RPC transport,
# pubsub hub, store/kv handlers reached via .call are covered by "call").
_REMOTE_METHODS = {"call", "call_async", "publish", "drain",
                   "open_connection", "open_unix_connection"}

_LOCK_MARKERS = ("lock", "_sem", "sem_", "semaphore", "_cv", "cond",
                 "mutex")


def _is_lockish(expr: ast.AST) -> Optional[str]:
    """Return a stable identity string when expr names a lock."""
    name = dotted_name(expr)
    if name is None:
        # e.g. self._venv_locks.setdefault(key, Lock()) — use source text
        try:
            text = ast.unparse(expr)
        except Exception:  # pragma: no cover
            return None
        low = text.lower()
        return text if any(m in low for m in _LOCK_MARKERS) else None
    low = name.lower()
    if any(m in part for part in low.split(".") for m in _LOCK_MARKERS):
        return name
    return None


def run(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        edges: Dict[Tuple[str, str], Tuple[int, str]] = {}
        for qual, fn in iter_async_functions(sf.tree):
            findings.extend(_scan_fn(sf, qual, fn, edges))
        # Sync functions still contribute lock-order edges (threading
        # locks deadlock the same way).
        for qual, fn in _iter_sync_functions(sf.tree):
            _collect_edges(sf, qual, fn, edges, held=[])
        for (a, b), (line, qual) in sorted(edges.items()):
            if a != b and (b, a) in edges and a < b:
                other_line = edges[(b, a)][0]
                findings.append(Finding(
                    sf.path, line, RULE_ORDER, "error",
                    f"inconsistent lock order: `{a}` -> `{b}` here but "
                    f"`{b}` -> `{a}` at line {other_line}; pick one "
                    "order module-wide", qual))
    return [f for f in findings if not _suppressed(f, files)]


def _suppressed(f: Finding, files: List[SourceFile]) -> bool:
    for sf in files:
        if sf.path == f.path:
            return sf.annotations.allows(f.line, f.rule, blocking=False)
    return False


def _iter_sync_functions(tree: ast.AST):
    def walk(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, stack + [child.name])
            elif isinstance(child, ast.FunctionDef):
                yield ".".join(stack + [child.name]), child
                yield from walk(child, stack + [child.name])
            elif not isinstance(child, ast.AsyncFunctionDef):
                yield from walk(child, stack)
    yield from walk(tree, [])


def _scan_fn(sf: SourceFile, qual: str, fn: ast.AsyncFunctionDef,
             edges: Dict[Tuple[str, str], Tuple[int, str]]
             ) -> List[Finding]:
    findings: List[Finding] = []
    for stmt in fn.body:
        _walk_block(sf, qual, stmt, held=[], edges=edges,
                    findings=findings)
    return findings


def _collect_edges(sf, qual, fn, edges, held):
    for stmt in fn.body:
        _walk_block(sf, qual, stmt, held=held, edges=edges, findings=[])


def _walk_block(sf: SourceFile, qual: str, node: ast.AST,
                held: List[str],
                edges: Dict[Tuple[str, str], Tuple[int, str]],
                findings: List[Finding]) -> None:
    """Dispatch on NODE ITSELF (not its children): recursion hands body
    statements straight back in, and a nested `with` passed that way
    must still register its acquisitions."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
        return  # own schedule; visited separately
    if isinstance(node, (ast.With, ast.AsyncWith)):
        acquired: List[str] = []
        for item in node.items:
            # the context expression evaluates BEFORE the lock is held
            _walk_block(sf, qual, item.context_expr, held + acquired,
                        edges, findings)
            lock = _is_lockish(item.context_expr)
            if lock is not None:
                for h in held + acquired:
                    if h != lock:
                        edges.setdefault((h, lock), (node.lineno, qual))
                acquired.append(lock)
        for stmt in node.body:
            _walk_block(sf, qual, stmt, held + acquired, edges, findings)
        return
    if isinstance(node, ast.Await) and held:
        remote = _remote_call_name(node.value, held)
        if remote is not None:
            findings.append(Finding(
                sf.path, node.lineno, RULE_AWAIT, "error",
                f"`await {remote}` while holding `{held[-1]}` parks "
                "the lock across a remote round-trip; release the "
                "lock first or stage the call", qual))
    for child in ast.iter_child_nodes(node):
        _walk_block(sf, qual, child, held, edges, findings)


def _remote_call_name(expr: ast.AST, held: List[str]) -> Optional[str]:
    if not isinstance(expr, ast.Call):
        return None
    func = expr.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr not in _REMOTE_METHODS:
        return None
    name = dotted_name(func) or func.attr
    # `await cv.wait()` / `cv.wait_for()` on the held condition releases
    # it — but .call/.publish never do; nothing to exempt for those.
    return name
