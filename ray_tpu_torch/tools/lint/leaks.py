"""Pass 4 — leak patterns.

asyncio event loops hold only weak references to tasks: a bare
``ensure_future(...)`` / ``create_task(...)`` whose result is dropped
can be garbage-collected mid-flight (GeneratorExit thrown into its
current await — the phantom WorkerCrashedError class utils/aio.spawn
exists to prevent). And an async def called without ``await`` never
runs at all. Both are flagged:

  unawaited-coroutine   expression-statement call of a known-async
                        function in the same module/class, not wrapped
                        in await/spawn/ensure_future/create_task/gather
  orphan-task           create_task/ensure_future result discarded
                        (neither stored nor given a done-callback);
                        use utils.aio.spawn
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ray_tpu_torch.tools.lint.common import (Finding, SourceFile, dotted_name)

RULE_CORO = "unawaited-coroutine"
RULE_TASK = "orphan-task"

_TASK_MAKERS = {"create_task", "ensure_future"}


def _collect_async_names(tree: ast.AST) -> Dict[str, Set[str]]:
    """{'': module-level async def names, ClassName: its async methods}."""
    table: Dict[str, Set[str]] = {"": set()}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            methods = {n.name for n in node.body
                       if isinstance(n, ast.AsyncFunctionDef)}
            table.setdefault(node.name, set()).update(methods)
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            table[""].add(node.name)
    return table


def run(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        table = _collect_async_names(sf.tree)
        all_methods: Set[str] = set()
        for methods in table.values():
            all_methods |= methods
        for qual, cls, fn in _iter_functions(sf.tree):
            findings.extend(_scan(sf, qual, cls, fn, table, all_methods))
    return [f for f in findings
            if not _suppressed(f, files)]


def _suppressed(f: Finding, files: List[SourceFile]) -> bool:
    for sf in files:
        if sf.path == f.path:
            return sf.annotations.allows(f.line, f.rule, blocking=False)
    return False


def _iter_functions(tree: ast.AST):
    """Yield (qualname, enclosing_class_or_None, fndef) for every def."""
    def walk(node, stack, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, stack + [child.name], child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                yield ".".join(stack + [child.name]), cls, child
                yield from walk(child, stack + [child.name], cls)
            else:
                yield from walk(child, stack, cls)
    yield from walk(tree, [], None)


def _walk_own(fn: ast.AST):
    """Walk fn's subtree without descending into nested defs — those are
    yielded by _iter_functions and scanned on their own visit."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


def _scan(sf: SourceFile, qual: str, cls: Optional[str], fn: ast.AST,
          table: Dict[str, Set[str]], all_methods: Set[str]
          ) -> List[Finding]:
    out: List[Finding] = []
    for stmt in _walk_own(fn):
        if not isinstance(stmt, ast.Expr):
            continue
        call = stmt.value
        if not isinstance(call, ast.Call):
            continue
        name = dotted_name(call.func)
        if name is None:
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _TASK_MAKERS:
            out.append(Finding(
                sf.path, call.lineno, RULE_TASK, "error",
                f"`{name}(...)` result discarded — the loop keeps only "
                "a weak ref, the task can be GC'd mid-flight; use "
                "utils.aio.spawn (or store the task / add a "
                "done-callback)", qual))
            continue
        if _is_local_async_call(name, cls, table, all_methods):
            out.append(Finding(
                sf.path, call.lineno, RULE_CORO, "error",
                f"coroutine `{name}(...)` is never awaited — the body "
                "never runs; await it or hand it to spawn()", qual))
    return out


def _is_local_async_call(name: str, cls: Optional[str],
                         table: Dict[str, Set[str]],
                         all_methods: Set[str]) -> bool:
    parts = name.split(".")
    if len(parts) == 1:
        return parts[0] in table[""]
    if len(parts) == 2 and parts[0] == "self":
        # any async method of any class in this module: conservative but
        # module-local, so no cross-file false positives
        return parts[1] in all_methods
    if parts[0] == "cls" and len(parts) == 2:
        return parts[1] in all_methods
    return False
