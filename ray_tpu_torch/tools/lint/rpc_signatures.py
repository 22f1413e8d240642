"""Pass 3b — RPC handler-signature drift.

`RpcServer.register_object(obj)` exposes every public async method of
the registered object by NAME; call sites reach them as
`client.call("<method>", *args, **kwargs)`. Nothing ties the two ends
together at import time, so renaming a handler or changing its
parameters breaks callers only at runtime. This pass rebuilds both
sides from the AST:

  * handler classes = every class whose body contains a
    `<server>.register_object(self, ...)` call (Controller, NodeAgent,
    CoreWorker today), public `async def`s only, honoring the `prefix`
    argument;
  * call sites = every `.call("name", ...)` / `.call_async("name", ...)`
    with a constant method name,

then simulates the argument binding. A `timeout=` keyword the handler
does not accept is tolerated (SyncRpcClient consumes it at the
transport layer); `*args` / `**kwargs` splats at the call site skip the
check.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ray_tpu_torch.tools.lint.common import Finding, SourceFile

RULE_ARITY = "rpc-arity-drift"
RULE_UNKNOWN = "rpc-unknown-method"

_TRANSPORT_KWARGS = {"timeout"}


@dataclass
class HandlerSig:
    cls: str
    method: str
    path: str
    line: int
    positional: List[str] = field(default_factory=list)  # after self
    defaults: int = 0
    vararg: bool = False
    kwonly: List[str] = field(default_factory=list)
    kwonly_required: Set[str] = field(default_factory=set)
    kwarg: bool = False

    def describe(self) -> str:
        parts = list(self.positional)
        if self.defaults:
            for i in range(len(parts) - self.defaults, len(parts)):
                parts[i] += "=..."
        if self.vararg:
            parts.append("*args")
        for k in self.kwonly:
            parts.append(f"{k}=..." if k not in self.kwonly_required
                         else f"*, {k}")
        if self.kwarg:
            parts.append("**kwargs")
        return f"{self.cls}.{self.method}({', '.join(parts)})"

    def binds(self, npos: int, kws: Set[str]) -> Optional[str]:
        """None if the call binds, else a human-readable reason."""
        kws = {k for k in kws
               if not (k in _TRANSPORT_KWARGS
                       and k not in self.positional
                       and k not in self.kwonly and not self.kwarg)}
        if npos > len(self.positional) and not self.vararg:
            return (f"takes at most {len(self.positional)} positional "
                    f"args, got {npos}")
        filled = set(self.positional[:npos])
        for k in kws:
            if k in filled:
                return f"got multiple values for {k!r}"
            if k not in self.positional and k not in self.kwonly \
                    and not self.kwarg:
                return f"got an unexpected keyword {k!r}"
        required = set(self.positional[:len(self.positional)
                                       - self.defaults])
        missing = required - filled - kws
        if missing:
            return f"missing required args: {sorted(missing)}"
        missing_kw = self.kwonly_required - kws
        if missing_kw:
            return f"missing required keyword args: {sorted(missing_kw)}"
        return None


def collect_handlers(files: List[SourceFile]) -> Dict[str, List[HandlerSig]]:
    table: Dict[str, List[HandlerSig]] = {}
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            prefix = _registered_prefix(node)
            if prefix is None:
                continue
            for item in node.body:
                if not isinstance(item, ast.AsyncFunctionDef):
                    continue
                if item.name.startswith("_"):
                    continue
                sig = _signature(node.name, item, sf.path)
                table.setdefault(prefix + item.name, []).append(sig)
    return table


def _registered_prefix(cls: ast.ClassDef) -> Optional[str]:
    """Non-None (the registration prefix) when the class body contains
    `<x>.register_object(self, ...)`."""
    for node in ast.walk(cls):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "register_object"
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == "self"):
            prefix = ""
            for kw in node.keywords:
                if kw.arg == "prefix" and isinstance(kw.value,
                                                     ast.Constant):
                    prefix = kw.value.value
            if len(node.args) > 1 and isinstance(node.args[1],
                                                 ast.Constant):
                prefix = node.args[1].value
            return prefix
    return None


def _signature(cls: str, fn: ast.AsyncFunctionDef, path: str) -> HandlerSig:
    a = fn.args
    names = [arg.arg for arg in a.posonlyargs + a.args]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return HandlerSig(
        cls=cls, method=fn.name, path=path, line=fn.lineno,
        positional=names, defaults=len(a.defaults),
        vararg=a.vararg is not None,
        kwonly=[arg.arg for arg in a.kwonlyargs],
        kwonly_required={arg.arg for i, arg in enumerate(a.kwonlyargs)
                         if a.kw_defaults[i] is None},
        kwarg=a.kwarg is not None)


def check_call_sites(files: List[SourceFile],
                     handlers: Dict[str, List[HandlerSig]]
                     ) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("call", "call_async")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            method = node.args[0].value
            candidates = handlers.get(method)
            if candidates is None:
                findings.append(Finding(
                    sf.path, node.lineno, RULE_UNKNOWN, "error",
                    f'call("{method}", ...) matches no public async '
                    "method on any registered RPC object "
                    "(Controller/NodeAgent/CoreWorker)"))
                continue
            if any(isinstance(arg, ast.Starred) for arg in node.args) \
                    or any(kw.arg is None for kw in node.keywords):
                continue  # splat: arity not statically known
            npos = len(node.args) - 1
            kws = {kw.arg for kw in node.keywords}
            reasons = []
            for sig in candidates:
                reason = sig.binds(npos, kws)
                if reason is None:
                    reasons = []
                    break
                reasons.append(f"{sig.describe()}: {reason}")
            if reasons:
                findings.append(Finding(
                    sf.path, node.lineno, RULE_ARITY, "error",
                    f'call("{method}", ...) does not bind: '
                    + "; ".join(reasons)))
    return [f for f in findings if not _suppressed(f, files)]


def _suppressed(f: Finding, files: List[SourceFile]) -> bool:
    for sf in files:
        if sf.path == f.path:
            return sf.annotations.allows(f.line, f.rule, blocking=False)
    return False


def run(handler_files: List[SourceFile],
        call_site_files: List[SourceFile]) -> List[Finding]:
    handlers = collect_handlers(handler_files)
    if not handlers:
        return [Finding("<rpc>", 1, RULE_UNKNOWN, "error",
                        "no registered RPC handler classes found "
                        "(register_object(self) sites)")]
    return check_call_sites(call_site_files, handlers)
