"""Pass 1 — event-loop safety.

Flags blocking work lexically inside ``async def`` bodies: a single
blocking call on the io loop stalls every RPC, lease heartbeat, and
pubsub long-poll sharing that loop (the io-loop submission deadlock of
round 5 was exactly this class). Nested sync ``def``s are skipped — they
run on executors/threads, not the loop (see iter_body_nodes).

Escape hatch: ``# lint: allow-blocking(<reason>)`` on (or directly
above) the flagged line; the reason string is mandatory.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ray_tpu_torch.tools.lint.common import (Finding, SourceFile, dotted_name,
                                       iter_async_functions, iter_body_nodes)

RULE = "blocking-call"

# Dotted-name suffixes that always block the calling thread. Matched
# against the trailing components of the call's dotted name, so both
# `time.sleep` and an aliased `sleep` import hit.
BLOCKING_CALLS: Dict[str, str] = {
    "time.sleep": "time.sleep blocks the event loop; use asyncio.sleep",
    "subprocess.run": "subprocess.run blocks; use asyncio.create_subprocess_exec or an executor",
    "subprocess.call": "subprocess.call blocks; use asyncio.create_subprocess_exec or an executor",
    "subprocess.check_call": "subprocess.check_call blocks; use an executor",
    "subprocess.check_output": "subprocess.check_output blocks; use an executor",
    "os.system": "os.system blocks; use asyncio.create_subprocess_shell",
    "os.popen": "os.popen blocks; use an executor",
    "os.waitpid": "os.waitpid blocks; use an executor or child-watcher",
    "socket.create_connection": "synchronous connect blocks; use asyncio.open_connection",
    "urllib.request.urlopen": "synchronous HTTP blocks; use an executor",
    "api.get": "api.get drives a blocking event-loop round-trip; await the ref instead",
    "api.wait": "api.wait blocks; use asyncio.wait on the refs",
}

# Synchronous file I/O openers (tmpfs metadata taps are sometimes
# deliberate on the loop — annotate those with a measured reason).
FILE_IO_CALLS: Set[str] = {"open", "os.open", "io.open"}

# os-level read/write on raw fds (data-plane copies must go to an
# executor; see core_worker._store_put's >4MiB rule).
FD_IO_CALLS: Set[str] = {"os.read", "os.write", "os.pread", "os.pwrite",
                         "os.sendfile"}

# The blocking C store client: one C round-trip per op over a unix
# socket, no event loop on either side. Any attribute path through a
# fastpath handle used inside async code blocks the loop.
_FASTPATH_MARKERS = ("fastpath", "fast_client", "faststore")

# Methods whose receiver chain marks them as the blocking store client
# even without a fastpath-named attribute in the chain.
_SYNC_CLIENT_METHODS: Set[str] = set()

# Direct producers of concurrent.futures.Future: calling .result() on
# these from the loop thread deadlocks (the future needs the very loop
# that is now parked in .result()).
_FUTURE_PRODUCERS = {"_run", "run_coroutine_threadsafe", "call_async"}


def _matches(dotted: str, table) -> Optional[str]:
    """Suffix-match `dotted` against table keys ('time.sleep' matches
    'time.sleep' and 'x.time.sleep' but not 'mytime.sleep')."""
    for key in table:
        if dotted == key or dotted.endswith("." + key):
            return key
    return None


def run(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        for line, msg in sf.annotations.bad:
            findings.append(Finding(sf.path, line, "bad-annotation",
                                    "error", msg))
        for qual, fn in iter_async_functions(sf.tree):
            findings.extend(_scan_async_fn(sf, qual, fn))
    return [f for f in findings
            if not _suppressed(f, files)]


def _suppressed(f: Finding, files: List[SourceFile]) -> bool:
    for sf in files:
        if sf.path == f.path:
            return sf.annotations.allows(f.line, f.rule,
                                         blocking=f.rule == RULE)
    return False


def _scan_async_fn(sf: SourceFile, qual: str,
                   fn: ast.AsyncFunctionDef) -> List[Finding]:
    out: List[Finding] = []
    # name -> assigned from a concurrent-future producer in this body
    future_vars: Set[str] = set()
    for node in iter_body_nodes(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            prod = _producer_name(node.value)
            if prod in _FUTURE_PRODUCERS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        future_vars.add(tgt.id)
        if not isinstance(node, ast.Call):
            continue
        # fut.result() on a concurrent future from the loop thread.
        # Checked FIRST: a chained producer (`self._run(c).result()`)
        # has a Call in its attribute chain, so dotted_name is None.
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "result"):
            base = node.func.value
            chained = (isinstance(base, ast.Call)
                       and _producer_name(base) in _FUTURE_PRODUCERS)
            via_var = isinstance(base, ast.Name) and base.id in future_vars
            if chained or via_var:
                out.append(Finding(
                    sf.path, node.lineno, RULE, "error",
                    "blocking .result() on a concurrent future inside "
                    "async def deadlocks the loop that must fulfil it; "
                    "await the coroutine directly", qual))
                continue
        name = dotted_name(node.func)
        if name is None:
            continue
        hit = _matches(name, BLOCKING_CALLS)
        if hit:
            out.append(Finding(sf.path, node.lineno, RULE, "error",
                               BLOCKING_CALLS[hit], qual))
            continue
        if _matches(name, dict.fromkeys(FILE_IO_CALLS)):
            out.append(Finding(
                sf.path, node.lineno, RULE, "error",
                f"synchronous file open `{name}` on the event loop; "
                "use run_in_executor (or annotate a bounded tmpfs tap)",
                qual))
            continue
        if _matches(name, dict.fromkeys(FD_IO_CALLS)):
            out.append(Finding(
                sf.path, node.lineno, RULE, "error",
                f"synchronous fd I/O `{name}` on the event loop; "
                "move the copy to an executor", qual))
            continue
        if any(m in part.lower() for part in name.split(".")
               for m in _FASTPATH_MARKERS):
            out.append(Finding(
                sf.path, node.lineno, RULE, "error",
                f"blocking C store client call `{name}` inside async "
                "def; route through the agent RPC or an executor", qual))
    return out


def _producer_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None
