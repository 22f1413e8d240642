"""Pass 4b: memory-order discipline for the native planes.

The lock-free structures in ray_tpu_torch/csrc/ (graftscope's single-writer rings,
graftcopy's claim cursors, the sidecar/rpc shutdown flags) are correct
because of *specific* acquire/release pairings, and nothing enforced
them: a drive-by `fetch_add` without an order silently upgrades to
seq_cst (hiding the intent and costing a fence on ARM), and a relaxed
store that another thread acquires is a real reorder bug TSAN only
catches if the interleaving happens under test.

No clang available — same regex/tokenizer approach as the ctypes pass
(3d), which the house C++ style in ray_tpu_torch/csrc/ makes reliable. Rules:

  * memory-order / implicit seq_cst: every std::atomic operation must
    name an explicit std::memory_order_* — `x.load()` and bare
    `s->flag` reads/assignments (operator overloads = implicit seq_cst)
    are flagged. Naming the order is the documentation: relaxed says
    "standalone counter", acquire/release says "publication edge".
  * memory-order / missing release bridge: if an atomic has any
    acquire-class reader (acquire/acq_rel/seq_cst load or RMW) in the
    file, then a relaxed write to it must be followed, in the same
    function, by a release-class write to *some* atomic — otherwise
    nothing orders the relaxed write before the reader's acquire and
    the "published" value can be observed without its payload. The
    known-good shapes this models:
      - scope_core ring: relaxed payload stores + head.store(release),
        head.load(acquire) + lap re-check on the drain side;
      - copy_core pool: next.fetch_add(relaxed) claim cursor, err CAS
        relaxed, done.fetch_add(acq_rel) as the publishing edge,
        done.load(acquire) on the waiter.
    Pure-relaxed atomics (stat counters, mutex-guarded flags) have no
    acquire readers and are clean by construction.
  * spin-no-backoff: an atomic_flag test_and_set spin loop whose body
    has no pause/yield/backoff burns a hardware thread (and on SMT
    starves the lock holder); require a cpu-relax hint in the loop.

Suppression: `// lint: allow(<rule>: <reason>)` on (or right above) the
line, or the committed allowlist keyed by the enclosing function name.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.tools.lint.common import (Finding, match_brace,
                                       split_c_functions)

RULE = "memory-order"
RULE_SPIN = "spin-no-backoff"

_METHODS = ("load", "store", "exchange", "fetch_add", "fetch_sub",
            "fetch_or", "fetch_and", "fetch_xor",
            "compare_exchange_strong", "compare_exchange_weak",
            "test_and_set", "clear")
_METHODS_RE = "|".join(_METHODS)
_READS = {"load", "exchange", "fetch_add", "fetch_sub", "fetch_or",
          "fetch_and", "fetch_xor", "compare_exchange_strong",
          "compare_exchange_weak", "test_and_set"}
_WRITES = {"store", "exchange", "fetch_add", "fetch_sub", "fetch_or",
           "fetch_and", "fetch_xor", "compare_exchange_strong",
           "compare_exchange_weak", "test_and_set", "clear"}

_ACQUIRE = {"acquire", "acq_rel", "seq_cst"}
_RELEASE = {"release", "acq_rel", "seq_cst"}

_ATOMIC_DECL = re.compile(
    r"std::atomic(?:_flag\s+|\s*<[^;>]*>\s+)(\w+)\s*[\[{;=(]")
_ORDER_TOKEN = re.compile(r"memory_order_(\w+)")

_C_ALLOW = re.compile(r"//\s*lint:\s*allow\(([\w-]+)\s*:\s*([^)]*)\)")


def c_allowed_lines(text: str) -> Dict[int, set]:
    """line -> rules suppressed by `// lint: allow(rule: reason)`; a
    comment on its own line also covers the next line."""
    out: Dict[int, set] = {}
    for i, ln in enumerate(text.splitlines(), start=1):
        m = _C_ALLOW.search(ln)
        if m and m.group(2).strip():
            covered = (i, i + 1) if ln.strip().startswith("//") else (i,)
            for c in covered:
                out.setdefault(c, set()).add(m.group(1))
    return out


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _in_comment(text: str, pos: int) -> bool:
    ls = text.rfind("\n", 0, pos) + 1
    return "//" in text[ls:pos]


def _match_paren(text: str, open_pos: int) -> int:
    depth = 0
    for i in range(open_pos, len(text)):
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
            if depth == 0:
                return i
    return len(text)


class _Op:
    __slots__ = ("name", "method", "orders", "pos", "line", "implicit")

    def __init__(self, name, method, orders, pos, line, implicit):
        self.name, self.method = name, method
        self.orders, self.pos, self.line = orders, pos, line
        self.implicit = implicit

    @property
    def is_read(self) -> bool:
        return self.method in _READS

    @property
    def is_write(self) -> bool:
        return self.method in _WRITES

    @property
    def acquire_read(self) -> bool:
        return self.is_read and bool(set(self.orders) & _ACQUIRE)

    @property
    def release_write(self) -> bool:
        return self.is_write and bool(set(self.orders) & _RELEASE)

    @property
    def relaxed_write(self) -> bool:
        # A write is "relaxed" for the bridge rule only when it names no
        # ordering at all: an acquire RMW (test_and_set(acquire) lock
        # idiom) gets its pairing from the clear(release) in unlock.
        return self.is_write and not self.release_write and \
            not (set(self.orders) & _ACQUIRE)


def collect_atomics(text: str) -> Dict[str, int]:
    return {m.group(1): _line_of(text, m.start())
            for m in _ATOMIC_DECL.finditer(text)}


def collect_ops(text: str, atomics: Dict[str, int]) -> List[_Op]:
    ops: List[_Op] = []
    for name in atomics:
        op_re = re.compile(
            r"\b%s\s*(?:\[[^\]]*\]\s*)*\.\s*(%s)\s*\("
            % (re.escape(name), _METHODS_RE))
        for m in op_re.finditer(text):
            if _in_comment(text, m.start()):
                continue
            close = _match_paren(text, m.end() - 1)
            args = text[m.end():close]
            orders = _ORDER_TOKEN.findall(args)
            implicit = not orders
            ops.append(_Op(name, m.group(1),
                           orders or ["seq_cst"], m.start(),
                           _line_of(text, m.start()), implicit))
    ops.sort(key=lambda o: o.pos)
    return ops


def collect_bare_accesses(text: str, atomics: Dict[str, int]):
    """(name, pos, line, is_write) for member accesses of an atomic that
    bypass load()/store() — C++'s operator overloads make them implicit
    seq_cst, and they hide the publication intent entirely. Restricted
    to `.`/`->` prefixed uses so same-named locals don't match."""
    out = []
    lines = text.splitlines()
    for name in atomics:
        bare_re = re.compile(
            r"(?:->|\.)\s*(%s)\b(?!\s*(?:\[[^\]]*\]\s*)*\s*"
            r"(?:\.\s*(?:%s)\s*\(|\())" % (re.escape(name), _METHODS_RE))
        for m in bare_re.finditer(text):
            line = _line_of(text, m.start())
            src = lines[line - 1] if line <= len(lines) else ""
            if "std::atomic" in src or src.lstrip().startswith("//"):
                continue
            if _in_comment(text, m.start()):
                continue
            rest = text[m.end():]
            is_write = bool(re.match(r"\s*=(?!=)", rest))
            out.append((name, m.start(), line, is_write))
    return out


def check_spin_loops(text: str, rel: str, allowed, regions) -> \
        List[Finding]:
    out: List[Finding] = []
    for m in re.finditer(r"\bwhile\s*\(", text):
        close = _match_paren(text, m.end() - 1)
        cond = text[m.end():close]
        if "test_and_set" not in cond:
            continue
        after = re.match(r"\s*\{", text[close + 1:])
        if after:
            body_open = close + 1 + after.end() - 1
            body = text[body_open:match_brace(text, body_open)]
        else:
            semi = text.find(";", close + 1)
            body = text[close + 1:semi + 1]
        if re.search(r"pause|yield|relax|backoff|sleep", body,
                     re.IGNORECASE):
            continue
        line = _line_of(text, m.start())
        if RULE_SPIN in allowed.get(line, ()):
            continue
        out.append(Finding(
            rel, line, RULE_SPIN, "error",
            "atomic_flag spin loop with no pause/backoff in the body: "
            "add a cpu-relax hint (__builtin_ia32_pause / yield) so the "
            "spinner doesn't starve the flag holder",
            _region_name(regions, m.start())))
    return out


def _region_name(regions, pos: int) -> str:
    for name, body_open, body_end, _line in regions:
        if body_open <= pos < body_end:
            return name
    return ""


def check_file(text: str, rel: str,
               extra_atomics: Optional[Dict[str, int]] = None) -> \
        List[Finding]:
    out: List[Finding] = []
    allowed = c_allowed_lines(text)
    regions = split_c_functions(text)
    atomics = dict(extra_atomics or {})
    atomics.update(collect_atomics(text))
    ops = collect_ops(text, atomics)

    def flag(line, pos, msg, rule=RULE):
        if rule in allowed.get(line, ()):
            return
        out.append(Finding(rel, line, rule, "error", msg,
                           _region_name(regions, pos)))

    for op in ops:
        if op.implicit:
            flag(op.line, op.pos,
                 f"implicit seq_cst: {op.name}.{op.method}() must name "
                 f"a std::memory_order (relaxed for standalone "
                 f"counters, acquire/release for publication edges)")
    for name, pos, line, is_write in collect_bare_accesses(text, atomics):
        kind = "assignment to" if is_write else "read of"
        fix = ".store(v, order)" if is_write else ".load(order)"
        flag(line, pos,
             f"bare {kind} atomic '{name}' is an implicit seq_cst "
             f"operation: use {fix} with an explicit memory order")

    # Release-bridge rule: a relaxed write to an atomic with acquire
    # readers must be followed (same function) by a release-class write.
    acquired = {op.name for op in ops if op.acquire_read}
    release_positions = [op.pos for op in ops if op.release_write]
    for op in ops:
        if not op.relaxed_write or op.name not in acquired:
            continue
        region = None
        for r in regions:
            if r[1] <= op.pos < r[2]:
                region = r
                break
        if region is None:
            continue
        if any(op.pos < p < region[2] for p in release_positions):
            continue
        flag(op.line, op.pos,
             f"relaxed {op.method} to '{op.name}' has acquire-class "
             f"readers in this file but no release-class write follows "
             f"in this function: nothing publishes it (no "
             f"happens-before edge to the readers)")

    out += check_spin_loops(text, rel, allowed, regions)
    return out


def run(cc_files: List[Tuple[str, str]]) -> List[Finding]:
    """cc_files: [(abspath, repo_relative_path)]. Headers (.h) in the
    list contribute their atomic declarations to every .cc that
    #includes them (scope_core's ring atomics live in scope_core.h),
    and are themselves checked too."""
    texts: List[Tuple[str, str, str]] = []
    for abspath, rel in cc_files:
        try:
            with open(abspath, encoding="utf-8") as f:
                texts.append((abspath, rel, f.read()))
        except OSError:
            continue
    header_decls = {os.path.basename(rel): collect_atomics(text)
                    for _a, rel, text in texts if rel.endswith(".h")}
    findings: List[Finding] = []
    for _abspath, rel, text in texts:
        extra: Dict[str, int] = {}
        for hname, decls in header_decls.items():
            if re.search(r'#\s*include\s*"%s"' % re.escape(hname), text):
                extra.update(decls)
        findings += check_file(text, rel, extra)
    return findings
