"""Pass 4c: error-path resource (fd/inode) discipline for ray_tpu_torch/csrc.

Every descriptor acquired in a function (open/openat/socket/accept/
epoll_create1/memfd_create/pipe/MakePipe/eventfd/...) must reach a
close/unlink — or provably escape to a longer-lived owner — on *every*
exit of that function. The failure mode this hunts is the ENOSPC/EINTR
unwind: the happy path closes everything, the third error branch added
last quarter closes two of the three fds, and a node under disk
pressure bleeds descriptors until accept() returns EMFILE. graftshm
multiplies fd handoffs (one memfd per large object), so this gets worse
before it gets better.

This is a *lexical under-approximation* chosen for zero false
positives rather than completeness:

  * A resource is "live" at an exit if it was acquired lexically before
    the exit and neither released (close/unlink of the same name) nor
    escaped (returned; stored into an escaping owner, a member of a
    parameter, or a `new`-ed object that itself escapes) earlier.
  * If the code contains ANY validity test of the resource name
    (`fd < 0`, `== -1`, `!p`, `== nullptr`, ...) between acquisition
    and the exit, the exit is skipped: the test means the code branches
    on acquisition success and a lexical scan cannot tell which side of
    the branch the exit is on.
  * Short-circuit rule: when an exit is guarded by a condition that
    itself contains acquiring calls (`if (MakePipe(&a,&b) != 0 ||
    MakePipe(&c,&d) != 0) { ... return; }`), only the LAST acquiring
    call in the condition may have failed without acquiring — its
    resources are skipped; every earlier call succeeded (short-circuit
    evaluation) and its resources ARE checked on that exit. This is
    exactly the shape that leaks in practice.

Suppression: `// lint: allow(fd-leak: reason)` or the allowlist keyed
by function name.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.tools.lint.common import Finding, match_brace, \
    split_c_functions
from ray_tpu_torch.tools.lint.memorder import (_in_comment, _line_of,
                                         _match_paren, c_allowed_lines)

RULE = "fd-leak"

_FD_CALLS = (r"open|openat|creat|socket|accept4?|epoll_create1?|"
             r"memfd_create|dup2?|eventfd2?|inotify_init1?|signalfd4?|"
             r"timerfd_create")
_ACQ_ASSIGN = re.compile(
    r"([A-Za-z_][\w>.\[\]-]*)\s*=\s*(?:::)?(%s)\s*\(" % _FD_CALLS)
_PIPE_CALL = re.compile(r"\b(\w*[Pp]ipe2?\w*)\s*\(")
_OWNER_DECL = re.compile(r"\b(\w+)\s*=\s*new\s+\w")
_RELEASE_FNS = r"close|store_client_close|unlink\w*"


class _Res:
    __slots__ = ("names", "call_pos", "line", "fn")

    def __init__(self, name: str, call_pos: int, line: int, fn: str):
        self.names = [name]
        self.call_pos = call_pos
        self.line = line
        self.fn = fn


def _base(name: str) -> str:
    m = re.match(r"[A-Za-z_]\w*", name)
    return m.group(0) if m else name


def _collect_acquisitions(text: str, start: int, end: int) -> List[_Res]:
    out: List[_Res] = []
    for m in _ACQ_ASSIGN.finditer(text, start, end):
        if _in_comment(text, m.start()):
            continue
        out.append(_Res(m.group(1), m.start(), _line_of(text, m.start()),
                        m.group(2)))
    for m in _PIPE_CALL.finditer(text, start, end):
        if _in_comment(text, m.start()):
            continue
        close = _match_paren(text, m.end() - 1)
        args = text[m.end():close]
        outs = re.findall(r"&\s*([A-Za-z_][\w>.\[\]-]*)", args)
        if not outs and re.match(r"\s*[A-Za-z_][\w>.\[\]-]*\s*[,)]", args):
            outs = [args.split(",")[0].strip().rstrip(")")]
        if not outs:
            continue
        res = _Res(outs[0], m.start(), _line_of(text, m.start()),
                   m.group(1))
        res.names = outs
        out.append(res)
    return out


def _collect_ifs(text: str, start: int, end: int):
    """(cond_start, cond_end, block_start, block_end) for each if."""
    out = []
    for m in re.finditer(r"\bif\s*\(", text[start:end]):
        pos = start + m.start()
        if _in_comment(text, pos):
            continue
        cond_open = start + m.end() - 1
        cond_close = _match_paren(text, cond_open)
        after = re.match(r"\s*\{", text[cond_close + 1:])
        if after:
            block_open = cond_close + 1 + after.end() - 1
            block_end = match_brace(text, block_open)
        else:
            block_open = cond_close + 1
            semi = text.find(";", block_open)
            block_end = (semi + 1) if semi != -1 else end
        out.append((cond_open, cond_close, block_open, block_end))
    return out


def _validity_tested(text: str, name: str, start: int, end: int) -> bool:
    e = re.escape(name)
    pat = (r"(?:%s\s*(?:<\s*0|<=\s*-1|[=!]=\s*-1|>=\s*0|>\s*0|"
           r"[=!]=\s*nullptr)|!\s*%s\b)" % (e, e))
    return re.search(pat, text[start:end]) is not None


def _released(text: str, names: List[str], start: int, end: int) -> bool:
    for name in names:
        pat = r"(?:::)?(?:%s)\s*\(\s*%s\b" % (_RELEASE_FNS,
                                              re.escape(name))
        if re.search(pat, text[start:end]):
            return True
    return False


def _escape_pos(text: str, res: _Res, owners: Dict[str, int],
                owner_escapes: Dict[str, int], start: int,
                end: int) -> Optional[int]:
    """Earliest position at which the resource provably escapes to a
    longer-lived owner (or is returned), or None."""
    best: Optional[int] = None

    def consider(pos: Optional[int]):
        nonlocal best
        if pos is not None and (best is None or pos < best):
            best = pos

    region = text[start:end]
    for name in list(res.names):
        e = re.escape(name)
        m = re.search(r"\breturn\s+%s\b" % e, region)
        consider(start + m.start() if m else None)
        # Stored into a new-ed object's initializer.
        for nm in re.finditer(r"\bnew\s+\w+", region):
            stmt_end = region.find(";", nm.end())
            stmt = region[nm.start():stmt_end if stmt_end != -1 else None]
            if re.search(r"\b%s\b" % e, stmt):
                consider(start + nm.start())
        # Assigned into something else: local/owner member -> alias,
        # parameter/member of unknown base -> escape.
        for am in re.finditer(
                r"([A-Za-z_][\w>.\[\]-]*)\s*=\s*%s\s*[;,)]" % e, region):
            target = am.group(1)
            if target in res.names:
                continue
            if re.fullmatch(r"[A-Za-z_]\w*", target) or \
                    _base(target) in owners:
                if target not in res.names:
                    res.names.append(target)
            else:
                consider(start + am.start())
        # The owner the resource lives in escapes.
        ob = _base(name)
        if ob in owner_escapes and ("->" in name or "." in name or
                                    name != ob):
            consider(owner_escapes[ob])
    return best


def check_file(text: str, rel: str) -> List[Finding]:
    out: List[Finding] = []
    allowed = c_allowed_lines(text)
    seen = set()
    for fn_name, body_open, body_end, _fn_line in split_c_functions(text):
        start, end = body_open, body_end
        acqs = _collect_acquisitions(text, start, end)
        if not acqs:
            continue
        owners = {m.group(1): m.start()
                  for m in _OWNER_DECL.finditer(text, start, end)}
        owner_escapes: Dict[str, int] = {}
        for o in owners:
            e = re.escape(o)
            m = re.search(r"(?:\breturn\s+%s\b|=\s*%s\s*[;,)])" % (e, e),
                          text[start:end])
            if m:
                owner_escapes[o] = start + m.start()
        ifs = _collect_ifs(text, start, end)
        exits = [m.start() for m in re.finditer(r"\breturn\b", text[
            start:end]) if not _in_comment(text, start + m.start())]
        exits = [start + p for p in exits]
        exits.append(end)  # falling off the end is an exit too
        for res in acqs:
            esc = _escape_pos(text, res, owners, owner_escapes, start,
                              end)
            for E in exits:
                if E <= res.call_pos:
                    continue
                if esc is not None and esc <= E:
                    continue
                if any(_validity_tested(text, n, res.call_pos, E)
                       for n in res.names):
                    continue
                # Short-circuit rule: guarded by a condition containing
                # this acquiring call -> only the LAST call in the
                # condition may have failed un-acquired.
                skip = False
                for cs, ce, bs, be in ifs:
                    if bs <= E < be:
                        in_cond = sorted(a.call_pos for a in acqs
                                         if cs <= a.call_pos < ce)
                        if in_cond and res.call_pos == in_cond[-1]:
                            skip = True
                            break
                if skip:
                    continue
                if _released(text, res.names, res.call_pos, E):
                    continue
                line = _line_of(text, min(E, len(text) - 1))
                key = (rel, line, res.names[0])
                if key in seen:
                    continue
                seen.add(key)
                if RULE in allowed.get(line, ()) or \
                        RULE in allowed.get(res.line, ()):
                    continue
                out.append(Finding(
                    rel, line, RULE, "error",
                    f"fd leak: '{res.names[0]}' from {res.fn}() at line "
                    f"{res.line} is neither closed nor escaped on this "
                    f"exit path (error unwinds bleed descriptors)",
                    fn_name))
    return out


def run(cc_files: List[Tuple[str, str]]) -> List[Finding]:
    """cc_files: [(abspath, repo_relative_path)]."""
    findings: List[Finding] = []
    for abspath, rel in cc_files:
        try:
            with open(abspath, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        findings += check_file(text, rel)
    return findings
