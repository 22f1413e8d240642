"""Shared lint plumbing: findings, annotations, allowlist, file walking."""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple


@dataclass
class Finding:
    path: str          # repo-relative
    line: int
    rule: str          # e.g. "blocking-call", "await-under-lock"
    severity: str      # "error" | "warning"
    message: str
    qualname: str = ""  # enclosing Class.method, for stable allowlisting

    def render(self) -> str:
        where = f" [{self.qualname}]" if self.qualname else ""
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"{self.rule}: {self.message}{where}")


# --------------------------------------------------------------------------
# Inline annotations.
#
#   # lint: allow-blocking(<reason>)   — suppresses event-loop findings on
#                                        this line (or the line below the
#                                        comment); the reason is REQUIRED.
#   # lint: allow(<rule>: <reason>)    — same, for any rule.
# --------------------------------------------------------------------------
_ALLOW_BLOCKING = re.compile(r"#\s*lint:\s*allow-blocking\(([^)]*)\)")
_ALLOW_RULE = re.compile(r"#\s*lint:\s*allow\(([\w-]+)\s*:\s*([^)]*)\)")


@dataclass
class Annotations:
    """Per-file map line -> set of suppressed rules ('*blocking*' covers
    every event-loop rule). A comment on its own line covers the next
    code line too."""

    blocking_lines: Set[int] = field(default_factory=set)
    rule_lines: Dict[int, Set[str]] = field(default_factory=dict)
    bad: List[Tuple[int, str]] = field(default_factory=list)

    def allows(self, line: int, rule: str, blocking: bool) -> bool:
        if blocking and line in self.blocking_lines:
            return True
        return rule in self.rule_lines.get(line, ())


def parse_annotations(source: str) -> Annotations:
    ann = Annotations()
    lines = source.splitlines()
    for i, text in enumerate(lines, start=1):
        covered = (i, i + 1) if text.split("#", 1)[0].strip() == "" else (i,)
        m = _ALLOW_BLOCKING.search(text)
        if m:
            if not m.group(1).strip():
                ann.bad.append((i, "allow-blocking() requires a reason"))
            else:
                ann.blocking_lines.update(covered)
        m = _ALLOW_RULE.search(text)
        if m:
            if not m.group(2).strip():
                ann.bad.append((i, "allow(rule: reason) requires a reason"))
            else:
                for ln in covered:
                    ann.rule_lines.setdefault(ln, set()).add(m.group(1))
    return ann


# --------------------------------------------------------------------------
# Allowlist file: committed suppressions for findings that are deliberate
# but have no natural inline anchor (e.g. lock-order pairs). Format, one
# per line (reason AND expiry required; '#' comments and blanks skipped):
#
#   <repo-relative-path> : <rule> : <qualname> : <YYYY-MM> : <reason>
#
# The expiry month keeps suppressions from rotting: once the current
# month is past it, lint fails until the entry is re-justified (bump the
# date) or the underlying finding is fixed.
# --------------------------------------------------------------------------
_EXPIRY_RE = re.compile(r"^\d{4}-(0[1-9]|1[0-2])$")


@dataclass
class Allowlist:
    entries: List[Tuple[str, str, str, str, str]] = \
        field(default_factory=list)
    used: Set[int] = field(default_factory=set)

    def allows(self, f: Finding) -> bool:
        for i, (path, rule, qual, _expiry, _reason) in \
                enumerate(self.entries):
            if path == f.path and rule == f.rule and qual == f.qualname:
                self.used.add(i)
                return True
        return False

    def unused(self) -> List[Tuple[str, str, str, str, str]]:
        return [e for i, e in enumerate(self.entries) if i not in self.used]


def load_allowlist(path: Optional[str],
                   today: Optional[str] = None) -> Allowlist:
    """`today` is a 'YYYY-MM' override for tests; defaults to the
    current month. An entry expires when its month is strictly before
    today's (string comparison is correct for zero-padded ISO months)."""
    al = Allowlist()
    if not path or not os.path.exists(path):
        return al
    if today is None:
        import datetime
        today = datetime.date.today().strftime("%Y-%m")
    with open(path) as f:
        for ln, raw in enumerate(f, start=1):
            text = raw.strip()
            if not text or text.startswith("#"):
                continue
            parts = [p.strip() for p in text.split(":", 4)]
            if len(parts) != 5 or not parts[4]:
                raise SystemExit(
                    f"{path}:{ln}: allowlist entries are "
                    f"'path : rule : qualname : YYYY-MM : reason' "
                    f"(expiry and reason required)")
            if not _EXPIRY_RE.match(parts[3]):
                raise SystemExit(
                    f"{path}:{ln}: allowlist expiry '{parts[3]}' is not "
                    f"YYYY-MM")
            if parts[3] < today:
                raise SystemExit(
                    f"{path}:{ln}: allowlist entry for {parts[0]} "
                    f"({parts[1]}) expired {parts[3]} — fix the finding "
                    f"or re-justify with a new expiry")
            al.entries.append(tuple(parts))
    return al


# --------------------------------------------------------------------------
# Parsed-module cache + walking helpers.
# --------------------------------------------------------------------------
@dataclass
class SourceFile:
    path: str        # repo-relative, '/'-separated
    abspath: str
    source: str
    tree: ast.AST
    annotations: Annotations


# Several passes re-parse the same modules (the wire passes load the
# protocol files the AST passes already walked; the RPC pass reloads all
# of ray_tpu_torch/). Parsing dominates driver wall time, so cache per
# (abspath, repo_root), invalidated on mtime/size change.
_SOURCE_CACHE: Dict[Tuple[str, str], Tuple[int, int, SourceFile]] = {}


def load_source(abspath: str, repo_root: str) -> Optional[SourceFile]:
    key = (abspath, repo_root)
    try:
        st = os.stat(abspath)
    except OSError:
        return None
    cached = _SOURCE_CACHE.get(key)
    if cached is not None and cached[0] == st.st_mtime_ns and \
            cached[1] == st.st_size:
        return cached[2]
    with open(abspath, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=abspath)
    except SyntaxError:
        return None
    rel = os.path.relpath(abspath, repo_root).replace(os.sep, "/")
    sf = SourceFile(rel, abspath, source, tree, parse_annotations(source))
    _SOURCE_CACHE[key] = (st.st_mtime_ns, st.st_size, sf)
    return sf


def iter_py_files(paths: List[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", "_native")]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_async_functions(tree: ast.AST):
    """Yield (qualname, AsyncFunctionDef) for every async def, including
    nested ones (each gets its own visit)."""
    def walk(node: ast.AST, stack: List[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, stack + [child.name])
            elif isinstance(child, ast.AsyncFunctionDef):
                yield ".".join(stack + [child.name]), child
                yield from walk(child, stack + [child.name])
            elif isinstance(child, ast.FunctionDef):
                yield from walk(child, stack + [child.name])
            else:
                yield from walk(child, stack)
    yield from walk(tree, [])


# --------------------------------------------------------------------------
# Lightweight C/C++ region splitting shared by the native passes (4b/4c).
# Same -fsyntax-only-free philosophy as the wire passes: the house style
# in ray_tpu_torch/csrc/ is regular enough that identifier + balanced parens + '{' is a
# reliable function-definition detector.
# --------------------------------------------------------------------------
_C_NONFUNC = {"if", "for", "while", "switch", "catch", "return", "sizeof",
              "else", "do", "defined", "alignof", "alignas", "decltype"}
_C_FN_RE = re.compile(r"\b([A-Za-z_]\w*)\s*\(")


def match_brace(text: str, open_pos: int) -> int:
    """Index just past the '}' matching text[open_pos] == '{' (len(text)
    when unbalanced). No string/comment awareness — good enough for the
    house C++ style these passes target."""
    depth = 0
    for i in range(open_pos, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def split_c_functions(text: str) -> List[Tuple[str, int, int, int]]:
    """[(name, body_open, body_end, line)] for each function definition
    in a C/C++ file: identifier + balanced parens + optional
    const/noexcept/override/ctor-init + '{'. Candidates inside an
    already-claimed body (calls, local blocks) are skipped so each
    offset belongs to at most one region; prototypes (no '{') and
    control keywords never match."""
    out: List[Tuple[str, int, int, int]] = []
    claimed_end = -1
    for m in _C_FN_RE.finditer(text):
        if m.start() < claimed_end:
            continue
        name = m.group(1)
        if name in _C_NONFUNC:
            continue
        depth, j = 0, m.end() - 1
        while j < len(text):
            if text[j] == "(":
                depth += 1
            elif text[j] == ")":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        if j >= len(text):
            continue
        tail = re.match(r"\s*(?:const\b\s*|noexcept\b\s*|override\b\s*)*"
                        r"(?::\s*[^{;]*)?\{", text[j + 1:])
        if tail is None:
            continue
        body_open = j + 1 + tail.end() - 1
        body_end = match_brace(text, body_open)
        out.append((name, body_open, body_end,
                    text.count("\n", 0, m.start()) + 1))
        claimed_end = body_end
    return out


def iter_body_nodes(fn: ast.AST, *, into_sync_defs: bool = False):
    """Walk a function body WITHOUT descending into nested function or
    lambda definitions: nested defs execute on their own schedule (thread
    pools, executors, callbacks), so their bodies are not 'lexically on
    the event loop' even when the enclosing def is async."""
    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)) and not into_sync_defs:
                continue
            yield child
            yield from walk(child)
    yield from walk(fn)
