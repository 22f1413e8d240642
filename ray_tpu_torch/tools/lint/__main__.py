"""graftlint driver.

    python -m ray_tpu_torch.tools.lint [paths...] [options]

With no paths: lints the framework control plane (ray_tpu_torch/core,
ray_tpu_torch/serve, ray_tpu_torch/data), checks the store wire schema against
ray_tpu_torch/csrc/store_server.cc, and cross-checks RPC call sites across all of
ray_tpu_torch/. Exits 1 when findings remain after annotations + allowlist.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ray_tpu_torch.tools.lint import event_loop, hotpath, leaks, locks, \
    memorder, protocol, resource_paths, rpc_signatures, wire_schema
from ray_tpu_torch.tools.lint.common import (Finding, SourceFile,
                                             iter_py_files, load_allowlist,
                                             load_source)

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
# Every default input lies in the port's own package (its C++ too).
_PKG = "ray_tpu_torch"
_DEFAULT_PATHS = [f"{_PKG}/core", f"{_PKG}/serve", f"{_PKG}/data"]
_DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(__file__),
                                  "allowlist.txt")


def _load(paths: List[str], root: str) -> List[SourceFile]:
    out = []
    for p in iter_py_files(paths):
        sf = load_source(p, root)
        if sf is not None:
            out.append(sf)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.lint",
        description="framework-aware static analysis for ray_tpu_torch")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs for the AST passes "
                         f"(default: {' '.join(_DEFAULT_PATHS)})")
    ap.add_argument("--root", default=_REPO_ROOT,
                    help="repo root for relative finding paths")
    ap.add_argument("--store-py", default=None,
                    help="Python side of the store wire schema "
                         "(default: ray_tpu_torch/core/object_store.py)")
    ap.add_argument("--store-cc", default=None,
                    help="C side of the store wire schema "
                         "(default: ray_tpu_torch/csrc/store_server.cc)")
    ap.add_argument("--no-wire", action="store_true",
                    help="skip the wire-schema drift pass")
    ap.add_argument("--graft-py", default=None,
                    help="Python side of the graftrpc frame schema "
                         "(default: ray_tpu_torch/core/_native/graftrpc.py)")
    ap.add_argument("--graft-cc", default=None,
                    help="C side of the graftrpc frame schema "
                         "(default: ray_tpu_torch/csrc/rpc_core.cc)")
    ap.add_argument("--scope-py", default=None,
                    help="Python side of the graftscope record schema "
                         "(default: ray_tpu_torch/core/_native/graftscope.py)")
    ap.add_argument("--scope-cc", default=None,
                    help="C side of the graftscope record schema "
                         "(default: ray_tpu_torch/csrc/scope_core.h)")
    ap.add_argument("--pulse-py", default=None,
                    help="Python side of the graftpulse record schema "
                         "(default: ray_tpu_torch/core/_native/graftpulse.py)")
    ap.add_argument("--pulse-cc", default=None,
                    help="C side of the graftpulse record schema "
                         "(default: ray_tpu_torch/csrc/scope_core.h)")
    ap.add_argument("--prof-py", default=None,
                    help="Python side of the graftprof record schema "
                         "(default: ray_tpu_torch/core/_native/graftprof.py)")
    ap.add_argument("--prof-cc", default=None,
                    help="C side of the graftprof record schema "
                         "(default: ray_tpu_torch/csrc/prof_core.h)")
    ap.add_argument("--log-py", default=None,
                    help="Python side of the graftlog record schema "
                         "(default: ray_tpu_torch/core/_native/graftlog.py)")
    ap.add_argument("--log-cc", default=None,
                    help="C side of the graftlog record schema "
                         "(default: ray_tpu_torch/csrc/log_core.h)")
    ap.add_argument("--rpc-root", default=None,
                    help="root scanned for RPC call sites/handlers "
                         "(default: ray_tpu_torch/); 'none' disables")
    ap.add_argument("--protocol", default=protocol.DEFAULT_PROTOCOL,
                    help="checked protocol state-machine artifact "
                         "(default: tools/lint/protocol.json)")
    ap.add_argument("--no-protocol", action="store_true",
                    help="skip the protocol state-machine pass (4a)")
    ap.add_argument("--budgets", default=hotpath.DEFAULT_BUDGETS,
                    help="checked hot-path cost budget artifact "
                         "(default: tools/lint/budgets.json)")
    ap.add_argument("--no-hotpath", action="store_true",
                    help="skip the hot-path round-trip budget pass (4d)")
    ap.add_argument("--hotpath-only", action="store_true",
                    help="run only the hot-path budget pass (4d) — the "
                         "make lint-hotpath edit loop")
    ap.add_argument("--costs", action="store_true",
                    help="print the derived per-op round-trip cost table "
                         "and exit")
    ap.add_argument("--native-only", action="store_true",
                    help="run only the native passes: memory-order "
                         "discipline (4b) + error-path fd leaks (4c)")
    ap.add_argument("--allowlist", default=_DEFAULT_ALLOWLIST,
                    help="committed allowlist file")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings")
    ap.add_argument("--list-passes", action="store_true")
    args = ap.parse_args(argv)

    if args.list_passes:
        print("event-loop  blocking calls inside async def")
        print("locks       await-under-lock + lock-order inversions")
        print("wire        Python<->C store schema + RPC arity drift")
        print("leaks       un-awaited coroutines, orphaned tasks")
        print("protocol    store op state machine vs protocol.json (4a)")
        print("memorder    atomics memory-order discipline in the C++ (4b)")
        print("fd-leak     error-path close/unlink coverage in the C++ (4c)")
        print("hotpath     per-op round-trip costs vs budgets.json (4d)")
        return 0

    root = os.path.abspath(args.root)
    explicit_paths = bool(args.paths)
    allow = load_allowlist(args.allowlist)

    def hotpath_walk() -> List[SourceFile]:
        out: List[SourceFile] = []
        for rel in hotpath.WALK_FILES:
            p = os.path.join(root, rel.replace("/", os.sep))
            sf = load_source(p, root) if os.path.exists(p) else None
            if sf is not None:
                out.append(sf)
        return out

    if args.costs:
        proto = protocol.load_protocol(args.protocol)
        print(hotpath.cost_table(args.budgets, hotpath_walk(), proto))
        return 0

    if args.hotpath_only:
        proto = protocol.load_protocol(args.protocol)
        findings = hotpath.check(args.budgets, hotpath_walk(), proto)
        kept = [f for f in findings if not allow.allows(f)]
        kept.sort(key=lambda f: (f.path, f.line, f.rule))
        if args.json:
            print(json.dumps([f.__dict__ for f in kept], indent=2))
        else:
            for f in kept:
                print(f.render())
            print(f"graftlint (hotpath): {len(kept)} finding(s) "
                  f"({len(findings) - len(kept)} allowlisted)",
                  file=sys.stderr)
        return 1 if kept else 0

    def native_cc_files():
        csrc = os.path.join(root, _PKG, "csrc")
        names = []
        if os.path.isdir(csrc):
            names = sorted(n for n in os.listdir(csrc)
                           if n.endswith((".cc", ".h"))
                           and "_test" not in n)
        return [(os.path.join(csrc, n), f"{_PKG}/csrc/{n}") for n in names]

    if args.native_only:
        findings = memorder.run(native_cc_files())
        findings += resource_paths.run(native_cc_files())
        kept = [f for f in findings if not allow.allows(f)]
        kept.sort(key=lambda f: (f.path, f.line, f.rule))
        if args.json:
            print(json.dumps([f.__dict__ for f in kept], indent=2))
        else:
            for f in kept:
                print(f.render())
            print(f"graftlint (native): {len(kept)} finding(s) "
                  f"({len(findings) - len(kept)} allowlisted)",
                  file=sys.stderr)
        return 1 if kept else 0

    paths = [p if os.path.isabs(p) else os.path.join(root, p)
             for p in (args.paths or _DEFAULT_PATHS)]
    files = _load(paths, root)

    findings: List[Finding] = []
    findings += event_loop.run(files)
    findings += locks.run(files)
    findings += leaks.run(files)

    if not args.no_wire:
        py_path = args.store_py or os.path.join(
            root, _PKG, "core", "object_store.py")
        cc_path = args.store_cc or os.path.join(
            root, _PKG, "csrc", "store_server.cc")
        if os.path.exists(py_path) and os.path.exists(cc_path):
            findings += wire_schema.run(
                py_path, cc_path,
                os.path.relpath(py_path, root).replace(os.sep, "/"),
                os.path.relpath(cc_path, root).replace(os.sep, "/"))
        elif args.store_py or args.store_cc or not explicit_paths:
            findings.append(Finding(
                "<wire>", 1, wire_schema.RULE, "error",
                f"wire schema sources missing: {py_path} / {cc_path}"))
        g_py = args.graft_py or os.path.join(
            root, _PKG, "core", "_native", "graftrpc.py")
        g_cc = args.graft_cc or os.path.join(
            root, _PKG, "csrc", "rpc_core.cc")
        if os.path.exists(g_py) and os.path.exists(g_cc):
            findings += wire_schema.run_graft(
                g_py, g_cc,
                os.path.relpath(g_py, root).replace(os.sep, "/"),
                os.path.relpath(g_cc, root).replace(os.sep, "/"))
        elif args.graft_py or args.graft_cc or not explicit_paths:
            findings.append(Finding(
                "<wire>", 1, wire_schema.RULE, "error",
                f"graftrpc schema sources missing: {g_py} / {g_cc}"))
        # Pass 3e: graftscope flight-recorder record schema.
        s_py = args.scope_py or os.path.join(
            root, _PKG, "core", "_native", "graftscope.py")
        s_cc = args.scope_cc or os.path.join(
            root, _PKG, "csrc", "scope_core.h")
        if os.path.exists(s_py) and os.path.exists(s_cc):
            findings += wire_schema.run_scope(
                s_py, s_cc,
                os.path.relpath(s_py, root).replace(os.sep, "/"),
                os.path.relpath(s_cc, root).replace(os.sep, "/"))
        elif args.scope_py or args.scope_cc or not explicit_paths:
            findings.append(Finding(
                "<wire>", 1, wire_schema.RULE, "error",
                f"graftscope schema sources missing: {s_py} / {s_cc}"))
        # Pass 3f: graftpulse telemetry record schema.
        p_py = args.pulse_py or os.path.join(
            root, _PKG, "core", "_native", "graftpulse.py")
        p_cc = args.pulse_cc or os.path.join(
            root, _PKG, "csrc", "scope_core.h")
        if os.path.exists(p_py) and os.path.exists(p_cc):
            findings += wire_schema.run_pulse(
                p_py, p_cc,
                os.path.relpath(p_py, root).replace(os.sep, "/"),
                os.path.relpath(p_cc, root).replace(os.sep, "/"))
        elif args.pulse_py or args.pulse_cc or not explicit_paths:
            findings.append(Finding(
                "<wire>", 1, wire_schema.RULE, "error",
                f"graftpulse schema sources missing: {p_py} / {p_cc}"))
        # Pass 3g: graftprof sample record schema.
        pr_py = args.prof_py or os.path.join(
            root, _PKG, "core", "_native", "graftprof.py")
        pr_cc = args.prof_cc or os.path.join(
            root, _PKG, "csrc", "prof_core.h")
        if os.path.exists(pr_py) and os.path.exists(pr_cc):
            findings += wire_schema.run_prof(
                pr_py, pr_cc,
                os.path.relpath(pr_py, root).replace(os.sep, "/"),
                os.path.relpath(pr_cc, root).replace(os.sep, "/"))
        elif args.prof_py or args.prof_cc or not explicit_paths:
            findings.append(Finding(
                "<wire>", 1, wire_schema.RULE, "error",
                f"graftprof schema sources missing: {pr_py} / {pr_cc}"))
        # Pass 3h: graftlog crash-persistent log record schema.
        lg_py = args.log_py or os.path.join(
            root, _PKG, "core", "_native", "graftlog.py")
        lg_cc = args.log_cc or os.path.join(
            root, _PKG, "csrc", "log_core.h")
        if os.path.exists(lg_py) and os.path.exists(lg_cc):
            findings += wire_schema.run_log(
                lg_py, lg_cc,
                os.path.relpath(lg_py, root).replace(os.sep, "/"),
                os.path.relpath(lg_cc, root).replace(os.sep, "/"))
        elif args.log_py or args.log_cc or not explicit_paths:
            findings.append(Finding(
                "<wire>", 1, wire_schema.RULE, "error",
                f"graftlog schema sources missing: {lg_py} / {lg_cc}"))
        # Pass 3d: ctypes binding signatures vs the C exports of every
        # translation unit in the shared library.
        ct_py = args.store_py or os.path.join(
            root, _PKG, "core", "object_store.py")
        ct_ccs = [os.path.join(root, _PKG, "csrc", f)
                  for f in ("object_store.cc", "store_server.cc",
                            "copy_core.cc", "scope_core.cc",
                            "prof_core.cc", "log_core.cc")]
        ct_ccs_found = [p for p in ct_ccs if os.path.exists(p)]
        if os.path.exists(ct_py) and ct_ccs_found:
            findings += wire_schema.run_ctypes(
                ct_py, ct_ccs_found,
                os.path.relpath(ct_py, root).replace(os.sep, "/"),
                [os.path.relpath(p, root).replace(os.sep, "/")
                 for p in ct_ccs_found])
        elif not explicit_paths:
            findings.append(Finding(
                "<wire>", 1, wire_schema.RULE, "error",
                f"ctypes schema sources missing: {ct_py} / {ct_ccs}"))

    # Pass 4a: store op protocol state machine vs the committed
    # artifact (tools/lint/protocol.json). Walks the canonical client
    # files only — receiver inference is tuned for them.
    if not args.no_wire and not args.no_protocol:
        cc_path = args.store_cc or os.path.join(
            root, _PKG, "csrc", "store_server.cc")
        walk: List[SourceFile] = []
        for rel in protocol.WALK_FILES:
            p = os.path.join(root, rel.replace("/", os.sep))
            sf = load_source(p, root) if os.path.exists(p) else None
            if sf is not None:
                walk.append(sf)
        if os.path.exists(cc_path) and walk:
            findings += protocol.run(
                args.protocol, cc_path,
                os.path.relpath(cc_path, root).replace(os.sep, "/"),
                walk)
        elif not explicit_paths:
            findings.append(Finding(
                "<protocol>", 1, protocol.RULE_DRIFT, "error",
                f"protocol pass sources missing: {cc_path} / "
                f"{', '.join(protocol.WALK_FILES)}"))

    # Pass 4d: hot-path round-trip costs vs the committed budget
    # artifact (tools/lint/budgets.json). Same walk discipline as 4a:
    # canonical files only, receiver inference tuned for them.
    if not args.no_wire and not args.no_hotpath:
        walk = hotpath_walk()
        if walk:
            proto = protocol.load_protocol(args.protocol)
            findings += hotpath.check(args.budgets, walk, proto)
        elif not explicit_paths:
            findings.append(Finding(
                "<hotpath>", 1, hotpath.RULE_DRIFT, "error",
                f"hotpath pass sources missing: "
                f"{', '.join(hotpath.WALK_FILES)}"))

    # Passes 4b/4c: memory-order + error-path fd discipline over the
    # native planes (skipped when linting explicit fixture paths).
    if not explicit_paths:
        cc_files = native_cc_files()
        if cc_files:
            findings += memorder.run(cc_files)
            findings += resource_paths.run(cc_files)

    if args.rpc_root != "none":
        rpc_root = args.rpc_root or os.path.join(root, _PKG)
        rpc_files = _load([rpc_root], root)
        handlers = rpc_signatures.collect_handlers(rpc_files)
        if handlers:
            findings += rpc_signatures.check_call_sites(rpc_files,
                                                        handlers)
        elif not explicit_paths:
            findings.append(Finding(
                "<rpc>", 1, rpc_signatures.RULE_UNKNOWN, "error",
                "no registered RPC handler classes found under "
                f"{rpc_root} (register_object(self) sites)"))

    kept = [f for f in findings if not allow.allows(f)]
    kept.sort(key=lambda f: (f.path, f.line, f.rule))

    if args.json:
        print(json.dumps([f.__dict__ for f in kept], indent=2))
    else:
        for f in kept:
            print(f.render())
        for path, rule, qual, expiry, reason in allow.unused():
            print(f"note: unused allowlist entry {path}:{rule}:{qual} "
                  f"(expires {expiry}; {reason})", file=sys.stderr)
        n_suppressed = len(findings) - len(kept)
        print(f"graftlint: {len(kept)} finding(s) "
              f"({n_suppressed} allowlisted) across {len(files)} files",
              file=sys.stderr)
    return 1 if kept else 0


if __name__ == "__main__":
    sys.exit(main())
