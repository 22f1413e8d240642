"""The port's graftlint (ray_tpu_torch.tools.lint) held against every case
of tests/test_lint.py, with each input pointed at the port's tree
(ray_tpu_torch/ and ray_tpu_torch/csrc/): pass fixtures + CLI gate, and
the regression tests for the four fixes that shipped with the linter
(ingest-name pid-namespace collision, async function-export race,
controller durable-store fail-fast, content-derived batch-LLM seeds).
Three cases of its own close the file: the default run walks only the
port's files, a lock planted in a copy of the port's tree fails it, and
the two packages' lints agree on the same fixtures.

Every negative fixture here is the drift the linter exists to catch:
if a test starts failing because the repo itself regressed (not the
linter), fix the repo — the CI lint stage gates on the same passes.
"""

import asyncio
import os
import textwrap
import threading
from types import SimpleNamespace

import pytest

from ray_tpu_torch.tools.lint import (event_loop, hotpath, leaks, locks,
                                      memorder, protocol, resource_paths,
                                      rpc_signatures, wire_schema)
from ray_tpu_torch.tools.lint.__main__ import main as lint_main
from ray_tpu_torch.tools.lint.common import (load_allowlist, load_source,
                                             split_c_functions)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_PY = os.path.join(REPO, "ray_tpu_torch", "core", "object_store.py")
STORE_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "store_server.cc")


def _sf(tmp_path, source, name="mod.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    sf = load_source(str(p), str(tmp_path))
    assert sf is not None, "fixture failed to parse"
    return sf


def _rules(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------------
# pass 1 — event-loop safety
# ---------------------------------------------------------------------------

def test_blocking_sleep_in_async_def_flagged(tmp_path):
    sf = _sf(tmp_path, """
        import time

        async def poll():
            time.sleep(0.5)
    """)
    fs = event_loop.run([sf])
    assert _rules(fs) == ["blocking-call"]
    assert fs[0].qualname == "poll"
    assert "asyncio.sleep" in fs[0].message


def test_sync_defs_and_executor_bodies_not_flagged(tmp_path):
    # time.sleep in a plain def, and in a nested def handed to an
    # executor, both run OFF the loop — neither may be flagged.
    sf = _sf(tmp_path, """
        import time

        def worker():
            time.sleep(1)
            open("/tmp/x")

        async def dispatch(loop):
            def _copy():
                time.sleep(1)
                open("/tmp/y")
            await loop.run_in_executor(None, _copy)
    """)
    assert event_loop.run([sf]) == []


def test_file_io_api_get_and_fastpath_flagged(tmp_path):
    sf = _sf(tmp_path, """
        from ray_tpu_torch import api

        class W:
            async def handler(self, ref):
                open("/etc/hosts")
                api.get(ref)
                self._fastpath.ingest(b"oid", "name", 1, 0)
    """)
    fs = event_loop.run([sf])
    assert _rules(fs) == ["blocking-call"] * 3
    assert {f.qualname for f in fs} == {"W.handler"}


def test_result_on_concurrent_future_flagged(tmp_path):
    sf = _sf(tmp_path, """
        class W:
            async def handler(self):
                fut = self._run(self.refresh())
                fut.result()
                self._run(self.refresh()).result()
                done, _ = await self.wait_all()
                done.result()  # plain var: not a known producer
    """)
    fs = event_loop.run([sf])
    assert _rules(fs) == ["blocking-call"] * 2
    assert all(".result()" in f.message for f in fs)


def test_allow_blocking_annotation_needs_reason(tmp_path):
    sf = _sf(tmp_path, """
        import time

        async def tap():
            time.sleep(0.01)  # lint: allow-blocking(bounded tmpfs tap, measured 40us)

        async def sloppy():
            # lint: allow-blocking()
            time.sleep(0.01)
    """)
    fs = event_loop.run([sf])
    # tap: suppressed. sloppy: empty reason => bad-annotation AND the
    # blocking finding stays.
    assert _rules(fs) == ["bad-annotation", "blocking-call"]
    assert fs[1].qualname == "sloppy" or fs[0].qualname == "sloppy"


def test_allow_comment_on_own_line_covers_next_line(tmp_path):
    sf = _sf(tmp_path, """
        import time

        async def tap():
            # lint: allow-blocking(diagnostics-only; bounded)
            time.sleep(0.01)
    """)
    assert event_loop.run([sf]) == []


# ---------------------------------------------------------------------------
# pass 2 — lock discipline
# ---------------------------------------------------------------------------

def test_await_rpc_under_lock_flagged(tmp_path):
    sf = _sf(tmp_path, """
        class A:
            async def refresh(self):
                async with self._table_lock:
                    await self.agent.call("pull_object", b"oid")
    """)
    fs = locks.run([sf])
    assert _rules(fs) == ["await-under-lock"]
    assert "self._table_lock" in fs[0].message


def test_await_outside_lock_and_local_await_under_lock_clean(tmp_path):
    sf = _sf(tmp_path, """
        class A:
            async def refresh(self):
                await self.agent.call("pull_object", b"oid")
                async with self._table_lock:
                    await self._rebuild_index()
    """)
    assert locks.run([sf]) == []


def test_lock_order_inversion_flagged(tmp_path):
    sf = _sf(tmp_path, """
        class A:
            async def forward(self):
                async with self._a_lock:
                    async with self._b_lock:
                        self.n += 1

            async def backward(self):
                async with self._b_lock:
                    async with self._a_lock:
                        self.n -= 1
    """)
    fs = locks.run([sf])
    assert _rules(fs) == ["lock-order"]
    assert "self._a_lock" in fs[0].message \
        and "self._b_lock" in fs[0].message


def test_consistent_lock_order_clean(tmp_path):
    sf = _sf(tmp_path, """
        class A:
            async def forward(self):
                async with self._a_lock:
                    async with self._b_lock:
                        self.n += 1

            async def also_forward(self):
                async with self._a_lock:
                    async with self._b_lock:
                        self.n -= 1
    """)
    assert locks.run([sf]) == []


def test_sync_functions_contribute_lock_order_edges(tmp_path):
    # threading locks deadlock the same way: one sync side of the
    # inversion must still be seen.
    sf = _sf(tmp_path, """
        class A:
            def sync_side(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            async def async_side(self):
                async with self._b_lock:
                    async with self._a_lock:
                        pass
    """)
    assert _rules(locks.run([sf])) == ["lock-order"]


# ---------------------------------------------------------------------------
# pass 4 — leak patterns
# ---------------------------------------------------------------------------

def test_unawaited_coroutine_and_orphan_task_flagged(tmp_path):
    sf = _sf(tmp_path, """
        import asyncio

        class A:
            async def work(self):
                return 1

            def kick(self):
                self.work()

            async def ok(self):
                await self.work()
                asyncio.create_task(self.work())
                t = asyncio.create_task(self.work())
                t.add_done_callback(print)
    """)
    fs = leaks.run([sf])
    assert _rules(fs) == ["orphan-task", "unawaited-coroutine"]


def test_spawned_and_awaited_coroutines_clean(tmp_path):
    sf = _sf(tmp_path, """
        from ray_tpu_torch.utils.aio import spawn

        class A:
            async def work(self):
                return 1

            async def ok(self):
                await self.work()
                self._spawn(self.work())
                spawn(self.work())
    """)
    assert leaks.run([sf]) == []


# ---------------------------------------------------------------------------
# pass 3a — wire-schema drift (Python store client vs C store server)
# ---------------------------------------------------------------------------

def test_wire_schema_repo_in_sync():
    fs = wire_schema.run(STORE_PY, STORE_CC, "py", "cc")
    assert fs == [], [f.render() for f in fs]


def _mutated_cc(tmp_path, old, new):
    with open(STORE_CC) as f:
        text = f.read()
    assert old in text, f"fixture drifted: {old!r} not in store_server.cc"
    p = tmp_path / "store_server.cc"
    p.write_text(text.replace(old, new, 1))
    return str(p)


def test_wire_schema_detects_opcode_flip(tmp_path):
    cc = _mutated_cc(tmp_path, "kOpDelete = 4", "kOpDelete = 6")
    fs = wire_schema.run(STORE_PY, cc, "py", "cc")
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("delete" in f.message for f in fs), \
        [f.render() for f in fs]


def test_wire_schema_detects_struct_width_change(tmp_path):
    cc = _mutated_cc(tmp_path, "uint64_t size;", "uint32_t size;")
    fs = wire_schema.run(STORE_PY, cc, "py", "cc")
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("size" in f.message.lower() for f in fs), \
        [f.render() for f in fs]


def test_wire_schema_detects_origin_width_drift(tmp_path):
    # grafttrail provenance rides the journal's origin byte; widening it
    # on the C side shifts every field behind it, so the pass must flag
    # both the origin itself and the knock-on oid/size displacement.
    cc = _mutated_cc(tmp_path, "uint8_t origin;", "uint16_t origin;")
    fs = wire_schema.run(STORE_PY, cc, "py", "cc")
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("origin" in f.message for f in fs), \
        [f.render() for f in fs]
    assert any("oid" in f.message for f in fs), \
        [f.render() for f in fs]


def test_wire_schema_detects_origin_slice_drift(tmp_path):
    # Python reading a 2-byte origin that C packs as a single byte.
    py = _mutated(tmp_path, STORE_PY, "rec[1:2]", "rec[1:3]",
                  "object_store.py")
    fs = wire_schema.run(py, STORE_CC, "py", "cc")
    assert fs and any("origin" in f.message for f in fs), \
        [f.render() for f in fs]


def test_wire_schema_detects_origin_drain_clobber(tmp_path):
    # A drain memcpy landing the oid at offset 1 silently overwrites the
    # origin byte — every object record decodes with plane "copy".
    cc = _mutated_cc(tmp_path,
                     "std::memcpy(buf + n + 2, e.oid, kIdSize);",
                     "std::memcpy(buf + n + 1, e.oid, kIdSize);")
    fs = wire_schema.run(STORE_PY, cc, "py", "cc")
    assert fs and any("oid" in f.message and "offset 1" in f.message
                      for f in fs), [f.render() for f in fs]


# ---------------------------------------------------------------------------
# pass 3b — RPC handler-signature drift
# ---------------------------------------------------------------------------

# NOTE: indented to match the 8-space base of the in-test fragments it
# is concatenated with, so the shared textwrap.dedent strips both evenly.
_RPC_HANDLERS = """
        class Widget:
            def __init__(self, server):
                server.register_object(self)

            async def frob(self, a, b, flag=False):
                return a

            async def _private(self, x):
                return x
"""


def test_rpc_call_sites_bind_against_handlers(tmp_path):
    sf = _sf(tmp_path, _RPC_HANDLERS + """
        async def good(client):
            await client.call("frob", 1, 2)
            await client.call("frob", 1, b=2, flag=True)
            await client.call("frob", 1, 2, timeout=5.0)
    """)
    handlers = rpc_signatures.collect_handlers([sf])
    assert set(handlers) == {"frob"}  # public async defs only
    assert rpc_signatures.check_call_sites([sf], handlers) == []


def test_rpc_arity_and_unknown_method_flagged(tmp_path):
    sf = _sf(tmp_path, _RPC_HANDLERS + """
        async def bad(client):
            await client.call("frob", 1, 2, 3, 4)
            await client.call("frob", 1, 2, wrong=1)
            await client.call("frob", 1)
            await client.call("defrobulate", 1)
    """)
    handlers = rpc_signatures.collect_handlers([sf])
    fs = rpc_signatures.check_call_sites([sf], handlers)
    assert _rules(fs) == ["rpc-arity-drift"] * 3 + ["rpc-unknown-method"]


def test_rpc_register_prefix_honored(tmp_path):
    sf = _sf(tmp_path, """
        class Gadget:
            def __init__(self, server):
                server.register_object(self, prefix="g_")

            async def spin(self, rpm):
                return rpm

        async def call_it(client):
            await client.call("g_spin", 100)
            await client.call("spin", 100)
    """)
    handlers = rpc_signatures.collect_handlers([sf])
    assert set(handlers) == {"g_spin"}
    fs = rpc_signatures.check_call_sites([sf], handlers)
    assert _rules(fs) == ["rpc-unknown-method"]  # unprefixed name


def test_rpc_repo_handlers_collected():
    files = []
    for base in ("core",):
        d = os.path.join(REPO, "ray_tpu_torch", base)
        for name in os.listdir(d):
            if name.endswith(".py"):
                sf = load_source(os.path.join(d, name), REPO)
                if sf:
                    files.append(sf)
    handlers = rpc_signatures.collect_handlers(files)
    # The three registered control-plane objects must be discovered.
    classes = {sig.cls for sigs in handlers.values() for sig in sigs}
    assert {"Controller", "NodeAgent", "CoreWorker"} <= classes


# ---------------------------------------------------------------------------
# driver / CLI
# ---------------------------------------------------------------------------

def test_cli_clean_on_repo(capsys):
    # THE gate: the framework control plane lints clean with the
    # committed allowlist (`python -m ray_tpu_torch.tools.lint`, no
    # arguments: the invocation chip_smoke.py's planes phase runs).
    rc = lint_main([])
    out = capsys.readouterr()
    assert rc == 0, out.out + out.err


def test_cli_nonzero_on_bad_fixture(tmp_path, capsys):
    p = tmp_path / "bad.py"
    p.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    rc = lint_main([str(p), "--root", str(tmp_path), "--no-wire",
                    "--rpc-root", "none", "--allowlist", ""])
    assert rc == 1
    assert "blocking-call" in capsys.readouterr().out


def test_cli_allowlist_suppresses_by_qualname(tmp_path, capsys):
    p = tmp_path / "mod.py"
    p.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    al = tmp_path / "allow.txt"
    al.write_text(
        "mod.py : blocking-call : f : 2099-12 : deliberate test fixture\n")
    rc = lint_main([str(p), "--root", str(tmp_path), "--no-wire",
                    "--rpc-root", "none", "--allowlist", str(al)])
    assert rc == 0, capsys.readouterr().out


def test_allowlist_reason_required(tmp_path):
    al = tmp_path / "allow.txt"
    al.write_text("mod.py : blocking-call : f : 2099-12 :\n")
    with pytest.raises(SystemExit):
        load_allowlist(str(al))


def test_allowlist_expiry_required_and_validated(tmp_path):
    al = tmp_path / "allow.txt"
    # Legacy 4-field entries (no expiry) must be rejected outright.
    al.write_text("mod.py : blocking-call : f : some reason\n")
    with pytest.raises(SystemExit):
        load_allowlist(str(al))
    al.write_text("mod.py : blocking-call : f : 2099-13 : reason\n")
    with pytest.raises(SystemExit):  # month 13 is not a month
        load_allowlist(str(al))


def test_allowlist_expired_entry_fails_lint(tmp_path):
    al = tmp_path / "allow.txt"
    al.write_text("mod.py : blocking-call : f : 2024-01 : stale excuse\n")
    with pytest.raises(SystemExit, match="expired"):
        load_allowlist(str(al))
    # Injectable clock: the same entry is fine while the month lasts.
    assert len(load_allowlist(str(al), today="2024-01").entries) == 1
    assert len(load_allowlist(str(al), today="2023-12").entries) == 1
    with pytest.raises(SystemExit, match="expired"):
        load_allowlist(str(al), today="2024-02")


def test_source_cache_reuses_parsed_ast(tmp_path):
    # The wire/RPC passes reload files the AST passes already walked;
    # the mtime+size-validated cache must hand back the same object,
    # and invalidate when the file changes.
    p = tmp_path / "m.py"
    p.write_text("x = 1\n")
    a = load_source(str(p), str(tmp_path))
    b = load_source(str(p), str(tmp_path))
    assert a is b
    os.utime(str(p), (1, 1))
    p.write_text("x = 2  # different size\n")
    c = load_source(str(p), str(tmp_path))
    assert c is not a and "x = 2" in c.source


# ---------------------------------------------------------------------------
# r5 advisor regression tests (the fixes that shipped with this linter)
# ---------------------------------------------------------------------------

def test_ingest_names_unique_across_pid_namespaces():
    # Containerized workers each think they are pid 1: the name must
    # disambiguate on worker_id, not just (pid, seq).
    from ray_tpu_torch.core.core_worker import CoreWorker

    def fake(hexid):
        return SimpleNamespace(_fastpath_lock=threading.Lock(),
                               _ingest_seq=0,
                               worker_id=SimpleNamespace(hex=lambda: hexid))

    a, b = fake("aa" * 20), fake("bb" * 20)
    na = CoreWorker._next_ingest_name(a)
    nb = CoreWorker._next_ingest_name(b)
    assert na != nb          # same pid + same seq, different workers
    assert "aa" * 8 in na and "bb" * 8 in nb
    assert CoreWorker._next_ingest_name(a) != na  # seq advances


def test_pending_export_reopens_retry_window():
    # Re-submitting a cached function while its background export is
    # still in flight must keep async_export=True so executors keep
    # their retry window (the r5 async function-export race).
    from ray_tpu_torch.core.core_worker import CoreWorker

    def func():
        return 1

    fid = b"\x01" * 20
    w = SimpleNamespace(_func_id_cache={func: fid},
                        _pending_exports={fid})
    assert CoreWorker._export_function(w, func) == (fid, True)
    w._pending_exports.clear()
    assert CoreWorker._export_function(w, func) == (fid, False)


def test_export_bg_failure_unmarks_and_clears_pending():
    from ray_tpu_torch.core.core_worker import CoreWorker

    fid = b"\x02" * 20
    w = SimpleNamespace(_exported_funcs={fid}, _pending_exports={fid})

    async def boom():
        raise RuntimeError("kv down")

    asyncio.run(CoreWorker._export_bg(w, fid, boom()))
    assert fid not in w._pending_exports   # retry window closed
    assert fid not in w._exported_funcs    # next submission re-exports

    w = SimpleNamespace(_exported_funcs={fid}, _pending_exports={fid})

    async def ok():
        return None

    asyncio.run(CoreWorker._export_bg(w, fid, ok()))
    assert fid not in w._pending_exports
    assert fid in w._exported_funcs


def test_controller_fails_fast_on_unopenable_durable_store(tmp_path):
    from ray_tpu_torch.core.controller import Controller
    from ray_tpu_torch.core.store_client import MemoryStoreClient
    from ray_tpu_torch.utils.config import GlobalConfig

    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    bad = str(blocker / "state.db")  # parent is a file: cannot open
    try:
        GlobalConfig.initialize({"gcs_storage_path": bad})
        with pytest.raises(RuntimeError, match="failed to open"):
            Controller()
        # Explicit override: degrade to empty in-memory state, loudly.
        GlobalConfig.initialize({"gcs_storage_allow_empty_start": True})
        c = Controller()
        assert isinstance(c._store, MemoryStoreClient)
    finally:
        GlobalConfig._overrides.clear()
        GlobalConfig._cache.clear()


def test_batch_llm_row_seed_content_derived():
    # Seeds derive from (configured seed, prompt token ids) — NOT the
    # row's position in its batch — so reruns reproduce regardless of
    # batch_size and distinct prompts get distinct Gumbel streams.
    from ray_tpu_torch.data.llm import _LLMBatchWorker

    seed = _LLMBatchWorker._row_seed
    w = SimpleNamespace(seed=7)
    rows = [[5], [6, 7], [8, 9, 10], [11]]

    one_batch = [seed(w, r) for r in rows]
    rebatched = [seed(w, r) for r in rows[:2]] + \
                [seed(w, r) for r in rows[2:]]
    assert one_batch == rebatched            # batch-size independent
    assert len(set(one_batch)) == len(rows)  # distinct streams per row
    assert seed(w, [5]) == one_batch[0]      # rerun-stable
    assert seed(SimpleNamespace(seed=8), [5]) != one_batch[0]
    # numpy token dtypes hash identically to Python ints
    np = pytest.importorskip("numpy")
    assert seed(w, list(np.asarray([6, 7], np.int32))) == one_batch[1]


# ---------------------------------------------------------------------------
# pass 3c — graftrpc dispatch-plane schema drift
# ---------------------------------------------------------------------------

GRAFT_PY = os.path.join(REPO, "ray_tpu_torch", "core", "_native",
                        "graftrpc.py")
GRAFT_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "rpc_core.cc")


def _mutated(tmp_path, src_path, old, new, name):
    with open(src_path) as f:
        text = f.read()
    assert old in text, f"fixture drifted: {old!r} not in {src_path}"
    p = tmp_path / name
    p.write_text(text.replace(old, new, 1))
    return str(p)


def test_graft_schema_repo_in_sync():
    fs = wire_schema.run_graft(GRAFT_PY, GRAFT_CC, "py", "cc")
    assert fs == [], [f.render() for f in fs]


def test_graft_schema_detects_opcode_drift(tmp_path):
    cc = _mutated(tmp_path, GRAFT_CC, "kOpIntern = 3", "kOpIntern = 7",
                  "rpc_core.cc")
    fs = wire_schema.run_graft(GRAFT_PY, cc, "py", "cc")
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("intern" in f.message for f in fs), \
        [f.render() for f in fs]


def test_graft_schema_detects_missing_opcode(tmp_path):
    cc = _mutated(tmp_path, GRAFT_CC, "kOpGoaway = 5", "kOpGoaway2 = 5",
                  "rpc_core.cc")
    fs = wire_schema.run_graft(GRAFT_PY, cc, "py", "cc")
    assert any("goaway" in f.message for f in fs), \
        [f.render() for f in fs]


def test_graft_schema_detects_header_width_drift(tmp_path):
    cc = _mutated(tmp_path, GRAFT_CC, "uint16_t chan;", "uint32_t chan;",
                  "rpc_core.cc")
    fs = wire_schema.run_graft(GRAFT_PY, cc, "py", "cc")
    assert fs and any("chan" in f.message for f in fs), \
        [f.render() for f in fs]


def test_graft_schema_detects_field_order_drift(tmp_path):
    py = _mutated(tmp_path, GRAFT_PY, '("flags", 1),\n    ("chan", 2),',
                  '("chan", 2),\n    ("flags", 1),', "graftrpc.py")
    fs = wire_schema.run_graft(py, GRAFT_CC, "py", "cc")
    assert fs and any("order" in f.message or "flags" in f.message
                      for f in fs), [f.render() for f in fs]


def test_graft_schema_detects_frame_cap_drift(tmp_path):
    cc = _mutated(tmp_path, GRAFT_CC, "kMaxFrame = 64u << 20",
                  "kMaxFrame = 32u << 20", "rpc_core.cc")
    fs = wire_schema.run_graft(GRAFT_PY, cc, "py", "cc")
    assert fs and any("cap" in f.message for f in fs), \
        [f.render() for f in fs]


def test_graft_schema_detects_struct_format_mismatch(tmp_path):
    py = _mutated(tmp_path, GRAFT_PY, 'struct.Struct("<BBHQ")',
                  'struct.Struct("<BBIQ")', "graftrpc.py")
    fs = wire_schema.run_graft(py, GRAFT_CC, "py", "cc")
    assert fs, "format/width mismatch not detected"

# ---------------------------------------------------------------------------
# pass 3d — ctypes binding signatures vs C exports
# ---------------------------------------------------------------------------

OS_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "object_store.cc")
COPY_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "copy_core.cc")
SCOPE_CORE_CC = os.path.join(REPO, "ray_tpu_torch", "csrc",
                             "scope_core.cc")
PROF_CORE_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "prof_core.cc")
LOG_CORE_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "log_core.cc")
CT_CCS = [OS_CC, STORE_CC, COPY_CC, SCOPE_CORE_CC, PROF_CORE_CC,
          LOG_CORE_CC]
CT_RELS = ["object_store.cc", "store_server.cc", "copy_core.cc",
           "scope_core.cc", "prof_core.cc", "log_core.cc"]


def _ctypes_run(py=STORE_PY, ccs=None, rels=None):
    return wire_schema.run_ctypes(py, ccs or CT_CCS, "py",
                                  rels or CT_RELS)


def test_ctypes_schema_repo_in_sync():
    fs = _ctypes_run()
    assert fs == [], [f.render() for f in fs]


def test_ctypes_schema_detects_arity_drift(tmp_path):
    cc = _mutated(tmp_path, COPY_CC, "int copy_linkat(int src_fd, "
                  "const char* dst)",
                  "int copy_linkat(int src_fd, const char* dst, int flags)",
                  "copy_core.cc")
    fs = _ctypes_run(ccs=[OS_CC, STORE_CC, cc, SCOPE_CORE_CC,
                          PROF_CORE_CC, LOG_CORE_CC])
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("arity" in f.message and "copy_linkat" in f.message
               for f in fs), [f.render() for f in fs]


def test_ctypes_schema_detects_arg_width_drift(tmp_path):
    cc = _mutated(tmp_path, COPY_CC, "int nsegs)", "uint64_t nsegs)",
                  "copy_core.cc")
    fs = _ctypes_run(ccs=[OS_CC, STORE_CC, cc, SCOPE_CORE_CC,
                          PROF_CORE_CC, LOG_CORE_CC])
    assert fs and any("width" in f.message
                      and "copy_write_scatter" in f.message
                      for f in fs), [f.render() for f in fs]


def test_ctypes_schema_detects_restype_drift(tmp_path):
    cc = _mutated(tmp_path, COPY_CC, "int copy_engine_threads(",
                  "uint64_t copy_engine_threads(", "copy_core.cc")
    fs = _ctypes_run(ccs=[OS_CC, STORE_CC, cc, SCOPE_CORE_CC,
                          PROF_CORE_CC, LOG_CORE_CC])
    assert fs and any("restype" in f.message
                      and "copy_engine_threads" in f.message
                      for f in fs), [f.render() for f in fs]


def test_ctypes_schema_detects_default_restype_truncation(tmp_path):
    # Deleting a pointer-returning binding's restype leaves ctypes'
    # 4-byte c_int default: the worst drift class (handle truncation).
    py = _mutated(tmp_path, STORE_PY,
                  "    lib.copy_engine_create.restype = ctypes.c_void_p\n",
                  "", "object_store.py")
    fs = _ctypes_run(py=py)
    assert fs and any("truncation" in f.message
                      and "copy_engine_create" in f.message
                      for f in fs), [f.render() for f in fs]


def test_ctypes_schema_detects_cross_file_decl_drift(tmp_path):
    # store_server.cc forward-declares object_store.cc exports; a
    # one-sided parameter change must be flagged.
    cc = _mutated(tmp_path, STORE_CC,
                  "int store_delete(void* handle, const char* id);",
                  "int store_delete(void* handle, const char* id, "
                  "int force);", "store_server.cc")
    fs = _ctypes_run(ccs=[OS_CC, cc, COPY_CC],
                     rels=["object_store.cc", "store_server.cc",
                           "copy_core.cc"])
    assert fs and any("disagrees" in f.message for f in fs), \
        [f.render() for f in fs]


def test_ctypes_schema_detects_missing_c_definition(tmp_path):
    cc = _mutated(tmp_path, COPY_CC, "int copy_linkat(",
                  "int copy_linkat_v2(", "copy_core.cc")
    fs = _ctypes_run(ccs=[OS_CC, STORE_CC, cc, SCOPE_CORE_CC,
                          PROF_CORE_CC, LOG_CORE_CC])
    assert fs and any("no C definition" in f.message
                      and "copy_linkat" in f.message
                      for f in fs), [f.render() for f in fs]


# ---------------------------------------------------------------------------
# pass 3e — graftscope flight-recorder record drift
# ---------------------------------------------------------------------------

SCOPE_PY = os.path.join(REPO, "ray_tpu_torch", "core", "_native",
                        "graftscope.py")
SCOPE_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "scope_core.h")


def test_scope_schema_repo_in_sync():
    fs = wire_schema.run_scope(SCOPE_PY, SCOPE_CC, "py", "cc")
    assert fs == [], [f.render() for f in fs]


def test_scope_schema_detects_kind_value_drift(tmp_path):
    cc = _mutated(tmp_path, SCOPE_CC, "kScopeCopyScatter = 5",
                  "kScopeCopyScatter = 12", "scope_core.h")
    fs = wire_schema.run_scope(SCOPE_PY, cc, "py", "cc")
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("COPY_SCATTER" in f.message for f in fs), \
        [f.render() for f in fs]


def test_scope_schema_detects_missing_kind(tmp_path):
    cc = _mutated(tmp_path, SCOPE_CC, "kScopeScRename = 10",
                  "kScopeScRelink = 10", "scope_core.h")
    fs = wire_schema.run_scope(SCOPE_PY, cc, "py", "cc")
    assert any("SC_RELINK" in f.message or "SC_RENAME" in f.message
               for f in fs), [f.render() for f in fs]


def test_scope_schema_detects_field_width_drift(tmp_path):
    cc = _mutated(tmp_path, SCOPE_CC, "uint32_t size;", "uint64_t size;",
                  "scope_core.h")
    fs = wire_schema.run_scope(SCOPE_PY, cc, "py", "cc")
    assert fs and any("size" in f.message for f in fs), \
        [f.render() for f in fs]


def test_scope_schema_detects_field_order_drift(tmp_path):
    py = _mutated(tmp_path, SCOPE_PY, '("op", 1),\n    ("chan", 2),',
                  '("chan", 2),\n    ("op", 1),', "graftscope.py")
    fs = wire_schema.run_scope(py, SCOPE_CC, "py", "cc")
    assert fs and any("order" in f.message or "op" in f.message
                      for f in fs), [f.render() for f in fs]


def test_scope_schema_detects_record_size_drift(tmp_path):
    py = _mutated(tmp_path, SCOPE_PY, "SCOPE_RECORD_SIZE = 24",
                  "SCOPE_RECORD_SIZE = 32", "graftscope.py")
    fs = wire_schema.run_scope(py, SCOPE_CC, "py", "cc")
    assert fs and any("size" in f.message.lower() for f in fs), \
        [f.render() for f in fs]


def test_scope_schema_detects_struct_format_mismatch(tmp_path):
    py = _mutated(tmp_path, SCOPE_PY, 'struct.Struct("<BBHIQQ")',
                  'struct.Struct("<BBHQQQ")', "graftscope.py")
    fs = wire_schema.run_scope(py, SCOPE_CC, "py", "cc")
    assert fs, "format/width mismatch not detected"

# ---------------------------------------------------------------------------
# pass 3f — graftpulse telemetry record drift
# ---------------------------------------------------------------------------

PULSE_PY = os.path.join(REPO, "ray_tpu_torch", "core", "_native",
                        "graftpulse.py")
PULSE_CC = SCOPE_CC  # PulseWireRec lives in scope_core.h too


def test_pulse_schema_repo_in_sync():
    fs = wire_schema.run_pulse(PULSE_PY, PULSE_CC, "py", "cc")
    assert fs == [], [f.render() for f in fs]


def test_pulse_schema_detects_field_width_drift(tmp_path):
    cc = _mutated(tmp_path, PULSE_CC, "uint32_t store_objects;",
                  "uint64_t store_objects;", "scope_core.h")
    fs = wire_schema.run_pulse(PULSE_PY, cc, "py", "cc")
    assert fs and any("store_objects" in f.message for f in fs), \
        [f.render() for f in fs]


def test_pulse_schema_detects_field_order_drift(tmp_path):
    py = _mutated(tmp_path, PULSE_PY,
                  '("store_objects", 4),\n    ("shm_free_chunks", 4),',
                  '("shm_free_chunks", 4),\n    ("store_objects", 4),',
                  "graftpulse.py")
    fs = wire_schema.run_pulse(py, PULSE_CC, "py", "cc")
    assert fs and any("order" in f.message for f in fs), \
        [f.render() for f in fs]


def test_pulse_schema_detects_record_size_drift(tmp_path):
    py = _mutated(tmp_path, PULSE_PY, "PULSE_RECORD_SIZE = 104",
                  "PULSE_RECORD_SIZE = 96", "graftpulse.py")
    fs = wire_schema.run_pulse(py, PULSE_CC, "py", "cc")
    assert fs and any("size" in f.message.lower() for f in fs), \
        [f.render() for f in fs]


def test_pulse_schema_detects_struct_format_mismatch(tmp_path):
    py = _mutated(tmp_path, PULSE_PY,
                  'struct.Struct("<IHHQQQQQIIQIIQQQII")',
                  'struct.Struct("<IHHQQQQQIIQIIQQQQI")', "graftpulse.py")
    fs = wire_schema.run_pulse(py, PULSE_CC, "py", "cc")
    assert fs, "format/width mismatch not detected"


def test_pulse_schema_detects_version_registry_drift(tmp_path):
    # A registry row edited on one side only (or a size retconned) is
    # exactly what the append-only version -> size table must catch.
    cc = _mutated(tmp_path, PULSE_CC, "{1, 96},", "{1, 88},",
                  "scope_core.h")
    fs = wire_schema.run_pulse(PULSE_PY, cc, "py", "cc")
    assert fs and any("registry" in f.message for f in fs), \
        [f.render() for f in fs]


def test_pulse_schema_detects_widening_without_version_bump(tmp_path):
    # Roll the version back while the header stays 104 bytes: the
    # registry row for the claimed version no longer matches the record
    # size, i.e. the header was widened without a bump.
    py = _mutated(tmp_path, PULSE_PY, "PULSE_VERSION = 2",
                  "PULSE_VERSION = 1", "graftpulse.py")
    fs = wire_schema.run_pulse(py, PULSE_CC, "py", "cc")
    assert fs and any("version bump" in f.message or "version" in f.message
                      for f in fs), [f.render() for f in fs]


def test_pulse_schema_detects_magic_drift(tmp_path):
    cc = _mutated(tmp_path, PULSE_CC, "kPulseMagic = 0x45534c50",
                  "kPulseMagic = 0x45534c51", "scope_core.h")
    fs = wire_schema.run_pulse(PULSE_PY, cc, "py", "cc")
    assert fs and any("magic" in f.message for f in fs), \
        [f.render() for f in fs]


def test_pulse_schema_detects_hist_geometry_drift(tmp_path):
    py = _mutated(tmp_path, PULSE_PY, "PULSE_HIST_SHIFT = 10",
                  "PULSE_HIST_SHIFT = 11", "graftpulse.py")
    fs = wire_schema.run_pulse(py, PULSE_CC, "py", "cc")
    assert fs and any("shift" in f.message for f in fs), \
        [f.render() for f in fs]

# ---------------------------------------------------------------------------
# pass 3g — graftprof sample record drift
# ---------------------------------------------------------------------------

PROF_PY = os.path.join(REPO, "ray_tpu_torch", "core", "_native",
                       "graftprof.py")
PROF_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "prof_core.h")


def test_prof_schema_repo_in_sync():
    fs = wire_schema.run_prof(PROF_PY, PROF_CC, "py", "cc")
    assert fs == [], [f.render() for f in fs]


def test_prof_schema_detects_kind_value_drift(tmp_path):
    cc = _mutated(tmp_path, PROF_CC, "kProfThreadCpu = 2",
                  "kProfThreadCpu = 7", "prof_core.h")
    fs = wire_schema.run_prof(PROF_PY, cc, "py", "cc")
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("THREAD_CPU" in f.message for f in fs), \
        [f.render() for f in fs]


def test_prof_schema_detects_missing_kind(tmp_path):
    cc = _mutated(tmp_path, PROF_CC, "kProfGilWait = 3",
                  "kProfGilHold = 3", "prof_core.h")
    fs = wire_schema.run_prof(PROF_PY, cc, "py", "cc")
    assert any("GIL_HOLD" in f.message or "GIL_WAIT" in f.message
               for f in fs), [f.render() for f in fs]


def test_prof_schema_detects_field_width_drift(tmp_path):
    cc = _mutated(tmp_path, PROF_CC, "uint32_t val_us;",
                  "uint64_t val_us;", "prof_core.h")
    fs = wire_schema.run_prof(PROF_PY, cc, "py", "cc")
    assert fs and any("val_us" in f.message for f in fs), \
        [f.render() for f in fs]


def test_prof_schema_detects_field_order_drift(tmp_path):
    py = _mutated(tmp_path, PROF_PY, '("slot", 1),\n    ("flags", 2),',
                  '("flags", 2),\n    ("slot", 1),', "graftprof.py")
    fs = wire_schema.run_prof(py, PROF_CC, "py", "cc")
    assert fs and any("order" in f.message or "slot" in f.message
                      for f in fs), [f.render() for f in fs]


def test_prof_schema_detects_record_size_drift(tmp_path):
    py = _mutated(tmp_path, PROF_PY, "PROF_RECORD_SIZE = 24",
                  "PROF_RECORD_SIZE = 32", "graftprof.py")
    fs = wire_schema.run_prof(py, PROF_CC, "py", "cc")
    assert fs and any("size" in f.message.lower() for f in fs), \
        [f.render() for f in fs]


def test_prof_schema_detects_struct_format_mismatch(tmp_path):
    py = _mutated(tmp_path, PROF_PY, 'struct.Struct("<BBHIQQ")',
                  'struct.Struct("<BBHQQQ")', "graftprof.py")
    fs = wire_schema.run_prof(py, PROF_CC, "py", "cc")
    assert fs, "format/width mismatch not detected"


def test_prof_schema_detects_ring_geometry_drift(tmp_path):
    # The drain buffer is sized ring_cap * record_size on the Python
    # side; a one-sided ring resize silently truncates every drain.
    py = _mutated(tmp_path, PROF_PY, "PROF_RING_CAP = 4096",
                  "PROF_RING_CAP = 2048", "graftprof.py")
    fs = wire_schema.run_prof(py, PROF_CC, "py", "cc")
    assert fs and any("RING_CAP" in f.message for f in fs), \
        [f.render() for f in fs]


# ---------------------------------------------------------------------------
# pass 3h — graftlog crash-persistent log record drift
# ---------------------------------------------------------------------------

LOG_PY = os.path.join(REPO, "ray_tpu_torch", "core", "_native",
                      "graftlog.py")
LOG_CC = os.path.join(REPO, "ray_tpu_torch", "csrc", "log_core.h")


def test_log_schema_repo_in_sync():
    fs = wire_schema.run_log(LOG_PY, LOG_CC, "py", "cc")
    assert fs == [], [f.render() for f in fs]


def test_log_schema_detects_source_value_drift(tmp_path):
    cc = _mutated(tmp_path, LOG_CC, "kLogSrcStderr = 2",
                  "kLogSrcStderr = 5", "log_core.h")
    fs = wire_schema.run_log(LOG_PY, cc, "py", "cc")
    assert fs and all(f.rule == "wire-drift" for f in fs)
    assert any("SRC_STDERR" in f.message for f in fs), \
        [f.render() for f in fs]


def test_log_schema_detects_missing_source(tmp_path):
    cc = _mutated(tmp_path, LOG_CC, "kLogSrcAgent = 3",
                  "kLogSrcDaemon = 3", "log_core.h")
    fs = wire_schema.run_log(LOG_PY, cc, "py", "cc")
    assert any("SRC_AGENT" in f.message or "SRC_DAEMON" in f.message
               for f in fs), [f.render() for f in fs]


def test_log_schema_detects_payload_width_drift(tmp_path):
    # Char-array payload widths must fold into the field comparison —
    # a shrunken msg cap shifts every later salvage read.
    cc = _mutated(tmp_path, LOG_CC, "char msg[196];",
                  "char msg[180];", "log_core.h")
    fs = wire_schema.run_log(LOG_PY, cc, "py", "cc")
    assert fs and any("msg" in f.message for f in fs), \
        [f.render() for f in fs]


def test_log_schema_detects_field_width_drift(tmp_path):
    cc = _mutated(tmp_path, LOG_CC, "uint16_t line_len;",
                  "uint32_t line_len;", "log_core.h")
    fs = wire_schema.run_log(LOG_PY, cc, "py", "cc")
    assert fs and any("line_len" in f.message for f in fs), \
        [f.render() for f in fs]


def test_log_schema_detects_field_order_drift(tmp_path):
    py = _mutated(tmp_path, LOG_PY, '("level", 1),\n    ("source", 1),',
                  '("source", 1),\n    ("level", 1),', "graftlog.py")
    fs = wire_schema.run_log(py, LOG_CC, "py", "cc")
    assert fs and any("order" in f.message or "level" in f.message
                      for f in fs), [f.render() for f in fs]


def test_log_schema_detects_record_size_drift(tmp_path):
    py = _mutated(tmp_path, LOG_PY, "LOG_RECORD_SIZE = 256",
                  "LOG_RECORD_SIZE = 264", "graftlog.py")
    fs = wire_schema.run_log(py, LOG_CC, "py", "cc")
    assert fs and any("size" in f.message.lower() for f in fs), \
        [f.render() for f in fs]


def test_log_schema_detects_struct_format_mismatch(tmp_path):
    # "Ns" payload tokens must tokenize as one N-byte field; a format
    # edited away from the declared widths is the classic silent shear.
    py = _mutated(tmp_path, LOG_PY, 'struct.Struct("<BBHIQ32s12s196s")',
                  'struct.Struct("<BBHIQ32s16s192s")', "graftlog.py")
    fs = wire_schema.run_log(py, LOG_CC, "py", "cc")
    assert fs, "format/width mismatch not detected"


def test_log_schema_detects_magic_drift(tmp_path):
    # The hex magic gates salvage of rings left by older runs — it
    # must parse under int(x, 0), not the decimal-only kind regex.
    cc = _mutated(tmp_path, LOG_CC, "kLogMagic = 0x474C4F31",
                  "kLogMagic = 0x474C4F32", "log_core.h")
    fs = wire_schema.run_log(LOG_PY, cc, "py", "cc")
    assert fs and any("MAGIC" in f.message for f in fs), \
        [f.render() for f in fs]


def test_log_schema_detects_ring_geometry_drift(tmp_path):
    # Slot count sizes the mmap and the slot index mask on both sides;
    # a one-sided resize makes salvage read past (or short of) the file.
    py = _mutated(tmp_path, LOG_PY, "LOG_RING_SLOTS = 4096",
                  "LOG_RING_SLOTS = 2048", "graftlog.py")
    fs = wire_schema.run_log(py, LOG_CC, "py", "cc")
    assert fs and any("RING_SLOTS" in f.message for f in fs), \
        [f.render() for f in fs]


# ---------------------------------------------------------------------------
# pass 4a — store-protocol state machine vs tools/lint/protocol.json
# ---------------------------------------------------------------------------

def _proto_files():
    return [load_source(os.path.join(REPO, p.replace("/", os.sep)), REPO)
            for p in protocol.WALK_FILES]


def _proto_run(artifact=None, cc=None):
    return protocol.run(artifact or protocol.DEFAULT_PROTOCOL,
                        cc or STORE_CC, "cc", _proto_files())


def _mutated_protocol(tmp_path, mutate):
    import json
    with open(protocol.DEFAULT_PROTOCOL) as f:
        proto = json.load(f)
    mutate(proto)
    p = tmp_path / "protocol.json"
    p.write_text(json.dumps(proto))
    return str(p)


def test_protocol_artifact_committed_and_extensible():
    # graftshm made create/seal LIVE wire ops (9/10): the artifact must
    # carry their opcodes, reply discipline, and the seal-as-ingest
    # journaling the agent's bookkeeping relies on.
    import json
    with open(protocol.DEFAULT_PROTOCOL) as f:
        proto = json.load(f)
    assert proto["ops"]["create"]["value"] == 9
    assert proto["ops"]["seal"]["value"] == 10
    assert proto["ops"]["seal"]["journal"] == "ingest"
    assert proto["ops"]["create"]["reply"] is True
    assert proto["ops"]["drop"]["reply"] is False
    assert len(proto["ops"]) >= 10


def test_protocol_repo_in_sync():
    fs = _proto_run()
    assert fs == [], [f.render() for f in fs]


def test_protocol_detects_c_op_value_drift(tmp_path):
    cc = _mutated(tmp_path, STORE_CC, "kOpDrop = 7", "kOpDrop = 9",
                  "store_server.cc")
    fs = _proto_run(cc=cc)
    assert fs and all(f.rule == "protocol-drift" for f in fs)
    assert any("drop" in f.message.lower() for f in fs), \
        [f.render() for f in fs]


def test_protocol_detects_one_sided_op(tmp_path):
    # An op added on the C side only (beyond width/arity drift: this is
    # the ordering contract) must be flagged.
    cc = _mutated(tmp_path, STORE_CC, "kOpScope = 8",
                  "kOpScope = 8;\nconstexpr uint8_t kOpEvict = 9",
                  "store_server.cc")
    fs = _proto_run(cc=cc)
    assert any(f.rule == "protocol-drift" and "Evict" in f.message
               for f in fs), [f.render() for f in fs]


def test_protocol_reply_mode_drift_caught_both_sides(tmp_path):
    # Flip drop to reply-expected in the artifact: the fire-and-forget C
    # handler AND the Python drop_async send site must both surface.
    art = _mutated_protocol(
        tmp_path, lambda pr: pr["ops"]["drop"].update({"reply": True}))
    fs = _proto_run(artifact=art)
    rules = _rules(fs)
    assert "protocol-drift" in rules and "reply-path" in rules, \
        [f.render() for f in fs]


def test_protocol_transition_flip_caught_on_real_tree(tmp_path):
    # THE acceptance fixture: flipping a transition in the artifact must
    # make real call sites (node_agent seal->get pattern) illegal.
    art = _mutated_protocol(
        tmp_path, lambda pr: pr["ops"]["get"].update({"from": ["staged"]}))
    fs = _proto_run(artifact=art)
    assert any(f.rule == "op-order" and "node_agent" in f.path
               for f in fs), [f.render() for f in fs]


def test_protocol_py_table_value_drift(tmp_path):
    sf = _sf(tmp_path, """
        class C:
            OP_INGEST, OP_GET, OP_RELEASE, OP_DELETE, OP_CONTAINS = \\
                1, 3, 2, 4, 5
            OP_PUT = 6
            OP_DROP = 7
            OP_SCOPE = 8
    """)
    proto = protocol.load_protocol(protocol.DEFAULT_PROTOCOL)
    fs = protocol.check_py_table(proto, sf)
    assert any("OP_GET" in f.message and "disagrees" in f.message
               for f in fs), [f.render() for f in fs]


def test_protocol_illegal_sequences_flagged(tmp_path):
    sf = _sf(tmp_path, """
        class W:
            def a(self, fp, oid):
                fp.create(oid)
                fp.get(oid)        # get-before-seal
            def b(self, fp, oid):
                fp.put(oid)
                fp.release(oid)    # release-without-get
            def c(self, fp, oid):
                fp.get(oid)
                fp.delete(oid)     # delete while pinned
            def d(self, fp, oid):
                fp.delete(oid)
                fp.drop_async(oid)  # double-drop
    """)
    proto = protocol.load_protocol(protocol.DEFAULT_PROTOCOL)
    fs = protocol.walk_call_sites(proto, [sf])
    assert len(fs) == 4 and all(f.rule == "op-order" for f in fs)
    msgs = " | ".join(f.message for f in fs)
    assert "get-before-seal" in msgs and "release-without-get" in msgs
    assert "pin(s)" in msgs and "double-drop" in msgs


def test_protocol_legal_patterns_clean(tmp_path):
    # The shapes the real tree uses: create/seal/get/release, loop
    # bodies with per-iteration get..release..delete, try/finally
    # release, branch-dependent release, and helper indirection.
    sf = _sf(tmp_path, """
        class W:
            def stage(self, fp, oid):
                fp.create(oid)
                fp.seal(oid)
                fp.get(oid)
                fp.release(oid)
                fp.delete(oid)

            def pipeline(self, fp, oids):
                for oid in oids:
                    fp.get(oid)
                    try:
                        self.consume(oid)
                    finally:
                        fp.release(oid)
                    fp.delete(oid)

            def maybe(self, fp, oid):
                got = fp.get(oid)
                if got:
                    fp.release(oid)

            def quiet_release(self, fp, oid):
                try:
                    fp.release(oid)
                except OSError:
                    pass

            def via_helper(self, fp, oid):
                fp.get(oid)
                self.quiet_release(fp, oid)
    """)
    proto = protocol.load_protocol(protocol.DEFAULT_PROTOCOL)
    fs = protocol.walk_call_sites(proto, [sf])
    assert fs == [], [f.render() for f in fs]


def test_protocol_detects_one_sided_shm_op(tmp_path):
    # Seeded drift: drop 'seal' from the artifact — the live C handler
    # (kOpSeal=10) AND the Python OP_SEAL constant both become ops
    # added on one side only, and both sides must surface.
    art = _mutated_protocol(tmp_path, lambda pr: pr["ops"].pop("seal"))
    fs = _proto_run(artifact=art)
    assert any(f.rule == "protocol-drift" and "kOpSeal" in f.message
               for f in fs), [f.render() for f in fs]
    assert any(f.rule == "protocol-drift" and "OP_SEAL" in f.message
               for f in fs), [f.render() for f in fs]


def test_protocol_seal_before_create_flagged(tmp_path):
    sf = _sf(tmp_path, """
        class W:
            def backwards(self, fp, oid):
                fp.seal(oid)
                fp.create(oid)   # create of an already-sealed object
    """)
    proto = protocol.load_protocol(protocol.DEFAULT_PROTOCOL)
    fs = protocol.walk_call_sites(proto, [sf])
    assert any(f.rule == "op-order" and "create" in f.message
               for f in fs), [f.render() for f in fs]


def test_protocol_shm_transition_flip_caught_on_real_tree(tmp_path):
    # Flipping seal's from-set must make the REAL graftshm put plane
    # (create -> in-place write -> seal in core_worker._put_shm)
    # illegal: proves the walker actually covers those call sites.
    art = _mutated_protocol(
        tmp_path, lambda pr: pr["ops"]["seal"].update({"from": ["sealed"]}))
    fs = _proto_run(artifact=art)
    assert any(f.rule == "op-order" and "core_worker" in f.path
               and "seal" in f.message for f in fs), \
        [f.render() for f in fs]


def test_protocol_divergent_helper_poisons_not_replays(tmp_path):
    # A helper whose client ops live on divergent branches (the
    # fallback delete in an except handler next to the success-path
    # seal — the _put_shm shape) must NOT be replayed linearly at call
    # sites: create,delete,seal is a sequence no single path executes.
    # Its oid params poison to UNKNOWN instead, so the caller's
    # fallback ladder stays clean.
    sf = _sf(tmp_path, """
        class W:
            def shm_put(self, oid, fp):
                fp.create(oid)
                try:
                    self.write_in_place(oid)
                except OSError:
                    fp.delete(oid)
                    return False
                fp.seal(oid)
                return True

            def outer(self, fp, oid):
                if self.shm_put(oid, fp):
                    return True
                return fp.ingest(oid)  # fallback: state unknowable here
    """)
    proto = protocol.load_protocol(protocol.DEFAULT_PROTOCOL)
    fs = protocol.walk_call_sites(proto, [sf])
    assert fs == [], [f.render() for f in fs]


def test_protocol_reply_discipline_call_sites(tmp_path):
    sf = _sf(tmp_path, """
        class C:
            OP_GET = 2
            OP_DROP = 7
            def bad(self, payload):
                store_client_send(self._fd, self.OP_GET, payload)
                return self._req(self.OP_DROP, payload)
            def good(self, payload):
                store_client_send(self._fd, self.OP_DROP, payload)
                return self._req(self.OP_GET, payload)
    """)
    proto = protocol.load_protocol(protocol.DEFAULT_PROTOCOL)
    fs = protocol.check_reply_paths(proto, sf)
    assert len(fs) == 2 and all(f.rule == "reply-path" for f in fs)
    assert any("OP_GET" in f.message and "fire-and-forget" in f.message
               for f in fs)
    assert any("OP_DROP" in f.message and "blocks forever" in f.message
               for f in fs)


def test_protocol_c_extraction_shape():
    with open(STORE_CC) as f:
        values, handlers = protocol.parse_c_handlers(f.read())
    assert values["drop"] == 7 and values["ingest"] == 1
    assert handlers["drop"]["reply"] is False      # continue; path
    assert handlers["get"]["reply"] is True
    assert handlers["ingest"]["journal"] == "ingest"  # fall-through label
    assert handlers["drop"]["journal"] == "delete"


# ---------------------------------------------------------------------------
# pass 4b — memory-order discipline (ray_tpu_torch/csrc atomics)
# ---------------------------------------------------------------------------

NATIVE_CC = [(os.path.join(REPO, "ray_tpu_torch", "csrc", n),
              f"ray_tpu_torch/csrc/{n}")
             for n in ("copy_core.cc", "object_store.cc", "rpc_core.cc",
                       "scope_core.cc", "store_server.cc",
                       "scope_core.h")]


def _cc_fixture(tmp_path, source, name="fix.cc"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return [(str(p), name)]


def test_memorder_repo_clean():
    fs = memorder.run(NATIVE_CC)
    assert fs == [], [f.render() for f in fs]


def test_memorder_implicit_seq_cst_flagged(tmp_path):
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        std::atomic<int> g_count{0};
        void bump() { g_count.fetch_add(1); }
        int peek() { return g_count.load(std::memory_order_relaxed); }
    """))
    assert _rules(fs) == ["memory-order"]
    assert "implicit seq_cst" in fs[0].message and fs[0].qualname == "bump"


def test_memorder_relaxed_store_without_bridge_flagged(tmp_path):
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        struct Q {
          std::atomic<int> data{0};
          std::atomic<int> ready{0};
        };
        void produce(Q* q, int v) {
          q->data.store(v, std::memory_order_relaxed);
          q->ready.store(1, std::memory_order_relaxed);
        }
        int consume(Q* q) {
          if (q->ready.load(std::memory_order_acquire)) {
            return q->data.load(std::memory_order_relaxed);
          }
          return -1;
        }
    """))
    assert _rules(fs) == ["memory-order"], [f.render() for f in fs]
    assert "ready" in fs[0].message and "release" in fs[0].message


def test_memorder_single_writer_ring_shape_clean(tmp_path):
    # The scope_core known-good shape: relaxed payload stores published
    # by head.store(release); drain acquires head, relaxed payload
    # loads, lap re-check.
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        struct Ring {
          std::atomic<unsigned long> head{0};
          std::atomic<unsigned long> w[16];
        };
        void emit(Ring* r, unsigned long a) {
          unsigned long h = r->head.load(std::memory_order_relaxed);
          r->w[h % 16].store(a, std::memory_order_relaxed);
          r->head.store(h + 1, std::memory_order_release);
        }
        unsigned long drain(Ring* r) {
          unsigned long h = r->head.load(std::memory_order_acquire);
          unsigned long v = r->w[(h - 1) % 16].load(
              std::memory_order_relaxed);
          if (r->head.load(std::memory_order_acquire) != h) return 0;
          return v;
        }
    """))
    assert fs == [], [f.render() for f in fs]


def test_memorder_worker_pool_shape_clean(tmp_path):
    # The copy_core known-good shape: relaxed claim cursor + relaxed err
    # CAS published by done.fetch_add(acq_rel); waiter acquires done.
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        struct Job {
          std::atomic<unsigned long> next{0};
          std::atomic<unsigned long> done{0};
          std::atomic<int> err{0};
        };
        void work(Job* j, int rc) {
          unsigned long i = j->next.fetch_add(
              1, std::memory_order_relaxed);
          (void)i;
          if (rc != 0) {
            int expected = 0;
            j->err.compare_exchange_strong(expected, rc,
                                           std::memory_order_relaxed,
                                           std::memory_order_relaxed);
          }
          j->done.fetch_add(1, std::memory_order_acq_rel);
        }
        int wait_done(Job* j, unsigned long n) {
          while (j->done.load(std::memory_order_acquire) < n) {
          }
          return j->err.load(std::memory_order_relaxed);
        }
    """))
    assert fs == [], [f.render() for f in fs]


def test_memorder_spin_without_backoff_flagged(tmp_path):
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        std::atomic_flag f = ATOMIC_FLAG_INIT;
        void lock_bad() {
          while (f.test_and_set(std::memory_order_acquire)) {
          }
        }
        void lock_good() {
          while (f.test_and_set(std::memory_order_acquire)) {
            __builtin_ia32_pause();
          }
        }
        void unlock_it() { f.clear(std::memory_order_release); }
    """))
    assert _rules(fs) == ["spin-no-backoff"], [f.render() for f in fs]
    assert fs[0].qualname == "lock_bad"


def test_memorder_bare_atomic_read_flagged(tmp_path):
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        struct S { std::atomic<bool> stopping{false}; };
        int poll_bad(S* s) {
          if (s->stopping) return 1;
          return 0;
        }
        int poll_ok(S* s) {
          if (s->stopping.load(std::memory_order_acquire)) return 1;
          return 0;
        }
    """))
    assert _rules(fs) == ["memory-order"], [f.render() for f in fs]
    assert "bare read" in fs[0].message and fs[0].qualname == "poll_bad"


def test_memorder_pure_relaxed_counters_clean(tmp_path):
    # Stat counters with no acquire readers need no bridges.
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        std::atomic<unsigned long> g_hits{0};
        void hit() { g_hits.fetch_add(1, std::memory_order_relaxed); }
        unsigned long hits() {
          return g_hits.load(std::memory_order_relaxed);
        }
    """))
    assert fs == [], [f.render() for f in fs]


def test_memorder_inline_allow_suppresses(tmp_path):
    fs = memorder.run(_cc_fixture(tmp_path, """
        #include <atomic>
        std::atomic<int> g_n{0};
        void f() {
          g_n.fetch_add(1);  // lint: allow(memory-order: legacy shim)
        }
    """))
    assert fs == [], [f.render() for f in fs]


def test_memorder_header_decls_cover_including_cc(tmp_path):
    # scope_core-style split: atomics declared in the .h, used in the
    # .cc — the pass must resolve them across the #include.
    h = tmp_path / "ring.h"
    h.write_text("#include <atomic>\n"
                 "struct R { std::atomic<int> head{0}; };\n")
    cc = tmp_path / "ring.cc"
    cc.write_text('#include "ring.h"\n'
                  "int peek(R* r) { return r->head.load(); }\n")
    fs = memorder.run([(str(h), "ring.h"), (str(cc), "ring.cc")])
    assert _rules(fs) == ["memory-order"], [f.render() for f in fs]
    assert fs[0].path == "ring.cc"


# ---------------------------------------------------------------------------
# pass 4c — error-path fd/inode discipline (ray_tpu_torch/csrc)
# ---------------------------------------------------------------------------

def test_fdleak_repo_clean():
    fs = resource_paths.run(NATIVE_CC)
    assert fs == [], [f.render() for f in fs]


def test_fdleak_error_path_flagged(tmp_path):
    fs = resource_paths.run(_cc_fixture(tmp_path, """
        int prepare(char* buf);
        int stage(const char* p, char* buf) {
          int fd = ::open(p, 0);
          if (prepare(buf) != 0) {
            return -1;
          }
          ::close(fd);
          return 0;
        }
    """))
    assert _rules(fs) == ["fd-leak"], [f.render() for f in fs]
    assert "'fd'" in fs[0].message and fs[0].qualname == "stage"


def test_fdleak_closed_on_all_paths_clean(tmp_path):
    fs = resource_paths.run(_cc_fixture(tmp_path, """
        int prepare(char* buf);
        int ok(const char* p, char* buf) {
          int fd = ::open(p, 0);
          if (prepare(buf) != 0) {
            ::close(fd);
            return -1;
          }
          ::close(fd);
          return 0;
        }
    """))
    assert fs == [], [f.render() for f in fs]


def test_fdleak_validity_test_suppresses_lexical_scan(tmp_path):
    # Branching on acquisition success means a lexical scan cannot tell
    # which side an exit is on: must stay silent (under-approximation).
    fs = resource_paths.run(_cc_fixture(tmp_path, """
        int checked(const char* p) {
          int fd = ::open(p, 0);
          if (fd < 0) {
            return -1;
          }
          ::close(fd);
          return 0;
        }
    """))
    assert fs == [], [f.render() for f in fs]


def test_fdleak_escape_to_returned_owner_clean(tmp_path):
    fs = resource_paths.run(_cc_fixture(tmp_path, """
        struct Owner { int fd = -1; };
        Owner* make(const char* p) {
          auto* o = new Owner();
          o->fd = ::open(p, 0);
          return o;
        }
    """))
    assert fs == [], [f.render() for f in fs]


def test_fdleak_original_rpc_start_shape_regression(tmp_path):
    # The exact shape this pass caught for real in rpc_core_start: the
    # short-circuit || guard leaks the FIRST pipe when the second fails,
    # and the epoll failure path leaked all four pipe fds.
    fs = resource_paths.run(_cc_fixture(tmp_path, """
        struct Endpoint {
          int wake_r = -1, wake_w = -1, notify_r = -1, notify_w = -1;
          int epfd = -1;
        };
        int MakePipe(int* r, int* w, bool cloexec);
        void* start_shape() {
          auto* ep = new Endpoint();
          if (MakePipe(&ep->wake_r, &ep->wake_w, true) != 0 ||
              MakePipe(&ep->notify_r, &ep->notify_w, true) != 0) {
            delete ep;
            return nullptr;
          }
          ep->epfd = ::epoll_create1(0);
          if (ep->epfd < 0) {
            delete ep;
            return nullptr;
          }
          return ep;
        }
    """))
    assert fs and all(f.rule == "fd-leak" for f in fs), \
        [f.render() for f in fs]
    msgs = " | ".join(f.message for f in fs)
    assert "wake_r" in msgs and "notify_r" in msgs
    # Short-circuit rule: the LAST acquiring call in the || guard may
    # have failed un-acquired — notify must NOT be flagged at the first
    # guard's exit (only at the epoll exit, where it is live for sure).
    first_exit = min(f.line for f in fs)
    assert all("notify" not in f.message for f in fs
               if f.line == first_exit), [f.render() for f in fs]


def test_split_c_functions_regions():
    text = ("int helper(int a) { return a; }\n"
            "struct S { int x; };\n"
            "void outer(S* s) {\n"
            "  if (s->x) { helper(1); }\n"
            "  while (s->x) { break; }\n"
            "}\n")
    names = [n for n, _s, _e, _l in split_c_functions(text)]
    assert names == ["helper", "outer"]


# ---------------------------------------------------------------------------
# driver — graftgate CLI integration
# ---------------------------------------------------------------------------

def test_cli_native_only_clean(capsys):
    rc = lint_main(["--native-only"])
    out = capsys.readouterr()
    assert rc == 0, out.out + out.err
    assert "native" in out.err


def test_cli_protocol_drift_fails_build(tmp_path, capsys):
    # CI acceptance: an op-ordering drift in the committed artifact is
    # caught by the port's default invocation.
    art = _mutated_protocol(
        tmp_path,
        lambda pr: pr["ops"]["drop"].update({"reply": True}))
    rc = lint_main(["--protocol", art])
    out = capsys.readouterr()
    assert rc == 1
    assert "protocol-drift" in out.out or "reply-path" in out.out


# ---------------------------------------------------------------------------
# pass 4d — hot-path round-trip costs vs tools/lint/budgets.json
# ---------------------------------------------------------------------------

def _hotpath_files():
    return [load_source(os.path.join(REPO, p.replace("/", os.sep)), REPO)
            for p in hotpath.WALK_FILES]


def _real_proto():
    return protocol.load_protocol(protocol.DEFAULT_PROTOCOL)


def _mutated_budgets(tmp_path, mutate):
    import json
    with open(hotpath.DEFAULT_BUDGETS) as f:
        budgets = json.load(f)
    mutate(budgets)
    p = tmp_path / "budgets.json"
    p.write_text(json.dumps(budgets))
    return str(p)


def test_hotpath_identity_real_tree_matches_artifact():
    # The committed artifact must re-derive EXACTLY from the real tree:
    # this is the identity the CI gate enforces. If this fails after an
    # intentional hot-path change, re-derive budgets.json (and justify
    # any cost increase) — do not loosen the test.
    fs = hotpath.check(hotpath.DEFAULT_BUDGETS, _hotpath_files(),
                       _real_proto())
    assert fs == [], [f.render() for f in fs]


def test_hotpath_budget_flip_artifact_cheaper_fails(tmp_path):
    # Direction 1: artifact claims the tree is CHEAPER than it is
    # (derived lowered below reality) -> the tree looks like a
    # regression against the committed contract -> hotpath-drift.
    art = _mutated_budgets(
        tmp_path,
        lambda b: b["ops"]["put"]["derived"].update({"sidecar_rt": 1}))
    fs = hotpath.check(art, _hotpath_files(), _real_proto())
    assert any(f.rule == "hotpath-drift" and "'put'" in f.message
               for f in fs), [f.render() for f in fs]


def test_hotpath_budget_flip_artifact_dearer_fails(tmp_path):
    # Direction 2: artifact claims the tree is DEARER than it is
    # (derived raised above reality) -> the tree got cheaper and the
    # artifact must be tightened -> hotpath-drift again. Exact
    # identity, not an inequality, in both directions.
    art = _mutated_budgets(
        tmp_path,
        lambda b: b["ops"]["put"]["derived"].update({"sidecar_rt": 3}))
    fs = hotpath.check(art, _hotpath_files(), _real_proto())
    assert any(f.rule == "hotpath-drift" and "'put'" in f.message
               for f in fs), [f.render() for f in fs]


def test_hotpath_budget_ceiling_breach_fails(tmp_path):
    # A budget cap below the (correctly re-derived) tree cost is a
    # breach: derived matches, so no drift — the budget gate alone
    # must catch it.
    art = _mutated_budgets(
        tmp_path,
        lambda b: b["ops"]["put"]["budget"].update({"sidecar_rt": 1}))
    fs = hotpath.check(art, _hotpath_files(), _real_proto())
    assert any(f.rule == "hotpath-budget" and "'put'" in f.message
               for f in fs), [f.render() for f in fs]
    assert not any(f.rule == "hotpath-drift" for f in fs), \
        [f.render() for f in fs]


def test_hotpath_stale_root_and_cold_entries_fail(tmp_path):
    # Renamed/deleted functions must not rot silently in the artifact.
    art = _mutated_budgets(
        tmp_path,
        lambda b: (b["ops"]["put"].update({"root": "CoreWorker._gone"}),
                   b["cold"].update({"CoreWorker._also_gone": "stale"})))
    fs = hotpath.check(art, _hotpath_files(), _real_proto())
    msgs = " | ".join(f.message for f in fs)
    assert "stale artifact" in msgs
    assert "_gone" in msgs and "_also_gone" in msgs


def test_hotpath_rpc_in_loop_flagged(tmp_path):
    # The anti-pattern every sub-1.0x bench row shared: one awaited
    # RPC per item. Cost counts the loop body ONCE (budgets are
    # per-op, not per-item) but the finding fires at the call site.
    sf = _sf(tmp_path, """
        class W:
            async def submit(self, items):
                for it in items:
                    await self.agent.call("push", it)
    """)
    budgets = {"ops": {"submit": {"root": "W.submit",
                                  "derived": {"agent_rt": 1}}},
               "cold": {}}
    derived, findings = hotpath.derive_costs(budgets, [sf], _real_proto())
    assert derived["submit"]["agent_rt"] == 1
    assert _rules(findings) == ["rpc-in-loop"]
    assert findings[0].qualname == "W.submit"


def test_hotpath_rt_under_lock_flagged(tmp_path):
    sf = _sf(tmp_path, """
        class W:
            async def submit(self, item):
                async with self._lock:
                    await self.controller.call("put", item)
    """)
    budgets = {"ops": {"submit": {"root": "W.submit",
                                  "derived": {"controller_rt": 1}}},
               "cold": {}}
    derived, findings = hotpath.derive_costs(budgets, [sf], _real_proto())
    assert derived["submit"]["controller_rt"] == 1
    assert _rules(findings) == ["rt-under-lock"]


def test_hotpath_helper_summary_poisons_loop_context(tmp_path):
    # Interprocedural: the RPC lives in a helper with no loop of its
    # own — the LOOP at the call site applies to everything the helper
    # reaches. The finding lands on the caller's call site, attributed
    # to the caller, naming the helper.
    sf = _sf(tmp_path, """
        class W:
            async def _push_one(self, it):
                await self.agent.call("push", it)

            async def submit(self, items):
                for it in items:
                    await self._push_one(it)
    """)
    budgets = {"ops": {"submit": {"root": "W.submit",
                                  "derived": {"agent_rt": 1}}},
               "cold": {}}
    derived, findings = hotpath.derive_costs(budgets, [sf], _real_proto())
    assert derived["submit"]["agent_rt"] == 1
    assert _rules(findings) == ["rpc-in-loop"]
    assert findings[0].qualname == "W.submit"
    assert "_push_one" in findings[0].message


def test_hotpath_blocking_sidecar_rt_on_loop_flagged(tmp_path):
    # A replying (reply:true) sidecar call in a sync helper reached
    # from an async def blocks the whole event loop on the reply read.
    sf = _sf(tmp_path, """
        class W:
            def _fetch(self, oid):
                return self.store.get(oid)

            async def submit(self, oid):
                return self._fetch(oid)
    """)
    budgets = {"ops": {"get": {"root": "W.submit",
                               "derived": {"sidecar_rt": 1}}},
               "cold": {}}
    derived, findings = hotpath.derive_costs(budgets, [sf], _real_proto())
    assert derived["get"]["sidecar_rt"] == 1
    assert "blocking-rt-on-loop" in _rules(findings)


def test_hotpath_deferred_put_is_send_not_rt(tmp_path):
    # put_deferred shares OP_PUT's replying wire slot but reads the
    # ack on a later request: classified sidecar_send, and exempt from
    # blocking-rt-on-loop (a socket write is microseconds).
    sf = _sf(tmp_path, """
        class W:
            async def submit(self, oid, data):
                self.store.put_deferred(oid, data)
    """)
    budgets = {"ops": {"put": {"root": "W.submit",
                               "derived": {"sidecar_send": 1}}},
               "cold": {}}
    derived, findings = hotpath.derive_costs(budgets, [sf], _real_proto())
    assert derived["put"]["sidecar_send"] == 1
    assert derived["put"]["sidecar_rt"] == 0
    assert findings == [], [f.render() for f in findings]


def test_hotpath_cold_functions_cost_zero(tmp_path):
    # Miss/retry paths are correctness paths: a cold entry excludes a
    # helper's round-trips from the caller's derived cost.
    src = """
        class W:
            async def _fetch_remote(self, oid):
                await self.agent.call("pull", oid)

            async def submit(self, oid):
                await self._fetch_remote(oid)
    """
    budgets = {"ops": {"get": {"root": "W.submit",
                               "derived": {"agent_rt": 1}}},
               "cold": {}}
    derived, _ = hotpath.derive_costs(
        budgets, [_sf(tmp_path, src)], _real_proto())
    assert derived["get"]["agent_rt"] == 1
    cold = {"ops": {"get": {"root": "W.submit", "derived": {}}},
            "cold": {"W._fetch_remote": "miss path, not hot path"}}
    derived, findings = hotpath.derive_costs(
        cold, [_sf(tmp_path, src, "m2.py")], _real_proto())
    assert derived["get"]["agent_rt"] == 0
    assert findings == []


def test_hotpath_allowlist_expiry_month_enforced(tmp_path):
    # Suppressions cannot rot: an entry whose month is strictly before
    # today's fails the whole lint run until re-justified or removed.
    p = tmp_path / "allow.txt"
    p.write_text("budgets.json : hotpath-drift : CoreWorker._put_direct"
                 " : 2026-07 : re-batching in flight\n")
    with pytest.raises(SystemExit, match="expired"):
        load_allowlist(str(p), today="2026-08")
    # Same month is still valid; future months too.
    al = load_allowlist(str(p), today="2026-07")
    assert len(al.entries) == 1
    al = load_allowlist(str(p), today="2026-01")
    assert len(al.entries) == 1


def test_hotpath_allowlist_suppresses_matching_finding(tmp_path):
    # The allowlist flow end-to-end: a drift finding with a matching
    # (path, rule, qualname) entry is suppressed; others are not.
    art = _mutated_budgets(
        tmp_path,
        lambda b: b["ops"]["put"]["derived"].update({"sidecar_rt": 1}))
    fs = hotpath.check(art, _hotpath_files(), _real_proto())
    drift = [f for f in fs if f.rule == "hotpath-drift"]
    assert drift
    f = drift[0]
    p = tmp_path / "allow.txt"
    p.write_text(f"{f.path} : {f.rule} : {f.qualname} : 2099-12 : "
                 f"known while re-batching lands\n")
    al = load_allowlist(str(p), today="2026-08")
    assert al.allows(f)
    assert al.unused() == []


def test_cli_hotpath_only_clean(capsys):
    rc = lint_main(["--hotpath-only"])
    out = capsys.readouterr()
    assert rc == 0, out.out + out.err
    assert "hotpath" in out.err


def test_cli_hotpath_budget_flip_fails_build(tmp_path, capsys):
    # CI acceptance: flipping a budgets.json entry fails the same
    # --hotpath-only invocation.
    art = _mutated_budgets(
        tmp_path,
        lambda b: b["ops"]["put"]["derived"].update({"sidecar_rt": 1}))
    rc = lint_main(["--hotpath-only", "--budgets", art])
    out = capsys.readouterr()
    assert rc == 1
    assert "hotpath-drift" in out.out


def test_cli_costs_table(capsys):
    rc = lint_main(["--costs"])
    out = capsys.readouterr()
    assert rc == 0
    assert "sidecar_rt" in out.out and "put" in out.out
    assert "derived[/budget]" in out.out


# ---------------------------------------------------------------------------
# the port's own cases: what the default run walks, a planted fault in a
# copy of the port's tree, and agreement with the JAX package's lint
# ---------------------------------------------------------------------------

def _record_inputs(monkeypatch):
    """Record every file the driver hands to a pass: the .py files it
    loads and each path argument of the wire, protocol and native
    passes."""
    import ray_tpu_torch.tools.lint.__main__ as drv
    seen = []

    def note(value):
        if isinstance(value, str) and value.endswith(
                (".py", ".cc", ".h", ".json")):
            seen.append(os.path.abspath(value))
        elif isinstance(value, (list, tuple)):
            for v in value:
                note(v)

    real_load = drv.load_source

    def load(abspath, root):
        note(abspath)
        return real_load(abspath, root)

    monkeypatch.setattr(drv, "load_source", load)
    for mod, names in ((wire_schema, ("run", "run_graft", "run_ctypes",
                                      "run_scope", "run_pulse",
                                      "run_prof", "run_log")),
                       (protocol, ("run",)), (memorder, ("run",)),
                       (resource_paths, ("run",))):
        for name in names:
            real = getattr(mod, name)

            def wrapped(*args, _real=real, **kwargs):
                note(list(args))
                return _real(*args, **kwargs)

            monkeypatch.setattr(mod, name, wrapped)
    return seen


def test_default_run_walks_only_port_files(monkeypatch, capsys):
    seen = _record_inputs(monkeypatch)
    import json

    rc = lint_main(["--json", "--allowlist", ""])
    findings = json.loads(capsys.readouterr().out)
    port = os.path.join(REPO, "ray_tpu_torch") + os.sep
    assert seen, "the default run walked nothing"
    outside = sorted({p for p in seen if not p.startswith(port)})
    assert outside == [], outside
    # Every plane's C++ and every default Python tree is walked.
    for rel in ("csrc/store_server.cc", "csrc/rpc_core.cc",
                "csrc/scope_core.h", "csrc/prof_core.h", "csrc/log_core.h",
                "csrc/copy_core.cc", "csrc/shm_core.cc",
                "core/object_store.py", "core/core_worker.py",
                "core/node_agent.py", "api.py", "serve/controller.py",
                "data/dataset.py", "core/_native/graftrpc.py",
                "tools/lint/protocol.json"):
        assert port + rel.replace("/", os.sep) in seen, rel
    # With no allowlist the only findings are the allowlisted pair, and
    # they name the port's file.
    assert rc == 1
    assert findings and all(f["path"].startswith("ray_tpu_torch/")
                            for f in findings), findings
    assert {f["path"] for f in findings} == {"ray_tpu_torch/core/rpc.py"}
    assert {f["rule"] for f in findings} == {"await-under-lock"}


def _copy_port_tree(dst):
    import shutil
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.so")
    for rel in ("core", "serve", "data", "csrc"):
        shutil.copytree(os.path.join(REPO, "ray_tpu_torch", rel),
                        os.path.join(dst, "ray_tpu_torch", rel),
                        ignore=ignore)
    shutil.copy(os.path.join(REPO, "ray_tpu_torch", "api.py"),
                os.path.join(dst, "ray_tpu_torch", "api.py"))


def test_planted_await_under_lock_in_port_copy_fails(tmp_path, capsys):
    _copy_port_tree(str(tmp_path))
    rc = lint_main(["--root", str(tmp_path)])
    out = capsys.readouterr()
    assert rc == 0, out.out + out.err
    target = tmp_path / "ray_tpu_torch" / "serve" / "controller.py"
    with open(target, "a") as f:
        f.write(textwrap.dedent("""

            class _Planted:
                async def refresh(self):
                    async with self._table_lock:
                        await self.agent.call("pull_object", b"oid")
        """))
    rc = lint_main(["--root", str(tmp_path)])
    out = capsys.readouterr()
    assert rc == 1, out.out + out.err
    assert "ray_tpu_torch/serve/controller.py" in out.out
    assert "await-under-lock" in out.out
    assert "_Planted.refresh" in out.out or "self._table_lock" in out.out


_PY_FIXTURES = {
    "blocking.py": """
        import time
        from ray_tpu_torch import api

        async def f(ref):
            time.sleep(1)
            with open("/tmp/x") as fh:
                fh.read()
            return api.get(ref)
    """,
    "locks.py": """
        class A:
            async def refresh(self):
                async with self._table_lock:
                    await self.agent.call("pull_object", b"oid")

            async def forward(self):
                async with self._a_lock:
                    async with self._b_lock:
                        self.n += 1

            async def backward(self):
                async with self._b_lock:
                    async with self._a_lock:
                        self.n -= 1
    """,
    "leaks.py": """
        import asyncio

        class A:
            async def work(self):
                return 1

            def kick(self):
                self.work()

            async def ok(self):
                asyncio.create_task(self.work())
    """,
    "rpc.py": _RPC_HANDLERS + """
        async def bad(client):
            await client.call("frob", 1, 2, 3, 4)
            await client.call("defrobulate", 1)
    """,
}

_CC_FIXTURE = """
    #include <atomic>
    #include <fcntl.h>
    #include <unistd.h>
    std::atomic<int> g_flag;
    std::atomic<long> g_head;
    int publish(int v) {
      g_flag.store(v);
      g_head.store(v, std::memory_order_relaxed);
      return g_flag.load();
    }
    int prepare(char* buf);
    int stage(const char* p, char* buf) {
      int fd = ::open(p, O_RDONLY);
      if (prepare(buf) != 0) {
        return -1;
      }
      ::close(fd);
      return 0;
    }
"""


def _strip_pkg(findings):
    return sorted((f.path, f.line, f.rule, f.severity,
                   f.message.replace("ray_tpu_torch", "ray_tpu"))
                  for f in findings)


@pytest.mark.parametrize("kind", ["python", "wire", "native"])
def test_port_and_reference_lints_agree_on_fixtures(kind, tmp_path, capsys):
    import json

    # The JAX package's lint: the one case of this file that imports it.
    from ray_tpu.tools.lint import memorder as ref_memorder
    from ray_tpu.tools.lint import resource_paths as ref_resource_paths
    from ray_tpu.tools.lint import wire_schema as ref_wire_schema
    from ray_tpu.tools.lint.__main__ import main as ref_main

    if kind == "python":
        for name, src in _PY_FIXTURES.items():
            (tmp_path / name).write_text(textwrap.dedent(src))
        args = [str(tmp_path), "--root", str(tmp_path), "--no-wire",
                "--rpc-root", str(tmp_path), "--allowlist", "", "--json"]
        assert lint_main(args) == 1
        ours = capsys.readouterr().out
        assert ref_main(args) == 1
        theirs = capsys.readouterr().out
        assert ours == theirs
        rules = {f["rule"] for f in json.loads(ours)}
        assert {"blocking-call", "await-under-lock", "lock-order",
                "unawaited-coroutine", "orphan-task", "rpc-arity-drift",
                "rpc-unknown-method"} <= rules, rules
    elif kind == "wire":
        seen = 0
        for old, new in (("kOpDelete = 4", "kOpDelete = 6"),
                         ("uint64_t size;", "uint32_t size;"),
                         ("uint8_t origin;", "uint16_t origin;")):
            cc = _mutated_cc(tmp_path, old, new)
            ours = wire_schema.run(STORE_PY, cc, "py", "cc")
            theirs = ref_wire_schema.run(STORE_PY, cc, "py", "cc")
            assert ours and _strip_pkg(ours) == _strip_pkg(theirs)
            seen += len(ours)
        assert seen >= 3
    else:
        files = _cc_fixture(tmp_path, _CC_FIXTURE)
        ours = memorder.run(files) + resource_paths.run(files)
        theirs = ref_memorder.run(files) + ref_resource_paths.run(files)
        assert ours and _strip_pkg(ours) == _strip_pkg(theirs)
        assert {"fd-leak", "memory-order"} <= {f.rule for f in ours}, \
            _strip_pkg(ours)
