"""Pass 3a — Python<->C wire-schema drift.

The fast-path store protocol is hand-duplicated: opcode numbers and the
event-journal layout live in `ray_tpu_torch/core/object_store.py`
(`FastStoreClient.OP_*`, `StoreSidecar.EVENT_SIZE` + `drain()` slicing)
and again in `ray_tpu_torch/csrc/store_server.cc` (`kOp*`, `struct Event`, the drain
packing, and the request/response framing). A one-sided edit ships a
protocol break that only surfaces as runtime corruption, so this pass
re-derives both sides (AST for Python, regex-over-constexpr for C — no
clang needed) and fails on any mismatch in opcode values, field order,
offsets, or widths.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.tools.lint.common import Finding

RULE = "wire-drift"

_C_TYPE_WIDTHS = {"uint8_t": 1, "int8_t": 1, "char": 1, "uint16_t": 2,
                  "int16_t": 2, "uint32_t": 4, "int32_t": 4, "int": 4,
                  "uint64_t": 8, "int64_t": 8}


# --------------------------------------------------------------------------
# Python side.
# --------------------------------------------------------------------------
class PySchema:
    def __init__(self) -> None:
        self.opcodes: Dict[str, int] = {}      # INGEST -> 1
        self.event_size: Optional[int] = None
        # field name -> (offset, width) parsed from drain()'s slicing
        self.event_fields: Dict[str, Tuple[int, int]] = {}


def parse_python(path: str) -> Tuple[PySchema, List[str]]:
    errors: List[str] = []
    schema = PySchema()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    client = sidecar = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            if node.name == "FastStoreClient":
                client = node
            elif node.name == "StoreSidecar":
                sidecar = node
    if client is None:
        errors.append("class FastStoreClient not found")
    else:
        for stmt in client.body:
            if not isinstance(stmt, ast.Assign):
                continue
            targets = stmt.targets[0]
            names = ([t.id for t in targets.elts]
                     if isinstance(targets, ast.Tuple)
                     else [targets.id] if isinstance(targets, ast.Name)
                     else [])
            values = (stmt.value.elts if isinstance(stmt.value, ast.Tuple)
                      else [stmt.value])
            for name, val in zip(names, values):
                if name.startswith("OP_") and isinstance(val, ast.Constant):
                    schema.opcodes[name[3:]] = val.value
        if not schema.opcodes:
            errors.append("FastStoreClient defines no OP_* constants")
    if sidecar is None:
        errors.append("class StoreSidecar not found")
    else:
        for stmt in sidecar.body:
            if (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "EVENT_SIZE"):
                # may be `29` or an arithmetic expression
                try:
                    schema.event_size = int(
                        ast.literal_eval(_fold(stmt.value)))
                except Exception:
                    errors.append("cannot evaluate StoreSidecar.EVENT_SIZE")
        drain = next((n for n in sidecar.body
                      if isinstance(n, ast.FunctionDef)
                      and n.name == "drain"), None)
        if drain is None:
            errors.append("StoreSidecar.drain not found")
        else:
            slices = _rec_slices(drain)
            if slices:
                schema.event_fields = slices
            else:
                errors.append("drain(): no rec[...] slicing found")
    return schema, errors


def _fold(node: ast.AST) -> ast.AST:
    return node


def _rec_slices(drain: ast.FunctionDef) -> Dict[str, Tuple[int, int]]:
    """Read drain()'s `rec[a:b]` subscripts: offset 0 byte = op. With
    three slices (the grafttrail journal layout) they are, in offset
    order, origin / oid / size; with two (the legacy layout) the first
    multi-byte slice = oid, the second = size."""
    pairs: List[Tuple[int, int]] = []
    for node in ast.walk(drain):
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "rec"):
            continue
        sl = node.slice
        if (isinstance(sl, ast.Slice)
                and isinstance(sl.lower, ast.Constant)
                and isinstance(sl.upper, ast.Constant)):
            pairs.append((sl.lower.value, sl.upper.value))
    pairs.sort()
    fields: Dict[str, Tuple[int, int]] = {"op": (0, 1)}
    names = (["origin", "oid", "size"] if len(pairs) >= 3
             else ["oid", "size"])
    for name, (lo, hi) in zip(names, pairs):
        fields[name] = (lo, hi - lo)
    return fields


# --------------------------------------------------------------------------
# C side (clang-free: targeted regexes over the constexpr block, the
# Event struct, the drain packing, and the framing code).
# --------------------------------------------------------------------------
class CSchema:
    def __init__(self) -> None:
        self.opcodes: Dict[str, int] = {}      # Ingest -> 1
        self.id_size: Optional[int] = None
        self.event_fields: List[Tuple[str, int]] = []  # (name, width)
        self.drain_offsets: Dict[str, int] = {}        # oid/size offsets
        self.drain_stride: Optional[int] = None
        self.req_header: Optional[int] = None          # client buffer
        self.server_reads: List[int] = []              # header widths
        self.server_writes: List[int] = []             # response widths
        self.client_reads: List[int] = []              # response widths


def parse_c(path: str) -> Tuple[CSchema, List[str]]:
    errors: List[str] = []
    schema = CSchema()
    with open(path, encoding="utf-8") as f:
        text = f.read()

    m = re.search(r"constexpr\s+int\s+kIdSize\s*=\s*(\d+)\s*;", text)
    if m:
        schema.id_size = int(m.group(1))
    else:
        errors.append("kIdSize constexpr not found")

    for m in re.finditer(r"kOp([A-Za-z0-9_]+)\s*=\s*(\d+)", text):
        schema.opcodes[m.group(1)] = int(m.group(2))
    if not schema.opcodes:
        errors.append("no kOp* constants found")

    consts = {"kIdSize": schema.id_size or 0}

    def ev(expr: str) -> Optional[int]:
        expr = expr.strip()
        for k, v in consts.items():
            expr = expr.replace(k, str(v))
        if not re.fullmatch(r"[\d\s+*()-]+", expr):
            return None
        try:
            return int(eval(expr))  # noqa: S307 — digits/ops only
        except Exception:
            return None

    m = re.search(r"struct\s+Event\s*\{(.*?)\};", text, re.S)
    if not m:
        errors.append("struct Event not found")
    else:
        for fm in re.finditer(
                r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s+([A-Za-z_][A-Za-z0-9_]*)"
                r"(?:\[([^\]]+)\])?\s*;", m.group(1), re.M):
            ctype, name, arr = fm.group(1), fm.group(2), fm.group(3)
            width = _C_TYPE_WIDTHS.get(ctype)
            if width is None:
                errors.append(f"struct Event: unknown type {ctype}")
                continue
            if arr is not None:
                count = ev(arr)
                if count is None:
                    errors.append(f"struct Event: cannot size {name}[{arr}]")
                    continue
                width *= count
            schema.event_fields.append((name, width))

    # Drain packing: buf[n] = op; memcpy(buf + n + OFF, e.FIELD, W)
    for fm in re.finditer(
            r"memcpy\(buf\s*\+\s*n\s*\+\s*(\d+)\s*,\s*&?e\.(\w+)\s*,"
            r"\s*([A-Za-z0-9_]+)\)", text):
        schema.drain_offsets[fm.group(2)] = int(fm.group(1))
    m = re.search(r"n\s*\+=\s*(\d+)\s*;", text)
    if m:
        schema.drain_stride = int(m.group(1))

    # Client request header buffer: char req[1 + kIdSize + 8 + 8 + 2]
    m = re.search(r"char\s+req\[([^\]]+)\]", text)
    if m:
        schema.req_header = ev(m.group(1))
    else:
        errors.append("client request buffer (char req[...]) not found")

    # Server-side header reads / response writes, client response reads.
    server_region = _region(text, "ConnLoop")
    client_region = _region(text, "store_client_request")
    schema.server_reads = _io_widths(server_region, "ReadFull", ev)[:5]
    schema.server_writes = _io_widths(server_region, "WriteFull", ev)[:4]
    schema.client_reads = _io_widths(client_region, "ReadFull", ev)[:4]
    return schema, errors


def _region(text: str, fn_name: str) -> str:
    """The body of the (column-0) function definition of `fn_name`: from
    the definition line to the next closing brace at column 0."""
    m = re.search(r"^[A-Za-z_][\w:<> ]*\*?\s*\b" + fn_name + r"\s*\(",
                  text, re.M)
    if m is None:
        return ""
    end = text.find("\n}", m.start())
    return text[m.start():end + 2] if end >= 0 else text[m.start():]


def _io_widths(region: str, fn: str, ev) -> List[int]:
    out = []
    for m in re.finditer(fn + r"\(fd,\s*[^,]+,\s*([A-Za-z0-9_ +*-]+)\)",
                         region):
        w = ev(m.group(1))
        if w is not None:
            out.append(w)
    return out


# --------------------------------------------------------------------------
# Cross-checks.
# --------------------------------------------------------------------------
def run(py_path: str, cc_path: str, py_rel: str, cc_rel: str
        ) -> List[Finding]:
    findings: List[Finding] = []

    def err(path: str, msg: str) -> None:
        findings.append(Finding(path, 1, RULE, "error", msg))

    py, py_errors = parse_python(py_path)
    cc, cc_errors = parse_c(cc_path)
    for e in py_errors:
        err(py_rel, e)
    for e in cc_errors:
        err(cc_rel, e)
    if py_errors or cc_errors:
        return findings

    # 1. Opcode tables: same names, same values.
    py_ops = {k.lower(): v for k, v in py.opcodes.items()}
    cc_ops = {k.lower(): v for k, v in cc.opcodes.items()}
    for name in sorted(set(py_ops) | set(cc_ops)):
        if name not in py_ops:
            err(py_rel, f"opcode {name!r} exists in C (kOp*) but has no "
                        f"OP_* constant in FastStoreClient")
        elif name not in cc_ops:
            err(cc_rel, f"opcode {name!r} exists in Python (OP_*) but "
                        f"has no kOp* constant")
        elif py_ops[name] != cc_ops[name]:
            err(py_rel, f"opcode {name!r} drift: Python OP_={py_ops[name]}"
                        f" vs C kOp={cc_ops[name]}")

    # 2. Object-id width: C kIdSize vs the drain() oid slice.
    oid = py.event_fields.get("oid")
    if oid is not None and cc.id_size is not None \
            and oid[1] != cc.id_size:
        err(py_rel, f"oid width drift: drain() slices {oid[1]} bytes but "
                    f"C kIdSize={cc.id_size}")

    # 3. Event record: packed struct width == EVENT_SIZE == drain stride,
    #    field offsets agree with Python's slicing.
    packed = sum(w for _, w in cc.event_fields)
    if py.event_size is not None and packed != py.event_size:
        err(cc_rel, f"event record drift: C struct Event packs to "
                    f"{packed} bytes but Python EVENT_SIZE="
                    f"{py.event_size}")
    if cc.drain_stride is not None and py.event_size is not None \
            and cc.drain_stride != py.event_size:
        err(cc_rel, f"event record drift: C drain stride "
                    f"{cc.drain_stride} != Python EVENT_SIZE "
                    f"{py.event_size}")
    offset = 0
    c_offsets = {}
    for name, width in cc.event_fields:
        c_offsets[name] = (offset, width)
        offset += width
    for fname, (py_off, py_w) in py.event_fields.items():
        c = c_offsets.get(fname)
        if c is None:
            continue
        if (py_off, py_w) != c:
            err(py_rel, f"event field {fname!r} drift: Python reads "
                        f"[{py_off}:{py_off + py_w}] but C packs it at "
                        f"offset {c[0]} width {c[1]}")
    for fname, (c_off, c_w) in c_offsets.items():
        # every drain memcpy offset must match the packed layout
        d = cc.drain_offsets.get(fname)
        if d is not None and d != c_off:
            err(cc_rel, f"drain packing drift: field {fname!r} copied at "
                        f"offset {d} but struct layout says {c_off}")

    # 4. Request/response framing: client layout vs server reads.
    if cc.req_header is not None and cc.server_reads:
        if cc.req_header != sum(cc.server_reads):
            err(cc_rel, f"request header drift: client sends "
                        f"{cc.req_header} bytes, server reads "
                        f"{sum(cc.server_reads)}")
    if cc.server_writes and cc.client_reads \
            and cc.server_writes != cc.client_reads:
        err(cc_rel, f"response framing drift: server writes widths "
                    f"{cc.server_writes}, client reads "
                    f"{cc.client_reads}")
    return findings


# ==========================================================================
# Pass 3c — graftrpc dispatch-plane schema drift.
#
# The graftrpc frame format is hand-duplicated the same way the store
# protocol is: opcodes + header layout live in
# `ray_tpu_torch/core/_native/graftrpc.py` (OP_*, FRAME_HEADER_FIELDS,
# FRAME_HEADER struct format, FRAME_HEADER_SIZE, MAX_FRAME) and again in
# `ray_tpu_torch/csrc/rpc_core.cc` (kOp*, packed struct FrameHeader, kFrameHeaderSize,
# kMaxFrame). Re-derive both sides and fail on any field-by-field
# mismatch: name, width, order, total size, opcode value, frame cap.
# ==========================================================================

_STRUCT_CHAR_WIDTHS = {"b": 1, "B": 1, "h": 2, "H": 2, "i": 4, "I": 4,
                       "l": 4, "L": 4, "q": 8, "Q": 8}


def _const_int(node: ast.AST) -> Optional[int]:
    """Evaluate a literal int expression (constants, << + - * |)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.BinOp):
        lhs, rhs = _const_int(node.left), _const_int(node.right)
        if lhs is None or rhs is None:
            return None
        op = node.op
        if isinstance(op, ast.LShift):
            return lhs << rhs
        if isinstance(op, ast.Add):
            return lhs + rhs
        if isinstance(op, ast.Sub):
            return lhs - rhs
        if isinstance(op, ast.Mult):
            return lhs * rhs
        if isinstance(op, ast.BitOr):
            return lhs | rhs
    return None


class GraftPySchema:
    def __init__(self) -> None:
        self.opcodes: Dict[str, int] = {}            # CALL -> 1
        self.header_fields: List[Tuple[str, int]] = []  # (name, width)
        self.struct_widths: List[int] = []           # from "<BBHQ"
        self.header_size: Optional[int] = None
        self.max_frame: Optional[int] = None


def parse_graft_py(path: str) -> Tuple[GraftPySchema, List[str]]:
    errors: List[str] = []
    schema = GraftPySchema()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            continue
        name, val = stmt.targets[0].id, stmt.value
        if name.startswith("OP_"):
            v = _const_int(val)
            if v is None:
                errors.append(f"cannot evaluate {name}")
            else:
                schema.opcodes[name[3:]] = v
        elif name == "FRAME_HEADER_FIELDS":
            if not isinstance(val, ast.Tuple):
                errors.append("FRAME_HEADER_FIELDS is not a tuple")
                continue
            for el in val.elts:
                if (isinstance(el, ast.Tuple) and len(el.elts) == 2
                        and isinstance(el.elts[0], ast.Constant)):
                    w = _const_int(el.elts[1])
                    if w is None:
                        errors.append("FRAME_HEADER_FIELDS: bad width")
                        continue
                    schema.header_fields.append((el.elts[0].value, w))
                else:
                    errors.append("FRAME_HEADER_FIELDS: bad entry shape")
        elif name == "FRAME_HEADER":
            # struct.Struct("<BBHQ") — read widths off the format chars.
            if (isinstance(val, ast.Call) and val.args
                    and isinstance(val.args[0], ast.Constant)):
                fmt = val.args[0].value
                for ch in str(fmt).lstrip("<>=!@"):
                    w = _STRUCT_CHAR_WIDTHS.get(ch)
                    if w is None:
                        errors.append(
                            f"FRAME_HEADER: unknown format char {ch!r}")
                    else:
                        schema.struct_widths.append(w)
            else:
                errors.append("FRAME_HEADER is not struct.Struct(<literal>)")
        elif name == "FRAME_HEADER_SIZE":
            schema.header_size = _const_int(val)
            if schema.header_size is None:
                errors.append("cannot evaluate FRAME_HEADER_SIZE")
        elif name == "MAX_FRAME":
            schema.max_frame = _const_int(val)
            if schema.max_frame is None:
                errors.append("cannot evaluate MAX_FRAME")
    if not schema.opcodes:
        errors.append("no OP_* constants found")
    if not schema.header_fields:
        errors.append("FRAME_HEADER_FIELDS not found")
    if not schema.struct_widths:
        errors.append("FRAME_HEADER struct format not found")
    return schema, errors


class GraftCSchema:
    def __init__(self) -> None:
        self.opcodes: Dict[str, int] = {}            # Call -> 1
        self.header_fields: List[Tuple[str, int]] = []
        self.header_size: Optional[int] = None
        self.max_frame: Optional[int] = None


def parse_graft_c(path: str) -> Tuple[GraftCSchema, List[str]]:
    errors: List[str] = []
    schema = GraftCSchema()
    with open(path, encoding="utf-8") as f:
        text = f.read()

    for m in re.finditer(r"kOp([A-Za-z0-9_]+)\s*=\s*(\d+)", text):
        schema.opcodes[m.group(1)] = int(m.group(2))
    if not schema.opcodes:
        errors.append("no kOp* constants found")

    m = re.search(r"constexpr\s+int\s+kFrameHeaderSize\s*=\s*(\d+)\s*;",
                  text)
    if m:
        schema.header_size = int(m.group(1))
    else:
        errors.append("kFrameHeaderSize constexpr not found")

    m = re.search(r"kMaxFrame\s*=\s*([0-9a-zA-Z<< ]+?)\s*;", text)
    if m:
        expr = m.group(1).replace("u", "").strip()
        if re.fullmatch(r"[\d\s<<]+", expr):
            try:
                schema.max_frame = int(eval(expr))  # noqa: S307 — digits/<<
            except Exception:
                errors.append(f"cannot evaluate kMaxFrame = {m.group(1)!r}")
        else:
            errors.append(f"cannot evaluate kMaxFrame = {m.group(1)!r}")
    else:
        errors.append("kMaxFrame not found")

    m = re.search(r"struct\s+FrameHeader\s*\{(.*?)\};", text, re.S)
    if not m:
        errors.append("struct FrameHeader not found")
    else:
        for fm in re.finditer(
                r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s+([A-Za-z_][A-Za-z0-9_]*)"
                r"\s*;", m.group(1), re.M):
            ctype, fname = fm.group(1), fm.group(2)
            width = _C_TYPE_WIDTHS.get(ctype)
            if width is None:
                errors.append(f"struct FrameHeader: unknown type {ctype}")
                continue
            schema.header_fields.append((fname, width))
        if not schema.header_fields:
            errors.append("struct FrameHeader has no parsable fields")
    return schema, errors


def run_graft(py_path: str, cc_path: str, py_rel: str, cc_rel: str
              ) -> List[Finding]:
    findings: List[Finding] = []

    def err(path: str, msg: str) -> None:
        findings.append(Finding(path, 1, RULE, "error", msg))

    py, py_errors = parse_graft_py(py_path)
    cc, cc_errors = parse_graft_c(cc_path)
    for e in py_errors:
        err(py_rel, e)
    for e in cc_errors:
        err(cc_rel, e)
    if py_errors or cc_errors:
        return findings

    # 1. Opcode tables: same names, same values.
    py_ops = {k.lower(): v for k, v in py.opcodes.items()}
    cc_ops = {k.lower(): v for k, v in cc.opcodes.items()}
    for name in sorted(set(py_ops) | set(cc_ops)):
        if name not in py_ops:
            err(py_rel, f"graft opcode {name!r} exists in C (kOp*) but "
                        f"has no OP_* constant in graftrpc.py")
        elif name not in cc_ops:
            err(cc_rel, f"graft opcode {name!r} exists in Python (OP_*) "
                        f"but has no kOp* constant")
        elif py_ops[name] != cc_ops[name]:
            err(py_rel, f"graft opcode {name!r} drift: Python "
                        f"OP_={py_ops[name]} vs C kOp={cc_ops[name]}")

    # 2. Frame header: field-by-field name/width/order.
    if len(py.header_fields) != len(cc.header_fields):
        err(py_rel, f"frame header drift: Python declares "
                    f"{len(py.header_fields)} fields, C struct has "
                    f"{len(cc.header_fields)}")
    for (pn, pw), (cn, cw) in zip(py.header_fields, cc.header_fields):
        if pn != cn:
            err(py_rel, f"frame header field order drift: Python has "
                        f"{pn!r} where C has {cn!r}")
        elif pw != cw:
            err(py_rel, f"frame header field {pn!r} width drift: Python "
                        f"{pw} vs C {cw}")

    # 3. Struct format chars vs the declared field widths.
    declared = [w for _, w in py.header_fields]
    if py.struct_widths != declared:
        err(py_rel, f"FRAME_HEADER format widths {py.struct_widths} != "
                    f"FRAME_HEADER_FIELDS widths {declared}")

    # 4. Header size: both constants and both layouts must agree.
    psum = sum(w for _, w in py.header_fields)
    csum = sum(w for _, w in cc.header_fields)
    if py.header_size is not None and psum != py.header_size:
        err(py_rel, f"FRAME_HEADER_FIELDS pack to {psum} bytes but "
                    f"FRAME_HEADER_SIZE={py.header_size}")
    if cc.header_size is not None and csum != cc.header_size:
        err(cc_rel, f"struct FrameHeader packs to {csum} bytes but "
                    f"kFrameHeaderSize={cc.header_size}")
    if py.header_size is not None and cc.header_size is not None \
            and py.header_size != cc.header_size:
        err(py_rel, f"header size drift: FRAME_HEADER_SIZE="
                    f"{py.header_size} vs kFrameHeaderSize="
                    f"{cc.header_size}")

    # 5. Frame cap.
    if py.max_frame is not None and cc.max_frame is not None \
            and py.max_frame != cc.max_frame:
        err(py_rel, f"frame cap drift: MAX_FRAME={py.max_frame} vs "
                    f"kMaxFrame={cc.max_frame}")
    return findings


# ==========================================================================
# Pass 3d — ctypes binding signatures vs C exports.
#
# Every native entry point is declared twice: the C definition in
# ray_tpu_torch/csrc/*.cc and the ctypes restype/argtypes in
# `ray_tpu_torch/core/object_store.py::_load_lib`. A one-sided edit (an added
# parameter, a widened size field, a handle return) produces silent
# stack/register garbage at call time — ctypes cannot check it. This
# pass re-derives both sides (AST for the _load_lib assignments, regex
# over column-0 function definitions for C) and fails on arity drift,
# per-argument width/pointerness drift, return-type drift, and the
# nastiest default: a C function returning a pointer or 64-bit value
# whose binding never sets restype (ctypes defaults to 4-byte c_int —
# pointer truncation on 64-bit).
# ==========================================================================

# ctypes type -> (class, byte width). Pointers compare by class only.
_CTYPES_CLASSES: Dict[str, Tuple[str, int]] = {
    "c_void_p": ("ptr", 8), "c_char_p": ("ptr", 8), "c_wchar_p": ("ptr", 8),
    "py_object": ("ptr", 8),
    "c_bool": ("int", 1), "c_uint8": ("int", 1), "c_int8": ("int", 1),
    "c_byte": ("int", 1), "c_ubyte": ("int", 1), "c_char": ("int", 1),
    "c_uint16": ("int", 2), "c_int16": ("int", 2), "c_short": ("int", 2),
    "c_ushort": ("int", 2),
    "c_uint32": ("int", 4), "c_int32": ("int", 4), "c_int": ("int", 4),
    "c_uint": ("int", 4),
    "c_uint64": ("int", 8), "c_int64": ("int", 8), "c_size_t": ("int", 8),
    "c_ssize_t": ("int", 8), "c_long": ("int", 8), "c_ulong": ("int", 8),
    "c_longlong": ("int", 8), "c_ulonglong": ("int", 8),
    "c_float": ("float", 4), "c_double": ("float", 8),
}

# Column-0 C function definition/declaration, params possibly wrapping.
_C_FN_RE = re.compile(
    r"^(?P<ret>(?:const\s+)?[A-Za-z_][A-Za-z0-9_]*\s*\**)\s*"
    r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*\((?P<args>[^)]*)\)\s*[;{]",
    re.M)


def _fmt_class(cls: Tuple[str, int]) -> str:
    kind, width = cls
    if kind == "ptr":
        return "pointer"
    if kind == "void":
        return "void"
    return f"{width * 8}-bit {kind}"


def _ctypes_class(node: ast.AST) -> Optional[Tuple[str, int]]:
    """Width class of a ctypes type expression (ctypes.c_uint64,
    POINTER(...), bare c_int)."""
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) \
            else getattr(fn, "id", "")
        if name == "POINTER":
            return ("ptr", 8)
        return None
    name = node.attr if isinstance(node, ast.Attribute) \
        else getattr(node, "id", None)
    if name is None:
        return None
    return _CTYPES_CLASSES.get(name)


def _collect_binding_assigns(body, env: Dict[str, List[str]],
                             sigs: Dict[str, dict],
                             errors: List[str]) -> None:
    """Walk _load_lib statements collecting `lib.NAME.restype/argtypes`
    and the `for fn in ("a", "b"): getattr(lib, fn).x = ...` batch
    idiom (env maps the loop variable to its literal names)."""
    for stmt in body:
        if isinstance(stmt, ast.For):
            env2 = dict(env)
            if (isinstance(stmt.target, ast.Name)
                    and isinstance(stmt.iter, (ast.Tuple, ast.List))
                    and all(isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                            for e in stmt.iter.elts)):
                env2[stmt.target.id] = [e.value for e in stmt.iter.elts]
            _collect_binding_assigns(stmt.body, env2, sigs, errors)
            continue
        if isinstance(stmt, (ast.If, ast.With, ast.Try)):
            _collect_binding_assigns(getattr(stmt, "body", []), env, sigs,
                                     errors)
            continue
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1):
            continue
        t = stmt.targets[0]
        if not (isinstance(t, ast.Attribute)
                and t.attr in ("restype", "argtypes")):
            continue
        base = t.value
        fn_names: List[str] = []
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "lib"):
            fn_names = [base.attr]
        elif (isinstance(base, ast.Call)
              and getattr(base.func, "id", "") == "getattr"
              and len(base.args) == 2
              and isinstance(base.args[1], ast.Name)):
            fn_names = env.get(base.args[1].id, [])
            if not fn_names:
                errors.append(
                    f"line {stmt.lineno}: cannot resolve "
                    f"getattr(lib, {base.args[1].id}) to literal names")
        else:
            continue
        for fname in fn_names:
            sig = sigs.setdefault(fname, {"restype": None, "argtypes": None,
                                          "line": stmt.lineno})
            if t.attr == "restype":
                cls = _ctypes_class(stmt.value)
                if cls is None:
                    errors.append(f"line {stmt.lineno}: unknown ctypes "
                                  f"restype expression for {fname}")
                else:
                    sig["restype"] = cls
            else:
                if not isinstance(stmt.value, (ast.List, ast.Tuple)):
                    errors.append(f"line {stmt.lineno}: argtypes for "
                                  f"{fname} is not a literal list")
                    continue
                classes = []
                for el in stmt.value.elts:
                    cls = _ctypes_class(el)
                    if cls is None:
                        errors.append(f"line {stmt.lineno}: unknown "
                                      f"ctypes argtype for {fname}")
                        classes = None
                        break
                    classes.append(cls)
                if classes is not None:
                    sig["argtypes"] = classes


def parse_ctypes_py(path: str) -> Tuple[Dict[str, dict], List[str]]:
    errors: List[str] = []
    sigs: Dict[str, dict] = {}
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    loader = next((n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)
                   and n.name == "_load_lib"), None)
    if loader is None:
        errors.append("_load_lib not found")
        return sigs, errors
    _collect_binding_assigns(loader.body, {}, sigs, errors)
    if not sigs:
        errors.append("_load_lib declares no lib.*.restype/argtypes")
    return sigs, errors


def _c_param_class(param: str) -> Optional[Tuple[str, int]]:
    param = param.strip()
    if not param or param == "void" or param == "...":
        return None
    if "*" in param:
        return ("ptr", 8)
    toks = [t for t in re.split(r"\s+", param)
            if t not in ("const", "struct", "volatile")]
    if not toks:
        return None
    width = _C_TYPE_WIDTHS.get(toks[0])
    if width is None:
        return None
    return ("int", width)


def _c_ret_class(ret: str) -> Optional[Tuple[str, int]]:
    ret = ret.strip()
    if "*" in ret:
        return ("ptr", 8)
    tok = ret.replace("const", "").strip()
    if tok == "void":
        return ("void", 0)
    width = _C_TYPE_WIDTHS.get(tok)
    if width is None:
        return None
    return ("int", width)


def parse_c_exports(path: str, rel: str, errors: List[Finding]
                    ) -> Dict[str, Tuple[str, int, Tuple, List]]:
    """name -> (rel, line, ret_class, [param_class]) for every column-0
    function definition/declaration in the file. Anonymous-namespace
    helpers also match; callers only consult bound names, so they are
    inert."""
    out: Dict[str, Tuple[str, int, Tuple, List]] = {}
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for m in _C_FN_RE.finditer(text):
        name = m.group("name")
        line = text.count("\n", 0, m.start()) + 1
        ret = _c_ret_class(m.group("ret"))
        if ret is None:
            continue  # not a function def (macro, template, etc.)
        args_src = m.group("args").strip()
        params: List[Tuple[str, int]] = []
        bad = False
        if args_src and args_src != "void":
            for p in args_src.split(","):
                cls = _c_param_class(p)
                if cls is None:
                    bad = True
                    break
                params.append(cls)
        if bad:
            continue  # unparsable param (function pointer etc.)
        out[name] = (rel, line, ret, params)
    return out


def run_ctypes(py_path: str, cc_paths: List[str], py_rel: str,
               cc_rels: List[str]) -> List[Finding]:
    findings: List[Finding] = []

    def err(path: str, line: int, msg: str) -> None:
        findings.append(Finding(path, line, RULE, "error", msg))

    py_sigs, py_errors = parse_ctypes_py(py_path)
    for e in py_errors:
        err(py_rel, 1, e)
    if py_errors and not py_sigs:
        return findings

    # One C namespace across the shared library's translation units;
    # later files may re-declare earlier files' exports (forward decls)
    # — those must agree too.
    c_sigs: Dict[str, List[Tuple[str, int, Tuple, List]]] = {}
    for path, rel in zip(cc_paths, cc_rels):
        for name, entry in parse_c_exports(path, rel, findings).items():
            c_sigs.setdefault(name, []).append(entry)
    for name, entries in sorted(c_sigs.items()):
        if name not in py_sigs or len(entries) < 2:
            continue
        rel0, line0, ret0, params0 = entries[0]
        for rel1, line1, ret1, params1 in entries[1:]:
            if (ret1, params1) != (ret0, params0):
                err(rel1, line1,
                    f"C declaration of {name!r} disagrees with the one "
                    f"at {rel0}:{line0}")

    for fname in sorted(py_sigs):
        sig = py_sigs[fname]
        entries = c_sigs.get(fname)
        if not entries:
            err(py_rel, sig["line"],
                f"ctypes binding {fname!r} has no C definition in "
                f"{', '.join(cc_rels)}")
            continue
        c_rel, c_line, c_ret, c_params = entries[0]
        py_args = sig["argtypes"]
        if py_args is not None:
            if len(py_args) != len(c_params):
                err(py_rel, sig["line"],
                    f"ctypes arity drift for {fname!r}: binding declares "
                    f"{len(py_args)} argument(s), C takes "
                    f"{len(c_params)} ({c_rel}:{c_line})")
            else:
                for i, (pa, ca) in enumerate(zip(py_args, c_params)):
                    if pa != ca:
                        err(py_rel, sig["line"],
                            f"ctypes width drift for {fname!r} argument "
                            f"{i}: binding passes {_fmt_class(pa)}, C "
                            f"expects {_fmt_class(ca)} "
                            f"({c_rel}:{c_line})")
        py_ret = sig["restype"]
        if py_ret is None:
            # ctypes defaults restype to c_int (4 bytes): fine for
            # void/int returns, silent truncation for anything wider.
            if c_ret[0] == "ptr" or (c_ret[0] == "int" and c_ret[1] > 4):
                err(py_rel, sig["line"],
                    f"ctypes binding {fname!r} leaves restype at the "
                    f"4-byte c_int default but C returns "
                    f"{_fmt_class(c_ret)} ({c_rel}:{c_line}) — silent "
                    f"truncation on 64-bit")
        elif c_ret == ("void", 0):
            err(py_rel, sig["line"],
                f"ctypes binding {fname!r} sets restype but C returns "
                f"void ({c_rel}:{c_line})")
        elif py_ret != c_ret:
            err(py_rel, sig["line"],
                f"ctypes restype drift for {fname!r}: binding reads "
                f"{_fmt_class(py_ret)}, C returns {_fmt_class(c_ret)} "
                f"({c_rel}:{c_line})")
    return findings


# ==========================================================================
# Pass 3e — graftscope flight-recorder record drift.
#
# The 24-byte recorder record is hand-duplicated: kind numbers + field
# layout live in `ray_tpu_torch/core/_native/graftscope.py` (KIND_*,
# SCOPE_RECORD_FIELDS, SCOPE_RECORD struct format, SCOPE_RECORD_SIZE)
# and again in `ray_tpu_torch/csrc/scope_core.h` (kScope* kind constants, packed
# struct ScopeWireRec, kScopeRecordSize). Drift here corrupts every
# decoded span/counter silently (records still parse — into garbage),
# so re-derive both sides and fail on any mismatch: kind name/value,
# field name/width/order, record size.
# ==========================================================================

def _camel_to_upper_snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).upper()


def _scope_py_name(c_kind: str) -> str:
    """kScopeRpcSend -> KIND_RPC_SEND; kScopeKindCount -> KIND_COUNT
    (the snake form already starts with KIND_)."""
    snake = _camel_to_upper_snake(c_kind)
    return snake if snake.startswith("KIND_") else "KIND_" + snake


class ScopePySchema:
    def __init__(self) -> None:
        self.kinds: Dict[str, int] = {}              # KIND_RPC_SEND -> 1
        self.record_fields: List[Tuple[str, int]] = []
        self.struct_widths: List[int] = []           # from "<BBHIQQ"
        self.record_size: Optional[int] = None


def parse_scope_py(path: str) -> Tuple[ScopePySchema, List[str]]:
    errors: List[str] = []
    schema = ScopePySchema()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            continue
        name, val = stmt.targets[0].id, stmt.value
        if name.startswith("KIND_"):
            if isinstance(val, (ast.Dict, ast.List, ast.Set)):
                continue  # lookup tables (KIND_NAMES), not kind values
            v = _const_int(val)
            if v is None:
                errors.append(f"cannot evaluate {name}")
            else:
                schema.kinds[name] = v
        elif name == "SCOPE_RECORD_FIELDS":
            if not isinstance(val, ast.Tuple):
                errors.append("SCOPE_RECORD_FIELDS is not a tuple")
                continue
            for el in val.elts:
                if (isinstance(el, ast.Tuple) and len(el.elts) == 2
                        and isinstance(el.elts[0], ast.Constant)):
                    w = _const_int(el.elts[1])
                    if w is None:
                        errors.append("SCOPE_RECORD_FIELDS: bad width")
                        continue
                    schema.record_fields.append((el.elts[0].value, w))
                else:
                    errors.append("SCOPE_RECORD_FIELDS: bad entry shape")
        elif name == "SCOPE_RECORD":
            if (isinstance(val, ast.Call) and val.args
                    and isinstance(val.args[0], ast.Constant)):
                fmt = val.args[0].value
                for ch in str(fmt).lstrip("<>=!@"):
                    w = _STRUCT_CHAR_WIDTHS.get(ch)
                    if w is None:
                        errors.append(
                            f"SCOPE_RECORD: unknown format char {ch!r}")
                    else:
                        schema.struct_widths.append(w)
            else:
                errors.append("SCOPE_RECORD is not struct.Struct(<literal>)")
        elif name == "SCOPE_RECORD_SIZE":
            schema.record_size = _const_int(val)
            if schema.record_size is None:
                errors.append("cannot evaluate SCOPE_RECORD_SIZE")
    if not schema.kinds:
        errors.append("no KIND_* constants found")
    if not schema.record_fields:
        errors.append("SCOPE_RECORD_FIELDS not found")
    if not schema.struct_widths:
        errors.append("SCOPE_RECORD struct format not found")
    return schema, errors


class ScopeCSchema:
    def __init__(self) -> None:
        self.kinds: Dict[str, int] = {}              # RpcSend -> 1
        self.record_fields: List[Tuple[str, int]] = []
        self.record_size: Optional[int] = None


def parse_scope_c(path: str) -> Tuple[ScopeCSchema, List[str]]:
    errors: List[str] = []
    schema = ScopeCSchema()
    with open(path, encoding="utf-8") as f:
        text = f.read()

    for m in re.finditer(r"kScope([A-Za-z0-9_]+)\s*=\s*(\d+)", text):
        if m.group(1) in ("RecordSize", "HistBuckets", "HistShift"):
            continue  # layout constants, not kinds
        schema.kinds[m.group(1)] = int(m.group(2))
    if not schema.kinds:
        errors.append("no kScope* kind constants found")

    m = re.search(r"constexpr\s+int\s+kScopeRecordSize\s*=\s*(\d+)\s*;",
                  text)
    if m:
        schema.record_size = int(m.group(1))
    else:
        errors.append("kScopeRecordSize constexpr not found")

    m = re.search(r"struct\s+ScopeWireRec\s*\{(.*?)\};", text, re.S)
    if not m:
        errors.append("struct ScopeWireRec not found")
    else:
        for fm in re.finditer(
                r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s+([A-Za-z_][A-Za-z0-9_]*)"
                r"\s*;", m.group(1), re.M):
            ctype, fname = fm.group(1), fm.group(2)
            width = _C_TYPE_WIDTHS.get(ctype)
            if width is None:
                errors.append(f"struct ScopeWireRec: unknown type {ctype}")
                continue
            schema.record_fields.append((fname, width))
        if not schema.record_fields:
            errors.append("struct ScopeWireRec has no parsable fields")
    return schema, errors


def run_scope(py_path: str, cc_path: str, py_rel: str, cc_rel: str
              ) -> List[Finding]:
    findings: List[Finding] = []

    def err(path: str, msg: str) -> None:
        findings.append(Finding(path, 1, RULE, "error", msg))

    py, py_errors = parse_scope_py(py_path)
    cc, cc_errors = parse_scope_c(cc_path)
    for e in py_errors:
        err(py_rel, e)
    for e in cc_errors:
        err(cc_rel, e)
    if py_errors or cc_errors:
        return findings

    # 1. Kind tables: same names (under the mechanical rename), same
    #    values.
    cc_kinds = {_scope_py_name(k): v for k, v in cc.kinds.items()}
    for name in sorted(set(py.kinds) | set(cc_kinds)):
        if name not in py.kinds:
            err(py_rel, f"scope kind {name!r} exists in C (kScope*) but "
                        f"has no KIND_* constant in graftscope.py")
        elif name not in cc_kinds:
            err(cc_rel, f"scope kind {name!r} exists in Python (KIND_*) "
                        f"but has no kScope* constant")
        elif py.kinds[name] != cc_kinds[name]:
            err(py_rel, f"scope kind {name!r} drift: Python "
                        f"{py.kinds[name]} vs C {cc_kinds[name]}")

    # 2. Record layout: field-by-field name/width/order.
    if len(py.record_fields) != len(cc.record_fields):
        err(py_rel, f"scope record drift: Python declares "
                    f"{len(py.record_fields)} fields, C struct has "
                    f"{len(cc.record_fields)}")
    for (pn, pw), (cn, cw) in zip(py.record_fields, cc.record_fields):
        if pn != cn:
            err(py_rel, f"scope record field order drift: Python has "
                        f"{pn!r} where C has {cn!r}")
        elif pw != cw:
            err(py_rel, f"scope record field {pn!r} width drift: Python "
                        f"{pw} vs C {cw}")

    # 3. Struct format chars vs the declared field widths.
    declared = [w for _, w in py.record_fields]
    if py.struct_widths != declared:
        err(py_rel, f"SCOPE_RECORD format widths {py.struct_widths} != "
                    f"SCOPE_RECORD_FIELDS widths {declared}")

    # 4. Record size: both constants and both layouts must agree.
    psum = sum(w for _, w in py.record_fields)
    csum = sum(w for _, w in cc.record_fields)
    if py.record_size is not None and psum != py.record_size:
        err(py_rel, f"SCOPE_RECORD_FIELDS pack to {psum} bytes but "
                    f"SCOPE_RECORD_SIZE={py.record_size}")
    if cc.record_size is not None and csum != cc.record_size:
        err(cc_rel, f"struct ScopeWireRec packs to {csum} bytes but "
                    f"kScopeRecordSize={cc.record_size}")
    if py.record_size is not None and cc.record_size is not None \
            and py.record_size != cc.record_size:
        err(py_rel, f"scope record size drift: SCOPE_RECORD_SIZE="
                    f"{py.record_size} vs kScopeRecordSize="
                    f"{cc.record_size}")
    return findings


# ==========================================================================
# Pass 3f — graftpulse telemetry record drift.
#
# The 96-byte pulse header is hand-duplicated: the decoder layout lives
# in `ray_tpu_torch/core/_native/graftpulse.py` (PULSE_RECORD_FIELDS,
# PULSE_RECORD struct format, PULSE_RECORD_SIZE, PULSE_MAGIC,
# PULSE_VERSION, PULSE_HIST_BUCKETS/SHIFT) and again in
# `ray_tpu_torch/csrc/scope_core.h` (packed struct PulseWireRec, kPulseRecordSize,
# kPulseMagic, kPulseVersion, kScopeHistBuckets/Shift). A one-sided edit
# skews every controller aggregate — pulses still decode, into garbage
# occupancy numbers and shifted histogram buckets — so re-derive both
# sides and fail on any mismatch: field name/width/order, record size,
# magic, version, and the histogram geometry the percentile math
# depends on.
# ==========================================================================

class PulsePySchema:
    def __init__(self) -> None:
        self.record_fields: List[Tuple[str, int]] = []
        self.struct_widths: List[int] = []           # from "<IHHQ..."
        self.record_size: Optional[int] = None
        self.magic: Optional[int] = None
        self.version: Optional[int] = None
        self.hist_buckets: Optional[int] = None
        self.hist_shift: Optional[int] = None
        self.version_sizes: Dict[int, int] = {}      # PULSE_VERSION_SIZES


def parse_pulse_py(path: str) -> Tuple[PulsePySchema, List[str]]:
    errors: List[str] = []
    schema = PulsePySchema()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    scalars = {"PULSE_RECORD_SIZE": "record_size", "PULSE_MAGIC": "magic",
               "PULSE_VERSION": "version",
               "PULSE_HIST_BUCKETS": "hist_buckets",
               "PULSE_HIST_SHIFT": "hist_shift"}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            continue
        name, val = stmt.targets[0].id, stmt.value
        if name in scalars:
            v = _const_int(val)
            if v is None:
                errors.append(f"cannot evaluate {name}")
            else:
                setattr(schema, scalars[name], v)
        elif name == "PULSE_RECORD_FIELDS":
            if not isinstance(val, ast.Tuple):
                errors.append("PULSE_RECORD_FIELDS is not a tuple")
                continue
            for el in val.elts:
                if (isinstance(el, ast.Tuple) and len(el.elts) == 2
                        and isinstance(el.elts[0], ast.Constant)):
                    w = _const_int(el.elts[1])
                    if w is None:
                        errors.append("PULSE_RECORD_FIELDS: bad width")
                        continue
                    schema.record_fields.append((el.elts[0].value, w))
                else:
                    errors.append("PULSE_RECORD_FIELDS: bad entry shape")
        elif name == "PULSE_RECORD":
            if (isinstance(val, ast.Call) and val.args
                    and isinstance(val.args[0], ast.Constant)):
                fmt = val.args[0].value
                for ch in str(fmt).lstrip("<>=!@"):
                    w = _STRUCT_CHAR_WIDTHS.get(ch)
                    if w is None:
                        errors.append(
                            f"PULSE_RECORD: unknown format char {ch!r}")
                    else:
                        schema.struct_widths.append(w)
            else:
                errors.append("PULSE_RECORD is not struct.Struct(<literal>)")
        elif name == "PULSE_VERSION_SIZES":
            if not isinstance(val, ast.Dict):
                errors.append("PULSE_VERSION_SIZES is not a dict literal")
                continue
            for k, v in zip(val.keys, val.values):
                kv, vv = _const_int(k), _const_int(v)
                if kv is None or vv is None:
                    errors.append("PULSE_VERSION_SIZES: bad entry")
                else:
                    schema.version_sizes[kv] = vv
    if not schema.record_fields:
        errors.append("PULSE_RECORD_FIELDS not found")
    if not schema.struct_widths:
        errors.append("PULSE_RECORD struct format not found")
    return schema, errors


class PulseCSchema:
    def __init__(self) -> None:
        self.record_fields: List[Tuple[str, int]] = []
        self.record_size: Optional[int] = None
        self.magic: Optional[int] = None
        self.version: Optional[int] = None
        self.hist_buckets: Optional[int] = None
        self.hist_shift: Optional[int] = None
        self.version_sizes: Dict[int, int] = {}      # kPulseVersionSizes


def parse_pulse_c(path: str) -> Tuple[PulseCSchema, List[str]]:
    errors: List[str] = []
    schema = PulseCSchema()
    with open(path, encoding="utf-8") as f:
        text = f.read()

    scalars = {"kPulseRecordSize": "record_size", "kPulseMagic": "magic",
               "kPulseVersion": "version",
               "kScopeHistBuckets": "hist_buckets",
               "kScopeHistShift": "hist_shift"}
    for cname, attr in scalars.items():
        m = re.search(r"constexpr\s+[a-z0-9_]+\s+" + cname
                      + r"\s*=\s*(0[xX][0-9a-fA-F]+|\d+)\s*;", text)
        if m:
            setattr(schema, attr, int(m.group(1), 0))
        else:
            errors.append(f"{cname} constexpr not found")

    m = re.search(r"kPulseVersionSizes\[\]\[2\]\s*=\s*\{(.*?)\};",
                  text, re.S)
    if m:
        for rm in re.finditer(r"\{\s*(\d+)\s*,\s*(\d+)\s*\}", m.group(1)):
            schema.version_sizes[int(rm.group(1))] = int(rm.group(2))
    else:
        errors.append("kPulseVersionSizes registry not found")

    m = re.search(r"struct\s+PulseWireRec\s*\{(.*?)\};", text, re.S)
    if not m:
        errors.append("struct PulseWireRec not found")
    else:
        for fm in re.finditer(
                r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s+([A-Za-z_][A-Za-z0-9_]*)"
                r"\s*;", m.group(1), re.M):
            ctype, fname = fm.group(1), fm.group(2)
            width = _C_TYPE_WIDTHS.get(ctype)
            if width is None:
                errors.append(f"struct PulseWireRec: unknown type {ctype}")
                continue
            schema.record_fields.append((fname, width))
        if not schema.record_fields:
            errors.append("struct PulseWireRec has no parsable fields")
    return schema, errors


def run_pulse(py_path: str, cc_path: str, py_rel: str, cc_rel: str
              ) -> List[Finding]:
    findings: List[Finding] = []

    def err(path: str, msg: str) -> None:
        findings.append(Finding(path, 1, RULE, "error", msg))

    py, py_errors = parse_pulse_py(py_path)
    cc, cc_errors = parse_pulse_c(cc_path)
    for e in py_errors:
        err(py_rel, e)
    for e in cc_errors:
        err(cc_rel, e)
    if py_errors or cc_errors:
        return findings

    # 1. Record layout: field-by-field name/width/order.
    if len(py.record_fields) != len(cc.record_fields):
        err(py_rel, f"pulse record drift: Python declares "
                    f"{len(py.record_fields)} fields, C struct has "
                    f"{len(cc.record_fields)}")
    for (pn, pw), (cn, cw) in zip(py.record_fields, cc.record_fields):
        if pn != cn:
            err(py_rel, f"pulse record field order drift: Python has "
                        f"{pn!r} where C has {cn!r}")
        elif pw != cw:
            err(py_rel, f"pulse record field {pn!r} width drift: Python "
                        f"{pw} vs C {cw}")

    # 2. Struct format chars vs the declared field widths.
    declared = [w for _, w in py.record_fields]
    if py.struct_widths != declared:
        err(py_rel, f"PULSE_RECORD format widths {py.struct_widths} != "
                    f"PULSE_RECORD_FIELDS widths {declared}")

    # 3. Record size: both constants and both layouts must agree.
    psum = sum(w for _, w in py.record_fields)
    csum = sum(w for _, w in cc.record_fields)
    if py.record_size is not None and psum != py.record_size:
        err(py_rel, f"PULSE_RECORD_FIELDS pack to {psum} bytes but "
                    f"PULSE_RECORD_SIZE={py.record_size}")
    if cc.record_size is not None and csum != cc.record_size:
        err(cc_rel, f"struct PulseWireRec packs to {csum} bytes but "
                    f"kPulseRecordSize={cc.record_size}")
    if py.record_size is not None and cc.record_size is not None \
            and py.record_size != cc.record_size:
        err(py_rel, f"pulse record size drift: PULSE_RECORD_SIZE="
                    f"{py.record_size} vs kPulseRecordSize="
                    f"{cc.record_size}")

    # 4. Magic / version / histogram geometry.
    for label, pv, cv, cname in (
            ("magic", py.magic, cc.magic, "kPulseMagic"),
            ("version", py.version, cc.version, "kPulseVersion"),
            ("histogram bucket count", py.hist_buckets, cc.hist_buckets,
             "kScopeHistBuckets"),
            ("histogram shift", py.hist_shift, cc.hist_shift,
             "kScopeHistShift")):
        if pv is not None and cv is not None and pv != cv:
            err(py_rel, f"pulse {label} drift: Python {pv} vs "
                        f"C {cname}={cv}")

    # 5. Version -> size registries: identical on both sides, and the
    #    CURRENT version's registered size must equal the record size —
    #    widening the header without bumping the version (or without
    #    appending a registry row) is exactly the silent drift this
    #    registry exists to catch.
    if py.version_sizes != cc.version_sizes:
        err(py_rel, f"pulse version registry drift: Python "
                    f"PULSE_VERSION_SIZES={py.version_sizes} vs C "
                    f"kPulseVersionSizes={cc.version_sizes}")
    if py.version is not None and py.version_sizes:
        reg = py.version_sizes.get(py.version)
        if reg is None:
            err(py_rel, f"PULSE_VERSION={py.version} has no entry in "
                        f"PULSE_VERSION_SIZES — append one per wire "
                        f"revision")
        elif py.record_size is not None and reg != py.record_size:
            err(py_rel, f"pulse header widened without a version bump: "
                        f"PULSE_RECORD_SIZE={py.record_size} but "
                        f"PULSE_VERSION_SIZES[{py.version}]={reg}")
    if cc.version is not None and cc.version_sizes:
        reg = cc.version_sizes.get(cc.version)
        if reg is None:
            err(cc_rel, f"kPulseVersion={cc.version} has no entry in "
                        f"kPulseVersionSizes — append one per wire "
                        f"revision")
        elif cc.record_size is not None and reg != cc.record_size:
            err(cc_rel, f"pulse header widened without a version bump: "
                        f"kPulseRecordSize={cc.record_size} but "
                        f"kPulseVersionSizes[{cc.version}]={reg}")
    return findings


# ==========================================================================
# Pass 3g — graftprof sample-record drift.
#
# The 24-byte profiler sample record is hand-duplicated: kind numbers,
# field layout and the ring geometry live in
# `ray_tpu_torch/core/_native/graftprof.py` (PROF_TICK/.../PROF_KIND_COUNT,
# PROF_RECORD_FIELDS, PROF_RECORD struct format, PROF_RECORD_SIZE,
# PROF_DEFAULT_HZ/MAX_THREADS/RING_CAP/NAME_CAP) and again in
# `ray_tpu_torch/csrc/prof_core.h` (kProf* kind constants, packed struct ProfWireRec,
# kProfRecordSize, the kProf* geometry constexprs). Drift corrupts
# every decoded sample silently (records still parse — into garbage
# CPU/GIL attribution) or desyncs the drain stride, so re-derive both
# sides and fail on any mismatch: kind name/value, field
# name/width/order, record size, geometry scalar.
# ==========================================================================

# C geometry constant -> Python name; everything else matching kProf*
# is a record kind.
_PROF_GEOMETRY = {
    "DefaultHz": "PROF_DEFAULT_HZ",
    "MaxThreads": "PROF_MAX_THREADS",
    "RingCap": "PROF_RING_CAP",
    "NameCap": "PROF_NAME_CAP",
}


def _prof_py_name(c_kind: str) -> str:
    """kProfThreadCpu -> PROF_THREAD_CPU; kProfKindCount ->
    PROF_KIND_COUNT."""
    return "PROF_" + _camel_to_upper_snake(c_kind)


class ProfPySchema:
    def __init__(self) -> None:
        self.kinds: Dict[str, int] = {}          # PROF_THREAD_CPU -> 2
        self.record_fields: List[Tuple[str, int]] = []
        self.struct_widths: List[int] = []       # from "<BBHIQQ"
        self.record_size: Optional[int] = None
        self.geometry: Dict[str, int] = {}       # PROF_RING_CAP -> 4096


def parse_prof_py(path: str) -> Tuple[ProfPySchema, List[str]]:
    errors: List[str] = []
    schema = ProfPySchema()
    geometry_names = set(_PROF_GEOMETRY.values())
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            continue
        name, val = stmt.targets[0].id, stmt.value
        if name == "PROF_RECORD_FIELDS":
            if not isinstance(val, ast.Tuple):
                errors.append("PROF_RECORD_FIELDS is not a tuple")
                continue
            for el in val.elts:
                if (isinstance(el, ast.Tuple) and len(el.elts) == 2
                        and isinstance(el.elts[0], ast.Constant)):
                    w = _const_int(el.elts[1])
                    if w is None:
                        errors.append("PROF_RECORD_FIELDS: bad width")
                        continue
                    schema.record_fields.append((el.elts[0].value, w))
                else:
                    errors.append("PROF_RECORD_FIELDS: bad entry shape")
        elif name == "PROF_RECORD":
            if (isinstance(val, ast.Call) and val.args
                    and isinstance(val.args[0], ast.Constant)):
                fmt = val.args[0].value
                for ch in str(fmt).lstrip("<>=!@"):
                    w = _STRUCT_CHAR_WIDTHS.get(ch)
                    if w is None:
                        errors.append(
                            f"PROF_RECORD: unknown format char {ch!r}")
                    else:
                        schema.struct_widths.append(w)
            else:
                errors.append("PROF_RECORD is not struct.Struct(<literal>)")
        elif name == "PROF_RECORD_SIZE":
            schema.record_size = _const_int(val)
            if schema.record_size is None:
                errors.append("cannot evaluate PROF_RECORD_SIZE")
        elif name in geometry_names:
            v = _const_int(val)
            if v is None:
                errors.append(f"cannot evaluate {name}")
            else:
                schema.geometry[name] = v
        elif name.startswith("PROF_"):
            if isinstance(val, (ast.Dict, ast.List, ast.Set)):
                continue  # lookup tables (PROF_KIND_NAMES), not kinds
            v = _const_int(val)
            if v is None:
                errors.append(f"cannot evaluate {name}")
            else:
                schema.kinds[name] = v
    if not schema.kinds:
        errors.append("no PROF_* kind constants found")
    if not schema.record_fields:
        errors.append("PROF_RECORD_FIELDS not found")
    if not schema.struct_widths:
        errors.append("PROF_RECORD struct format not found")
    return schema, errors


class ProfCSchema:
    def __init__(self) -> None:
        self.kinds: Dict[str, int] = {}          # ThreadCpu -> 2
        self.record_fields: List[Tuple[str, int]] = []
        self.record_size: Optional[int] = None
        self.geometry: Dict[str, int] = {}       # RingCap -> 4096


def parse_prof_c(path: str) -> Tuple[ProfCSchema, List[str]]:
    errors: List[str] = []
    schema = ProfCSchema()
    with open(path, encoding="utf-8") as f:
        text = f.read()

    for m in re.finditer(r"kProf([A-Za-z0-9_]+)\s*=\s*(\d+)", text):
        name, value = m.group(1), int(m.group(2))
        if name == "RecordSize":
            continue  # checked via the constexpr regex below
        if name in _PROF_GEOMETRY:
            schema.geometry[name] = value
        else:
            schema.kinds[name] = value
    if not schema.kinds:
        errors.append("no kProf* kind constants found")
    for cname in _PROF_GEOMETRY:
        if cname not in schema.geometry:
            errors.append(f"kProf{cname} constexpr not found")

    m = re.search(r"constexpr\s+int\s+kProfRecordSize\s*=\s*(\d+)\s*;",
                  text)
    if m:
        schema.record_size = int(m.group(1))
    else:
        errors.append("kProfRecordSize constexpr not found")

    m = re.search(r"struct\s+ProfWireRec\s*\{(.*?)\};", text, re.S)
    if not m:
        errors.append("struct ProfWireRec not found")
    else:
        for fm in re.finditer(
                r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s+([A-Za-z_][A-Za-z0-9_]*)"
                r"\s*;", m.group(1), re.M):
            ctype, fname = fm.group(1), fm.group(2)
            width = _C_TYPE_WIDTHS.get(ctype)
            if width is None:
                errors.append(f"struct ProfWireRec: unknown type {ctype}")
                continue
            schema.record_fields.append((fname, width))
        if not schema.record_fields:
            errors.append("struct ProfWireRec has no parsable fields")
    return schema, errors


def run_prof(py_path: str, cc_path: str, py_rel: str, cc_rel: str
             ) -> List[Finding]:
    findings: List[Finding] = []

    def err(path: str, msg: str) -> None:
        findings.append(Finding(path, 1, RULE, "error", msg))

    py, py_errors = parse_prof_py(py_path)
    cc, cc_errors = parse_prof_c(cc_path)
    for e in py_errors:
        err(py_rel, e)
    for e in cc_errors:
        err(cc_rel, e)
    if py_errors or cc_errors:
        return findings

    # 1. Kind tables: same names (under the mechanical rename), same
    #    values.
    cc_kinds = {_prof_py_name(k): v for k, v in cc.kinds.items()}
    for name in sorted(set(py.kinds) | set(cc_kinds)):
        if name not in py.kinds:
            err(py_rel, f"prof kind {name!r} exists in C (kProf*) but "
                        f"has no PROF_* constant in graftprof.py")
        elif name not in cc_kinds:
            err(cc_rel, f"prof kind {name!r} exists in Python (PROF_*) "
                        f"but has no kProf* constant")
        elif py.kinds[name] != cc_kinds[name]:
            err(py_rel, f"prof kind {name!r} drift: Python "
                        f"{py.kinds[name]} vs C {cc_kinds[name]}")

    # 2. Record layout: field-by-field name/width/order.
    if len(py.record_fields) != len(cc.record_fields):
        err(py_rel, f"prof record drift: Python declares "
                    f"{len(py.record_fields)} fields, C struct has "
                    f"{len(cc.record_fields)}")
    for (pn, pw), (cn, cw) in zip(py.record_fields, cc.record_fields):
        if pn != cn:
            err(py_rel, f"prof record field order drift: Python has "
                        f"{pn!r} where C has {cn!r}")
        elif pw != cw:
            err(py_rel, f"prof record field {pn!r} width drift: Python "
                        f"{pw} vs C {cw}")

    # 3. Struct format chars vs the declared field widths.
    declared = [w for _, w in py.record_fields]
    if py.struct_widths != declared:
        err(py_rel, f"PROF_RECORD format widths {py.struct_widths} != "
                    f"PROF_RECORD_FIELDS widths {declared}")

    # 4. Record size: both constants and both layouts must agree.
    psum = sum(w for _, w in py.record_fields)
    csum = sum(w for _, w in cc.record_fields)
    if py.record_size is not None and psum != py.record_size:
        err(py_rel, f"PROF_RECORD_FIELDS pack to {psum} bytes but "
                    f"PROF_RECORD_SIZE={py.record_size}")
    if cc.record_size is not None and csum != cc.record_size:
        err(cc_rel, f"struct ProfWireRec packs to {csum} bytes but "
                    f"kProfRecordSize={cc.record_size}")
    if py.record_size is not None and cc.record_size is not None \
            and py.record_size != cc.record_size:
        err(py_rel, f"prof record size drift: PROF_RECORD_SIZE="
                    f"{py.record_size} vs kProfRecordSize="
                    f"{cc.record_size}")

    # 5. Ring/sampler geometry: the drain stride, the thread table and
    #    the name buffer are sized from these on both sides.
    for cname, pyname in sorted(_PROF_GEOMETRY.items()):
        pv, cv = py.geometry.get(pyname), cc.geometry.get(cname)
        if pv is None:
            err(py_rel, f"{pyname} not found in graftprof.py")
        elif cv is not None and pv != cv:
            err(py_rel, f"prof geometry drift: {pyname}={pv} vs "
                        f"C kProf{cname}={cv}")
    return findings


# ==========================================================================
# Pass 3h — graftlog log-record drift.
#
# The 256-byte crash-persistent log record is hand-duplicated: source
# kinds, field layout and the ring geometry live in
# `ray_tpu_torch/core/_native/graftlog.py` (LOG_SRC_*, LOG_RECORD_FIELDS,
# LOG_RECORD struct format, LOG_RECORD_SIZE, LOG_RING_SLOTS /
# LOG_HEADER_SIZE / LOG_TASK_CAP / LOG_ACTOR_CAP / LOG_MSG_CAP /
# LOG_MAGIC / LOG_RING_VERSION) and again in `ray_tpu_torch/csrc/log_core.h` (kLogSrc*
# constants, packed struct LogWireRec with char[] payload fields,
# kLogRecordSize, the kLog* geometry constexprs). This record crosses a
# PROCESS boundary through a file: the C emit path writes it, the
# Python agent tails it live and salvages it after the writer is
# SIGKILLed — drift turns every postmortem tail into garbage (records
# still parse: wrong task attribution, truncated or shifted messages)
# or desyncs the slot stride so salvage reads straddle records.
# Re-derive both sides and fail on any mismatch: source name/value,
# field name/width/order, record size, geometry scalar (incl. the file
# magic and version, which gate salvage of rings from older runs).
# ==========================================================================

# C geometry constant -> Python name; kLogSrc* are record sources.
# Magic is hex in C — parsed with int(x, 0) below.
_LOG_GEOMETRY = {
    "RingSlots": "LOG_RING_SLOTS",
    "HeaderSize": "LOG_HEADER_SIZE",
    "TaskCap": "LOG_TASK_CAP",
    "ActorCap": "LOG_ACTOR_CAP",
    "MsgCap": "LOG_MSG_CAP",
    "Magic": "LOG_MAGIC",
    "RingVersion": "LOG_RING_VERSION",
}


def _log_py_name(c_kind: str) -> str:
    """kLogSrcStdout -> LOG_SRC_STDOUT; kLogSrcCount -> LOG_SRC_COUNT."""
    return "LOG_" + _camel_to_upper_snake(c_kind)


def _log_struct_widths(fmt: str, errors: List[str]) -> List[int]:
    """Per-FIELD widths of a struct format that may carry "Ns" tokens
    (fixed char arrays — one field of width N, unlike "NB" which is N
    one-byte fields). _STRUCT_CHAR_WIDTHS deliberately has no "s"."""
    widths: List[int] = []
    body = fmt.lstrip("<>=!@")
    pos = 0
    for m in re.finditer(r"(\d*)([a-zA-Z])", body):
        if m.start() != pos:
            errors.append(f"LOG_RECORD: unparsed format text "
                          f"{body[pos:m.start()]!r}")
        pos = m.end()
        count, ch = m.group(1), m.group(2)
        if ch == "s":
            widths.append(int(count) if count else 1)
            continue
        w = _STRUCT_CHAR_WIDTHS.get(ch)
        if w is None:
            errors.append(f"LOG_RECORD: unknown format char {ch!r}")
            continue
        widths.extend([w] * (int(count) if count else 1))
    if pos != len(body):
        errors.append(f"LOG_RECORD: unparsed format tail "
                      f"{body[pos:]!r}")
    return widths


class LogPySchema:
    def __init__(self) -> None:
        self.kinds: Dict[str, int] = {}          # LOG_SRC_STDOUT -> 1
        self.record_fields: List[Tuple[str, int]] = []
        self.struct_widths: List[int] = []       # from "<BBHIQ32s..."
        self.record_size: Optional[int] = None
        self.geometry: Dict[str, int] = {}       # LOG_RING_SLOTS -> 4096


def parse_log_py(path: str) -> Tuple[LogPySchema, List[str]]:
    errors: List[str] = []
    schema = LogPySchema()
    geometry_names = set(_LOG_GEOMETRY.values())
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            continue
        name, val = stmt.targets[0].id, stmt.value
        if name == "LOG_RECORD_FIELDS":
            if not isinstance(val, ast.Tuple):
                errors.append("LOG_RECORD_FIELDS is not a tuple")
                continue
            for el in val.elts:
                if (isinstance(el, ast.Tuple) and len(el.elts) == 2
                        and isinstance(el.elts[0], ast.Constant)):
                    w = _const_int(el.elts[1])
                    if w is None:
                        errors.append("LOG_RECORD_FIELDS: bad width")
                        continue
                    schema.record_fields.append((el.elts[0].value, w))
                else:
                    errors.append("LOG_RECORD_FIELDS: bad entry shape")
        elif name == "LOG_RECORD":
            if (isinstance(val, ast.Call) and val.args
                    and isinstance(val.args[0], ast.Constant)):
                schema.struct_widths = _log_struct_widths(
                    str(val.args[0].value), errors)
            else:
                errors.append("LOG_RECORD is not struct.Struct(<literal>)")
        elif name == "LOG_RECORD_SIZE":
            schema.record_size = _const_int(val)
            if schema.record_size is None:
                errors.append("cannot evaluate LOG_RECORD_SIZE")
        elif name in geometry_names:
            v = _const_int(val)
            if v is None:
                errors.append(f"cannot evaluate {name}")
            else:
                schema.geometry[name] = v
        elif name.startswith("LOG_SRC_"):
            if isinstance(val, (ast.Dict, ast.List, ast.Set)):
                continue  # lookup tables (LOG_SRC_NAMES), not sources
            v = _const_int(val)
            if v is None:
                errors.append(f"cannot evaluate {name}")
            else:
                schema.kinds[name] = v
        # Other LOG_* names (LOG_HEADER, the header struct) are emit/
        # salvage implementation detail, not part of the record contract.
    if not schema.kinds:
        errors.append("no LOG_SRC_* source constants found")
    if not schema.record_fields:
        errors.append("LOG_RECORD_FIELDS not found")
    if not schema.struct_widths:
        errors.append("LOG_RECORD struct format not found")
    return schema, errors


class LogCSchema:
    def __init__(self) -> None:
        self.kinds: Dict[str, int] = {}          # SrcStdout -> 1
        self.record_fields: List[Tuple[str, int]] = []
        self.record_size: Optional[int] = None
        self.geometry: Dict[str, int] = {}       # RingSlots -> 4096


def parse_log_c(path: str) -> Tuple[LogCSchema, List[str]]:
    errors: List[str] = []
    schema = LogCSchema()
    with open(path, encoding="utf-8") as f:
        text = f.read()

    # kLogMagic is hex; int(x, 0) accepts both bases.
    for m in re.finditer(
            r"kLog([A-Za-z0-9_]+)\s*=\s*(0[xX][0-9a-fA-F]+|\d+)", text):
        name, value = m.group(1), int(m.group(2), 0)
        if name == "RecordSize":
            continue  # checked via the constexpr regex below
        if name in _LOG_GEOMETRY:
            schema.geometry[name] = value
        else:
            schema.kinds[name] = value
    if not schema.kinds:
        errors.append("no kLogSrc* source constants found")
    for cname in _LOG_GEOMETRY:
        if cname not in schema.geometry:
            errors.append(f"kLog{cname} constexpr not found")

    m = re.search(r"constexpr\s+int\s+kLogRecordSize\s*=\s*(\d+)\s*;",
                  text)
    if m:
        schema.record_size = int(m.group(1))
    else:
        errors.append("kLogRecordSize constexpr not found")

    m = re.search(r"struct\s+LogWireRec\s*\{(.*?)\};", text, re.S)
    if not m:
        errors.append("struct LogWireRec not found")
    else:
        # Payload fields are char arrays (`char task[32]` or sized by a
        # kLog* cap constant) — the prof field regex can't see those.
        for fm in re.finditer(
                r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s+([A-Za-z_][A-Za-z0-9_]*)"
                r"\s*(?:\[\s*([A-Za-z0-9_]+)\s*\])?\s*;", m.group(1), re.M):
            ctype, fname, dim = fm.group(1), fm.group(2), fm.group(3)
            width = _C_TYPE_WIDTHS.get(ctype)
            if width is None:
                errors.append(f"struct LogWireRec: unknown type {ctype}")
                continue
            if dim is not None:
                if dim.isdigit():
                    n = int(dim)
                elif dim.startswith("kLog") \
                        and dim[4:] in schema.geometry:
                    n = schema.geometry[dim[4:]]
                else:
                    errors.append(f"struct LogWireRec: cannot size "
                                  f"{fname}[{dim}]")
                    continue
                width *= n
            schema.record_fields.append((fname, width))
        if not schema.record_fields:
            errors.append("struct LogWireRec has no parsable fields")
    return schema, errors


def run_log(py_path: str, cc_path: str, py_rel: str, cc_rel: str
            ) -> List[Finding]:
    findings: List[Finding] = []

    def err(path: str, msg: str) -> None:
        findings.append(Finding(path, 1, RULE, "error", msg))

    py, py_errors = parse_log_py(py_path)
    cc, cc_errors = parse_log_c(cc_path)
    for e in py_errors:
        err(py_rel, e)
    for e in cc_errors:
        err(cc_rel, e)
    if py_errors or cc_errors:
        return findings

    # 1. Source tables: same names (under the mechanical rename), same
    #    values.
    cc_kinds = {_log_py_name(k): v for k, v in cc.kinds.items()}
    for name in sorted(set(py.kinds) | set(cc_kinds)):
        if name not in py.kinds:
            err(py_rel, f"log source {name!r} exists in C (kLogSrc*) "
                        f"but has no LOG_SRC_* constant in graftlog.py")
        elif name not in cc_kinds:
            err(cc_rel, f"log source {name!r} exists in Python "
                        f"(LOG_SRC_*) but has no kLogSrc* constant")
        elif py.kinds[name] != cc_kinds[name]:
            err(py_rel, f"log source {name!r} drift: Python "
                        f"{py.kinds[name]} vs C {cc_kinds[name]}")

    # 2. Record layout: field-by-field name/width/order (char-array
    #    widths already folded in on the C side).
    if len(py.record_fields) != len(cc.record_fields):
        err(py_rel, f"log record drift: Python declares "
                    f"{len(py.record_fields)} fields, C struct has "
                    f"{len(cc.record_fields)}")
    for (pn, pw), (cn, cw) in zip(py.record_fields, cc.record_fields):
        if pn != cn:
            err(py_rel, f"log record field order drift: Python has "
                        f"{pn!r} where C has {cn!r}")
        elif pw != cw:
            err(py_rel, f"log record field {pn!r} width drift: Python "
                        f"{pw} vs C {cw}")

    # 3. Struct format chars (incl. "Ns" payload tokens) vs the
    #    declared field widths.
    declared = [w for _, w in py.record_fields]
    if py.struct_widths != declared:
        err(py_rel, f"LOG_RECORD format widths {py.struct_widths} != "
                    f"LOG_RECORD_FIELDS widths {declared}")

    # 4. Record size: both constants and both layouts must agree — the
    #    slot stride; a mismatch shears every salvage read.
    psum = sum(w for _, w in py.record_fields)
    csum = sum(w for _, w in cc.record_fields)
    if py.record_size is not None and psum != py.record_size:
        err(py_rel, f"LOG_RECORD_FIELDS pack to {psum} bytes but "
                    f"LOG_RECORD_SIZE={py.record_size}")
    if cc.record_size is not None and csum != cc.record_size:
        err(cc_rel, f"struct LogWireRec packs to {csum} bytes but "
                    f"kLogRecordSize={cc.record_size}")
    if py.record_size is not None and cc.record_size is not None \
            and py.record_size != cc.record_size:
        err(py_rel, f"log record size drift: LOG_RECORD_SIZE="
                    f"{py.record_size} vs kLogRecordSize="
                    f"{cc.record_size}")

    # 5. Ring geometry: file magic/version gate salvage of foreign
    #    rings; slots/header size the mmap and the slot indexing; the
    #    payload caps bound decode on both sides.
    for cname, pyname in sorted(_LOG_GEOMETRY.items()):
        pv, cv = py.geometry.get(pyname), cc.geometry.get(cname)
        if pv is None:
            err(py_rel, f"{pyname} not found in graftlog.py")
        elif cv is not None and pv != cv:
            err(py_rel, f"log geometry drift: {pyname}={pv} vs "
                        f"C kLog{cname}={cv}")
    return findings
