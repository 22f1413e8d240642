"""graftcopy: Python seam over the native copy engine (csrc/copy_core.cc).

The object-store put plane lands pickle-5 segments in tmpfs object
files. Python's os.pwritev covers the single-thread case (one syscall,
GIL dropped for the duration); this seam adds what Python cannot do:

  * ``write_scatter`` — hand the segment list to the native engine,
    which fans fixed-size chunks over a worker pool sized to host cores
    (sequential on 1-core hosts). The ctypes call releases the GIL, so a
    GiB-scale put saturates memory bandwidth without stalling the
    process.
  * ``linkat`` — the O_TMPFILE ingredient: atomically link an anonymous
    written-out fd into the store dir (CPython's os.link cannot express
    AT_SYMLINK_FOLLOW on a /proc/self/fd source).

Everything degrades cleanly: ``available()`` is False when the flag is
off or the native library cannot load, and callers fall back to the
pwritev + OP_INGEST path (the acceptance contract for
RAY_TPU_TORCH_GRAFTCOPY=0).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.config import GlobalConfig

logger = get_logger("graftcopy")


class CopySeg(ctypes.Structure):
    """Mirror of the CopySeg struct in csrc/copy_core.cc (field widths
    cross-checked by the lint wire-schema ctypes pass)."""
    _fields_ = [("src", ctypes.c_void_p),
                ("len", ctypes.c_uint64),
                ("off", ctypes.c_uint64)]


_lock = threading.Lock()
_lib = None          # CDLL | False (load failed) | None (unprobed)
_engine = None       # native engine handle (per process, lazy)


def _get_lib():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                try:
                    from ray_tpu_torch.core.object_store import _get_lib as gl
                    _lib = gl()
                except Exception as e:  # missing toolchain/build failure
                    logger.debug("graftcopy native library unavailable: %r",
                                 e)
                    _lib = False
    return _lib or None


def available() -> bool:
    """True when the graftcopy plane should be used: flag on AND the
    native library loads."""
    return bool(GlobalConfig.graftcopy) and _get_lib() is not None


def engine() -> Optional[int]:
    """Process-wide copy-engine handle (lazily created; never destroyed
    — worker pools die with the process, like the reference's plasma
    client threads)."""
    global _engine
    if _engine is None:
        lib = _get_lib()
        if lib is None:
            return None
        with _lock:
            if _engine is None:
                _engine = lib.copy_engine_create(
                    int(GlobalConfig.graftcopy_threads))
    return _engine


def engine_threads() -> int:
    e = engine()
    if e is None:
        return 0
    return _get_lib().copy_engine_threads(e)


def _seg_addr(buf) -> Optional[int]:
    """Borrowed base address of a buffer-protocol object. Writable
    buffers go through from_buffer; read-only ``bytes`` use the
    c_char_p view. Anything else (read-only memoryviews) returns None
    and the caller falls back to pwritev."""
    if isinstance(buf, bytes):
        return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
    try:
        return ctypes.addressof(ctypes.c_char.from_buffer(buf))
    except (TypeError, ValueError):
        return None


def write_scatter(fd: int, segs: Sequence[Tuple[object, int]]) -> None:
    """Copy each (buffer, file_offset) segment into fd via the native
    engine. Raises OSError on write failure and ValueError when a
    segment's address cannot be resolved without a copy (caller falls
    back to os.pwritev)."""
    lib = _get_lib()
    eng = engine()
    if lib is None or eng is None:
        raise ValueError("graftcopy engine unavailable")
    live: List[object] = []   # keep buffers pinned across the C call
    arr = (CopySeg * len(segs))()
    n = 0
    for buf, off in segs:
        ln = len(buf)
        if ln == 0:
            continue
        addr = _seg_addr(buf)
        if addr is None:
            raise ValueError("read-only segment; use pwritev fallback")
        live.append(buf)
        arr[n].src = addr
        arr[n].len = ln
        arr[n].off = off
        n += 1
    if n == 0:
        return
    rc = lib.copy_write_scatter(eng, fd, ctypes.cast(arr, ctypes.c_void_p),
                                n)
    if rc != 0:
        raise OSError(-rc, "graftcopy scatter write failed")
    del live


def linkat(src_fd: int, dst: str) -> None:
    """Atomically link src_fd's (possibly anonymous O_TMPFILE) file at
    dst. Raises OSError with the underlying errno (EEXIST: dst taken)."""
    lib = _get_lib()
    if lib is None:
        raise OSError("graftcopy native library unavailable")
    rc = lib.copy_linkat(src_fd, dst.encode())
    if rc != 0:
        import os
        raise OSError(-rc, os.strerror(-rc), dst)
