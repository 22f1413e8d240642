"""graftshm: Python seam over the shared-memory object plane
(csrc/shm_core.cc + the sidecar's OP_CREATE/OP_SEAL handlers).

The put plane asks the sidecar for a store-owned slab (OP_CREATE), maps
the fd it receives over SCM_RIGHTS, and lets ``SerializedValue``
serialize **in place** through the mapping — the object's bytes are
written exactly once, into the pages the store will serve them from.
OP_SEAL publishes the object; no staging file, rename, or bulk-copy
phase exists. This module owns the two pieces Python needs for that:

  * ``SlabMapCache`` — writable MAP_SHARED mappings keyed by slab inode.
    The arena recycles slabs by exact size, so a steady-state put loop
    gets the same inode back and the cached mapping is reused without an
    mmap/munmap pair per put. Reuse is always coherent: a MAP_SHARED
    mapping of an inode sees that inode's current content, and holding
    the mapping keeps the inode alive, so the key cannot alias a new
    file.
  * DLPack export — hand a zero-copy numpy view of a sealed (read-only)
    object to ``jax.device_put``/``from_dlpack`` WITHOUT materializing
    intermediate bytes. numpy and jax refuse ``__dlpack__`` on read-only
    arrays, so the capsule is built by hand (ctypes DLManagedTensor);
    the registry pins the mapping until every consumer's deleter runs.

Everything degrades cleanly: ``available()`` is False when the flag is
off or the native library cannot load, and callers fall back to the
graftcopy put path (the acceptance contract for RAY_TPU_TORCH_GRAFTSHM=0).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.config import GlobalConfig

logger = get_logger("graftshm")

_lock = threading.Lock()
_lib = None  # CDLL | False (load failed) | None (unprobed)


def _get_lib():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                try:
                    from ray_tpu_torch.core.object_store import _get_lib as gl
                    _lib = gl()
                except Exception as e:  # missing toolchain/build failure
                    logger.debug("graftshm native library unavailable: %r", e)
                    _lib = False
    return _lib or None


def available() -> bool:
    """True when the shm put plane should be used: flag on AND the
    native library loads."""
    return bool(GlobalConfig.graftshm) and _get_lib() is not None


# ---------------------------------------------------------------------
# Slab mapping cache
# ---------------------------------------------------------------------

class SlabMapCache:
    """Writable MAP_SHARED mappings keyed by (st_ino, size).

    ``map_fd`` consumes the slab fd (closes it either way) and returns a
    live ``mmap.mmap``. A hit costs one fstat; a miss mmaps and caches.
    Entries are LRU-bounded by count so a worker that cycles many sizes
    does not hold the whole arena mapped.
    """

    def __init__(self, max_entries: int = 8):
        self._max = max_entries
        self._maps: "OrderedDict[Tuple[int, int], mmap.mmap]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def map_fd(self, fd: int, size: int) -> mmap.mmap:
        try:
            ino = os.fstat(fd).st_ino
            key = (ino, size)
            m = self._maps.get(key)
            if m is not None and not m.closed:
                self._maps.move_to_end(key)
                self.hits += 1
                return m
            m = mmap.mmap(fd, size)  # MAP_SHARED read/write by default
            self.misses += 1
            self._maps[key] = m
            while len(self._maps) > self._max:
                _, old = self._maps.popitem(last=False)
                old.close()
            return m
        finally:
            os.close(fd)

    def close(self) -> None:
        while self._maps:
            _, m = self._maps.popitem()
            m.close()


# ---------------------------------------------------------------------
# DLPack export (hand-rolled capsule: numpy/jax reject read-only arrays)
# ---------------------------------------------------------------------

class DLDevice(ctypes.Structure):
    _fields_ = [("device_type", ctypes.c_int32),
                ("device_id", ctypes.c_int32)]


class DLDataType(ctypes.Structure):
    _fields_ = [("code", ctypes.c_uint8), ("bits", ctypes.c_uint8),
                ("lanes", ctypes.c_uint16)]


class DLTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("device", DLDevice),
                ("ndim", ctypes.c_int32), ("dtype", DLDataType),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("strides", ctypes.POINTER(ctypes.c_int64)),
                ("byte_offset", ctypes.c_uint64)]


class DLManagedTensor(ctypes.Structure):
    pass


_DELETER = ctypes.CFUNCTYPE(None, ctypes.POINTER(DLManagedTensor))
DLManagedTensor._fields_ = [("dl_tensor", DLTensor),
                            ("manager_ctx", ctypes.c_void_p),
                            ("deleter", _DELETER)]

_kDLCPU = 1
# numpy kind -> DLPack type code (bfloat16 comes through ml_dtypes with
# kind 'V'/'f' depending on version; resolved by name below).
_DL_CODES = {"i": 0, "u": 1, "f": 2, "c": 5, "b": 6}

# Capsules whose deleter has not fired yet: manager_ctx key ->
# (struct, shape array, keepalive owner). Keeping the struct alive here
# is load-bearing — the consumer dereferences it long after this module
# returns; the owner entry pins the mmap the data points into.
_live_capsules = {}
_next_key = [1]
_cap_lock = threading.Lock()


@_DELETER
def _dl_deleter(mtp):
    with _cap_lock:
        _live_capsules.pop(mtp.contents.manager_ctx, None)


_pyapi = ctypes.pythonapi
_pyapi.PyCapsule_New.restype = ctypes.py_object
_pyapi.PyCapsule_New.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_void_p]

# The destructor gets the capsule as a raw pointer: it runs while the
# capsule is being deallocated, so it must not take a reference to it (a
# py_object argument would, and its release would free the capsule again).
_CAP_DESTRUCTOR = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_cap_is_valid = ctypes.PYFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_char_p)(("PyCapsule_IsValid",
                                                    _pyapi))
_cap_pointer = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_char_p)(("PyCapsule_GetPointer",
                                                   _pyapi))


@_CAP_DESTRUCTOR
def _cap_destruct(cap):
    # Fires when the capsule is garbage-collected UNCONSUMED (a consumer
    # renames it to "used_dltensor" and owns the deleter from then on).
    try:
        if _cap_is_valid(cap, b"dltensor"):
            p = _cap_pointer(cap, b"dltensor")
            mt = ctypes.cast(p, ctypes.POINTER(DLManagedTensor))
            mt.contents.deleter(mt)
    except Exception:
        pass


def live_capsules() -> int:
    """Outstanding exports whose deleter has not fired (test hook)."""
    with _cap_lock:
        return len(_live_capsules)


def _dtype_code_bits(dtype) -> Tuple[int, int]:
    name = getattr(dtype, "name", str(dtype))
    if name == "bfloat16":
        return 4, 16
    kind = dtype.kind
    if kind not in _DL_CODES:
        raise TypeError(f"dtype {name} has no DLPack mapping")
    return _DL_CODES[kind], dtype.itemsize * 8


def make_capsule(addr: int, shape: Sequence[int], dtype_code: int,
                 bits: int, keepalive: object):
    """Build a 'dltensor' PyCapsule over raw CPU memory. ``keepalive``
    (typically the mmap or MappedObject) stays referenced until the
    consumer's deleter runs."""
    nd = len(shape)
    shp = (ctypes.c_int64 * max(nd, 1))(*shape)
    mt = DLManagedTensor()
    mt.dl_tensor.data = addr
    mt.dl_tensor.device = DLDevice(_kDLCPU, 0)
    mt.dl_tensor.ndim = nd
    mt.dl_tensor.dtype = DLDataType(dtype_code, bits, 1)
    mt.dl_tensor.shape = shp
    mt.dl_tensor.strides = None  # NULL = compact row-major
    mt.dl_tensor.byte_offset = 0
    with _cap_lock:
        key = _next_key[0]
        _next_key[0] += 1
        mt.manager_ctx = key
        mt.deleter = _dl_deleter
        _live_capsules[key] = (mt, shp, keepalive)
    return _pyapi.PyCapsule_New(ctypes.byref(mt), b"dltensor",
                                ctypes.cast(_cap_destruct, ctypes.c_void_p))


class DLPackExporter:
    """The object ``jax.dlpack.from_dlpack`` (and any array API consumer)
    ingests: wraps a C-contiguous numpy array — READ-ONLY views included,
    which is the whole point — plus the owner that pins its memory."""

    def __init__(self, arr, owner: object = None):
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("DLPack export requires a C-contiguous array")
        self._addr = arr.__array_interface__["data"][0]
        self._shape = arr.shape
        self._code, self._bits = _dtype_code_bits(arr.dtype)
        # The array itself also pins its buffer; owner pins the mapping.
        self._owner = (arr, owner)

    def __dlpack__(self, stream=None):
        return make_capsule(self._addr, self._shape, self._code,
                            self._bits, self._owner)

    def __dlpack_device__(self):
        return (_kDLCPU, 0)
