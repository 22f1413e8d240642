"""Unique IDs for the distributed runtime.

TPU-native analogue of the reference's ID scheme (reference:
src/ray/common/id.h — JobID/TaskID/ObjectID/ActorID/NodeID with embedded
lineage: an ObjectID embeds the TaskID of the task that creates it plus a
return index, which is what makes lineage reconstruction addressable).

All IDs are fixed-width random or derived byte strings with a cheap hex
representation; ObjectID = TaskID (16B) + 4B big-endian return index.
"""

from __future__ import annotations

import os
import struct
import threading

# Fast unique 16-byte IDs: one urandom seed per process plus a counter.
# A getrandom(2) syscall per ID costs tens of microseconds on small VMs —
# two orders of magnitude above the pack+concat — and ID generation sits
# on the actor-call submission hot path. Collision safety: uniqueness
# within a process comes from the counter; across processes from the
# 8-byte random prefix (reseeded after fork).
_rand_lock = threading.Lock()
_rand_prefix = os.urandom(8)
_rand_counter = int.from_bytes(os.urandom(4), "little")


def _reseed() -> None:
    global _rand_prefix, _rand_counter
    _rand_prefix = os.urandom(8)
    _rand_counter = int.from_bytes(os.urandom(4), "little")


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed)


def _fast16() -> bytes:
    global _rand_counter
    with _rand_lock:
        _rand_counter += 1
        c = _rand_counter
    return _rand_prefix + struct.pack("<Q", c & 0xFFFFFFFFFFFFFFFF)


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, b: bytes):
        if len(b) != self.SIZE:
            raise ValueError(f"{type(self).__name__} needs {self.SIZE} bytes, got {len(b)}")
        self._bytes = b

    @classmethod
    def random(cls):
        if cls.SIZE == 16:
            return cls(_fast16())
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def __hash__(self):
        return hash(self._bytes)

    def __eq__(self, other):
        return type(self) is type(other) and self._bytes == other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]})"


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ObjectID(BaseID):
    """TaskID (16B) + big-endian return index (4B)."""

    SIZE = 20

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def from_put(cls) -> "ObjectID":
        # Puts get a unique "task" prefix with index 0xFFFFFFFF.
        return cls(_fast16() + b"\xff\xff\xff\xff")

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:16])

    def return_index(self) -> int:
        return struct.unpack(">I", self._bytes[16:])[0]

    def is_put(self) -> bool:
        return self._bytes[16:] == b"\xff\xff\xff\xff"
