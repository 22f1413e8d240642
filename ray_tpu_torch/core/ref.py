"""ObjectRef and ActorHandle — the distributed future / actor proxy types.

Analogue of the reference's ObjectRef (Cython class, python/ray/_raylet.pyx)
and ActorHandle (python/ray/actor.py). Refs carry their owner's address so any
holder can resolve status/location by asking the owner (the ownership model,
reference: src/ray/core_worker/reference_count.cc). Serializing a ref inside
a value reports it to the in-flight serializer for borrower accounting.
"""

from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import Address
from ray_tpu_torch.core.ids import ActorID, ObjectID

# Set by CoreWorker on process init; ObjectRef methods route through it.
_core_worker = None


def set_core_worker(cw) -> None:
    global _core_worker
    _core_worker = cw


def get_core_worker():
    if _core_worker is None:
        raise RuntimeError("ray_tpu_torch not initialized in this process "
                           "(call ray_tpu_torch.init())")
    return _core_worker


def _reconstruct_ref(oid_bytes: bytes, owner_addr) -> "ObjectRef":
    ref = ObjectRef(ObjectID(oid_bytes), tuple(owner_addr) if owner_addr else None,
                    _deserialized=True)
    if _core_worker is not None:
        _core_worker.on_ref_deserialized(ref)
    return ref


class ObjectRef:
    __slots__ = ("id", "owner_addr", "_weakref_released")

    def __init__(self, oid: ObjectID, owner_addr: Optional[Address] = None,
                 _deserialized: bool = False):
        self.id = oid
        self.owner_addr = owner_addr
        self._weakref_released = False

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def __reduce__(self):
        serialization.note_contained_ref(self)
        return (_reconstruct_ref, (self.id.binary(), self.owner_addr))

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self.id == other.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:12]})"

    def __del__(self):
        if _core_worker is not None and not self._weakref_released:
            try:
                _core_worker.remove_local_ref(self)
            except Exception:
                pass

    # convenience: await-able in async actors
    def __await__(self):
        return get_core_worker().get_async(self).__await__()

    def future(self):
        return get_core_worker().get_future(self)


class ObjectRefGenerator:
    """Iterator over a streaming task's yielded ObjectRefs, in yield order
    (reference: python/ray/_raylet.pyx:297 ObjectRefGenerator over
    task_manager.cc's ObjectRefStream). Blocks in ``__next__`` until the
    next item is reported by the executing worker; raises the task's error
    if it failed; StopIteration once the generator completes."""

    def __init__(self, task_id: bytes):
        self._task_id = task_id
        self._next = 0
        self._released = False

    @property
    def task_id(self) -> bytes:
        return self._task_id

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> "ObjectRef":
        ref = get_core_worker().next_stream_item(self._task_id, self._next)
        if ref is None:
            raise StopIteration
        self._next += 1
        return ref

    async def __aiter__(self):
        while True:
            ref = await get_core_worker().next_stream_item_async(
                self._task_id, self._next)
            if ref is None:
                return
            self._next += 1
            yield ref

    def release(self) -> None:
        """Drop interest in remaining items (unblocks the producer)."""
        if not self._released:
            self._released = True
            if _core_worker is not None:
                try:
                    _core_worker.release_stream(self._task_id)
                except Exception:
                    pass

    def __del__(self):
        self.release()

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()[:12]}, next={self._next})"


def _reconstruct_actor_handle(state: dict) -> "ActorHandle":
    h = ActorHandle(ActorID(state["actor_id"]), state["name"],
                    state["method_names"], state["max_task_retries"])
    return h


class ActorHandle:
    """Proxy for a remote actor; `handle.method.remote(...)` submits a task."""

    def __init__(self, actor_id: ActorID, name: str, method_names: list,
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._name = name
        self._method_names = method_names
        self._max_task_retries = max_task_retries

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        if item not in self._method_names:
            raise AttributeError(
                f"Actor {self._name} has no method {item!r}")
        m = ActorMethod(self, item)
        # Cache so repeated handle.method lookups skip __getattr__
        # (__reduce__ pickles explicit state, so the cache never ships).
        self.__dict__[item] = m
        return m

    def __reduce__(self):
        return (_reconstruct_actor_handle, ({
            "actor_id": self._actor_id.binary(),
            "name": self._name,
            "method_names": self._method_names,
            "max_task_retries": self._max_task_retries,
        },))

    def __repr__(self):
        return f"ActorHandle({self._name}, {self._actor_id.hex()[:12]})"


class ActorMethod:
    __slots__ = ("_handle", "_method")

    def __init__(self, handle: ActorHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args: Any, **kwargs: Any):
        return get_core_worker().submit_actor_task(
            self._handle, self._method, args, kwargs)

    def bind(self, *args: Any, **kwargs: Any):
        """Lazy DAG node (reference: dag_node bind API)."""
        from ray_tpu_torch.dag import ClassMethodNode
        return ClassMethodNode(self._handle, self._method, args, kwargs)

    def options(self, **opts):
        handle, method = self._handle, self._method

        class _Bound:
            def remote(self, *args, **kwargs):
                return get_core_worker().submit_actor_task(
                    handle, method, args, kwargs, **opts)

        return _Bound()
