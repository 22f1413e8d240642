"""Common runtime datatypes: task specs, addresses, errors, resources.

Analogue of the reference's src/ray/common/ (TaskSpecification in
task/task_spec.cc, Status model in status.h, scheduling resource sets in
scheduling/resource_set.cc) — flattened to the pieces the runtime
needs, in pickle-friendly dataclasses (the wire format is the RPC layer's
pickle; protobuf's role as cross-language schema is a non-goal for v1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

Address = Tuple[str, int]  # (host, port) of an RPC server

# --- resources -------------------------------------------------------------

CPU = "CPU"
GPU = "GPU"  # one unit per whole device, pinned to a worker through
#              CUDA_VISIBLE_DEVICES (ray_tpu_torch/accelerators.py)
MEMORY = "memory"


def resources_fit(avail: Dict[str, float], need: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in need.items() if v > 0)


def resources_sub(avail: Dict[str, float], need: Dict[str, float]) -> None:
    for k, v in need.items():
        if v:
            avail[k] = avail.get(k, 0.0) - v


def resources_add(avail: Dict[str, float], need: Dict[str, float]) -> None:
    for k, v in need.items():
        if v:
            avail[k] = avail.get(k, 0.0) + v


def labels_match(labels: Dict[str, str], selector: Optional[Dict[str, str]]
                 ) -> bool:
    """Node-label selector matching (reference:
    src/ray/common/scheduling/label_selector.cc — equals / not-equals /
    in / not-in operators encoded in the value string):

        {"zone": "us1"}            zone == us1
        {"zone": "!us1"}           zone != us1
        {"zone": "in(us1,us2)"}    zone in {us1, us2}
        {"zone": "!in(us1,us2)"}   zone not in {us1, us2}

    A missing label never satisfies a positive match and always
    satisfies a negative one.
    """
    if not selector:
        return True
    for key, want in selector.items():
        have = labels.get(key)
        neg = want.startswith("!")
        if neg:
            want = want[1:]
        if want.startswith("in(") and want.endswith(")"):
            hit = have is not None and have in [
                v.strip() for v in want[3:-1].split(",")]
        else:
            hit = have == want
        if hit if neg else not hit:
            return False
    return True


# --- task spec -------------------------------------------------------------

@dataclasses.dataclass
class TaskSpec:
    task_id: bytes
    name: str
    func_id: bytes                     # key into the controller function table
    args: List[Any]                    # ("v", data, meta) | ("r", oid, owner_addr)
    num_returns: int
    resources: Dict[str, float]
    owner_addr: Address
    owner_worker_id: bytes
    job_id: bytes = b"\x00" * 4
    # Streaming generator task: yields are reported to the owner one at a
    # time (reference: _raylet.pyx:297 ObjectRefGenerator + task_manager.cc
    # ObjectRefStream); num_returns is ignored when True.
    streaming: bool = False
    # actor fields
    actor_id: Optional[bytes] = None           # target actor for method calls
    actor_creation: Optional[dict] = None      # creation spec (max_restarts...)
    method_name: str = ""
    seqno: int = 0                             # per-caller ordering
    caller_id: bytes = b""
    # fault tolerance
    max_retries: int = 0
    retry_count: int = 0
    # Distributed tracing (reference: util/tracing/tracing_helper.py —
    # OTel span context injected into the task spec): trace_id names the
    # whole task tree (the root task's id); parent_span is the
    # submitting task's id (b"" when the driver submitted).
    trace_id: bytes = b""
    parent_span: bytes = b""
    # Owner exported the function table entry asynchronously (io-loop
    # submission): executors briefly retry a missing kv entry.
    fn_async_export: bool = False
    # placement
    placement_group: Optional[bytes] = None
    pg_bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None  # e.g. NodeAffinity
    label_selector: Optional[dict] = None      # node-label constraints
    runtime_env: Optional[dict] = None

    @property
    def is_actor_creation(self) -> bool:
        return self.actor_creation is not None

    @property
    def is_actor_task(self) -> bool:
        return self.actor_id is not None and self.actor_creation is None

    def scheduling_class(self) -> tuple:
        return (self.func_id, tuple(sorted(self.resources.items())))


# --- errors ----------------------------------------------------------------

class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised; carries the remote traceback. Re-raised at ray.get."""

    def __init__(self, cause_repr: str, traceback_str: str = ""):
        super().__init__(cause_repr)
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str

    def __str__(self):
        return f"{self.cause_repr}\n\nRemote traceback:\n{self.traceback_str}"


class WorkerCrashedError(RayTpuError):
    pass


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    pass


class ObjectLostError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    """Raised at ray.get on a task cancelled via ray_tpu.cancel()."""
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class PlacementGroupError(RayTpuError):
    pass


# --- lifecycle states ------------------------------------------------------

class ActorState:
    PENDING = "PENDING"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class NodeState:
    ALIVE = "ALIVE"
    DEAD = "DEAD"


class PGState:
    PENDING = "PENDING"
    CREATED = "CREATED"
    REMOVED = "REMOVED"


def now() -> float:
    return time.monotonic()
