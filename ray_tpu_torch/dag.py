"""Compiled actor DAGs (aDAG-lite).

Analogue of the reference's compiled graphs (reference: python/ray/dag/ —
dag_node.py lazy nodes, input_node.py InputNode, output_node.py
MultiOutputNode, compiled_dag_node.py CompiledDAG:805 with NCCL channels
and overlap scheduling; collective_node.py:252 CollectiveOutputNode). TPU
redesign: the lazy ``bind`` API is kept verbatim; compilation
topologically sorts the graph ONCE and replays it per execute() with
direct pipelined actor pushes and ObjectRef plumbing. Edges marked
``.with_tensor_transport()`` move their tensors over the DEVICE plane:
the producer keeps the tensor in its own memory and ships a tiny
DeviceRef; a consumer of the same node pulls a CUDA tensor into its own
memory on the card by CUDA IPC (``experimental/device_plane.py``) — no
host pickle round-trip; a CPU tensor, or a consumer on another node, takes
the host relay. ``allreduce([...])`` is the in-DAG collective node (a hub
reduce on the first participant's device).

    with InputNode() as inp:
        x = preproc.run.bind(inp).with_tensor_transport()
        y = model.forward.bind(x)
        dag = MultiOutputNode([y, postproc.run.bind(y)])
    compiled = dag.experimental_compile()
    out_refs = compiled.execute(batch)

    # in-DAG collective: one output per participating actor
    outs = allreduce([w1.grad.bind(inp), w2.grad.bind(inp)], op="mean")
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional


class DAGNode:
    def __init__(self):
        self._upstream: List["DAGNode"] = []

    def experimental_compile(self) -> "CompiledDAG":
        return CompiledDAG(self)

    def execute(self, *args) -> Any:
        """Eager one-shot execution (compiles a throwaway plan)."""
        return CompiledDAG(self).execute(*args)


class InputNode(DAGNode):
    """The DAG's input placeholder (reference: input_node.py). Usable as
    a context manager purely for the reference's familiar spelling — the
    graph edges come from passing the node into bind()."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        pass


def _scan_nodes(value, out: List["DAGNode"]) -> None:
    """Collect DAGNodes nested inside containers (one task arg may be a
    list/tuple/dict holding node outputs)."""
    if isinstance(value, DAGNode):
        out.append(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _scan_nodes(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _scan_nodes(v, out)


def _substitute(value, resolved: Dict[int, Any]):
    if isinstance(value, DAGNode):
        return resolved[id(value)]
    if isinstance(value, list):
        return [_substitute(v, resolved) for v in value]
    if isinstance(value, tuple):
        return tuple(_substitute(v, resolved) for v in value)
    if isinstance(value, dict):
        return {k: _substitute(v, resolved) for k, v in value.items()}
    return value


class ClassMethodNode(DAGNode):
    """One actor-method invocation in the graph (reference:
    dag/class_node.py ClassMethodNode)."""

    def __init__(self, actor, method_name: str, args: tuple, kwargs: dict):
        super().__init__()
        self.actor = actor
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        self.tensor_transport = False
        found: List[DAGNode] = []
        _scan_nodes(list(args) + list(kwargs.values()), found)
        self._upstream.extend(found)

    def with_tensor_transport(self, transport: str = "auto"
                              ) -> "ClassMethodNode":
        """Keep this node's output in device memory: downstream nodes
        receive it device-to-device over the transfer plane instead of
        through the host object path (reference:
        dag_node.py with_tensor_transport / TorchTensorType hints)."""
        self.tensor_transport = True
        return self


class AllReduceNode(DAGNode):
    """One participant's output of an in-DAG allreduce (reference:
    dag/collective_node.py:252 CollectiveOutputNode). Created via
    `allreduce(nodes, op)`; executes on the same actor as its input."""

    def __init__(self, input_node: ClassMethodNode, rank: int,
                 group: List[ClassMethodNode], op: str):
        super().__init__()
        self.input_node = input_node
        self.rank = rank
        self.group = group
        self.op = op
        self._upstream = list(group)  # needs every participant's tensor


def allreduce(nodes: List[ClassMethodNode],
              op: str = "sum") -> List[AllReduceNode]:
    """Bind an allreduce across the outputs of `nodes` (one per actor).
    Returns one AllReduceNode per participant, each device-resident on
    its actor. Inputs are auto-marked for tensor transport."""
    if not nodes:
        raise ValueError("allreduce needs at least one input node")
    for n in nodes:
        if not isinstance(n, ClassMethodNode):
            raise TypeError("allreduce inputs must be actor-method nodes")
        n.with_tensor_transport()
    group = list(nodes)  # ONE shared list: execute() keys the op by it
    return [AllReduceNode(n, i, group, op) for i, n in enumerate(nodes)]


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__()
        self.outputs = list(outputs)
        self._upstream = list(outputs)


class CompiledDAG:
    """Topologically-sorted replayable plan (reference:
    compiled_dag_node.py CompiledDAG — ours replays direct actor pushes;
    the runtime already pipelines and ships refs worker-to-worker)."""

    def __init__(self, root: DAGNode):
        self._root = root
        self._order: List[DAGNode] = []
        self._input: Optional[InputNode] = None
        self._toposort(root, set())
        for node in self._order:
            if isinstance(node, InputNode):
                if self._input is not None and self._input is not node:
                    raise ValueError("a DAG supports one InputNode")
                self._input = node

    def _toposort(self, node: DAGNode, seen: set) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        for up in node._upstream:
            self._toposort(up, seen)
        self._order.append(node)

    def execute(self, *args) -> Any:
        """Run the plan; returns the ObjectRef of the root node (or a
        list of refs for MultiOutputNode). Intermediate results flow as
        ObjectRefs straight between the actors."""
        if self._input is not None:
            if len(args) != 1:
                raise TypeError(
                    f"DAG takes exactly 1 input, got {len(args)}")
        from ray_tpu_torch.core.ref import ActorMethod

        values: Dict[int, Any] = {}
        op_keys: Dict[int, bytes] = {}  # allreduce group -> this round's key
        for node in self._order:
            if isinstance(node, InputNode):
                values[id(node)] = args[0]
            elif isinstance(node, ClassMethodNode):
                call_args = [_substitute(a, values) for a in node.args]
                call_kwargs = {k: _substitute(v, values)
                               for k, v in node.kwargs.items()}
                device_in = any(
                    isinstance(up, (ClassMethodNode, AllReduceNode))
                    and getattr(up, "tensor_transport", True)
                    for up in node._upstream)
                if node.tensor_transport or device_in:
                    # Device-plane edge: run through the worker builtin
                    # that unwraps DeviceRef args (a CUDA IPC pull within
                    # the node) and/or keeps the output in device memory.
                    out_mode = "device" if node.tensor_transport else "host"
                    method = ActorMethod(node.actor, "__rt_dag_call__")
                    values[id(node)] = method.remote(
                        node.method_name, out_mode, *call_args,
                        **call_kwargs)
                else:
                    method = getattr(node.actor, node.method_name)
                    values[id(node)] = method.remote(*call_args,
                                                     **call_kwargs)
            elif isinstance(node, AllReduceNode):
                key = op_keys.get(id(node.group))
                if key is None:
                    key = op_keys[id(node.group)] = os.urandom(16)
                inputs = [values[id(n)] for n in node.group]
                method = ActorMethod(node.input_node.actor,
                                     "__rt_dag_allreduce__")
                values[id(node)] = method.remote(
                    key, node.rank, len(node.group), node.op, inputs)
            elif isinstance(node, MultiOutputNode):
                values[id(node)] = [values[id(o)] for o in node.outputs]
            else:
                raise TypeError(f"unknown DAG node {type(node).__name__}")
        return values[id(self._root)]

    def teardown(self) -> None:
        pass  # no channel resources to release in the ref-based plan
