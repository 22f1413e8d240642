"""graftlint — framework-aware static analysis for the ray_tpu_torch runtime.

Four passes over the control plane (the ~190 hand-rolled ``async def``s
in core/, serve/, data/) plus the hand-duplicated Python<->C wire schema:

  event-loop   blocking calls lexically inside ``async def`` bodies
  locks        awaits of RPC/pubsub under held locks + lock-order cycles
  wire         Python OP_*/framing vs ray_tpu_torch/csrc kOp*/struct layout drift, and
               RPC handler-signature vs call-site arity/keyword drift
  leaks        un-awaited coroutines and orphaned create_task results

The generic-linter gap this fills: every regression class from rounds
4-5 (streaming-batch completion deadlock, io-loop submission deadlock,
FIFO lease starvation) was mechanically detectable by one of these
passes. Run ``python -m ray_tpu_torch.tools.lint``; see README.md for the
allowlist format and the ``# lint: allow-blocking(<reason>)`` escape
hatch.
"""

from ray_tpu_torch.tools.lint.common import (  # noqa: F401
    Finding, load_allowlist)
