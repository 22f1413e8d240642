"""Public utilities over the actor runtime (counterpart of
``ray_tpu/util/__init__.py``).

Analogue of the reference's ray.util helpers (reference:
python/ray/util/actor_pool.py ActorPool, python/ray/util/queue.py Queue —
an actor-backed distributed queue).
"""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue

__all__ = ["ActorPool", "Empty", "Full", "Queue"]
