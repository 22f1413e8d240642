"""ray_tpu_torch.serve — model serving on the port's actor runtime
(counterpart of ``ray_tpu/serve``).

Replicas are async actors that handle requests concurrently on their io
loop; each handle's router picks a replica by power-of-two choices over
live queue lengths; the controller reconciles deployments to their replica
sets, replaces dead replicas and autoscales; the HTTP proxy (and the
optional gRPC one, which needs ``grpcio``) resolve routes to handles.
Replicas ask for whole cards with ``num_gpus`` (the JAX package's
``num_tpus``). The control plane imports no torch: a replica that serves a
model imports it itself (``serve/llm.py``, ``serve/engine.py``).

    import ray_tpu_torch.serve as serve

    @serve.deployment(num_replicas=2)
    class Echo:
        async def __call__(self, request):
            return request

    serve.run(Echo.bind(), name="echo")
    handle = serve.get_deployment_handle("echo")
    out = handle.remote({"x": 1}).result()
"""

from ray_tpu_torch.serve.api import (Application, Deployment, batch, delete,
                                     deployment, get_deployment_handle,
                                     get_grpc_proxy, get_proxy, run,
                                     shutdown, start)
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                           multiplexed)

__all__ = [
    "Application", "Deployment", "DeploymentHandle", "DeploymentResponse",
    "batch", "delete", "deployment", "get_deployment_handle",
    "get_grpc_proxy", "get_proxy",
    "get_multiplexed_model_id", "multiplexed", "run", "shutdown", "start",
]
