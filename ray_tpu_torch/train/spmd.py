"""The training step (counterpart of ``ray_tpu/train/spmd.py``).

``make_train_fns`` returns ``init_fn`` and ``step_fn`` as the JAX package
does: the state is ``{"params", "opt_state", "step"}`` and the metrics are
``{"loss", "tokens", "grad_norm"}``. Where the JAX step is a jitted pure
function that donates its state, ``step_fn`` updates the state's tensors in
place (parameters and both AdamW moments) and returns the same dict: that
keeps one copy of 16 bytes per parameter on the card. Nothing in the step
reads a value back to the host, so steps queue up on the device.

Under a ``ParallelContext`` every rank keeps its block of the state under
the sharding rules (``state_shardings``) and takes the global batch, as
the JAX step does; the gradients come out of the model's backward already
summed over the ranks that share each block. The trainer and data ingest
wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.optim.adamw import adamw

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel.comm import all_reduce_nograd
from ray_tpu_torch.parallel.context import ParallelContext
from ray_tpu_torch.parallel.sharding import axes_of, batch_to, tree_shard

TrainState = Dict[str, Any]  # {"params", "opt_state", "step"}


def _leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    out = []
    for key in sorted(tree):
        node = tree[key]
        out.extend(_leaves(node) if isinstance(node, dict) else [node])
    return out


def _map(fn: Callable, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class ClipAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))``.

    The clip is optax's: g / ‖g‖ · grad_clip only when ‖g‖ ≥ grad_clip,
    with no epsilon, decided on the device (no host sync). AdamW is
    ``torch.optim``'s functional step (fused on the card): decoupled decay
    of every leaf, norms included, from the pre-update parameter, as optax
    does. Its state mirrors optax's ``ScaleByAdamState``:
    ``{"count", "mu", "nu"}``."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        leaf = _leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                "mu": _map(torch.zeros_like, params),
                "nu": _map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: Dict[str, Any], opt_state: Dict[str, Any],
               params: Dict[str, Any], specs: Optional[Dict[str, Any]] = None,
               ctx: Optional[ParallelContext] = None) -> torch.Tensor:
        """Clip ``grads`` and apply one AdamW step to ``params`` and
        ``opt_state``, all in place. Returns the global norm of the
        gradients before clipping. Under ``ctx`` the leaves are this
        rank's blocks under ``specs``: the norm counts each element once,
        summing a block's squares over the axes that split it."""
        ps, gs = _leaves(params), _leaves(grads)
        mus, nus = _leaves(opt_state["mu"]), _leaves(opt_state["nu"])
        norms = [torch.linalg.vector_norm(g) for g in gs]
        if ctx is not None:
            norms = _sharded_norms(norms, _leaves(specs), ctx)
        norm = torch.linalg.vector_norm(torch.stack(norms))
        keep = norm < self.grad_clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        denom = torch.where(keep, one, norm)
        mult = torch.where(keep, one, one * self.grad_clip)
        for g in gs:  # optax order: (g / norm) * max_norm
            g.div_(denom).mul_(mult)
        count = opt_state["count"]
        # one step counter per leaf: the functional step advances each
        steps = list(count.to(torch.float32).repeat(len(ps)).unbind(0))
        on_card = ps[0].device.type == "cuda"
        adamw(ps, gs, mus, nus, [], steps, foreach=False, fused=on_card,
              amsgrad=False, beta1=self.b1, beta2=self.b2, lr=self.lr,
              weight_decay=self.weight_decay, eps=self.eps, maximize=False)
        count.add_(1)
        return norm


def _sharded_norms(norms: List[torch.Tensor], specs: List[Any],
                   ctx: ParallelContext) -> List[torch.Tensor]:
    """Each leaf's norm over its whole global tensor: the squares of the
    blocks summed over the axes that split the leaf, one all-reduce per
    axis for all leaves together."""
    out = list(norms)
    for axis in ("pp", "dp", "fsdp", "ep", "sp", "tp"):
        group = ctx.group(axis)
        split = [i for i, spec in enumerate(specs)
                 if any(axis in axes_of(e) for e in spec)]
        if group is None or not split:
            continue
        sq = all_reduce_nograd(torch.stack([out[i] ** 2 for i in split]),
                               group)
        for j, i in enumerate(split):
            out[i] = sq[j].sqrt()
    return out


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      grad_clip: float = 1.0) -> ClipAdamW:
    return ClipAdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


def _to_device(tree: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """A params tree of tensors or numpy-like leaves -> the state's own
    copies on ``dev``."""
    if all(isinstance(x, torch.Tensor) for x in _leaves(tree)):
        return _map(lambda x: x.detach().to(dev, copy=True), tree)
    return llama.params_from_jax(tree, dev)


def state_shardings(cfg: llama.LlamaConfig, ctx: ParallelContext,
                    opt: Optional[ClipAdamW] = None) -> Dict[str, Any]:
    """The spec of every leaf of the train state: the parameters' under
    the rules, the same for AdamW's ``mu`` and ``nu``; ``count`` and
    ``step`` replicated."""
    param_sh = llama.param_specs(cfg, ctx)
    return {"params": param_sh,
            "opt_state": {"count": (), "mu": param_sh, "nu": param_sh},
            "step": ()}


def _shard_params(params: Dict[str, Any], cfg: llama.LlamaConfig,
                  ctx: Optional[ParallelContext]) -> Dict[str, Any]:
    """Global parameters -> this rank's blocks, each its own storage."""
    if ctx is None:
        return params
    # a split leaf is a view of the global tensor: give it its own storage
    # so the global one can go
    return _map(lambda t: t if t._base is None else t.clone(),
                tree_shard(params, llama.param_specs(cfg, ctx), ctx))


def make_train_fns(cfg: llama.LlamaConfig,
                   ctx: Optional[ParallelContext] = None,
                   opt: Optional[ClipAdamW] = None,
                   loss_fn: Optional[Callable] = None,
                   device: DeviceLike = None
                   ) -> Tuple[Callable[[Any], TrainState],
                              Callable[[TrainState, Any],
                                       Tuple[TrainState,
                                             Dict[str, torch.Tensor]]]]:
    """Returns (init_fn(seed | params tree) -> state,
    step_fn(state, tokens) -> (state, metrics)).

    ``loss_fn(params, tokens) -> (loss, metrics)`` defaults to the model's
    next-token loss. Pass tokens already on the device to keep the step
    free of host syncs; the metrics stay tensors on the device.

    Under ``ctx`` (whose device replaces ``device``) ``init_fn`` draws or
    takes the global parameters, the same on every mesh, and keeps this
    rank's blocks; ``step_fn`` takes the global batch, or this rank's rows
    of it marked by ``mark_rank_local``."""
    if ctx is not None and not isinstance(ctx, ParallelContext):
        raise TypeError(f"ctx must be a ParallelContext, not {type(ctx)}")
    dev = ctx.device if ctx is not None else resolve_device(device)
    opt = opt or default_optimizer()
    loss = loss_fn or (lambda p, toks: llama.loss_fn(p, toks, cfg, ctx))
    specs = llama.param_specs(cfg, ctx) if ctx is not None else None

    def init_fn(seed_or_params: Union[int, torch.Generator, Dict[str, Any]]
                ) -> TrainState:
        if isinstance(seed_or_params, dict):
            params = _to_device(seed_or_params, dev)
        else:
            params = llama.init_params(cfg, seed_or_params, device=dev)
        params = _shard_params(params, cfg, ctx)
        for p in _leaves(params):
            p.requires_grad_(True)
        return {"params": params, "opt_state": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def step_fn(state: TrainState, tokens: Any
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state["params"]
        tokens = batch_to(tokens, dev, non_blocking=True)
        l, metrics = loss(params, tokens)
        grads = torch.autograd.grad(l, _leaves(params))
        del l
        gnorm = opt.update(_unflatten(params, grads), state["opt_state"],
                           params, specs, ctx)
        state["step"] = state["step"] + 1
        return state, dict(metrics, grad_norm=gnorm)

    return init_fn, step_fn


def _unflatten(like: Dict[str, Any], leaves) -> Dict[str, Any]:
    """Inverse of ``_leaves`` for the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return build(like)


def _find_adam_state(node: Any) -> Optional[Any]:
    """optax's ``ScaleByAdamState`` (fields count, mu, nu) inside a chain's
    nested tuples of states."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def state_from_jax(jax_state: Dict[str, Any], cfg: llama.LlamaConfig,
                   device: DeviceLike = None,
                   ctx: Optional[ParallelContext] = None) -> TrainState:
    """A JAX ``TrainState`` of ``default_optimizer()`` for ``cfg``, with
    numpy leaves (``jax.tree.map(np.asarray, state)``) -> the port's state
    on ``device``: params through ``params_from_jax``, optax's Adam
    ``count``/``mu``/``nu`` as the optimizer state, so a run can go on in
    this package where it stopped in the other. Under ``ctx`` (whose
    device replaces ``device``) each rank keeps its blocks."""
    dev = ctx.device if ctx is not None else resolve_device(device)
    adam = _find_adam_state(jax_state["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")

    def convert(tree):
        return _shard_params(llama.params_from_jax(tree, dev), cfg, ctx)

    params = convert(jax_state["params"])
    for p in _leaves(params):
        p.requires_grad_(True)
    opt_state = {
        "count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                              device=dev),
        "mu": convert(adam.mu),
        "nu": convert(adam.nu)}
    step = torch.tensor(int(np.asarray(jax_state["step"])),
                        dtype=torch.int32, device=dev)
    return {"params": params, "opt_state": opt_state, "step": step}
