"""Llama-family decoder-only transformer, dense and MoE (counterpart of
``ray_tpu/models/llama.py``).

Parameters are a plain dict with the JAX package's keys and stacked
``[L, ...]`` layouts, so weights carry across one-to-one
(``params_from_jax``). The ``scan`` over layers becomes a Python loop over
the stacked tensors, and ``jax.checkpoint`` with its policies becomes
``torch.utils.checkpoint`` per layer.

Parallelism (all driven by a ``ParallelContext``; ``ctx=None`` is one
device):
  * dp/fsdp — the batch is split over (dp, fsdp); fsdp-sharded parameters
    are all-gathered at the start of the forward (reduce-scattered in the
    backward), and every parameter's gradient is summed over the batch
    shards that used it
  * tp      — Megatron-style: heads, kv heads, d_ff and the vocabulary are
    split, with an all-reduce after each row-parallel product; the loss is
    a vocab-parallel cross-entropy
  * sp      — ring attention over the sp group
  * pp      — GPipe over the pp group (``ray_tpu_torch.parallel.pipeline``)
  * ep      — MoE experts split over ep (``ray_tpu_torch.ops.moe``)
Under a context, every parameter is this rank's block under the sharding
rules (``param_specs``), ``tokens`` is the global batch, as the JAX
step takes it, and each rank slices its own part (``shard_batch``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.ops.norms import apply_rope, rms_norm, rope_frequencies
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.comm import (all_reduce_nograd, copy_to,
                                         gather_param, reduce_from)
from ray_tpu_torch.parallel.context import (ParallelContext, axis_group,
                                            axis_size)
from ray_tpu_torch.parallel.pipeline import gpipe_spmd
from ray_tpu_torch.parallel.sharding import axes_of, shard_batch, tree_specs


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # MoE: 0 experts = dense FFN in every layer.
    n_experts: int = 0
    top_k_experts: int = 2
    moe_aux_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master parameter dtype
    remat: bool = True
    # Rematerialization policy when remat=True (torch.utils.checkpoint per
    # layer, see ``_REMAT_SAVE``): "none" (save everything), "full"
    # (recompute the whole layer in the backward), "dots" (save every
    # matmul output), "dots_nobatch" (save the weight-matmul outputs,
    # recompute attention, norms and elementwise work).
    remat_policy: str = "full"
    num_microbatches: int = 0          # 0 => equal to pp size

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    # ---- presets ----
    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=500000.0)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, max_seq=128, dtype=torch.float32)
        base.update(kw)
        return LlamaConfig(**base)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical axis names of every parameter."""
    layers: Dict[str, Tuple] = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
    }
    if cfg.n_experts > 0:
        layers.update({
            "router": ("layers", "embed", "expert"),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        })
    else:
        layers.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    return {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def param_specs(cfg: LlamaConfig, ctx: ParallelContext) -> Dict[str, Any]:
    """The spec of every parameter under ``ctx``'s rules. Under pp the
    stacked layer dim is split by stage (the rules' "stage" axis), as the
    JAX package's pipeline reshapes ``[L]`` into ``[pp, L/pp]``."""
    specs = tree_specs(logical_axes(cfg), ctx.rules)
    if ctx.pp > 1:
        stage = ctx.rules.get("stage")
        specs["layers"] = {k: (stage,) + s[1:]
                           for k, s in specs["layers"].items()}
    return specs


def _shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    L, D, H, KVH = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, Fd, V, E = cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.n_experts
    layers = {"attn_norm": (L, D), "wq": (L, D, H * hd),
              "wk": (L, D, KVH * hd), "wv": (L, D, KVH * hd),
              "wo": (L, H * hd, D), "mlp_norm": (L, D)}
    if E > 0:
        layers.update({"router": (L, D, E), "w_gate": (L, E, D, Fd),
                       "w_up": (L, E, D, Fd), "w_down": (L, E, Fd, D)})
    else:
        layers.update({"w_gate": (L, D, Fd), "w_up": (L, D, Fd),
                       "w_down": (L, Fd, D)})
    return {"embed": (V, D), "layers": layers, "final_norm": (D,),
            "lm_head": (D, V)}


def init_params(cfg: LlamaConfig, seed: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters (normal * 0.02, norms at 1) in ``cfg.param_dtype``,
    drawn on ``device`` from a ``torch.Generator`` (an int seeds one)."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    pd = cfg.param_dtype
    shapes = _shapes(cfg)

    def norm(shape, scale=0.02):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=pd).mul_(scale)

    layers = {}
    for name, shape in shapes["layers"].items():
        layers[name] = (torch.ones(shape, dtype=pd, device=dev)
                        if name.endswith("norm") else norm(shape))
    return {
        "embed": norm(shapes["embed"]),
        "layers": layers,
        "final_norm": torch.ones(shapes["final_norm"], dtype=pd, device=dev),
        "lm_head": norm(shapes["lm_head"]),
    }


def param_count(cfg: LlamaConfig) -> int:
    shapes = _shapes(cfg)
    leaves = [shapes["embed"], shapes["final_norm"], shapes["lm_head"],
              *shapes["layers"].values()]
    return sum(int(np.prod(s)) for s in leaves)


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret bits
        t = torch.from_numpy(np.array(arr).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def params_from_jax(tree: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter pytree (numpy leaves, or anything
    ``np.asarray`` takes) -> the same nested dict of tensors on
    ``device``. Keys and layouts are identical; values are copied bit for
    bit."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(tree)


# ---------------------------------------------------------------------------
# Parallel helpers (each is the identity for ctx=None)
# ---------------------------------------------------------------------------

def _check_layout(cfg: LlamaConfig, ctx: Optional[ParallelContext]) -> None:
    tp, ep, pp = (axis_size(ctx, a) for a in ("tp", "ep", "pp"))
    checks = [("n_heads", cfg.n_heads, tp), ("n_kv_heads", cfg.n_kv_heads, tp),
              ("n_layers", cfg.n_layers, pp)]
    if cfg.n_experts > 0:
        checks.append(("n_experts", cfg.n_experts, ep))
    for what, n, k in checks:
        if n % k:
            raise ValueError(f"{what}={n} does not split over {k} ranks")


def _microbatches(cfg: LlamaConfig, ctx: Optional[ParallelContext]) -> int:
    """GPipe's microbatch count; 1 without pp (num_microbatches is then
    ignored, as in the JAX package)."""
    pp = axis_size(ctx, "pp")
    return (cfg.num_microbatches or pp) if pp > 1 else 1


def _local(batch, cfg: LlamaConfig, ctx: Optional[ParallelContext]):
    return batch if ctx is None else shard_batch(batch, ctx,
                                                 _microbatches(cfg, ctx))


def _enter(params: Dict[str, Any], cfg: LlamaConfig,
           ctx: Optional[ParallelContext]) -> Dict[str, Any]:
    """Each parameter as the forward reads it: all-gathered over fsdp
    where the rules split a dim over it, and entered with a gradient sum
    over every batch axis (dp, fsdp, sp) whose ranks share it."""
    if ctx is None:
        return params

    def enter(p, spec):
        used = set()
        for dim, entry in enumerate(spec):
            axes = axes_of(entry)
            used.update(axes)
            if "fsdp" in axes:
                if axes != ("fsdp",):
                    raise ValueError(f"fsdp must split a dim alone: {spec}")
                p = gather_param(p, dim, ctx.group("fsdp"))
        for axis in ("dp", "fsdp", "sp"):
            if axis not in used:
                p = copy_to(p, ctx.group(axis))
        return p

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return enter(node, spec)

    return walk(params, param_specs(cfg, ctx))


def _embed(table: torch.Tensor, tokens: torch.Tensor,
           ctx: Optional[ParallelContext]) -> torch.Tensor:
    """Lookup in a vocab-split table: each tp rank looks up the ids in its
    block and the group sums."""
    g = axis_group(ctx, "tp")
    if g is None:
        return table[tokens]
    Vl = table.shape[0]
    ids = tokens - ctx.rank("tp") * Vl
    inside = (ids >= 0) & (ids < Vl)
    rows = table[ids.clamp(0, Vl - 1)] * inside[..., None]
    return reduce_from(rows, g)


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                   ctx: Optional[ParallelContext]) -> torch.Tensor:
    """Per-position log-sum-exp minus the gold logit. With the vocabulary
    split over tp this is the vocab-parallel form: a max and a sum of
    exponentials over the group, and the gold logit from the rank that
    holds it."""
    g = axis_group(ctx, "tp")
    if g is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None].long())[..., 0]
        return logz - gold
    Vl = logits.shape[-1]
    m = all_reduce_nograd(logits.detach().amax(-1), g,
                          torch.distributed.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(-1), g)
    ids = targets.long() - ctx.rank("tp") * Vl
    inside = (ids >= 0) & (ids < Vl)
    gold = logits.gather(-1, ids.clamp(0, Vl - 1)[..., None])[..., 0]
    return m + torch.log(sumexp) - reduce_from(gold * inside, g)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

AttnFn = Callable[..., torch.Tensor]


def _layer_fwd(lp: Dict[str, torch.Tensor], x: torch.Tensor, cos, sin,
               positions, cfg: LlamaConfig, attn_fn: AttnFn,
               ctx: Optional[ParallelContext]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    tp = axis_size(ctx, "tp")
    H, KVH, hd = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    dt = cfg.dtype
    g_tp = axis_group(ctx, "tp")

    h = copy_to(rms_norm(x, lp["attn_norm"], cfg.norm_eps), g_tp)
    q = (h @ lp["wq"].to(dt)).view(B, S, H, hd).transpose(1, 2)
    k = (h @ lp["wk"].to(dt)).view(B, S, KVH, hd).transpose(1, 2)
    v = (h @ lp["wv"].to(dt)).view(B, S, KVH, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    # k/v keep KVH heads: the attention reads kv head h // (H // KVH),
    # which is what repeat_kv would give.
    if axis_size(ctx, "sp") > 1:
        attn = ring_attention(q, k, v, group=ctx.group("sp"), causal=True)
    else:
        attn = attn_fn(q, k, v, True)
    attn = attn.transpose(1, 2).reshape(B, S, H * hd)
    x = x + reduce_from(attn @ lp["wo"].to(dt), g_tp)

    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts > 0:
        out, aux = moe_ffn(h.reshape(B * S, D), lp["router"].to(dt),
                           lp["w_up"].to(dt), lp["w_gate"].to(dt),
                           lp["w_down"].to(dt), top_k=cfg.top_k_experts,
                           ctx=ctx)
        return x + out.view(B, S, D), aux
    h = copy_to(h, g_tp)
    gate = h @ lp["w_gate"].to(dt)
    up = h @ lp["w_up"].to(dt)
    out = reduce_from((F.silu(gate) * up) @ lp["w_down"].to(dt), g_tp)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


# Matmul ops whose outputs the "dots" policies save (as
# jax.checkpoint_policies.dots_saveable and
# dots_with_no_batch_dims_saveable do); everything else is recomputed.
# "none" saves everything, so it runs without checkpointing.
_REMAT_SAVE = {
    "full": frozenset(),
    "none": None,
    "dots": frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                       torch.ops.aten.bmm.default,
                       torch.ops.aten.baddbmm.default}),
    "dots_nobatch": frozenset({torch.ops.aten.mm.default,
                               torch.ops.aten.addmm.default}),
}


def _save_policy(ops, ctx, op, *args, **kwargs):
    # Ops inside a custom autograd.Function's forward (flash attention's
    # plain version, which scales its scores in place) run with grad mode
    # off and keep their own saved tensors: recompute them.
    if op in ops and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer(cfg: LlamaConfig) -> Callable:
    """``_layer_fwd`` wrapped for ``cfg``'s remat policy."""
    if cfg.remat_policy not in _REMAT_SAVE:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"one of {sorted(_REMAT_SAVE)}")
    ops = _REMAT_SAVE[cfg.remat_policy]
    if not cfg.remat or ops is None:
        return _layer_fwd
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if ops:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_policy, ops))
    return functools.partial(checkpoint, _layer_fwd, **kw)


def _stack_fwd(layers_p: Dict[str, torch.Tensor], x: torch.Tensor, cos, sin,
               cfg: LlamaConfig, attn_fn: AttnFn,
               ctx: Optional[ParallelContext]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop over a stack of layers (leading 'layers' axis on every leaf).
    Returns (x, the MoE aux loss summed over the stack).

    ``unbind`` slices every stacked leaf once, so the backward stacks each
    leaf's per-layer gradients in one pass. Under sp the positions start
    at this rank's block of the sequence."""
    offset = 0 if ctx is None else ctx.rank("sp") * x.shape[1]
    positions = offset + torch.arange(x.shape[1], device=x.device)
    layer = _remat_layer(cfg)
    if not torch.is_grad_enabled():  # nothing to save for a backward
        layer = _layer_fwd
    per_layer = {name: w.unbind(0) for name, w in layers_p.items()}
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(next(iter(layers_p.values())).shape[0]):
        lp = {name: ws[i] for name, ws in per_layer.items()}
        x, aux = layer(lp, x, cos, sin, positions, cfg, attn_fn, ctx)
        aux_sum = aux_sum + aux
    return x, aux_sum


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: LlamaConfig,
                     ctx: Optional[ParallelContext] = None, *,
                     attn_fn: AttnFn = flash_attention
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits float32, MoE aux loss scalar).

    Without ``ctx`` the logits are [B, S, V]. Under ``ctx`` ``tokens`` is
    the global batch and the logits are this rank's block: its rows of the
    batch (``shard_batch``), its block of the sequence (sp) and of the
    vocabulary (tp). ``attn_fn(q, k, v, causal)`` is the attention; the
    default runs the flash kernels on the card (ring attention replaces it
    under sp)."""
    _check_layout(cfg, ctx)
    dt = cfg.dtype
    p = _enter(params, cfg, ctx)
    tokens = _local(torch.as_tensor(tokens, device=p["embed"].device),
                    cfg, ctx)
    x = _embed(p["embed"], tokens, ctx).to(dt)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=x.device)
    stack = functools.partial(_stack_fwd, cos=cos, sin=sin, cfg=cfg,
                              attn_fn=attn_fn, ctx=ctx)
    if axis_size(ctx, "pp") > 1:
        M = _microbatches(cfg, ctx)
        B = x.shape[0]
        out, aux = gpipe_spmd(stack, p["layers"],
                              x.reshape(M, B // M, *x.shape[1:]),
                              group=ctx.group("pp"))
        x = out.reshape(B, *x.shape[1:])
    else:
        x, aux = stack(p["layers"], x)
    if axis_size(ctx, "sp") > 1:  # the mean of the sequence blocks' aux
        aux = reduce_from(aux, ctx.group("sp")) / ctx.sp
    x = copy_to(rms_norm(x, p["final_norm"], cfg.norm_eps),
                axis_group(ctx, "tp"))
    logits = x @ p["lm_head"].to(dt)
    return logits.float(), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            ctx: Optional[ParallelContext] = None, *,
            attn_fn: AttnFn = flash_attention) -> torch.Tensor:
    """tokens [B, S] -> logits (float32; see ``forward_with_aux``)."""
    return forward_with_aux(params, tokens, cfg, ctx, attn_fn=attn_fn)[0]


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            ctx: Optional[ParallelContext] = None, *,
            attn_fn: AttnFn = flash_attention
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ weighted MoE aux loss); targets =
    tokens shifted left, last position masked -> (loss, {"loss",
    "tokens"}), all on the device.

    Under ``ctx`` the loss is the global one on every rank; its backward
    gives each rank's parameters their whole gradient (the sums over
    batch shards happen inside)."""
    logits, aux = forward_with_aux(params, tokens, cfg, ctx, attn_fn=attn_fn)
    tokens = torch.as_tensor(tokens, device=logits.device)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=logits.device)
    mask[:, -1] = 0.0
    n_tok = mask.sum()
    targets, mask = _local((targets, mask), cfg, ctx)
    ce = _cross_entropy(logits, targets, ctx) * mask
    total = ce.sum()
    for axis in ("sp", "fsdp", "dp"):
        total = reduce_from(total, axis_group(ctx, axis))
    loss = total / n_tok.clamp_min(1.0)
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss, {"loss": loss.detach(), "tokens": n_tok}


def flops_per_token(cfg: LlamaConfig, seq: int) -> float:
    """Approximate training FLOPs/token (6N + attention term) for MFU, the
    JAX package's formula (N counts every expert of an MoE layer)."""
    n = param_count(cfg) - cfg.vocab_size * cfg.d_model  # exclude embed lookup
    attn = 12 * cfg.n_layers * cfg.d_model * seq  # 2*2*3 * L * D * S (fwd+bwd qk+av)
    return 6.0 * n + attn
