"""Llama-family decoder-only transformer, dense path (counterpart of
``ray_tpu/models/llama.py``).

Parameters are a plain dict with the JAX package's keys and stacked
``[L, ...]`` layouts, so weights carry across one-to-one
(``params_from_jax``). The ``scan`` over layers becomes a Python loop over
the stacked tensors, and ``jax.checkpoint`` with its policies becomes
``torch.utils.checkpoint`` per layer. MoE, sequence and pipeline
parallelism wait for later slices of the port.
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
from ray_tpu_torch.ops.norms import apply_rope, rms_norm, rope_frequencies


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
    # MoE: 0 experts = dense FFN in every layer (the only path ported).
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
    num_microbatches: int = 0          # pipeline microbatches; pp not ported

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

def _check_dense(cfg: LlamaConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError("the port has the dense Llama path only; "
                                  "MoE waits for a later slice")


def logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical axis names of every parameter (the dense layout)."""
    _check_dense(cfg)
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def _shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    L, D, H, KVH = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, Fd, V = cfg.head_dim, cfg.d_ff, cfg.vocab_size
    return {
        "embed": (V, D),
        "layers": {
            "attn_norm": (L, D), "wq": (L, D, H * hd), "wk": (L, D, KVH * hd),
            "wv": (L, D, KVH * hd), "wo": (L, H * hd, D), "mlp_norm": (L, D),
            "w_gate": (L, D, Fd), "w_up": (L, D, Fd), "w_down": (L, Fd, D),
        },
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def init_params(cfg: LlamaConfig, seed: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters (normal * 0.02, norms at 1) in ``cfg.param_dtype``,
    drawn on ``device`` from a ``torch.Generator`` (an int seeds one)."""
    _check_dense(cfg)
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

    ls = shapes["layers"]
    layers = {"attn_norm": torch.ones(ls["attn_norm"], dtype=pd, device=dev)}
    for name in ("wq", "wk", "wv", "wo"):
        layers[name] = norm(ls[name])
    layers["mlp_norm"] = torch.ones(ls["mlp_norm"], dtype=pd, device=dev)
    for name in ("w_gate", "w_up", "w_down"):
        layers[name] = norm(ls[name])
    return {
        "embed": norm(shapes["embed"]),
        "layers": layers,
        "final_norm": torch.ones(shapes["final_norm"], dtype=pd, device=dev),
        "lm_head": norm(shapes["lm_head"]),
    }


def param_count(cfg: LlamaConfig) -> int:
    _check_dense(cfg)
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
# Forward
# ---------------------------------------------------------------------------

AttnFn = Callable[..., torch.Tensor]


def _layer_fwd(lp: Dict[str, torch.Tensor], x: torch.Tensor, cos, sin,
               positions, cfg: LlamaConfig,
               attn_fn: AttnFn) -> torch.Tensor:
    B, S, D = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype

    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"].to(dt)).view(B, S, H, hd).transpose(1, 2)
    k = (h @ lp["wk"].to(dt)).view(B, S, KVH, hd).transpose(1, 2)
    v = (h @ lp["wv"].to(dt)).view(B, S, KVH, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    # k/v keep KVH heads: the attention reads kv head h // (H // KVH),
    # which is what repeat_kv would give.
    attn = attn_fn(q, k, v, True)
    attn = attn.transpose(1, 2).reshape(B, S, H * hd)
    x = x + attn @ lp["wo"].to(dt)

    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = h @ lp["w_gate"].to(dt)
    up = h @ lp["w_up"].to(dt)
    return x + (F.silu(gate) * up) @ lp["w_down"].to(dt)


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
               cfg: LlamaConfig, attn_fn: AttnFn) -> torch.Tensor:
    """Loop over a stack of layers (leading 'layers' axis on every leaf).

    ``unbind`` slices every stacked leaf once, so the backward stacks each
    leaf's per-layer gradients in one pass."""
    positions = torch.arange(x.shape[1], device=x.device)
    layer = _remat_layer(cfg)
    if not torch.is_grad_enabled():  # nothing to save for a backward
        layer = _layer_fwd
    per_layer = {name: w.unbind(0) for name, w in layers_p.items()}
    for i in range(next(iter(layers_p.values())).shape[0]):
        lp = {name: ws[i] for name, ws in per_layer.items()}
        x = layer(lp, x, cos, sin, positions, cfg, attn_fn)
    return x


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: LlamaConfig, ctx: Optional[Any] = None, *,
                     attn_fn: AttnFn = flash_attention
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] float32, aux loss 0.0).

    ``attn_fn(q, k, v, causal)`` is the attention; the default runs the
    flash forward (the CUDA kernel on the card)."""
    if ctx is not None:
        raise NotImplementedError("parallel contexts wait for a later "
                                  "slice of the port")
    _check_dense(cfg)
    if cfg.num_microbatches:
        raise NotImplementedError("num_microbatches needs pipeline "
                                  "parallelism, which waits for a later "
                                  "slice of the port")
    dt = cfg.dtype
    x = params["embed"][tokens].to(dt)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=x.device)
    x = _stack_fwd(params["layers"], x, cos, sin, cfg, attn_fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(dt)
    return logits.float(), torch.zeros((), dtype=torch.float32,
                                       device=x.device)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            ctx: Optional[Any] = None, *,
            attn_fn: AttnFn = flash_attention) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (float32)."""
    return forward_with_aux(params, tokens, cfg, ctx, attn_fn=attn_fn)[0]


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            ctx: Optional[Any] = None, *, attn_fn: AttnFn = flash_attention
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy; targets = tokens shifted left, last
    position masked -> (loss, {"loss", "tokens"}), all on the device."""
    logits, _ = forward_with_aux(params, tokens, cfg, ctx, attn_fn=attn_fn)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=logits.device)
    mask[:, -1] = 0.0
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    ce = (logz - gold) * mask
    n_tok = mask.sum()
    loss = ce.sum() / n_tok.clamp_min(1.0)
    return loss, {"loss": loss.detach(), "tokens": n_tok}


def flops_per_token(cfg: LlamaConfig, seq: int) -> float:
    """Approximate training FLOPs/token (6N + attention term) for MFU, the
    JAX package's formula."""
    n = param_count(cfg) - cfg.vocab_size * cfg.d_model  # exclude embed lookup
    attn = 12 * cfg.n_layers * cfg.d_model * seq  # 2*2*3 * L * D * S (fwd+bwd qk+av)
    return 6.0 * n + attn
