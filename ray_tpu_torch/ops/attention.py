"""Attention ops: reference softmax attention and the flash-attention
forward (counterpart of ``ray_tpu/ops/attention.py``).

  * ``attention_reference`` / ``_fwd_with_lse_reference`` — plain PyTorch,
    f32 softmax; ground truth for the tests.
  * ``flash_fwd`` — the wrapper of the hand-written CUDA kernel
    ``csrc/flash_fwd.cu`` (which replaces the Pallas TPU kernel
    ``_flash_fwd_kernel``). On a CUDA tensor it launches the kernel or
    raises; on a CPU tensor it runs ``flash_fwd_plain``, the kernel's
    arithmetic in plain PyTorch. There is no fallback between the two.
  * ``flash_attention`` — ``torch.autograd.Function`` around ``flash_fwd``.
    The backward computes the plain math for CPU tensors and raises
    ``NotImplementedError`` for CUDA tensors until the two backward kernels
    (``_flash_bwd_dkv_kernel``, ``_flash_bwd_dq_kernel``) are ported.

Layout: [batch, num_heads, seq, head_dim] (BHSD). k and v may carry fewer
heads than q (grouped-query attention): q head h reads kv head
h // (H // KVH), which is what ``repeat_kv`` would give.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Reference implementations
# ---------------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention:
    [b, kvh, s, d] -> [b, kvh*n_rep, s, d]."""
    if n_rep == 1:
        return x
    b, kvh, s, d = x.shape
    return x[:, :, None].expand(b, kvh, n_rep, s, d).reshape(
        b, kvh * n_rep, s, d)


def _causal_mask(sq: int, skv: int, q_offset: int, kv_offset: int,
                 device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = kv_offset + torch.arange(skv, device=device)[None, :]
    return q_pos >= k_pos


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        q_offset: int = 0,
                        kv_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention with f32 scores.

    ``q_offset``/``kv_offset`` give the global positions of the local q/kv
    shards (ring attention sees rotated K/V)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], q_offset, kv_offset,
                            q.device)
        s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _fwd_with_lse_reference(q, k, v, *, causal, sm_scale):
    """(out, lse [b, h, sq] f32), the JAX package's reference forward."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], 0, 0, q.device)
        s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul((p / l).to(v.dtype), v)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


# ---------------------------------------------------------------------------
# Flash forward: plain version + CUDA kernel wrapper
# ---------------------------------------------------------------------------

def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: f32 scores, P rounded to
    the input dtype before P·V (as the kernel feeds P to the tensor cores),
    f32 accumulation, O = acc / max(l, 1e-30), LSE = m + log(max(l,
    1e-30))."""
    n_rep = q.shape[1] // k.shape[1]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(sm_scale)
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], 0, 0, q.device)
        s.masked_fill_(~mask, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_fn():
    from ray_tpu_torch.ops._build import load

    fn = load("flash_fwd").ray_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_fwd kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if q.shape[-1] != 128:
        raise ValueError(f"flash_fwd kernel takes head_dim 128, "
                         f"not {q.shape[-1]}")
    B, H, Sq, D = q.shape
    _, KVH, Skv, _ = k.shape
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % align for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_fwd kernel needs {name} with a dense "
                             f"last dim and 16-byte aligned rows, got "
                             f"strides {t.stride()}")
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        B, H, KVH, Sq, Skv, D, float(sm_scale), int(causal),
        _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err} (shape q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} dtype={q.dtype})")
    flash_fwd.launches += 1
    return o, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward -> (O [b, h, sq, d] in q's dtype, LSE
    [b, h, sq] f32). CUDA tensors launch ``csrc/flash_fwd.cu`` (counted in
    ``flash_fwd.launches``); CPU tensors run ``flash_fwd_plain``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.shape[0] != k.shape[0] or k.shape != v.shape \
            or q.shape[-1] != k.shape[-1] or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_fwd: incompatible shapes q={tuple(q.shape)}"
                         f" k={tuple(k.shape)} v={tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_fwd: q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k and v must share a device")
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")


flash_fwd.launches = 0


def _flash_bwd_plain(q, k, v, out, lse, dout, causal, scale):
    """Plain flash backward (the math of the two Pallas backward kernels):
    P = exp(S - LSE), dV = Pᵀ dO, dS = P (dO Vᵀ - delta) scale, dQ = dS K,
    dK = dSᵀ Q; grouped kv heads sum their query heads' gradients."""
    n_rep = q.shape[1] // k.shape[1]
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    qf, dof = q.float(), dout.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], 0, 0, q.device)
        s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    if n_rep > 1:
        b, kvh, skv, d = k.shape
        dk = dk.view(b, kvh, n_rep, skv, d).sum(dim=2)
        dv = dv.view(b, kvh, n_rep, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type != "cpu":
            raise NotImplementedError(
                "flash_attention backward on CUDA needs the backward "
                "kernels (_flash_bwd_dkv_kernel, _flash_bwd_dq_kernel), "
                "which are not ported yet")
        dq, dk, dv = _flash_bwd_plain(q, k, v, out, lse, dout, ctx.causal,
                                      ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention through the flash forward; k/v may have fewer
    heads than q (grouped-query attention)."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
