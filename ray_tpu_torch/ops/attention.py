"""Attention ops: reference softmax attention and flash attention, forward
and backward (counterpart of ``ray_tpu/ops/attention.py``).

  * ``attention_reference`` / ``_fwd_with_lse_reference`` — plain PyTorch,
    f32 softmax; ground truth for the tests.
  * ``attention_route`` — where a head_dim goes, decided by shape before
    anything launches, as the JAX package decides (``_flash_fwd`` and
    ``_flash_vjp_bwd``, ray_tpu/ops/attention.py:394-450): 128, 256, 384
    and 512 to the hand-written kernels (their plain versions on CPU
    tensors); a
    head_dim that is not a multiple of 128 to the port's copy of the JAX
    package's jnp branch (``flash_fwd_reference``, ``flash_bwd_reference``,
    on any device: that branch has no Pallas kernel); a multiple of 128
    from 640 up, which the Pallas kernels take and these kernels do not
    (their tiles outgrow the card's shared memory), raises.
  * ``flash_fwd`` — the wrapper of the hand-written CUDA kernel
    ``csrc/flash_fwd.cu`` (which replaces the Pallas TPU kernel
    ``_flash_fwd_kernel``). On a CUDA tensor it launches the kernel or
    raises; on a CPU tensor it runs ``flash_fwd_plain``, the kernel's
    arithmetic in plain PyTorch. There is no fallback between the two.
  * ``flash_bwd`` — the backward: delta = rowsum(dO·O), then the wrappers
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` of the hand-written CUDA kernels
    ``csrc/flash_bwd_dkv.cu`` and ``csrc/flash_bwd_dq.cu`` (which replace
    the Pallas kernels ``_flash_bwd_dkv_kernel`` and
    ``_flash_bwd_dq_kernel``). CPU tensors run ``flash_bwd_plain``, the
    kernels' arithmetic in plain PyTorch, rounded where they round.
  * ``flash_attention`` — ``torch.autograd.Function`` over ``flash_fwd``
    and ``flash_bwd``.

Each kernel takes f32 and bf16 at head_dim 128, 256, 384 and 512: bf16 at
128 runs its wgmma kernel, every other case its generic variant. Sequence lengths
are not routed: the kernels take any S (TMA zero-fills, the stores are
guarded), where the JAX package sends S % 128 != 0 to its jnp branch.

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
    """(out, lse [b, h, sq] f32), the JAX package's reference forward (q,
    k, v with one head count)."""
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
# Routing by head_dim, and the JAX package's jnp branch
# ---------------------------------------------------------------------------

KERNEL_HEAD_DIMS = (128, 256, 384, 512)


def attention_route(head_dim: int) -> str:
    """"kernel" for a head_dim the kernels take (128, 256, 384, 512),
    "reference" for one that is not a multiple of 128 (the JAX package's
    jnp branch); ValueError for a multiple of 128 from 640 up, where the
    generic variants' dK/dV and dQ tiles (252 and 249 KB at 640) pass the
    card's 227 KB of shared memory per block. Decided by shape alone, never
    because a launch failed."""
    if head_dim in KERNEL_HEAD_DIMS:
        return "kernel"
    if head_dim % 128:
        return "reference"
    raise ValueError(f"head_dim {head_dim}: the flash kernels take head_dim "
                     f"128, 256, 384 and 512 (from 640 up their tiles do "
                     f"not fit the 227 KB of shared memory per block), and "
                     f"the jnp branch head_dims that are not multiples of "
                     f"128")


def flash_fwd_reference(q, k, v, causal: bool, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's forward for a head_dim that is not a multiple of
    128: ``_fwd_with_lse_reference`` (ray_tpu/ops/attention.py:182) on K
    and V repeated to q's heads. Counted in ``flash_fwd_reference.calls``."""
    flash_fwd_reference.calls += 1
    n_rep = q.shape[1] // k.shape[1]
    return _fwd_with_lse_reference(q, repeat_kv(k, n_rep),
                                   repeat_kv(v, n_rep), causal=causal,
                                   sm_scale=sm_scale)


# KV rows per block of the jnp backward: the default of the JAX package's
# ``flash_attention(..., block_k_bwd=512)`` (ray_tpu/ops/attention.py:389).
BLOCK_K_BWD = 512


def flash_bwd_reference(q, k, v, out, lse, dout, causal: bool,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's blockwise backward for a head_dim that is not a
    multiple of 128 (``_flash_vjp_bwd``, ray_tpu/ops/attention.py:413-450):
    per block of ``BLOCK_K_BWD`` KV rows (one block when that does not
    divide Skv), S in f32 from the inputs, P = exp(S − LSE), dV = Pᵀ·dO,
    dP = dO·Vᵀ, dS = P·(dP − delta)·scale, dK = dSᵀ·Q, and dQ summed over
    the blocks, all in f32 with no rounding of P or dS; K and V are
    repeated to q's heads and their gradients summed back over each group
    in f32. Counted in ``flash_bwd_reference.calls``."""
    flash_bwd_reference.calls += 1
    kvh, n_rep = k.shape[1], q.shape[1] // k.shape[1]
    kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    skv = k.shape[2]
    block = min(BLOCK_K_BWD, skv)
    if skv % block:
        block = skv
    delta = _delta(out, dout)[..., None]
    qf, dof, lse_ = q.float(), dout.float(), lse[..., None]
    q_pos = torch.arange(q.shape[2], device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for start in range(0, skv, block):
        kb = kr[:, :, start:start + block].float()
        vb = vr[:, :, start:start + block].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * sm_scale
        if causal:
            k_pos = start + torch.arange(block, device=q.device)[None, :]
            s = s.masked_fill(q_pos < k_pos, DEFAULT_MASK_VALUE)
        p = torch.exp(s - lse_)
        dvs.append(torch.matmul(p.transpose(-1, -2), dof))
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta) * sm_scale
        dq = dq + torch.matmul(ds, kb)
        dks.append(torch.matmul(ds.transpose(-1, -2), qf))
    dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    return (dq.to(q.dtype), _sum_groups(dk, kvh).to(k.dtype),
            _sum_groups(dv, kvh).to(v.dtype))


flash_fwd_reference.calls = 0
flash_bwd_reference.calls = 0


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


def kernel_variant(q: torch.Tensor) -> str:
    """The name of the kernel variant that q's dtype and head_dim launch:
    "bf16_d128" (the wgmma kernels), "f32_d128" ... "f32_d512", "bf16_d256"
    ... "bf16_d512" (the generic ones). The wrappers count launches by it in
    ``launches_by_variant`` beside ``launches``."""
    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    return f"{dt}_d{q.shape[-1]}"


def _count(wrapper, q: torch.Tensor) -> None:
    wrapper.launches += 1
    v = kernel_variant(q)
    wrapper.launches_by_variant[v] = wrapper.launches_by_variant.get(v, 0) + 1


def _kernel_fn():
    from ray_tpu_torch.ops._build import load

    fn = load("flash_fwd").ray_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_kernel_layout(what: str, **tensors: torch.Tensor) -> None:
    """Raise ValueError unless each [b, h, s, d] tensor has a dense last
    dim, batch/head/seq strides that are multiples of 16 bytes and a
    16-byte aligned base address: what the kernels' TMA tensor maps and
    16-byte loads take. Strided views are fine (v as the transpose of a
    [b, s, kvh, d] view). Only strides and addresses are read, so it runs
    on CPU tensors too."""
    for name, t in tensors.items():
        align = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % align for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what} needs {name} with a dense last dim "
                             f"and 16-byte aligned rows, got strides "
                             f"{t.stride()}")


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_fwd kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    B, H, Sq, D = q.shape
    _, KVH, Skv, _ = k.shape
    check_kernel_layout("flash_fwd kernel", q=q, k=k, v=v)
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
    _count(flash_fwd, q)
    return o, lse


def _check_qkv(fn: str, q, k, v, *rest) -> None:
    """q [b, h, sq, d], k/v [b, kvh, skv, d] with kvh dividing h; one dtype
    for q, k, v and one device for all."""
    if q.shape[0] != k.shape[0] or k.shape != v.shape \
            or q.shape[-1] != k.shape[-1] or q.shape[1] % k.shape[1]:
        raise ValueError(f"{fn}: incompatible shapes q={tuple(q.shape)}"
                         f" k={tuple(k.shape)} v={tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{fn}: q, k and v must share a dtype")
    if any(t.device != q.device for t in (k, v, *rest)):
        raise ValueError(f"{fn}: all tensors must share a device")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward -> (O [b, h, sq, d] in q's dtype, LSE
    [b, h, sq] f32). Routed by ``attention_route``: at the kernels'
    head_dims (128 to 512) CUDA tensors launch ``csrc/flash_fwd.cu`` (counted in
    ``flash_fwd.launches``) and CPU tensors run ``flash_fwd_plain``; a
    head_dim that is not a multiple of 128 runs ``flash_fwd_reference``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    _check_qkv("flash_fwd", q, k, v)
    if attention_route(q.shape[-1]) == "reference":
        return flash_fwd_reference(q, k, v, causal, scale)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")


flash_fwd.launches = 0
flash_fwd.launches_by_variant = {}


# ---------------------------------------------------------------------------
# Flash backward: plain versions + CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _bwd_p_ds(q, k, v, dout, lse, delta, causal, sm_scale):
    """(P f32, dS in q's dtype, dO in q's dtype, k and v repeated to H
    heads): what both Pallas backward kernels recompute per block pair."""
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    do = dout.to(q.dtype)
    s = torch.matmul(q.float(), kr.float().transpose(-1, -2)).mul_(sm_scale)
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], 0, 0, q.device)
        s.masked_fill_(~mask, DEFAULT_MASK_VALUE)
    p = s.sub_(lse[..., None]).exp_()
    dp = torch.matmul(do.float(), vr.float().transpose(-1, -2))
    ds = dp.sub_(delta[..., None]).mul_(p).mul_(sm_scale).to(q.dtype)
    return p, ds, do, kr


def _sum_groups(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[b, h, s, d] -> [b, kvh, s, d]: the VJP of ``repeat_kv``."""
    b, h, s, d = x.shape
    return x if h == kvh else x.view(b, kvh, h // kvh, s, d).sum(dim=2)


def flash_bwd_plain_dkv(q, k, v, dout, lse, delta, causal: bool,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_flash_bwd_dkv_kernel``'s arithmetic in plain PyTorch: dV = Pᵀ·dO
    with P rounded to v's dtype, dK = dSᵀ·Q with dS rounded to q's dtype,
    f32 accumulation; grouped kv heads sum their query heads in f32."""
    p, ds, do, _ = _bwd_p_ds(q, k, v, dout, lse, delta, causal, sm_scale)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do.float())
    del p
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    kvh = k.shape[1]
    return _sum_groups(dk, kvh).to(k.dtype), _sum_groups(dv, kvh).to(v.dtype)


def flash_bwd_plain_dq(q, k, v, dout, lse, delta, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """``_flash_bwd_dq_kernel``'s arithmetic in plain PyTorch: dQ = dS·K
    with dS rounded to q's dtype, f32 accumulation."""
    _, ds, _, kr = _bwd_p_ds(q, k, v, dout, lse, delta, causal, sm_scale)
    return torch.matmul(ds.float(), kr.float()).to(q.dtype)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO · O) in f32 [b, h, sq], computed outside the
    kernels as ``_flash_bwd_pallas`` does."""
    return (dout.float() * out.float()).sum(dim=-1)


def flash_bwd_plain(q, k, v, out, lse, dout, causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two Pallas backward kernels' arithmetic in plain PyTorch ->
    (dQ, dK, dV): P = exp(S·scale − LSE) in f32, dV = Pᵀ·dO with P rounded
    to v's dtype, dS = P·(dP − delta)·scale rounded to q's dtype, dQ = dS·K,
    dK = dSᵀ·Q, accumulation in f32; with KVH < H, dK and dV are summed
    over each kv head's query heads."""
    delta = _delta(out, dout)
    dk, dv = flash_bwd_plain_dkv(q, k, v, dout, lse, delta, causal, sm_scale)
    dq = flash_bwd_plain_dq(q, k, v, dout, lse, delta, causal, sm_scale)
    return dq, dk, dv


def _bwd_kernel_fn(name: str):
    from ray_tpu_torch.ops._build import load

    fn = getattr(load(name), f"ray_{name}")
    if fn.argtypes is None:
        n_out = 2 if name == "flash_bwd_dkv" else 1
        fn.argtypes = ([ctypes.c_void_p] * (6 + n_out)
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_check(q, k, v, dout, lse, delta):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the flash backward kernels take float32 or "
                        f"bfloat16, not {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash backward kernels take head_dim "
                         f"{KERNEL_HEAD_DIMS}, not {q.shape[-1]}")
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError(f"dout must match q: {tuple(dout.shape)} "
                         f"{dout.dtype} vs {tuple(q.shape)} {q.dtype}")
    check_kernel_layout("the flash backward kernels", q=q, k=k, v=v,
                        dout=dout)
    rows = q.shape[:3]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != rows \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be dense f32 {tuple(rows)}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _bwd_launch(name, outs, q, k, v, dout, lse, delta, causal, scale):
    B, H, Sq, D = q.shape
    _, KVH, Skv, _ = k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_kernel_fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *[o.data_ptr() for o in outs],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], B, H, KVH, Sq, Skv, D, float(scale), int(causal),
        _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(shape q={tuple(q.shape)} k={tuple(k.shape)})")


def _bwd_device(fn_name: str, q, k, v, *rest) -> str:
    _check_qkv(fn_name, q, k, v, *rest)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn_name} runs on cuda or cpu, not {q.device}")
    return q.device.type


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [b, kvh, skv, d] in k's dtype. CUDA tensors launch
    ``csrc/flash_bwd_dkv.cu`` (counted in ``flash_bwd_dkv.launches``); CPU
    tensors run ``flash_bwd_plain_dkv``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if _bwd_device("flash_bwd_dkv", q, k, v, dout, lse, delta) == "cpu":
        return flash_bwd_plain_dkv(q, k, v, dout, lse, delta, causal, scale)
    _bwd_check(q, k, v, dout, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv", (dk, dv), q, k, v, dout, lse, delta, causal,
                scale)
    _count(flash_bwd_dkv, q)
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """dQ [b, h, sq, d] in q's dtype. CUDA tensors launch
    ``csrc/flash_bwd_dq.cu`` (counted in ``flash_bwd_dq.launches``); CPU
    tensors run ``flash_bwd_plain_dq``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if _bwd_device("flash_bwd_dq", q, k, v, dout, lse, delta) == "cpu":
        return flash_bwd_plain_dq(q, k, v, dout, lse, delta, causal, scale)
    _bwd_check(q, k, v, dout, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", (dq,), q, k, v, dout, lse, delta, causal,
                scale)
    _count(flash_bwd_dq, q)
    return dq


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches_by_variant = {}
flash_bwd_dq.launches_by_variant = {}


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward -> (dQ, dK, dV), dK/dV with k's KVH heads.
    Routed by ``attention_route``: at the kernels' head_dims (128 to 512)
    CUDA tensors
    compute delta = rowsum(dO·O) and launch the dK/dV kernel and the dQ
    kernel, CPU tensors run ``flash_bwd_plain``; a head_dim that is not a
    multiple of 128 runs ``flash_bwd_reference``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    device = _bwd_device("flash_bwd", q, k, v, out, lse, dout)
    if attention_route(q.shape[-1]) == "reference":
        return flash_bwd_reference(q, k, v, out, lse, dout, causal, scale)
    if device == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, dout, causal, scale)
    delta = _delta(out, dout)
    dout = dout.to(q.dtype)
    align = 16 // dout.element_size()
    if dout.stride(-1) != 1 or any(s % align for s in dout.stride()[:3]) \
            or dout.data_ptr() % 16:  # e.g. the expanded grad of a sum
        dout = dout.contiguous()
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


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
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention through the flash forward and backward, routed by
    head_dim (``attention_route``); k/v may have fewer heads than q
    (grouped-query attention)."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
