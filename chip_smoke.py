#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and builds the
kernels from ``ray_tpu_torch/ops/csrc`` with ``nvcc`` on first use.

1. Build every kernel and print the seconds taken.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (B1 H32 KVH8 D128 bf16, causal at the
   bucket widths 32..8192 and once non-causal; the f32 variant at two
   shapes), at the model's layout (q, k, v as transposes of [B, S, heads,
   D] views, which the TMA maps read through their strides), at the ragged
   lengths 100 and 8000 (TMA zero-fills past the end), at the MoE step's
   S4096 (both layouts), and at the bench configuration's B8 H16 KVH16
   S2048; the generic variants (f32 at head_dim 128 and 256, bf16 at 256)
   at B1 H8 KVH2 S2048 and the ragged S1000, causal and not, and at the
   shapes of their train-parity runs; time kernel, plain version, SDPA
   (the library yardstick, never called by the port) and the roofline
   bound. Then head_dim 64 on the card: ``flash_fwd`` and ``flash_bwd``
   route to the JAX package's jnp branch and launch no kernel.
3. Serve 8 concurrent requests on Llama-3-8B at full width and depth
   (random bf16 weights from a seed) through ``Engine``; check every
   stream, the kernel's launch count (one per layer per prefill) and the
   greedy tokens against a teacher-forced recomputation through the plain
   attention; measure TTFT, decode tokens/s at 1 and 8 streams, the host
   cost of a decode chunk, and peak memory.
4. Answer one completion through ``LLMServer`` at a small size.
5. Hold the two backward kernels (dK/dV and dQ) against their plain
   versions on the card at the training shapes (B1 H32 KVH8 D128 bf16,
   causal at S 64..8192, the ragged S 100 and 8000, once non-causal, at
   the train step's strided layout at S 2048 and at the MoE step's S 4096
   in both layouts; B8 H16 KVH16 S2048 as the bench configuration has
   it), and the generic variants as in phase 2, and time kernel, plain
   version, the SDPA backward (the library yardstick, never called by the
   port) and the bound.
6. Train parity: one loss-and-gradient pass of Llama-3-8B at full width
   with 2 layers at S 2048, through the kernels and through the plain
   attention forward and backward, on the same weights and tokens; in
   bf16 and in f32 compute, with 32 heads of 128 and with 16 heads of
   256 (8 KV heads), so that each kernel variant runs inside a model.
7. The training main path: ``make_train_fns`` on ``llama3_8b(n_layers=8)``
   (random f32 master weights from a seed), B1 x S8192, 2 warm-up and 5
   timed steps on one batch; the loss falls, each kernel is launched the
   expected number of times per step; step time, tokens/s, MFU, peak
   memory and a profiled step.
8. ``bench.py``'s training configuration (d_model 2048, 8 layers, H 16,
   ``dots_nobatch``) at B8 x S2048 for a few steps, built as ``bench.py``
   builds it: ``make_train_fns(cfg, ParallelContext.create(MeshConfig()))``
   (a world-1 NCCL group on the card), then the same steps with
   ``ctx=None``: the losses agree and the two rates give the context's
   cost.
9. The MoE train step: ``llama3_8b(n_experts=8, top_k_experts=2,
   n_layers=2)`` (Mixtral-8x7B's expert layer on the Llama-3-8B preset;
   depth cut 32 -> 2 to fit 16 bytes of state per parameter on one card)
   at B1 x S4096 through ``ParallelContext.create(MeshConfig())``: one
   full-width MoE layer through the kernels against the plain attention
   at S4096, the kernel run routed as the plain run chose (the tokens it
   would have routed otherwise are counted), the same loss and gradients
   with ``ctx=None`` and with the context, then 2 warm-up and 5 timed
   steps: exact launch counts 4/2/2 per step, a falling loss, a finite aux
   loss, the share of dropped assignments, step time, tokens/s, MFU (all
   experts and active experts), peak memory and a profiled step.
10. Checkpoints: ``bench.py``'s configuration through ``make_train_fns``,
   2 steps, an ``AsyncCheckpointer.save`` into a temporary directory, step
   3 while the write runs, then step 3 again from the state restored into
   a fresh ``init_fn`` state: the loss must be bitwise the same. The
   snapshot pause, write time, GB written, GB/s and the disk are printed,
   and the directory is deleted. Then ``LLMServer`` at phase 4's size
   from a checkpoint of parameters drawn from another seed than its own
   (``params_path``) must answer, through the flash kernel, as an engine
   on those parameters does, and not as phase 4 did.

Any mismatch raises and the script exits non-zero. The line before the last
is the kernels' JSON; the last is ``{"ok": true, "device": {...}}``.
Details go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --only-kernels

builds the kernels and runs phase 2 alone (a quick check after a kernel
edit), ``--only-bwd`` runs phase 5 alone in the same way, ``--only-moe``
phase 9, ``--only-ckpt`` phases 4 and 10, and ``--only-ttft N``
measures idle TTFT alone (N requests per prompt length; run it from
another tree's root to compare the two); none prints a result line.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (LlamaConfig, flops_per_token,
                                        forward, forward_with_aux,
                                        init_params, loss_fn, param_count)
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (attention_route, flash_bwd,
                                         flash_bwd_dkv, flash_bwd_dq,
                                         flash_bwd_plain, flash_bwd_plain_dkv,
                                         flash_bwd_plain_dq,
                                         flash_bwd_reference, flash_fwd,
                                         flash_fwd_plain, flash_fwd_reference,
                                         kernel_variant)
from ray_tpu_torch.ops import moe as moe_module
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.parallel import MeshConfig, ParallelContext
from ray_tpu_torch.serve.engine import Engine
from ray_tpu_torch.serve.llm import LLMConfig, LLMServer, _model_from_cfg
from ray_tpu_torch.train import (AsyncCheckpointer, make_train_fns,
                                 restore_checkpoint, save_checkpoint)

SEED = 0
# H100 SXM published dense peaks (NVIDIA data sheet, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Tolerances, kernel vs plain version on the same inputs. bf16 O: the two
# round the same f32 value to bf16 after different summation orders, so
# they may differ by one bf16 step (2**-6 for |O| < 4; O averages unit
# normal v). LSE and f32 O: f32 summation order and the kernel's fast exp.
ATOL_O_BF16 = 1.6e-2
ATOL_LSE = 1e-4
ATOL_F32 = 1e-5
ATTN_WIDTHS = (32, 64, 512, 2048, 8192)
BF16, F32 = torch.bfloat16, torch.float32
# (B, H, KVH, S, causal, dtype, layout) for the forward check. "dense" is
# contiguous BHSD; "model" gives q, k and v as the transposes of
# [B, S, heads, D] views (the layout of (h @ wv).view(B, S, KVH, hd)
# .transpose(1, 2) in models/llama.py and serve/engine.py).
FWD_CASES = [(1, 32, 8, S, True, BF16, "dense") for S in ATTN_WIDTHS] + [
    (1, 32, 8, 2048, False, BF16, "dense"),
    (1, 32, 8, 512, True, F32, "dense"),
    (1, 32, 8, 100, False, F32, "dense"),
    (1, 32, 8, 2048, True, BF16, "model"),
    (1, 32, 8, 4096, True, BF16, "dense"),
    (1, 32, 8, 4096, True, BF16, "model"),
    (1, 32, 8, 100, True, BF16, "dense"),
    (1, 32, 8, 8000, True, BF16, "dense"),
    (8, 16, 16, 2048, True, BF16, "dense")]
# The generic kernel variants (every dtype and head_dim but bf16 D128), in
# phases 2 and 5: at B1 H8 KVH2, S2048 and the ragged S1000, causal and not,
# and at the shape the train-parity path of their dtype and head_dim gives
# them (``PARITY_RUNS``: B1 H32 KVH8 D128, B1 H16 KVH8 D256, S2048 causal).
VARIANTS = (("f32_d128", 128, F32), ("f32_d256", 256, F32),
            ("bf16_d256", 256, BF16))
VARIANT_MAIN = {128: (1, 32, 8), 256: (1, 16, 8)}  # B, H, KVH
VARIANT_CASES = [(name, D, dt, 1, 8, 2, S, causal)
                 for name, D, dt in VARIANTS for S in (2048, 1000)
                 for causal in (True, False)] + [
    (name, D, dt, *VARIANT_MAIN[D], 2048, True) for name, D, dt in VARIANTS]
PROMPT_LENS = (17, 100, 300, 700, 1500, 3000, 5000, 8000)
SAMPLED = {1: dict(temperature=0.8, top_k=40, seed=1234),
           6: dict(temperature=1.0, top_k=0, seed=5678)}
MAX_TOKENS = 32
# Idle TTFT is a median over this many requests per prompt length: single
# 100-token requests spread from about 30 to 90 ms (host-bound).
TTFT_REPEATS = 7
# Engine tokens against a teacher-forced recomputation. The engine's decode
# (8-row matmuls, f32 attention over the bf16 cache) and the recomputation
# (8k-row matmuls, the plain flash arithmetic) round in bf16 at different
# places through 32 layers. With random weights the top logits of a
# 128k vocabulary lie a few hundredths of a row std apart, so near-ties
# swap: in two H100 runs 1 token in 7 to 10 was not the recomputed argmax,
# and none ranked below 4th. A token unrelated to the logits (wrong page,
# position or mask) ranks about 64k on average.
GREEDY_MAX_RANK = 8
GREEDY_ARGMAX_SHARE = 0.75
# Backward kernels vs their plain versions, max |kernel - plain| over max
# |plain| per output. Both round P and dS to bf16 at the same places; they
# differ where an f32 sum taken in another order (and the kernel's fast
# exp) flips a bf16 rounding, which moves an output by a few bf16 steps
# (2**-8 relative) at most. A wrong mask, tile or head mapping moves it by
# the order of the output itself.
REL_TOL_BWD = 2e-2
# The f32 variants round nothing: kernel and plain version differ by f32
# summation order and expf alone, about 1e-6 of the largest output at
# S2048; a wrong mask, tile or head mapping moves it by order 1.
REL_TOL_BWD_F32 = 1e-4
# (B, H, KVH, S, causal, layout) for the backward check; the main path's
# shape is B1 H32 KVH8 S8192 causal, the MoE step's S4096 in the model's
# layout. "model" gives q, k, v and dO as the
# transposes of [B, S, heads, D] views, as a train step can hand them to
# the backward (dO is the gradient of attn.transpose(1, 2).reshape(...)
# in models/llama.py); the TMA maps read them through their strides.
BWD_CASES = [(1, 32, 8, S, True, "dense") for S in (64, 512, 2048, 8192)] + [
    (1, 32, 8, 100, True, "dense"), (1, 32, 8, 8000, True, "dense"),
    (1, 32, 8, 2048, False, "dense"), (1, 32, 8, 2048, True, "model"),
    (1, 32, 8, 4096, True, "dense"), (1, 32, 8, 4096, True, "model"),
    (8, 16, 16, 2048, True, "dense")]
# Train parity, kernels vs the plain attention on the same weights and
# tokens, bf16 compute: the two attentions round to bf16 in other orders,
# and each layer's matmuls carry the difference on (a few bf16 steps,
# 2**-8 relative each). A wrong gradient kernel gives a relative error of
# order 1 in the attention weights' gradients.
PARITY_LOSS_RTOL = 1e-3
PARITY_GRAD_REL_L2 = 5e-2
# In f32 nothing rounds to bf16: the two attentions differ by f32
# summation order and expf (about 1e-6 relative), which the layers carry
# on at that size.
PARITY_F32_LOSS_RTOL = 1e-5
PARITY_F32_GRAD_REL_L2 = 1e-4
# The train-parity runs, one per kernel variant that a model at full width
# reaches (phase 6; label, llama3_8b overrides): bf16 at head_dim 128 (the
# main path's variant), Llama-3-8B's width with 16 heads of 256 (8 KV heads,
# groups of 2) in bf16 and in f32 compute, and the preset in f32 compute.
PARITY_RUNS = (("bf16_d128", dict(n_layers=2)),
               ("bf16_d256", dict(n_layers=2, n_heads=16)),
               ("f32_d128", dict(n_layers=2, dtype=F32)),
               ("f32_d256", dict(n_layers=2, n_heads=16, dtype=F32)))
PARITY_SEQ = 2048
TRAIN_SEQ = 8192
TRAIN_LAYERS = 8
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# bench.py:34-37, the repo's training benchmark configuration
BENCH_MODEL = dict(vocab_size=32000, d_model=2048, n_layers=8, n_heads=16,
                   n_kv_heads=16, d_ff=5504, max_seq=2048,
                   remat_policy="dots_nobatch")
BENCH_BATCH, BENCH_SEQ, BENCH_STEPS = 8, 2048, 3
# Phase 9: Mixtral-8x7B's expert layer (mistralai/Mixtral-8x7B-v0.1: 8
# experts of width 14336 at d_model 4096, top-2) on the Llama-3-8B preset,
# depth cut from 32 to 2 layers.
MOE_MODEL = dict(n_experts=8, top_k_experts=2, n_layers=2)
MOE_SEQ = 4096
MOE_WARMUP, MOE_STEPS = 2, 5
# moe_ffn's capacity factor, which the model's MoE layers take as it is
MOE_CAPACITY_FACTOR = inspect.signature(moe_ffn).parameters[
    "capacity_factor"].default
# The MoE layer parity: routing is discontinuous, so where the kernels and
# the plain attention round the layer's input differently a token can pick
# other experts, and its share of a gradient then moves by its own size.
# So the kernel run takes the experts the plain run chose (``_routing``):
# the two then differ by the attention's rounding alone, and phase 6's
# bounds hold. The tokens the kernel run would have routed otherwise are
# counted; a forward kernel that moved the layer's input by more than
# rounding would reroute most of them (more than MOE_FLIPS_MAX).
MOE_FLIPS_MAX = 0.01
# ctx=None and MeshConfig() run the same arithmetic; a sum in another order
# (an atomic add) would show as a few f32 ulps, far below these.
CTX_PARITY_LOSS_RTOL = 1e-6
CTX_PARITY_GRAD_REL_L2 = 1e-5
OUT_DIR = "chiprun_out"
# nvcc/ptxas lines worth printing: registers, shared memory, spills, and
# any warning (setmaxnreg ignored, wgmma serialized).
BUILD_REPORT = ("registers", "spill", "smem", "arning", "wgmma",
                "setmaxnreg")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def gpu_ms(fn, iters: int) -> float:
    """Device time per call: the calls queue up behind a sleep kernel, so
    the events time them back to back, without host launch gaps."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_bound(B, H, KVH, S, D, causal, elem, peak_flops):
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * D * pairs           # q k^T and p v
    nbytes = (2 * B * H * S * D + 2 * B * KVH * S * D) * elem + B * H * S * 4
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def _attn_input(B, heads, S, D, gen, dt, layout):
    if layout == "model":
        return torch.randn(B, S, heads, D, generator=gen, device="cuda").to(
            dt).transpose(1, 2)
    return torch.randn(B, heads, S, D, generator=gen, device="cuda").to(dt)


def _fwd_case(gen, card, B, H, KVH, S, causal, dt, layout, D=128):
    q = _attn_input(B, H, S, D, gen, dt, layout)
    k = _attn_input(B, KVH, S, D, gen, dt, layout)
    v = _attn_input(B, KVH, S, D, gen, dt, layout)
    scale = D ** -0.5
    o, lse = flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, scale)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    atol_o = ATOL_O_BF16 if dt == torch.bfloat16 else ATOL_F32
    atol_lse = ATOL_LSE if dt == torch.bfloat16 else ATOL_F32
    check(finite and err_o <= atol_o and err_lse <= atol_lse,
          f"flash_fwd B{B} H{H} KVH{KVH} S{S} D{D} causal={causal} {dt} "
          f"{layout}: |dO|={err_o} "
          f"(atol {atol_o}) |dLSE|={err_lse} (atol {atol_lse})")
    del o_ref, lse_ref
    iters = 20 if S <= 2048 else 5
    ms = gpu_ms(lambda: flash_fwd(q, k, v, causal), iters)
    plain_ms = gpu_ms(lambda: flash_fwd_plain(q, k, v, causal, scale),
                      max(2, iters // 4))
    lib_ms = gpu_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), iters)
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
    bound_ms, bound_by, flops, nbytes = attn_bound(
        B, H, KVH, S, D, causal, q.element_size(), peak)
    row = dict(shape=f"B{B} H{H} KVH{KVH} S{S} D{D}", causal=causal,
               dtype=str(dt).replace("torch.", ""), layout=layout,
               variant=kernel_variant(q), max_abs_err=err_o,
               lse_abs_err=err_lse, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               tflops=flops / ms / 1e9, card=card)
    log("KERNEL", json.dumps(row))
    del q, k, v
    torch.cuda.empty_cache()
    return row


def phase_kernels(card: str):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [_fwd_case(gen, card, B, H, KVH, S, causal, dt, layout)
            for B, H, KVH, S, causal, dt, layout in FWD_CASES]
    rows += [_fwd_case(gen, card, B, H, KVH, S, causal, dt, "dense", D)
             for _, D, dt, B, H, KVH, S, causal in VARIANT_CASES]
    return rows


def _launch_counts() -> tuple:
    return tuple((w.launches, dict(w.launches_by_variant))
                 for w in (flash_fwd, flash_bwd_dkv, flash_bwd_dq))


def _reset_launch_counts() -> None:
    for w in (flash_fwd, flash_bwd_dkv, flash_bwd_dq):
        w.launches = 0
        w.launches_by_variant.clear()


def phase_reference_route(card: str) -> dict:
    """head_dim 64 on the card: ``flash_fwd`` and ``flash_bwd`` route to the
    JAX package's jnp branch (``attention_route``), launch no kernel, and
    give what that branch gives when called itself."""
    check(attention_route(64) == "reference"
          and attention_route(256) == "kernel", "attention_route")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v, do = (_attn_input(1, h, 1000, 64, gen, BF16, "dense")
                   for h in (8, 2, 2, 8))
    counts0 = _launch_counts()
    calls0 = (flash_fwd_reference.calls, flash_bwd_reference.calls)
    o, lse = flash_fwd(q, k, v, True)
    grads = flash_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    calls = (flash_fwd_reference.calls - calls0[0],
             flash_bwd_reference.calls - calls0[1])
    check(_launch_counts() == counts0 and calls == (1, 1),
          f"head_dim 64: kernel launches {_launch_counts()} (before "
          f"{counts0}), reference-branch calls {calls}")
    o2, lse2 = flash_fwd_reference(q, k, v, True, 64 ** -0.5)
    same = torch.equal(o, o2) and torch.equal(lse, lse2) and all(
        torch.equal(a, b) for a, b in zip(grads, flash_bwd_reference(
            q, k, v, o, lse, do, True, 64 ** -0.5)))
    out = dict(shape="B1 H8 KVH2 S1000 D64 bf16 causal",
               route=attention_route(64), reference_calls=calls,
               kernel_launches_added=0, equal_to_branch=same, card=card)
    log("REFERENCE_ROUTE", json.dumps(out))
    check(same, "head_dim 64: flash_fwd/flash_bwd differ from the branch")
    return out


# ---------------------------------------------------------------------------
# phase 3: the serving engine on Llama-3-8B
# ---------------------------------------------------------------------------

def _drain(stream, times: list, toks: list) -> None:
    while True:
        item = stream.get(timeout=600)
        if item is None:
            return
        times.append((time.perf_counter(), len(item)))
        toks.extend(item)


def _run_concurrent(eng, jobs):
    """jobs: (ids, max_tokens, kwargs); all submitted at once from their
    own threads. Returns per job (t_submit, [(t, n)], tokens)."""
    res = [None] * len(jobs)
    barrier = threading.Barrier(len(jobs))

    def run(i):
        ids, n, kw = jobs[i]
        barrier.wait()
        t0 = time.perf_counter()
        times, toks = [], []
        _drain(eng.submit(ids, n, **kw), times, toks)
        res[i] = (t0, times, toks)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "engine streams hung")
    check(eng.error is None, f"engine error: {eng.error}")
    return res


def _decode_rate(res) -> float:
    """Tokens/s over the window where every stream is past its first token
    and none has ended."""
    t0 = max(times[0][0] for _, times, _ in res)
    t1 = min(times[-1][0] for _, times, _ in res)
    n = sum(c for _, times, _ in res for t, c in times if t0 < t <= t1)
    check(t1 > t0 and n > 0, "decode-rate window is empty")
    return n / (t1 - t0)


def _plain_attn(q, k, v, causal):
    return flash_fwd_plain(q, k, v, causal, q.shape[-1] ** -0.5)[0]


def phase_engine(card: str):
    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, SEED, device="cuda")
    eng = Engine(params, cfg, n_slots=8, decode_chunk=8, page_size=64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    log(f"ENGINE llama3_8b built in {setup_s:.2f} s: {eng.n_pages} pages of "
        f"{eng.page}, buckets {eng.buckets}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    jobs = [(p, MAX_TOKENS, SAMPLED.get(i, {})) for i, p in enumerate(prompts)]

    # -- the main path: 8 concurrent requests, counted kernel launches --
    _reset_launch_counts()
    t = time.perf_counter()
    res = _run_concurrent(eng, jobs)
    main_s = time.perf_counter() - t
    launches = flash_fwd.launches
    for i, (_, _, toks) in enumerate(res):
        check(len(toks) == MAX_TOKENS and all(
            0 <= x < cfg.vocab_size for x in toks),
            f"request {i} streamed {len(toks)} tokens")
    check(launches == cfg.n_layers * len(jobs),
          f"flash_fwd launched {launches} times, expected "
          f"{cfg.n_layers} per prefill x {len(jobs)}")
    ttft = [times[0][0] - t0 for t0, times, _ in res]
    log(f"ENGINE 8 concurrent requests ({sum(PROMPT_LENS)} prompt tokens) in "
        f"{main_s:.2f} s; flash_fwd launches {launches}; TTFT per request "
        f"(s): {[round(x, 3) for x in ttft]}")

    # -- greedy tokens against a teacher-forced plain-attention forward --
    # Rule (GREEDY_MAX_RANK, GREEDY_ARGMAX_SHARE): every emitted greedy
    # token ranks within the top 8 of the recomputed logits at its position,
    # and at least 3 in 4 are its argmax.
    ranks, gaps = [], []
    for i, (ids, _, kw) in enumerate(jobs):
        if kw:
            continue
        toks = res[i][2]
        seq = torch.tensor([ids + toks[:-1]], device="cuda")
        with torch.no_grad():
            logits = forward(eng.params, seq, cfg, attn_fn=_plain_attn)[0]
        rows = logits[len(ids) - 1:]
        del logits
        got = rows.gather(1, torch.tensor(toks, device="cuda")[:, None])
        ranks += (rows > got).sum(-1).tolist()
        gaps += ((rows.max(-1).values - got[:, 0])
                 / rows.std(-1)).tolist()
        del rows
        torch.cuda.empty_cache()
    argmax_share = ranks.count(0) / len(ranks)
    teacher = dict(tokens=len(ranks), argmax_share=argmax_share,
                   max_rank=max(ranks), top2_share=sum(
                       r < 2 for r in ranks) / len(ranks),
                   worst_gap_in_row_std=max(gaps))
    log(f"ENGINE greedy vs teacher-forced plain forward: {json.dumps(teacher)}")
    check(max(ranks) < GREEDY_MAX_RANK and argmax_share >= GREEDY_ARGMAX_SHARE,
          f"greedy tokens disagree with the recomputed logits: {teacher}, "
          f"ranks {ranks}")

    # -- TTFT on an idle engine, decode rate at 1 and 8 streams --
    ttft_idle_all = _ttft_idle(eng, cfg, rng, TTFT_REPEATS)
    ttft_idle = {n: statistics.median(v) for n, v in ttft_idle_all.items()}
    long_jobs = [(rng.integers(0, cfg.vocab_size, 128).tolist(), 129, {})
                 for _ in range(8)]
    rate1 = _decode_rate(_run_concurrent(eng, long_jobs[:1]))
    rate8 = _decode_rate(_run_concurrent(eng, long_jobs))
    log(f"ENGINE TTFT idle (s, median of {TTFT_REPEATS}): prompt 100 -> "
        f"{ttft_idle[100]:.4f}, prompt 2000 -> {ttft_idle[2000]:.4f}; "
        f"decode tok/s: 1 stream {rate1:.1f}, 8 streams {rate8:.1f}  [{card}]")
    log("ENGINE TTFT idle, every request (ms): " + json.dumps(
        {n: [round(x * 1e3, 1) for x in v] for n, v in ttft_idle_all.items()}))

    # -- one decode chunk under the profiler: host cost vs device time --
    eng.stop()
    chunk = _profile_chunk(eng)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"ENGINE decode chunk ({eng.chunk} steps x 8 slots): "
        f"{json.dumps(chunk)}; peak memory {peak_gb:.2f} GB  [{card}]")
    out = dict(setup_s=setup_s, main_s=main_s, launches=launches,
               ttft_concurrent_s=ttft, ttft_idle_s=ttft_idle,
               ttft_idle_all_s=ttft_idle_all,
               decode_tok_s_1=rate1, decode_tok_s_8=rate8,
               teacher=teacher,
               chunk=chunk, peak_mem_gb=peak_gb, card=card)
    del eng, params
    torch.cuda.empty_cache()
    return out


def _ttft_idle(eng, cfg, rng, repeats: int) -> dict:
    """{prompt length: [TTFT s of each request]}, one request at a time on
    an idle engine, for prompts of 100 and 2,000 tokens."""
    out = {}
    for n in (100, 2000):
        vals = []
        for _ in range(repeats):
            (t0, times, _), = _run_concurrent(
                eng, [(rng.integers(0, cfg.vocab_size, n).tolist(), 1, {})])
            vals.append(times[0][0] - t0)
        out[n] = vals
    return out


def phase_ttft_only(card: str, repeats: int):
    """Idle TTFT alone on Llama-3-8B, after one warm-up request per
    length: to compare two trees of the package with this script."""
    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    eng = Engine(init_params(cfg, SEED, device="cuda"), cfg, n_slots=8,
                 decode_chunk=8, page_size=64)
    rng = np.random.default_rng(SEED)
    try:
        _ttft_idle(eng, cfg, rng, 1)
        vals = _ttft_idle(eng, cfg, rng, repeats)
    finally:
        eng.stop()
    check(eng.error is None, f"engine error: {eng.error}")
    log("TTFT idle (ms): " + json.dumps(
        {n: dict(median=statistics.median(v) * 1e3,
                 all=[round(x * 1e3, 1) for x in v])
         for n, v in vals.items()}) + f"  [{card}]")


def _device_profile(run) -> dict:
    """Wall and host (enqueue) time of one ``run()`` after a warm call,
    then the same call under the profiler: device kernel time, op count,
    the device's idle share of the wall time, and the top 6 kernels."""
    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels, dev_us, by_name = 0, 0.0, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            us = ev.time_range.elapsed_us()
            dev_us += us
            by_name[ev.name[:60]] = by_name.get(ev.name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_s * 1e3, host_enqueue_ms=host_s * 1e3,
                device_kernel_ms=dev_us / 1e3, device_ops=kernels,
                device_idle_share=(1 - dev_us / 1e3 / (wall_s * 1e3))
                if dev_us else None,
                top_kernels_ms={name: us / 1e3 for name, us in top})


def _profile_chunk(eng) -> dict:
    """One decode chunk with all 8 slots active, run directly on the
    stopped engine: wall time, host (enqueue) time, device kernel time and
    launch count."""
    ns = eng.n_slots
    dev = eng.device
    bt = torch.zeros((ns, eng.maxp), dtype=torch.int64, device=dev)
    bt[:, :4] = torch.arange(1, 4 * ns + 1, device=dev).view(ns, 4)
    state = dict(
        bt=bt, active=torch.ones(ns, dtype=torch.bool, device=dev),
        temp=torch.zeros(ns, device=dev),
        topk=torch.zeros(ns, dtype=torch.int64, device=dev),
        seeds=torch.zeros(ns, dtype=torch.int64, device=dev))
    last = torch.ones(ns, dtype=torch.int64, device=dev)
    pos = torch.full((ns,), 100, dtype=torch.int64, device=dev)

    def run():
        return eng._decode(eng.params, eng._kc, eng._vc, state["bt"], last,
                           pos, state["active"], state["temp"],
                           state["topk"], state["seeds"])

    return _device_profile(run)


# ---------------------------------------------------------------------------
# phase 4: the in-process LLM server
# ---------------------------------------------------------------------------

LLM_SERVER = dict(vocab_size=32000, d_model=512, n_layers=2, max_seq=512,
                  max_ongoing_requests=4)
LLM_BODY = {"prompt": [1, 2, 3, 4, 5], "max_tokens": 8}


def phase_llm_server(params_path: str = ""):
    before = flash_fwd.launches
    server = LLMServer(LLMConfig(params_path=params_path, **LLM_SERVER))
    try:
        resp = server.complete(dict(LLM_BODY))
    finally:
        server.stop()
    text = resp["choices"][0]["text"]
    check(resp["object"] == "text_completion" and len(text.split()) == 8,
          f"LLMServer.complete gave {resp}")
    check(flash_fwd.launches - before == 2, "LLMServer prefill missed the "
          "flash_fwd kernel")
    log(f"LLMSERVER {json.dumps(resp)}")
    return resp


# ---------------------------------------------------------------------------
# phase 5: the backward kernels against their plain versions
# ---------------------------------------------------------------------------

def bwd_bounds(B, H, KVH, S, causal, D=128, elem=2, peak=PEAK_BF16_FLOPS):
    """{kernel: (bound ms, bound by, FLOP, operations ms, bytes ms)} from
    each kernel's own work: dK/dV does 4 products (8 B H D pairs FLOP), dQ
    3 (6 B H D pairs); bytes are each input read once and each output
    written once."""
    pairs = S * (S + 1) // 2 if causal else S * S
    q_bytes, kv_bytes, row_bytes = B * H * S * D * elem, \
        B * KVH * S * D * elem, B * H * S * 4
    inputs = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes  # q dO k v lse delta
    out = {}
    for name, flops, nbytes in (
            ("flash_bwd_dkv", 8.0 * B * H * D * pairs, inputs + 2 * kv_bytes),
            ("flash_bwd_dq", 6.0 * B * H * D * pairs, inputs + q_bytes)):
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     t_ops * 1e3, t_bytes * 1e3)
    return out


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _bwd_case(gen, card, B, H, KVH, S, causal, layout, D=128, dt=BF16):
    q, k, v, do = (_attn_input(B, h, S, D, gen, dt, layout)
                   for h in (H, KVH, KVH, H))
    scale = D ** -0.5
    o, lse = flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(*args)
    dq = flash_bwd_dq(*args)
    torch.cuda.synchronize()
    pk, pv = flash_bwd_plain_dkv(*args)
    err = dict(dk=_rel_err(dk, pk), dv=_rel_err(dv, pv))
    abs_dkv = max((dk.float() - pk.float()).abs().max().item(),
                  (dv.float() - pv.float()).abs().max().item())
    del pk, pv
    pq = flash_bwd_plain_dq(*args)
    err["dq"] = _rel_err(dq, pq)
    abs_dq = (dq.float() - pq.float()).abs().max().item()
    del pq
    finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    tol = REL_TOL_BWD if dt == BF16 else REL_TOL_BWD_F32
    check(finite and max(err.values()) <= tol,
          f"flash backward B{B} H{H} KVH{KVH} S{S} D{D} causal={causal} "
          f"{dt} {layout}: relative max errors {err} (bound {tol})")
    torch.cuda.empty_cache()
    iters = 20 if S <= 2048 else 5
    ms = dict(flash_bwd_dkv=gpu_ms(lambda: flash_bwd_dkv(*args), iters),
              flash_bwd_dq=gpu_ms(lambda: flash_bwd_dq(*args), iters))
    plain_ms = dict(
        flash_bwd_dkv=gpu_ms(lambda: flash_bwd_plain_dkv(*args), 2),
        flash_bwd_dq=gpu_ms(lambda: flash_bwd_plain_dq(*args), 2))
    torch.cuda.empty_cache()
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                        enable_gqa=True)
    lib_ms = gpu_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), do, retain_graph=True), iters)
    del ql, kl, vl, ol
    bounds = bwd_bounds(B, H, KVH, S, causal, D, q.element_size(),
                        PEAK_BF16_FLOPS if dt == BF16 else PEAK_F32_FLOPS)
    row = dict(shape=f"B{B} H{H} KVH{KVH} S{S} D{D}", causal=causal,
               dtype=str(dt).replace("torch.", ""), layout=layout,
               variant=kernel_variant(q),
               rel_err=err, abs_err=dict(flash_bwd_dkv=abs_dkv,
                                         flash_bwd_dq=abs_dq),
               ms=ms, plain_ms=plain_ms, sdpa_bwd_ms=lib_ms,
               bound_ms={n: b[0] for n, b in bounds.items()},
               bound_by={n: b[1] for n, b in bounds.items()},
               ops_bound_ms={n: b[3] for n, b in bounds.items()},
               bytes_bound_ms={n: b[4] for n, b in bounds.items()},
               tflops={n: bounds[n][2] / ms[n] / 1e9 for n in ms},
               card=card)
    log("BWD", json.dumps(row))
    del q, k, v, do, o, lse, delta, dq, dk, dv, args
    torch.cuda.empty_cache()
    return row


def phase_bwd_kernels(card: str):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = [_bwd_case(gen, card, B, H, KVH, S, causal, layout)
            for B, H, KVH, S, causal, layout in BWD_CASES]
    rows += [_bwd_case(gen, card, B, H, KVH, S, causal, "dense", D, dt)
             for _, D, dt, B, H, KVH, S, causal in VARIANT_CASES]
    return rows


# ---------------------------------------------------------------------------
# phases 6-8: training
# ---------------------------------------------------------------------------

class _PlainAttention(torch.autograd.Function):
    """The flash forward and backward through their plain versions only:
    the reference of the train-parity check."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        scale = q.shape[-1] ** -0.5
        out, lse = flash_fwd_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_plain(q, k, v, out, lse, dout, ctx.causal,
                                     ctx.scale)
        return dq, dk, dv, None


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def _tokens(cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))
                            ).to("cuda")


def _train_parity(card: str, variant: str, overrides: dict) -> dict:
    """One loss-and-gradient pass through the kernels and through the plain
    attention, same weights and tokens; every launch of the kernel run is
    of ``variant``, one forward per layer (and one in the recompute), one
    dK/dV and one dQ per layer."""
    cfg = LlamaConfig.llama3_8b(**overrides)
    params = init_params(cfg, SEED, device="cuda")
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tokens = _tokens(cfg, 1, PARITY_SEQ, SEED)
    results = {}
    for name, attn in (("kernels", None), ("plain", _PlainAttention.apply)):
        kw = {} if attn is None else dict(attn_fn=attn)
        _reset_launch_counts()
        loss, _ = loss_fn(params, tokens, cfg, **kw)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        results[name] = (loss.detach(), grads, _launch_counts())
        del loss
    lk, gk, ck = results["kernels"]
    lp, gp, cp = results["plain"]
    L = cfg.n_layers
    want = tuple((n, {variant: n}) for n in (2 * L, L, L))
    check(ck == want and cp == ((0, {}),) * 3,
          f"parity {variant} launch counts: kernels {ck} (expected {want}), "
          f"plain {cp}")
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    grad_rel = {key: (torch.linalg.vector_norm(a.float() - b.float())
                      / torch.linalg.vector_norm(b.float())).item()
                for key, a, b in zip(leaves, gk, gp)}
    bf16 = cfg.dtype == BF16
    loss_tol = PARITY_LOSS_RTOL if bf16 else PARITY_F32_LOSS_RTOL
    grad_tol = PARITY_GRAD_REL_L2 if bf16 else PARITY_F32_GRAD_REL_L2
    out = dict(shape=f"llama3_8b {overrides} B1 S{PARITY_SEQ} "
               f"(H{cfg.n_heads} KVH{cfg.n_kv_heads} D{cfg.head_dim})",
               variant=variant, loss_kernels=lk.item(), loss_plain=lp.item(),
               loss_rel=loss_rel, grad_rel_l2=grad_rel,
               launches={n: c[0] for n, c in zip(
                   ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"), ck)},
               card=card)
    log("TRAIN_PARITY", json.dumps(out))
    check(np.isfinite(lk.item()) and loss_rel <= loss_tol
          and max(grad_rel.values()) <= grad_tol,
          f"train parity {variant}: loss rel {loss_rel} (bound {loss_tol}), "
          f"grad rel L2 {grad_rel} (bound {grad_tol})")
    del params, leaves, results, gk, gp
    torch.cuda.empty_cache()
    return out


def phase_train_parity(card: str) -> dict:
    return {variant: _train_parity(card, variant, overrides)
            for variant, overrides in PARITY_RUNS}


def _active_flops_per_token(cfg, seq) -> float:
    """``flops_per_token`` with only the top-k experts of each MoE layer
    counted (the parameters a token passes through)."""
    idle = cfg.n_experts - cfg.top_k_experts
    n = (param_count(cfg) - cfg.vocab_size * cfg.d_model
         - cfg.n_layers * idle * 3 * cfg.d_model * cfg.d_ff)
    return 6.0 * n + 12 * cfg.n_layers * cfg.d_model * seq


@contextlib.contextmanager
def _routing(force=None):
    """Yields the experts every ``moe_ffn`` call inside the block chose, in
    call order (idx [tokens, k] each). With ``force`` (the idx of one
    layer's tokens) each call takes those experts instead of its own
    top-k, their weights still softmaxed from its own logits, so that two
    runs whose layer inputs round differently route alike; what a call
    would have chosen is still what is yielded."""
    seen = []
    top_k = moe_module.top_k_routing

    def route(logits, k):
        weights, idx = top_k(logits, k)
        seen.append(idx)
        if force is None:
            return weights, idx
        return torch.softmax(logits.gather(-1, force).float(), -1), force

    moe_module.top_k_routing = route
    try:
        yield seen
    finally:
        moe_module.top_k_routing = top_k


def _moe_probe(params, tokens, cfg, ctx) -> dict:
    """One forward without gradients: the aux loss and the share of
    dropped expert assignments, from the experts each layer chose (an
    expert keeps the first ``capacity`` of its assignments, token by
    token, over the whole batch on one card)."""
    with torch.no_grad(), _routing() as seen:
        _, aux = forward_with_aux(params, tokens, cfg, ctx)
    check(len(seen) == cfg.n_layers, f"{len(seen)} MoE layers ran")
    n = tokens.numel() * cfg.top_k_experts
    capacity = max(1, math.ceil(n * MOE_CAPACITY_FACTOR / cfg.n_experts))
    dropped = [(torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
                - capacity).clamp(min=0).sum().item() / n for idx in seen]
    return dict(aux=aux.item(), dropped_share=sum(dropped) / len(dropped),
                dropped_per_layer=dropped)


def _train_run(cfg, batch, seq, warmup, steps, card, label, profile,
               ctx=None):
    """make_train_fns on ``cfg`` (under ``ctx`` when given): warm-up and
    timed steps on one batch with the launch counters read around them;
    the loss must fall."""
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn = make_train_fns(cfg, ctx)
    state = init_fn(SEED)
    tokens = _tokens(cfg, batch, seq, SEED + 2)
    if cfg.n_experts:
        at_init = _moe_probe(state["params"], tokens, cfg, ctx)
    losses = []
    _reset_launch_counts()
    for _ in range(warmup):
        state, m = step_fn(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / steps
    n = warmup + steps
    launches = dict(flash_fwd=flash_fwd.launches,
                    flash_bwd_dkv=flash_bwd_dkv.launches,
                    flash_bwd_dq=flash_bwd_dq.launches)
    L = cfg.n_layers
    want = dict(flash_fwd=2 * L * n, flash_bwd_dkv=L * n, flash_bwd_dq=L * n)
    losses = [x.item() for x in losses]
    check(launches == want, f"{label}: launches {launches} in {n} steps, "
          f"expected {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: loss did not fall: {losses}")
    tok_s = batch * seq / step_s
    mfu = flops_per_token(cfg, seq) * tok_s / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    free_gb, total_gb = (x / 1e9 for x in torch.cuda.mem_get_info())
    out = dict(config=label, batch=batch, seq=seq, layers=L,
               remat_policy=cfg.remat_policy,
               parallel_context=None if ctx is None else str(ctx.config),
               losses=losses,
               grad_norm=m["grad_norm"].item(), step_s=step_s,
               tokens_per_s=tok_s, mfu=mfu, peak_mem_gb=peak_gb,
               card_total_gb=total_gb, free_after_gb=free_gb,
               launches=launches, launches_per_step={
                   k: v / n for k, v in launches.items()}, card=card)
    if cfg.n_experts:
        out["mfu_active"] = (_active_flops_per_token(cfg, seq) * tok_s
                             / PEAK_BF16_FLOPS)
        out["at_init"] = at_init
        out.update(_moe_probe(state["params"], tokens, cfg, ctx))
        check(np.isfinite(out["aux"]) and np.isfinite(at_init["aux"]),
              f"{label}: aux loss {at_init['aux']} -> {out['aux']}")
    if profile:
        out["profile"] = _device_profile(lambda: step_fn(state, tokens))
    log("TRAIN", json.dumps(out))
    del state, tokens, m
    torch.cuda.empty_cache()
    return out


def phase_train_main(card: str):
    return _train_run(LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS), 1,
                      TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS, card,
                      f"llama3_8b n_layers={TRAIN_LAYERS}", profile=True)


def phase_train_bench(card: str):
    """bench.py's configuration as bench.py builds it, through the
    context; then the same steps without it, whose losses must agree."""
    cfg = LlamaConfig(**BENCH_MODEL)
    out = _train_run(cfg, BENCH_BATCH, BENCH_SEQ, 1, BENCH_STEPS, card,
                     "bench.py d2048 L8 H16", profile=False,
                     ctx=ParallelContext.create(MeshConfig()))
    plain = _train_run(cfg, BENCH_BATCH, BENCH_SEQ, 1, BENCH_STEPS, card,
                       "bench.py d2048 L8 H16, ctx=None", profile=False)
    out["no_ctx"] = {k: plain[k] for k in ("step_s", "tokens_per_s",
                                           "losses")}
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(out["losses"], plain["losses"]))
    log(f"TRAIN bench.py configuration: {out['tokens_per_s']:.0f} tok/s "
        f"through ParallelContext(MeshConfig()), {plain['tokens_per_s']:.0f}"
        f" tok/s with ctx=None (ratio "
        f"{out['tokens_per_s'] / plain['tokens_per_s']:.4f}); losses' "
        f"largest relative difference {loss_rel}  [{card}]")
    check(loss_rel <= CTX_PARITY_LOSS_RTOL,
          f"bench.py configuration: losses {out['losses']} through the "
          f"context, {plain['losses']} without")
    return out


# ---------------------------------------------------------------------------
# phase 9: the MoE family
# ---------------------------------------------------------------------------

def _loss_and_grads(params, tokens, cfg, ctx=None, attn_fn=None):
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    kw = {} if attn_fn is None else dict(attn_fn=attn_fn)
    loss, _ = loss_fn(params, tokens, cfg, ctx, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _grad_rel(a: dict, b: dict) -> dict:
    return {k: (torch.linalg.vector_norm(a[k].float() - b[k].float())
                / torch.linalg.vector_norm(b[k].float())).item() for k in b}


def phase_moe(card: str):
    # -- one full-width MoE layer: kernels against the plain attention --
    cfg1 = LlamaConfig.llama3_8b(**dict(MOE_MODEL, n_layers=1))
    params = init_params(cfg1, SEED, device="cuda")
    tokens = _tokens(cfg1, 1, MOE_SEQ, SEED)
    with _routing() as seen:
        lp, gp = _loss_and_grads(params, tokens, cfg1,
                                 attn_fn=_PlainAttention.apply)
    chosen = seen[0]
    counts0 = (flash_fwd.launches, flash_bwd_dkv.launches,
               flash_bwd_dq.launches)
    with _routing(force=chosen) as seen:
        lk, gk = _loss_and_grads(params, tokens, cfg1)
    torch.cuda.synchronize()
    counts = (flash_fwd.launches - counts0[0],
              flash_bwd_dkv.launches - counts0[1],
              flash_bwd_dq.launches - counts0[2])
    flips = (seen[0].sort(-1).values != chosen.sort(-1).values).any(
        -1).sum().item()
    n = chosen.shape[0]
    layer = dict(shape=f"llama3_8b moe8 top2 n_layers=1 B1 S{MOE_SEQ}",
                 loss_kernels=lk.item(), loss_plain=lp.item(),
                 loss_rel=abs(lk.item() - lp.item()) / abs(lp.item()),
                 grad_rel_l2=_grad_rel(gk, gp),
                 tokens_routed_differently=flips, tokens=n,
                 launches=counts, card=card)
    log("MOE_LAYER_PARITY", json.dumps(layer))
    check(counts == (2, 1, 1), f"MoE layer parity launch counts {counts}")
    check(np.isfinite(layer["loss_kernels"])
          and layer["loss_rel"] <= PARITY_LOSS_RTOL
          and flips <= MOE_FLIPS_MAX * n
          and max(layer["grad_rel_l2"].values()) <= PARITY_GRAD_REL_L2,
          f"MoE layer parity: {layer} (bounds: loss {PARITY_LOSS_RTOL}, "
          f"grad {PARITY_GRAD_REL_L2}, rerouted {MOE_FLIPS_MAX * n})")
    del params, gk, gp, seen, chosen
    torch.cuda.empty_cache()

    # -- the same loss and gradients with ctx=None and MeshConfig() --
    cfg = LlamaConfig.llama3_8b(**MOE_MODEL)
    ctx = ParallelContext.create(MeshConfig())
    params = init_params(cfg, SEED, device="cuda")
    tokens = _tokens(cfg, 1, MOE_SEQ, SEED + 2)
    l0, g0 = _loss_and_grads(params, tokens, cfg)
    l1, g1 = _loss_and_grads(params, tokens, cfg, ctx)
    ctx_parity = dict(loss_none=l0.item(), loss_ctx=l1.item(),
                      loss_rel=abs(l0.item() - l1.item()) / abs(l0.item()),
                      grad_rel_l2=_grad_rel(g1, g0),
                      bitwise=bool(torch.equal(l0, l1)) and all(
                          torch.equal(g0[k], g1[k]) for k in g0))
    log("MOE_CTX_PARITY", json.dumps(ctx_parity))
    check(ctx_parity["loss_rel"] <= CTX_PARITY_LOSS_RTOL
          and max(ctx_parity["grad_rel_l2"].values())
          <= CTX_PARITY_GRAD_REL_L2, f"ctx=None vs MeshConfig(): {ctx_parity}")
    del params, g0, g1
    torch.cuda.empty_cache()

    # -- the main path: make_train_fns through the context --
    train = _train_run(cfg, 1, MOE_SEQ, MOE_WARMUP, MOE_STEPS, card,
                       "llama3_8b moe8 top2 n_layers=2", profile=True,
                       ctx=ctx)
    return dict(layer_parity=layer, ctx_parity=ctx_parity, train=train)


# ---------------------------------------------------------------------------
# phase 10: checkpoints
# ---------------------------------------------------------------------------

def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _greedy_tokens(params, mcfg: LlamaConfig, scfg: LLMConfig) -> list:
    """LLM_BODY's greedy completion from an ``Engine`` built on ``params``
    as ``LLMServer`` builds its own."""
    eng = Engine(params, mcfg, n_slots=scfg.max_ongoing_requests,
                 decode_chunk=scfg.decode_chunk, page_size=scfg.page_size,
                 n_pages=scfg.kv_pages, device=scfg.device)
    try:
        stream = eng.submit(LLM_BODY["prompt"], LLM_BODY["max_tokens"],
                            temperature=0.0, top_k=0, seed=0)
        toks = []
        while (chunk := stream.get()) is not None:
            toks += [int(t) for t in chunk]
        return toks
    finally:
        eng.stop()


def phase_checkpoint(card: str, server_resp: dict) -> dict:
    """bench.py's configuration through ``make_train_fns``: 2 steps, an
    ``AsyncCheckpointer.save`` (the pause is the device->host snapshot),
    step 3 while the write runs, then the state restored into a fresh
    ``init_fn`` state takes step 3 again: its loss must be bitwise the
    uninterrupted step 3's (step 3 updates the state in place, so this also
    shows the snapshot is a copy). Then ``LLMServer`` at phase 4's size
    from a checkpoint of parameters drawn from another seed than its own
    (``params_path``) must give, through the flash kernel, the completion of
    an engine on those parameters, and not phase 4's."""
    cfg = LlamaConfig(**BENCH_MODEL)
    init_fn, step_fn = make_train_fns(cfg)
    tokens = _tokens(cfg, BENCH_BATCH, BENCH_SEQ, SEED + 4)
    state = init_fn(SEED)
    for _ in range(2):
        state, _ = step_fn(state, tokens)
    torch.cuda.synchronize()
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckptr = AsyncCheckpointer()
    try:
        t0 = time.perf_counter()
        fut = ckptr.save(directory, state, step=2)
        t1 = time.perf_counter()
        done = []
        fut.add_done_callback(lambda _: done.append(time.perf_counter()))
        state, m3 = step_fn(state, tokens)
        _, m4 = step_fn(state, tokens)
        loss3, loss4 = m3["loss"].clone(), m4["loss"].clone()
        torch.cuda.synchronize()
        ckpt = ckptr.wait()
        write_s = done[0] - t1
        nbytes = _dir_bytes(ckpt.path)
        disk = shutil.disk_usage(directory)
        del state, m3, m4
        torch.cuda.empty_cache()
        t = time.perf_counter()
        fresh = init_fn(SEED + 7)
        restored = restore_checkpoint(ckpt, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        del fresh
        restored, r3 = step_fn(restored, tokens)
        _, r4 = step_fn(restored, tokens)
        torch.cuda.synchronize()
        out = dict(config="bench.py d2048 L8 H16 B8 S2048",
                   params=param_count(cfg),
                   snapshot_pause_ms=(t1 - t0) * 1e3, write_s=write_s,
                   gb_written=nbytes / 1e9, write_gb_s=nbytes / 1e9 / write_s,
                   restore_s=restore_s, files=len(os.listdir(ckpt.path)),
                   disk_total_gb=disk.total / 1e9,
                   disk_free_gb=disk.free / 1e9,
                   loss3=loss3.item(), loss3_resumed=r3["loss"].item(),
                   loss3_bitwise=bool(torch.equal(loss3, r3["loss"])),
                   loss4=loss4.item(), loss4_resumed=r4["loss"].item(),
                   loss4_bitwise=bool(torch.equal(loss4, r4["loss"])),
                   card=card)
        del restored, r3, r4
        torch.cuda.empty_cache()
        log("CHECKPOINT", json.dumps(out))
        check(out["loss3_bitwise"], f"resumed step 3 loss {out['loss3_resumed']}"
              f" differs from the uninterrupted {out['loss3']}")

        # -- the server from a checkpoint of parameters of another seed --
        scfg = LLMConfig(device="cuda", **LLM_SERVER)
        mcfg, params = _model_from_cfg(scfg)
        params = init_params(mcfg, SEED + 9, device="cuda")
        served = save_checkpoint(os.path.join(directory, "server"), params,
                                 step=0)
        want = _greedy_tokens(params, mcfg, scfg)
        del params
        resp = phase_llm_server(served.path)
        got = [int(t) for t in resp["choices"][0]["text"].split()]
        check(got == want, f"LLMServer from params_path gave {got}; an "
              f"engine on the saved parameters {want}")
        check(resp != server_resp, f"LLMServer from params_path answered as "
              f"phase 4's seed-0 server: {resp}")
        out["server_from_params_path"] = resp
        return out
    finally:
        ckptr.close()
        shutil.rmtree(directory, ignore_errors=True)


def _variant_entries(rows, bwd_rows, parity) -> list:
    """The kernels line's entries of the generic variants: launches from
    their train-parity run (the path that reaches them), times at that
    run's shape (``VARIANT_MAIN``, S2048 causal), errors over every case."""
    out = []
    for variant, D, dt in VARIANTS:
        B, H, KVH = VARIANT_MAIN[D]
        shape = f"B{B} H{H} KVH{KVH} S2048 D{D}"
        fwd = next(r for r in rows if r["shape"] == shape and r["causal"]
                   and r["variant"] == variant)
        bwd = next(r for r in bwd_rows if r["shape"] == shape
                   and r["causal"] and r["variant"] == variant)
        label = f"{shape} causal {variant.split('_')[0]}"
        out.append(dict(
            name=f"flash_fwd.{variant}", route="cuda",
            source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
            replaces="ray_tpu/ops/attention.py:140",
            launches=parity[variant]["launches"]["flash_fwd"],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["variant"] == variant),
            ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
            bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
            shape=label))
        for name, src, line in (("flash_bwd_dkv", "flash_bwd_dkv.cu", 326),
                                ("flash_bwd_dq", "flash_bwd_dq.cu", 356)):
            out.append(dict(
                name=f"{name}.{variant}", route="cuda",
                source=f"ray_tpu_torch/ops/csrc/{src}",
                replaces=f"ray_tpu/ops/attention.py:{line}",
                launches=parity[variant]["launches"][name],
                max_abs_err=max(r["abs_err"][name] for r in bwd_rows
                                if r["variant"] == variant),
                ms=bwd["ms"][name], plain_ms=bwd["plain_ms"][name],
                bound_ms=bwd["bound_ms"][name],
                bound_by=bwd["bound_by"][name],
                library_ms=bwd["sdpa_bwd_ms"], shape=label))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="build the kernels and run phase 2 only")
    ap.add_argument("--only-bwd", action="store_true",
                    help="build the kernels and run phase 5 only")
    ap.add_argument("--only-ttft", type=int, default=0, metavar="N",
                    help="build the kernels and measure idle TTFT only, N "
                    "requests per prompt length")
    ap.add_argument("--only-moe", action="store_true",
                    help="build the kernels and run phase 9 only")
    ap.add_argument("--only-ckpt", action="store_true",
                    help="build the kernels and run phases 4 and 10 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 compares in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"CARD {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t
    log(f"BUILD {_build.sources()} in {build_s:.2f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in BUILD_REPORT):
                log(f"BUILD {name}: {line.strip()}")

    if args.only_ttft:
        phase_ttft_only(card, args.only_ttft)
        return 0
    if args.only_bwd:
        phase_bwd_kernels(card)
        return 0
    if args.only_moe:
        phase_moe(card)
        return 0
    if args.only_ckpt:
        phase_checkpoint(card, phase_llm_server())
        return 0
    rows = phase_kernels(card)
    route = phase_reference_route(card)
    if args.only_kernels:
        return 0
    engine = phase_engine(card)
    server = phase_llm_server()
    bwd_rows = phase_bwd_kernels(card)
    parity = phase_train_parity(card)
    train = phase_train_main(card)
    bench = phase_train_bench(card)
    moe = phase_moe(card)
    ckpt = phase_checkpoint(card, server)

    main_row = next(r for r in rows if r["shape"] == "B1 H32 KVH8 S8192 D128"
                    and r["causal"] and r["layout"] == "dense")
    kernels = [dict(
        name="flash_fwd", route="cuda",
        source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/attention.py:140", launches=engine["launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        shape=main_row["shape"] + " causal bf16",
        launches_train=train["launches"]["flash_fwd"],
        launches_moe_train=moe["train"]["launches"]["flash_fwd"])]
    bwd_main = next(r for r in bwd_rows
                    if r["shape"] == "B1 H32 KVH8 S8192 D128" and r["causal"]
                    and r["layout"] == "dense")
    for name, src, line in (("flash_bwd_dkv", "flash_bwd_dkv.cu", 326),
                            ("flash_bwd_dq", "flash_bwd_dq.cu", 356)):
        kernels.append(dict(
            name=name, route="cuda", source=f"ray_tpu_torch/ops/csrc/{src}",
            replaces=f"ray_tpu/ops/attention.py:{line}",
            launches=train["launches"][name],
            max_abs_err=max(r["abs_err"][name] for r in bwd_rows),
            ms=bwd_main["ms"][name], plain_ms=bwd_main["plain_ms"][name],
            bound_ms=bwd_main["bound_ms"][name],
            bound_by=bwd_main["bound_by"][name],
            library_ms=bwd_main["sdpa_bwd_ms"],
            shape=bwd_main["shape"] + " causal bf16",
            launches_moe_train=moe["train"]["launches"][name]))
    kernels += _variant_entries(rows, bwd_rows, parity)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, kernel_rows=rows,
                       engine=engine, bwd_rows=bwd_rows, train_parity=parity,
                       train=train, train_bench=bench, moe=moe,
                       reference_route=route, checkpoint=ckpt,
                       kernels=kernels), f,
                  indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if dist.is_initialized():  # the world-1 group of phases 8 and 9
            dist.destroy_process_group()
    sys.exit(rc)
