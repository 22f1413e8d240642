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
   shapes), and time kernel, plain version, SDPA (the library yardstick,
   never called by the port) and the roofline bound.
3. Serve 8 concurrent requests on Llama-3-8B at full width and depth
   (random bf16 weights from a seed) through ``Engine``; check every
   stream, the kernel's launch count (one per layer per prefill) and the
   greedy tokens against a teacher-forced recomputation through the plain
   attention; measure TTFT, decode tokens/s at 1 and 8 streams, the host
   cost of a decode chunk, and peak memory.
4. Answer one completion through ``LLMServer`` at a small size.

Any mismatch raises and the script exits non-zero. The line before the last
is the kernels' JSON; the last is ``{"ok": true, "device": {...}}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import LlamaConfig, forward, init_params
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import flash_fwd, flash_fwd_plain
from ray_tpu_torch.serve.engine import Engine
from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

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
PROMPT_LENS = (17, 100, 300, 700, 1500, 3000, 5000, 8000)
SAMPLED = {1: dict(temperature=0.8, top_k=40, seed=1234),
           6: dict(temperature=1.0, top_k=0, seed=5678)}
MAX_TOKENS = 32
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
OUT_DIR = "chiprun_out"


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

def phase_kernels(card: str):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    cases = [(S, True, torch.bfloat16) for S in ATTN_WIDTHS]
    cases += [(2048, False, torch.bfloat16), (512, True, torch.float32),
              (100, False, torch.float32)]
    for S, causal, dt in cases:
        B, H, KVH, D = 1, 32, 8, 128
        q = torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, KVH, S, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, KVH, S, D, generator=gen, device="cuda").to(dt)
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
              f"flash_fwd S={S} causal={causal} {dt}: |dO|={err_o} "
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
                   dtype=str(dt).replace("torch.", ""), max_abs_err=err_o,
                   lse_abs_err=err_lse, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9, card=card)
        rows.append(row)
        log("KERNEL", json.dumps(row))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


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
    flash_fwd.launches = 0
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
    ttft_idle = {}
    for n in (100, 2000):
        vals = []
        for r in range(3):
            (t0, times, _), = _run_concurrent(
                eng, [(rng.integers(0, cfg.vocab_size, n).tolist(), 1, {})])
            vals.append(times[0][0] - t0)
        ttft_idle[n] = statistics.median(vals)
    long_jobs = [(rng.integers(0, cfg.vocab_size, 128).tolist(), 129, {})
                 for _ in range(8)]
    rate1 = _decode_rate(_run_concurrent(eng, long_jobs[:1]))
    rate8 = _decode_rate(_run_concurrent(eng, long_jobs))
    log(f"ENGINE TTFT idle (s, median of 3): prompt 100 -> "
        f"{ttft_idle[100]:.4f}, prompt 2000 -> {ttft_idle[2000]:.4f}; "
        f"decode tok/s: 1 stream {rate1:.1f}, 8 streams {rate8:.1f}  [{card}]")

    # -- one decode chunk under the profiler: host cost vs device time --
    eng.stop()
    chunk = _profile_chunk(eng)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"ENGINE decode chunk ({eng.chunk} steps x 8 slots): "
        f"{json.dumps(chunk)}; peak memory {peak_gb:.2f} GB  [{card}]")
    out = dict(setup_s=setup_s, main_s=main_s, launches=launches,
               ttft_concurrent_s=ttft, ttft_idle_s=ttft_idle,
               decode_tok_s_1=rate1, decode_tok_s_8=rate8,
               teacher=teacher,
               chunk=chunk, peak_mem_gb=peak_gb, card=card)
    del eng, params
    torch.cuda.empty_cache()
    return out


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


# ---------------------------------------------------------------------------
# phase 4: the in-process LLM server
# ---------------------------------------------------------------------------

def phase_llm_server():
    before = flash_fwd.launches
    server = LLMServer(LLMConfig(vocab_size=32000, d_model=512, n_layers=2,
                                 max_seq=512, max_ongoing_requests=4))
    try:
        resp = server.complete({"prompt": [1, 2, 3, 4, 5], "max_tokens": 8})
    finally:
        server.stop()
    text = resp["choices"][0]["text"]
    check(resp["object"] == "text_completion" and len(text.split()) == 8,
          f"LLMServer.complete gave {resp}")
    check(flash_fwd.launches - before == 2, "LLMServer prefill missed the "
          "flash_fwd kernel")
    log(f"LLMSERVER {json.dumps(resp)}")
    return resp


def main() -> int:
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
            if "registers" in line or "spill" in line:
                log(f"BUILD {name}: {line.strip()}")

    rows = phase_kernels(card)
    engine = phase_engine(card)
    phase_llm_server()

    main_row = next(r for r in rows if r["shape"].endswith("S8192 D128")
                    and r["causal"])
    kernels = [dict(
        name="flash_fwd", route="cuda",
        source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/attention.py:140", launches=engine["launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        shape=main_row["shape"] + " causal bf16")]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, kernel_rows=rows,
                       engine=engine, kernels=kernels), f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
