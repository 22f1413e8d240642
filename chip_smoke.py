#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and builds the
kernels from ``ray_tpu_torch/ops/csrc`` with ``nvcc`` on first use.

1. Build every kernel (nvcc) and the runtime's host library (g++) side by
   side, and print the seconds taken.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (B1 H32 KVH8 D128 bf16, causal at the
   bucket widths 32..8192 and once non-causal; the f32 variant at two
   shapes), at the model's layout (q, k, v as transposes of [B, S, heads,
   D] views, which the TMA maps read through their strides), at the ragged
   lengths 100 and 8000 (TMA zero-fills past the end), at the MoE step's
   S4096 (both layouts), and at the bench configuration's B8 H16 KVH16
   S2048; the other variants (f32 at head_dim 128 to 1024, bf16 at 256
   to 1024; bf16 256 on the wgmma kernels, at 640 the forward, dK/dV and
   dQ in f32 and in bf16 on the cluster kernels of 5 CTAs, at 1024 the
   same on clusters of 8, the forward, dK/dV and dQ at 512 (f32 and bf16)
   on clusters of 4, the forward, dK/dV and dQ at 384 (f32 and bf16) on
   clusters of 3, the forward, dK/dV and dQ at f32 256 on clusters of 2
   and the dK/dV and dQ at f32 128 on clusters of 1, the rest generic,
   tiled over D from 768) at B1
   H8 KVH2 S2048 and the ragged S1000, causal and not, and at the shapes
   of their train-parity runs, f32 256 also at B1 H16 KVH8 S120, f32 128
   at B1 H32 KVH8 S120, bf16
   256 also at ``llama3_8b(n_heads=16)``'s training length, B1 H16 KVH8
   S8192 causal, and D896 and D768 (f32 and
   bf16), B1 H8 KVH2 S2048 causal: the generic chunked instances of 128
   and 256 columns that the cluster kernels took D640 and D1024 from (no
   ptxas spill allowed in any generic instance, wgmma kernel or cluster
   kernel, and no serialized wgmma); time kernel, plain version, SDPA (the library
   yardstick, never called by the port) and the roofline bound. Then head_dim 64 on the card: ``flash_fwd`` and ``flash_bwd``
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
   bf16 and in f32 compute, with 32 heads of 128, 16 of 256, 8 of 512
   and, at d_model 3072, 8 of 384, so that each kernel variant runs
   inside a model.
7. The training main path: ``make_train_fns`` on ``llama3_8b(n_layers=8)``
   (random f32 master weights from a seed), B1 x S8192, 2 warm-up and 5
   timed steps on one batch; the loss falls, each kernel is launched the
   expected number of times per step; step time, tokens/s, MFU, peak
   memory and a profiled step.
8. ``bench.py``'s training configuration (d_model 2048, 8 layers, H 16,
   ``dots_nobatch``) at B8 x S2048, 3 warm-up and 10 timed steps on one
   batch, built as ``bench.py`` builds it: ``make_train_fns(cfg,
   ParallelContext.create(MeshConfig()))`` (a world-1 NCCL group on the
   card), then the same steps with
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
11. The distributed runtime: ``ray_tpu_torch.init()`` starts a controller
   and a node agent, which advertises ``GPU`` by its own discovery (one,
   the card count). An actor ``remote(num_gpus=1)``, pinned to the card
   through ``CUDA_VISIBLE_DEVICES``, builds ``Engine`` on
   ``llama3_8b(n_layers=4)`` (full width, random bf16 weights drawn on the
   card from a seed) and serves phase 3's 8 prompts through its streaming
   methods: 4 flash_fwd launches per prefill in the worker, a second
   ``num_gpus=1`` actor pending until the first is killed, the 8 greedy
   streams equal to an in-process engine's on the same seed's weights
   (both submit all 8 at once), a 256 MB put/get bitwise. Cluster start,
   actor spawn to ready (process, torch import, CUDA start, weights),
   TTFT and decode rates through the actor and in process, and the
   put/get GB/s are printed.
12. The trainer path (``bench.py``'s phase A): ``ray_tpu_torch.init()``,
   a ``from_items`` dataset of ``bench.py``'s rows (``RandomState(0)``,
   8 x 13 rows of 2,048 int32 tokens, 13 blocks) and ``TorchTrainer`` with
   ``ScalingConfig(num_workers=1, use_gpu=True)``: one worker placed and
   pinned to the card by the scheduler runs ``bench.py``'s loop in torch
   on its configuration (not cut), fed by ``iter_torch_batches`` over its
   dataset shard, 3 warm-up and 10 timed steps and the last batch again
   under ``ray_tpu_torch.train.profile()``. The worker saw one pinned card
   and an NCCL group; each kernel launched ``bf16_d128`` as often per step
   as in phase 8; the last batch's loss fell once trained on; and this
   process, once the worker is gone,
   runs the first 3 steps again on the same weights and batches, whose
   losses must agree with the worker's (rel 1e-3; whether bitwise is
   printed). Tokens/s against phase 8's (``framework_overhead``, bench.py's
   second metric), cluster start, time to the first step, ingest ms per
   batch, peak memory and the device's idle share are printed.

13. The serve app: ``LLMConfig(vocab_size=128256, d_model=4096,
   n_layers=8, max_seq=8192, max_ongoing_requests=8, decode_chunk=8,
   page_size=64)`` (Llama-3-8B's width, vocabulary and context under the
   serve preset's shape rule, **depth cut 32 -> 8** to keep the run inside
   its time limit; random weights from seed 0). An
   in-process engine records the greedy streams of phase 3's 8 prompts
   and bench_serve.py's numbers, and is freed. Then ``init()``,
   ``serve.start(http=True)`` and ``build_llm_app`` with ``num_gpus=1``:
   the 8 prompts at once over HTTP give the reference streams, and
   bench_serve.py's measurements (p50/p95 TTFT of 15 solo 16-token
   requests, decode tokens/s over 96 tokens, aggregate tokens/s at 8
   streams of 32), read a byte at a time. The app is deleted, and
   ``run_pd_llm_app``'s deployments (both pools ``num_gpus=0`` on the one
   card) take the same traffic: the reference streams, a sampled stream
   equal to the mono app's, every KV handoff by CUDA IPC (none by the host
   relay) and the prefill replica holding no device object at the end;
   KV MB and handoff ms per request are printed. A decode chunk in the
   mono replica and a small and a large handoff in the decode replica run
   under the profiler (the device's idle share, the host's longest calls).
   Last,
   ``build_llm_processor`` over 16 rows gives the references cut to 16
   tokens. The replicas are the package's servers with a launch reader
   added (``CountedLLMServer`` ...): one ``bf16_d128`` forward per layer
   per prefill in the mono replica and in the prefill pool, none in the
   decode pool.
14. The device edges: ``init()`` and three ``num_gpus=0`` actors that
   share the card. ``DeviceChannel`` at capacity 2 from this process to
   an actor and from one actor to another, bf16 tensors of 4 KB and
   256 MB: each read bitwise equal on the card, the writer's allocated
   bytes back down after the releases; at capacity 1 a second write times
   out until the reader releases. A DAG edge
   ``a0.part.bind(inp).with_tensor_transport()`` -> ``a1.check`` at 64 MB
   f32 (staged at the producer, pulled by the consumer, replayed), its
   execute ms with and without the transport (medians of 20);
   ``allreduce`` over the three for sum, mean, max, min and prod at 64 MB
   f32 and sum in bf16, every output bitwise equal to the rank-order
   reduction on the card, mean's output also feeding a consumer; the
   host-plane collectives (``CollectiveMixin``, the coordinator actor)
   on 1 MB CUDA tensors in f32 and bf16, each result on the caller's card
   in its dtype. Every channel read and DAG pull of the phase must go by
   CUDA IPC, none by the host relay.
15. RLlib with the learners on the card: each of the four learners, 3
   updates on the card against the same learner on the CPU from the same
   weights and batches (SAC under the same injected noise), every leaf
   within rel L2 1e-4; then PPO, IMPALA and DQN on CartPole, SAC on
   Pendulum and multi-agent PPO on CooperativeMatch at their reference
   tests' configurations, each to its test's criterion, with seconds per
   iteration split into sampling and learner, learner ms per update and
   env steps/s; and one update of each learner on the card and on the
   CPU in this process (64 x 64 MLPs: launch-bound on a GPU).
16. Tune, the CLI and jobs: ``init()``, then (a) ``Tuner`` over a function
   trainable that trains phase 8's configuration (not cut) through
   ``make_train_fns``: 2 trials over ``lr`` (phase 8's first; **cut**
   from 4 to keep the run inside its time limit), ASHA on
   the loss (rungs at 1, 2 and 4 of 6 steps), ``resources_per_trial=
   {"GPU": 1}`` and ``max_concurrent_trials=2`` on the one card. Each
   trial reports its loss, step time and the kernels' launch counters
   every step (16/8/8 per step, exactly), and a trial that runs all its
   steps saves its state by ``train.checkpointing`` and reports the
   directory's path. No trial errs, ASHA stops one early at least, the
   trials hold the card one after the other, and the trial at phase 8's
   ``lr`` reports phase 8's losses (rel 1e-3; whether bitwise is printed).
   (b) ``PPO.as_trainable`` under ``Tuner``: 2 trials at once, their
   learners on the card in ``num_gpus=0`` actors, each to a finite return
   in 3 iterations. (c) ``python -m ray_tpu_torch.cli start --head``,
   ``status`` (GPU 1), ``job submit`` of a driver whose ``num_gpus=1``
   task holds the flash forward against its plain version at the train
   step's shape (B8 H16 KVH16 S2048, its layout), ``job logs`` with the
   task's line, the dashboard's nodes (the GPU) and jobs (SUCCEEDED), and
   ``stop``, which leaves no process of the head's runtime.
17. The autoscaler, the soak and the scale harness: (a) ``init()`` with
   a head that advertises no GPU (``{"CPU": 2, "GPU": 0}``), an
   ``Autoscaler`` over a ``LocalNodeProvider`` whose node shape is
   ``{"CPU": 2, "GPU": 1}`` (1 to 2 nodes, 3 s idle timeout), and phase
   11's ``num_gpus=1`` engine actor on ``llama3_8b(n_layers=4)`` (full
   width), pending until the autoscaler's node registers. Exactly one node
   is launched, the actor lands on it with the card pinned, phase 11's 8
   requests go through it with 32 ``flash_fwd`` launches, and its greedy
   streams equal the in-process engine's (phase 11's; alone, an in-process
   engine built once the node is culled). Then the actor is killed: the
   node is culled, its agent and the actor's process are gone and the
   card's memory comes back. Printed: demand seen to ``create_node``, the
   node registered, the actor ready (torch import, CUDA start, weights),
   TTFT through it, kill to culled. (b) ``python -m ray_tpu_torch.cli soak
   --profile smoke`` as a subprocess: exit 0, every verdict ``ok``; the
   workloads' p50 and p99 and the chaos action's detection time. (c) The
   scale harness's miniature (``run_scale`` on 8 and 16 simulated nodes,
   two SIGKILLed; ``tests/test_graftscale.py``'s spec and asserts): the
   level rows and ``kill_detected``'s ``detect_s``.
18. The native planes on the GPU host: (a) ``make -C
   ray_tpu_torch/csrc test``, the seven C++ unit suites (the store, the
   graftrpc reactor, the copy engine, the scope, shm, prof and log
   planes), each ``ALL OK``, with each suite's seconds and the machine's
   ``hardware_concurrency`` printed (the suites build first, in
   parallel, with ``make -j suites``). (b) ``python -m
   ray_tpu_torch.tools.lint`` from the root: 0 findings (the number of
   files walked is printed), and the hot-path costs it derives from the
   port's tree equal ``budgets.json``'s. (c) One ingest on the card: a
   put 256x512 f32 array comes back from ``device_ingest(ref)`` as a
   CUDA tensor equal to it, through a DLPack capsule over the store's
   mapping (one capsule made), and no capsule is left live after ``del``.

Any mismatch raises and the script exits non-zero. The line before the last
is the kernels' JSON; the last is ``{"ok": true, "device": {...}}``.
Details go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --only-kernels

builds the kernels and runs phase 2 alone (a quick check after a kernel
edit), ``--only-bwd`` runs phase 5 alone in the same way, ``--only-times``
times the bf16 wgmma kernels alone at head_dim 256 and 128, S2048 and
S8192, the six D640 cluster kernels (forward, dK/dV and dQ, f32 and
bf16), the six D1024 ones, the six D512 ones, the six D384 ones, the
three f32 D256 ones and the f32 D128 dK/dV and dQ (beside the generic f32
D128 forward) at their parity shapes, in 3 rounds, and checks
nothing of the build (run it from two trees' roots in turns to compare
them; with ``--tree-csrc DIR`` it times the dQ entry point, or with
``--tree-kernel flash_bwd_dkv`` or ``flash_fwd`` the dK/dV or forward one,
as another tree's sources build it beside this tree's, in one process),
``--only-moe``
phase 9, ``--only-ckpt`` phases 4 and 10, ``--only-runtime`` phase 11,
``--only-trainer`` phases 8 and 12, ``--only-serve`` phase 13,
``--only-edges`` phase 14, ``--only-rllib`` phase 15, ``--only-tune``
phase 16, ``--only-autoscale`` phase 17, ``--only-planes`` phase 18 and
then (d) ``pytest`` on the eight plane suites ``tests/test_torch_graft*``
and ``tests/test_torch_native_store.py`` (their details go to
``chiprun_out/chip_smoke_edges.json``, ``..._rllib.json``,
``..._tune.json``, ``..._autoscale.json`` and ``..._planes.json``), and
``--only-ttft N``
measures idle TTFT alone (N requests per prompt length; run it from
another tree's root to compare the two); none prints a result line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import gc
import glob
import inspect
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import ray_tpu_torch
import ray_tpu_torch.serve as serve
from ray_tpu_torch import accelerators
from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider
from ray_tpu_torch.collective import CollectiveMixin, init_collective_group
from ray_tpu_torch.core import object_store
from ray_tpu_torch.core._native import graftrpc, graftshm
from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce
from ray_tpu_torch.device_objects import device_get, device_ingest
from ray_tpu_torch.experimental import DeviceChannel, device_plane
from ray_tpu_torch.load.verdict import passed as verdicts_passed
from ray_tpu_torch.models.llama import (LlamaConfig, flops_per_token,
                                        forward, forward_with_aux,
                                        init_params, loss_fn, param_count)
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (_bwd_launch, _fwd_launch,
                                         attention_route,
                                         flash_bwd, flash_bwd_dkv,
                                         flash_bwd_dq, flash_bwd_plain,
                                         flash_bwd_plain_dkv,
                                         flash_bwd_plain_dq,
                                         flash_bwd_reference, flash_fwd,
                                         flash_fwd_plain, flash_fwd_reference,
                                         kernel_variant)
from ray_tpu_torch.ops import moe as moe_module
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.parallel import MeshConfig, ParallelContext
from ray_tpu_torch.rllib import (CartPole, CooperativeMatch, DQNConfig,
                                 DQNLearner, IMPALAConfig, IMPALALearner,
                                 MultiAgentPPOConfig, Pendulum, PPOConfig,
                                 PPOLearner, SACConfig, SACLearner)
from ray_tpu_torch.scale import ScaleSpec, run_scale
from ray_tpu_torch.serve.engine import Engine
from ray_tpu_torch.serve.api import Application, Deployment
from ray_tpu_torch.serve.llm import (DecodeServer, LLMConfig, LLMServer,
                                     PrefillServer, _deploy_pd, _engine,
                                     _model_from_cfg, _pd_deployments,
                                     build_llm_app)
from ray_tpu_torch.tools.lint import hotpath, protocol
from ray_tpu_torch.tools.lint.common import load_source
from ray_tpu_torch.train import (AsyncCheckpointer, Checkpoint,
                                 default_optimizer, make_train_fns,
                                 restore_checkpoint)
from ray_tpu_torch.train.checkpointing import save_checkpoint

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
# Phase 13's serve preset gives the kernel B1 H32 KVH16 (GQA groups of 2)
# in the model layout at its prefill buckets (32 to 8192); --only-serve
# checks these too.
SERVE_FWD_CASES = [(1, 32, 16, S, True, BF16, "model")
                   for S in (32, 512, 2048, 8192)]
FWD_CASES += SERVE_FWD_CASES
# The kernel variants other than bf16 D128 (bf16 D256 on the wgmma kernels,
# at D384, D512, D640 and D1024 the forward, dK/dV and dQ in f32 and in
# bf16, and at f32 D256 the forward, dK/dV and dQ on the cluster kernels,
# every other one generic), in phases 2 and 5: at B1 H8 KVH2, S2048 and the
# ragged S1000, causal and not, and at the shape the train-parity path of
# their dtype and head_dim gives them
# (``PARITY_RUNS``: B1 H32 KVH8 D128, B1 H16 KVH8 D256, B1 H8 KVH4 D384,
# D512 and D640, B1 H4 KVH2 D1024, S2048 causal); bf16 D256 also at phase
# 7's training length, B1 H16 KVH8 S8192 causal (``llama3_8b(n_heads=16)``
# at S8192). The cluster kernels split D640 over 5 CTAs, D1024 over 8, D512
# over 4, D384 over 3 and f32 D256 over 2
# (the rows of a dK/dV or dQ cluster's 64 unevenly over 5: 12 or 13 a CTA,
# 8 each over 8, 16 over 4, 21 or 22 over 3, in two row slots of 16 (f32)
# or three of 8 (bf16), 32 over 2 in two full row slots of 16; the ragged
# S1000 ending in a tile of 40, so that over 4 the third CTA's 16 rows are
# half past Skv or Sq and the fourth's all, over 3 the second CTA's rows
# 37-41 (f32's second slot, bf16's third) lie partly past them (40-41), and
# all the third CTA's rows lie past them, and over 2 the second CTA's first
# slot (rows 32-47) lies partly past Skv or Sq (40-47) and its second
# wholly; the forward's 128-row q tiles, 25 or 26 rows a CTA over 5, 16 over
# 8, 32 over 4, 42 or 43 over 3 (three row slots of 16 in f32, six of 8 in
# bf16) and 64 over 2 (four row slots of 16), end in one of 104, so that
# over 4 the fourth CTA's rows 104-127 lie past Sq, over 3 the third CTA's
# rows 104-127 (85-127 its own): its second slot's last 13 rows and all its
# third slot's in f32, its third slot's last 5 and all its fourth to sixth
# slots' in bf16, and over 2 the second CTA's third slot (96-111) half past
# Sq and its fourth wholly). f32 D256 also at its parity heads, B1 H16 KVH8,
# at S120, causal and not: one q tile of 120 rows, so the forward's fourth
# slot (rows 112-127) lies half past Sq, the only case that leaves it partly
# full, and the last 64-row q and KV tiles hold 56 rows, the second CTA's
# second slot (48-63) half past Sq in the dQ and past Skv in the dK/dV.
# f32 D128 also at its parity heads, B1 H32 KVH8, at S120, causal and not:
# the last 64-row q and KV tiles hold 56 rows, so the one CTA's fourth
# exchange slot (48-63) lies half past Sq in the dQ and past Skv in the
# dK/dV.
# D896 and D768 (f32 and bf16; B1 H8 KVH2 S2048 causal) keep the generic
# chunked
# instances of 128 and 256 columns checked and timed: no parity run
# reaches them, and since the cluster kernels took D640 and D1024 they
# serve only D896, 1152, ... and D768, 1280, ...
VARIANTS = (("f32_d128", 128, F32), ("f32_d256", 256, F32),
            ("bf16_d256", 256, BF16), ("f32_d384", 384, F32),
            ("bf16_d384", 384, BF16), ("f32_d512", 512, F32),
            ("bf16_d512", 512, BF16), ("f32_d640", 640, F32),
            ("bf16_d640", 640, BF16), ("f32_d1024", 1024, F32),
            ("bf16_d1024", 1024, BF16))
VARIANT_MAIN = {128: (1, 32, 8), 256: (1, 16, 8), 384: (1, 8, 4),
                512: (1, 8, 4), 640: (1, 8, 4), 1024: (1, 4, 2)}  # B, H, KVH
# Phase 7's sequence length, and the bf16 D256 case's below
TRAIN_SEQ = 8192
VARIANT_CASES = [(name, D, dt, 1, 8, 2, S, causal)
                 for name, D, dt in VARIANTS for S in (2048, 1000)
                 for causal in (True, False)] + [
    (name, D, dt, *VARIANT_MAIN[D], 2048, True) for name, D, dt in VARIANTS
] + [("bf16_d256", 256, BF16, *VARIANT_MAIN[256], TRAIN_SEQ, True)] + [
    ("f32_d256", 256, F32, *VARIANT_MAIN[256], 120, causal)
    for causal in (True, False)] + [
    ("f32_d128", 128, F32, *VARIANT_MAIN[128], 120, causal)
    for causal in (True, False)] + [
    (f"{dt_name}_d896", 896, dt, 1, 8, 2, 2048, True)
    for dt_name, dt in (("f32", F32), ("bf16", BF16))] + [
    ("f32_d768", 768, F32, 1, 8, 2, 2048, True),
    ("bf16_d768", 768, BF16, 1, 8, 2, 2048, True)]
# The variants that run wgmma kernels besides bf16 D128, by kernel: bf16
# D256 (all three); and those that run the cluster kernels: the forward,
# dK/dV and dQ at D384, D512, D640 and D1024 in f32 and in bf16, at f32
# D256, and the dK/dV and dQ at f32 D128. Every other variant runs a generic
# instance.
WGMMA_VARIANTS = {"flash_fwd": ("bf16_d256",),
                  "flash_bwd_dkv": ("bf16_d256",),
                  "flash_bwd_dq": ("bf16_d256",)}
CLUSTER_VARIANTS = {"flash_fwd": ("f32_d256", "f32_d384", "bf16_d384",
                                  "f32_d512", "bf16_d512", "f32_d640",
                                  "bf16_d640", "f32_d1024", "bf16_d1024"),
                    "flash_bwd_dkv": ("f32_d128", "f32_d256", "f32_d384",
                                      "bf16_d384",
                                      "f32_d512", "bf16_d512", "f32_d640",
                                      "bf16_d640", "f32_d1024", "bf16_d1024"),
                    "flash_bwd_dq": ("f32_d128", "f32_d256", "f32_d384",
                                     "bf16_d384", "f32_d512", "bf16_d512",
                                     "f32_d640", "bf16_d640", "f32_d1024",
                                     "bf16_d1024")}
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
# The train-parity runs, one per kernel variant (phase 6; label, llama3_8b
# overrides): bf16 at head_dim 128 (the main path's variant), Llama-3-8B's
# width with 16 heads of 256 (8 KV heads, groups of 2) in bf16 and in f32
# compute, the preset in f32 compute, and 8 heads of 512 (4 KV heads) at
# its width and of 384 at d_model 3072 (4096 is no multiple of 384), 8
# heads of 640 at d_model 5120 and 4 heads of 1024 (2 KV heads) at its
# width, in both: no preset has a head of 256 or more, so these are the
# only model paths that reach those variants.
PARITY_RUNS = (("bf16_d128", dict(n_layers=2)),
               ("bf16_d256", dict(n_layers=2, n_heads=16)),
               ("f32_d128", dict(n_layers=2, dtype=F32)),
               ("f32_d256", dict(n_layers=2, n_heads=16, dtype=F32)),
               ("bf16_d384", dict(n_layers=2, d_model=3072, n_heads=8,
                                  n_kv_heads=4)),
               ("f32_d384", dict(n_layers=2, d_model=3072, n_heads=8,
                                 n_kv_heads=4, dtype=F32)),
               ("bf16_d512", dict(n_layers=2, n_heads=8, n_kv_heads=4)),
               ("f32_d512", dict(n_layers=2, n_heads=8, n_kv_heads=4,
                                 dtype=F32)),
               ("bf16_d640", dict(n_layers=2, d_model=5120, n_heads=8,
                                  n_kv_heads=4)),
               ("f32_d640", dict(n_layers=2, d_model=5120, n_heads=8,
                                 n_kv_heads=4, dtype=F32)),
               ("bf16_d1024", dict(n_layers=2, n_heads=4, n_kv_heads=2)),
               ("f32_d1024", dict(n_layers=2, n_heads=4, n_kv_heads=2,
                                  dtype=F32)))
PARITY_SEQ = 2048
TRAIN_LAYERS = 8
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# bench.py:34-37, the repo's training benchmark configuration
BENCH_MODEL = dict(vocab_size=32000, d_model=2048, n_layers=8, n_heads=16,
                   n_kv_heads=16, d_ff=5504, max_seq=2048,
                   remat_policy="dots_nobatch")
BENCH_BATCH, BENCH_SEQ = 8, 2048
# bench.py:36-37: 3 warm-up and 10 timed steps, in phase 8 (bench_raw's
# loop) and in phase 12 (the trainer's), whose rates are compared
BENCH_WARMUP, BENCH_STEPS = 3, 10
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
# Generic instances: 1 one-chunk one in the forward (f32 D128: bf16 D128
# and D256 are the wgmma kernels', f32 D256 and D384 and D512 in both dtypes
# the cluster kernels', so every instance at D256 and D384 is a wgmma or
# cluster kernel; the dK/dV and dQ at f32 D128 are cluster kernels of 1
# CTA, so they have no one-chunk instance), and each kernel 4 chunked ones
# (f32 and bf16, chunks of 128 and 256). D640 and D1024 are the cluster
# kernels' for
# all three in f32 and in bf16, so the instances of 128-column chunks serve
# only D896, 1152, ... (D above 512 with D % 256 != 0; the D896 cases of
# VARIANT_CASES run them) and those of 256-column chunks only D768, 1280,
# ... (the D768 cases run them)
GENERIC_INSTANCES = 13
# wgmma kernels: each of the three at D128 and D256 (the forward's two from
# one template)
WGMMA_INSTANCES = 6
# Cluster kernels: of 5 CTAs at D640, the f32 forward, dK/dV and dQ on the
# FMA units and the bf16 forward, dK/dV and dQ on wgmma; of 8 CTAs at
# D1024, the f32 forward, dK/dV and dQ on the FMA units and the bf16
# forward, dK/dV and dQ on wgmma (each its D640 instance's template); of 4
# CTAs at D512 and of 3 at D384, the forward, dK/dV and dQ in f32 and in
# bf16, of 2 CTAs at f32 D256, the forward, dK/dV and dQ, and of 1 CTA at
# f32 D128, the dK/dV and dQ (each its dtype's template of that kernel)
CLUSTER_INSTANCES = 29


def log(*a):
    print(*a, flush=True)


def kernel_kind(name: str, variant: str) -> str:
    """"wgmma", "cluster" or "generic": which code of kernel ``name``
    (``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq``) the variant runs
    besides bf16 D128."""
    if variant in WGMMA_VARIANTS[name]:
        return "wgmma"
    return "cluster" if variant in CLUSTER_VARIANTS[name] else "generic"


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


def ptxas_spills(text: str) -> dict:
    """{kernel (mangled name): (spill store bytes, spill load bytes)} from
    an ``nvcc -Xptxas -v`` report: each "Function properties for <name>"
    line is followed by its "... bytes spill stores, ... bytes spill
    loads" line."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


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
          and all(attention_route(d) == "kernel"
                  for d in (256, 384, 512, 640, 1024)), "attention_route")
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


def _abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


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


# --only-times: the bf16 wgmma kernels alone at the training shapes of
# head_dim 256 and 128 (D, H, KVH; B1, causal), each timed in 3 rounds in
# turn, medians printed: the quick A/B of two trees in one call (run it
# from each root in turns). Then the cluster kernels at their parity runs'
# shapes, S2048 only: the forward, dK/dV and dQ in f32 and bf16 at D640,
# D1024, D512 and D384, and in f32 at D256 (all cluster kernels) and D128
# (the dK/dV and dQ cluster kernels, the forward generic).
TIME_SHAPES = ((256, 16, 8), (128, 32, 8))
TIME_SEQS = (2048, TRAIN_SEQ)
TIME_ROUNDS = 3
TIME_CLUSTER = (640, 8, 4, 2048)  # D, H, KVH, S; B1, causal
TIME_CLUSTER_1024 = (1024, 4, 2, 2048)
TIME_CLUSTER_512 = (512, 8, 4, 2048)
TIME_CLUSTER_384 = (384, 8, 4, 2048)
TIME_CLUSTER_256 = (256, 16, 8, 2048)
TIME_CLUSTER_128 = (128, 32, 8, 2048)


def phase_kernel_times(card: str) -> list:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [(D, H, KVH, S, BF16) for S in TIME_SEQS
             for D, H, KVH in TIME_SHAPES] + [
        (*TIME_CLUSTER, F32), (*TIME_CLUSTER, BF16),
        (*TIME_CLUSTER_1024, F32), (*TIME_CLUSTER_1024, BF16),
        (*TIME_CLUSTER_512, F32), (*TIME_CLUSTER_512, BF16),
        (*TIME_CLUSTER_384, F32), (*TIME_CLUSTER_384, BF16),
        (*TIME_CLUSTER_256, F32), (*TIME_CLUSTER_128, F32)]
    rows = []
    for D, H, KVH, S, dt in cases:
        q, k, v, do = (_attn_input(1, h, S, D, gen, dt, "dense")
                       for h in (H, KVH, KVH, H))
        o, lse = flash_fwd(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, True, D ** -0.5)
        fns = dict(flash_fwd=lambda: flash_fwd(q, k, v, True),
                   flash_bwd_dkv=lambda: flash_bwd_dkv(*args),
                   flash_bwd_dq=lambda: flash_bwd_dq(*args))
        iters = 20 if S <= 2048 else 10
        times = {n: [] for n in fns}
        for _ in range(TIME_ROUNDS):
            for n, fn in fns.items():
                times[n].append(gpu_ms(fn, iters))
        row = dict(shape=f"B1 H{H} KVH{KVH} S{S} D{D}", causal=True,
                   dtype=str(dt).replace("torch.", ""),
                   ms={n: statistics.median(t) for n, t in times.items()},
                   rounds_ms=times, card=card)
        log("TIMES", json.dumps(row))
        rows.append(row)
        del q, k, v, do, o, lse, delta, args, fns
        torch.cuda.empty_cache()
    return rows


# --only-times --tree-csrc DIR ...: an entry point (``--tree-kernel``:
# ``flash_bwd_dq``, the default, ``flash_bwd_dkv`` or ``flash_fwd``) as each
# named source directory builds it (another tree's ``ray_tpu_torch/ops/csrc``,
# unpacked with ``git archive``; its ``ray_<kernel>`` must keep this tree's C
# signature) and then as this tree builds it, all launched through the
# wrapper's own ``_bwd_launch`` or ``_fwd_launch`` on the same inputs: by
# default D384 in both dtypes, bf16 D512, f32 D128 and D256 and the chunked
# D768 and D896 in both dtypes at their shapes (S2048 causal; ``--tree-case
# DTYPE:D:H:KVH`` picks others, as for a tree that served fewer head_dims,
# or one whose instance this tree replaced), each held against the plain
# version (the forward's O and LSE by phase 2's absolute bounds, the
# backward's outputs by phase 5's relative ones), then timed in 3 rounds in
# the order A B ... B A: the A/B of one kernel across commits.
TREE_CASES = ("bf16:384:8:4", "f32:384:8:4", "bf16:512:8:4", "f32:128:8:4",
              "f32:256:8:4", "bf16:768:8:2", "f32:768:8:2", "bf16:896:8:2",
              "f32:896:8:2")
TREE_PLAIN = {"flash_bwd_dq": lambda *a: (flash_bwd_plain_dq(*a),),
              "flash_bwd_dkv": flash_bwd_plain_dkv,
              "flash_fwd": flash_fwd_plain}


def phase_trees(card: str, kernel: str, dirs: list, cases: list) -> list:
    srcs = [os.path.abspath(d) for d in dirs] + [str(_build.CSRC)]
    with ThreadPoolExecutor(len(srcs)) as ex:  # one nvcc each, at once
        paths = list(ex.map(lambda d: _build.build_all(
            [kernel], Path(d))[kernel], srcs))
    libs = [ctypes.CDLL(str(path)) for path in paths]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for case in cases or TREE_CASES:
        name, D, H, KVH = case.split(":")
        dt = dict(bf16=BF16, f32=F32)[name]
        D, H, KVH, S = int(D), int(H), int(KVH), 2048
        q, k, v, do = (_attn_input(1, h, S, D, gen, dt, "dense")
                       for h in (H, KVH, KVH, H))
        if kernel == "flash_fwd":  # O and LSE, absolute errors
            args = (q, k, v, True, D ** -0.5)
            launch = _fwd_launch
            tols = (ATOL_O_BF16, ATOL_LSE) if dt == BF16 else (ATOL_F32,) * 2
            err_fn = _abs_err
        else:  # dQ, or dK and dV, relative errors
            o, lse = flash_fwd(q, k, v, True)
            delta = (do.float() * o.float()).sum(-1)
            args = (q, k, v, do, lse, delta, True, D ** -0.5)
            launch = functools.partial(_bwd_launch, kernel)
            tols = (REL_TOL_BWD if dt == BF16 else REL_TOL_BWD_F32,) * 2
            err_fn = _rel_err
        want = TREE_PLAIN[kernel](*args)
        outs = [tuple(torch.empty_like(w) for w in want) for _ in libs]
        fns = [lambda lib=lib, out=out: launch(out, *args, lib=lib)
               for lib, out in zip(libs, outs)]
        errs = []
        for fn, out in zip(fns, outs):
            fn()
            torch.cuda.synchronize()
            errs.append([err_fn(g, w) for g, w in zip(out, want)])
        check(all(e <= t for es in errs for e, t in zip(es, tols)),
              f"{kernel} D{D} {dt} across trees {srcs}: max errors {errs} "
              f"(bounds {tols})")
        times = [[] for _ in fns]
        order = list(range(len(fns)))
        for _ in range(TIME_ROUNDS):
            for i in order + order[::-1]:
                times[i].append(gpu_ms(fns[i], 20))
        for src, t, e in zip(srcs, times, errs):
            row = dict(kernel=kernel, src=os.path.relpath(src),
                       shape=f"B1 H{H} KVH{KVH} S{S} D{D}", causal=True,
                       dtype=str(dt).replace("torch.", ""),
                       ms=statistics.median(t), rounds_ms=t, errs=e,
                       card=card)
            log("TREES", json.dumps(row))
            rows.append(row)
        del q, k, v, do, args, want, outs, fns
        torch.cuda.empty_cache()
    return rows


# The cluster kernels by kernel-line entry: (library, its max-clusters
# entry point, CTAs a cluster).
CLUSTER_FIT = {
    "flash_fwd.f32_d256": ("flash_fwd", "ray_flash_fwd_f32_d256_max_clusters",
                           2),
    "flash_fwd.f32_d384": ("flash_fwd", "ray_flash_fwd_f32_d384_max_clusters",
                           3),
    "flash_fwd.bf16_d384": ("flash_fwd",
                            "ray_flash_fwd_bf16_d384_max_clusters", 3),
    "flash_fwd.f32_d512": ("flash_fwd", "ray_flash_fwd_f32_d512_max_clusters",
                           4),
    "flash_fwd.bf16_d512": ("flash_fwd",
                            "ray_flash_fwd_bf16_d512_max_clusters", 4),
    "flash_fwd.f32_d640": ("flash_fwd", "ray_flash_fwd_max_clusters", 5),
    "flash_fwd.bf16_d640": ("flash_fwd", "ray_flash_fwd_bf16_max_clusters",
                            5),
    "flash_fwd.f32_d1024": ("flash_fwd",
                            "ray_flash_fwd_f32_d1024_max_clusters", 8),
    "flash_fwd.bf16_d1024": ("flash_fwd",
                             "ray_flash_fwd_bf16_d1024_max_clusters", 8),
    "flash_bwd_dkv.f32_d128": ("flash_bwd_dkv",
                               "ray_flash_bwd_dkv_f32_d128_max_clusters", 1),
    "flash_bwd_dkv.f32_d256": ("flash_bwd_dkv",
                               "ray_flash_bwd_dkv_f32_d256_max_clusters", 2),
    "flash_bwd_dkv.f32_d384": ("flash_bwd_dkv",
                               "ray_flash_bwd_dkv_f32_d384_max_clusters", 3),
    "flash_bwd_dkv.bf16_d384": ("flash_bwd_dkv",
                                "ray_flash_bwd_dkv_bf16_d384_max_clusters",
                                3),
    "flash_bwd_dkv.f32_d512": ("flash_bwd_dkv",
                               "ray_flash_bwd_dkv_f32_d512_max_clusters", 4),
    "flash_bwd_dkv.bf16_d512": ("flash_bwd_dkv",
                                "ray_flash_bwd_dkv_bf16_d512_max_clusters",
                                4),
    "flash_bwd_dkv.f32_d640": ("flash_bwd_dkv",
                               "ray_flash_bwd_dkv_max_clusters", 5),
    "flash_bwd_dkv.bf16_d640": ("flash_bwd_dkv",
                                "ray_flash_bwd_dkv_bf16_max_clusters", 5),
    "flash_bwd_dkv.f32_d1024": ("flash_bwd_dkv",
                                "ray_flash_bwd_dkv_f32_d1024_max_clusters",
                                8),
    "flash_bwd_dkv.bf16_d1024": ("flash_bwd_dkv",
                                 "ray_flash_bwd_dkv_bf16_d1024_max_clusters",
                                 8),
    "flash_bwd_dq.f32_d128": ("flash_bwd_dq",
                              "ray_flash_bwd_dq_f32_d128_max_clusters", 1),
    "flash_bwd_dq.f32_d256": ("flash_bwd_dq",
                              "ray_flash_bwd_dq_f32_d256_max_clusters", 2),
    "flash_bwd_dq.f32_d384": ("flash_bwd_dq",
                              "ray_flash_bwd_dq_f32_d384_max_clusters", 3),
    "flash_bwd_dq.bf16_d384": ("flash_bwd_dq",
                               "ray_flash_bwd_dq_bf16_d384_max_clusters", 3),
    "flash_bwd_dq.f32_d512": ("flash_bwd_dq",
                              "ray_flash_bwd_dq_f32_d512_max_clusters", 4),
    "flash_bwd_dq.bf16_d512": ("flash_bwd_dq",
                               "ray_flash_bwd_dq_bf16_d512_max_clusters", 4),
    "flash_bwd_dq.f32_d640": ("flash_bwd_dq",
                              "ray_flash_bwd_dq_f32_d640_max_clusters", 5),
    "flash_bwd_dq.bf16_d640": ("flash_bwd_dq",
                               "ray_flash_bwd_dq_bf16_max_clusters", 5),
    "flash_bwd_dq.f32_d1024": ("flash_bwd_dq",
                               "ray_flash_bwd_dq_max_clusters", 8),
    "flash_bwd_dq.bf16_d1024": ("flash_bwd_dq",
                                "ray_flash_bwd_dq_bf16_d1024_max_clusters",
                                8)}


def cluster_fit() -> dict:
    """{kernel-line entry: how many of its clusters (``CLUSTER_FIT``'s
    size) the card holds at once} for each cluster kernel
    (``cudaOccupancyMaxActiveClusters`` at its shared memory); at least one
    each, or that kernel cannot launch."""
    out = {}
    for name, (lib, fn, _) in CLUSTER_FIT.items():
        f = getattr(_build.load(lib), fn)
        f.argtypes, f.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        n = ctypes.c_int(0)
        err = f(ctypes.byref(n))
        check(err == 0 and n.value >= 1,
              f"the {name} cluster does not fit: CUDA error {err}, "
              f"{n.value} clusters")
        out[name] = n.value
    return out


def phase_bwd_kernels(card: str):
    fit = cluster_fit()
    log("CLUSTER the cluster kernels, clusters at once (CTAs a cluster): "
        + json.dumps({n: f"{c} ({CLUSTER_FIT[n][2]})"
                      for n, c in fit.items()}) + f"  [{card}]")
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
    out = _train_run(cfg, BENCH_BATCH, BENCH_SEQ, BENCH_WARMUP, BENCH_STEPS,
                     card, "bench.py d2048 L8 H16", profile=False,
                     ctx=ParallelContext.create(MeshConfig()))
    plain = _train_run(cfg, BENCH_BATCH, BENCH_SEQ, BENCH_WARMUP,
                       BENCH_STEPS, card,
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


# ---------------------------------------------------------------------------
# phase 11: the distributed runtime on the card, Llama-3-8B from a GPU actor
# ---------------------------------------------------------------------------

# Full width, depth cut 32 -> 4: phase 3 serves the full depth in process;
# here the weights (3.9 GB) are made inside a worker process.
RUNTIME_LAYERS = 4
RUNTIME_ENGINE = dict(n_slots=8, decode_chunk=8, page_size=64)
RUNTIME_PUT_BYTES = 256 * 2**20


class RuntimeEngineActor:
    """The port's ``Engine`` on ``llama3_8b(n_layers=RUNTIME_LAYERS)``
    inside a ``num_gpus=1`` actor, on random bf16 weights drawn on the card
    by a generator seeded with ``seed``. One async method makes the actor
    async, so each streaming call gets its own producer thread and the
    requests share the engine's continuous batching. Imports are local:
    the class unpickles in the worker without torch, and ``__init__`` times
    the torch import, CUDA's start and the weights."""

    def __init__(self, seed, n_layers, engine_kw, allow_tf32):
        t = {"init": time.time()}
        import torch
        t["torch_imported"] = time.time()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t["cuda_ready"] = time.time()
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        torch.backends.cudnn.allow_tf32 = allow_tf32
        from ray_tpu_torch.models.llama import LlamaConfig, init_params
        from ray_tpu_torch.serve.engine import Engine
        cfg = LlamaConfig.llama3_8b(n_layers=n_layers,
                                    param_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.eng = Engine(init_params(cfg, gen, device="cuda"), cfg,
                          **engine_kw)
        torch.cuda.synchronize()
        t["weights_ready"] = time.time()
        self.times = t

    async def ready(self) -> dict:
        import os
        import torch
        from ray_tpu_torch.core._native import graftrpc
        return dict(times=self.times, pid=os.getpid(),
                    cuda_visible_devices=os.environ.get(
                        "CUDA_VISIBLE_DEVICES"),
                    device_count=torch.cuda.device_count(),
                    device_name=torch.cuda.get_device_name(0),
                    graftrpc=graftrpc.available(),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    def generate(self, ids, max_tokens):
        """One request, streamed chunk by chunk as the engine emits it."""
        stream = self.eng.submit(ids, max_tokens)
        while (item := stream.get(timeout=600)) is not None:
            yield [int(x) for x in item]

    def launches(self, reset: bool = False) -> tuple:
        from ray_tpu_torch.ops.attention import flash_fwd
        out = (flash_fwd.launches, dict(flash_fwd.launches_by_variant))
        if reset:
            flash_fwd.launches = 0
            flash_fwd.launches_by_variant.clear()
        return out

    def digest(self, arr) -> str:
        import hashlib
        return hashlib.sha256(memoryview(arr).cast("B")).hexdigest()

    def stop(self):
        self.eng.stop()
        return None if self.eng.error is None else repr(self.eng.error)


class RuntimeProbe:
    """A second ``num_gpus=1`` actor: which device it was given."""

    async def gpus(self):
        import os
        return os.environ.get("CUDA_VISIBLE_DEVICES")


class _ActorStream:
    """A streaming actor call read as an ``Engine`` stream: ``get`` gives
    the next chunk, then None."""

    def __init__(self, gen):
        self._it = iter(gen)

    def get(self, timeout=None):
        ref = next(self._it, None)
        return None if ref is None else ray_tpu_torch.get(ref, timeout=timeout)


class _ActorEngine:
    """The actor behind ``submit``, so the phase-3 drivers
    (``_run_concurrent``, ``_ttft_idle``) time it as they time an
    ``Engine``."""

    error = None

    def __init__(self, actor):
        self.actor = actor

    def submit(self, ids, max_tokens, **kw):
        check(not kw, f"the actor serves greedy requests only, got {kw}")
        return _ActorStream(self.actor.generate.options(
            num_returns="streaming").remote(ids, max_tokens))


def _local_launches(reset: bool) -> tuple:
    out = (flash_fwd.launches, dict(flash_fwd.launches_by_variant))
    if reset:
        _reset_launch_counts()
    return out


def _serve_and_time(eng, cfg, label: str, card: str, launches) -> tuple:
    """The main path: 8 concurrent greedy requests (phase 3's prompts),
    with the flash_fwd launches of the process that runs the engine zeroed
    just before and read just after (``launches(reset)``); then idle TTFT
    and decode rates. On an ``Engine`` or an actor behind
    ``_ActorEngine``. Returns (numbers, the 8 streams)."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    launches(True)
    t = time.perf_counter()
    res = _run_concurrent(eng, [(p, MAX_TOKENS, {}) for p in prompts])
    burst_s = time.perf_counter() - t
    n, by_variant = launches(True)
    check(n == RUNTIME_LAYERS * len(prompts)
          and by_variant == {"bf16_d128": n},
          f"{label}: flash_fwd launched {n} times ({by_variant}), expected "
          f"{RUNTIME_LAYERS} per prefill x {len(prompts)}")
    streams = [toks for _, _, toks in res]
    for i, toks in enumerate(streams):
        check(len(toks) == MAX_TOKENS and all(
            0 <= x < cfg.vocab_size for x in toks),
            f"{label}: request {i} streamed {len(toks)} tokens")
    ttft = [times[0][0] - t0 for t0, times, _ in res]
    rng = np.random.default_rng(SEED + 11)
    idle = _ttft_idle(eng, cfg, rng, TTFT_REPEATS)
    long_jobs = [(rng.integers(0, cfg.vocab_size, 128).tolist(), 129, {})
                 for _ in range(8)]
    rate1 = _decode_rate(_run_concurrent(eng, long_jobs[:1]))
    rate8 = _decode_rate(_run_concurrent(eng, long_jobs))
    out = dict(launches=n, burst_s=burst_s, ttft_burst_s=ttft,
               ttft_idle_s={n: statistics.median(v) for n, v in idle.items()},
               ttft_idle_all_s=idle, decode_tok_s_1=rate1,
               decode_tok_s_8=rate8)
    log(f"RUNTIME {label}: flash_fwd launches {n} in the 8-request burst "
        f"({burst_s:.2f} s), TTFT idle median "
        f"{out['ttft_idle_s'][100] * 1e3:.1f} ms (prompt 100), "
        f"{out['ttft_idle_s'][2000] * 1e3:.1f} ms (2000); decode tok/s 1 "
        f"stream {rate1:.1f}, 8 streams {rate8:.1f}  [{card}]")
    return out, streams


def phase_runtime(card: str) -> dict:
    """``ray_tpu_torch.init()`` on this host, an engine actor holding the
    card by ``num_gpus=1``, a second such actor pending until the first is
    killed, the actor's streams against an in-process engine on the same
    seed's weights, and a 256 MB put/get."""
    torch.cuda.empty_cache()
    check(graftrpc.available(), "graftrpc's native plane is not available "
          "in this process")
    t = time.perf_counter()
    ray_tpu_torch.init()
    start_s = time.perf_counter() - t
    try:
        return _phase_runtime(card, start_s)
    finally:
        ray_tpu_torch.shutdown()


def _phase_runtime(card: str, start_s: float) -> dict:
    res = ray_tpu_torch.cluster_resources()
    seen = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES",
                                            "NVIDIA_VISIBLE_DEVICES")}
    log(f"RUNTIME cluster up in {start_s:.3f} s, resources {res}, {seen}, "
        f"device files {sorted(glob.glob('/dev/nvidia[0-9]*'))}  [{card}]")
    check(res.get("GPU") == torch.cuda.device_count(),
          f"the agent advertises GPU {res.get('GPU')}, the card count is "
          f"{torch.cuda.device_count()}")
    pinned = accelerators.worker_env_for_gpus([0])["CUDA_VISIBLE_DEVICES"]
    cfg = LlamaConfig.llama3_8b(n_layers=RUNTIME_LAYERS,
                                param_dtype=torch.bfloat16)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32

    # -- the engine actor: spawn to ready --
    t_spawn = time.time()
    actor = ray_tpu_torch.remote(num_gpus=1)(RuntimeEngineActor).remote(
        SEED, RUNTIME_LAYERS, RUNTIME_ENGINE, allow_tf32)
    info = ray_tpu_torch.get(actor.ready.remote(), timeout=600)
    t_ready = time.time()
    tm = info["times"]
    spawn = dict(total_s=t_ready - t_spawn,
                 process_and_register_s=tm["init"] - t_spawn,
                 torch_import_s=tm["torch_imported"] - tm["init"],
                 cuda_init_s=tm["cuda_ready"] - tm["torch_imported"],
                 weights_and_engine_s=tm["weights_ready"] - tm["cuda_ready"])
    log(f"RUNTIME actor spawn to ready: {json.dumps(spawn)}; "
        f"{json.dumps({k: v for k, v in info.items() if k != 'times'})}  "
        f"[{card}]")
    check(info["cuda_visible_devices"] == pinned and info["device_count"] == 1
          and info["device_name"] == torch.cuda.get_device_name(0),
          f"the actor sees CUDA_VISIBLE_DEVICES="
          f"{info['cuda_visible_devices']!r} ({info['device_count']} "
          f"devices), expected the pinned {pinned!r}")
    check(info["graftrpc"], "graftrpc's native plane is not available in "
          "the actor")

    # -- the main path: 8 requests through the actor's methods --
    timed, streams = _serve_and_time(
        _ActorEngine(actor), cfg, "through the actor", card,
        lambda reset: ray_tpu_torch.get(actor.launches.remote(reset)))

    # -- put/get of 256 MB, here and into the actor --
    arr = np.random.default_rng(SEED + 12).integers(
        0, 2**63 - 1, RUNTIME_PUT_BYTES // 8, dtype=np.int64)
    t = time.perf_counter()
    ref = ray_tpu_torch.put(arr)
    put_s = time.perf_counter() - t
    t = time.perf_counter()
    back = ray_tpu_torch.get(ref)
    get_s = time.perf_counter() - t
    bitwise = bool(np.array_equal(back, arr))
    t = time.perf_counter()
    digest = ray_tpu_torch.get(actor.digest.remote(ref), timeout=300)
    actor_get_s = time.perf_counter() - t
    import hashlib
    want_digest = hashlib.sha256(memoryview(arr).cast("B")).hexdigest()
    gb = arr.nbytes / 1e9
    put_get = dict(bytes=arr.nbytes, put_s=put_s, get_s=get_s,
                   put_gb_s=gb / put_s, get_gb_s=gb / get_s,
                   actor_get_and_hash_s=actor_get_s, bitwise=bitwise,
                   actor_digest_equal=digest == want_digest)
    log(f"RUNTIME put/get 256 MB: {json.dumps(put_get)}  [{card}]")
    check(bitwise and digest == want_digest, "256 MB put/get did not "
          "round-trip bitwise")
    del arr, back, ref

    # -- a second GPU actor waits while the first holds the card, and is
    # placed on the freed card once the first dies. The controller keeps
    # retrying a pending actor for about 12 s (60 tries, 0.2 s apart, as
    # the JAX package's controller does), then declares it dead, so the
    # first is killed well inside that. --
    err = ray_tpu_torch.get(actor.stop.remote(), timeout=120)
    check(err is None, f"the actor's engine failed: {err}")
    probe = ray_tpu_torch.remote(num_gpus=1)(RuntimeProbe).remote()
    probe_ref = probe.gpus.remote()
    ready, _ = ray_tpu_torch.wait([probe_ref], timeout=3)
    check(ready == [], "a second num_gpus=1 actor was placed while the "
          "first held the only GPU")
    ray_tpu_torch.kill(actor)
    got = ray_tpu_torch.get(probe_ref, timeout=300)
    check(got == pinned, f"the second actor got CUDA_VISIBLE_DEVICES="
          f"{got!r}, expected {pinned!r}")
    ray_tpu_torch.kill(probe)

    # -- the same requests on an in-process engine, same seed's weights --
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    eng = Engine(init_params(cfg, gen, device="cuda"), cfg, **RUNTIME_ENGINE)
    try:
        local, local_streams = _serve_and_time(eng, cfg, "in process", card,
                                               _local_launches)
    finally:
        eng.stop()
    check(eng.error is None, f"engine error: {eng.error}")
    same = [a == b for a, b in zip(streams, local_streams)]
    log(f"RUNTIME actor streams equal to the in-process engine's: {same}")
    check(all(same), f"the actor's greedy streams differ from the "
          f"in-process engine's: {same}")
    del eng
    torch.cuda.empty_cache()
    return dict(cluster_start_s=start_s, resources=res, pinned=pinned,
                actor=info, spawn=spawn, launches=timed["launches"],
                launches_per_prefill=timed["launches"] / len(PROMPT_LENS),
                streams_equal=same, through_actor=timed, in_process=local,
                streams=local_streams, put_get=put_get, card=card)


# ---------------------------------------------------------------------------
# phase 12: the trainer path (bench.py's phase A)
# ---------------------------------------------------------------------------

# bench.py:88-95: rows of 2,048 int32 tokens from RandomState(0), one
# block per batch (13 blocks)
TRAINER_BLOCKS = max(4, BENCH_WARMUP + BENCH_STEPS)
# this process's run of the worker's first steps, on the same weights
TRAINER_PARITY_STEPS = 3
# The same step on the same weights and batches on the same card: the
# kernels and cuBLAS pick the same algorithms in both processes, so the
# losses should agree to the bit; the bound leaves room for a library
# that picks another algorithm in another process (a few bf16 roundings,
# 2**-8 relative, averaged over the loss).
TRAINER_LOSS_RTOL = 1e-3


def _trainer_rows(vocab: int) -> np.ndarray:
    """bench.py:bench_framework's rows (:89-92), regenerated from the
    seed: [8 x 13, 2048] int32."""
    rng = np.random.RandomState(0)
    return np.stack([rng.randint(0, vocab, (BENCH_SEQ,), dtype=np.int32)
                     for _ in range(BENCH_BATCH * TRAINER_BLOCKS)])


def _trainer_loop(config):
    """bench.py:_train_loop (:45-76) in torch, in the TorchTrainer's GPU
    worker: the bench configuration through ``make_train_fns(cfg,
    ParallelContext.create(MeshConfig()))``, batches from the dataset
    shard's ``iter_torch_batches``. Reports tokens/s over the timed
    steps, every loss, each kernel's launches by variant over the timed
    steps (counts zeroed just before them), the host ms inside the
    iterator's ``next()`` per step, peak memory, the worker's
    ``torch_info()``, and the directory of one step profiled under
    ``ray_tpu_torch.train.profile()``. Self-contained: it is pickled by
    value into the worker."""
    import time

    import torch

    import ray_tpu_torch.train as rt
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.parallel import MeshConfig, ParallelContext
    from ray_tpu_torch.train.worker import torch_info

    t_loop = time.time()
    torch.backends.cuda.matmul.allow_tf32 = config["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = config["allow_tf32"]
    cfg = LlamaConfig(**config["model"])
    ctx = ParallelContext.create(MeshConfig())
    t_ctx = time.time()
    init, step = rt.make_train_fns(cfg, ctx)
    state = init(config["seed"])
    float(state["step"])
    t_state = time.time()
    it = iter(rt.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["batch"], ctx=ctx, drop_last=True))
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dkv": flash_bwd_dkv,
                "flash_bwd_dq": flash_bwd_dq}
    losses, next_ms = [], []

    def take():
        t = time.perf_counter()
        tokens = next(it)["tokens"]
        next_ms.append((time.perf_counter() - t) * 1e3)
        return tokens

    t_first = first_step_s = None
    for i in range(config["warmup"]):
        tokens = take()
        t = time.time()
        state, m = step(state, tokens)
        losses.append(m["loss"])
        if i == 0:  # a cold process: the step's first run
            float(m["loss"])
            t_first = time.time()
            first_step_s = t_first - t
    float(m["loss"])  # warm-up ends with a host read
    for w in wrappers.values():
        w.launches = 0
        w.launches_by_variant.clear()
    t0 = time.perf_counter()
    for _ in range(config["steps"]):
        tokens = take()
        state, m = step(state, tokens)
        losses.append(m["loss"])
    float(m["loss"])
    dt = time.perf_counter() - t0
    launches = {k: dict(w.launches_by_variant) for k, w in wrappers.items()}
    for leftover in it:  # drop_last: nothing is left
        raise RuntimeError(f"a batch past the timed steps: {leftover}")
    # the last batch again, profiled: its loss must have fallen since
    with rt.profile() as trace_dir:
        state, m = step(state, tokens)
        again = float(m["loss"])
    rt.report({
        "tokens_per_sec": config["batch"] * config["seq"] * config["steps"]
        / dt,
        "step_s": dt / config["steps"], "steps": config["steps"],
        "losses": [float(x) for x in losses], "launches": launches,
        "next_ms": next_ms, "trace_dir": trace_dir,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if torch.cuda.is_initialized() else None),
        "last_batch_again": again, "t_loop": t_loop, "t_ctx": t_ctx,
        "t_state": t_state, "t_first_step": t_first,
        "first_step_s": first_step_s, "info": torch_info()})


def _trace_device_ms(trace_dir: str) -> tuple:
    """(device ms, device op count) in the Chrome trace that
    ``ray_tpu_torch.train.profile()`` wrote: kernels, copies and sets, as
    ``_device_profile`` counts them."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sum(e.get("dur", 0) for e in ops) / 1e3, len(ops)


def phase_trainer(card: str, bench: dict) -> dict:
    """``TorchTrainer`` on ``bench.py``'s configuration in a GPU worker
    placed and pinned by the scheduler, fed by the streaming ingest; its
    launches, rate and losses against phase 8 and against an in-process
    run of the same steps."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    torch.cuda.empty_cache()
    log(f"TRAINER this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card before "
        f"fit()  [{card}]")
    t = time.perf_counter()
    ray_tpu_torch.init()
    start_s = time.perf_counter() - t
    trace_base = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        res = ray_tpu_torch.cluster_resources()
        check(res.get("GPU") == torch.cuda.device_count(),
              f"the agent advertises GPU {res.get('GPU')}, the card count "
              f"is {torch.cuda.device_count()}")
        rows = _trainer_rows(BENCH_MODEL["vocab_size"])
        ds = rdata.from_items([{"tokens": r} for r in rows],
                              num_blocks=TRAINER_BLOCKS)
        trainer = TorchTrainer(
            _trainer_loop,
            train_loop_config=dict(
                model=BENCH_MODEL, batch=BENCH_BATCH, seq=BENCH_SEQ,
                warmup=BENCH_WARMUP, steps=BENCH_STEPS, seed=SEED,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="trainer", storage_path=trace_base),
            datasets={"train": ds})
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        out = dict(result.metrics_history[-1])
        device_ms, device_ops = _trace_device_ms(out.pop("trace_dir"))
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(trace_base, ignore_errors=True)
    info = out["info"]
    pinned = accelerators.worker_env_for_gpus([0])["CUDA_VISIBLE_DEVICES"]
    check(info["cuda_visible_devices"] == pinned
          and info["cuda_device_count"] == 1 and info["device"] == "cuda:0",
          f"the worker was not pinned to one card: {info}")
    check(info["backend"] == "nccl", f"the worker's group: {info}")
    L = BENCH_MODEL["n_layers"]
    want = {"flash_fwd": {"bf16_d128": 2 * L * BENCH_STEPS},
            "flash_bwd_dkv": {"bf16_d128": L * BENCH_STEPS},
            "flash_bwd_dq": {"bf16_d128": L * BENCH_STEPS}}
    check(out["launches"] == want,
          f"launches in the worker's timed steps {out['launches']}, "
          f"expected {want}")
    per_step = {k: want[k]["bf16_d128"] / BENCH_STEPS for k in want}
    check(per_step == bench["launches_per_step"],
          f"launches per step: {per_step} in the worker, "
          f"{bench['launches_per_step']} in phase 8")
    # The batches are uniform random tokens, so a loss from one batch to
    # the next moves by its noise; the last batch, trained on once,
    # shows the step's effect.
    losses = out["losses"]
    check(all(np.isfinite(losses)) and out["last_batch_again"] < losses[-1],
          f"trainer: the last batch's loss did not fall once trained on: "
          f"{losses[-1]} -> {out['last_batch_again']} ({losses})")

    # the first steps again in this process, on the same weights and the
    # same batches regenerated from the seed
    cfg = LlamaConfig(**BENCH_MODEL)
    init_fn, step_fn = make_train_fns(
        cfg, ParallelContext.create(MeshConfig()))
    state = init_fn(SEED)
    mine = []
    for i in range(TRAINER_PARITY_STEPS):
        batch = torch.from_numpy(
            rows[i * BENCH_BATCH:(i + 1) * BENCH_BATCH]).to("cuda")
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        mine.append(m["loss"].item())
        if i == 0:  # the same first step in a warm process
            warm_first_step_s = time.perf_counter() - t
    del state, m
    torch.cuda.empty_cache()
    theirs = losses[:TRAINER_PARITY_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(theirs, mine))
    bitwise = theirs == mine
    check(rel <= TRAINER_LOSS_RTOL,
          f"trainer: worker losses {theirs}, in process {mine}")

    raw = bench["tokens_per_s"]
    overhead = (raw - out["tokens_per_sec"]) / raw * 100
    ingest = out["next_ms"][BENCH_WARMUP:]
    out.update(
        cluster_start_s=start_s, fit_s=fit_s,
        fit_to_loop_s=out["t_loop"] - t_fit,
        fit_to_context_s=out["t_ctx"] - t_fit,
        fit_to_state_s=out["t_state"] - t_fit,
        fit_to_first_step_s=out["t_first_step"] - t_fit,
        ingest_ms_per_batch=statistics.mean(ingest),
        ingest_ms_max=max(ingest),
        device_ms=device_ms, device_ops=device_ops,
        device_idle_share=1 - device_ms / (out["step_s"] * 1e3),
        raw_tokens_per_s=raw, framework_overhead_pct=overhead,
        in_process_losses=mine, losses_rel=rel, losses_bitwise=bitwise,
        in_process_first_step_s=warm_first_step_s,
        launches_per_step=per_step, card=card)
    log("TRAINER", json.dumps(out))
    log(f"TRAINER cluster up {start_s:.3f} s; fit() {fit_s:.2f} s, loop "
        f"entered {out['fit_to_loop_s']:.2f} s and first step done "
        f"{out['fit_to_first_step_s']:.2f} s after fit(); "
        f"(context {out['fit_to_context_s']:.2f} s, state "
        f"{out['fit_to_state_s']:.2f} s, first batch "
        f"{out['next_ms'][0] / 1e3:.2f} s, first step "
        f"{out['first_step_s']:.2f} s; in this process "
        f"{warm_first_step_s:.2f} s); "
        f"{out['tokens_per_sec']:.0f} tok/s in the worker against "
        f"{raw:.0f} raw (phase 8): framework_overhead {overhead:.2f}%; "
        f"ingest {out['ingest_ms_per_batch']:.3f} ms per batch (max "
        f"{out['ingest_ms_max']:.3f}); device idle "
        f"{out['device_idle_share'] * 100:.2f}% of a step; peak "
        f"{out['peak_mem_gb']:.2f} GB; losses vs in process rel {rel:.3g}"
        f" (bitwise {bitwise})  [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 13: the serve app on the card — mono, PD and batch inference
# ---------------------------------------------------------------------------

# Llama-3-8B's width, vocabulary and context through the serve preset, whose
# model follows the JAX package's rule (heads d_model / 128, KV heads
# d_model / 256, d_ff 2.75 d_model): 32 heads of 128, 16 KV heads, d_ff
# 11264, 8 KB of KV per token and layer. Random weights from seed 0. Depth
# cut from 32 to 8 layers (2.6 B parameters, 5.1 GB in bf16): at 32 the
# phase took 300 s of the run's 1,200 (its three bench_serve.py passes
# decode at about 9 tokens/s), and every check it makes (streams equal to
# the references, one forward per layer per prefill, every KV handoff by
# CUDA IPC) holds at any depth; phase 3 serves the full 32 layers.
SERVE_CFG = dict(vocab_size=128256, d_model=4096, n_layers=8, max_seq=8192,
                 max_ongoing_requests=8, decode_chunk=8, page_size=64)
SERVE_SAMPLED = dict(temperature=0.8, top_k=40, seed=1234)
# bench_serve.py's measurements: TTFT over 15 solo requests (a 16-token
# prompt, 8 new), decode over a 96-token stream (twice), aggregate
# tokens/s at 8 streams of 32 tokens
SERVE_TTFT_N, SERVE_TTFT_PROMPT, SERVE_TTFT_TOKENS = 15, 16, 8
SERVE_DECODE_TOKENS, SERVE_DECODE_RUNS = 96, 2
SERVE_AGG_STREAMS, SERVE_AGG_TOKENS = 8, 32
# build_llm_processor over 16 rows: phase 3's 8 prompts twice, 16 tokens
BATCH_ROWS, BATCH_TOKENS = 16, 16
# A replica's memory is back on the card this long after it is deleted
SERVE_FREE_TIMEOUT_S = 120


def _flash_launches(reset: bool) -> tuple:
    """(launches, by variant) of flash_fwd in this process; zeroed after
    the read with ``reset``."""
    from ray_tpu_torch.ops.attention import flash_fwd as fwd
    out = (fwd.launches, dict(fwd.launches_by_variant))
    if reset:
        fwd.launches = 0
        fwd.launches_by_variant.clear()
    return out


def _plane_stats():
    from ray_tpu_torch.experimental.device_plane import DevicePlane
    plane = DevicePlane.maybe()
    return plane.stats() if plane else None


class CountedLLMServer(LLMServer):
    """``LLMServer`` with a reader of the replica's kernel launches and a
    profile of its decode."""

    def launches(self, reset: bool = False) -> tuple:
        return _flash_launches(reset)

    def profile_decode(self) -> dict:
        """``_profile_chunk`` in this replica, while it serves nothing."""
        torch.cuda.set_device(self.engine.device)
        return _profile_chunk(self.engine)


class CountedPrefillServer(PrefillServer):
    """``PrefillServer`` with readers of the replica's kernel launches, of
    the device objects it still holds and of its transfer plane."""

    def launches(self, reset: bool = False) -> tuple:
        return _flash_launches(reset)

    def held(self) -> int:
        from ray_tpu_torch.core.ref import get_core_worker
        return len(get_core_worker()._device_objects)

    def plane(self):
        return _plane_stats()


class CountedDecodeServer(DecodeServer):
    """``DecodeServer`` with readers of the replica's kernel launches and
    of its transfer plane (how each KV handoff came)."""

    def launches(self, reset: bool = False) -> tuple:
        return _flash_launches(reset)

    def plane(self):
        return _plane_stats()

    def profile_handoff(self, meta: dict) -> dict:
        """One KV handoff (k and v, pulled and freed as ``decode_stream``
        does) under the profiler: the wall time; the plane's pulls (map,
        copy, unmap) against the rest (the RPC to the owner, its staging);
        the device's time and idle share; the host's longest calls."""
        from ray_tpu_torch.device_objects import device_get, free_ref
        from ray_tpu_torch.experimental.device_plane import DevicePlane

        dev = self.engine.device
        torch.cuda.set_device(dev)
        plane = DevicePlane.get()
        pull = plane.pull
        pull_s = []

        def timed_pull(desc, t0):
            t = time.perf_counter()
            try:
                return pull(desc, t0)
            finally:
                pull_s.append(time.perf_counter() - t)

        plane.pull = timed_pull
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        try:
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                ks = device_get(meta["k"], device=dev)
                vs = device_get(meta["v"], device=dev)
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t
        finally:
            del plane.pull
            free_ref(meta["k"])
            free_ref(meta["v"])
        dev_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3)
                       for e in prof.key_averages()), key=lambda kv: -kv[1])
        nbytes = sum(x.numel() * x.element_size() for x in (ks, vs))
        return dict(kv_mb=nbytes / 1e6, wall_ms=wall * 1e3,
                    pulls_ms=sum(pull_s) * 1e3,
                    rest_ms=(wall - sum(pull_s)) * 1e3,
                    device_ms=dev_us / 1e3,
                    device_idle_share=1 - dev_us / 1e3 / (wall * 1e3),
                    top_host_self_ms=dict(host[:8]))


def _profile_handoffs(pre, dec, prompts: list) -> dict:
    """A small (16-token) and a large (the 8,000-token prompt, bucket
    8192) prefill, each handed to ``profile_handoff`` in the decode
    replica. The prefill's response is held until the pull is done, as
    ``PDIngress`` holds it."""
    out = {}
    for label, prompt in (("16_tokens", list(range(1, 17))),
                          ("8000_tokens", prompts[-1])):
        resp = pre.options(method_name="prefill").remote(
            {"prompt": prompt, "max_tokens": 2})
        meta = resp.result(timeout=300)
        out[label] = _call(dec, "profile_handoff", meta)
        del meta, resp
    return out


def counted_llm_app(cfg: LLMConfig):
    """``build_llm_app(cfg)`` with ``CountedLLMServer``: every option and
    argument the same."""
    app = build_llm_app(cfg)
    dep = app.deployment
    return Application(Deployment(CountedLLMServer, dep.name, dep._config),
                       app.init_args, app.init_kwargs)


def counted_pd_deployments(cfg: LLMConfig, name: str, n_prefill: int,
                           n_decode: int) -> tuple:
    """``run_pd_llm_app``'s three deployments, the pools' classes swapped
    for the counted subclasses, every option the same."""
    pre, dec, ing = _pd_deployments(cfg, name, n_prefill, n_decode)
    return (Deployment(CountedPrefillServer, pre.name, pre._config),
            Deployment(CountedDecodeServer, dec.name, dec._config), ing)


def run_counted_pd(cfg: LLMConfig, name: str):
    """``run_pd_llm_app(cfg, name=name)`` on the counted deployments, one
    replica per pool: (ingress, prefill, decode) handles."""
    pre, dec, ing = counted_pd_deployments(cfg, name, 1, 1)
    h_ing = _deploy_pd(cfg, pre, dec, ing)
    return (h_ing, serve.get_deployment_handle(pre.name),
            serve.get_deployment_handle(dec.name))


def _call(handle, method: str, *args):
    return handle.options(method_name=method).remote(*args).result(
        timeout=120)


def _http_request(port: int, path: str, body: dict) -> tuple:
    """One streamed completion through the proxy, read a byte at a time
    as bench_serve.py reads it (``read(n)`` would wait to gather n bytes
    across chunks): (TTFT s, total s, token ids)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"x-serve-stream": "1"})
    t0 = time.perf_counter()
    ttft, buf = None, bytearray()
    with urllib.request.urlopen(req, timeout=900) as resp:
        while chunk := resp.read(1):
            if ttft is None:
                ttft = time.perf_counter() - t0
            buf += chunk
    total = time.perf_counter() - t0
    text = buf.decode()
    check(bool(text) and all(t.isdigit() for t in text.split()),
          f"{path}: the stream is not token ids: {text[:200]!r}")
    return ttft, total, [int(t) for t in text.split()]


def _wait_route(port: int, path: str) -> float:
    """Wait until the proxy's table routes ``path``, as a client of a new
    deployment does: the proxy refreshes its table on a miss at most once
    per 2 s (``RouteTable._NEG_CACHE_TTL_S``, as the JAX package's does),
    so a burst at a route it has not seen would mostly get 404s. Its
    ``/-/routes`` endpoint refreshes the table; seconds waited."""
    t0 = time.perf_counter()
    while True:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/routes",
                                    timeout=30) as resp:
            if path in json.loads(resp.read()):
                return time.perf_counter() - t0
        check(time.perf_counter() - t0 < 60, f"the proxy never routed "
              f"{path}")
        time.sleep(0.5)


def _http_concurrent(port: int, path: str, bodies: list) -> list:
    """Every body at once from its own thread: [(TTFT, total, ids)]."""
    out = [None] * len(bodies)
    errors = []
    barrier = threading.Barrier(len(bodies))

    def run(i):
        barrier.wait()
        try:
            out[i] = _http_request(port, path, bodies[i])
        except Exception as e:  # re-raised below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not errors and all(o is not None for o in out),
          f"{path}: concurrent requests failed: {errors}")
    return out


def _stream_bench(submit) -> dict:
    """bench_serve.py's numbers over ``submit(body) -> (TTFT, total,
    ids)``: one warm-up, p50 / p95 TTFT over 15 solo requests of a
    16-token prompt, decode tokens/s over a 96-token stream (mean of 2),
    aggregate tokens/s at 8 streams of 32 tokens."""
    def body(n):
        return {"prompt": list(range(1, SERVE_TTFT_PROMPT + 1)),
                "max_tokens": n}

    submit(body(SERVE_TTFT_TOKENS))
    ttfts = sorted(submit(body(SERVE_TTFT_TOKENS))[0] * 1e3
                   for _ in range(SERVE_TTFT_N))
    rates = []
    for _ in range(SERVE_DECODE_RUNS):
        ttft, total, ids = submit(body(SERVE_DECODE_TOKENS))
        check(len(ids) == SERVE_DECODE_TOKENS, f"decode stream gave "
              f"{len(ids)} tokens")
        rates.append((len(ids) - 1) / (total - ttft))
    out = [None] * SERVE_AGG_STREAMS

    def run(i):
        out[i] = submit(body(SERVE_AGG_TOKENS))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(SERVE_AGG_STREAMS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(all(o is not None and len(o[2]) == SERVE_AGG_TOKENS for o in out),
          "aggregate streams failed")
    return dict(ttft_p50_ms=ttfts[len(ttfts) // 2],
                ttft_p95_ms=ttfts[min(len(ttfts) - 1,
                                      int(len(ttfts) * 0.95))],
                ttft_all_ms=ttfts, decode_tok_s=sum(rates) / len(rates),
                agg_tok_s=SERVE_AGG_STREAMS * SERVE_AGG_TOKENS / wall)


def _engine_submit(eng):
    """``_stream_bench``'s submit on an in-process engine."""
    def submit(body):
        t0 = time.perf_counter()
        times, toks = [], []
        _drain(eng.submit(body["prompt"], body["max_tokens"]), times, toks)
        return times[0][0] - t0, times[-1][0] - t0, toks
    return submit


def _wait_for_card(free_before: int, what: str) -> float:
    """Wait until the card's free memory is back within 2 GB of
    ``free_before`` (a deleted replica's process has exited); seconds."""
    t0 = time.perf_counter()
    deadline = t0 + SERVE_FREE_TIMEOUT_S
    while torch.cuda.mem_get_info()[0] < free_before - 2e9:
        check(time.perf_counter() < deadline,
              f"{what}: the card's memory did not come back "
              f"({torch.cuda.mem_get_info()[0] / 1e9:.1f} GB free, "
              f"{free_before / 1e9:.1f} before)")
        time.sleep(0.5)
    return time.perf_counter() - t0


def _plane_delta(after: dict, before, key: str) -> dict:
    """A route counter of a replica's plane between two reads (None: the
    plane was not started yet)."""
    return {r: v - (before[key][r] if before else 0)
            for r, v in after[key].items()}


def _handoff(after: dict, before, n_req: int) -> dict:
    """KV handoff cost per request by CUDA IPC between two reads."""
    nbytes = _plane_delta(after, before, "bytes_by_route")["cuda_ipc"]
    secs = _plane_delta(after, before, "seconds_by_route")["cuda_ipc"]
    return dict(requests=n_req, kv_mb_per_request=nbytes / n_req / 1e6,
                handoff_ms_per_request=secs / n_req * 1e3,
                ipc_gb_s=nbytes / secs / 1e9 if secs else None)


def _mem_line(what: str, card: str) -> int:
    free, total = torch.cuda.mem_get_info()
    log(f"SERVE {what}: {free / 1e9:.2f} of {total / 1e9:.2f} GB free on "
        f"the card; this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB  [{card}]")
    return free


def phase_serve(card: str, engine: dict = None) -> dict:
    """The serve app on Llama-3-8B's width and depth: reference streams
    from an in-process engine, then the mono app (``build_llm_app``,
    ``num_gpus=1``) and the PD app (``run_pd_llm_app``, both pools with
    ``num_gpus=0`` on the one card) through the HTTP proxy, then
    ``build_llm_processor`` over a dataset; each against the references,
    with launches read in the replicas."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data.llm import build_llm_processor

    torch.cuda.empty_cache()
    free0 = _mem_line("at the phase's start", card)
    cfg = LLMConfig(num_gpus=1, **SERVE_CFG)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]

    # -- 1. reference streams: an in-process engine on the same weights --
    t = time.perf_counter()
    eng = _engine(cfg)
    build_s = time.perf_counter() - t
    try:
        refs = [toks for _, _, toks in _run_concurrent(
            eng, [(p, MAX_TOKENS, {}) for p in prompts])]
        inproc = _stream_bench(_engine_submit(eng))
    finally:
        eng.stop()
    check(eng.error is None, f"engine error: {eng.error}")
    del eng
    torch.cuda.empty_cache()
    log(f"SERVE in-process engine (built in {build_s:.1f} s): "
        f"{json.dumps({k: v for k, v in inproc.items() if k != 'ttft_all_ms'})}"
        f"  [{card}]")
    free1 = _mem_line("the reference engine freed", card)

    t = time.perf_counter()
    ray_tpu_torch.init()
    out = dict(cluster_start_s=time.perf_counter() - t, in_process=inproc,
               reference_engine_build_s=build_s, card=card)
    try:
        serve.start(http=True)
        port = serve.get_proxy().port
        bodies = [{"prompt": p, "max_tokens": MAX_TOKENS} for p in prompts]

        # -- 2. mono: build_llm_app, num_gpus=1 --
        t = time.perf_counter()
        mono = serve.run(counted_llm_app(cfg), name="llm")
        out["mono_ready_s"] = time.perf_counter() - t
        _wait_route(port, "/llm")
        _call(mono, "launches", True)
        res = _http_concurrent(port, "/llm", bodies)
        n, by_variant = _call(mono, "launches", True)
        same = [r[2] == want for r, want in zip(res, refs)]
        log(f"SERVE mono: ready in {out['mono_ready_s']:.1f} s; 8 "
            f"concurrent requests over HTTP equal the references: {same}; "
            f"flash_fwd launches in the replica {n} {by_variant}")
        check(all(same), f"mono streams differ from the in-process "
              f"engine's: {same}")
        check(n == cfg.n_layers * len(prompts)
              and by_variant == {"bf16_d128": n},
              f"mono replica: flash_fwd launched {n} times ({by_variant}), "
              f"expected {cfg.n_layers} per prefill x {len(prompts)}")
        out["launches_mono"] = n
        sampled = dict(bodies[1], **SERVE_SAMPLED)
        mono_sampled = _http_request(port, "/llm", sampled)[2]
        out["mono"] = _stream_bench(
            lambda b: _http_request(port, "/llm", b))
        log(f"SERVE mono over HTTP: "
            f"{json.dumps({k: v for k, v in out['mono'].items() if k != 'ttft_all_ms'})}"
            f"  [{card}]")
        out["mono_decode_profile"] = _call(mono, "profile_decode")
        log(f"SERVE mono replica, one decode chunk of 8 steps, 8 slots: "
            f"{json.dumps(out['mono_decode_profile'])}  [{card}]")
        serve.delete("llm")
        out["mono_freed_s"] = _wait_for_card(free1, "mono deleted")

        # -- 3. PD: two pools on the one card, num_gpus=0 --
        cfg_pd = dataclasses.replace(cfg, num_gpus=0)
        t = time.perf_counter()
        pd, pre, dec = run_counted_pd(cfg_pd, "pd")
        out["pd_ready_s"] = time.perf_counter() - t
        _mem_line("the PD pools up", card)
        _wait_route(port, "/pd")
        _call(pre, "launches", True)
        _call(dec, "launches", True)
        plane0 = _call(dec, "plane")
        res = _http_concurrent(port, "/pd", bodies)
        n_pre, by_pre = _call(pre, "launches", True)
        n_dec, by_dec = _call(dec, "launches", True)
        same = [r[2] == want for r, want in zip(res, refs)]
        log(f"SERVE PD: ready in {out['pd_ready_s']:.1f} s; 8 concurrent "
            f"requests equal the references: {same}; flash_fwd launches: "
            f"prefill {n_pre} {by_pre}, decode {n_dec} {by_dec}")
        check(all(same), f"PD streams differ from the references: {same}")
        check(n_pre == cfg.n_layers * len(prompts)
              and by_pre == {"bf16_d128": n_pre} and n_dec == 0,
              f"PD: flash_fwd launched {n_pre} times in the prefill pool "
              f"({by_pre}) and {n_dec} in the decode pool, expected "
              f"{cfg.n_layers} per prefill x {len(prompts)} and 0")
        out["launches_prefill"], out["launches_decode"] = n_pre, n_dec
        pd_sampled = _http_request(port, "/pd", sampled)[2]
        check(pd_sampled == mono_sampled, f"PD sampled stream "
              f"{pd_sampled} differs from the mono app's {mono_sampled}")
        plane_mid = _call(dec, "plane")
        out["pd"] = _stream_bench(lambda b: _http_request(port, "/pd", b))
        plane1 = _call(dec, "plane")
        out["handoff_profile"] = _profile_handoffs(pre, dec, prompts)
        log(f"SERVE PD decode replica, KV handoffs under the profiler: "
            f"{json.dumps(out['handoff_profile'])}  [{card}]")
        held = _call(pre, "held")
        # Every request through /pd: the 8 and the sampled one, then the
        # bench's 1 + 15 + 2 + 8 of a 16-token prompt; each hands over k
        # and v.
        n_burst = len(bodies) + 1
        n_small = 1 + SERVE_TTFT_N + SERVE_DECODE_RUNS + SERVE_AGG_STREAMS
        n_req = n_burst + n_small
        pulls = _plane_delta(plane1, plane0, "pulls_by_route")
        handoff = dict(requests=n_req, pulls=pulls,
                       burst=_handoff(plane_mid, plane0, n_burst),
                       small=_handoff(plane1, plane_mid, n_small),
                       prefill_holds_after=held)
        out["handoff"] = handoff
        log(f"SERVE PD over HTTP: "
            f"{json.dumps({k: v for k, v in out['pd'].items() if k != 'ttft_all_ms'})};"
            f" KV handoffs {json.dumps(handoff)}  [{card}]")
        check(pulls == {"cuda_ipc": 2 * n_req, "host_relay": 0},
              f"PD handoffs: {pulls}, expected k and v of {n_req} requests "
              f"by CUDA IPC and none by the host relay")
        check(held == 0, f"the prefill replica still holds {held} device "
              f"objects after the streams ended")
        serve.shutdown()
        out["pd_freed_s"] = _wait_for_card(free1, "PD shut down")

        # -- 4. batch inference over a dataset --
        rows = [{"prompt": prompts[i % len(prompts)], "row": i}
                for i in range(BATCH_ROWS)]
        t = time.perf_counter()
        proc = build_llm_processor(cfg, max_tokens=BATCH_TOKENS,
                                   concurrency=1)
        got = sorted(proc(rdata.from_items(rows)).take_all(),
                     key=lambda r: r["row"])
        out["batch_s"] = time.perf_counter() - t
        same = [np.asarray(r["generated"]).tolist()
                == refs[r["row"] % len(prompts)][:BATCH_TOKENS] for r in got]
        log(f"SERVE build_llm_processor: {len(got)} rows in "
            f"{out['batch_s']:.1f} s (actor start included), generated "
            f"equal to the references: {same}  [{card}]")
        check(len(got) == BATCH_ROWS and all(same),
              f"batch inference differs from the references: {same}")
        out["batch_equal"] = same
        if engine is not None:  # phase 3, same run: in process, full traffic
            out["phase3_ttft_idle_s"] = engine["ttft_idle_s"]
        log(f"SERVE TTFT p50 ms: in process {inproc['ttft_p50_ms']:.1f}, "
            f"mono over HTTP {out['mono']['ttft_p50_ms']:.1f}, PD over HTTP "
            f"{out['pd']['ttft_p50_ms']:.1f}; decode tok/s {inproc['decode_tok_s']:.1f}"
            f" / {out['mono']['decode_tok_s']:.1f} / "
            f"{out['pd']['decode_tok_s']:.1f}  [{card}]")
    finally:
        with contextlib.suppress(Exception):
            serve.shutdown()
        ray_tpu_torch.shutdown()
    return out


# ---------------------------------------------------------------------------
# Phase 14: the device edges on one card. Three num_gpus=0 actors share it
# (a worker given no GPU sees every card, as phase 13's PD pools do).
# ---------------------------------------------------------------------------
# Channels carry bf16 tensors of 4 KB and 256 MB (EDGE_CHANNEL_ROUNDS writes
# per size and route, capacity 2); the DAG's transport and allreduce f32
# tensors of 64 MB (and the allreduce's sum once in bf16); the host-plane
# collectives tensors of 1 MB.
EDGE_CHANNEL_BYTES = (4 * 1024, 256 * 2**20)
EDGE_CHANNEL_ROUNDS = 3
EDGE_DAG_BYTES = 64 * 2**20
EDGE_AR_OPS = ("sum", "mean", "max", "min", "prod")
EDGE_DAG_REPEATS = 20
EDGE_COLL_BYTES = 2**20
EDGE_COLL_REPEATS = 10
EDGE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The writer's allocated bytes after the last release may exceed those
# before the first write by no more than this (the caching allocator's
# rounding; an item left in the table would be 256 MB).
EDGE_MEM_SLACK = 2**20


def _edge_tensor(spec: tuple, seed: int, device) -> torch.Tensor:
    """The tensor of ``spec`` = (bytes, dtype name) that a participant with
    ``seed`` makes: normal draws from a seeded generator on ``device``, so
    any process there makes it again bit for bit."""
    nbytes, dt = spec
    dtype = EDGE_DTYPES[dt]
    numel = nbytes // torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(numel, generator=gen, device=device).to(dtype)


def _edge_reduce(parts: list, op: str) -> torch.Tensor:
    """The DAG allreduce's arithmetic, in rank order (``CoreWorker.
    _builtin_dag_allreduce``): the result each output must equal."""
    acc = parts[0]
    for p in parts[1:]:
        acc = {"sum": torch.add, "mean": torch.add, "max": torch.maximum,
               "min": torch.minimum, "prod": torch.mul}[op](acc, p)
    return acc / len(parts) if op == "mean" else acc


def _median_ms(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


class EdgeActor(CollectiveMixin):
    """A participant of phase 14: makes its tensors on the card, reads
    channels, runs DAG nodes and the host-plane collectives, and reports
    its plane's counters and its allocated bytes."""

    def __init__(self, rank: int, device: str = "cuda"):
        self.rank = rank
        self.device = torch.device(device)

    def ready(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.init()
            return torch.cuda.get_device_name(0)
        return "cpu"

    def part(self, spec: tuple) -> torch.Tensor:
        return _edge_tensor(spec, 100 + self.rank, self.device)

    def check(self, t: torch.Tensor, spec: tuple, src_rank: int) -> bool:
        """``t`` is bit for bit rank ``src_rank``'s part, on this
        process's device."""
        return (t.device.type == self.device.type
                and torch.equal(t, _edge_tensor(spec, 100 + src_rank,
                                                self.device)))

    def check_mean(self, t: torch.Tensor, spec: tuple, world: int) -> bool:
        want = _edge_reduce([_edge_tensor(spec, 100 + r, self.device)
                             for r in range(world)], "mean")
        return t.device.type == self.device.type and torch.equal(t, want)

    def write_channel(self, ch, spec: tuple, seed: int) -> tuple:
        """Write one item: the write's wall ms, and this process's
        allocated bytes while the channel holds it."""
        x = _edge_tensor(spec, seed, self.device)
        _sync(self.device)
        t = time.perf_counter()
        ch.write(x, timeout=120)
        ms = (time.perf_counter() - t) * 1e3
        del x
        return ms, _allocated(self.device)

    def read_channel(self, ch, spec: tuple, seed: int) -> dict:
        """Read one item: its wall ms and whether it is, bit for bit and on
        this process's device, what the writer made from ``seed``."""
        t = time.perf_counter()
        x = ch.read(timeout=120)
        _sync(self.device)
        ms = (time.perf_counter() - t) * 1e3
        ok = (x.device.type == self.device.type
              and torch.equal(x, _edge_tensor(spec, seed, self.device)))
        return {"ms": ms, "equal": bool(ok)}

    def stats(self):
        plane = device_plane.DevicePlane.maybe()
        return plane.stats() if plane else None

    def allocated(self) -> int:
        return _allocated(self.device)

    def table_size(self) -> int:
        from ray_tpu_torch.core.ref import get_core_worker
        return len(get_core_worker()._device_objects)

    def collectives(self, nbytes: int, dt: str, repeats: int) -> dict:
        """Each host-plane collective on this rank's tensor of ``nbytes``
        (its rank + 1 everywhere): right values, on this device, in the
        expected dtype; then the median ms of each over ``repeats``."""
        from ray_tpu_torch import collective as col

        dtype = EDGE_DTYPES[dt]
        world = col.get_collective_group_size("edges")
        # about nbytes: a multiple of the world for reducescatter
        numel = (nbytes // torch.empty((), dtype=dtype).element_size()
                 // world * world)
        x = torch.full((numel,), float(self.rank + 1), device=self.device,
                       dtype=dtype)
        total = float(world * (world + 1) // 2)

        def same(t, value, n=numel):
            return (t.device.type == self.device.type and t.dtype == dtype
                    and t.numel() == n
                    and bool((t.float() == value).all()))

        calls = {
            "allreduce": (lambda: col.allreduce(x, "edges"),
                          lambda t: same(t, total)),
            "allgather": (lambda: col.allgather(x, "edges"),
                          lambda ts: all(same(t, r + 1.0)
                                         for r, t in enumerate(ts))),
            "broadcast": (lambda: col.broadcast(x, 1, "edges"),
                          lambda t: same(t, 2.0)),
            "reducescatter": (lambda: col.reducescatter(x, "edges"),
                              lambda t: same(t, total, numel // world)),
            "barrier": (lambda: col.barrier("edges"), lambda r: r is None),
        }
        out = {"ok": {}, "ms": {}}
        for name, (call, good) in calls.items():
            out["ok"][name] = bool(good(call()))
            out["ms"][name] = _median_ms(call, repeats)
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _allocated(device: torch.device) -> int:
    """This process's allocated bytes on the card, once the blocks it
    shared by CUDA IPC and its peers have let go are collected."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.ipc_collect()
    return torch.cuda.memory_allocated()


def _route_sum(stats: list, key: str) -> dict:
    out: dict = {}
    for st in stats:
        for k, v in (st or {}).get(key, {}).items():
            out[k] = out.get(k, 0) + v
    return out


def phase_edges(card: str) -> dict:
    """Phase 14 on the card: ``ray_tpu_torch.init()``, then
    ``_phase_edges``."""
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ray_tpu_torch.init()
    start_s = time.perf_counter() - t
    try:
        out = _phase_edges(card, "cuda", start_s)
    finally:
        ray_tpu_torch.shutdown()
    out["phase_s"] = time.perf_counter() - t
    log(f"EDGES phase 14 took {out['phase_s']:.1f} s  [{card}]")
    return out


def _phase_edges(card: str, device: str, start_s: float = 0.0,
                 channel_bytes=EDGE_CHANNEL_BYTES, dag_bytes=EDGE_DAG_BYTES,
                 coll_bytes=EDGE_COLL_BYTES, repeats=EDGE_DAG_REPEATS
                 ) -> dict:
    """Device channels (this process to an actor, an actor to an actor,
    capacity 1's backpressure), the DAG's tensor transport and allreduce,
    and the host-plane collectives, among three actors on ``device``.
    On a card every channel read and every DAG pull must go by CUDA IPC;
    the sizes are arguments so that the phase can run on the CPU, small,
    where every pull is a host relay."""
    from ray_tpu_torch.core.ref import get_core_worker

    dev = torch.device(device)
    ipc = dev.type == "cuda"
    route = device_plane.ROUTE_IPC if ipc else device_plane.ROUTE_HOST
    other = device_plane.ROUTE_HOST if ipc else device_plane.ROUTE_IPC
    t = time.perf_counter()
    actors = [ray_tpu_torch.remote(num_gpus=0)(EdgeActor).remote(r, device)
              for r in range(3)]
    names = ray_tpu_torch.get([a.ready.remote() for a in actors],
                              timeout=300)
    out = dict(card=card, cluster_start_s=start_s,
               actors_ready_s=time.perf_counter() - t)
    log(f"EDGES cluster up in {start_s:.2f} s; 3 num_gpus=0 actors on "
        f"{names} in {out['actors_ready_s']:.2f} s  [{card}]")
    a0, a1, a2 = actors
    reads = 0  # pulls the phase makes, each by ``route``
    here0 = device_plane.DevicePlane.get().stats()  # this process's so far

    # -- 1. channels: this process -> a0, then a1 -> a0, capacity 2 --
    chans = []
    base = _allocated(dev)
    for label, writer in (("driver->actor", None), ("actor->actor", a1)):
        ch = DeviceChannel.create([a0], capacity=2)
        w_base = base if writer is None else ray_tpu_torch.get(
            writer.allocated.remote())
        held = 0  # the writer's allocated bytes while it holds an item
        for nbytes in channel_bytes:
            spec = (nbytes, "bf16")
            writes, got = [], []
            for i in range(EDGE_CHANNEL_ROUNDS):
                # Each write completes before its read starts (capacity 2
                # lets it), so a read's time is the pull alone.
                seed = 1000 + i
                if writer is None:
                    x = _edge_tensor(spec, seed, dev)
                    _sync(dev)
                    t = time.perf_counter()
                    ch.write(x, timeout=120)
                    writes.append((time.perf_counter() - t) * 1e3)
                    del x  # the channel holds it until the reader releases
                    held = max(held, _allocated(dev))
                else:
                    ms, alloc = ray_tpu_torch.get(writer.write_channel.remote(
                        ch, spec, seed), timeout=300)
                    writes.append(ms)
                    held = max(held, alloc)
                got.append(ray_tpu_torch.get(
                    a0.read_channel.remote(ch, spec, seed), timeout=300))
                reads += 1
            check(all(g["equal"] for g in got),
                  f"channel {label} {nbytes} B: a read differs from the "
                  f"write")
            read_ms = statistics.median(g["ms"] for g in got)
            row = dict(route=label, bytes=nbytes,
                       write_ms=statistics.median(writes), read_ms=read_ms,
                       read_gb_s=nbytes / read_ms / 1e6,
                       write_ms_all=writes, read_ms_all=[g["ms"] for g in got])
            chans.append(row)
            log(f"EDGES channel {label} bf16 {nbytes} B: write "
                f"{row['write_ms']:.3f} ms, read {read_ms:.3f} ms "
                f"({row['read_gb_s']:.2f} GB/s), medians of "
                f"{EDGE_CHANNEL_ROUNDS}  [{card}]")
        after = (_allocated(dev) if writer is None else
                 ray_tpu_torch.get(writer.allocated.remote()))
        log(f"EDGES channel {label}: the writer's allocated bytes "
            f"{w_base} before the first write, at most {held} while it "
            f"held an item, {after} after the last release  [{card}]")
        check(held >= w_base + channel_bytes[-1] or not ipc,
              f"channel {label}: the writer's allocated bytes ({held}) "
              f"never held the item")
        check(after <= w_base + EDGE_MEM_SLACK,
              f"channel {label}: the writer holds {after - w_base} more "
              f"bytes after every release")
        if writer is None:
            check(not get_core_worker()._channel_items.get(ch.channel_id),
                  "channel driver->actor: released items left in the "
                  "writer's table")
        ch.close()
    out["channels"] = chans

    # -- 2. capacity 1: a second write times out until the reader releases
    spec = (channel_bytes[0], "bf16")
    ch = DeviceChannel.create([a0], capacity=1)
    ch.write(_edge_tensor(spec, 1, dev), timeout=60)
    t = time.perf_counter()
    try:
        ch.write(_edge_tensor(spec, 2, dev), timeout=1.5)
        blocked = False
    except TimeoutError:
        blocked = True
    blocked_s = time.perf_counter() - t
    check(blocked, "capacity 1: the second write did not wait for the "
          "reader's release")
    check(ray_tpu_torch.get(a0.read_channel.remote(ch, spec, 1))["equal"],
          "capacity 1: the first read differs")
    ch.write(_edge_tensor(spec, 2, dev), timeout=60)
    check(ray_tpu_torch.get(a0.read_channel.remote(ch, spec, 2))["equal"],
          "capacity 1: the read after the release differs")
    reads += 2
    ch.close()
    out["backpressure_timeout_s"] = blocked_s
    log(f"EDGES capacity 1: the second write timed out after "
        f"{blocked_s:.2f} s until the reader released  [{card}]")

    # -- 3. DAG transport: a0.part -> a1.check, 64 MB f32 --
    spec = (dag_bytes, "f32")
    st0 = ray_tpu_torch.get([a.stats.remote() for a in actors])
    with InputNode() as inp:
        t_node = a0.part.bind(inp).with_tensor_transport()
        dag = a1.check.bind(t_node, inp, 0)
    compiled = dag.experimental_compile()
    check(ray_tpu_torch.get(compiled.execute(spec), timeout=300),
          "DAG transport: the consumer's tensor differs")
    check(ray_tpu_torch.get(compiled.execute(spec), timeout=300),
          "DAG transport: the replay's tensor differs")
    st1 = ray_tpu_torch.get([a.stats.remote() for a in actors])
    staged = (st1[0] or {}).get("staged", 0) - (st0[0] or {}).get(
        "staged", 0)
    pulled = _plane_delta(st1[1], st0[1], "pulls_by_route")
    check(pulled[route] == 2 and pulled[other] == 0,
          f"DAG transport: the consumer's pulls {pulled}, expected 2 by "
          f"{route}")
    check(staged == (2 if ipc else 0),
          f"DAG transport: the producer staged {staged}")
    reads += 2
    with_ms = _median_ms(
        lambda: ray_tpu_torch.get(compiled.execute(spec), timeout=300),
        repeats)
    reads += repeats
    with InputNode() as inp:
        host_dag = a1.check.bind(a0.part.bind(inp), inp, 0)
    host_compiled = host_dag.experimental_compile()
    check(ray_tpu_torch.get(host_compiled.execute(spec), timeout=300),
          "DAG without tensor transport: the consumer's tensor differs")
    without_ms = _median_ms(
        lambda: ray_tpu_torch.get(host_compiled.execute(spec), timeout=300),
        repeats)
    out["dag_transport"] = dict(
        bytes=dag_bytes, staged=staged, pulls=pulled,
        execute_ms_with_transport=with_ms,
        execute_ms_without_transport=without_ms, repeats=repeats)
    log(f"EDGES DAG a0.part -> a1.check, f32 {dag_bytes} B: execute "
        f"{with_ms:.2f} ms with tensor transport, {without_ms:.2f} ms "
        f"without (the host object path), medians of {repeats}; staged "
        f"{staged}, pulls {pulled}  [{card}]")

    # -- 4. DAG allreduce over the three actors --
    ars = []
    for op, dt in [(op, "f32") for op in EDGE_AR_OPS] + [("sum", "bf16")]:
        spec = (dag_bytes, dt)
        with InputNode() as inp:
            outs = allreduce([a.part.bind(inp) for a in actors], op=op)
            dag = MultiOutputNode(outs)
        compiled = dag.experimental_compile()
        t = time.perf_counter()
        drefs = ray_tpu_torch.get(compiled.execute(spec), timeout=300)
        first_ms = (time.perf_counter() - t) * 1e3
        want = _edge_reduce([_edge_tensor(spec, 100 + r, dev)
                             for r in range(3)], op)
        same = [bool(torch.equal(device_get(
                    d, device=None if ipc else "cpu", timeout=120), want))
                for d in drefs]
        check(all(same), f"DAG allreduce {op} {dt}: outputs equal to the "
              f"rank-order reduction: {same}")
        # rank 0 pulls 2 peers, ranks 1 and 2 the result, this process the
        # three outputs
        reads += 2 + 2 + 3
        del drefs
        ms = _median_ms(lambda: ray_tpu_torch.get(
            compiled.execute(spec), timeout=300), 5)
        reads += 4 * 5
        ars.append(dict(op=op, dtype=dt, bytes=dag_bytes,
                        first_ms=first_ms, ms=ms))
        log(f"EDGES DAG allreduce {op} {dt} 3 x {dag_bytes} B: outputs "
            f"bitwise equal to the rank-order reduction; {ms:.2f} ms "
            f"(median of 5; the first {first_ms:.2f} ms)  [{card}]")
    spec = (dag_bytes, "f32")
    with InputNode() as inp:
        outs = allreduce([a.part.bind(inp) for a in actors], op="mean")
        # Every rank's output is an output of the DAG, so that all three
        # run (rank 1's waits for rank 0's); a0 consumes rank 1's, after
        # its own rank's task (an actor runs its tasks in order).
        dag = MultiOutputNode([outs[0], outs[2],
                               a0.check_mean.bind(outs[1], inp, 3)])
    fed = ray_tpu_torch.get(dag.experimental_compile().execute(spec),
                            timeout=300)
    check(fed[2] is True,
          "DAG allreduce mean -> consumer: the consumer's tensor differs")
    del fed
    reads += 4 + 1
    out["dag_allreduce"] = ars

    # -- 5. the host-plane collectives over the coordinator actor --
    init_collective_group(actors, "edges")
    colls = {}
    for dt in ("f32", "bf16"):
        res = ray_tpu_torch.get(
            [a.collectives.remote(coll_bytes, dt, EDGE_COLL_REPEATS)
             for a in actors], timeout=300)
        check(all(all(r["ok"].values()) for r in res),
              f"collectives {dt}: {[r['ok'] for r in res]}")
        colls[dt] = {k: statistics.median(r["ms"][k] for r in res)
                     for k in res[0]["ms"]}
        log(f"EDGES collectives {dt} {coll_bytes} B through the "
            f"coordinator actor, ms (median over ranks of each rank's "
            f"median of {EDGE_COLL_REPEATS}): {json.dumps(colls[dt])}  "
            f"[{card}]")
    out["collectives"] = dict(bytes=coll_bytes, ms=colls)

    # -- every pull of the phase went by ``route`` --
    final = ray_tpu_torch.get([a.stats.remote() for a in actors])
    here = device_plane.DevicePlane.get().stats()
    final.append({k: _plane_delta(here, here0, k)
                  for k in ("pulls_by_route", "relays_by_reason")})
    by_route = _route_sum(final, "pulls_by_route")
    relays = _route_sum(final, "relays_by_reason")
    out.update(pulls_by_route=by_route, relays_by_reason=relays,
               pulls_expected=reads)
    log(f"EDGES pulls by route over the phase: {by_route}, host relays by "
        f"reason {relays} ({reads} expected by {route})  [{card}]")
    check(by_route.get(route, 0) == reads and by_route.get(other, 0) == 0,
          f"pulls {by_route}: expected {reads}, all by {route}")
    for a in actors:
        ray_tpu_torch.kill(a)
    return out


# ---------------------------------------------------------------------------
# Phase 15: RLlib with its learners on the card
# ---------------------------------------------------------------------------
# Each learner on the card against the same learner on the CPU, from the
# same weights, over RL_PARITY_STEPS updates on the same batches (SAC under
# the same injected noise): every parameter leaf within rel L2
# RL_PARITY_REL_L2 and every metric within rel RL_PARITY_RTOL. TF32 is off
# (main()), so both run f32 matmuls; cuBLAS sums in another order than the
# CPU's kernels, and CUDA's tanh, exp and log round differently, which Adam
# carries into each leaf at about 1e-6 of its size.
RL_PARITY_STEPS = 3
RL_PARITY_REL_L2 = 1e-4
RL_PARITY_RTOL = 1e-4
# The finding: one learner update on the card against the CPU in this
# process, on the reference tests' shapes (ms per update, median of
# RL_UPDATE_REPEATS after a warm-up).
RL_UPDATE_REPEATS = 20


def _rl_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _rl_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _rl_leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree, np.float64)


def _rl_tree_err(got, want) -> float:
    got, want = dict(_rl_leaves(got)), dict(_rl_leaves(want))
    check(sorted(got) == sorted(want), f"leaves differ: {sorted(got)} vs "
          f"{sorted(want)}")
    return max(float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), 1e-30)) for k in want)


def _rl_metric_err(got: dict, want: dict) -> float:
    check(sorted(got) == sorted(want), f"metrics differ: {sorted(got)}")
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
               for k in want)


def _rl_batches(kind: str, rng) -> dict:
    """One batch of the shape each algorithm's reference test gives its
    learner: PPO 1024 rows of CartPole (2 runners x 512), IMPALA 4
    fragments of 64, DQN 64 transitions with importance weights, SAC 128
    of Pendulum (observations scaled into tanh's unsaturated range, where
    the card's and the CPU's f32 tanh agree to a few ulps that the log of
    1 - tanh^2 does not blow up)."""
    if kind == "ppo":
        n = 1024
        return {"obs": rng.randn(n, 4).astype(np.float32),
                "actions": rng.randint(0, 2, n).astype(np.int32),
                "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(
                    np.float32),
                "advantages": rng.randn(n).astype(np.float32),
                "returns": rng.randn(n).astype(np.float32)}
    if kind == "impala":
        B, T, D = 4, 64, 4
        terms = (rng.rand(B, T) < 0.05).astype(np.float32)
        truncs = ((rng.rand(B, T) < 0.05) & (terms == 0)).astype(np.float32)
        return {"obs": rng.randn(B, T, D).astype(np.float32),
                "actions": rng.randint(0, 2, (B, T)).astype(np.int32),
                "rewards": np.ones((B, T), np.float32),
                "terms": terms, "truncs": truncs,
                "trunc_obs": np.where(truncs[..., None] > 0,
                                      rng.randn(B, T, D), 0).astype(
                                          np.float32),
                "behavior_logp": np.log(rng.uniform(0.2, 0.8, (B, T))
                                        ).astype(np.float32),
                "bootstrap_obs": rng.randn(B, D).astype(np.float32)}
    if kind == "dqn":
        n = 64
        return {"obs": rng.randn(n, 4).astype(np.float32),
                "actions": rng.randint(0, 2, n).astype(np.int32),
                "rewards": np.ones(n, np.float32),
                "next_obs": rng.randn(n, 4).astype(np.float32),
                "dones": (rng.rand(n) < 0.05).astype(np.float32),
                "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)}
    n = 128
    return {"obs": (rng.randn(n, 3) * 0.2).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": -rng.uniform(0, 10, n).astype(np.float32),
            "next_obs": (rng.randn(n, 3) * 0.2).astype(np.float32),
            "dones": np.zeros(n, np.float32)}


def _rl_learners(kind: str, device: str):
    if kind == "ppo":
        return PPOLearner(4, 2, lr=1e-3, seed=1, device=device)
    if kind == "impala":
        return IMPALALearner(4, 2, lr=1e-3, seed=1, device=device)
    if kind == "dqn":
        return DQNLearner(4, 2, lr=1e-3, seed=1, device=device)
    return SACLearner(3, 1, action_scale=2.0, lr=1e-3, seed=0,
                      device=device)


def _rl_update(kind: str, learner, batch: dict, noise=None) -> dict:
    if kind == "ppo":
        return learner.update_minibatches(batch, num_epochs=6,
                                          minibatch_size=128)
    if kind == "dqn":
        return learner.update(batch)[0]
    if kind == "sac":
        return learner.update(batch, noise=noise)
    return learner.update(batch)


def _rl_parity(card: str, device: str = "cuda") -> dict:
    """Each learner on ``device`` against the same one on the CPU."""
    out = {}
    for kind in ("ppo", "impala", "dqn", "sac"):
        cpu = _rl_learners(kind, "cpu")
        dev = _rl_learners(kind, device)
        dev.load_params(cpu.params_numpy(), cpu.target_params_numpy())
        rng = np.random.RandomState(7)
        leaf_err = metric_err = 0.0
        for _ in range(RL_PARITY_STEPS):
            batch = _rl_batches(kind, rng)
            noise = None
            if kind == "sac":
                n = len(batch["obs"])
                noise = (rng.randn(n, 1).astype(np.float32),
                         rng.randn(n, 1).astype(np.float32))
            want = _rl_update(kind, cpu, batch, noise)
            got = _rl_update(kind, dev, batch, noise)
            metric_err = max(metric_err, _rl_metric_err(got, want))
            leaf_err = max(leaf_err, _rl_tree_err(dev.params_numpy(),
                                                  cpu.params_numpy()))
            if cpu.target is not None:
                leaf_err = max(leaf_err, _rl_tree_err(
                    dev.target_params_numpy(), cpu.target_params_numpy()))
        on_dev = all(p.device.type == torch.device(device).type
                     for p in dev.nets.parameters())
        out[kind] = dict(leaf_rel_l2=leaf_err, metric_rel=metric_err,
                         on_device=on_dev)
        log(f"RLLIB parity {kind} on {device} vs the CPU, "
            f"{RL_PARITY_STEPS} updates: every leaf within rel L2 "
            f"{leaf_err:.3g}, metrics within rel {metric_err:.3g}  [{card}]")
        check(on_dev, f"{kind}: the learner's parameters are not on "
              f"{device}")
        check(leaf_err <= RL_PARITY_REL_L2 and metric_err <= RL_PARITY_RTOL,
              f"{kind} on {device} differs from the CPU: leaves "
              f"{leaf_err:.3g}, metrics {metric_err:.3g}")
    return out


def _rl_update_ms(card: str, device: str = "cuda") -> dict:
    """The finding: ms per learner update on ``device`` and on the CPU in
    this process, on the reference tests' shapes."""
    out = {}
    for kind in ("ppo", "impala", "dqn", "sac"):
        row = {}
        for where in (device, "cpu"):
            learner = _rl_learners(kind, where)
            batch = _rl_batches(kind, np.random.RandomState(3))
            _rl_update(kind, learner, batch)  # warm-up
            ms = _median_ms(lambda: _rl_update(kind, learner, batch),
                            RL_UPDATE_REPEATS)
            if kind == "ppo":  # 6 epochs x 8 minibatches per call
                ms /= 48
            row[where] = ms
        out[kind] = row
        log(f"RLLIB one {kind} learner update (ms, median of "
            f"{RL_UPDATE_REPEATS}): {device} {row[device]:.3f}, cpu "
            f"{row['cpu']:.3f} in this process "
            f"({torch.get_num_threads()} CPU threads)  [{card}]")
    return out


def _rl_train(name: str, algo, iters: int, done, card: str,
              device: str) -> dict:
    """Train ``algo`` until ``done(history)`` or ``iters`` iterations;
    the split of each iteration's wall time between sampling and the
    learner."""
    try:
        learner = getattr(algo, "_learner", None)
        learners = ([learner] if learner is not None
                    else list(algo._learners.values()))
        on_dev = all(p.device.type == torch.device(device).type
                     for ln in learners for p in ln.nets.parameters())
        check(on_dev, f"{name}: the learner's parameters are not on "
              f"{device}")
        hist = []
        for _ in range(iters):
            hist.append(algo.train())
            if done(hist):
                break
    finally:
        algo.stop()
    total = sum(h["time_this_iter_s"] for h in hist)
    learn = sum(h["learner_time_this_iter_s"] for h in hist)
    updates = sum(h.get("learner_updates_this_iter",
                        h.get("updates_this_iter", 0)) for h in hist)
    steps = sum(h["env_steps_this_iter"] for h in hist)
    row = dict(iterations=len(hist), solved=bool(done(hist)),
               s_per_iter=total / len(hist),
               learner_s_per_iter=learn / len(hist),
               sampling_s_per_iter=(total - learn) / len(hist),
               learner_ms_per_update=learn / updates * 1e3 if updates
               else None,
               env_steps_per_s=steps / total,
               returns=[h["episode_return_mean"] for h in hist])
    log(f"RLLIB {name} (learner on {device}): {len(hist)} iterations, "
        f"solved {row['solved']}; {row['s_per_iter']:.3f} s/iter "
        f"(sampling {row['sampling_s_per_iter']:.3f}, learner "
        f"{row['learner_s_per_iter']:.3f}); learner "
        f"{row['learner_ms_per_update'] or 0:.3f} ms/update; "
        f"{row['env_steps_per_s']:.0f} env steps/s; returns "
        f"{[round(r, 1) for r in row['returns']]}  [{card}]")
    check(row["solved"], f"{name} did not meet its test's criterion: "
          f"{row['returns']}")
    return row


def _ppo_done(hist) -> bool:
    # tests/test_rllib.py::test_ppo_learns_cartpole
    baseline = hist[0]["episode_return_mean"]
    best = max(h["episode_return_mean"] for h in hist)
    return len(hist) > 1 and best > max(2 * baseline, 60)


def _impala_done(hist) -> bool:
    # test_impala_learns_cartpole (and test_dqn_learns_cartpole's return
    # criterion): the baseline floored at 15
    baseline = max(hist[0]["episode_return_mean"], 15.0)
    best = max(h["episode_return_mean"] for h in hist)
    return len(hist) > 1 and best > max(2 * baseline, 60)


def _dqn_done(hist) -> bool:
    return _impala_done(hist) and hist[-1]["epsilon"] < 0.5


def _sac_done(hist) -> bool:
    # test_sac_learns_pendulum: after iteration 20, final > -950 and 250
    # above iteration 6's
    if len(hist) < 22:
        return False
    final = hist[-1]["episode_return_mean"]
    return final > -950 and final - hist[6]["episode_return_mean"] > 250


def _ma_done(hist) -> bool:
    # test_multi_agent_ppo_learns_cooperation
    return len(hist) > 11 and hist[-1]["episode_return_mean"] > 9.0


def phase_rllib(card: str) -> dict:
    """Phase 15 on the card: ``ray_tpu_torch.init()``, then
    ``_phase_rllib``."""
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ray_tpu_torch.init()
    try:
        out = _phase_rllib(card, "cuda")
    finally:
        ray_tpu_torch.shutdown()
    out["phase_s"] = time.perf_counter() - t
    log(f"RLLIB phase 15 took {out['phase_s']:.1f} s  [{card}]")
    return out


def _phase_rllib(card: str, device: str) -> dict:
    """The four learners on ``device`` against the CPU, then PPO, IMPALA,
    DQN, SAC and multi-agent PPO with their learners on ``device``, each
    at its reference test's configuration and to its criterion, and the
    GPU-against-CPU learner finding."""
    out = dict(card=card, parity=_rl_parity(card, device))
    algos = [
        ("ppo_cartpole", PPOConfig().environment(CartPole)
         .env_runners(2, rollout_fragment_length=512)
         .training(lr=1e-3, num_epochs=6, minibatch_size=128, seed=1,
                   device=device), 15, _ppo_done),
        ("impala_cartpole", IMPALAConfig().environment(CartPole)
         .env_runners(2, rollout_fragment_length=64)
         .training(lr=1e-3, train_batch_fragments=4,
                   updates_per_iteration=8, entropy_coeff=0.01, seed=1,
                   device=device), 15, _impala_done),
        ("dqn_cartpole", DQNConfig().environment(CartPole)
         .env_runners(2, rollout_fragment_length=64)
         .training(lr=1e-3, train_batch_size=64, updates_per_iteration=64,
                   fragments_per_iteration=4, learning_starts=500,
                   target_update_freq=50, epsilon_anneal_steps=3000,
                   seed=1, device=device), 25, _dqn_done),
        ("sac_pendulum", SACConfig().environment(Pendulum)
         .env_runners(2, rollout_fragment_length=100)
         .training(updates_per_iteration=200, train_batch_size=128,
                   learning_starts=400, lr=1e-3, seed=0, device=device),
         40, _sac_done),
        ("multi_agent_ppo", MultiAgentPPOConfig()
         .environment(CooperativeMatch)
         .multi_agent(policy_mapping_fn=lambda a: a)
         .env_runners(2, rollout_fragment_length=256)
         .training(lr=5e-3, minibatch_size=128, num_epochs=4, seed=0,
                   device=device), 30, _ma_done),
    ]
    out["train"] = {name: _rl_train(name, cfg.build(), iters, done, card,
                                    device)
                    for name, cfg, iters, done in algos}
    out["update_ms"] = _rl_update_ms(card, device)
    return out


# ---------------------------------------------------------------------------
# phase 16: Tune, the CLI and jobs on the card
# ---------------------------------------------------------------------------

# (a) Tune over phase 8's configuration: 2 trials over lr, phase 8's
# (default_optimizer's) first, so that ASHA records it at every rung before
# the other; each trial asks for a whole card, and two may run at once, so
# the tuner holds the second until the first has ended. Cut from 4 trials
# (3e-4, 1e-4, 3e-5, 1e-5): a trial costs about 34 s on the card, mostly its
# process's start (torch import, first step), and 2 keep every check (no
# trial errs, ASHA stops one early: 1e-5 trails 3e-4 from rung 2 on; the
# trials hold the card in turn; the first trial's losses are phase 8's).
TUNE_LRS = (3e-4, 1e-5)
TUNE_STEPS = 6           # ASHA's max_t: rungs at 1, 2 and 4 steps
TUNE_CONCURRENT = 2
TUNE_ASHA = dict(grace_period=1, reduction_factor=2)
# (b) PPO.as_trainable: two trials over lr, phase 15's PPO configuration
TUNE_PPO_LRS = (1e-3, 3e-4)
TUNE_PPO_ITERS = 3
# (c) the job's task: the flash forward at the training step's shape and
# layout (bench.py's configuration: B8 H16 KVH16 S2048 D128, causal)
JOB_FLASH_SHAPE = (BENCH_BATCH, BENCH_MODEL["n_heads"],
                   BENCH_MODEL["n_kv_heads"], BENCH_SEQ,
                   BENCH_MODEL["d_model"] // BENCH_MODEL["n_heads"])
CLI_TIMEOUT_S = 300
# A job's driver: it connects through RAY_TPU_TORCH_ADDRESS, which the job
# supervisor sets, runs one num_gpus=1 task (the forward against its plain
# version; launches counted in the task from zero) and prints the task's
# line; argv: the shape as JSON, the device, the two tolerances.
JOB_DRIVER = '''\
import json
import sys

import ray_tpu_torch


@ray_tpu_torch.remote(num_gpus=1)
def flash_task(shape, device, atol_o, atol_lse):
    import os

    import torch

    from ray_tpu_torch.ops.attention import flash_fwd, flash_fwd_plain
    B, H, KVH, S, D = shape
    gen = torch.Generator(device=device).manual_seed(0)

    def x(heads):  # the train step's layout: [B, S, heads, D] transposed
        return torch.randn(B, S, heads, D, generator=gen, device=device
                           ).to(torch.bfloat16).transpose(1, 2)

    q, k, v = x(H), x(KVH), x(KVH)
    flash_fwd.launches = 0
    flash_fwd.launches_by_variant.clear()
    o, lse = flash_fwd(q, k, v, True)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = dict(flash_fwd.launches_by_variant)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, True, D ** -0.5)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    line = dict(shape=list(shape), launches=launches, max_abs_err=err_o,
                lse_abs_err=err_lse,
                ok=bool(torch.isfinite(o).all()) and err_o <= atol_o
                and err_lse <= atol_lse,
                cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device=(torch.cuda.get_device_name(0) if device == "cuda"
                        else device))
    print("FLASH_TASK " + json.dumps(line), flush=True)
    return line


ray_tpu_torch.init()
line = ray_tpu_torch.get(flash_task.remote(
    json.loads(sys.argv[1]), sys.argv[2], float(sys.argv[3]),
    float(sys.argv[4])), timeout=600)
print("FLASH_RESULT " + json.dumps(line), flush=True)
sys.exit(0 if line["ok"] else 1)
'''


def _tune_trial(config):
    """One trial of phase 16 (a): ``make_train_fns`` on ``config["model"]``
    at ``config["lr"]`` from ``config["seed"]``, ``config["steps"]`` steps
    on phase 8's batch (``_tokens``'s draw), each reported with its loss,
    its time and the kernels' launch counters by variant (zeroed just
    before the first step). After the last step the state is saved by
    ``train.checkpointing`` into a directory under ``config["ckpt_root"]``,
    and its path, never the tensors, goes with the last report. A trial
    that ASHA stops raises out of ``tune.report`` and saves nothing.
    Self-contained: it is pickled by value into the trial's actor."""
    import time
    t_start = time.time()
    import os

    import numpy as np
    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.train import make_train_fns
    from ray_tpu_torch.train.checkpointing import save_checkpoint
    from ray_tpu_torch.train.spmd import default_optimizer

    t_import = time.time()
    dev = torch.device(config["device"])
    torch.backends.cuda.matmul.allow_tf32 = config["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = config["allow_tf32"]
    cfg = LlamaConfig(**config["model"])
    init_fn, step_fn = make_train_fns(
        cfg, opt=default_optimizer(lr=config["lr"]), device=dev)
    state = init_fn(config["seed"])
    rng = np.random.default_rng(config["seed"] + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (config["batch"], config["seq"]))).to(dev)
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dkv": flash_bwd_dkv,
                "flash_bwd_dq": flash_bwd_dq}
    # What a cold process's first step pays besides the step: loading the
    # kernels' libraries (built by this checkout's first process) and the
    # first cuBLAS call; nothing is launched here.
    cold = {}
    if dev.type == "cuda":
        from ray_tpu_torch.ops import _build
        t = time.perf_counter()
        for name in wrappers:
            _build.load(name)
        cold["kernel_load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        x = torch.ones(64, 64, device=dev)
        (x @ x).sum().item()
        cold["first_matmul_s"] = time.perf_counter() - t
    for w in wrappers.values():
        w.launches = 0
        w.launches_by_variant.clear()
    t_ready = time.time()
    for i in range(config["steps"]):
        t = time.perf_counter()
        state, m = step_fn(state, tokens)
        loss = m["loss"].item()
        report = dict(
            loss=loss, step_s=time.perf_counter() - t, t_step=time.time(),
            launches={k: dict(w.launches_by_variant)
                      for k, w in wrappers.items()},
            t_start=t_start, t_import=t_import, t_ready=t_ready,
            cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
            pid=os.getpid(), **cold)
        if i + 1 < config["steps"]:
            tune.report(report)
            continue
        t = time.perf_counter()
        ckpt = save_checkpoint(os.path.join(
            config["ckpt_root"], f"lr{config['lr']:g}"), state, i + 1)
        report.update(checkpoint_dir=ckpt.path,
                      checkpoint_s=time.perf_counter() - t,
                      t_end=time.time())
        tune.report(report, checkpoint=ckpt.path)


def _in_process_losses(model: dict, batch: int, seq: int, steps: int,
                       lr: float, device: str) -> list:
    """The trial's steps in this process: phase 8's run (``ctx=None``)
    where phase 8 did not run."""
    cfg = LlamaConfig(**model)
    init_fn, step_fn = make_train_fns(
        cfg, opt=default_optimizer(lr=lr), device=device)
    state = init_fn(SEED)
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))
                              ).to(device)
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, tokens)
        losses.append(m["loss"].item())
    del state, m, tokens
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses


def _tune_trials(card: str, device: str, model: dict, batch: int, seq: int,
                 steps: int, lrs: tuple, ref_losses: list) -> dict:
    """Phase 16 (a) on the cluster this process is connected to."""
    from ray_tpu_torch import tune

    L = model["n_layers"]
    per_step = ({"flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L}
                if device == "cuda" else {})
    pinned = accelerators.worker_env_for_gpus([0])["CUDA_VISIBLE_DEVICES"]
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        t_fit = time.time()
        grid = tune.Tuner(
            _tune_trial,
            param_space=dict(
                lr=tune.grid_search(list(lrs)), model=model, batch=batch,
                seq=seq, steps=steps, seed=SEED, device=device,
                ckpt_root=ckpt_root,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32),
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                max_concurrent_trials=TUNE_CONCURRENT,
                scheduler=tune.ASHAScheduler(max_t=steps, **TUNE_ASHA),
                resources_per_trial={"GPU": 1})).fit()
        fit_s = time.time() - t_fit
        check(grid.num_errors() == 0,
              f"tune: errored trials: {[r.error for r in grid]}")
        trials, spans, total = [], [], {}
        for r in grid:
            hist = r.metrics_history
            check(len(hist) == r.iterations >= 1,
                  f"tune {r.trial_id}: {len(hist)} reports in "
                  f"{r.iterations} iterations")
            for j, h in enumerate(hist, 1):
                want = {k: {"bf16_d128": n * j} for k, n in per_step.items()}
                got = {k: v for k, v in h["launches"].items() if v}
                check(got == want, f"tune {r.trial_id} step {j}: launches "
                      f"{h['launches']}, expected {want}")
                check(h["cuda_visible_devices"] == pinned,
                      f"tune {r.trial_id}: not pinned to one card: "
                      f"{h['cuda_visible_devices']}")
            for k, v in hist[-1]["launches"].items():
                for variant, n in v.items():
                    total.setdefault(k, {}).setdefault(variant, 0)
                    total[k][variant] += n
            last = hist[-1]
            end = last.get("t_end", last["t_step"])
            spans.append((last["t_start"], end, r.trial_id))
            step_t = [h["t_step"] for h in hist]
            row = dict(
                trial_id=r.trial_id, lr=r.config["lr"], status=r.status,
                iterations=r.iterations, losses=[h["loss"] for h in hist],
                start_s=last["t_start"] - t_fit,
                torch_import_s=last["t_import"] - last["t_start"],
                state_s=last["t_ready"] - last["t_import"],
                first_step_s=hist[0]["step_s"],
                kernel_load_s=last.get("kernel_load_s"),
                first_matmul_s=last.get("first_matmul_s"),
                steps_per_s=((len(hist) - 1) / (step_t[-1] - step_t[0])
                             if len(hist) > 1 else None),
                step_s=[h["step_s"] for h in hist], pid=last["pid"])
            if "checkpoint_dir" in last:
                path = last["checkpoint_dir"]
                with open(os.path.join(path, "_METADATA.json")) as f:
                    saved = json.load(f)["step"]
                check(Checkpoint(path).is_valid()
                      and saved == steps == r.iterations,
                      f"tune {r.trial_id}: checkpoint {path} (committed "
                      f"{Checkpoint(path).is_valid()}) of step {saved} "
                      f"after {r.iterations} steps")
                row.update(checkpoint_dir=path,
                           checkpoint_s=last["checkpoint_s"],
                           checkpoint_gb=_dir_bytes(path) / 1e9)
            else:
                check(r.iterations < steps,
                      f"tune {r.trial_id} ran {steps} steps and saved no "
                      f"checkpoint")
            trials.append(row)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    spans.sort()
    check(all(a[1] <= b[0] for a, b in zip(spans, spans[1:])),
          f"tune: trials held the card at once: {spans}")
    early = [t for t in trials if t["iterations"] < steps]
    check(early, f"tune: ASHA stopped no trial early: "
          f"{[(t['lr'], t['iterations']) for t in trials]}")
    check(any("checkpoint_dir" in t for t in trials),
          "tune: no trial saved a checkpoint")
    first = next(t for t in trials if t["lr"] == lrs[0])
    mine = first["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(mine, ref_losses))
    bitwise = mine == list(ref_losses[:len(mine)])
    check(rel <= TRAINER_LOSS_RTOL,
          f"tune: the trial at lr {lrs[0]} lost {mine}, phase 8 "
          f"{ref_losses[:len(mine)]}")
    for t in trials:
        log(f"TUNE trial {t['trial_id']} lr {t['lr']:g}: {t['status']} "
            f"after {t['iterations']} steps; started {t['start_s']:.2f} s "
            f"after fit() (torch import {t['torch_import_s']:.2f} s, "
            f"state {t['state_s']:.2f} s, kernel libraries "
            f"{t['kernel_load_s'] or 0:.2f} s, first matmul "
            f"{t['first_matmul_s'] or 0:.2f} s), first step "
            f"{t['first_step_s']:.2f} s, "
            f"{t['steps_per_s'] or 0:.2f} steps/s, losses "
            f"{[round(x, 4) for x in t['losses']]}"
            + (f"; checkpoint {t['checkpoint_gb']:.2f} GB in "
               f"{t['checkpoint_s']:.2f} s" if "checkpoint_dir" in t
               else "") + f"  [{card}]")
    log(f"TUNE {len(trials)} trials in {fit_s:.2f} s, {len(early)} stopped "
        f"early by ASHA; the card held one at a time; launches in the "
        f"trials {total}; the lr {lrs[0]:g} trial against phase 8: rel "
        f"{rel:.3g} (bitwise {bitwise})  [{card}]")
    return dict(fit_s=fit_s, trials=trials, launches=total,
                losses_rel=rel, losses_bitwise=bitwise,
                spans=[list(s) for s in spans])


def _tune_ppo(card: str, device: str, fragment: int = 512) -> dict:
    """Phase 16 (b): ``PPO.as_trainable`` under ``Tuner``, two trials at
    once with their learners on ``device`` (actors with ``num_gpus=0``
    that share the card)."""
    from ray_tpu_torch import tune

    algo = (PPOConfig().environment(CartPole)
            .env_runners(2, rollout_fragment_length=fragment)
            .training(num_epochs=6, minibatch_size=128, seed=1,
                      device=device).build())
    try:
        trainable = algo.as_trainable(TUNE_PPO_ITERS)
    finally:
        algo.stop()
    t = time.time()
    grid = tune.Tuner(
        trainable, param_space={"lr": tune.grid_search(list(TUNE_PPO_LRS))},
        tune_config=tune.TuneConfig(metric="episode_return_mean",
                                    mode="max", max_concurrent_trials=2),
    ).fit()
    fit_s = time.time() - t
    check(grid.num_errors() == 0,
          f"tune PPO: errored trials: {[r.error for r in grid]}")
    out = dict(fit_s=fit_s, trials=[])
    for r in grid:
        returns = [h["episode_return_mean"] for h in r.metrics_history]
        check(r.iterations == TUNE_PPO_ITERS
              and all(np.isfinite(x) for x in returns),
              f"tune PPO {r.trial_id}: {r.status}, returns {returns}")
        out["trials"].append(dict(
            lr=r.config["lr"], returns=returns,
            s_per_iter=statistics.mean(
                h["time_this_iter_s"] for h in r.metrics_history),
            learner_s_per_iter=statistics.mean(
                h["learner_time_this_iter_s"] for h in r.metrics_history)))
    log(f"TUNE PPO.as_trainable: 2 trials x {TUNE_PPO_ITERS} iterations "
        f"with the learners on {device} in {fit_s:.2f} s; "
        + "; ".join(f"lr {t['lr']:g}: returns "
                    f"{[round(x, 1) for x in t['returns']]}, "
                    f"{t['s_per_iter']:.3f} s/iter (learner "
                    f"{t['learner_s_per_iter']:.3f})" for t in out["trials"])
        + f"  [{card}]")
    return out


def _runtime_procs(mark: str) -> list:
    """(pid, command line) of the port's runtime processes (controller,
    node agent, workers) whose environment carries ``mark``: the ones a
    head started with it spawned."""
    pat = re.compile(r"ray_tpu_torch\.core\.(worker_main|node_agent|"
                     r"controller)")
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            if not pat.search(cmd):
                continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                if mark.encode() not in f.read():
                    continue
        except OSError:  # gone, or not ours to read
            continue
        found.append((int(pid), cmd))
    return found


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase_cli(card: str, device: str, shape: tuple,
               extra_env: dict = None) -> dict:
    """Phase 16 (c): ``python -m ray_tpu_torch.cli start --head``,
    ``status``, ``job submit`` of ``JOB_DRIVER`` and ``job logs``, the
    dashboard's nodes and jobs endpoints, ``stop``; no process of the
    head's runtime may be left. Every command's output goes to a file:
    the head's processes inherit the first one's."""
    import uuid

    mark = f"chip-smoke-cli-{uuid.uuid4().hex}"
    env = dict(os.environ, CHIP_SMOKE_CLI_MARK=mark, **(extra_env or {}))
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    n_cmd = [0]

    def cli(*args, wait=True):
        n_cmd[0] += 1
        out_path = os.path.join(work, f"{n_cmd[0]}_{args[0]}.out")
        with open(out_path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.cli", *args],
                stdout=f, stderr=subprocess.STDOUT, env=env, text=True)
        if not wait:
            return proc, out_path
        rc = proc.wait(timeout=CLI_TIMEOUT_S)
        with open(out_path) as f:
            return rc, f.read()

    out = dict(card=card)
    dash = None
    t = time.perf_counter()
    rc, text = cli("start", "--head")
    out["start_s"] = time.perf_counter() - t
    m = re.search(r"Controller at (\S+:\d+)", text)
    check(rc == 0 and m is not None, f"cli start --head: rc {rc}: {text}")
    addr = m.group(1)
    try:
        check(_runtime_procs(mark), "cli start --head left no process")
        t = time.perf_counter()
        rc, text = cli("status", "--address", addr)
        out["status_s"] = time.perf_counter() - t
        n = torch.cuda.device_count() if device == "cuda" else 1
        check(rc == 0 and f"GPU: {n:g}/{n:g} available" in text,
              f"cli status does not show GPU {n}: rc {rc}: {text}")
        drv = os.path.join(work, "flash_job.py")
        with open(drv, "w") as f:
            f.write(JOB_DRIVER)
        t = time.perf_counter()
        # The command right after "submit": on some Python 3.12 releases
        # argparse takes no positional of the command after the options.
        rc, text = cli("job", "submit", sys.executable, drv,
                       json.dumps(list(shape)), device, str(ATOL_O_BF16),
                       str(ATOL_LSE), "--address", addr, "--wait",
                       "--timeout", str(CLI_TIMEOUT_S))
        out["job_wall_s"] = time.perf_counter() - t
        m = re.search(r"submitted: (\S+)", text)
        check(rc == 0 and m is not None and "SUCCEEDED" in text,
              f"cli job submit: rc {rc}: {text}")
        job_id = m.group(1)
        rc, logs = cli("job", "logs", "--address", addr, "--job-id", job_id)
        m = re.search(r"^FLASH_RESULT (.*)$", logs, re.M)
        check(rc == 0 and m is not None,
              f"cli job logs shows no task line: rc {rc}: {logs}")
        # the task's own line, streamed to the driver, may follow on it
        task = json.JSONDecoder().raw_decode(m.group(1))[0]
        # A task's GPU is a reservation: the runtime pins actors to their
        # cards (CUDA_VISIBLE_DEVICES), not pooled task workers, as the
        # JAX package pins TPU chips to actors only.
        want = {"bf16_d128": 1} if device == "cuda" else {}
        check(task["ok"] and task["launches"] == want,
              f"the job's task: {task}, expected launches {want}")
        out.update(job_id=job_id, task=task,
                   task_line_streamed="FLASH_TASK" in logs)
        port = _free_port()
        dash, dash_out = cli("dashboard", "--address", addr, "--port",
                             str(port), wait=False)
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/api/nodes",
                        timeout=10) as r:
                    nodes = json.loads(r.read())
                break
            except OSError:
                check(dash.poll() is None and time.monotonic() < deadline,
                      f"the dashboard did not answer: "
                      f"{open(dash_out).read()}")
                time.sleep(0.2)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/jobs",
                                    timeout=30) as r:
            jobs = json.loads(r.read())
        check(any(nd["resources_total"].get("GPU") == n for nd in nodes),
              f"the dashboard's nodes list no GPU: {nodes}")
        check(any(j["submission_id"] == job_id
                  and j["status"] == "SUCCEEDED" for j in jobs),
              f"the dashboard's jobs do not list {job_id}: {jobs}")
    finally:
        if dash is not None:
            dash.terminate()
            try:
                dash.wait(timeout=30)
            except subprocess.TimeoutExpired:
                dash.kill()
                dash.wait()
        rc, text = cli("stop", "--address", addr)
        deadline = time.monotonic() + 30
        while _runtime_procs(mark) and time.monotonic() < deadline:
            time.sleep(0.2)
    check(rc == 0, f"cli stop: rc {rc}: {text}")
    left = _runtime_procs(mark)
    check(not left, f"cli stop left processes of the runtime: {left}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"CLI start --head {out['start_s']:.2f} s, status "
        f"{out['status_s']:.2f} s (GPU {n}); job {out['job_id']} SUCCEEDED "
        f"in {out['job_wall_s']:.2f} s (submit to end): its num_gpus=1 "
        f"task's flash forward at {list(shape)} |dO| "
        f"{task['max_abs_err']:.3g} |dLSE| {task['lse_abs_err']:.3g}, "
        f"launches {task['launches']}, on {task['device']} "
        f"(CUDA_VISIBLE_DEVICES {task['cuda_visible_devices']}; its own "
        f"line streamed to the job's log: {out['task_line_streamed']}); the "
        f"dashboard lists the "
        f"GPU and the job; stop left no process  [{card}]")
    return out


def phase_tune(card: str, bench: dict = None) -> dict:
    """Phase 16 on the card: ``ray_tpu_torch.init()``, (a) the Tune trials
    over phase 8's configuration (their losses against phase 8's, or
    against this process's run of the same steps where phase 8 did not
    run) and (b) ``PPO.as_trainable``; then (c) the CLI and jobs on a head
    of their own."""
    t0 = time.perf_counter()
    if bench is None:
        ref = _in_process_losses(BENCH_MODEL, BENCH_BATCH, BENCH_SEQ,
                                 TUNE_STEPS, TUNE_LRS[0], "cuda")
    else:
        ref = bench["no_ctx"]["losses"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ray_tpu_torch.init()
    out = dict(card=card, cluster_start_s=time.perf_counter() - t)
    try:
        check(ray_tpu_torch.cluster_resources().get("GPU")
              == torch.cuda.device_count(), "the agent advertises no GPU")
        out["trials"] = _tune_trials(card, "cuda", BENCH_MODEL, BENCH_BATCH,
                                     BENCH_SEQ, TUNE_STEPS, TUNE_LRS, ref)
        out["ppo"] = _tune_ppo(card, "cuda")
    finally:
        ray_tpu_torch.shutdown()
    out["cli"] = _phase_cli(card, "cuda", JOB_FLASH_SHAPE)
    out["phase_s"] = time.perf_counter() - t0
    log(f"TUNE phase 16 took {out['phase_s']:.1f} s (cluster up "
        f"{out['cluster_start_s']:.2f} s)  [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 17: the autoscaler, the soak and the scale harness
# ---------------------------------------------------------------------------

# (a) a head with no GPU; the autoscaler's node shape holds the card
AUTOSCALE_HEAD = {"CPU": 2, "GPU": 0}
AUTOSCALE_NODE = {"CPU": 2, "GPU": 1}
AUTOSCALE_IDLE_S = 3.0
AUTOSCALE_PERIOD_S = 0.5
AUTOSCALE_TIMEOUT_S = 600
AUTOSCALE_CULL_TIMEOUT_S = 120
# (b) `python -m ray_tpu_torch.cli soak --profile smoke` (8 s of load)
SOAK_TIMEOUT_S = 300
# (c) the spec of tests/test_graftscale.py's ramp-kill case
SCALE_FAST_CADENCE = {"pulse_period_ms": 500, "pulse_dead_ms": 3000,
                      "health_check_period_ms": 100, "meta_tick_ms": 250}
SCALE_SPEC = dict(levels=(8, 16), hold_s=3.0, tick_s=0.5, seed=42,
                  kill_nodes=2, v1_nodes=1)


class _TimedProvider(LocalNodeProvider):
    """``LocalNodeProvider`` that stamps each ``create_node`` (its call
    and its return: the agent is registered and listening) and keeps the
    handles."""

    def __init__(self, controller_addr):
        super().__init__(controller_addr)
        self.created = []

    def create_node(self, resources):
        t = time.time()
        handle = super().create_node(resources)
        self.created.append(dict(resources=dict(resources), t_call=t,
                                 t_return=time.time(), handle=handle))
        return handle


class _TimedAutoscaler(Autoscaler):
    """Stamps the first reconcile tick whose state holds a pending GPU
    demand."""

    t_demand = None

    def _state(self) -> dict:
        st = super()._state()
        if self.t_demand is None and any(
                d.get("GPU") for d in st["pending_actors"]):
            self.t_demand = time.time()
        return st


def _gone(pid: int) -> bool:
    """No such process, or only its zombie entry."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _alive_nodes() -> dict:
    return {n["node_id"].hex()[:12]: n for n in ray_tpu_torch.nodes()
            if n["state"] == "ALIVE"}


def _autoscaled_node(card: str, ref_streams) -> dict:
    """Phase 17 (a): a head with ``AUTOSCALE_HEAD``, an ``Autoscaler``
    over a ``LocalNodeProvider`` whose node shape holds the card, and a
    ``num_gpus=1`` engine actor (phase 11's) that parks until the
    autoscaler's node registers; phase 11's requests through it, then the
    node culled after the actor is killed, and the card's memory back."""
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    cfg = LlamaConfig.llama3_8b(n_layers=RUNTIME_LAYERS,
                                param_dtype=torch.bfloat16)
    pinned = accelerators.worker_env_for_gpus([0])["CUDA_VISIBLE_DEVICES"]
    t = time.perf_counter()
    ray_tpu_torch.init(resources=dict(AUTOSCALE_HEAD))
    out = dict(card=card, head_start_s=time.perf_counter() - t,
               free_before_gb=free_before / 1e9)
    scaler = None
    try:
        from ray_tpu_torch import api, state
        head = set(_alive_nodes())
        check(ray_tpu_torch.cluster_resources().get("GPU", 0) == 0,
              "the head advertises a GPU")
        provider = _TimedProvider(api._cw().controller_addr)
        scaler = _TimedAutoscaler(
            provider, node_resources=dict(AUTOSCALE_NODE), min_nodes=1,
            max_nodes=2, idle_timeout_s=AUTOSCALE_IDLE_S,
            update_period_s=AUTOSCALE_PERIOD_S).start()
        t_submit = time.time()
        actor = ray_tpu_torch.remote(num_gpus=1)(RuntimeEngineActor).remote(
            SEED, RUNTIME_LAYERS, RUNTIME_ENGINE,
            torch.backends.cuda.matmul.allow_tf32)
        ready_ref = actor.ready.remote()
        t_registered = None
        deadline = time.monotonic() + AUTOSCALE_TIMEOUT_S
        while not ray_tpu_torch.wait([ready_ref], timeout=0.05)[0]:
            if t_registered is None and set(_alive_nodes()) - head:
                t_registered = time.time()
            check(time.monotonic() < deadline,
                  "the autoscaled actor did not become ready")
        info = ray_tpu_torch.get(ready_ref)
        t_ready = time.time()
        t_registered = t_registered or t_ready
        check(len(provider.created) == 1
              and provider.created[0]["resources"] == AUTOSCALE_NODE,
              f"the autoscaler launched {len(provider.created)} nodes: "
              f"{[c['resources'] for c in provider.created]}")
        launch = provider.created[0]
        (new_id,) = set(_alive_nodes()) - head
        node = _alive_nodes()[new_id]
        (row,) = [a for a in state.list_actors()
                  if a["state"] == "ALIVE"]
        check(row["node_id"] == new_id
              and node["addr"][1] == provider.node_port(launch["handle"])
              and node["resources_total"].get("GPU") == 1,
              f"the actor is on node {row['node_id']}, the launched node "
              f"is {new_id} ({node})")
        tm = info["times"]
        timeline = dict(
            demand_seen_s=scaler.t_demand - t_submit,
            demand_to_create_node_s=launch["t_call"] - scaler.t_demand,
            create_node_s=launch["t_return"] - launch["t_call"],
            node_registered_s=t_registered - t_submit,
            process_and_register_s=tm["init"] - launch["t_return"],
            torch_import_s=tm["torch_imported"] - tm["init"],
            cuda_init_s=tm["cuda_ready"] - tm["torch_imported"],
            weights_and_engine_s=tm["weights_ready"] - tm["cuda_ready"],
            submit_to_ready_s=t_ready - t_submit)
        log(f"AUTOSCALE demand to ready: {json.dumps(timeline)}; the actor: "
            f"{json.dumps({k: v for k, v in info.items() if k != 'times'})}"
            f"  [{card}]")
        check(info["cuda_visible_devices"] == pinned
              and info["device_count"] == 1
              and info["device_name"] == torch.cuda.get_device_name(0),
              f"the autoscaled actor sees CUDA_VISIBLE_DEVICES="
              f"{info['cuda_visible_devices']!r} ({info['device_count']} "
              f"devices, {info['device_name']}), expected the pinned "
              f"{pinned!r}")

        timed, streams = _serve_and_time(
            _ActorEngine(actor), cfg, "through the autoscaled actor", card,
            lambda reset: ray_tpu_torch.get(actor.launches.remote(reset)))
        err = ray_tpu_torch.get(actor.stop.remote(), timeout=120)
        check(err is None, f"the actor's engine failed: {err}")

        agent_pid = launch["handle"]["proc"].pid
        t_kill = time.time()
        ray_tpu_torch.kill(actor)
        deadline = time.monotonic() + AUTOSCALE_CULL_TIMEOUT_S
        while new_id in _alive_nodes() or scaler._launched:
            check(time.monotonic() < deadline,
                  f"the autoscaled node {new_id} was not culled")
            time.sleep(0.1)
        t_culled = time.time()
        deadline = time.monotonic() + 30
        while not (_gone(agent_pid) and _gone(info["pid"])):
            check(time.monotonic() < deadline,
                  f"the culled node left processes: agent {agent_pid} "
                  f"gone {_gone(agent_pid)}, actor {info['pid']} gone "
                  f"{_gone(info['pid'])}")
            time.sleep(0.1)
        freed_s = _wait_for_card(free_before, "the culled node")
        check(len(provider.created) == 1, "the autoscaler launched again")
        out.update(timeline=timeline, actor=info, pinned=pinned,
                   launches=timed["launches"], through_actor=timed,
                   kill_to_culled_s=t_culled - t_kill,
                   culled_to_card_free_s=freed_s,
                   free_after_gb=torch.cuda.mem_get_info()[0] / 1e9)
    finally:
        if scaler is not None:
            scaler.stop()
        ray_tpu_torch.shutdown()

    if ref_streams is None:  # alone: the in-process engine on the freed card
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        eng = Engine(init_params(cfg, gen, device="cuda"), cfg,
                     **RUNTIME_ENGINE)
        try:
            _, ref_streams = _serve_and_time(eng, cfg, "in process", card,
                                             _local_launches)
        finally:
            eng.stop()
        check(eng.error is None, f"engine error: {eng.error}")
        del eng
        torch.cuda.empty_cache()
    same = [a == b for a, b in zip(streams, ref_streams, strict=True)]
    check(all(same), f"the autoscaled actor's greedy streams differ from "
          f"the in-process engine's: {same}")
    out["streams_equal"] = same
    log(f"AUTOSCALE one {AUTOSCALE_NODE} node launched for the pending "
        f"num_gpus=1 actor; flash_fwd launches {timed['launches']}; TTFT "
        f"through it idle {timed['ttft_idle_s'][100] * 1e3:.1f} ms (prompt "
        f"100), burst p50 {statistics.median(timed['ttft_burst_s']) * 1e3:.1f}"
        f" ms; streams equal to the in-process engine's {same}; kill to "
        f"culled {out['kill_to_culled_s']:.2f} s, card free "
        f"{out['free_after_gb']:.2f} GB ({out['free_before_gb']:.2f} before)"
        f"  [{card}]")
    return out


def _soak(card: str) -> dict:
    """Phase 17 (b): ``python -m ray_tpu_torch.cli soak --profile smoke``
    as a subprocess: exit 0 and every verdict row ``ok``."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cli", "soak", "--profile",
         "smoke"], capture_output=True, text=True, timeout=SOAK_TIMEOUT_S)
    wall_s = time.perf_counter() - t
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    verdicts = {r["check"]: r["ok"] for r in rows if r.get("row") == "verdict"}
    check(proc.returncode == 0 and verdicts and all(verdicts.values()),
          f"the soak: rc {proc.returncode}, verdicts {verdicts}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    workloads = {r["workload"]: dict(requests=r["requests"],
                                     p50_ms=r["p50_ms"], p99_ms=r["p99_ms"])
                 for r in rows if r.get("row") == "workload"}
    chaos = [dict(kind=r["kind"], at_s=r["at_s"], ok=r["ok"],
                  detect_s=r["recovery_s"]) for r in rows
             if r.get("row") == "chaos"]
    log(f"SOAK smoke: rc 0 in {wall_s:.1f} s, verdicts {verdicts}; "
        f"workloads {json.dumps(workloads)}; chaos {json.dumps(chaos)}"
        f"  [{card}]")
    return dict(wall_s=wall_s, verdicts=verdicts, workloads=workloads,
                chaos=chaos, rows=rows)


def _scale(card: str) -> dict:
    """Phase 17 (c): the scale harness's miniature, with the asserts of
    ``tests/test_graftscale.py``'s ramp-kill case."""
    t = time.perf_counter()
    rows = run_scale(ScaleSpec(**SCALE_SPEC, env=dict(SCALE_FAST_CADENCE)))
    wall_s = time.perf_counter() - t
    by_check = {r["check"]: r for r in rows if r["row"] == "verdict"}
    levels = [r for r in rows if r["row"] == "level"]
    meta = [r for r in rows if r["row"] == "meta"][-1]
    planes = {r["plane"] for r in rows if r["row"] == "plane"}
    kill = by_check.get("kill_detected", {})
    check([r["nodes"] for r in levels] == [8, 16]
          and [r["alive"] for r in levels] == [8, 16]
          and levels[-1]["pulse_records_per_s"] > 0
          and levels[-1]["rss_bytes"] > 0
          and all(by_check[c]["ok"] for c in (
              "pulse_fold_p99_bounded", "loop_lag_bounded",
              "no_unintended_deaths", "rss_per_node_bounded",
              "kill_detected", "meta_ingest_drop",
              "audit_clean_after_kill"))
          and kill["detect_s"] < 30
          and by_check["audit_clean_after_kill"]["leaked_objects"] == 0
          and {"pulse", "trail", "log", "prof"} <= planes
          and meta["max_nodes_sustained"] == 16 and meta["passed"] is True
          and verdicts_passed(rows),
          f"the scale harness: {json.dumps(rows)}")
    level_rows = [dict(nodes=r["nodes"], alive=r["alive"],
                       pulse_records_per_s=r["pulse_records_per_s"],
                       rss_bytes=r["rss_bytes"],
                       pulse_fold_p99_us=r["pulse_fold_p99_us"],
                       loop_lag_p99_ms=r["loop_lag_p99_ms"])
                  for r in levels]
    drop = by_check["meta_ingest_drop"]
    log(f"SCALE levels {json.dumps(level_rows)}; kill_detected detect_s "
        f"{kill['detect_s']}; pulse records/s {drop['pulse_rps_before']} "
        f"before the kill, {drop['pulse_rps_after']} after (at most "
        f"{drop['expected_max']}); passed in {wall_s:.1f} s  [{card}]")
    return dict(wall_s=wall_s, levels=level_rows,
                kill_detect_s=kill["detect_s"], ingest_drop=drop, rows=rows)


def phase_autoscale(card: str, runtime: dict = None) -> dict:
    """Phase 17: (a) the autoscaled GPU node (its streams against phase
    11's in-process engine's, or, alone, an in-process engine's built
    after the node is culled), (b) the smoke soak, (c) the scale
    harness's miniature."""
    t0 = time.perf_counter()
    out = dict(card=card)
    out["node"] = _autoscaled_node(
        card, None if runtime is None else runtime["streams"])
    out["soak"] = _soak(card)
    out["scale"] = _scale(card)
    out["phase_s"] = time.perf_counter() - t0
    log(f"AUTOSCALE phase 17 took {out['phase_s']:.1f} s  [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 18: the native planes: their C++ suites, the lint, one ingest
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(ROOT, "ray_tpu_torch", "csrc")
C_SUITES = ("object_store_test", "rpc_core_test", "copy_core_test",
            "scope_core_test", "shm_core_test", "prof_core_test",
            "log_core_test")
PLANE_TESTS = tuple(f"tests/test_torch_{n}.py" for n in (
    "graftrpc", "graftcopy", "graftshm", "grafttrail", "graftprof",
    "graftlog", "graftsched", "native_store"))
C_SUITES_TIMEOUT_S = 300
LINT_TIMEOUT_S = 300
PLANE_TESTS_TIMEOUT_S = 900
INGEST_SHAPE = (256, 512)


def _run_group(cmd: list, timeout: float) -> subprocess.CompletedProcess:
    """``cmd`` from the repo root in a process group of its own, killed
    whole (make and the suites it runs, pytest and its clusters) if it
    outlives ``timeout``."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise RuntimeError(f"{' '.join(cmd)} outlived {timeout} s: "
                           f"{out[-3000:]} {err[-3000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _c_suites(card: str) -> dict:
    """Phase 18 (a): the seven C++ unit suites of ray_tpu_torch/csrc."""
    t = time.perf_counter()
    built = _run_group(["make", "-s", "-C", CSRC_DIR,
                        f"-j{os.cpu_count() or 1}", "suites"],
                       C_SUITES_TIMEOUT_S)
    build_s = time.perf_counter() - t
    check(built.returncode == 0,
          f"the C++ suites did not build: {built.stderr[-3000:]}")
    # The suites hold CPU-time ratios (prof_core_test's spinner against
    # its idler), so the host's load as they start goes into the record.
    load1 = os.getloadavg()[0]
    t = time.perf_counter()
    run = _run_group(["make", "-s", "-C", CSRC_DIR, "test"],
                     C_SUITES_TIMEOUT_S)
    run_s = time.perf_counter() - t
    text = run.stdout
    ok = [n for n in C_SUITES if f"{n}: ALL OK" in text]
    check(run.returncode == 0 and ok == list(C_SUITES),
          f"the C++ suites: rc {run.returncode}, ALL OK from {ok}, "
          f"load average {load1:.2f} at their start: "
          f"{text[-4000:]} {run.stderr[-3000:]}")
    suite_s = {m.group(1): int(m.group(2)) / 1e3 for m in re.finditer(
        r"^(\w+_test): (\d+) ms$", text, re.M)}
    hw = re.search(r"hardware_concurrency (\d+), auto-sized pool (\d+)",
                   text)
    check(set(suite_s) == set(C_SUITES) and hw is not None,
          f"the C++ suites' report: {text[-4000:]}")
    log(f"PLANES C++ suites: all {len(ok)} ALL OK; build {build_s:.2f} s "
        f"(make -j), run {run_s:.2f} s: {json.dumps(suite_s)}; "
        f"hardware_concurrency {hw.group(1)}, copy pool {hw.group(2)}; "
        f"load average {load1:.2f} at their start  [{card}]")
    return dict(build_s=build_s, run_s=run_s, suite_s=suite_s, load1=load1,
                hardware_concurrency=int(hw.group(1)),
                copy_pool=int(hw.group(2)))


def _lint(card: str) -> dict:
    """Phase 18 (b): the port's lint over the checkout, and its derived
    hot-path costs against the committed ``budgets.json``."""
    t = time.perf_counter()
    proc = _run_group([sys.executable, "-m", "ray_tpu_torch.tools.lint"],
                      LINT_TIMEOUT_S)
    lint_s = time.perf_counter() - t
    m = re.search(r"graftlint: (\d+) finding\(s\) \((\d+) allowlisted\) "
                  r"across (\d+) files", proc.stderr)
    check(proc.returncode == 0 and m is not None and m.group(1) == "0",
          f"the lint: rc {proc.returncode}: {proc.stdout[-3000:]} "
          f"{proc.stderr[-3000:]}")
    files = [load_source(os.path.join(ROOT, rel), ROOT)
             for rel in hotpath.WALK_FILES]
    budgets = hotpath.load_budgets(hotpath.DEFAULT_BUDGETS)
    derived, _ = hotpath.derive_costs(
        budgets, files, protocol.load_protocol(protocol.DEFAULT_PROTOCOL))
    committed = {op: {k: int(spec.get("derived", {}).get(k, 0))
                      for k in hotpath.COST_KEYS}
                 for op, spec in budgets["ops"].items()}
    check(derived == committed,
          f"derived hot-path costs {derived} != budgets.json {committed}")
    log(f"PLANES lint: 0 findings ({m.group(2)} allowlisted) across "
        f"{m.group(3)} files in {lint_s:.2f} s; derived costs equal "
        f"budgets.json for {len(derived)} ops  [{card}]")
    return dict(lint_s=lint_s, files=int(m.group(3)),
                allowlisted=int(m.group(2)), costs=derived)


def _ingest(card: str) -> dict:
    """Phase 18 (c): a put array to the card through ``device_ingest``."""
    arr = np.random.default_rng(SEED).standard_normal(
        INGEST_SHAPE, dtype=np.float32)
    ray_tpu_torch.init()
    try:
        ref = ray_tpu_torch.put({"w": arr})
        host_read_only = not ray_tpu_torch.get(ref)["w"].flags["WRITEABLE"]
        made, live = graftshm.capsules_made(), graftshm.live_capsules()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = device_ingest(ref)
        torch.cuda.synchronize()
        ingest_ms = (time.perf_counter() - t) * 1e3
        w = out["w"]
        check(w.is_cuda and w.dtype == torch.float32
              and tuple(w.shape) == INGEST_SHAPE
              and torch.equal(w.cpu(), torch.from_numpy(arr)),
              f"device_ingest gave {w.device} {w.dtype} {tuple(w.shape)}, "
              f"or other values")
        check(graftshm.capsules_made() == made + 1,
              f"device_ingest made {graftshm.capsules_made() - made} "
              f"capsules, not one: the DLPack path was not taken")
        del out, w
        deadline = time.monotonic() + 10
        while graftshm.live_capsules() > live and \
                time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.05)
        check(graftshm.live_capsules() <= live,
              f"{graftshm.live_capsules() - live} capsules left live")
    finally:
        ray_tpu_torch.shutdown()
    log(f"PLANES ingest: {INGEST_SHAPE} f32 put -> cuda through one DLPack "
        f"capsule in {ingest_ms:.3f} ms (host view read-only: "
        f"{host_read_only}); capsules released  [{card}]")
    return dict(ingest_ms=ingest_ms, host_read_only=host_read_only)


def _plane_suites(card: str) -> dict:
    """Phase 18 (d), ``--only-planes`` only: the eight plane suites.
    ``--noconftest``: tests/conftest.py imports jax, which a GPU host
    of the port need not have. pytest.ini's ``-q`` leaves the count line
    last."""
    t = time.perf_counter()
    proc = _run_group([sys.executable, "-m", "pytest", "--noconftest",
                       "-rs", "-p", "no:cacheprovider", *PLANE_TESTS],
                      PLANE_TESTS_TIMEOUT_S)
    wall_s = time.perf_counter() - t
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?)", tail)}
    check(proc.returncode == 0 and counts.get("passed", 0) > 0,
          f"the plane suites: rc {proc.returncode}: {proc.stdout[-6000:]} "
          f"{proc.stderr[-2000:]}")
    log(f"PLANES suites: {tail} ({wall_s:.1f} s)  [{card}]")
    return dict(wall_s=wall_s, counts=counts, summary=tail)


def phase_planes(card: str, suites: bool = False) -> dict:
    """Phase 18: (a) the C++ suites, (b) the lint, (c) one ingest on the
    card, and with ``suites`` (d) the Python plane suites."""
    t0 = time.perf_counter()
    out = dict(card=card)
    out["c_suites"] = _c_suites(card)
    out["lint"] = _lint(card)
    out["ingest"] = _ingest(card)
    if suites:
        out["plane_suites"] = _plane_suites(card)
    out["phase_s"] = time.perf_counter() - t0
    log(f"PLANES phase 18 took {out['phase_s']:.1f} s  [{card}]")
    return out


def _variant_entries(rows, bwd_rows, parity, tune_launches) -> list:
    """The kernels line's entries of the variants other than bf16 D128:
    launches from their train-parity run (the path that reaches them) and
    in phase 16's Tune trials (by variant), times at that run's shape
    (``VARIANT_MAIN``, S2048 causal), errors over every case, the kernel
    that serves each (``wgmma``, ``cluster`` or ``generic``), and for a
    variant also
    timed at S8192 (bf16 D256), its times there under ``at_s8192``."""
    out = []

    def at(rs, shape, variant):
        return next((r for r in rs if r["shape"] == shape and r["causal"]
                     and r["variant"] == variant), None)

    for variant, D, dt in VARIANTS:
        B, H, KVH = VARIANT_MAIN[D]
        shape = f"B{B} H{H} KVH{KVH} S2048 D{D}"
        long_shape = f"B{B} H{H} KVH{KVH} S{TRAIN_SEQ} D{D}"
        fwd, bwd = at(rows, shape, variant), at(bwd_rows, shape, variant)
        fwd_l, bwd_l = (at(rows, long_shape, variant),
                        at(bwd_rows, long_shape, variant))
        label = f"{shape} causal {variant.split('_')[0]}"
        entry = dict(
            name=f"flash_fwd.{variant}", route="cuda",
            source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
            replaces="ray_tpu/ops/attention.py:140",
            kernel=kernel_kind("flash_fwd", variant),
            launches=parity[variant]["launches"]["flash_fwd"],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["variant"] == variant),
            ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
            bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
            shape=label, launches_tune_trials=tune_launches.get(
                "flash_fwd", {}).get(variant, 0))
        if fwd_l is not None:
            entry["at_s8192"] = dict(
                shape=f"{long_shape} causal", ms=fwd_l["ms"],
                plain_ms=fwd_l["plain_ms"], bound_ms=fwd_l["bound_ms"],
                bound_by=fwd_l["bound_by"], library_ms=fwd_l["library_ms"],
                max_abs_err=fwd_l["max_abs_err"])
        out.append(entry)
        for name, src, line in (("flash_bwd_dkv", "flash_bwd_dkv.cu", 326),
                                ("flash_bwd_dq", "flash_bwd_dq.cu", 356)):
            entry = dict(
                name=f"{name}.{variant}", route="cuda",
                source=f"ray_tpu_torch/ops/csrc/{src}",
                replaces=f"ray_tpu/ops/attention.py:{line}",
                kernel=kernel_kind(name, variant),
                launches=parity[variant]["launches"][name],
                max_abs_err=max(r["abs_err"][name] for r in bwd_rows
                                if r["variant"] == variant),
                ms=bwd["ms"][name], plain_ms=bwd["plain_ms"][name],
                bound_ms=bwd["bound_ms"][name],
                bound_by=bwd["bound_by"][name],
                library_ms=bwd["sdpa_bwd_ms"], shape=label,
                launches_tune_trials=tune_launches.get(name, {}).get(
                    variant, 0))
            if bwd_l is not None:
                entry["at_s8192"] = dict(
                    shape=f"{long_shape} causal", ms=bwd_l["ms"][name],
                    plain_ms=bwd_l["plain_ms"][name],
                    bound_ms=bwd_l["bound_ms"][name],
                    bound_by=bwd_l["bound_by"][name],
                    library_ms=bwd_l["sdpa_bwd_ms"],
                    max_abs_err=bwd_l["abs_err"][name])
            out.append(entry)
    return out


def _dump(name: str, result: dict) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(result, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="build the kernels and run phase 2 only")
    ap.add_argument("--only-bwd", action="store_true",
                    help="build the kernels and run phase 5 only")
    ap.add_argument("--only-times", action="store_true",
                    help="build the kernels and time the bf16 wgmma "
                    "kernels and the cluster kernels alone, 3 rounds each "
                    "(no check of the build)")
    ap.add_argument("--tree-csrc", action="append", default=[],
                    metavar="DIR",
                    help="with --only-times: time an entry point "
                    "as each DIR (another tree's ray_tpu_torch/ops/csrc) "
                    "and this tree build it, in turns, in place of the "
                    "kernel times")
    ap.add_argument("--tree-kernel", default="flash_bwd_dq",
                    choices=sorted(TREE_PLAIN),
                    help="with --tree-csrc: the entry point to time")
    ap.add_argument("--tree-case", action="append", default=[],
                    metavar="DTYPE:D:H:KVH",
                    help="with --tree-csrc: a case to time (bf16 or f32; "
                    "default: TREE_CASES)")
    ap.add_argument("--only-ttft", type=int, default=0, metavar="N",
                    help="build the kernels and measure idle TTFT only, N "
                    "requests per prompt length")
    ap.add_argument("--only-moe", action="store_true",
                    help="build the kernels and run phase 9 only")
    ap.add_argument("--only-ckpt", action="store_true",
                    help="build the kernels and run phases 4 and 10 only")
    ap.add_argument("--only-runtime", action="store_true",
                    help="build the kernels and run phase 11 only")
    ap.add_argument("--only-trainer", action="store_true",
                    help="build the kernels and run phases 8 and 12 only")
    ap.add_argument("--only-serve", action="store_true",
                    help="build the kernels and run phase 13 only")
    ap.add_argument("--only-edges", action="store_true",
                    help="build the kernels and run phase 14 only")
    ap.add_argument("--only-rllib", action="store_true",
                    help="build the kernels and run phase 15 only")
    ap.add_argument("--only-tune", action="store_true",
                    help="build the kernels and run phase 16 only")
    ap.add_argument("--only-autoscale", action="store_true",
                    help="build the kernels and run phase 17 only")
    ap.add_argument("--only-planes", action="store_true",
                    help="build the kernels and run phase 18 only, with "
                    "the plane suites under pytest")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 compares in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"CARD {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # The runtime's host library (g++) builds beside the kernels (nvcc).
    host = {}

    def build_host():
        t0 = time.perf_counter()
        object_store._get_lib()
        host["s"] = time.perf_counter() - t0

    host_build = threading.Thread(target=build_host)
    t = time.perf_counter()
    host_build.start()
    _build.build_all()
    build_s = time.perf_counter() - t
    host_build.join()
    phase1_s = time.perf_counter() - t  # both builds
    check("s" in host, "the runtime's host library did not build")
    log(f"BUILD {_build.sources()} in {build_s:.2f} s; the runtime's host "
        f"library {os.path.basename(object_store._LIB_PATH)} in "
        f"{host['s']:.2f} s, beside them")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in BUILD_REPORT):
                log(f"BUILD {name}: {line.strip()}")
    if args.only_times:  # before the checks of the build: it compares trees
        if args.tree_csrc:
            phase_trees(card, args.tree_kernel, args.tree_csrc,
                        args.tree_case)
        else:
            phase_kernel_times(card)
        return 0
    # The generic variants hold DC/4 (forward) or 2 DC/8 (dK/dV) f32
    # accumulators per thread for their chunk of DC columns, near the
    # register limit at DC 384 (the chunked instances stop at 256 for that
    # reason, and no one-chunk instance above 128 is left); the wgmma
    # kernels hold 64 or 128 (D128:
    # O, or dK and dV, or dQ; D256: O, or a half of dK and dV, or of dQ)
    # beside their scores under setmaxnreg 240, the f32 cluster kernels 64
    # dK, dV or O accumulators (32 of dQ) beside an 8 x 8 score tile, the
    # bf16 ones 64 dK, dV or O (32 of dQ) beside 32 of scores. A spill in
    # any instance is a defect, not a slowdown to accept.
    spills = {k: v for text in _build.build_log.values()
              for k, v in ptxas_spills(text).items()}
    generic = {k: v for k, v in spills.items() if "generic" in k}
    cluster = {k: v for k, v in spills.items() if "cluster" in k}
    wgmma = {k: v for k, v in spills.items()
             if k not in generic and k not in cluster}
    log(f"BUILD spills (store, load bytes) of the generic instances: "
        f"{json.dumps(generic)}; of the wgmma kernels: {json.dumps(wgmma)}"
        f"; of the cluster kernels: {json.dumps(cluster)}")
    built_all = len(_build.build_log) == len(_build.sources())
    check(not built_all or (len(generic) == GENERIC_INSTANCES
                            and len(wgmma) == WGMMA_INSTANCES
                            and len(cluster) == CLUSTER_INSTANCES),
          f"expected {GENERIC_INSTANCES} generic instances, "
          f"{WGMMA_INSTANCES} wgmma kernels and {CLUSTER_INSTANCES} "
          f"cluster kernels in the ptxas report, got {sorted(generic)}, "
          f"{sorted(wgmma)} and {sorted(cluster)}")
    check(all(v == (0, 0) for v in spills.values()),
          f"ptxas spills: {spills}")
    # C7514/C7515: ptxas serialized a kernel's wgmma (its overlap lost).
    serialized = [n for n, text in _build.build_log.items()
                  if "C7514" in text or "C7515" in text]
    check(not serialized, f"ptxas serialized wgmma in {serialized}")

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
    if args.only_runtime:
        phase_runtime(card)
        return 0
    if args.only_trainer:
        phase_trainer(card, phase_train_bench(card))
        return 0
    if args.only_serve:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for B, H, KVH, S, causal, dt, layout in SERVE_FWD_CASES:
            _fwd_case(gen, card, B, H, KVH, S, causal, dt, layout)
        phase_serve(card)
        return 0
    if args.only_edges:
        _dump("chip_smoke_edges.json", phase_edges(card))
        return 0
    if args.only_rllib:
        _dump("chip_smoke_rllib.json", phase_rllib(card))
        return 0
    if args.only_tune:
        _dump("chip_smoke_tune.json", phase_tune(card))
        return 0
    if args.only_autoscale:
        _dump("chip_smoke_autoscale.json", phase_autoscale(card))
        return 0
    if args.only_planes:
        _dump("chip_smoke_planes.json", phase_planes(card, suites=True))
        return 0
    # Each phase's seconds, printed as it ends and kept in the JSON: the
    # whole run has to end inside its time limit.
    phase_s = {1: phase1_s}

    def timed(n, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[n] = time.perf_counter() - t0
        log(f"PHASE {n} took {phase_s[n]:.1f} s  [{card}]")
        return out

    log(f"PHASE 1 took {phase1_s:.1f} s  [{card}]")
    rows, route = timed(2, lambda: (phase_kernels(card),
                                    phase_reference_route(card)))
    if args.only_kernels:
        return 0
    engine = timed(3, phase_engine, card)
    server = timed(4, phase_llm_server)
    bwd_rows = timed(5, phase_bwd_kernels, card)
    parity = timed(6, phase_train_parity, card)
    train = timed(7, phase_train_main, card)
    bench = timed(8, phase_train_bench, card)
    moe = timed(9, phase_moe, card)
    ckpt = timed(10, phase_checkpoint, card, server)
    runtime = timed(11, phase_runtime, card)
    trainer = timed(12, phase_trainer, card, bench)
    serving = timed(13, phase_serve, card, engine)
    edges = timed(14, phase_edges, card)
    rl = timed(15, phase_rllib, card)
    tuned = timed(16, phase_tune, card, bench)
    auto = timed(17, phase_autoscale, card, runtime)
    planes = timed(18, phase_planes, card)
    log(f"PHASES 1-18 took {sum(phase_s.values()):.1f} s  [{card}]")

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
        launches_moe_train=moe["train"]["launches"]["flash_fwd"],
        launches_runtime_actor=runtime["launches"],
        launches_trainer_worker=trainer["launches"]["flash_fwd"][
            "bf16_d128"],
        launches_serve_mono_replica=serving["launches_mono"],
        launches_serve_prefill_replica=serving["launches_prefill"],
        launches_serve_decode_replica=serving["launches_decode"],
        launches_tune_trials=tuned["trials"]["launches"].get(
            "flash_fwd", {}).get("bf16_d128", 0),
        launches_job=tuned["cli"]["task"]["launches"].get("bf16_d128", 0),
        launches_autoscaled_actor=auto["node"]["launches"])]
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
            launches_moe_train=moe["train"]["launches"][name],
            launches_trainer_worker=trainer["launches"][name]["bf16_d128"],
            launches_tune_trials=tuned["trials"]["launches"].get(
                name, {}).get("bf16_d128", 0)))
    kernels += _variant_entries(rows, bwd_rows, parity,
                                tuned["trials"]["launches"])
    fit = cluster_fit()
    for entry in kernels:
        if entry["name"] in fit:
            entry["max_active_clusters"] = fit[entry["name"]]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, kernel_rows=rows,
                       engine=engine, bwd_rows=bwd_rows, train_parity=parity,
                       train=train, train_bench=bench, moe=moe,
                       reference_route=route, checkpoint=ckpt,
                       runtime=runtime, trainer=trainer, serve=serving,
                       edges=edges, rllib=rl, tune=tuned, autoscale=auto,
                       planes=planes, kernels=kernels, phase_s=phase_s),
                  f, indent=1)
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
