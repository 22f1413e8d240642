"""Continuous-batching LLM decode engine with a PAGED KV cache
(counterpart of ``ray_tpu/serve/engine.py``).

- **Paged KV arena** ``[n_layers, n_pages, page, kv_heads, head_dim]`` with
  a per-slot BLOCK TABLE ``[n_slots, max_pages]`` of physical page ids.
  Reads are one gather per layer (``kc[bt]``), writes one scatter at each
  slot's position. Page 0 is the NULL page: unused and overflow table
  entries point at it, so out-of-reservation writes are harmless and
  gathers of unused pages are masked. The arena is updated IN PLACE
  (``index_put_`` / ``index_copy_``), where the JAX engine donated it to
  each call. Several inactive slots write page 0 at offset 0 in one
  scatter; the order of those writes does not matter, since page 0 is
  never read unmasked.
- **Reservation admission**: a request is admitted when
  ceil(min(len + max_tokens, max_seq) / page) free pages exist, so growth
  never fails mid-decode. Requests queue FIFO while pages are short.
- **Sync-free dispatch loop + emitter thread**: the engine loop only
  dispatches device work (prefills, decode chunks, slot pokes). Host state
  goes to the device through fresh pinned buffers copied with
  ``non_blocking=True`` (the loop mutates its numpy state while a chunk is
  in flight, and the fresh buffer is never written again); results come
  back through pinned buffers and a CUDA event that only the EMITTER
  thread waits on. Slot and page control state advances on the host, since
  only token VALUES depend on the device.
- **Weights in bf16 once**: the JAX engine keeps f32 master weights and
  casts each to the compute dtype at every use. This engine casts once,
  when it is built, and keeps the compute-dtype copy on the card: the
  values are the same, and each decode step reads half the bytes.
- **Prefill buckets**: one prefill width per power of 2 up to max_seq, so a
  short prompt pays a short prefill. Eager PyTorch compiles nothing, so
  every bucket is ready at once; the JAX engine's bucket warming (and its
  scratch arena) has no counterpart.

Prefill attention runs through ``flash_attention`` (the hand-written CUDA
flash forward on the card, 1 launch per layer). The paged decode attention
is a gather plus einsum, as in the JAX engine, and stays plain PyTorch.
"""

from __future__ import annotations

import queue
import threading
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import apply_rope, rms_norm, rope_frequencies


def _layer(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i] for name, w in params["layers"].items()}


def _make_prefill_core(mcfg):
    """fn(params, tokens [1, W], length) -> (first_token, ks, vs, logits)
    where ks/vs are [L, W, KVH, hd] and logits the f32 row at
    ``length - 1``: the shared prefill pass of the engine."""
    H, KVH, hd = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim
    dt = mcfg.dtype

    def _prefill_layer(x, lp, cos, sin):
        B, Sq, _ = x.shape
        h = rms_norm(x, lp["attn_norm"], mcfg.norm_eps)
        q = (h @ lp["wq"].to(dt)).view(B, Sq, H, hd).transpose(1, 2)
        k = (h @ lp["wk"].to(dt)).view(B, Sq, KVH, hd).transpose(1, 2)
        v = (h @ lp["wv"].to(dt)).view(B, Sq, KVH, hd).transpose(1, 2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # Grouped-query attention without repeat_kv copies: the flash
        # forward reads kv head h // (H // KVH).
        attn = flash_attention(q, k, v, True)
        attn = attn.transpose(1, 2).reshape(B, Sq, H * hd)
        x = x + attn @ lp["wo"].to(dt)
        h = rms_norm(x, lp["mlp_norm"], mcfg.norm_eps)
        gate = h @ lp["w_gate"].to(dt)
        up = h @ lp["w_up"].to(dt)
        x = x + (F.silu(gate) * up) @ lp["w_down"].to(dt)
        # cache pre-repeat k/v: [S, KVH, hd] (B == 1 squeezed)
        return x, k[0].transpose(0, 1), v[0].transpose(0, 1)

    def core(params, tokens, length):
        x = params["embed"][tokens].to(dt)
        cos, sin = rope_frequencies(hd, tokens.shape[1], mcfg.rope_theta,
                                    device=x.device)
        ks, vs = [], []
        for i in range(mcfg.n_layers):
            x, k, v = _prefill_layer(x, _layer(params, i), cos, sin)
            ks.append(k)
            vs.append(v)
        x = rms_norm(x, params["final_norm"], mcfg.norm_eps)
        last_h = x[:, length - 1]
        logits = last_h @ params["lm_head"].to(dt)
        first = torch.argmax(logits[0])
        return first, torch.stack(ks), torch.stack(vs), logits[0].float()

    return core


# Cap on per-request top_k (requests asking for more sample from the best
# TOPK_CAP), as in the JAX engine.
TOPK_CAP = 64

_M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A 64-bit constant as the signed int64 torch stores."""
    c &= _M64
    return c - (1 << 64) if c >= 1 << 63 else c


_MIX1, _MIX2 = _i64(0xBF58476D1CE4E5B9), _i64(0x94D049BB133111EB)
_GOLD, _POS_K = _i64(0x9E3779B97F4A7C15), _i64(0xD1B54A32D192ED03)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _gumbel(seeds: torch.Tensor, pos: torch.Tensor, cap: int) -> torch.Tensor:
    """[n, cap] Gumbel noise from a counter-based hash (splitmix64's
    finalizer) of (seed, position, index): a request's noise depends only
    on its seed and position, never on its slot or its co-tenants.
    (``jax.random``'s bits cannot be matched; this keeps the property the
    engine relies on.)"""
    j = torch.arange(cap, device=seeds.device, dtype=torch.int64)
    x = (seeds[:, None] * _GOLD + pos[:, None].to(torch.int64) * _POS_K
         + j[None, :] * _GOLD)
    x = x ^ _lsr(x, 30)
    x = x * _MIX1
    x = x ^ _lsr(x, 27)
    x = x * _MIX2
    x = x ^ _lsr(x, 31)
    u = (_lsr(x, 40).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _sample_tokens(logits, temp, topk, seeds, pos, cap=TOPK_CAP):
    """Per-slot token sampling: temperature + top-k via Gumbel-max over the
    top-``cap`` logits (cap = min(TOPK_CAP, vocab)); temp == 0 slots stay
    greedy (argmax, first index on ties)."""
    cap = min(cap, logits.shape[-1])
    greedy = torch.argmax(logits, dim=-1)
    vals, idxs = torch.topk(logits.float(), cap, dim=-1)
    k_eff = torch.where(topk > 0, topk.clamp_max(cap), cap)
    mask = torch.arange(cap, device=logits.device)[None, :] < k_eff[:, None]
    scaled = torch.where(mask, vals / temp.clamp_min(1e-6)[:, None],
                         torch.full_like(vals, -1e30))
    pick = torch.argmax(scaled + _gumbel(seeds, pos, cap), dim=-1)
    sampled = torch.gather(idxs, 1, pick[:, None])[:, 0]
    return torch.where(temp > 0, sampled, greedy)


def _build_fns(mcfg, n_slots: int, chunk: int, page: int, n_pages: int,
               device: torch.device):
    """Build (prefill, decode, adopt, poke, empty_caches). The arena
    functions update kc/vc in place."""
    if mcfg.n_experts > 0:
        raise ValueError("the serving engine supports dense models only")

    S = mcfg.max_seq
    L = mcfg.n_layers
    H, KVH, hd = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim
    dt = mcfg.dtype
    ns = n_slots
    maxp = -(-S // page)          # logical pages per slot
    CTX = maxp * page             # gathered context width (>= S)
    cos, sin = rope_frequencies(hd, S, mcfg.rope_theta, device=device)
    slot_idx = torch.arange(ns, device=device)
    ctx_idx = torch.arange(CTX, device=device)

    def empty_caches():
        shape = (L, n_pages, page, KVH, hd)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def _write_pages(kc, vc, pages, ks, vs):
        """Scatter prefilled [L, W, KVH, hd] k/v into physical pages;
        ``pages[:wp]`` entries of 0 route padding into the null page."""
        W = ks.shape[1]
        wp = -(-W // page)
        pad = wp * page - W
        ksp = F.pad(ks, (0, 0, 0, 0, 0, pad)).view(L, wp, page, KVH, hd)
        vsp = F.pad(vs, (0, 0, 0, 0, 0, pad)).view(L, wp, page, KVH, hd)
        kc.index_copy_(1, pages[:wp], ksp.to(dt))
        vc.index_copy_(1, pages[:wp], vsp.to(dt))

    _core = _make_prefill_core(mcfg)

    def prefill(params, kc, vc, pages, tokens, length, temp, topk, seed):
        """tokens [1, W] padded to a BUCKET width; writes the slot's pages
        and returns the first generated token (a device scalar; sampled, or
        greedy when temp == 0)."""
        _, ks, vs, logits_row = _core(params, tokens, length)
        _write_pages(kc, vc, pages, ks, vs)

        def row(val, dtype):  # a fill kernel: no host->device copy
            return torch.full((1,), val, dtype=dtype, device=device)

        return _sample_tokens(logits_row[None], row(temp, torch.float32),
                              row(topk, torch.int64), row(seed, torch.int64),
                              row(length - 1, torch.int64))[0]

    def adopt(kc, vc, pages, ks, vs):
        """Write externally prefilled k/v into the slot's pages."""
        _write_pages(kc, vc, pages, ks, vs)

    def _rope_one(x, c, s):
        # x [ns, heads, hd], c/s [ns, 1, hd//2]
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                         dim=-1).to(x.dtype)

    def _decode_layer(x, lp, kc_l, vc_l, bt, pp, off, mask, c, s):
        # x [ns, D]; kc_l/vc_l [n_pages, page, KVH, hd]; bt [ns, maxp]
        h = rms_norm(x, lp["attn_norm"], mcfg.norm_eps)
        q = (h @ lp["wq"]).view(ns, H, hd)
        k = (h @ lp["wk"]).view(ns, KVH, hd)
        v = (h @ lp["wv"]).view(ns, KVH, hd)
        q = _rope_one(q, c, s)
        k = _rope_one(k, c, s)
        # Scatter k/v at each slot's (page, offset); inactive slots (and
        # positions past a reservation) go to the NULL page 0.
        kc_l[pp, off] = k
        vc_l[pp, off] = v
        # Gather each slot's pages -> its logical KV history.
        kh = kc_l[bt].view(ns, CTX, KVH, hd)
        vh = vc_l[bt].view(ns, CTX, KVH, hd)
        # Grouped-query attention against the gathered history, in f32 and
        # masked with -1e30 as the JAX engine does.
        qg = q.view(ns, KVH, H // KVH, hd).float()
        scores = torch.einsum("nkgd,nskd->nkgs", qg, kh.float()) / (hd ** 0.5)
        scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
        wts = torch.softmax(scores, dim=-1)
        attn = torch.einsum("nkgs,nskd->nkgd", wts, vh.float())
        x = x + attn.reshape(ns, H * hd).to(dt) @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], mcfg.norm_eps)
        gate = h @ lp["w_gate"]
        up = h @ lp["w_up"]
        return x + (F.silu(gate) * up) @ lp["w_down"]

    def _step(params, kc, vc, bt, last, pos, active, temp, topk, seeds):
        act = active & (pos < S)
        x = params["embed"][last].to(dt)
        w = pos.clamp_max(S - 1)
        c = cos[w][:, None]
        s = sin[w][:, None]
        pp = torch.where(act, bt[slot_idx, w // page], 0)
        off = torch.where(act, w % page, 0)
        mask = ctx_idx[None, :] <= w[:, None]                 # [ns, CTX]
        for i in range(L):
            x = _decode_layer(x, _layer(params, i), kc[i], vc[i], bt, pp,
                              off, mask, c, s)
        x = rms_norm(x, params["final_norm"], mcfg.norm_eps)
        logits = x @ params["lm_head"]                        # [ns, V]
        nxt = _sample_tokens(logits, temp, topk, seeds, pos)
        nxt = torch.where(act, nxt, last)
        pos2 = torch.where(act, pos + 1, pos)
        return nxt, pos2

    def decode(params, kc, vc, bt, last, pos, active, temp, topk, seeds):
        """``chunk`` decode steps over every slot -> (last, pos, out
        [ns, chunk]); the arena is written in place."""
        out = torch.zeros((ns, chunk), dtype=torch.int64, device=device)
        for i in range(chunk):
            last, pos = _step(params, kc, vc, bt, last, pos, active, temp,
                              topk, seeds)
            out[:, i] = last
        return last, pos, out

    def poke(last, pos, slot, first, length):
        """Admission bookkeeping ON DEVICE: set one slot's (last, pos)
        without a host round-trip (``first`` may be a device scalar)."""
        last[slot] = first
        pos[slot] = length

    return prefill, decode, adopt, poke, empty_caches


def _seed_key(seed: int) -> int:
    """The request seed as the signed int64 the sampler hashes."""
    return _i64(int(seed))


class _Request:
    __slots__ = ("ids", "max_tokens", "out", "produced", "slot",
                 "adopt_kv", "first", "temperature", "top_k", "seed")

    def __init__(self, ids: List[int], max_tokens: int,
                 adopt_kv: Optional[Tuple[Any, Any]] = None,
                 first: int = -1, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
        self.ids = ids
        self.max_tokens = max_tokens
        self.out: "queue.Queue[Optional[List[int]]]" = queue.Queue()
        self.produced = 0
        self.slot = -1
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        # Disaggregated handoff: (ks, vs) prefilled elsewhere + the first
        # generated token (already streamed by the prefill side, so this
        # engine never re-emits it).
        self.adopt_kv = adopt_kv
        self.first = first


def _cast_params(params: Dict[str, Any], dtype: torch.dtype,
                 device: torch.device) -> Dict[str, Any]:
    """Every weight in the compute dtype on ``device``, cast once; the
    norms (read in f32 by rms_norm) keep their dtype."""
    def conv(name, t):
        if isinstance(t, dict):
            return {k: conv(k, v) for k, v in t.items()}
        if name.endswith("norm"):
            return t.to(device)
        return t.to(device=device, dtype=dtype)
    return {k: conv(k, v) for k, v in params.items()}


class Engine:
    """One continuous-batching decode loop over a paged KV cache.
    submit() from any thread; each request streams token chunks through
    its own queue."""

    # Smallest prefill bucket; buckets double up to max_seq.
    _MIN_BUCKET = 32

    def __init__(self, params, mcfg, *, n_slots: int = 8,
                 decode_chunk: int = 8, page_size: int = 64,
                 n_pages: Optional[int] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.mcfg = mcfg
        self.n_slots = n_slots
        self.chunk = decode_chunk
        self.params = _cast_params(params, mcfg.dtype, self.device)
        S = mcfg.max_seq
        self.page = min(page_size, S)
        self.maxp = -(-S // self.page)
        if n_pages is None:
            # Null page + half the worst case: density comes from short
            # requests reserving only what len+max_tokens needs.
            n_pages = 1 + max(self.maxp, (n_slots * self.maxp + 1) // 2)
        if n_pages < 1 + self.maxp:
            raise ValueError(
                f"n_pages={n_pages} cannot hold one max_seq request "
                f"({self.maxp} pages of {self.page} tokens) + null page")
        self.n_pages = n_pages
        (self._prefill, self._decode, self._adopt, self._poke,
         empty) = _build_fns(mcfg, n_slots, decode_chunk, self.page,
                             n_pages, self.device)
        self._kc, self._vc = empty()
        # Prefill shape buckets (powers of 2, capped at max_seq).
        self.buckets: List[int] = []
        b = min(self._MIN_BUCKET, mcfg.max_seq)
        while b < mcfg.max_seq:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(mcfg.max_seq)
        # host-side slot + page state (control flow is host-predicted;
        # only token VALUES come back from the device)
        self._slot_req: List[Optional[_Request]] = [None] * n_slots
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._bt = np.zeros((n_slots, self.maxp), np.int64)
        self._pos = np.zeros(n_slots, np.int64)
        self._active = np.zeros(n_slots, bool)
        # Per-slot sampling state (temp 0 = greedy; seed per request so
        # streams are reproducible wherever the slot lands).
        self._temp = np.zeros(n_slots, np.float32)
        self._topk = np.zeros(n_slots, np.int64)
        self._seeds = np.zeros(n_slots, np.int64)
        self._last_d = torch.zeros(n_slots, dtype=torch.int64,
                                   device=self.device)
        self._pos_d = torch.zeros(n_slots, dtype=torch.int64,
                                  device=self.device)
        self.peak_pages_used = 0
        self._pending: deque = deque()
        self._plock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.error: Optional[str] = None
        # Emission FIFO: the dispatch loop enqueues device results; the
        # emitter thread performs the host syncs. maxsize bounds how far
        # dispatch runs ahead of the device (pipeline depth).
        self._emit_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._emitter = threading.Thread(target=self._emit_loop,
                                         daemon=True, name="llm-emit")
        self._emitter.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # ------------------------------------------------------------------
    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Host state -> device without blocking the loop: a fresh pinned
        copy (never written again) sent with non_blocking; on the CPU a
        fresh copy, since the loop mutates ``arr`` while a chunk runs."""
        if self.device.type == "cuda":
            return torch.from_numpy(arr).pin_memory().to(
                self.device, non_blocking=True)
        return torch.from_numpy(arr.copy())

    def _fetch(self, t: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
        """Start a device->host copy; the emitter waits on the event."""
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    # ------------------------------------------------------------------
    def submit(self, ids: List[int], max_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               seed: int = 0) -> "queue.Queue":
        """Enqueue a request; returns its stream of token-chunk lists
        (None terminates the stream). temperature 0 = greedy; top_k
        bounds sampling to the best k logits (capped at TOPK_CAP); seed
        makes the sample stream reproducible."""
        if self.error is not None or not self._thread.is_alive():
            raise RuntimeError(f"LLM engine died:\n{self.error}")
        req = _Request(ids[: self.mcfg.max_seq - 1], max_tokens,
                       temperature=temperature, top_k=top_k, seed=seed)
        if max_tokens <= 0:
            req.out.put(None)  # nothing to generate; skip the prefill too
            return req.out
        with self._plock:
            self._pending.append(req)
        self._wake.set()
        return req.out

    def submit_prefilled(self, ks: Any, vs: Any, length: int, first: int,
                         max_tokens: int, *, temperature: float = 0.0,
                         top_k: int = 0, seed: int = 0) -> "queue.Queue":
        """Adopt an externally prefilled request: KV [L, W, KVH, hd] from
        a prefill pass; decoding continues from token ``first`` at position
        ``length``. The stream yields only tokens AFTER ``first``."""
        if self.error is not None or not self._thread.is_alive():
            raise RuntimeError(f"LLM engine died:\n{self.error}")
        req = _Request([0] * min(length, self.mcfg.max_seq - 1),
                       max_tokens, adopt_kv=(ks, vs), first=first,
                       temperature=temperature, top_k=top_k, seed=seed)
        if max_tokens <= 1:
            req.out.put(None)  # prefill's first token was the whole ask
            return req.out
        with self._plock:
            self._pending.append(req)
        self._wake.set()
        return req.out

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)
        try:
            self._emit_q.put(None, timeout=10)  # sentinel: drain + exit
        except queue.Full:
            pass
        self._emitter.join(timeout=30)

    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Admit pending requests into free slots while their page
        reservations fit (FIFO: the head waits for a finish rather than
        being overtaken). Safe with chunks in flight: an in-flight chunk
        saw the new slot as inactive, and the prefill + poke queue behind
        it on the device stream. Every first-token copy of a burst starts
        before anything blocks."""
        S = self.mcfg.max_seq
        emits: List[Tuple[_Request, Any, bool]] = []  # (req, first, done)
        while True:
            with self._plock:
                req = self._pending[0] if self._pending else None
            if req is None:
                break
            slot = next((i for i in range(self.n_slots)
                         if not self._active[i]
                         and self._slot_req[i] is None), None)
            need = -(-min(len(req.ids) + req.max_tokens, S) // self.page)
            if slot is None or len(self._free) < need:
                break  # head-of-line waits for a finish

            with self._plock:
                self._pending.popleft()
            pages = [self._free.pop() for _ in range(need)]
            self._slot_pages[slot] = pages
            self.peak_pages_used = max(self.peak_pages_used,
                                       self.pages_in_use())
            self._bt[slot, :] = 0
            self._bt[slot, :need] = pages
            pages_d = self._h2d(self._bt[slot])
            if req.adopt_kv is not None:
                ks, vs = req.adopt_kv
                req.adopt_kv = None
                self._adopt(self._kc, self._vc, pages_d,
                            ks.to(self.device), vs.to(self.device))
                first = req.first
            else:
                width = next(b for b in self.buckets if b >= len(req.ids))
                toks = np.zeros((1, width), np.int64)
                toks[0, :len(req.ids)] = req.ids
                first = self._prefill(
                    self.params, self._kc, self._vc, pages_d,
                    self._h2d(toks), len(req.ids), req.temperature,
                    req.top_k, _seed_key(req.seed))
            req.slot = slot
            self._slot_req[slot] = req
            self._pos[slot] = len(req.ids)
            self._active[slot] = True
            # Sampling state applies on BOTH branches (a handoff continues
            # decoding with the request's params).
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._seeds[slot] = _seed_key(req.seed)
            req.produced = 1
            self._poke(self._last_d, self._pos_d, slot, first,
                       int(self._pos[slot]))
            done = (req.produced >= req.max_tokens
                    or self._pos[slot] >= S)
            if done:
                self._finish_state(slot)
            emits.append((req, first, done))
        # Start EVERY device->host copy first, THEN enqueue: a burst
        # overlaps its transfers even when the bounded put blocks.
        fetched = [(req, self._fetch(first), done)
                   for req, first, done in emits]
        for req, handle, done in fetched:
            self._emit_q.put(("first", req, handle, done))

    def _finish_state(self, slot: int) -> None:
        """Free the slot + pages (host control state only — the stream's
        terminating None is emitted by the emitter thread, AFTER the
        slot's final tokens)."""
        self._slot_req[slot] = None
        self._active[slot] = False
        self._free.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._bt[slot, :] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._finish_state(slot)
        if req is not None:
            req.out.put(None)

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._run_inner()
        except Exception:
            # A dead engine must not strand consumers on silent queues.
            self.error = traceback.format_exc()
            for slot in range(self.n_slots):
                self._finish(slot)
            while True:
                with self._plock:
                    req = self._pending.popleft() if self._pending else None
                if req is None:
                    break
                req.out.put(None)

    @staticmethod
    def _host(handle) -> Any:
        value, ev = handle
        if ev is not None:
            ev.synchronize()
        return value

    def _emit_loop(self) -> None:
        """The only place the serving path waits on the device: fetch
        first tokens / chunk outputs and emit them to each request's
        stream, in dispatch order."""
        while True:
            item = self._emit_q.get()
            if item is None:
                return
            try:
                if item[0] == "first":
                    _, req, handle, done = item
                    if req.first < 0:
                        req.out.put([int(self._host(handle))])
                    if done:
                        req.out.put(None)
                else:  # ("chunk", handle, plan)
                    _, handle, plan = item
                    out_h = self._host(handle).tolist()
                    for slot, req, take, fin in plan:
                        toks = out_h[slot][:take]
                        if toks:
                            req.out.put(toks)
                        if fin:
                            req.out.put(None)
            except Exception:
                self.error = self.error or traceback.format_exc()
                # Terminate the affected streams rather than stranding
                # their consumers.
                if item[0] == "first":
                    item[1].out.put(None)
                else:
                    for _, req, _, _ in item[2]:
                        req.out.put(None)

    def _run_inner(self) -> None:
        S = self.mcfg.max_seq
        while not self._stop:
            self._admit()
            if not self._active.any():
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            # Predict this chunk's control outcome on the host: per-slot
            # emit counts and finishes depend only on pos/produced, never
            # on token values, so the chunk's finishes free slots/pages
            # immediately (a later request always writes a position before
            # reading it, and its device work queues behind this chunk).
            plan = []
            for slot in range(self.n_slots):
                req = self._slot_req[slot]
                if req is None or not self._active[slot]:
                    continue
                valid = int(max(0, min(self.chunk, S - self._pos[slot])))
                take = int(min(valid, req.max_tokens - req.produced))
                fin = (req.produced + take >= req.max_tokens
                       or self._pos[slot] + valid >= S)
                req.produced += take
                plan.append((slot, req, take, fin))
            if not plan:  # defensive: never hot-spin
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            self._last_d, self._pos_d, out_d = self._decode(
                self.params, self._kc, self._vc, self._h2d(self._bt),
                self._last_d, self._pos_d, self._h2d(self._active),
                self._h2d(self._temp), self._h2d(self._topk),
                self._h2d(self._seeds))
            self._pos = np.where(
                self._active, np.minimum(self._pos + self.chunk, S),
                self._pos).astype(np.int64)
            for slot, req, take, fin in plan:
                if fin and self._slot_req[slot] is req:
                    self._finish_state(slot)
            # Blocks when the emitter is `maxsize` chunks behind — the
            # pipeline-depth bound.
            self._emit_q.put(("chunk", self._fetch(out_d), plan))
