"""LLM serving preset: Llama replicas behind an OpenAI-style endpoint
(counterpart of ``ray_tpu/serve/llm.py``).

Analogue of the reference's LLM layer (reference: python/ray/llm/ —
_internal/serve/deployments/llm/ wraps an engine as Serve deployments with
an OpenAI-compatible router). The engine is this package's paged
continuous-batching ``Engine`` (serve/engine.py), whose prefill runs the
hand-written flash-attention forward on the card; replicas are serve
deployments holding ``num_gpus`` whole cards (the JAX package's
``num_tpus``), streamed over the proxy's chunked HTTP path. ``LLMServer``
also runs in process (``LLMServer(LLMConfig(...))``).

Tokenization is bring-your-own (``LLMConfig.tokenizer`` / ``detokenizer``);
the default passes token-id lists through untouched. Weights are random
(seed 0), or read from a checkpoint of a params tree (``params_path``,
written by either package's ``save_checkpoint``).

Prefill/decode disaggregation (``run_pd_llm_app``): a prefill pool returns
the first token and the KV cache as ``DeviceRef``s, which the decode pool
pulls by CUDA IPC within a node (host bytes across nodes;
``experimental/device_plane.py``).

    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve.llm import LLMConfig, build_llm_app

    handle = serve.run(build_llm_app(LLMConfig(d_model=1024, n_layers=8)),
                       name="llm", route_prefix="/v1/completions")
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import cloudpickle
import numpy as np
import torch

import ray_tpu_torch.serve as serve
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, init_params
from ray_tpu_torch.serve.engine import (Engine, _cast_params,
                                        _make_prefill_core, _sample_tokens,
                                        _seed_key, prefill_buckets)
from ray_tpu_torch.train.checkpointing import load_checkpoint_host


@dataclass
class LLMConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    max_seq: int = 512
    num_replicas: int = 1
    num_gpus: int = 1              # whole cards per replica
    max_ongoing_requests: int = 16
    decode_chunk: int = 8          # tokens per decode dispatch
    page_size: int = 64            # KV page width (tokens)
    kv_pages: Optional[int] = None  # physical pages (None: engine default)
    params_path: str = ""          # committed checkpoint dir (step-N)
    tokenizer: Optional[Callable[[str], List[int]]] = None
    detokenizer: Optional[Callable[[List[int]], str]] = None
    device: DeviceLike = None      # None: the CUDA card


def _config(cfg: Union[LLMConfig, bytes]) -> LLMConfig:
    """The servers take the cloudpickled config (as deployments bind it)
    or, in process, the config itself."""
    return cloudpickle.loads(cfg) if isinstance(cfg, (bytes, bytearray)) \
        else cfg


def _release_cached(device: torch.device) -> None:
    """Release the blocks freed while building (the f32 weights, once
    cast) from this process's caching allocator: replicas that share a
    card (a PD app with ``num_gpus=0``) need them."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _engine(cfg: LLMConfig) -> Engine:
    mcfg, params = _model_from_cfg(cfg)
    eng = Engine(params, mcfg, n_slots=cfg.max_ongoing_requests,
                 decode_chunk=cfg.decode_chunk, page_size=cfg.page_size,
                 n_pages=cfg.kv_pages, device=cfg.device)
    del params
    _release_cached(eng.device)
    return eng


def _text(cfg: LLMConfig, ids: List[int]) -> str:
    out = cfg.detokenizer(ids) if cfg.detokenizer is not None else ids
    return out if isinstance(out, str) \
        else " ".join(str(t) for t in out) + " "


class LLMServer:
    """The replica: builds the model + continuous-batching engine once,
    then serves streaming completions. Concurrent requests share ONE
    decode loop over a paged KV arena (serve/engine.py)."""

    def __init__(self, cfg: Union[LLMConfig, bytes]):
        self.cfg = _config(cfg)
        self.engine = _engine(self.cfg)
        self.mcfg = self.engine.mcfg

    def __call__(self, body: Dict[str, Any]):
        """Streaming completion: yields decoded chunks (body: {"prompt":
        [...ids] | str, "max_tokens": N, "temperature": T, "top_k": K,
        "seed": S}; temperature 0/absent = greedy)."""
        ids = _encode_prompt(self.cfg, body.get("prompt", [1]))
        max_new = int(body.get("max_tokens", 16))
        seed = body.get("seed")
        if seed is None:
            # Absent seed = fresh entropy per request (a fixed default
            # would make every client's "sampled" completion identical).
            seed = random.getrandbits(62)
        stream = self.engine.submit(
            ids, max_new,
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)), seed=int(seed))
        while True:
            toks = stream.get()
            if toks is None:
                return
            yield _text(self.cfg, toks)

    def complete(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Non-streaming OpenAI-style response."""
        text = "".join(self(body))
        return {"object": "text_completion",
                "model": f"ray_tpu-llama-{self.cfg.d_model}",
                "choices": [{"index": 0, "text": text,
                             "finish_reason": "length"}]}

    def stop(self) -> None:
        self.engine.stop()


def build_llm_app(cfg: LLMConfig):
    """A bound serve application for this LLM config (reference:
    serve/llm build_openai_app)."""
    dep = serve.deployment(
        num_replicas=cfg.num_replicas,
        num_gpus=cfg.num_gpus,
        max_ongoing_requests=cfg.max_ongoing_requests,
    )(LLMServer)
    return dep.bind(cloudpickle.dumps(cfg))


def _model_from_cfg(cfg: LLMConfig):
    """(LlamaConfig, params on cfg.device) with the JAX package's shape
    rule: head_dim 128 from d_model 256 up, GQA groups of 2."""
    mcfg = LlamaConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=max(2, cfg.d_model // 128),
        n_kv_heads=max(1, cfg.d_model // 256),
        d_ff=int(cfg.d_model * 2.75), max_seq=cfg.max_seq)
    if cfg.params_path:
        dev = resolve_device(cfg.device)
        host = load_checkpoint_host(cfg.params_path)
        params = _unflatten({k: torch.as_tensor(v).to(dev, mcfg.param_dtype)
                             for k, v in host.items()})
        return mcfg, params
    return mcfg, init_params(mcfg, 0, cfg.device)


def _unflatten(host: Dict[str, Any]) -> Dict[str, Any]:
    """'a.b.c' host-checkpoint keys -> nested dict."""
    out: Dict[str, Any] = {}
    for key, value in host.items():
        parts = key.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value
    return out


def _encode_prompt(cfg: LLMConfig, prompt) -> List[int]:
    if isinstance(prompt, list):
        return [int(t) for t in prompt]
    if cfg.tokenizer is not None:
        return cfg.tokenizer(prompt)
    raise ValueError(
        "string prompts need LLMConfig.tokenizer; or pass token ids")


# ---------------------------------------------------------------------------
# Prefill/decode disaggregation (reference:
# llm/_internal/serve/deployments/prefill_decode_disagg/
# prefill_decode_disagg.py:177 build_pd_openai_app — two engine pools
# joined by a KV-cache transfer backend; here the handoff rides DeviceRefs:
# CUDA IPC within a node, host bytes across nodes).
# ---------------------------------------------------------------------------

class PrefillServer:
    """Prefill pool replica: one full causal pass per prompt, returning
    the first token + the KV cache as DeviceRefs (the tensors stay in
    this replica's memory until the decode side pulls them)."""

    def __init__(self, cfg_blob: Union[LLMConfig, bytes]):
        self.cfg = cfg = _config(cfg_blob)
        self.device = resolve_device(cfg.device)
        self.mcfg, params = _model_from_cfg(cfg)
        # The engine's weights: the compute dtype, cast once.
        self.params = _cast_params(params, self.mcfg.dtype, self.device)
        del params
        _release_cached(self.device)
        self._core = _make_prefill_core(self.mcfg)
        # The engine's bucket ladder and its warm policy: eager PyTorch
        # compiles nothing per width, so every bucket is ready at once (the
        # JAX package warms the smallest and largest and the rest in a
        # background thread, rounding requests up until then).
        self.buckets = prefill_buckets(self.mcfg.max_seq)

    def _row(self, val, dtype) -> torch.Tensor:
        return torch.full((1,), val, dtype=dtype, device=self.device)

    def prefill(self, body: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.device_objects import device_put_ref

        ids = _encode_prompt(self.cfg, body.get("prompt", [1]))
        ids = ids[: self.mcfg.max_seq - 1]
        width = next(b for b in self.buckets if b >= len(ids))
        toks = np.zeros((1, width), np.int64)
        toks[0, :len(ids)] = ids
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            first, ks, vs, logits_row = self._core(
                self.params, torch.from_numpy(toks).to(self.device),
                len(ids))
            temp = float(body.get("temperature", 0.0))
            if temp > 0:
                # Sample the FIRST token here with the monolithic engine's
                # (seed, position) noise: identical seeds give identical
                # streams across deployment topologies.
                first = _sample_tokens(
                    logits_row[None], self._row(temp, torch.float32),
                    self._row(int(body.get("top_k", 0)), torch.int64),
                    self._row(_seed_key(int(body.get("seed", 0))),
                              torch.int64),
                    self._row(len(ids) - 1, torch.int64))[0]
        return {
            "first": int(first),
            "length": len(ids),
            "k": device_put_ref(ks),
            "v": device_put_ref(vs),
        }


class DecodeServer:
    """Decode pool replica: the continuous-batching engine, fed by
    KV handoffs from the prefill pool."""

    def __init__(self, cfg_blob: Union[LLMConfig, bytes]):
        self.cfg = _config(cfg_blob)
        self.engine = _engine(self.cfg)
        self.mcfg = self.engine.mcfg

    def decode_stream(self, meta: Dict[str, Any]):
        """Pull the prefilled KV (CUDA IPC within a node, host bytes
        across nodes) and stream the remaining tokens."""
        from ray_tpu_torch.device_objects import device_get, free_ref

        kref, vref = meta["k"], meta["v"]
        dev = self.engine.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        ks = device_get(kref, device=dev, timeout=120.0)
        vs = device_get(vref, device=dev, timeout=120.0)
        # The copies are done: the prefill side's tensors can go.
        free_ref(kref)
        free_ref(vref)
        stream = self.engine.submit_prefilled(
            ks, vs, meta["length"], meta["first"], meta["max_tokens"],
            temperature=float(meta.get("temperature", 0.0)),
            top_k=int(meta.get("top_k", 0)),
            seed=int(meta.get("seed", 0)))
        while True:
            toks = stream.get()
            if toks is None:
                return
            yield toks


class PDIngress:
    """Router deployment: prompt -> prefill pool, stream -> decode pool
    (the reference's PDProxyServer shape). The first token streams to
    the client straight from the prefill reply — decode-pool admission
    never sits in front of TTFT."""

    def __init__(self, cfg_blob: Union[LLMConfig, bytes], prefill_name: str,
                 decode_name: str):
        self.cfg = _config(cfg_blob)
        self._prefill = serve.get_deployment_handle(prefill_name)
        self._decode = serve.get_deployment_handle(decode_name)

    def __call__(self, body: Dict[str, Any]):
        max_new = int(body.get("max_tokens", 16))
        body = dict(body)
        if body.get("seed") is None:
            # Resolve the seed BEFORE prefill: the prefill side samples
            # the first token with it, the decode side continues with it.
            body["seed"] = random.getrandbits(62)
        resp = self._prefill.options(method_name="prefill").remote(body)
        # ``resp`` is held until the stream ends: its result entry borrows
        # the KV DeviceRefs from the prefill replica, so they stay there
        # until the decode pool has pulled (and freed) them. The hold was
        # the workaround for a fault of the runtime that the JAX package
        # keeps: a borrow of a ref unpickled here registered
        # asynchronously and could land after a dropped result's release.
        # ``CoreWorker._notify_remove_borrow`` now waits for this process's
        # own ``add_borrow`` of the ref first, so the hold is no longer
        # needed for that; it stays as the plain lifetime of the reply.
        meta = resp.result(timeout=300)
        yield _text(self.cfg, [meta["first"]])
        if max_new <= 1:
            return
        meta["max_tokens"] = max_new
        meta["temperature"] = float(body.get("temperature", 0.0))
        meta["top_k"] = int(body.get("top_k", 0))
        meta["seed"] = int(body["seed"])
        for toks in self._decode.options(
                method_name="decode_stream").stream(meta):
            yield _text(self.cfg, toks)

    def complete(self, body: Dict[str, Any]) -> Dict[str, Any]:
        text = "".join(self(body))
        return {"object": "text_completion",
                "model": f"ray_tpu-llama-pd-{self.cfg.d_model}",
                "choices": [{"index": 0, "text": text,
                             "finish_reason": "length"}]}


def _pd_deployments(cfg: LLMConfig, name: str, num_prefill_replicas: int,
                    num_decode_replicas: int) -> Tuple[Any, Any, Any]:
    """The prefill, decode and ingress deployments of a PD app."""
    prefill_dep = serve.deployment(
        name=f"{name}-prefill", num_replicas=num_prefill_replicas,
        num_gpus=cfg.num_gpus,
        max_ongoing_requests=cfg.max_ongoing_requests)(PrefillServer)
    decode_dep = serve.deployment(
        name=f"{name}-decode", num_replicas=num_decode_replicas,
        num_gpus=cfg.num_gpus,
        max_ongoing_requests=cfg.max_ongoing_requests)(DecodeServer)
    ingress_dep = serve.deployment(
        name=name, num_replicas=1,
        max_ongoing_requests=4 * cfg.max_ongoing_requests)(PDIngress)
    return prefill_dep, decode_dep, ingress_dep


def _deploy_pd(cfg: LLMConfig, prefill_dep, decode_dep, ingress_dep):
    """Deploy a PD app's three deployments (pools first: the ingress
    resolves them by name); returns the ingress handle."""
    blob = cloudpickle.dumps(cfg)
    serve.run(prefill_dep.bind(blob), name=prefill_dep.name)
    serve.run(decode_dep.bind(blob), name=decode_dep.name)
    return serve.run(
        ingress_dep.bind(blob, prefill_dep.name, decode_dep.name),
        name=ingress_dep.name)


def run_pd_llm_app(cfg: LLMConfig, *, name: str = "llm-pd",
                   num_prefill_replicas: int = 1,
                   num_decode_replicas: int = 1):
    """Deploy the disaggregated app: prefill pool + decode pool +
    ingress; returns the ingress handle (reference:
    prefill_decode_disagg.py:177 build_pd_openai_app)."""
    return _deploy_pd(cfg, *_pd_deployments(
        cfg, name, num_prefill_replicas, num_decode_replicas))
