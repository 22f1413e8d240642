"""LLM serving preset, in-process half (counterpart of
``ray_tpu/serve/llm.py``): a Llama model behind the continuous-batching
engine, answering OpenAI-style completion bodies.

Tokenization is bring-your-own (``LLMConfig.tokenizer`` /
``detokenizer``); the default passes token-id lists through untouched.
Weights are random (seed 0), or read from a checkpoint of a params tree
(``params_path``, written by either package's ``save_checkpoint``). The
serve deployment, HTTP and prefill/decode-disaggregated half
(``build_llm_app``, ``PrefillServer``, ``DecodeServer``, ``PDIngress``,
``run_pd_llm_app``) needs the runtime and waits for a later slice.

    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    server = LLMServer(LLMConfig(d_model=1024, n_layers=8))
    server.complete({"prompt": [1, 2, 3], "max_tokens": 16})
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, init_params
from ray_tpu_torch.serve.engine import Engine
from ray_tpu_torch.train.checkpointing import load_checkpoint_host


@dataclass
class LLMConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    max_seq: int = 512
    max_ongoing_requests: int = 16
    decode_chunk: int = 8          # tokens per decode dispatch
    page_size: int = 64            # KV page width (tokens)
    kv_pages: Optional[int] = None  # physical pages (None: engine default)
    params_path: str = ""          # committed checkpoint dir (step-N)
    tokenizer: Optional[Callable[[str], List[int]]] = None
    detokenizer: Optional[Callable[[List[int]], str]] = None
    device: DeviceLike = None      # None: the CUDA card


class LLMServer:
    """Builds the model + continuous-batching engine once, then serves
    streaming completions. Concurrent requests share ONE decode loop over
    a paged KV arena (serve/engine.py)."""

    def __init__(self, cfg: LLMConfig):
        self.cfg = cfg
        self.mcfg, params = _model_from_cfg(cfg)
        self.engine = Engine(params, self.mcfg,
                             n_slots=cfg.max_ongoing_requests,
                             decode_chunk=cfg.decode_chunk,
                             page_size=cfg.page_size,
                             n_pages=cfg.kv_pages, device=cfg.device)

    def _decode_text(self, ids: List[int]):
        if self.cfg.detokenizer is not None:
            return self.cfg.detokenizer(ids)
        return ids

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
            out = self._decode_text(toks)
            yield (out if isinstance(out, str)
                   else " ".join(str(t) for t in out) + " ")

    def complete(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Non-streaming OpenAI-style response."""
        text = "".join(self(body))
        return {"object": "text_completion",
                "model": f"ray_tpu-llama-{self.cfg.d_model}",
                "choices": [{"index": 0, "text": text,
                             "finish_reason": "length"}]}

    def stop(self) -> None:
        self.engine.stop()


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
