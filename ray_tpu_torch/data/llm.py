"""Batch LLM inference over Datasets (counterpart of
``ray_tpu/data/llm.py``).

Analogue of the reference's Data+LLM bridge (reference:
python/ray/llm/_internal/batch/processor/ — build_llm_processor wraps a
vLLM engine as a Dataset stage with actor-pool concurrency). Here the
stage hosts this package's paged-KV engine (serve/engine.py): each pool
actor builds the engine once, and a batch's prompts are submitted together
so the engine's continuous batching decodes them concurrently across slots
— offline throughput from the same machinery that serves online traffic.
Importing this module loads no torch; the pool actors import it.

    from ray_tpu_torch.data.llm import build_llm_processor
    from ray_tpu_torch.serve.llm import LLMConfig

    proc = build_llm_processor(LLMConfig(...), max_tokens=32)
    out = proc(ds)           # adds a "generated" column
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class _LLMBatchWorker:
    """Actor-pool stage body: one engine per pool actor."""

    def __init__(self, cfg_blob: bytes, prompt_column: str,
                 output_column: str, max_tokens: int, temperature: float,
                 top_k: int, seed: int):
        import cloudpickle

        from ray_tpu_torch.serve.llm import _engine

        cfg = cloudpickle.loads(cfg_blob)
        self.cfg = cfg
        self.engine = _engine(cfg)
        self.prompt_column = prompt_column
        self.output_column = output_column
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed

    def _row_seed(self, ids) -> int:
        """Per-row sampling seed derived from the prompt CONTENT plus
        the configured seed: identical across reruns AND across
        batch-size changes, with distinct noise streams for distinct
        prompts."""
        import hashlib
        h = hashlib.blake2b(digest_size=8)
        h.update(int(self.seed).to_bytes(8, "little", signed=True))
        for t in ids:
            h.update(int(t).to_bytes(4, "little", signed=True))
        return int.from_bytes(h.digest(), "little")

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        from ray_tpu_torch.data.block import _column_array
        from ray_tpu_torch.serve.llm import _encode_prompt

        prompts = batch[self.prompt_column]
        # Submit the WHOLE batch first: the engine's continuous batching
        # decodes all of them concurrently across KV slots.
        streams = []
        for prompt in prompts:
            if isinstance(prompt, np.ndarray):
                prompt = prompt.tolist()
            ids = _encode_prompt(self.cfg, prompt)
            streams.append(self.engine.submit(
                ids, self.max_tokens, temperature=self.temperature,
                top_k=self.top_k,
                seed=self._row_seed(ids) if self.temperature > 0 else 0))
        outs = []
        for q in streams:
            toks: list = []
            while True:
                item = q.get()
                if item is None:
                    break
                toks.extend(item)
            if self.cfg.detokenizer is not None:
                outs.append(self.cfg.detokenizer(toks))
            else:
                outs.append(np.asarray(toks, np.int32))
        out = dict(batch)
        out[self.output_column] = _column_array(outs)
        return out

    def stop(self) -> None:
        self.engine.stop()


def build_llm_processor(cfg, *, prompt_column: str = "prompt",
                        output_column: str = "generated",
                        max_tokens: int = 16, temperature: float = 0.0,
                        top_k: int = 0, seed: int = 0,
                        batch_size: int = 32,
                        concurrency: int = 1) -> Callable:
    """Dataset -> Dataset stage generating completions for
    `prompt_column` (token-id lists, or strings via cfg.tokenizer)
    into `output_column`. `concurrency` engines run as an actor pool
    (``cfg.num_gpus`` whole cards each). Reference:
    ray.data.llm.build_llm_processor."""
    import cloudpickle

    blob = cloudpickle.dumps(cfg)

    def apply(ds):
        res = {"GPU": float(cfg.num_gpus)} if cfg.num_gpus else None
        return ds.map_batches(
            _LLMBatchWorker, batch_size=batch_size,
            concurrency=max(1, concurrency),  # engines live in actors
            fn_constructor_args=(blob, prompt_column, output_column,
                                 max_tokens, temperature, top_k, seed),
            resources=res)

    return apply
