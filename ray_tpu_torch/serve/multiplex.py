"""Model multiplexing: many models share a pool of replicas.

Analogue of the reference's multiplexing (reference: serve/multiplex.py
_ModelMultiplexWrapper + serve/api.py @serve.multiplexed +
get_multiplexed_model_id): a replica lazily loads models on demand and
keeps an LRU of at most `max_num_models_per_replica`; the handle tags
requests with `options(multiplexed_model_id=...)`, the router sticks a
model's requests to the replica that already holds it, and the loader
inside the replica reads the id via `get_multiplexed_model_id()`.

    @serve.deployment
    class Mux:
        def __init__(self):
            self._get = serve.multiplexed(
                max_num_models_per_replica=2)(self._load)

        def _load(self, model_id: str):
            return load_weights(model_id)          # slow, cached

        def __call__(self, body):
            model = self._get(serve.get_multiplexed_model_id())
            return model.predict(body)
"""

from __future__ import annotations

import contextvars
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id the CURRENT request was tagged with
    (handle.options(multiplexed_model_id=...)); "" when untagged."""
    return _current_model_id.get()


def _set_current_model_id(model_id: str):
    return _current_model_id.set(model_id or "")


class _ModelMultiplexWrapper:
    """Per-replica LRU of loaded models keyed by model id."""

    def __init__(self, loader: Callable[[str], Any], max_models: int):
        self._loader = loader
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, model_id: str) -> Any:
        if not model_id:
            raise ValueError(
                "no multiplexed model id on this request — call with "
                "handle.options(multiplexed_model_id=...)")
        with self._lock:
            model = self._models.get(model_id)
            if model is not None:
                self._models.move_to_end(model_id)
                return model
        # Load OUTSIDE the lock (loads are slow); a racing duplicate load
        # of the same id is wasteful but harmless (last one wins).
        model = self._loader(model_id)
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self._max:
                self._models.popitem(last=False)  # LRU eviction
        return model

    @property
    def loaded_model_ids(self):
        with self._lock:
            return list(self._models)


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator/wrapper producing a per-replica multiplexed loader
    (reference: serve/api.py multiplexed)."""
    def wrap(f: Callable) -> _ModelMultiplexWrapper:
        return _ModelMultiplexWrapper(f, max_num_models_per_replica)

    if func is not None:
        return wrap(func)
    return wrap
