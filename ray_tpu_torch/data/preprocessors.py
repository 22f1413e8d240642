"""Dataset preprocessors: fit statistics once, transform as a streamed
map stage.

Analogue of the reference's preprocessor layer (reference:
python/ray/data/preprocessor.py Preprocessor.fit/transform +
python/ray/data/preprocessors/{scaler.py,encoder.py,concatenator.py,
chain.py}). `fit` aggregates per-block partial statistics THROUGH
the streaming executor (map_batches emits one small stats row per block;
the driver reduces them), and `transform` is a plain map_batches stage,
so fitted pipelines compose with sharding and `iter_torch_batches` like
any other dataset op.

    from ray_tpu_torch.data.preprocessors import StandardScaler, Chain
    prep = Chain(StandardScaler(["x"]), Concatenator(["x", "y"], "f"))
    prep.fit(train_ds)
    model_input = prep.transform(eval_ds)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Preprocessor:
    """fit(ds) learns state; transform(ds) applies it lazily."""

    _fitted = False

    # -- subclass hooks -------------------------------------------------
    def _aggregate(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Per-block partial statistics (runs inside a task)."""
        raise NotImplementedError

    def _reduce(self, partials: List[Dict[str, Any]]) -> None:
        """Combine partials into fitted state (runs on the driver)."""
        raise NotImplementedError

    def _transform_batch(self, batch: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # -- public ---------------------------------------------------------
    def fit(self, ds) -> "Preprocessor":
        agg = self._aggregate

        def per_block(batch):
            return {"__stats__": np.asarray([agg(batch)], dtype=object)}

        partials = [row["__stats__"] for row in
                    ds.map_batches(per_block).take_all()]
        self._reduce(partials)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        return ds.map_batches(self._transform_batch)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        """Apply to ONE in-memory batch (serving-time path; reference:
        Preprocessor.transform_batch)."""
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        return self._transform_batch(batch)

    def _needs_fit(self) -> bool:
        return True


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference: preprocessors/scaler.py
    StandardScaler — same one-pass sum/sum-of-squares reduction)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _aggregate(self, batch):
        out = {}
        for c in self.columns:
            v = np.asarray(batch[c], dtype=np.float64)
            out[c] = (v.size, float(v.sum()), float((v * v).sum()))
        return out

    def _reduce(self, partials):
        for c in self.columns:
            n = sum(p[c][0] for p in partials)
            s = sum(p[c][1] for p in partials)
            ss = sum(p[c][2] for p in partials)
            mean = s / max(1, n)
            var = max(0.0, ss / max(1, n) - mean * mean)
            self.stats_[c] = (mean, float(np.sqrt(var)) or 1.0)

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            out[c] = (np.asarray(batch[c], np.float64) - mean) / (std or 1.0)
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column (reference: scaler.py
    MinMaxScaler)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _aggregate(self, batch):
        return {c: (float(np.min(batch[c])), float(np.max(batch[c])))
                for c in self.columns}

    def _reduce(self, partials):
        for c in self.columns:
            lo = min(p[c][0] for p in partials)
            hi = max(p[c][1] for p in partials)
            self.stats_[c] = (lo, hi)

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[c]
            span = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c], np.float64) - lo) / span
        return out


class LabelEncoder(Preprocessor):
    """Categorical column -> dense int codes, deterministic (sorted)
    label order (reference: preprocessors/encoder.py LabelEncoder)."""

    def __init__(self, column: str):
        self.column = column
        self.classes_: List[Any] = []
        self._index: Dict[Any, int] = {}

    def _aggregate(self, batch):
        return {"labels": sorted({v if not isinstance(v, np.generic)
                                  else v.item()
                                  for v in np.asarray(batch[self.column])})}

    def _reduce(self, partials):
        seen = set()
        for p in partials:
            seen.update(p["labels"])
        self.classes_ = sorted(seen)
        self._index = {v: i for i, v in enumerate(self.classes_)}

    def _transform_batch(self, batch):
        out = dict(batch)
        idx = self._index
        vals = np.asarray(batch[self.column])
        codes = np.empty(len(vals), np.int64)
        for i, v in enumerate(vals):
            v = v.item() if isinstance(v, np.generic) else v
            code = idx.get(v)
            if code is None:
                raise ValueError(
                    f"LabelEncoder({self.column!r}): value {v!r} was not "
                    f"seen during fit (known: {self.classes_[:10]}...)")
            codes[i] = code
        out[self.column] = codes
        return out


class Concatenator(Preprocessor):
    """Stack columns into one feature matrix column (reference:
    preprocessors/concatenator.py) — the standard last step before
    `iter_torch_batches` hands a dense array to the model. Stateless."""

    def __init__(self, columns: List[str], output_column: str = "features",
                 *, dtype=np.float32, drop_inputs: bool = True):
        self.columns = list(columns)
        self.output_column = output_column
        self.dtype = dtype
        self.drop_inputs = drop_inputs
        self._fitted = True

    def _needs_fit(self) -> bool:
        return False

    def fit(self, ds):
        return self

    def _transform_batch(self, batch):
        cols = []
        for c in self.columns:
            v = np.asarray(batch[c], dtype=self.dtype)
            cols.append(v[:, None] if v.ndim == 1 else
                        v.reshape(len(v), -1))
        out = {k: v for k, v in batch.items()
               if not (self.drop_inputs and k in self.columns)}
        out[self.output_column] = np.concatenate(cols, axis=1)
        return out


class Chain(Preprocessor):
    """Sequential composition; fit() fits each stage on the output of
    the previous stages (reference: preprocessors/chain.py)."""

    def __init__(self, *stages: Preprocessor):
        self.stages = list(stages)
        self._fitted = True  # delegated to stages

    def _needs_fit(self) -> bool:
        return False

    def fit(self, ds):
        cur = ds
        for st in self.stages:
            st.fit(cur)
            cur = st.transform(cur)
        return self

    def transform(self, ds):
        for st in self.stages:
            ds = st.transform(ds)
        return ds

    def transform_batch(self, batch):
        for st in self.stages:
            batch = st.transform_batch(batch)
        return batch
