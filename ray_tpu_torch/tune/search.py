"""Search spaces + variant generation (counterpart of
``ray_tpu/tune/search.py``).

Analogue of the reference's search layer (reference: python/ray/tune/
search/sample.py Domain/Float/Integer/Categorical, search/basic_variant.py
BasicVariantGenerator — grid cross-product x num_samples random sampling).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math
        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self._lo, self._hi))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, options: List[Any]):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class GridSearch:
    """Marker: every value is tried (cross-product with other grids)."""

    def __init__(self, values: List[Any]):
        self.values = list(values)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(options: List[Any]) -> Choice:
    return Choice(options)


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(values)


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None
                      ) -> Iterator[Dict[str, Any]]:
    """Grid keys expand to their cross-product; Domain keys are sampled
    fresh per variant; plain values pass through. num_samples multiplies
    the grid (reference: BasicVariantGenerator semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grid_values = [param_space[k].values for k in grid_keys]
    grid_points = list(itertools.product(*grid_values)) if grid_keys \
        else [()]
    for _ in range(num_samples):
        for point in grid_points:
            cfg: Dict[str, Any] = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = point[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            yield cfg


# ---------------------------------------------------------------------------
# Searcher seam (reference: python/ray/tune/search/searcher.py Searcher +
# basic_variant.py BasicVariantGenerator): pluggable suggestion
# algorithms — the Tuner asks `suggest(trial_id)` for each trial's config
# and feeds completions back for adaptive searchers.
# ---------------------------------------------------------------------------

class Searcher:
    """Base: subclass and implement suggest(); optionally learn from
    on_trial_complete()."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False,
                          budget: int = 0) -> None:
        """`budget`: the iteration count the trial reached — multi-
        fidelity searchers (BOHB's TPE) compare observations only
        within a budget level."""
        pass

    def on_trial_restore(self, trial_id: str,
                         config: Dict[str, Any]) -> None:
        """A restored (re-run) trial is back in flight with `config`:
        adaptive searchers re-register it so its eventual completion is
        attributable (Tuner.restore path)."""
        pass


class BasicVariantGenerator(Searcher):
    """Random/grid sampling over a param space — the default search
    behavior expressed through the Searcher seam."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._variants = list(generate_variants(param_space, num_samples,
                                                seed))
        self._i = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._variants):
            return None
        v = self._variants[self._i]
        self._i += 1
        return v
