"""TPE — Tree-structured Parzen Estimator searcher (counterpart of
``ray_tpu/tune/tpe.py``).

Analogue of the reference's adaptive search integrations (reference:
python/ray/tune/search/hyperopt/hyperopt_search.py wraps hyperopt's TPE;
search/optuna defaults to the same family). Implemented natively against
this framework's Domain types rather than wrapping an external library:
per-dimension Parzen mixtures over the observed trials, split into a
GOOD quantile and the rest; candidates are sampled from the good mixture
and ranked by the density ratio l(x)/g(x) (Bergstra et al., NeurIPS'11 —
the standard independent-factorization simplification).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search import (Choice, Domain, GridSearch,
                                       LogUniform, RandInt, Searcher,
                                       Uniform, generate_variants)


class TPESearcher(Searcher):
    """suggest() returns random draws for the first ``n_initial`` trials,
    then per-dimension TPE proposals; feed completions back through
    on_trial_complete (the Tuner does this automatically)."""

    def __init__(self, param_space: Dict[str, Any], *, metric: str,
                 mode: str = "min", n_initial: int = 8,
                 n_candidates: int = 24, gamma: float = 0.25,
                 seed: Optional[int] = None):
        assert mode in ("min", "max")
        if any(isinstance(v, GridSearch) for v in param_space.values()):
            raise ValueError("grid_search dimensions don't mix with TPE; "
                             "use BasicVariantGenerator for grids")
        self.space = dict(param_space)
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.n_candidates = n_candidates
        self.gamma = gamma
        self._rng = random.Random(seed)
        # trial_id -> config for pending attribution; observations are
        # (config, score) with score oriented so LOWER is better.
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._obs: List[Tuple[Dict[str, Any], float]] = []

    # -- Searcher interface ---------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._obs) < self.n_initial:
            cfg = next(generate_variants(
                self.space, 1, self._rng.randrange(1 << 30)))
        else:
            cfg = self._propose()
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_restore(self, trial_id: str,
                         config: Dict[str, Any]) -> None:
        self._pending[trial_id] = dict(config)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False,
                          budget: int = 0) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or error or not result \
                or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score
        self._obs.append((cfg, score, int(budget)))

    # -- TPE core --------------------------------------------------------
    def _split(self) -> Tuple[list, list]:
        # Multi-fidelity (BOHB, Falkner et al. 2018): model the HIGHEST
        # budget with enough observations — scores from different rungs
        # are not comparable (an early-stopped trial's loss carries the
        # low-fidelity bias). With a single budget level (no early
        # stopping) this is all observations, plain TPE.
        n_min = max(2, len([d for d in self.space.values()
                            if isinstance(d, Domain)]) + 1)
        by_budget: Dict[int, list] = {}
        for o in self._obs:
            by_budget.setdefault(o[2], []).append(o)
        pool = self._obs
        for b in sorted(by_budget, reverse=True):
            if len(by_budget[b]) >= n_min:
                pool = by_budget[b]
                break
        ranked = sorted(pool, key=lambda o: o[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _propose(self) -> Dict[str, Any]:
        good, bad = self._split()
        cfg: Dict[str, Any] = {}
        for key, dom in self.space.items():
            if isinstance(dom, Domain):
                cfg[key] = self._propose_dim(key, dom, good, bad)
            else:
                cfg[key] = dom  # constant passthrough
        return cfg

    def _propose_dim(self, key: str, dom: Domain, good: list, bad: list):
        if isinstance(dom, Choice):
            return self._propose_choice(key, dom, good, bad)
        lo, hi, fwd, inv = _numeric_transform(dom)
        g_vals = [fwd(o[0][key]) for o in good]
        b_vals = [fwd(o[0][key]) for o in bad]
        # Parzen bandwidth: range-scaled, shrinking with the TOTAL
        # observation count (a good-count-only denominator leaves the
        # mixture near-uniform and proposals barely better than random).
        n_total = len(g_vals) + len(b_vals)
        bw = max((hi - lo) / max(4.0, float(n_total)), 1e-12)
        best_x, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            center = self._rng.choice(g_vals)
            x = min(hi, max(lo, self._rng.gauss(center, bw)))
            score = (_log_parzen(x, g_vals, bw, lo, hi)
                     - _log_parzen(x, b_vals, bw, lo, hi))
            if score > best_score:
                best_x, best_score = x, score
        out = inv(best_x)
        if isinstance(dom, RandInt):
            out = min(dom.high - 1, max(dom.low, int(round(out))))
        return out

    def _propose_choice(self, key: str, dom: Choice, good: list,
                        bad: list):
        def probs(obs):
            counts = {repr(opt): 1.0 for opt in dom.options}  # +1 prior
            for o in obs:
                counts[repr(o[0][key])] = counts.get(
                    repr(o[0][key]), 1.0) + 1.0
            total = sum(counts.values())
            return {k: v / total for k, v in counts.items()}

        pg, pb = probs(good), probs(bad)
        # Sample ∝ density ratio (not argmax: keep exploring ties).
        scored = [(pg[repr(opt)] / pb[repr(opt)], opt)
                  for opt in dom.options]
        r = self._rng.uniform(0, sum(w for w, _ in scored))
        acc = 0.0
        for w, opt in scored:
            acc += w
            if r <= acc:
                return opt
        return scored[-1][1]


def _numeric_transform(dom: Domain):
    """(lo, hi, forward, inverse) in the search's metric space."""
    if isinstance(dom, Uniform):
        return dom.low, dom.high, (lambda v: float(v)), (lambda x: x)
    if isinstance(dom, LogUniform):
        return dom._lo, dom._hi, (lambda v: math.log(v)), \
            (lambda x: math.exp(x))
    if isinstance(dom, RandInt):
        return float(dom.low), float(dom.high - 1), \
            (lambda v: float(v)), (lambda x: x)
    raise TypeError(f"TPE cannot search domain {type(dom).__name__}")


def _log_parzen(x: float, centers: List[float], bw: float,
                lo: float, hi: float) -> float:
    """log density of a uniform-floored Gaussian mixture (the floor keeps
    the ratio finite where one side has no mass)."""
    floor = 1.0 / max(hi - lo, 1e-12)
    if not centers:
        return math.log(floor)
    total = 0.0
    norm = 1.0 / (bw * math.sqrt(2 * math.pi))
    for c in centers:
        total += norm * math.exp(-0.5 * ((x - c) / bw) ** 2)
    mix = 0.9 * (total / len(centers)) + 0.1 * floor
    return math.log(max(mix, 1e-300))
