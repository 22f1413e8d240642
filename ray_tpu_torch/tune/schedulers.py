"""Trial schedulers: FIFO + ASHA (counterpart of
``ray_tpu/tune/schedulers.py``).

Analogue of the reference's schedulers (reference: python/ray/tune/
schedulers/trial_scheduler.py FIFOScheduler, async_hyperband.py
AsyncHyperBandScheduler/ASHAScheduler — rungs at reduction_factor
intervals; a trial reaching a rung survives only if it is in the top
1/reduction_factor of results recorded at that rung).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


def _rung_decision(vals: Dict[str, float], metric_value: float,
                   rf: int, mode: str) -> str:
    """Successive-halving cut at one rung: survive only in the top
    1/rf of the values recorded there (optimistic until rf peers
    exist). Shared by ASHA and the BOHB brackets."""
    if len(vals) < rf:
        return CONTINUE
    ranked = sorted(vals.values())
    if mode == "max":
        ranked = ranked[::-1]
    cutoff = ranked[max(0, len(vals) // rf - 1)]
    good = metric_value <= cutoff if mode == "min" \
        else metric_value >= cutoff
    return CONTINUE if good else STOP


class FIFOScheduler:
    def on_result(self, trial_id: str, iteration: int,
                  metric_value: float) -> str:
        return CONTINUE


class ASHAScheduler:
    """Asynchronous Successive Halving (reference:
    schedulers/async_hyperband.py:29)."""

    def __init__(self, *, max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3, metric: Optional[str] = None,
                 mode: str = "min"):
        assert mode in ("min", "max")
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.metric = metric  # default: the tuner's metric
        self.mode = mode
        # Rung milestones: grace, grace*rf, grace*rf^2, ... <= max_t
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> {trial_id: recorded metric}. Trial-keyed so a
        # re-run (Tuner.restore) REPLACES its old entry instead of
        # double-counting it against peers.
        self._recorded: Dict[int, Dict[str, float]] = {
            r: {} for r in self.rungs}

    def on_trial_restore(self, trial_id: str) -> None:
        """A restored trial restarts from iteration 0: drop its phase-1
        rung entries so its re-reports don't double-count."""
        for vals in self._recorded.values():
            vals.pop(trial_id, None)

    def on_result(self, trial_id: str, iteration: int,
                  metric_value: float) -> str:
        if iteration >= self.max_t:
            return STOP  # budget exhausted (not a failure)
        for rung in reversed(self.rungs):
            if iteration == rung:
                vals = self._recorded[rung]
                vals[trial_id] = metric_value
                return _rung_decision(vals, metric_value, self.rf,
                                      self.mode)
        return CONTINUE


EXPLOIT = "EXPLOIT"


class PBTScheduler:
    """Population Based Training (reference:
    python/ray/tune/schedulers/pbt.py PopulationBasedTraining — Jaderberg
    et al. 2017). Every `perturbation_interval` iterations, a trial in
    the bottom quantile EXPLOITS a top-quantile peer: the tuner restarts
    it from the peer's checkpoint with perturbed hyperparameters.
    Trainables must save state via tune.report(..., checkpoint=...) and
    resume via tune.get_checkpoint().

    on_result returns CONTINUE, STOP, or ("EXPLOIT", source_trial_id,
    mutated_config_delta)."""

    def __init__(self, *, hyperparam_mutations: Dict[str, Any],
                 perturbation_interval: int = 5,
                 quantile_fraction: float = 0.25,
                 metric: Optional[str] = None, mode: str = "max",
                 perturbation_factors=(0.8, 1.2), seed: int = 0):
        import random as _random
        assert mode in ("min", "max")
        assert 0 < quantile_fraction <= 0.5
        self.mutations = hyperparam_mutations
        self.interval = perturbation_interval
        self.quantile = quantile_fraction
        self.metric = metric
        self.mode = mode
        self.factors = perturbation_factors
        self._rng = _random.Random(seed)
        self._latest: Dict[str, float] = {}       # trial -> last metric
        self._configs: Dict[str, dict] = {}       # trial -> live config
        self._last_perturb: Dict[str, int] = {}

    def track(self, trial_id: str, config: dict) -> None:
        """The tuner registers each trial's (live) config."""
        self._configs[trial_id] = dict(config)
        self._last_perturb.setdefault(trial_id, 0)

    def on_trial_restore(self, trial_id: str) -> None:
        """A restored trial restarts from iteration 0: clear its stale
        metric and perturb clock (track() re-registers the config)."""
        self._latest.pop(trial_id, None)
        self._last_perturb[trial_id] = 0

    def _quantiles(self):
        ranked = sorted(self._latest.items(), key=lambda kv: kv[1],
                        reverse=self.mode == "max")
        n = max(1, int(len(ranked) * self.quantile))
        top = [t for t, _ in ranked[:n]]
        bottom = [t for t, _ in ranked[-n:]] if len(ranked) > 1 else []
        return top, bottom

    def _mutate(self, config: dict) -> dict:
        """Perturb each mutated hyperparam: resample with p=0.25, else
        scale by a perturbation factor (the reference's explore())."""
        from ray_tpu_torch.tune.search import Domain
        out = dict(config)
        for key, spec in self.mutations.items():
            old = out.get(key)
            if self._rng.random() < 0.25 or old is None \
                    or not isinstance(old, (int, float)):
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self._rng)
                elif isinstance(spec, (list, tuple)):
                    out[key] = self._rng.choice(list(spec))
                elif callable(spec):
                    out[key] = spec()
            else:
                out[key] = old * self._rng.choice(self.factors)
                if isinstance(old, int):
                    out[key] = max(1, int(round(out[key])))
        return out

    def on_result(self, trial_id: str, iteration: int,
                  metric_value: float):
        self._latest[trial_id] = metric_value
        if iteration - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = iteration
        if len(self._latest) < 2:
            return CONTINUE
        top, bottom = self._quantiles()
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        source = self._rng.choice(top)
        if source == trial_id:
            return CONTINUE
        new_config = self._mutate(self._configs.get(source, {}))
        self._configs[trial_id] = new_config
        return (EXPLOIT, source, new_config)


class BOHBScheduler:
    """HyperBand bracketing for BOHB (reference: python/ray/tune/
    schedulers/hb_bohb.py HyperBandForBOHB + Falkner et al. 2018): pair
    this scheduler with TPESearcher as the search_alg and you have BOHB —
    model-based proposals + multi-bracket successive halving. Each trial
    is assigned (round-robin over the HyperBand bracket allocation) to a
    bracket whose rung ladder starts at grace_period * rf^s; within a
    bracket the asynchronous successive-halving rule applies, so
    aggressive brackets kill weak trials with tiny budgets while the
    conservative bracket lets slow starters mature."""

    def __init__(self, *, max_t: int = 81, grace_period: int = 1,
                 reduction_factor: int = 3,
                 metric: Optional[str] = None, mode: str = "min"):
        assert mode in ("min", "max")
        self.max_t = max_t
        self.rf = reduction_factor
        self.metric = metric
        self.mode = mode
        # Brackets s = s_max .. 0; bracket s's first rung is
        # grace * rf^s (HyperBand's r_s = R / rf^s budget schedule,
        # expressed as rung milestones).
        s_max = 0
        t = grace_period
        while t * reduction_factor < max_t:
            t *= reduction_factor
            s_max += 1
        # Bracket i (aggressive-first): rung ladder starting at
        # grace * rf^i — bracket 0 halves from the smallest budget,
        # bracket s_max runs near-full budget before any cut.
        self._brackets: List[List[int]] = []
        for i in range(s_max + 1):
            rungs = []
            r = grace_period * (reduction_factor ** i)
            while r < max_t:
                rungs.append(r)
                r *= reduction_factor
            self._brackets.append(rungs or [grace_period])
        # HyperBand allocates ~rf^s / (s+1) trials to the bracket doing
        # s rounds of halving (more to aggressive brackets); bracket i
        # halves s = s_max - i times.
        weights = [max(1, round((reduction_factor ** (s_max - i))
                                / (s_max - i + 1)))
                   for i in range(s_max + 1)]
        self._cycle: List[int] = []
        for idx, w in enumerate(weights):
            self._cycle.extend([idx] * w)
        self._next = 0
        self._bracket_of: Dict[str, int] = {}
        # (bracket, rung) -> {trial_id: metric}
        self._recorded: Dict[tuple, Dict[str, float]] = {}

    def track(self, trial_id: str, config: dict) -> None:
        if trial_id in self._bracket_of:
            return
        self._bracket_of[trial_id] = self._cycle[self._next
                                                 % len(self._cycle)]
        self._next += 1

    def on_trial_restore(self, trial_id: str) -> None:
        for vals in self._recorded.values():
            vals.pop(trial_id, None)

    def on_result(self, trial_id: str, iteration: int,
                  metric_value: float) -> str:
        if iteration >= self.max_t:
            return STOP
        b = self._bracket_of.get(trial_id)
        if b is None:  # untracked (restored mid-run): conservative
            b = len(self._brackets) - 1
            self._bracket_of[trial_id] = b
        for rung in reversed(self._brackets[b]):
            if iteration == rung:
                vals = self._recorded.setdefault((b, rung), {})
                vals[trial_id] = metric_value
                return _rung_decision(vals, metric_value, self.rf,
                                      self.mode)
        return CONTINUE
