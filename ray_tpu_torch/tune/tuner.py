"""Tuner + TuneController — the experiment driver (counterpart of
``ray_tpu/tune/tuner.py``).

Analogue of the reference's Tuner/TuneController (reference:
python/ray/tune/tuner.py Tuner, tune/execution/tune_controller.py:68 —
manage trial actors up to a concurrency cap, feed results to the
scheduler, collect a ResultGrid).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, FIFOScheduler
from ray_tpu_torch.tune.search import generate_variants
from ray_tpu_torch.tune.trial import (ERROR, PENDING, RUNNING, STOPPED,
                                      TERMINATED, TrialRunner)
from ray_tpu_torch.utils import get_logger

logger = get_logger("tune")


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"                 # or "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None             # FIFO | ASHA | BOHB | PBT
    search_alg: Any = None            # Searcher (suggest/on_trial_complete)
    seed: Optional[int] = None
    # "CPU" -> num_cpus, "GPU" -> num_gpus (whole cards); any other key
    # is a custom resource.
    resources_per_trial: Dict[str, float] = field(default_factory=dict)
    # In-run trial fault tolerance (reference: FailureConfig.max_failures):
    # a trial whose actor dies (node loss) is rescheduled from its latest
    # controller-held checkpoint up to this many times.
    max_failures: int = 0


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any] = field(default_factory=dict)  # last report
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    status: str = PENDING
    error: Optional[str] = None
    iterations: int = 0


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    @property
    def results(self) -> List[TrialResult]:
        return list(self._results)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        assert metric, "a metric is required to rank results"
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError("no trial reported the metric "
                             f"{metric!r}")
        return (min if mode == "min" else max)(
            scored, key=lambda r: r.metrics[metric])

    def num_errors(self) -> int:
        return sum(1 for r in self._results if r.status == ERROR)


class Tuner:
    def __init__(self, trainable: Callable[[dict], Any], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 storage_path: Optional[str] = None,
                 name: str = "tune_run"):
        """storage_path: persist experiment state (trial table + searcher
        state) under storage_path/name after every trial completion —
        Tuner.restore() resumes an interrupted run from it (reference:
        tune/execution/experiment_state.py + Tuner.restore)."""
        self._fn_blob = cloudpickle.dumps(trainable)
        self._space = param_space or {}
        self._cfg = tune_config or TuneConfig()
        self._storage = storage_path
        self._name = name
        self._restored_trials: List[TrialResult] = []
        self._restart_errored = False

    @property
    def experiment_path(self) -> Optional[str]:
        import os
        if not self._storage:
            return None
        return os.path.join(self._storage, self._name)

    @classmethod
    def restore(cls, path: str, trainable: Callable[[dict], Any], *,
                restart_errored: bool = False) -> "Tuner":
        """Resume an interrupted experiment from its state file
        (reference: Tuner.restore). Completed trials keep their results;
        pending/interrupted trials re-run; errored trials re-run only
        with restart_errored=True. The searcher resumes with everything
        it had learned."""
        import os
        import pickle
        with open(os.path.join(path, "experiment_state.pkl"), "rb") as f:
            st = pickle.load(f)
        tuner = cls(trainable,
                    param_space=cloudpickle.loads(st["space_blob"]),
                    tune_config=cloudpickle.loads(st["cfg_blob"]),
                    storage_path=os.path.dirname(os.path.abspath(path)),
                    name=os.path.basename(os.path.abspath(path)))
        tuner._restored_trials = [
            TrialResult(**rec) for rec in st["trials"]]
        tuner._restart_errored = restart_errored
        return tuner

    def _save_state(self, trials: List[TrialResult]) -> None:
        import os
        import pickle
        path = self.experiment_path
        if not path:
            return
        os.makedirs(path, exist_ok=True)
        # cfg_blob captures the searcher/scheduler OBJECTS — including
        # everything an adaptive searcher learned so far.
        st = {
            "space_blob": cloudpickle.dumps(self._space),
            "cfg_blob": cloudpickle.dumps(self._cfg),
            "trials": [{
                "trial_id": t.trial_id, "config": t.config,
                "metrics": t.metrics,
                "metrics_history": t.metrics_history,
                "status": t.status, "error": t.error,
                "iterations": t.iterations,
            } for t in trials],
        }
        tmp = os.path.join(path, "experiment_state.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(st, f)
        os.replace(tmp, os.path.join(path, "experiment_state.pkl"))

    def fit(self) -> ResultGrid:
        cfg = self._cfg
        scheduler = cfg.scheduler or FIFOScheduler()
        if getattr(scheduler, "metric", "x") is None:
            scheduler.metric = cfg.metric

        # Restored trial table: finished trials keep their results;
        # interrupted (and optionally errored) ones re-run.
        trials: List[TrialResult] = list(self._restored_trials)
        rerun: List[TrialResult] = []
        for t in trials:
            if t.status in (TERMINATED, STOPPED):
                continue
            if t.status == ERROR and not self._restart_errored:
                continue
            t.status = PENDING
            t.error = None
            t.metrics = {}
            t.metrics_history = []
            t.iterations = 0
            rerun.append(t)
        next_index = len(trials)

        # Variant source: the searcher proposes LAZILY (one config per
        # launch slot, so completions can inform later suggestions —
        # reference: SearchGenerator), the default generator is a
        # precomputed sequence.
        if cfg.search_alg is None:
            # Same seed -> same sequence: skip the variants the restored
            # trials (completed AND re-queued) already consumed.
            seq = iter(list(generate_variants(
                self._space, cfg.num_samples, cfg.seed))[next_index:])

            def next_variant(trial_id: str):
                return next(seq, None)
        else:
            def next_variant(trial_id: str):
                return cfg.search_alg.suggest(trial_id)

        def launch_next() -> Optional[TrialResult]:
            nonlocal next_index
            if rerun:
                t = rerun.pop(0)
                if cfg.search_alg is not None:
                    # Re-register so the searcher attributes the re-run's
                    # completion (its pending entry died with phase 1).
                    cfg.search_alg.on_trial_restore(t.trial_id, t.config)
                if hasattr(scheduler, "on_trial_restore"):
                    # Restored scheduler state (pickled with the config)
                    # must drop the trial's phase-1 records: it restarts
                    # from iteration 0.
                    scheduler.on_trial_restore(t.trial_id)
                return t
            # Searcher runs are capped at num_samples trials; the
            # default generator's sequence bounds itself (num_samples
            # MULTIPLIES the grid there, reference semantics).
            if cfg.search_alg is not None \
                    and next_index >= cfg.num_samples:
                return None
            tid = f"trial_{next_index:05d}"
            v = next_variant(tid)
            if v is None:
                return None
            t = TrialResult(trial_id=tid, config=v)
            next_index += 1
            trials.append(t)
            by_id[t.trial_id] = t
            if hasattr(scheduler, "track"):  # PBT needs live configs
                scheduler.track(t.trial_id, t.config)
            return t

        running: Dict[str, Any] = {}   # trial_id -> actor handle
        stopping: set = set()
        # Controller-held latest (checkpoint_blob, iteration) + failure
        # count per trial (the reschedule-with-checkpoint FT path).
        ckpts: Dict[str, tuple] = {}
        failures: Dict[str, int] = {}
        # Probe once whether the searcher accepts the budget kwarg (a
        # live-call TypeError fallback would double-invoke a searcher
        # whose BODY raised TypeError).
        searcher_takes_budget = False
        if cfg.search_alg is not None:
            import inspect
            try:
                searcher_takes_budget = "budget" in inspect.signature(
                    cfg.search_alg.on_trial_complete).parameters
            except (TypeError, ValueError):
                pass
        actor_cls = ray_tpu_torch.remote(TrialRunner)
        opts: Dict[str, Any] = {}
        if cfg.resources_per_trial:
            res = dict(cfg.resources_per_trial)
            if "CPU" in res:
                opts["num_cpus"] = res.pop("CPU")
            if "GPU" in res:  # whole cards, pinned to the trial's actor
                opts["num_gpus"] = res.pop("GPU")
            if res:
                opts["resources"] = res
        if opts:
            actor_cls = actor_cls.options(**opts)
        need = {k: float(v) for k, v in cfg.resources_per_trial.items()
                if float(v) > 0}

        def room_for_one_more() -> bool:
            """Whether the cluster's totals hold one more trial beside the
            running ones. A trial queued behind others on a resource (a
            card) waits here, unlaunched: as an actor it would wait in the
            controller, which gives up placing it after a few seconds,
            while the polls below block on it (Ray Tune, likewise, starts
            a trial only once its resources are granted). A request the
            cluster cannot hold at all is launched, and fails, as
            before."""
            if not need or not running:
                return True
            total = ray_tpu_torch.cluster_resources()
            n = len(running) + 1
            return all(total.get(k, 0.0) < v or total.get(k, 0.0) >= n * v
                       for k, v in need.items())

        by_id = {t.trial_id: t for t in trials}
        if hasattr(scheduler, "track"):
            for t in rerun:
                scheduler.track(t.trial_id, t.config)
        exhausted = False
        while True:
            while not exhausted and len(running) < cfg.max_concurrent_trials \
                    and room_for_one_more():
                t = launch_next()
                if t is None:
                    exhausted = True
                    break
                t.status = RUNNING
                running[t.trial_id] = actor_cls.remote(self._fn_blob,
                                                       t.config)
            if not running and exhausted:
                break
            done: List[str] = []
            for tid, actor in running.items():
                t = by_id[tid]
                try:
                    p = ray_tpu_torch.get(actor.poll.remote(), timeout=60)
                except Exception as e:
                    failures[tid] = failures.get(tid, 0) + 1
                    if tid in stopping:
                        # The scheduler already cut this trial; losing
                        # its actor finalizes the stop instead of
                        # resurrecting a full-budget run.
                        t.status = STOPPED
                        done.append(tid)
                        continue
                    if failures[tid] <= cfg.max_failures:
                        # Node/actor loss mid-trial: reschedule from the
                        # latest controller-held checkpoint (fresh start
                        # if it never checkpointed). Reference:
                        # tune_controller restoring FAILED trials under
                        # FailureConfig. Kill the old actor first — a
                        # poll TIMEOUT (not death) must never leave two
                        # copies of the trial running.
                        try:
                            ray_tpu_torch.kill(actor)
                        except Exception:
                            pass
                        ck = ckpts.get(tid)
                        start_it = ck[1] if ck else 0
                        logger.warning(
                            "trial %s lost (%r): rescheduling "
                            "(failure %d/%d, checkpoint_iter=%s)", tid, e,
                            failures[tid], cfg.max_failures, start_it)
                        if hasattr(scheduler, "on_trial_restore") \
                                and ck is None:
                            scheduler.on_trial_restore(tid)
                        # Iteration numbering restarts AT the checkpoint
                        # so scheduler rungs stay aligned.
                        t.iterations = start_it
                        running[tid] = actor_cls.remote(
                            self._fn_blob, t.config,
                            restored=ck[0] if ck else None,
                            start_iteration=start_it)
                        continue
                    t.status = ERROR
                    t.error = f"trial actor died: {e!r}"
                    done.append(tid)
                    continue
                if p.get("checkpoint") is not None:
                    ckpts[tid] = (p["checkpoint"],
                                  p.get("checkpoint_iteration",
                                        p["iteration"]))
                for m in p["reported"]:
                    t.metrics_history.append(m)
                    t.metrics = m
                t.iterations = p["iteration"]
                # The scheduler may rank on its OWN metric (e.g. ASHA on
                # accuracy while the tuner reports best-loss).
                metric = getattr(scheduler, "metric", None) or cfg.metric
                if metric and p["reported"] and tid not in stopping:
                    decision = CONTINUE
                    for i, m in enumerate(p["reported"]):
                        if metric in m:
                            it = (t.iterations - len(p["reported"]) + 1
                                  + i)
                            decision = scheduler.on_result(
                                tid, it, float(m[metric]))
                            if decision != CONTINUE:
                                break
                    if decision == STOP:
                        stopping.add(tid)
                        try:
                            actor.stop_trial.remote()
                        except Exception:
                            pass
                    elif isinstance(decision, tuple) \
                            and decision[0] == "EXPLOIT" \
                            and not p["finished"]:
                        # PBT: restart this trial from the source's
                        # checkpoint with the mutated config. A trial
                        # whose SAME poll already reported finished is
                        # past exploiting (the replacement would be
                        # killed by the done-handling below).
                        _, source_tid, new_config = decision
                        replaced = self._exploit(
                            actor_cls, running, by_id, tid, source_tid,
                            new_config)
                        if replaced is not None:
                            running[tid] = replaced[0]
                            # The FT reschedule path must restore the
                            # EXPLOITED state, not the trial's stale
                            # pre-exploit checkpoint.
                            ckpts[tid] = (replaced[1], t.iterations)
                if p["finished"]:
                    if p["error"]:
                        t.status = ERROR
                        t.error = p["error"]
                    else:
                        t.status = STOPPED if tid in stopping \
                            else TERMINATED
                    done.append(tid)
            for tid in done:
                actor = running.pop(tid)
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    pass
                t = by_id[tid]
                # Completions feed the searcher IMMEDIATELY so later
                # suggestions learn from them (reference: SearchGenerator
                # on_trial_complete).
                if cfg.search_alg is not None:
                    kw = {"budget": t.iterations} \
                        if searcher_takes_budget else {}
                    cfg.search_alg.on_trial_complete(
                        tid, t.metrics or None,
                        error=t.status == ERROR, **kw)
            if done:
                # One snapshot per poll round (it serializes the whole
                # trial table + searcher state).
                self._save_state(trials)
            if running:
                time.sleep(0.2)
        logger.info("tune finished: %d trials (%d errors)", len(trials),
                    sum(1 for t in trials if t.status == ERROR))
        self._save_state(trials)
        return ResultGrid(trials, cfg.metric, cfg.mode)

    def _exploit(self, actor_cls, running, by_id, tid: str,
                 source_tid: str, new_config: dict):
        """PBT exploit: clone the source's checkpoint into a replacement
        actor for `tid` running `new_config` (reference: pbt.py
        _exploit — checkpoint copy + explore). Returns (new_actor,
        checkpoint_blob) or None."""
        source = running.get(source_tid)
        if source is None:
            return None  # source finished: skip this round
        try:
            ckpt = ray_tpu_torch.get(source.get_trial_checkpoint.remote(),
                               timeout=60)
        except Exception:
            return None
        if ckpt is None:
            return None  # source never checkpointed: nothing to copy
        t = by_id[tid]
        old = running[tid]
        try:
            ray_tpu_torch.kill(old)
        except Exception:
            pass
        t.config = dict(new_config)
        logger.info("PBT exploit: %s <- %s (config %s)", tid, source_tid,
                    new_config)
        return (actor_cls.remote(self._fn_blob, dict(new_config),
                                 restored=ckpt,
                                 start_iteration=t.iterations), ckpt)
