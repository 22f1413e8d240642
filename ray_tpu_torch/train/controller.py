"""TrainController — gang-schedules and supervises the worker group (a
copy of ``ray_tpu/train/controller.py``).

Analogue of the reference's Train v2 controller (reference:
python/ray/train/v2/_internal/execution/controller/controller.py:96
_run_control_loop_iteration/:259 _poll_workers, worker_group/worker_group.py,
failure_policy/). Differences by design: runs in the driver process (fit()
blocks anyway; a detached controller actor is the reference's resume story,
ours is the checkpoint manager), and the group's store address is chosen
up front and passed in each worker's env at spawn, beside the card
pinning (``CUDA_VISIBLE_DEVICES``) that CUDA reads at its first use.

Control loop: reserve a placement group (one bundle per worker, GPUs
first-class) → create one TrainWorker actor per bundle with the group's
env in its runtime_env → start() everyone → poll; on any worker failure
tear the group down and restart it (FailureConfig.max_failures), seeding
the new group with the latest reported checkpoint.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch import api as _api
from ray_tpu_torch.train.api_config import (FailureConfig, Result, RunConfig,
                                            ScalingConfig)
from ray_tpu_torch.train.worker import TrainWorker
from ray_tpu_torch.utils import get_logger

logger = get_logger("train.controller")


class TrainingFailedError(RuntimeError):
    pass


class _ResizeRequested(Exception):
    """Control-flow signal: the scaling policy wants a new world size."""

    def __init__(self, target: int):
        super().__init__(f"resize to {target} workers")
        self.target = target


class TrainController:
    def __init__(self, train_loop, train_loop_config: Optional[dict],
                 scaling_config: ScalingConfig, run_config: RunConfig,
                 worker_env: Optional[Dict[str, Optional[str]]] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self._fn_blob = cloudpickle.dumps(train_loop)
        self._config = train_loop_config
        self._scaling = scaling_config
        self._run_cfg = run_config
        self._worker_env = dict(worker_env or {})
        self._datasets = dict(datasets or {})
        self._latest_checkpoint: Any = None
        self._metrics_history: List[Dict[str, Any]] = []
        # World size is policy-owned: fixed by default, capacity-tracked
        # when ScalingConfig.max_workers is set (reference: train/v2
        # ScalingPolicy + controller.py:171 _execute_resize_decision).
        from ray_tpu_torch.train.scaling_policy import (ElasticScalingPolicy,
                                                        FixedScalingPolicy)
        if scaling_config.max_workers is not None:
            self._policy = ElasticScalingPolicy(
                scaling_config.min_workers or scaling_config.num_workers,
                scaling_config.max_workers)
        else:
            self._policy = FixedScalingPolicy(scaling_config.num_workers)
        self._world = scaling_config.num_workers
        self._resize_pending = 0
        self._resize_target = None
        self._last_policy_check = 0.0
        self._policy_err_logged = False
        # Set while a resize attempt hasn't proven schedulable yet so a
        # failed re-gang rolls back instead of burning failure budget;
        # a rolled-back target is backed off for a while.
        self._pre_resize_world: Optional[int] = None
        self._failed_resize_target: Optional[int] = None
        self._resize_backoff_until = 0.0
        # Top-K retention + auto-resume over the run's storage path
        # (reference: checkpoint_manager.py owned by the controller).
        self._ckpt_manager = None
        if run_config.storage_path:
            from ray_tpu_torch.train.checkpointing import (CheckpointManager,
                                                           run_dir)
            ccfg = run_config.checkpoint_config
            self._ckpt_manager = CheckpointManager(
                run_dir(run_config.storage_path, run_config.name),
                max_to_keep=ccfg.num_to_keep,  # None = keep all
                metric=ccfg.checkpoint_score_attribute,
                mode=ccfg.checkpoint_score_order)
            latest = self._ckpt_manager.latest()
            if latest is not None:  # auto-resume from a prior run
                logger.info("auto-resuming from %s", latest)
                self._latest_checkpoint = latest

    def _make_shards(self, n: int) -> List[Dict[str, Any]]:
        """streaming_split every dataset across the group; one fresh split
        per attempt (a restarted group must not resume half-consumed
        iterators). Returns per-rank {name: DataIterator}."""
        per_rank: List[Dict[str, Any]] = [{} for _ in range(n)]
        self._coordinators: List[Any] = []
        for name, ds in self._datasets.items():
            its = ds.streaming_split(n, equal=True)
            self._coordinators.append(its[0]._coordinator)
            for rank, it in enumerate(its):
                per_rank[rank][name] = it
        return per_rank

    # -- worker group lifecycle -----------------------------------------
    def _make_group(self, pg, n: int):
        if not pg.ready(timeout=120):
            raise TrainingFailedError(
                f"could not reserve {n}x{self._scaling.bundle()} "
                f"({self._scaling.placement_strategy})")
        # The group's store runs inside rank 0's process — pick a free
        # port ON rank 0's node via its agent (a driver-side probe would
        # test the wrong host on multi-host clusters).
        cw = _api._cw()
        info = cw._run(cw.controller.call("get_pg_info",
                                          pg.id.binary())).result()
        nodes = {n_["node_id"]: n_ for n_ in ray_tpu_torch.nodes()}
        addr0 = tuple(nodes[info["bundle_nodes"][0]]["addr"])
        port = cw._run(cw._client_for_worker(addr0).call(
            "probe_free_port")).result()
        coord = f"{addr0[0]}:{port}"

        actor_cls = ray_tpu_torch.remote(TrainWorker)
        workers = []
        for rank in range(n):
            env: Dict[str, Optional[str]] = dict(self._worker_env)
            env["RAY_TPU_TORCH_TRAIN_COORD"] = coord
            env["RAY_TPU_TORCH_TRAIN_RANK"] = str(rank)
            env["RAY_TPU_TORCH_TRAIN_WORLD"] = str(n)
            env["RAY_TPU_TORCH_TRAIN_BACKEND"] = (
                "nccl" if self._scaling.use_gpu else "gloo")
            opts = dict(
                placement_group=pg,
                placement_group_bundle_index=rank,
                runtime_env={"env_vars": env},
                max_restarts=0,  # restarts are group-level, not per-worker
            )
            if self._scaling.use_gpu:
                opts["num_gpus"] = float(self._scaling.gpus_per_worker or 1)
            workers.append(actor_cls.options(**opts).remote())
        return workers

    def _teardown(self, pg, workers) -> None:
        for w in workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        # Split coordinators are per-attempt: kill them or each restart
        # leaks a worker process (and the blocks its parked streaming
        # tasks pin in the object store).
        for coord in getattr(self, "_coordinators", []):
            try:
                ray_tpu_torch.kill(coord)
            except Exception:
                pass
        self._coordinators = []
        try:
            ray_tpu_torch.remove_placement_group(pg)
        except Exception:
            pass

    # -- control loop ----------------------------------------------------
    def run(self) -> Result:
        max_failures = self._run_cfg.failure_config.max_failures
        attempt = 0
        last_error: Optional[BaseException] = None
        while max_failures == -1 or attempt <= max_failures:
            if attempt > 0:
                logger.info("restarting worker group (attempt %d/%s)",
                            attempt, max_failures)
            try:
                result = self._run_attempt()
                result.metrics_history = self._metrics_history
                result.checkpoint = self._latest_checkpoint
                return result
            except _ResizeRequested as r:
                # Elastic resize is PROGRESS, not failure: re-gang at the
                # new world size from the latest checkpoint without
                # burning a failure budget (reference:
                # controller.py:171 _execute_resize_decision).
                logger.info("elastic resize: %d -> %d workers",
                            self._world, r.target)
                self._pre_resize_world = self._world
                self._world = r.target
            except TrainingFailedError as e:
                if self._pre_resize_world is not None:
                    # The resized gang never became schedulable/healthy:
                    # roll back to the size that WAS working instead of
                    # burning the failure budget on an optimistic target.
                    logger.warning(
                        "resize to %d failed (%s); rolling back to %d",
                        self._world, e, self._pre_resize_world)
                    self._failed_resize_target = self._world
                    self._resize_backoff_until = time.monotonic() + 60.0
                    self._world = self._pre_resize_world
                    self._pre_resize_world = None
                    continue
                last_error = e
                attempt += 1
        return Result(metrics=(self._metrics_history[-1]
                               if self._metrics_history else {}),
                      metrics_history=self._metrics_history,
                      checkpoint=self._latest_checkpoint, error=last_error)

    def _maybe_request_resize(self) -> None:
        """Poll-loop hook: ask the policy for a target world size; two
        consecutive IDENTICAL non-current answers trigger the resize
        (debounce against node-state flaps); a target that just failed
        to re-gang is backed off."""
        now = time.monotonic()
        if now - self._last_policy_check < 1.0:
            return
        self._last_policy_check = now
        try:
            target = self._policy.target_workers(
                self._world, ray_tpu_torch.nodes(), self._scaling.bundle())
        except Exception:
            if not self._policy_err_logged:
                self._policy_err_logged = True
                logger.warning("scaling policy check failed (elastic "
                               "resize disabled until it recovers)",
                               exc_info=True)
            return
        self._policy_err_logged = False
        if target == self._world or target < 1 or (
                target == self._failed_resize_target
                and now < self._resize_backoff_until):
            self._resize_pending = 0
            self._resize_target = None
            return
        if target != self._resize_target:
            self._resize_target = target
            self._resize_pending = 1
            return
        self._resize_pending += 1
        if self._resize_pending >= 2:
            self._resize_pending = 0
            self._resize_target = None
            raise _ResizeRequested(target)

    def _run_attempt(self) -> Result:
        # Attempt-start policy check (no debounce): after a FAILURE the
        # poll loop never saw the capacity change — a node loss must
        # shrink the re-gang here instead of wedging on an unreservable
        # world size (the healthy-path growth stays debounced in
        # _maybe_request_resize).
        try:
            target = self._policy.target_workers(
                self._world, ray_tpu_torch.nodes(), self._scaling.bundle())
            if (target >= 1 and target != self._world
                    and not (target == self._failed_resize_target
                             and time.monotonic()
                             < self._resize_backoff_until)):
                logger.info("attempt-start resize: %d -> %d workers",
                            self._world, target)
                self._world = target
        except Exception:
            pass
        n = self._world
        pg = ray_tpu_torch.placement_group(
            [self._scaling.bundle() for _ in range(n)],
            strategy=self._scaling.placement_strategy)
        workers: list = []
        try:
            workers = self._make_group(pg, n)
            shards = self._make_shards(n)
            starts = [
                w.start.remote(
                    self._fn_blob, self._config,
                    self._run_cfg.name, self._run_cfg.storage_path,
                    self._latest_checkpoint,
                    cloudpickle.dumps(shards[rank]))
                for rank, w in enumerate(workers)]
            ray_tpu_torch.get(starts, timeout=120)
            # The (possibly resized) gang is live: later failures are
            # real failures, not a bad resize target.
            self._pre_resize_world = None
            return self._poll_until_done(workers)
        except (TrainingFailedError, _ResizeRequested):
            raise
        except Exception as e:
            raise TrainingFailedError(f"worker group failed: {e!r}") from e
        finally:
            self._teardown(pg, workers)

    def _ingest_polls(self, polls) -> None:
        """Fold workers' reported (metrics, checkpoint) pairs into the
        run state (rank 0's metrics are the history)."""
        for rank, p in enumerate(polls):
            for metrics, ckpt in p["reported"]:
                if rank == 0:
                    self._metrics_history.append(metrics)
                if ckpt is not None:
                    # Ranks drain independently: only advance, never
                    # regress, the resume point.
                    new_step = getattr(ckpt, "step", None)
                    cur_step = getattr(self._latest_checkpoint, "step",
                                       None)
                    if (new_step is None or cur_step is None
                            or new_step >= cur_step):
                        self._latest_checkpoint = ckpt
                    if rank == 0 and self._ckpt_manager is not None:
                        from ray_tpu_torch.train.checkpointing import Checkpoint
                        if isinstance(ckpt, Checkpoint):
                            self._ckpt_manager.register(ckpt)

    def _poll_until_done(self, workers) -> Result:
        poll_period = 0.2
        while True:
            try:
                polls = ray_tpu_torch.get([w.poll.remote() for w in workers],
                                    timeout=60)
            except Exception as e:  # worker/actor death mid-training
                raise TrainingFailedError(
                    f"worker poll failed: {e!r}") from e
            self._ingest_polls(polls)
            errs = [(i, p["error"]) for i, p in enumerate(polls)
                    if p["status"] == "error"]
            if errs:
                rank, tb = errs[0]
                raise TrainingFailedError(
                    f"train loop failed on rank {rank}:\n{tb}")
            if all(p["status"] == "finished" for p in polls):
                final = self._metrics_history[-1] \
                    if self._metrics_history else {}
                return Result(metrics=final)
            try:
                self._maybe_request_resize()
            except _ResizeRequested:
                # A report can race the resize decision (the worker
                # reported between our poll and the policy check): drain
                # once more so the pre-resize history survives the
                # attempt restart.
                try:
                    self._ingest_polls(ray_tpu_torch.get(
                        [w.poll.remote() for w in workers], timeout=30))
                except Exception:
                    pass
                raise
            time.sleep(poll_period)
            poll_period = min(poll_period * 1.5, 2.0)
