"""The port's Tune, the slower half: the node-kill, TPE and BOHB cases of
``tests/test_tune.py`` with the same inputs and assertions on the port's
runtime, and TPE's proposals against the JAX package's given the same
history (plain, and by budget as BOHB feeds it). The rest of the
counterparts are in ``tests/test_torch_tune.py``.
"""

import numpy as np
import pytest

import ray_tpu.tune as jtune
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.core.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 8})
    c.connect()
    yield c
    c.shutdown()


def test_trial_reschedules_with_checkpoint_after_node_kill(tmp_path):
    """Mid-trial node loss: the trial's actor dies with the node; with
    max_failures the controller reschedules it on a surviving node FROM
    ITS LATEST CHECKPOINT. It runs before the module's cluster starts:
    each half on a cluster of its own."""
    import os
    import threading

    assert not ray_tpu_torch.is_initialized()
    c = Cluster(num_nodes=1, resources={"CPU": 2})
    c.connect()
    try:
        n2 = c.add_node(resources={"CPU": 2, "victim": 1})
        progress = str(tmp_path / "progress")

        def trainable(config):
            import time as _time
            start = tune.get_checkpoint() or 0
            for i in range(start, 8):
                with open(config["progress"], "a") as f:
                    f.write(f"{i}\n")
                tune.report({"loss": float(8 - i)}, checkpoint=i + 1)
                _time.sleep(0.4)

        def killer():
            import time as _time
            deadline = _time.monotonic() + 30
            while _time.monotonic() < deadline:
                if os.path.exists(progress) and \
                        len(open(progress).readlines()) >= 3:
                    c.kill_node(n2)
                    return
                _time.sleep(0.1)

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        grid = tune.Tuner(
            trainable, param_space={"progress": progress},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", num_samples=1,
                max_failures=2,
                resources_per_trial={"victim": 1})).fit()
        kt.join(timeout=30)
        assert grid.num_errors() == 1  # no surviving node has "victim"
    finally:
        c.shutdown()

    c = Cluster(num_nodes=1, resources={"CPU": 2})
    c.connect()
    try:
        n2 = c.add_node(resources={"CPU": 2})
        progress2 = str(tmp_path / "progress2")
        pidfile = str(tmp_path / "pids")

        def trainable2(config):
            import os as _os
            import time as _time
            with open(config["pidfile"], "a") as f:
                f.write(f"{_os.getpid()}\n")
            start = tune.get_checkpoint() or 0
            for i in range(start, 8):
                with open(config["progress"], "a") as f:
                    f.write(f"{i}\n")
                tune.report({"loss": float(8 - i)}, checkpoint=i + 1)
                _time.sleep(0.4)

        def killer2():
            import time as _time
            deadline = _time.monotonic() + 60
            while _time.monotonic() < deadline:
                if os.path.exists(progress2) and \
                        len(open(progress2).readlines()) >= 3:
                    c.kill_node(n2)
                    return
                _time.sleep(0.1)

        # If the trial landed on the head, the kill is a no-op and the
        # test still passes (checkpointing is a superset of the happy
        # path).
        kt = threading.Thread(target=killer2, daemon=True)
        kt.start()
        grid = tune.Tuner(
            trainable2, param_space={"progress": progress2,
                                     "pidfile": pidfile},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", num_samples=1,
                max_failures=2)).fit()
        kt.join(timeout=60)
        assert grid.num_errors() == 0
        best = grid.get_best_result()
        assert best.metrics["loss"] == 1.0  # reached i=7
        steps = [int(x) for x in open(progress2).read().split()]
        pids = open(pidfile).read().split()
        if len(pids) > 1:  # the kill actually hit the trial's node
            # The restart resumed FROM THE CHECKPOINT: step 0 runs once,
            # and the second attempt begins at the last checkpointed i.
            assert 0 not in steps[1:], \
                f"restarted from scratch, not checkpoint: {steps}"
            assert len(steps) < 16, steps  # no full re-run
    finally:
        c.shutdown()


def test_tpe_converges_beyond_random(cluster):
    """After the random warmup, TPE's proposals concentrate near the
    optimum — the best result beats the warmup phase's best on a
    deterministic quadratic."""
    def trainable(config):
        loss = (config["x"] - 0.7) ** 2 + (config["y"] - 3.0) ** 2 / 25.0
        tune.report({"loss": loss})

    searcher = tune.TPESearcher(
        {"x": tune.uniform(0.0, 5.0), "y": tune.loguniform(0.1, 100.0)},
        metric="loss", mode="min", n_initial=8, seed=7)
    grid = tune.Tuner(
        trainable,
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    num_samples=32, search_alg=searcher,
                                    max_concurrent_trials=1),
    ).fit()
    assert len(grid) == 32 and grid.num_errors() == 0
    results = grid.results
    warmup_best = min(r.metrics["loss"] for r in results[:8])
    learned_best = min(r.metrics["loss"] for r in results[8:])
    assert learned_best <= warmup_best, (learned_best, warmup_best)
    assert learned_best < 0.5, f"TPE never got close: {learned_best}"
    # The learned phase concentrates: its median beats the warmup median.
    import statistics
    warm = statistics.median(r.metrics["loss"] for r in results[:8])
    late = statistics.median(r.metrics["loss"] for r in results[16:])
    assert late < warm, (late, warm)


def test_bohb_budget_efficiency_and_quality(cluster):
    """BOHB = TPESearcher + BOHBScheduler end to end on a multi-fidelity
    quadratic: brackets cut weak trials early (materially less total
    budget than running every trial to max_t), while the model-based
    proposals still reach TPE-quality optima and beat the random warmup
    phase."""
    def trainable(config):
        import time as _time
        true = (config["x"] - 0.7) ** 2 + (config["y"] - 3.0) ** 2 / 25.0
        for it in range(1, 10):
            _time.sleep(0.12)  # real iteration time: rung cuts can land
            tune.report({"loss": true + 0.5 / it})

    space = {"x": tune.uniform(0.0, 5.0), "y": tune.loguniform(0.1, 100.0)}
    n_initial, num_samples, max_t = 8, 18, 9
    search = tune.TPESearcher(space, metric="loss", mode="min",
                              n_initial=n_initial, seed=7)
    sched = tune.BOHBScheduler(max_t=max_t, grace_period=1,
                               reduction_factor=3,
                               metric="loss", mode="min")
    grid = tune.Tuner(
        trainable,
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=num_samples,
            max_concurrent_trials=2, scheduler=sched,
            search_alg=search, seed=7)).fit()
    assert len(grid) == num_samples and grid.num_errors() == 0
    results = grid.results
    # Brackets actually cut: total budget well under full-fidelity.
    total_iters = sum(r.iterations for r in results)
    assert total_iters < 0.8 * num_samples * max_t, total_iters
    assert any(r.status == "STOPPED" and r.iterations < max_t
               for r in results)
    # Quality: the model phase reaches the optimum region and beats the
    # random warmup's best (same bars as the plain-TPE test).
    best = grid.get_best_result().metrics["loss"]
    warmup_best = min(r.metrics["loss"] for r in results[:n_initial]
                      if "loss" in r.metrics)
    assert best < 0.5, best
    assert best <= warmup_best, (best, warmup_best)


# ----------------------------------------------------------------------
# TPE against the JAX package, without a cluster
# ----------------------------------------------------------------------

def _tpe(pkg, mode):
    space = {"x": pkg.uniform(0.0, 5.0), "y": pkg.loguniform(0.1, 100.0),
             "n": pkg.randint(1, 9), "act": pkg.choice(["relu", "tanh", 3]),
             "fixed": 17}
    return pkg.TPESearcher(space, metric="loss", mode=mode, n_initial=6,
                           seed=13)


def _objective(cfg):
    return ((cfg["x"] - 0.7) ** 2 + np.log(cfg["y"] / 3.0) ** 2
            + 0.1 * cfg["n"] + (0.5 if cfg["act"] == "relu" else 0.0))


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("budgets", [False, True], ids=["tpe", "bohb"])
def test_tpe_suggestions_match_jax_package(mode, budgets):
    """Both searchers see the same history: each suggestion of the JAX
    package's is fed to both with its score (with the iteration budget
    BOHB's tuner passes when ``budgets``; one trial in five errors), and
    both must propose the same configs throughout."""
    t, j = _tpe(tune, mode), _tpe(jtune, mode)
    rng = np.random.RandomState(4)
    for i in range(40):
        tid = f"trial_{i:05d}"
        got, want = t.suggest(tid), j.suggest(tid)
        assert got == want, (i, got, want)
        loss = float(_objective(want))
        result = {"loss": -loss if mode == "max" else loss}
        kw = {"budget": int(rng.choice([1, 3, 9]))} if budgets else {}
        error = i % 5 == 4
        t.on_trial_complete(tid, result, error=error, **kw)
        j.on_trial_complete(tid, result, error=error, **kw)
    assert len(t._obs) == len(j._obs) == 32
