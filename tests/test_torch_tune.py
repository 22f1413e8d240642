"""The port's Tune (``ray_tpu_torch.tune``): the cases of
``tests/test_tune.py`` with the same inputs and assertions on the port's
runtime (search-space expansion, concurrent trials, ASHA early stopping,
best-result selection, failure isolation, PBT, the searcher seam,
``Tuner.restore``, BOHB's brackets), and, without a cluster, the variant
generator and the ASHA, PBT and BOHB schedulers against the JAX package's
on the same inputs. TPE, BOHB end to end and the node-kill case are in
``tests/test_torch_tune_search.py``.
"""

import time

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


def test_variant_generation():
    from ray_tpu_torch.tune.search import generate_variants
    space = {"a": tune.grid_search([1, 2, 3]), "b": tune.uniform(0, 1),
             "c": "fixed"}
    variants = list(generate_variants(space, num_samples=2, seed=0))
    assert len(variants) == 6  # 3-grid x 2 samples
    assert {v["a"] for v in variants} == {1, 2, 3}
    assert all(0 <= v["b"] <= 1 and v["c"] == "fixed" for v in variants)


# ----------------------------------------------------------------------
# chip_smoke.py's phase 16 on the CPU, small
# ----------------------------------------------------------------------

def test_chip_smoke_tune_phase_on_the_cpu():
    """chip_smoke.py's phase 16 (a) and (b) at a small size on the CPU, on
    a node that advertises one GPU: the Tune trials over a 2-layer model,
    each asking for the GPU (``num_gpus``), two allowed at once: none
    errs, they take the GPU in turn, each pinned to it, ASHA stops one
    early at least, the first trial's losses equal this process's run of
    the same steps, and no kernel launches on the CPU; then
    ``PPO.as_trainable``. (Its part (c) is in
    ``tests/test_torch_state_cli.py``.) It runs before the module's
    cluster starts."""
    import cloudpickle
    import torch

    import chip_smoke

    assert not ray_tpu_torch.is_initialized()
    model = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=128, max_seq=64, dtype=torch.float32)
    # 24 steps (rungs 1, 2, 4, 8 and 16): a step takes milliseconds here,
    # and ASHA's stop, sent on the tuner's next poll, must land before
    # the trial's last step
    steps = 24
    ref = chip_smoke._in_process_losses(model, 2, 32, steps, 3e-4, "cpu")
    c = Cluster(num_nodes=1, resources={"CPU": 8, "GPU": 1})
    c.connect()
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        trials = chip_smoke._tune_trials("cpu", "cpu", model, 2, 32, steps,
                                         chip_smoke.TUNE_LRS, ref)
        ppo = chip_smoke._tune_ppo("cpu", "cpu", fragment=128)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
        c.shutdown()
    assert trials["losses_bitwise"] and trials["launches"] == {}
    assert len(trials["trials"]) == len(chip_smoke.TUNE_LRS)
    assert len(ppo["trials"]) == 2


def test_quadratic_search_finds_minimum(cluster):
    def objective(config):
        tune.report({"loss": (config["x"] - 3.0) ** 2})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search(
            [0.0, 1.0, 2.0, 3.0, 4.0, 5.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=3),
    ).fit()
    best = grid.get_best_result()
    assert best.config["x"] == 3.0
    assert best.metrics["loss"] == 0.0
    assert len(grid) == 6
    assert all(r.status == "TERMINATED" for r in grid)


def test_asha_stops_bad_trials_early(cluster):
    """Bad trials must burn fewer iterations than good ones."""
    def objective(config):
        for step in range(30):
            time.sleep(0.05)  # real iterations take time; polls interleave
            tune.report({"score": config["quality"] - 0.001 * step})

    # Good trials first: ASHA rungs are optimistic until enough peers
    # recorded (same asynchrony as the reference ASHA).
    grid = tune.Tuner(
        objective,
        param_space={"quality": tune.grid_search(
            [1.0, 0.95, 0.9, 0.3, 0.2, 0.1])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(max_t=30, grace_period=3,
                                         reduction_factor=3,
                                         mode="max")),
    ).fit()
    best = grid.get_best_result(metric="score", mode="max")
    assert best.config["quality"] == 1.0
    iters = {r.config["quality"]: r.iterations for r in grid}
    stopped = [r for r in grid if r.status == "STOPPED"]
    assert stopped, f"ASHA never stopped a trial: {iters}"
    assert max(iters[q] for q in (0.1, 0.2)) < 30, \
        f"bad trials ran to completion: {iters}"
    assert iters[1.0] == 30  # the best trial ran its full budget


def test_trial_failure_isolated(cluster):
    def objective(config):
        if config["boom"]:
            raise RuntimeError("bad trial")
        tune.report({"loss": 1.0})

    grid = tune.Tuner(
        objective,
        param_space={"boom": tune.grid_search([False, True, False])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
    ).fit()
    assert grid.num_errors() == 1
    ok = [r for r in grid if r.status == "TERMINATED"]
    assert len(ok) == 2
    assert grid.get_best_result().metrics["loss"] == 1.0


def test_pbt_exploits_and_perturbs(cluster):
    """PBT: a bottom-quantile trial restarts from a top trial's
    checkpoint with perturbed hyperparams. Trainable: score grows by lr
    each iter — exploiting copies the best score so everyone converges
    toward the top lr's trajectory."""
    def trainable(config):
        state = tune.get_checkpoint() or {"score": 0.0}
        score = state["score"]
        for _ in range(20):
            score += config["lr"]
            tune.report({"score": score}, checkpoint={"score": score})

    pbt = tune.PBTScheduler(
        hyperparam_mutations={"lr": tune.uniform(0.1, 2.0)},
        perturbation_interval=4, quantile_fraction=0.34,
        metric="score", mode="max", seed=7)
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.choice([0.01, 0.02, 2.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=3,
            max_concurrent_trials=3, scheduler=pbt, seed=5),
    ).fit()
    assert grid.num_errors() == 0
    best = grid.get_best_result()
    assert best.metrics["score"] > 20 * 0.5  # far above the 0.01-lr path
    # At least one laggard was exploited: its final score outruns what
    # its ORIGINAL lr could ever reach alone (20 * 0.02 = 0.4).
    others = sorted(r.metrics["score"] for r in grid)[:-1]
    assert any(s > 1.0 for s in others), others


def test_searcher_seam(cluster):
    """A custom Searcher drives trial configs via suggest() and hears
    completions."""
    class FixedSearcher(tune.Searcher):
        def __init__(self):
            self.completed = []

        def suggest(self, trial_id):
            return {"x": int(trial_id[-1])}

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed.append((trial_id, error))

    def trainable(config):
        tune.report({"loss": (config["x"] - 2) ** 2})

    searcher = FixedSearcher()
    grid = tune.Tuner(
        trainable, tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=4,
            search_alg=searcher),
    ).fit()
    assert len(grid) == 4
    assert grid.get_best_result().config == {"x": 2}
    assert len(searcher.completed) == 4


def test_tuner_restore_resumes_interrupted_run(cluster, tmp_path):
    """Tuner.restore: an interrupted experiment resumes — completed
    trials keep their results (not re-executed), failed/unfinished ones
    re-run."""
    import os

    marker_dir = str(tmp_path / "runs")
    os.makedirs(marker_dir)
    flag = str(tmp_path / "phase2")

    def trainable(config):
        import os as _os
        i = config["i"]
        # Count executions per variant across both phases.
        with open(_os.path.join(config["marker_dir"], f"run-{i}"),
                  "a") as f:
            f.write("x")
        if i >= 3 and not _os.path.exists(config["flag"]):
            raise RuntimeError("simulated interruption")  # phase 1 only
        tune.report({"loss": float(i)})

    space = {"i": tune.grid_search([0, 1, 2, 3, 4, 5]),
             "marker_dir": marker_dir, "flag": flag}
    storage = str(tmp_path / "exp")
    t1 = tune.Tuner(trainable, param_space=space,
                    tune_config=tune.TuneConfig(metric="loss", mode="min",
                                                num_samples=1, seed=3),
                    storage_path=storage, name="resume_me")
    g1 = t1.fit()
    assert g1.num_errors() == 3  # trials 3..5 "interrupted"

    # Phase 2: restore and re-run only the failed trials.
    open(flag, "w").close()
    t2 = tune.Tuner.restore(os.path.join(storage, "resume_me"),
                            trainable, restart_errored=True)
    g2 = t2.fit()
    assert len(g2) == 6 and g2.num_errors() == 0
    losses = sorted(r.metrics["loss"] for r in g2.results)
    assert losses == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    # Completed trials were NOT re-executed; failed ones ran twice.
    for i in range(6):
        runs = len(open(os.path.join(marker_dir, f"run-{i}")).read())
        assert runs == (2 if i >= 3 else 1), (i, runs)


def test_bohb_brackets_and_assignment():
    """BOHB unit mechanics: bracket rung ladders follow HyperBand's
    budget schedule; trials spread over brackets; weak trials at a rung
    are cut once rf peers record."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP

    s = tune.BOHBScheduler(max_t=27, grace_period=1, reduction_factor=3,
                           metric="loss", mode="min")
    # Brackets (aggressive -> conservative): rungs [1,3,9], [3,9], [9].
    assert s._brackets == [[1, 3, 9], [3, 9], [9]]
    for i in range(9):
        s.track(f"t{i}", {})
    assert len({s._bracket_of[f"t{i}"] for i in range(9)}) == 3
    # Pin three trials into bracket 0 and race them at rung 1.
    a, b, c = [t for t in s._bracket_of if s._bracket_of[t] == 0][:3]
    assert s.on_result(a, 1, 0.1) == CONTINUE  # too few peers yet
    assert s.on_result(b, 1, 0.5) == CONTINUE
    assert s.on_result(c, 1, 0.9) == STOP      # bottom of 3 at rf=3
    assert s.on_result(a, 27, 0.1) == STOP     # max_t budget exhausted


# ----------------------------------------------------------------------
# The port against the JAX package, without a cluster
# ----------------------------------------------------------------------

def _space(pkg):
    return {"a": pkg.grid_search([1, 2, 3]), "u": pkg.uniform(-2.0, 5.0),
            "lu": pkg.loguniform(1e-5, 1e-1), "r": pkg.randint(0, 17),
            "c": pkg.choice(["x", "y", 7, None]), "k": "fixed"}


@pytest.mark.parametrize("num_samples,seed", [(1, 0), (4, 7), (3, None)])
def test_generate_variants_match_jax_package(num_samples, seed):
    """Same space and seed: the same configs in the same order (a seed of
    None draws from the OS, so then only the grid and constants agree)."""
    from ray_tpu.tune.search import generate_variants as jgen
    from ray_tpu_torch.tune.search import generate_variants as tgen

    got = list(tgen(_space(tune), num_samples, seed))
    want = list(jgen(_space(jtune), num_samples, seed))
    assert len(got) == len(want) == 3 * num_samples
    if seed is None:
        assert [(v["a"], v["k"]) for v in got] == \
            [(v["a"], v["k"]) for v in want]
    else:
        assert got == want


def _drive(sched, events):
    """Feed (trial, iteration, value) events; return the decisions."""
    return [sched.on_result(t, it, v) for t, it, v in events]


def _sequences(n_trials, n_iters, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    vals = rng.rand(n_trials, n_iters).cumsum(axis=1)
    order = [(f"t{i}", it + 1, float(vals[i, it]))
             for it in range(n_iters) for i in rng.permutation(n_trials)]
    return order


@pytest.mark.parametrize("mode", ["min", "max"])
def test_asha_decisions_match_jax_package(mode):
    kw = dict(max_t=20, grace_period=1, reduction_factor=2, mode=mode)
    events = _sequences(7, 22, seed=3)
    got = _drive(tune.ASHAScheduler(**kw), events)
    want = _drive(jtune.ASHAScheduler(**kw), events)
    assert got == want
    assert "STOP" in got and "CONTINUE" in got


def test_pbt_decisions_match_jax_package():
    """The same reported sequences and seed give the same exploit
    decisions, sources and mutated configs."""
    def run(pkg):
        s = pkg.PBTScheduler(
            hyperparam_mutations={"lr": pkg.uniform(0.1, 2.0),
                                  "bs": [16, 32, 64], "depth": 3},
            perturbation_interval=3, quantile_fraction=0.34,
            metric="score", mode="max", seed=11)
        for i in range(6):
            s.track(f"t{i}", {"lr": 0.1 * (i + 1), "bs": 32,
                              "depth": i + 1})
        out = []
        for t, it, v in _sequences(6, 15, seed=5):
            d = s.on_result(t, it, v)
            out.append(d)
            if isinstance(d, tuple):
                s.on_trial_restore(t)
        return out

    got, want = run(tune), run(jtune)
    assert got == want
    assert any(isinstance(d, tuple) for d in got)


def test_bohb_decisions_match_jax_package():
    """Bracket assignment and rung decisions on the same sequences."""
    kw = dict(max_t=27, grace_period=1, reduction_factor=3, mode="min")
    t, j = tune.BOHBScheduler(**kw), jtune.BOHBScheduler(**kw)
    for i in range(12):
        t.track(f"t{i}", {})
        j.track(f"t{i}", {})
    assert t._brackets == j._brackets and t._bracket_of == j._bracket_of
    events = _sequences(12, 28, seed=9)
    got, want = _drive(t, events), _drive(j, events)
    assert got == want
    assert "STOP" in got


def test_resources_per_trial_maps_gpu_to_num_gpus(monkeypatch):
    """``"GPU"`` becomes ``num_gpus`` and ``"CPU"`` ``num_cpus``; any other
    key stays a custom resource (the reference maps ``"TPU"`` to
    ``num_tpus``)."""
    from ray_tpu_torch.tune import tuner as tuner_mod

    seen = {}

    class _Stop(Exception):
        pass

    class _Cls:
        def options(self, **opts):
            seen.update(opts)
            raise _Stop

    monkeypatch.setattr(tuner_mod.ray_tpu_torch, "remote",
                        lambda cls: _Cls())
    with pytest.raises(_Stop):
        tune.Tuner(lambda c: None, tune_config=tune.TuneConfig(
            resources_per_trial={"CPU": 2, "GPU": 1, "disk": 3})).fit()
    assert seen == {"num_cpus": 2, "num_gpus": 1,
                    "resources": {"disk": 3}}


def test_tune_imports_no_torch_jax_or_ray_tpu():
    import subprocess
    import sys
    code = ("import sys\n"
            "import ray_tpu_torch.tune, ray_tpu_torch.util\n"
            "import ray_tpu_torch.cli, ray_tpu_torch.dashboard\n"
            "import ray_tpu_torch.job_submission\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'ray_tpu')]\n"
            "assert not bad, bad\n")
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert ray_tpu_torch.tune is tune
