"""The port's RLlib (``ray_tpu_torch.rllib``): each learner against the
JAX package's on shared weights and batches, and the cases of
``tests/test_rllib.py`` with the same assertions and seeds, on the CPU.

Parity: the JAX learner is built (seed 0), its parameters are carried
across (``learner_from_jax``), and both take 3 updates on the same numpy
batches from a ``RandomState`` seed, in f32 on the CPU. Losses and metrics
agree within rel 1e-5 and every parameter leaf within rel L2
``PARAM_REL_L2`` after each update; SAC gets the JAX learner's own noise,
drawn here from its key sequence and passed through ``noise=``.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import learner as jl
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.rllib import CartPole, PPOConfig, PPOLearner
from ray_tpu_torch.rllib import learner as tl

METRIC_RTOL = 1e-5
# SAC's metrics, loosened from 1e-5: its entropy is the mean of log-probs
# whose terms (log std, eps^2 / 2, log 2pi / 2, the tanh correction) are
# several times larger than the mean and cancel, and XLA's f32 tanh, exp
# and log differ from torch's by a few ulps (tanh up to 4 on the CPU).
SAC_METRIC_RTOL = 1e-4
# Every leaf within this relative L2 of the JAX learner's: the learners'
# Adam is optax's arithmetic in f32 (``tl.Adam``, held against optax.adam
# below), so the leaves differ by the losses' and gradients' rounding.
PARAM_REL_L2 = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: 64 x 64 MLPs gain nothing from
    more, and beside the suite's other workers the threads only contend
    (the SAC learning case takes 38 s on one thread against 53 s on
    eight, at eight times the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    """(path, array) in a fixed order (jax sorts dict keys when it maps a
    tree, so order by key)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree, np.float64)


def _assert_tree_close(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        err = np.linalg.norm(got[k] - want[k]) / max(
            np.linalg.norm(want[k]), 1e-30)
        assert err <= PARAM_REL_L2, f"{what}{k}: rel L2 {err:.3g}"


def _assert_metrics_close(got, want, what, rtol=METRIC_RTOL):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
        assert err <= rtol, (f"{what} {k}: {got[k]!r} vs "
                                    f"{want[k]!r} (rel {err:.3g})")


def _pair(jax_cls, torch_cls, *args, **kw):
    j = jax_cls(*args, seed=0, **kw)
    t = tl.learner_from_jax(j, torch_cls(*args, seed=0, device=CPU, **kw))
    _assert_tree_close(t.params_numpy(), j.params, "init")
    return j, t


# ----------------------------------------------------------------------
# Parity with the JAX package's learners
# ----------------------------------------------------------------------

def test_ppo_learner_matches_jax():
    rng = np.random.RandomState(1)
    j, t = _pair(jl.PPOLearner, tl.PPOLearner, 4, 2, lr=1e-3)
    n = 64
    for step in range(3):
        batch = {
            "obs": rng.randn(n, 4).astype(np.float32),
            "actions": rng.randint(0, 2, n).astype(np.int32),
            "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
            "advantages": rng.randn(n).astype(np.float32) * 3 + 1,
            "returns": rng.randn(n).astype(np.float32),
        }
        want = j.update_minibatches(batch, num_epochs=2, minibatch_size=32)
        got = t.update_minibatches(batch, num_epochs=2, minibatch_size=32)
        _assert_metrics_close(got, want, f"ppo step {step}")
        _assert_tree_close(t.params_numpy(), j.params, f"ppo step {step}")
        _assert_tree_close(t.get_weights(), j.get_weights(),
                           f"ppo weights {step}")


def _fragment_batch(rng, B, T, D):
    """A [B, T] batch with terminations and truncations inside the
    fragments (never both at one step), each truncation with its final
    pre-reset obs."""
    terms = (rng.rand(B, T) < 0.1).astype(np.float32)
    truncs = ((rng.rand(B, T) < 0.1) & (terms == 0)).astype(np.float32)
    trunc_obs = np.where(truncs[..., None] > 0,
                         rng.randn(B, T, D), 0.0).astype(np.float32)
    return {
        "obs": rng.randn(B, T, D).astype(np.float32),
        "actions": rng.randint(0, 2, (B, T)).astype(np.int32),
        "rewards": rng.randn(B, T).astype(np.float32),
        "terms": terms, "truncs": truncs, "trunc_obs": trunc_obs,
        "behavior_logp": np.log(rng.uniform(0.2, 0.8, (B, T))).astype(
            np.float32),
        "bootstrap_obs": rng.randn(B, D).astype(np.float32),
    }


def test_impala_learner_matches_jax():
    rng = np.random.RandomState(2)
    j, t = _pair(jl.IMPALALearner, tl.IMPALALearner, 4, 2, lr=1e-3)
    for step in range(3):
        batch = _fragment_batch(rng, 4, 16, 4)
        assert batch["terms"].any() and batch["truncs"].any()
        want = j.update(batch)
        got = t.update(batch)
        _assert_metrics_close(got, want, f"impala step {step}")
        _assert_tree_close(t.params_numpy(), j.params,
                           f"impala step {step}")


@pytest.mark.parametrize("weighted", [True, False])
def test_dqn_learner_matches_jax(weighted):
    rng = np.random.RandomState(3)
    j, t = _pair(jl.DQNLearner, tl.DQNLearner, 4, 3)
    n = 32
    for step in range(3):
        batch = {
            "obs": rng.randn(n, 4).astype(np.float32),
            "actions": rng.randint(0, 3, n).astype(np.int32),
            "rewards": (rng.randn(n) * 2).astype(np.float32),
            "next_obs": rng.randn(n, 4).astype(np.float32),
            "dones": (rng.rand(n) < 0.2).astype(np.float32),
            "indices": np.arange(n),
        }
        if weighted:
            batch["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
        want, want_td = j.update(batch)
        got, got_td = t.update(batch)
        _assert_metrics_close(got, want, f"dqn step {step}")
        assert got_td.shape == want_td.shape == (n,)
        # |TD| is a difference of two terms of the batch's scale: a
        # near-zero one carries their f32 rounding, so its error is
        # bounded relative to the largest |TD|, not to itself.
        np.testing.assert_allclose(got_td, want_td, rtol=METRIC_RTOL,
                                   atol=METRIC_RTOL * want_td.max())
        _assert_tree_close(t.params_numpy(), j.params, f"dqn step {step}")
        _assert_tree_close(t.target_params_numpy(), j.target_params,
                           f"dqn target {step}")
        if step == 1:
            j.sync_target()
            t.sync_target()
            _assert_tree_close(t.target_params_numpy(), t.params_numpy(),
                               "dqn synced target")


def _jax_sac_noise(learner, n, action_size):
    """The noise the JAX learner's next update draws: its key splits into
    the update's key, which splits into the critic's and the actor's."""
    _, sub = jax.random.split(learner._key)
    ka, kb = jax.random.split(sub)
    return (np.asarray(jax.random.normal(ka, (n, action_size))),
            np.asarray(jax.random.normal(kb, (n, action_size))))


def test_sac_learner_matches_jax():
    """SAC under the JAX learner's own noise. The observations are scaled
    by 0.2 so that the squashed actions stay out of tanh's saturation:
    there, log(1 - tanh(x)^2 + 1e-6) turns XLA's f32 tanh (up to 4 ulps
    from torch's on the CPU) into log-prob differences of up to 0.39 at
    |x| = 8, which no tolerance of the two frameworks' arithmetic covers."""
    rng = np.random.RandomState(4)
    j, t = _pair(jl.SACLearner, tl.SACLearner, 3, 1, action_scale=2.0,
                 lr=1e-3)
    _assert_tree_close(t.target_params_numpy(), j.target_params,
                       "sac target init")
    n = 64
    for step in range(3):
        batch = {
            "obs": (rng.randn(n, 3) * 0.2).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rng.randn(n).astype(np.float32),
            "next_obs": (rng.randn(n, 3) * 0.2).astype(np.float32),
            "dones": (rng.rand(n) < 0.2).astype(np.float32),
        }
        noise = _jax_sac_noise(j, n, 1)
        want = j.update(batch)
        got = t.update(batch, noise=noise)
        _assert_metrics_close(got, want, f"sac step {step}",
                              rtol=SAC_METRIC_RTOL)
        _assert_tree_close(t.params_numpy(), j.params, f"sac step {step}")
        _assert_tree_close(t.target_params_numpy(), j.target_params,
                           f"sac target {step}")
    w = t.get_weights()
    assert w["action_scale"].shape == () and w["action_scale"] == 2.0
    assert w["action_shift"].shape == () and w["action_shift"] == 0.0


def test_learner_weights_keep_the_jax_layout():
    """get_weights(): per layer {"w": [in, out], "b": [out]} numpy f32, as
    the env runners consume them."""
    t = tl.PPOLearner(4, 2, hidden=(8,), seed=0, device=CPU)
    w = t.get_weights()
    assert sorted(w) == ["pi", "vf"]
    assert [(x["w"].shape, x["b"].shape) for x in w["pi"]] == [
        ((4, 8), (8,)), ((8, 2), (2,))]
    assert all(x["w"].dtype == np.float32 and x["b"].dtype == np.float32
               for x in w["pi"] + w["vf"])
    assert all(not x["b"].any() for x in w["pi"])  # zero biases
    # normal x sqrt(2 / fan_in) from the seeded generator
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        w["pi"][0]["w"], (torch.randn(4, 8, generator=gen)
                          * np.sqrt(2.0 / 4)).numpy())


def test_learner_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.PPOLearner(4, 2)


ADAM_REL_L2 = 1e-6


def test_adam_matches_optax_adam():
    """The learners' Adam against ``optax.adam`` on the same leaves and
    gradients for 10 steps: every leaf within rel L2 ``ADAM_REL_L2`` after
    every step. Gradients span four decades, and one leaf starts at zero
    (as the biases do), so that its value is the steps alone."""
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(0)
    shapes = [(4, 64), (64,), (64, 64), (64,), (64, 2), (2,), ()]
    init = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    init[1][:] = 0
    leaves = [torch.nn.Parameter(torch.tensor(x)) for x in init]
    opt = tl.Adam(leaves, lr=3e-4)
    tx = optax.adam(3e-4)
    params = [jnp.asarray(x) for x in init]
    state = tx.init(params)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for step in range(10):
        grads = [np.asarray(rng.randn(*s) * 10.0 ** rng.uniform(-3, 1),
                            np.float32) for s in shapes]
        opt.zero_grad()
        for leaf, g in zip(leaves, grads):
            leaf.grad = torch.tensor(g)
        opt.step()
        params, state = update([jnp.asarray(g) for g in grads], state,
                               params)
        for i, (got, want) in enumerate(zip(leaves, params)):
            got = got.detach().numpy().astype(np.float64)
            want = np.asarray(want, np.float64)
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= ADAM_REL_L2, f"step {step} leaf {i}: {err:.3g}"


@pytest.mark.parametrize("name", ["PPO", "IMPALA", "DQN", "SAC"])
def test_as_trainable_gives_a_picklable_trainable(name):
    """Each algorithm's ``as_trainable`` returns the trainable that
    ``Tuner`` cloudpickles into its trial actors (it reads only the
    algorithm's config, so no algorithm is built here)."""
    import cloudpickle

    rl = ray_tpu_torch.rllib
    cfg = getattr(rl, f"{name}Config")().training(device=CPU)
    algo = object.__new__(getattr(rl, name))
    algo.config = cfg
    trainable = cloudpickle.loads(cloudpickle.dumps(algo.as_trainable(2)))
    assert callable(trainable)


def test_ppo_as_trainable_under_tuner(cluster):
    """``PPO.as_trainable`` under ``Tuner``: 2 trials over ``lr``, 2
    iterations each, the learners on the CPU; both finish and report a
    finite return each iteration."""
    from ray_tpu_torch import tune

    algo = (PPOConfig()
            .environment(CartPole)
            .env_runners(1, rollout_fragment_length=128)
            .training(num_epochs=1, minibatch_size=64, seed=1, device=CPU)
            .build())
    try:
        trainable = algo.as_trainable(2)
    finally:
        algo.stop()
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([1e-3, 3e-4])},
        tune_config=tune.TuneConfig(metric="episode_return_mean",
                                    mode="max", max_concurrent_trials=2),
    ).fit()
    assert len(grid) == 2 and grid.num_errors() == 0, \
        [r.error for r in grid]
    for r in grid:
        assert r.status == "TERMINATED" and r.iterations == 2
        assert len(r.metrics_history) == 2
        assert all(np.isfinite(m["episode_return_mean"])
                   and m["env_steps_this_iter"] == 128
                   for m in r.metrics_history), r.metrics_history
    assert sorted(r.config["lr"] for r in grid) == [3e-4, 1e-3]


def test_env_runners_import_no_torch():
    """The env runners are CPU actors: their modules load no torch."""
    code = ("import sys\n"
            "import ray_tpu_torch.rllib.env_runner\n"
            "import ray_tpu_torch.rllib.multi_agent\n"
            "import ray_tpu_torch.rllib.replay\n"
            "from ray_tpu_torch.rllib import CartPole\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ----------------------------------------------------------------------
# The cases of tests/test_rllib.py
# ----------------------------------------------------------------------

def test_cartpole_dynamics():
    env = CartPole()
    obs = env.reset(seed=0)
    assert obs.shape == (4,)
    total = 0.0
    term = trunc = False
    while not (term or trunc):
        obs, rew, term, trunc, _ = env.step(0)  # constant push fails fast
        total += rew
    assert 1 <= total < 200  # constant action topples the pole quickly


def test_learner_update_shapes():
    learner = PPOLearner(4, 2, hidden=(8,), seed=0, device=CPU)
    n = 64
    rng = np.random.RandomState(0)
    batch = {
        "obs": rng.rand(n, 4).astype(np.float32),
        "actions": rng.randint(0, 2, n).astype(np.int32),
        "logp_old": np.full(n, -0.69, np.float32),
        "advantages": rng.randn(n).astype(np.float32),
        "returns": rng.rand(n).astype(np.float32),
    }
    metrics = learner.update_minibatches(batch, num_epochs=2,
                                         minibatch_size=32)
    assert np.isfinite(metrics["total_loss"])
    w = learner.get_weights()
    assert w["pi"][0]["w"].shape == (4, 8)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 8})
    c.connect()
    yield c
    c.shutdown()


def test_ppo_learns_cartpole(cluster):
    algo = (PPOConfig()
            .environment(CartPole)
            .env_runners(2, rollout_fragment_length=512)
            .training(lr=1e-3, num_epochs=6, minibatch_size=128, seed=1,
                      device=CPU)
            .build())
    try:
        first = algo.train()
        assert first["env_steps_this_iter"] == 1024  # 2 runners x 512
        baseline = first["episode_return_mean"]
        best = baseline
        for _ in range(14):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
            if best > max(3 * baseline, 80):
                break
        assert best > max(2 * baseline, 60), \
            f"PPO failed to learn: baseline={baseline:.1f} best={best:.1f}"
    finally:
        algo.stop()


def test_replay_buffers():
    from ray_tpu_torch.rllib import PrioritizedReplayBuffer, ReplayBuffer
    rb = ReplayBuffer(capacity=100, seed=0)
    for i in range(5):
        rb.add({"obs": np.full((30, 2), i, np.float32),
                "rew": np.full(30, i, np.float32)})
    assert len(rb) == 100  # ring wrapped (150 added)
    s = rb.sample(64)
    assert s["obs"].shape == (64, 2)
    # 150 rows through a 100 ring: rows of value 0 are fully overwritten
    # (10 rows of value 1 survive, all of 2..4) — min can be 1, never 0.
    assert s["rew"].min() >= 1.0

    prb = PrioritizedReplayBuffer(capacity=64, seed=0)
    prb.add({"x": np.arange(32, dtype=np.float32)})
    s = prb.sample(16)
    assert "weights" in s and "indices" in s
    # Cranking one index's priority makes it dominate sampling.
    prb.update_priorities(np.array([5]), np.array([1e6]))
    s = prb.sample(256)
    assert (s["indices"] == 5).mean() > 0.5


def test_impala_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import IMPALAConfig
    algo = (IMPALAConfig()
            .environment(CartPole)
            .env_runners(2, rollout_fragment_length=64)
            .training(lr=1e-3, train_batch_fragments=4,
                      updates_per_iteration=8, entropy_coeff=0.01,
                      seed=1, device=CPU)
            .build())
    try:
        first = algo.train()
        assert first["env_steps_this_iter"] == 8 * 4 * 64
        baseline = max(first["episode_return_mean"], 15.0)
        best = baseline
        for _ in range(14):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
            if best > max(3 * baseline, 80):
                break
        assert best > max(2 * baseline, 60), \
            f"IMPALA failed to learn: baseline={baseline:.1f} " \
            f"best={best:.1f}"
    finally:
        algo.stop()


def test_dqn_learns_cartpole(cluster):
    """DQN + prioritized replay solves CartPole beyond its random-policy
    baseline (reference: rllib/algorithms/dqn/ learning smoke tests)."""
    from ray_tpu_torch.rllib import DQNConfig
    algo = (DQNConfig()
            .environment(CartPole)
            .env_runners(2, rollout_fragment_length=64)
            .training(lr=1e-3, train_batch_size=64,
                      updates_per_iteration=64,
                      fragments_per_iteration=4,
                      learning_starts=500, target_update_freq=50,
                      epsilon_anneal_steps=3000, seed=1, device=CPU)
            .build())
    try:
        first = algo.train()
        assert first["env_steps_this_iter"] == 4 * 64
        assert first["buffer_size"] == 256
        baseline = max(first["episode_return_mean"], 15.0)
        best = baseline
        for _ in range(24):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
            if best > max(3 * baseline, 80):
                break
        assert best > max(2 * baseline, 60), \
            f"DQN failed to learn: baseline={baseline:.1f} best={best:.1f}"
        # Epsilon annealed away from its initial value.
        assert m["epsilon"] < 0.5
    finally:
        algo.stop()


def test_dqn_learner_priorities_roundtrip():
    """DQNLearner returns per-sample |TD| aligned with the batch, and a
    target sync zeroes the TD against the online net's own targets."""
    from ray_tpu_torch.rllib import DQNLearner
    rng = np.random.RandomState(0)
    learner = DQNLearner(4, 2, lr=1e-3, seed=0, device=CPU)
    batch = {
        "obs": rng.randn(32, 4).astype(np.float32),
        "actions": rng.randint(0, 2, 32).astype(np.int32),
        "rewards": rng.randn(32).astype(np.float32),
        "next_obs": rng.randn(32, 4).astype(np.float32),
        "dones": (rng.rand(32) < 0.1).astype(np.float32),
        "weights": np.ones(32, np.float32),
    }
    metrics, td = learner.update(batch)
    assert td.shape == (32,)
    assert np.all(td >= 0)
    assert "loss" in metrics and np.isfinite(metrics["loss"])
    learner.sync_target()


def test_pendulum_dynamics():
    from ray_tpu_torch.rllib.env import Pendulum

    env = Pendulum()
    obs = env.reset(seed=0)
    assert obs.shape == (3,)
    np.testing.assert_allclose(np.hypot(obs[0], obs[1]), 1.0, atol=1e-5)
    total, trunc = 0.0, False
    steps = 0
    while not trunc:
        obs, rew, term, trunc, _ = env.step(np.array([0.0]))
        assert rew <= 0.0 and not term
        total += rew
        steps += 1
    assert steps == Pendulum.MAX_STEPS


def test_sac_learner_update_shapes():
    from ray_tpu_torch.rllib import SACLearner

    learner = SACLearner(3, 1, action_scale=2.0, hidden=(16,), seed=0,
                         device=CPU)
    rng = np.random.RandomState(0)
    n = 64
    batch = {
        "obs": rng.randn(n, 3).astype(np.float32),
        "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
        "rewards": rng.randn(n).astype(np.float32),
        "next_obs": rng.randn(n, 3).astype(np.float32),
        "dones": rng.randint(0, 2, n).astype(np.float32),
    }
    m = learner.update(batch)
    assert set(m) >= {"critic_loss", "actor_loss", "alpha", "entropy"}
    assert np.isfinite(m["loss"])
    # Weights carry the squashing scale for the runner-side policy.
    w = learner.get_weights()
    assert w["action_scale"] == 2.0 and "pi" in w


def test_sac_learns_pendulum(cluster):
    """SAC solves the Pendulum-class continuous-control task: returns
    improve from random (~-1300) decisively within a bounded budget
    (reference: rllib/algorithms/sac learning tests)."""
    from ray_tpu_torch.rllib import SACConfig
    from ray_tpu_torch.rllib.env import Pendulum

    algo = (SACConfig().environment(Pendulum)
            .env_runners(2, rollout_fragment_length=100)
            .training(updates_per_iteration=200, train_batch_size=128,
                      learning_starts=400, lr=1e-3, seed=0, device=CPU)
            .build())
    try:
        early, final = None, None
        for i in range(40):
            r = algo.train()
            if i == 6:
                early = r["episode_return_mean"]
            final = r["episode_return_mean"]
            if i > 20 and final > -750:
                break  # solved early enough
        assert final > -950, (early, final)
        assert final - early > 250, (early, final)
    finally:
        algo.stop()


def test_multi_agent_env_runner_batches(cluster):
    """Per-policy batch routing: agent->policy mapping groups streams,
    shapes line up, shared-policy mapping concatenates both agents."""
    import cloudpickle

    from ray_tpu_torch.rllib import PPOLearner
    from ray_tpu_torch.rllib.env import CooperativeMatch
    from ray_tpu_torch.rllib.multi_agent import MultiAgentEnvRunner

    runner = MultiAgentEnvRunner(
        cloudpickle.dumps(CooperativeMatch),
        cloudpickle.dumps(lambda a: "shared"), seed=0)
    learner = PPOLearner(8, 4, hidden=(16,), seed=0, device=CPU)
    runner.set_weights({"shared": learner.get_weights()})
    out = runner.sample(32)
    assert set(out) == {"shared", "__episode_returns__"}
    batch = out["shared"]
    # Both agents' 32-step streams concatenate under the shared policy.
    assert batch["obs"].shape == (64, 8)
    assert batch["actions"].shape == (64,)
    assert np.isfinite(batch["advantages"]).all()


def test_multi_agent_ppo_learns_cooperation(cluster):
    """Two independent policies must JOINTLY learn the context-matching
    game (random ~2.5/episode, optimal 16): the cooperative multi-agent
    rollout-and-update path end to end (reference:
    rllib/env/multi_agent_env_runner.py + two-policy training)."""
    from ray_tpu_torch.rllib import MultiAgentPPOConfig
    from ray_tpu_torch.rllib.env import CooperativeMatch

    algo = (MultiAgentPPOConfig().environment(CooperativeMatch)
            .multi_agent(policy_mapping_fn=lambda a: a)
            .env_runners(2, rollout_fragment_length=256)
            .training(lr=5e-3, minibatch_size=128, num_epochs=4, seed=0,
                      device=CPU)
            .build())
    try:
        first = final = None
        for i in range(30):
            r = algo.train()
            if i == 2:
                first = r["episode_return_mean"]
            final = r["episode_return_mean"]
            if i > 10 and final > 11.0:
                break
        assert final > 9.0, (first, final)
        assert sorted(algo.get_weights()) == ["a0", "a1"]
        # Distinct per-policy learners actually trained.
        assert any(k.startswith("a0/") for k in r)
        assert any(k.startswith("a1/") for k in r)
    finally:
        algo.stop()
