"""RL learners — PyTorch policy/value MLPs and their updates (counterpart
of ``ray_tpu/rllib/learner.py``).

Analogue of the reference's learner stack (reference: rllib/core/learner/
learner.py + algorithms/ppo/ppo_torch_learner.py loss; RLModule forward).
Each learner holds ``nn.Module`` MLPs (tanh between layers) on an explicit
device — ``device=None`` is the CUDA card and raises without one; tests
pass ``device="cpu"`` — and one ``Adam`` over every leaf, which is
``optax.adam``'s arithmetic in f32 (betas 0.9/0.999, eps 1e-8; SAC's
leaves include ``log_alpha``). Weights start from an explicit
``torch.Generator`` seeded with ``seed``: normal x sqrt(2/fan_in), zero
biases, drawn on the CPU so that every device starts from the same
numbers.

``get_weights()`` keeps the JAX package's layout and types — per layer
``{"w": [in, out], "b": [out]}`` as numpy f32 (``nn.Linear``'s weight
transposed back) — which the env runners consume as it is.
``params_numpy()`` / ``target_params_numpy()`` give the JAX learner's
``params`` / ``target_params`` layout, and ``learner_from_jax`` loads a
JAX learner's parameters into a learner of this module, so both can start
from the same weights.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import DeviceLike, resolve_device


class MLP(nn.Module):
    """Linear layers with tanh between them (none after the last)."""

    def __init__(self, sizes, gen: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList()
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            layer = nn.Linear(fan_in, fan_out)
            w = torch.randn(fan_in, fan_out, generator=gen) * math.sqrt(
                2.0 / fan_in)
            with torch.no_grad():
                layer.weight.copy_(w.t())
                layer.bias.zero_()
            self.layers.append(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = torch.tanh(x)
        return x

    def to_numpy(self) -> list:
        """The JAX package's layout: [{"w": [in, out], "b": [out]}]."""
        return [{"w": np.ascontiguousarray(
                    layer.weight.detach().cpu().numpy().T),
                 "b": layer.bias.detach().cpu().numpy().copy()}
                for layer in self.layers]

    @torch.no_grad()
    def load_numpy(self, layers) -> None:
        if len(layers) != len(self.layers):
            raise ValueError(f"{len(layers)} layers for an MLP of "
                             f"{len(self.layers)}")
        for layer, src in zip(self.layers, layers):
            w = torch.tensor(np.asarray(src["w"], np.float32))
            b = torch.tensor(np.asarray(src["b"], np.float32))
            if tuple(w.shape) != tuple(layer.weight.shape[::-1]):
                raise ValueError(f"weight of shape {tuple(w.shape)} for a "
                                 f"layer of {tuple(layer.weight.shape)}")
            layer.weight.copy_(w.t())
            layer.bias.copy_(b)


def _batch(batch: Dict[str, np.ndarray], dev: torch.device,
           skip=("indices",)) -> Dict[str, torch.Tensor]:
    """Numpy batch -> tensors on the learner's device (int columns as
    int64, for ``gather``)."""
    out = {}
    for k, v in batch.items():
        if k in skip:
            continue
        t = torch.tensor(np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(dev, non_blocking=True)
    return out


def _metrics(aux: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy for every metric."""
    keys = list(aux)
    vals = torch.stack([aux[k].detach().float() for k in keys]).cpu()
    return {k: float(v) for k, v in zip(keys, vals.tolist())}


class Adam:
    """``optax.adam(lr)`` over a list of leaves, as the JAX learners run it:
    ``optax.scale_by_adam``'s arithmetic in f32 and in its order, then
    ``scale_by_learning_rate`` and ``apply_updates``. Per leaf::

        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        update = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
        p = p + (-lr) * update

    The bias corrections are f32 tensors on the leaves' device (where
    ``torch.optim.Adam`` computes them in float64), and the division by
    them is a true division (a CPU scalar would let CUDA multiply by the
    reciprocal instead)."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        dev = self.params[0].device
        f32 = dict(dtype=torch.float32, device=dev)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self._b1 = torch.tensor(b1, **f32)
        self._b2 = torch.tensor(b2, **f32)
        self.count = torch.zeros((), **f32)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        bc1 = 1 - self._b1 ** self.count
        bc2 = 1 - self._b2 ** self.count
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_((g * g).mul_(1 - self.b2))
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            p.add_(update.mul_(-self.lr))


class _Learner:
    """Nets on one device and one Adam over their leaves."""

    def __init__(self, nets: Dict[str, MLP], lr: float, device: DeviceLike,
                 extra: Optional[Dict[str, nn.Parameter]] = None):
        self.device = resolve_device(device)
        self.nets = nn.ModuleDict(nets).to(self.device)
        self.extra = nn.ParameterDict(extra or {}).to(self.device)
        self._opt = Adam(
            list(self.nets.parameters()) + list(self.extra.parameters()),
            lr=lr)
        self.target: Optional[nn.ModuleDict] = None

    def _step(self, loss: torch.Tensor) -> None:
        self._opt.zero_grad()
        loss.backward()
        self._opt.step()

    def params_numpy(self) -> Dict[str, Any]:
        """Every leaf in the JAX learner's ``params`` layout."""
        out: Dict[str, Any] = {k: net.to_numpy()
                               for k, net in self.nets.items()}
        for k, p in self.extra.items():
            out[k] = p.detach().cpu().numpy().copy()
        return out

    def target_params_numpy(self) -> Optional[Dict[str, Any]]:
        if self.target is None:
            return None
        return {k: net.to_numpy() for k, net in self.target.items()}

    @torch.no_grad()
    def load_params(self, params: Dict[str, Any],
                    target_params: Optional[Dict[str, Any]] = None) -> None:
        """Load numpy (or array-like) leaves in the JAX learner's layout:
        every net and extra leaf of ``params``, and the target nets from
        ``target_params`` where this learner has them."""
        for k, net in self.nets.items():
            net.load_numpy(params[k])
        for k, p in self.extra.items():
            p.copy_(torch.tensor(np.asarray(params[k], np.float32)))
        if target_params is not None and self.target is not None:
            for k, net in self.target.items():
                net.load_numpy(target_params[k])


def learner_from_jax(jax_learner: Any, learner: _Learner) -> _Learner:
    """Carry a JAX learner's ``params`` (and ``target_params``) across into
    ``learner`` (read as numpy; nothing of JAX is imported here)."""
    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [tree(v) for v in x]
        return np.asarray(x)

    target = getattr(jax_learner, "target_params", None)
    learner.load_params(tree(jax_learner.params),
                        None if target is None else tree(target))
    return learner


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _categorical_terms(logits: torch.Tensor, actions: torch.Tensor):
    """(log-softmax, log-prob of ``actions``, mean entropy)."""
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, actions.unsqueeze(-1)).squeeze(-1)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    return logp_all, logp, entropy


class PPOLearner(_Learner):
    """Holds policy+value nets and performs PPO updates."""

    def __init__(self, obs_size: int, num_actions: int, *,
                 hidden: Tuple[int, ...] = (64, 64), lr: float = 3e-4,
                 clip: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, seed: int = 0,
                 device: DeviceLike = None):
        gen = _seeded(seed)
        super().__init__({"pi": MLP((obs_size, *hidden, num_actions), gen),
                          "vf": MLP((obs_size, *hidden, 1), gen)}, lr,
                         device)
        self._clip = clip
        self._vf_coeff = vf_coeff
        self._entropy_coeff = entropy_coeff

    def loss(self, b: Dict[str, torch.Tensor]):
        logits = self.nets["pi"](b["obs"])
        values = self.nets["vf"](b["obs"])[:, 0]
        _, logp, entropy = _categorical_terms(logits, b["actions"])
        ratio = torch.exp(logp - b["logp_old"])
        adv = b["advantages"]
        # jnp.std: ddof 0
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - self._clip, 1 + self._clip) * adv
        pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
        vf_loss = torch.mean((values - b["returns"]) ** 2)
        total = pi_loss + self._vf_coeff * vf_loss \
            - self._entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def get_weights(self) -> Any:
        return self.params_numpy()

    def update_minibatches(self, batch: Dict[str, np.ndarray], *,
                           num_epochs: int = 4,
                           minibatch_size: int = 128) -> Dict[str, float]:
        """``num_epochs`` passes of minibatch updates over ``batch`` (the
        JAX learner's order: ``RandomState(0)`` permutations, truncated to
        a multiple of the minibatch); the metrics of the last minibatch."""
        n = len(batch["obs"])
        if num_epochs < 1:
            raise ValueError("num_epochs must be >= 1")
        num_mb = max(1, n // minibatch_size)
        usable = num_mb * minibatch_size
        rng = np.random.RandomState(0)
        full = _batch(batch, self.device)
        for _ in range(num_epochs):
            perm = rng.permutation(n)[:usable]
            idx_all = torch.as_tensor(perm).to(self.device)
            for i in range(num_mb):
                idx = idx_all[i * minibatch_size:(i + 1) * minibatch_size]
                mb = {k: v[idx] for k, v in full.items()}
                total, aux = self.loss(mb)
                self._step(total)
        aux["total_loss"] = total
        return _metrics(aux)


class IMPALALearner(_Learner):
    """V-trace actor-critic updates on [B, T] trajectory fragments
    (reference: rllib/algorithms/impala/impala.py:599 training_step +
    vtrace torch/tf implementations; Espeholt et al. 2018). Off-policy
    correction lets rollouts be a few updates stale — the async pipeline
    never waits for the learner."""

    def __init__(self, obs_size: int, num_actions: int, *,
                 hidden: Tuple[int, ...] = (64, 64), lr: float = 5e-4,
                 gamma: float = 0.99, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01,
                 rho_bar: float = 1.0, c_bar: float = 1.0, seed: int = 0,
                 device: DeviceLike = None):
        gen = _seeded(seed)
        super().__init__({"pi": MLP((obs_size, *hidden, num_actions), gen),
                          "vf": MLP((obs_size, *hidden, 1), gen)}, lr,
                         device)
        self._gamma = gamma
        self._vf_coeff = vf_coeff
        self._entropy_coeff = entropy_coeff
        self._rho_bar = rho_bar
        self._c_bar = c_bar

    def loss(self, b: Dict[str, torch.Tensor]):
        # batch leaves: obs [B,T,D], actions [B,T], rewards [B,T],
        # terms/truncs [B,T], trunc_obs [B,T,D],
        # behavior_logp [B,T], bootstrap_obs [B,D]
        logits = self.nets["pi"](b["obs"])                      # [B,T,A]
        values = self.nets["vf"](b["obs"])[..., 0]
        v_boot = self.nets["vf"](b["bootstrap_obs"])[..., 0]    # [B]
        v_trunc = self.nets["vf"](b["trunc_obs"])[..., 0]       # [B,T]
        _, logp, entropy = _categorical_terms(logits, b["actions"])
        rho = torch.exp(logp - b["behavior_logp"])
        rho_clip = torch.clamp(rho, max=self._rho_bar)
        c_clip = torch.clamp(rho, max=self._c_bar)
        terms, truncs = b["terms"], b["truncs"]
        # Termination zeroes the bootstrap; truncation bootstraps from the
        # final pre-reset obs. BOTH cut the backward carry (the recursion
        # must not cross episode boundaries).
        discounts = self._gamma * (1.0 - terms)                 # [B,T]
        boundary = torch.maximum(terms, truncs)
        v_next = torch.cat([values[:, 1:], v_boot[:, None]], dim=1)
        v_next = torch.where(truncs > 0, v_trunc, v_next)
        deltas = rho_clip * (b["rewards"] + discounts * v_next - values)
        # vs_t - V_t recursion, backwards over T. vs only reaches the loss
        # through stop_gradient in the JAX learner: computed detached.
        with torch.no_grad():
            carry_disc = discounts * (1.0 - boundary)
            acc = torch.zeros_like(values[:, 0])
            accs = [None] * values.shape[1]
            for t in range(values.shape[1] - 1, -1, -1):
                acc = deltas[:, t] + carry_disc[:, t] * c_clip[:, t] * acc
                accs[t] = acc
            vs = torch.stack(accs, dim=1) + values              # [B,T]
            vs_next = torch.cat([vs[:, 1:], v_boot[:, None]], dim=1)
            vs_next = torch.where(truncs > 0, v_trunc, vs_next)
            pg_adv = rho_clip * (b["rewards"] + discounts * vs_next
                                 - values)
        pi_loss = -torch.mean(logp * pg_adv)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        total = pi_loss + self._vf_coeff * vf_loss \
            - self._entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def get_weights(self) -> Any:
        return self.params_numpy()

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One V-trace update on a stacked [B, T] fragment batch."""
        total, aux = self.loss(_batch(batch, self.device))
        self._step(total)
        aux["total_loss"] = total
        return _metrics(aux)


class DQNLearner(_Learner):
    """Double-DQN with a target network and per-sample TD errors for
    prioritized replay (reference: rllib/algorithms/dqn/
    dqn_rainbow_torch_learner.py loss — double-Q action selection from
    the ONLINE net, evaluation from the TARGET net; Huber TD loss
    weighted by importance-sampling weights)."""

    def __init__(self, obs_size: int, num_actions: int, *,
                 hidden: Tuple[int, ...] = (64, 64), lr: float = 1e-3,
                 gamma: float = 0.99, seed: int = 0,
                 device: DeviceLike = None):
        gen = _seeded(seed)
        super().__init__({"q": MLP((obs_size, *hidden, num_actions), gen)},
                         lr, device)
        self._gamma = gamma
        self.sync_target()

    def sync_target(self) -> None:
        self.target = copy.deepcopy(self.nets).requires_grad_(False)

    def loss(self, b: Dict[str, torch.Tensor]):
        q_net, q_target = self.nets["q"], self.target["q"]
        q = q_net(b["obs"])
        q_sa = q.gather(1, b["actions"][:, None])[:, 0]
        with torch.no_grad():
            # Double DQN: the ONLINE net picks the argmax action, the
            # TARGET net evaluates it.
            best = torch.argmax(q_net(b["next_obs"]), dim=-1)
            q_next = q_target(b["next_obs"]).gather(1, best[:, None])[:, 0]
            target = b["rewards"] + self._gamma * (1.0 - b["dones"]) \
                * q_next
        td = q_sa - target
        # Huber: quadratic near 0, linear past 1 (stable with the
        # occasional large TD error).
        abs_td = torch.abs(td)
        huber = torch.where(abs_td <= 1.0, 0.5 * td ** 2, abs_td - 0.5)
        weights = b.get("weights")
        if weights is None:
            weights = torch.ones_like(huber)
        loss = torch.mean(weights * huber)
        return loss, {"td_abs": abs_td, "q_mean": torch.mean(q_sa)}

    def get_weights(self) -> Any:
        return self.params_numpy()

    def update(self, batch: Dict[str, np.ndarray]
               ) -> Tuple[Dict[str, float], np.ndarray]:
        """One update; returns (metrics, per-sample |TD| for priority
        writes)."""
        loss, aux = self.loss(_batch(batch, self.device))
        self._step(loss)
        td_abs = aux.pop("td_abs").detach().cpu().numpy()
        aux["loss"] = loss
        return _metrics(aux), td_abs


LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


class SACLearner(_Learner):
    """Soft Actor-Critic for continuous control (reference:
    rllib/algorithms/sac/sac.py + torch learner losses; Haarnoja et al.
    2018): squashed-Gaussian policy, twin Q critics with a polyak-
    averaged target pair, and automatic entropy-temperature tuning
    against target_entropy = -action_size. One update performs critic +
    actor + alpha steps (one Adam step over every leaf) and the soft
    target sync.

    The Gaussian noise comes from the learner's own generator (seeded
    with ``seed + 17`` on the learner's device); ``update(batch,
    noise=(eps_next, eps_new))`` takes it from the caller instead, each
    [B, action_size]: the parity tests pass the JAX learner's draws."""

    def __init__(self, obs_size: int, action_size: int, *,
                 action_scale: float = 1.0, action_shift: float = 0.0,
                 hidden: Tuple[int, ...] = (64, 64), lr: float = 3e-4,
                 gamma: float = 0.99, tau: float = 0.005,
                 init_alpha: float = 0.1, seed: int = 0,
                 device: DeviceLike = None):
        gen = _seeded(seed)
        nets = {"pi": MLP((obs_size, *hidden, 2 * action_size), gen),
                "q1": MLP((obs_size + action_size, *hidden, 1), gen),
                "q2": MLP((obs_size + action_size, *hidden, 1), gen)}
        log_alpha = nn.Parameter(torch.tensor(float(np.log(init_alpha)),
                                              dtype=torch.float32))
        super().__init__(nets, lr, device, extra={"log_alpha": log_alpha})
        self.target = copy.deepcopy(nn.ModuleDict(
            {"q1": self.nets["q1"], "q2": self.nets["q2"]})
        ).requires_grad_(False)
        # Affine squash: action = shift + scale * tanh(.), covering
        # asymmetric [low, high] boxes (scale=(high-low)/2,
        # shift=(high+low)/2).
        self.action_scale = float(action_scale)
        self.action_shift = float(action_shift)
        self.action_size = action_size
        self._target_entropy = -float(action_size)
        self._gamma = gamma
        self._tau = tau
        self._noise_gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 17)

    def _pi_sample(self, obs: torch.Tensor, eps: torch.Tensor):
        out = self.nets["pi"](obs)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
        std = torch.exp(log_std)
        pre = mean + std * eps
        act = torch.tanh(pre)
        # log-prob with tanh change-of-variables (SAC appendix C).
        logp = (-0.5 * (eps ** 2 + 2 * log_std
                        + math.log(2 * math.pi))).sum(-1)
        logp = logp - torch.log(1 - act ** 2 + 1e-6).sum(-1)
        return self.action_shift + act * self.action_scale, logp

    @staticmethod
    def _q(net: MLP, obs: torch.Tensor, act: torch.Tensor,
           params: Optional[dict] = None) -> torch.Tensor:
        x = torch.cat([obs, act], dim=-1)
        if params is None:
            return net(x)[..., 0]
        return torch.func.functional_call(net, params, (x,))[..., 0]

    def loss(self, b: Dict[str, torch.Tensor], eps_next: torch.Tensor,
             eps_new: torch.Tensor):
        log_alpha = self.extra["log_alpha"]
        alpha = torch.exp(log_alpha)
        q1n, q2n = self.nets["q1"], self.nets["q2"]
        # ---- critic (the backup carries no gradient) ----
        with torch.no_grad():
            a_next, logp_next = self._pi_sample(b["next_obs"], eps_next)
            q_next = torch.minimum(
                self._q(self.target["q1"], b["next_obs"], a_next),
                self._q(self.target["q2"], b["next_obs"], a_next))
            backup = b["rewards"] + self._gamma * (1 - b["dones"]) * (
                q_next - alpha * logp_next)
        q1 = self._q(q1n, b["obs"], b["actions"])
        q2 = self._q(q2n, b["obs"], b["actions"])
        critic_loss = torch.mean((q1 - backup) ** 2 + (q2 - backup) ** 2)
        # ---- actor: the Q PARAMETERS are stopped, not the actions ----
        a_new, logp_new = self._pi_sample(b["obs"], eps_new)
        frozen1 = {k: v.detach() for k, v in q1n.named_parameters()}
        frozen2 = {k: v.detach() for k, v in q2n.named_parameters()}
        q_new = torch.minimum(self._q(q1n, b["obs"], a_new, frozen1),
                              self._q(q2n, b["obs"], a_new, frozen2))
        actor_loss = torch.mean(alpha.detach() * logp_new - q_new)
        # ---- temperature ----
        alpha_loss = -torch.mean(
            log_alpha * (logp_new + self._target_entropy).detach())
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": -torch.mean(logp_new)}

    def get_weights(self) -> Any:
        return {"pi": self.nets["pi"].to_numpy(),
                "action_scale": np.asarray(self.action_scale),
                "action_shift": np.asarray(self.action_shift)}

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[Tuple[Any, Any]] = None) -> Dict[str, float]:
        b = _batch(batch, self.device)
        shape = (len(batch["obs"]), self.action_size)
        if noise is None:
            eps_next = torch.randn(shape, generator=self._noise_gen,
                                   device=self.device)
            eps_new = torch.randn(shape, generator=self._noise_gen,
                                  device=self.device)
        else:
            eps_next, eps_new = (
                torch.tensor(np.asarray(e, np.float32)).to(self.device)
                for e in noise)
        total, aux = self.loss(b, eps_next, eps_new)
        self._step(total)
        with torch.no_grad():
            for k in ("q1", "q2"):
                for t, p in zip(self.target[k].parameters(),
                                self.nets[k].parameters()):
                    t.copy_((1 - self._tau) * t + self._tau * p)
        aux["loss"] = total
        return _metrics(aux)
