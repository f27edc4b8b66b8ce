"""SAC: the port's counterpart of `ray_tpu/rllib/algorithms/sac.py`
(reference: rllib/algorithms/sac/*): a squashed-Gaussian actor, twin
critics and an auto-tuned temperature.

The weights are one module, `SACNet`, whose state_dict holds JAX's dict
`{actor, q1, q2, q1_target, q2_target, log_alpha}` as prefixes (log_alpha
a 0-d parameter). `SACLearner` holds it on `config.device` with four Adam
states kept apart (actor, q1, q2, alpha) and runs JAX's update in JAX's
order: the critics step first toward the entropy-regularized target of
the target critics; the actor's loss takes the updated critics; the
temperature's loss takes the actor pass's log-probs without their
gradient; the Polyak averaging of the targets comes last. Each loss's
gradients are taken for its own net only (`torch.autograd.grad`).

Random draws. JAX splits a key into k1 (the target's action at s') and
k2 (the actor's action at s). `update` takes their standard normals as
`noise={"next": [B, A], "pi": [B, A]}`, so a test can replay JAX's draws;
without them it draws from the learner's `torch.Generator` on its device.

`SACLearner` needs no env: the `SAC` Algorithm probes the env's spaces,
builds one, and keeps JAX's loop (sample on the host CPU, add to the
replay buffer, wait for learning to start, `train_intensity` updates).
"""

import copy
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.torsos import MLPTorso, dense
from ray_tpu_torch.ops.optim import make_optimizer
from .. import sample_batch as SB
from ..algorithm import Algorithm, AlgorithmConfig, _merge_runner_metrics
from ..buffers import TRANSITION_KEYS, ReplayBuffer
from ..distributions import SquashedGaussian
from ..learner import _host_metrics
from ..rl_module import ModuleSpec
from ..sample_batch import SampleBatch


class _Actor(nn.Module):
    """obs -> (mean, log_std), each [N, action_dim]."""

    def __init__(self, spec: ModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.torso = MLPTorso(int(np.prod(spec.obs_shape)), spec.hiddens, generator=generator)
        z = self.torso.out_features
        self.mean = dense(z, spec.action_dim, None, generator)
        self.log_std = dense(z, spec.action_dim, None, generator)

    def forward(self, obs):
        z = self.torso(obs)
        return self.mean(z), self.log_std(z)


class _Critic(nn.Module):
    """(obs, action) -> Q [N]."""

    def __init__(self, spec: ModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.torso = MLPTorso(int(np.prod(spec.obs_shape)) + spec.action_dim, spec.hiddens,
                              generator=generator)
        self.q = dense(self.torso.out_features, 1, None, generator)

    def forward(self, obs, action):
        x = torch.cat([obs.reshape(obs.shape[0], -1), action], -1)
        return self.q(self.torso(x))[:, 0]


def frozen_copy(module: nn.Module) -> nn.Module:
    """A target net: a copy that takes no gradient."""
    return copy.deepcopy(module).requires_grad_(False)


class SACNet(nn.Module):
    """JAX's SAC weight dict as one module (targets start as copies)."""

    def __init__(self, spec: ModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.actor = _Actor(spec, generator)
        self.q1 = _Critic(spec, generator)
        self.q2 = _Critic(spec, generator)
        self.q1_target = frozen_copy(self.q1)
        self.q2_target = frozen_copy(self.q2)
        self.log_alpha = nn.Parameter(torch.zeros(()))


class SACModule:
    """The acting surface over a SAC net's actor (make_net, init, forward,
    explore_step, inference_step), as the EnvRunner calls it."""

    net_class = SACNet

    def __init__(self, spec: ModuleSpec, low: float = -1.0, high: float = 1.0):
        if spec.action_kind != "continuous":
            raise ValueError("SAC needs a continuous (Box) action space")
        self.spec = spec
        self.low, self.high = low, high

    def make_net(self, seed: int = 0, device="cpu") -> nn.Module:
        return self.net_class(self.spec, torch.Generator().manual_seed(seed)).to(device)

    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        return self.make_net(seed).state_dict()

    def dist(self, actor: nn.Module, obs) -> SquashedGaussian:
        mean, log_std = actor(obs.reshape((-1,) + tuple(self.spec.obs_shape)))
        return SquashedGaussian(mean, log_std, self.low, self.high)

    def _lead(self, obs):
        return obs.shape[: obs.ndim - len(self.spec.obs_shape)]

    def forward(self, net, obs):
        lead = self._lead(obs)
        mean = self.dist(net.actor, obs).base.mean
        return mean.reshape(lead + (self.spec.action_dim,)), torch.zeros(lead, device=obs.device)

    def explore_step(self, net, obs, generator: torch.Generator):
        lead = self._lead(obs)
        a, logp = self.dist(net.actor, obs).sample_and_log_prob(generator)
        return (a.reshape(lead + (self.spec.action_dim,)), logp.reshape(lead),
                torch.zeros(lead, device=obs.device))

    def inference_step(self, net, obs):
        lead = self._lead(obs)
        mode = self.dist(net.actor, obs).mode()
        return mode.reshape(lead + (self.spec.action_dim,)), torch.zeros(lead, device=obs.device)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = SAC
        self.lr = 3e-4
        self.tau = 0.005
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.train_intensity = 1
        self.target_entropy = None   # None -> -action_dim
        self.rollout_fragment_length = 8


def step_on(optimizer, params, loss):
    """Gradients of `loss` for `params` only, then one optimizer step."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    optimizer.step()


@torch.no_grad()
def polyak_(targets: Iterable[torch.Tensor], sources: Iterable[torch.Tensor], tau: float):
    """targets = (1 - tau) targets + tau sources, in place."""
    targets, sources = list(targets), list(sources)
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, sources, alpha=tau)


class SACLearner:
    """A SAC net and its per-net optimizers on `config.device`; `update`
    is JAX's jitted update (see the module note)."""

    module_class = SACModule
    # the optimizers a net: name -> the net's submodules they step
    OPTIMIZED = {"actor": ("actor",), "q1": ("q1",), "q2": ("q2",), "alpha": ("log_alpha",)}

    def __init__(self, spec: ModuleSpec, config, low: float = -1.0, high: float = 1.0,
                 seed: int = 0):
        self.config = config
        self.device = resolve_device(getattr(config, "device", "cuda"))
        self.module = self.make_module(spec, low, high)
        self.net = self.module.make_net(seed, self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.target_entropy = (config.target_entropy if config.target_entropy is not None
                               else -float(spec.action_dim))
        self.params = {name: [p for part in parts for p in self._params_of(part)]
                       for name, parts in self.OPTIMIZED.items()}
        self.optimizers = {}
        for name, params in self.params.items():
            self.optimizers[name], self.lr_schedule = self.new_optimizer(params)

    def make_module(self, spec, low, high):
        return self.module_class(spec, low, high)

    def new_optimizer(self, params):
        """(optimizer, schedule) for one net. JAX's online SAC: plain Adam at
        the config's lr."""
        return make_optimizer(params, lr=self.config.lr)

    def _params_of(self, name):
        part = getattr(self.net, name)
        return [part] if isinstance(part, nn.Parameter) else list(part.parameters())

    def device_noise(self, noise) -> Dict[str, torch.Tensor]:
        """Injected draws (numpy or tensors) on the learner's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in (noise or {}).items()}

    def sample(self, obs, noise=None):
        """(action, log-prob) of the current actor at `obs`."""
        return self.module.dist(self.net.actor, obs).sample_and_log_prob(self.generator, noise)

    def step_alpha(self, logp):
        """The temperature's step; returns its new value."""
        log_alpha = self.net.log_alpha
        loss = -(log_alpha.exp() * (logp.detach() + self.target_entropy)).mean()
        step_on(self.optimizers["alpha"], self.params["alpha"], loss)
        return log_alpha.detach().exp()

    def critic_target(self, b, alpha, noise):
        """r + gamma (1 - d) (min target-Q(s', a') - alpha log pi(a'|s'))."""
        with torch.no_grad():
            a_n, logp_n = self.sample(b[SB.NEXT_OBS], noise.get("next"))
            net = self.net
            q_n = torch.minimum(net.q1_target(b[SB.NEXT_OBS], a_n),
                                net.q2_target(b[SB.NEXT_OBS], a_n))
            return b[SB.REWARDS] + self.config.gamma * (1 - b[SB.TERMINATEDS]) * (
                q_n - alpha * logp_n)

    def step_critics(self, l1, l2):
        """Both critics' steps from one backward (l1 does not depend on q2,
        nor l2 on q1)."""
        params = self.params["q1"] + self.params["q2"]
        for p, g in zip(params, torch.autograd.grad(l1 + l2, params)):
            p.grad = g
        self.optimizers["q1"].step()
        self.optimizers["q2"].step()

    def update(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """One SAC update on a minibatch; metrics are device tensors."""
        b = SampleBatch(batch).to_device(self.device)
        noise = self.device_noise(noise)
        net = self.net
        obs, act = b[SB.OBS], b[SB.ACTIONS]
        alpha = net.log_alpha.detach().exp()
        target = self.critic_target(b, alpha, noise)
        l1 = (net.q1(obs, act) - target).square().mean()
        l2 = (net.q2(obs, act) - target).square().mean()
        self.step_critics(l1, l2)

        a, logp = self.sample(obs, noise.get("pi"))
        q = torch.minimum(net.q1(obs, a), net.q2(obs, a))
        la = (alpha * logp - q).mean()
        step_on(self.optimizers["actor"], self.params["actor"], la)
        new_alpha = self.step_alpha(logp)
        polyak_(net.q1_target.parameters(), net.q1.parameters(), self.config.tau)
        polyak_(net.q2_target.parameters(), net.q2.parameters(), self.config.tau)
        return {"critic_loss": 0.5 * (l1 + l2).detach(), "actor_loss": la.detach(),
                "alpha": new_alpha, "entropy": -logp.detach().mean()}

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", copy=True) for k, v in self.net.state_dict().items()}

    def set_weights(self, weights):
        """Load every net, targets included; the optimizers' moments stay,
        as JAX keeps its opt_state."""
        self.net.load_state_dict(weights)


class SAC(Algorithm):
    learner_class = SACLearner

    def setup(self, config: SACConfig):
        from ..env_runner import EnvRunner
        probe = EnvRunner(config.env, num_envs=1, rollout_len=2, env_config=config.env_config)
        spec = probe.get_spec()
        space = probe.envs.single_action_space
        low, high = float(np.min(space.low)), float(np.max(space.high))
        probe.close()
        self.learner = self.learner_class(spec, config, low, high, seed=config.seed)
        self.module = self.learner.module
        self._setup_runners()
        self.buffer = ReplayBuffer(config.replay_buffer_capacity, seed=config.seed)
        self.env_steps = 0

    def _make_runner_kwargs(self):
        kw = super()._make_runner_kwargs()
        kw["module"] = self.module
        kw["record_next_obs"] = True
        return kw

    def training_step(self) -> Dict:
        cfg = self.config
        batch, rm = self._sample_all(self.learner.get_weights())
        flat = batch.flatten()
        self.env_steps += flat.count
        self.buffer.add_batch({k: flat[k] for k in TRANSITION_KEYS})
        metrics = _merge_runner_metrics([rm])
        metrics["num_env_steps_sampled_this_iter"] = flat.count
        if self.env_steps < cfg.num_steps_sampled_before_learning_starts:
            return metrics
        for _ in range(cfg.train_intensity):
            last = self.learner.update(self.buffer.sample(cfg.train_batch_size))
        metrics["learner"] = _host_metrics([last])
        return metrics

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
