"""DQN with double-Q and the dueling head: the port's counterpart of
`ray_tpu/rllib/algorithms/dqn.py` (reference: rllib/algorithms/dqn/*).

`DQNLearner` holds the Q-net and its target on `config.device` and runs
one TD update a call: online and target forwards, Huber on the TD error
(weighted by PER's `_weights` when the minibatch has them), the
global-norm clip and Adam, where JAX runs one jitted program. It is built
from a spec and a config, so it needs no env; the `DQN` Algorithm owns
one and keeps JAX's loop: sample on the host CPU, add to the replay
buffer, wait for learning to start, update `train_intensity` times, copy
the online net to the target every `target_network_update_freq` SGD
steps. The clip takes the gradients' global norm once an update, in the
optimizer's pre-step hook; nothing takes it again for a metric (JAX's
DQN reports none).

Epsilon lives in the Q-net as the buffer `epsilon`, so the weights a
runner receives carry it, as JAX's `{"params", "epsilon"}` do. Acting
draws from a `torch.Generator` where JAX splits a key.
"""

import copy
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.torsos import CNNTorso, MLPTorso, dense
from ray_tpu_torch.ops.losses import huber
from ray_tpu_torch.ops.optim import make_optimizer
from .. import sample_batch as SB
from ..algorithm import Algorithm, AlgorithmConfig, _merge_runner_metrics
from ..buffers import TRANSITION_KEYS, PrioritizedReplayBuffer, ReplayBuffer
from ..rl_module import ModuleSpec
from ..sample_batch import SampleBatch


class QNet(nn.Module):
    """obs [N, *obs_shape] -> Q [N, action_dim] on the MLP or Nature-CNN
    torso; the dueling head is val + adv - mean(adv). Heads take flax's
    default init (LeCun normal)."""

    def __init__(self, spec: ModuleSpec, dueling: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spec.use_cnn:
            self.torso = CNNTorso(spec.obs_shape, generator=generator)
        else:
            self.torso = MLPTorso(int(np.prod(spec.obs_shape)), spec.hiddens, generator=generator)
        z = self.torso.out_features
        self.dueling = dueling
        if dueling:
            self.adv = dense(z, spec.action_dim, None, generator)
            self.val = dense(z, 1, None, generator)
        else:
            self.q = dense(z, spec.action_dim, None, generator)
        self.register_buffer("epsilon", torch.tensor(1.0))

    def forward(self, obs):
        z = self.torso(obs)
        if self.dueling:
            adv = self.adv(z)
            return self.val(z) + adv - adv.mean(-1, keepdim=True)
        return self.q(z)


class DQNModule:
    """Epsilon-greedy acting over a Q-net; the RLModule surface the
    EnvRunner calls (make_net, init, forward, explore_step,
    inference_step)."""

    def __init__(self, spec: ModuleSpec, dueling: bool = False):
        if spec.action_kind != "discrete":
            raise ValueError("DQN needs a discrete action space")
        self.spec = spec
        self.dueling = dueling

    def make_net(self, seed: int = 0, device="cpu") -> QNet:
        return QNet(self.spec, self.dueling, torch.Generator().manual_seed(seed)).to(device)

    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        return self.make_net(seed).state_dict()

    def _q(self, net, obs):
        lead = obs.shape[: obs.ndim - len(self.spec.obs_shape)]
        q = net(obs.reshape((-1,) + tuple(self.spec.obs_shape)))
        return q.reshape(lead + (self.spec.action_dim,))

    def forward(self, net, obs):
        q = self._q(net, obs)
        return q, q.max(-1).values

    def explore_step(self, net, obs, generator: torch.Generator):
        q = self._q(net, obs)
        greedy = q.argmax(-1)
        random_a = torch.randint(0, self.spec.action_dim, greedy.shape, generator=generator,
                                 device=q.device)
        take_random = torch.rand(greedy.shape, generator=generator, device=q.device) < net.epsilon
        action = torch.where(take_random, random_a, greedy)
        return action, torch.zeros(action.shape, device=q.device), q.max(-1).values

    def inference_step(self, net, obs):
        q = self._q(net, obs)
        return q.argmax(-1), q.max(-1).values


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DQN
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500   # in SGD steps
        self.train_intensity = 1                # SGD steps an env-step batch
        self.double_q = True
        self.dueling = False
        self.prioritized_replay = False
        self.per_alpha = 0.6
        self.per_beta = 0.4
        self.epsilon_start = 1.0
        self.epsilon_end = 0.02
        self.epsilon_decay_steps = 10_000
        self.rollout_fragment_length = 4
        self.grad_clip = 10.0


class DQNLearner:
    """The Q-net, its target and Adam (after the global-norm clip) on
    `config.device`."""

    def __init__(self, spec: ModuleSpec, config, seed: int = 0):
        self.config = config
        self.device = resolve_device(getattr(config, "device", "cuda"))
        self.module = DQNModule(spec, dueling=config.dueling)
        self.net = self.module.make_net(seed, self.device)
        self.target = copy.deepcopy(self.net).requires_grad_(False)
        self.optimizer, _ = make_optimizer(self.net.parameters(), lr=config.lr,
                                           grad_clip=config.grad_clip)

    def update(self, batch) -> Dict[str, torch.Tensor]:
        """One TD update on a minibatch (numpy or tensors; `_weights` are
        PER's importance weights). Returns device tensors: `loss`,
        `td_abs` [B] and `qmean`."""
        b = SampleBatch(batch).to_device(self.device)
        cfg = self.config
        q = self.net(b[SB.OBS])
        q_taken = q.gather(1, b[SB.ACTIONS].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_t = self.target(b[SB.NEXT_OBS])
            if cfg.double_q:
                a_star = self.net(b[SB.NEXT_OBS]).argmax(-1)
                q_next = q_next_t.gather(1, a_star[:, None])[:, 0]
            else:
                q_next = q_next_t.max(-1).values
            target = b[SB.REWARDS] + cfg.gamma * (1.0 - b[SB.TERMINATEDS]) * q_next
        td = q_taken - target
        w = b.get("_weights")
        loss = (huber(td) if w is None else w * huber(td)).mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), "td_abs": td.detach().abs(), "qmean": q_taken.detach().mean()}

    def sync_target(self):
        self.target.load_state_dict(self.net.state_dict())

    def set_epsilon(self, epsilon: float):
        self.net.epsilon.fill_(epsilon)

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", copy=True) for k, v in self.net.state_dict().items()}

    def set_weights(self, weights):
        """Load the net and its target (the optimizer's moments stay, as
        JAX's DQN keeps its opt_state)."""
        self.net.load_state_dict(weights)
        self.sync_target()


def learn_from_replay(learner: DQNLearner, buffer, cfg, sgd_steps: int):
    """`cfg.train_intensity` updates on minibatches from `buffer` (with
    PER's beta, and its TD errors written back), the target synced every
    `target_network_update_freq` SGD steps. Returns (the losses as device
    tensors, the SGD step count)."""
    losses = []
    for _ in range(cfg.train_intensity):
        if cfg.prioritized_replay:
            sample = buffer.sample(cfg.train_batch_size, beta=cfg.per_beta)
            indices = sample.pop("_indices")
        else:
            sample, indices = buffer.sample(cfg.train_batch_size), None
        aux = learner.update(sample)
        sgd_steps += 1
        if indices is not None:
            buffer.update_priorities(indices, aux["td_abs"].cpu().numpy())
        losses.append(aux["loss"])
        if sgd_steps % cfg.target_network_update_freq == 0:
            learner.sync_target()
    return losses, sgd_steps


class DQN(Algorithm):
    def setup(self, config: DQNConfig):
        from ..env_runner import EnvRunner
        # probe the spaces first: the runners need the Q-module at construction
        probe = EnvRunner(config.env, num_envs=1, rollout_len=2, env_config=config.env_config)
        spec = probe.get_spec()
        probe.close()
        self.learner = DQNLearner(spec, config, seed=config.seed)
        self.module = self.learner.module
        self._setup_runners()
        if config.prioritized_replay:
            self.buffer = PrioritizedReplayBuffer(config.replay_buffer_capacity,
                                                  alpha=config.per_alpha, seed=config.seed)
        else:
            self.buffer = ReplayBuffer(config.replay_buffer_capacity, seed=config.seed)
        self.env_steps = 0
        self.sgd_steps = 0

    def _make_runner_kwargs(self):
        kw = super()._make_runner_kwargs()
        kw["module"] = self.module
        kw["record_next_obs"] = True
        return kw

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(self.env_steps / max(cfg.epsilon_decay_steps, 1), 1.0)
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def training_step(self) -> Dict:
        cfg = self.config
        self.learner.set_epsilon(self._epsilon())
        batch, rm = self._sample_all(self.learner.get_weights())
        flat = batch.flatten()
        self.env_steps += flat.count
        self.buffer.add_batch({k: flat[k] for k in TRANSITION_KEYS})
        metrics: Dict = _merge_runner_metrics([rm])
        metrics["num_env_steps_sampled_this_iter"] = flat.count
        metrics["epsilon"] = float(self._epsilon())
        if self.env_steps < cfg.num_steps_sampled_before_learning_starts:
            return metrics

        losses, self.sgd_steps = learn_from_replay(self.learner, self.buffer, cfg,
                                                   self.sgd_steps)
        metrics["learner"] = {"loss": float(np.mean(torch.stack(losses).cpu().numpy(),
                                                    dtype=np.float64)),
                              "sgd_steps": self.sgd_steps}
        return metrics

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
