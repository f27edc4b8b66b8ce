"""PPO: the port's counterpart of `ray_tpu/rllib/algorithms/ppo.py`
(reference: rllib/algorithms/ppo/ppo.py and its torch losses).

The loss is the reference's (clipped surrogate, clipped value loss,
entropy bonus). An update moves the flattened batch to the learner's
device once; each epoch shuffles it with the reference's numpy generator
(`default_rng(seed + 1)`, made anew each update) and takes minibatches of
the shuffled rows on the device, dropping the remainder.
"""

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.ops.losses import clipped_value_loss, ppo_surrogate
from .. import sample_batch as SB
from ..algorithm import Algorithm, AlgorithmConfig, _merge_runner_metrics
from ..connectors import compute_gae, standardize_advantages
from ..learner import TorchLearner, _host_metrics, make_learner_group
from ..rl_module import RLModule
from ..sample_batch import SampleBatch


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = PPO
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.0          # 0 -> pure clipping (the reference's default path)
        self.kl_target = 0.01
        self.num_epochs = 10
        self.minibatch_size = 128
        self.train_batch_size = 4000
        self.grad_clip = 0.5
        self.standardize_advantages = True


class PPOLearner(TorchLearner):
    def compute_loss(self, net, batch):
        cfg = self.config
        dist_in, values = self.module.forward(net, batch[SB.OBS])
        dist = self.module.dist(dist_in)
        logp = dist.log_prob(batch[SB.ACTIONS])
        pi_loss, clip_frac = ppo_surrogate(logp, batch[SB.LOGP], batch[SB.ADVANTAGES],
                                           cfg.clip_param)
        vf_loss = clipped_value_loss(values, batch[SB.VF_PREDS], batch[SB.VALUE_TARGETS],
                                     cfg.vf_clip_param)
        entropy = dist.entropy().mean()
        loss = pi_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        approx_kl = (batch[SB.LOGP] - logp).mean()
        if cfg.kl_coeff:
            loss = loss + cfg.kl_coeff * approx_kl
        return loss, {"policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy,
                      "clip_frac": clip_frac, "approx_kl": approx_kl}

    _TRAIN_KEYS = (SB.OBS, SB.ACTIONS, SB.LOGP, SB.ADVANTAGES, SB.VF_PREDS, SB.VALUE_TARGETS)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + 1)
        # subset before flatten: per-env columns like BOOTSTRAP_VALUE have a
        # different length and must not ride into the minibatches
        flat = SampleBatch({k: batch[k] for k in self._TRAIN_KEYS}).flatten()
        n, size = flat.count, cfg.minibatch_size
        cols = self.to_device(flat)
        steps = []
        for _ in range(cfg.num_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for i in range(0, n - size + 1, size):
                idx = perm[i:i + size]
                steps.append(self.update_once({k: v[idx] for k, v in cols.items()}))
        return _host_metrics(steps)


class PPO(Algorithm):
    def setup(self, config: PPOConfig):
        if config.policies:
            raise NotImplementedError("multi-agent PPO is a later slice of the port "
                                      "(ROADMAP.md §A item 5)")
        self._setup_runners()
        spec = self._local_runner.get_spec()
        self.learner_group = make_learner_group(PPOLearner, RLModule(spec), config,
                                                seed=config.seed)
        self.learner = self.learner_group.learner

    def _collect(self):
        """Rollouts until train_batch_size env steps: (batch, runner metrics,
        env steps)."""
        cfg = self.config
        weights = self.learner.get_weights()
        collected, runner_metrics, timesteps = [], [], 0
        while timesteps < cfg.train_batch_size:
            batch, rm = self._sample_all(weights)
            collected.append(batch)
            runner_metrics.append(rm)
            timesteps += batch[SB.REWARDS].size
        return SampleBatch.concat(collected, axis=1), runner_metrics, timesteps

    def training_step(self) -> Dict:
        cfg = self.config
        batch, runner_metrics, timesteps = self._collect()
        batch = compute_gae(batch, cfg.gamma, cfg.lambda_)
        if cfg.standardize_advantages:
            batch = standardize_advantages(batch)
        result = _merge_runner_metrics(runner_metrics)
        result["num_env_steps_sampled_this_iter"] = timesteps
        result["learner"] = self.learner_group.update(batch)
        return result

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
