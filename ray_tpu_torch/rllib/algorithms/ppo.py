"""PPO: the port's counterpart of `ray_tpu/rllib/algorithms/ppo.py`
(reference: rllib/algorithms/ppo/ppo.py and its torch losses).

The loss is the reference's (clipped surrogate, clipped value loss,
entropy bonus). An update moves the flattened batch to the learner's
device once; each epoch shuffles it with the reference's numpy generator
(`default_rng(seed + 1)`, made anew each update) and takes minibatches of
the shuffled rows on the device, dropping the remainder.

Multi-agent mode (`config.multi_agent(policies=..., policy_mapping_fn=...)`)
keeps one learner group a policy and a `MultiAgentEnvRunner` acting on the
host CPU; `multi_agent_training_step` is its iteration, which a caller
with its own runner and learners may also drive.
"""

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.ops.losses import clipped_value_loss, ppo_surrogate
from .. import sample_batch as SB
from ..algorithm import Algorithm, AlgorithmConfig, _merge_runner_metrics
from ..connectors import compute_gae, standardize_advantages
from ..learner import TorchLearner, _host_metrics, make_learner_group
from ..multi_agent import MultiAgentEnvRunner, module_specs_for
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


def multi_agent_training_step(runner, learner_groups: Dict, cfg) -> Dict:
    """One multi-agent PPO iteration: rollouts from `runner` (a
    MultiAgentEnvRunner) until `cfg.train_batch_size` env steps, then, a
    policy, its [T, k] batches joined on the agent axis, GAE, standardized
    advantages and its learner group's update. Learner metrics are keyed
    by policy, as the reference's."""
    weights = {pid: g.get_weights() for pid, g in learner_groups.items()}
    timesteps, runner_metrics = 0, []
    per_policy: Dict[str, list] = {pid: [] for pid in learner_groups}
    while timesteps < cfg.train_batch_size:
        ma_batch, rm = runner.sample(weights)
        runner_metrics.append(rm)
        timesteps += ma_batch.env_steps()
        for pid, batch in ma_batch.policy_batches.items():
            per_policy[pid].append(batch)
    learn: Dict[str, Dict] = {}
    for pid, batches in per_policy.items():
        if not batches:
            continue
        batch = compute_gae(SampleBatch.concat(batches, axis=1), cfg.gamma, cfg.lambda_)
        if cfg.standardize_advantages:
            batch = standardize_advantages(batch)
        learn[pid] = learner_groups[pid].update(batch)
    result = _merge_runner_metrics(runner_metrics)
    result["num_env_steps_sampled_this_iter"] = timesteps
    result["learner"] = learn
    return result


class PPO(Algorithm):
    def setup(self, config: PPOConfig):
        if config.policies:
            return self._setup_multi_agent(config)
        self._setup_runners()
        spec = self._local_runner.get_spec()
        self.learner_group = make_learner_group(PPOLearner, RLModule(spec), config,
                                                seed=config.seed)
        self.learner = self.learner_group.learner

    # -- multi-agent mode (reference: rllib/env/multi_agent_env.py and the
    # policy map): one PPOLearner a policy, a policy's agents batched ------
    def _ma_env_creator(self):
        env = self.config.env
        return env if callable(env) else (lambda: env)

    def _ma_runner(self, explore: bool, seed: int) -> MultiAgentEnvRunner:
        cfg = self.config
        return MultiAgentEnvRunner(
            self._ma_env_creator(), policy_mapping_fn=self._mapping,
            modules={pid: g.learner.module for pid, g in self.ma_learner_groups.items()},
            rollout_len=cfg.rollout_fragment_length, explore=explore, seed=seed)

    def _setup_multi_agent(self, config):
        self._mapping = config.policy_mapping_fn or (lambda aid: config.policies[0])
        specs = module_specs_for(self._ma_env_creator()(), self._mapping,
                                 hiddens=tuple(config.model.get("hiddens", (256, 256))))
        missing = set(specs) - set(config.policies)
        if missing:
            raise ValueError(f"policy_mapping_fn produced unknown policies "
                             f"{sorted(missing)}; declared {config.policies}")
        self.ma_learner_groups = {
            pid: make_learner_group(PPOLearner, RLModule(specs[pid]), config,
                                    seed=config.seed + i)
            for i, pid in enumerate(sorted(specs))}
        self._ma_sampler = self._ma_runner(config.explore, config.seed)

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
        if cfg.policies:
            return multi_agent_training_step(self._ma_sampler, self.ma_learner_groups, cfg)
        batch, runner_metrics, timesteps = self._collect()
        batch = compute_gae(batch, cfg.gamma, cfg.lambda_)
        if cfg.standardize_advantages:
            batch = standardize_advantages(batch)
        result = _merge_runner_metrics(runner_metrics)
        result["num_env_steps_sampled_this_iter"] = timesteps
        result["learner"] = self.learner_group.update(batch)
        return result

    def evaluate(self) -> Dict:
        """Greedy episodes; in multi-agent mode on a fresh greedy runner
        seeded `seed + 10_000`, until `evaluation_duration` episodes end
        (the metrics of the last rollout that ended one)."""
        if not self.config.policies:
            return super().evaluate()
        cfg = self.config
        runner = self._ma_runner(False, cfg.seed + 10_000)
        weights = self.get_weights()
        episodes, merged = 0, {}
        while episodes < cfg.evaluation_duration:
            _b, m = runner.sample(weights)
            episodes += m.get("episodes_this_iter", 0)
            if "episode_return_mean" in m:
                merged = m
        return merged

    def get_weights(self):
        if self.config.policies:
            return {pid: g.get_weights() for pid, g in self.ma_learner_groups.items()}
        return self.learner.get_weights()

    def set_weights(self, weights):
        if self.config.policies:
            for pid, w in weights.items():
                self.ma_learner_groups[pid].set_weights(w)
            return
        self.learner.set_weights(weights)
