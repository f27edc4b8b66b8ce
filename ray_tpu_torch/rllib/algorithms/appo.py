"""APPO: the port's counterpart of `ray_tpu/rllib/algorithms/appo.py`
(reference: rllib/algorithms/appo), PPO's clipped surrogate on
V-trace-corrected advantages.

The V-trace targets are computed under the learner's current weights, with
no gradient, on the learner's device, then the PPO update runs on them.
"""

from typing import Dict

import torch

from .. import sample_batch as SB
from ..algorithm import _merge_runner_metrics
from ..connectors import standardize_advantages
from .impala import IMPALALearner, batch_vtrace
from .ppo import PPO, PPOConfig


class APPOConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.num_epochs = 2          # fewer epochs: the data is slightly stale
        self.use_kl_loss = False


class APPO(PPO):
    _supports_sebulba = True

    @torch.no_grad()
    def _targets(self, batch):
        """V-trace (pg advantages, value targets) of a [T, B] batch under the
        learner's current weights, as numpy."""
        learner, module = self.learner, self.learner.module
        cols = learner.to_device({k: batch[k] for k in IMPALALearner._TRAIN_KEYS})
        dist_in, values = module.forward(learner.net, cols[SB.OBS])
        target_logp = module.dist(dist_in).log_prob(cols[SB.ACTIONS])
        vt = batch_vtrace(cols, target_logp, values, self.config)
        return vt.pg_advantages.cpu().numpy(), vt.vs.cpu().numpy()

    def _sebulba_update(self, batch) -> Dict:
        """The learn stage of a replay-sampled [T, B] batch: V-trace targets
        under the current weights (the correction that absorbs the
        off-policy gap), then the clipped-surrogate update."""
        batch[SB.ADVANTAGES], batch[SB.VALUE_TARGETS] = self._targets(batch)
        if self.config.standardize_advantages:
            batch = standardize_advantages(batch)
        return self.learner_group.update(batch)

    def training_step(self) -> Dict:
        batch, runner_metrics, timesteps = self._collect()
        # V-trace instead of GAE (the reference's APPO learner path)
        result = _merge_runner_metrics(runner_metrics)
        result["num_env_steps_sampled_this_iter"] = timesteps
        result["learner"] = self._sebulba_update(batch)
        return result
