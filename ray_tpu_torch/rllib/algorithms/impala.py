"""IMPALA: the port's counterpart of `ray_tpu/rllib/algorithms/impala.py`
(reference: rllib/algorithms/impala), V-trace actor-critic.

The off-policy correction is `ops.losses.vtrace` on the whole [T, B]
batch at once (JAX vmaps its [T] form over B). The whole sequence is one
SGD step, no minibatches, per the reference's learner. JAX's
`stop_gradient`s become detached inputs: V-trace takes the target
log-probs and the values detached, so its `vs` and `pg_advantages` carry
no gradient.
"""

from typing import Dict

import torch

from ray_tpu_torch.ops.losses import vtrace
from .. import sample_batch as SB
from ..algorithm import Algorithm, AlgorithmConfig, _merge_runner_metrics
from ..learner import TorchLearner, _host_metrics, _rows, make_learner_group
from ..rl_module import RLModule
from ..sample_batch import SampleBatch


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = IMPALA
        self.lr = 5e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.grad_clip = 40.0
        self.rollout_fragment_length = 50
        self.train_batch_size = 500


def batch_vtrace(batch, target_logp, values, cfg):
    """V-trace of a [T, B] batch, given the target log-probs and values
    [T, B] under the current weights; it sees both detached."""
    values_tb1 = torch.cat([values, batch[SB.BOOTSTRAP_VALUE][None]], 0)   # [T+1, B]
    return vtrace(batch[SB.LOGP], target_logp.detach(), batch[SB.REWARDS],
                  values_tb1.detach(), batch[SB.DONES], cfg.gamma,
                  cfg.vtrace_clip_rho, cfg.vtrace_clip_c)


class IMPALALearner(TorchLearner):
    _TRAIN_KEYS = (SB.OBS, SB.ACTIONS, SB.LOGP, SB.REWARDS, SB.DONES, SB.BOOTSTRAP_VALUE)

    def compute_loss(self, net, batch):
        cfg = self.config
        dist_in, values = self.module.forward(net, batch[SB.OBS])   # [T, B] sequences
        dist = self.module.dist(dist_in)
        target_logp = dist.log_prob(batch[SB.ACTIONS])
        vt = batch_vtrace(batch, target_logp, values, cfg)
        pg_loss = -(target_logp * vt.pg_advantages).mean()
        vf_loss = 0.5 * (values - vt.vs).square().mean()
        entropy = dist.entropy().mean()
        loss = pg_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        return loss, {"policy_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}

    def dp_shard(self, batch, rank: int, n: int):
        """This rank's envs of a time-major [T, B] batch: V-trace scans over
        T and must see whole sequences, so the shard is on B (and
        BOOTSTRAP_VALUE [B] alike)."""
        return {k: _rows(v, rank, n, 0 if k == SB.BOOTSTRAP_VALUE else 1)
                for k, v in batch.items()}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return _host_metrics([self.update_once({k: batch[k] for k in self._TRAIN_KEYS})])


class IMPALA(Algorithm):
    # V-trace corrects for stale behaviour policies, so replayed sebulba
    # trajectories (gap >= 1) are exactly its intended input
    _supports_sebulba = True

    def setup(self, config: IMPALAConfig):
        self._setup_runners()
        spec = self._local_runner.get_spec()
        self.learner_group = make_learner_group(IMPALALearner, RLModule(spec), config,
                                                seed=config.seed)
        self.learner = self.learner_group.learner

    def training_step(self) -> Dict:
        cfg = self.config
        weights = self.learner.get_weights()
        timesteps, metrics_list, learn = 0, [], {}
        while timesteps < cfg.train_batch_size:
            batch, rm = self._sample_all(weights)
            metrics_list.append(rm)
            timesteps += batch[SB.REWARDS].size
            learn = self.learner.update(batch)  # learn per rollout arrival
        result = _merge_runner_metrics(metrics_list)
        result["num_env_steps_sampled_this_iter"] = timesteps
        result["learner"] = learn
        return result

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
