"""BC and MARWIL: the port's counterpart of `ray_tpu/rllib/algorithms/bc.py`
(reference: rllib/algorithms/bc, rllib/algorithms/marwil).

Offline: learns from recorded (obs, actions[, advantages, ...]) columns
with no env. beta = 0 is behaviour cloning; beta > 0 weights the
log-likelihood by exponentiated advantages (MARWIL) when the data has an
`advantages` column. `BCLearner` is a `TorchLearner` on `config.device`;
each `train()` is one update on a minibatch drawn with the reference's
seeded numpy generator. A dataset is taken by duck typing (an object with
`take_batch`), as JAX's is.
"""

from typing import Dict

import numpy as np
import torch

from .. import sample_batch as SB
from ..algorithm import Algorithm, AlgorithmConfig
from ..learner import TorchLearner, _host_metrics, make_learner_group
from ..rl_module import ModuleSpec, RLModule


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = BC
        self.lr = 1e-3
        self.beta = 0.0                  # 0 -> BC; > 0 -> MARWIL
        self.offline_data = None         # SampleBatch | dict | dataset
        self.train_batch_size = 256
        self.moving_average_sqd_adv_norm = 100.0

    def offline_data_source(self, data):
        self.offline_data = data
        return self


class BCLearner(TorchLearner):
    def compute_loss(self, net, batch):
        cfg = self.config
        dist_in, values = self.module.forward(net, batch[SB.OBS])
        logp = self.module.dist(dist_in).log_prob(batch[SB.ACTIONS])
        if cfg.beta > 0 and SB.ADVANTAGES in batch:
            adv = batch[SB.ADVANTAGES]
            norm = max(float(np.sqrt(np.float32(cfg.moving_average_sqd_adv_norm))), 1e-8)
            loss = -(torch.exp(cfg.beta * adv / norm) * logp).mean()
            vf_loss = 0.5 * (values - batch.get(SB.VALUE_TARGETS, adv)).square().mean()
            loss = loss + 0.5 * vf_loss
        else:
            loss = -logp.mean()
        out = {"bc_logp": logp.mean()}
        if dist_in.ndim >= 1 and self.module.spec.action_kind == "discrete":
            out["action_accuracy"] = (dist_in.argmax(-1) == batch[SB.ACTIONS]).float().mean()
        return loss, out


class BC(Algorithm):
    def setup(self, config: BCConfig):
        if config.offline_data is None:
            raise ValueError("BC needs config.offline_data")
        self._data = self._to_arrays(config.offline_data)
        obs_shape = self._data[SB.OBS].shape[1:]
        acts = np.asarray(self._data[SB.ACTIONS])
        hiddens = tuple(config.model.get("hiddens", (256, 256)))
        if np.issubdtype(acts.dtype, np.integer):
            spec = ModuleSpec(obs_shape, "discrete", int(acts.max()) + 1, hiddens)
        else:
            spec = ModuleSpec(obs_shape, "continuous", int(np.prod(acts.shape[1:])), hiddens)
        self.learner_group = make_learner_group(BCLearner, RLModule(spec), config,
                                                seed=config.seed)
        self.learner = self.learner_group.learner
        self._rng = np.random.default_rng(config.seed)
        self._n = len(self._data[SB.OBS])

    @staticmethod
    def _to_arrays(data) -> Dict[str, np.ndarray]:
        if isinstance(data, dict):
            return {k: np.asarray(v) for k, v in data.items()}
        if hasattr(data, "take_batch"):   # a ray_tpu.data Dataset
            return data.take_batch(data.count(), batch_format="numpy")
        raise TypeError(f"unsupported offline data {type(data)}")

    def training_step(self) -> Dict:
        idx = self._rng.integers(0, self._n, size=self.config.train_batch_size)
        minibatch = {k: v[idx] for k, v in self._data.items()}
        return {"learner": _host_metrics([self.learner.update_once(minibatch)]),
                "num_env_steps_sampled_this_iter": 0}

    def evaluate(self):
        if self.config.env is None:
            return {}
        return super().evaluate()

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0


MARWIL = BC
