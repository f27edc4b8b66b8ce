"""IQL, Implicit Q-Learning: the port's counterpart of
`ray_tpu/rllib/algorithms/iql.py` (reference: rllib/algorithms/iql/;
arXiv:2110.06169). Offline RL that never queries Q at an action outside
the data:
- a value net V(s) fits the twin target-Q at the data's actions by
  expectile regression (weight tau where Q > V, 1 - tau elsewhere);
- the critics regress r + gamma (1 - d) V'(s'), V' the value net just
  stepped (no action is sampled at s');
- the actor is advantage-weighted regression: it maximizes
  min(exp(beta (Q_target(s, a) - V(s))), cap) log pi(a | s).

`IQLLearner` holds SAC's nets plus `value` in one module (the weights
carry JAX's `{actor, q1, q2, q1_target, q2_target, value, log_alpha}`;
log_alpha is kept and unused) and one optimizer a net (actor, q1, q2,
value) from the config's lr schedule, optimizer and grad clip. The update
draws nothing.
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.models.torsos import MLPTorso, dense
from .. import sample_batch as SB
from ..algorithm import Algorithm
from ..rl_module import ModuleSpec
from ..sample_batch import SampleBatch
from .offline_utils import (evaluate_continuous, load_continuous_dataset,
                            make_offline_optimizer, offline_training_step)
from .sac import SACConfig, SACLearner, SACModule, SACNet, polyak_, step_on


class _ValueNet(nn.Module):
    """obs -> V [N]."""

    def __init__(self, spec: ModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.torso = MLPTorso(int(np.prod(spec.obs_shape)), spec.hiddens, generator=generator)
        self.v = dense(self.torso.out_features, 1, None, generator)

    def forward(self, obs):
        return self.v(self.torso(obs))[:, 0]


class IQLNet(SACNet):
    def __init__(self, spec: ModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__(spec, generator)
        self.value = _ValueNet(spec, generator)


class IQLModule(SACModule):
    net_class = IQLNet


class IQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = IQL
        self.offline_data = None
        self.expectile = 0.8         # the reference's iql.py:69 (tau in the paper)
        self.beta = 0.1              # AWR temperature, iql.py:66
        self.awr_weight_cap = 100.0  # exp-advantage clip (the paper's appendix)
        self.train_intensity = 8
        self.action_low = None
        self.action_high = None

    def offline_data_source(self, data):
        self.offline_data = data
        return self


class IQLLearner(SACLearner):
    module_class = IQLModule
    OPTIMIZED = {"actor": ("actor",), "q1": ("q1",), "q2": ("q2",), "value": ("value",)}

    def new_optimizer(self, params):
        return make_offline_optimizer(self.config, params)

    def update(self, batch, noise=None) -> Dict[str, torch.Tensor]:
        b = SampleBatch(batch).to_device(self.device)
        cfg, net = self.config, self.net
        obs, act, nxt = b[SB.OBS], b[SB.ACTIONS], b[SB.NEXT_OBS]

        # the value net: expectile regression toward min target-Q(s, a_data)
        with torch.no_grad():
            q_t = torch.minimum(net.q1_target(obs, act), net.q2_target(obs, act))
        v = net.value(obs)
        diff = q_t - v
        wgt = torch.where(diff > 0, cfg.expectile, 1 - cfg.expectile)
        lv = (wgt * diff.square()).mean()
        step_on(self.optimizers["value"], self.params["value"], lv)

        # the critics: Bellman toward the stepped V at s'
        with torch.no_grad():
            target = b[SB.REWARDS] + cfg.gamma * (1 - b[SB.TERMINATEDS]) * net.value(nxt)
        l1 = (net.q1(obs, act) - target).square().mean()
        l2 = (net.q2(obs, act) - target).square().mean()
        self.step_critics(l1, l2)

        # the actor: AWR, the advantage from the target critics and the old V
        adv = q_t - v.detach()
        awr_w = torch.clamp(torch.exp(cfg.beta * adv), max=cfg.awr_weight_cap)
        logp = self.module.dist(net.actor, obs).log_prob(act)
        la = -(awr_w * logp).mean()
        step_on(self.optimizers["actor"], self.params["actor"], la)
        polyak_(net.q1_target.parameters(), net.q1.parameters(), cfg.tau)
        polyak_(net.q2_target.parameters(), net.q2.parameters(), cfg.tau)
        return {"value_loss": lv.detach(), "critic_loss": 0.5 * (l1 + l2).detach(),
                "actor_loss": la.detach(), "adv_mean": adv.mean(),
                "awr_weight_mean": awr_w.mean(), "behavior_logp": logp.detach().mean()}


class IQL(Algorithm):
    # its weights are SAC's nets, which a generic EnvRunner cannot act
    # with: evaluate() is this class's own inline loop
    _supports_eval_actors = False

    def setup(self, config: IQLConfig):
        if config.offline_data is None:
            raise ValueError("IQL needs config.offline_data")
        self._data, self._n, spec, low, high = load_continuous_dataset(config)
        self.learner = IQLLearner(spec, config, low, high, seed=config.seed)
        self.module = self.learner.module
        self._lr_schedule = self.learner.lr_schedule
        self._rng = np.random.default_rng(config.seed)
        self._updates = 0

    def training_step(self) -> Dict:
        return offline_training_step(self, lambda mb, i: self.learner.update(mb))

    def evaluate(self) -> Dict:
        return evaluate_continuous(self)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
