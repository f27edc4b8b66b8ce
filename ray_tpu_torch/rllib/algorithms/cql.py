"""CQL, Conservative Q-Learning: the port's counterpart of
`ray_tpu/rllib/algorithms/cql.py` (reference: rllib/algorithms/cql/cql.py,
a conservative penalty over SAC's twin critics, trained from offline data
only).

`CQLLearner` is `SACLearner` with two changes inside the update:
- each critic's loss gains the CQL(H) term
  `cql_alpha * mean(logsumexp_a Q(s, a) - Q(s, a_data))`, the logsumexp
  taken over `num_cql_actions` uniform actions (less the uniform's
  log-density), policy actions at s and policy actions at s' (each less
  its log-prob), all scored at s;
- during the first `bc_iters` updates the actor's loss is behaviour
  cloning (-mean log pi(a_data | s)).
Its optimizers take the config's lr schedule, optimizer and grad clip.

Random draws. JAX splits five keys from `PRNGKey(seed * 100_003 + i)`:
the target's action at s' (normal [B, A]), the actor's at s ([B, A]),
the uniform actions ([N B, A] in [low, high]), and the policy's actions
at the repeated s and s' ([N B, A] each). `update` takes them as
`noise={"next", "pi", "rand", "pi_rep", "pin_rep"}` ("rand" holds the
uniform actions themselves); without them it draws its own. Rows repeat
state-major, s0 N times then s1 (`jnp.repeat` is `repeat_interleave`).
"""

from typing import Dict, Optional

import numpy as np
import torch

from .. import sample_batch as SB
from ..algorithm import Algorithm
from ..sample_batch import SampleBatch
from .offline_utils import (evaluate_continuous, load_continuous_dataset,
                            make_offline_optimizer, offline_training_step)
from .sac import SACConfig, SACLearner, polyak_, step_on


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.offline_data = None
        self.cql_alpha = 1.0          # min_q_weight
        self.num_cql_actions = 4      # sampled actions a source (rand / pi / pi')
        self.bc_iters = 0             # actor log-prob warm-start updates
        self.train_intensity = 8      # SGD steps a train() call
        self.action_low = None        # None -> inferred from the dataset
        self.action_high = None

    def offline_data_source(self, data):
        self.offline_data = data
        return self


class CQLLearner(SACLearner):
    def __init__(self, spec, config, low: float = -1.0, high: float = 1.0, seed: int = 0):
        super().__init__(spec, config, low, high, seed)
        # log-density of the uniform proposal, for the importance weights
        self.log_u = -spec.action_dim * float(np.log(max(high - low, 1e-8)))

    def new_optimizer(self, params):
        return make_offline_optimizer(self.config, params)

    def _draws(self, b, noise):
        n_act, d = self.config.num_cql_actions, self.module.spec.action_dim
        shape = (n_act * b, d)
        out = dict(noise)
        if "rand" not in out:
            low, high = self.module.low, self.module.high
            out["rand"] = low + (high - low) * torch.rand(shape, generator=self.generator,
                                                          device=self.device)
        for k in ("pi_rep", "pin_rep"):
            if k not in out:
                out[k] = torch.randn(shape, generator=self.generator, device=self.device)
        return out

    def update(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None,
               bc_phase: bool = False) -> Dict[str, torch.Tensor]:
        b = SampleBatch(batch).to_device(self.device)
        cfg, net = self.config, self.net
        obs, act, nxt = b[SB.OBS], b[SB.ACTIONS], b[SB.NEXT_OBS]
        n, n_act = obs.shape[0], cfg.num_cql_actions
        noise = self._draws(n, self.device_noise(noise))
        alpha = net.log_alpha.detach().exp()
        target = self.critic_target(b, alpha, noise)

        # the conservative term's inputs, shared by both critics
        obs_rep = obs.repeat_interleave(n_act, dim=0)
        with torch.no_grad():
            a_pi, logp_pi = self.sample(obs_rep, noise["pi_rep"])
            a_pin, logp_pin = self.sample(nxt.repeat_interleave(n_act, dim=0), noise["pin_rep"])
        a_rand = noise["rand"]

        def q_loss(q):
            q_data = q(obs, act)
            bellman = (q_data - target).square().mean()
            shape = (n, n_act)
            cat = torch.cat([q(obs_rep, a_rand).reshape(shape) - self.log_u,
                             q(obs_rep, a_pi).reshape(shape) - logp_pi.reshape(shape),
                             q(obs_rep, a_pin).reshape(shape) - logp_pin.reshape(shape)], dim=1)
            gap = torch.logsumexp(cat, dim=1) - q_data
            return bellman + cfg.cql_alpha * gap.mean(), gap.mean()

        l1, gap1 = q_loss(net.q1)
        l2, _ = q_loss(net.q2)
        self.step_critics(l1, l2)

        # the actor: SAC's objective, or behaviour cloning while warming up
        dist = self.module.dist(net.actor, obs)
        a, logp = dist.sample_and_log_prob(self.generator, noise.get("pi"))
        if bc_phase:
            la = -dist.log_prob(act).mean()
        else:
            la = (alpha * logp - torch.minimum(net.q1(obs, a), net.q2(obs, a))).mean()
        step_on(self.optimizers["actor"], self.params["actor"], la)
        new_alpha = self.step_alpha(logp)
        polyak_(net.q1_target.parameters(), net.q1.parameters(), cfg.tau)
        polyak_(net.q2_target.parameters(), net.q2.parameters(), cfg.tau)
        return {"critic_loss": 0.5 * (l1 + l2).detach(), "actor_loss": la.detach(),
                "cql_penalty": gap1.detach(), "alpha": new_alpha,
                "entropy": -logp.detach().mean()}


class CQL(Algorithm):
    # its weights are SAC's nets, which a generic EnvRunner cannot act
    # with: evaluate() is this class's own inline loop
    _supports_eval_actors = False

    def setup(self, config: CQLConfig):
        if config.offline_data is None:
            raise ValueError("CQL needs config.offline_data")
        self._data, self._n, spec, low, high = load_continuous_dataset(config)
        self.learner = CQLLearner(spec, config, low, high, seed=config.seed)
        self.module = self.learner.module
        self._lr_schedule = self.learner.lr_schedule
        self._rng = np.random.default_rng(config.seed)
        self._updates = 0

    def training_step(self) -> Dict:
        bc_iters = self.config.bc_iters
        return offline_training_step(
            self, lambda mb, i: self.learner.update(mb, bc_phase=i < bc_iters))

    def evaluate(self) -> Dict:
        return evaluate_continuous(self)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
