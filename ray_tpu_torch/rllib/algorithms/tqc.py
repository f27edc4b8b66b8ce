"""TQC, Truncated Quantile Critics: the port's counterpart of
`ray_tpu/rllib/algorithms/tqc.py` (reference: rllib/algorithms/tqc/;
arXiv:2005.04269).

SAC with distributional critics: `n_critics` nets each emit `n_quantiles`
atoms of Z(s, a). The Bellman target pools every target atom at
(s', a' ~ pi), sorts them and drops the top
`top_quantiles_to_drop_per_net * n_critics`; the critics fit the kept
atoms by quantile Huber regression; the actor maximizes the mean of all
atoms less the entropy bonus; the temperature tunes as in SAC.

The ensemble is stacked as JAX's vmapped params are: one module whose
layers hold kernels [n_critics, in, out] and biases [n_critics, out],
applied with `torch.baddbmm` (one batched product a layer, no loop over
nets), keeping flax's [in, out] kernel layout. `z_all` returns
[B, n_critics, n_quantiles]. One Adam state covers the stacked critics.
Draws as SAC's: `noise={"next", "pi"}` replays JAX's k1 and k2.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.models.torsos import dense
from .. import sample_batch as SB
from ..rl_module import ModuleSpec
from ..sample_batch import SampleBatch
from .sac import (SAC, SACConfig, SACLearner, SACModule, _Actor, frozen_copy, polyak_,
                  step_on)


class _StackedDense(nn.Module):
    """n Dense layers applied at once: x [n, B, in] -> [n, B, out]."""

    def __init__(self, layers):
        super().__init__()
        self.kernel = nn.Parameter(torch.stack([l.weight.detach().t() for l in layers]))
        self.bias = nn.Parameter(torch.stack([l.bias.detach() for l in layers]))

    def forward(self, x):
        return torch.baddbmm(self.bias[:, None, :], x, self.kernel)


class _QuantileCritics(nn.Module):
    """(obs, action) -> atoms [n_critics, B, n_quantiles]: each critic an
    MLP torso (tanh, orthogonal sqrt(2) init) and a LeCun-normal head `z`."""

    def __init__(self, spec: ModuleSpec, n_quantiles: int, n_critics: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_critics = n_critics
        self.torso = nn.Module()
        n_in = int(np.prod(spec.obs_shape)) + spec.action_dim
        for i, size in enumerate(spec.hiddens):
            self.torso.add_module(f"dense_{i}", _StackedDense(
                [dense(n_in, size, math.sqrt(2), generator) for _ in range(n_critics)]))
            n_in = size
        self.n_layers = len(spec.hiddens)
        self.z = _StackedDense([dense(n_in, n_quantiles, None, generator)
                                for _ in range(n_critics)])

    def forward(self, obs, action):
        x = torch.cat([obs.reshape(obs.shape[0], -1), action], -1)
        x = x.expand(self.n_critics, *x.shape)
        for i in range(self.n_layers):
            x = torch.tanh(getattr(self.torso, f"dense_{i}")(x))
        return self.z(x)


class TQCNet(nn.Module):
    """JAX's TQC weight dict `{actor, critics, critics_target, log_alpha}`
    as one module."""

    def __init__(self, spec: ModuleSpec, n_quantiles: int, n_critics: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.actor = _Actor(spec, generator)
        self.critics = _QuantileCritics(spec, n_quantiles, n_critics, generator)
        self.critics_target = frozen_copy(self.critics)
        self.log_alpha = nn.Parameter(torch.zeros(()))


class TQCModule(SACModule):
    """SAC's acting surface over a TQC net."""

    def __init__(self, spec: ModuleSpec, low: float, high: float,
                 n_quantiles: int = 25, n_critics: int = 2):
        super().__init__(spec, low, high)
        self.n_quantiles = n_quantiles
        self.n_critics = n_critics

    def make_net(self, seed: int = 0, device="cpu") -> TQCNet:
        return TQCNet(self.spec, self.n_quantiles, self.n_critics,
                      torch.Generator().manual_seed(seed)).to(device)

    @staticmethod
    def z_all(critics: nn.Module, obs, action):
        """Every critic's atoms: [B, n_critics, n_quantiles]."""
        return critics(obs, action).transpose(0, 1)


class TQCConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = TQC
        self.n_quantiles = 25                    # the reference's tqc.py:52
        self.n_critics = 2
        self.top_quantiles_to_drop_per_net = 2


class TQCLearner(SACLearner):
    OPTIMIZED = {"actor": ("actor",), "critics": ("critics",), "alpha": ("log_alpha",)}

    def __init__(self, spec: ModuleSpec, config, low: float = -1.0, high: float = 1.0,
                 seed: int = 0):
        m, n = config.n_quantiles, config.n_critics
        self.n_keep = n * m - n * config.top_quantiles_to_drop_per_net
        if self.n_keep <= 0:
            raise ValueError("top_quantiles_to_drop_per_net drops every atom")
        super().__init__(spec, config, low, high, seed)
        # quantile midpoints tau_i = (2i + 1) / 2M, one an atom
        self.taus = (torch.arange(m, dtype=torch.float32, device=self.device) + 0.5) / m

    def make_module(self, spec, low, high):
        return TQCModule(spec, low, high, self.config.n_quantiles, self.config.n_critics)

    def quantile_huber(self, z, target):
        """z [B, C, M] against target [B, K] -> [C]: a critic's loss is the
        batch mean of the sum over atoms of the mean over targets of the
        asymmetric (kappa 1) Huber."""
        delta = target[:, None, None, :] - z[..., None]             # [B, C, M, K]
        a = delta.abs()
        huber = torch.where(a <= 1.0, 0.5 * delta * delta, a - 0.5)
        wgt = (self.taus[None, None, :, None] - (delta < 0).float()).abs()
        return (wgt * huber).mean(3).sum(2).mean(0)

    def update(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        b = SampleBatch(batch).to_device(self.device)
        noise = self.device_noise(noise)
        cfg, net, z_all = self.config, self.net, self.module.z_all
        obs, act, nxt = b[SB.OBS], b[SB.ACTIONS], b[SB.NEXT_OBS]
        alpha = net.log_alpha.detach().exp()
        with torch.no_grad():   # the truncated distributional target
            a_n, logp_n = self.sample(nxt, noise.get("next"))
            z_n = z_all(net.critics_target, nxt, a_n)
            z_keep = torch.sort(z_n.reshape(z_n.shape[0], -1), dim=-1).values[:, :self.n_keep]
            target = b[SB.REWARDS][:, None] + cfg.gamma * (1 - b[SB.TERMINATEDS])[:, None] * (
                z_keep - alpha * logp_n[:, None])
        lz = self.quantile_huber(z_all(net.critics, obs, act), target).sum()
        step_on(self.optimizers["critics"], self.params["critics"], lz)

        # the actor: the mean of all atoms (no truncation on the policy side)
        a, logp = self.sample(obs, noise.get("pi"))
        la = (alpha * logp - z_all(net.critics, obs, a).mean((1, 2))).mean()
        step_on(self.optimizers["actor"], self.params["actor"], la)
        new_alpha = self.step_alpha(logp)
        polyak_(net.critics_target.parameters(), net.critics.parameters(), cfg.tau)
        return {"critic_loss": lz.detach() / cfg.n_critics, "actor_loss": la.detach(),
                "alpha": new_alpha, "entropy": -logp.detach().mean(),
                "z_target_mean": z_keep.mean()}


class TQC(SAC):
    """SAC's setup, replay loop and weights surface over a TQCLearner."""

    learner_class = TQCLearner
