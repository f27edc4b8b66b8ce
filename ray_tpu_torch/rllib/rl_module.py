"""RLModule: policy/value network plus action-distribution glue, the port's
counterpart of `ray_tpu/rllib/rl_module.py` (reference:
rllib/core/rl_module/rl_module.py and the catalog).

The catalog picks the torso (MLP for flat obs, CNN for [H, W, C] obs) and
the head for the action space (Discrete: Categorical logits; Box: a mean
and a learned, state-independent log_std).

JAX's module is stateless: params are passed in. Here `PolicyValueNet` is
an `nn.Module` that holds them, and `RLModule`'s steps take either such a
net or a state_dict of one (run through `torch.func.functional_call` on a
template net), so a learner passes its net and a caller may pass weights.
Submodule names: `torso` (flax's `MLPTorso_0` or `CNNTorso_0`), `pi`,
`vf`, and the top-level `log_std` for continuous actions.
"""

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.models.torsos import CNNTorso, MLPTorso, dense
from .distributions import Categorical, DiagGaussian


@dataclasses.dataclass
class ModuleSpec:
    """What the catalog derived from the spaces (pickles cleanly to actors)."""
    obs_shape: Tuple[int, ...]
    action_kind: str          # "discrete" | "continuous"
    action_dim: int
    hiddens: Sequence[int] = (256, 256)
    use_cnn: bool = False
    free_log_std: bool = True

    @staticmethod
    def from_spaces(obs_space, action_space, hiddens=(256, 256)) -> "ModuleSpec":
        import gymnasium as gym
        obs_shape = tuple(obs_space.shape)
        use_cnn = len(obs_shape) == 3
        if isinstance(action_space, gym.spaces.Discrete):
            return ModuleSpec(obs_shape, "discrete", int(action_space.n), hiddens, use_cnn)
        if isinstance(action_space, gym.spaces.Box):
            return ModuleSpec(obs_shape, "continuous", int(np.prod(action_space.shape)),
                              hiddens, use_cnn)
        raise ValueError(f"unsupported action space {action_space}")


class PolicyValueNet(nn.Module):
    """Shared-torso actor-critic net: obs [N, *obs_shape] -> (dist_inputs,
    value [N]). The `pi` head is orthogonal with gain 0.01, `vf` with 1.0."""

    def __init__(self, spec: ModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        if spec.use_cnn:
            self.torso = CNNTorso(spec.obs_shape, generator=generator)
        else:
            self.torso = MLPTorso(int(np.prod(spec.obs_shape)), spec.hiddens,
                                  generator=generator)
        z = self.torso.out_features
        self.pi = dense(z, spec.action_dim, 0.01, generator)
        self.continuous = spec.action_kind == "continuous" and spec.free_log_std
        if self.continuous:
            self.log_std = nn.Parameter(torch.zeros(spec.action_dim))
        self.vf = dense(z, 1, 1.0, generator)

    def forward(self, obs):
        z = self.torso(obs)
        dist_in = self.pi(z)
        if self.continuous:
            dist_in = torch.cat([dist_in, self.log_std.expand_as(dist_in)], -1)
        return dist_in, self.vf(z)[..., 0]


Net = Union[nn.Module, Dict[str, torch.Tensor]]


class RLModule:
    """Builds nets for a spec and runs them: forward, one acting step,
    greedy inference."""

    def __init__(self, spec: ModuleSpec):
        self.spec = spec
        self._template = None     # a net whose params functional_call replaces

    def make_net(self, seed: int = 0, device="cpu") -> PolicyValueNet:
        """A freshly initialized net, its draws from a generator seeded with
        `seed`, on `device`."""
        return PolicyValueNet(self.spec, torch.Generator().manual_seed(seed)).to(device)

    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Fresh params (the state_dict of `make_net(seed)`), on the CPU."""
        return self.make_net(seed).state_dict()

    def dist(self, dist_inputs: torch.Tensor):
        if self.spec.action_kind == "discrete":
            return Categorical(dist_inputs)
        mean, log_std = torch.chunk(dist_inputs, 2, dim=-1)
        return DiagGaussian(mean, log_std)

    def _apply(self, net: Net, flat):
        if isinstance(net, nn.Module):
            return net(flat)
        if self._template is None:
            self._template = PolicyValueNet(self.spec)
        return torch.func.functional_call(self._template, net, (flat,))

    def forward(self, net: Net, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [..., *obs_shape] -> (dist_inputs, value); flattens the
        leading dims, so [T, B, ...] rollouts need no reshape."""
        lead = obs.shape[: obs.ndim - len(self.spec.obs_shape)]
        dist_in, value = self._apply(net, obs.reshape((-1,) + tuple(self.spec.obs_shape)))
        return dist_in.reshape(lead + dist_in.shape[1:]), value.reshape(lead)

    def explore_step(self, net: Net, obs, generator: torch.Generator):
        """One acting step: (sampled action, its log-prob, value)."""
        dist_in, value = self.forward(net, obs)
        dist = self.dist(dist_in)
        action = dist.sample(generator)
        return action, dist.log_prob(action), value

    def inference_step(self, net: Net, obs):
        dist_in, value = self.forward(net, obs)
        return self.dist(dist_in).mode(), value
