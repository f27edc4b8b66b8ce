"""Action distributions: the port's counterpart of
`ray_tpu/rllib/distributions.py` (reference:
rllib/models/torch/torch_distributions.py).

Each distribution is a thin struct over its parameters, vectorized over
leading batch dims. Sampling takes an explicit `torch.Generator` on the
parameters' device, where JAX takes a key.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2 * math.pi)


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits  # [..., n]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Gumbel-max draw, as jax.random.categorical makes it: argmax of
        logits - log(E), E ~ Exp(1)."""
        e = torch.empty_like(self.logits).exponential_(generator=generator)
        return torch.argmax(self.logits - torch.log(e), dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(self.logits, dim=-1)
        return logp.gather(-1, x.long()[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = F.log_softmax(self.logits, dim=-1)
        return -(logp.exp() * logp).sum(-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        logp = F.log_softmax(self.logits, dim=-1)
        logq = F.log_softmax(other.logits, dim=-1)
        return (logp.exp() * (logp - logq)).sum(-1)


class DiagGaussian:
    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor):
        self.mean = mean
        self.log_std = torch.broadcast_to(log_std, mean.shape)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                            device=self.mean.device)
        return self.mean + torch.exp(self.log_std) * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2 * self.log_std)
        ll = -0.5 * ((x - self.mean).square() / var + 2 * self.log_std + _LOG_2PI)
        return ll.sum(-1)

    def entropy(self) -> torch.Tensor:
        return (self.log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        var, ovar = torch.exp(2 * self.log_std), torch.exp(2 * other.log_std)
        return (other.log_std - self.log_std
                + (var + (self.mean - other.mean).square()) / (2 * ovar) - 0.5).sum(-1)


class SquashedGaussian:
    """tanh-squashed Gaussian for bounded continuous actions (SAC)."""

    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor,
                 low: float = -1.0, high: float = 1.0):
        self.base = DiagGaussian(mean, torch.clamp(log_std, -20.0, 2.0))
        self.low, self.high = low, high

    def _squash(self, u):
        return self.low + (torch.tanh(u) + 1.0) * 0.5 * (self.high - self.low)

    def _log_prob_u(self, u):
        # log det of tanh plus the affine map, in the softplus form
        correction = (2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u))).sum(-1)
        scale = math.log((self.high - self.low) * 0.5 + 1e-8)
        return self.base.log_prob(u) - correction - scale * u.shape[-1]

    def sample_and_log_prob(self, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        u = self.base.sample(generator)
        return self._squash(u), self._log_prob_u(u)

    def log_prob(self, a: torch.Tensor) -> torch.Tensor:
        """Density of a squashed action (inverse tanh), clipped inside the
        open interval so atanh stays finite on boundary actions."""
        t = 2.0 * (a - self.low) / (self.high - self.low) - 1.0
        return self._log_prob_u(torch.atanh(torch.clamp(t, -1.0 + 1e-6, 1.0 - 1e-6)))

    def mode(self) -> torch.Tensor:
        return self._squash(self.base.mean)
