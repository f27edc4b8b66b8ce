"""Small policy/value torsos for RL: the port's counterpart of
`ray_tpu/models/torsos.py` (reference: rllib catalog's MLP and CNN
encoders). f32; RL nets are small and run on whatever device the learner
or the rollout holds them.

Layout. Inputs are NHWC, as the reference's are. The convolutions run in
NCHW, so `CNNTorso` permutes in and, before flattening, back to NHWC: the
flattened features are then in flax's order, and `proj.weight` is flax's
kernel transposed and nothing else (`models/convert.py`).

Padding. flax's `nn.Conv` pads "SAME": the output is ceil(n / stride) and
the padding total (out - 1) * stride + k - n is split with the smaller
half before. At 84x84 the three convolutions give 21, 11 and 11, and the
second pads 1 before and 2 after; `nn.Conv2d(padding="same")` refuses a
stride above 1, so the pads are applied with `F.pad`.

Inputs are cast to the weights' dtype (f32 unless the module is cast).

Init. The MLP's Dense layers are orthogonal with gain sqrt(2), as the
reference's; the CNN's layers take flax's default, LeCun normal
(truncated at two standard deviations); biases start at 0. The values are
drawn from the `generator` given, so a seed fixes them; they are not
JAX's draws (weights carried from JAX go through `models/convert.py`).
"""

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's default kernel init: truncated normal (at +-2 std, rescaled to
    unit variance) with variance 1 / fan_in."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    return weight


def dense(n_in: int, n_out: int, gain: Optional[float] = None,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A Dense layer with a zero bias: orthogonal weight of `gain`, or LeCun
    normal without one."""
    layer = nn.Linear(n_in, n_out)
    if gain is None:
        lecun_normal_(layer.weight, generator)
    else:
        nn.init.orthogonal_(layer.weight, gain, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _param_dtype(module: nn.Module) -> torch.dtype:
    """The dtype the torso computes in: its weights' (f32 unless the caller
    casts the module), as flax's `dtype` field sets it."""
    return next(module.parameters(), torch.empty(0)).dtype


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under "SAME", as lax
    computes it."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class MLPTorso(nn.Module):
    """Flattens [N, ...] to [N, in_features] and applies Dense layers, each
    followed by `activation` (tanh by default)."""

    def __init__(self, in_features: int, hidden_sizes: Sequence[int] = (256, 256),
                 activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.out_features = in_features
        for i, size in enumerate(hidden_sizes):
            self.add_module(f"dense_{i}", dense(self.out_features, size, math.sqrt(2), generator))
            self.out_features = size
        self.n_layers = len(hidden_sizes)

    def forward(self, x):
        x = x.to(_param_dtype(self)).reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = self.activation(getattr(self, f"dense_{i}")(x))
        return x


class CNNTorso(nn.Module):
    """Conv stack for NHWC image observations (the Nature DQN torso by
    default), then one Dense layer of `hidden`. uint8 input is scaled to
    [0, 1]."""

    def __init__(self, obs_shape: Sequence[int],
                 channels: Sequence[int] = (32, 64, 64),
                 kernels: Sequence[Tuple[int, int]] = ((8, 8), (4, 4), (3, 3)),
                 strides: Sequence[Tuple[int, int]] = ((4, 4), (2, 2), (1, 1)),
                 hidden: int = 512, activation: Callable = torch.relu,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = obs_shape
        self.activation = activation
        self.pads = []
        for i, (ch, k, s) in enumerate(zip(channels, kernels, strides)):
            conv = nn.Conv2d(c, ch, k, s)
            lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
            self.add_module(f"conv_{i}", conv)
            (ph0, ph1), (pw0, pw1) = same_pads(h, k[0], s[0]), same_pads(w, k[1], s[1])
            self.pads.append((pw0, pw1, ph0, ph1))        # F.pad's order: W, then H
            h, w, c = -(-h // s[0]), -(-w // s[1]), ch
        self.n_convs = len(channels)
        self.proj = dense(h * w * c, hidden, None, generator)
        self.out_features = hidden

    def forward(self, x):
        dt = _param_dtype(self)
        if x.dtype == torch.uint8:
            x = x.to(dt) / 255.0
        x = x.to(dt).permute(0, 3, 1, 2)                  # NHWC -> NCHW
        for i in range(self.n_convs):
            x = self.activation(getattr(self, f"conv_{i}")(F.pad(x, self.pads[i])))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        return self.activation(self.proj(x))
