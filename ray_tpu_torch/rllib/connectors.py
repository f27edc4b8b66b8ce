"""Connectors: batch processing between the rollout and the learner, the
port's counterpart of `ray_tpu/rllib/connectors.py` (reference:
rllib/connectors; GAE in rllib/evaluation/postprocessing.py).

`compute_gae` runs the port's `ops.losses.gae` over the time axis of a
[T, B] batch on the host CPU, where the batch is, and writes numpy back
into the batch, as JAX's does after its jitted scan.
"""

import numpy as np
import torch

from ray_tpu_torch.ops.losses import gae as _gae
from . import sample_batch as SB
from .sample_batch import SampleBatch


def compute_gae(batch: SampleBatch, gamma: float = 0.99, lam: float = 0.95) -> SampleBatch:
    """Add ADVANTAGES and VALUE_TARGETS to a [T, B] rollout batch.

    Needs VF_PREDS [T, B], BOOTSTRAP_VALUE [B] (value of the obs after the
    last step, zeroed where terminated), DONES [T, B].
    """
    col = lambda k: torch.as_tensor(np.asarray(batch[k], np.float32))
    values = torch.cat([col(SB.VF_PREDS), col(SB.BOOTSTRAP_VALUE)[None]], 0)  # [T+1, B]
    adv, targets = _gae(col(SB.REWARDS), values, col(SB.DONES), gamma, lam)
    batch[SB.ADVANTAGES] = adv.numpy()
    batch[SB.VALUE_TARGETS] = targets.numpy()
    return batch


def standardize_advantages(batch: SampleBatch) -> SampleBatch:
    adv = np.asarray(batch[SB.ADVANTAGES])
    batch[SB.ADVANTAGES] = (adv - adv.mean()) / (adv.std() + 1e-8)
    return batch


class RunningMeanStd:
    """Streaming obs normalizer (reference: rllib MeanStdFilter)."""

    def __init__(self, shape):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = 1e-4

    def update(self, x: np.ndarray):
        x = x.reshape((-1,) + self.mean.shape)
        b_mean, b_var, b_count = x.mean(0), x.var(0), x.shape[0]
        delta = b_mean - self.mean
        tot = self.count + b_count
        self.mean = self.mean + delta * b_count / tot
        m_a = self.var * self.count
        m_b = b_var * b_count
        self.var = (m_a + m_b + np.square(delta) * self.count * b_count / tot) / tot
        self.count = tot

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mean) / np.sqrt(self.var + 1e-8)).astype(np.float32)

    def state(self):
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def set_state(self, s):
        self.mean, self.var, self.count = s["mean"], s["var"], s["count"]
