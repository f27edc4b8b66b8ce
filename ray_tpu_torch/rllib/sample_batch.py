"""SampleBatch, the rollout data container: the port's own copy of
`ray_tpu/rllib/sample_batch.py` (reference: rllib/policy/sample_batch.py).

A dict of numpy arrays under standard column names. Rollout batches are
[T, B, ...], time-major, so GAE and V-trace run over axis 0 without a
transpose; `flatten()` collapses them to [T*B, ...] for SGD minibatches.
`to_device` moves the columns to a torch device.
"""

from typing import Dict, Iterator, List, Union

import numpy as np
import torch

OBS = "obs"
NEXT_OBS = "next_obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
DONES = "dones"
LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
BOOTSTRAP_VALUE = "bootstrap_value"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        for v in self.values():
            if hasattr(v, "shape") and v.ndim >= 1:
                return int(np.prod(v.shape[:1]))
        return 0

    def flatten(self) -> "SampleBatch":
        """[T, B, ...] -> [T*B, ...] (skips scalar entries)."""
        out = SampleBatch()
        for k, v in self.items():
            v = np.asarray(v)
            out[k] = v.reshape((-1,) + v.shape[2:]) if v.ndim >= 2 else v
        return out

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(self.count)
        return SampleBatch({k: np.asarray(v)[perm] if np.asarray(v).ndim >= 1
                            else v for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for i in range(0, n - size + 1, size):
            yield SampleBatch({k: np.asarray(v)[i:i + size]
                               if np.asarray(v).ndim >= 1 else v
                               for k, v in self.items()})

    @staticmethod
    def concat(batches: List["SampleBatch"], axis: int = 1) -> "SampleBatch":
        """Concat rollouts from several runners along the env/batch axis."""
        if len(batches) == 1:
            return batches[0]
        out = SampleBatch()
        for k in batches[0].keys():
            vs = [np.asarray(b[k]) for b in batches]
            out[k] = (np.concatenate(vs, axis=axis if vs[0].ndim > axis else 0)
                      if vs[0].ndim >= 1 else vs[0])
        return out

    def to_device(self, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
        """The columns (numpy arrays or tensors) as tensors on `device`;
        float64 columns become float32, as JAX's device_put makes them
        without x64."""
        out = {}
        for k, v in self.items():
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            out[k] = t.to(device, torch.float32 if t.dtype == torch.float64 else t.dtype)
        return out
