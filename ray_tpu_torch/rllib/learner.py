"""Torch learner stack: the port's counterpart of `ray_tpu/rllib/learner.py`
(reference: rllib/core/learner/learner.py and torch_learner.py).

A `TorchLearner` holds an RLModule's `PolicyValueNet` on one device
(`config.device`, "cuda" unless the config asks for the CPU) and an
optimizer from `ops/optim.make_optimizer`. One `update_once` runs forward,
loss, backward, the global-norm clip and the optimizer step, where JAX
runs one jitted program with donated params.

Metrics stay device tensors until `_host_metrics`, which reads every step
of an `update` in one copy to the host: one sync an update, not one a step.
`metrics["grad_norm"]` is the global norm before clipping, as JAX's
(`optax.global_norm(grads)`); `cur_lr` is schedule(n) for the n-th update.

JAX's dp learner group is one process over a {"dp": N} mesh; the port's
would be N ranks with a gradient all-reduce, a later slice (ROADMAP §A):
`num_learners > 1` raises `NotImplementedError`.
"""

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.optim import global_norm, make_optimizer
from .rl_module import RLModule
from .sample_batch import SampleBatch

_LATER = ("a data-parallel learner group (num_learners > 1) is a later slice of "
          "the port (ROADMAP.md §A, the dp learner group)")


class TorchLearner:
    """Base learner: subclass and implement `compute_loss`."""

    def __init__(self, module: RLModule, config, seed: int = 0):
        self.module = module
        self.config = config
        self.device = resolve_device(getattr(config, "device", "cuda"))
        self.net = module.make_net(seed, self.device)
        self._num_updates = 0
        self._reset_optimizer()

    def _reset_optimizer(self):
        cfg = self.config
        self.optimizer, self._lr_schedule = make_optimizer(
            self.net.parameters(), lr=getattr(cfg, "lr", 3e-4),
            lr_schedule=getattr(cfg, "lr_schedule", None),
            optimizer=getattr(cfg, "optimizer", "adam"),
            grad_clip=getattr(cfg, "grad_clip", None),
            weight_decay=getattr(cfg, "weight_decay", 0.0))

    # -- to implement --------------------------------------------------------
    def compute_loss(self, net, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    # -- update api ----------------------------------------------------------
    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's columns on the learner's device (tensors already there
        pass through)."""
        return SampleBatch(batch).to_device(self.device)

    def update_once(self, batch) -> Dict[str, Any]:
        """One SGD step on an (already minibatched) batch of numpy arrays or
        tensors. The metrics are device tensors, but for `cur_lr`."""
        batch = self.to_device(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.compute_loss(self.net, batch)
        loss.backward()
        grad_norm = global_norm(p.grad for p in self.net.parameters() if p.grad is not None)
        self.optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        metrics["cur_lr"] = float(self._lr_schedule(self._num_updates))
        self._num_updates += 1
        return metrics

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        """Full update (subclasses may do epochs and minibatches); returns
        host metrics averaged over the SGD steps."""
        return _host_metrics([self.update_once(dict(batch))])

    # -- weights -------------------------------------------------------------
    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The net's state_dict, copied to the CPU."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self.net.state_dict().items()}

    def set_weights(self, params):
        """Load a state_dict (on any device); the optimizer starts afresh,
        as JAX re-inits its opt_state."""
        self.net.load_state_dict(params)
        self._reset_optimizer()

    def get_state(self):
        """Params and optimizer state, copied to the CPU (Adam's moments are
        updated in place, so a state that shared them would move on)."""
        return {"params": self.get_weights(), "opt_state": _cpu_copy(self.optimizer.state_dict())}

    def set_state(self, state):
        self.net.load_state_dict(state["params"])
        self._reset_optimizer()
        self.optimizer.load_state_dict(state["opt_state"])


def _cpu_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree


def _scalar_metrics(step: Dict[str, Any]) -> Dict[str, Any]:
    """A step's metrics with each vector metric (DQN's `td_abs` [B]) as two
    scalars, `<name>_mean` and `<name>_max`."""
    out = {}
    for k, v in step.items():
        if isinstance(v, torch.Tensor) and v.ndim:
            out[f"{k}_mean"], out[f"{k}_max"] = v.float().mean(), v.float().max()
        else:
            out[k] = v
    return out


def _host_metrics(steps: List[Dict[str, Any]]) -> Dict[str, float]:
    """Mean of each metric over the steps (a vector metric as its mean and
    its max), the device tensors of every step read in one copy to the
    host."""
    if not steps:
        return {}
    steps = [_scalar_metrics(s) for s in steps]
    keys = list(steps[0])
    dev = [k for k in keys if isinstance(steps[0][k], torch.Tensor)]
    host = {}
    if dev:
        table = torch.stack([torch.stack([s[k].float() for k in dev]) for s in steps])
        host = dict(zip(dev, table.cpu().numpy().T))
    return {k: float(np.mean(host[k] if k in host else [s[k] for s in steps])) for k in keys}


class LearnerGroup:
    """The reference's learner group (rllib/core/learner/learner_group.py)
    over one local learner."""

    num_learners = 1

    def __init__(self, learner: TorchLearner):
        self.learner = learner

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self.learner.update(batch)

    # reference-API alias
    def update_from_batch(self, batch) -> Dict[str, float]:
        return self.update(batch)

    def foreach_learner(self, fn: Callable) -> list:
        return [fn(self.learner)]

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        self.learner.set_weights(w)

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state):
        self.learner.set_state(state)


def make_learner_group(learner_cls, module: RLModule, config, seed: int = 0) -> LearnerGroup:
    """A LearnerGroup from AlgorithmConfig.num_learners: 0 or 1 -> one local
    learner; more raises (see the module note)."""
    n = max(getattr(config, "num_learners", 0), 1)
    if n > 1:
        raise NotImplementedError(_LATER)
    return LearnerGroup(learner_cls(module, config, seed=seed))
