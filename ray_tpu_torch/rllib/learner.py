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
`jit_cache_size()` counts the distinct (column, shape, dtype) signatures
`update_once` has seen, where JAX counts its jitted update's compiled
variants: the recompile guard reads 1 under the fixed [T, B] contract.

The data-parallel group. JAX's group is one process over a {"dp": N}
mesh, where XLA inserts the gradient psum. The port's is N ranks, one a
card (NCCL; gloo on the CPU), every rank running the same program: the
same Algorithm, seeds and batches, and a learner given the {"dp": N}
mesh. Its `update_once` takes the whole minibatch, as JAX's does, drops
JAX's ragged remainder, keeps this rank's shard (`dp_shard`: rows of a
flat batch; learners with time-major batches shard the env axis), runs
forward and backward, all-reduces the mean of the gradients over the dp
group in one flat bucket, so that `grad_norm` and the optimizer's clip
see the global gradient, all-reduces the mean of the metrics in one more
call, and steps. Each rank's loss is a mean over equal shards of JAX's
global one, so the mean of the shards' gradients is its gradient. The
all-reduce hands every rank the same sum, so the params stay bitwise
equal across ranks. (The learners call `compute_loss(self.net, ...)`,
which may reach sub-methods of the net and so bypass DDP's hooks: the
all-reduce is explicit, after `backward()`.)
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.device import bind_card, resolve_device
from ray_tpu_torch.ops.optim import global_norm, make_optimizer
from .rl_module import RLModule
from .sample_batch import SampleBatch


class TorchLearner:
    """Base learner: subclass and implement `compute_loss`. With a `mesh`
    (a DeviceMesh with a "dp" axis, which this rank belongs to), each
    update is the dp group's (see the module note)."""

    def __init__(self, module: RLModule, config, mesh=None, seed: int = 0):
        self.module = module
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(getattr(config, "device", "cuda"))
        self.net = module.make_net(seed, self.device)
        self._num_updates = 0
        self._signatures = set()   # the inputs' (column, shape, dtype) sets seen
        self._dp = None
        self.dp_bytes = 0          # bytes all-reduced by the last dp update
        if mesh is not None:
            if mesh.get_coordinate() is None:
                raise ValueError(f"rank {dist.get_rank()} is not in the learners' dp mesh "
                                 f"{mesh.mesh.tolist()}")
            self._dp = (mesh.get_group("dp"), mesh.size(), mesh.get_local_rank("dp"))
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

    def dp_shard(self, batch, rank: int, n: int):
        """This rank's shard of a flat batch: rows rank * m / n to
        (rank + 1) * m / n of every column."""
        return {k: _rows(v, rank, n, 0) for k, v in batch.items()}

    def update_once(self, batch) -> Dict[str, Any]:
        """One SGD step on an (already minibatched) batch of numpy arrays or
        tensors. The metrics are device tensors, but for `cur_lr`. In a dp
        group the batch is the whole minibatch, and the step is the group's;
        a minibatch with fewer rows than learners returns {}, as JAX's."""
        self._signatures.add(tuple(sorted(
            (k, tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in batch.items())))
        if self._dp is not None:
            _, n, rank = self._dp
            rows = min(v.shape[0] for v in batch.values())
            if rows % n:
                # dp sharding needs a divisible leading dim; drop the
                # remainder rows, as JAX does (and the reference's ragged
                # minibatches)
                keep = rows - rows % n
                if keep == 0:
                    return {}
                batch = {k: v[:keep] for k, v in batch.items()}
            batch = self.dp_shard(batch, rank, n)
        batch = self.to_device(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.compute_loss(self.net, batch)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        if self._dp is not None:
            metrics = self._dp_mean(metrics)
        grad_norm = global_norm(p.grad for p in self.net.parameters() if p.grad is not None)
        self.optimizer.step()
        metrics["grad_norm"] = grad_norm
        metrics["cur_lr"] = float(self._lr_schedule(self._num_updates))
        self._num_updates += 1
        return metrics

    def jit_cache_size(self) -> int:
        """The number of distinct input signatures (columns, shapes,
        dtypes) the update has seen: JAX's recompile guard. Fixed-shape
        [T, B] batches make it 1 across a whole run; a second entry is a
        shape or dtype leak."""
        return len(self._signatures)

    @torch.no_grad()
    def _dp_mean(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The mean over the dp group of the gradients (one flat bucket,
        whose views become the params' .grad) and of the metrics (one more
        all-reduce); returns the metrics."""
        group, n, _ = self._dp
        params = [p for p in self.net.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=group)
        flat /= n
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)
        keys = list(metrics)
        table = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(table, group=group)
        table /= n
        self.dp_bytes = flat.numel() * flat.element_size() + table.numel() * table.element_size()
        return dict(zip(keys, table.unbind()))

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


def _rows(v, rank: int, n: int, axis: int):
    """Block `rank` of `n` equal blocks of `v` (numpy or tensor) on `axis`."""
    m = v.shape[axis]
    if m % n:
        raise ValueError(f"a dp shard needs axis {axis} of size {m} divisible by the "
                         f"{n} learners")
    size = m // n
    index = [slice(None)] * axis + [slice(rank * size, (rank + 1) * size)]
    return v[tuple(index)]


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
    """The reference's learner group (rllib/core/learner/learner_group.py):
    this rank's learner. With num_learners > 1 the learner holds the dp
    mesh and every rank of it runs the same calls (see the module note)."""

    def __init__(self, learner: TorchLearner, num_learners: int = 1):
        self.learner = learner
        self.num_learners = max(num_learners, 1)

    @property
    def mesh(self):
        return self.learner.mesh

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self.learner.update(batch)

    # reference-API alias
    def update_from_batch(self, batch) -> Dict[str, float]:
        return self.update(batch)

    def foreach_learner(self, fn: Callable) -> list:
        """fn on this rank's learner (each rank calls it on its own)."""
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
    learner; N > 1 -> this rank's learner on a {"dp": N} mesh over ranks
    0..N-1 of the world (the default process group, started as
    `parallel.mesh.ensure_world` starts it). Every rank of the world calls
    this; the learners start from the same seed, so from equal params. On
    `device="cuda"` each rank's learner sits on its own card (`bind_card`)."""
    n = max(getattr(config, "num_learners", 0), 1)
    mesh: Optional[Any] = None
    if n > 1:
        from ray_tpu_torch.parallel.mesh import ensure_world, make_mesh
        device = getattr(config, "device", "cuda")
        world = ensure_world(device)
        if n > world:
            raise ValueError(
                f"num_learners={n} but only {world} ranks in the world; a learner is "
                f"a rank of the dp mesh, one a card (start a world of {n} ranks, for "
                f"example with torchrun, or gloo ranks on device='cpu' for testing)")
        bind_card(device)
        mesh = make_mesh({"dp": n}, devices=range(n), device=device)
    return LearnerGroup(learner_cls(module, config, mesh=mesh, seed=seed), num_learners=n)
