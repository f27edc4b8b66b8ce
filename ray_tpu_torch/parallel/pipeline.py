"""Pipeline parallelism over a mesh `pp` axis: the port's counterpart of
`ray_tpu/parallel/pipeline.py` (the GPipe schedule as one SPMD program).

M microbatches through S stages take M + S - 1 ticks. At tick t stage 0
takes microbatch min(t, M - 1), every other stage the activation its
predecessor sent at t - 1, and the last stage writes output t - (S - 1)
once t >= S - 1. The activation moves one stage on by
`xla_ops.ppermute_shift`, and the outputs are psum'd so every stage
returns them.

Where the port differs from JAX's `shard_map` form: each rank is one
stage and holds only its own stage's parameters (`shard_pipeline_params`
gives its [1, ...] slice of the stacked tree), and calls `pipeline_apply`
with the mesh. Gradients flow through it: `ppermute_shift`'s backward
shifts the cotangent back and `psum`'s is the identity, so a loss taken
alike on every rank from the outputs gives each rank JAX's gradient for
its own stage. Every rank's graph holds the same shifts (stage 0 keeps
the activation it ignores through `torch.where`, and the stages that do
not write outputs keep theirs zeroed, as JAX's program does), so every
rank runs the backward's shifts in the same order.

A parameter tree is a dict, list or tuple of tensors
(`torch.utils._pytree`).
"""

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ray_tpu_torch.parallel import xla_ops


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor, mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run microbatches through the S stages of the `axis` axis of `mesh`.

    stage_fn: (params, x) -> y, one shape for x and y (stages 0 and S-1
      project in and out themselves).
    stage_params: this rank's stage, a tree whose leaves have a leading
      dimension of 1 (`shard_pipeline_params`).
    microbatches: [M, ...], the same on every rank; every microbatch
      enters stage 0.
    Returns the last stage's [M, ...] outputs, on every rank of the axis.
    Every rank of the axis calls it together.
    """
    n_stages = xla_ops.axis_size(axis, mesh)
    n_micro = microbatches.shape[0]
    params = pytree.tree_map(lambda p: p[0], stage_params)
    stage = xla_ops.axis_index(axis, mesh)
    dev = microbatches.device
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = stage == n_stages - 1

    buf = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        inp = torch.where(is_first, microbatches[min(t, n_micro - 1)], buf)
        y = stage_fn(params, inp)
        out_idx = min(max(t - (n_stages - 1), 0), n_micro - 1)
        take = torch.tensor(is_last and t >= n_stages - 1, device=dev)
        outs[out_idx] = torch.where(take, y, outs[out_idx])
        if t < n_micro + n_stages - 2:    # the last tick's shift reaches no one
            buf = xla_ops.ppermute_shift(y, axis, mesh, 1)
    # only the last stage wrote its outputs; psum replicates them
    outs = torch.stack(outs)
    outs = torch.where(torch.tensor(is_last, device=dev), outs, torch.zeros_like(outs))
    return xla_ops.psum(outs, axis, mesh)


def make_microbatches(batch: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got "
                         f"{num_microbatches}")
    B = batch.shape[0]
    if B % num_microbatches:
        raise ValueError(
            f"batch size {B} (batch shape {tuple(batch.shape)}) is not "
            f"divisible by num_microbatches={num_microbatches}: "
            f"{B} % {num_microbatches} == {B % num_microbatches} rows "
            f"would be dropped — pad or resize the batch")
    return batch.reshape((num_microbatches, B // num_microbatches) + tuple(batch.shape[1:]))


def stack_stage_params(params_list):
    """List of per-stage trees (one structure) -> one tree whose leaves
    have a leading S dimension."""
    leaves, spec = zip(*(pytree.tree_flatten(p) for p in params_list))
    return pytree.tree_unflatten([torch.stack(ps) for ps in zip(*leaves)], spec[0])


def shard_pipeline_params(stacked, mesh, axis: str = "pp"):
    """This rank's [1, ...] slice of every leaf of the stacked tree: the
    stage at its index on `axis`."""
    i = xla_ops.axis_index(axis, mesh)
    return pytree.tree_map(lambda p: p[i:i + 1], stacked)
