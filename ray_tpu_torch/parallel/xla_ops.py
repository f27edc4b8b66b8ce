"""Collective primitives over one axis of a device mesh: the port's
counterpart of `ray_tpu/parallel/xla_ops.py` (the file keeps its name so
a reader finds it).

JAX calls these inside `shard_map`, where each shard sees its block and
the mesh is implied. Here each rank calls them on its local tensor, and
the mesh is an explicit argument: an op runs over the process group of
`axis` (`mesh.get_group(axis)`) through
`torch.distributed._functional_collectives`, on the current stream, and
returns a new tensor, also on an axis of size 1. Every rank of the axis's
group must make the same calls in the same order.

`ppermute_shift` is a pair of point-to-point ops (`batch_isend_irecv`):
the functional `permute_tensor` is an all-to-all with empty splits, which
gloo refuses. A mesh on cards runs over NCCL (one rank per card); gloo
groups hold CPU tensors.

Gradients. JAX differentiates through its collectives; here `psum` and
`ppermute_shift` are `torch.autograd.Function`s with JAX's results:
- `ppermute_shift`'s backward shifts the cotangent by -shift (the
  transpose of `ppermute`);
- `psum`'s backward is the identity on each rank's cotangent (Megatron's
  "g" operator): a loss computed alike on every rank from a psum'd value
  gets JAX's gradient, not the axis size times it, which is what
  `torch.distributed.nn.functional.all_reduce`'s summing backward gives.
A backward that shifts is a collective too: every rank of the axis must
run the same backward ops in the same order, so each rank's graph must
hold the same shifts (a stage that ignores what it received keeps it in
its graph with `torch.where`, as `parallel/pipeline.py` does). The other
ops carry no gradient.
"""

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.distributed.device_mesh import DeviceMesh

# torch 2.13 renames all_gather_tensor and reduce_scatter_tensor (same
# arguments) and deprecates the old names; torch 2.11 has only the old ones
_all_gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
_reduce_scatter = getattr(fc, "reduce_scatter_single", fc.reduce_scatter_tensor)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def axis_size(axis: str, mesh: DeviceMesh) -> int:
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(axis: str, mesh: DeviceMesh) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _wait(fc.all_reduce(x, "sum", mesh.get_group(axis)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, axis: str, mesh: DeviceMesh) -> torch.Tensor:
    """The sum over the axis, on every rank; its gradient is the identity
    (module docstring)."""
    return _PSum.apply(x, axis, mesh)


def pmean(x: torch.Tensor, axis: str, mesh: DeviceMesh) -> torch.Tensor:
    return psum(x, axis, mesh) / axis_size(axis, mesh)


def pmax(x: torch.Tensor, axis: str, mesh: DeviceMesh) -> torch.Tensor:
    return _wait(fc.all_reduce(x, "max", mesh.get_group(axis)))


def pmin(x: torch.Tensor, axis: str, mesh: DeviceMesh) -> torch.Tensor:
    """Not in JAX's xla_ops; `collective.XlaGroup` reduces MIN with it."""
    return _wait(fc.all_reduce(x, "min", mesh.get_group(axis)))


def all_gather(x: torch.Tensor, axis: str, mesh: DeviceMesh, *, tiled: bool = True,
               gather_axis: int = 0) -> torch.Tensor:
    """The ranks' blocks in axis order, concatenated along `gather_axis`
    (tiled) or stacked on a new axis there."""
    if not tiled:
        x = x.unsqueeze(gather_axis)
    gather_axis %= x.ndim
    return _wait(_all_gather(x.contiguous(), gather_axis, mesh.get_group(axis)))


def reduce_scatter(x: torch.Tensor, axis: str, mesh: DeviceMesh, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """Block i (along `scatter_axis`) of the sum over the axis, on the rank
    at index i."""
    scatter_axis %= x.ndim
    n = axis_size(axis, mesh)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"axis {scatter_axis} of {tuple(x.shape)} does not split into "
                         f"{n} blocks")
    return _wait(_reduce_scatter(x.contiguous(), "sum", scatter_axis, mesh.get_group(axis)))


def _shift(x: torch.Tensor, axis: str, mesh: DeviceMesh, shift: int) -> torch.Tensor:
    n = axis_size(axis, mesh)
    if shift % n == 0:
        return x.clone()
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    i = axis_index(axis, mesh)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermuteShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, shift):
        ctx.axis, ctx.mesh, ctx.shift = axis, mesh, shift
        return _shift(x, axis, mesh, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, ctx.mesh, -ctx.shift), None, None, None


def ppermute_shift(x: torch.Tensor, axis: str, mesh: DeviceMesh,
                   shift: int = 1) -> torch.Tensor:
    """Ring shift by `shift` along the axis: the rank at index i receives
    the block of index (i - shift) mod n (ring attention's data motion). A
    shift by a multiple of n is a copy. Its gradient is the cotangent
    shifted by -shift."""
    return _PPermuteShift.apply(x, axis, mesh, shift)


def all_to_all(x: torch.Tensor, axis: str, mesh: DeviceMesh, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all: block j of `x` along `split_axis` goes to the rank
    at index j; the blocks received are concatenated along `concat_axis`
    in index order."""
    n = axis_size(axis, mesh)
    split_axis %= x.ndim
    concat_axis %= x.ndim
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split into "
                         f"{n} blocks")
    blocks = torch.stack(x.chunk(n, dim=split_axis))        # [n, ...block]
    blocks = _wait(fc.all_to_all_single(blocks.contiguous(), None, None, mesh.get_group(axis)))
    return torch.cat(list(blocks), dim=concat_axis)
