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

Gradients. JAX differentiates through its collectives; here each op
that a model differentiates is a `torch.autograd.Function` with the
transpose JAX's autodiff gives it under `shard_map`:
- `ppermute_shift`'s backward shifts the cotangent by -shift (the
  transpose of `ppermute`);
- `psum`'s backward is the identity on each rank's cotangent (Megatron's
  "g" operator): a loss computed alike on every rank from a psum'd value
  gets JAX's gradient, not the axis size times it, which is what
  `torch.distributed.nn.functional.all_reduce`'s summing backward gives;
- `all_gather`'s backward is a `reduce_scatter` (sum) over the same axis:
  each rank's gathered copy was used on its own data (the fsdp weight
  gather), so the block's gradient is the sum of every rank's;
- `reduce_scatter`'s backward is an `all_gather`;
- `pvary` is the identity forward with a `psum` backward (Megatron's "f",
  JAX's `lax.pvary`): where a value alike on every rank enters a block
  whose ranks each compute a part (a tensor-parallel matmul), each rank's
  cotangent is a part, and their sum is the value's gradient;
- `all_gather_invariant`'s backward is this rank's block of the
  cotangent: the gathered value is used alike on every rank (the
  embedding's tp lookup, the gathered logits), so the cotangent is alike
  too, and nothing is summed.
A backward that communicates is a collective too: every rank of the axis
must run the same backward ops in the same order, so each rank's graph
must hold the same collectives (a stage that ignores what it received
keeps it in its graph with `torch.where`, as `parallel/pipeline.py`
does). `pmean` is a psum divided by the axis size; `pmax`, `pmin` and
`all_to_all` carry no gradient.
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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, gather_axis):
        ctx.axis, ctx.mesh, ctx.gather_axis = axis, mesh, gather_axis
        return _wait(_all_gather(x.contiguous(), gather_axis, mesh.get_group(axis)))

    @staticmethod
    def backward(ctx, g):
        return (_wait(_reduce_scatter(g.contiguous(), "sum", ctx.gather_axis,
                                      ctx.mesh.get_group(ctx.axis))), None, None, None)


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, gather_axis):
        ctx.axis, ctx.mesh, ctx.gather_axis = axis, mesh, gather_axis
        return _wait(_all_gather(x.contiguous(), gather_axis, mesh.get_group(axis)))

    @staticmethod
    def backward(ctx, g):
        n, i = axis_size(ctx.axis, ctx.mesh), axis_index(ctx.axis, ctx.mesh)
        return g.chunk(n, dim=ctx.gather_axis)[i].contiguous(), None, None, None


def all_gather(x: torch.Tensor, axis: str, mesh: DeviceMesh, *, tiled: bool = True,
               gather_axis: int = 0) -> torch.Tensor:
    """The ranks' blocks in axis order, concatenated along `gather_axis`
    (tiled) or stacked on a new axis there. Its gradient is the
    reduce_scatter of the cotangent (module docstring)."""
    if not tiled:
        x = x.unsqueeze(gather_axis)
    return _AllGather.apply(x, axis, mesh, gather_axis % x.ndim)


def all_gather_invariant(x: torch.Tensor, axis: str, mesh: DeviceMesh, *,
                         gather_axis: int = 0) -> torch.Tensor:
    """`all_gather` (tiled) of a value then used alike on every rank; its
    gradient is this rank's block of the cotangent (module docstring)."""
    return _AllGatherInvariant.apply(x, axis, mesh, gather_axis % x.ndim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, scatter_axis):
        ctx.axis, ctx.mesh, ctx.scatter_axis = axis, mesh, scatter_axis
        return _wait(_reduce_scatter(x.contiguous(), "sum", scatter_axis, mesh.get_group(axis)))

    @staticmethod
    def backward(ctx, g):
        return (_wait(_all_gather(g.contiguous(), ctx.scatter_axis,
                                  ctx.mesh.get_group(ctx.axis))), None, None, None)


def reduce_scatter(x: torch.Tensor, axis: str, mesh: DeviceMesh, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """Block i (along `scatter_axis`) of the sum over the axis, on the rank
    at index i. Its gradient is the all_gather of the cotangent."""
    scatter_axis %= x.ndim
    n = axis_size(axis, mesh)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"axis {scatter_axis} of {tuple(x.shape)} does not split into "
                         f"{n} blocks")
    return _ReduceScatter.apply(x, axis, mesh, scatter_axis)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _wait(fc.all_reduce(g, "sum", ctx.mesh.get_group(ctx.axis))), None, None


def pvary(x: torch.Tensor, axis: str, mesh: DeviceMesh) -> torch.Tensor:
    """`x` itself; its gradient is the psum of the cotangent over the axis
    (module docstring)."""
    return _PVary.apply(x, axis, mesh)


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
