"""ray_tpu_torch.parallel.collective against ray_tpu.parallel.collective on
the CPU, at 2 and 4 gloo ranks (spawned processes that import torch and
the port only; see test_torch_distributed.run_ranks).

Rank r's input is block r of one seeded numpy array, with small integer
values so that every summation order gives the same floats. Each rank's
allreduce (SUM, MAX, MIN), allgather, reducescatter, alltoall and
broadcast must equal the matching block of `XlaGroup` over
`local_cpu_mesh` given the same blocks, through the host backend (numpy)
and through the tensor group that backend="nccl" builds, here over a gloo
group with CPU tensors. reduce, PRODUCT, send/recv and barrier follow
HostGroup's numpy rule (`_NUMPY_REDUCE` over the ranks in order). The
operations XlaGroup refuses, the port's tensor group refuses with the
same error."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import collective as tcol
from ray_tpu_torch.parallel import distributed as tdist
from test_torch_distributed import run_ranks

OPS = ("sum", "max", "min")


def _blocks(world, seed=0):
    """Rank r's input: block r of [world, 2 * world, 3], integers in floats;
    positive ones for PRODUCT."""
    rng = np.random.default_rng(seed + world)
    x = rng.integers(-8, 9, (world, 2 * world, 3)).astype(np.float32)
    pos = rng.integers(1, 4, (world, 2 * world, 3)).astype(np.float32)
    return x, pos


def _ops(group, rank, world, x, as_in, as_out, alltoall_in):
    """The per-rank results of one group's collectives on block `x`."""
    out = {f"allreduce_{op}": as_out(group.allreduce(as_in(x), op)) for op in OPS}
    gathered = group.allgather(as_in(x))
    out["allgather"] = np.concatenate(gathered) if isinstance(gathered, list) else \
        as_out(gathered)
    out["reducescatter"] = as_out(group.reducescatter(as_in(x)))
    got = group.alltoall(alltoall_in(as_in(x)))
    out["alltoall"] = np.concatenate(got) if isinstance(got, list) else as_out(got)
    out["broadcast"] = as_out(group.broadcast(as_in(x), src_rank=world - 1))
    out["reduce"] = as_out(group.reduce(as_in(x), dst_rank=1))
    group.barrier()
    # a ring, and one send to this rank itself; even ranks send first
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    if rank % 2 == 0:
        group.send(as_in(x), nxt)
        got = group.recv(prv, like=as_in(x))
    else:
        got = group.recv(prv, like=as_in(x))
        group.send(as_in(x), nxt)
    group.send(as_in(2 * x), rank)
    out["recv"] = as_out(got)
    out["recv_self"] = as_out(group.recv(rank, like=as_in(x)))
    return out


def _collective_rank(rank, world, store):
    import sys
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    x, pos = _blocks(world)
    x, pos = x[rank], pos[rank]
    g = tcol.init_collective_group(world, rank, backend="host", group_name="h")
    assert tcol.is_group_initialized("h") and not tcol.is_group_initialized("t")
    host = _ops(g, rank, world, x, np.asarray, np.asarray,
                lambda a: np.split(a, world))
    host["product"] = tcol.allreduce(pos, group_name="h", op=tcol.ReduceOp.PRODUCT)
    host["module_sum"] = tcol.allreduce(x, group_name="h")
    host["module_rank"] = (tcol.get_rank("h"), tcol.get_collective_group_size("h"))
    tcol.barrier("h")
    # the tensor group backend="nccl" builds, over gloo with CPU tensors
    tg = tcol.TensorGroup(world, rank, "t", dist.new_group(list(range(world)),
                                                         backend="gloo"), torch.device("cpu"))
    tensor = _ops(tg, rank, world, x, torch.from_numpy, lambda t: t.numpy(), lambda t: t)
    dist.destroy_process_group(tg.pg)
    tcol.destroy_collective_group("h")
    assert not tcol.is_group_initialized("h")
    dist.destroy_process_group()
    return dict(host=host, tensor=tensor, jax_loaded="jax" in sys.modules)


def _xla_expected(world):
    """XlaGroup over a CPU mesh of `world` devices, on the ranks' blocks
    stacked along axis 0, split back into per-rank blocks."""
    import jax
    from ray_tpu.parallel import local_cpu_mesh
    from ray_tpu.parallel.collective import XlaGroup
    x, _ = _blocks(world)
    g = XlaGroup(local_cpu_mesh(world, {"dp": world}), "dp", "x")
    flat = x.reshape(-1, 3)
    per_rank = lambda a: np.split(np.asarray(jax.device_get(a)), world)
    want = {f"allreduce_{op}": per_rank(g.allreduce(flat, op)) for op in OPS}
    want["allgather"] = [np.asarray(g.allgather(flat))] * world
    want["reducescatter"] = per_rank(g.reducescatter(flat))
    want["alltoall"] = per_rank(g.alltoall(flat))
    # single controller: broadcast returns the input; rank r gets block src
    want["broadcast"] = [per_rank(g.broadcast(flat))[world - 1]] * world
    return want


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_xla_and_host_rule(world, tmp_path):
    from ray_tpu.parallel.collective import _NUMPY_REDUCE
    got = run_ranks(_collective_rank, world, tmp_path)
    want = _xla_expected(world)
    x, pos = _blocks(world)
    for rank, res in enumerate(got):
        assert not res["jax_loaded"]
        for backend in ("host", "tensor"):
            out = res[backend]
            for key, blocks in want.items():
                np.testing.assert_array_equal(out[key], blocks[rank],
                                              err_msg=f"{backend} rank {rank} {key}")
            # HostGroup's rule: numpy over the ranks' arrays, in rank order
            total = _NUMPY_REDUCE["sum"](x)
            np.testing.assert_array_equal(out["reduce"], total if rank == 1 else x[rank])
            np.testing.assert_array_equal(out["recv"], x[(rank - 1) % world])
            np.testing.assert_array_equal(out["recv_self"], 2 * x[rank])
        np.testing.assert_array_equal(res["host"]["product"], _NUMPY_REDUCE["product"](pos))
        np.testing.assert_array_equal(res["host"]["module_sum"], _NUMPY_REDUCE["sum"](x))
        assert res["host"]["module_rank"] == (rank, world)


def test_unsupported_ops_raise_as_xla():
    from ray_tpu.parallel import local_cpu_mesh
    from ray_tpu.parallel import collective as jcol
    xg = jcol.XlaGroup(local_cpu_mesh(2, {"dp": 2}), "dp", "x")
    tg = tcol.TensorGroup(1, 0, "t", None, torch.device("cpu"))
    x = np.ones((4, 2), np.float32)
    for group, arg, name in ((xg, x, "xla"), (tg, torch.from_numpy(x), "nccl")):
        with pytest.raises(ValueError, match=f"{name} backend does not support op=product"):
            group.allreduce(arg, jcol.ReduceOp.PRODUCT)
        with pytest.raises(ValueError, match=f"reducescatter supports SUM on the {name} "
                                             "backend"):
            group.reducescatter(arg, jcol.ReduceOp.MAX)
    with pytest.raises(ValueError, match="does not support op=product"):
        tg.reduce(torch.from_numpy(x), op=tcol.ReduceOp.PRODUCT)


def test_group_registry_and_backends():
    """The module API refuses what it cannot serve: an unknown group, an
    unknown backend, nccl with no card (no drop to gloo), and JAX's "xla"
    backend with no mesh and no card: its default mesh is on cuda
    (mesh groups themselves: test_torch_xla_ops.py)."""
    with pytest.raises(RuntimeError, match="not initialized"):
        tcol.get_rank("nope")
    with pytest.raises(ValueError, match="unknown backend"):
        tcol.init_collective_group(1, 0, backend="mpi")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcol.init_collective_group(1, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcol.init_collective_group(1, 0, backend="xla")
    assert not dist.is_initialized() and not tcol.is_group_initialized()


def test_one_rank_host_group_in_process():
    """A group of one starts its own in-memory world and takes it down
    with the group: every result equals its input, and a send to itself
    comes back."""
    assert not dist.is_initialized()
    g = tcol.init_collective_group(1, 0, backend="host", group_name="solo")
    try:
        x = np.arange(6.0).reshape(3, 2)
        for op in OPS + ("product",):
            np.testing.assert_array_equal(tcol.allreduce(x, "solo", op), x)
        np.testing.assert_array_equal(tcol.reducescatter(x, "solo"), x)
        assert [a.tolist() for a in tcol.allgather(x, "solo")] == [x.tolist()]
        tcol.send(x, 0, "solo")
        np.testing.assert_array_equal(tcol.recv(None, 0, "solo"), x)
        with pytest.raises(RuntimeError, match="already initialized"):
            tcol.init_collective_group(1, 0, group_name="solo")
        assert tdist.process_count() == 1 and g.world_size == 1
    finally:
        tcol.destroy_collective_group("solo")
    assert not dist.is_initialized()
