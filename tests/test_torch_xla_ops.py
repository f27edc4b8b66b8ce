"""ray_tpu_torch.parallel.xla_ops, collective groups over a mesh and the
sharded device feed, against ray_tpu on the CPU, on one world of 4 gloo
ranks (spawned with run_ranks; the rank functions import no jax).

- Each xla_ops op, run by every rank on its block, equals JAX's op under
  `shard_map` on 4 CPU devices (block r on device r): over the one axis
  of a {"dp": 4} mesh, and over each axis of a {"dp": 2, "tp": 2} mesh.
- The gradients of `ppermute_shift`, `psum`, `all_gather` (the fsdp
  weight gather), `all_gather_invariant` (the tp activation gather),
  `reduce_scatter` and `pvary` (the tp entry) equal `jax.grad` through
  `shard_map` on the same inputs: a loss on an output sharded over every
  mesh axis is each rank's own; one on an output replicated over the axis
  (psum, all_gather_invariant) is taken alike on every rank of it; pvary's
  input is replicated over the axis, as JAX's identity with that in_spec.
- `init_collective_group(backend="xla", mesh=..., axis=...)` gives each
  rank the block of JAX's `XlaGroup` result that its device holds; send
  and recv raise JAX's error.
- `iter_device_batches(sharding=data_sharding(mesh))` yields DTensors
  whose local blocks equal JAX's addressable shards of the same batch and
  whose full_tensor() is the host batch."""

import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import collective as tcol
from ray_tpu_torch.parallel import xla_ops
from test_torch_distributed import run_ranks

MESHES = [("dp",), ("dp", "tp")]


def _x(seed=0):
    """[16, 8] integers in floats: every summation order gives the same floats."""
    return np.random.default_rng(seed).integers(-8, 9, (16, 8)).astype(np.float32)


def _ops(axis):
    """name -> fn(x, axis, ops) run on each shard's block; `ops` is JAX's
    xla_ops or the port's with the mesh bound."""
    return {
        "psum": lambda x, o: o.psum(x, axis),
        "pmean": lambda x, o: o.pmean(x, axis),
        "pmax": lambda x, o: o.pmax(x, axis),
        "all_gather_0": lambda x, o: o.all_gather(x, axis),
        "all_gather_1": lambda x, o: o.all_gather(x, axis, gather_axis=1),
        "all_gather_stacked": lambda x, o: o.all_gather(x, axis, tiled=False),
        "reduce_scatter_0": lambda x, o: o.reduce_scatter(x, axis),
        "reduce_scatter_1": lambda x, o: o.reduce_scatter(x, axis, scatter_axis=1),
        "ppermute_1": lambda x, o: o.ppermute_shift(x, axis, 1),
        "ppermute_-1": lambda x, o: o.ppermute_shift(x, axis, -1),
        "all_to_all_0_1": lambda x, o: o.all_to_all(x, axis, 0, 1),
        "all_to_all_1_0": lambda x, o: o.all_to_all(x, axis, 1, 0),
        "axis_index": lambda x, o: o.axis_index(axis),
        "axis_size": lambda x, o: o.axis_size(axis),
    }


class _Bound:
    """The port's xla_ops with the mesh bound, called as JAX's are."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __getattr__(self, name):
        fn = getattr(xla_ops, name)

        def call(*args, **kw):
            if name in ("axis_index", "axis_size"):
                return fn(args[0], self.mesh)
            return fn(args[0], args[1], self.mesh, *args[2:], **kw)
        return call


GRAD_OPS = ("ppermute_1", "ppermute_-1", "psum", "all_gather_0", "all_gather_1",
            "all_gather_invariant", "reduce_scatter_0", "reduce_scatter_1", "pvary")
REPLICATED_OUT = ("psum", "all_gather_invariant")   # output alike over the axis
REPLICATED_IN = ("pvary",)                          # input alike over the axis


def _grad_fn(axis, name, jax_side=False):
    """The gradient case's op. JAX's counterparts: pvary is the identity
    with a replicated in_spec, all_gather_invariant is all_gather with a
    replicated out_spec."""
    if name == "pvary":
        return (lambda x, o: x) if jax_side else (lambda x, o: o.pvary(x, axis))
    if name == "all_gather_invariant" and not jax_side:
        return lambda x, o: o.all_gather_invariant(x, axis)
    if name == "all_gather_invariant":
        return lambda x, o: o.all_gather(x, axis)
    return _ops(axis)[name]


def _blocks_of(names, axis, replicated):
    """How a tensor splits on dim 0: (number of blocks, fn(mesh, rank) ->
    the rank's block): over every axis (device order, the rank), or,
    replicated over `axis`, over the other one."""
    other = [a for a in names if a != axis]
    if not replicated:
        return 4, lambda mesh, rank: rank
    if not other:
        return 1, lambda mesh, rank: 0
    return 2, lambda mesh, rank: mesh.get_local_rank(other[0])


def _grad_w(shape):
    """The loss weights of a gradient case over the op's whole output."""
    return np.random.default_rng(7).normal(size=shape).astype(np.float32)


def _batches():
    rng = np.random.default_rng(4)
    return [{"tokens": rng.integers(0, 256, (8, 5), dtype=np.int32),
             "w": rng.normal(size=(4,)).astype(np.float32)} for _ in range(3)]


def _rank(rank, world, store):
    import torch.distributed as dist
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train.ingest import iter_device_batches
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    x = torch.from_numpy(np.split(_x(), world)[rank])
    out = {"ops": {}, "groups": {}}
    meshes = {names: make_mesh({"dp": 4} if names == ("dp",) else {"dp": 2, "tp": 2},
                               device="cpu") for names in MESHES}
    for names, mesh in meshes.items():
        for axis in names:
            for name, fn in _ops(axis).items():
                r = fn(x, _Bound(mesh))
                out["ops"][(names, axis, name)] = (np.asarray(r) if not torch.is_tensor(r)
                                                   else r.numpy())
            g = tcol.init_collective_group(world, rank, backend="xla",
                                           group_name=f"{names}-{axis}", mesh=mesh, axis=axis)
            res = {f"allreduce_{op}": g.allreduce(x, op) for op in ("sum", "max", "min")}
            res.update(allgather=g.allgather(x), reducescatter=g.reducescatter(x),
                       alltoall=g.alltoall(x), reduce=g.reduce(x, dst_rank=1),
                       broadcast=g.broadcast(x, src_rank=1))
            g.barrier()
            for fn in (lambda: g.send(x, 0), lambda: g.recv(0, like=x)):
                try:
                    fn()
                except NotImplementedError as e:
                    res.setdefault("p2p", []).append(str(e))
            out["groups"][(names, axis)] = dict(
                {k: v.numpy() for k, v in res.items() if k != "p2p"}, p2p=res.get("p2p"),
                rank=g.rank, world=g.world_size)
            tcol.destroy_collective_group(f"{names}-{axis}")
    out["grads"] = {}
    for names, mesh in meshes.items():
        for axis in names:
            for name in GRAD_OPS:
                n_in, at_in = _blocks_of(names, axis, name in REPLICATED_IN)
                xg = torch.from_numpy(np.split(_x(), n_in)[at_in(mesh, rank)]).requires_grad_()
                y = _grad_fn(axis, name)(xg, _Bound(mesh))
                n_out, at_out = _blocks_of(names, axis, name in REPLICATED_OUT)
                w = np.split(_grad_w((n_out * y.shape[0],) + tuple(y.shape[1:])), n_out)
                (y * torch.from_numpy(w[at_out(mesh, rank)])).sum().backward()
                out["grads"][(names, axis, name)] = xg.grad.numpy()
    batches = []
    for names, mesh in meshes.items():
        for b in iter_device_batches(iter(_batches()), sharding=data_sharding(mesh), prefetch=2):
            batches.append({k: (v.to_local().numpy(), v.full_tensor().numpy(),
                                tuple(v.placements)) for k, v in b.items()})
    out["batches"] = batches
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


def _jax_mesh(names):
    import jax
    from ray_tpu.parallel import make_mesh
    return make_mesh({"dp": 4} if names == ("dp",) else {"dp": 2, "tp": 2}, jax.devices()[:4])


def _jax_blocks(names, fn):
    """fn under shard_map with block r of _x() on device r; the per-device
    results, in device order."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ray_tpu.parallel import xla_ops as jops
    mesh = _jax_mesh(names)
    spec = P(names if len(names) > 1 else names[0])

    def body(x):
        r = fn(x, jops)
        return jax.numpy.asarray(r).reshape((1,) + jax.numpy.shape(r))

    out = jax.jit(shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec,
                            check_vma=False))(_x())
    return list(np.asarray(out))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    got = run_ranks(_rank, 4, tmp_path_factory.mktemp("xla_ops"))
    assert not any(r["jax_loaded"] for r in got)
    return got


@pytest.mark.parametrize("names,axis", [(("dp",), "dp"), (("dp", "tp"), "dp"),
                                        (("dp", "tp"), "tp")],
                         ids=["dp4", "dp2xtp2-over-dp", "dp2xtp2-over-tp"])
def test_ops_match_shard_map(ranks, names, axis):
    for name, fn in _ops(axis).items():
        want = _jax_blocks(names, fn)
        for rank, res in enumerate(ranks):
            np.testing.assert_array_equal(res["ops"][(names, axis, name)], want[rank],
                                          err_msg=f"{names} over {axis}: {name} rank {rank}")


@pytest.mark.parametrize("names,axis", [(("dp",), "dp"), (("dp", "tp"), "dp"),
                                        (("dp", "tp"), "tp")],
                         ids=["dp4", "dp2xtp2-over-dp", "dp2xtp2-over-tp"])
def test_grads_match_jax_grad(ranks, names, axis):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ray_tpu.parallel import xla_ops as jops
    mesh = _jax_mesh(names)
    full = P(names if len(names) > 1 else names[0])
    rep = P(*[a for a in names if a != axis])
    for name in GRAD_OPS:
        in_spec = rep if name in REPLICATED_IN else full
        fn = shard_map(lambda x: _grad_fn(axis, name, True)(x, jops), mesh=mesh,
                       in_specs=in_spec,
                       out_specs=rep if name in REPLICATED_OUT else full, check_vma=False)
        x = _x()
        w = _grad_w(jax.eval_shape(fn, x).shape)
        grad = np.asarray(jax.jit(jax.grad(lambda x: (fn(x) * w).sum()))(x))
        n_in, at_in = _blocks_of(names, axis, name in REPLICATED_IN)
        for rank, res in enumerate(ranks):
            want = np.split(grad, n_in)[at_in(_Coords(names, rank), rank)]
            np.testing.assert_allclose(res["grads"][(names, axis, name)], want,
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{names} over {axis}: d{name} rank {rank}")


class _Coords:
    """A rank's coordinates on the test's meshes (row-major over ranks), as
    `_blocks_of` reads them from a DeviceMesh."""

    def __init__(self, names, rank):
        self.coord = dict(zip(names, np.unravel_index(rank, (4,) if len(names) == 1
                                                      else (2, 2))))

    def get_local_rank(self, axis):
        return int(self.coord[axis])


@pytest.mark.parametrize("names,axis", [(("dp",), "dp"), (("dp", "tp"), "tp")],
                         ids=["dp4", "dp2xtp2-over-tp"])
def test_mesh_groups_match_xla_group(ranks, names, axis):
    import jax
    from ray_tpu.parallel.collective import XlaGroup
    mesh = _jax_mesh(names)
    g = XlaGroup(mesh, axis, "x")
    n = mesh.shape[axis]
    for rank, res in enumerate(ranks):
        got = res["groups"][(names, axis)]
        # JAX's group takes the axis's members' blocks stacked on axis 0;
        # this rank's block of its result is at the rank's index on the axis
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        where = list(np.argwhere(ids == rank)[0])
        where[mesh.axis_names.index(axis)] = slice(None)
        members = [int(m) for m in ids[tuple(where)]]
        blocks = np.split(_x(), 4)
        flat = np.concatenate([blocks[m] for m in members])
        i = members.index(rank)
        per = lambda a: np.split(np.asarray(jax.device_get(a)), n)[i]
        assert (got["rank"], got["world"]) == (i, n)
        for op in ("sum", "max", "min"):
            np.testing.assert_array_equal(got[f"allreduce_{op}"], per(g.allreduce(flat, op)))
        np.testing.assert_array_equal(got["allgather"], np.asarray(g.allgather(flat)))
        np.testing.assert_array_equal(got["reducescatter"], per(g.reducescatter(flat)))
        np.testing.assert_array_equal(got["alltoall"], per(g.alltoall(flat)))
        np.testing.assert_array_equal(got["reduce"], per(g.reduce(flat, dst_rank=1)))
        np.testing.assert_array_equal(got["broadcast"], blocks[members[1]])
        for msg in got["p2p"]:
            with pytest.raises(NotImplementedError) as want:
                g.send(np.ones(2), 1)
            assert msg == str(want.value)


def test_sharded_batches_match_jax(ranks):
    import jax
    from ray_tpu.parallel.sharding import data_sharding
    from ray_tpu.train.ingest import iter_device_batches
    want = []
    for names in MESHES:
        mesh = _jax_mesh(names)
        for b in iter_device_batches(iter(_batches()), sharding=data_sharding(mesh)):
            want.append({k: {s.device.id: np.asarray(s.data) for s in v.addressable_shards}
                         for k, v in b.items()})
    hosts = _batches() * len(MESHES)
    for rank, res in enumerate(ranks):
        assert len(res["batches"]) == len(want)
        for got, jb, host in zip(res["batches"], want, hosts):
            for k, (local, full, placements) in got.items():
                np.testing.assert_array_equal(local, jb[k][rank], err_msg=f"{k} rank {rank}")
                np.testing.assert_array_equal(full, host[k])
