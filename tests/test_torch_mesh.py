"""ray_tpu_torch.parallel.mesh against ray_tpu.parallel.mesh on the CPU.

The shape arithmetic (axis order, the -1 wildcard, JAX's three errors) is
held against JAX's make_mesh and auto_mesh on the 8 virtual CPU devices
without a world. On 4 gloo ranks (spawned with run_ranks; the rank
functions import no jax), each rank's coordinates in the port's meshes
equal the position of the same device index in JAX's meshes; hybrid_mesh
puts the hosts (GROUP_RANK) on the DCN axes; local_cpu_mesh raises JAX's
error when the world is too small."""

import os
import sys

import numpy as np
import pytest

from ray_tpu_torch.parallel import mesh as tmesh
from test_torch_distributed import run_ranks

AXES = [{"dp": -1, "tp": 2}, {"tp": 2, "dp": 4}, {"dp": 8}, {"tp": 2, "fsdp": 2, "dp": -1},
        {"ep": 2, "tp": 2, "dp": 2}, {"tp": 4, "xx": 2}, {"pp": 2, "sp": 2, "dp": -1}]
AUTO = [dict(tp=2), dict(tp=2, fsdp=2), dict(ep=2, tp=2), dict(pp=2, sp=2), dict()]


@pytest.mark.parametrize("axes", AXES, ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
def test_mesh_shape_matches_jax(axes):
    from ray_tpu.parallel import make_mesh
    want = make_mesh(axes)
    names, sizes = tmesh.mesh_shape(axes, 8)
    assert names == tuple(want.axis_names)
    assert dict(zip(names, sizes)) == dict(want.shape)


@pytest.mark.parametrize("kw", AUTO, ids=lambda k: "-".join(f"{a}{v}" for a, v in k.items())
                         or "default")
def test_auto_mesh_axes_match_jax(kw):
    from ray_tpu.parallel import auto_mesh
    want = auto_mesh(**kw)
    names, sizes = tmesh.mesh_shape(tmesh.auto_axes(**kw), 8)
    assert (names, sizes) == (tuple(want.axis_names), tuple(want.shape.values()))


@pytest.mark.parametrize("axes", [{"dp": 3, "tp": 3}, {"dp": -1, "tp": -1}, {"dp": -1, "tp": 3}],
                         ids=["too-many", "two-wildcards", "not-divisible"])
def test_make_mesh_errors_match_jax(axes):
    from ray_tpu.parallel import make_mesh
    with pytest.raises(ValueError) as want:
        make_mesh(axes)
    with pytest.raises(ValueError) as got:
        tmesh.mesh_shape(axes, 8)
    assert str(got.value) == str(want.value)


MESHES = [{"dp": 2, "tp": 2}, {"tp": 4}, {"fsdp": 2, "tp": 2}, {"ep": 2, "tp": 2}]


def _mesh_rank(rank, world, store):
    from ray_tpu_torch.parallel import distributed as tdist
    os.environ.update(GROUP_RANK=str(rank // 2), LOCAL_RANK=str(rank % 2))
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    out = {}
    for axes in MESHES:
        m = tmesh.make_mesh(axes, device="cpu")
        out[str(axes)] = (m.get_coordinate(), tmesh.axis_sizes(m), m.device_type)
    m = tmesh.auto_mesh(tp=2, device="cpu")
    out["auto tp=2"] = (m.get_coordinate(), tmesh.axis_sizes(m), m.device_type)
    m = tmesh.local_cpu_mesh(4, {"fsdp": 2, "tp": 2})
    out["local_cpu_mesh"] = (m.get_coordinate(), tmesh.axis_sizes(m), m.device_type)
    m = tmesh.hybrid_mesh({"tp": 2}, {"dp": 2}, device="cpu")
    out["hybrid"] = (m.get_coordinate(), tmesh.axis_sizes(m), m.device_type)
    try:
        tmesh.local_cpu_mesh(8)
    except RuntimeError as e:
        out["too_small"] = str(e)
    # a mesh over the first two ranks: every rank builds it, two are members
    m = tmesh.make_mesh({"tp": 2}, devices=[0, 1], device="cpu")
    out["subset"] = m.get_coordinate()
    out["jax_loaded"] = "jax" in sys.modules
    import torch.distributed as dist
    dist.destroy_process_group()
    return out


def _jax_position(mesh, index):
    return tuple(int(i) for i in np.argwhere(
        np.vectorize(lambda d: d.id)(mesh.devices) == index)[0])


def test_mesh_coordinates_match_jax_on_4_ranks(tmp_path):
    import jax
    from ray_tpu.parallel import auto_mesh, make_mesh
    got = run_ranks(_mesh_rank, 4, tmp_path)
    devs = jax.devices()[:4]
    want = {str(a): make_mesh(a, devs) for a in MESHES}
    want["auto tp=2"] = auto_mesh(tp=2, devices=devs)
    want["local_cpu_mesh"] = make_mesh({"fsdp": 2, "tp": 2}, devs)
    want["hybrid"] = make_mesh({"dp": 2, "tp": 2}, devs)   # host r // 2 on dp
    for rank, res in enumerate(got):
        assert not res["jax_loaded"]
        for key, jmesh in want.items():
            coord, sizes, dev = res[key]
            assert coord == _jax_position(jmesh, devs[rank].id), (rank, key)
            assert sizes == dict(jmesh.shape) and dev == "cpu", key
        assert res["too_small"].startswith("need 8 cpu devices, have 4")
        assert res["subset"] == ((rank,) if rank < 2 else None)


def test_jax_raises_too_few_devices_as_the_port_does():
    """The port's local_cpu_mesh error opens as JAX's does."""
    from ray_tpu.parallel import local_cpu_mesh
    with pytest.raises(RuntimeError, match="need 64 cpu devices, have 8"):
        local_cpu_mesh(64)
