"""ray_tpu_torch.parallel.pipeline against ray_tpu.parallel.pipeline on the
CPU: JAX's four cases (`tests/test_parallel.py`: matches sequential, a
single microbatch, fewer microbatches than stages, the remainder error's
text) with pipelines of 2 and 4 stages, each rank one stage, against
JAX's `pipeline_apply` under `shard_map` on the same inputs; and the
gradient of a loss through it against `jax.grad`.

One world of 4 gloo ranks (spawned with run_ranks; the rank functions
import no jax): a 4-stage pipeline is {"pp": 4}, two 2-stage pipelines
are {"pp": 2, "dp": 2}. Inputs are made with numpy from a seed."""

import functools
import sys

import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks

D = 8
# name -> (stages S, microbatches M, batch rows)
CASES = {"sequential_s4": (4, 8, 16), "sequential_s2": (2, 8, 16),
         "fewer_microbatches": (4, 2, 4), "fewer_microbatches_s2": (2, 1, 2)}


def _case(name):
    """(per-stage params, batch, loss weights) of a tanh-stage case."""
    n_stages, n_micro, rows = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    params = [{"w": (rng.normal(size=(D, D)) / D).astype(np.float32),
               "b": np.full((D,), 0.1, np.float32)} for _ in range(n_stages)]
    batch = rng.normal(size=(rows, D)).astype(np.float32)
    w = rng.normal(size=(n_micro, rows // n_micro, D)).astype(np.float32)
    return params, batch, w


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _rank(rank, world, store):
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.pipeline import (make_microbatches, pipeline_apply,
                                                 shard_pipeline_params, stack_stage_params)
    torch.set_num_threads(1)     # tiny tensors; the other test workers keep the cores
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    meshes = {s: make_mesh({"pp": s, "dp": world // s}, device="cpu") for s in (2, 4)}
    out = {}
    for name, (n_stages, n_micro, _) in CASES.items():
        params, batch, w = _case(name)
        mesh = meshes[n_stages]
        stacked = stack_stage_params([pytree.tree_map(torch.from_numpy, p) for p in params])
        mine = pytree.tree_map(lambda p: p.clone().requires_grad_(),
                               shard_pipeline_params(stacked, mesh))
        mbs = make_microbatches(torch.from_numpy(batch), n_micro)
        got = pipeline_apply(_tanh_stage, mine, mbs, mesh)
        (got * torch.from_numpy(w)).sum().backward()
        out[name] = dict(out=got.detach().numpy(), stage=mesh.get_local_rank("pp"),
                         grads={k: v.grad.numpy() for k, v in mine.items()})
    # JAX's single-microbatch case: two stages adding 1 and 10 to zeros
    stacked = stack_stage_params([{"c": torch.tensor(1.0)}, {"c": torch.tensor(10.0)}])
    out["single"] = pipeline_apply(lambda p, x: x + p["c"],
                                   shard_pipeline_params(stacked, meshes[2]),
                                   torch.zeros((1, 4)), meshes[2]).numpy()
    errors = []
    for batch, m in ((torch.zeros((10, 4)), 3), (torch.zeros((4, 4)), 0)):
        try:
            make_microbatches(batch, m)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    got = run_ranks(_rank, 4, tmp_path_factory.mktemp("pipeline"))
    assert not any(r["jax_loaded"] for r in got)
    return got


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(JAX's pipeline_apply outputs, jax.grad of sum(out * w) by the stacked
    params), on the case's inputs."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.pipeline import (make_microbatches, pipeline_apply,
                                           shard_pipeline_params, stack_stage_params)
    n_stages, n_micro, _ = CASES[name]
    params, batch, w = _case(name)
    mesh = make_mesh({"pp": n_stages}, devices=jax.devices()[:n_stages])
    stacked = shard_pipeline_params(stack_stage_params(params), mesh)
    mbs = make_microbatches(jnp.asarray(batch), n_micro)
    fn = lambda p: pipeline_apply(lambda q, x: jnp.tanh(x @ q["w"] + q["b"]), p, mbs, mesh)
    out = jax.jit(fn)(stacked)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(fn(p) * w)))(stacked)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads), params, batch


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_jax_and_sequential(ranks, name):
    want, _, params, batch = _jax(name)
    ref = batch
    for p in params:
        ref = np.tanh(ref @ p["w"] + p["b"])
    np.testing.assert_allclose(want, ref.reshape(want.shape), rtol=1e-5, atol=1e-6)
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res[name]["out"], want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_grads_match_jax_grad(ranks, name):
    _, grads, _, _ = _jax(name)
    for rank, res in enumerate(ranks):
        s = res[name]["stage"]
        for k, g in res[name]["grads"].items():
            np.testing.assert_allclose(g, grads[k][s:s + 1], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank} (stage {s}): d {k}")


def test_pipeline_single_microbatch(ranks):
    import jax
    import jax.numpy as jnp
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.pipeline import (pipeline_apply, shard_pipeline_params,
                                           stack_stage_params)
    mesh = make_mesh({"pp": 2}, devices=jax.devices()[:2])
    stages = [{"c": jnp.asarray(1.0)}, {"c": jnp.asarray(10.0)}]
    want = pipeline_apply(lambda p, x: x + p["c"],
                          shard_pipeline_params(stack_stage_params(stages), mesh),
                          jnp.zeros((1, 4)), mesh)
    np.testing.assert_array_equal(np.asarray(want), np.full((1, 4), 11.0))
    for res in ranks:
        np.testing.assert_array_equal(res["single"], np.asarray(want))


def test_make_microbatches_errors_match_jax(ranks):
    import jax.numpy as jnp
    from ray_tpu.parallel.pipeline import make_microbatches
    want = []
    for batch, m in ((jnp.zeros((10, 4)), 3), (jnp.zeros((4, 4)), 0)):
        with pytest.raises(ValueError) as ei:
            make_microbatches(batch, m)
        want.append(str(ei.value))
    assert "10 % 3 == 1 rows" in want[0]
    for res in ranks:
        assert res["errors"] == want
