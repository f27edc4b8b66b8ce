"""ray_tpu_torch.ops.ring_attention against ray_tpu's ring_attention under
`shard_map`, on the CPU: one world of 4 gloo ranks (spawned with
run_ranks; the rank functions import no jax), the JAX side in the test
process on its virtual CPU devices.

- Each rank's output block equals JAX's (f32, GQA H=4 Kh=2, B=2, T=64,
  D=16), causal and not, at sp 1, 2 and 4 (atol 2e-5, as
  `tests/test_ops.py::TestRingAttention`): the 4 ranks form 4 // sp rings
  of one mesh {"dp": 4 // sp, "sp": sp}, each ring on the same sequence.
- dQ, dK and dV of sum(out * dO) equal `jax.grad` through JAX's ring on
  the same dO (atol 2e-5).
- A sequence that does not split evenly over the ranks raises ValueError
  on every rank."""

import functools
import sys

import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks

B, T, H, KH, D = 2, 64, 4, 2, 16
SPS = (1, 2, 4)


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    do = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v, do


def _block(x, i, n):
    return torch.from_numpy(np.ascontiguousarray(np.split(x, n, axis=1)[i]))


def _rank(rank, world, store):
    import torch.distributed as dist
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)     # tiny tensors; the other test workers keep the cores
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    q, k, v, do = _inputs()
    out = {}
    for sp in SPS:
        mesh = make_mesh({"dp": world // sp, "sp": sp}, device="cpu")
        i = mesh.get_local_rank("sp")
        for causal in (True, False):
            qb, kb, vb = (_block(x, i, sp).requires_grad_() for x in (q, k, v))
            o = ring_attention(qb, kb, vb, "sp", causal=causal, mesh=mesh)
            o.backward(_block(do, i, sp))
            out[(sp, causal)] = dict(out=o.detach().numpy(), dq=qb.grad.numpy(),
                                     dk=kb.grad.numpy(), dv=vb.grad.numpy())
    mesh = make_mesh({"sp": world}, device="cpu")
    n = T // world - (rank == world - 1)       # the last rank's block is one token short
    try:
        ring_attention(*(torch.zeros((B, n) + x.shape[2:]) for x in (q, k, v)), mesh=mesh)
    except ValueError as e:
        out["uneven"] = str(e)
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    got = run_ranks(_rank, 4, tmp_path_factory.mktemp("ring"))
    assert not any(r["jax_loaded"] for r in got)
    return got


@functools.lru_cache(maxsize=None)
def _jax_ring(sp, causal):
    """(out, dq, dk, dv) of JAX's ring under shard_map on sp CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ray_tpu.ops.ring_attention import ring_attention as jring
    from ray_tpu.parallel.mesh import local_cpu_mesh
    mesh = local_cpu_mesh(sp, {"sp": sp})
    spec = P(None, "sp")
    fn = jax.jit(shard_map(lambda a, b, c: jring(a, b, c, axis_name="sp", causal=causal),
                           mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))
    q, k, v, do = _inputs()
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sp", SPS)
def test_ring_matches_jax(ranks, sp, causal):
    want = _jax_ring(sp, causal)[0]
    for rank, res in enumerate(ranks):
        i = rank % sp          # sp is the inner axis of {"dp", "sp"}
        np.testing.assert_allclose(res[(sp, causal)]["out"], np.split(want, sp, axis=1)[i],
                                   atol=2e-5, err_msg=f"sp={sp} rank {rank}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sp", SPS)
def test_ring_grads_match_jax_grad(ranks, sp, causal):
    _, *want = _jax_ring(sp, causal)
    for rank, res in enumerate(ranks):
        i = rank % sp
        for name, w in zip(("dq", "dk", "dv"), want):
            np.testing.assert_allclose(res[(sp, causal)][name], np.split(w, sp, axis=1)[i],
                                       atol=2e-5, err_msg=f"sp={sp} rank {rank}: {name}")


def test_uneven_sequence_raises(ranks):
    msgs = [r.get("uneven") for r in ranks]
    assert all(m and "does not split evenly over sp=4" in m for m in msgs), msgs
