"""Sequence parallelism: the port's Llama with attn_impl="ring" on a
{"sp": 4} mesh of 4 gloo ranks against ray_tpu's ring Llama under
`shard_map` on 4 virtual CPU devices, on the JAX tiny preset's f32 params
carried across by `models/convert.py`. B=2, T=64 (16 tokens a rank).

- With the block's global positions, the logits equal JAX's within 1e-5
  (and the dense model's).
- With positions omitted, both default to `arange` of the local block:
  the port's logits equal JAX's, and both are off the dense model's.
- The param grads of a summed CE loss, summed over sp, equal `jax.grad`.
- `shard_state_dict` places every parameter whole on an sp mesh.
- ring with no mesh, or a mesh without sp, raises ValueError; so does sp
  with tp, and blocks of unequal length, checked once a forward (one pmax
  for all the layers).
One spawn of 4 ranks (the rank functions import no jax); the JAX side
runs in the test process."""

import functools
import sys

import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks

B, T, SP = 2, 64, 4


def _tokens():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (B, T)).astype(np.int32),
            rng.integers(0, 256, (B, T)).astype(np.int64))


def _tcfg(**kw):
    from ray_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, attn_impl="ring",
                            **kw)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rank(rank, world, store, sd):
    import torch.distributed as dist
    import torch.nn.functional as F
    from ray_tpu_torch.models.convert import shard_state_dict
    from ray_tpu_torch.models.llama import Llama
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel import xla_ops
    from ray_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)     # tiny tensors; the other test workers keep the cores
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    mesh = make_mesh({"sp": world}, device="cpu")
    placed = shard_state_dict(sd, mesh)
    out = {"whole": all(torch.equal(placed[k], v) for k, v in sd.items())}
    model = Llama(_tcfg(), device="cpu", mesh=mesh)
    model.load_state_dict(placed)
    toks, labels = _tokens()
    n = T // world
    mine = slice(rank * n, (rank + 1) * n)
    tok = torch.from_numpy(toks[:, mine]).long()
    pos = torch.arange(rank * n, (rank + 1) * n)[None].expand(B, n)
    pmax, checks = xla_ops.pmax, []
    xla_ops.pmax = lambda *a, **kw: checks.append(1) or pmax(*a, **kw)
    try:
        with torch.no_grad():
            out["logits_omitted"] = model(tok)[0].numpy()
    finally:
        xla_ops.pmax = pmax
    out["split_checks"] = len(checks)
    logits = model(tok, pos)[0]
    out["logits"] = logits.detach().numpy()
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    torch.from_numpy(labels[:, mine]).reshape(-1), reduction="sum").backward()
    out["grads"] = {k: xla_ops.psum(p.grad, "sp", mesh).numpy()
                    for k, p in model.named_parameters()}
    out["errors"] = dict(
        no_mesh=_raises(lambda: Llama(_tcfg(), device="cpu")),
        no_sp=_raises(lambda: Llama(_tcfg(), device="cpu",
                                    mesh=make_mesh({"dp": world}, device="cpu"))),
        sp_with_tp=_raises(lambda: Llama(_tcfg(), device="cpu",
                                         mesh=make_mesh({"sp": 2, "tp": 2}, device="cpu"))),
        uneven=_raises(lambda: model(tok[:, :n - (rank == world - 1)])))
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX's results on its tiny params: {"params", "logits", "logits_omitted",
    "dense", "grads"}."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel.mesh import local_cpu_mesh
    cfg = lambda impl: jllama.LlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                                               attn_impl=impl)
    ring, dense = jllama.Llama(cfg("ring")), jllama.Llama(cfg("xla"))
    params = dense.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    mesh = local_cpu_mesh(SP, {"sp": SP})
    seq = P(None, "sp")
    sharded = lambda fn, n_in: jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(),) + (seq,) * n_in,
                                                 out_specs=seq, check_vma=False))
    with_pos = sharded(lambda p, t, pos: ring.apply(p, t, pos)[0], 2)
    omitted = sharded(lambda p, t: ring.apply(p, t)[0], 1)
    toks, labels = _tokens()
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))

    def loss(p):
        logp = jax.nn.log_softmax(with_pos(p, toks, pos), -1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).sum()

    get = lambda x: np.asarray(jax.device_get(x))
    return dict(params=jax.device_get(params), logits=get(with_pos(params, toks, pos)),
                logits_omitted=get(omitted(params, toks)),
                dense=get(dense.apply(params, jnp.asarray(toks))[0]),
                grads=jax.device_get(jax.grad(loss)(params)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from ray_tpu_torch.models.convert import flax_to_state_dict
    sd = {k: v.numpy() for k, v in flax_to_state_dict(_jax()["params"]).items()}
    got = run_ranks(_rank, SP, tmp_path_factory.mktemp("sp"), sd)
    assert not any(r["jax_loaded"] for r in got)
    return got


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def test_ring_logits_with_global_positions_match_jax(ranks):
    want = _jax()
    got = _gathered(ranks, "logits")
    np.testing.assert_allclose(got, want["logits"], atol=1e-5)
    np.testing.assert_allclose(got, want["dense"], atol=1e-5)


def test_ring_logits_with_positions_omitted_match_jax(ranks):
    """The positions trap: JAX's default is the local arange, and so is the
    port's; a caller that omits positions gets JAX's logits, not dense ones."""
    want = _jax()
    got = _gathered(ranks, "logits_omitted")
    np.testing.assert_allclose(got, want["logits_omitted"], atol=1e-5)
    assert np.abs(got - want["dense"]).max() > 1e-3
    assert np.abs(want["logits_omitted"] - want["dense"]).max() > 1e-3


def test_ring_param_grads_match_jax_grad(ranks):
    from ray_tpu_torch.models.convert import flax_to_state_dict
    want = {k: v.numpy() for k, v in flax_to_state_dict(_jax()["grads"]).items()}
    for rank, res in enumerate(ranks):
        assert res["grads"].keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(res["grads"][k], w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"rank {rank}: d {k}")


def test_ring_llama_checks_split_once_a_forward(ranks):
    # the tiny preset has 2 layers: a check in every layer would count 2
    assert [r["split_checks"] for r in ranks] == [1] * SP


def test_sp_mesh_places_params_whole(ranks):
    assert all(r["whole"] for r in ranks)


@pytest.mark.parametrize("case,text", [
    ("no_mesh", "attn_impl='ring' needs a mesh with the sequence axis 'sp', got None"),
    ("no_sp", "attn_impl='ring' needs a mesh with the sequence axis 'sp', got ('dp',)"),
    ("sp_with_tp", "sp=2 with tp=2, ep=1: sequence parallelism runs with replicated "
                   "parameters"),
    ("uneven", "the sequence does not split evenly over sp=4: blocks of 15 to 16 tokens"),
])
def test_ring_errors(ranks, case, text):
    for r in ranks:
        assert r["errors"][case] is not None and text in r["errors"][case], r["errors"]
