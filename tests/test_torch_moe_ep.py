"""Expert parallelism of the port's MoE forward against JAX's
`test_ep_sharded_apply_matches` (tests/test_moe.py) on the CPU: the
moe_tiny model with its expert banks sharded over ep (and their hidden
width over tp), on a world of 4 gloo ranks, gives the logits of JAX's
unsharded apply on the same weights and tokens within JAX's atol of 1e-4,
on an {"ep": 2, "tp": 2} mesh and on an {"ep": 4} one. Every rank routes
every token the same way (the router is replicated) and holds E/ep
experts."""

import sys

import numpy as np
import torch

from test_torch_distributed import run_ranks

MESHES = [{"ep": 2, "tp": 2}, {"ep": 4}]


def _ep_rank(rank, world, store, sd, tokens):
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import shard_state_dict
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    cfg = LlamaConfig.moe_tiny(dtype=torch.float32, param_dtype=torch.float32,
                               attn_impl="xla")
    whole = {k: torch.from_numpy(v) for k, v in sd.items()}
    out = {}
    for axes in MESHES:
        mesh = make_mesh(axes, device="cpu")
        model = Llama(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(shard_state_dict(whole, mesh))
        with torch.no_grad():
            logits, _ = model(torch.from_numpy(tokens))
        out[str(axes)] = dict(
            logits=logits.numpy(), experts=model.layers_0.moe.w_gate.shape[0],
            gate_idx=[b.moe.last_gate_idx.numpy() for b in model.blocks()])
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


def test_ep_sharded_apply_matches(tmp_path):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.models.convert import flax_to_state_dict
    cfg = LlamaConfig.moe_tiny(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla")
    model = Llama(cfg)
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 16))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    sd = {k: v.numpy() for k, v in flax_to_state_dict(jax.device_get(params)).items()}
    got = run_ranks(_ep_rank, 4, tmp_path, sd, tokens)
    ref, _ = model.apply(params, jnp.asarray(tokens))
    # the port's unsharded forward: the routing every rank must reproduce
    whole = tllama.Llama(tllama.LlamaConfig.moe_tiny(dtype=torch.float32,
                                                     param_dtype=torch.float32,
                                                     attn_impl="xla"), device="cpu")
    whole.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        whole(torch.from_numpy(tokens))
    ids = [b.moe.last_gate_idx.numpy() for b in whole.blocks()]
    for rank, res in enumerate(got):
        assert not res["jax_loaded"]
        for axes in MESHES:
            r = res[str(axes)]
            np.testing.assert_allclose(r["logits"], np.asarray(ref), atol=1e-4,
                                       err_msg=f"{axes} rank {rank}")
            assert r["experts"] == cfg.n_experts // axes["ep"]
            for got_ids, want_ids in zip(r["gate_idx"], ids):
                np.testing.assert_array_equal(got_ids, want_ids)
