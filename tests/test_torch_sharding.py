"""ray_tpu_torch.parallel.sharding against ray_tpu.parallel.sharding on the
CPU.

`llama_rules` over converted tiny and moe_tiny trees: for every leaf, the
port's spec on its state_dict path equals JAX's spec on the flax path
carried through the Dense transpose (reversed for a kernel, the same for
the embedding, the norms and the MoE banks), on a tp-only mesh and on an
fsdp x tp one, and its DTensor placements follow from it. On a world of 4
gloo ranks, each rank's block of `shard_tree` (and of
`convert.shard_state_dict`) is torch.equal to JAX's addressable shard of
the same leaf on the same device, on both meshes, and each DTensor's
full_tensor() is the whole leaf."""

import functools
import sys
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from ray_tpu_torch.models import convert
from ray_tpu_torch.parallel import sharding as tshard
from test_torch_distributed import run_ranks

MESHES = [{"tp": 4}, {"fsdp": 2, "tp": 2}]


@functools.lru_cache(maxsize=None)
def _jax_tree(preset):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import Llama, LlamaConfig
    cfg = getattr(LlamaConfig, preset)(dtype=jnp.float32, param_dtype=jnp.float32)
    return Llama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


def _port_key(flax_path):
    """params/layers_0/attn/wq/kernel -> (layers_0.attn.wq.weight, transposed)."""
    path = flax_path[len("params/"):]
    if path.endswith("/kernel"):
        return path[:-len("/kernel")].replace("/", ".") + ".weight", True
    return path.replace("/", "."), False


def _norm(spec):
    return tshard.P(*tuple(spec))


def _fake_mesh(names):
    return types.SimpleNamespace(mesh_dim_names=tuple(names))


def test_sharding_rules_llama():
    P = tshard.P
    rules = tshard.llama_rules()
    assert rules.spec_for("layers/0/attn/wq/weight") == P(("tp",), ("fsdp",))
    assert rules.spec_for("layers/0/mlp/w_down/weight") == P(("fsdp",), ("tp",))
    assert rules.spec_for("layers/0/attn_norm/scale") == P()
    assert rules.spec_for("unknown/param") == P()
    assert P(("fsdp",), ("tp",)) == ("fsdp", "tp") and P(("dp", "fsdp")) == (("dp", "fsdp"),)


@pytest.mark.parametrize("preset", ["tiny", "moe_tiny"])
@pytest.mark.parametrize("axes", [None] + MESHES, ids=["unfiltered", "tp", "fsdp-tp"])
def test_rules_carry_jax_specs_through_the_transpose(preset, axes):
    import jax
    from ray_tpu.parallel import make_mesh
    from ray_tpu.parallel.sharding import _filter_axes as jfilter
    from ray_tpu.parallel.sharding import llama_rules as jrules
    from ray_tpu.parallel.sharding import tree_paths as jpaths
    params = {"params": _jax_tree(preset)["params"]}
    sd = convert.flax_to_state_dict(jax.device_get(params))
    port_paths = dict(tshard.tree_paths(sd))
    jmesh = make_mesh(axes, jax.devices()[:4]) if axes else None
    seen_ep = 0
    for path, leaf in jpaths(params):
        key, transposed = _port_key(path)
        want = jrules().spec_for(path, leaf)
        got = tshard.llama_rules().spec_for(key.replace(".", "/"), sd[key])
        if jmesh is not None:
            want = jfilter(want, jmesh)
            got = tshard._filter_axes(got, _fake_mesh(jmesh.axis_names))
        want = list(tuple(want)) + [None] * (leaf.ndim - len(tuple(want)))
        got = list(tuple(got)) + [None] * (leaf.ndim - len(tuple(got)))
        if transposed:
            want = want[::-1]
        assert _norm(got) == _norm(want), (path, got, want)
        assert key.replace(".", "/") in port_paths
        seen_ep += "/moe/w_" in path and _norm(want)[0] == "ep"
    if axes is None:
        assert seen_ep == (6 if preset == "moe_tiny" else 0)   # 2 layers x 3 banks


def test_placements_of_specs():
    P = tshard.P
    mesh = types.SimpleNamespace(mesh_dim_names=("dp", "fsdp", "tp"))
    assert tshard.spec_placements(P("tp", "fsdp"), mesh, 2) == (Replicate(), Shard(1),
                                                               Shard(0))
    assert tshard.spec_placements(P(("dp", "fsdp")), mesh, 3) == (Shard(0), Shard(0),
                                                                 Replicate())
    assert tshard.spec_placements(P(), mesh, 1) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of mesh order"):
        tshard.spec_placements(P(("fsdp", "dp")), mesh, 1)
    with pytest.raises(ValueError, match="twice"):
        tshard.spec_placements(P("tp", "tp"), mesh, 2)


def _sd(preset):
    """A seeded port state_dict of the preset (numpy, so the ranks need no jax)."""
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    model = Llama(getattr(LlamaConfig, preset)(dtype=torch.float32,
                                                 param_dtype=torch.float32), device="cpu")
    convert.init_params(model, torch.Generator().manual_seed(3))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _shard_rank(rank, world, store, trees):
    import torch.distributed as dist
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    out = {}
    for axes in MESHES:
        mesh = make_mesh(axes, device="cpu")
        rules = tshard.llama_rules()
        for preset, tree in trees.items():
            sd = {k: torch.from_numpy(v) for k, v in tree.items()}
            placed = tshard.shard_tree(sd, mesh, rules)
            blocks = convert.shard_state_dict(sd, mesh)
            full_ok = all(torch.equal(placed[k].full_tensor(), sd[k]) for k in sd)
            same = all(torch.equal(placed[k].to_local(), blocks[k]) for k in sd)
            placements = rules.tree_placements(sd, mesh)
            pl_ok = all(tuple(placed[k].placements) == placements[k] for k in sd)
            out[(str(axes), preset)] = dict(
                local={k: placed[k].to_local().numpy() for k in sd}, full=full_ok,
                same_as_shard_state_dict=same, placements=pl_ok)
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


def test_shard_tree_blocks_match_jax_shards_on_4_ranks(tmp_path):
    import jax
    from ray_tpu.parallel import make_mesh
    from ray_tpu.parallel.sharding import llama_rules as jrules
    from ray_tpu.parallel.sharding import shard_tree as jshard
    trees = {p: _sd(p) for p in ("tiny", "moe_tiny")}
    got = run_ranks(_shard_rank, 4, tmp_path, trees)
    devs = jax.devices()[:4]
    for axes in MESHES:
        jmesh = make_mesh(axes, devs)
        for preset, sd in trees.items():
            # the same values as a flax tree: kernels back to [in, out]
            flax = {}
            for key, v in sd.items():
                node = flax
                parts = key.split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                if parts[-1] == "weight":
                    node["kernel"] = v.T
                else:
                    node[parts[-1]] = v
            placed = jshard({"params": flax}, jmesh, jrules())
            for key in sd:
                parts = key.split(".")
                leaf = placed["params"]
                for p in parts[:-1]:
                    leaf = leaf[p]
                leaf = leaf["kernel" if parts[-1] == "weight" else parts[-1]]
                by_device = {s.device.id: np.asarray(s.data) for s in leaf.addressable_shards}
                for rank, res in enumerate(got):
                    mine = res[(str(axes), preset)]
                    want = by_device[devs[rank].id]
                    want = want.T if parts[-1] == "weight" else want
                    np.testing.assert_array_equal(mine["local"][key], want,
                                                  err_msg=f"{axes} {preset} {key} rank {rank}")
    for res in got:
        assert not res["jax_loaded"]
        for key, r in res.items():
            if key != "jax_loaded":
                assert r["full"] and r["same_as_shard_state_dict"] and r["placements"], key


def test_data_sharding_and_batch_spec():
    P = tshard.P
    assert tshard.batch_spec() == P(("dp", "fsdp"))
    assert tshard.batch_spec(True) == P(("dp", "fsdp"), ("sp",))
    mesh = types.SimpleNamespace(mesh_dim_names=("fsdp", "tp"))
    ds = tshard.data_sharding(mesh)
    assert ds.spec == P("fsdp") and ds.placements(2) == (Shard(0), Replicate())
    assert ds.placements(0) == (Replicate(), Replicate())
