"""Training the port's Llama over dp, fsdp, tp and ep meshes against JAX's
jit over `llama_rules` on the CPU, with the settings of `_dryrun_impl`
(`__graft_entry__.py`): the tiny preset in f32 with attn_impl="xla",
batch 8 x 32 from `PRNGKey(7)`, params from `PRNGKey(0)`, `adamw(1e-2)`,
two steps on the same batch; moe_tiny with capacity_factor 2.0.

One spawn of 4 gloo ranks (the rank function imports no jax) trains every
case in turn: the shard-local model on the case's mesh loaded with
`shard_state_dict` of JAX's params, `make_train_step(mesh=...)` over
`adamw(1e-2)`, its batch fed by
`iter_device_batches(sharding=data_sharding(mesh))`. The JAX side runs in
the test process on 4 of its 8 virtual CPU devices, device r where the
port has rank r ({"tp": 2} on the first two), while the ranks train. Each case holds:
- losses 1 and 2 within 1e-5 of JAX's on the same mesh;
- each rank's blocks after two steps against the addressable shard of
  JAX's device at its coordinate, and the gathered whole params
  (`gather_state_dict`, `state_dict_to_flax`) against JAX's whole, by the
  share of coordinates lr / 100 apart (Adam turns rounding into steps of
  about lr, so a norm would not do).
The hybrid case is the port's `hybrid_mesh({"fsdp": 2}, {"dp": 2})` over
two hosts of two ranks (GROUP_RANK and LOCAL_RANK set as torchrun sets
them); JAX's hybrid mesh needs two processes, so its side is the mesh
that hybrid mesh lays out, dp outer and fsdp inner, on one. A tp that
does not divide n_kv_heads raises ValueError (JAX's tiny tp:4 splits a
KV head; the port does not)."""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks

LR = 1e-2
BATCH, SEQ = 8, 32
# the share of coordinates lr / 100 apart that a case may hold, and the
# bound of any coordinate: Adam moves each by at most about lr a step
FAR_SHARE = 1e-3
CASES = {
    "dp4": ("tiny", {"dp": 4}),
    "fsdp4": ("tiny", {"fsdp": 4}),
    "tp2": ("tiny", {"tp": 2}),
    "dp2_fsdp2": ("tiny", {"dp": 2, "fsdp": 2}),
    "fsdp2_tp2": ("tiny", {"fsdp": 2, "tp": 2}),
    "hybrid_dp2_fsdp2": ("tiny", "hybrid"),
    "moe_ep4": ("moe_tiny", {"ep": 4}),
    "moe_ep2_tp2": ("moe_tiny", {"ep": 2, "tp": 2}),
}
OVERRIDES = {"tiny": dict(attn_impl="xla", max_seq_len=64),
             "moe_tiny": dict(attn_impl="xla", max_seq_len=64, capacity_factor=2.0)}
HYBRID_AXES = {"dp": 2, "fsdp": 2}      # the layout of hybrid_mesh({"fsdp": 2}, {"dp": 2})


def _size(axes):
    return 4 if axes == "hybrid" else int(np.prod(list(axes.values())))


def _mesh_rank(rank, world, store, params, tokens):
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import gather_state_dict, state_dict_to_flax
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import axis_sizes, hybrid_mesh, make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train.ingest import iter_device_batches
    from ray_tpu_torch.models.convert import flax_to_state_dict, shard_state_dict
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.ops.optim import make_optimizer
    from ray_tpu_torch.train.llm_step import make_train_step
    torch.set_num_threads(1)
    os.environ.update(GROUP_RANK=str(rank // 2), LOCAL_RANK=str(rank % 2))
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")

    def build(preset, mesh):
        cfg = getattr(LlamaConfig, preset)(dtype=torch.float32, param_dtype=torch.float32,
                                           remat=True, **OVERRIDES[preset])
        model = Llama(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(shard_state_dict(flax_to_state_dict(params[preset]), mesh))
        opt, _ = make_optimizer(model.parameters(), lr=LR, optimizer="adamw",
                                weight_decay=1e-4)
        return model, make_train_step(model, opt, mesh=mesh)

    out = {}
    for name, (preset, axes) in CASES.items():
        mesh = (hybrid_mesh({"fsdp": 2}, {"dp": 2}, device="cpu") if axes == "hybrid"
                else make_mesh(axes, devices=range(_size(axes)), device="cpu"))
        if mesh.get_coordinate() is None:       # {"tp": 2} holds ranks 0 and 1
            continue
        model, step = build(preset, mesh)
        feed = iter_device_batches([tokens] * 2, sharding=data_sharding(mesh))
        losses = [float(step(t)) for t in feed]
        whole = gather_state_dict(model.state_dict(), mesh)
        out[name] = dict(losses=losses, mesh=axis_sizes(mesh),
                         coordinate=tuple(mesh.get_coordinate()),
                         blocks={k: v.detach().numpy() for k, v in model.state_dict().items()},
                         whole=state_dict_to_flax(whole) if rank == 0 else None)
    try:
        build("tiny", make_mesh({"tp": 4}, device="cpu"))
    except ValueError as e:
        out["tp4_error"] = str(e)
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


def _jax_cfg(preset):
    import jax.numpy as jnp
    from ray_tpu.models.llama import LlamaConfig
    return getattr(LlamaConfig, preset)(dtype=jnp.float32, param_dtype=jnp.float32,
                                        **OVERRIDES[preset])


def _jax_setup():
    """(tokens, {preset: params}) as `_dryrun_impl` draws them."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import Llama
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (BATCH, SEQ + 1), 0,
                                           _jax_cfg("tiny").vocab_size, jnp.int32))
    plain = lambda t: ({k: plain(v) for k, v in t.items()} if hasattr(t, "items")
                       else np.asarray(t))
    params = {p: plain({"params": Llama(_jax_cfg(p)).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:, :-1]))["params"]}) for p in OVERRIDES}
    return tokens, params


def _jax_two_steps(preset, axes, params0, tokens):
    """`_dryrun_impl`'s two_steps on a mesh of devices 0..3: (losses, {flax
    path: {device id: shard}}, {flax path: whole})."""
    import jax
    import optax
    from ray_tpu.models.llama import Llama
    from ray_tpu.ops.losses import cross_entropy
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.sharding import data_sharding, llama_rules
    model = Llama(_jax_cfg(preset))
    opt = optax.adamw(LR)
    rules = llama_rules()

    def loss_g(params, tokens):
        logits, _ = model.apply(params, tokens[:, :-1])
        return cross_entropy(logits, tokens[:, 1:])[0]

    def step_g(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(loss_g)(params, tokens)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    mesh = make_mesh(HYBRID_AXES if axes == "hybrid" else axes,
                     devices=jax.devices()[:_size(axes)])
    param_sh = rules.tree_shardings(params0, mesh)
    opt_state = opt.init(params0)
    opt_sh = rules.tree_shardings(opt_state, mesh)
    params = jax.device_put(params0, param_sh)
    opt_state = jax.device_put(opt_state, opt_sh)
    batch = jax.device_put(tokens, data_sharding(mesh))
    step = jax.jit(step_g, out_shardings=(param_sh, opt_sh, None))
    losses = []
    with mesh:
        for _ in range(2):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    path = lambda kp: "/".join(str(getattr(k, "key", k)) for k in kp)
    shards = {path(kp): {s.device.id: np.asarray(s.data) for s in leaf.addressable_shards}
              for kp, leaf in flat}
    whole = {path(kp): np.asarray(leaf) for kp, leaf in flat}
    return losses, shards, whole


def _port_key(flax_path):
    """`params/layers_0/attn/wq/kernel` -> (`layers_0.attn.wq.weight`, transposed)."""
    parts = flax_path.split("/")[1:]
    if parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"]), True
    return ".".join(parts), False


def _gap(pairs):
    """(max |a - b|, share of coordinates lr / 100 apart) over (a, b) pairs."""
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in pairs])
    return float(diff.max()), float(np.mean(diff > LR / 100))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """({case: JAX's (losses, shards, whole)}, the ranks' results, JAX's
    initial params); the ranks train while JAX compiles."""
    import threading
    tokens, params = _jax_setup()
    got = []
    ranks = threading.Thread(target=lambda: got.append(run_ranks(
        _mesh_rank, 4, tmp_path_factory.mktemp("train_mesh"), params, tokens, timeout=240)))
    ranks.start()
    try:
        want = {name: _jax_two_steps(preset, axes, params[preset], tokens)
                for name, (preset, axes) in CASES.items()}
    finally:
        ranks.join()
    assert got, "the ranks failed (see the captured output)"
    assert not any(r["jax_loaded"] for r in got[0])
    return want, got[0], params


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax_on_the_same_mesh(both, case):
    want, got, _ = both
    jl = want[case][0]
    for rank, res in enumerate(got[:_size(CASES[case][1])]):
        np.testing.assert_allclose(res[case]["losses"], jl, rtol=0, atol=1e-5,
                                   err_msg=f"{case} rank {rank}")
        mesh = CASES[case][1]
        assert res[case]["mesh"] == (HYBRID_AXES if mesh == "hybrid" else mesh)


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_match_jax_addressable_shards(both, case):
    """Each rank's blocks against the shard of JAX's device r, and the
    gathered whole params against JAX's whole, after two steps."""
    want, got, params = both
    _, shards, whole = want[case]
    pairs = []
    for rank, res in enumerate(got[:_size(CASES[case][1])]):
        blocks = res[case]["blocks"]
        assert len(blocks) == len(shards)
        for path, by_device in shards.items():
            key, kernel = _port_key(path)
            jb = by_device[rank]
            pairs.append((blocks[key], jb.T if kernel else jb))
    worst, far = _gap(pairs)
    assert worst <= 2 * LR * 2 and far <= FAR_SHARE, (case, worst, far)
    flat = lambda tree, pre="": {p: v for k, sub in tree.items() for p, v in (
        flat(sub, f"{pre}{k}/").items() if isinstance(sub, dict) else [(pre + k, sub)])}
    gathered = flat(got[0][case]["whole"])
    assert gathered.keys() == whole.keys()
    worst, far = _gap([(gathered[p], whole[p]) for p in whole])
    assert worst <= 2 * LR * 2 and far <= FAR_SHARE, (case, worst, far)
    init = flat(params[CASES[case][0]])
    assert _gap([(whole[p], init[p]) for p in whole])[1] > 0.5     # the steps moved them


def test_tp_that_splits_a_kv_head_raises(both):
    _, got, _ = both
    for res in got:
        assert res["tp4_error"] == "tp=4 must divide n_kv_heads=2"
