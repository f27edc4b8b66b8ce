"""ray_tpu_torch.train.checkpoint against ray_tpu.train.checkpoint on the CPU.

- test_train.py::test_checkpoint_roundtrip_pytree's case through both
  packages (orbax in JAX, torch.save in the port), with its metadata;
- a pickled state.pkl and the metadata sidecar, written by one package and
  read by the other;
- _CheckpointBook's keep-N and best-by-score sequence, equal to JAX's on
  the same registrations;
- a directory holding only JAX's orbax pytree/ is refused by name;
- a restore onto a target takes the target's devices and dtypes, and a
  model's and an optimizer's state dicts come back bit-equal;
- sharded, on 4 gloo ranks (the counterpart of orbax's sharded write): the
  tiny Llama trained on an {"fsdp": 2, "tp": 2} mesh, saved after step 2
  with each rank writing its own blocks, restored into a fresh model and
  AdamW on the same mesh: every block and AdamW moment torch.equal, steps
  3-4 equal to the uninterrupted run's;
- the same checkpoint read whole (no mesh): each block of the whole on
  the writing mesh torch.equal the saved block; restored onto {"dp": 2,
  "fsdp": 2} and onto {"fsdp": 4} with the target's specs: every block
  and AdamW moment torch.equal the whole's block under that mesh, and two
  resumed steps' losses within 1e-5 of the uninterrupted run's;
- JAX's tiny Llama params written sharded by the port on {"fsdp": 2,
  "tp": 2} in f32 and read whole equal exactly JAX's `Checkpoint.to_state()`
  of the same params saved sharded by `llama_rules` on the same mesh of
  JAX's CPU devices;
- a sharded checkpoint written without specs raises `ValueError` on a
  whole read, and a restore onto another mesh without the target's specs
  raises naming both layouts."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ray_tpu.train import Checkpoint as JCheckpoint
from ray_tpu.train import CheckpointConfig
from ray_tpu.train.checkpoint import _CheckpointBook as JBook
from ray_tpu_torch.train import Checkpoint
from ray_tpu_torch.train.checkpoint import _CheckpointBook as TBook
from test_torch_distributed import run_ranks


class Opaque:
    """A leaf neither orbax nor torch.load(weights_only=True) can hold."""

    def __init__(self, v):
        self.v = v


def test_checkpoint_roundtrip_pytree(tmp_path):
    state = {"params": {"w": np.arange(6.0).reshape(2, 3)}, "step": np.asarray(7)}
    for cls, name in ((JCheckpoint, "jax"), (Checkpoint, "port")):
        ckpt = cls.from_state(state, path=str(tmp_path / name))
        restored = ckpt.to_state()
        np.testing.assert_array_equal(restored["params"]["w"], state["params"]["w"])
        assert int(np.asarray(restored["step"])) == 7
        ckpt.set_metadata({"note": "hi"})
        assert cls.from_directory(ckpt.path).get_metadata()["note"] == "hi"
    port = Checkpoint.from_directory(str(tmp_path / "port")).to_state()
    assert (tmp_path / "port" / "state.pt").exists()
    assert isinstance(port["params"]["w"], np.ndarray)   # numpy in, numpy out
    assert port["params"]["w"].dtype == np.float64 and port["step"].shape == ()


def test_pickle_and_metadata_read_across_packages(tmp_path):
    state = {"obj": Opaque(3), "w": np.arange(4, dtype=np.float32), "tag": "x"}
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    JCheckpoint.from_state(state, path=jdir, metadata={"it": 1})
    Checkpoint.from_state(state, path=tdir, metadata={"it": 2})
    assert os.path.exists(os.path.join(jdir, "state.pkl"))
    assert os.path.exists(os.path.join(tdir, "state.pkl"))
    for reader, path in ((Checkpoint, jdir), (JCheckpoint, tdir)):
        got = reader.from_directory(path).to_state()
        assert got["obj"].v == 3 and got["tag"] == "x"
        np.testing.assert_array_equal(got["w"], state["w"])
    Checkpoint.from_directory(jdir).update_metadata({"score": 0.5})
    JCheckpoint.from_directory(tdir).update_metadata({"score": 0.25})
    assert JCheckpoint.from_directory(jdir).get_metadata() == {"it": 1, "score": 0.5}
    assert Checkpoint.from_directory(tdir).get_metadata() == {"it": 2, "score": 0.25}
    # a torch-expressible state saved into the same dir replaces the pickle
    Checkpoint.from_state({"w": state["w"]}, path=tdir)
    assert sorted(p for p in os.listdir(tdir) if p.startswith("state")) == ["state.pt"]


def test_orbax_directory_is_named(tmp_path):
    JCheckpoint.from_state({"w": np.ones(3)}, path=str(tmp_path / "j"))
    assert (tmp_path / "j" / "pytree").is_dir()
    with pytest.raises(ValueError, match=r"orbax pytree checkpoint \(pytree/\)"):
        Checkpoint.from_directory(str(tmp_path / "j")).to_state()
    (tmp_path / "empty").mkdir()
    for cls in (Checkpoint, JCheckpoint):
        with pytest.raises(FileNotFoundError):
            cls.from_directory(str(tmp_path / "empty")).to_state()


@pytest.mark.parametrize("cfg", [
    dict(num_to_keep=2),
    dict(num_to_keep=2, checkpoint_score_attribute="acc", checkpoint_score_order="max"),
    dict(num_to_keep=3, checkpoint_score_attribute="loss", checkpoint_score_order="min"),
    dict(num_to_keep=None, checkpoint_score_attribute="acc"),
], ids=["oldest", "max", "min", "keep-all"])
def test_checkpoint_book_matches_jax(tmp_path, cfg):
    """The same registrations (some without the score) through both books:
    the same survivors on disk, latest and best after every step."""
    rng = np.random.default_rng(3)
    metrics = [{"acc": float(a), "loss": float(l)} for a, l in rng.random((7, 2))]
    metrics[2] = {}                              # an unscored report
    config = CheckpointConfig(**cfg)
    books = {"jax": (JBook(config), JCheckpoint), "port": (TBook(config), Checkpoint)}
    seen = {}
    for name, (book, cls) in books.items():
        steps = []
        for i, m in enumerate(metrics):
            ck = cls.from_state({"i": i}, path=str(tmp_path / name / f"ck{i}"))
            book.register(ck, m)
            steps.append((sorted(os.listdir(tmp_path / name)),
                          os.path.basename(book.latest.path), os.path.basename(book.best.path)))
        seen[name] = steps
    assert seen["port"] == seen["jax"]


def test_restore_onto_target_devices_and_dtypes(tmp_path):
    """A model's and an AdamW's state dicts come back bit-equal onto a fresh
    model and optimizer; the target's dtype wins, and a shape or a key that
    does not match is an error."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(3, 4)).sum().backward()
    opt.step()
    ckpt = Checkpoint.from_state({"model": model.state_dict(), "optim": opt.state_dict(),
                                  "step": 1}, path=str(tmp_path / "ck"))
    fresh = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    fresh_opt = torch.optim.AdamW(fresh.parameters(), lr=1e-3)
    got = ckpt.to_state(target={"model": fresh.state_dict(), "optim": fresh_opt.state_dict()})
    fresh.load_state_dict(got["model"])
    fresh_opt.load_state_dict(got["optim"])
    assert got["step"] == 1
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    for k, s in opt.state_dict()["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[key], fresh_opt.state_dict()["state"][k][key])
    wide = ckpt.to_state(target={"model": {k: v.double() for k, v in
                                           model.state_dict().items()}})
    assert all(v.dtype == torch.float64 for v in wide["model"].values())
    with pytest.raises(ValueError, match="target"):
        ckpt.to_state(target={"model": {"0.weight": torch.zeros(2, 2)}})
    with pytest.raises(ValueError, match="lacks"):
        ckpt.to_state(target={"nope": torch.zeros(1)})


RESUME_TOL = 1e-5      # resumed losses on another mesh, absolute (f32, tiny)


def _sharded_rank(rank, world, store, root, jax_params):
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import shard_state_dict
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding, local_slice
    from ray_tpu_torch.train.ingest import iter_device_batches
    from ray_tpu_torch.train.llm_step import build_llama_trainer, train_state
    torch.set_num_threads(1)
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    mesh = make_mesh({"fsdp": 2, "tp": 2}, device="cpu")
    build = lambda seed, m=mesh, params=None: build_llama_trainer(
        "tiny", 4, 16, device="cpu", seed=seed, dtype=torch.float32, mesh=m, params=params,
        overrides=dict(attn_impl="xla"))
    feed = lambda bs, m=mesh: iter_device_batches(bs, sharding=data_sharding(m))
    clone = lambda tree: {k: (clone(v) if isinstance(v, dict) else
                              v.clone() if torch.is_tensor(v) else v) for k, v in tree.items()}
    model, opt, step, batches, _ = build(0)
    losses = [step(t) for t in feed(batches[:2])]
    state, specs = train_state(model, opt, step=2)
    path = os.path.join(root, "ck")
    Checkpoint.from_state(state, path=path, mesh=mesh, specs=specs, metadata={"step": 2})
    saved = clone(state)
    losses += [step(t) for t in feed(batches[2:4])]
    final = clone(train_state(model, opt)[0])

    model, opt, step, _, _ = build(1)          # other weights: the restore must set them
    ckpt = Checkpoint.from_directory(path)
    got = ckpt.to_state(target=train_state(model, opt)[0], mesh=mesh)
    model.load_state_dict(got["model"])
    opt.load_state_dict(got["optim"])
    same = lambda a, b: a.keys() == b.keys() and all(
        same(a[k], b[k]) if isinstance(a[k], dict) else
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)
    now = train_state(model, opt)[0]
    out = dict(restored_model=same(now["model"], saved["model"]),
               restored_moments=same(now["optim"]["state"], saved["optim"]["state"]),
               step=got["step"])
    resumed = [step(t) for t in feed(batches[2:4])]
    out["losses_equal"] = all(torch.equal(a, b) for a, b in zip(resumed, losses[2:]))
    out["final_equal"] = same(train_state(model, opt)[0]["model"], final["model"]) and same(
        train_state(model, opt)[0]["optim"]["state"], final["optim"]["state"])

    # whole: the blocks of the whole on the writing mesh are the saved blocks
    whole = ckpt.to_state()
    names = list(saved["model"])
    moments = lambda st, i: (st["optim"]["state"][i]["exp_avg"],
                             st["optim"]["state"][i]["exp_avg_sq"])
    out["whole_shapes"] = {k: tuple(v.shape) for k, v in whole["model"].items()}
    out["whole_blocks"] = same(shard_state_dict(whole["model"], mesh), saved["model"]) and all(
        torch.equal(local_slice(w, specs["optim"]["state"][i]["exp_avg"], mesh), b)
        for i in range(len(names)) for w, b in zip(moments(whole, i), moments(saved, i)))
    out["whole_step"] = whole["step"]
    out["whole_optim_steps"] = sorted({float(s["step"]) for s in whole["optim"]["state"].values()})

    # reshard onto two other layouts; blocks and two resumed steps
    for axes in ({"dp": 2, "fsdp": 2}, {"fsdp": 4}):
        other = make_mesh(axes, device="cpu")
        model, opt, step, _, _ = build(1, other)
        target, tspecs = train_state(model, opt)
        got = ckpt.to_state(target=target, mesh=other, specs=tspecs)
        want_model = shard_state_dict(whole["model"], other)
        blocks = same(got["model"], {k: want_model[k] for k in got["model"]}) and all(
            torch.equal(g, local_slice(w, tspecs["optim"]["state"][i]["exp_avg"], other))
            for i in range(len(names)) for g, w in zip(moments(got, i), moments(whole, i)))
        model.load_state_dict(got["model"])
        opt.load_state_dict(got["optim"])
        resumed = [float(step(t)) for t in feed(batches[2:4], other)]
        out["/".join(axes)] = dict(
            blocks=blocks, dtypes={str(v.dtype) for v in got["model"].values()},
            block_shapes={k: tuple(v.shape) for k, v in got["model"].items()},
            gap=max(abs(a - float(b)) for a, b in zip(resumed, losses[2:])))
    try:
        ckpt.to_state(target=train_state(model, opt)[0], mesh=other)
    except ValueError as e:
        out["no_specs_for_other_mesh"] = str(e)

    # JAX's params written sharded by the port, for the test's whole read
    model, opt, _, _, _ = build(0, params=jax_params)
    jstate, jspecs = train_state(model, opt)
    Checkpoint.from_state({"model": jstate["model"]}, path=os.path.join(root, "ck_jax"),
                          mesh=mesh, specs={"model": jspecs["model"]})
    nospec = Checkpoint.from_state({"model": jstate["model"]},
                                   path=os.path.join(root, "ck_nospec"), mesh=mesh)
    try:
        nospec.to_state()
    except ValueError as e:
        out["no_specs_whole"] = str(e)

    out["files"] = sorted(os.listdir(os.path.join(path, "shards")))
    with open(os.path.join(path, "shards", "layout.json")) as f:
        out["layout"] = json.load(f)
    out["metadata"] = ckpt.get_metadata()
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


def _jax_whole(root):
    """JAX's tiny Llama params (f32, seed 0) saved sharded by llama_rules on
    {"fsdp": 2, "tp": 2} over JAX's CPU devices 0..3 and read back whole by
    its Checkpoint; returns (the params as numpy, the whole read)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import Llama, LlamaConfig
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.sharding import llama_rules
    cfg = LlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla")
    params = Llama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    plain = lambda t: ({k: plain(v) for k, v in t.items()} if hasattr(t, "items")
                       else np.asarray(t))
    params = plain({"params": params["params"]})
    mesh = make_mesh({"fsdp": 2, "tp": 2}, devices=jax.devices()[:4])
    sharded = jax.device_put(params, llama_rules().tree_shardings(params, mesh))
    assert any(len({str(s.index) for s in leaf.addressable_shards}) > 1
               for leaf in jax.tree_util.tree_leaves(sharded))
    JCheckpoint.from_state(sharded, path=os.path.join(root, "jax_ck"))
    return params, plain(JCheckpoint.from_directory(os.path.join(root, "jax_ck")).to_state())


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(the ranks' results, JAX's whole read, the directory): one spawn of
    4 gloo ranks for every sharded case."""
    root = tmp_path_factory.mktemp("sharded")
    params, jax_whole = _jax_whole(str(root))
    got = run_ranks(_sharded_rank, 4, root, str(root), params, timeout=150)
    assert not any(r["jax_loaded"] for r in got)
    return got, jax_whole, root


def test_sharded_checkpoint_round_trip_on_four_ranks(sharded):
    got, _, _ = sharded
    for rank, r in enumerate(got):
        assert (r["restored_model"], r["restored_moments"], r["losses_equal"],
                r["final_equal"], r["step"]) == (True, True, True, True, 2), (rank, r)
    assert got[0]["files"] == ["layout.json"] + [f"rank-{r:05d}.pt" for r in range(4)]
    layout = got[0]["layout"]
    assert layout["mesh"] == {"fsdp": 2, "tp": 2}
    assert layout["specs"]["model"]["layers_0.attn.wq.weight"] == ["tp", "fsdp"]
    assert layout["specs"]["model"]["layers_0.attn_norm.scale"] == []
    assert layout["specs"]["optim"]["state"]["2"]["exp_avg"] == ["tp", "fsdp"]    # wq
    assert got[0]["metadata"] == {"step": 2}


def test_sharded_checkpoint_reads_whole(sharded):
    """No mesh: the whole state, whose blocks on the writing mesh are the
    saved blocks (parameters and AdamW moments), with its scalars."""
    got, _, _ = sharded
    for rank, r in enumerate(got):
        assert r["whole_blocks"] and r["whole_step"] == 2 and r["whole_optim_steps"] == [2.0]
        assert r["whole_shapes"]["layers_0.attn.wq.weight"] == (64, 64)
        assert r["whole_shapes"]["embed.embedding"] == (256, 64)


@pytest.mark.parametrize("axes,wq_block", [("dp/fsdp", (64, 32)), ("fsdp", (64, 16))],
                         ids=["dp2_fsdp2", "fsdp4"])
def test_sharded_checkpoint_reshards(sharded, axes, wq_block):
    """Onto another mesh with the target's specs: every block and moment
    is the whole's block there, f32 stays f32, and two resumed steps'
    losses are within RESUME_TOL of the uninterrupted run's."""
    got, _, _ = sharded
    for rank, r in enumerate(got):
        case = r[axes]
        assert case["blocks"] and case["dtypes"] == {"torch.float32"}, (rank, case)
        assert case["gap"] <= RESUME_TOL, (rank, case["gap"])
        assert case["block_shapes"]["layers_0.attn.wq.weight"] == wq_block


def test_sharded_checkpoint_refusals(sharded):
    got, _, _ = sharded
    for r in got:
        assert r["no_specs_for_other_mesh"] == (
            "checkpoint written on mesh {'fsdp': 2, 'tp': 2} over ranks [0, 1, 2, 3]; "
            "restoring onto mesh {'fsdp': 4} over ranks [0, 1, 2, 3] needs the target's "
            "specs (train.llm_step.train_state gives them)")
        assert "written without specs: its blocks cannot be assembled" in r["no_specs_whole"]


def test_whole_read_equals_jax(sharded):
    """The port's whole read of JAX's params, written sharded by the port,
    equals JAX's whole read of them saved sharded, exactly."""
    from ray_tpu_torch.models.convert import state_dict_to_flax
    _, jax_whole, root = sharded
    whole = Checkpoint.from_directory(str(root / "ck_jax")).to_state()
    mine = state_dict_to_flax(whole["model"])
    flat = lambda t, pre="": ([(pre + k, v) for k, v in t.items() if not hasattr(v, "items")]
                              + [x for k, v in t.items() if hasattr(v, "items")
                                 for x in flat(v, pre + k + "/")])
    want, have = dict(flat(jax_whole)), dict(flat(mine))
    assert want.keys() == have.keys() and len(want) > 10
    for k, v in want.items():
        assert have[k].dtype == v.dtype == np.float32 and have[k].shape == v.shape, k
        np.testing.assert_array_equal(have[k], v, err_msg=k)
