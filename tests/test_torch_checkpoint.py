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
  3-4 equal to the uninterrupted run's; a restore onto {"dp": 2, "fsdp":
  2} raises naming both layouts, and one without a mesh raises."""

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


def _sharded_rank(rank, world, store, root):
    import torch.distributed as dist
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train.ingest import iter_device_batches
    from ray_tpu_torch.train.llm_step import build_llama_trainer, train_state
    torch.set_num_threads(1)
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    mesh = make_mesh({"fsdp": 2, "tp": 2}, device="cpu")
    build = lambda seed: build_llama_trainer("tiny", 4, 16, device="cpu", seed=seed,
                                             dtype=torch.float32, mesh=mesh,
                                             overrides=dict(attn_impl="xla"))
    feed = lambda bs: iter_device_batches(bs, sharding=data_sharding(mesh))
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
    other = make_mesh({"dp": 2, "fsdp": 2}, device="cpu")
    for name, m in (("other_layout", other), ("no_mesh", None)):
        try:
            ckpt.to_state(target=train_state(model, opt)[0], mesh=m)
        except ValueError as e:
            out[name] = str(e)
    out["files"] = sorted(os.listdir(os.path.join(path, "shards")))
    with open(os.path.join(path, "shards", "layout.json")) as f:
        out["layout"] = json.load(f)
    out["metadata"] = ckpt.get_metadata()
    out["jax_loaded"] = "jax" in sys.modules
    dist.destroy_process_group()
    return out


def test_sharded_checkpoint_round_trip_on_four_ranks(tmp_path):
    got = run_ranks(_sharded_rank, 4, tmp_path, str(tmp_path), timeout=120)
    for rank, r in enumerate(got):
        assert not r["jax_loaded"]
        assert (r["restored_model"], r["restored_moments"], r["losses_equal"],
                r["final_equal"], r["step"]) == (True, True, True, True, 2), (rank, r)
        assert r["other_layout"] == (
            "checkpoint written on mesh {'fsdp': 2, 'tp': 2} over ranks [0, 1, 2, 3]; "
            "restoring onto mesh {'dp': 2, 'fsdp': 2} over ranks [0, 1, 2, 3]: resharding "
            "across layouts is not supported")
        assert r["no_mesh"].endswith("holds a sharded checkpoint of mesh {'fsdp': 2, "
                                     "'tp': 2}: pass the mesh to restore onto")
    assert got[0]["files"] == ["layout.json"] + [f"rank-{r:05d}.pt" for r in range(4)]
    layout = got[0]["layout"]
    assert layout["mesh"] == {"fsdp": 2, "tp": 2}
    assert layout["specs"]["model"]["layers_0.attn.wq.weight"] == ["tp", "fsdp"]
    assert layout["specs"]["model"]["layers_0.attn_norm.scale"] == []
    assert layout["specs"]["optim"]["state"]["2"]["exp_avg"] == ["tp", "fsdp"]    # wq
    assert got[0]["metadata"] == {"step": 2}
