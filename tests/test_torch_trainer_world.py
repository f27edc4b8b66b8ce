"""TorchTrainer at world 2: two gloo ranks (spawned with `run_ranks`; this
module imports no jax, which the ranks assert) each run the same `fit()`
with ScalingConfig(num_workers=2), as every host runs JAX's under
jax.distributed. The loop trains the port's tiny Llama on {"fsdp": 2}
(f32, attn_impl="xla") for 4 steps and reports a sharded checkpoint
(`Checkpoint.from_state(..., mesh=mesh)`, every rank its own blocks) at
step 2. Held:
- rank 0 alone writes the run's disk state: progress.jsonl holds 4 lines,
  one `checkpoint_000000` holds both ranks' shard files and the layout;
  rank 1's Result has no checkpoint of its own (JAX's rank-0 rule);
- every rank's context says world 2 and its rank, and a dataset whose
  `split` takes `equal` gives each rank its shard;
- a second fit in a fresh directory, resumed from the first run's
  `checkpoint_000000`, takes steps 3-4 with losses and every rank's
  blocks torch.equal to the first fit's.
A run in which rank 1's loop raises at step 2 makes fit() raise
TrainingFailedError on rank 1 (its loop's error the cause) and, once rank
1 has left the world, on rank 0 from the collective it waited in; neither
returns a Result. FailureConfig retries at world > 1 are a ValueError."""

import os
import sys

import numpy as np

from test_torch_distributed import run_ranks

STEPS, SAVE_AT = 4, 2


class Rows:
    """A dataset by duck typing: `split(n, equal=True)` gives equal shards."""

    def __init__(self, rows):
        self.rows = list(rows)

    def split(self, n, *, equal=False):
        per = len(self.rows) // n
        return [Rows(self.rows[i * per:(i + 1) * per]) for i in range(n)]

    def __iter__(self):
        return iter(self.rows)


def _fit_rank(rank, world, store, root):
    import torch
    import torch.distributed as dist
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train.llm_step import build_llama_trainer, train_state
    torch.set_num_threads(1)
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    mesh = make_mesh({"fsdp": world}, device="cpu")
    seen = {"losses": {}, "shards": [], "contexts": []}

    def loop(config):
        model, opt, step, batches, _ = build_llama_trainer(
            "tiny", 4, 16, device="cpu", dtype=torch.float32, mesh=mesh,
            overrides=dict(attn_impl="xla"))
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            state = ckpt.to_state(target=train_state(model, opt)[0], mesh=mesh)
            model.load_state_dict(state["model"])
            opt.load_state_dict(state["optim"])
            start = state["step"]
        ctx = train.get_context()
        seen["contexts"].append((ctx.get_world_size(), ctx.get_world_rank()))
        seen["shards"].append(list(train.get_dataset_shard("train")))
        feed = train.iter_device_batches(batches[start:STEPS], sharding=data_sharding(mesh))
        for i, tokens in zip(range(start, STEPS), feed):
            loss = step(tokens)
            seen["losses"][i] = loss.clone()
            ckpt = None
            if i + 1 == SAVE_AT:
                state, specs = train_state(model, opt, step=i + 1)
                ckpt = train.Checkpoint.from_state(
                    state, path=os.path.join(config["scratch"], f"step{i + 1}"), mesh=mesh,
                    specs=specs)
            train.report({"loss": float(loss), "step": i}, checkpoint=ckpt)
        seen["final"] = {k: v.clone() for k, v in model.state_dict().items()}

    def fit(name, resume=None):
        return train.TorchTrainer(
            loop, train_loop_config={"scratch": os.path.join(root, f"{name}-scratch")},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name=name, storage_path=root),
            datasets={"train": Rows(range(10))}, resume_from_checkpoint=resume).fit()

    first = fit("first")
    losses, final = dict(seen["losses"]), seen["final"]
    dist.barrier()
    kept = os.path.join(first.path, "checkpoint_000000")
    second = fit("second", resume=train.Checkpoint(kept))
    dist.barrier()
    listing = lambda path: sorted(os.listdir(path))
    return dict(
        jax_loaded="jax" in sys.modules,
        errors=[first.error, second.error],
        contexts=seen["contexts"], shards=seen["shards"],
        losses=np.array([losses[i].item() for i in range(STEPS)], np.float32),
        resumed_equal=all(torch.equal(seen["losses"][i], losses[i])
                          for i in range(SAVE_AT, STEPS)),
        blocks_equal=final.keys() == seen["final"].keys() and all(
            torch.equal(seen["final"][k], v) for k, v in final.items()),
        first=dict(history=first.metrics_history, listing=listing(first.path),
                   checkpoint=first.checkpoint and first.checkpoint.path,
                   best=[c.path for c, _ in first.best_checkpoints],
                   kept=listing(kept), shards=listing(os.path.join(kept, "shards")),
                   meta=train.Checkpoint(kept).get_metadata()),
        second=dict(history=second.metrics_history, listing=listing(second.path),
                    checkpoint=second.checkpoint and second.checkpoint.path),
        progress=[len(open(os.path.join(r.path, "progress.jsonl")).readlines())
                  for r in (first, second)])


def test_two_ranks_fit_sharded_checkpoint_and_resume(tmp_path):
    got = run_ranks(_fit_rank, 2, tmp_path, str(tmp_path), timeout=150)
    for rank, r in enumerate(got):
        assert not r["jax_loaded"]
        assert r["errors"] == [None, None], (rank, r["errors"])
        assert r["contexts"] == [(2, rank), (2, rank)]
        assert r["shards"] == [list(range(5 * rank, 5 * rank + 5))] * 2
        assert r["resumed_equal"] and r["blocks_equal"], rank
        assert [m["step"] for m in r["first"]["history"]] == list(range(STEPS))
        assert [m["step"] for m in r["second"]["history"]] == list(range(SAVE_AT, STEPS))
        # rank 0 alone wrote the history and the checkpoint copy
        assert r["progress"] == [STEPS, STEPS - SAVE_AT]
        assert r["first"]["listing"] == [".run_id", "checkpoint_000000", "progress.jsonl"]
        assert r["second"]["listing"] == [".run_id", "progress.jsonl"]
        assert r["first"]["kept"] == [".ray_tpu_ckpt_meta.json", "shards"]
        assert r["first"]["shards"] == ["layout.json", "rank-00000.pt", "rank-00001.pt"]
        assert r["first"]["meta"]["metrics"]["step"] == SAVE_AT - 1
    # the losses are the global batch's (pmean), so equal on both ranks
    assert np.array_equal(got[0]["losses"], got[1]["losses"])
    assert got[0]["first"]["history"] == got[1]["first"]["history"]
    kept = os.path.join(str(tmp_path), "first", "checkpoint_000000")
    assert got[0]["first"]["checkpoint"] == kept and got[0]["first"]["best"] == [kept]
    assert got[1]["first"]["checkpoint"] is None and got[1]["first"]["best"] == []
    # the second fit's start is its resume checkpoint on every rank
    assert got[0]["second"]["checkpoint"] == got[1]["second"]["checkpoint"] == kept


def _fail_rank(rank, world, store, root):
    import time

    import torch
    import torch.distributed as dist
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import distributed as tdist
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")

    def loop():
        for i in range(4):
            if rank == 1 and i == 2:
                raise RuntimeError("rank 1 fails at step 2")
            total = torch.ones(1)
            dist.all_reduce(total)
            train.report({"step": i, "total": float(total)})

    def fit(**run_fields):
        return train.TorchTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=world),
            run_config=train.RunConfig(name="fail", storage_path=root, **run_fields)).fit()

    try:
        fit(failure_config=train.FailureConfig(max_failures=1))
        retries = None
    except ValueError as e:
        retries = str(e)
    start = time.monotonic()
    try:
        fit()
        return dict(retries=retries, raised=None)
    except train.TrainingFailedError as e:
        return dict(retries=retries, raised=str(e).splitlines()[0],
                    cause=(type(e.__cause__).__name__, str(e.__cause__)),
                    seconds=time.monotonic() - start)


def test_a_failing_rank_makes_fit_raise_on_every_rank(tmp_path):
    got = run_ranks(_fail_rank, 2, tmp_path, str(tmp_path), timeout=60)
    for rank, r in enumerate(got):
        assert r["retries"].startswith("FailureConfig(max_failures=1) with ScalingConfig("
                                       "num_workers=2)"), r["retries"]
        assert r["raised"] == f"train rank {rank} of 2 failed:", (rank, r["raised"])
        assert r["seconds"] < 30, (rank, r["seconds"])
    assert got[1]["cause"] == ("RuntimeError", "rank 1 fails at step 2")
    assert got[0]["cause"] != got[1]["cause"]       # the collective's error
    history = open(os.path.join(str(tmp_path), "fail", "progress.jsonl")).readlines()
    assert len(history) == 2
