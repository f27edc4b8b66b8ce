"""Train worker orchestration: the port's counterpart of
`ray_tpu/train/worker_group.py` (reference:
python/ray/train/v2/_internal/execution/worker_group/worker_group.py).

`run_training` runs the user's train loop under a
session (`session.py`) with report and checkpoint plumbing, a checkpoint
book rebuilt from the experiment dir, and FailureConfig retries that
resume from the newest checkpoint. `TrainWorker` hosts it in an actor
of the port's runtime: `TorchTrainer` makes it a restartable actor (a
crashed process is respawned, `run()` re-executes, and run_training
resumes from the newest on-disk checkpoint) or a worker group with
group restart, splitting the datasets once with `presplit_datasets` and
building a killed run's Result with `result_after_worker_death`.

Multi-worker (`num_workers > 1`) is the process world of
`torch.distributed`, one rank a card: every rank runs the same `fit()`,
as every host does under `jax.distributed` in JAX, and `_world_info`
checks the world exists instead of silently training on 1/N of the
requested compute. Rank 0 owns all disk state (the run-id claim, the
history, the checkpoint copies).
"""

import inspect
import json
import os
import re
import shutil
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.parallel.distributed import (coordinator_endpoint, initialize_multihost,
                                                process_count, process_index)
from ray_tpu_torch.train import session as _session
from ray_tpu_torch.train.checkpoint import Checkpoint, _CheckpointBook
from ray_tpu_torch.train.config import CheckpointConfig, DataConfig, FailureConfig, RunConfig

_PROGRESS_FILE = "progress.jsonl"
_RUN_ID_FILE = ".run_id"
_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")


def _claim_run_dir(exp_dir: str, run_id: str) -> bool:
    """Returns True when this call CONTINUES the run that owns exp_dir (same
    run_id → actor restart / retry → resume from its checkpoints). A
    different run_id claims the dir fresh: prior checkpoints stay on disk
    (their indices are skipped) but are not auto-resumed — a new fit()
    must not silently pick up some earlier run's state."""
    path = os.path.join(exp_dir, _RUN_ID_FILE)
    try:
        with open(path) as f:
            if f.read().strip() == run_id:
                return True
    except OSError:
        pass
    with open(path, "w") as f:
        f.write(run_id)
    # fresh claim: history restarts (file truncated), book starts empty
    try:
        os.remove(os.path.join(exp_dir, _PROGRESS_FILE))
    except OSError:
        pass
    return False


def rebuild_book(exp_dir: str, ckpt_cfg) -> tuple:
    """Reconstruct checkpoint bookkeeping from the experiment dir so a
    restarted worker resumes where the dead one left off. Returns
    (book, next_checkpoint_index)."""
    book = _CheckpointBook(ckpt_cfg)
    entries = []
    if os.path.isdir(exp_dir):
        for name in os.listdir(exp_dir):
            m = _CKPT_RE.match(name)
            if m:
                entries.append((int(m.group(1)), name))
    for _idx, name in sorted(entries):
        ckpt = Checkpoint(os.path.join(exp_dir, name))
        meta = ckpt.get_metadata()
        book.register(ckpt, meta.get("metrics") or {})
    next_idx = max((i for i, _ in entries), default=-1) + 1
    return book, next_idx


def load_history(exp_dir: str) -> list:
    path = os.path.join(exp_dir, _PROGRESS_FILE)
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass  # torn write from a killed worker
    return out


def _append_history(exp_dir: str, metrics: Dict) -> None:
    try:
        with open(os.path.join(exp_dir, _PROGRESS_FILE), "a") as f:
            f.write(json.dumps(metrics, default=str) + "\n")
    except OSError:
        pass


def _splittable(ds) -> bool:
    """A dataset whose `split` takes `equal` (`ray_tpu.data.Dataset`'s
    interface), found by its signature: the port imports no `ray_tpu`
    module, and a str's or a tensor's `split` is another function."""
    split = getattr(ds, "split", None)
    if not callable(split):
        return False
    try:
        return "equal" in inspect.signature(split).parameters
    except (TypeError, ValueError):   # a builtin without a signature
        return False


def _shard_datasets(datasets: Dict[str, Any], data_config,
                    world_size: int, world_rank: int) -> Dict[str, Any]:
    """Per-worker dataset view (ref: train/_internal/data_config.py
    DataConfig.configure): splittable datasets named by
    DataConfig.datasets_to_split ("all" by default) are row-partitioned so
    each rank trains on its own shard; everything else (lists, arrays,
    other iterables) replicates."""
    if world_size <= 1 or not datasets:
        return dict(datasets)
    cfg = data_config or DataConfig()
    split = set(cfg.split_names(list(datasets)))
    out = {}
    for name, ds in datasets.items():
        if name in split and _splittable(ds):
            # equal=True: unequal shards would run different numbers of
            # batches per rank, deadlocking any per-batch collective
            out[name] = ds.split(world_size, equal=True)[world_rank]
        else:
            out[name] = ds
    return out


def presplit_datasets(datasets: Dict[str, Any], data_config,
                      n: int) -> list:
    """Driver-side: split each to-be-split dataset ONCE into n shards and
    return [datasets-for-rank-0, ..., datasets-for-rank-n-1]; replicated
    entries appear in every rank's dict."""
    cfg = data_config or DataConfig()
    split = set(cfg.split_names(list(datasets or {})))
    per_rank = [dict() for _ in range(n)]
    for name, ds in (datasets or {}).items():
        if name in split and _splittable(ds):
            parts = ds.split(n, equal=True)
            for r in range(n):
                per_rank[r][name] = parts[r]
        else:
            for r in range(n):
                per_rank[r][name] = ds
    return per_rank


def run_training(train_loop: Callable, train_loop_config: Dict,
                 scaling, run_cfg: RunConfig,
                 datasets: Dict[str, Any],
                 resume_ckpt_path: Optional[str],
                 run_id: str,
                 data_config=None) -> Dict[str, Any]:
    """Runs `train_loop` under a session with
    report/checkpoint plumbing, retrying per FailureConfig. Runs either
    in-process or inside a TrainWorker actor. Returns a picklable result
    dict; Checkpoints travel as paths.

    `run_id` scopes disk state to ONE logical fit(): a re-invocation with the
    same id (actor restart) resumes from the dir's checkpoints; a different
    id starts fresh instead of adopting a previous run's state."""
    exp_dir = run_cfg.experiment_dir()
    ckpt_cfg = run_cfg.checkpoint_config or CheckpointConfig()
    fail_cfg = run_cfg.failure_config or FailureConfig()
    world_size, world_rank = _world_info(scaling)
    if world_size > 1:
        # group mode: a re-running rank would issue collectives its peers
        # are not in — fail fast instead of retrying locally
        fail_cfg = FailureConfig(max_failures=0)
    # rank 0 owns ALL disk state (run-id claim, history, checkpoints);
    # other ranks writing the shared dir would duplicate/garble it
    resuming = _claim_run_dir(exp_dir, run_id) if world_rank == 0 else True
    book, next_idx = rebuild_book(exp_dir, ckpt_cfg)
    if not resuming:
        book = _CheckpointBook(ckpt_cfg)  # prior ckpts stay but aren't ours

    history = load_history(exp_dir) if resuming else []
    ckpt_counter = [next_idx]

    def _should_stop(metrics: Dict[str, Any]) -> bool:
        stop = run_cfg.stop
        if not stop:
            return False
        if callable(stop):
            return bool(stop(metrics))
        return any(key in metrics and metrics[key] >= threshold
                   for key, threshold in stop.items())

    def report_fn(metrics: Dict[str, Any], ckpt: Optional[Checkpoint]):
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", len(history) + 1)
        history.append(metrics)
        if world_rank == 0:
            _append_history(exp_dir, metrics)
        if ckpt is not None and world_rank == 0:
            dst = os.path.join(exp_dir, f"checkpoint_{ckpt_counter[0]:06d}")
            ckpt_counter[0] += 1
            meta = {"iteration": metrics["training_iteration"], "metrics": _jsonable(metrics)}
            if os.path.abspath(ckpt.path) != os.path.abspath(dst):
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                # a sharded checkpoint is whole here (from_state returns
                # after every rank wrote); its shards/ dir and layout go
                # along. The copy lands under its name whole or not at all:
                # a worker killed mid-copy (a group's peer died) leaves a
                # partial directory that the book never reads
                partial = f"{dst}.partial"
                shutil.rmtree(partial, ignore_errors=True)
                shutil.copytree(ckpt.path, partial)
                Checkpoint(partial).update_metadata(meta)
                os.replace(partial, dst)
                ckpt = Checkpoint(dst)
            else:
                ckpt.update_metadata(meta)
            book.register(ckpt, metrics)
        sess = _session._get_session()
        sess.checkpoint = book.latest or sess.checkpoint
        if _should_stop(metrics):
            sess.stop_requested = True

    def _call_loop():
        sig = inspect.signature(train_loop)
        if len(sig.parameters) == 0:
            return train_loop()
        return train_loop(train_loop_config)

    start_ckpt = Checkpoint(resume_ckpt_path) if resume_ckpt_path else None
    attempts = 0
    error: Optional[BaseException] = None
    error_tb = None
    while True:
        ctx = _session.TrainContext(
            world_size=world_size, world_rank=world_rank,
            local_rank=world_rank, local_world_size=1,
            node_rank=world_rank,
            experiment_name=run_cfg.name or "experiment",
            trial_name=run_cfg.name or "experiment",
            trial_id="train_0", trial_dir=exp_dir)
        _session.init_session(ctx, checkpoint=book.latest or start_ckpt,
                              report_fn=report_fn,
                              dataset_shards=_shard_datasets(
                                  datasets, data_config,
                                  world_size, world_rank))
        try:
            _call_loop()
            error = error_tb = None
            break
        except _session.TrainingStopped:
            error = error_tb = None
            break
        except Exception as e:  # noqa: BLE001 - retried per FailureConfig
            error = e
            error_tb = traceback.format_exc()
            attempts += 1
            limit = fail_cfg.max_failures
            if limit == -1 or attempts <= limit:
                traceback.print_exc()
                # the failed attempt's frames hold its model and optimizer:
                # drop their locals so the retry does not train beside a
                # second copy of the state (type and message are kept)
                traceback.clear_frames(e.__traceback__)
                continue
            break
        finally:
            _session.shutdown_session()

    return _result_dict(exp_dir, book, history, error, error_tb,
                        fallback_ckpt=start_ckpt.path if start_ckpt else None)


def _result_dict(exp_dir: str, book, history, error, error_tb,
                 fallback_ckpt: Optional[str] = None) -> Dict[str, Any]:
    """The run_training return contract — sole constructor, so every caller
    (including an actor-death fallback) stays in sync."""
    return {
        "metrics": dict(history[-1]) if history else None,
        "history": history,
        "latest_ckpt": book.latest.path if book.latest else fallback_ckpt,
        "best_ckpts": [(c.path, s) for s, _, c in book.entries],
        "error": error,
        "error_tb": error_tb,
        "path": exp_dir,
    }


def result_after_worker_death(run_cfg: RunConfig, error,
                              resume_path: Optional[str]) -> Dict[str, Any]:
    """Build a result from on-disk state when the worker actor died beyond
    its restart budget (the caller never received run()'s return)."""
    exp_dir = run_cfg.experiment_dir()
    book, _ = rebuild_book(exp_dir, run_cfg.checkpoint_config
                           or CheckpointConfig())
    return _result_dict(exp_dir, book, load_history(exp_dir), error,
                        traceback.format_exc(), fallback_ckpt=resume_path)


def _jsonable(metrics: Dict) -> Dict:
    out = {}
    for k, v in metrics.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = str(v)
    return out


def _world_info(scaling) -> Tuple[int, int]:
    """(world_size, world_rank). A declared multi-worker run without a live
    process group of that size is an error: it would silently train on
    1/N of the requested compute."""
    if scaling.num_workers <= 1:
        return 1, 0
    count, index = process_count(), process_index()
    if count < scaling.num_workers:
        raise ValueError(
            f"ScalingConfig(num_workers={scaling.num_workers}) but the "
            f"torch.distributed process world has {count} process(es). Initialize "
            f"multi-host first (ray_tpu_torch.parallel.initialize_multihost) or "
            f"set num_workers=1; refusing to silently train on "
            f"1/{scaling.num_workers} of the requested compute.")
    return count, index


def _join_world(coordinator: str, world_size: int, world_rank: int, device="cuda"):
    """Join the job's process group before any collective runs."""
    initialize_multihost(coordinator_address=coordinator, num_processes=world_size,
                         process_id=world_rank, device=device)


class TrainWorker:
    """The worker hosting the train loop (reference: worker_group's
    RayTrainWorker), a plain class: `ray_tpu_torch.remote(num_cpus=1,
    max_restarts=N, max_task_retries=N)(TrainWorker)` makes it a
    restartable actor, whose `run()` resumes from the newest checkpoint on
    disk after a crash. In a group, every rank's worker is given the same
    coordinator (`coordinator_endpoint()` of rank 0) and `run(coordinator)`
    joins the process group on `device` ("cuda": NCCL; "cpu": gloo)
    before the loop touches a card."""

    def __init__(self, loop_blob: bytes, train_loop_config: Dict,
                 scaling, run_cfg: RunConfig,
                 datasets: Dict[str, Any], resume_ckpt_path: Optional[str],
                 run_id: str,
                 world_rank: int = 0, world_size: int = 1,
                 data_config=None, device="cuda"):
        import cloudpickle
        self._loop = cloudpickle.loads(loop_blob)
        self._data_config = data_config
        self._cfg = train_loop_config
        self._scaling = scaling
        self._run_cfg = run_cfg
        self._datasets = datasets
        self._resume = resume_ckpt_path
        self._run_id = run_id
        self._world_rank = world_rank
        self._world_size = world_size
        self._device = device

    def coordinator_endpoint(self) -> str:
        return coordinator_endpoint()

    def _join_world(self, coordinator: str):
        _join_world(coordinator, self._world_size, self._world_rank, device=self._device)

    def run(self, coordinator: Optional[str] = None) -> Dict[str, Any]:
        if coordinator is not None and self._world_size > 1:
            self._join_world(coordinator)
        out = run_training(self._loop, self._cfg, self._scaling,
                           self._run_cfg, self._datasets, self._resume,
                           run_id=self._run_id,
                           data_config=self._data_config)
        if self._world_size > 1 and out.get("error") is not None:
            # group mode: RAISE so the caller's get() fails and tears the
            # whole group down — returning an error dict would leave peer
            # ranks hung in collectives this rank left
            raise RuntimeError(
                f"train worker rank {self._world_rank} failed:\n"
                f"{out.get('error_tb') or out['error']}")
        return out

    def ping(self):
        return "pong"
