"""TorchTrainer — the Train entry point, the port's counterpart of
`ray_tpu/train/trainer.py` `JaxTrainer` (reference:
python/ray/train/v2/jax/jax_trainer.py + base_trainer.py BaseTrainer.fit).

Execution model: one process a card. Where the loop runs:
- in a restartable `TrainWorker` actor of the port's runtime when
  `use_worker_actor` is True, or None with `ray_tpu_torch.is_initialized()`
  (JAX's default). The actor claims `"GPU"` from `use_gpu`, as
  `ScalingConfig.as_resources` does; a crashed process is respawned on a
  card and resumes from the newest checkpoint on disk, up to
  `FailureConfig.max_failures` times;
- with `num_workers > 1` in that mode, in a worker group: one
  `TrainWorker` a bundle of a placement group, rank 0 picks the process
  group's address, and every rank joins one world (NCCL when the bundle
  claims a card, gloo otherwise). Any rank's death tears the whole group
  down, and `max_failures` counts group restarts, each resuming from the
  newest checkpoint, as JAX's `_fit_worker_group` does;
- in process otherwise, under `run_training` (`worker_group.py`). There,
  with `num_workers > 1`, every rank of a live `torch.distributed` world
  (torchrun, `spawn_ranks`) runs the same `fit()`, as every host does
  under `jax.distributed`, and a declared multi-worker run without that
  world is an ERROR, not a silent world of one. One rank of such a world
  cannot retry alone, so a FailureConfig with retries is a ValueError
  and a failed run raises TrainingFailedError instead of returning a
  Result, so that the launcher tears the world down.
"""

import dataclasses
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.parallel.distributed import process_count, process_index
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (FailureConfig, RunConfig, ScalingConfig,
                                        TrainingFailedError)
from ray_tpu_torch.train.worker_group import (TrainWorker, presplit_datasets,
                                              result_after_worker_death, run_training)

# seconds a group retry waits for the cluster to hold its bundles again
GROUP_REPLACE_WAIT_S = 120.0


@dataclasses.dataclass
class Result:
    """What fit() returns (reference: ray.train.Result)."""
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException]
    path: str
    metrics_history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    best_checkpoints: List = dataclasses.field(default_factory=list)

    @property
    def metrics_dataframe(self):
        import pandas as pd
        return pd.DataFrame(self.metrics_history)

    @classmethod
    def from_run(cls, out: Dict[str, Any]) -> "Result":
        """The Result of run_training's (or `TrainWorker.run()`'s) dict."""
        return cls(
            metrics=out["metrics"],
            checkpoint=Checkpoint(out["latest_ckpt"]) if out["latest_ckpt"] else None,
            error=out["error"],
            path=out["path"],
            metrics_history=out["history"],
            best_checkpoints=[(Checkpoint(p), s) for p, s in out["best_ckpts"]],
        )


class TorchTrainer:
    """Runs `train_loop_per_worker(config)` under a train session.

    train_loop_per_worker: fn() or fn(config) calling
      `ray_tpu_torch.train.report(...)` to emit metrics/checkpoints.
    datasets: {name: Dataset-or-iterable} surfaced via
      `train.get_dataset_shard(name)`; at world > 1 a dataset whose
      `split` takes `equal` is split into a shard a rank.
    use_worker_actor: run the loop in a restartable actor of the port's
      runtime (a worker group at num_workers > 1). Default: yes when
      `ray_tpu_torch.is_initialized()`, in process otherwise.
    In process at `scaling_config.num_workers > 1`,
    `run_config.failure_config` must allow no retry, and a failure raises
    TrainingFailedError.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        use_worker_actor: Optional[bool] = None,
        data_config=None,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.data_config = data_config
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.use_worker_actor = use_worker_actor

    def _in_actor(self) -> bool:
        if self.use_worker_actor is not None:
            return self.use_worker_actor
        import ray_tpu_torch
        return ray_tpu_torch.is_initialized()

    def fit(self) -> Result:
        resume_path = (self.resume_from_checkpoint.path
                       if self.resume_from_checkpoint else None)
        # one id per logical fit(): an actor restart or a retry re-runs with
        # the same id and resumes; a different fit() on the same dir starts
        # fresh
        run_id = uuid.uuid4().hex
        if self._in_actor():
            if self.scaling_config.num_workers > 1:
                return Result.from_run(self._fit_worker_group(resume_path, run_id))
            return Result.from_run(self._fit_in_actor(resume_path, run_id))
        group = self.scaling_config.num_workers > 1
        failures = (self.run_config.failure_config or FailureConfig()).max_failures
        if group and failures != 0:
            # one rank of a world cannot retry alone, its peers are in its
            # collectives; the worker group restarts all of it
            raise ValueError(
                f"FailureConfig(max_failures={failures}) with ScalingConfig("
                f"num_workers={self.scaling_config.num_workers}): fit() in process at "
                f"world > 1 cannot retry; use the worker group (use_worker_actor=True "
                f"under ray_tpu_torch.init) or restart the whole world (torchrun "
                f"--max-restarts) and resume from the run's newest checkpoint")
        out = run_training(self.train_loop, self.train_loop_config,
                           self.scaling_config, self.run_config,
                           self.datasets, resume_path, run_id=run_id,
                           data_config=self.data_config)
        if group and out["error"] is not None:
            # raise, as TrainWorker.run does: a Result would let this rank
            # carry on while its peers wait in the collectives it left
            raise TrainingFailedError(
                f"train rank {process_index()} of {process_count()} failed:\n"
                f"{out['error_tb'] or out['error']}") from out["error"]
        return Result.from_run(out)

    # ------------------------------------------------------------ actors
    def _worker_bundle(self) -> Dict[str, float]:
        """One worker's claim: a CPU, `"GPU"` from `use_gpu`, and the
        custom resources."""
        return {k: float(v) for k, v in self.scaling_config.as_resources().items()}

    def _actor_options(self) -> Dict[str, Any]:
        """The worker actor's options beside its restarts: the card must be
        on the actor's own spec (not just a bundle) or the controller never
        binds it (`CUDA_VISIBLE_DEVICES` comes from the spec's resources)."""
        opts: Dict[str, Any] = {"num_cpus": 0}
        if self.scaling_config.use_gpu:
            opts["num_gpus"] = self.scaling_config.chips_per_worker or 1
        if self.scaling_config.resources_per_worker:
            opts["resources"] = dict(self.scaling_config.resources_per_worker)
        return opts

    def _worker_device(self) -> str:
        """The worker's process-group device: NCCL over its card when it
        claims one, gloo on the CPU otherwise."""
        return "cuda" if self.scaling_config.use_gpu else "cpu"

    def _place_group(self, n: int, wait_s: float):
        """The group's placement group: STRICT_SPREAD over the nodes when
        there are enough, else SPREAD. A retry waits up to `wait_s` for
        the cluster to hold its bundles again: when a rank's node died, its
        replacement (the reconciler's, or one started by hand) registers
        seconds after the group's failure is seen."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.exceptions import PlacementGroupInfeasibleError
        from ray_tpu_torch.util.placement_group import placement_group

        deadline = time.monotonic() + wait_s
        while True:
            alive = [r for r in rt.nodes() if r.get("alive", True)]
            strategy = "STRICT_SPREAD" if len(alive) >= n else "SPREAD"
            try:
                return placement_group([self._worker_bundle() for _ in range(n)],
                                       strategy=strategy)
            except PlacementGroupInfeasibleError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)

    def _fit_worker_group(self, resume_path: Optional[str], run_id: str) -> Dict[str, Any]:
        """One TrainWorker a bundle of a placement group (`_place_group`),
        rank 0 picking the process group's address, every rank's fit in
        that one world. Any rank's death tears the group down, and the
        whole group retries per FailureConfig, resuming from the newest
        checkpoint on disk (the shared run_id keeps the resume)."""
        import cloudpickle

        import ray_tpu_torch as rt
        from ray_tpu_torch.util.placement_group import remove_placement_group
        from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

        n = self.scaling_config.num_workers
        limit = (self.run_config.failure_config or FailureConfig()).max_failures
        attempts = 0
        blob = cloudpickle.dumps(self.train_loop)
        Worker = rt.remote(max_restarts=0, **self._actor_options())(TrainWorker)
        # split each dataset once here and ship each rank only its shard
        per_rank = presplit_datasets(self.datasets, self.data_config, n)
        while True:
            pg = None
            workers = []
            try:
                pg = self._place_group(n, GROUP_REPLACE_WAIT_S if attempts else 0.0)
                rt.get(pg.ready(), timeout=120)
                for rank in range(n):
                    strat = PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=rank)
                    workers.append(Worker.options(scheduling_strategy=strat).remote(
                        blob, self.train_loop_config, self.scaling_config, self.run_config,
                        per_rank[rank], resume_path, run_id, world_rank=rank, world_size=n,
                        data_config=None, device=self._worker_device()))
                coordinator = rt.get(workers[0].coordinator_endpoint.remote(), timeout=120)
                outs = _get_first_error([w.run.remote(coordinator) for w in workers])
                # rank 0 owns checkpoints and history; surface the first
                # error any rank hit
                out = outs[0]
                if out.get("error") is None:
                    for o in outs[1:]:
                        if o.get("error") is not None:
                            out["error"], out["error_tb"] = o["error"], o.get("error_tb")
                            break
                return out
            except Exception as e:  # noqa: BLE001 - a rank died: group retry
                attempts += 1
                if limit != -1 and attempts > max(limit, 0):
                    return result_after_worker_death(self.run_config, e, resume_path)
            finally:
                for w in workers:
                    try:
                        rt.kill(w)
                    except Exception:  # noqa: BLE001 - already dead
                        pass
                if pg is not None:
                    try:
                        remove_placement_group(pg)
                    except Exception:  # noqa: BLE001 - best-effort cleanup
                        pass

    def _fit_in_actor(self, resume_path: Optional[str], run_id: str) -> Dict[str, Any]:
        """Launch the TrainWorker actor and await its run(): a crash
        respawns the actor (max_restarts) and re-runs the task
        (max_task_retries), each attempt resuming from the newest
        checkpoint on disk."""
        import cloudpickle

        import ray_tpu_torch as rt

        limit = (self.run_config.failure_config or FailureConfig()).max_failures
        restarts = -1 if limit == -1 else max(limit, 0)
        Worker = rt.remote(max_restarts=restarts, max_task_retries=restarts,
                           **self._actor_options())(TrainWorker)
        worker = Worker.remote(
            cloudpickle.dumps(self.train_loop), self.train_loop_config,
            self.scaling_config, self.run_config, self.datasets, resume_path,
            run_id, data_config=self.data_config, device=self._worker_device())
        try:
            return rt.get(worker.run.remote())
        except Exception as e:  # noqa: BLE001 - actor died beyond retries
            return result_after_worker_death(self.run_config, e, resume_path)
        finally:
            try:
                rt.kill(worker)
            except Exception:  # noqa: BLE001 - already dead
                pass


def _get_first_error(refs) -> List[Any]:
    """Every ref's value, raising as soon as any one fails: a rank that
    died leaves its NCCL peers waiting in a collective, so the group
    cannot wait for them in order."""
    import ray_tpu_torch as rt
    pending = list(refs)
    while pending:
        ready, pending = rt.wait(pending, num_returns=1)
        rt.get(ready)
    return rt.get(list(refs))
