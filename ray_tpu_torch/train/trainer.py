"""TorchTrainer — the Train entry point, the port's counterpart of
`ray_tpu/train/trainer.py` `JaxTrainer` (reference:
python/ray/train/v2/jax/jax_trainer.py + base_trainer.py BaseTrainer.fit).

Execution model: one process a card. `fit()` runs the loop in process
under `run_training` (`worker_group.py`); with `num_workers > 1` every
rank of a live `torch.distributed` world runs the same `fit()`, as every
host does under `jax.distributed`, and a declared multi-worker run without
that world is an ERROR, not a silent world of one.

Two differences at world > 1, where JAX's group restart is not here: a
FailureConfig with retries is a ValueError (one rank cannot retry alone),
and a failed run raises TrainingFailedError instead of returning a Result,
so that the launcher tears the world down.

JAX's trainer launches a restartable `TrainWorker` actor by default when a
`ray_tpu` runtime is up. The port imports no runtime, so it runs in process
by default; the actor is composed by the caller,
`ray_tpu.remote(...)(TrainWorker)` over
`ray_tpu_torch.train.worker_group.TrainWorker`, whose `run()` returns
run_training's dict.
"""

import dataclasses
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.parallel.distributed import process_count, process_index
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (FailureConfig, RunConfig, ScalingConfig,
                                        TrainingFailedError)
from ray_tpu_torch.train.worker_group import run_training


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
    use_worker_actor: True raises NotImplementedError (the actor runtime
      stays with `ray_tpu`); None or False run in process.
    At `scaling_config.num_workers > 1`, `run_config.failure_config` must
    allow no retry, and a failure raises TrainingFailedError.
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

    def fit(self) -> Result:
        if self.use_worker_actor:
            raise NotImplementedError(
                "TorchTrainer(use_worker_actor=True): the actor runtime stays with "
                "ray_tpu; compose it as ray_tpu.remote(...)(TrainWorker) over "
                "ray_tpu_torch.train.worker_group.TrainWorker and build the Result "
                "with Result.from_run(worker.run())")
        group = self.scaling_config.num_workers > 1
        failures = (self.run_config.failure_config or FailureConfig()).max_failures
        if group and failures != 0:
            # JAX retries a group by restarting all of it (_fit_worker_group);
            # one rank of a world cannot retry alone, its peers are in its
            # collectives
            raise ValueError(
                f"FailureConfig(max_failures={failures}) with ScalingConfig("
                f"num_workers={self.scaling_config.num_workers}): fit() at world > 1 "
                f"cannot retry; restart the whole world (torchrun --max-restarts) "
                f"and resume from the run's newest checkpoint instead")
        resume_path = (self.resume_from_checkpoint.path
                       if self.resume_from_checkpoint else None)
        # one id per logical fit(): a retry in the same fit resumes; a
        # different fit() on the same dir starts fresh
        out = run_training(self.train_loop, self.train_loop_config,
                           self.scaling_config, self.run_config,
                           self.datasets, resume_path, run_id=uuid.uuid4().hex,
                           data_config=self.data_config)
        if group and out["error"] is not None:
            # raise, as TrainWorker.run does: a Result would let this rank
            # carry on while its peers wait in the collectives it left
            raise TrainingFailedError(
                f"train rank {process_index()} of {process_count()} failed:\n"
                f"{out['error_tb'] or out['error']}") from out["error"]
        return Result.from_run(out)
