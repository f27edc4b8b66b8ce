"""Train configs: the port's copy of `ray_tpu/train/config.py` (reference:
ray.train's ScalingConfig / RunConfig / CheckpointConfig / FailureConfig).

The fields and defaults are JAX's. A worker is one process a card: under
`torch.distributed` every rank runs the same `fit()`, so `num_workers` is
the process world's size. One difference: `as_resources()` claims `"GPU"`
where JAX's claims `"TPU"`, and it reads `use_gpu`, the field JAX accepts
and ignores.
"""

import dataclasses
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How much hardware a trainer uses.

    num_workers: processes in the job's world (one a card). 1 alone.
    use_tpu: accepted for compatibility with JAX's config; not read here.
    use_gpu: claim cards from the scheduler (the `"GPU"` resource).
    chips_per_worker: cards each worker binds; None = 1.
    topology: informational name of the cards' layout.
    resources_per_worker: extra custom resources per worker.
    """
    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = False
    chips_per_worker: Optional[int] = None
    topology: Optional[str] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    @property
    def total_workers(self) -> int:
        return self.num_workers

    def as_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1)
        if self.use_gpu:
            res["GPU"] = self.chips_per_worker or 1
        return res


@dataclasses.dataclass
class CheckpointConfig:
    """Keep-N policy (reference: ray.train.CheckpointConfig)."""
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclasses.dataclass
class FailureConfig:
    """max_failures: retries of the whole train run, resuming from the last
    checkpoint. 0 disables; -1 = unlimited (reference semantics)."""
    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    """Where results/checkpoints land (reference: ray.train.RunConfig)."""
    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 0
    log_to_file: bool = False

    def experiment_dir(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
        name = self.name or "experiment"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path


@dataclasses.dataclass
class BackendConfig:
    """Base class for backend-specific setup (ref: train/backend.py
    BackendConfig). The process group is started by `initialize_multihost`
    (or a `TrainWorker`'s join), so this exists for API-compatible
    subclassing."""


@dataclasses.dataclass
class DataConfig:
    """Which datasets split across train workers vs replicate (ref:
    train/_internal/data_config.py DataConfig); "all" splits every dataset
    that can be split."""
    datasets_to_split: object = "all"   # "all" | list of dataset names

    def split_names(self, names):
        if self.datasets_to_split == "all":
            return list(names)
        return [n for n in names if n in set(self.datasets_to_split)]


@dataclasses.dataclass
class SyncConfig:
    """Checkpoint/artifact sync settings (ref: train/_internal/syncer.py);
    these knobs gate artifact syncing."""
    sync_artifacts: bool = False
    sync_period: int = 300


TRAIN_DATASET_KEY = "train"


class TrainingFailedError(RuntimeError):
    """Raised/recorded when a training run fails permanently (ref:
    ray.train.base_trainer.TrainingFailedError). TorchTrainer.fit returns
    the failure in Result.error at world 1, and raises it wrapped in this
    type at world > 1."""
