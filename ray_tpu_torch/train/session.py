"""Per-worker train session: the port's copy of `ray_tpu/train/session.py`
(reference: python/ray/train/_internal/session.py `get_session` /
`train.report` / `train.get_context`).

The session is thread-local state installed by the trainer around the user's
`train_loop_per_worker`. `report()` hands metrics (and optionally a
checkpoint) back to the trainer; the common pattern is
`report(metrics, checkpoint=Checkpoint.from_state({"model":
model.state_dict(), "optim": opt.state_dict(), "step": i}))` every N steps.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:   # the session itself needs no torch
    from ray_tpu_torch.train.checkpoint import Checkpoint

_local = threading.local()


class TrainContext:
    """What `get_context()` exposes inside a train loop (reference:
    ray.train.get_context() → TrainContext)."""

    def __init__(self, world_size=1, world_rank=0, local_rank=0,
                 local_world_size=1, node_rank=0, experiment_name="",
                 trial_name="", trial_id="", trial_dir=""):
        self._world_size = world_size
        self._world_rank = world_rank
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._experiment_name = experiment_name
        self._trial_name = trial_name
        self._trial_id = trial_id
        self._trial_dir = trial_dir

    def get_world_size(self):
        return self._world_size

    def get_world_rank(self):
        return self._world_rank

    def get_local_rank(self):
        return self._local_rank

    def get_local_world_size(self):
        return self._local_world_size

    def get_node_rank(self):
        return self._node_rank

    def get_experiment_name(self):
        return self._experiment_name

    def get_trial_name(self):
        return self._trial_name

    def get_trial_id(self):
        return self._trial_id

    def get_trial_dir(self):
        return self._trial_dir


class _Session:
    def __init__(self, context: TrainContext, checkpoint: Optional[Checkpoint],
                 report_fn, dataset_shards: Optional[Dict[str, Any]] = None):
        self.context = context
        self.checkpoint = checkpoint
        self.report_fn = report_fn
        self.dataset_shards = dataset_shards or {}
        self.iteration = 0
        self.stop_requested = False


def _get_session(required=True) -> Optional[_Session]:
    s = getattr(_local, "session", None)
    if s is None and required:
        raise RuntimeError(
            "No train session active — call inside train_loop_per_worker "
            "(or tune trainable) run by a Trainer/Tuner.")
    return s


def init_session(context: TrainContext, checkpoint=None, report_fn=None,
                 dataset_shards=None) -> _Session:
    s = _Session(context, checkpoint, report_fn or (lambda m, c: None),
                 dataset_shards)
    _local.session = s
    return s


def shutdown_session():
    _local.session = None


# -- public API (ray_tpu_torch.train.{report,get_checkpoint,get_context,...}) --

def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    """Report metrics (and optionally a checkpoint) for this iteration.

    Raises TrainingStopped when the trainer decided to stop (stop
    criteria / scheduler decision).
    """
    s = _get_session()
    s.iteration += 1
    s.report_fn(dict(metrics), checkpoint)
    if s.stop_requested:
        raise TrainingStopped()


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().checkpoint


def get_context() -> TrainContext:
    return _get_session().context


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    shard = s.dataset_shards.get(name)
    if shard is None:
        raise KeyError(f"no dataset shard named {name!r}; "
                       f"have {list(s.dataset_shards)}")
    return shard


class TrainingStopped(Exception):
    """Raised out of report() when the trainer requests early stop; the
    trainer catches it — user loops may also catch it to clean up."""
