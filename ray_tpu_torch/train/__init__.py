"""Training: the Train library's entry point (`TorchTrainer`, the port of
`ray_tpu.train.JaxTrainer`, with its configs and the in-loop session:
report / get_checkpoint / get_context / get_dataset_shard), the Llama
decoder's step (`llm_step.py`, the counterpart of bench.py's flagship
training step), the checkpoint and the device feed, and the MPMD
pipeline over the port's actors (`mpmd.py`: `PipelineStage`,
`MPMDPipeline`, `build_pipeline`). The trainer runs its loop in a
restartable actor or a worker group of the port's runtime when one is up
(`trainer.py`)."""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (TRAIN_DATASET_KEY, BackendConfig, CheckpointConfig,
                                        DataConfig, FailureConfig, RunConfig, ScalingConfig,
                                        SyncConfig, TrainingFailedError)
from ray_tpu_torch.train.ingest import iter_device_batches, prefetch_iterator
from ray_tpu_torch.train.llm_step import make_train_step, train_llama
from ray_tpu_torch.train.mpmd import MPMDPipeline, PipelineStage, build_pipeline, sgd
from ray_tpu_torch.train.session import (TrainContext, TrainingStopped, get_checkpoint,
                                         get_context, get_dataset_shard, report)
from ray_tpu_torch.train.trainer import Result, TorchTrainer

__all__ = [
    "BackendConfig", "Checkpoint", "CheckpointConfig", "DataConfig",
    "FailureConfig", "RunConfig", "SyncConfig", "TRAIN_DATASET_KEY",
    "TrainingFailedError",
    "ScalingConfig", "TorchTrainer", "Result", "TrainContext",
    "TrainingStopped", "report", "get_checkpoint", "get_context",
    "get_dataset_shard", "iter_device_batches", "prefetch_iterator",
    "PipelineStage", "MPMDPipeline", "build_pipeline", "sgd", "make_train_step", "train_llama",
]
