"""Training: the Train library's entry point (`TorchTrainer`, the port of
`ray_tpu.train.JaxTrainer`, with its configs and the in-loop session:
report / get_checkpoint / get_context / get_dataset_shard), the Llama
decoder's step (`llm_step.py`, the counterpart of bench.py's flagship
training step), the checkpoint and the device feed, and the MPMD
pipeline over the port's actors (`mpmd.py`: `PipelineStage`,
`MPMDPipeline`, `build_pipeline`). The trainer runs its loop in a
restartable actor or a worker group of the port's runtime when one is up
(`trainer.py`).

Names load on first use (as `ray_tpu_torch`'s do): the configs and the
session need no torch, so a Tune trial that only reports starts without
it."""

# name -> the submodule that defines it, imported on first use
_LAZY = {**{name: ".checkpoint" for name in ("Checkpoint",)},
         **{name: ".config" for name in (
             "TRAIN_DATASET_KEY", "BackendConfig", "CheckpointConfig", "DataConfig",
             "FailureConfig", "RunConfig", "ScalingConfig", "SyncConfig",
             "TrainingFailedError")},
         **{name: ".ingest" for name in ("iter_device_batches", "prefetch_iterator")},
         **{name: ".llm_step" for name in ("make_train_step", "train_llama")},
         **{name: ".mpmd" for name in ("MPMDPipeline", "PipelineStage", "build_pipeline",
                                       "sgd")},
         **{name: ".session" for name in ("TrainContext", "TrainingStopped", "get_checkpoint",
                                          "get_context", "get_dataset_shard", "report")},
         **{name: ".trainer" for name in ("Result", "TorchTrainer")}}
_SUBMODULES = ("checkpoint", "config", "ingest", "llm_step", "mpmd", "session", "trainer",
               "worker_group")

__all__ = [
    "BackendConfig", "Checkpoint", "CheckpointConfig", "DataConfig",
    "FailureConfig", "RunConfig", "SyncConfig", "TRAIN_DATASET_KEY",
    "TrainingFailedError",
    "ScalingConfig", "TorchTrainer", "Result", "TrainContext",
    "TrainingStopped", "report", "get_checkpoint", "get_context",
    "get_dataset_shard", "iter_device_batches", "prefetch_iterator",
    "PipelineStage", "MPMDPipeline", "build_pipeline", "sgd", "make_train_step", "train_llama",
]


def __getattr__(name):
    import importlib
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(f"module 'ray_tpu_torch.train' has no attribute '{name}'")
    globals()[name] = value
    return value
