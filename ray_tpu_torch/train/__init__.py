"""Training: the Llama decoder's step (`llm_step.py`), the counterpart of
bench.py's flagship training step, with the checkpoint and the device feed
of `ray_tpu.train`, and one stage of an MPMD pipeline (`mpmd.py`). The
trainer, its worker actors and the pipeline's actor runner are `ray_tpu`'s
runtime: `worker_group.py` holds the functions of it that touch the
process world."""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.ingest import iter_device_batches, prefetch_iterator
from ray_tpu_torch.train.llm_step import make_train_step, train_llama
from ray_tpu_torch.train.mpmd import PipelineStage, sgd

__all__ = ["Checkpoint", "iter_device_batches", "make_train_step", "prefetch_iterator",
           "train_llama", "PipelineStage", "sgd"]
