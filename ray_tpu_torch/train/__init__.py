"""Training: the Llama decoder's step (`llm_step.py`), the counterpart of
bench.py's flagship training step. The trainer, worker group and
checkpoints of `ray_tpu.train` come with a later slice."""

from ray_tpu_torch.train.llm_step import make_train_step, train_llama

__all__ = ["make_train_step", "train_llama"]
