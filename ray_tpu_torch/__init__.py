"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute layer.

The package mirrors `ray_tpu`'s layout (`ops/`, `models/`, `serve/`,
`train/`, `parallel/`, `rllib/`, `util/`) and holds the paged Llama
serving engine, the Llama training step and the trainer's world around it
(checkpoints, the device feed, the process group and collective groups),
the mesh layer, and RLlib's core for an NVIDIA H100. Every Pallas kernel of the JAX package has a
CUDA C++ counterpart under `ops/csrc/`, built with nvcc at first use. The package imports torch and numpy only: never
jax, flax or any `ray_tpu` module.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
