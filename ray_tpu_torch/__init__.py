"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute layer.

The package mirrors `ray_tpu`'s layout (`ops/`, `models/`, `serve/`,
`train/`) and holds the paged Llama serving engine and the Llama training
step for an NVIDIA H100. Every Pallas kernel of the JAX package has a
CUDA C++ counterpart under `ops/csrc/`, built with nvcc at first use. The package imports torch and numpy only: never
jax, flax or any `ray_tpu` module.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
