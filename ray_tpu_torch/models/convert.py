"""Weights for the port's Llama: from a flax param tree, or from a seed.

`flax_to_state_dict` turns the JAX package's param tree, given as nested
dicts of numpy arrays (for example `jax.device_get(server.params)`), into
the state_dict of `ray_tpu_torch.models.llama.Llama`:

- the key is the flax path with "/" as "." (`layers_0/attn/wq/kernel` ->
  `layers_0.attn.wq.weight`);
- a flax Dense kernel is [in, out] and the port's Dense weight is
  [out, in], so kernels are transposed;
- embeddings (`embed/embedding`, used by `attend` as x @ E^T for a tied
  head) and norm scales keep their layout.

`flax_lora_to_port` does the same for a JAX LoRA adapter
(`ray_tpu.models.lora.init_lora`'s tree, as numpy): the factor paths
become state_dict keys, and a = [in, r], b = [r, out], whose product is a
kernel's [in, out] delta, become a = [r, in], b = [out, r], whose product
b @ a is the port weight's [out, in] delta.

`init_params` fills a model from a `torch.Generator` the way the flax
initializers do (normal with std 0.02 for kernels and the embedding, ones
for norm scales), for runs with no JAX params.
"""

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _to_tensor(arr) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # owned and writable
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: move the raw bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax Llama params (with or without the top-level "params" key) ->
    the port's state_dict, on the CPU, in the params' own dtype."""
    tree = params["params"] if "params" in params else params
    out = {}
    for path, value in _flatten(tree):
        t = _to_tensor(value)
        if path.endswith("/kernel"):
            key = path[:-len("/kernel")].replace("/", ".") + ".weight"
            t = t.t().contiguous()
        else:
            key = path.replace("/", ".")
        out[key] = t
    return out


def flax_lora_to_port(lora: Mapping) -> Dict:
    """A JAX adapter {"scale", "factors": {path: {"a", "b"}}} (paths with or
    without the top-level "params/") -> the port's adapter
    (`models/lora.py`), on the CPU."""
    factors = {}
    for path, f in lora["factors"].items():
        path = path[len("params/"):] if path.startswith("params/") else path
        if not path.endswith("/kernel"):
            raise ValueError(f"LoRA factor {path!r} is not on a Dense kernel")
        key = path[:-len("/kernel")].replace("/", ".") + ".weight"
        factors[key] = {"a": _to_tensor(f["a"]).t().contiguous(),
                        "b": _to_tensor(f["b"]).t().contiguous()}
    return {"scale": _to_tensor(lora["scale"]), "factors": factors}


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Seeded init: normal(0, std) for Dense weights and the embedding,
    ones for norm scales. The generator must live on the model's device."""
    for name, p in model.named_parameters():
        if name.endswith("scale"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, std, generator=generator)
    return model
