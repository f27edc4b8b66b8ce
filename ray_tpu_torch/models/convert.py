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

`flax_rl_module_to_state_dict` does the same for an RLModule's flax
params (`ray_tpu.rllib.RLModule.init`'s tree) into the state_dict of
`ray_tpu_torch.rllib.rl_module.PolicyValueNet`: flax's auto-named torso
(`MLPTorso_0` or `CNNTorso_0`) becomes `torso`, Dense kernels are
transposed, Conv kernels go from HWIO to OIHW, and `log_std` passes
through. (`flax_to_state_dict` would call `.t()` on a 4-D conv kernel.)
The off-policy algorithms' weights go the same way, a net at a time:
`flax_qnet_to_state_dict` (DQN's QNet, dueling heads and `epsilon`),
`flax_sac_to_state_dict` (SAC's and CQL's weight dict, and IQL's with its
value net) and `flax_tqc_to_state_dict` (the stacked critics keep their
leading n_critics dim and flax's [n, in, out] kernels).

`init_params` fills a model from a `torch.Generator` the way the flax
initializers do (normal with std 0.02 for kernels and the embedding, ones
for norm scales), for runs with no JAX params.

On a mesh: `shard_state_dict` takes this rank's blocks of a whole
state_dict (the shard-local model's state_dict), and
`init_params_sharded` draws `init_params`'s values one whole parameter at
a time and keeps this rank's block, so a shard-local model is bitwise
the blocks of the unsharded seeded model, and no rank ever holds more
than one whole parameter.
"""

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.parallel import sharding as _sharding


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


_RL_TORSOS = ("MLPTorso_0", "CNNTorso_0")


def flax_rl_module_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax RLModule params (with or without the top-level "params" key) ->
    the port's PolicyValueNet state_dict, on the CPU."""
    tree = params["params"] if "params" in params else params
    out = {}
    for path, value in _flatten(tree):
        head, _, rest = path.partition("/")
        if head in _RL_TORSOS:
            path = "torso/" + rest
        t = _to_tensor(value)
        if path.endswith("/kernel"):
            key = path[:-len("/kernel")].replace("/", ".") + ".weight"
            t = (t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()).contiguous()
        else:
            key = path.replace("/", ".")
        out[key] = t
    return out


def flax_qnet_to_state_dict(weights: Mapping) -> Dict[str, torch.Tensor]:
    """JAX's DQN weights `{"params": QNet variables, "epsilon"}` -> the
    port's QNet state_dict (the torso, the `q` head or the dueling `adv` and
    `val` heads, and the `epsilon` buffer), on the CPU."""
    out = flax_rl_module_to_state_dict(weights["params"])
    out["epsilon"] = _to_tensor(weights["epsilon"]).reshape(())
    return out


def _flax_stacked_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A vmapped flax MLP's params (leaves [n, ...]) -> the port's stacked
    layers, which keep flax's [n, in, out] kernels."""
    tree = params["params"] if "params" in params else params
    out = {}
    for path, value in _flatten(tree):
        head, _, rest = path.partition("/")
        key = ("torso/" + rest) if head in _RL_TORSOS else path
        out[key.replace("/", ".")] = _to_tensor(value)
    return out


_SAC_NETS = ("actor", "q1", "q2", "q1_target", "q2_target", "value")


def flax_sac_to_state_dict(weights: Mapping) -> Dict[str, torch.Tensor]:
    """JAX's SAC / CQL weights `{actor, q1, q2, q1_target, q2_target,
    log_alpha}` (IQL's also hold the value net `value`) -> the port's
    `SACNet` / `IQLNet` state_dict, on the CPU. log_alpha is 0-d."""
    out = {}
    for name in _SAC_NETS:
        if name in weights:
            out.update({f"{name}.{k}": v
                        for k, v in flax_rl_module_to_state_dict(weights[name]).items()})
    out["log_alpha"] = _to_tensor(weights["log_alpha"]).reshape(())
    return out


def flax_tqc_to_state_dict(weights: Mapping) -> Dict[str, torch.Tensor]:
    """JAX's TQC weights `{actor, critics, critics_target, log_alpha}`, the
    critics stacked with leading dim n_critics -> the port's `TQCNet`
    state_dict, on the CPU."""
    out = {f"actor.{k}": v for k, v in flax_rl_module_to_state_dict(weights["actor"]).items()}
    for name in ("critics", "critics_target"):
        out.update({f"{name}.{k}": v
                    for k, v in _flax_stacked_to_state_dict(weights[name]).items()})
    out["log_alpha"] = _to_tensor(weights["log_alpha"]).reshape(())
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


def _draw(name: str, t: torch.Tensor, generator: torch.Generator, std: float):
    if name.endswith("scale"):
        t.fill_(1.0)
    else:
        t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Seeded init: normal(0, std) for Dense weights and the embedding,
    ones for norm scales. The generator must live on the model's device."""
    for name, p in model.named_parameters():
        _draw(name, p, generator, std)
    return model


def shard_state_dict(sd: Mapping[str, torch.Tensor], mesh,
                     rules=None) -> Dict[str, torch.Tensor]:
    """This rank's blocks of the whole state_dict `sd` (for example
    `flax_to_state_dict(jax_params)`) under `rules` (`llama_rules()` by
    default) on `mesh`: views of `sd`'s tensors, for the shard-local
    model's `load_state_dict`."""
    rules = rules or _sharding.llama_rules()
    out = {}
    for key, t in sd.items():
        path = key.replace(".", "/")
        spec = _sharding._filter_axes(rules.spec_for(path, t), mesh)
        out[key] = _sharding.local_slice(t, spec, mesh)
    return out


@torch.no_grad()
def init_params_sharded(model: nn.Module, full_shapes: Iterable[Tuple[str, torch.Size]],
                        generator: torch.Generator, mesh, rules=None, std: float = 0.02):
    """`init_params` for a shard-local model: `full_shapes` are the unsharded
    model's (name, shape) pairs in its parameter order; each whole parameter
    is drawn on the model's device from `generator`, this rank's block is
    kept and the rest freed."""
    rules = rules or _sharding.llama_rules()
    local = dict(model.named_parameters())
    for name, shape in full_shapes:
        p = local[name]
        whole = torch.empty(shape, dtype=p.dtype, device=p.device)
        _draw(name, whole, generator, std)
        spec = _sharding._filter_axes(rules.spec_for(name.replace(".", "/"), whole), mesh)
        p.copy_(_sharding.local_slice(whole, spec, mesh))
        del whole
    return model
