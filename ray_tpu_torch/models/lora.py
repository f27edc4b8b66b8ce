"""LoRA adapters for the port's Llama, functional style.

Counterpart of `ray_tpu/models/lora.py`. No module surgery: an adapter is
{"scale": alpha/rank, "factors": {key: {"a": [r, in], "b": [out, r]}}},
addressed by the SAME state_dict keys as the base weights (a Dense weight
is [out, in]), and

    effective = params + scale * (b @ a)

is computed by `apply_lora`, a pure function of the two. Training
differentiates through it with respect to the factors only
(`torch.func.functional_call(model, apply_lora(base, lora), args)`), so
the base stays frozen and optimizer state is O(r). `lora_parameters` lists
what an optimizer may update: the factors, never `scale`, which is a
hyperparameter (decoupled weight decay would shrink it like any other
tensor it is given). Serving folds an adapter into a copy of the base with
`merge_lora` and hands it to `LLMServer(params=...)`.

The JAX package keeps a = [in, r] and b = [r, out] for its [in, out]
kernels; `models/convert.py` `flax_lora_to_port` re-keys such an adapter
and transposes its factors, so that either package merges it into the same
weights.
"""

import math
import re
from typing import Any, Dict, List, Mapping, Sequence

import torch

# default: every attention projection and FFN matrix (2-D weights only; the
# MoE banks are 3-D and the router and lm_head do not match)
DEFAULT_TARGETS = (r"(wq|wk|wv|wo)\.weight$",
                   r"(w_gate|w_up|w_down)\.weight$")


def lora_targets(params: Mapping[str, torch.Tensor],
                 patterns: Sequence[str] = DEFAULT_TARGETS) -> List[str]:
    """State_dict keys an adapter covers (2-D weights matching patterns)."""
    pats = [re.compile(p) for p in patterns]
    return [key for key, w in params.items()
            if w.ndim == 2 and any(p.search(key) for p in pats)]


def init_lora(generator: torch.Generator, params: Mapping[str, torch.Tensor],
              rank: int = 8, alpha: float = 16.0,
              patterns: Sequence[str] = DEFAULT_TARGETS) -> Dict[str, Any]:
    """A new adapter over `params` (a state_dict): `a` gaussian / sqrt(in),
    `b` zeros, so it starts as an exact no-op. Factors are f32 leaf tensors
    that require grad, on each weight's device (the generator must live on
    that device)."""
    targets = lora_targets(params, patterns)
    if not targets:
        raise ValueError(f"no params match LoRA patterns {list(patterns)}")
    factors = {}
    for key in targets:
        w = params[key]
        d_out, d_in = w.shape
        a = torch.randn((rank, d_in), generator=generator, dtype=torch.float32,
                        device=w.device) / math.sqrt(d_in)
        b = torch.zeros((d_out, rank), dtype=torch.float32, device=w.device)
        factors[key] = {"a": a.requires_grad_(), "b": b.requires_grad_()}
    return {"scale": torch.tensor(alpha / rank, dtype=torch.float32),
            "factors": factors}


def apply_lora(params: Mapping[str, torch.Tensor], lora) -> Dict[str, torch.Tensor]:
    """effective = params + scale * (b @ a) on adapted keys, the other
    tensors as they are; differentiable with respect to the factors.

    Raises if a factor matches no key: a silently ignored factor would
    serve or train the bare base model under the adapter's name."""
    factors = lora["factors"]
    orphans = set(factors) - set(params)
    if orphans:
        raise ValueError(
            f"LoRA factors match no param path (adapter built against a "
            f"different model?): {sorted(orphans)[:4]}... "
            f"example param paths: {sorted(params)[:2]}")
    scale = lora["scale"].detach()
    out = {}
    for key, w in params.items():
        f = factors.get(key)
        if f is not None:
            delta = (f["b"] @ f["a"]).to(w.dtype)
            w = w + scale.to(device=w.device, dtype=w.dtype) * delta
        out[key] = w
    return out


@torch.no_grad()
def merge_lora(params: Mapping[str, torch.Tensor], lora) -> Dict[str, torch.Tensor]:
    """The adapter folded into a NEW state_dict for serving: every tensor is
    a copy, so the base can go on training or be freed."""
    return {k: v.detach().clone() for k, v in apply_lora(params, lora).items()}


def lora_parameters(lora) -> List[torch.Tensor]:
    """The trainable tensors of an adapter, for an optimizer: every factor,
    and not `scale`."""
    return [f[name] for f in lora["factors"].values() for name in ("a", "b")]


def lora_param_count(lora) -> int:
    return sum(t.numel() for t in lora_parameters(lora))
