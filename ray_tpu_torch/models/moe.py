"""Mixture-of-experts FFN for the Llama family (Mixtral layout).

Counterpart of `ray_tpu/models/moe.py`: GShard/Switch dense dispatch.
Routing builds one-hot `dispatch`/`combine` tensors and the expert bank
runs as batched products over a leading [E, ...] dim, the same static-shape
formulation as the JAX package (no data-dependent gather/scatter of tokens).
On the card the products are cuBLAS batched GEMMs; no hand kernel is
needed, as the JAX version runs them as plain einsums outside any Pallas
kernel.

Capacity: each expert takes at most C = max(1, ceil(capacity_factor * K *
S / E)) tokens (S = B*T tokens of the call); positions are k-major, so
every first choice claims capacity before any second choice. A token over
budget gets a zero combine weight and the block's residual carries it.
Serving forces C = S (dropless, `serve/llm.py`), which makes the bank
compute every expert on every token: E/K times the top-k FLOPs.

Router: f32 input, f32 weight and an f32 product with TF32 off, whatever
the activation dtype and the process's TF32 setting: a near-tie flipped by
rounding changes which experts a token gets. Top-k breaks ties to the
lower expert index, as `jax.lax.top_k` does.

Load balancing: the Switch aux loss E * sum_e f_e * P_e (f_e = share of
tokens whose first choice is e, P_e = mean router prob) is kept on the
module as `aux_loss` after each forward (flax sows it into "losses");
`moe_aux_loss(model, weight)` averages it over the MoE layers.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 with TF32 off for this product only."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    if a.device.type != "cuda":
        return a @ b
    flags = torch.backends.cuda.matmul
    keep = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return a @ b
    finally:
        flags.allow_tf32 = keep


def expert_capacity(capacity_factor: float, top_k: int, n_tokens: int,
                    n_experts: int) -> int:
    """Slots per expert: C = max(1, ceil(capacity_factor * K * S / E))."""
    return max(1, math.ceil(capacity_factor * top_k * n_tokens / n_experts))


def top_k_lower_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index (`jax.lax.top_k`'s order; `torch.topk` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU expert bank; drop-in for llama.MLP ([B,T,D] ->
    [B,T,D]). Parameters keep the flax names: `router.weight` [E, D] (f32),
    `w_gate`/`w_up` [E, D, F] and `w_down` [E, F, D] in param_dtype."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        E, D, F_ = cfg.n_experts, cfg.d_model, cfg.ffn_dim
        self.router = nn.Linear(D, E, bias=False, dtype=torch.float32, device=device)
        bank = lambda *s: nn.Parameter(torch.empty(*s, dtype=cfg.param_dtype,
                                                   device=device))
        self.w_gate = bank(E, D, F_)
        self.w_up = bank(E, D, F_)
        self.w_down = bank(E, F_, D)
        self.aux_loss = None
        self.last_gate_idx = None

    def forward(self, x):
        cfg = self.cfg
        E, K = cfg.n_experts, cfg.moe_top_k
        B, T, D = x.shape
        S = B * T
        dt = cfg.dtype
        xf = x.reshape(S, D)

        logits = _matmul_f32(xf, self.router.weight.t())       # [S, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = top_k_lower_first(probs, K)      # [S, K]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        self.last_gate_idx = gate_idx

        # Switch load-balance aux loss (top-1 assignment shares)
        f_e = F.one_hot(gate_idx[:, 0], E).to(torch.float32).mean(0)
        p_e = probs.mean(0)
        self.aux_loss = E * (f_e * p_e).sum()

        # position of each (token, k) in its expert's queue, k-major
        C = expert_capacity(cfg.capacity_factor, K, S, E)
        sel = F.one_hot(gate_idx, E).transpose(0, 1)           # [K, S, E]
        selk = sel.reshape(K * S, E)
        pos = (selk.cumsum(0) - selk).reshape(K, S, E)
        posk = (pos * sel).sum(-1)                             # [K, S]
        keep = posk < C
        gates = gate_vals.t() * keep                           # [K, S]

        # combine[s, e, c]: gate weight of token s at slot c of expert e.
        # Each (s, e, c) holds at most one (token, k) pair, so writing the
        # gates in place is the JAX einsum exactly; dropped pairs (gate 0)
        # land in an extra column that is cut off.
        combine = torch.zeros(S, E, C + 1, dtype=torch.float32, device=x.device)
        s_idx = torch.arange(S, device=x.device).expand(K, S)
        combine[s_idx, gate_idx.t(), torch.where(keep, posk, C)] = gates
        combine = combine[..., :C]
        dispatch = (combine > 0).to(dt)                        # [S, E, C]

        with torch.profiler.record_function("moe_einsums"):
            expert_in = torch.einsum("sec,sd->ecd", dispatch, xf.to(dt))
            h = torch.bmm(expert_in, self.w_gate.to(dt))       # [E, C, F]
            u = torch.bmm(expert_in, self.w_up.to(dt))
            out = torch.bmm(F.silu(h) * u, self.w_down.to(dt))  # [E, C, D]
            y = torch.einsum("sec,ecd->sd", combine.to(dt), out)
        return y.reshape(B, T, D)


def moe_aux_loss(model: nn.Module, weight: float) -> torch.Tensor:
    """weight x the mean of the MoE layers' aux losses from the last
    forward; 0.0 when the model has no MoE layer."""
    vals = [m.aux_loss for m in model.modules()
            if isinstance(m, MoEMLP) and m.aux_loss is not None]
    if not vals:
        return torch.tensor(0.0)
    return weight * sum(vals) / len(vals)
