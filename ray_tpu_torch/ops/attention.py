"""Plain PyTorch attention, RoPE and KV-cache decode attention.

Counterpart of `ray_tpu/ops/attention.py`. These functions have no hand
kernel (the JAX package has none for them either): the continuation
prefill and the dense KV cache run them as they are, on the CPU and on the
card. Layouts follow the JAX package: [B, T, H, D] activations, GQA through
a grouped head axis, f32 softmax.
"""

import math
from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite: keeps masked softmax rows NaN-free


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               device="cpu"):
    """Precompute (sin, cos) tables, each [max_len, head_dim // 2], f32."""
    freqs = _rope_freqs(head_dim, theta, device)
    angles = torch.arange(max_len, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotate-half RoPE. x: [B, T, H, D], positions: [B, T] int.

    Computed in f32 and cast back to x.dtype (bf16 rotation loses precision
    at long context).
    """
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, T, D/2]
    sin = torch.sin(angles)[:, :, None, :]                   # [B, T, 1, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense attention with GQA
# ---------------------------------------------------------------------------

def mha_reference(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, Kh, D] (GQA: H = Kh * groups)
    v: torch.Tensor,  # [B, Tk, Kh, D]
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,  # [B, Tq, Tk] or broadcastable, True=keep
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention, f32 softmax, returns [B, Tq, H, D] in q.dtype.

    `q_offset` shifts query positions for causal masking (decode / chunked
    prefill: queries start at absolute position q_offset).
    """
    b, tq, h, d = q.shape
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"{h} heads not divisible by {kh} kv heads")
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qg = q.reshape(b, tq, kh, g, d)
    # [B, Kh, G, Tq, Tk]
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if causal:
        tk = k.shape[1]
        rows = torch.arange(tq, device=q.device)[:, None] + q_offset
        cols = torch.arange(tk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    if mask is not None:
        keep = mask[:, None, None, :, :] if mask.dim() == 3 else mask
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)
    return out.reshape(b, tq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention over a (pre-allocated) KV cache
# ---------------------------------------------------------------------------

def decode_attention(
    q: torch.Tensor,        # [B, T, H, D] new-token queries
    k_cache: torch.Tensor,  # [B, Smax, Kh, D] cache with the new K already written
    v_cache: torch.Tensor,  # [B, Smax, Kh, D]
    lengths: torch.Tensor,  # [B] int: tokens in cache BEFORE this chunk
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode/chunked-prefill attention against a static-shape cache.

    Query j sits at absolute position lengths+j and attends cache slots
    at or before that position; the whole cache is read and the invalid
    slots masked.
    """
    b, t, h, d = q.shape
    smax, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qg = q.reshape(b, t, kh, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k_cache.float()) * scale
    pos = lengths.to(torch.int64)[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    valid = torch.arange(smax, device=q.device)[None, None, :] <= pos  # [B, T, Smax]
    s = torch.where(valid[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, t, h, d).to(q.dtype)
