"""Flash attention forward: hand-written CUDA kernel and its plain version.

Counterpart of `ray_tpu/ops/flash_attention.py` (forward only; the two
backward kernels come with the training slice).

Kernel: `csrc/flash_fwd.cu` (CUDA C++, sm_90a). It replaces
`ray_tpu/ops/flash_attention.py::_fwd_kernel` (launched by `_flash_fwd`)
and returns out and the f32 logsumexp, as that kernel does. One CTA per
(b, h, 64-row query tile) loops over 64-key tiles up to the causal
diagonal with an online f32 softmax; rows and columns past T and S are
masked in the kernel, so any T runs on it.

Bound on the H100: compute at long T (4 T^2 H D / 2 flops causal), and at
the serving prefill chunks (T <= 128) the work is a few microseconds, so
launch latency dominates. Left for later: tensor-core products (mma.sync or
wgmma), TMA loads into a multi-stage ring, and the backward kernels.

`flash_attention` takes a CPU tensor to `flash_attention_reference`, the
plain PyTorch version, and a CUDA tensor to the kernel; it never falls back
from one to the other.
"""

import math
from typing import Optional

import torch

from ray_tpu_torch.ops import _build

# kernel launches since the count was last reset (chip_smoke.py resets it)
LAUNCHES = 0


def flash_attention_reference(q, k, v, causal: bool = True,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """Plain PyTorch version of the kernel: f32 scores, f32 softmax and f32
    P·V, out cast to q's dtype; lse [B, H, T] in f32.

    q: [B, T, H, D]; k, v: [B, S, Kh, D]. Causal masks column j > row i.
    """
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, t, kh, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if causal:
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(s_len, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                       # [B, Kh, G, T]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    out = out.reshape(b, t, h, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b, h, t)
    return out


def _check_inputs(q, k, v):
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("flash_attention takes [B, T, H, D] q and [B, S, Kh, D] k, v")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} heads not divisible by {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in (16, 32, 64, 128):
        raise ValueError(f"flash kernel takes head_dim 16, 32, 64 or 128, got {q.shape[3]}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous last (head_dim) axis")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash kernel needs T >= 1 and S >= 1")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Forward pass returning (out [B, T, H, D] in q's dtype, lse [B, H, T] f32)."""
    devices = {x.device for x in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v must share one device, got {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("backward kernels: later slice")
    _check_inputs(q, k, v)
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    code = lib.rtt_flash_fwd(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, t, s_len, h, kh, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        float(scale), int(bool(causal)), _build.stream_handle(q.device))
    _build.check(code, "flash_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention in [B, T, H, D] layout (matches `mha_reference`).

    q: [B, T, H, D]; k, v: [B, S, Kh, D] with H a multiple of Kh.
    """
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
