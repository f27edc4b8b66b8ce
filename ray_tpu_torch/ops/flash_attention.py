"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Counterpart of `ray_tpu/ops/flash_attention.py`: the three Pallas kernels
and the `_flash` custom_vjp that ties them together.

Kernels (CUDA C++, sm_90a), each with one route per dtype:
- `csrc/flash_fwd.cu` replaces `_fwd_kernel` (launched by `_flash_fwd`) and
  returns out and the f32 logsumexp, as that kernel does. One CTA per
  (b, h, 64-row query tile) loops over 64-key tiles up to the causal
  diagonal with an online f32 softmax. bf16 runs on the tensor cores
  (wgmma products, K and V through a cp.async ring, P rounded to bf16 in
  registers before P·V: the one rounding point `_fwd_kernel` does not
  have); f32 runs scalar FMAs.
- `csrc/flash_bwd.cu` replaces `_bwd_dq_kernel` and `_bwd_dkv_kernel`
  (launched by `_flash_bwd`): dQ with one CTA per (b, h, query tile)
  looping over key tiles, dK/dV with one CTA per (b, kv head, key tile)
  looping over the G query heads and the query tiles. Sums stay in
  registers: no atomics, deterministic results. In bf16 both run on the
  tensor cores with the TPU kernels' own roundings: dQ on wgmma (S and dP
  from shared memory, dS rounded to bf16 in registers as the A operand of
  dS·K, K and V through a cp.async ring), dK/dV on mma.sync (P and dS to
  bf16); f32 dQ and dK/dV run scalar FMAs.
Rows and columns past T and S are masked in the kernels, so any T runs on
them: the port has no counterpart of the JAX wrapper's O(T^2) fallback.
The bf16 routes copy rows with 16-byte cp.async, so a bf16 CUDA call needs
the layout `check_bf16_layout` accepts, and raises otherwise.

Bound on the H100: compute at long T (forward 4, dQ 6, dK/dV 8 flops per
head dim and (query, key) pair inside the causal area), and at the serving
prefill chunks (T <= 128) launch latency.

`flash_attention` routes a call that needs a gradient through
`_FlashAttention`, whose backward computes delta = rowsum(dO * O) once and
runs dQ then dK/dV. A CPU tensor takes the plain PyTorch versions
(`flash_attention_reference`, `flash_attention_bwd_reference`), a CUDA
tensor the kernels; neither ever falls back to the other.
"""

import math
from typing import Optional

import torch

from ray_tpu_torch.ops import _build

# kernel launches since the counts were last reset (chip_smoke.py resets them)
LAUNCHES = 0          # forward (flash_fwd.cu)
BWD_DQ_LAUNCHES = 0   # dQ (flash_bwd.cu)
BWD_DKV_LAUNCHES = 0  # dK/dV (flash_bwd.cu)


def _grouped_scores(q, k, causal, scale):
    """f32 scores [B, Kh, G, T, S] of q [B, T, H, D] against k [B, S, Kh, D],
    -inf above the causal diagonal."""
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, t, kh, h // kh, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if causal:
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(s_len, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    return s


def flash_attention_reference(q, k, v, causal: bool = True,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """Plain PyTorch version of the forward kernel: f32 scores, f32 softmax
    and f32 P·V, out cast to q's dtype; lse [B, H, T] in f32.

    q: [B, T, H, D]; k, v: [B, S, Kh, D]. Causal masks column j > row i.
    """
    b, t, h, d = q.shape
    kh = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _grouped_scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)                       # [B, Kh, G, T]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    out = out.reshape(b, t, h, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b, h, t)
    return out


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal: bool = True,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the two backward kernels, in their order and
    with their rounding points (`ray_tpu/ops/flash_attention.py:166, :205,
    :211, :232`): delta = rowsum(f32(dO) f32(O)); P = exp(S scale - lse) in
    f32; dS = P (dP - delta) scale cast to the input dtype; P cast to the
    input dtype before dV; f32 sums, each gradient cast once at the end.
    dK and dV sum the G query heads of each kv head.

    q, out, do: [B, T, H, D]; k, v: [B, S, Kh, D]; lse: [B, H, T] f32.
    Returns (dq, dk, dv) in q's, k's and v's dtypes.
    """
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    grouped = lambda x: x.float().reshape(b, t, kh, g, d)
    delta = (do.float() * out.float()).sum(-1)             # [B, T, H]
    delta = delta.reshape(b, t, kh, g).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(_grouped_scores(q, k, causal, scale)
                  - lse.reshape(b, kh, g, t)[..., None])   # [B, Kh, G, T, S]
    dp = torch.einsum("btkgd,bskd->bkgts", grouped(do), v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float()).reshape(b, t, h, d)
    dk = torch.einsum("bkgts,btkgd->bskd", ds, grouped(q))
    dv = torch.einsum("bkgts,btkgd->bskd", p.to(q.dtype).float(), grouped(do))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    if q.dtype == torch.bfloat16:
        check_bf16_layout(q=q, k=k, v=v)


def _bf16_layout_ok(x) -> bool:
    return x.data_ptr() % 16 == 0 and all(
        x.stride(i) % 8 == 0 for i in range(3) if x.shape[i] > 1)


def check_bf16_layout(**tensors):
    """The bf16 kernels copy each row of q, k, v and dO with 16-byte
    cp.async: every tensor needs a 16-byte aligned base pointer and batch,
    sequence and head strides that are multiples of 8 elements (a stride of
    an axis of size 1 is never used). Raises ValueError naming the first
    tensor that has neither; the model's q, k, v and autograd's dO have
    both."""
    for name, x in tensors.items():
        if not _bf16_layout_ok(x):
            raise ValueError(
                f"bf16 flash kernel needs 16-byte aligned {name} with batch, sequence "
                f"and head strides a multiple of 8 elements, got data_ptr % 16 = "
                f"{x.data_ptr() % 16}, strides {tuple(x.stride())}")


def _device_of(*xs) -> torch.device:
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"flash_attention inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    return dev


def _strides(x):
    return x.stride(0), x.stride(1), x.stride(2)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Forward pass returning (out [B, T, H, D] in q's dtype, lse [B, H, T] f32).
    Not differentiable on the card: `flash_attention` is."""
    if _device_of(q, k, v).type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, return_lse=True)
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
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        float(scale), int(bool(causal)), _build.stream_handle(q.device))
    _build.check(code, "flash_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def bwd_delta(out, do):
    """delta = rowsum(f32(dO) f32(O)) as the backward kernels read it:
    contiguous [B, H, T] f32 (the JAX package computes it outside its
    kernels too, `flash_attention.py:232`)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def launch_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ kernel on CUDA tensors (inputs checked by `flash_attention_bwd`)."""
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    code = _build.load_library().rtt_flash_bwd_dq(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, t, s_len, h, kh, d, *_strides(q), *_strides(k), *_strides(v),
        *_strides(do), *_strides(dq), float(scale), int(bool(causal)),
        _build.stream_handle(q.device))
    _build.check(code, "flash_bwd_dq")
    global BWD_DQ_LAUNCHES
    BWD_DQ_LAUNCHES += 1
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK/dV kernel on CUDA tensors (inputs checked by `flash_attention_bwd`)."""
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    dk = torch.empty((b, s_len, kh, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s_len, kh, d), dtype=v.dtype, device=v.device)
    code = _build.load_library().rtt_flash_bwd_dkv(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, s_len, h, kh, d, *_strides(q), *_strides(k), *_strides(v),
        *_strides(do), *_strides(dk), *_strides(dv), float(scale), int(bool(causal)),
        _build.stream_handle(q.device))
    _build.check(code, "flash_bwd_dkv")
    global BWD_DKV_LAUNCHES
    BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) from the forward's inputs, out and lse and the gradient
    dO of out. CUDA tensors: delta once, then the dQ and the dK/dV kernels.
    dO is read through its strides; it is copied only when its last axis
    is not contiguous or, in bf16, its layout is not one
    `check_bf16_layout` accepts."""
    if _device_of(q, k, v, out, lse, do).type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal, scale)
    _check_inputs(q, k, v)
    b, t, h, d = q.shape
    if out.shape != q.shape or do.shape != q.shape or not (
            out.dtype == do.dtype == q.dtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dO {tuple(do.shape)} "
                         f"{do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, T] f32, got {tuple(lse.shape)} {lse.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not _bf16_layout_ok(do)):
        do = torch.empty_like(do, memory_format=torch.contiguous_format).copy_(do)
    lse = lse.contiguous()
    delta = bwd_delta(out, do)
    dq = launch_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The `_flash` custom_vjp: the forward keeps q, k, v, out and lse; the
    backward recomputes P from lse in the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention in [B, T, H, D] layout (matches `mha_reference`).

    q: [B, T, H, D]; k, v: [B, S, Kh, D] with H a multiple of Kh. A call
    that needs a gradient goes through `_FlashAttention`.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
