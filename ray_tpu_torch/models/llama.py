"""Llama-family decoder in PyTorch.

Counterpart of `ray_tpu/models/llama.py` (flax). Design points kept:
- bf16 activations over a configurable param dtype; every Dense casts both
  its input and its weight to the activation dtype before the product, the
  embedding table is cast before the lookup, RMSNorm computes in f32 and
  casts after the scale, RoPE runs in f32, logits come out in f32.
- Parameter names follow the flax param paths (`embed.embedding`,
  `layers_N.attn.wq.weight`, ...); `models/convert.py` carries a flax tree
  across. A Dense weight is stored [out, in], as torch's Linear stores it.
- Attention branches as in the JAX decoder: dense decode, paged decode
  (B4 kernel), paged chunk-local prefill (B1 kernel) and paged continuation
  (page gather + `decode_attention`). `attn_impl="auto"` means the kernels
  on CUDA and the plain versions on the CPU.
- The dense and paged caches are updated IN PLACE; `forward` still returns
  the cache with its lengths advanced, as the JAX decoder does.
- `remat=True` recomputes each block in the backward
  (`torch.utils.checkpoint`) when there is no cache and a gradient is
  being taken, where the JAX decoder wraps Block in `nn.remat`. The JAX
  policy keeps the projections' outputs; the port keeps only each block's
  input and recomputes the whole block, so the flash forward kernel runs
  twice per layer and step under remat.

`n_experts > 0` swaps the FFN of every `moe_every`-th block for the expert
bank of `models/moe.py` (child `moe`, as in the flax tree).

`attn_impl="ring"` is sequence parallelism (`ops/ring_attention.py`): on a
mesh with the axis `cfg.sp_axis`, each rank holds every parameter and its
block of the sequence, and attention without a cache runs the ring over
that axis, as JAX's decoder does under `shard_map`. The paged first chunk
and the caches attend locally, as in JAX. Positions default to
`arange(t)` of the local block, as JAX's do: a sequence-sharded caller
passes the global positions of its block (`rank * t + arange(t)`), or
RoPE turns at the wrong offsets. Parameter gradients are this rank's
part; their sum over the axis (`xla_ops.psum`) is the whole sequence's.
`sp` > 1 with fsdp, tp or ep > 1 raises: JAX's ring model runs with
replicated parameters and has no tensor-parallel form.

Shard-local modules: given a mesh (`Llama(cfg, mesh=...)`, axes dp,
fsdp, tp, ep and `cfg.sp_axis`), each rank holds its blocks of the
parameters under `parallel.sharding.llama_rules` as plain tensors, on the
tp, ep and fsdp axes alike, and calls `parallel.xla_ops` where GSPMD
would put the collectives:
- fsdp: every Dense, the embedding, the head and the MoE banks cast their
  local block to the activation dtype and gather it over fsdp at use (the
  values of gathering first, at half the bytes); the gather's backward
  reduce-scatters the weight's gradient over fsdp. Under `remat` the
  gathers run again in the recompute, as JAX's remat does.
- tp: wq, wk, wv, w_gate and w_up are split on their output dimension,
  behind `pvary` (identity forward, psum backward: the replicated input's
  gradient is the sum of the ranks' parts); wo and w_down on their input
  dimension, then a psum over tp (identity backward). The embedding is
  split over d, then gathered over tp (`all_gather_invariant`: its
  backward takes this rank's block); a tied head is a psum of partial
  products; lm_head is split over the vocabulary, then the logits are
  gathered the same way, so every rank holds the same full row. Each rank
  holds H/tp query heads and Kh/tp KV heads in contiguous blocks, so the
  GQA group of a local head is local; head counts come from the local
  weights, and tp must divide n_kv_heads (JAX's meshes that split a KV
  head have no counterpart here).
- ep: the MoE bank's combine is followed by a psum over ep and tp
  (`models/moe.py`).
- dp and the batch half of fsdp split the batch only; the train step
  (`train/llm_step.py`) means the gradients over them.
Norm scales and the router stay replicated. No hand kernel sees a DTensor.
"""

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.moe import MoEMLP
from ray_tpu_torch.ops.attention import apply_rope, decode_attention, mha_reference
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.paged_attention import (PagedKVCache, paged_attention,
                                               write_layer_tokens)
from ray_tpu_torch.ops.ring_attention import check_even_split, ring_attention
from ray_tpu_torch.parallel import xla_ops
from ray_tpu_torch.parallel.mesh import axis_sizes


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16       # activations
    param_dtype: Any = torch.float32  # master weights
    attn_impl: str = "auto"           # auto | flash | xla | ring
    sp_axis: str = "sp"               # mesh axis for ring attention
    remat: bool = False
    # mixture-of-experts (models/moe.py). 0 = dense.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # ---- presets (sizes follow the Llama family; test config is `tiny`).
    # kwargs override the preset's own values (e.g. tiny(max_seq_len=64)).
    @staticmethod
    def tiny(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=16, ffn_dim=128,
            max_seq_len=128, rope_theta=10000.0), **kw})

    @staticmethod
    def moe_tiny(**kw):
        """Test-scale Mixtral layout: every FFN is a 4-expert top-2 bank."""
        return LlamaConfig(**{**dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=16, ffn_dim=128, max_seq_len=128,
            rope_theta=10000.0, n_experts=4, moe_top_k=2), **kw})

    @staticmethod
    def mixtral_8x7b(**kw):
        """Mixtral-8x7B shape: Llama-7B trunk, 8 experts, top-2 routing."""
        return LlamaConfig(**{**dict(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, head_dim=128, ffn_dim=14336, max_seq_len=32768,
            rope_theta=1000000.0, n_experts=8, moe_top_k=2), **kw})

    @staticmethod
    def llama_125m(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=32000, d_model=768, n_layers=12,
            n_heads=12, n_kv_heads=12, head_dim=64,
            ffn_dim=2048, max_seq_len=2048), **kw})

    @staticmethod
    def llama_1b(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=32000, d_model=2048, n_layers=16,
            n_heads=32, n_kv_heads=8, head_dim=64,
            ffn_dim=5632, max_seq_len=4096), **kw})

    @staticmethod
    def llama_8b(**kw):
        return LlamaConfig(**kw)  # defaults above are 8B

    @staticmethod
    def llama_70b(**kw):
        return LlamaConfig(**{**dict(
            d_model=8192, n_layers=80, n_heads=64,
            n_kv_heads=8, head_dim=128, ffn_dim=28672), **kw})


@dataclasses.dataclass
class KVCache:
    """Static-shape per-layer K/V cache: tuples of [B, Smax, Kh, D] tensors.

    `length` counts valid tokens per batch row. Capacity invariant
    (caller-enforced, host-side): length + new_tokens must stay <= Smax. A
    write that would overflow is shifted back to end at Smax, as JAX's
    dynamic_update_slice clamps its start: the serving loop keeps every row
    inside its capacity. A row whose length is frozen (terminated slot)
    keeps taking one masked write per step at that frozen position."""
    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    length: torch.Tensor  # [B] int32

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
             dtype=None, device="cuda") -> "KVCache":
        max_len = max_len or cfg.max_seq_len
        dtype = dtype or cfg.dtype
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        zeros = lambda: torch.zeros(shape, dtype=dtype, device=device)
        return KVCache(
            k=tuple(zeros() for _ in range(cfg.n_layers)),
            v=tuple(zeros() for _ in range(cfg.n_layers)),
            length=torch.zeros((batch,), dtype=torch.int32, device=device))


class ShardPlace:
    """A shard-local model's place on its mesh: the size of each of the dp,
    fsdp, tp and ep axes (1 where the mesh lacks it), this rank's index on
    tp and ep, and the collectives the modules call. The axis `sp_axis` holds
    replicated parameters and splits the sequence (ring attention); it may
    exceed 1 only where fsdp, tp and ep are 1. Other axes must have size 1.
    Every split must be even."""

    AXES = ("dp", "fsdp", "tp", "ep")

    def __init__(self, mesh, sp_axis: str = "sp"):
        sizes = axis_sizes(mesh)
        other = {a: n for a, n in sizes.items()
                 if a not in self.AXES + (sp_axis,) and n > 1}
        if other:
            raise ValueError(f"the shard-local Llama computes over dp, fsdp, tp, ep and "
                             f"{sp_axis}; mesh axes {other} are not supported")
        self.mesh = mesh
        self.sizes = {a: sizes.get(a, 1) for a in self.AXES}
        self.fsdp, self.tp, self.ep = (self.sizes[a] for a in ("fsdp", "tp", "ep"))
        self.sp = sizes.get(sp_axis, 1)
        if self.sp > 1 and (self.tp > 1 or self.ep > 1):
            raise ValueError(f"{sp_axis}={self.sp} with tp={self.tp}, ep={self.ep}: sequence "
                             f"parallelism runs with replicated parameters (tp and ep 1)")
        if self.sp > 1 and self.fsdp > 1:
            raise ValueError(f"{sp_axis}={self.sp} with fsdp={self.fsdp}: sequence "
                             f"parallelism runs with replicated parameters (fsdp 1)")
        self.tp_index = xla_ops.axis_index("tp", mesh) if "tp" in sizes else 0
        self.ep_index = xla_ops.axis_index("ep", mesh) if "ep" in sizes else 0

    def size(self, axis: Optional[str]) -> int:
        return self.sizes.get(axis, 1) if axis else 1

    def split(self, n: int, axis: Optional[str], what: str) -> int:
        parts = self.size(axis)
        if n % parts:
            raise ValueError(f"{axis}={parts} must divide {what}={n}")
        return n // parts

    def psum(self, x, *axes):
        for a in axes:
            if self.size(a) > 1:
                x = xla_ops.psum(x, a, self.mesh)
        return x

    def pvary(self, x, *axes):
        """x; its gradient summed over `axes` (the entry of a block whose
        ranks each compute a part)."""
        for a in axes:
            if self.size(a) > 1:
                x = xla_ops.pvary(x, a, self.mesh)
        return x

    def gather_tp(self, x):
        """The tp blocks of the last dimension, concatenated; the value is
        used alike on every tp rank."""
        if self.tp == 1:
            return x
        return xla_ops.all_gather_invariant(x, "tp", self.mesh, gather_axis=-1)

    def gather_fsdp(self, w, dim: int):
        """A weight's fsdp blocks along `dim`, concatenated: the whole
        weight on every fsdp rank, each using it on its own rows."""
        if self.fsdp == 1:
            return w
        return xla_ops.all_gather(w, "fsdp", self.mesh, gather_axis=dim)

    def gather_whole(self, w, axes):
        """The whole tensor from this rank's block, `axes` naming the mesh
        axis of each dimension: fsdp gathered as `gather_fsdp`, tp as a
        value used alike on every tp rank."""
        for dim, a in enumerate(axes):
            if a == "fsdp":
                w = self.gather_fsdp(w, dim)
            elif a == "tp" and self.tp > 1:
                w = xla_ops.all_gather_invariant(w, "tp", self.mesh, gather_axis=dim)
        return w


class Dense(nn.Module):
    """Bias-free projection; weight [out, in]. Input and weight are cast to
    the activation dtype before the product, as flax's Dense(dtype=...).
    Shard-local (`place`): `axes` are the mesh axes of the weight's [out,
    in] dimensions under `llama_rules` and `names` their sizes' names for
    the errors; the weight holds its block and is gathered over fsdp at
    use."""

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype,
                 device=None, place=None, axes=(None, None), names=("out", "in")):
        super().__init__()
        self.dtype = dtype
        self.place = place
        self.fsdp_dim = None
        if place is not None:
            out_features = place.split(out_features, axes[0], names[0])
            in_features = place.split(in_features, axes[1], names[1])
            if place.fsdp > 1 and "fsdp" in axes:
                self.fsdp_dim = axes.index("fsdp")
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=param_dtype, device=device))

    def forward(self, x):
        w = self.weight.to(self.dtype)
        if self.fsdp_dim is not None:
            w = self.place.gather_fsdp(w, self.fsdp_dim)
        return F.linear(x.to(self.dtype), w)


class Embed(nn.Module):
    """Token embedding [V, D]; `attend` is the tied head x @ E^T. Shard-local:
    [V/fsdp, D/tp], the table gathered over fsdp at use, the lookup
    gathered over tp, the head a psum of partials."""

    AXES = ("fsdp", "tp")

    def __init__(self, vocab: int, dim: int, dtype, param_dtype, device=None, place=None):
        super().__init__()
        self.dtype = dtype
        self.place = place
        if place is not None:
            vocab = place.split(vocab, "fsdp", "vocab_size")
            dim = place.split(dim, "tp", "d_model")
        self.embedding = nn.Parameter(torch.empty(vocab, dim, dtype=param_dtype,
                                                  device=device))

    def table(self):
        """The table in the activation dtype: [V, D/tp] on a mesh."""
        t = self.embedding.to(self.dtype)
        return t if self.place is None else self.place.gather_fsdp(t, 0)

    def forward(self, tokens):
        x = F.embedding(tokens, self.table())
        return x if self.place is None else self.place.gather_tp(x)

    def attend(self, x):
        if self.place is None:
            return x.to(self.dtype) @ self.table().t()
        table = self.table()
        d = table.shape[1]
        x = self.place.pvary(x, "tp")
        part = x[..., self.place.tp_index * d:(self.place.tp_index + 1) * d]
        return self.place.psum(part.to(self.dtype) @ table.t(), "tp")


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.to(torch.float32)
        normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(self.dtype)


def _resolve_attn_impl(impl: str, device: torch.device, local: bool = False) -> str:
    """"auto": the flash kernel on CUDA, the plain reference on the CPU.
    `local`: attention over a chunk this rank holds whole (the paged first
    chunk), where "ring" means "auto" too, as in JAX."""
    if impl == "auto" or (local and impl == "ring"):
        return "flash" if device.type == "cuda" else "xla"
    return impl


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer_idx: int = 0, device=None, place=None):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        self.place = place
        heads, kv_heads, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if place is not None:   # whole heads on each tp rank
            place.split(heads, "tp", "n_heads")
            place.split(kv_heads, "tp", "n_kv_heads")
        dense = lambda i, o, axes, names: Dense(i, o, cfg.dtype, cfg.param_dtype, device,
                                                place, axes, names)
        col, row = ("tp", "fsdp"), ("fsdp", "tp")
        self.wq = dense(cfg.d_model, heads * hd, col, ("n_heads * head_dim", "d_model"))
        self.wk = dense(cfg.d_model, kv_heads * hd, col, ("n_kv_heads * head_dim", "d_model"))
        self.wv = dense(cfg.d_model, kv_heads * hd, col, ("n_kv_heads * head_dim", "d_model"))
        self.wo = dense(heads * hd, cfg.d_model, row, ("d_model", "n_heads * head_dim"))

    def forward(self, x, positions, cache=None, paged_chunk_local: bool = False):
        cfg = self.cfg
        layer_idx = self.layer_idx
        b, t, _ = x.shape
        # head counts from the (local) weights: H/tp and Kh/tp on a mesh
        n_heads = self.wq.weight.shape[0] // cfg.head_dim
        n_kv_heads = self.wk.weight.shape[0] // cfg.head_dim
        if self.place is not None:
            x = self.place.pvary(x, "tp")
        q = self.wq(x).reshape(b, t, n_heads, cfg.head_dim)
        k = self.wk(x).reshape(b, t, n_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(b, t, n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        new_cache_kv = None
        if isinstance(cache, PagedKVCache):
            # write this layer's K/V into its page slice, then attend
            cache = write_layer_tokens(cache, layer_idx, k, v, positions)
            if t == 1:
                # decode: the B4 kernel walks the block table (gather
                # reference on the CPU)
                out = paged_attention(q[:, 0], cache.k_pages[layer_idx],
                                      cache.v_pages[layer_idx], cache.block_tables,
                                      positions[:, -1] + 1)[:, None]
            elif paged_chunk_local:
                # FIRST chunk of a fresh row (start == 0, no cached prefix):
                # chunk-local causal attention is exact, no page gather
                impl = _resolve_attn_impl(cfg.attn_impl, x.device, local=True)
                out = (flash_attention(q, k, v, causal=True) if impl == "flash"
                       else mha_reference(q, k, v, causal=True))
            else:
                # continuation chunk or prefix hit: queries see the row's
                # cached prefix. Gather the row's pages into contiguous KV
                # (slot s = absolute position s; placeholder pages sit past
                # every valid query position and are masked).
                kp = cache.k_pages[layer_idx]              # [Kh, P, ps, D]
                vp = cache.v_pages[layer_idx]
                tb = cache.block_tables.long()             # [B, mp]
                kh_, d_ = kp.shape[0], kp.shape[-1]
                k_all = kp[:, tb].permute(1, 2, 3, 0, 4).reshape(b, -1, kh_, d_)
                v_all = vp[:, tb].permute(1, 2, 3, 0, 4).reshape(b, -1, kh_, d_)
                out = decode_attention(q, k_all, v_all, positions[:, 0])
            new_cache_kv = cache
        elif cache is not None:
            # dense decode: write current K/V at `length`, attend the cache
            k_cache, v_cache = cache.k[layer_idx], cache.v[layer_idx]
            smax = k_cache.shape[1]
            start = cache.length.long().clamp(0, smax - t)
            idx = start[:, None] + torch.arange(t, device=x.device)[None, :]
            rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
            k_cache[rows, idx] = k.to(k_cache.dtype)
            v_cache[rows, idx] = v.to(v_cache.dtype)
            out = decode_attention(q, k_cache, v_cache, cache.length)
            new_cache_kv = (k_cache, v_cache)
        else:
            impl = _resolve_attn_impl(cfg.attn_impl, x.device)
            if impl == "flash":
                out = flash_attention(q, k, v, causal=True)
            elif impl == "ring":
                # Llama.forward checked the split once for every layer
                out = ring_attention(q, k, v, axis_name=cfg.sp_axis, causal=True,
                                     mesh=self.place.mesh, check_split=False)
            else:
                out = mha_reference(q, k, v, causal=True)

        out = self.wo(out.reshape(b, t, n_heads * cfg.head_dim))
        if self.place is not None:
            out = self.place.psum(out, "tp")
        return out, new_cache_kv


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, place=None):
        super().__init__()
        self.place = place
        dense = lambda i, o, axes, names: Dense(i, o, cfg.dtype, cfg.param_dtype, device,
                                                place, axes, names)
        self.w_gate = dense(cfg.d_model, cfg.ffn_dim, ("tp", "fsdp"), ("ffn_dim", "d_model"))
        self.w_up = dense(cfg.d_model, cfg.ffn_dim, ("tp", "fsdp"), ("ffn_dim", "d_model"))
        self.w_down = dense(cfg.ffn_dim, cfg.d_model, ("fsdp", "tp"), ("d_model", "ffn_dim"))

    def forward(self, x):
        if self.place is not None:
            x = self.place.pvary(x, "tp")
        out = self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))
        return out if self.place is None else self.place.psum(out, "tp")


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer_idx: int = 0, device=None, place=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        self.attn = Attention(cfg, layer_idx, device, place)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        if cfg.n_experts > 0 and layer_idx % cfg.moe_every == 0:
            self.moe = MoEMLP(cfg, device, place)
        else:
            self.mlp = MLP(cfg, device, place)

    def forward(self, x, positions, cache, paged_chunk_local=False):
        h, new_kv = self.attn(self.attn_norm(x), positions, cache, paged_chunk_local)
        x = x + h
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        x = x + ffn(self.mlp_norm(x))
        return x, new_kv


class Llama(nn.Module):
    """The decoder. With `mesh` (a DeviceMesh with axes among dp, fsdp, tp,
    ep and `cfg.sp_axis`), the shard-local model: this rank's blocks of the
    parameters under `llama_rules`, and the collectives of the module
    docstring. `attn_impl="ring"` needs a mesh with `cfg.sp_axis`."""

    HEAD_AXES = ("tp", "fsdp")      # lm_head's [vocab, d] under llama_rules

    def __init__(self, cfg: LlamaConfig, device=None, mesh=None):
        super().__init__()
        if cfg.attn_impl not in ("auto", "flash", "xla", "ring"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        if cfg.attn_impl == "ring" and (mesh is None or cfg.sp_axis not in mesh.mesh_dim_names):
            raise ValueError(f"attn_impl='ring' needs a mesh with the sequence axis "
                             f"{cfg.sp_axis!r}, got "
                             f"{None if mesh is None else tuple(mesh.mesh_dim_names)}")
        self.cfg = cfg
        self.place = place = None if mesh is None else ShardPlace(mesh, cfg.sp_axis)
        if place is not None and place.sp > 1 and cfg.attn_impl != "ring":
            raise ValueError(f"{cfg.sp_axis}={place.sp} splits the sequence: it needs "
                             f"attn_impl='ring', got {cfg.attn_impl!r}")
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, cfg.param_dtype, device,
                           place)
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", Block(cfg, i, device, place))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, cfg.param_dtype,
                                 device, place, self.HEAD_AXES, ("vocab_size", "d_model"))

    def blocks(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.n_layers)]

    def head_weight(self) -> torch.Tensor:
        """The whole [V, D] head the training loss multiplies with: lm_head,
        or the tied embedding; on a mesh, gathered from this rank's block
        (over fsdp, then tp) in its own dtype."""
        if self.cfg.tie_embeddings:
            w, axes = self.embed.embedding, Embed.AXES
        else:
            w, axes = self.lm_head.weight, self.HEAD_AXES
        return w if self.place is None else self.place.gather_whole(w, axes)

    def forward(self, tokens, positions=None, cache=None,
                return_hidden: bool = False, paged_chunk_local: bool = False):
        """tokens [B, T] int -> logits [B, T, V] (f32), new cache (or None).

        Prefill/train: cache=None, full causal attention. Decode: pass a
        KVCache or PagedKVCache; T is the number of new tokens.

        Positions default to `arange(T)` (after the cache's length). Under
        `attn_impl="ring"` tokens is this rank's block of the sequence, and
        the caller passes the block's global positions: the default is
        JAX's, local to the block. Blocks of unequal length over the sp
        axis raise ValueError on every rank, checked once a forward.

        `paged_chunk_local=True` (paged prefill only): the chunk is the FIRST
        tokens of a fresh row (start == 0, no cached prefix), so chunk-local
        causal attention is exact and skips the page gather.

        `return_hidden=True` returns the final-norm hidden states [B, T, D]
        instead of logits."""
        cfg = self.cfg
        b, t = tokens.shape
        if positions is None:
            steps = torch.arange(t, device=tokens.device, dtype=torch.int32)[None, :]
            if cache is not None:
                positions = cache.length[:, None].to(torch.int32) + steps
            else:
                positions = steps.expand(b, t)
        if cfg.attn_impl == "ring" and cache is None:
            check_even_split(t, cfg.sp_axis, self.place.mesh, tokens.device)

        x = self.embed(tokens)
        paged = isinstance(cache, PagedKVCache)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        new_k, new_v = [], []
        for block in self.blocks():
            if remat:
                x, new_kv = checkpoint(block, x, positions, cache, paged_chunk_local,
                                       use_reentrant=False)
            else:
                x, new_kv = block(x, positions, cache, paged_chunk_local)
            if paged:
                cache = new_kv
            elif new_kv is not None:
                new_k.append(new_kv[0])
                new_v.append(new_kv[1])

        x = self.final_norm(x)
        new_cache = None
        if paged:
            new_cache = cache.replace(lengths=cache.lengths + t)
        elif cache is not None:
            new_cache = KVCache(k=tuple(new_k), v=tuple(new_v), length=cache.length + t)
        if return_hidden:
            return x, new_cache
        if cfg.tie_embeddings:
            logits = self.embed.attend(x)
        else:
            if self.place is None:
                logits = self.lm_head(x)
            else:
                logits = self.place.gather_tp(self.lm_head(self.place.pvary(x, "tp")))
        return logits.to(torch.float32), new_cache


def _n_moe_layers(cfg: LlamaConfig) -> int:
    if cfg.n_experts <= 0:
        return 0
    return len(range(0, cfg.n_layers, cfg.moe_every))


def _attn_params(cfg: LlamaConfig) -> int:
    """Per-layer attention weights: single source for count AND flops."""
    return cfg.d_model * cfg.head_dim * (cfg.n_heads * 2
                                         + cfg.n_kv_heads * 2)


def _mlp_params(cfg: LlamaConfig) -> int:
    """One dense SwiGLU FFN (also the per-expert size in an MoE bank)."""
    return 3 * cfg.d_model * cfg.ffn_dim


def llama_param_count(cfg: LlamaConfig) -> int:
    per_layer = _attn_params(cfg) + _mlp_params(cfg) + 2 * cfg.d_model
    total = cfg.n_layers * per_layer
    # MoE blocks swap the dense FFN for E experts + a router
    n_moe = _n_moe_layers(cfg)
    total += n_moe * ((cfg.n_experts - 1) * _mlp_params(cfg)
                      + cfg.d_model * cfg.n_experts)
    embed = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return total + embed + head + cfg.d_model


def llama_compute_flops(cfg: LlamaConfig, batch: int, seq: int) -> float:
    """Training FLOPs per step ~ 6 N_active tokens + attention term
    (causal). For MoE, N_active counts top_k experts per token."""
    n_moe = _n_moe_layers(cfg)
    n_dense = cfg.n_layers - n_moe
    n_active = (cfg.n_layers * _attn_params(cfg)
                + n_dense * _mlp_params(cfg)
                + n_moe * (cfg.moe_top_k * _mlp_params(cfg)
                           + cfg.d_model * cfg.n_experts))
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    n_active += head
    tokens = batch * seq
    attn = 6 * cfg.n_layers * cfg.n_heads * cfg.head_dim * batch * seq * seq
    return 6.0 * n_active * tokens + attn
