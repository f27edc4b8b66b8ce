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
`attn_impl="ring"` (sequence parallel) belongs to a later slice.
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
    attn_impl: str = "auto"           # auto | flash | xla (ring: later slice)
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


class Dense(nn.Module):
    """Bias-free projection; weight [out, in]. Input and weight are cast to
    the activation dtype before the product, as flax's Dense(dtype=...)."""

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=param_dtype, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Embed(nn.Module):
    """Token embedding [V, D]; `attend` is the tied head x @ E^T."""

    def __init__(self, vocab: int, dim: int, dtype, param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, dim, dtype=param_dtype,
                                                  device=device))

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding.to(self.dtype))

    def attend(self, x):
        return x.to(self.dtype) @ self.embedding.to(self.dtype).t()


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


def _resolve_attn_impl(impl: str, device: torch.device) -> str:
    """"auto": the flash kernel on CUDA, the plain reference on the CPU."""
    if impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return impl


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer_idx: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        dense = lambda i, o: Dense(i, o, cfg.dtype, cfg.param_dtype, device)
        self.wq = dense(cfg.d_model, cfg.n_heads * cfg.head_dim)
        self.wk = dense(cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
        self.wv = dense(cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
        self.wo = dense(cfg.n_heads * cfg.head_dim, cfg.d_model)

    def forward(self, x, positions, cache=None, paged_chunk_local: bool = False):
        cfg = self.cfg
        layer_idx = self.layer_idx
        b, t, _ = x.shape
        q = self.wq(x).reshape(b, t, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
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
                impl = _resolve_attn_impl(cfg.attn_impl, x.device)
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
            elif impl == "xla":
                out = mha_reference(q, k, v, causal=True)
            else:
                raise NotImplementedError(f"attn_impl={impl!r}: later slice")

        out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
        return self.wo(out), new_cache_kv


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        dense = lambda i, o: Dense(i, o, cfg.dtype, cfg.param_dtype, device)
        self.w_gate = dense(cfg.d_model, cfg.ffn_dim)
        self.w_up = dense(cfg.d_model, cfg.ffn_dim)
        self.w_down = dense(cfg.ffn_dim, cfg.d_model)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer_idx: int = 0, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        self.attn = Attention(cfg, layer_idx, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        if cfg.n_experts > 0 and layer_idx % cfg.moe_every == 0:
            self.moe = MoEMLP(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, positions, cache, paged_chunk_local=False):
        h, new_kv = self.attn(self.attn_norm(x), positions, cache, paged_chunk_local)
        x = x + h
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        x = x + ffn(self.mlp_norm(x))
        return x, new_kv


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        if cfg.attn_impl == "ring":
            raise NotImplementedError("attn_impl='ring' (sequence parallel): later slice")
        if cfg.attn_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, cfg.param_dtype, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", Block(cfg, i, device))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype,
                                 cfg.param_dtype, device)

    def blocks(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, tokens, positions=None, cache=None,
                return_hidden: bool = False, paged_chunk_local: bool = False):
        """tokens [B, T] int -> logits [B, T, V] (f32), new cache (or None).

        Prefill/train: cache=None, full causal attention. Decode: pass a
        KVCache or PagedKVCache; T is the number of new tokens.

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
            logits = self.lm_head(x)
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
