"""Ring attention: sequence-parallel attention over a ring of ranks.

Counterpart of `ray_tpu/ops/ring_attention.py`. Q, K and V are split along
the sequence over the mesh axis `sp`: each rank keeps its query block and
passes its K/V block one hop around the ring per step
(`xla_ops.ppermute_shift`), folding each block it receives into an
online-softmax accumulator. No rank ever holds the whole sequence.

As JAX's, the blocks are computed with plain ops (`jnp.einsum` there,
`torch.einsum` here), f32 scores and f32 accumulators, GQA through
`h // kh` query groups, the causal mask at global offsets (this rank's
queries start at `rank * tq`, the block from rank `src` at `src * tq`) and
masked scores set to `NEG_INF = -1e30`. No hand kernel is involved.

Where the port differs from JAX's `shard_map` form:
- Each rank calls `ring_attention` on its local block with the mesh as an
  explicit argument (as `parallel/xla_ops.py` does); the results are
  JAX's.
- A block that lies wholly above the causal diagonal (src > rank) is not
  computed: JAX computes it and its merge weight `exp(-1e30 - m)` is 0,
  so skipping it gives the same accumulator bit for bit.
- Forward and backward are one `torch.autograd.Function`. The forward
  keeps q, this rank's own k and v, out and the f32 row log-sum-exp
  `m + log(l)` [B, Kh, G, Tq]. The backward runs a second ring: per block
  it recomputes P from the log-sum-exp, with `delta = rowsum(dO * out)`;
  dQ accumulates here, dK and dV accumulate into f32 buffers that travel
  with K and V and are home, summed over every rank's queries, after the
  last shift. Autograd through the per-block ops would keep a P of
  [B, Kh, G, Tq, Tk] f32 per block and layer alive until the backward
  (2.1 GB a block at llama_1b width with 4096-token blocks).
- The ring is simple: each shift is blocking point-to-point between two
  block computations, not overlapped with the next block.

`mha_reference` on the gathered sequence is the plain, unsharded version
the tests hold the ring against.
"""

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF
from ray_tpu_torch.parallel import xla_ops


def _scores(q, k, scale, row_offset, col_offset, causal):
    """f32 scores [B, Kh, G, Tq, Tk] of the local queries q [B, Tq, H, D]
    against one block k [B, Tk, Kh, D], NEG_INF above the global causal
    diagonal."""
    b, tq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, tq, kh, h // kh, d).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if causal:
        rows = row_offset + torch.arange(tq, device=q.device)[:, None]
        cols = col_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        s.masked_fill_(rows < cols, NEG_INF)
    return s


def _block_attn(q, k, v, scale, row_offset, col_offset, causal):
    """One flash step: local q [B, Tq, H, D] against one rotating K/V block.
    Returns the f32 partials (m, l, acc): row max [B, Kh, G, Tq], row sum
    and the weighted values [B, Tq, Kh, G, D]."""
    s = _scores(q, k, scale, row_offset, col_offset, causal)
    m = s.amax(-1)
    p = s.sub_(m[..., None]).exp_()
    l = p.sum(-1)
    acc = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return m, l, acc


def _masked_out(causal, src, rank):
    """The block from `src` lies wholly above the causal diagonal of this
    rank's queries (every score NEG_INF, merge weight 0)."""
    return causal and src > rank


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, axis, mesh, causal, scale):
        b, tq, h, d = q.shape
        kh = k.shape[2]
        g = h // kh
        n = xla_ops.axis_size(axis, mesh)
        rank = xla_ops.axis_index(axis, mesh)
        m_acc = torch.full((b, kh, g, tq), -math.inf, dtype=torch.float32, device=q.device)
        l_acc = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=q.device)
        o_acc = torch.zeros((b, tq, kh, g, d), dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for i in range(n):
            src = (rank - i) % n     # block i started on rank (rank - i) mod n
            if not _masked_out(causal, src, rank):
                m_blk, l_blk, acc_blk = _block_attn(q, k_cur, v_cur, scale, rank * tq,
                                                    src * tq, causal)
                m_new = torch.maximum(m_acc, m_blk)
                alpha = torch.exp(m_acc - m_new)
                beta = torch.exp(m_blk - m_new)
                l_acc = alpha * l_acc + beta * l_blk
                o_acc = (o_acc * alpha.permute(0, 3, 1, 2)[..., None]
                         + acc_blk * beta.permute(0, 3, 1, 2)[..., None])
                m_acc = m_new
            if i < n - 1:
                k_cur = xla_ops.ppermute_shift(k_cur, axis, mesh, 1)
                v_cur = xla_ops.ppermute_shift(v_cur, axis, mesh, 1)
        # under causality each query sees at least itself: l > 0
        out = (o_acc / l_acc.permute(0, 3, 1, 2)[..., None]).reshape(b, tq, h, d).to(q.dtype)
        lse = m_acc + torch.log(l_acc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.mesh, ctx.causal, ctx.scale = axis, mesh, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis, mesh, causal, scale = ctx.axis, ctx.mesh, ctx.causal, ctx.scale
        b, tq, h, d = q.shape
        kh = k.shape[2]
        g = h // kh
        n = xla_ops.axis_size(axis, mesh)
        rank = xla_ops.axis_index(axis, mesh)
        dog = do.reshape(b, tq, kh, g, d).float()
        qg = q.reshape(b, tq, kh, g, d).float()
        delta = (dog * out.reshape(b, tq, kh, g, d).float()).sum(-1).permute(0, 2, 3, 1)
        dq = torch.zeros((b, tq, kh, g, d), dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for i in range(n):
            src = (rank - i) % n
            if not _masked_out(causal, src, rank):
                p = _scores(q, k_cur, scale, rank * tq, src * tq, causal)
                p.sub_(lse[..., None]).exp_()                          # [B, Kh, G, Tq, Tk]
                dv_cur = dv_cur + torch.einsum("bkgts,btkgd->bskd", p, dog)
                ds = torch.einsum("btkgd,bskd->bkgts", dog, v_cur.float())   # dP
                ds.sub_(delta[..., None]).mul_(p).mul_(scale)
                del p
                dq = dq + torch.einsum("bkgts,bskd->btkgd", ds, k_cur.float())
                dk_cur = dk_cur + torch.einsum("bkgts,btkgd->bskd", ds, qg)
            # dK and dV travel with their block: after n shifts they are home
            dk_cur = xla_ops.ppermute_shift(dk_cur, axis, mesh, 1)
            dv_cur = xla_ops.ppermute_shift(dv_cur, axis, mesh, 1)
            if i < n - 1:
                k_cur = xla_ops.ppermute_shift(k_cur, axis, mesh, 1)
                v_cur = xla_ops.ppermute_shift(v_cur, axis, mesh, 1)
        return (dq.reshape(b, tq, h, d).to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None)


def check_even_split(tq: int, axis_name: str, mesh, device) -> None:
    """Raises ValueError, on every rank of the `axis_name` axis alike,
    unless every rank holds a block of `tq` tokens: one small all-reduce
    of the longest and the shortest block, and a host sync. Every rank of
    the axis calls it together."""
    longest, neg_shortest = xla_ops.pmax(torch.tensor([tq, -tq], device=device),
                                         axis_name, mesh).tolist()
    if longest != -neg_shortest:
        raise ValueError(f"the sequence does not split evenly over {axis_name}="
                         f"{xla_ops.axis_size(axis_name, mesh)}: blocks of {-neg_shortest} "
                         f"to {longest} tokens")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str = "sp",
                   causal: bool = True, scale: Optional[float] = None, *,
                   mesh, check_split: bool = True) -> torch.Tensor:
    """Sequence-parallel attention on this rank's blocks: q [B, T/P, H, D],
    k and v [B, T/P, Kh, D], the sequence split over the `axis_name` axis
    of `mesh` in rank order. Every rank of the axis calls it together.
    Returns this rank's block of dense attention on the gathered sequence,
    [B, T/P, H, D] in q's dtype. Raises ValueError when the blocks do not
    split a sequence evenly (unequal block lengths) or H is not a multiple
    of Kh. `check_split=False` skips the block-length check
    (`check_even_split`), for a caller that made it once for many calls on
    blocks of one split, as the ring Llama does once a forward."""
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, tq) or k.shape[3] != d:
        raise ValueError(f"ring attention needs k and v of one shape [B, T/P, Kh, D] with "
                         f"q's B, T/P and D: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} heads not divisible by {k.shape[2]} kv heads")
    if check_split:
        check_even_split(tq, axis_name, mesh, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return _RingAttention.apply(q, k, v, axis_name, mesh, causal, scale)
