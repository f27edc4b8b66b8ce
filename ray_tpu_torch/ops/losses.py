"""Token cross-entropy for the Llama training step.

Counterpart of `ray_tpu/ops/losses.py` (`cross_entropy`,
`chunked_cross_entropy`); the RL losses (GAE, V-trace, PPO) come with the
RLlib slice. Plain PyTorch: the JAX package has no kernel here either.

The head product. JAX computes the logits as hidden (activation dtype) x
lm_head kernel (param dtype) with an f32 result (`losses.py:76-78`). The
port does the same: for bf16 hidden states and bf16 weights on the card it
asks cuBLAS for a bf16 product with an f32 output (`torch.mm(...,
out_dtype=torch.float32)`, f32 sums), so no logit is rounded to bf16; in
every other case (f32 params, or the CPU) both operands are widened to f32
first, which is the same arithmetic. The backward's two products take
their operands in the forward product's dtype (bf16 only when hidden and
head both are): the f32 logit gradient is cast to it, the sums are f32,
and the head's gradient is summed over the chunks in f32 and cast to its
dtype once.
"""

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, z_loss: float = 0.0,
                  label_smoothing: float = 0.0):
    """Mean token cross-entropy with optional z-loss (logsumexp squared, keeps
    bf16 logits from drifting) and label smoothing.

    logits [..., V], labels [...] int, mask [...] 0/1 or bool. Returns
    (loss, {"loss", "z_loss", "accuracy", "tokens"}).
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logits
    if label_smoothing:
        smooth = -logits.mean(-1) + lse
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    zl = lse.square()
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp(min=1.0)
    loss = (nll * mask).sum() / denom
    zterm = z_loss * (zl * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).float() * mask).sum() / denom
    return loss + zterm, {"loss": loss, "z_loss": zterm, "accuracy": acc,
                          "tokens": mask.sum()}


def _operand_dtype(h, w):
    """bf16 when hidden and head both are bf16, else f32 (JAX's promotion)."""
    return torch.bfloat16 if h.dtype == w.dtype == torch.bfloat16 else torch.float32


def _mm_f32(a, b):
    """a @ b with an f32 result; a and b share one dtype (bf16 or f32)."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logits(h, w):
    """[N, D] x [V, D] -> [N, V] f32 logits (see the module note)."""
    dt = _operand_dtype(h, w)
    return _mm_f32(h.to(dt), w.to(dt).t())


class _ChunkedCE(torch.autograd.Function):
    """Sum of token NLLs and of argmax hits, chunk by chunk along T. Keeps
    only the per-token logsumexp [B, T]: each chunk's [B, c, V] logits are
    made again in the backward, so [B, T, V] is never held."""

    @staticmethod
    def forward(ctx, hidden, w_head, labels, chunk_size):
        b, t, d = hidden.shape
        nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        hits = torch.zeros((), dtype=torch.int64, device=hidden.device)
        lse_all = torch.empty((b, t), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, t, chunk_size):
            h_c = hidden[:, c0:c0 + chunk_size].reshape(-1, d)
            y_c = labels[:, c0:c0 + chunk_size].reshape(-1)
            logits = _logits(h_c, w_head)                       # [B c, V] f32
            lse = torch.logsumexp(logits, dim=-1)
            label_logits = logits.gather(-1, y_c[:, None])[:, 0]
            nll_sum += (lse - label_logits).sum()
            hits += (logits.argmax(-1) == y_c).sum()
            lse_all[:, c0:c0 + chunk_size] = lse.reshape(b, -1)
        ctx.save_for_backward(hidden, w_head, labels, lse_all)
        ctx.chunk_size = chunk_size
        ctx.mark_non_differentiable(hits)
        return nll_sum, hits

    @staticmethod
    def backward(ctx, g_nll, _g_hits):
        hidden, w_head, labels, lse_all = ctx.saved_tensors
        b, t, d = hidden.shape
        chunk = ctx.chunk_size
        dh = torch.empty_like(hidden) if ctx.needs_input_grad[0] else None
        dw = torch.zeros(w_head.shape, dtype=torch.float32, device=w_head.device)
        dt = _operand_dtype(hidden, w_head)
        w_op = w_head.to(dt)
        for c0 in range(0, t, chunk):
            h_c = hidden[:, c0:c0 + chunk].reshape(-1, d)
            y_c = labels[:, c0:c0 + chunk].reshape(-1)
            logits = _logits(h_c, w_head)
            # d(sum nll)/d logits = softmax - onehot, times the incoming grad
            dlogits = torch.exp(logits - lse_all[:, c0:c0 + chunk].reshape(-1, 1))
            dlogits[torch.arange(y_c.numel(), device=y_c.device), y_c] -= 1.0
            dlogits = (dlogits * g_nll).to(dt)
            if dh is not None:
                dh[:, c0:c0 + chunk] = _mm_f32(dlogits, w_op).reshape(b, -1, d)
            dw += _mm_f32(dlogits.t(), h_c.to(dt))
        return dh, dw.to(w_head.dtype), None, None


def chunked_cross_entropy(hidden: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, chunk_size: int = 512):
    """Cross-entropy fused with the lm_head, computed per sequence chunk.

    hidden [B, T, D] final hidden states (before the head); w_head [V, D],
    the port's `lm_head.weight` (or the tied `embed.embedding`); labels
    [B, T] int. The full [B, T, V] logits are never held: peak logits
    memory is B x chunk x V, and each chunk's head product is made once
    more in the backward. The dense-LM subset of `cross_entropy` (no mask,
    z_loss or label smoothing). Returns (mean loss, {"loss", "accuracy",
    "tokens"}).
    """
    b, t, _ = hidden.shape
    if chunk_size <= 0 or t % chunk_size:
        raise ValueError(f"sequence length {t} is not a multiple of chunk_size {chunk_size}")
    nll_sum, hits = _ChunkedCE.apply(hidden, w_head, labels.long(), chunk_size)
    n = b * t
    loss = nll_sum / n
    return loss, {"loss": loss, "accuracy": hits / n, "tokens": n}
