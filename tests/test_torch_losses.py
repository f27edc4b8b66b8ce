"""ray_tpu_torch.ops.losses against ray_tpu.ops.losses on the CPU, on the
same numpy-seeded logits, hidden states, head and labels: the loss and its
metrics, and the gradients (torch autograd vs jax.grad). f32 throughout;
tolerance 1e-5 relative (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import losses as jlosses
from ray_tpu_torch.ops import losses as tlosses

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(got - want).max() <= rtol * scale, (np.abs(got - want).max(), scale)


def _data(seed, b=2, t=8, v=32):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v), dtype=np.float32) * 3
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    return logits, labels, mask


@pytest.mark.parametrize("kw", [
    {}, {"mask": True}, {"z_loss": 1e-3}, {"label_smoothing": 0.1},
    {"mask": True, "z_loss": 1e-4, "label_smoothing": 0.2},
], ids=["plain", "mask", "z_loss", "smoothing", "all"])
def test_cross_entropy_matches_jax(kw):
    logits, labels, mask = _data(0)
    kw = dict(kw)
    use_mask = kw.pop("mask", False)

    def jloss(lg):
        return jlosses.cross_entropy(lg, jnp.asarray(labels),
                                     mask=jnp.asarray(mask) if use_mask else None, **kw)

    (want, wm), wgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got, gm = tlosses.cross_entropy(tl, torch.from_numpy(labels).long(),
                                    mask=torch.from_numpy(mask) if use_mask else None, **kw)
    got.backward()
    _close(got, want)
    for key in ("loss", "z_loss", "accuracy", "tokens"):
        _close(gm[key], wm[key])
    _close(tl.grad, wgrad)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_cross_entropy_matches_jax(chunk):
    """Value, accuracy, token count and the grads of hidden and head; the
    port's head is [V, D] (lm_head.weight), JAX's kernel [D, V]."""
    rng = np.random.default_rng(chunk)
    b, t, d, v = 2, 16, 8, 40
    hidden = rng.standard_normal((b, t, d), dtype=np.float32)
    w = rng.standard_normal((d, v), dtype=np.float32) * 0.5
    labels = rng.integers(0, v, (b, t)).astype(np.int32)

    def jloss(h, wk):
        return jlosses.chunked_cross_entropy(h, wk, jnp.asarray(labels), chunk_size=chunk)

    (want, wm), (wh, ww) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    got, gm = tlosses.chunked_cross_entropy(th, tw, torch.from_numpy(labels), chunk_size=chunk)
    got.backward()
    _close(got, want)
    _close(gm["accuracy"], wm["accuracy"])
    assert gm["tokens"] == int(wm["tokens"]) == b * t
    _close(th.grad, wh)
    _close(tw.grad, np.asarray(ww).T)


def test_chunked_equals_full_cross_entropy():
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 12, 8), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 8), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 24, (2, 12)))
    full, fm = tlosses.cross_entropy(h @ w.t(), y)
    chunked, cm = tlosses.chunked_cross_entropy(h, w, y, chunk_size=4)
    _close(chunked, full.detach().numpy())
    _close(cm["accuracy"], fm["accuracy"].numpy())


def test_chunked_rejects_ragged_chunks():
    h, w = torch.zeros(1, 10, 4), torch.zeros(6, 4)
    with pytest.raises(ValueError):
        tlosses.chunked_cross_entropy(h, w, torch.zeros(1, 10, dtype=torch.long), chunk_size=4)
