"""ray_tpu_torch.ops.flash_attention against ray_tpu's Pallas flash
attention (interpret mode) on the CPU. A CPU tensor takes the port's plain
version, which repeats the CUDA kernel's arithmetic (f32 scores, softmax
and P.V); the kernel itself is held to it on the card by chip_smoke.py.
Forward tolerances: f32 2e-5, bf16 2e-2 max-abs. The bf16 kernel's one
extra rounding point (P to bf16 before P.V) is emulated here and held to
the Pallas forward with chip_smoke.py's bf16 limits (FWD_BF16_MAX,
FWD_BF16_MEAN), which a control must miss. The backward (the plain
version of the dQ and dK/dV kernels, and autograd through flash_attention)
is held to `_flash_bwd` and to jax.grad with the tolerances at BWD_TOL and
BWD_MEAN_TOL."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tflash

# the module (ray_tpu.ops re-exports a function of the same name)
jflash = importlib.import_module("ray_tpu.ops.flash_attention")


def _inputs(seed, t, h, kh, d=16):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return mk(2, t, h, d), mk(2, t, kh, d), mk(2, t, kh, d)


@pytest.mark.parametrize("kh", [4, 2], ids=["gqa1", "gqa2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_matches_pallas_f32(causal, kh):
    q, k, v = _inputs(0, 64, 4, kh)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, block_q=32, block_kv=32,
                                  interpret=True)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_matches_pallas_bf16(causal):
    q, k, v = _inputs(1, 32, 4, 2)
    want = jflash.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                  causal=causal, block_q=16, block_kv=16,
                                  interpret=True)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    got = tflash.flash_attention(bf(q), bf(k), bf(v), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=2e-2)


def test_lse_matches_pallas_forward():
    """The logsumexp the backward kernels will read: [B, H, T] f32."""
    q, k, v = _inputs(2, 32, 4, 2)
    scale = 1.0 / np.sqrt(16)
    sw = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)
    _, want = jflash._flash_fwd(sw(q), sw(k), sw(v), causal=True, scale=scale,
                                block_q=16, block_kv=16, interpret=True)
    out, got = tflash.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), causal=True)
    assert got.shape == (2, 4, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_ragged_length_matches_reference():
    """T=100 does not tile: JAX falls back to mha_reference; the port's
    kernel masks ragged edges itself, and its plain version agrees."""
    q, k, v = _inputs(3, 100, 4, 2)
    from ray_tpu.ops.attention import mha_reference
    want = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 16, 4, 2))
    before = tflash.LAUNCHES
    out = tflash.flash_attention(q, k, v)
    ref = tflash.flash_attention_reference(q, k, v)
    assert tflash.LAUNCHES == before
    assert torch.equal(out, ref)


def test_wrapper_rejects_mixed_and_foreign_devices():
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 16, 4, 2))
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError):
        tflash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ------------------------------------------------- bf16 forward on the card
# The bf16 kernel rounds P to bf16 before P.V (the Pallas kernel multiplies
# f32 P by f32 V); the row sum l and lse use the f32 P. chip_smoke.py holds
# the kernel to the plain version on the same bf16 inputs with these limits:
# max-abs, and mean |err| over mean |out|. A forward that rounds the scores
# to bf16 before the softmax (the control) must miss the mean limit at long
# rows; at T of a few dozen, scores of size ~1 round no worse than P does.
FWD_BF16_MAX = 2e-2
FWD_BF16_MEAN = 2e-3


def _bf16_fwd_emulated(q, k, v, causal, round_scores=False):
    """The bf16 kernel's arithmetic in plain PyTorch: f32 scores of the bf16
    inputs, f32 softmax statistics, P rounded to bf16 before an f32-summed
    P.V, divided by the f32 row sum, out rounded to bf16 once. With
    round_scores, the control instead: scores rounded to bf16 before an f32
    softmax and f32 P.V."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    s = tflash._grouped_scores(q, k, causal, 1.0 / math.sqrt(d))   # [B, Kh, G, T, S]
    if round_scores:
        s = s.to(torch.bfloat16).float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = p if round_scores else p.to(torch.bfloat16).float()
    out = torch.einsum("bkgts,bskd->bkgtd", pv, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(torch.bfloat16)


@pytest.mark.parametrize("kh", [4, 1], ids=["gqa1", "gqa4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_p_rounding_within_fwd_limits(causal, kh):
    """The emulated bf16 kernel against the Pallas forward (interpret mode)
    on the same bf16 inputs, T=512: within FWD_BF16_MAX and FWD_BF16_MEAN;
    the control, scores rounded to bf16, misses the mean limit."""
    rng = np.random.default_rng(13)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    q, k, v = mk(1, 512, 4, 64), mk(1, 512, kh, 64), mk(1, 512, kh, 64)
    want = jflash.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                  causal=causal, block_q=128, block_kv=128,
                                  interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    err = lambda got: np.abs(got.float().numpy() - want)
    kernel = err(_bf16_fwd_emulated(tq, tk, tv, causal))
    control = err(_bf16_fwd_emulated(tq, tk, tv, causal, round_scores=True))
    assert kernel.max() <= FWD_BF16_MAX
    assert kernel.mean() / np.abs(want).mean() <= FWD_BF16_MEAN
    assert control.mean() / np.abs(want).mean() > FWD_BF16_MEAN


def test_bf16_layout_check_rejects_what_cp_async_cannot_copy():
    """A bf16 CUDA call raises (and never falls back) for a head stride that
    is not a multiple of 8 elements or a base pointer off 16 bytes; the f32
    route reads any stride."""
    padded = torch.zeros(2, 16, 4, 20, dtype=torch.bfloat16)[..., :16]  # head stride 20
    ok = torch.zeros(2, 16, 4, 16, dtype=torch.bfloat16)
    shifted = torch.zeros(2 * 16 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 4, 16)
    assert shifted.data_ptr() % 16 != 0
    for bad in (padded, shifted):
        with pytest.raises(ValueError, match="bf16 flash kernel"):
            tflash.check_bf16_layout(q=bad)
        with pytest.raises(ValueError, match="bf16 flash kernel"):
            tflash._check_inputs(bad, ok[:, :, :2], ok[:, :, :2])
    tflash.check_bf16_layout(q=ok, k=ok[:, :, :2].contiguous())
    tflash._check_inputs(padded.float(), ok[:, :, :2].float(), ok[:, :, :2].float())


def test_bf16_layout_check_accepts_model_qkv_and_autograd_do(monkeypatch):
    """The tiny Llama in bf16: the q, k, v its attention hands to
    flash_attention, and the dO autograd hands back, pass the check."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import init_params
    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                 attn_impl="flash")
    model = llama.Llama(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    seen, grads = [], []

    def recorder(q, k, v, causal=True, scale=None):
        seen.append((q, k, v))
        out = tflash.flash_attention(q, k, v, causal=causal, scale=scale)
        out.register_hook(grads.append)
        return out

    monkeypatch.setattr(llama, "flash_attention", recorder)
    tokens = torch.from_numpy(np.random.default_rng(12).integers(0, 256, (2, 32)))
    logits, _ = model(tokens)
    logits.float().square().mean().backward()
    assert len(seen) == len(grads) == cfg.n_layers
    for (q, k, v), do in zip(seen, reversed(grads)):
        assert q.dtype == do.dtype == torch.bfloat16
        tflash.check_bf16_layout(q=q, k=k, v=v, do=do)
        tflash._check_inputs(q, k, v)


# ---------------------------------------------------------------- backward
# The plain backward repeats the two backward kernels' arithmetic (chip_smoke.py
# holds the kernels to it on the card). Tolerances per gradient, max-abs over
# the largest |grad| (BWD_TOL) and mean-abs over the mean |grad|
# (BWD_MEAN_TOL): f32 differs in summation order only, bf16 by a few flips of
# the bf16 outputs. A backward that skips the dS and P casts to bf16 stays
# under the max limit but misses the mean limit by more than 10x; the bf16
# cases check that it does.
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
BWD_MEAN_TOL = {"float32": 1e-6, "bfloat16": 1e-4}


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _mean_rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).mean() / np.abs(want).mean()


@pytest.mark.parametrize("kh", [4, 2], ids=["gqa1", "gqa2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_reference_matches_pallas_bwd(dtype, causal, kh):
    """Plain backward vs `_flash_bwd` (both Pallas kernels, interpret mode)
    on the same q, k, v, out, lse and dO: 32 rows in two 16-row blocks."""
    q, k, v = _inputs(6, 32, 4, kh)
    do = np.random.default_rng(7).standard_normal(q.shape, dtype=np.float32)
    jdt = jnp.dtype(dtype)
    sw = lambda x: jnp.swapaxes(jnp.asarray(x, jdt), 1, 2)
    scale = 0.25
    out, lse = jflash._flash_fwd(sw(q), sw(k), sw(v), causal=causal, scale=scale,
                                 block_q=16, block_kv=16, interpret=True)
    want = jflash._flash_bwd(sw(q), sw(k), sw(v), out, lse, sw(do), causal=causal,
                             scale=scale, block_q=16, block_kv=16, interpret=True)
    tdt = getattr(torch, dtype)
    tt = lambda x: torch.from_numpy(np.array(x, np.float32)).to(tdt)
    back = lambda x: np.swapaxes(np.asarray(x.astype(jnp.float32)), 1, 2)
    args = (tt(q), tt(k), tt(v), tt(back(out)), torch.from_numpy(np.array(lse)), tt(do))
    got = tflash.flash_attention_bwd_reference(*args, causal=causal, scale=scale)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt
        assert _rel_err(g.float().numpy(), back(w)) <= BWD_TOL[dtype], name
        assert _mean_rel_err(g.float().numpy(), back(w)) <= BWD_MEAN_TOL[dtype], name
    if dtype == "bfloat16":  # the control: no dS/P casts, gradients rounded once
        unrounded = tflash.flash_attention_bwd_reference(
            *(x.float() for x in args), causal=causal, scale=scale)
        misses = [_mean_rel_err(g.to(tdt).float().numpy(), back(w))
                  for g, w in zip(unrounded, want)]
        assert max(misses) > BWD_MEAN_TOL[dtype], misses


@pytest.mark.parametrize("kh", [4, 2], ids=["gqa1", "gqa2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_autograd_matches_jax_grad(causal, kh):
    """d/d(q, k, v) of sum(out**2) (the loss of tests/test_ops.py:39) through
    the port's flash_attention (the autograd Function with the plain forward
    and backward on the CPU) vs jax.grad of the Pallas flash attention."""
    q, k, v = _inputs(8, 32, 4, kh)
    loss = lambda *a: jnp.sum(jflash.flash_attention(
        *a, causal=causal, block_q=16, block_kv=16, interpret=True) ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tflash.flash_attention(tq, tk, tv, causal=causal) ** 2).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert _rel_err(g.numpy(), w) <= BWD_TOL["float32"], name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ragged_grads_match_mha_reference(causal):
    """T=100 does not tile: the port's backward masks the ragged edge the way
    its kernels do; jax.grad of mha_reference is the oracle."""
    from ray_tpu.ops.attention import mha_reference
    q, k, v = _inputs(9, 100, 4, 2)
    loss = lambda *a: jnp.sum(mha_reference(*a, causal=causal) ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tflash.flash_attention(tq, tk, tv, causal=causal) ** 2).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert _rel_err(g.numpy(), w) <= BWD_TOL["float32"], name


def test_cpu_grad_call_launches_no_kernel():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(10, 16, 4, 2))
    counts = lambda: (tflash.LAUNCHES, tflash.BWD_DQ_LAUNCHES, tflash.BWD_DKV_LAUNCHES)
    before = counts()
    out = tflash.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert counts() == before
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_bwd_rejects_mixed_devices():
    q, k, v = (torch.from_numpy(x) for x in _inputs(11, 16, 4, 2))
    out, lse = tflash.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        tflash.flash_attention_bwd(q, k, v, out, lse.to("meta"), out)
