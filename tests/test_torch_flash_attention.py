"""ray_tpu_torch.ops.flash_attention against ray_tpu's Pallas flash
attention (interpret mode) on the CPU. A CPU tensor takes the port's plain
version, which repeats the CUDA kernel's arithmetic (f32 scores, softmax
and P.V); the kernel itself is held to it on the card by chip_smoke.py.
Tolerances: f32 2e-5, bf16 2e-2 max-abs."""

import importlib

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
