"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention on the CPU:
RoPE, grouped-query `mha_reference` (causal, q_offset, mask) and
`decode_attention`, on the same numpy-seeded f32 inputs. Tolerance: 2e-5
max-abs (f32; the two frameworks sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

ATOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def test_constants_and_rope_table():
    assert tattn.NEG_INF == jattn.NEG_INF
    js, jc = jattn.rope_table(32, 16, 10000.0)
    ts, tc = tattn.rope_table(32, 16, 10000.0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("kh", [4, 2], ids=["gqa1", "gqa2"])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5), (False, 0)])
def test_mha_reference(kh, causal, q_offset):
    rng = np.random.default_rng(1)
    q = _rand(rng, 2, 6, 4, 16)
    k = _rand(rng, 2, 11, kh, 16)
    v = _rand(rng, 2, 11, kh, 16)
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, q_offset=q_offset)
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mha_reference_mask():
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 5, 4, 8), _rand(rng, 2, 5, 2, 8), _rand(rng, 2, 5, 2, 8)
    mask = rng.random((2, 5, 5)) > 0.3
    mask[:, :, 0] = True
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=False, mask=jnp.asarray(mask))
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("t", [1, 4])
def test_decode_attention(t):
    rng = np.random.default_rng(3)
    q = _rand(rng, 3, t, 4, 16)
    kc, vc = _rand(rng, 3, 24, 2, 16), _rand(rng, 3, 24, 2, 16)
    lengths = np.array([0, 9, 20 - t], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(lengths))
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_cast_points():
    """bf16 in, bf16 out, P cast to v's dtype before P.V as in the JAX
    reference: the two agree to bf16 rounding (2e-2)."""
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 1, 8, 4, 16), _rand(rng, 1, 8, 2, 16), _rand(rng, 1, 8, 2, 16)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    got = tattn.mha_reference(bf(q), bf(k), bf(v))
    want = jattn.mha_reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=2e-2)
