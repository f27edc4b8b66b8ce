"""The RL half of ray_tpu_torch.ops.losses against ray_tpu.ops.losses on the
CPU, on numpy-seeded f32 inputs, in the [T] and [T, B] forms: gae, vtrace,
ppo_surrogate, clipped_value_loss, huber and td_target, with the gradients
of ppo_surrogate and clipped_value_loss against jax.grad; then the cases
of tests/test_ops.py::TestLosses that these functions answer.

Tolerance: 1e-5 of the largest |value| (f32; the scans add in the same
order, so only the transcendental functions' last bits differ)."""

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
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(got - want).max() <= rtol * scale, (np.abs(got - want).max(), scale)


def _rollout(seed, shape):
    """rewards, values (T+1 rows), dones, and two log-prob columns."""
    rng = np.random.default_rng(seed)
    t = shape[0]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    rewards = f(*shape)
    values = f(t + 1, *shape[1:])
    dones = (rng.random(shape) < 0.15).astype(np.float32)
    blp, tlp = f(*shape) * 0.3, f(*shape) * 0.3
    return rewards, values, dones, blp, tlp


SHAPES = [(37,), (23, 5)]
IDS = ["T", "TxB"]
T_ = lambda a: torch.from_numpy(a)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 1.0)])
def test_gae_matches_jax(shape, gamma, lam):
    r, v, d, _, _ = _rollout(0, shape)
    if len(shape) == 1:
        want = jlosses.gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), gamma, lam)
    else:   # JAX's IMPALA/APPO vmap the [T] form over the env axis
        want = jax.vmap(lambda a, b, c: jlosses.gae(a, b, c, gamma, lam), in_axes=1,
                        out_axes=1)(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d))
    got = tlosses.gae(T_(r), T_(v), T_(d), gamma, lam)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("clip_rho,clip_c", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_jax(shape, clip_rho, clip_c):
    r, v, d, blp, tlp = _rollout(1, shape)
    fn = lambda *a: jlosses.vtrace(*a, 0.99, clip_rho, clip_c)
    args = [jnp.asarray(a) for a in (blp, tlp, r, v, d)]
    want = fn(*args) if len(shape) == 1 else jax.vmap(fn, in_axes=1, out_axes=1)(*args)
    got = tlosses.vtrace(T_(blp), T_(tlp), T_(r), T_(v), T_(d), 0.99, clip_rho, clip_c)
    _close(got.vs, want.vs)
    _close(got.pg_advantages, want.pg_advantages)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ppo_surrogate_and_grad_match_jax(shape):
    r, _, _, blp, tlp = _rollout(2, shape)
    tlp = blp + 0.4 * tlp          # ratios on both sides of the clip
    (want, wfrac), wgrad = jax.value_and_grad(
        lambda lp: jlosses.ppo_surrogate(lp, jnp.asarray(blp), jnp.asarray(r), 0.2),
        has_aux=True)(jnp.asarray(tlp))
    lp = T_(tlp).requires_grad_()
    got, frac = tlosses.ppo_surrogate(lp, T_(blp), T_(r), 0.2)
    got.backward()
    assert 0.0 < float(frac) < 1.0
    _close(got, want)
    _close(frac, wfrac)
    _close(lp.grad, wgrad)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("clip", [10.0, 0.3])
def test_clipped_value_loss_and_grad_match_jax(shape, clip):
    rng = np.random.default_rng(3)
    values, old, targets = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    want, wgrad = jax.value_and_grad(
        lambda v: jlosses.clipped_value_loss(v, jnp.asarray(old), jnp.asarray(targets), clip)
    )(jnp.asarray(values))
    v = T_(values).requires_grad_()
    got = tlosses.clipped_value_loss(v, T_(old), T_(targets), clip)
    got.backward()
    _close(got, want)
    _close(v.grad, wgrad)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_huber_and_td_target_match_jax(shape):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    r, q = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    d = (rng.random(shape) < 0.3).astype(np.float32)
    _close(tlosses.huber(T_(x), 1.5), jlosses.huber(jnp.asarray(x), 1.5))
    _close(tlosses.td_target(T_(r), T_(q), T_(d), 0.97),
           jlosses.td_target(jnp.asarray(r), jnp.asarray(q), jnp.asarray(d), 0.97))


# -- tests/test_ops.py::TestLosses, the RL cases -----------------------------
def test_gae_vs_naive():
    T = 7
    rng = np.random.RandomState(0)
    r = rng.randn(T).astype(np.float32)
    val = rng.randn(T + 1).astype(np.float32)
    done = np.array([0, 0, 1, 0, 0, 0, 0], np.float32)
    gamma, lam = 0.9, 0.8
    adv, tgt = tlosses.gae(T_(r), T_(val), T_(done), gamma, lam)
    expect = np.zeros(T, np.float32)
    acc = 0.0
    for t in reversed(range(T)):
        nd = 1.0 - done[t]
        delta = r[t] + gamma * val[t + 1] * nd - val[t]
        acc = delta + gamma * lam * nd * acc
        expect[t] = acc
    np.testing.assert_allclose(adv.numpy(), expect, rtol=1e-4)
    np.testing.assert_allclose(tgt.numpy(), expect + val[:-1], rtol=1e-4)


def test_vtrace_on_policy_is_gae_lambda1():
    # with rho = c = 1 (on-policy) the V-trace targets are TD(lambda=1) returns
    T = 5
    rng = np.random.RandomState(1)
    r = torch.tensor(rng.randn(T), dtype=torch.float32)
    val = torch.tensor(rng.randn(T + 1), dtype=torch.float32)
    done = torch.zeros(T)
    lp = torch.zeros(T)
    out = tlosses.vtrace(lp, lp, r, val, done, gamma=0.9)
    _, tgt = tlosses.gae(r, val, done, gamma=0.9, lam=1.0)
    np.testing.assert_allclose(out.vs.numpy(), tgt.numpy(), rtol=1e-4)


def test_ppo_surrogate_clip():
    lp = torch.tensor([0.0, np.log(2.0)])
    loss, frac = tlosses.ppo_surrogate(lp, torch.zeros(2), torch.ones(2), clip=0.2)
    # ratios [1, 2] -> clipped to [1, 1.2] -> loss = -mean = -1.1
    np.testing.assert_allclose(float(loss), -1.1, rtol=1e-5)
    np.testing.assert_allclose(float(frac), 0.5)


def test_huber():
    np.testing.assert_allclose(tlosses.huber(torch.tensor([-2.0, 0.5, 2.0])).numpy(),
                               [1.5, 0.125, 1.5])
