"""The port's RL torsos, PolicyValueNet, RLModule and action distributions
against ray_tpu's on the CPU. Flax params are carried across with
`convert.flax_rl_module_to_state_dict`; inputs are numpy-seeded.

Tolerances (f32): module outputs within 1e-5 of the largest |output| for
the MLP, 1e-4 for the CNN (sums of up to 7744 products); distribution
log-probs, entropies and KLs within 1e-5 of the largest |value|. Sample
moments within 5 standard errors of their expectation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import torsos as jtorsos
from ray_tpu.rllib import distributions as jdist
from ray_tpu.rllib.rl_module import ModuleSpec as JSpec, RLModule as JModule
from ray_tpu_torch.models import torsos as ttorsos
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
from ray_tpu_torch.rllib import distributions as tdist
from ray_tpu_torch.rllib.rl_module import ModuleSpec, PolicyValueNet, RLModule


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def _close(got, want, rtol=1e-5):
    err = _err(got, want)
    assert err <= rtol, err


def _port(module_cls, params, *args):
    net = module_cls(*args)
    net.load_state_dict(flax_rl_module_to_state_dict(params))
    return net


# -- torsos ------------------------------------------------------------------
def test_mlp_torso_matches_flax():
    x = np.random.default_rng(0).standard_normal((6, 3, 4)).astype(np.float32)
    jt = jtorsos.MLPTorso((32, 16))
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(x))
    net = _port(ttorsos.MLPTorso, params, 12, (32, 16))
    assert set(net.state_dict()) == {"dense_0.weight", "dense_0.bias",
                                     "dense_1.weight", "dense_1.bias"}
    _close(net(torch.from_numpy(x)), jt.apply(params, jnp.asarray(x)))


def test_cnn_geometry_is_flax_same():
    """84x84 -> 21, 11, 11 under SAME; the second conv pads 1 before, 2
    after; proj is 7744 x 512 (the flax module's own shapes)."""
    params = jtorsos.CNNTorso().init(jax.random.PRNGKey(0), jnp.zeros((1, 84, 84, 4)))
    net = ttorsos.CNNTorso((84, 84, 4))
    assert net.pads == [(2, 2, 2, 2), (1, 2, 1, 2), (1, 1, 1, 1)]
    sd = flax_rl_module_to_state_dict(params)
    assert tuple(sd["proj.weight"].shape) == (512, 7744)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def cnn():
    params = jtorsos.CNNTorso().init(jax.random.PRNGKey(1), jnp.zeros((1, 84, 84, 4)))
    frames = np.random.default_rng(1).integers(0, 256, (2, 84, 84, 4)).astype(np.uint8)
    return params, frames, _port(ttorsos.CNNTorso, params, (84, 84, 4))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_cnn_torso_matches_flax(cnn, dtype):
    params, frames, net = cnn
    x = frames if dtype == "uint8" else frames.astype(np.float32) / 255.0
    want = jtorsos.CNNTorso().apply(params, jnp.asarray(x))
    _close(net(torch.from_numpy(x)), want, 1e-4)


def test_cnn_limit_rejects_wrong_padding_and_flatten(cnn):
    """The CNN limit has the power to see the two layout faults: the larger
    pad before (a symmetric 1/1 would not even give 11x11), and a
    flatten in NCHW order."""
    params, frames, net = cnn
    want = jtorsos.CNNTorso().apply(params, jnp.asarray(frames))
    x = torch.from_numpy(frames)
    pads = list(net.pads)
    try:
        net.pads[1] = (2, 1, 2, 1)
        assert _err(net(x), want) > 1e-2
    finally:
        net.pads[:] = pads
    with torch.no_grad():
        h = x.float().permute(0, 3, 1, 2) / 255.0
        for i in range(3):
            h = torch.relu(getattr(net, f"conv_{i}")(torch.nn.functional.pad(h, net.pads[i])))
        wrong = torch.relu(net.proj(h.reshape(h.shape[0], -1)))   # NCHW order
    assert _err(wrong, want) > 1e-2
    _close(net(x), want, 1e-4)


# -- PolicyValueNet / RLModule -------------------------------------------------
@pytest.mark.parametrize("kind,dim", [("discrete", 3), ("continuous", 2)])
def test_policy_value_net_matches_flax(kind, dim):
    jm = JModule(JSpec((5,), kind, dim, hiddens=(32, 32)))
    params = jm.init(jax.random.PRNGKey(2))
    if kind == "continuous":   # a log_std other than its zero init
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["params"]["log_std"] = jnp.asarray([0.3, -0.7], jnp.float32)
    tm = RLModule(ModuleSpec((5,), kind, dim, hiddens=(32, 32)))
    sd = flax_rl_module_to_state_dict(jax.device_get(params))
    net = PolicyValueNet(tm.spec)
    net.load_state_dict(sd)
    obs = np.random.default_rng(2).standard_normal((4, 3, 5)).astype(np.float32)
    want_in, want_v = jm.forward(params, jnp.asarray(obs))
    for weights in (net, sd):      # a net, or a state_dict through functional_call
        got_in, got_v = tm.forward(weights, torch.from_numpy(obs))
        _close(got_in, want_in)
        _close(got_v, want_v)
    got_a, _ = tm.inference_step(net, torch.from_numpy(obs))
    want_a, _ = jm.inference_step(params, jnp.asarray(obs))
    if kind == "discrete":
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    else:
        _close(got_a, want_a)
    a, logp, v = tm.explore_step(net, torch.from_numpy(obs), torch.Generator().manual_seed(0))
    assert a.shape[:2] == (4, 3) and logp.shape == (4, 3) and v.shape == (4, 3)
    _close(logp, tm.dist(got_in).log_prob(a))


def test_init_is_seeded_with_reference_gains():
    spec = ModuleSpec((4,), "discrete", 2, hiddens=(64, 64))
    a, b = RLModule(spec).init(0), RLModule(spec).init(0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pi.weight"], RLModule(spec).init(1)["pi.weight"])
    # orthogonal rows scaled by the gain: W W^T = gain^2 I for out <= in
    for name, gain in (("torso.dense_1.weight", 2 ** 0.5), ("pi.weight", 0.01),
                       ("vf.weight", 1.0)):
        w = a[name]
        np.testing.assert_allclose((w @ w.T).numpy(), gain ** 2 * np.eye(w.shape[0]),
                                   atol=1e-5 * max(gain ** 2, 1))
    assert all(not a[k].any() for k in a if k.endswith("bias"))


# -- distributions -------------------------------------------------------------
def _gauss(seed, shape=(5, 3)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal(shape) * 0.5).astype(np.float32))


def test_categorical_matches_jax():
    rng = np.random.default_rng(3)
    logits, other = (rng.standard_normal((6, 4)).astype(np.float32) * 2 for _ in range(2))
    x = rng.integers(0, 4, 6)
    j, jo = jdist.Categorical(jnp.asarray(logits)), jdist.Categorical(jnp.asarray(other))
    t, to = tdist.Categorical(torch.from_numpy(logits)), tdist.Categorical(torch.from_numpy(other))
    _close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)))
    _close(t.entropy(), j.entropy())
    _close(t.kl(to), j.kl(jo))
    np.testing.assert_array_equal(t.mode().numpy(), np.asarray(j.mode()))


def test_diag_gaussian_matches_jax():
    mean, log_std = _gauss(4)
    omean, olog_std = _gauss(5)
    x = _gauss(6)[0]
    j = jdist.DiagGaussian(jnp.asarray(mean), jnp.asarray(log_std[0]))   # log_std broadcast
    jo = jdist.DiagGaussian(jnp.asarray(omean), jnp.asarray(olog_std))
    t = tdist.DiagGaussian(torch.from_numpy(mean), torch.from_numpy(log_std[0]))
    to = tdist.DiagGaussian(torch.from_numpy(omean), torch.from_numpy(olog_std))
    _close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)))
    _close(t.entropy(), j.entropy())
    _close(t.kl(to), j.kl(jo))
    _close(t.mode(), j.mode())


def test_squashed_gaussian_matches_jax():
    mean, log_std = _gauss(7)
    log_std[0, 0], log_std[1, 1] = 5.0, -30.0        # outside [-20, 2]: clipped
    a = np.tanh(_gauss(8)[0]).astype(np.float32) * 0.9
    a[2, 0] = 1.0                                     # a boundary action
    j = jdist.SquashedGaussian(jnp.asarray(mean), jnp.asarray(log_std), -2.0, 2.0)
    t = tdist.SquashedGaussian(torch.from_numpy(mean), torch.from_numpy(log_std), -2.0, 2.0)
    _close(t.log_prob(torch.from_numpy(a * 2)), j.log_prob(jnp.asarray(a * 2)))
    _close(t.mode(), j.mode())
    assert float(t.base.log_std.max()) == 2.0 and float(t.base.log_std.min()) == -20.0


def test_squashed_log_prob_inverts_its_sample():
    mean, log_std = _gauss(9)
    t = tdist.SquashedGaussian(torch.from_numpy(mean), torch.from_numpy(log_std) - 1.0)
    a, logp = t.sample_and_log_prob(torch.Generator().manual_seed(0))
    assert float(a.abs().max()) < 1.0
    np.testing.assert_allclose(t.log_prob(a).numpy(), logp.numpy(), rtol=1e-4, atol=1e-4)


def test_sample_moments():
    n = 200_000
    g = torch.Generator().manual_seed(1)
    probs = np.array([0.1, 0.2, 0.3, 0.4])
    c = tdist.Categorical(torch.log(torch.tensor(probs, dtype=torch.float32)).expand(n, 4))
    freq = np.bincount(c.sample(g).numpy(), minlength=4) / n
    assert np.all(np.abs(freq - probs) <= 5 * np.sqrt(probs * (1 - probs) / n)), freq
    mean, log_std = np.array([0.5, -1.0], np.float32), np.array([0.0, -0.7], np.float32)
    d = tdist.DiagGaussian(torch.from_numpy(mean).expand(n, 2), torch.from_numpy(log_std))
    s = d.sample(g).numpy()
    std = np.exp(log_std)
    assert np.all(np.abs(s.mean(0) - mean) <= 5 * std / np.sqrt(n)), s.mean(0)
    assert np.all(np.abs(s.std(0) - std) <= 5 * std / np.sqrt(2 * n)), s.std(0)
