"""The port's DreamerV3 against ray_tpu's on the CPU, at JAX's test widths
(deter 64, stoch 4 x classes 4, hiddens (64, 64), B 4, T 12, H 5).

- the twohot bins bit-equal to JAX's, both the eager values (twohot, the
  critic) and the jitted ones (the reward head inside JAX's update);
  symlog, symexp and twohot within 1e-6; JAX's round-trip case;
- `_SequenceReplay` drawing JAX's windows from one seed, before and after
  the ring wraps;
- the world model's methods and the flax-form GRU cell against JAX's
  (jitted `apply` of the same weights, carried over with
  `convert.flax_dreamer_to_state_dict`, and JAX's Gumbels), within 1e-5
  relative; the act step against JAX's `_act` on JAX's key;
- two updates on CartPole's shapes (discrete) and Pendulum's
  (continuous), the port re-synced to JAX's weights and `ret_scale`
  before each (Adam's moments stay on both sides), with JAX's draws
  rebuilt from its key chain: the sampled latents' and actions' indices
  equal first, then every metric and `ret_scale` within 1e-4 of max(1,
  |v|), the nets within `check_params` (tests/test_torch_rl_learner.py)
  and the EMA critic within 1e-6 plus (1 - decay) of the critic's gap;
- JAX's four Algorithm cases run on the port; a build from a callable env
  in a fresh interpreter leaves gymnasium unimported; chip_smoke.py's
  numpy CartPole steps as gymnasium's CartPole-v1.

Draws. `jax.random.categorical(key, logits)` is argmax(gumbel(key,
logits.shape) + logits); `jax_draws` rebuilds an update's draws from its
key as JAX splits it, after `test_gumbel_rebuild_reproduces_categorical`
has held the rebuild to `jax.random.categorical`. An argmax whose top two
differ by rounding may flip between two correct implementations: an index
mismatch reports the gap of JAX's top two (ROADMAP §C lists a gap under
1e-5 as a check-design item, not a fault).

Percentiles: `jnp.percentile(x, 95)` and `torch.quantile(x, 0.95)` take the
same linear rule, but their rounding differs (about 5e-7 relative on 2880
values); the difference reaches `ret_scale` and so every advantage, and
stays inside the metric limit."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import DreamerV3Config as JConfig
from ray_tpu.rllib.algorithms import dreamerv3 as J
from ray_tpu_torch.models.convert import flax_dreamer_to_state_dict
from ray_tpu_torch.rllib import DreamerV3Config
from ray_tpu_torch.rllib.algorithms import dreamerv3 as P

B, T, H = 4, 12, 5
WIDTHS = dict(deter=64, stoch=4, classes=4, model={"hiddens": (64, 64)}, batch_size_B=B,
              batch_length_T=T, horizon=H)
METRIC_TOL = 1e-4
NEAR_TIE = 1e-5
ENVS = {"discrete": "CartPole-v1", "continuous": "Pendulum-v1"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(env, seed=3):
    """JAX's algorithm and the port's (on the CPU) holding JAX's weights."""
    jalgo = JConfig().environment(env).training(**WIDTHS).debugging(seed=seed).build()
    talgo = (DreamerV3Config().environment(env).training(**WIDTHS).debugging(seed=seed)
             .resources(device="cpu").build())
    talgo.set_weights(flax_dreamer_to_state_dict(jax.device_get(jalgo.weights)))
    return jalgo, talgo


# ----------------------------------------------------------- symlog / twohot
def test_bins_bit_equal_to_jax():
    assert np.array_equal(P._bins().numpy(), np.asarray(J._bins()))
    assert np.array_equal(P._bins(fused=False).numpy(), np.asarray(jax.jit(J._bins)()))
    # the two differ: JAX's reward head sees other bins than its twohot
    assert not np.array_equal(P._bins().numpy(), P._bins(fused=False).numpy())


def test_symlog_symexp_twohot_match_jax():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 30
    x[:6] = [-100.0, -1.5, 0.0, 0.3, 7.0, 500.0]
    t = torch.from_numpy(x)
    np.testing.assert_allclose(P.symlog(t).numpy(), np.asarray(J.symlog(x)), rtol=1e-6, atol=1e-6)
    small = x / 10
    np.testing.assert_allclose(P.symexp(torch.from_numpy(small)).numpy(),
                               np.asarray(J.symexp(small)), rtol=1e-6, atol=1e-6)
    sl = np.asarray(J.symlog(x))
    np.testing.assert_allclose(P.twohot(torch.from_numpy(sl.copy()), P._bins()).numpy(),
                               np.asarray(J.twohot(sl, J._bins())), rtol=1e-6, atol=1e-6)


def test_symlog_twohot_roundtrip():
    """JAX's round-trip case, on the port."""
    x = torch.tensor([-100.0, -1.5, 0.0, 0.3, 7.0, 500.0])
    torch.testing.assert_close(P.symexp(P.symlog(x)), x, rtol=1e-5, atol=1e-5)
    bins = P._bins()
    enc = P.twohot(P.symlog(x), bins)
    torch.testing.assert_close(enc.sum(-1), torch.ones(6), rtol=0, atol=1e-5)
    dec = P.symexp((enc * bins).sum(-1))
    np.testing.assert_allclose(dec.numpy(), x.numpy(), rtol=2e-2, atol=1e-2)


# --------------------------------------------------------------------- replay
def test_sequence_replay_draws_jax_windows():
    """The same adds and draws through both replays, before and after an
    80-row stream wraps a 32-slot ring: the same windows."""
    want, got = J._SequenceReplay(32, seed=0), P._SequenceReplay(32, seed=0)
    for start in range(0, 80, 10):
        rows = {"obs": np.arange(start, start + 10, dtype=np.float32)[:, None],
                "is_first": (np.arange(start, start + 10) % 7 == 0).astype(np.float32)}
        want.add(rows)
        got.add(rows)
        if len(got) > 6:
            w, g = want.sample(16, 6), got.sample(16, 6)
            assert set(w) == set(g) and all(np.array_equal(w[k], g[k]) for k in w)
    assert len(got) == len(want) == 32
    s = got.sample(64, 6)
    assert (np.diff(s["obs"][:, :, 0], axis=1) == 1).all()


# ------------------------------------------------------------------- modules
def _inputs(rng, n, obs_dim, a_dim, deter=64, z=16):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(obs=f(n, obs_dim), h=f(n, deter), z=f(n, z), a=f(n, a_dim), embed=f(n, 64),
                first=(np.arange(n) % 3 == 0).astype(np.float32), feat=f(n, deter + z))


def _close(got, want, tol=1e-5):
    """Within tol of the tensor's scale, max(1, max |want|)."""
    got, want = got.detach().numpy(), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol * max(1.0, float(np.abs(want).max())), err


def test_world_model_methods_match_jax():
    jalgo, talgo = _pair("CartPole-v1")
    w, wm = jalgo.weights["wm"], talgo.wm
    x = _inputs(np.random.default_rng(1), 8, 4, 2)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    # eager, but the reward head, which JAX calls inside its jitted update
    call = lambda m, *a: jalgo.wm.apply(w, *a, method=m)
    jit_call = lambda m, *a: jax.jit(lambda *b: jalgo.wm.apply(w, *b, method=m))(*a)
    _close(wm.embed(t["obs"]), call(J._WorldModel.embed, x["obs"]))
    key = jax.random.PRNGKey(7)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (8, 4, 4))))
    want = call(J._WorldModel.obs_step, x["h"], x["z"], x["a"], x["embed"], x["first"], key)
    got = wm.obs_step(t["h"], t["z"], t["a"], t["embed"], t["first"], g)
    for gv, wv in zip(got, want):
        _close(gv, wv)
    want = call(J._WorldModel.img_step, x["h"], x["z"], x["a"], key)
    for gv, wv in zip(wm.img_step(t["h"], t["z"], t["a"], g), want):
        _close(gv, wv)
    for name in ("heads", "reward", "cont"):
        want = (jit_call if name == "reward" else call)(getattr(J._WorldModel, name), x["feat"])
        got = getattr(wm, name)(t["feat"])
        for gv, wv in zip(got if name == "heads" else [got], want if name == "heads" else [want]):
            _close(gv, wv)
    # the GRU cell against flax's nn.GRUCell with the same weights
    import flax.linen as nn
    cell = nn.GRUCell(features=64)
    h2, _ = cell.apply({"params": w["params"]["gru"]}, x["h"], x["embed"])
    _close(wm.gru(t["h"], t["embed"]), h2)
    # actor and critic
    feat = x["feat"]
    _close(talgo.actor(t["feat"]), jalgo.actor.apply(jalgo.weights["actor"], feat))
    _close(P._critic_value(talgo.critic(t["feat"]), talgo.bins),
           J._critic_value(jalgo.critic.apply(jalgo.weights["critic"], feat), J._bins()))
    jalgo.stop()
    talgo.stop()


def test_gumbel_rebuild_reproduces_categorical():
    logits = jnp.asarray(np.random.default_rng(2).standard_normal((64, 4, 4)), jnp.float32)
    for i in range(4):
        key = jax.random.PRNGKey(i)
        want = jax.random.categorical(key, logits)
        got = jnp.argmax(jax.random.gumbel(key, logits.shape) + logits, -1)
        assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("kind", list(ENVS))
def test_act_step_matches_jax(kind):
    jalgo, talgo = _pair(ENVS[kind])
    rng = np.random.default_rng(3)
    d = talgo._a_prev.shape[0]
    h, z, a = (np.zeros(v.shape, np.float32) for v in (talgo._h, talgo._z, talgo._a_prev))
    th, tz, ta = (torch.from_numpy(v) for v in (h, z, a))
    for step in range(6):
        obs = rng.standard_normal(talgo._env.observation_space.shape).astype(np.float32)
        key = jax.random.PRNGKey(100 + step)
        k_post, k_act = jax.random.split(key)
        noise = {"post": np.array(jax.random.gumbel(k_post, (1, 4, 4))),
                 "act": np.array(jax.random.gumbel(k_act, (d,)) if kind == "discrete"
                                   else jax.random.normal(k_act, (d,)))}
        first = float(step % 4 == 0)
        h, z, a = jalgo._act(jalgo.weights, h, z, a, obs, first, key)
        th, tz, ta = talgo._act(th, tz, ta, obs, step % 4 == 0,
                                {k: torch.from_numpy(v) for k, v in noise.items()})
        for gv, wv in ((th, h), (tz, z), (ta, a)):
            _close(gv, wv)
    jalgo.stop()
    talgo.stop()


# --------------------------------------------------------------------- update
def jax_draws(key, n_actions, discrete):
    """JAX's draws of one update from its key: k_wm -> T posterior keys;
    k_img -> H keys, each split into the actor's k1 and the prior's k2."""
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.gumbel(k, (B, 4, 4)) for k in jax.random.split(k_wm, T)]
    prior, act = [], []
    for k in jax.random.split(k_img, H):
        k1, k2 = jax.random.split(k)
        act.append(jax.random.gumbel(k1, (B * T, n_actions)) if discrete
                   else jax.random.normal(k1, (B * T, n_actions)))
        prior.append(jax.random.gumbel(k2, (B * T, 4, 4)))
    return {k: np.asarray(jnp.stack(v)) for k, v in
            (("post", post), ("prior", prior), ("act", act))}


def _jax_replay(jalgo):
    """A jitted replay of JAX's update's draws from JAX's own modules: the
    posterior under the old world model, imagination under the new one
    and the old actor. Returns the perturbed logits (gumbel + logits) of
    every draw; their argmax is JAX's index."""
    wm, actor, discrete = jalgo.wm, jalgo.actor, jalgo._discrete

    def run(w_old, wm_new, batch, noise):
        embed = wm.apply(w_old["wm"], batch["obs"], method=J._WorldModel.embed)
        act = batch["action"]
        a_prev = jnp.concatenate([jnp.zeros_like(act[:, :1]), act[:, :-1]], 1)

        def post_step(carry, xs):
            h, z = carry
            a_p, emb, first, g = xs
            h, _, _, lg = wm.apply(w_old["wm"], h, z, a_p, emb, first, jax.random.PRNGKey(0),
                                   method=J._WorldModel.obs_step)
            return (h, _st(lg, g)), (h, _st(lg, g), g + lg)

        xs = (jnp.moveaxis(a_prev, 0, 1), jnp.moveaxis(embed, 0, 1),
              jnp.moveaxis(batch["is_first"], 0, 1), noise["post"])
        h0 = jnp.zeros((B, wm.deter))
        z0 = jnp.zeros((B, wm.stoch * wm.classes))
        _, (hs, zs, post_pert) = jax.lax.scan(post_step, (h0, z0), xs)
        h = jnp.moveaxis(hs, 0, 1).reshape(B * T, -1)
        z = jnp.moveaxis(zs, 0, 1).reshape(B * T, -1)

        def img(carry, xs):
            h, z = carry
            ga, gp = xs
            out = actor.apply(w_old["actor"], jnp.concatenate([h, z], -1))
            if discrete:
                pert_a = ga + out
                a = jax.nn.one_hot(jnp.argmax(pert_a, -1), out.shape[-1])
            else:
                d = out.shape[-1] // 2
                a = jnp.tanh(out[..., :d] + jnp.exp(jnp.clip(out[..., d:], -5, 2)) * ga)
                pert_a = a

            def body(m):
                hh = m.gru(h, m.img_in(jnp.concatenate([z, a], -1)))[1]
                return hh, m._logits(m.prior_net(hh))
            hh, lg = wm.apply(wm_new, method=body)
            return (hh, _st(lg, gp)), (pert_a, gp + lg)

        _, (act_pert, prior_pert) = jax.lax.scan(img, (h, z), (noise["act"], noise["prior"]))
        return post_pert, prior_pert, act_pert

    return jax.jit(run)


def _st(lg, g):
    """JAX's `_sample` given its Gumbels."""
    oh = jax.nn.one_hot(jnp.argmax(g + lg, -1), lg.shape[-1])
    probs = jax.nn.softmax(lg, -1)
    st = oh + probs - jax.lax.stop_gradient(probs)
    return st.reshape(st.shape[:-2] + (st.shape[-2] * st.shape[-1],))


def _top_two_gap(pert):
    s = np.sort(pert, -1)
    return s[..., -1] - s[..., -2]


def _check_indices(got, pert, what):
    """The port's draws (perturbed logits) against JAX's: equal argmaxes."""
    got, want = got.argmax(-1).numpy(), np.argmax(pert, -1)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = got != want
    if bad.any():
        gaps = _top_two_gap(pert)[bad]
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.size} sampled indices differ; "
                             f"JAX's top-two gaps there {gaps.tolist()} (a gap under "
                             f"{NEAR_TIE:g} is a near-tie)")


def _batch(rng, obs_dim, n_actions, discrete):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    act = (np.eye(n_actions, dtype=np.float32)[rng.integers(0, n_actions, (B, T))] if discrete
           else rng.uniform(-1, 1, (B, T, n_actions)).astype(np.float32))
    return {"obs": f(B, T, obs_dim), "action": act, "reward": f(B, T),
            "is_first": (rng.random((B, T)) < 0.1).astype(np.float32),
            "is_terminated": (rng.random((B, T)) < 0.1).astype(np.float32)}


def _check_ema(got, want, got_c, want_c, decay):
    for k in want:
        gap = (got[k] - want[k]).abs()
        allow = 1e-6 + (1 - decay) * (got_c[k] - want_c[k]).abs()
        assert bool((gap <= allow).all()), (k, float(gap.max()))


@pytest.mark.parametrize("kind", list(ENVS))
def test_update_matches_jax(kind):
    from test_torch_rl_learner import check_params

    discrete = kind == "discrete"
    jalgo, talgo = _pair(ENVS[kind])
    cfg = jalgo.config
    obs_dim, n_act = talgo._env.observation_space.shape[0], talgo._a_prev.shape[0]
    jalgo.ret_scale = jnp.float32(1.0)      # one compile: the carried scale is not weak-typed
    replay = _jax_replay(jalgo)
    rng = np.random.default_rng(5)
    for i in range(2):
        talgo.set_weights(flax_dreamer_to_state_dict(jax.device_get(jalgo.weights)))
        talgo.ret_scale = torch.tensor(float(jalgo.ret_scale))
        before = talgo.get_weights()
        batch = _batch(rng, obs_dim, n_act, discrete)
        key = jax.random.PRNGKey(cfg.seed * 7919 + i)
        noise = jax_draws(key, n_act, discrete)
        w_old = jax.device_get(jalgo.weights)
        jalgo.weights, jalgo.opt_state, jalgo.ret_scale, want = jalgo._update(
            jalgo.weights, jalgo.opt_state, jalgo.ret_scale,
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        want = {k: float(v) for k, v in jax.device_get(want).items()}
        post, prior, act = (np.asarray(v) for v in replay(
            w_old, jalgo.weights["wm"], batch, {k: jnp.asarray(v) for k, v in noise.items()}))
        draws = {}
        got = talgo._update(batch, {k: torch.from_numpy(v) for k, v in noise.items()}, draws)
        _check_indices(draws["post"], post, f"{kind} update {i}: posterior")
        _check_indices(draws["prior"], prior, f"{kind} update {i}: prior")
        if discrete:
            _check_indices(draws["act"], act, f"{kind} update {i}: actions")
        assert set(got) == set(want)
        for k, w in want.items():
            assert abs(float(got[k]) - w) <= METRIC_TOL * max(1.0, abs(w)), (k, float(got[k]), w)
        assert abs(float(talgo.ret_scale) - float(jalgo.ret_scale)) <= METRIC_TOL
        jw = flax_dreamer_to_state_dict(jax.device_get(jalgo.weights))
        tw = talgo.get_weights()
        for net, lr in (("wm", cfg.wm_lr), ("actor", cfg.ac_lr), ("critic", cfg.ac_lr)):
            check_params(tw[net], jw[net], before[net], lr, 1)
        _check_ema(tw["critic_ema"], jw["critic_ema"], tw["critic"], jw["critic"],
                   cfg.critic_ema_decay)
    jalgo.stop()
    talgo.stop()


# ------------------------------------------------------------- JAX's cases
@pytest.mark.parametrize("env", ["CartPole-v1", "Pendulum-v1"])
def test_dreamerv3_trains(env):
    algo = (DreamerV3Config().environment(env).resources(device="cpu")
            .training(deter=64, stoch=4, classes=4, model={"hiddens": (64, 64)},
                      batch_size_B=4, batch_length_T=12, horizon=5,
                      rollout_fragment_length=64,
                      num_steps_sampled_before_learning_starts=128)
            .debugging(seed=3).build())
    learned = False
    for _ in range(4):
        result = algo.train()
        assert result["num_env_steps_sampled_this_iter"] == 64
        if "learner" in result:
            learned = True
            lm = result["learner"]
            for k in ("wm_loss", "wm_recon", "wm_kl_dyn", "actor_loss", "critic_loss",
                      "imagined_return"):
                assert np.isfinite(lm[k]), (k, lm)
            assert lm["return_scale"] > 0
    assert learned
    algo.stop()


def test_dreamerv3_world_model_learns_dynamics():
    """On a deterministic env the recon loss drops markedly as the RSSM fits
    the transition structure (JAX's settings and bar)."""
    algo = (DreamerV3Config().environment("CartPole-v1").resources(device="cpu")
            .training(deter=64, stoch=4, classes=4, model={"hiddens": (64, 64)},
                      batch_size_B=8, batch_length_T=16, horizon=5,
                      rollout_fragment_length=128,
                      num_steps_sampled_before_learning_starts=128, train_intensity=8)
            .debugging(seed=1).build())
    first, last = None, None
    for _ in range(6):
        lm = algo.train().get("learner")
        if lm:
            first = lm["wm_recon"] if first is None else first
            last = lm["wm_recon"]
    assert first is not None
    assert last < first * 0.7, (first, last)
    algo.stop()


def test_dreamerv3_weight_roundtrip():
    mk = lambda seed: (DreamerV3Config().environment("CartPole-v1").resources(device="cpu")
                       .training(deter=32, stoch=4, classes=4, model={"hiddens": (32,)},
                                 rollout_fragment_length=8,
                                 num_steps_sampled_before_learning_starts=4,
                                 batch_size_B=2, batch_length_T=6, horizon=3)
                       .debugging(seed=seed).build())
    a, b = mk(0), mk(1)
    a.train()
    b.train()
    opt_state = {k: v.clone() for k, v in b.wm_opt.state_dict()["state"][0].items()}
    b.set_weights(a.get_weights())
    wa, wb = a.get_weights(), b.get_weights()
    for net in wa:
        assert set(wa[net]) == set(wb[net])
        for k in wa[net]:
            assert torch.equal(wa[net][k], wb[net][k]), (net, k)
    # set_weights keeps the optimizers' moments, as JAX keeps its opt_state
    kept = b.wm_opt.state_dict()["state"][0]
    assert all(torch.equal(kept[k], v) for k, v in opt_state.items())
    a.stop()
    b.stop()


_CALLABLE_ENV = """
import sys
sys.path.insert(0, {repo!r})
from chip_smoke import NumpyCartPole
from ray_tpu_torch.rllib import DreamerV3Config
algo = (DreamerV3Config().environment(NumpyCartPole).resources(device="cpu")
        .training(deter=32, stoch=4, classes=4, model={{"hiddens": (32,)}},
                  rollout_fragment_length=16, num_steps_sampled_before_learning_starts=16,
                  batch_size_B=2, batch_length_T=6, horizon=3).build())
lm = [algo.train() for _ in range(2)][-1]["learner"]
algo.stop()
print("gymnasium" in sys.modules, "jax" in sys.modules, lm["wm_loss"])
"""


def test_callable_env_leaves_gymnasium_unimported():
    out = subprocess.run([sys.executable, "-c", _CALLABLE_ENV.format(repo=REPO)],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    gym_loaded, jax_loaded, loss = out.stdout.split()
    assert (gym_loaded, jax_loaded) == ("False", "False") and np.isfinite(float(loss))


def test_chip_smoke_cartpole_steps_as_gymnasium():
    """chip_smoke.py's numpy CartPole (the chip machine has no gymnasium)
    against gymnasium's CartPole-v1 from one seed, through resets and the
    500-step truncation, on a seeded action stream."""
    import gymnasium as gym
    sys.path.insert(0, REPO)
    from chip_smoke import NumpyCartPole
    want, got = gym.make("CartPole-v1"), NumpyCartPole()
    (ow, _), (og, _) = want.reset(seed=4), got.reset(seed=4)
    assert np.array_equal(ow, og)
    rng = np.random.default_rng(0)
    ends = 0
    for t in range(3000):
        a = int(rng.integers(2)) if t % 700 < 600 else t % 2   # alternating: long episodes
        sw, sg = want.step(a), got.step(a)
        assert np.array_equal(sw[0], sg[0]) and sw[1:4] == sg[1:4], (t, sw[:4], sg[:4])
        if sw[2] or sw[3]:
            ends += 1
            (ow, _), (og, _) = want.reset(), got.reset()
            assert np.array_equal(ow, og)
    assert ends > 10
