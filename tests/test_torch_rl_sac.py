"""The port's SAC and TQC against ray_tpu's on the CPU (Pendulum-v1's
spaces, the default (256, 256) nets): two updates each, the port
re-synced to JAX's weights before each (Adam's moments stay in both), on
numpy-seeded minibatches with JAX's own draws injected (`jax.random.normal`
on the keys JAX splits inside its update); TQC's stacked layout; TQC's
truncation property on the port's own update; and the Algorithms'
replay loops on Pendulum-v1 on `.resources(device="cpu")`.

Tolerances (f32): critic_loss, actor_loss, alpha and entropy (and TQC's
z_target_mean) within 1e-4 relative (of max(1, |value|)); the online
nets' params as tests/test_torch_rl_learner.py holds them (the Adam
bound, 2 lr a step, and at most 1e-3 of the coordinates lr / 100 apart);
each Polyak target within 1e-6 plus tau times its online param's gap."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import SACConfig as JSACConfig, TQCConfig as JTQCConfig
from ray_tpu_torch.models.convert import flax_sac_to_state_dict, flax_tqc_to_state_dict
from ray_tpu_torch.rllib import SACConfig, TQCConfig, sample_batch as SB
from ray_tpu_torch.rllib.algorithms.sac import SACLearner
from ray_tpu_torch.rllib.algorithms.tqc import TQCLearner
from ray_tpu_torch.rllib.rl_module import ModuleSpec
from test_torch_rl_learner import check_params

METRIC_TOL = 1e-4
POLYAK_TOL = 1e-6
PENDULUM = ModuleSpec((3,), "continuous", 1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: parallel test workers
    then do not oversubscribe the cores, and results do not depend on the
    machine's core count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pendulum_batch(seed, n=256):
    rng = np.random.default_rng(seed)
    return {SB.OBS: rng.standard_normal((n, 3)).astype(np.float32),
            SB.ACTIONS: rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            SB.REWARDS: rng.standard_normal(n).astype(np.float32),
            SB.NEXT_OBS: rng.standard_normal((n, 3)).astype(np.float32),
            SB.TERMINATEDS: (rng.random(n) < 0.1).astype(np.float32)}


def jax_normals(key, n, d, count):
    """JAX's standard normals for the first `count` keys split from `key`."""
    keys = jax.random.split(key, count)
    return [np.array(jax.random.normal(k, (n, d))) for k in keys]


def check_metrics(got, want, keys):
    for k in keys:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= METRIC_TOL * max(1.0, abs(w)), (k, g, w)


def check_update(got_w, want_w, before, lr, tau, target_of):
    """Online params by the Adam share; each target key t within
    POLYAK_TOL + tau |online gap| of JAX's, its online key `target_of(t)`."""
    targets = {k for k in want_w if target_of(k) is not None}
    online = lambda d: {k: v for k, v in d.items() if k not in targets}
    check_params(online(got_w), online(want_w), online(before), lr, 1)
    for k in targets:
        gap = (got_w[k] - want_w[k]).abs()
        src = target_of(k)
        allow = POLYAK_TOL + tau * (got_w[src] - want_w[src]).abs()
        assert bool((gap <= allow).all()), (k, float(gap.max()))


def _sac_target_of(k):
    head = k.split(".")[0]
    return k.replace(head, head[:-len("_target")], 1) if head.endswith("_target") else None


def test_sac_updates_match_jax():
    jalgo = JSACConfig().environment("Pendulum-v1").build()
    cfg = SACConfig().resources(device="cpu")
    learner = SACLearner(PENDULUM, cfg, -2.0, 2.0)
    for i, seed in enumerate((1, 2)):
        learner.set_weights(flax_sac_to_state_dict(jax.device_get(jalgo.weights)))
        before = learner.get_weights()
        batch = pendulum_batch(seed)
        key = jax.random.PRNGKey(1000 + i)
        nxt, pi = jax_normals(key, 256, 1, 2)
        jalgo.weights, jalgo.opt_state, want = jalgo._update(jalgo.weights, jalgo.opt_state,
                                                             batch, key)
        got = learner.update(batch, noise={"next": nxt, "pi": pi})
        check_metrics(got, want, ("critic_loss", "actor_loss", "alpha", "entropy"))
        check_update(learner.get_weights(), flax_sac_to_state_dict(jax.device_get(jalgo.weights)),
                     before, cfg.lr, cfg.tau, _sac_target_of)
    jalgo.stop()


def _tqc_target_of(k):
    return k.replace("critics_target.", "critics.", 1) if k.startswith("critics_target.") else None


def test_tqc_updates_match_jax():
    jalgo = JTQCConfig().environment("Pendulum-v1").build()
    cfg = TQCConfig().resources(device="cpu")
    learner = TQCLearner(PENDULUM, cfg, -2.0, 2.0)
    for i, seed in enumerate((3, 4)):
        learner.set_weights(flax_tqc_to_state_dict(jax.device_get(jalgo.weights)))
        before = learner.get_weights()
        batch = pendulum_batch(seed)
        key = jax.random.PRNGKey(2000 + i)
        nxt, pi = jax_normals(key, 256, 1, 2)
        jalgo.weights, jalgo.opt_state, want = jalgo._update(jalgo.weights, jalgo.opt_state,
                                                             batch, key)
        got = learner.update(batch, noise={"next": nxt, "pi": pi})
        check_metrics(got, want, ("critic_loss", "actor_loss", "alpha", "entropy",
                                  "z_target_mean"))
        check_update(learner.get_weights(), flax_tqc_to_state_dict(jax.device_get(jalgo.weights)),
                     before, cfg.lr, cfg.tau, _tqc_target_of)
    jalgo.stop()


def test_tqc_ensemble_is_stacked():
    cfg = (TQCConfig().environment("Pendulum-v1").resources(device="cpu")
           .training(n_quantiles=7, n_critics=3, top_quantiles_to_drop_per_net=1,
                     rollout_fragment_length=4))
    algo = cfg.build()
    w = algo.get_weights()
    crit = {k: v for k, v in w.items() if k.startswith("critics")}
    assert crit and all(v.shape[0] == 3 for v in crit.values())
    assert w["critics.torso.dense_0.kernel"].shape == (3, 4, 256)      # flax's [n, in, out]
    z = algo.module.z_all(algo.learner.net.critics, torch.zeros(5, 3), torch.zeros(5, 1))
    assert z.shape == (5, 3, 7)
    # the stacked apply equals each critic run alone
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    z = algo.module.z_all(algo.learner.net.critics, x[:, :3], x[:, 3:])
    for c in range(3):
        h = x
        for i in range(2):
            layer = getattr(algo.learner.net.critics.torso, f"dense_{i}")
            h = torch.tanh(h @ layer.kernel[c] + layer.bias[c])
        zc = h @ algo.learner.net.critics.z.kernel[c] + algo.learner.net.critics.z.bias[c]
        torch.testing.assert_close(z[:, c], zc.detach(), rtol=1e-5, atol=1e-6)
    algo.stop()


def test_tqc_truncation_lowers_the_target():
    """Dropping the top atoms lowers the pooled target's mean, on the port's
    own update from identical weights, data and draws."""
    batch = pendulum_batch(11, 64)
    noise = {"next": np.random.default_rng(0).standard_normal((64, 1)).astype(np.float32)}

    def target_mean(drop):
        cfg = TQCConfig().training(n_quantiles=11, n_critics=2,
                                   top_quantiles_to_drop_per_net=drop,
                                   model={"hiddens": (32, 32)}).resources(device="cpu")
        learner = TQCLearner(ModuleSpec((3,), "continuous", 1, (32, 32)), cfg, -2.0, 2.0, seed=11)
        return float(learner.update(batch, noise)["z_target_mean"])

    assert target_mean(8) < target_mean(0)
    with pytest.raises(ValueError, match="drops every atom"):
        target_mean(11)


@pytest.mark.parametrize("config_cls", [SACConfig, TQCConfig], ids=["sac", "tqc"])
def test_replay_loop_on_pendulum(config_cls):
    algo = (config_cls().environment("Pendulum-v1").resources(device="cpu")
            .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
            .training(train_batch_size=64, num_steps_sampled_before_learning_starts=64,
                      train_intensity=2, n_quantiles=13)
            .debugging(seed=5).build())
    results = [algo.train() for _ in range(3)]
    assert "learner" not in results[0] and "learner" in results[1]
    lm = results[-1]["learner"]
    assert np.isfinite(lm["critic_loss"]) and np.isfinite(lm["actor_loss"]) and lm["alpha"] > 0
    assert len(algo.buffer) == 96 and results[-1]["num_env_steps_sampled_this_iter"] == 32
    algo.stop()
