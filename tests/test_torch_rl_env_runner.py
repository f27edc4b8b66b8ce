"""The port's EnvRunner, compute_gae and SampleBatch against ray_tpu's on
the CPU (gymnasium's CartPole-v1, numpy-seeded batches), and the port's
EnvRunner as a `ray_tpu` actor.

Greedy runners (explore=False) from the same weights (JAX's, carried
across) must give equal obs, actions, rewards and dones; vf_preds and the
bootstrap within 1e-5 of max |value| (f32 MLP forward); GAE within 1e-5
of max |value|."""

import numpy as np
import pytest
import torch

from ray_tpu.rllib import EnvRunner as JEnvRunner, SampleBatch as JSampleBatch
from ray_tpu.rllib.connectors import compute_gae as jcompute_gae
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
from ray_tpu_torch.rllib import EnvRunner, SampleBatch, sample_batch as SB
from ray_tpu_torch.rllib.connectors import RunningMeanStd, compute_gae, standardize_advantages

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def jax_weights():
    runner = JEnvRunner("CartPole-v1", num_envs=1, rollout_len=2, seed=7)
    w = runner.init_params()
    runner.close()
    return w


def _greedy_pair(jax_weights, num_envs=3, rollout_len=40, seed=5):
    kw = dict(num_envs=num_envs, rollout_len=rollout_len, seed=seed, explore=False,
              record_next_obs=True)
    jr = JEnvRunner("CartPole-v1", **kw)
    tr = EnvRunner("CartPole-v1", **kw)
    jr.set_weights(jax_weights)
    tr.set_weights(flax_rl_module_to_state_dict(jax_weights))
    return jr, tr


def _check_rollouts(got, want):
    assert set(got) == set(want)
    for k in (SB.OBS, SB.NEXT_OBS, SB.REWARDS, SB.DONES, SB.TERMINATEDS, SB.LOGP):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got[SB.ACTIONS], np.asarray(want[SB.ACTIONS]).astype(np.int64))
    _close(got[SB.VF_PREDS], want[SB.VF_PREDS])
    _close(got[SB.BOOTSTRAP_VALUE], want[SB.BOOTSTRAP_VALUE])


def test_greedy_rollouts_match_jax(jax_weights):
    jr, tr = _greedy_pair(jax_weights)
    done = 0
    for _ in range(3):              # rollouts continue from the last state
        want, got = jr.sample(), tr.sample()
        _check_rollouts(got, want)
        done += int(got[SB.DONES].sum())
        # the bootstrap is 0 where the last step terminated
        assert np.all(got[SB.BOOTSTRAP_VALUE][got[SB.TERMINATEDS][-1] == 1.0] == 0.0)
    assert done > 0
    assert tr.pop_metrics() == pytest.approx(jr.pop_metrics())
    jr.close()
    tr.close()


def test_env_runner_shapes_and_metrics():
    runner = EnvRunner("CartPole-v1", num_envs=4, rollout_len=50, seed=3)
    runner.set_weights(runner.init_params())
    batch = runner.sample()
    assert batch[SB.OBS].shape == (50, 4, 4)
    assert batch[SB.ACTIONS].shape == (50, 4)
    assert batch[SB.REWARDS].shape == (50, 4)
    assert batch[SB.BOOTSTRAP_VALUE].shape == (4,)
    m = runner.pop_metrics()
    assert m["episodes_this_iter"] > 0  # a random policy ends episodes fast
    assert m["episode_return_mean"] > 0
    runner.close()


def test_explore_is_seeded_and_records_version():
    from ray_tpu_torch.util import metrics
    outs = []
    for _ in range(2):
        runner = EnvRunner("CartPole-v1", num_envs=2, rollout_len=20, seed=11)
        runner.set_weights(runner.init_params(), version=3)
        outs.append(runner.sample())
        runner.close()
    np.testing.assert_array_equal(outs[0][SB.ACTIONS], outs[1][SB.ACTIONS])
    assert runner.params_version == 3
    gauge = metrics.get_or_create(metrics.Gauge, "rllib_param_version", tag_keys=("role",))
    assert [v for k, v in gauge.snapshot()["values"].items() if ("role", "rollout") in k] == [3]


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 12, 3
    batch = {SB.REWARDS: rng.standard_normal((T, B)).astype(np.float32),
             SB.VF_PREDS: rng.standard_normal((T, B)).astype(np.float32),
             SB.BOOTSTRAP_VALUE: rng.standard_normal(B).astype(np.float32),
             SB.DONES: (rng.random((T, B)) < 0.2).astype(np.float32)}
    want = jcompute_gae(JSampleBatch(dict(batch)), 0.97, 0.9)
    got = compute_gae(SampleBatch(dict(batch)), 0.97, 0.9)
    for k in (SB.ADVANTAGES, SB.VALUE_TARGETS):
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32
        _close(got[k], want[k])
    std = standardize_advantages(got)[SB.ADVANTAGES]
    assert abs(std.mean()) < 1e-6 and abs(std.std() - 1) < 1e-5


def test_compute_gae_batch_shapes():
    T, B = 8, 3
    batch = SampleBatch({
        SB.REWARDS: np.ones((T, B), np.float32),
        SB.VF_PREDS: np.zeros((T, B), np.float32),
        SB.BOOTSTRAP_VALUE: np.zeros(B, np.float32),
        SB.DONES: np.zeros((T, B), np.float32),
    })
    batch = compute_gae(batch, gamma=1.0, lam=1.0)
    # undiscounted, zero values: the advantage at t is the T - t rewards left
    np.testing.assert_allclose(batch[SB.ADVANTAGES][:, 0], np.arange(T, 0, -1), rtol=1e-6)


def test_sample_batch_matches_jax():
    x = np.arange(24).reshape(6, 4)
    cols = {"x": x, "y": x * 2.0, "s": np.float32(3)}
    jb, tb = JSampleBatch(cols), SampleBatch(cols)
    assert tb.count == jb.count == 6
    jf, tf = jb.flatten(), tb.flatten()
    np.testing.assert_array_equal(tf["x"], jf["x"])
    assert [m["x"].shape[0] for m in tf.minibatches(10)] == [10, 10]
    for a, b in zip(tf.shuffle(np.random.default_rng(4)).minibatches(8),
                    jf.shuffle(np.random.default_rng(4)).minibatches(8)):
        np.testing.assert_array_equal(a["y"], b["y"])
    cat = SampleBatch.concat([tb, tb])
    np.testing.assert_array_equal(cat["x"], JSampleBatch.concat([jb, jb])["x"])
    dev = tb.to_device("cpu")
    assert dev["x"].dtype == torch.int64 and dev["y"].dtype == torch.float32


def test_running_mean_std():
    rng = np.random.default_rng(2)
    rms = RunningMeanStd(shape=(3,))
    data = rng.normal(loc=2.0, scale=3.0, size=(1000, 3))
    for chunk in np.split(data, 10):
        rms.update(chunk)
    np.testing.assert_allclose(rms.mean, data.mean(0), rtol=1e-6)
    np.testing.assert_allclose(rms.var, data.var(0), rtol=1e-4)


def test_env_runner_as_ray_tpu_actor(ray_session, jax_weights):
    """ray_tpu's runtime composed with the port: the port's EnvRunner as an
    actor, its weights through the object store, samples equal to the
    inline runner's."""
    weights = flax_rl_module_to_state_dict(jax_weights)
    kw = dict(num_envs=2, rollout_len=30, seed=9, explore=False)
    inline = EnvRunner("CartPole-v1", **kw)
    inline.set_weights(weights)
    actor = ray_session.remote(num_cpus=1)(EnvRunner).remote("CartPole-v1", **kw)
    wref = ray_session.put(weights)
    for _ in range(2):
        got = ray_session.get(actor.sample.remote(wref))
        want = inline.sample()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ray_session.get(actor.pop_metrics.remote()) == inline.pop_metrics()
    ray_session.kill(actor)
    inline.close()
