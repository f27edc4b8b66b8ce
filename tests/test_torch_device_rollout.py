"""The port's device-resident CartPole (`rllib/sebulba.py`) on the CPU:
`TorchCartPole.step` against `JaxCartPole.step` on the same states and
actions; DeviceRollout's fixed shapes, autoreset and determinism given a
seed (tests/test_rllib_sebulba.py's cases); its bootstrap rule; and the
columns it records against the module and the physics.

Tolerance: the next state within 1e-6 absolute of JAX's (f32, |x| < 3:
a few ulp of the cos and sin implementations); the flags exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import JaxCartPole
from ray_tpu_torch.rllib import DeviceRollout, TorchCartPole, sample_batch as SB
from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig, IMPALALearner

STATE_TOL = 1e-6


def _states(n=256, seed=0):
    """States across the whole box, some beyond the limits, and step counts
    up to the truncation step."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1, 1, (n, 4)) * [2.6, 2.0, 0.25, 2.5]).astype(np.float32)
    t = rng.integers(490, 500, n).astype(np.int32)
    a = rng.integers(0, 2, n)
    return x, t, a


def test_cartpole_step_matches_jax():
    x, t, a = _states()
    want = JaxCartPole.step(jnp.asarray(x), jnp.asarray(t), jnp.asarray(a))
    got = TorchCartPole.step(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(a))
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= STATE_TOL
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    term, trunc = got[3].numpy(), got[4].numpy()
    assert term.any() and (~term).any() and trunc.any()


def test_cartpole_matches_gym_physics():
    import gymnasium as gym
    env = gym.make("CartPole-v1")
    env.reset(seed=0)
    state = np.array([0.01, -0.02, 0.03, 0.04], np.float32)
    for action in (0, 1):
        env.unwrapped.state = state.copy()
        obs_g, rew_g, term_g, _, _ = env.step(action)
        x2, _, rew, term, _ = TorchCartPole.step(torch.from_numpy(state[None]),
                                                 torch.zeros(1, dtype=torch.int32),
                                                 torch.tensor([action]))
        np.testing.assert_allclose(x2[0].numpy(), obs_g, atol=1e-5)
        assert float(rew[0]) == rew_g == 1.0 and bool(term[0]) == term_g
    env.close()


def test_device_rollout_fixed_shapes_and_autoreset():
    roll = DeviceRollout("cartpole", num_envs=3, rollout_len=16, seed=5, device="cpu")
    roll.set_weights(roll.init_params(), version=0)
    total_done = 0
    for _ in range(6):   # random-policy episodes end well inside ~96 steps
        b = roll.sample()
        assert b[SB.OBS].shape == (16, 3, 4) and b[SB.OBS].dtype == np.float32
        assert b[SB.ACTIONS].shape == (16, 3) and b[SB.ACTIONS].dtype == np.int64
        assert b[SB.BOOTSTRAP_VALUE].shape == (3,)
        term_last = b[SB.TERMINATEDS][-1]
        assert np.all(b[SB.BOOTSTRAP_VALUE][term_last == 1.0] == 0.0)
        total_done += int(b[SB.DONES].sum())
    assert total_done > 0
    assert roll.pop_metrics()["episodes_this_iter"] == total_done
    assert roll.params_version == 0


def test_device_rollout_deterministic_given_seed():
    params = DeviceRollout("cartpole", num_envs=2, rollout_len=8, seed=9,
                           device="cpu").init_params()
    outs = []
    for _ in range(2):
        roll = DeviceRollout("cartpole", num_envs=2, rollout_len=8, seed=9, device="cpu")
        roll.set_weights(params, version=0)
        outs.append([roll.sample() for _ in range(2)])
    for a, b in zip(*outs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(outs[0][0][SB.OBS], outs[0][1][SB.OBS])


def test_columns_follow_the_module_and_the_physics():
    """logp and vf_preds are the module's on the recorded obs; each next obs
    is the step of the last one, or a reset state where the env was done;
    the bootstrap is the value of the state after the last step, masked by
    the last terminal flag."""
    roll = DeviceRollout("cartpole", num_envs=8, rollout_len=40, seed=2, device="cpu")
    params = roll.init_params()
    roll.set_weights(params)
    b = roll.sample()
    nxt = roll.sample()[SB.OBS][0]
    obs = torch.from_numpy(b[SB.OBS])
    dist_in, value = roll.module.forward(params, obs)
    logp = roll.module.dist(dist_in).log_prob(torch.from_numpy(b[SB.ACTIONS]))
    np.testing.assert_allclose(b[SB.LOGP], logp.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b[SB.VF_PREDS], value.detach().numpy(), rtol=1e-6, atol=1e-6)
    T = b[SB.OBS].shape[0]
    following = np.concatenate([b[SB.OBS][1:], nxt[None]])
    for t in range(T):
        x2, _, _, term, _ = TorchCartPole.step(obs[t], torch.zeros(8, dtype=torch.int32),
                                               torch.from_numpy(b[SB.ACTIONS][t]))
        np.testing.assert_array_equal(term.numpy(), b[SB.TERMINATEDS][t] == 1.0)
        done = b[SB.DONES][t] == 1.0
        np.testing.assert_array_equal(following[t][~done], x2.numpy()[~done])
        assert np.all(np.abs(following[t][done]) <= 0.05)
    _, boot = roll.module.forward(params, torch.from_numpy(nxt))
    np.testing.assert_allclose(b[SB.BOOTSTRAP_VALUE],
                               boot.detach().numpy() * (1 - b[SB.TERMINATEDS][-1]), atol=1e-6)


def test_device_rollout_feeds_the_impala_learner():
    roll = DeviceRollout("cartpole", num_envs=4, rollout_len=10, seed=1, device="cpu")
    cfg = IMPALAConfig().resources(device="cpu")
    learner = IMPALALearner(roll.module, cfg, seed=1)
    for _ in range(2):
        m = learner.update(roll.sample(learner.get_weights()))
        assert np.isfinite(m["total_loss"]) and m["grad_norm"] > 0


def test_device_rollout_defaults_to_cuda():
    if torch.cuda.is_available():
        assert DeviceRollout("cartpole").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceRollout("cartpole")
