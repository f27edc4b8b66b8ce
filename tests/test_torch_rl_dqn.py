"""The port's DQN against ray_tpu's on the CPU: the Q-net forward (MLP,
Nature CNN, dueling) from JAX's params carried across with
`convert.flax_qnet_to_state_dict`; one TD update from JAX's params and a
separate target, double-Q on and off, with PER importance weights; the
target sync, the epsilon schedule and greedy acting; and a CartPole-v1
run past learning starts on `.resources(device="cpu")`.

Tolerances (f32): Q values within 1e-5 of max(1, |Q|); the update's loss,
`qmean` and `td_abs` within 1e-5 relative (of max(1, |value|)); params as
tests/test_torch_rl_learner.py holds them (the Adam bound, 2 lr a step,
on each coordinate, and at most 1e-3 of the coordinates lr / 100
apart)."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import DQNConfig as JDQNConfig
from ray_tpu.rllib.algorithms.dqn import QNet as JQNet
from ray_tpu.rllib.rl_module import ModuleSpec as JSpec
from ray_tpu_torch.models.convert import flax_qnet_to_state_dict
from ray_tpu_torch.rllib import DQNConfig, sample_batch as SB
from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner, DQNModule, QNet
from ray_tpu_torch.rllib.learner import _host_metrics
from ray_tpu_torch.rllib.rl_module import ModuleSpec
from test_torch_rl_learner import check_params
from test_torch_rl_sac import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def _qnet_pair(obs_shape, n_actions, dueling, use_cnn=False, seed=0):
    jspec = JSpec(obs_shape, "discrete", n_actions, (32, 32), use_cnn)
    jnet = JQNet(jspec, dueling)
    params = jnet.init(jax.random.PRNGKey(seed), np.zeros((1,) + obs_shape, np.float32))
    net = QNet(ModuleSpec(obs_shape, "discrete", n_actions, (32, 32), use_cnn), dueling)
    net.load_state_dict(flax_qnet_to_state_dict({"params": params, "epsilon": 0.5}))
    return jnet, params, net


@pytest.mark.parametrize("obs_shape,n_actions,dueling,use_cnn", [
    ((4,), 2, False, False), ((4,), 3, True, False), ((84, 84, 4), 6, False, True),
    ((84, 84, 4), 6, True, True)], ids=["mlp", "mlp_dueling", "cnn", "cnn_dueling"])
def test_qnet_forward_matches_jax(obs_shape, n_actions, dueling, use_cnn):
    jnet, params, net = _qnet_pair(obs_shape, n_actions, dueling, use_cnn)
    rng = np.random.default_rng(1)
    obs = (rng.integers(0, 256, (3,) + obs_shape).astype(np.uint8) if use_cnn
           else rng.standard_normal((5,) + obs_shape).astype(np.float32))
    want = np.asarray(jnet.apply(params, obs))
    got = net(torch.from_numpy(obs)).detach().numpy()
    assert float(net.epsilon) == 0.5
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()))


def _cartpole_batch(seed, n=32, weights=True):
    rng = np.random.default_rng(seed)
    b = {SB.OBS: rng.standard_normal((n, 4)).astype(np.float32),
         SB.ACTIONS: rng.integers(0, 2, n), SB.REWARDS: np.ones(n, np.float32),
         SB.NEXT_OBS: rng.standard_normal((n, 4)).astype(np.float32),
         SB.TERMINATEDS: (rng.random(n) < 0.2).astype(np.float32)}
    if weights:
        b["_weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return b


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0, np.abs(want))), (got, want)


@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "max_q"])
def test_update_matches_jax(double_q):
    """One update of JAX's DQN (CartPole-v1's spaces, its default (256,
    256) net) against DQNLearner from the same online params and a target
    from other params, on a batch with PER weights."""
    jcfg = JDQNConfig().environment("CartPole-v1").training(double_q=double_q)
    jalgo = jcfg.build()
    target = JQNet(jalgo.module.spec).init(jax.random.PRNGKey(9), np.zeros((1, 4), np.float32))
    params = jalgo.weights["params"]
    learner = DQNLearner(ModuleSpec((4,), "discrete", 2),
                         DQNConfig().training(double_q=double_q).resources(device="cpu"))
    learner.set_weights(flax_qnet_to_state_dict(jax.device_get(jalgo.weights)))
    learner.target.load_state_dict(flax_qnet_to_state_dict({"params": target, "epsilon": 1.0}))
    before = learner.get_weights()
    batch = _cartpole_batch(3)
    new_params, _, aux = jalgo._update(params, target, jalgo.opt_state, batch)
    got = learner.update(batch)
    for k in ("loss", "qmean", "td_abs"):
        _close(got[k].numpy(), aux[k])
    host = _host_metrics([got])              # the vector td_abs as its mean and max
    assert sorted(host) == ["loss", "qmean", "td_abs_max", "td_abs_mean"]
    _close(host["td_abs_mean"], np.mean(aux["td_abs"]))
    _close(host["td_abs_max"], np.max(aux["td_abs"]))
    check_params(learner.get_weights(),
                 flax_qnet_to_state_dict({"params": jax.device_get(new_params), "epsilon": 1.0}),
                 before, jcfg.lr, 1)
    jalgo.stop()


def test_target_sync_epsilon_and_greedy_acting():
    cfg = (DQNConfig().environment("CartPole-v1").resources(device="cpu")
           .env_runners(rollout_fragment_length=8)
           .training(num_steps_sampled_before_learning_starts=0, train_intensity=4,
                     target_network_update_freq=4, epsilon_decay_steps=20))
    jcfg = (JDQNConfig().environment("CartPole-v1").env_runners(rollout_fragment_length=8)
            .training(num_steps_sampled_before_learning_starts=0, train_intensity=4,
                      target_network_update_freq=4, epsilon_decay_steps=20))
    algo, jalgo = cfg.build(), jcfg.build()
    eps = []
    for _ in range(3):
        r, jr = algo.train(), jalgo.train()
        assert r["epsilon"] == pytest.approx(jr["epsilon"], rel=1e-12)
        eps.append(r["epsilon"])
        assert r["learner"]["sgd_steps"] == jr["learner"]["sgd_steps"]
        net, target = algo.learner.net.state_dict(), algo.learner.target.state_dict()
        assert all(torch.equal(net[k], target[k]) for k in net if k != "epsilon")
    np.testing.assert_allclose(eps, [1.0 + f * (0.02 - 1.0) for f in (8 / 20, 16 / 20, 1.0)])
    # the runner acted with the epsilon of the env steps before the iteration
    assert float(algo.learner.net.epsilon) == pytest.approx(eps[-2])
    assert float(jax.device_get(jalgo.weights["epsilon"])) == pytest.approx(eps[-2])

    algo.learner.config.target_network_update_freq = 5     # sync at step 15, not 16
    before = algo.learner.target.state_dict()["q.weight"].clone()
    algo.train()
    assert not torch.equal(algo.learner.target.state_dict()["q.weight"], before)
    assert not torch.equal(algo.learner.target.state_dict()["q.weight"],
                           algo.learner.net.state_dict()["q.weight"])

    # greedy acting equals the argmax; epsilon 1 acts uniformly at random
    module = DQNModule(ModuleSpec((4,), "discrete", 2, (32, 32)))
    net = module.make_net(0)
    obs = torch.randn(256, 4, generator=torch.Generator().manual_seed(0))
    a, _ = module.inference_step(net, obs)
    assert torch.equal(a, net(obs).argmax(-1))
    net.epsilon.fill_(0.0)
    assert torch.equal(module.explore_step(net, obs, torch.Generator())[0], a)
    net.epsilon.fill_(1.0)
    share = (module.explore_step(net, obs, torch.Generator().manual_seed(1))[0] == a)
    assert 0.3 < float(share.float().mean()) < 0.7
    algo.stop()
    jalgo.stop()


@pytest.mark.parametrize("prioritized", [False, True], ids=["uniform", "per"])
def test_dqn_cartpole_runs_past_learning_starts(prioritized):
    cfg = (DQNConfig().environment("CartPole-v1").resources(device="cpu")
           .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
           .training(num_steps_sampled_before_learning_starts=32, train_intensity=2,
                     dueling=prioritized, prioritized_replay=prioritized,
                     target_network_update_freq=3))
    assert cfg.device == "cpu" and DQNConfig().device == "cuda"
    algo = cfg.build()
    assert "learner" in algo.train()                    # 2 x 16 env steps: learning starts
    r = algo.train()
    assert np.isfinite(r["learner"]["loss"]) and r["learner"]["sgd_steps"] >= 2
    assert r["num_env_steps_sampled_this_iter"] == 32
    if prioritized:
        assert algo.buffer.max_priority != 1.0          # the TD errors were written back
    algo.stop()
