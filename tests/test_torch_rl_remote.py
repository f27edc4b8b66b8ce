"""RLlib's remote env runners and evaluation actors on the port's runtime,
against JAX's on `ray_tpu`'s (gymnasium's CartPole-v1 and Pendulum-v1 on
the CPU).

Both packages start from JAX's weights carried across
(`models/convert.py`): the port with `device="cpu"` on a module session of
its own runtime (`num_gpus=0`), JAX's on `ray_session`. With
`num_env_runners=2` and `explore=False`, each remote runner's batch and the
concatenated batch of `_sample_all` equal JAX's, and one `train()` (two
updates) matches JAX's within test_torch_rl_algorithm.py's limits (metrics
within 1e-4 of max(1, |value|), params by `check_params`), its
evaluation through two evaluation actors equal to JAX's. Then the ports
of test_rllib_eval_lr.py's three evaluation-actor tests, CQL, IQL and
DreamerV3 evaluating inline (no actors made), and stop() leaving no
runner actor alive."""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.rllib import IMPALAConfig as JIMPALAConfig, PPOConfig as JPPOConfig
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
from ray_tpu_torch.rllib import (CQLConfig, DreamerV3Config, IMPALAConfig, IQLConfig,
                                 PPOConfig, SACConfig)
from test_torch_rl_algorithm import _check
from test_torch_rl_offline import _pendulum_dataset, offline_data
from test_torch_rl_sac import one_torch_thread  # noqa: F401 - a fixture


@pytest.fixture(scope="module")
def port_session():
    rt.init(num_cpus=4, num_gpus=0)
    yield rt
    rt.shutdown()


def _chain(cfg, runners=2, envs=2, rollout=32, **training):
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=runners, num_envs_per_env_runner=envs,
                         rollout_fragment_length=rollout, explore=False)
            .training(model={"hiddens": (32, 32)}, **training)
            .debugging(seed=3).resources(device="cpu"))


def _assert_batches_equal(got, want):
    assert set(got.keys()) == set(want.keys())
    for k in want.keys():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _pair(jcfg, tcfg):
    jalgo, talgo = jcfg.build(), tcfg.build()
    start = flax_rl_module_to_state_dict(jalgo.get_weights())
    talgo.set_weights(start)
    return jalgo, talgo, start


def _runner_batches(ray_session, jalgo, talgo, start):
    """Each remote runner's batch from the same weights, runner by runner."""
    jw = ray_session.put(jalgo.get_weights())
    tw = rt.put(start)
    want = ray_session.get([r.sample.remote(jw) for r in jalgo._runner_handles], timeout=120)
    got = rt.get([r.sample.remote(tw) for r in talgo._runner_handles], timeout=120)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert (rt.get([r.pop_metrics.remote() for r in talgo._runner_handles], timeout=60)
            == ray_session.get([r.pop_metrics.remote() for r in jalgo._runner_handles],
                               timeout=60))


def _assert_stopped(talgo, handles):
    talgo.stop()
    for h in handles:
        with pytest.raises(rt.exceptions.ActorDiedError):
            rt.get(h.node_info.remote(), timeout=60)


def test_ppo_remote_runners_and_eval_actors_match_jax(ray_session, port_session,
                                                      one_torch_thread):
    jcfg, tcfg = (_chain(c, train_batch_size=128, minibatch_size=64, num_epochs=1)
                  .evaluation(evaluation_interval=1, evaluation_duration=4,
                              evaluation_num_env_runners=2)
                  for c in (JPPOConfig(), PPOConfig()))
    jalgo, talgo, start = _pair(jcfg, tcfg)
    assert len(talgo._runner_handles) == len(talgo._eval_handles) == 2
    _runner_batches(ray_session, jalgo, talgo, start)
    (got, gm), (want, wm) = talgo._sample_all(start), jalgo._sample_all(jalgo.get_weights())
    assert got.count == want.count and np.asarray(got["obs"]).shape == (32, 4, 4)
    _assert_batches_equal(got, want)
    assert gm == pytest.approx(wm)
    # one train() from the same weights: two minibatch updates, then the
    # evaluation actors' greedy episodes on the updated weights
    talgo.set_weights(start)
    want, got = jalgo.train(), talgo.train()
    _check(got, want, start, jalgo, talgo, 3e-4, 2)
    assert got["evaluation"]["episodes_this_iter"] >= 4
    for k, w in want["evaluation"].items():
        assert got["evaluation"][k] == pytest.approx(w, rel=1e-6), k
    jalgo.stop()
    _assert_stopped(talgo, talgo._runner_handles + talgo._eval_handles)


def test_impala_remote_runners_match_jax(ray_session, port_session, one_torch_thread):
    jcfg, tcfg = (_chain(c, rollout=16, train_batch_size=64)
                  for c in (JIMPALAConfig(), IMPALAConfig()))
    jalgo, talgo, start = _pair(jcfg, tcfg)
    _runner_batches(ray_session, jalgo, talgo, start)
    want, got = jalgo.train(), talgo.train()
    _check(got, want, start, jalgo, talgo, 5e-4, 1)      # one rollout, one update
    jalgo.stop()
    _assert_stopped(talgo, talgo._runner_handles)


def _slow_cartpole(sleep_s=0.002):
    import gymnasium as gym

    class SlowCartPole(gym.Wrapper):
        def __init__(self):
            super().__init__(gym.make("CartPole-v1"))

        def step(self, action):
            time.sleep(sleep_s)
            return self.env.step(action)

    return SlowCartPole


def test_parallel_eval_does_not_block_train(port_session, one_torch_thread):
    """The iteration that launches a parallel evaluation does not pay its
    episodes: it takes less than an inline iteration that runs them (env
    steps sleep 2 ms, and greedy CartPole episodes last ~100 steps at the
    start, so the evaluation's share is mostly sleep, whatever the load).
    JAX's test times the next iteration, whose evaluation_interval
    of 1 makes it wait for the launched evaluation, and gives it 3x an
    inline one; here the launching iteration itself is timed, with the
    evaluation actor warmed by one evaluate() first. The result attaches
    to a later iteration."""
    def build(parallel, n_eval):
        return (PPOConfig()
                .environment(_slow_cartpole())
                .training(lr=1e-3, train_batch_size=64, minibatch_size=64, num_epochs=1,
                          model={"hiddens": (32, 32)})
                .env_runners(rollout_fragment_length=32)
                .evaluation(evaluation_interval=1, evaluation_duration=4,
                            evaluation_num_env_runners=n_eval,
                            evaluation_parallel_to_training=parallel)
                .resources(device="cpu")
                .build())

    inline = build(parallel=False, n_eval=0)
    inline.train()
    t0 = time.perf_counter()
    r_inline = inline.train()
    inline_time = time.perf_counter() - t0
    assert "evaluation" in r_inline

    par = build(parallel=True, n_eval=1)
    par.evaluate()
    t0 = time.perf_counter()
    r1 = par.train()    # launches the evaluation in the dedicated actor
    par_time = time.perf_counter() - t0
    r2 = par.train()
    assert "evaluation" not in r1
    # results attach once ready (waited for at the next due interval)
    assert ("evaluation" in r2) or ("evaluation" in par.train())
    assert par_time < inline_time, (par_time, inline_time)
    inline.stop()
    par.stop()


def test_eval_metrics_from_dedicated_workers(port_session, one_torch_thread):
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .training(lr=1e-3, train_batch_size=64, minibatch_size=64, num_epochs=1)
            .env_runners(rollout_fragment_length=32)
            .evaluation(evaluation_interval=1, evaluation_duration=4,
                        evaluation_num_env_runners=2)
            .resources(device="cpu")
            .build())
    ev = algo.evaluate()
    assert ev["episodes_this_iter"] >= 4
    assert np.isfinite(ev["episode_return_mean"])
    algo.stop()


def test_sac_eval_actors_use_module_override(port_session, one_torch_thread):
    """Dedicated eval runners are built with the algorithm's runner kwargs
    (SAC's module override), not generic ones."""
    algo = (SACConfig()
            .environment("Pendulum-v1")
            .training(train_batch_size=64, num_steps_sampled_before_learning_starts=64)
            .env_runners(rollout_fragment_length=16)
            .evaluation(evaluation_interval=1, evaluation_duration=1,
                        evaluation_num_env_runners=1)
            .resources(device="cpu")
            .debugging(seed=3)
            .build())
    assert len(algo._eval_handles) == 1
    ev = algo.evaluate()    # a generic runner cannot act with SAC's weights
    assert ev["episodes_this_iter"] >= 1
    algo.stop()


@pytest.mark.parametrize("name", ["cql", "iql", "dreamerv3"])
def test_offline_and_dreamer_evaluate_inline(port_session, one_torch_thread, name):
    """CQL, IQL and DreamerV3 set `_supports_eval_actors = False`, as JAX's
    do: evaluation actors asked for are not made, and the evaluation runs
    inline (DreamerV3's reports the episodes its training loop finished,
    so it is read from train()'s result before any update)."""
    evaluation = dict(evaluation_interval=1, evaluation_duration=1,
                      evaluation_num_env_runners=2)
    if name == "dreamerv3":
        cfg = (DreamerV3Config().environment("CartPole-v1")
               .training(deter=32, stoch=4, classes=4, model={"hiddens": (32,)},
                         rollout_fragment_length=128,
                         num_steps_sampled_before_learning_starts=10_000,
                         batch_size_B=2, batch_length_T=6, horizon=3))
    else:
        cls = {"cql": CQLConfig, "iql": IQLConfig}[name]
        data = _pendulum_dataset(200) if name == "cql" else offline_data(200, seed=1)
        cfg = cls().environment("Pendulum-v1").offline_data_source(data)
    algo = cfg.evaluation(**evaluation).resources(device="cpu").debugging(seed=0).build()
    assert algo._eval_handles == []
    ev = algo.train()["evaluation"] if name == "dreamerv3" else algo.evaluate()
    assert ev["episodes_this_iter"] >= 1 and np.isfinite(ev["episode_return_mean"])
    algo.stop()
