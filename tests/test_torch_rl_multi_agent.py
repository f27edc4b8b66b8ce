"""The port's multi-agent RL against ray_tpu's on the CPU: JAX's five cases
(tests/test_rllib_multi_agent.py) on the port, each runner case with a
greedy rollout whose per-policy batches equal JAX's runner's from the
same weights (carried across with `convert.flax_rl_module_to_state_dict`);
multi-agent PPO's greedy (explore=False) `train()` iteration in shared and
independent mode from JAX's weights, whose env-step counts, episode
metrics, per-policy learner metrics and weights must match JAX's, and its
greedy `evaluate()`; and the EnvRunner's `run_eval` and `node_info`.

Tolerances (f32): batch columns within 1e-5; learner metrics within 1e-4
of max(1, |value|); weights as in tests/test_torch_rl_learner.py (the Adam
bound, 2 lr a step, and at most 1e-3 of the coordinates lr / 100 apart).
The learning cases keep JAX's settings and bar (best episode return over
40 in 10 iterations; random play ~24) and start from JAX's initial
weights. Explored actions are drawn from torch generators, not JAX's keys,
and whether a run passes the bar depends on its draws in both packages:
over seeds 0-31, each from its own package's initial weights
(`test_ppo_multi_agent_learning_survey`, marked slow), JAX's runs passed
25 of 32 in shared mode and 23 of 32 in independent mode, the port's 26
and 25 (one-sided Fisher p 0.73 and 0.81), and the port's seed 0 misses
the bar in shared mode; the greedy `train()` above matches JAX's."""

import os

import numpy as np
import pytest

from ray_tpu.rllib.algorithms.ppo import PPOConfig as JPPOConfig
from ray_tpu.rllib.multi_agent import (MultiAgentEnvRunner as JRunner,
                                       module_specs_for as jspecs_for)
from ray_tpu.rllib.rl_module import RLModule as JModule
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
from ray_tpu_torch.rllib import EnvRunner, PPOConfig, RLModule
from ray_tpu_torch.rllib.multi_agent import (MultiAgentBatch, MultiAgentEnvRunner,
                                             module_specs_for)
from test_rllib_multi_agent import MatchGame
from test_torch_rl_learner import check_params
from test_torch_rl_sac import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
METRIC_TOL = 1e-4


def _runners(mapping, rollout_len=32, explore=True, hiddens=(32,)):
    specs = module_specs_for(MatchGame(), mapping, hiddens=hiddens)
    runner = MultiAgentEnvRunner(lambda: MatchGame(), policy_mapping_fn=mapping,
                                 modules={pid: RLModule(s) for pid, s in specs.items()},
                                 rollout_len=rollout_len, explore=explore)
    jspecs = jspecs_for(MatchGame(), mapping, hiddens=hiddens)
    jrunner = JRunner(lambda: MatchGame(), policy_mapping_fn=mapping,
                      modules={pid: JModule(s) for pid, s in jspecs.items()},
                      rollout_len=rollout_len, explore=explore)
    return runner, jrunner


def _check_greedy_equal(mapping, rollouts=2):
    runner, jrunner = _runners(mapping, explore=False)
    jparams = jrunner.init_params()
    params = {pid: flax_rl_module_to_state_dict(p) for pid, p in jparams.items()}
    for _ in range(rollouts):
        (got, gm), (want, wm) = runner.sample(params), jrunner.sample(jparams)
        assert gm == pytest.approx(wm)
        assert sorted(got.keys()) == sorted(want.keys())
        for pid in want.keys():
            g, w = got[pid], want[pid]
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(np.asarray(g[k], np.float64), np.asarray(w[k]),
                                           rtol=TOL, atol=TOL, err_msg=f"{pid}/{k}")


def test_runner_shapes_and_per_policy_batches():
    mapping = lambda aid: aid          # independent: one policy an agent
    runner, _ = _runners(mapping)
    ma_batch, metrics = runner.sample(runner.init_params())
    assert isinstance(ma_batch, MultiAgentBatch)
    assert sorted(ma_batch.keys()) == ["a0", "a1"]
    for pid in ("a0", "a1"):
        b = ma_batch[pid]
        assert b["obs"].shape == (32, 1, 2)
        assert b["rewards"].shape == (32, 1)
        assert b["bootstrap_value"].shape == (1,)
    assert ma_batch.env_steps() == 32
    assert ma_batch.agent_steps() == 64
    assert metrics["episodes_this_iter"] == 2   # 32 steps of 16-step episodes
    _check_greedy_equal(mapping)


def test_shared_policy_batches_agents_together():
    mapping = lambda aid: "shared"
    runner, _ = _runners(mapping)
    ma_batch, _ = runner.sample(runner.init_params())
    assert sorted(ma_batch.keys()) == ["shared"]
    assert ma_batch["shared"]["obs"].shape == (32, 2, 2)    # both agents are rows
    _check_greedy_equal(mapping)


def test_unknown_policy_mapping_raises():
    specs = module_specs_for(MatchGame(), lambda a: "p", hiddens=(16,))
    with pytest.raises(KeyError, match="not in"):
        MultiAgentEnvRunner(lambda: MatchGame(), policy_mapping_fn=lambda a: "other",
                            modules={"p": RLModule(specs["p"])})


@pytest.mark.parametrize("mapping,policies", [
    (lambda aid: "shared", ["shared"]),
    (lambda aid: aid, ["a0", "a1"]),
], ids=["shared", "independent"])
def test_ppo_multi_agent_greedy_train_matches_jax(mapping, policies):
    lr = 3e-4

    def chain(cfg):
        return (cfg.environment(lambda: MatchGame())
                .multi_agent(policies=policies, policy_mapping_fn=mapping)
                .env_runners(rollout_fragment_length=32, explore=False)
                .training(train_batch_size=64, minibatch_size=32, num_epochs=2, lr=lr,
                          entropy_coeff=0.01, model={"hiddens": (32, 32)})
                .evaluation(evaluation_duration=2).debugging(seed=3))
    jalgo = chain(JPPOConfig()).build()
    talgo = chain(PPOConfig().resources(device="cpu")).build()
    start = {pid: flax_rl_module_to_state_dict(w) for pid, w in jalgo.get_weights().items()}
    talgo.set_weights(start)
    want, got = jalgo.train(), talgo.train()
    for k in ("num_env_steps_sampled_this_iter", "episodes_this_iter", "training_iteration"):
        assert got[k] == want[k], k
    for k in ("episode_return_mean", "episode_len_mean"):
        assert got.get(k) == pytest.approx(want.get(k)), k
    assert sorted(got["learner"]) == sorted(want["learner"]) == sorted(policies)
    steps = 2 * (64 * 2 // 32)          # epochs x minibatches of the largest policy batch
    jweights, tweights = jalgo.get_weights(), talgo.get_weights()
    for pid in policies:
        g, w = got["learner"][pid], want["learner"][pid]
        assert set(g) == set(w), pid
        for k, v in w.items():
            assert abs(g[k] - v) <= METRIC_TOL * max(1.0, abs(v)), (pid, k, g[k], v)
        check_params(tweights[pid], flax_rl_module_to_state_dict(jweights[pid]), start[pid],
                     lr, steps)
    jev, tev = jalgo.evaluate(), talgo.evaluate()
    assert tev["episodes_this_iter"] >= 1 and set(tev) == set(jev)
    for k, v in jev.items():
        assert tev[k] == pytest.approx(v, rel=1e-6), k
    jalgo.stop()
    talgo.stop()


def _learning_config(cfg, mapping, policies, seed=0):
    """JAX's learning case (tests/test_rllib_multi_agent.py) on either package."""
    return (cfg.environment(lambda: MatchGame())
            .multi_agent(policies=policies, policy_mapping_fn=mapping)
            .training(train_batch_size=256, minibatch_size=64, num_epochs=4, lr=1e-2,
                      entropy_coeff=0.01)
            .env_runners(rollout_fragment_length=64).debugging(seed=seed))


def _best_return(algo, iters=10):
    best, last = -np.inf, None
    for _ in range(iters):
        last = algo.train()
        best = max(best, last.get("episode_return_mean", -np.inf))
    return best, last


def _train_ppo(mapping, policies, iters=10):
    """JAX's case on the port, from JAX's initial weights (its seed 0)."""
    jalgo = _learning_config(JPPOConfig(), mapping, policies).build()
    algo = _learning_config(PPOConfig().resources(device="cpu"), mapping, policies).build()
    algo.set_weights({pid: flax_rl_module_to_state_dict(w)
                      for pid, w in jalgo.get_weights().items()})
    jalgo.stop()
    best, last = _best_return(algo, iters)
    return algo, best, last


def test_ppo_multi_agent_shared_mode_learns():
    algo, best, last = _train_ppo(lambda aid: "shared", ["shared"])
    assert sorted(last["learner"].keys()) == ["shared"]
    assert np.isfinite(last["learner"]["shared"]["total_loss"])
    assert best > 40, f"shared-mode PPO failed to learn: best={best}"
    algo.config.evaluation_duration = 2
    ev = algo.evaluate()                 # greedy, on a fresh runner
    assert ev["episodes_this_iter"] >= 1 and ev["episode_return_mean"] > 40
    algo.stop()


def test_ppo_multi_agent_independent_mode_learns():
    algo, best, last = _train_ppo(lambda aid: aid, ["a0", "a1"])
    assert sorted(last["learner"].keys()) == ["a0", "a1"]
    for pid in ("a0", "a1"):
        assert np.isfinite(last["learner"][pid]["total_loss"])
    assert best > 40, f"independent-mode PPO failed to learn: best={best}"
    w = algo.get_weights()
    algo.set_weights(w)
    assert sorted(w) == ["a0", "a1"]
    algo.stop()


SURVEY_SEEDS = 32


@pytest.mark.slow
@pytest.mark.parametrize("mapping,policies", [
    (lambda aid: "shared", ["shared"]),
    (lambda aid: aid, ["a0", "a1"]),
], ids=["shared", "independent"])
def test_ppo_multi_agent_learning_survey(mapping, policies):
    """JAX's learning case over seeds 0..SURVEY_SEEDS-1, each package from
    its own initial weights and draws: prints each seed's best return, and
    fails if the port passes the bar (40) significantly less often than
    JAX (one-sided Fisher exact test, p < 0.05). Run with `-m slow -s`."""
    from scipy.stats import fisher_exact
    passes = {}
    for name, cls in (("jax", JPPOConfig), ("torch", PPOConfig)):
        rows = []
        for seed in range(SURVEY_SEEDS):
            cfg = _learning_config(cls(), mapping, policies, seed)
            algo = (cfg.resources(device="cpu") if name == "torch" else cfg).build()
            rows.append(_best_return(algo)[0])
            algo.stop()
        passes[name] = sum(b > 40 for b in rows)
        print(f"\nsurvey {policies} {name}: passes {passes[name]}/{SURVEY_SEEDS}; "
              "best by seed " + " ".join(f"{b:.2f}" for b in rows))
    table = [[passes["torch"], SURVEY_SEEDS - passes["torch"]],
             [passes["jax"], SURVEY_SEEDS - passes["jax"]]]
    p = fisher_exact(table, alternative="less").pvalue
    print(f"survey {policies}: one-sided Fisher p = {p:.4f}")
    assert p >= 0.05, (passes, p)


def test_env_runner_run_eval_and_node_info():
    runner = EnvRunner("CartPole-v1", num_envs=2, rollout_len=16, explore=False)
    m = runner.run_eval(runner.init_params(), num_episodes=3)
    assert m["episodes_this_iter"] >= 3 and np.isfinite(m["episode_return_mean"])
    assert runner.num_completed_episodes() == 0           # popped
    info = runner.node_info()
    assert info["pid"] == os.getpid() and info["ppid"] == os.getppid() and info["hostname"]
    runner.close()
