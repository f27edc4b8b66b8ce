"""The port's PPO, IMPALA and APPO Algorithms against ray_tpu's on the CPU
(gymnasium's CartPole-v1), from the same starting weights: one greedy
(explore=False) `train()` iteration each, whose env-step counts, episode
metrics and learner metrics must match JAX's, and whose weights after the
update must too; inline evaluation; the checkpoint round trip of
tests/test_rllib.py; multi-agent PPO's build and first iteration; every
ported config's defaults against JAX's; the `NotImplementedError`s of
what the port leaves to the runtime; and a two-learner group on a world of
one rank raising JAX's ValueError.

Tolerances (f32): learner metrics within 1e-4 of max(1, |value|); weights
as in tests/test_torch_rl_learner.py (the Adam bound, 2 lr a step, on
each coordinate, and at most 1e-3 of the coordinates lr / 100 apart)."""

import pytest
import torch

from ray_tpu.rllib import APPOConfig as JAPPOConfig, IMPALAConfig as JIMPALAConfig, \
    PPOConfig as JPPOConfig
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig, PPOConfig
from test_torch_rl_learner import check_params
from test_torch_rl_learner_group import fresh_world  # noqa: F401 - a fixture

TOL = 1e-4


def _configs(jcls, tcls, rollout=32, envs=2, **training):
    def chain(cfg):
        return (cfg.environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=envs, rollout_fragment_length=rollout,
                             explore=False)
                .training(**training).debugging(seed=3).resources(device="cpu"))
    return chain(jcls()), chain(tcls())


def _check(got, want, before, jalgo, talgo, lr, steps):
    for k in ("num_env_steps_sampled_this_iter", "episodes_this_iter", "training_iteration"):
        assert got[k] == want[k], k
    for k in ("episode_return_mean", "episode_len_mean"):
        assert got.get(k) == pytest.approx(want.get(k)), k
    assert set(got["learner"]) == set(want["learner"])
    for k, w in want["learner"].items():
        assert abs(got["learner"][k] - w) <= TOL * max(1.0, abs(w)), (k, got["learner"][k], w)
    check_params(talgo.get_weights(), flax_rl_module_to_state_dict(jalgo.get_weights()),
                 before, lr, steps)


def _run_pair(jcfg, tcfg):
    jalgo, talgo = jcfg.build(), tcfg.build()
    start = flax_rl_module_to_state_dict(jalgo.get_weights())
    talgo.set_weights(start)
    return jalgo, talgo, start, jalgo.train(), talgo.train()


def test_ppo_train_iteration_matches_jax():
    jcfg, tcfg = _configs(JPPOConfig, PPOConfig, train_batch_size=64, minibatch_size=32,
                          num_epochs=2)
    jalgo, talgo, start, want, got = _run_pair(jcfg, tcfg)
    _check(got, want, start, jalgo, talgo, 3e-4, 2 * 2)
    jalgo.stop()
    talgo.stop()


def test_impala_train_iteration_matches_jax():
    jcfg, tcfg = _configs(JIMPALAConfig, IMPALAConfig, rollout=16, train_batch_size=64)
    jalgo, talgo, start, want, got = _run_pair(jcfg, tcfg)
    _check(got, want, start, jalgo, talgo, 5e-4, 2)      # two rollouts, one update each
    jalgo.stop()
    talgo.stop()


def test_appo_train_iteration_matches_jax():
    jcfg, tcfg = _configs(JAPPOConfig, APPOConfig, train_batch_size=64, minibatch_size=32)
    jalgo, talgo, start, want, got = _run_pair(jcfg, tcfg)
    _check(got, want, start, jalgo, talgo, 3e-4, 2 * 2)
    jalgo.stop()
    talgo.stop()


def test_inline_evaluation_matches_jax():
    jcfg, tcfg = _configs(JPPOConfig, PPOConfig, rollout=16, train_batch_size=32,
                          minibatch_size=16, num_epochs=1)
    for cfg in (jcfg, tcfg):
        cfg.evaluation(evaluation_interval=1, evaluation_duration=2)
    jalgo, talgo, _, want, got = _run_pair(jcfg, tcfg)
    assert got["evaluation"]["episodes_this_iter"] >= 2
    for k, w in want["evaluation"].items():
        assert got["evaluation"][k] == pytest.approx(w, rel=1e-6), k
    jalgo.stop()
    talgo.stop()


def test_algorithm_checkpoint_roundtrip(tmp_path):
    config = (PPOConfig().environment("CartPole-v1")
              .env_runners(rollout_fragment_length=16)
              .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
              .resources(device="cpu"))
    algo = config.build()
    algo.train()
    ckpt = algo.save(str(tmp_path / "ck"))
    algo2 = config.copy().build()
    algo2.restore(ckpt)
    w0, w1 = algo.get_weights(), algo2.get_weights()
    assert set(w0) == set(w1) and all(torch.equal(w0[k], w1[k]) for k in w0)
    assert algo2.iteration == algo.iteration == 1
    algo.stop()
    algo2.stop()


def _cpu_ppo():
    return (PPOConfig().environment("CartPole-v1").resources(device="cpu")
            .env_runners(rollout_fragment_length=8).training(train_batch_size=8))


@pytest.mark.parametrize("change,error,match", [
    (lambda c: c.env_runners(num_env_runners=2), NotImplementedError, "num_env_runners"),
    (lambda c: c.evaluation(evaluation_interval=1, evaluation_num_env_runners=1),
     NotImplementedError, "evaluation_num_env_runners"),
    (lambda c: c.sebulba(), NotImplementedError, "sebulba"),
    # a group of two learners needs a world of two ranks (JAX's error, with
    # the port's world named)
    (lambda c: c.learners(num_learners=2), ValueError, "num_learners=2 but only 1 ranks"),
], ids=["remote_runners", "eval_actors", "sebulba", "dp_learners"])
def test_later_and_runtime_paths_raise(fresh_world, change, error, match):
    with pytest.raises(error, match=match):
        change(_cpu_ppo()).build()


def test_multi_agent_ppo_builds_and_trains():
    from test_rllib_multi_agent import MatchGame
    algo = (PPOConfig().environment(lambda: MatchGame()).resources(device="cpu")
            .multi_agent(policies={"a0", "a1"}, policy_mapping_fn=lambda aid: aid)
            .env_runners(rollout_fragment_length=16)
            .training(train_batch_size=32, minibatch_size=16, num_epochs=1).build())
    result = algo.train()
    assert sorted(result["learner"]) == ["a0", "a1"]
    assert result["num_env_steps_sampled_this_iter"] == 32
    with pytest.raises(ValueError, match="unknown policies"):
        (PPOConfig().environment(lambda: MatchGame()).resources(device="cpu")
         .multi_agent(policies={"a0"}, policy_mapping_fn=lambda aid: aid).build())
    algo.stop()


_CONFIGS = ("PPOConfig", "IMPALAConfig", "APPOConfig", "DQNConfig", "SACConfig", "TQCConfig",
            "BCConfig", "MARWILConfig", "CQLConfig", "IQLConfig", "DreamerV3Config")


def test_config_defaults_and_device():
    import ray_tpu.rllib as jrllib
    import ray_tpu_torch.rllib as trllib
    for name in _CONFIGS:
        tcls = getattr(trllib, name)
        assert tcls().device == "cuda"
        assert tcls().resources(device="cpu").device == "cpu"
        j, t = vars(getattr(jrllib, name)()), vars(tcls())
        for k, v in t.items():
            if k not in ("device", "framework_str", "algo_class"):
                assert j[k] == v, (name, k)
        assert tcls().algo_class.__name__ == getattr(jrllib, name)().algo_class.__name__
