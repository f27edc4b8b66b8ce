"""The port's sebulba pieces against ray_tpu's on the CPU: `RolloutActor`
in process (its trajectories, info and `pipeline.act` windows against
JAX's actor on the same weights; the device env on `device="cpu"`), the
actor-method protocol it follows, the config's `sebulba()` and the hooks that
`ray_tpu.rllib.sebulba.SebulbaPipeline` reads, the learner's recompile
guard, and the composition: ray_tpu's `SebulbaPipeline` over the port's
IMPALA under `ray_session`, with ray_tpu's `RolloutActor` replaced by the
port's, at tests/test_rllib_sebulba.py's lockstep settings (CartPole-v1,
2 envs x 8 steps, train_batch_size 16, seed 3).

The port's own `SebulbaPipeline` (`.sebulba(enabled=True)`) runs on the
port's runtime (a module session of `ray_tpu_torch.init`): the
`ReplayActor` against JAX's, lockstep `train()` against the sync IMPALA
and against JAX's own lockstep, JAX's async gap-and-guard case, and the
ValueError of PPO.

Lockstep mode is the synchronous schedule, so its params after two
iterations are `torch.equal` to the port's sync IMPALA's. Against JAX's
lockstep (greedy, from JAX's initial weights) they are held as in
tests/test_torch_rl_learner.py: the Adam bound on each coordinate and at
most 1e-3 of the coordinates lr / 100 apart."""

import signal
import time

import numpy as np
import pytest
import torch

from ray_tpu.rllib import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib import PPOConfig as JPPOConfig
from ray_tpu.rllib import sebulba as jsebulba
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig
from ray_tpu_torch.rllib import sebulba as tsebulba
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.appo import APPO
from ray_tpu_torch.rllib.algorithms.impala import IMPALA
from ray_tpu_torch.util import tracing as ttracing
from test_rllib_sebulba import _leaked_big
from test_torch_rl_learner import check_params
from test_torch_rl_sac import one_torch_thread  # noqa: F401  (autouse)

SEED, ENVS, STEPS, LR = 3, 2, 8, 5e-4     # IMPALA's default lr


@pytest.fixture(autouse=True)
def _reset_port_tracing():
    ttracing.clear()
    yield
    ttracing.clear()
    ttracing.refresh()


@pytest.fixture
def time_limit():
    """Fail (not hang) a runtime test after 300 s."""
    def expire(signum, frame):
        raise TimeoutError("sebulba composition exceeded its 300 s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(300)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _chain(cfg, explore=True):
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=ENVS,
                         rollout_fragment_length=STEPS, explore=explore)
            .training(train_batch_size=ENVS * STEPS)      # one update an iteration
            .debugging(seed=SEED).resources(device="cpu"))


def _runner_kwargs(explore=False):
    return dict(env_creator="CartPole-v1", num_envs=ENVS, rollout_len=STEPS, seed=SEED,
                explore=explore)


# ------------------------------------------------------------ rollout actor
def test_rollout_actor_matches_jax_in_process():
    """Same weights, versions 0..2: equal trajectories and info, and the
    same `pipeline.act` windows (args) in each package's ring."""
    from ray_tpu.util import tracing as jtracing
    jact = jsebulba.RolloutActor(_runner_kwargs())
    tact = tsebulba.RolloutActor({**_runner_kwargs(), "device": "cpu"}, index=0)
    jw = jact.init_params()
    tw = flax_rl_module_to_state_dict(jw)
    assert tact.get_spec().obs_shape == tuple(jact.get_spec().obs_shape)
    assert tact.ping() == jact.ping() == 0
    info_t = tact.node_info()
    assert info_t["actor"] == 0 and set(info_t) == set(jact.node_info())
    for v in range(3):
        jact.set_weights(jw, v)
        tact.set_weights(tw, v)
        jt, ji = jact.sample_traj()
        tt, ti = tact.sample_traj()
        ji.pop("dur_s")
        assert ti.pop("dur_s") >= 0
        assert ti == ji == {"version": v, "steps": ENVS * STEPS, "actor": 0}
        assert set(tt) == set(jt) and tt["version"] == jt["version"] == v
        for k in ("obs", "actions", "rewards", "dones", "terminateds"):
            np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)
        for k in ("action_logp", "vf_preds", "bootstrap_value"):
            np.testing.assert_allclose(tt[k], np.asarray(jt[k]), atol=1e-5, err_msg=k)
    want = [(e["name"], e["cat"], e["args"]) for e in jtracing.events()
            if e["name"] == "pipeline.act"]
    got = [(e["name"], e["cat"], e["args"]) for e in ttracing.events()
           if e["name"] == "pipeline.act"]
    assert got == want == [("pipeline.act", "rllib", {"actor": 0, "version": v})
                           for v in range(3)]
    assert tact.pop_metrics() == jact.pop_metrics()
    jact.close()
    tact.close()


def test_rollout_actor_device_env():
    """jax_env="cartpole" is DeviceRollout(TorchCartPole) on the runner
    kwargs' device; its trajectory is the DeviceRollout's own. With no
    device named it is "cuda", which raises here: no fallback."""
    kw = dict(num_envs=3, rollout_len=5, seed=7)
    act = tsebulba.RolloutActor({**kw, "device": "cpu"}, index=2, jax_env="cartpole")
    roll = tsebulba.DeviceRollout("cartpole", device="cpu", **kw)
    w = roll.init_params()
    act.set_weights(w, 4)
    roll.set_weights(w, 4)
    traj, info = act.sample_traj()
    want = roll.sample()
    assert info["version"] == 4 and info["steps"] == 15 and info["actor"] == 2
    assert traj["version"] == 4 and traj["actor"] == 2
    for k, v in want.items():
        np.testing.assert_array_equal(traj[k], v, err_msg=k)
    (e,) = [e for e in ttracing.events() if e["name"] == "pipeline.act"]
    assert e["args"] == {"actor": 2, "version": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsebulba.RolloutActor(kw, jax_env="cartpole")


def test_sample_traj_num_returns_protocol():
    """The port sets the attribute ray_tpu's `method(num_returns=2)` sets."""
    from ray_tpu.actor import method

    @method(num_returns=2)
    def f(self):
        pass

    assert tsebulba.RolloutActor.sample_traj.__rtpu_method_options__ == \
        f.__rtpu_method_options__ == jsebulba.RolloutActor.sample_traj.__rtpu_method_options__


# ---------------------------------------------------------------- config api
def test_config_sebulba_matches_jax():
    kw = dict(num_rollout_actors=3, inflight_rollouts=4, replay_capacity=32,
              replay_mode="fifo", sample_batch_count=2, min_replay=3, broadcast_interval=2,
              max_staleness=8, lockstep=True, replay_seed=77, jax_env="cartpole")
    fields = lambda c: {k: v for k, v in vars(c).items() if k.startswith("sebulba_")}
    assert fields(IMPALAConfig()) == fields(JIMPALAConfig())
    assert fields(IMPALAConfig().sebulba(**kw)) == fields(JIMPALAConfig().sebulba(**kw))
    cfg = IMPALAConfig().sebulba(enabled=False, **kw)
    assert not cfg.sebulba_enabled and cfg.sebulba_jax_env == "cartpole"
    # the repair: an unknown keyword raises (it used to be swallowed)
    with pytest.raises(TypeError, match="num_rollout_actor"):
        IMPALAConfig().sebulba(num_rollout_actor=3)


def test_sebulba_hooks_match_jax():
    from ray_tpu.rllib.algorithm import Algorithm as JAlgorithm
    from ray_tpu.rllib.algorithms.appo import APPO as JAPPO
    from ray_tpu.rllib.algorithms.impala import IMPALA as JIMPALA
    from ray_tpu.rllib.algorithms.ppo import PPO as JPPO
    from ray_tpu_torch.rllib.algorithms.ppo import PPO
    for t, j in ((Algorithm, JAlgorithm), (PPO, JPPO), (IMPALA, JIMPALA), (APPO, JAPPO)):
        assert t._supports_sebulba is j._supports_sebulba, t.__name__
    algo = _chain(IMPALAConfig()).build()
    assert algo._make_runner_kwargs()["device"] == "cpu"
    algo.stop()


def test_jit_cache_size_counts_signatures():
    algo = _chain(IMPALAConfig()).build()
    learner = algo.learner
    assert learner.jit_cache_size() == 0
    batch = algo._local_runner.sample(algo.get_weights())
    for _ in range(2):
        algo._sebulba_update(batch)
    assert learner.jit_cache_size() == 1
    algo._sebulba_update({k: v[:4] for k, v in batch.items() if k != "bootstrap_value"}
                         | {"bootstrap_value": batch["bootstrap_value"]})
    assert learner.jit_cache_size() == 2
    algo.stop()


def test_ppo_rejects_the_pipeline():
    algo = _chain(PPOConfig()).training(minibatch_size=8).build()
    with pytest.raises(ValueError, match="sebulba"):
        jsebulba.SebulbaPipeline(algo, algo.config)
    algo.stop()


# ------------------------------------------------------------- composition
def _lockstep(ray_session, monkeypatch, cfg, weights=None, iters=2):
    """ray_tpu's SebulbaPipeline in lockstep mode over the port's IMPALA
    (optionally started from `weights`) with the port's RolloutActor;
    returns (the last result's sebulba stats, the weights), shut down."""
    algo = cfg.sebulba(enabled=False, lockstep=True).build()
    if weights is not None:
        algo.set_weights(weights)     # before the pipeline broadcasts version 0
    with monkeypatch.context() as m:
        m.setattr(jsebulba, "RolloutActor", tsebulba.RolloutActor)
        pipe = jsebulba.SebulbaPipeline(algo, algo.config)
    try:
        for _ in range(iters):
            result = pipe.training_step()
    finally:
        pipe.shutdown()
    w = algo.get_weights()
    algo.stop()
    return result, w


def _assert_lockstep_stats(s):
    assert s["lockstep"] and s["updates"] == 2 and s["num_rollout_actors"] == 1
    assert s["gap_counts"] == {0: 2}          # exact off-policy gap 0
    assert s["jit_cache_size"] == 1           # recompile guard


def test_lockstep_equals_sync_impala(ray_session, monkeypatch, time_limit):
    sync = _chain(IMPALAConfig()).build()
    for _ in range(2):
        sync.train()
    want = sync.get_weights()
    sync.stop()
    result, got = _lockstep(ray_session, monkeypatch, _chain(IMPALAConfig()))
    _assert_lockstep_stats(result["sebulba"])
    assert result["num_env_steps_sampled_this_iter"] == ENVS * STEPS
    assert set(result["learner"]) >= {"total_loss", "policy_loss", "vf_loss"}
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    time.sleep(0.5)
    assert not _leaked_big()                  # replay.clear() ran


def test_greedy_lockstep_matches_jax_lockstep(ray_session, monkeypatch, time_limit):
    jalgo = _chain(JIMPALAConfig(), explore=False).sebulba(lockstep=True).build()
    start = flax_rl_module_to_state_dict(jalgo.get_weights())
    for _ in range(2):
        want = jalgo.train()
    jw = flax_rl_module_to_state_dict(jalgo.get_weights())
    jalgo.stop()
    result, got = _lockstep(ray_session, monkeypatch,
                            _chain(IMPALAConfig(), explore=False), weights=start)
    _assert_lockstep_stats(result["sebulba"])
    _assert_lockstep_stats(want["sebulba"])
    for k in ("episodes_this_iter", "num_env_steps_sampled_this_iter"):
        assert result[k] == want[k], k
    check_params(got, jw, start, LR, 2)
    time.sleep(0.5)
    assert not _leaked_big()


# -------------------------------------------- the port's own pipeline
@pytest.fixture(scope="module")
def port_session():
    import ray_tpu_torch as rt
    rt.init(num_cpus=4, num_gpus=0)
    yield rt
    rt.shutdown()


def _port_leaked_big(min_bytes=1 << 16):
    """test_rllib_sebulba's leak scan, over the port's object table."""
    from ray_tpu_torch._private import state
    from ray_tpu_torch._private.health import LeakDetector
    ctl = state.global_client().controller
    det = LeakDetector(age_s=0.0, clock=lambda: time.time() + 3600.0)
    return [f for f in det.scan(ctl.objects) if (f.get("size") or 0) >= min_bytes]


def _replay_program(cls):
    """tests/test_rllib_sebulba.py's three ReplayActor cases on `cls`,
    returning everything they read."""
    out = []
    buf = cls(capacity=3, seed=0, mode="fifo")
    out += [buf.add_refs(["r0", "r1"], [0, 0]), buf.size(), buf.sample_refs(1),
            buf.sample_refs(5), buf.sample_refs(1)]
    buf.add_refs(["r2", "r3", "r4"], 1)      # a scalar version for every ref
    out += [buf.stats(), buf.sample_refs(2), buf.clear(), buf.size(), buf.sample_refs(1)]
    buf = cls(capacity=8, seed=123, mode="uniform")
    buf.add_refs([f"r{i}" for i in range(8)], list(range(8)))
    out += [buf._sample_indices(4), buf._sample_indices(4), buf.sample_refs(3), buf.stats()]
    buf2 = cls(capacity=8, seed=123, mode="uniform")
    buf2.add_refs([f"r{i}" for i in range(8)], 0)
    out.append(buf2._sample_indices(8))
    with pytest.raises(ValueError, match="unknown replay mode") as err:
        cls(capacity=4, mode="priority")
    out.append(str(err.value))
    return out


def test_replay_actor_matches_jax():
    """The port's ReplayActor against JAX's, in process: the fifo ring,
    its eviction and clear, the seeded uniform draws (pinned by JAX's
    test) and the unknown-mode error read the same."""
    from ray_tpu.rllib import ReplayActor as JReplayActor
    from ray_tpu_torch.rllib import ReplayActor
    got, want = _replay_program(ReplayActor), _replay_program(JReplayActor)
    assert got == want
    assert got[2:5] == [[("r0", 0)], [("r1", 0)], []] and got[10] == [0, 5, 4, 0]


def test_port_lockstep_train_equals_sync_impala(port_session, time_limit):
    """`.sebulba(enabled=True, lockstep=True).build().train()` on the port's
    runtime (one RolloutActor and one ReplayActor; the learner here):
    after two iterations the params are torch.equal to the sync IMPALA's,
    the gap is 0 and the update's signature cache holds one entry; the
    replay's refs are released at stop()."""
    sync = _chain(IMPALAConfig()).build()
    for _ in range(2):
        sync.train()
    want = sync.get_weights()
    sync.stop()
    algo = _chain(IMPALAConfig()).sebulba(lockstep=True).build()
    try:
        for _ in range(2):
            result = algo.train()
        got = algo.get_weights()
    finally:
        algo.stop()
    _assert_lockstep_stats(result["sebulba"])
    assert result["num_env_steps_sampled_this_iter"] == ENVS * STEPS
    assert result["training_iteration"] == 2
    assert all(torch.equal(got[k], want[k]) for k in want) and got.keys() == want.keys()
    time.sleep(0.5)
    assert not _port_leaked_big()


def test_port_greedy_lockstep_matches_jax_lockstep(ray_session, port_session, time_limit):
    """Greedy lockstep train() of both packages' own pipelines, the port's
    from JAX's initial weights (re-broadcast as version 0): the episode
    and step counts equal JAX's, the params within the Adam bound."""
    jalgo = _chain(JIMPALAConfig(), explore=False).sebulba(lockstep=True).build()
    start = flax_rl_module_to_state_dict(jalgo.get_weights())
    for _ in range(2):
        want = jalgo.train()
    jw = flax_rl_module_to_state_dict(jalgo.get_weights())
    jalgo.stop()
    algo = _chain(IMPALAConfig(), explore=False).sebulba(lockstep=True).build()
    try:
        algo.set_weights(start)
        algo._sebulba._broadcast(block=True)      # the actor acts from JAX's weights
        for _ in range(2):
            result = algo.train()
        got = algo.get_weights()
    finally:
        algo.stop()
    _assert_lockstep_stats(result["sebulba"])
    _assert_lockstep_stats(want["sebulba"])
    for k in ("episodes_this_iter", "num_env_steps_sampled_this_iter"):
        assert result[k] == want[k], k
    check_params(got, jw, start, LR, 2)


def test_port_async_offpolicy_gap_and_guard(port_session, time_limit):
    """test_rllib_sebulba's async case on the port: two rollout actors of
    DeviceRollout(TorchCartPole) on the CPU with two rollouts in flight
    each; the learner sees a gap >= 1, its signature cache holds one
    entry, broadcasts go out, and stop() leaves no trajectory pinned."""
    algo = _chain(IMPALAConfig()).debugging(seed=7).sebulba(
        num_rollout_actors=2, inflight_rollouts=2, replay_capacity=8,
        jax_env="cartpole").build()
    try:
        for _ in range(4):
            stats = algo.train()["sebulba"]
            if any(g >= 1 for g in stats["gap_counts"]):
                break
        replay = port_session.get(algo._sebulba.replay.stats.remote())
    finally:
        algo.stop()
    assert stats["updates"] >= 1 and stats["num_rollout_actors"] == 2
    assert any(g >= 1 for g in stats["gap_counts"]), stats["gap_counts"]
    assert stats["jit_cache_size"] == 1, "the update saw a second signature"
    assert stats["counters"]["broadcasts"] >= 1 and stats["broadcasts_async"] >= 1
    assert replay["admitted"] > 0 and replay["mode"] == "uniform"
    time.sleep(0.5)
    assert not _port_leaked_big()


def test_ppo_sebulba_build_raises_as_jax():
    """PPO has no V-trace: building it with the pipeline raises JAX's
    ValueError in both packages, before any runtime starts."""
    for cfg in (JPPOConfig(), PPOConfig()):
        chained = (cfg.environment("CartPole-v1").resources(device="cpu")
                   .env_runners(num_envs_per_env_runner=1, rollout_fragment_length=4)
                   .training(train_batch_size=8, minibatch_size=4).sebulba())
        with pytest.raises(ValueError, match="PPO does not support the sebulba pipeline"):
            chained.build()
