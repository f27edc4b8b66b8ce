"""The port's offline RL against ray_tpu's on the CPU: `as_sample_batch`
(a SampleBatch, a dict, and a `ray_tpu.data` dataset the test builds);
`offline_training_step`'s minibatches and cur_lr; BC to JAX's accuracy
bar on JAX's expert data; MARWIL's update; CQL's updates (a `bc_iters`
step, then a SAC-objective step) with JAX's five draws injected; IQL's
updates; CQL's penalty against its ablation; the IQL weight round trip.

Offline nets are (32, 32) (the configs' `model`), except where the
default is what is tested. Updates are held from JAX's weights, the port
re-synced before each (Adam's moments stay in both). Tolerances (f32):
metrics within 1e-5 relative (of max(1, |value|)) for BC/MARWIL and 1e-4
for CQL and IQL (a logsumexp over 12 sampled actions and the AWR exp sit
between them and the params); params as tests/test_torch_rl_learner.py
holds them, targets as tests/test_torch_rl_sac.py does."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import (BCConfig as JBCConfig, CQLConfig as JCQLConfig,
                           IQLConfig as JIQLConfig, MARWILConfig as JMARWILConfig)
from ray_tpu.rllib.algorithms import offline_utils as joffline
from ray_tpu.rllib.algorithms.bc import BCLearner as JBCLearner
from ray_tpu.rllib.offline import as_sample_batch as jas_sample_batch, sample_batch_to_dataset
from ray_tpu.rllib.rl_module import ModuleSpec as JSpec, RLModule as JModule
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict, flax_sac_to_state_dict
from ray_tpu_torch.rllib import (BCConfig, CQLConfig, IQLConfig, MARWILConfig, RLModule,
                                 SampleBatch, sample_batch as SB)
from ray_tpu_torch.rllib.algorithms import offline_utils
from ray_tpu_torch.rllib.algorithms.bc import BCLearner
from ray_tpu_torch.rllib.offline import as_sample_batch
from ray_tpu_torch.rllib.rl_module import ModuleSpec
from test_torch_rl_learner import check_params
from test_torch_rl_sac import (_sac_target_of, check_update, one_torch_thread,  # noqa: F401
                               pendulum_batch)

SMALL = {"hiddens": (32, 32)}


def offline_data(n=600, seed=0):
    """Pendulum-shaped transitions (obs 3, action 1 in [-2, 2])."""
    return pendulum_batch(seed, n)


def expert_data():
    """JAX's BC case (tests/test_rllib_algos.py): action = obs[0] > 0."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2000, 4)).astype(np.float32)
    return {"obs": obs, "actions": (obs[:, 0] > 0).astype(np.int64)}


def _close(got, want, tol, keys=None):
    for k in keys or want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= tol * max(1.0, abs(w)), (k, g, w)


def test_as_sample_batch_matches_jax():
    data = offline_data(64)
    ds = sample_batch_to_dataset(JSampleBatch(data))
    want = jas_sample_batch(ds)
    got = as_sample_batch(ds)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got[SB.ACTIONS], data[SB.ACTIONS])    # [N, 1] restored
    batch = SampleBatch(data)
    assert as_sample_batch(batch) is batch
    from_dict = as_sample_batch({k: list(v) for k, v in data.items()})
    assert all(np.array_equal(from_dict[k], data[k]) for k in data)
    with pytest.raises(TypeError, match="unsupported offline data"):
        as_sample_batch([1, 2, 3])


class _Algo:
    """The attributes offline_training_step reads."""

    def __init__(self, cfg, data, schedule):
        self.config, self._data, self._n = cfg, data, len(data[SB.OBS])
        self._rng = np.random.default_rng(cfg.seed)
        self._lr_schedule, self._updates = schedule, 0


def test_offline_training_step_draws_jax_minibatches():
    from ray_tpu_torch.ops.optim import make_lr_schedule
    from ray_tpu.ops.optim import make_optimizer as jmake_optimizer
    sched = [[0, 1e-3], [5, 1e-4]]
    data = offline_data(300)
    cfg = CQLConfig().training(train_intensity=3, train_batch_size=16, lr=1e-3).debugging(seed=4)
    seen = {"jax": [], "port": []}
    jalgo = _Algo(cfg, data, jmake_optimizer(lr=1e-3, lr_schedule=sched)[1])
    talgo = _Algo(cfg, data, make_lr_schedule(1e-3, sched))
    jax_step = lambda mb, i: (seen["jax"].append((i, mb)) or (None, None, {"x": np.float32(i)}))
    port_step = lambda mb, i: (seen["port"].append((i, mb)) or {"x": torch.tensor(float(i))})
    for _ in range(2):
        jalgo.weights = jalgo.opt_state = None
        want = joffline.offline_training_step(jalgo, jax_step)
        got = offline_utils.offline_training_step(talgo, port_step)
        assert got["learner"] == pytest.approx(want["learner"], rel=1e-6)   # JAX's lr is f32
        assert got["num_env_steps_sampled_this_iter"] == want["num_env_steps_sampled_this_iter"]
    assert [i for i, _ in seen["port"]] == list(range(6))
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        assert all(np.array_equal(a[k], b[k]) for k in b)


def test_bc_reaches_jax_accuracy_bar():
    config = BCConfig().training(lr=1e-2, train_batch_size=256).resources(device="cpu")
    config.offline_data_source(expert_data())
    algo = config.build()
    acc = 0.0
    for _ in range(60):
        acc = algo.train()["learner"].get("action_accuracy", 0.0)
        if acc > 0.95:
            break
    assert acc > 0.95, f"BC accuracy only {acc}"
    assert algo.evaluate() == {}
    algo.stop()


@pytest.mark.parametrize("config_pair", [(JBCConfig, BCConfig), (JMARWILConfig, MARWILConfig)],
                         ids=["bc", "marwil"])
def test_bc_and_marwil_updates_match_jax(config_pair):
    jcls, tcls = config_pair
    lr = 1e-3
    rng = np.random.default_rng(5)
    batch = {**{k: v[:128] for k, v in expert_data().items()},
             SB.ADVANTAGES: rng.standard_normal(128).astype(np.float32) * 3,
             SB.VALUE_TARGETS: rng.standard_normal(128).astype(np.float32)}
    jl = JBCLearner(JModule(JSpec((4,), "discrete", 2, (32, 32))), jcls().training(lr=lr))
    tl = BCLearner(RLModule(ModuleSpec((4,), "discrete", 2, (32, 32))),
                   tcls().training(lr=lr).resources(device="cpu"))
    tl.set_weights(flax_rl_module_to_state_dict(jl.get_weights()))
    before = tl.get_weights()
    want = {k: float(v) for k, v in jl.update_once(batch).items()}
    got = {k: float(v) for k, v in tl.update_once(batch).items()}
    assert set(got) == set(want)
    _close(got, want, 1e-5)
    check_params(tl.get_weights(), flax_rl_module_to_state_dict(jl.get_weights()), before, lr, 1)


def _cql_draws(key, b, n_act, d, low, high):
    """JAX's five draws inside CQL's update, from its key."""
    k_t, k_pi, k_rand, k_spi, k_spin = jax.random.split(key, 5)
    normal = lambda k, n: np.array(jax.random.normal(k, (n, d)))
    return {"next": normal(k_t, b), "pi": normal(k_pi, b),
            "rand": np.array(jax.random.uniform(k_rand, (n_act * b, d), minval=low, maxval=high)),
            "pi_rep": normal(k_spi, n_act * b), "pin_rep": normal(k_spin, n_act * b)}


def test_cql_updates_match_jax():
    data = offline_data()
    chain = lambda c: (c.offline_data_source(data)
                       .training(model=SMALL, train_batch_size=64, bc_iters=1).debugging(seed=2))
    jalgo, algo = chain(JCQLConfig()).build(), chain(CQLConfig().resources(device="cpu")).build()
    cfg = algo.config
    low, high = algo.module.low, algo.module.high
    assert (low, high) == (jalgo.module.low, jalgo.module.high)
    for i in range(2):       # update 0 in the bc phase, update 1 on SAC's objective
        algo.set_weights(flax_sac_to_state_dict(jax.device_get(jalgo.weights)))
        before = algo.get_weights()
        mb = {k: v[i * 64:(i + 1) * 64] for k, v in jalgo._data.items()}
        key = jax.random.PRNGKey(cfg.seed * 100_003 + i)
        jalgo.weights, jalgo.opt_state, want = jalgo._update(jalgo.weights, jalgo.opt_state, mb,
                                                             key, i < cfg.bc_iters)
        got = algo.learner.update(mb, _cql_draws(key, 64, cfg.num_cql_actions, 1, low, high),
                                  bc_phase=i < cfg.bc_iters)
        _close(got, want, 1e-4)
        check_update(algo.get_weights(), flax_sac_to_state_dict(jax.device_get(jalgo.weights)),
                     before, cfg.lr, cfg.tau, _sac_target_of)


def test_iql_updates_match_jax():
    data = offline_data(seed=1)
    chain = lambda c: (c.offline_data_source(data)
                       .training(model=SMALL, train_batch_size=64, beta=1.0).debugging(seed=3))
    jalgo, algo = chain(JIQLConfig()).build(), chain(IQLConfig().resources(device="cpu")).build()
    cfg = algo.config
    for i in range(2):
        algo.set_weights(flax_sac_to_state_dict(jax.device_get(jalgo.weights)))
        before = algo.get_weights()
        mb = {k: v[i * 64:(i + 1) * 64] for k, v in jalgo._data.items()}
        jalgo.weights, jalgo.opt_state, want = jalgo._update(jalgo.weights, jalgo.opt_state, mb)
        got = algo.learner.update(mb)
        _close(got, want, 1e-4)
        check_update(algo.get_weights(), flax_sac_to_state_dict(jax.device_get(jalgo.weights)),
                     before, cfg.lr, cfg.tau, _sac_target_of)
    assert set(algo.get_weights()) == set(flax_sac_to_state_dict(jax.device_get(jalgo.weights)))


def _pendulum_dataset(n_steps, seed=0):
    from test_rllib_cql import _pendulum_dataset as record
    return record(n_steps=n_steps, seed=seed)


def test_cql_penalty_below_its_ablation_and_evaluates():
    """JAX's ablation (tests/test_rllib_cql.py) on the port: after 4
    iterations the conservative gap at cql_alpha 1 is below the one at 0."""
    data = _pendulum_dataset(2000)

    def run(alpha, evaluate=False):
        algo = (CQLConfig().environment("Pendulum-v1").offline_data_source(data)
                .training(lr=3e-4, train_batch_size=256, cql_alpha=alpha, num_cql_actions=4,
                          train_intensity=10, bc_iters=10)
                .evaluation(evaluation_duration=2).resources(device="cpu").debugging(seed=7)
                .build())
        for _ in range(4):
            learner = algo.train()["learner"]
            assert np.isfinite(learner["critic_loss"]) and np.isfinite(learner["actor_loss"])
        if evaluate:
            ev = algo.evaluate()
            assert ev["episodes_this_iter"] == 2 and np.isfinite(ev["episode_return_mean"])
        return learner["cql_penalty"]

    assert run(1.0, evaluate=True) < run(0.0)


def test_iql_trains_and_weights_round_trip(tmp_path):
    data = _pendulum_dataset(500)
    cfg = lambda seed: (IQLConfig().offline_data_source(data).resources(device="cpu")
                        .training(train_batch_size=128, train_intensity=2, model=SMALL)
                        .debugging(seed=seed))
    algo = cfg(0).build()
    learner = algo.train()["learner"]
    for k in ("value_loss", "critic_loss", "actor_loss"):
        assert np.isfinite(learner[k])
    assert 0 < learner["awr_weight_mean"] < 101
    algo2 = cfg(1).build()
    algo2.set_weights(algo.get_weights())
    a, b = algo.learner.net.value.state_dict(), algo2.learner.net.value.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    algo3 = cfg(2).build()
    algo3.restore(algo.save(str(tmp_path / "iql")))
    w, w3 = algo.get_weights(), algo3.get_weights()
    assert all(torch.equal(w[k], w3[k]) for k in w)
