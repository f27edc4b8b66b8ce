"""The port's data-parallel learner group against ray_tpu's on the CPU.

JAX's group is one process over a {"dp": N} mesh of its 8 virtual CPU
devices; the port's is N gloo ranks (spawned with `run_ranks`; the rank
functions below import no jax, which the ranks assert), each holding the
group's learner. JAX's four cases (tests/test_rllib_learner_group.py):
two learners against one learner on the concatenated batch, here also
against JAX's group, re-synced to JAX's params before each update (Adam's
moments stay on both sides); the ragged minibatch on 4 ranks, 30 rows and
then 2; num_learners=1000 raising ValueError; PPO trained through a
two-learner group. And IMPALA's time-major [T, B] batch, sharded on B,
against the port's single learner at 2 and 4 ranks.

Tolerances (f32): metrics within 1e-4 of max(1, |value|); params as
tests/test_torch_rl_learner.py's `check_params` holds them (2 lr a step on
every coordinate, at most 1e-3 of them lr / 100 apart). Across ranks the
params are bitwise equal: the all-reduce hands every rank the same sum."""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import distributed as tdist
from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig, make_learner_group, sample_batch as SB
from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner
from ray_tpu_torch.rllib.learner import TorchLearner
from ray_tpu_torch.rllib.rl_module import ModuleSpec, RLModule
from test_torch_distributed import run_ranks

METRIC_TOL = 1e-4
LR = 1e-2


class _Cfg:
    lr = LR
    grad_clip = None
    num_learners = 0
    seed = 0
    device = "cpu"


class _MSELearner(TorchLearner):
    """JAX's supervised toy learner: fit obs -> target with the policy torso."""

    def compute_loss(self, net, batch):
        dist_in, _ = self.module.forward(net, batch["obs"])
        loss = (dist_in - batch["target"]).square().mean()
        return loss, {"mse": loss}


def _spec():
    return ModuleSpec((4,), "continuous", 2, (16,))


def _cfg(n):
    cfg = _Cfg()
    cfg.num_learners = n
    return cfg


def _host(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _numpy(weights):
    """A state_dict as numpy arrays (the ranks' results cross a queue, and
    a tensor there would need the rank alive until it is read)."""
    return {k: v.numpy() for k, v in weights.items()}


def _start(rank, world, store):
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")


def _mse_rank(rank, world, store, batch, params_before):
    """The group's learner on each rank: before each update, this step's
    JAX params (the optimizer keeps its moments); the update on the whole
    batch; its metrics and the params after."""
    _start(rank, world, store)
    group = make_learner_group(_MSELearner, RLModule(_spec()), _cfg(world), seed=0)
    steps = []
    for params in params_before:
        group.learner.net.load_state_dict(params)
        m = group.learner.update_once(dict(batch))
        steps.append((_host(m), _numpy(group.get_weights())))
    out = dict(steps=steps, num_learners=group.num_learners,
               dp=dict(zip(group.mesh.mesh_dim_names, group.mesh.mesh.shape)),
               jax_loaded="jax" in sys.modules)
    dist.destroy_process_group()
    return out


def _port_single(batch, params_before):
    single = make_learner_group(_MSELearner, RLModule(_spec()), _cfg(0), seed=0)
    assert single.num_learners == 1 and single.mesh is None
    steps = []
    for params in params_before:
        single.learner.net.load_state_dict(params)
        steps.append((_host(single.learner.update_once(dict(batch))), single.get_weights()))
    return steps


def _jax_steps(n, batch, updates):
    """JAX's group of n learners: (params before, metrics, params after) of
    each update, as the port's state_dicts."""
    import jax
    from ray_tpu.rllib.rl_module import RLModule as JModule
    from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
    from test_rllib_learner_group import _Cfg as JCfg, _MSELearner as JMSE, _spec as jspec
    from ray_tpu.rllib import make_learner_group as jmake

    cfg = JCfg()
    cfg.num_learners = n
    group = jmake(JMSE, JModule(jspec()), cfg, seed=0)
    out = []
    for _ in range(updates):
        before = flax_rl_module_to_state_dict(group.get_weights())
        m = jax.device_get(group.learner.update_once(dict(batch)))
        out.append((before, {k: float(v) for k, v in m.items()},
                    flax_rl_module_to_state_dict(group.get_weights())))
    return out


def _check_metrics(got, want, keys):
    for k in keys:
        assert abs(got[k] - want[k]) <= METRIC_TOL * max(1.0, abs(want[k])), (k, got[k], want[k])


def _same_on_ranks(weights):
    assert all(set(w) == set(weights[0]) and all(np.array_equal(w[k], weights[0][k]) for k in w)
               for w in weights[1:])


def test_two_learner_update_equals_single_learner(tmp_path):
    from test_rllib_learner_group import _batch
    from test_torch_rl_learner import check_params

    batch = _batch(np.random.default_rng(0), 32)
    want = _jax_steps(2, batch, 3)
    before = [b for b, _, _ in want]
    ranks = run_ranks(_mse_rank, 2, tmp_path, batch, before)
    single = _port_single(batch, before)
    for r in ranks:
        assert r["num_learners"] == 2 and r["dp"] == {"dp": 2} and not r["jax_loaded"]
    for i, (b, jm, jw) in enumerate(want):
        got_m, got_w = ranks[0]["steps"][i]
        keys = ("mse", "total_loss", "grad_norm")
        _check_metrics(got_m, jm, keys)
        _check_metrics(got_m, single[i][0], keys)
        check_params(got_w, jw, b, LR, 1)
        check_params(single[i][1], jw, b, LR, 1)
        _same_on_ranks([r["steps"][i][1] for r in ranks])


def _ragged_rank(rank, world, store, params, batch30, batch2):
    _start(rank, world, store)
    group = make_learner_group(_MSELearner, RLModule(_spec()), _cfg(world), seed=0)
    group.learner.net.load_state_dict(params)
    m30 = _host(group.learner.update_once(dict(batch30)))      # 30 % 4 != 0: 28 rows
    m2 = group.learner.update_once(dict(batch2))                # 2 < 4
    out = dict(m30=m30, m2=m2, weights=_numpy(group.get_weights()))
    dist.destroy_process_group()
    return out


def test_ragged_minibatch_dropped_not_crashed(tmp_path):
    import jax
    from ray_tpu.rllib import make_learner_group as jmake
    from ray_tpu.rllib.rl_module import RLModule as JModule
    from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
    from test_rllib_learner_group import _Cfg as JCfg, _MSELearner as JMSE, _batch, _spec as jspec

    cfg = JCfg()
    cfg.num_learners = 4
    jgroup = jmake(JMSE, JModule(jspec()), cfg, seed=0)
    rng = np.random.default_rng(1)
    batch30, batch2 = _batch(rng, 30), _batch(rng, 2)
    params = flax_rl_module_to_state_dict(jgroup.get_weights())
    want = jax.device_get(jgroup.learner.update_once(dict(batch30)))
    assert jgroup.learner.update_once(dict(batch2)) == {}
    ranks = run_ranks(_ragged_rank, 4, tmp_path, params, batch30, batch2)
    for r in ranks:
        assert np.isfinite(r["m30"]["mse"]) and r["m2"] == {}
        _check_metrics(r["m30"], {k: float(v) for k, v in want.items()},
                       ("mse", "total_loss", "grad_norm"))
    _same_on_ranks([r["weights"] for r in ranks])


@pytest.fixture
def fresh_world(monkeypatch):
    """No process group before the test; the one-rank world that
    make_learner_group starts is taken down after it."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tdist, "_initialized", False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_num_learners_over_devices_raises(fresh_world):
    from ray_tpu.rllib import make_learner_group as jmake
    from ray_tpu.rllib.rl_module import RLModule as JModule
    from test_rllib_learner_group import _Cfg as JCfg, _MSELearner as JMSE, _spec as jspec

    cfg = JCfg()
    cfg.num_learners = 1000
    with pytest.raises(ValueError, match="num_learners=1000 but only 8 devices"):
        jmake(JMSE, JModule(jspec()), cfg, seed=0)
    with pytest.raises(ValueError, match="num_learners=1000 but only 1 ranks"):
        make_learner_group(_MSELearner, RLModule(_spec()), _cfg(1000), seed=0)


@pytest.mark.parametrize("device,local_rank,rank,want", [
    ("cuda", "3", 1, 3),        # the launcher's LOCAL_RANK (torchrun's)
    ("cuda", None, 5, 1),       # else the world rank modulo the 4 cards
    ("cuda:2", "3", 1, None),   # a device that names its card is used as given
    ("cpu", "3", 1, None),
], ids=["local_rank", "rank_mod_cards", "named_card", "cpu"])
def test_bind_card(monkeypatch, device, local_rank, rank, want):
    """A cuda group's rank binds its own card before its learner resolves
    "cuda", so that no two ranks share card 0."""
    from ray_tpu_torch.rllib.learner import bind_card
    bound = []
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    assert bind_card(device) == want
    assert bound == ([] if want is None else [want])


def _ppo_rank(rank, world, store):
    _start(rank, world, store)
    torch.set_num_threads(1)
    algo = (PPOConfig().environment("CartPole-v1")
            .training(train_batch_size=512, minibatch_size=128, num_epochs=2, lr=5e-3)
            .learners(num_learners=2).env_runners(num_env_runners=0)
            .resources(device="cpu").build())
    assert algo.learner_group.num_learners == 2
    for _ in range(3):
        result = algo.train()
    out = dict(total_loss=result["learner"]["total_loss"],
               episode_return_mean=result["episode_return_mean"],
               weights=_numpy(algo.get_weights()),
               jax_loaded="jax" in sys.modules)
    algo.stop()
    dist.destroy_process_group()
    return out


def test_ppo_trains_through_two_learner_group(tmp_path):
    """PPO end to end with num_learners=2 (two ranks, each running the same
    Algorithm): finite metrics, a positive return, equal params."""
    ranks = run_ranks(_ppo_rank, 2, tmp_path, timeout=180)
    for r in ranks:
        assert np.isfinite(r["total_loss"]) and r["episode_return_mean"] > 0
        assert not r["jax_loaded"]
    assert ranks[0]["total_loss"] == ranks[1]["total_loss"]
    _same_on_ranks([r["weights"] for r in ranks])


T, B = 16, 8


def _impala_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {SB.OBS: f(T, b, 4), SB.ACTIONS: rng.integers(0, 2, (T, b)),
            SB.LOGP: np.log(rng.uniform(0.35, 0.65, (T, b))).astype(np.float32),
            SB.REWARDS: np.ones((T, b), np.float32),
            SB.DONES: (rng.random((T, b)) < 0.1).astype(np.float32),
            SB.BOOTSTRAP_VALUE: f(b)}


def _impala_cfg(n):
    return IMPALAConfig().training(lr=5e-4).learners(num_learners=n).resources(device="cpu")


def _impala_spec():
    return ModuleSpec((4,), "discrete", 2, (32, 32))


def _impala_rank(rank, world, store, batch, ragged):
    _start(rank, world, store)
    group = make_learner_group(IMPALALearner, RLModule(_impala_spec()), _impala_cfg(world),
                               seed=0)
    out = dict(metrics=_host(group.learner.update_once(dict(batch))),
               weights=_numpy(group.get_weights()), dp_bytes=group.learner.dp_bytes)
    try:
        group.learner.update_once(dict(ragged))
    except ValueError as e:
        out["ragged"] = str(e)
    dist.destroy_process_group()
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_impala_batch_sharded_on_envs(tmp_path, world):
    """IMPALA's [T, B] batch: each rank takes B / N whole sequences (and
    their BOOTSTRAP_VALUE); the group's update equals the single learner's
    on the whole batch. B % N != 0 raises ValueError."""
    from test_torch_rl_learner import check_params

    batch = _impala_batch()
    single = make_learner_group(IMPALALearner, RLModule(_impala_spec()), _impala_cfg(0), seed=0)
    before = single.get_weights()
    want = _host(single.learner.update_once(dict(batch)))
    ranks = run_ranks(_impala_rank, world, tmp_path, batch, _impala_batch(1, b=world + 1))
    for r in ranks:
        assert set(r["metrics"]) == set(want)
        _check_metrics(r["metrics"], want, want)
        assert "divisible by the" in r["ragged"]
    check_params(ranks[0]["weights"], single.get_weights(), before, 5e-4, 1)
    _same_on_ranks([r["weights"] for r in ranks])
    n_params = sum(v.numel() for v in before.values())
    assert ranks[0]["dp_bytes"] == 4 * (n_params + len(want) - 2)  # grads + metrics, f32
