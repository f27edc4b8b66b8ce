"""The port's PPO, IMPALA and APPO learners against ray_tpu's on the CPU,
from the same initial params (JAX's, carried across with
`convert.flax_rl_module_to_state_dict`) and the same numpy-seeded batch:
the loss, every metric and the params after the update; APPO's V-trace
targets; `grad_norm` taken before clipping; `cur_lr` under a schedule;
and the optimizer reset by `set_weights`.

Tolerances (f32). Metrics within 1e-4 of max(1, |value|). Params: Adam
divides by sqrt(v), so its first steps move each coordinate by about
lr * sign(g), and a coordinate whose gradient is at rounding level lands
up to 2 lr a step from the other package's, whatever the other does. The
params are held to (a) that bound on every coordinate and (b) at most
FAR_SHARE of the coordinates more than lr / 100 apart, a share a wrong
gradient exceeds: it moves most coordinates by ~lr (the control test
below shows the check rejecting another batch's update)."""

import numpy as np
import pytest
import torch

from ray_tpu.rllib import APPOConfig as JAPPOConfig
from ray_tpu.rllib import sample_batch as JSB
from ray_tpu.rllib.algorithms.impala import IMPALAConfig as JIMPALAConfig, \
    IMPALALearner as JIMPALALearner
from ray_tpu.rllib.algorithms.ppo import PPOConfig as JPPOConfig, PPOLearner as JPPOLearner
from ray_tpu.rllib.rl_module import ModuleSpec as JSpec, RLModule as JModule
from ray_tpu_torch.models.convert import flax_rl_module_to_state_dict
from ray_tpu_torch.rllib import APPOConfig, sample_batch as SB
from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig, IMPALALearner
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.learner import make_learner_group
from ray_tpu_torch.rllib.rl_module import ModuleSpec, RLModule
from test_torch_rl_learner_group import fresh_world  # noqa: F401 - a fixture

HIDDENS = (32, 32)
T, B = 16, 4
METRIC_TOL = 1e-4
FAR_SHARE = 1e-3


def _pair(jcls, tcls, jcfg, tcfg, seed=0):
    """A JAX learner and the port's, holding JAX's initial params."""
    jl = jcls(JModule(JSpec((4,), "discrete", 2, HIDDENS)), jcfg, seed=seed)
    tl = tcls(RLModule(ModuleSpec((4,), "discrete", 2, HIDDENS)), tcfg, seed=seed)
    tl.set_weights(flax_rl_module_to_state_dict(jl.get_weights()))
    return jl, tl


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        SB.OBS: f(T, B, 4), SB.ACTIONS: rng.integers(0, 2, (T, B)),
        SB.LOGP: np.log(rng.uniform(0.35, 0.65, (T, B))).astype(np.float32),
        SB.ADVANTAGES: f(T, B), SB.VF_PREDS: f(T, B) * 0.1, SB.VALUE_TARGETS: f(T, B),
        SB.REWARDS: np.ones((T, B), np.float32),
        SB.DONES: (rng.random((T, B)) < 0.1).astype(np.float32),
        SB.BOOTSTRAP_VALUE: f(B),
    }


def _check_metrics(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_TOL * max(1.0, abs(want[k])), (k, got[k], want[k])


def param_gap(got, want, lr):
    """(max |got - want|, share of coordinates more than lr / 100 apart)."""
    diff = np.concatenate([np.abs(np.asarray(got[k]) - np.asarray(want[k])).ravel()
                           for k in want])
    return diff.max(), float(np.mean(diff > lr / 100))


def check_params(got, want, before, lr, steps):
    """`got` (a port state_dict) within the Adam bound of `want` with at most
    FAR_SHARE of the coordinates lr / 100 apart, where the update from
    `before` moved most of them that far."""
    worst, far = param_gap(got, want, lr)
    assert worst <= 2 * lr * steps, worst
    assert far <= FAR_SHARE, far
    assert param_gap(want, before, lr)[1] > 0.5


def _check_params(tl, jl, before, lr, steps):
    check_params(tl.get_weights(), flax_rl_module_to_state_dict(jl.get_weights()), before,
                 lr, steps)


def _cfgs(jcls, tcls, **training):
    return (jcls().training(**training),
            tcls().training(**training).resources(device="cpu"))


@pytest.mark.parametrize("epochs,minibatch", [(1, 64), (2, 16)])
def test_ppo_update_matches_jax(epochs, minibatch):
    lr = 1e-3
    jcfg, tcfg = _cfgs(JPPOConfig, PPOConfig, lr=lr, num_epochs=epochs,
                       minibatch_size=minibatch, entropy_coeff=0.01, kl_coeff=0.2)
    jl, tl = _pair(JPPOLearner, PPOLearner, jcfg, tcfg)
    before = tl.get_weights()
    batch = _batch(1)
    want = jl.update(JSB.SampleBatch(batch))
    got = tl.update(SB.SampleBatch(batch))
    _check_metrics(got, want)
    _check_params(tl, jl, before, lr, epochs * (T * B // minibatch))


def test_params_check_rejects_another_batchs_update():
    """The control: the same learner updated on another batch moves the
    params by as much as on its own, and the check rejects it."""
    lr = 1e-3
    jcfg, tcfg = _cfgs(JIMPALAConfig, IMPALAConfig, lr=lr)
    jl, tl = _pair(JIMPALALearner, IMPALALearner, jcfg, tcfg)
    before = tl.get_weights()
    jl.update(JSB.SampleBatch(_batch(2)))
    tl.update(SB.SampleBatch(_batch(3)))
    with pytest.raises(AssertionError):
        _check_params(tl, jl, before, lr, 1)
    assert param_gap(tl.get_weights(), flax_rl_module_to_state_dict(jl.get_weights()),
                     lr)[1] > 0.1


def test_impala_update_matches_jax():
    lr = 1e-3
    jcfg, tcfg = _cfgs(JIMPALAConfig, IMPALAConfig, lr=lr)
    jl, tl = _pair(JIMPALALearner, IMPALALearner, jcfg, tcfg)
    before = tl.get_weights()
    for seed in (2, 3):      # two updates: the second from moved params
        batch = _batch(seed)
        want = jl.update(JSB.SampleBatch(batch))
        got = tl.update(SB.SampleBatch(batch))
        _check_metrics(got, want)
    _check_params(tl, jl, before, lr, 2)


def test_grad_norm_is_taken_before_clipping():
    lr, clip = 1e-3, 1e-3
    jcfg, tcfg = _cfgs(JIMPALAConfig, IMPALAConfig, lr=lr, grad_clip=clip)
    jl, tl = _pair(JIMPALALearner, IMPALALearner, jcfg, tcfg)
    before = tl.get_weights()
    batch = _batch(4)
    want = jl.update(JSB.SampleBatch(batch))
    got = tl.update(SB.SampleBatch(batch))
    assert got["grad_norm"] > 100 * clip
    _check_metrics(got, want)
    _check_params(tl, jl, before, lr, 1)


def test_cur_lr_follows_the_schedule():
    sched = [[0, 1e-3], [4, 1e-4]]
    jcfg, tcfg = _cfgs(JIMPALAConfig, IMPALAConfig, lr=1e-3, lr_schedule=sched)
    jl, tl = _pair(JIMPALALearner, IMPALALearner, jcfg, tcfg)
    before = tl.get_weights()
    keys = IMPALALearner._TRAIN_KEYS
    got, want = [], []
    for seed in range(6):
        batch = _batch(10 + seed)
        want.append(float(jl.update_once({k: batch[k] for k in keys})["cur_lr"]))
        got.append(tl.update_once({k: batch[k] for k in keys})["cur_lr"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, [1e-3, 7.75e-4, 5.5e-4, 3.25e-4, 1e-4, 1e-4], rtol=1e-6)
    _check_params(tl, jl, before, 1e-3, 6)


def test_set_weights_resets_the_optimizer():
    """JAX re-inits opt_state on set_weights: Adam's moments and the
    schedule's count start again, while cur_lr keeps counting updates."""
    sched = [[0, 1e-3], [2, 1e-4]]
    jcfg, tcfg = _cfgs(JIMPALAConfig, IMPALAConfig, lr=1e-3, lr_schedule=sched)
    jl, tl = _pair(JIMPALALearner, IMPALALearner, jcfg, tcfg)
    for seed in (5, 6, 7):
        batch = _batch(seed)
        jl.update(JSB.SampleBatch(batch))
        tl.update(SB.SampleBatch(batch))
    start = flax_rl_module_to_state_dict(jl.get_weights())
    jl.set_weights(jl.get_weights())
    tl.set_weights(start)
    assert tl.optimizer.state_dict()["state"] == {}
    batch = _batch(8)
    want = jl.update(JSB.SampleBatch(batch))
    got = tl.update(SB.SampleBatch(batch))
    _check_metrics(got, want)
    assert got["cur_lr"] == pytest.approx(1e-4)        # schedule(3)
    _check_params(tl, jl, start, 1e-3, 1)             # stepped at lr 1e-3: count 0


def test_state_round_trip_keeps_moments_and_schedule():
    sched = [[0, 1e-3], [3, 1e-4]]
    cfg = IMPALAConfig().training(lr=1e-3, lr_schedule=sched).resources(device="cpu")
    spec = ModuleSpec((4,), "discrete", 2, HIDDENS)
    a = IMPALALearner(RLModule(spec), cfg, seed=0)
    a.update(SB.SampleBatch(_batch(20)))
    a.update(SB.SampleBatch(_batch(21)))
    b = IMPALALearner(RLModule(spec), cfg, seed=1)
    b.set_state(a.get_state())
    for learner in (a, b):
        learner.update(SB.SampleBatch(_batch(22)))
    wa, wb = a.get_weights(), b.get_weights()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_appo_vtrace_targets_match_jax():
    jalgo = (JAPPOConfig().environment("CartPole-v1")
             .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
             .training(train_batch_size=16, minibatch_size=8).build())
    talgo = (APPOConfig().environment("CartPole-v1")
             .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
             .training(train_batch_size=16, minibatch_size=8).resources(device="cpu").build())
    talgo.set_weights(flax_rl_module_to_state_dict(jalgo.get_weights()))
    batch = _batch(30)
    batch[SB.LOGP] = batch[SB.LOGP] - 0.1
    keys = (SB.OBS, SB.ACTIONS, SB.LOGP, SB.REWARDS, SB.DONES, SB.BOOTSTRAP_VALUE)
    want_adv, want_vs = jalgo._targets(jalgo.learner.params, {k: batch[k] for k in keys})
    got_adv, got_vs = talgo._targets(batch)
    for g, w in ((got_adv, want_adv), (got_vs, want_vs)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= METRIC_TOL * np.abs(w).max()
    jalgo.stop()
    talgo.stop()


def test_learner_defaults_to_cuda_and_dp_raises(fresh_world):
    """A learner builds on cuda by default; a two-learner group on a world
    of one rank raises JAX's ValueError (the group is one rank a learner;
    the one-rank world it starts to count the ranks is taken down)."""
    spec = RLModule(ModuleSpec((4,), "discrete", 2, HIDDENS))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PPOLearner(spec, PPOConfig())
    with pytest.raises(ValueError, match="num_learners=2 but only 1 ranks"):
        make_learner_group(PPOLearner, spec,
                           PPOConfig().learners(num_learners=2).resources(device="cpu"))
