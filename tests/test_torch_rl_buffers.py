"""The port's replay buffers against ray_tpu's: for each seed, the same
adds give the same sampled indices, rows, importance weights and
priorities in both packages (exact: both draw from numpy's generator in
the same order and do the same float64 arithmetic), and the properties of
JAX's three buffer cases (tests/test_rllib_algos.py) hold on the port's."""

import numpy as np
import pytest

from ray_tpu.rllib.buffers import PrioritizedReplayBuffer as JPER, ReplayBuffer as JReplay
from ray_tpu_torch.rllib import PrioritizedReplayBuffer, ReplayBuffer


def _transitions(rng, n):
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n), "rewards": rng.standard_normal(n).astype(np.float32)}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_uniform_buffer_draws_as_jax(seed):
    rng = np.random.default_rng(100 + seed)
    bufs = (JReplay(64, seed=seed), ReplayBuffer(64, seed=seed))
    for n in (40, 50, 3):          # wraps the ring
        batch = _transitions(rng, n)
        for b in bufs:
            b.add_batch(batch)
        assert len(bufs[0]) == len(bufs[1])
        _equal(bufs[1].sample(16), bufs[0].sample(16))
    for b in bufs:
        b.add(obs=np.ones(4, np.float32), actions=1, rewards=0.5)
    _equal(bufs[1].sample(32), bufs[0].sample(32))


@pytest.mark.parametrize("seed", [0, 3])
def test_prioritized_buffer_draws_as_jax(seed):
    rng = np.random.default_rng(200 + seed)
    bufs = (JPER(50, alpha=0.6, seed=seed), PrioritizedReplayBuffer(50, alpha=0.6, seed=seed))
    for step in range(4):
        batch = _transitions(rng, 20)
        for b in bufs:
            b.add_batch(batch)
        want, got = bufs[0].sample(24, beta=0.4), bufs[1].sample(24, beta=0.4)
        _equal(got, want)
        td = rng.standard_normal(24) * (step + 1)
        for b, s in zip(bufs, (want, got)):
            b.update_priorities(s["_indices"], td)
        np.testing.assert_array_equal(bufs[1].tree.tree, bufs[0].tree.tree)
        assert bufs[1].max_priority == bufs[0].max_priority


def test_replay_buffer_ring_and_sampling():
    buf = ReplayBuffer(capacity=100, seed=0)
    buf.add_batch({"x": np.arange(150), "y": np.arange(150) * 2})
    assert len(buf) == 100
    s = buf.sample(32)
    assert s["x"].shape == (32,)
    assert s["x"].min() >= 50            # the ring evicted the oldest 50
    np.testing.assert_array_equal(s["y"], s["x"] * 2)


def test_replay_buffer_uniformity():
    buf = ReplayBuffer(capacity=10, seed=1)
    buf.add_batch({"x": np.arange(10)})
    counts = np.zeros(10)
    for _ in range(200):
        for v in buf.sample(10)["x"]:
            counts[v] += 1
    assert counts.min() > 100 and counts.max() < 320    # 200 each, within noise


def test_prioritized_buffer_prefers_high_priority():
    buf = PrioritizedReplayBuffer(capacity=8, alpha=1.0, seed=2)
    buf.add_batch({"x": np.arange(8)})
    buf.update_priorities(np.arange(8), np.ones(8) * 0.01)
    buf.update_priorities([3], [100.0])
    s = buf.sample(200, beta=1.0)
    assert float(np.mean(s["x"] == 3)) > 0.8
    assert "_weights" in s and s["_weights"].max() <= 1.0 + 1e-6
