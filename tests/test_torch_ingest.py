"""ray_tpu_torch.train.ingest against ray_tpu.train.ingest on the CPU: the
same seeded host batches (dicts, lists and tuples of numpy arrays) come out
of both iter_device_batches with equal values, dtypes and structure, in
order; a producer error surfaces on the consumer's side in both; the
prefetch_iterator lookahead is JAX's. The pinned copy on a side stream is
checked on the card (chip_smoke.py, phase trainer)."""

import threading
import types

import jax
import numpy as np
import pytest
import torch

from ray_tpu.train import ingest as jingest
from ray_tpu_torch.train import ingest as tingest


def _batches(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (2, 9), dtype=np.int32),
             "pair": (rng.normal(size=(3,)).astype(np.float32), np.float64(i)),
             "mask": [rng.random((2, 4)) > 0.5]} for i in range(n)]


def _flat(tree, path=""):
    """[(path, container type or leaf as numpy)] in order."""
    if isinstance(tree, dict):      # jax.device_put sorts a dict's keys
        return [(path, dict)] + [x for k, v in sorted(tree.items())
                                 for x in _flat(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [(path, type(tree))] + [x for i, v in enumerate(tree)
                                       for x in _flat(v, f"{path}/{i}")]
    return [(path, tree.numpy() if isinstance(tree, torch.Tensor)
             else np.asarray(jax.device_get(tree)))]


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_same_batches_as_jax(prefetch):
    batches = _batches()
    transform = lambda b: dict(b, tokens=b["tokens"] + 1)
    got = list(tingest.iter_device_batches(iter(batches), device="cpu", prefetch=prefetch,
                                           transform=transform))
    want = list(jingest.iter_device_batches(iter(batches), prefetch=prefetch,
                                            transform=transform))
    assert len(got) == len(want) == len(batches)
    for g, w in zip(got, want):
        assert g["tokens"].device.type == "cpu"
        assert g["tokens"].dtype == torch.int32 and g["mask"][0].dtype == torch.bool
        for (gp, gl), (wp, wl) in zip(_flat(g), _flat(w), strict=True):
            assert gp == wp
            if isinstance(wl, type):
                assert gl is wl, gp                     # the same containers
            else:                                       # JAX keeps no float64
                np.testing.assert_array_equal(gl, wl, err_msg=gp)
    # the yielded tensors are copies: the host batches stay the caller's
    got[0]["tokens"].zero_()
    assert batches[0]["tokens"].any()


def test_producer_error_surfaces_in_both():
    def broken():
        yield from _batches(2)
        raise OSError("disk gone")

    for it in (tingest.iter_device_batches(broken(), device="cpu"),
               jingest.iter_device_batches(broken())):
        with pytest.raises(OSError, match="disk gone"):
            assert len([b for b in it]) == 2


def test_early_stop_releases_the_producer():
    """A consumer that stops after one batch of an endless feed leaves no
    producer thread behind."""
    def endless():
        while True:
            yield {"x": np.zeros(4, np.float32)}

    before = {t.ident for t in threading.enumerate()}
    it = tingest.iter_device_batches(endless(), device="cpu", prefetch=2)
    next(it)
    it.close()
    left = [t for t in threading.enumerate()
            if t.ident not in before and t.name == "ray_tpu_torch-ingest"]
    assert not left


def test_sharding_waits_for_the_mesh_and_cuda_needs_a_card():
    """A sharding places the batch on its mesh's device, whatever `device`
    says: a cuda mesh needs a card, as the default device does (sharded
    feeds themselves: test_torch_xla_ops.py)."""
    from ray_tpu_torch.parallel.sharding import P
    on_cuda = types.SimpleNamespace(mesh=types.SimpleNamespace(device_type="cuda"), spec=P())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tingest.iter_device_batches(_batches(1), device="cpu", sharding=on_cuda))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tingest.iter_device_batches(_batches(1)))


@pytest.mark.parametrize("depth", [0, 1, 3, 9])
def test_prefetch_iterator_matches_jax(depth):
    assert list(tingest.prefetch_iterator(range(7), depth)) == list(
        jingest.prefetch_iterator(range(7), depth))
