"""ray_tpu_torch.parallel.distributed and the world functions of
ray_tpu_torch.train.worker_group against ray_tpu's on the CPU.

One process: initialize_multihost starts no group and returns False,
index 0, count 1, and barrier returns, in both packages. Two processes:
spawned gloo ranks over a file:// store under tmp_path (so concurrent test
workers never share a port); the ranks import torch and the port only.
_world_info raises JAX's error, with the port's world named, when the
world is smaller than ScalingConfig(num_workers=N).

`run_ranks` is the spawner test_torch_collective.py uses too."""

import multiprocessing as mp
import pickle
import queue
import sys
import traceback

import pytest
import torch.distributed as dist

from ray_tpu_torch.parallel import distributed as tdist
from ray_tpu_torch.train import worker_group as twg


def _rank_main(target, rank, world, store, results, args_path):
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        results.put((rank, target(rank, world, store, *args), None))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))


def run_ranks(target, world, tmp_path, *args, timeout=90):
    """Run target(rank, world, store_url, *args) in `world` spawned
    processes; returns the results in rank order. `target` is a
    module-level function of a module that imports no jax. `args` go
    through a file under tmp_path: a large argument in the spawn pipe
    would hold each start until the previous child has read it."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = f"file://{tmp_path}/store-{target.__name__}-{world}"
    args_path = tmp_path / f"args-{target.__name__}-{world}.pkl"
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, store, results, str(args_path)),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            rank, value, err = results.get(timeout=timeout)
            out[rank] = value
            if err:
                errors.append(f"rank {rank}:\n{err}")
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(out))} gave no result "
                      f"in {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not errors, "\n".join(errors)
    return [out[r] for r in range(world)]


def _world_rank(rank, world, store):
    first = tdist.initialize_multihost(store, num_processes=world, process_id=rank,
                                       device="cpu")
    again = tdist.initialize_multihost(store, num_processes=world, process_id=rank,
                                       device="cpu")
    got = dict(first=first, again=again, index=tdist.process_index(),
               count=tdist.process_count(), multi=tdist.is_multihost(),
               backend=dist.get_backend(), jax_loaded="jax" in sys.modules)
    tdist.barrier()
    got["world_info"] = twg._world_info(_Scaling(world))
    try:
        twg._world_info(_Scaling(world + 1))
    except ValueError as e:
        got["too_small"] = str(e)
    dist.destroy_process_group()
    return got


class _Scaling:
    def __init__(self, num_workers):
        self.num_workers = num_workers


@pytest.fixture
def single_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "TPU_WORKER_HOSTNAMES",
              "TPU_WORKER_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tdist, "_initialized", False)
    assert not dist.is_initialized()


def test_one_process_matches_jax(single_process, monkeypatch):
    from ray_tpu.parallel import distributed as jdist
    monkeypatch.setattr(jdist, "_initialized", False)
    for mod in (jdist, tdist):
        assert mod.initialize_multihost() is False
        assert mod.initialize_multihost() is False       # idempotent
        assert (mod.process_index(), mod.process_count(), mod.is_multihost()) == (0, 1, False)
        mod.barrier()
    assert not dist.is_initialized()                     # no group was started


def test_two_gloo_ranks(tmp_path):
    got = run_ranks(_world_rank, 2, tmp_path)
    for rank, g in enumerate(got):
        assert (g["first"], g["again"], g["multi"]) == (True, True, True)
        assert (g["index"], g["count"], g["backend"]) == (rank, 2, "gloo")
        assert not g["jax_loaded"]
        assert g["world_info"] == (2, rank)
        assert "ScalingConfig(num_workers=3)" in g["too_small"]
        assert "has 2 process(es)" in g["too_small"]


def test_world_info_error_matches_jax(single_process):
    """The same ScalingConfig through both packages' _world_info, with no
    world started: (1, 0) for one worker; for two, JAX's ValueError, whose
    text the port keeps with its own world named."""
    from ray_tpu.train import ScalingConfig
    from ray_tpu.train import worker_group as jwg
    assert twg._world_info(ScalingConfig(num_workers=1)) == jwg._world_info(
        ScalingConfig(num_workers=1)) == (1, 0)
    msgs = []
    for mod in (jwg, twg):
        with pytest.raises(ValueError) as err:
            mod._world_info(ScalingConfig(num_workers=2))
        msgs.append(str(err.value))
    for m in msgs:
        for part in ("ScalingConfig(num_workers=2) but the", "process world has 1 "
                     "process(es). Initialize multi-host first", "or set num_workers=1; "
                     "refusing to silently train on 1/2 of the requested compute."):
            assert part in m, (part, m)
    assert "torch.distributed" in msgs[1]


def test_coordinator_endpoint_and_env_defaults(single_process, monkeypatch):
    monkeypatch.setenv("RAY_TPU_COORD_HOST", "10.0.0.7")
    host, port = twg.coordinator_endpoint().rsplit(":", 1)
    assert host == "10.0.0.7" and 0 < int(port) < 65536
    # two processes from WORLD_SIZE but no coordinator anywhere: a clear error
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR and MASTER_PORT"):
        tdist.initialize_multihost(device="cpu")
    # nccl with no visible card raises; nothing drops to gloo
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.initialize_multihost("localhost:1", num_processes=2, process_id=0)
    assert not dist.is_initialized()
