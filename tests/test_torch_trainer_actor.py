"""TorchTrainer's actor paths on the port's runtime against JaxTrainer's
on ray_tpu's, on the CPU: tests/test_train_orchestration.py's programs
(a plain fit in the worker actor, a worker that kills its own process
mid-run and resumes from the checkpoint on disk, and one whose retries
run out) run through both trainers with `use_worker_actor=True`, and
their Results are compared field by field; the run whose retries ran out
is also held against each package's `result_after_worker_death` on its
run's directory. `use_worker_actor=None` runs in an actor under an
initialized session. The two-worker group on gloo (one `TrainWorker` a
bundle of a placement group, group restart) is held port against port:
its history after rank 1 kills itself once equals the unkilled group's.
JAX's CPU group needs a jax.distributed world, which is unsteady here
(ROADMAP §C)."""

import os
import signal
from concurrent.futures import ThreadPoolExecutor

import pytest

import ray_tpu_torch as rt
from ray_tpu import train as jtrain
from ray_tpu.train import worker_group as jwg
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.train import worker_group as twg


@pytest.fixture(scope="module")
def port_session():
    rt.init(num_cpus=4, num_gpus=0)
    yield rt
    rt.shutdown()


@pytest.fixture(autouse=True)
def time_limit():
    """Fail (not hang) a fit after 240 s: a worker that never returns would
    otherwise hold the test until the suite's own limit."""
    def expire(signum, frame):
        raise TimeoutError("an actor fit exceeded its 240 s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(240)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _crashy_loop(pkg):
    """test_train_orchestration.py's loop for either package: counts
    iterations by checkpoint and kills its own process once at `die_at`
    (every time when `flag` is None), so a resume comes only from the
    actor's restart and the checkpoint on disk. Rank `rank` alone dies
    in a group, whose every rank takes part in one all-reduce a step.
    Built in a function so that cloudpickle sends it by value."""

    def loop(config):
        import importlib
        import os
        train = importlib.import_module(f"{pkg}.train")
        ctx = train.get_context()
        start = 1
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_state()["it"] + 1
        for it in range(start, config["steps"] + 1):
            flag = config.get("flag")
            if (it == config.get("die_at") and ctx.get_world_rank() == config.get("rank", 0)
                    and not (flag and os.path.exists(flag))):
                if flag:
                    with open(flag, "w") as f:
                        f.write("died")
                os._exit(1)
            metrics = {"it": it, "pid": os.getpid()}
            if ctx.get_world_size() > 1:
                import torch
                import torch.distributed as dist
                x = torch.tensor([float(it * (ctx.get_world_rank() + 1))])
                dist.all_reduce(x)
                metrics["sum"] = float(x)
            train.report(metrics, checkpoint=train.Checkpoint.from_state({"it": it}))

    return loop


def _fit(pkg, root, name, config, failures=0, use_worker_actor=True, **kw):
    train = jtrain if pkg == "ray_tpu" else ttrain
    trainer_cls = train.JaxTrainer if pkg == "ray_tpu" else train.TorchTrainer
    return trainer_cls(
        _crashy_loop(pkg), train_loop_config=config,
        run_config=train.RunConfig(name=name, storage_path=str(root),
                                   failure_config=train.FailureConfig(max_failures=failures)),
        use_worker_actor=use_worker_actor, **kw).fit()


def _fit_both(root, name, config, **kw):
    """The same program through both trainers at once (each waits on its
    own actor), each under root/<package>, where a `flag` file name goes
    too: {package: Result}."""
    with ThreadPoolExecutor(2) as pool:
        futs = {}
        for pkg in ("ray_tpu", "ray_tpu_torch"):
            os.makedirs(root / pkg)
            cfg = dict(config, flag=str(root / pkg / config["flag"])) if "flag" in config \
                else config
            futs[pkg] = pool.submit(_fit, pkg, root / pkg, name, cfg, **kw)
        return {pkg: f.result() for pkg, f in futs.items()}


def _without_pids(history):
    return [{k: v for k, v in m.items() if k != "pid"} for m in history]


def _same_result(got, want):
    assert _without_pids(got.metrics_history) == _without_pids(want.metrics_history)
    assert (got.error is None) == (want.error is None)
    if got.checkpoint is None or want.checkpoint is None:
        assert got.checkpoint is want.checkpoint is None
    else:
        assert got.checkpoint.to_state() == want.checkpoint.to_state()
    assert [s for _, s in got.best_checkpoints] == [s for _, s in want.best_checkpoints]
    assert sorted(os.listdir(got.path)) == sorted(os.listdir(want.path))


def test_plain_fit_in_actor_matches_jax(ray_session, port_session, tmp_path):
    res = _fit_both(tmp_path, "plain", {"steps": 3})
    got, want = res["ray_tpu_torch"], res["ray_tpu"]
    _same_result(got, want)
    assert got.error is None and len(got.metrics_history) == 3
    assert {m["pid"] for m in got.metrics_history} != {os.getpid()}


def test_kill_mid_run_resumes_as_jax(ray_session, port_session, tmp_path):
    res = _fit_both(tmp_path, "crashrec", {"steps": 6, "die_at": 4, "flag": "died"},
                    failures=2)
    for pkg in res:
        assert os.path.exists(tmp_path / pkg / "died"), f"{pkg} never reached the crash point"
    got, want = res["ray_tpu_torch"], res["ray_tpu"]
    _same_result(got, want)
    assert got.error is None and [m["it"] for m in got.metrics_history] == [1, 2, 3, 4, 5, 6]
    assert got.checkpoint.to_state() == {"it": 6}
    # two processes: the one that died at iteration 4 and its respawn
    pids = [m["pid"] for m in got.metrics_history]
    assert pids[:3] == [pids[0]] * 3 and pids[3:] == [pids[3]] * 3 and pids[0] != pids[3]


def test_retries_exhausted_gives_the_result_after_worker_death(ray_session, port_session,
                                                             tmp_path):
    """The worker dies at iteration 3 with no retry allowed: fit()
    returns the run's state on disk with the error."""
    res = _fit_both(tmp_path, "dead", {"steps": 5, "die_at": 3})
    for pkg, wg in (("ray_tpu", jwg), ("ray_tpu_torch", twg)):
        r = res[pkg]
        train = jtrain if pkg == "ray_tpu" else ttrain
        want = wg.result_after_worker_death(
            train.RunConfig(name="dead", storage_path=str(tmp_path / pkg)), r.error, None)
        assert r.metrics_history == want["history"]
        assert r.checkpoint.path == want["latest_ckpt"]
        assert [(c.path, s) for c, s in r.best_checkpoints] == want["best_ckpts"]
        assert r.path == want["path"]
    got, jres = res["ray_tpu_torch"], res["ray_tpu"]
    _same_result(got, jres)
    assert type(got.error).__name__ == type(jres.error).__name__ == "ActorDiedError"
    assert [m["it"] for m in got.metrics_history] == [1, 2]
    assert got.checkpoint.to_state() == {"it": 2}


def test_default_runs_in_an_actor_under_a_session(ray_session, port_session, tmp_path):
    """use_worker_actor=None: in an actor when the package's runtime is
    initialized (both are here), as JAX's default."""
    for pkg, r in _fit_both(tmp_path, "default", {"steps": 2},
                            use_worker_actor=None).items():
        assert r.error is None and len(r.metrics_history) == 2
        assert {m["pid"] for m in r.metrics_history} != {os.getpid()}, pkg


def test_worker_group_restart_equals_the_unkilled_group(port_session, tmp_path):
    """Two TrainWorkers on gloo in a placement group: rank 1 kills its own
    process once at iteration 3, the whole group is torn down and retried
    (max_failures=1), resuming from the checkpoint of iteration 2; the
    history equals an unkilled group's."""
    scaling = ttrain.ScalingConfig(num_workers=2)
    base = {"steps": 4, "rank": 1}
    killed = _fit("ray_tpu_torch", tmp_path, "killed",
                  dict(base, die_at=3, flag=str(tmp_path / "died")), failures=1,
                  scaling_config=scaling)
    whole = _fit("ray_tpu_torch", tmp_path, "whole", base, scaling_config=scaling)
    assert os.path.exists(tmp_path / "died")
    assert killed.error is None and whole.error is None
    _same_result(killed, whole)
    assert [m["sum"] for m in killed.metrics_history] == [3.0, 6.0, 9.0, 12.0]
    pids = [m["pid"] for m in killed.metrics_history]
    assert pids[0] == pids[1] != pids[2] == pids[3]     # rank 0 restarted with the group
    # out of retries: the group's Result carries the error and the state on disk
    dead = _fit("ray_tpu_torch", tmp_path, "dead", dict(base, die_at=3),
                scaling_config=scaling)
    assert dead.error is not None and [m["it"] for m in dead.metrics_history] == [1, 2]


def test_restarted_actor_reads_its_large_creation_args(port_session, tmp_path):
    """A restartable actor whose creation argument is too large to ride
    inline (here 1 MiB, stored in the object store) is respawned after its
    process exits, and the retried call sees the same argument. Before the
    fix the argument's object was released when the first creation
    finished, and the restart failed with ObjectLostError (an llama_1b
    fit's batches in a TrainWorker on the card)."""
    import numpy as np

    class Holder:
        def __init__(self, blob, flag):
            self.total, self.flag = float(blob.sum()), flag

        def total_after_crash(self):
            import os
            if not os.path.exists(self.flag):
                open(self.flag, "w").close()
                os._exit(1)
            return self.total

    blob = np.arange(1 << 18, dtype=np.float32)          # 1 MiB
    actor = rt.remote(num_cpus=0, max_restarts=1, max_task_retries=1)(Holder).remote(
        blob, str(tmp_path / "died"))
    try:
        assert rt.get(actor.total_after_crash.remote(), timeout=120) == float(blob.sum())
    finally:
        rt.kill(actor)
    assert os.path.exists(tmp_path / "died")


def test_book_ignores_a_partial_checkpoint_copy(tmp_path):
    """Rank 0 copies a reported checkpoint into the run directory under a
    `.partial` name and renames it when whole, so a worker killed mid-copy
    (a group's peer died) leaves nothing the resumed run's book reads."""
    whole = ttrain.Checkpoint.from_state({"it": 2}, path=str(tmp_path / "checkpoint_000000"))
    whole.update_metadata({"iteration": 2, "metrics": {"it": 2}})
    ttrain.Checkpoint.from_state({"it": 3}, path=str(tmp_path / "checkpoint_000001.partial"))
    book, next_idx = twg.rebuild_book(str(tmp_path), ttrain.CheckpointConfig())
    assert book.latest.path == whole.path and book.latest.to_state() == {"it": 2}
    assert next_idx == 1
