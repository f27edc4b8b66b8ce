"""Tune on the port's runtime (`ray_tpu_torch.tune`) against `ray_tpu.tune`.

In process, each package's pure functions on the same inputs: every
search-space domain's draws from one seed, the grid cross-product,
`ConcurrencyLimiter`, the ASHA, HyperBand, median-stopping and PBT
decisions on one result stream, the stoppers, `QuasiBayesSearch`'s
suggestion streams, the factories, the stop callable's signature rule and
a resumed class trainable. Equal outputs, and JAX's assertions on the
port (`tests/test_tune.py`, `tests/test_tune_search_quality.py`).

Across actors: the programs of `tests/test_tune.py` and
`tests/test_tune_run_api.py` (its three Data cases wait for Data) are
written once against a package and run for each in fresh interpreters,
all at once (`readings`, as `tests/test_torch_runtime.py` does): JAX's
under `init(num_cpus=4)`, the port's under `init(num_cpus=4, num_gpus=2)`.
Each program gives one reading a JAX case; a reading that does not depend
on timing equals JAX's, and the rest hold JAX's assertions. The port
also claims "GPU" for a trial (`with_resources({"gpu": 1})`), each trial
actor seeing its `get_gpu_ids()` as `CUDA_VISIBLE_DEVICES`, and
`test_stop_callable_two_arg_signature`, unsteady on JAX's side, runs three
times on each package.

No jax at this module's top: the scenarios import it in their own
interpreters, the port's never."""

import importlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")
STOP_REPEATS = 3


def _tune(pkg):
    return importlib.import_module(f"{pkg}.tune")


def _both(program):
    """`program(pkg)` for each package: (JAX's output, the port's)."""
    return program("ray_tpu"), program("ray_tpu_torch")


# ------------------------------------------------------------- search spaces
DOMAINS = {
    "choice": lambda t: t.choice([1, 2, 3, "x"]),
    "uniform": lambda t: t.uniform(-2.0, 3.0),
    "quniform": lambda t: t.quniform(0.0, 10.0, 0.5),
    "loguniform": lambda t: t.loguniform(1e-4, 1e-1),
    "qloguniform": lambda t: t.qloguniform(1e-3, 1.0, 1e-3),
    "randint": lambda t: t.randint(5, 10),
    "qrandint": lambda t: t.qrandint(0, 100, 10),
    "lograndint": lambda t: t.lograndint(1, 1000),
    "qlograndint": lambda t: t.qlograndint(1, 1000, 5),
    "randn": lambda t: t.randn(1.0, 2.0),
    "qrandn": lambda t: t.qrandn(0.0, 1.0, 0.25),
    "sample_from": lambda t: t.sample_from(lambda: 42),
}


@pytest.mark.parametrize("name", sorted(DOMAINS))
def test_domain_draws_match_jax(name):
    """40 draws from default_rng(seed) for three seeds: equal values and
    types."""
    def draws(pkg):
        dom = DOMAINS[name](_tune(pkg))
        out = []
        for seed in (0, 1, 7):
            rng = np.random.default_rng(seed)
            out += [(v, type(v).__name__) for v in (dom.sample(rng) for _ in range(40))]
        return out
    jax_side, port = _both(draws)
    assert port == jax_side


def test_search_space_sampling():
    tune = _tune("ray_tpu_torch")
    rng = np.random.default_rng(0)
    assert tune.choice([1, 2, 3]).sample(rng) in (1, 2, 3)
    assert 0.0 <= tune.uniform(0.0, 1.0).sample(rng) <= 1.0
    assert 1e-4 <= tune.loguniform(1e-4, 1e-1).sample(rng) <= 1e-1
    assert 5 <= tune.randint(5, 10).sample(rng) < 10
    assert tune.qrandint(0, 100, 10).sample(rng) % 10 == 0
    assert tune.sample_from(lambda: 42).sample(rng) == 42
    with pytest.raises(ValueError, match="low > 0"):
        tune.loguniform(0, 1)


GRID_SPACE = lambda t: {"a": t.grid_search([1, 2, 3]), "b": t.grid_search(["x", "y"]),
                        "c": t.uniform(0, 1), "e": t.qrandint(0, 50, 5), "d": "const"}


def test_basic_variant_grid_cross_product_matches_jax():
    """The cross product of the grids x num_samples draws, for three seeds,
    suggested in the same order; then exhausted."""
    def suggestions(pkg):
        t = _tune(pkg)
        out = []
        for seed in (0, 3, 11):
            gen = t.BasicVariantGenerator(GRID_SPACE(t), num_samples=2, seed=seed)
            out.append([gen.total_trials] + [gen.suggest(f"t{i}")
                                             for i in range(gen.total_trials + 1)])
        return out
    jax_side, port = _both(suggestions)
    assert port == jax_side
    first = port[0]
    assert first[0] == 3 * 2 * 2 and first[-1] is None
    assert {(c["a"], c["b"]) for c in first[1:-1]} == {(a, b) for a in (1, 2, 3)
                                                        for b in ("x", "y")}
    assert all(0 <= c["c"] <= 1 and c["d"] == "const" for c in first[1:-1])


def test_concurrency_limiter_matches_jax():
    def sequence(pkg):
        t = _tune(pkg)
        lim = t.ConcurrencyLimiter(t.BasicVariantGenerator({"x": t.uniform(0, 1)},
                                                           num_samples=5), max_concurrent=2)
        out = [lim.suggest("t1"), lim.suggest("t2"), lim.suggest("t3")]
        lim.on_trial_complete("t1")
        out += [lim.suggest("t3"), lim.suggest("t4")]
        lim.on_trial_complete("t2")
        lim.on_trial_complete("t3")
        out += [lim.suggest("t4"), lim.suggest("t5"), lim.suggest("t6"), lim.total_trials]
        return out
    jax_side, port = _both(sequence)
    assert port == jax_side
    assert port[2] is None and port[3] is not None and port[4] is None


# ----------------------------------------------------------------- schedulers
def _stream(seed, trials=8, horizon=16):
    """Interleaved results of `trials` trials: a noisy descent each."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 10.0, trials)
    return [(f"t{i}", {"training_iteration": it,
                       "score": float(base[i] - 0.3 * it + rng.normal(0, 0.5))})
            for it in range(1, horizon + 1) for i in range(trials)]


def _decide(scheduler, stream):
    out = []
    for tid, result in stream:
        d = scheduler.on_result(tid, result)
        out.append(d if isinstance(d, str) else ("PBT", d.source_trial, d.new_config))
    return out


SCHEDULERS = {
    "asha_eta4": lambda t: t.ASHAScheduler(max_t=16, grace_period=1, reduction_factor=4,
                                           metric="score", mode="max"),
    "asha_eta2_min": lambda t: t.ASHAScheduler(max_t=12, grace_period=2, reduction_factor=2,
                                               metric="score", mode="min"),
    "hyperband": lambda t: t.HyperBandScheduler(max_t=16, reduction_factor=2),
    "median": lambda t: t.MedianStoppingRule(grace_period=2, min_samples_required=3),
    "pbt": lambda t: t.PopulationBasedTraining(
        perturbation_interval=2, seed=5, quantile_fraction=0.25,
        hyperparam_mutations={"lr": [0.1, 0.01, 0.001], "wd": t.loguniform(1e-5, 1e-2),
                              "mom": None}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_match_jax(name):
    """The same decisions, in order, on two seeded streams of 128 results
    (PBT: the same exploit sources and mutated configs)."""
    def decisions(pkg):
        out = []
        for seed in (0, 1):
            s = SCHEDULERS[name](_tune(pkg))
            if not hasattr(s, "metric"):
                s.set_properties("score", "max")
            for i in range(8):
                if hasattr(s, "register"):
                    s.register(f"t{i}", {"lr": 0.1, "wd": 1e-3, "mom": 0.9 + i / 100})
            out.append(_decide(s, _stream(seed)))
        return out
    jax_side, port = _both(decisions)
    assert port == jax_side
    flat = [d if isinstance(d, str) else d[0] for run in port for d in run]
    assert "CONTINUE" in flat and ("PBT" if name == "pbt" else "STOP") in flat


def test_asha_pruning_math():
    tune = _tune("ray_tpu_torch")
    sched = tune.ASHAScheduler(max_t=16, grace_period=1, reduction_factor=4,
                               metric="score", mode="max")
    d = {i: sched.on_result(f"t{i}", {"training_iteration": 1, "score": float(7 - i)})
         for i in range(8)}
    assert d[0] == "CONTINUE" and d[3] == "STOP" and d[7] == "STOP"
    assert sched.on_result("t7", {"training_iteration": 16, "score": 100.0}) == "STOP"


def test_median_stopping():
    sched = _tune("ray_tpu_torch").MedianStoppingRule(grace_period=2, min_samples_required=3)
    sched.set_properties("score", "max")
    for t in (1, 2, 3):
        assert sched.on_result("good", {"training_iteration": t, "score": 10.0}) == "CONTINUE"
        sched.on_result("mid", {"training_iteration": t, "score": 5.0})
        bad = sched.on_result("bad", {"training_iteration": t, "score": 1.0})
    assert bad == "STOP"


def test_pbt_exploit_decision():
    tune = _tune("ray_tpu_torch")
    from ray_tpu_torch.tune.schedulers import PBTDecision
    sched = tune.PopulationBasedTraining(perturbation_interval=2,
                                         hyperparam_mutations={"lr": [0.1, 0.01]}, seed=0)
    sched.set_properties("score", "max")
    sched.register("winner", {"lr": 0.1})
    sched.register("loser", {"lr": 0.0001})
    sched.on_result("winner", {"training_iteration": 2, "score": 10.0})
    d = sched.on_result("loser", {"training_iteration": 2, "score": 0.1})
    assert isinstance(d, PBTDecision)
    assert d.source_trial == "winner" and d.new_config["lr"] in (0.1, 0.01)


def test_stoppers_match_jax():
    def calls(pkg):
        t = _tune(pkg)
        plateau = t.TrialPlateauStopper("score", std=0.05, num_results=3, grace_period=3)
        combined = t.CombinedStopper(t.MaximumIterationStopper(10),
                                     t.FunctionStopper(lambda tid, r: r["score"] > 9.5))
        return [(plateau(tid, r), combined(tid, r)) for tid, r in _stream(2, trials=4)]
    jax_side, port = _both(calls)
    assert port == jax_side
    assert any(p for p, _ in port) and any(c for _, c in port)


# ------------------------------------------------------------ QuasiBayesSearch
def _surrogate(cfg):
    return -((cfg["x"] - 0.31) ** 2 + (cfg["y"] - 0.73) ** 2)


def _run_searcher(searcher, budget, score=_surrogate, key="score"):
    best, configs = -np.inf, []
    for i in range(budget):
        cfg = searcher.suggest(f"t{i}")
        if cfg is None:
            break
        configs.append(cfg)
        s = score(cfg)
        searcher.on_trial_complete(f"t{i}", {key: s})
        best = max(best, s)
    return best, configs


def test_quasibayes_streams_match_jax():
    """The same configs suggested for the same seeds and observations, in
    max and min mode."""
    def streams(pkg):
        from_space = importlib.import_module(f"{pkg}.tune.search_space")
        search = importlib.import_module(f"{pkg}.tune.search")
        space = {"x": from_space.Uniform(0.0, 1.0), "y": from_space.Uniform(0.0, 1.0),
                 "k": from_space.Randint(1, 9), "c": from_space.Categorical(["a", "b"])}
        out = []
        for seed, mode in ((0, "max"), (4, "min"), (9, "max")):
            qb = search.QuasiBayesSearch(dict(space), num_samples=24, seed=seed,
                                         metric="score", mode=mode, warmup=5)
            out.append(_run_searcher(qb, 25)[1])
        return out
    jax_side, port = _both(streams)
    assert port == jax_side


def test_quasibayes_beats_random_on_surrogate():
    """tests/test_tune_search_quality.py's first case, on the port."""
    from ray_tpu_torch.tune.search import BasicVariantGenerator, QuasiBayesSearch
    from ray_tpu_torch.tune.search_space import Uniform
    space = {"x": Uniform(0.0, 1.0), "y": Uniform(0.0, 1.0)}
    budget, qb_scores, rnd_scores = 32, [], []
    for seed in range(12):
        qb = QuasiBayesSearch(dict(space), num_samples=budget, seed=seed, metric="score",
                              mode="max", warmup=6)
        qb_scores.append(_run_searcher(qb, budget)[0])
        rnd = BasicVariantGenerator(dict(space), num_samples=budget, seed=seed)
        rnd_scores.append(_run_searcher(rnd, budget)[0])
    assert np.mean(qb_scores) > np.mean(rnd_scores), (qb_scores, rnd_scores)
    assert sum(q >= r for q, r in zip(qb_scores, rnd_scores)) >= len(qb_scores) * 0.6


def test_quasibayes_handles_minimize_mode():
    from ray_tpu_torch.tune.search import QuasiBayesSearch
    from ray_tpu_torch.tune.search_space import Uniform
    qb = QuasiBayesSearch({"x": Uniform(0.0, 1.0)}, num_samples=16, seed=3, metric="loss",
                          mode="min", warmup=4)
    best = np.inf
    for i in range(16):
        cfg = qb.suggest(f"t{i}")
        loss = (cfg["x"] - 0.5) ** 2
        qb.on_trial_complete(f"t{i}", {"loss": loss})
        best = min(best, loss)
    assert best < 0.01


# ----------------------------------------------------- factories and entry rules
def test_create_scheduler_and_searcher():
    def made(pkg):
        t = _tune(pkg)
        out = [type(t.create_scheduler(n)).__name__
               for n in ("fifo", "asha", "async_hyperband", "hyperband",
                         "median_stopping_rule", "pbt")]
        with pytest.raises(ValueError, match="unknown scheduler"):
            t.create_scheduler("bogus")
        with pytest.raises(ValueError, match="unknown searcher"):
            t.create_searcher("bogus")
        return out + [t.create_searcher("random"), type(t.create_searcher("quasi_bayes",
                                                        space={})).__name__]
    jax_side, port = _both(made)
    assert port == jax_side and port[1] == "ASHAScheduler" and port[-2] is None


def test_stop_callable_signature_rule_matches_jax():
    """The deterministic half of `test_stop_callable_two_arg_signature` and
    `test_stop_callable_one_required_arg_with_default`: `_build_stopper`
    calls a two-arg stop with (trial_id, result), a stop with one required
    argument with the result, and a dict as thresholds."""
    def built(pkg):
        t = _tune(pkg)
        train = importlib.import_module(f"{pkg}.train")
        seen = []

        def two(trial_id, result):
            seen.append(("two", trial_id))
            return result["i"] >= 2

        def one(result, verbose=False):
            seen.append(("one", sorted(result)))
            return result["i"] >= 1

        out = []
        for stop in (two, one, {"i": 3}):
            tuner = t.Tuner(lambda c: None, run_config=train.RunConfig(name="x", stop=stop))
            s = tuner._build_stopper()
            out.append([s("trial_00000", {"i": i}) for i in range(5)])
        return out, seen
    jax_side, port = _both(built)
    assert port == jax_side
    assert port[0][0] == [False, False, True, True, True] and port[1][0] == ("two",
                                                                              "trial_00000")


def test_class_trainable_resume_continues_iterations(tmp_path):
    """tests/test_tune_run_api.py's last case on both packages: resumed at
    iteration 2 from the sidecar, exactly two more steps, numbered 3, 4."""
    def resumed(pkg):
        session = importlib.import_module(f"{pkg}.train.session")
        checkpoint = importlib.import_module(f"{pkg}.train.checkpoint")
        experiment = importlib.import_module(f"{pkg}.tune.experiment")

        class Ck(experiment.Trainable):
            def step(self):
                return {"v": self.iteration}

            def save_checkpoint(self, d):
                pass

        ckdir = tmp_path / pkg
        ckdir.mkdir()
        (ckdir / "_trainable_meta.json").write_text(json.dumps({"iteration": 2}))
        reported = []
        ctx = session.TrainContext(trial_name="t", trial_id="t", trial_dir=str(tmp_path))
        session.init_session(ctx, checkpoint=checkpoint.Checkpoint(str(ckdir)),
                             report_fn=lambda m, c: reported.append(m))
        try:
            experiment._class_to_function(Ck, max_iters=4)({})
        finally:
            session.shutdown_session()
        return reported
    jax_side, port = _both(resumed)
    assert port == jax_side
    assert [m["training_iteration"] for m in port] == [3, 4]


# ---------------------------------------------------- the actor programs
_RESTORE_SWEEP = """
import time
import {pkg} as ray
from {pkg}.tune import Tuner, TuneConfig
from {pkg}.train import RunConfig

ray.init(num_cpus=2)

def trainable(config):
    from {pkg}.train import session
    for i in range(3):
        time.sleep(config["delay"])
        session.report({{"loss": config["x"] * 10 + i}})

Tuner(trainable,
      param_space={{"x": {{"grid_search": [0, 1, 2, 3, 4, 5]}}, "delay": 0.05}},
      tune_config=TuneConfig(metric="loss", mode="min", num_samples=1,
                             max_concurrent_trials=1),
      run_config=RunConfig(name="exp", storage_path={root!r})).fit()
"""


def _restore_program(pkg, tune, train, root):
    """test_tuner_restore_resumes_sweep: a sweep in a child interpreter is
    killed once two trials finished; Tuner.restore finishes it here."""
    env = dict(os.environ)
    for var in ("RAY_TPU_ARENA", "RAY_TPU_ADDRESS", "RTPT_ARENA", "RTPT_ADDRESS"):
        env.pop(var, None)
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(
        _RESTORE_SWEEP.format(pkg=pkg, root=root))], env=env, stdin=subprocess.DEVNULL,
        start_new_session=True)
    state_path = Path(root) / "exp" / "tuner.json"
    deadline = time.time() + 180
    while time.time() < deadline:
        if state_path.exists():
            st = json.loads(state_path.read_text())
            if sum(t["state"] == "TERMINATED" for t in st["trials"]) >= 2:
                break
        time.sleep(0.2)
    else:
        raise TimeoutError("sweep never reached 2 finished trials")
    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait(timeout=15)
    st = json.loads(state_path.read_text())
    finished = {t["trial_id"]: t["results"] for t in st["trials"] if t["state"] == "TERMINATED"}

    def trainable(config):
        session = importlib.import_module(f"{pkg}.train.session")
        for i in range(3):
            session.report({"loss": config["x"] * 10 + i})

    grid = tune.Tuner.restore(
        str(Path(root) / "exp"), trainable,
        param_space={"x": {"grid_search": [0, 1, 2, 3, 4, 5]}, "delay": 0.05},
        tune_config=tune.TuneConfig(metric="loss", mode="min", num_samples=1,
                                    max_concurrent_trials=2),
        run_config=train.RunConfig(name="exp", storage_path=root)).fit()
    by_id = {r.trial_id: r for r in grid}
    return dict(n=len(by_id), xs=sorted(r.config["x"] for r in grid),
                kept=all(by_id[tid].metrics_history == res for tid, res in finished.items()),
                at_least_two_finished=len(finished) >= 2, errors=len(grid.errors),
                best_x=grid.get_best_result().config["x"],
                losses={str(r.config["x"]): [m["loss"] for m in r.metrics_history]
                        for r in grid})


def _tuner_programs(pkg, root):
    """tests/test_tune.py's runtime cases against `pkg`."""
    tune = _tune(pkg)
    train = importlib.import_module(f"{pkg}.train")
    rc = lambda name, **kw: train.RunConfig(name=name, storage_path=os.path.join(root, name),
                                            **kw)
    out = {}

    def quadratic(config):
        for i in range(8):
            tune.report({"score": -(config["x"] - 3.0) ** 2 - 0.1 * i, "step": i})

    grid = tune.Tuner(quadratic, param_space={"x": tune.grid_search([0.0, 1.5, 3.0, 5.0])},
                      tune_config=tune.TuneConfig(metric="score", mode="max",
                                                  max_concurrent_trials=2),
                      run_config=rc("grid")).fit()
    df = grid.get_dataframe()
    out["tuner_end_to_end"] = dict(
        n=len(grid), errors=len(grid.errors), best_x=grid.get_best_result().config["x"],
        df="config/x" in df.columns and len(df) == 4,
        histories={str(r.config["x"]): [m["score"] for m in r.metrics_history] for r in grid})

    def slow_trainable(config):
        for i in range(1, 13):
            time.sleep(0.05)
            tune.report({"score": config["x"], "training_iteration": i})

    grid = tune.Tuner(slow_trainable, param_space={"x": tune.grid_search([4.0, 1.0])},
                      tune_config=tune.TuneConfig(
                          metric="score", mode="max", max_concurrent_trials=1,
                          scheduler=tune.ASHAScheduler(max_t=12, grace_period=2,
                                                       reduction_factor=2)),
                      run_config=rc("asha")).fit()
    iters = {r.config["x"]: len(r.metrics_history) for r in grid}
    out["tuner_with_asha_culls"] = dict(n=len(grid), best_x=grid.get_best_result().config["x"],
                                        full=iters[4.0], culled=iters[1.0] < 12)

    def ckpt_trainable(config):
        if config["x"] == 99:
            raise RuntimeError("doomed trial")
        for i in range(3):
            tune.report({"score": i}, checkpoint=tune.Checkpoint.from_state({"i": i}))

    grid = tune.Tuner(ckpt_trainable, param_space={"x": tune.grid_search([1, 99])},
                      tune_config=tune.TuneConfig(metric="score", mode="max"),
                      run_config=rc("ck")).fit()
    ok = [r for r in grid if not r.error][0]
    out["tuner_checkpoints_and_errors"] = dict(
        errors=len(grid.errors), doomed="doomed" in grid.errors[0].error,
        state=ok.checkpoint.to_state()["i"], history=[m["score"] for m in ok.metrics_history],
        ckpt_dirs=sorted(p.name for p in Path(ok.path).iterdir() if p.name.startswith("ch")))

    def forever(config):
        i = 0
        while True:
            i += 1
            time.sleep(0.01)
            tune.report({"iters": i, "training_iteration": i})

    grid = tune.Tuner(forever, tune_config=tune.TuneConfig(metric="iters", mode="max"),
                      run_config=rc("stop", stop={"training_iteration": 5})).fit()
    out["tuner_stop_criteria"] = dict(errors=len(grid.errors),
                                      stopped=5 <= grid[0].metrics["training_iteration"] < 500)

    big = np.arange(1000)

    def with_data(config, data=None):
        tune.report({"loss": float(config["x"] + data.sum())})

    grid = tune.Tuner(tune.with_parameters(with_data, data=big),
                      param_space={"x": tune.choice([0, 1])},
                      tune_config=tune.TuneConfig(num_samples=2)).fit()
    want = big.sum()
    out["with_parameters"] = dict(n=len(grid), losses=sorted(r.metrics["loss"] for r in grid),
                                  ok=all(r.metrics["loss"] in (want, want + 1) for r in grid))
    out["tuner_restore"] = _restore_program(pkg, tune, train, os.path.join(root, "restore"))
    return out


def _run_api_programs(pkg, root):
    """tests/test_tune_run_api.py's runtime cases against `pkg` (not its
    three Data cases)."""
    tune = _tune(pkg)
    out = {}

    def trainable(config):
        tune.report({"score": config["x"] * 2})

    a = tune.run(trainable, config={"x": tune.grid_search([1, 3])}, metric="score", mode="max",
                 storage_path=root)
    out["run_function_trainable"] = dict(best=a.best_result["score"], x=a.best_config["x"],
                                         n=len(a.trials), df="score" in a.dataframe().columns)

    class Counter(tune.Trainable):
        def setup(self, config):
            self.base = config.get("base", 0)

        def step(self):
            return {"value": self.base + self.iteration}

    a = tune.run(Counter, config={"base": tune.grid_search([0, 10])},
                 stop={"training_iteration": 3}, metric="value", mode="max", storage_path=root)
    out["run_class_trainable_with_stop"] = dict(
        value=a.best_result["value"], iteration=a.best_result["training_iteration"],
        histories=sorted([m["value"] for m in t.metrics_history] for t in a.trials))

    def registered(config):
        tune.report({"v": 1})

    tune.register_trainable("my_trainable", registered)
    a = tune.run("my_trainable", metric="v", mode="max", storage_path=root)
    try:
        tune.run("nope", metric="v")
        unknown = None
    except ValueError as e:
        unknown = "unknown trainable" in str(e)
    import gymnasium as gym
    made = []

    def creator(env_config):
        made.append(env_config)
        return gym.make("CartPole-v1")

    tune.register_env("my_cartpole", creator)
    env_runner = importlib.import_module(f"{pkg}.rllib.env_runner")
    r = env_runner.EnvRunner("my_cartpole", num_envs=1, rollout_len=8,
                             env_config={"difficulty": 2})
    r.set_weights(r.init_params())
    batch = r.sample()
    out["registered_trainable_and_env"] = dict(v=a.best_result["v"], unknown=unknown,
                                               made=made[:1], obs=len(batch["obs"]))

    def remote_creator(env_config):
        assert env_config.get("tag") == "remote"
        return gym.make("CartPole-v1")

    tune.register_env("remote_cartpole", remote_creator)
    rllib = importlib.import_module(f"{pkg}.rllib")
    algo = (rllib.PPOConfig().environment("remote_cartpole", env_config={"tag": "remote"})
            .env_runners(num_env_runners=1, num_envs_per_env_runner=1,
                         rollout_fragment_length=16)
            .training(train_batch_size=16, minibatch_size=16, num_epochs=1)
            .resources(device="cpu").build())
    try:
        result = algo.train()
        out["registered_env_reaches_remote_runners"] = dict(
            sampled=result["num_env_steps_sampled_this_iter"], remote=len(algo._runner_handles))
    finally:
        algo.stop()

    runs = []
    for _ in range(STOP_REPEATS):
        def counting(config):
            for i in range(10):
                tune.report({"i": i})

        seen = []

        def stop(trial_id, result):
            seen.append(trial_id)
            return result["i"] >= 2

        a = tune.run(counting, stop=stop, metric="i", mode="max", storage_path=root)
        runs.append(dict(seen=bool(seen), ids=sorted(set(seen)), best=a.best_result["i"],
                         n=len(a.trials[0].metrics_history),
                         errors=len(a.grid.errors)))
    out["stop_callable_two_arg_signature"] = runs

    def shared(config):
        tune.report({"v": 1})

    tune.register_trainable("shared_t", shared)
    tune.run("shared_t", metric="v", mode="max", resources_per_trial={"cpu": 1},
             storage_path=root)
    out["resources_per_trial_does_not_leak_to_registered"] = not hasattr(shared,
                                                                         "_tune_resources")

    class Ck(tune.Trainable):
        def step(self):
            return {"v": self.iteration}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"iteration": self.iteration}, f)

    a = tune.run(Ck, stop={"training_iteration": 4}, checkpoint_freq=2, metric="v",
                 mode="max", storage_path=root)
    ck = a.best_checkpoint
    out["class_trainable_checkpoints"] = dict(
        has=ck is not None,
        iteration=json.load(open(os.path.join(ck.path, "state.json")))["iteration"])

    def six(config):
        for i in range(6):
            tune.report({"i": i})

    def stop_one(result, verbose=False):
        return result["i"] >= 1

    a = tune.run(six, stop=stop_one, metric="i", mode="max", storage_path=root)
    out["stop_callable_one_required_arg_with_default"] = dict(
        best_at_most_5=a.best_result["i"] <= 5, errors=len(a.grid.errors))
    return out


def _gpu_program(tune, train, rt, root):
    """The port's trial claims "GPU": two trials at once, each actor's
    CUDA_VISIBLE_DEVICES its get_gpu_ids(); then a num_gpus=2 actor starts
    (both cards came back)."""
    def where(config):
        tune.report({"ids": rt.get_gpu_ids(), "vis": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "pid": os.getpid()})

    grid = tune.Tuner(tune.with_resources(where, {"cpu": 1, "gpu": 1}),
                      param_space={"x": tune.grid_search([0, 1])},
                      tune_config=tune.TuneConfig(max_concurrent_trials=2),
                      run_config=train.RunConfig(name="gpu", storage_path=root)).fit()
    seen = sorted((r.metrics["ids"], r.metrics["vis"]) for r in grid)

    @rt.remote(num_gpus=2)
    class Both:
        def ids(self):
            return rt.get_gpu_ids()

    both = Both.remote()
    back = rt.get(both.ids.remote(), timeout=120)
    rt.kill(both)
    return dict(seen=seen, back=back, errors=len(grid.errors))


def _scenario(pkg, part, root):
    rt = importlib.import_module(pkg)
    if pkg == "ray_tpu":
        rt.init(num_cpus=4)
    else:
        rt.init(num_cpus=4, num_gpus=2)
    try:
        if part == "tuner":
            out = _tuner_programs(pkg, root)
            if pkg == "ray_tpu_torch":
                out["gpu_trials"] = _gpu_program(_tune(pkg), importlib.import_module(
                    f"{pkg}.train"), rt, root)
        else:
            out = _run_api_programs(pkg, root)
    finally:
        rt.shutdown()
    return out


def _spawn(pkg, part, root):
    env = dict(os.environ, JAX_PLATFORMS="cpu", RAY_TPU_NUM_CHIPS="0")
    for var in ("RAY_TPU_ARENA", "RAY_TPU_ADDRESS", "RTPT_ARENA", "RTPT_ADDRESS"):
        env.pop(var, None)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    code = (f"import json, test_torch_tune as m; "
            f"print(json.dumps(m._scenario({pkg!r}, {part!r}, {root!r}), default=float))")
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(REPO))


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """Both packages' two scenarios in interpreters of their own, all four
    at once."""
    procs = {}
    for pkg in PACKAGES:
        for part in ("tuner", "run_api"):
            root = str(tmp_path_factory.mktemp(f"{pkg}_{part}"))
            procs[(pkg, part)] = _spawn(pkg, part, root)
    got = {}
    for key, p in procs.items():
        out, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-4000:]
        got[key] = json.loads(out.strip().splitlines()[-1])
    return {pkg: {**got[(pkg, "tuner")], **got[(pkg, "run_api")]} for pkg in PACKAGES}


def _steady(key, reading):
    """A reading without its timing-dependent parts."""
    if key == "tuner_with_asha_culls":
        return {k: v for k, v in reading.items() if k != "culled"}
    return reading


@pytest.mark.parametrize("key", [
    "tuner_end_to_end", "tuner_with_asha_culls", "tuner_checkpoints_and_errors",
    "tuner_stop_criteria", "with_parameters", "tuner_restore", "run_function_trainable",
    "run_class_trainable_with_stop", "registered_trainable_and_env",
    "registered_env_reaches_remote_runners", "resources_per_trial_does_not_leak_to_registered",
    "class_trainable_checkpoints", "stop_callable_one_required_arg_with_default"])
def test_program_matches_ray_tpu(readings, key):
    """The same program gives the same reading on both runtimes (ASHA's
    cull of the weak trial is timed, and held below)."""
    assert _steady(key, readings["ray_tpu_torch"][key]) == _steady(key, readings["ray_tpu"][key])


def test_readings_hold_jax_assertions(readings):
    got = readings["ray_tpu_torch"]
    e2e = got["tuner_end_to_end"]
    assert e2e["n"] == 4 and e2e["errors"] == 0 and e2e["best_x"] == 3.0 and e2e["df"]
    asha = got["tuner_with_asha_culls"]
    assert asha["n"] == 2 and asha["best_x"] == 4.0 and asha["full"] == 12 and asha["culled"]
    ck = got["tuner_checkpoints_and_errors"]
    assert ck["errors"] == 1 and ck["doomed"] and ck["state"] == 2
    assert got["tuner_stop_criteria"] == {"errors": 0, "stopped": True}
    assert got["with_parameters"]["n"] == 2 and got["with_parameters"]["ok"]
    rs = got["tuner_restore"]
    assert rs["n"] == 6 and rs["xs"] == [0, 1, 2, 3, 4, 5] and rs["kept"]
    assert rs["at_least_two_finished"] and rs["errors"] == 0 and rs["best_x"] == 0
    assert got["run_function_trainable"] == {"best": 6, "x": 3, "n": 2, "df": True}
    assert got["run_class_trainable_with_stop"]["value"] == 12
    assert got["run_class_trainable_with_stop"]["iteration"] == 3
    reg = got["registered_trainable_and_env"]
    assert reg == {"v": 1, "unknown": True, "made": [{"difficulty": 2}], "obs": 8}
    assert got["registered_env_reaches_remote_runners"]["sampled"] > 0
    assert got["resources_per_trial_does_not_leak_to_registered"]
    assert got["class_trainable_checkpoints"]["has"]
    assert got["class_trainable_checkpoints"]["iteration"] in (2, 4)
    assert got["stop_callable_one_required_arg_with_default"]["best_at_most_5"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_stop_callable_two_arg_signature_over_repeated_runs(readings, pkg):
    """JAX's case is unsteady: the stop callable sees a result only when
    the driver's poll fetches one before the trial ends (the final drain
    applies no stopper). So each run of each package holds what every run
    gives: no error, the best `i` at most 9, and whatever the stop saw
    was (trial_id, result) for the sweep's one trial; each package's runs
    are reported side by side."""
    runs = readings[pkg]["stop_callable_two_arg_signature"]
    assert len(runs) == STOP_REPEATS
    for r in runs:
        assert r["errors"] == 0 and r["best"] <= 9 and r["n"] <= 10
        assert r["ids"] in ([], ["trial_00000"]) and r["seen"] == bool(r["ids"])
    print(pkg, [r["seen"] for r in runs], [r["n"] for r in runs])


def test_gpu_trials_claim_their_cards(readings):
    """The port's trials under `with_resources({"gpu": 1})`: two at once on
    the two "GPU"s, each actor's CUDA_VISIBLE_DEVICES its get_gpu_ids();
    both cards back afterwards."""
    g = readings["ray_tpu_torch"]["gpu_trials"]
    assert g["errors"] == 0 and g["seen"] == [[[0], "0"], [[1], "1"]]
    assert sorted(g["back"]) == [0, 1]
