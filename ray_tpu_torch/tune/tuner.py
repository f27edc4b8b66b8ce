"""Tuner — trial driver loop: the port's copy of `ray_tpu.tune.tuner`
(reference: python/ray/tune/tuner.py + tune/execution/tune_controller.py).

Trials run as actors of the port's runtime so they hold resources
(num_cpus/num_gpus) and stream intermediate results back for scheduler
decisions (ASHA culls, PBT exploits) while running. `with_resources(fn,
{"gpu": n})` (or `"GPU"`) claims `num_gpus=n` for each trial's actor, where
JAX's claims `num_tpus` from `"tpu"`; the runtime binds the actor's cards
(`CUDA_VISIBLE_DEVICES` is its `get_gpu_ids()`) and truncates a fractional
count with `int()`, as JAX's controller does.
"""

import dataclasses
import os
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.train.config import RunConfig
from .schedulers import (CONTINUE, FIFOScheduler, PBTDecision, STOP,
                         TrialScheduler)
from .search import BasicVariantGenerator, Searcher
from .stopper import Stopper

if TYPE_CHECKING:   # loaded where a checkpoint is made: it needs torch
    from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    seed: int = 0


@dataclasses.dataclass
class TrialResult:
    """One trial's outcome (rendered in ResultGrid; reference: air.Result)."""
    trial_id: str
    config: Dict[str, Any]
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional["Checkpoint"]
    error: Optional[str]
    metrics_history: List[Dict] = dataclasses.field(default_factory=list)
    path: str = ""


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric, mode):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> TrialResult:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self):
        return [r for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        sign = 1 if mode == "max" else -1
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return max(scored, key=lambda r: sign * r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for r in self._results:
            row = dict(r.metrics or {})
            row.update({f"config/{k}": v for k, v in r.config.items()})
            row["trial_id"] = r.trial_id
            rows.append(row)
        return pd.DataFrame(rows)


class _TrialRunner:
    """Actor hosting one trial's train loop; results buffer for polling."""

    def __init__(self):
        self._results: List[Dict] = []
        self._session = None
        self._ckpt_dirs: List[Optional[str]] = []

    def run(self, fn, config, trial_id: str, trial_dir: str,
            resume_from: Optional[str] = None):
        import shutil

        from ray_tpu_torch.train import session as _session

        os.makedirs(trial_dir, exist_ok=True)
        counter = [0]

        def report_fn(metrics, ckpt):
            metrics.setdefault("training_iteration", len(self._results) + 1)
            path = None
            if ckpt is not None:
                path = os.path.join(trial_dir,
                                    f"checkpoint_{counter[0]:06d}")
                counter[0] += 1
                if os.path.abspath(ckpt.path) != os.path.abspath(path):
                    if os.path.exists(path):
                        shutil.rmtree(path)
                    shutil.copytree(ckpt.path, path)
            self._results.append(dict(metrics))
            self._ckpt_dirs.append(path)

        ctx = _session.TrainContext(trial_name=trial_id, trial_id=trial_id,
                                    trial_dir=trial_dir)
        start_ckpt = None
        if resume_from:
            from ray_tpu_torch.train.checkpoint import Checkpoint as Ckpt
            start_ckpt = Ckpt.from_directory(resume_from)
        self._session = _session.init_session(ctx, checkpoint=start_ckpt,
                                              report_fn=report_fn)
        try:
            fn(config)
            return {"status": "done"}
        except _session.TrainingStopped:
            return {"status": "stopped"}
        finally:
            _session.shutdown_session()

    def fetch_new(self, cursor: int):
        return self._results[cursor:], self._ckpt_dirs[cursor:]

    def request_stop(self):
        if self._session is not None:
            self._session.stop_requested = True
        return True


@dataclasses.dataclass
class _Trial:
    trial_id: str
    config: Dict
    actor: Any = None
    run_ref: Any = None
    cursor: int = 0
    state: str = "PENDING"
    results: List[Dict] = dataclasses.field(default_factory=list)
    last_ckpt_dir: Optional[str] = None
    error: Optional[str] = None
    resume_from: Optional[str] = None
    dir: str = ""


def with_resources(trainable: Callable, resources: Dict[str, float]):
    trainable._tune_resources = dict(resources)
    return trainable


def with_parameters(trainable: Callable, **kwargs):
    """Bind large constant objects to a trainable (ref:
    python/ray/tune/trainable/util.py with_parameters): the objects go to
    the object store ONCE; every trial's wrapper pulls them by ref instead
    of re-pickling them into each trial actor's creation spec. A CUDA
    tensor among them lands on the trial's first card (the store's rule)."""
    import functools

    import ray_tpu_torch as rt
    refs = {k: rt.put(v) for k, v in kwargs.items()}

    @functools.wraps(trainable)
    def wrapped(config):
        resolved = {k: rt.get(r) for k, r in refs.items()}
        return trainable(config, **resolved)

    if hasattr(trainable, "_tune_resources"):
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


class TuneError(RuntimeError):
    """Raised for tune-level failures (ref: ray.tune.TuneError)."""


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: Optional[Dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig(name="tune")
        self._restore_state: Optional[Dict] = None

    @classmethod
    def restore(cls, path: str, trainable: Callable, *,
                param_space: Optional[Dict] = None,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None) -> "Tuner":
        """Resume a crashed/killed sweep from its experiment directory
        (reference: python/ray/tune/tuner.py:135 Tuner.restore). Finished
        trials are kept as-is; trials that were in flight re-run (from
        their last checkpoint when one exists); the remaining sample budget
        continues. The searcher is replayed deterministically — seeded
        searchers reproduce their suggestion stream exactly.

        `fit()` journals experiment state to `<experiment_dir>/tuner.json`
        continuously, so restore works after any interruption."""
        import json
        state_path = os.path.join(path, "tuner.json")
        with open(state_path) as f:
            state = json.load(f)
        rc = run_config or RunConfig(name=os.path.basename(path.rstrip("/")),
                                     storage_path=os.path.dirname(
                                         path.rstrip("/")))
        tuner = cls(trainable, param_space=param_space,
                    tune_config=tune_config, run_config=rc)
        tuner._restore_state = state
        return tuner

    @staticmethod
    def can_restore(path: str) -> bool:
        return os.path.exists(os.path.join(path, "tuner.json"))

    def fit(self) -> ResultGrid:
        import ray_tpu_torch as rt
        if not rt.is_initialized():
            rt.init()
        tc = self.tune_config
        metric = tc.metric
        mode = tc.mode
        searcher = tc.search_alg or BasicVariantGenerator(
            self.param_space, tc.num_samples, seed=tc.seed)
        scheduler = tc.scheduler or FIFOScheduler()
        if metric:
            scheduler.set_properties(metric, mode)
        stopper = self._build_stopper()
        exp_dir = self.run_config.experiment_dir()

        res_opts = getattr(self.trainable, "_tune_resources", {"cpu": 1})
        actor_opts = {"num_cpus": res_opts.get("cpu", res_opts.get("CPU", 1)),
                      "max_concurrency": 4}
        if res_opts.get("gpu") or res_opts.get("GPU"):
            actor_opts["num_gpus"] = res_opts.get("gpu", res_opts.get("GPU"))
        RunnerActor = rt.remote(**actor_opts)(_TrialRunner)

        trials: List[_Trial] = []
        exhausted = False
        counter = [0]

        def launch(config: Dict, resume_from=None, id_suffix="",
                   tid: Optional[str] = None) -> _Trial:
            if tid is None:
                tid = f"trial_{counter[0]:05d}{id_suffix}"
                counter[0] += 1
            t = _Trial(trial_id=tid, config=config,
                       dir=os.path.join(exp_dir, tid),
                       resume_from=resume_from)
            t.actor = RunnerActor.remote()
            t.run_ref = t.actor.run.remote(
                self.trainable, config, tid, t.dir, resume_from)
            t.state = "RUNNING"
            if hasattr(scheduler, "register"):  # PBT tracks configs
                scheduler.register(tid, config)
            trials.append(t)
            return t

        _last_save = [0.0]

        def save_state(force: bool = False):
            """Journal the experiment (atomic rewrite, throttled to ~1 Hz —
            rewriting full history at poll rate would dominate the loop) so
            Tuner.restore can resume after a crash (ref: tune experiment
            checkpointing)."""
            import json
            now = time.monotonic()
            if not force and now - _last_save[0] < 1.0:
                return
            _last_save[0] = now
            import cloudpickle
            recs = []
            for t in trials:
                recs.append({
                    "trial_id": t.trial_id, "config": t.config,
                    # configs must round-trip EXACTLY (numpy scalars, tuples
                    # — default=str would silently corrupt a restored run)
                    "config_pkl": cloudpickle.dumps(t.config).hex(),
                    "state": t.state, "results": t.results,
                    "last_ckpt_dir": t.last_ckpt_dir, "error": t.error,
                    "resume_from": t.resume_from,
                })
            blob = json.dumps({"counter": counter[0], "trials": recs,
                               "exhausted": exhausted}, default=repr)
            tmp = os.path.join(exp_dir, "tuner.json.tmp")
            os.makedirs(exp_dir, exist_ok=True)
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, os.path.join(exp_dir, "tuner.json"))

        pending_restore: List[_Trial] = []
        if self._restore_state is not None:
            # Replay the journal in suggestion order: the searcher re-sees
            # suggest (+complete for finished trials), so seeded suggestion
            # streams stay aligned; the journaled config is the truth either
            # way. PBT-exploit trials (id suffix _pbt) never consumed a
            # suggestion originally, so they are not replayed through the
            # searcher. Unfinished trials relaunch from their last
            # checkpoint — via the MAIN loop, under max_concurrent_trials.
            import cloudpickle as _cp
            for rec in self._restore_state["trials"]:
                if rec.get("config_pkl"):  # exact round-trip (numpy/tuples)
                    rec = {**rec,
                           "config": _cp.loads(bytes.fromhex(rec["config_pkl"]))}
                if not rec["trial_id"].endswith("_pbt"):
                    searcher.suggest(rec["trial_id"])  # advance the stream
                if rec["state"] in ("TERMINATED", "ERROR"):
                    t = _Trial(trial_id=rec["trial_id"], config=rec["config"],
                               state=rec["state"],
                               dir=os.path.join(exp_dir, rec["trial_id"]))
                    t.results = list(rec["results"])
                    t.last_ckpt_dir = rec["last_ckpt_dir"]
                    t.error = rec["error"]
                    trials.append(t)
                    searcher.on_trial_complete(
                        t.trial_id, t.results[-1] if t.results else None)
                else:
                    t = _Trial(trial_id=rec["trial_id"], config=rec["config"],
                               dir=os.path.join(exp_dir, rec["trial_id"]),
                               resume_from=rec["last_ckpt_dir"])
                    pending_restore.append(t)
            counter[0] = max(counter[0], self._restore_state["counter"])

        def limited(s) -> bool:
            """ConcurrencyLimiter backpressure (None ≠ exhausted)."""
            return (hasattr(s, "max_concurrent")
                    and len(getattr(s, "_live", ())) >= s.max_concurrent)

        while True:
            running = [t for t in trials if t.state == "RUNNING"]
            # restored in-flight trials relaunch first, under the same cap
            while pending_restore and len(running) < tc.max_concurrent_trials:
                t = pending_restore.pop(0)
                launch(t.config, resume_from=t.resume_from, tid=t.trial_id)
                running = [t for t in trials if t.state == "RUNNING"]
            # launch new trials up to the concurrency cap
            while (not exhausted and not pending_restore
                   and len(running) < tc.max_concurrent_trials):
                cfg = searcher.suggest(f"trial_{counter[0]:05d}")
                if cfg is None:
                    if limited(searcher):
                        break  # retry next loop once a trial completes
                    exhausted = True
                    break
                launch(cfg)
                running = [t for t in trials if t.state == "RUNNING"]

            if (not running and not pending_restore
                    and (exhausted or not any(
                        t.state == "PENDING" for t in trials))):
                break

            # poll running trials
            for t in running:
                try:
                    new, ckpts = rt.get(
                        t.actor.fetch_new.remote(t.cursor), timeout=30)
                except Exception as e:  # noqa: BLE001 - actor died
                    t.state = "ERROR"
                    t.error = str(e)
                    # release the searcher slot (ConcurrencyLimiter) and the
                    # actor's resources, or fit() stops launching trials
                    searcher.on_trial_complete(
                        t.trial_id, t.results[-1] if t.results else None)
                    try:
                        rt.kill(t.actor)
                    except Exception:  # noqa: BLE001
                        pass
                    continue
                t.cursor += len(new)
                for result, ckpt_dir in zip(new, ckpts):
                    t.results.append(result)
                    if ckpt_dir:
                        t.last_ckpt_dir = ckpt_dir
                    decision = scheduler.on_result(t.trial_id, result) \
                        if (metric and metric in result) else CONTINUE
                    if isinstance(decision, PBTDecision):
                        src = next((x for x in trials
                                    if x.trial_id == decision.source_trial), None)
                        rt.get(t.actor.request_stop.remote())
                        if src is not None and src.last_ckpt_dir:
                            launch(decision.new_config,
                                   resume_from=src.last_ckpt_dir,
                                   id_suffix="_pbt")
                    elif decision == STOP:
                        rt.get(t.actor.request_stop.remote())
                    if stopper is not None and stopper(t.trial_id, result):
                        rt.get(t.actor.request_stop.remote())
                # completion check
                done, _ = rt.wait([t.run_ref], timeout=0)
                if done:
                    try:
                        rt.get(t.run_ref)
                        t.state = "TERMINATED"
                    except Exception as e:  # noqa: BLE001 - trainable raised
                        t.state = "ERROR"
                        t.error = str(e)
                    # final drain: results reported between the fetch above
                    # and completion would be lost once the actor dies
                    try:
                        new, ckpts = rt.get(
                            t.actor.fetch_new.remote(t.cursor), timeout=30)
                        t.cursor += len(new)
                        t.results.extend(new)
                        for c in ckpts:
                            if c:
                                t.last_ckpt_dir = c
                    except Exception:  # noqa: BLE001 - actor already gone
                        pass
                    searcher.on_trial_complete(
                        t.trial_id, t.results[-1] if t.results else None)
                    try:
                        rt.kill(t.actor)
                    except Exception:  # noqa: BLE001
                        pass
            save_state()
            time.sleep(0.02)

        save_state(force=True)
        from ray_tpu_torch.train.checkpoint import Checkpoint
        results = [
            TrialResult(
                trial_id=t.trial_id, config=t.config,
                metrics=t.results[-1] if t.results else None,
                checkpoint=(Checkpoint.from_directory(t.last_ckpt_dir)
                            if t.last_ckpt_dir else None),
                error=t.error, metrics_history=t.results, path=t.dir)
            for t in trials]
        return ResultGrid(results, metric, mode)

    def _build_stopper(self) -> Optional[Stopper]:
        stop = self.run_config.stop
        if stop is None:
            return None
        if isinstance(stop, Stopper):
            return stop
        if callable(stop):
            import inspect

            from .stopper import FunctionStopper
            # both stop signatures exist in the wild: the reference's
            # stop(trial_id, result) and the bare stop(result)
            try:
                required = [p for p in
                            inspect.signature(stop).parameters.values()
                            if p.default is inspect.Parameter.empty
                            and p.kind in (p.POSITIONAL_ONLY,
                                           p.POSITIONAL_OR_KEYWORD)]
                # only REQUIRED positionals count: stop(result,
                # verbose=False) is a one-arg stopper
                two_arg = len(required) >= 2
            except (TypeError, ValueError):
                two_arg = False
            return FunctionStopper(stop if two_arg
                                   else (lambda tid, r: stop(r)))
        if isinstance(stop, dict):
            crit = dict(stop)

            from .stopper import FunctionStopper

            def check(tid, r):
                return any(k in r and r[k] >= v for k, v in crit.items())

            return FunctionStopper(check)
        raise TypeError(f"unsupported stop criteria {stop!r}")


