"""Legacy tune entrypoints, the port's copy of `ray_tpu.tune.experiment`
(reference: python/ray/tune/tune.py run(),
tune/trainable/trainable.py Trainable, tune/analysis ExperimentAnalysis).

`tune.run` is the API most published RL/tuning code calls; here it is a
thin adapter onto the Tuner/ResultGrid machinery (one driver loop, not
two): function trainables pass through; class (Trainable) and registered-
name trainables are wrapped into the function form with a driver-side
step loop feeding session.report.
"""

from typing import Any, Callable, Dict, Optional, Union

from .registry import get_trainable
from .tuner import ResultGrid, TuneConfig, Tuner

__all__ = ["Trainable", "ExperimentAnalysis", "run", "create_scheduler",
           "create_searcher"]


class Trainable:
    """Class-API trainable: override setup/step (ref:
    tune/trainable/trainable.py; save/load hooks optional)."""

    def __init__(self, config: Optional[Dict] = None):
        self.config = dict(config or {})
        self.iteration = 0
        self.setup(self.config)

    # -- overridable hooks ---------------------------------------------------
    def setup(self, config: Dict) -> None:
        pass

    def step(self) -> Dict:
        raise NotImplementedError("Trainable subclasses implement step()")

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- driver API ----------------------------------------------------------
    def train(self) -> Dict:
        result = self.step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    def stop(self) -> None:
        self.cleanup()


def _class_to_function(cls, max_iters: int,
                       checkpoint_freq: int = 0) -> Callable:
    """Wrap a Trainable class into the function-trainable contract: a
    step loop reporting each result, honoring session stop requests via
    report() raising TrainingStopped. With checkpoint_freq>0 the class's
    save_checkpoint hook runs every N iterations (and load_checkpoint on
    resume), so class trainables checkpoint exactly like function ones."""
    _META = "_trainable_meta.json"

    def fn(config):
        import json
        import os
        import tempfile

        from ray_tpu_torch.train.session import get_checkpoint, report
        t = cls(config)
        start = get_checkpoint()
        if start is not None:
            t.load_checkpoint(start.path)
            # restore the iteration counter alongside user state, so a
            # resumed trial CONTINUES its training_iteration sequence and
            # loop budget instead of rewinding to 1 (schedulers would see
            # duplicate iterations and the stop criterion would overrun)
            meta = os.path.join(start.path, _META)
            if os.path.exists(meta):
                with open(meta) as f:
                    t.iteration = int(json.load(f)["iteration"])
        try:
            for i in range(t.iteration, max_iters):
                result = t.train()
                if checkpoint_freq and (i + 1) % checkpoint_freq == 0:
                    from ray_tpu_torch.train.checkpoint import Checkpoint
                    with tempfile.TemporaryDirectory() as d:
                        t.save_checkpoint(d)
                        with open(os.path.join(d, _META), "w") as f:
                            json.dump({"iteration": t.iteration}, f)
                        report(result, checkpoint=Checkpoint.from_directory(d))
                else:
                    report(result)
        finally:
            t.stop()
    if hasattr(cls, "_tune_resources"):
        fn._tune_resources = cls._tune_resources
    return fn


class ExperimentAnalysis:
    """Result view for tune.run (ref: tune/analysis/experiment_analysis.py)
    — wraps the ResultGrid with the names legacy call sites read."""

    def __init__(self, grid: ResultGrid, metric, mode):
        self.grid = grid
        self._metric = metric
        self._mode = mode

    @property
    def trials(self):
        return list(self.grid)

    @property
    def best_result(self) -> Dict:
        return self.grid.get_best_result(self._metric, self._mode).metrics

    @property
    def best_config(self) -> Dict:
        return self.grid.get_best_result(self._metric, self._mode).config

    @property
    def best_checkpoint(self):
        return self.grid.get_best_result(self._metric, self._mode).checkpoint

    def dataframe(self):
        return self.grid.get_dataframe()


def run(run_or_experiment: Union[str, Callable, type], *,
        config: Optional[Dict] = None, num_samples: int = 1,
        stop: Optional[Union[Dict, Callable]] = None,
        metric: Optional[str] = None, mode: str = "max",
        scheduler=None, search_alg=None, name: Optional[str] = None,
        storage_path: Optional[str] = None, max_concurrent_trials: int = 4,
        resources_per_trial: Optional[Dict] = None,
        checkpoint_freq: int = 0,
        _max_class_iters: int = 1000, **_compat) -> ExperimentAnalysis:
    """Drop-in tune.run (ref: python/ray/tune/tune.py run). Accepts a
    function trainable, a Trainable subclass, or a register_trainable'd
    name; unrecognized legacy kwargs are accepted and ignored."""
    from ray_tpu_torch.train.config import RunConfig

    trainable = run_or_experiment
    if isinstance(trainable, str):
        trainable = get_trainable(trainable)
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        # class API: a stop dict caps the step loop; otherwise the safety
        # cap _max_class_iters bounds it (the reference requires a stopper
        # for class trainables too)
        iters = _max_class_iters
        if isinstance(stop, dict) and "training_iteration" in stop:
            iters = int(stop["training_iteration"])
        trainable = _class_to_function(trainable, iters,
                                       checkpoint_freq=checkpoint_freq)
    if resources_per_trial:
        # wrap, never mutate: setting the attr on a registered/shared
        # trainable would leak resources into unrelated tune.run calls
        import functools
        inner = trainable

        @functools.wraps(inner)
        def trainable(config):  # noqa: F811 - deliberate rebind
            return inner(config)
        trainable._tune_resources = dict(resources_per_trial)

    rc_kwargs: Dict[str, Any] = {"name": name or "tune_run"}
    if storage_path:
        rc_kwargs["storage_path"] = storage_path
    if stop is not None:
        rc_kwargs["stop"] = stop
    grid = Tuner(
        trainable,
        param_space=config or {},
        tune_config=TuneConfig(metric=metric, mode=mode,
                               num_samples=num_samples,
                               max_concurrent_trials=max_concurrent_trials,
                               scheduler=scheduler, search_alg=search_alg),
        run_config=RunConfig(**rc_kwargs),
    ).fit()
    return ExperimentAnalysis(grid, metric, mode)


def create_scheduler(name: str, **kwargs):
    """Scheduler factory by name (ref: tune/schedulers/__init__.py
    create_scheduler)."""
    from . import schedulers as S
    table = {"fifo": S.FIFOScheduler, "asha": S.ASHAScheduler,
             "async_hyperband": S.ASHAScheduler,
             "hyperband": S.HyperBandScheduler,
             "median_stopping_rule": S.MedianStoppingRule,
             "pbt": S.PopulationBasedTraining}
    if name not in table:
        raise ValueError(f"unknown scheduler {name!r} (known: "
                         f"{sorted(table)})")
    return table[name](**kwargs)


def create_searcher(name: str, **kwargs):
    """Searcher factory by name (ref: tune/search/__init__.py
    create_searcher)."""
    from . import search as S
    table = {"random": None, "variant_generator": None,
             "quasi_bayes": S.QuasiBayesSearch}
    if name not in table:
        raise ValueError(f"unknown searcher {name!r} (known: "
                         f"{sorted(table)})")
    cls = table[name]
    return None if cls is None else cls(**kwargs)
