"""Hyperparameter tuning: the port's copy of `ray_tpu.tune` (reference:
python/ray/tune), on the port's runtime.

Trials run as resource-holding actors of `ray_tpu_torch` streaming results
to the driver loop; schedulers (ASHA/HyperBand/median/PBT) act on
intermediate results. `tune.report` is the same session API as
`train.report`. A trial claims cards with `with_resources({"gpu": n})`
(or `"GPU"`): its actor gets `num_gpus=n`, and its `CUDA_VISIBLE_DEVICES`
names the cards `get_gpu_ids()` returns. Search spaces, searchers and PBT
draw from `np.random.Generator` in JAX's order, so one seed gives the
same configs in both packages. Imports numpy and the port's `train`
configs and session only (pandas inside `ResultGrid.get_dataframe`):
`Checkpoint` and `Result`, which need torch, load on first use, so a trial
actor that only reports starts without torch. The runtime loads when a
sweep starts.
"""

from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig
from ray_tpu_torch.train.session import get_checkpoint, get_context, report
from .schedulers import (ASHAScheduler, FIFOScheduler, HyperBandScheduler,
                         MedianStoppingRule, PopulationBasedTraining,
                         TrialScheduler)
from .search import (BasicVariantGenerator, ConcurrencyLimiter,
                     QuasiBayesSearch, Searcher)
from .search_space import (choice, grid_search, lograndint, loguniform,
                           qlograndint, qloguniform, qrandint, qrandn,
                           quniform, randint, randn, sample_from, uniform)
from .stopper import (CombinedStopper, FunctionStopper,
                      MaximumIterationStopper, Stopper, TrialPlateauStopper)
from .experiment import (ExperimentAnalysis, Trainable,
                         create_scheduler, create_searcher, run)
from .registry import register_env, register_trainable
from .tuner import (ResultGrid, TrialResult, TuneConfig, TuneError,
                    Tuner, with_parameters, with_resources)

__all__ = [
    "Tuner", "TuneConfig", "TuneError", "ResultGrid", "TrialResult",
    "with_resources", "with_parameters", "Checkpoint", "CheckpointConfig",
    "run", "Trainable", "ExperimentAnalysis", "register_env",
    "register_trainable", "create_scheduler", "create_searcher",
    "FailureConfig", "Result", "RunConfig",
    "report", "get_checkpoint", "get_context",
    "choice", "uniform", "quniform", "loguniform", "qloguniform",
    "randint", "qrandint", "lograndint", "qlograndint", "randn", "qrandn",
    "sample_from", "grid_search",
    "BasicVariantGenerator", "ConcurrencyLimiter", "QuasiBayesSearch",
    "Searcher", "TrialScheduler", "FIFOScheduler", "ASHAScheduler",
    "HyperBandScheduler", "MedianStoppingRule", "PopulationBasedTraining",
    "Stopper", "MaximumIterationStopper", "TrialPlateauStopper",
    "FunctionStopper", "CombinedStopper",
]


def __getattr__(name):
    if name in ("Checkpoint", "Result"):
        from ray_tpu_torch import train
        value = getattr(train, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'ray_tpu_torch.tune' has no attribute '{name}'")
