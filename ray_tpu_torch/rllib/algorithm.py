"""AlgorithmConfig and the Algorithm base: the port's counterpart of
`ray_tpu/rllib/algorithm.py` (reference: rllib/algorithms/algorithm_config.py
and algorithm.py).

The same builder API (`config.environment(...).training(...).env_runners(...)`)
and `algo.train()` loop: collect on an inline EnvRunner (host CPU), learn
on the learner's device, `config.resources(device=...)`, "cuda" by
default. JAX's `.resources(**_)` accepts that keyword and ignores it, so
one builder chain configures both packages.

Remote env runners (`num_env_runners > 0`), evaluation actors and the
sebulba pipeline schedule `ray_tpu` actors: the port does not copy the
runtime, so they raise `NotImplementedError` here (ROADMAP §C). The
port's `EnvRunner` and `RolloutActor` are plain objects that
`ray_tpu.remote` makes actors. The pipeline is composed instead: build
the algorithm with `.sebulba(enabled=False, ...)` and its `sebulba_*`
fields set, and hand it to `ray_tpu.rllib.sebulba.SebulbaPipeline`,
which reads the hooks JAX's reads (`_supports_sebulba`,
`_make_runner_kwargs`, `_sebulba_update`, `get_weights`,
`learner.jit_cache_size`).
"""

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Type, Union

import numpy as np

from ray_tpu_torch.train.checkpoint import Checkpoint
from .env_runner import EnvRunner, host_env_runner, resolve_env_creator
from .sample_batch import SampleBatch

_RUNTIME = ("runs ray_tpu actors, runtime code the port does not copy (ROADMAP.md §C): "
            "compose ray_tpu's actors with the port's EnvRunner instead")


class AlgorithmConfig:
    algo_class: Optional[Type["Algorithm"]] = None

    def __init__(self):
        # environment
        self.env: Union[str, Callable, None] = None
        self.env_config: Dict = {}
        # env runners
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 1
        self.rollout_fragment_length = 200
        self.explore = True
        self.env_runner_scheduling_strategy = None
        self.env_runner_resources: Dict = {}
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 1
        self.grad_clip: Optional[float] = None
        self.model: Dict = {"hiddens": (256, 256)}
        # learners
        self.num_learners = 0
        self.num_tpus_per_learner = 0
        self.device = "cuda"          # the learner's device
        # multi-agent (None = single-agent)
        self.policies = None
        self.policy_mapping_fn = None
        # training extras (see ops/optim.py)
        self.lr_schedule = None
        self.optimizer = "adam"
        # evaluation
        self.evaluation_interval = 0
        self.evaluation_duration = 5
        self.evaluation_num_env_runners = 0
        self.evaluation_parallel_to_training = False
        # sebulba pipeline (composed, not built; see the module note)
        self.sebulba_enabled = False
        self.sebulba_num_rollout_actors = 2
        self.sebulba_inflight_rollouts = 2
        self.sebulba_replay_capacity = 64
        self.sebulba_replay_mode = "uniform"   # or "fifo"
        self.sebulba_sample_batch_count = 1    # trajectories per update
        self.sebulba_min_replay = 1
        self.sebulba_broadcast_interval = 1    # updates per param broadcast
        self.sebulba_max_staleness = None      # drop samples older than this
        self.sebulba_lockstep = False          # sync-parity schedule
        self.sebulba_replay_seed = None        # defaults to config.seed
        self.sebulba_jax_env = None            # e.g. "cartpole" (device path)
        # misc
        self.seed = 0
        self.framework_str = "torch"

    # -- builder sections (each returns self, reference-style) ---------------
    def environment(self, env=None, *, env_config=None, **_):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners=None, num_envs_per_env_runner=None,
                    rollout_fragment_length=None, explore=None,
                    scheduling_strategy=None, resources=None, **_):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if explore is not None:
            self.explore = explore
        if scheduling_strategy is not None:
            self.env_runner_scheduling_strategy = scheduling_strategy
        if resources is not None:
            self.env_runner_resources = dict(resources)
        return self

    def training(self, *, lr=None, gamma=None, train_batch_size=None,
                 minibatch_size=None, num_epochs=None, grad_clip=None,
                 lr_schedule=None, optimizer=None, model=None, **kwargs):
        if lr is not None:
            self.lr = lr
        if lr_schedule is not None:
            self.lr_schedule = lr_schedule
        if optimizer is not None:
            self.optimizer = optimizer
        if gamma is not None:
            self.gamma = gamma
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if minibatch_size is not None:
            self.minibatch_size = minibatch_size
        if num_epochs is not None:
            self.num_epochs = num_epochs
        if grad_clip is not None:
            self.grad_clip = grad_clip
        if model is not None:
            self.model.update(model)
        for k, v in kwargs.items():  # algorithm-specific keys land as attrs
            setattr(self, k, v)
        return self

    def learners(self, *, num_learners=None, num_tpus_per_learner=None, **_):
        if num_learners is not None:
            self.num_learners = num_learners
        if num_tpus_per_learner is not None:
            self.num_tpus_per_learner = num_tpus_per_learner
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None, **_):
        if policies is not None:
            self.policies = sorted(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def evaluation(self, *, evaluation_interval=None, evaluation_duration=None,
                   evaluation_num_env_runners=None,
                   evaluation_parallel_to_training=None, **_):
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        if evaluation_num_env_runners is not None:
            self.evaluation_num_env_runners = evaluation_num_env_runners
        if evaluation_parallel_to_training is not None:
            self.evaluation_parallel_to_training = evaluation_parallel_to_training
        return self

    def sebulba(self, *, enabled: bool = True, num_rollout_actors=None,
                inflight_rollouts=None, replay_capacity=None, replay_mode=None,
                sample_batch_count=None, min_replay=None, broadcast_interval=None,
                max_staleness=None, lockstep=None, replay_seed=None, jax_env=None):
        """The sebulba pipeline's settings (Podracer, arXiv:2104.06272), as
        JAX's `sebulba()` stores them; an unknown keyword raises TypeError.
        `jax_env` names a device env of `rllib/sebulba.py` ("cartpole").
        Building an algorithm with `enabled=True` raises (see the module
        note)."""
        self.sebulba_enabled = bool(enabled)
        for name, value in (("num_rollout_actors", num_rollout_actors),
                            ("inflight_rollouts", inflight_rollouts),
                            ("replay_capacity", replay_capacity),
                            ("replay_mode", replay_mode),
                            ("sample_batch_count", sample_batch_count),
                            ("min_replay", min_replay),
                            ("broadcast_interval", broadcast_interval),
                            ("max_staleness", max_staleness), ("lockstep", lockstep),
                            ("replay_seed", replay_seed), ("jax_env", jax_env)):
            if value is not None:
                setattr(self, f"sebulba_{name}", value)
        return self

    def framework(self, framework: str = "torch", **_):
        if framework not in ("jax", "tf2", "torch"):
            raise ValueError(framework)
        self.framework_str = framework
        return self

    def resources(self, *, device=None, **_):
        if device is not None:
            self.device = device
        return self

    def debugging(self, *, seed=None, **_):
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, env=None) -> "Algorithm":
        if env is not None:
            self.env = env
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use a subclass like PPOConfig")
        return self.algo_class(self.copy())

    # alias matching the reference's newer naming
    build_algo = build


class Algorithm:
    """Iteration driver: `train()` = collect -> learn -> metrics."""

    def __init__(self, config: AlgorithmConfig):
        if config.sebulba_enabled:
            raise NotImplementedError(f"the sebulba pipeline {_RUNTIME}")
        if config.num_env_runners > 0:
            raise NotImplementedError(f"num_env_runners > 0 {_RUNTIME}")
        if config.evaluation_interval and config.evaluation_num_env_runners > 0:
            raise NotImplementedError(f"evaluation_num_env_runners > 0 {_RUNTIME}")
        self.config = config
        self.iteration = 0
        self._env_steps_iter = 0
        self._env_steps_total = 0
        self._local_runner: Optional[EnvRunner] = None
        self._local_eval_runner: Optional[EnvRunner] = None
        self.setup(config)

    # -- runner --------------------------------------------------------------
    def _make_runner_kwargs(self) -> Dict[str, Any]:
        """A rollout producer's kwargs: the EnvRunner's, and the learner's
        `device`, where a device-resident rollout (`sebulba.RolloutActor`
        on a device env) runs."""
        cfg = self.config
        return dict(env_creator=resolve_env_creator(cfg.env, cfg.env_config),
                    num_envs=cfg.num_envs_per_env_runner,
                    rollout_len=cfg.rollout_fragment_length,
                    explore=cfg.explore, seed=cfg.seed, gamma=cfg.gamma,
                    device=cfg.device)

    def _setup_runners(self):
        self._local_runner = host_env_runner(self._make_runner_kwargs())

    def _sample_all(self, weights) -> (SampleBatch, Dict):
        b = self._local_runner.sample(weights)
        self._env_steps_iter += b.count
        return b, self._local_runner.pop_metrics()

    # -- to implement --------------------------------------------------------
    def setup(self, config: AlgorithmConfig):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public api ----------------------------------------------------------
    def _eval_runner_kwargs(self) -> Dict[str, Any]:
        kw = self._make_runner_kwargs()
        kw.update(num_envs=1, explore=False)
        return kw

    def _eval_due(self) -> bool:
        return bool(self.config.evaluation_interval and
                    self.iteration % self.config.evaluation_interval == 0)

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self._env_steps_iter = 0
        result = self.training_step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        # env-step accounting (ref: num_env_steps_sampled_* in result dicts)
        self._env_steps_total += self._env_steps_iter
        result.setdefault("num_env_steps_sampled_this_iter", self._env_steps_iter)
        result.setdefault("num_env_steps_sampled_lifetime", self._env_steps_total)
        if self._eval_due():
            result["evaluation"] = self.evaluate()
        result["time_this_iter_s"] = time.perf_counter() - t0
        return result

    def evaluate(self) -> Dict[str, Any]:
        """Greedy-policy episodes on a cached inline runner."""
        cfg = self.config
        if self._local_eval_runner is None:
            self._local_eval_runner = host_env_runner(
                {**self._eval_runner_kwargs(), "seed": cfg.seed + 10_000})
        runner = self._local_eval_runner
        runner.set_weights(self.get_weights())
        start = runner.num_completed_episodes()
        while runner.num_completed_episodes() - start < cfg.evaluation_duration:
            runner.sample()
        return runner.pop_metrics()

    # the sebulba pipeline replays data collected under OLDER params, so
    # only algorithms with an off-policy correction (V-trace) opt in
    _supports_sebulba = False

    def _sebulba_update(self, batch: SampleBatch) -> Dict[str, float]:
        """One learner update on a replay-sampled [T, B] batch: the sebulba
        pipeline's learn stage. Algorithms that preprocess the batch first
        (APPO's V-trace targets) override it."""
        return self.learner_group.update(batch)

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, weights):
        raise NotImplementedError

    def get_state(self) -> Dict:
        return {"weights": self.get_weights(), "iteration": self.iteration,
                "config_class": type(self.config).__name__}

    def set_state(self, state: Dict):
        self.set_weights(state["weights"])
        self.iteration = state.get("iteration", 0)

    def save(self, path: Optional[str] = None) -> Checkpoint:
        return Checkpoint.from_state(self.get_state(), path=path)

    def restore(self, ckpt: Union[str, Checkpoint]):
        if isinstance(ckpt, str):
            ckpt = Checkpoint.from_directory(ckpt)
        self.set_state(ckpt.to_state())

    def stop(self):
        for runner in (self._local_runner, self._local_eval_runner):
            if runner is not None:
                runner.close()


def _merge_runner_metrics(ms: List[Dict]) -> Dict:
    out: Dict[str, Any] = {"episodes_this_iter": sum(m.get("episodes_this_iter", 0) for m in ms)}
    means = [m for m in ms if "episode_return_mean" in m]
    if means:
        out["episode_return_mean"] = float(np.mean([m["episode_return_mean"] for m in means]))
        out["episode_return_max"] = float(np.max([m["episode_return_max"] for m in means]))
        out["episode_return_min"] = float(np.min([m["episode_return_min"] for m in means]))
        out["episode_len_mean"] = float(np.mean([m["episode_len_mean"] for m in means]))
    return out
