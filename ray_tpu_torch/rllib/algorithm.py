"""AlgorithmConfig and the Algorithm base: the port's counterpart of
`ray_tpu/rllib/algorithm.py` (reference: rllib/algorithms/algorithm_config.py
and algorithm.py).

The same builder API (`config.environment(...).training(...).env_runners(...)`)
and `algo.train()` loop: collect on an inline EnvRunner (host CPU), learn
on the learner's device, `config.resources(device=...)`, "cuda" by
default. JAX's `.resources(**_)` accepts that keyword and ignores it, so
one builder chain configures both packages.

`.sebulba(enabled=True)` runs the iterations through
`sebulba.SebulbaPipeline` on the port's runtime (rollout actors and a
replay actor, the learner here), as JAX's does; it reads the hooks JAX's
reads (`_supports_sebulba`, `_make_runner_kwargs`, `_sebulba_update`,
`get_weights`, `learner.jit_cache_size`). `num_env_runners > 0` makes
that many `EnvRunner` actors of the port's runtime (`ray_tpu_torch.init()`
is called if no session is up), and `evaluation_num_env_runners > 0`
dedicated greedy evaluation actors, as JAX's does; a remote runner acts on
its host's CPU, so its kwargs carry no `device`.
"""

import copy
import math
import time
from typing import Any, Callable, Dict, List, Optional, Type, Union

import numpy as np

from ray_tpu_torch.train.checkpoint import Checkpoint
from .env_runner import EnvRunner, host_env_runner, host_runner_kwargs, resolve_env_creator
from .sample_batch import SampleBatch


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
        # sebulba pipeline
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
        self.config = config
        self.iteration = 0
        self._env_steps_iter = 0
        self._env_steps_total = 0
        self._runner_handles: List = []
        self._local_runner: Optional[EnvRunner] = None
        self._eval_handles: List = []       # dedicated evaluation actors
        self._local_eval_runner: Optional[EnvRunner] = None
        self._pending_eval = None           # a parallel evaluation's refs
        self.setup(config)
        self._setup_eval_runners()
        self._sebulba = None
        if config.sebulba_enabled:
            from .sebulba import SebulbaPipeline
            self._sebulba = SebulbaPipeline(self, config)

    # -- runner --------------------------------------------------------------
    def _make_runner_kwargs(self) -> Dict[str, Any]:
        """A rollout producer's kwargs: the EnvRunner's, and the learner's
        `device`, where a device-resident rollout (`sebulba.RolloutActor`
        on a device env) runs."""
        cfg = self.config
        env = cfg.env
        if isinstance(env, str):
            # resolve a registered name here, in the driver: a remote
            # runner's process has its own registry
            env = resolve_env_creator(env, cfg.env_config)
        return dict(env_creator=env,
                    num_envs=cfg.num_envs_per_env_runner,
                    rollout_len=cfg.rollout_fragment_length,
                    explore=cfg.explore, seed=cfg.seed, gamma=cfg.gamma,
                    device=cfg.device)

    def _setup_runners(self):
        cfg = self.config
        if cfg.num_env_runners <= 0:
            self._local_runner = host_env_runner(self._make_runner_kwargs())
            return
        import ray_tpu_torch as rt
        if not rt.is_initialized():
            rt.init()
        decorator = {"num_cpus": 1}
        if cfg.env_runner_resources:
            decorator["resources"] = dict(cfg.env_runner_resources)
        if cfg.env_runner_scheduling_strategy is not None:
            decorator["scheduling_strategy"] = cfg.env_runner_scheduling_strategy
        remote_runner = rt.remote(**decorator)(EnvRunner)
        kw = host_runner_kwargs(self._make_runner_kwargs())
        self._runner_handles = [remote_runner.remote(**{**kw, "seed": cfg.seed + i})
                                for i in range(cfg.num_env_runners)]
        # a local runner for the module spec only (it never samples)
        self._local_runner = EnvRunner(**{**kw, "num_envs": 1, "rollout_len": 2})

    def _sample_all(self, weights) -> (SampleBatch, Dict):
        if self._runner_handles:
            import ray_tpu_torch as rt
            wref = rt.put(weights)
            batches = rt.get([r.sample.remote(wref) for r in self._runner_handles])
            metrics = rt.get([r.pop_metrics.remote() for r in self._runner_handles])
            batch = SampleBatch.concat(batches)
            self._env_steps_iter += batch.count
            return batch, _merge_runner_metrics(metrics)
        b = self._local_runner.sample(weights)
        self._env_steps_iter += b.count
        return b, self._local_runner.pop_metrics()

    # -- to implement --------------------------------------------------------
    def setup(self, config: AlgorithmConfig):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public api ----------------------------------------------------------
    # algorithms whose evaluate() cannot run on a generic EnvRunner (their
    # own weight layouts) opt out of the dedicated-actor path
    _supports_eval_actors = True

    def _eval_runner_kwargs(self) -> Dict[str, Any]:
        """The training runners' construction (SAC's and DQN's module
        overrides ride along), greedy and with one env."""
        kw = self._make_runner_kwargs()
        kw.update(num_envs=1, explore=False)
        return kw

    def _setup_eval_runners(self):
        """Dedicated evaluation EnvRunner actors (reference: Algorithm's
        evaluation worker set). None with `evaluation_num_env_runners` 0:
        evaluate() then runs a cached inline runner."""
        cfg = self.config
        if (not cfg.evaluation_interval or cfg.evaluation_num_env_runners <= 0
                or not self._supports_eval_actors or cfg.policies):
            return
        import ray_tpu_torch as rt
        if not rt.is_initialized():
            rt.init()
        remote_runner = rt.remote(num_cpus=1)(EnvRunner)
        kw = host_runner_kwargs(self._eval_runner_kwargs())
        self._eval_handles = [remote_runner.remote(**{**kw, "seed": cfg.seed + 10_000 + i})
                              for i in range(cfg.evaluation_num_env_runners)]

    def _launch_eval(self) -> List:
        """Each evaluation actor's run_eval over one put of the weights,
        ceil(duration / actors) episodes an actor."""
        import ray_tpu_torch as rt
        wref = rt.put(self.get_weights())
        per = math.ceil(self.config.evaluation_duration / len(self._eval_handles))
        return [h.run_eval.remote(wref, per) for h in self._eval_handles]

    def _eval_due(self) -> bool:
        return bool(self.config.evaluation_interval and
                    self.iteration % self.config.evaluation_interval == 0)

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self._env_steps_iter = 0
        result = (self._sebulba.training_step() if self._sebulba is not None
                  else self.training_step())
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        # env-step accounting (ref: num_env_steps_sampled_* in result dicts)
        self._env_steps_total += self._env_steps_iter
        result.setdefault("num_env_steps_sampled_this_iter", self._env_steps_iter)
        result.setdefault("num_env_steps_sampled_lifetime", self._env_steps_total)
        due = self._eval_due()
        # a parallel evaluation launched in an earlier iteration attaches to
        # the first result where it has finished (waited for when the next
        # one is due)
        if self._pending_eval is not None:
            import ray_tpu_torch as rt
            ready, _ = rt.wait(self._pending_eval, num_returns=len(self._pending_eval),
                               timeout=None if due else 0.0)
            if len(ready) == len(self._pending_eval):
                result["evaluation"] = _merge_runner_metrics(rt.get(self._pending_eval))
                self._pending_eval = None
        if due:
            parallel = self._eval_handles and self.config.evaluation_parallel_to_training
            if parallel and self._pending_eval is None:
                self._pending_eval = self._launch_eval()
            elif not parallel:
                result["evaluation"] = self.evaluate()
        result["time_this_iter_s"] = time.perf_counter() - t0
        return result

    def evaluate(self) -> Dict[str, Any]:
        """Greedy-policy episodes (blocking): on the evaluation actors where
        there are any, else on a cached inline runner."""
        cfg = self.config
        if self._eval_handles:
            import ray_tpu_torch as rt
            return _merge_runner_metrics(rt.get(self._launch_eval()))
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
        if self._sebulba is not None:
            self._sebulba.shutdown()
            self._sebulba = None
        for runner in (self._local_runner, self._local_eval_runner):
            if runner is not None:
                runner.close()
        if self._runner_handles or self._eval_handles:
            import ray_tpu_torch as rt
            for h in self._runner_handles + self._eval_handles:
                rt.kill(h)
            self._runner_handles, self._eval_handles, self._pending_eval = [], [], None


def _merge_runner_metrics(ms: List[Dict]) -> Dict:
    out: Dict[str, Any] = {"episodes_this_iter": sum(m.get("episodes_this_iter", 0) for m in ms)}
    means = [m for m in ms if "episode_return_mean" in m]
    if means:
        out["episode_return_mean"] = float(np.mean([m["episode_return_mean"] for m in means]))
        out["episode_return_max"] = float(np.max([m["episode_return_max"] for m in means]))
        out["episode_return_min"] = float(np.min([m["episode_return_min"] for m in means]))
        out["episode_len_mean"] = float(np.mean([m["episode_len_mean"] for m in means]))
    return out
