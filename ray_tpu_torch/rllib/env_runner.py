"""EnvRunner: rollouts on gymnasium vector envs, the port's counterpart of
`ray_tpu/rllib/env_runner.py` (reference:
rllib/env/single_agent_env_runner.py).

Acting runs on the host CPU, as the reference's does (the accelerator
belongs to the learner): the runner keeps a CPU copy of the weights it is
given, whatever device they come from. It emits fixed-shape [T, B]
SampleBatches with the reference's columns, over a `SyncVectorEnv` with
SAME_STEP autoreset (the obs recorded at step t is the pre-step obs; a
finished env's next obs is its reset obs), and a bootstrap value masked
by the last step's terminal flag.

Sampling draws from a `torch.Generator` seeded with `seed ^ 0x5eed`.
gymnasium is imported inside the functions that need it. A string env is
a `ray_tpu_torch.tune.register_env` name first and a gymnasium id
otherwise, as in the reference; it is resolved in the driver, and the
creator pickles by value into remote runners. The runner is a plain
object: `ray_tpu_torch.remote(num_cpus=1)(EnvRunner)` makes it an actor,
as `Algorithm` does for its remote and evaluation runners.
"""

import functools
import os
import socket
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ray_tpu_torch.util import metrics
from . import sample_batch as SB
from .rl_module import ModuleSpec, RLModule
from .sample_batch import SampleBatch


def _make_vector_env(env_creator, num_envs: int):
    import gymnasium as gym
    from gymnasium.vector import AutoresetMode
    return gym.vector.SyncVectorEnv([env_creator for _ in range(num_envs)],
                                    autoreset_mode=AutoresetMode.SAME_STEP)


def record_param_version(version: int):
    """The `rllib_param_version` gauge, role "rollout": the weights version
    a rollout producer received."""
    metrics.get_or_create(
        metrics.Gauge, "rllib_param_version",
        "params version in use (learner: published; rollout: received)",
        tag_keys=("role",)).set(version, tags={"role": "rollout"})


def resolve_env_creator(env: Union[str, Callable], env_config: Optional[dict] = None):
    """String env -> callable, DRIVER-side: `tune.register_env` names win
    over gymnasium ids (ref: rllib resolves through tune/registry.py before
    gym.make); a callable passes through. Must run where the registration
    happened: the returned CALLABLE then pickles by value into remote
    runner actors, whose own process-local registry is empty. Each
    invocation hands the creator a fresh dict copy (vector envs call it N
    times; a creator that pops keys must not corrupt its siblings'
    config)."""
    if callable(env):
        return env
    from ray_tpu_torch.tune.registry import get_env_creator
    registered = get_env_creator(env)
    if registered is not None:
        return lambda: registered(dict(env_config or {}))
    import gymnasium as gym
    return functools.partial(gym.make, env, **(env_config or {}))


class EnvRunner:
    def __init__(self, env_creator: Union[str, Callable], *,
                 num_envs: int = 1, rollout_len: int = 200,
                 module_spec: Optional[ModuleSpec] = None,
                 module=None, explore: bool = True, seed: int = 0,
                 gamma: float = 0.99, record_next_obs: bool = False,
                 env_config: Optional[dict] = None):
        if isinstance(env_creator, str):
            env_creator = resolve_env_creator(env_creator, env_config)
        self.envs = _make_vector_env(env_creator, num_envs)
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.explore = explore
        self.record_next_obs = record_next_obs  # off-policy algorithms need (s, s')
        spec = module_spec or ModuleSpec.from_spaces(
            self.envs.single_observation_space, self.envs.single_action_space)
        self.module = module if module is not None else RLModule(spec)
        self.params = None
        self.params_version = -1  # -1 = never versioned (sync path)
        self._net = None          # the CPU copy of the weights
        self._seed = seed
        self._generator = torch.Generator().manual_seed(seed ^ 0x5eed)
        self._episodes = Episodes(num_envs)
        self._obs = None

    # -- weights ------------------------------------------------------------
    def set_weights(self, params, version: Optional[int] = None):
        self.params = params
        self._load(params)
        if version is not None:
            self.params_version = int(version)
            record_param_version(self.params_version)

    def _load(self, params):
        if self._net is None:
            self._net = self.module.make_net(self._seed)
        self._net.load_state_dict(params)

    def get_spec(self) -> ModuleSpec:
        return self.module.spec

    def init_params(self):
        """Fresh params, on the CPU (used when the runner seeds the weights)."""
        return self.module.init(self._seed)

    # -- rollouts -----------------------------------------------------------
    def _act(self, obs):
        if self.explore:
            return self.module.explore_step(self._net, obs, self._generator)
        action, value = self.module.inference_step(self._net, obs)
        return action, torch.zeros(value.shape), value

    @torch.no_grad()
    def sample(self, params=None) -> SampleBatch:
        """Collect one [T, B] rollout continuing from the last state."""
        if params is not None:
            self.params = params
            self._load(params)
        if self._net is None:
            raise RuntimeError("set_weights() before sample()")
        if self._obs is None:
            self._obs, _ = self.envs.reset(seed=self._seed)
        T, B = self.rollout_len, self.num_envs
        obs_buf = np.empty((T, B) + self.envs.single_observation_space.shape, np.float32)
        next_obs_buf = np.empty_like(obs_buf) if self.record_next_obs else None
        actions_buf = None
        rewards = np.empty((T, B), np.float32)
        dones = np.empty((T, B), np.float32)
        terms = np.empty((T, B), np.float32)
        logps = np.empty((T, B), np.float32)
        vfs = np.empty((T, B), np.float32)
        obs = self._obs
        for t in range(T):
            action, logp, value = self._act(torch.from_numpy(obs.astype(np.float32)))
            action = action.numpy()
            if actions_buf is None:
                actions_buf = np.empty((T, B) + action.shape[1:], action.dtype)
            next_obs, rew, term, trunc, _info = self.envs.step(action)
            obs_buf[t] = obs
            if next_obs_buf is not None:
                next_obs_buf[t] = next_obs
            actions_buf[t] = action
            rewards[t] = rew
            terms[t] = term
            dones[t] = np.logical_or(term, trunc)
            logps[t] = logp.numpy()
            vfs[t] = value.numpy()
            self._episodes.step(rew, dones[t])
            obs = next_obs
        self._obs = obs

        # bootstrap value of the state after the last step; zero if that env
        # terminated there (SAME_STEP autoreset: obs is then the reset obs,
        # and a terminal state's future return is 0 anyway)
        _, boot = self.module.forward(self._net, torch.from_numpy(obs.astype(np.float32)))
        boot = boot.numpy() * (1.0 - terms[-1])

        out = SampleBatch({
            SB.OBS: obs_buf, SB.ACTIONS: actions_buf, SB.REWARDS: rewards,
            SB.DONES: dones, SB.TERMINATEDS: terms, SB.LOGP: logps,
            SB.VF_PREDS: vfs, SB.BOOTSTRAP_VALUE: boot,
        })
        if next_obs_buf is not None:
            out[SB.NEXT_OBS] = next_obs_buf
        return out

    def run_eval(self, params, num_episodes: int) -> Dict:
        """Sample until `num_episodes` complete; returns their metrics. One
        call an evaluation round, so an evaluation actor that `ray_tpu`'s
        runtime makes of this runner runs beside training."""
        self.set_weights(params)
        self._episodes.completed = []
        while self.num_completed_episodes() < num_episodes:
            self.sample()
        return self.pop_metrics()

    # -- metrics ------------------------------------------------------------
    def node_info(self) -> Dict:
        """Where this runner lives: pid, parent pid and host name, for
        checks of actor placement."""
        return {"pid": os.getpid(), "ppid": os.getppid(), "hostname": socket.gethostname()}

    def num_completed_episodes(self) -> int:
        return len(self._episodes.completed)

    def pop_metrics(self) -> Dict:
        return self._episodes.pop_metrics()

    def close(self):
        self.envs.close()


class Episodes:
    """Per-env episode bookkeeping on the host: returns and lengths summed
    step by step, and the episodes completed since the last pop."""

    def __init__(self, num_envs: int):
        self.ret = np.zeros(num_envs, np.float64)
        self.len = np.zeros(num_envs, np.int64)
        self.completed: List[Dict] = []

    def step(self, rewards, dones):
        self.ret += rewards
        self.len += 1
        for i in np.nonzero(dones)[0]:
            self.completed.append({"return": float(self.ret[i]), "len": int(self.len[i])})
            self.ret[i] = 0.0
            self.len[i] = 0

    def pop_metrics(self) -> Dict:
        eps, self.completed = self.completed, []
        if not eps:
            return {"episodes_this_iter": 0}
        rets = [e["return"] for e in eps]
        lens = [e["len"] for e in eps]
        return {"episodes_this_iter": len(eps),
                "episode_return_mean": float(np.mean(rets)),
                "episode_return_max": float(np.max(rets)),
                "episode_return_min": float(np.min(rets)),
                "episode_len_mean": float(np.mean(lens))}


def host_runner_kwargs(runner_kwargs: Dict) -> Dict:
    """An EnvRunner's kwargs of a rollout producer's kwargs
    (`Algorithm._make_runner_kwargs`). It acts on the host CPU, so the
    learner's `device` among them is not its own."""
    return {k: v for k, v in runner_kwargs.items() if k != "device"}


def host_env_runner(runner_kwargs: Dict) -> EnvRunner:
    """The inline EnvRunner of a rollout producer's kwargs."""
    return EnvRunner(**host_runner_kwargs(runner_kwargs))
