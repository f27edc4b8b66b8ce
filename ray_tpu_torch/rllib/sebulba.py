"""Device-resident rollouts and the rollout actor: the port's counterpart
of `ray_tpu/rllib/sebulba.py`'s `JaxCartPole`, `DeviceRollout` and
`RolloutActor` (Podracer architectures, arXiv:2104.06272).

`TorchCartPole` is CartPole-v1 as tensor functions (classic-control
physics, Barto-Sutton-Anderson '83, f32) over a [B, 4] state on a device,
with gymnasium's SAME_STEP autoreset semantics: the obs recorded at step t
is the pre-step obs, and a finished env's next obs is its reset obs.

`DeviceRollout` unrolls explore_step -> env.step -> autoreset for T steps
on its device ("cuda" unless `device="cpu"`), where JAX runs one jitted
`lax.scan`. The loop issues eager ops only: no value is read back inside
it, and one copy to the host ends `sample()`, as JAX's one `device_get`.
It emits EnvRunner's columns and bootstrap rule, and keeps the episode
metrics on the host after the unroll.

`RolloutActor` is a plain class (a caller makes it an actor): one
rollout producer, `DeviceRollout` on a device env or the gymnasium
`EnvRunner`, whose `sample_traj` stamps each trajectory with the version
of the weights it was collected under and records a `pipeline.act`
window. `ray_tpu.rllib.sebulba.SebulbaPipeline` (which schedules actors
and the replay actor, runtime code the port does not copy) drives it
over the port's IMPALA or APPO; its lockstep mode then reproduces the
port's synchronous IMPALA exactly.
"""

import math
import os
import socket
import time
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.util import metrics, tracing
from . import sample_batch as SB
from .env_runner import Episodes, host_env_runner, record_param_version
from .rl_module import ModuleSpec, RLModule
from .sample_batch import SampleBatch

__all__ = ["TorchCartPole", "DeviceRollout", "RolloutActor"]


class TorchCartPole:
    """CartPole-v1 on tensors: JAX's `JaxCartPole` constants and f32
    arithmetic, in the same order."""

    GRAV, MASSCART, MASSPOLE = 9.8, 1.0, 0.1
    TOTAL_MASS = MASSCART + MASSPOLE
    LENGTH = 0.5                       # half the pole's length
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG, TAU = 10.0, 0.02
    X_LIM = 2.4
    THETA_LIM = 12 * 2 * math.pi / 360
    MAX_STEPS = 500

    @staticmethod
    def spec() -> ModuleSpec:
        return ModuleSpec((4,), "discrete", 2)

    @staticmethod
    def reset(generator: torch.Generator, batch: int, device):
        """Uniform(-0.05, 0.05) states [B, 4] f32 and step counts [B] int32."""
        x = torch.rand((batch, 4), generator=generator, device=device) * 0.1 - 0.05
        return x, torch.zeros((batch,), dtype=torch.int32, device=device)

    @staticmethod
    def observe(x):
        return x

    @classmethod
    def step(cls, x, t, action):
        """(next state, next step count, reward, terminated, truncated)."""
        pos, vel, theta, theta_dot = x.unbind(1)
        force = torch.where(action == 1, cls.FORCE_MAG, -cls.FORCE_MAG).to(x.dtype)
        costh, sinth = torch.cos(theta), torch.sin(theta)
        temp = (force + cls.POLEMASS_LENGTH * theta_dot ** 2 * sinth) / cls.TOTAL_MASS
        theta_acc = (cls.GRAV * sinth - costh * temp) / (
            cls.LENGTH * (4.0 / 3.0 - cls.MASSPOLE * costh ** 2 / cls.TOTAL_MASS))
        x_acc = temp - cls.POLEMASS_LENGTH * theta_acc * costh / cls.TOTAL_MASS
        pos = pos + cls.TAU * vel
        vel = vel + cls.TAU * x_acc
        theta = theta + cls.TAU * theta_dot
        theta_dot = theta_dot + cls.TAU * theta_acc
        x2 = torch.stack([pos, vel, theta, theta_dot], dim=1)
        t2 = t + 1
        term = (pos.abs() > cls.X_LIM) | (theta.abs() > cls.THETA_LIM)
        trunc = (t2 >= cls.MAX_STEPS) & ~term
        return x2, t2, torch.ones_like(pos), term, trunc


_TORCH_ENVS = {"cartpole": TorchCartPole}


class DeviceRollout:
    """EnvRunner-shaped rollout producer whose [T, B] unroll runs on one
    device. Same surface and columns as EnvRunner, so a learner cannot
    tell the two apart."""

    def __init__(self, env_cls, *, num_envs: int = 1, rollout_len: int = 200,
                 seed: int = 0, module=None, device="cuda"):
        if isinstance(env_cls, str):
            env_cls = _TORCH_ENVS[env_cls]
        self.env_cls = env_cls
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.device = resolve_device(device)
        self.params = None
        self.params_version = -1
        self._seed = seed
        self.module = module if module is not None else RLModule(env_cls.spec())
        self._net = None
        self._state = None            # (x, t) on the device
        self._generator = torch.Generator(self.device).manual_seed(seed ^ 0x5eed)
        self._episodes = Episodes(num_envs)

    # same surface as EnvRunner -------------------------------------------
    def set_weights(self, params, version: Optional[int] = None):
        self.params = params
        self._load(params)
        if version is not None:
            self.params_version = int(version)
            record_param_version(self.params_version)

    def _load(self, params):
        if self._net is None:
            self._net = self.module.make_net(self._seed, self.device)
        self._net.load_state_dict(params)

    def get_spec(self) -> ModuleSpec:
        return self.module.spec

    def init_params(self):
        return self.module.init(self._seed)

    @torch.no_grad()
    def sample(self, params=None) -> SampleBatch:
        if params is not None:
            self.params = params
            self._load(params)
        if self._net is None:
            raise RuntimeError("set_weights() before sample()")
        env, module, net, gen = self.env_cls, self.module, self._net, self._generator
        T, B, dev = self.rollout_len, self.num_envs, self.device
        if self._state is None:
            self._state = env.reset(torch.Generator(dev).manual_seed(self._seed), B, dev)
        x, t = self._state
        obs_dim = env.observe(x).shape[1:]
        obs_buf = torch.empty((T, B) + obs_dim, device=dev)
        cols = torch.empty((T, 6, B), device=dev)    # action, reward, done, term, logp, vf
        for i in range(T):
            obs = env.observe(x)
            a, logp, v = module.explore_step(net, obs, gen)
            x2, t2, rew, term, trunc = env.step(x, t, a)
            done = term | trunc
            xr, tr = env.reset(gen, B, dev)
            x = torch.where(done[:, None], xr, x2)
            t = torch.where(done, tr, t2)
            obs_buf[i] = obs
            torch.stack([a.float(), rew, done.float(), term.float(), logp, v], out=cols[i])
        self._state = (x, t)
        # bootstrap value of the post-rollout state; a terminated env's state
        # is already its reset state and its future return is 0, so mask by
        # the last terminal flag: EnvRunner's rule
        _, boot = module.forward(net, env.observe(x))
        boot = boot * (1.0 - cols[-1, 3])
        host = torch.cat([obs_buf.reshape(-1), cols.reshape(-1), boot]).cpu().numpy()  # one sync
        n_obs = obs_buf.numel()
        obs = host[:n_obs].reshape(obs_buf.shape)
        act, rew, done, term, logp, vf = (
            c.copy() for c in host[n_obs:n_obs + cols.numel()].reshape(T, 6, B).swapaxes(0, 1))
        for i in range(T):                       # episode metrics, host side
            self._episodes.step(rew[i], done[i])
        return SampleBatch({
            SB.OBS: obs, SB.ACTIONS: act.astype("int64"), SB.REWARDS: rew, SB.DONES: done,
            SB.TERMINATEDS: term, SB.LOGP: logp, SB.VF_PREDS: vf,
            SB.BOOTSTRAP_VALUE: host[n_obs + cols.numel():],
        })

    def pop_metrics(self) -> Dict:
        return self._episodes.pop_metrics()

    def num_completed_episodes(self) -> int:
        return len(self._episodes.completed)

    def close(self):
        self._state = None


# ---------------------------------------------------------------------------
# rollout actor
# ---------------------------------------------------------------------------

def _rollout_backend(runner_kwargs: Dict[str, Any], jax_env):
    """`DeviceRollout` on `jax_env` (a name of `_TORCH_ENVS` or an env
    class) on the runner kwargs' device, "cuda" when they name none (never
    the CPU unless asked); else the gymnasium `EnvRunner`, which acts on
    the host CPU."""
    if jax_env is not None:
        return DeviceRollout(jax_env, num_envs=runner_kwargs["num_envs"],
                             rollout_len=runner_kwargs["rollout_len"],
                             seed=runner_kwargs.get("seed", 0),
                             device=runner_kwargs.get("device", "cuda"))
    return host_env_runner(runner_kwargs)


class RolloutActor:
    """One saturated act+step loop; `ray_tpu.remote(...)(RolloutActor)`
    deploys it as an actor.

    ``sample_traj`` returns two values, (trajectory, info): the [T, B]
    trajectory can stay in the actor's object store while the small info
    dict (version, step count) travels back by value."""

    def __init__(self, runner_kwargs: Dict[str, Any], index: int = 0, jax_env=None):
        self.index = index
        self._params = None
        self._version = -1
        self._impl = _rollout_backend(runner_kwargs, jax_env)

    def ping(self) -> int:
        return self.index

    def get_spec(self):
        return self._impl.get_spec()

    def init_params(self):
        return self._impl.init_params()

    def node_info(self) -> Dict:
        return {"pid": os.getpid(), "ppid": os.getppid(),
                "hostname": socket.gethostname(), "actor": self.index}

    def set_weights(self, params, version: int):
        """Broadcast target: the learner does not wait on it (but in
        lockstep mode)."""
        self._params = params
        self._version = int(version)
        self._impl.set_weights(params, version)

    def sample_traj(self):
        t0 = time.time()
        batch = self._impl.sample(self._params)
        t1 = time.time()
        steps = int(batch[SB.REWARDS].size)
        metrics.get_or_create(metrics.Counter, "rllib_env_steps",
                              "env steps collected by sebulba rollout actors").inc(steps)
        tracing.ship_window("pipeline.act", "rllib", None, t0, t1, tid=os.getpid(),
                            args={"actor": self.index, "version": self._version})
        traj = dict(batch)
        traj["version"] = self._version
        traj["actor"] = self.index
        info = {"version": self._version, "steps": steps, "actor": self.index,
                "dur_s": t1 - t0}
        return traj, info

    # ray_tpu's actor-method options protocol (what `ray_tpu.actor.method`
    # sets): the call returns two object refs
    sample_traj.__rtpu_method_options__ = {"num_returns": 2}

    def pop_metrics(self) -> Dict:
        return self._impl.pop_metrics()

    def close(self):
        self._impl.close()
