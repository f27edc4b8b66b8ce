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
window.

`SebulbaPipeline` drives rollout actors and a `ReplayActor` of the port's
runtime for IMPALA or APPO, with the learner in the driver: rollouts run
free, their trajectory refs go to replay, sampled refs are fetched on a
thread while the learner updates, and versioned params are broadcast
without waiting. Its lockstep mode reproduces the synchronous IMPALA
exactly. Where JAX's rollout actors take `num_cpus=1`, one whose
`DeviceRollout` runs on "cuda" claims a card (`num_gpus=1`): a CPU-only
worker sees `CUDA_VISIBLE_DEVICES=""`.
"""

import math
import os
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.util import metrics, tracing
from . import sample_batch as SB
from .buffers import ReplayActor
from .env_runner import Episodes, host_env_runner, record_param_version
from .rl_module import ModuleSpec, RLModule
from .sample_batch import SampleBatch

__all__ = ["TorchCartPole", "DeviceRollout", "RolloutActor", "SebulbaPipeline"]


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
    """One saturated act+step loop; `ray_tpu_torch.remote(...)(RolloutActor)`
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


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def _rollout_on_card(runner_kwargs: Dict[str, Any], jax_env) -> bool:
    """A rollout actor whose `DeviceRollout` runs on a card."""
    return jax_env is not None and \
        torch.device(runner_kwargs.get("device") or "cuda").type == "cuda"


class SebulbaPipeline:
    """Driver-side orchestrator: saturate rollouts, admit refs to replay,
    prefetch-overlap sampled batches with the update, broadcast versioned
    params fire-and-forget."""

    def __init__(self, algo, config):
        import ray_tpu_torch as rt
        if not getattr(algo, "_supports_sebulba", False):
            raise ValueError(
                f"{type(algo).__name__} does not support the sebulba "
                f"pipeline; it needs an off-policy-tolerant (V-trace) "
                f"update — use IMPALA or APPO")
        if not rt.is_initialized():
            rt.init()
        self.algo = algo
        self.cfg = config
        self.lockstep = bool(getattr(config, "sebulba_lockstep", False))
        n = 1 if self.lockstep else max(
            1, int(getattr(config, "sebulba_num_rollout_actors", 2)))
        self.inflight_per_actor = 1 if self.lockstep else max(
            1, int(getattr(config, "sebulba_inflight_rollouts", 2)))
        self.broadcast_interval = 1 if self.lockstep else max(
            1, int(getattr(config, "sebulba_broadcast_interval", 1)))
        self.sample_count = 1 if self.lockstep else max(
            1, int(getattr(config, "sebulba_sample_batch_count", 1)))
        mode = "fifo" if self.lockstep else str(
            getattr(config, "sebulba_replay_mode", "uniform"))
        self.min_replay = max(1, int(getattr(config, "sebulba_min_replay", 1)))
        self.max_staleness = getattr(config, "sebulba_max_staleness", None)
        replay_seed = getattr(config, "sebulba_replay_seed", None)
        if replay_seed is None:
            replay_seed = config.seed

        kw = algo._make_runner_kwargs()
        jax_env = getattr(config, "sebulba_jax_env", None)
        decorator: Dict[str, Any] = {"num_cpus": 1}
        if _rollout_on_card(kw, jax_env):
            decorator["num_gpus"] = 1
        if getattr(config, "env_runner_resources", None):
            decorator["resources"] = dict(config.env_runner_resources)
        if getattr(config, "env_runner_scheduling_strategy", None) is not None:
            decorator["scheduling_strategy"] = config.env_runner_scheduling_strategy
        RemoteRollout = rt.remote(**decorator)(RolloutActor)
        self.actors = [
            RemoteRollout.remote({**kw, "seed": config.seed + i}, index=i, jax_env=jax_env)
            for i in range(n)]
        RemoteReplay = rt.remote(num_cpus=1)(ReplayActor)
        self.replay = RemoteReplay.remote(
            int(getattr(config, "sebulba_replay_capacity", 64)),
            seed=int(replay_seed), mode=mode)
        rt.get([a.ping.remote() for a in self.actors] + [self.replay.ping.remote()])

        self.version = 0            # params version currently published
        self.updates = 0
        self._broadcasts = 0
        self._broadcasts_async = 0  # fire-and-forget (no ack awaited)
        self._env_steps_total = 0
        self._replay_admitted = 0
        self._stale_dropped = 0
        self._gap_counts: Dict[int, int] = {}   # off-policy gap -> updates
        self._last_learn: Dict[str, float] = {}
        self._inflight: Dict[str, tuple] = {}   # info-ref id -> (iref, tref, i)
        self._pending_sample = None             # in-flight sample_refs ref
        self._fetching = None                   # (future, versions)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="sebulba-fetch")
        self._closed = False

        # actors are useless until they hold v0 weights: this one
        # broadcast blocks; steady-state broadcasts are fire-and-forget
        self._broadcast(block=True)
        if not self.lockstep:
            for i in range(len(self.actors)):
                for _ in range(self.inflight_per_actor):
                    self._submit(i)

    # -- rollout side -------------------------------------------------------
    def _submit(self, idx: int):
        tref, iref = self.actors[idx].sample_traj.remote()
        self._inflight[iref.id] = (iref, tref, idx)

    def _count_env_steps(self, steps: int):
        metrics.get_or_create(metrics.Counter, "rllib_env_steps",
                              "env steps collected by sebulba rollout actors").inc(steps)

    def _reap(self, block: bool) -> int:
        """Admit finished rollouts to replay (refs only: the trajectory
        object never passes through the driver) and resubmit. Returns env
        steps admitted."""
        import ray_tpu_torch as rt
        if not self._inflight:
            return 0
        irefs = [e[0] for e in self._inflight.values()]
        ready, _ = rt.wait(irefs, num_returns=len(irefs), timeout=0.0)
        if not ready and block:
            ready, _ = rt.wait(irefs, num_returns=1, timeout=0.05)
        steps = 0
        for iref in ready:
            iref, tref, idx = self._inflight.pop(iref.id)
            info = rt.get(iref)
            # wrapped in a list -> arrives at the replay actor as a ref
            self.replay.add_refs.remote([tref], [int(info["version"])])
            del tref
            self._replay_admitted += 1
            steps += int(info["steps"])
            self._submit(idx)
        if steps:
            self._count_env_steps(steps)
        self._env_steps_total += steps
        return steps

    # -- learner side -------------------------------------------------------
    def _request_sample(self):
        if self._pending_sample is None and self._replay_admitted >= self.min_replay:
            self._pending_sample = self.replay.sample_refs.remote(self.sample_count)

    def _start_fetch(self, block: bool) -> bool:
        """Pending sample resolved -> hand the refs to the fetch thread, so
        trajectory bytes stream in while the driver thread runs the update
        (the prefetch overlap)."""
        import ray_tpu_torch as rt
        if self._fetching is not None or self._pending_sample is None:
            return False
        if not block:
            ready, _ = rt.wait([self._pending_sample], num_returns=1, timeout=0.0)
            if not ready:
                return False
        pairs = rt.get(self._pending_sample)
        self._pending_sample = None
        if not pairs:
            return False            # replay dry (fifo): retry after admits
        refs = [p[0] for p in pairs]
        versions = [int(p[1]) for p in pairs]
        self._fetching = (self._pool.submit(rt.get, refs), versions)
        return True

    def _learn_turn(self, block: bool = False) -> bool:
        """Advance the learner state machine; True if an update ran."""
        while True:
            if self._fetching is not None:
                fut, versions = self._fetching
                if not fut.done() and not block:
                    return False
                trajs = fut.result()
                self._fetching = None
                # queue the next sample before updating, so its fetch
                # overlaps this update
                self._request_sample()
                self._start_fetch(block=False)
                self._apply_update(trajs, versions)
                return True
            self._request_sample()
            if self._pending_sample is None:
                return False        # replay below min_replay: keep reaping
            if not self._start_fetch(block=block):
                if not block:
                    return False
                if self._pending_sample is None and self._fetching is None:
                    return False    # sampled empty: the caller reaps more

    def _apply_update(self, trajs: List[Dict], versions: List[int]):
        gap = self.version - min(versions)
        self._gap_counts[gap] = self._gap_counts.get(gap, 0) + 1
        metrics.get_or_create(
            metrics.Histogram, "rllib_offpolicy_gap",
            "learner_version - trajectory_version at update time (the "
            "off-policy gap V-trace corrects)",
            boundaries=(0.5, 1.5, 2.5, 4.5, 8.5, 16.5)).observe(float(gap))
        if self.max_staleness is not None and gap > self.max_staleness:
            self._stale_dropped += len(trajs)
            metrics.get_or_create(
                metrics.Counter, "rllib_stale_dropped",
                "replay samples dropped for exceeding "
                "sebulba_max_staleness").inc(len(trajs))
            return
        cols = [SampleBatch({k: v for k, v in t.items() if k not in ("version", "actor")})
                for t in trajs]
        batch = cols[0] if len(cols) == 1 else SampleBatch.concat(cols, axis=1)
        t0 = time.time()
        self._last_learn = self.algo._sebulba_update(batch)
        t1 = time.time()
        self.updates += 1
        self.version += 1
        tracing.ship_window("pipeline.learn", "rllib", None, t0, t1, tid=os.getpid(),
                            args={"version": self.version, "gap": gap})
        metrics.get_or_create(metrics.Counter, "rllib_learner_steps",
                              "sebulba learner updates").inc()
        metrics.get_or_create(
            metrics.Gauge, "rllib_param_version",
            "params version in use (learner: published; rollout: received)",
            tag_keys=("role",)).set(self.version, tags={"role": "learner"})
        if self.updates % self.broadcast_interval == 0:
            self._broadcast(block=self.lockstep)

    def _broadcast(self, block: bool = False):
        import ray_tpu_torch as rt
        wref = rt.put(self.algo.get_weights())
        acks = [a.set_weights.remote(wref, self.version) for a in self.actors]
        del wref
        self._broadcasts += 1
        if not block:
            self._broadcasts_async += 1
        metrics.get_or_create(
            metrics.Counter, "rllib_broadcasts",
            "sebulba param broadcasts (fire-and-forget except lockstep)",
            tag_keys=("kind",)).inc(1, tags={"kind": "blocking" if block else "async"})
        if block:
            rt.get(acks)

    # -- iteration ----------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt
        from .algorithm import _merge_runner_metrics
        target = self.cfg.train_batch_size
        steps = self._step_lockstep(target) if self.lockstep else self._step_async(target)
        self.algo._env_steps_iter += steps
        rms = rt.get([a.pop_metrics.remote() for a in self.actors])
        result = _merge_runner_metrics(rms)
        result["num_env_steps_sampled_this_iter"] = steps
        result["learner"] = dict(self._last_learn)
        result["sebulba"] = self.stats(remote=False)
        return result

    def _step_async(self, target: int) -> int:
        steps = 0
        updates_before = self.updates
        while steps < target:
            steps += self._reap(block=True)
            self._learn_turn(block=False)
        # an iteration must learn at least once (replay has an admission by
        # now, so a blocking turn can only stall on a dry fifo, which
        # reaping keeps feeding)
        while self.updates == updates_before:
            if not self._learn_turn(block=True):
                self._reap(block=True)
        return steps

    def _step_lockstep(self, target: int) -> int:
        """Strictly sequential schedule: sample -> admit -> replay (fifo) ->
        fetch -> update -> blocking broadcast. Reproduces the synchronous
        IMPALA iteration exactly."""
        import ray_tpu_torch as rt
        steps = 0
        while steps < target:
            tref, iref = self.actors[0].sample_traj.remote()
            info = rt.get(iref)
            self.replay.add_refs.remote([tref], [int(info["version"])])
            del tref
            self._replay_admitted += 1
            steps += int(info["steps"])
            self._env_steps_total += int(info["steps"])
            self._count_env_steps(int(info["steps"]))
            pairs = rt.get(self.replay.sample_refs.remote(1))
            trajs = rt.get([p[0] for p in pairs])
            self._apply_update(trajs, [int(p[1]) for p in pairs])
        return steps

    # -- introspection ------------------------------------------------------
    def stats(self, remote: bool = True) -> Dict[str, Any]:
        s: Dict[str, Any] = {
            "version": self.version, "updates": self.updates,
            "broadcasts": self._broadcasts,
            "broadcasts_async": self._broadcasts_async,
            "env_steps": self._env_steps_total,
            "replay_admitted": self._replay_admitted,
            "stale_dropped": self._stale_dropped,
            "gap_counts": dict(self._gap_counts),
            "num_rollout_actors": len(self.actors),
            "inflight": len(self._inflight),
            "lockstep": self.lockstep,
            "jit_cache_size": self.algo.learner.jit_cache_size(),
            "counters": metrics.rllib_sebulba_counters(),
            "offpolicy_gap": metrics.rllib_offpolicy_gap_summary(),
        }
        if remote and self.replay is not None:
            import ray_tpu_torch as rt
            s["replay"] = rt.get(self.replay.stats.remote())
        return s

    # -- teardown -----------------------------------------------------------
    def shutdown(self):
        """Leak-free stop: drain in-flight work, await the replay actor's
        clear() (its slot borrows must drop before the handle does), then
        release every handle."""
        if self._closed:
            return
        self._closed = True
        import ray_tpu_torch as rt
        try:
            if self._inflight:
                irefs = [e[0] for e in self._inflight.values()]
                rt.wait(irefs, num_returns=len(irefs), timeout=30.0)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        self._inflight.clear()
        if self._fetching is not None:
            try:
                self._fetching[0].result(timeout=30)
            except Exception:  # noqa: BLE001
                pass
            self._fetching = None
        if self._pending_sample is not None:
            try:
                rt.get(self._pending_sample)
            except Exception:  # noqa: BLE001
                pass
            self._pending_sample = None
        self._pool.shutdown(wait=True)
        try:
            if self.replay is not None:
                rt.get(self.replay.clear.remote())
        except Exception:  # noqa: BLE001
            pass
        self.replay = None
        self.actors = []
