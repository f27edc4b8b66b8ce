"""Multi-agent RL: the port's counterpart of `ray_tpu/rllib/multi_agent.py`
(reference: rllib/env/multi_agent_env.py, rllib/policy/policy_map.py and
the multi-agent episode handling).

Protocol: a MultiAgentEnv steps all live agents at once, with dict
observations and actions keyed by agent id (the reference's
simultaneous-action subset). A policy_mapping_fn assigns each agent a
policy id; "shared" and "independent" learning are two mappings (all to
one policy, or one policy an agent).

The runner acts on the host CPU, as the `EnvRunner` does: each policy has
a CPU net that holds a copy of the weights it is given, and its agents
are the rows of one forward a step, so a step runs one forward a policy
however many agents share it. Each policy draws from its own
`torch.Generator`, seeded `(seed + i) ^ 0x5eed` for the i-th policy id in
sorted order (JAX folds one key a step), so explored actions differ from
JAX's; greedy (`explore=False`) rollouts are JAX's.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import sample_batch as SB
from .rl_module import ModuleSpec, RLModule
from .sample_batch import SampleBatch


class MultiAgentEnv:
    """Base class (reference: ray.rllib.env.MultiAgentEnv).

    Subclasses define:
      possible_agents: list of agent ids
      observation_spaces / action_spaces: {agent_id: gymnasium.Space}
      reset(seed=None) -> (obs_dict, info_dict)
      step(action_dict) -> (obs, rewards, terminateds, truncateds, infos),
        each a per-agent dict; terminateds/truncateds carry "__all__".
    """

    possible_agents: List[str] = []
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    def reset(self, *, seed: Optional[int] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def get_observation_space(self, agent_id: str):
        return self.observation_spaces[agent_id]

    def get_action_space(self, agent_id: str):
        return self.action_spaces[agent_id]


class MultiAgentBatch:
    """{policy_id: SampleBatch([T, k])} and the env step count (reference:
    rllib/policy/sample_batch.py MultiAgentBatch)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch], env_steps: int):
        self.policy_batches = policy_batches
        self._env_steps = env_steps

    def env_steps(self) -> int:
        return self._env_steps

    def agent_steps(self) -> int:
        return sum(b[SB.REWARDS].size for b in self.policy_batches.values())

    def __getitem__(self, policy_id: str) -> SampleBatch:
        return self.policy_batches[policy_id]

    def keys(self):
        return self.policy_batches.keys()


class MultiAgentEnvRunner:
    """Collects [T, k]-shaped rollouts a policy from one MultiAgentEnv, each
    policy's k agents the rows of one batched forward."""

    def __init__(self, env_creator: Callable[[], MultiAgentEnv], *,
                 policy_mapping_fn: Callable[[str], str], modules: Dict[str, RLModule],
                 rollout_len: int = 200, explore: bool = True, seed: int = 0):
        self.env = env_creator()
        self.policy_mapping_fn = policy_mapping_fn
        self.modules = modules
        self.rollout_len = rollout_len
        self.explore = explore
        self._seed = seed
        self.agents = list(self.env.possible_agents)
        # a stable agent order a policy: fixed batch rows
        self.policy_agents: Dict[str, List[str]] = {}
        for aid in self.agents:
            pid = policy_mapping_fn(aid)
            if pid not in modules:
                raise KeyError(f"policy_mapping_fn({aid!r}) -> {pid!r} not in "
                               f"policies {sorted(modules)}")
            self.policy_agents.setdefault(pid, []).append(aid)
        self._nets: Dict[str, torch.nn.Module] = {}    # CPU copies of the weights
        self._generators = {pid: torch.Generator().manual_seed((seed + i) ^ 0x5eed)
                            for i, pid in enumerate(sorted(modules))}
        self._obs: Optional[Dict[str, Any]] = None
        self._ep_return = 0.0
        self._ep_len = 0
        self._completed: List[Dict] = []

    def init_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fresh params a policy, on the CPU, seeded `seed + i` in sorted
        policy order."""
        return {pid: m.init(self._seed + i) for i, (pid, m) in enumerate(sorted(self.modules.items()))}

    def _load(self, params_per_policy):
        for pid, params in params_per_policy.items():
            if pid not in self._nets:
                self._nets[pid] = self.modules[pid].make_net(self._seed)
            self._nets[pid].load_state_dict(params)

    def _act(self, pid, obs):
        module, net = self.modules[pid], self._nets[pid]
        if self.explore:
            return module.explore_step(net, obs, self._generators[pid])
        action, value = module.inference_step(net, obs)
        return action, torch.zeros(value.shape), value

    def _stack_obs(self, obs: Dict[str, Any], pid: str) -> np.ndarray:
        return np.stack([np.asarray(obs[a], np.float32) for a in self.policy_agents[pid]])

    @torch.no_grad()
    def sample(self, params_per_policy: Dict[str, Any]) -> Tuple[MultiAgentBatch, Dict]:
        self._load(params_per_policy)
        T = self.rollout_len
        if self._obs is None:
            self._obs, _ = self.env.reset(seed=self._seed)

        bufs = {}
        for pid, agents in self.policy_agents.items():
            k = len(agents)
            obs_shape = np.asarray(self._obs[agents[0]]).shape
            bufs[pid] = {
                SB.OBS: np.empty((T, k) + obs_shape, np.float32), SB.ACTIONS: None,
                SB.REWARDS: np.zeros((T, k), np.float32), SB.DONES: np.zeros((T, k), np.float32),
                "terms": np.zeros((T, k), np.float32), SB.LOGP: np.zeros((T, k), np.float32),
                SB.VF_PREDS: np.zeros((T, k), np.float32),
            }

        for t in range(T):
            action_dict = {}
            for pid, agents in self.policy_agents.items():
                ob = self._stack_obs(self._obs, pid)
                a, logp, v = self._act(pid, torch.from_numpy(ob))
                a = a.numpy()
                b = bufs[pid]
                if b[SB.ACTIONS] is None:
                    b[SB.ACTIONS] = np.empty((T,) + a.shape, a.dtype)
                b[SB.OBS][t] = ob
                b[SB.ACTIONS][t] = a
                b[SB.LOGP][t] = logp.numpy()
                b[SB.VF_PREDS][t] = v.numpy()
                for i, aid in enumerate(agents):
                    action_dict[aid] = a[i]
            obs, rew, term, trunc, _info = self.env.step(action_dict)
            done_all = bool(term.get("__all__", False) or trunc.get("__all__", False))
            for pid, agents in self.policy_agents.items():
                b = bufs[pid]
                for i, aid in enumerate(agents):
                    b[SB.REWARDS][t, i] = rew.get(aid, 0.0)
                    agent_term = bool(term.get(aid, False))
                    b["terms"][t, i] = float(agent_term)
                    b[SB.DONES][t, i] = float(agent_term or done_all or bool(trunc.get(aid, False)))
            self._ep_return += float(sum(rew.values()))
            self._ep_len += 1
            if done_all:
                self._completed.append({"return": self._ep_return, "len": self._ep_len})
                self._ep_return, self._ep_len = 0.0, 0
                obs, _ = self.env.reset()
            self._obs = obs

        batches = {}
        for pid in self.policy_agents:
            b = bufs[pid]
            _, boot = self.modules[pid].forward(self._nets[pid],
                                                torch.from_numpy(self._stack_obs(self._obs, pid)))
            b[SB.BOOTSTRAP_VALUE] = boot.numpy() * (1.0 - b.pop("terms")[-1])
            batches[pid] = SampleBatch(b)
        return MultiAgentBatch(batches, env_steps=T), self._metrics()

    def _metrics(self) -> Dict:
        eps, self._completed = self._completed, []
        if not eps:
            return {"episodes_this_iter": 0}
        rets = [e["return"] for e in eps]
        lens = [e["len"] for e in eps]
        return {"episodes_this_iter": len(eps),
                "episode_return_mean": float(np.mean(rets)),
                "episode_return_max": float(np.max(rets)),
                "episode_return_min": float(np.min(rets)),
                "episode_len_mean": float(np.mean(lens))}


def module_specs_for(env: MultiAgentEnv, policy_mapping_fn: Callable,
                     hiddens=(256, 256)) -> Dict[str, ModuleSpec]:
    """One ModuleSpec a policy, from a representative agent's spaces."""
    specs = {}
    for aid in env.possible_agents:
        pid = policy_mapping_fn(aid)
        if pid not in specs:
            specs[pid] = ModuleSpec.from_spaces(env.get_observation_space(aid),
                                                env.get_action_space(aid), hiddens=hiddens)
    return specs
