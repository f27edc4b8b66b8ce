"""ray_tpu_torch.rllib: the port of `ray_tpu.rllib` to PyTorch.

AlgorithmConfig/Algorithm drive iterations; an inline EnvRunner (or a
MultiAgentEnvRunner) collects rollouts on the host CPU, or a DeviceRollout
unrolls CartPole on the card; the learners run each update on their
device ("cuda" by default). Ported: PPO (with its multi-agent mode),
IMPALA, APPO, DQN, SAC, TQC, BC, MARWIL, CQL, IQL and DreamerV3, the
replay buffers, and the data-parallel learner group (`num_learners > 1`:
one rank a learner, `learner.py`), and the sebulba pipeline on the
port's runtime (`SebulbaPipeline`, `RolloutActor`, `ReplayActor`), and
the remote env runners and evaluation actors on that runtime
(`num_env_runners`, `evaluation_num_env_runners`).
gymnasium is imported only where an env is made.
"""

from .algorithm import Algorithm, AlgorithmConfig
from .algorithms import (APPO, APPOConfig, BC, BCConfig, CQL, CQLConfig, DQN, DQNConfig,
                         DreamerV3, DreamerV3Config, IMPALA, IMPALAConfig, IQL, IQLConfig,
                         MARWIL, MARWILConfig, PPO, PPOConfig, SAC, SACConfig, TQC, TQCConfig)
from .buffers import PrioritizedReplayBuffer, ReplayActor, ReplayBuffer
from .env_runner import EnvRunner
from .learner import LearnerGroup, TorchLearner, make_learner_group
from .rl_module import ModuleSpec, PolicyValueNet, RLModule
from .sample_batch import SampleBatch
from .sebulba import DeviceRollout, RolloutActor, SebulbaPipeline, TorchCartPole

__all__ = [
    "Algorithm", "AlgorithmConfig", "EnvRunner", "TorchLearner", "LearnerGroup",
    "make_learner_group", "ModuleSpec", "PolicyValueNet", "RLModule", "SampleBatch",
    "ReplayBuffer", "PrioritizedReplayBuffer", "ReplayActor", "SebulbaPipeline",
    "RolloutActor", "DeviceRollout", "TorchCartPole",
    "PPO", "PPOConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "IMPALA", "IMPALAConfig",
    "SAC", "SACConfig", "BC", "BCConfig", "MARWIL", "MARWILConfig", "CQL", "CQLConfig",
    "IQL", "IQLConfig", "TQC", "TQCConfig", "DreamerV3", "DreamerV3Config",
]
