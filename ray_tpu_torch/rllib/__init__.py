"""ray_tpu_torch.rllib: the port of `ray_tpu.rllib`'s core to PyTorch.

AlgorithmConfig/Algorithm drive iterations; an inline EnvRunner collects
rollouts on the host CPU, or a DeviceRollout unrolls CartPole on the card;
a TorchLearner runs each SGD step on its device ("cuda" by default). PPO,
IMPALA and APPO are ported; the other algorithms, multi-agent, replay
buffers and sebulba's actors are later slices (ROADMAP §A item 5).
gymnasium is imported only where an env is made.
"""

from .algorithm import Algorithm, AlgorithmConfig
from .algorithms import APPO, APPOConfig, IMPALA, IMPALAConfig, PPO, PPOConfig
from .env_runner import EnvRunner
from .learner import LearnerGroup, TorchLearner, make_learner_group
from .rl_module import ModuleSpec, PolicyValueNet, RLModule
from .sample_batch import SampleBatch
from .sebulba import DeviceRollout, TorchCartPole

__all__ = [
    "Algorithm", "AlgorithmConfig", "EnvRunner", "TorchLearner", "LearnerGroup",
    "make_learner_group", "ModuleSpec", "PolicyValueNet", "RLModule", "SampleBatch",
    "DeviceRollout", "TorchCartPole", "PPO", "PPOConfig", "APPO", "APPOConfig",
    "IMPALA", "IMPALAConfig",
]
