from .appo import APPO, APPOConfig
from .bc import BC, BCConfig, MARWIL, MARWILConfig
from .cql import CQL, CQLConfig
from .dqn import DQN, DQNConfig
from .dreamerv3 import DreamerV3, DreamerV3Config
from .impala import IMPALA, IMPALAConfig
from .iql import IQL, IQLConfig
from .ppo import PPO, PPOConfig
from .sac import SAC, SACConfig
from .tqc import TQC, TQCConfig

__all__ = ["PPO", "PPOConfig", "APPO", "APPOConfig", "DQN", "DQNConfig",
           "IMPALA", "IMPALAConfig", "SAC", "SACConfig", "BC", "BCConfig",
           "MARWIL", "MARWILConfig", "CQL", "CQLConfig", "IQL", "IQLConfig",
           "TQC", "TQCConfig", "DreamerV3", "DreamerV3Config"]
