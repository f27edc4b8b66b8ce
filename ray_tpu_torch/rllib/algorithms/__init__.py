from .appo import APPO, APPOConfig
from .impala import IMPALA, IMPALAConfig
from .ppo import PPO, PPOConfig

__all__ = ["PPO", "PPOConfig", "APPO", "APPOConfig", "IMPALA", "IMPALAConfig"]
