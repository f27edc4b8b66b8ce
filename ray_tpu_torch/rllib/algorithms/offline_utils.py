"""Helpers shared by the offline continuous-control algorithms (CQL, IQL):
the port's counterpart of `ray_tpu/rllib/algorithms/offline_utils.py`.

Both load an (obs, actions, rewards, next_obs, terminateds) dataset, infer
a continuous ModuleSpec and the action bounds from it, train on seeded
minibatches, and evaluate by rolling the squashed-Gaussian actor's mode
in a real env (on the host CPU, from a CPU copy of the weights).
"""

from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops.optim import make_optimizer
from .. import sample_batch as SB
from ..buffers import TRANSITION_KEYS
from ..learner import _host_metrics
from ..offline import as_sample_batch
from ..rl_module import ModuleSpec


def load_continuous_dataset(config) -> Tuple[Dict[str, np.ndarray], int, ModuleSpec,
                                             float, float]:
    """Returns (data, n_rows, spec, action_low, action_high)."""
    batch = as_sample_batch(config.offline_data)
    data = {k: np.asarray(batch[k]) for k in TRANSITION_KEYS}
    acts = data[SB.ACTIONS]
    if acts.ndim == 1:
        acts = acts[:, None]
        data[SB.ACTIONS] = acts
    low = config.action_low if config.action_low is not None else float(acts.min())
    high = config.action_high if config.action_high is not None else float(acts.max())
    spec = ModuleSpec(data[SB.OBS].shape[1:], "continuous", acts.shape[-1],
                      tuple(config.model.get("hiddens", (256, 256))))
    return data, len(data[SB.OBS]), spec, low, high


def make_offline_optimizer(config, params):
    """An optimizer over `params` from the config's lr, lr_schedule,
    optimizer and grad_clip: one a net, as JAX keeps one opt_state a net of
    one optax chain. Returns (optimizer, schedule)."""
    return make_optimizer(params, lr=config.lr, lr_schedule=getattr(config, "lr_schedule", None),
                          optimizer=getattr(config, "optimizer", "adam"),
                          grad_clip=getattr(config, "grad_clip", None))


def offline_training_step(algo, step_once) -> Dict:
    """The shared minibatch loop: `train_intensity` minibatches of
    `train_batch_size` rows drawn from `algo._rng` (numpy, seeded as JAX's),
    each through `step_once(minibatch, update_index)`, which returns the
    update's metrics (device tensors). The last update's metrics are read
    once. cur_lr is the lr of the last update applied (the schedule at the
    count before it, as the learners report it)."""
    cfg = algo.config
    last = {}
    lr_used = float(algo._lr_schedule(algo._updates))
    for _ in range(cfg.train_intensity):
        idx = algo._rng.integers(0, algo._n, size=cfg.train_batch_size)
        mb = {k: v[idx] for k, v in algo._data.items()}
        lr_used = float(algo._lr_schedule(algo._updates))
        last = step_once(mb, algo._updates)
        algo._updates += 1
    learner = _host_metrics([last])
    learner["cur_lr"] = lr_used
    return {"learner": learner, "num_env_steps_sampled_this_iter": 0}


@torch.no_grad()
def evaluate_continuous(algo) -> Dict:
    """Mode-policy episodes in `config.env` on the host CPU ({} without an
    env)."""
    cfg = algo.config
    if cfg.env is None:
        return {}
    import gymnasium as gym
    env = gym.make(cfg.env) if isinstance(cfg.env, str) else cfg.env()
    net = getattr(algo, "_eval_net", None)
    if net is None:    # one CPU net an algorithm, loaded anew each evaluation
        net = algo._eval_net = algo.module.make_net(cfg.seed)
    net.load_state_dict(algo.get_weights())
    rets, lens = [], []
    for ep in range(cfg.evaluation_duration):
        obs, _ = env.reset(seed=cfg.seed + 10_000 + ep)
        ret, n, done = 0.0, 0, False
        while not done:
            a, _ = algo.module.inference_step(net, torch.from_numpy(obs[None].astype(np.float32)))
            a = np.clip(a.numpy()[0], algo.module.low, algo.module.high)
            obs, r, term, trunc, _ = env.step(a)
            ret += float(r)
            n += 1
            done = term or trunc
        rets.append(ret)
        lens.append(n)
    env.close()
    return {"episodes_this_iter": len(rets),
            "episode_return_mean": float(np.mean(rets)),
            "episode_return_max": float(np.max(rets)),
            "episode_return_min": float(np.min(rets)),
            "episode_len_mean": float(np.mean(lens))}
