"""DreamerV3: the port's counterpart of `ray_tpu/rllib/algorithms/dreamerv3.py`
(reference: rllib/algorithms/dreamerv3; paper arXiv:2301.04104).

A Recurrent State-Space Model (RSSM) world model learns from replayed
[B, T] sequences; the actor and critic learn inside H-step imagined
rollouts from every posterior state: symlog-MSE reconstruction, a
twohot-symlog reward head, a Bernoulli continue head, KL balancing with
free bits, lambda-returns, a percentile-normalized REINFORCE actor with an
entropy bonus, and a twohot critic regularized toward its EMA.

JAX runs the observe pass, the imagination and the lambda-return
recursion as `lax.scan`s inside one jitted update; here they are Python
loops over T and H of eager PyTorch on `config.device` ("cuda" unless the
config asks for the CPU). The update keeps JAX's order: the world model
steps first (global-norm clip 1000, then Adam(wm_lr)); imagination runs
under the updated world model, the old actor and the old critic, with no
gradient; the actor re-scores the rollout's own actions; the critic's
regularizer takes the old EMA critic; the EMA then follows the new
critic. Actor and critic each have their own Adam (clip 100, then
Adam(ac_lr)). `ret_scale` is state carried from update to update.

Layout. The nets are `nn.Module`s whose state_dicts mirror flax's trees
(`Dense_i`, `LayerNorm_i`; the actor's and critic's `_MLP_0` is `mlp`),
and `models/convert.flax_dreamer_to_state_dict` carries JAX's weights
across. The GRU cell is flax's: its hidden products for the r and z gates
have no bias, only the n gate's does (torch.nn.GRUCell has b_hr and b_hz,
which would train away from JAX's). LayerNorm's epsilon is flax's 1e-6.

Draws. `jax.random.categorical(key, logits)` is argmax(logits + Gumbel).
`_update` and `_act` take their Gumbels (and the continuous actor's
normals) as `noise`, so a test can replay JAX's key chain; without it the
update draws from a `torch.Generator` on its device seeded
seed * 7919 + updates (JAX's key for that update), and acting from one
seeded `seed`. These are not JAX's draws.

Acting is an inline recurrent loop on `config.device` (the actor carries
(h, z, a_prev) across env steps): one host copy of the action an env step.
The env is `config.env()` when it is a callable; gymnasium is imported
only to make a named env.
"""

import collections
import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.torsos import lecun_normal_
from ray_tpu_torch.ops.optim import make_optimizer
from ..algorithm import Algorithm, AlgorithmConfig
from ..learner import _host_metrics

F32_TINY = float(np.finfo(np.float32).tiny)
LOG_2PI = math.log(2 * math.pi)
LOG_2PI_E = math.log(2 * math.pi * math.e)


# ----------------------------------------------------------- symlog / twohot
def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def twohot(x, bins):
    """Encode scalars as weight over the two nearest bins. x: [...], bins
    [K] ascending -> [..., K]."""
    k = bins.shape[0]
    idx = (bins <= x[..., None]).sum(-1) - 1
    idx = idx.clamp(0, k - 2)
    lo, hi = bins[idx], bins[idx + 1]
    w_hi = ((x - lo) / torch.clamp_min(hi - lo, 1e-8)).clamp(0.0, 1.0)
    oh_lo = F.one_hot(idx, k).to(x.dtype) * (1.0 - w_hi)[..., None]
    oh_hi = F.one_hot(idx + 1, k).to(x.dtype) * w_hi[..., None]
    return oh_lo + oh_hi


def _bins(k=255, lo=-20.0, hi=20.0, fused=True):
    """JAX's `jnp.linspace(lo, hi, k)` bit for bit, in f32 on the CPU.
    XLA computes it as lo * (1 - i r) + i (hi r), r = f32(1 / (k - 1)).
    Called eagerly (JAX's twohot and critic bins), the last multiply-add is
    fused (one rounding); inside a jitted function (JAX's reward head) the
    compiler folds the constant without fusing it: `fused=False`."""
    f = np.float32
    r = f(1) / f(k - 1)
    i = np.arange(k - 1, dtype=f)
    a = f(lo) * (f(1) - i * r)
    if fused:   # the product i * (hi r) is exact in f64, so one rounding to f32
        out = (i.astype(np.float64) * np.float64(f(hi) * r) + a).astype(f)
    else:
        out = a + i * (f(hi) * r)
    return torch.from_numpy(np.append(out, f(hi)))


# ------------------------------------------------------------------- modules
def _dense(n_in, n_out, generator, bias=True):
    """flax's nn.Dense: LeCun-normal kernel, zero bias."""
    layer = nn.Linear(n_in, n_out, bias=bias)
    lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class _MLP(nn.Module):
    """flax's `_MLP`: silu(LayerNorm(Dense(s)(x))) a size, then Dense(out)."""

    def __init__(self, n_in, sizes, out, generator=None):
        super().__init__()
        self.n_hidden = len(sizes)
        for i, s in enumerate(sizes):
            self.add_module(f"Dense_{i}", _dense(n_in, s, generator))
            self.add_module(f"LayerNorm_{i}", nn.LayerNorm(s, eps=1e-6))
            n_in = s
        self.add_module(f"Dense_{len(sizes)}", _dense(n_in, out, generator))

    def forward(self, x):
        for i in range(self.n_hidden):
            x = F.silu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.n_hidden}")(x)


class _GRUCell(nn.Module):
    """flax's `nn.GRUCell`: r = sigmoid(x W_ir + b_ir + h W_hr), z likewise,
    n = tanh(x W_in + b_in + r (h W_hn + b_hn)), h' = (1 - z) n + z h. The
    input products of r, z and n are one [3 deter, in] product with a bias;
    the hidden ones one [3 deter, deter] product, with a bias on n only.
    Input kernels LeCun normal, hidden kernels orthogonal, as flax's."""

    def __init__(self, n_in, features, generator=None):
        super().__init__()
        self.w_i = nn.Parameter(torch.empty(3 * features, n_in))
        self.b_i = nn.Parameter(torch.zeros(3 * features))
        self.w_h = nn.Parameter(torch.empty(3 * features, features))
        self.b_hn = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            for c in range(3):
                rows = slice(c * features, (c + 1) * features)
                lecun_normal_(self.w_i[rows], generator)
                nn.init.orthogonal_(self.w_h[rows], generator=generator)

    def forward(self, h, x):
        xr, xz, xn = F.linear(x, self.w_i, self.b_i).chunk(3, -1)
        hr, hz, hn = F.linear(h, self.w_h).chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + self.b_hn))
        return (1.0 - z) * n + z * h


class _WorldModel(nn.Module):
    """Encoder + RSSM + decoder/reward/continue heads for vector obs."""

    def __init__(self, obs_dim, action_dim, deter, stoch, classes, hiddens,
                 reward_bins=255, generator=None):
        super().__init__()
        self.deter, self.stoch, self.classes = deter, stoch, classes
        z_dim, e = stoch * classes, hiddens[-1]
        feat = deter + z_dim
        self.encoder = _MLP(obs_dim, hiddens, e, generator)
        self.gru = _GRUCell(e, deter, generator)
        self.img_in = _MLP(z_dim + action_dim, (e,), e, generator)
        self.prior_net = _MLP(deter, (e,), z_dim, generator)
        self.post_net = _MLP(deter + e, (e,), z_dim, generator)
        self.decoder = _MLP(feat, hiddens, obs_dim, generator)
        self.reward_head = _MLP(feat, hiddens, reward_bins, generator)
        self.cont_head = _MLP(feat, hiddens, 1, generator)
        # the values JAX's reward head sees inside its jitted update
        self.register_buffer("bins", _bins(reward_bins, fused=False), persistent=False)

    # -- latent utilities
    def _logits(self, raw):
        lg = raw.reshape(raw.shape[:-1] + (self.stoch, self.classes))
        # 1% uniform mixing keeps KL finite and gradients alive
        probs = 0.99 * torch.softmax(lg, -1) + 0.01 / self.classes
        return torch.log(probs)

    def _sample(self, logits, gumbel, draws=None):
        """A straight-through one-hot draw of each latent: argmax(logits +
        gumbel), JAX's `jax.random.categorical`. gumbel: logits' shape.
        `draws`, a list when given, receives the perturbed logits."""
        pert = gumbel + logits
        if draws is not None:
            draws.append(pert.detach())
        oh = F.one_hot(pert.argmax(-1), self.classes).to(logits.dtype)
        probs = torch.softmax(logits, -1)
        st = oh + probs - probs.detach()   # straight-through
        return st.reshape(st.shape[:-2] + (self.stoch * self.classes,))

    # -- one posterior (observe) step: carry (h, z_prev) over time
    def obs_step(self, h, z_prev, a_prev, embed, is_first, gumbel, prior=True, draws=None):
        """is_first: a tensor of the batch's leading shape (nonzero resets
        the carry), or a Python bool for one unbatched step. With
        prior=False the prior logits are not computed (None). `draws` as
        `_sample`'s."""
        if isinstance(is_first, torch.Tensor):
            first = is_first[..., None] != 0
            h = torch.where(first, 0.0, h)
            z_prev = torch.where(first, 0.0, z_prev)
            a_prev = torch.where(first, 0.0, a_prev)
        elif is_first:
            h, z_prev, a_prev = (torch.zeros_like(v) for v in (h, z_prev, a_prev))
        x = self.img_in(torch.cat([z_prev, a_prev], -1))
        h = self.gru(h, x)
        prior_logits = self._logits(self.prior_net(h)) if prior else None
        post_logits = self._logits(self.post_net(torch.cat([h, embed], -1)))
        z = self._sample(post_logits, gumbel, draws)
        return h, z, prior_logits, post_logits

    # -- one prior (imagine) step
    def img_step(self, h, z, a, gumbel, draws=None):
        x = self.img_in(torch.cat([z, a], -1))
        h = self.gru(h, x)
        prior_logits = self._logits(self.prior_net(h))
        return h, self._sample(prior_logits, gumbel, draws)

    def embed(self, obs):
        return self.encoder(symlog(obs))

    def heads(self, feat):
        recon = self.decoder(feat)
        reward_logits = self.reward_head(feat)
        cont_logit = self.cont_head(feat)[..., 0]
        return recon, reward_logits, cont_logit

    def reward(self, feat):
        probs = torch.softmax(self.reward_head(feat), -1)
        return symexp((probs * self.bins).sum(-1))

    def cont(self, feat):
        return torch.sigmoid(self.cont_head(feat)[..., 0])


class _Actor(nn.Module):
    def __init__(self, feat_dim, action_dim, discrete, hiddens, generator=None):
        super().__init__()
        out = action_dim if discrete else 2 * action_dim
        self.mlp = _MLP(feat_dim, hiddens, out, generator)

    def forward(self, feat):
        return self.mlp(feat)


class _Critic(nn.Module):
    def __init__(self, feat_dim, hiddens, bins=255, generator=None):
        super().__init__()
        self.mlp = _MLP(feat_dim, hiddens, bins, generator)

    def forward(self, feat):
        return self.mlp(feat)


def _critic_value(logits, bins):
    return symexp((torch.softmax(logits, -1) * bins).sum(-1))


def gumbel_like(shape, generator, device):
    """JAX's Gumbel: -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(F32_TINY)))


# -------------------------------------------------------------------- config
class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DreamerV3
        # model scale (reference model_size="XS" analog)
        self.deter = 256
        self.stoch = 8
        self.classes = 8
        self.model = {"hiddens": (256, 256)}
        # world-model loss
        self.free_nats = 1.0
        self.kl_dyn_scale = 0.5
        self.kl_rep_scale = 0.1
        self.wm_lr = 1e-4
        # actor-critic (imagination)
        self.horizon = 15
        self.gamma = 0.997
        self.lambda_ = 0.95
        self.ac_lr = 3e-5
        self.entropy_scale = 3e-4
        self.critic_ema_decay = 0.98
        self.critic_ema_scale = 1.0
        self.return_norm_decay = 0.99
        # replay / schedule
        self.batch_size_B = 8
        self.batch_length_T = 24
        self.replay_capacity = 50_000
        self.rollout_fragment_length = 64   # env steps collected per iter
        self.num_steps_sampled_before_learning_starts = 512
        self.train_intensity = 1            # updates per training_step


# ---------------------------------------------------------- sequence replay
class _SequenceReplay:
    """Flat transition store with is_first markers on host numpy; samples
    [B, T] windows uniformly in time order (windows may span episode
    boundaries: obs_step resets on is_first). JAX's, draw for draw."""

    def __init__(self, capacity, seed):
        self.capacity = capacity
        self._store = None
        self._n = 0
        self._ptr = 0
        self._rng = np.random.default_rng(seed)

    def add(self, rows: Dict[str, np.ndarray]):
        m = len(next(iter(rows.values())))
        if self._store is None:
            self._store = {k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                           for k, v in rows.items()}
        idx = (self._ptr + np.arange(m)) % self.capacity
        for k, v in rows.items():
            self._store[k][idx] = v
        self._ptr = (self._ptr + m) % self.capacity
        self._n = min(self._n + m, self.capacity)

    def __len__(self):
        return self._n

    def sample(self, b, t):
        # logical 0 is the oldest row (raw _ptr once wrapped), so no window
        # straddles the ring's write seam
        base = self._ptr if self._n == self.capacity else 0
        starts = self._rng.integers(0, self._n - t + 1, size=b)
        idx = (base + starts[:, None] + np.arange(t)[None, :]) % self.capacity
        return {k: v[idx] for k, v in self._store.items()}


# ----------------------------------------------------------------- algorithm
class DreamerV3(Algorithm):
    def setup(self, config: DreamerV3Config):
        if isinstance(config.env, str):
            import gymnasium as gym
            env = gym.make(config.env)
        else:
            env = config.env()
        self._env = env
        obs_space, act_space = env.observation_space, env.action_space
        self._discrete = hasattr(act_space, "n")
        obs_dim = int(np.prod(obs_space.shape))
        action_dim = int(act_space.n) if self._discrete else int(np.prod(act_space.shape))
        if not self._discrete:
            self._act_low = np.asarray(act_space.low, np.float32)
            self._act_high = np.asarray(act_space.high, np.float32)
        self.device = dev = resolve_device(config.device)
        hiddens = tuple(config.model.get("hiddens", (256, 256)))
        z_dim = config.stoch * config.classes
        feat_dim = config.deter + z_dim
        gen = torch.Generator().manual_seed(config.seed)
        self.wm = _WorldModel(obs_dim, action_dim, config.deter, config.stoch, config.classes,
                              hiddens, generator=gen).to(dev)
        self.actor = _Actor(feat_dim, action_dim, self._discrete, hiddens, gen).to(dev)
        self.critic = _Critic(feat_dim, hiddens, generator=gen).to(dev)
        self.critic_ema = copy.deepcopy(self.critic).requires_grad_(False)
        self.bins = _bins().to(dev)
        self.wm_opt = make_optimizer(self.wm.parameters(), lr=config.wm_lr, grad_clip=1000.0)[0]
        self.actor_opt = make_optimizer(self.actor.parameters(), lr=config.ac_lr,
                                        grad_clip=100.0)[0]
        self.critic_opt = make_optimizer(self.critic.parameters(), lr=config.ac_lr,
                                         grad_clip=100.0)[0]
        # return-normalization EMA of (p95 - p5)
        self.ret_scale = torch.ones((), device=dev)
        self.replay = _SequenceReplay(config.replay_capacity, config.seed)
        self.env_steps = 0
        self._updates = 0
        self._act_gen = torch.Generator(dev).manual_seed(config.seed)
        # recurrent acting state, on the device
        self._h = torch.zeros(config.deter, device=dev)
        self._z = torch.zeros(z_dim, device=dev)
        self._a_prev = torch.zeros(action_dim, device=dev)
        self._obs, _ = env.reset(seed=config.seed)
        self._is_first = True
        self._r_arrival = 0.0
        self._ep_ret = 0.0
        self._ep_len = 0
        self._ep_returns = collections.deque(maxlen=100)
        self._ep_lens = collections.deque(maxlen=100)

    # ------------------------------------------------------------------ act
    def _actor_action(self, out, noise):
        """The action for the actor's output `out` [..., A or 2d], given the
        draw `noise`: Gumbels [..., A] for a discrete space (a one-hot
        argmax), standard normals [..., d] for a continuous one (tanh of
        the Gaussian draw)."""
        if self._discrete:
            return F.one_hot((noise + out).argmax(-1), out.shape[-1]).to(out.dtype)
        d = out.shape[-1] // 2
        mean, log_std = out[..., :d], out[..., d:].clamp(-5, 2)
        return torch.tanh(mean + log_std.exp() * noise)

    def _actor_entropy(self, out, logp_all=None):
        if self._discrete:
            logp_all = torch.log_softmax(out, -1) if logp_all is None else logp_all
            return -(logp_all.exp() * logp_all).sum(-1)
        log_std = out[..., out.shape[-1] // 2:].clamp(-5, 2)
        return (log_std + 0.5 * LOG_2PI_E).sum(-1)

    def _act_noise(self):
        cfg, gen, dev = self.config, self._act_gen, self.device
        a_dim = self._a_prev.shape[0]
        act = (gumbel_like((a_dim,), gen, dev) if self._discrete
               else torch.randn((a_dim,), generator=gen, device=dev))
        return {"post": gumbel_like((1, cfg.stoch, cfg.classes), gen, dev), "act": act}

    @torch.no_grad()
    def _act(self, h, z, a_prev, obs, is_first, noise=None):
        """One env step's (h, z, action) on the device from the carried
        (h, z, a_prev) and the observation; `noise` as `_act_noise` draws
        it: {"post": [1, stoch, classes] Gumbels, "act": [A] Gumbels or
        [d] normals}."""
        noise = noise if noise is not None else self._act_noise()
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        embed = self.wm.embed(obs[None])
        if isinstance(is_first, torch.Tensor):
            is_first = is_first.reshape(1)
        h, z, _, _ = self.wm.obs_step(h[None], z[None], a_prev[None], embed, is_first,
                                      noise["post"], prior=False)
        out = self.actor(torch.cat([h, z], -1))
        return h[0], z[0], self._actor_action(out[0], noise["act"])

    # --------------------------------------------------------------- update
    def _update_noise(self, generator):
        """Every draw of one update, on the device: posterior Gumbels
        [T, B, stoch, classes], prior Gumbels [H, B T, stoch, classes], the
        actor's Gumbels [H, B T, A] or normals [H, B T, d]."""
        cfg, dev = self.config, self.device
        B, T, H = cfg.batch_size_B, cfg.batch_length_T, cfg.horizon
        lat = (cfg.stoch, cfg.classes)
        a_dim = self._a_prev.shape[0]
        act = (gumbel_like((H, B * T, a_dim), generator, dev) if self._discrete
               else torch.randn((H, B * T, a_dim), generator=generator, device=dev))
        return {"post": gumbel_like((T, B) + lat, generator, dev),
                "prior": gumbel_like((H, B * T) + lat, generator, dev), "act": act}

    def _wm_loss(self, b, gumbels, draws=None):
        cfg, wm = self.config, self.wm
        obs, act_seq = b["obs"], b["action"]
        rew, cont = b["reward"], 1.0 - b["is_terminated"]
        is_first = b["is_first"]
        B, T = obs.shape[:2]
        embed = wm.embed(obs)                                       # [B,T,E]
        h = obs.new_zeros((B, cfg.deter))
        z = obs.new_zeros((B, cfg.stoch * cfg.classes))
        # previous action at step t is act[t-1] (zero at t=0)
        a_prev = torch.cat([torch.zeros_like(act_seq[:, :1]), act_seq[:, :-1]], 1)
        hs, zs, priors, posts = [], [], [], []
        for t in range(T):
            h, z, prior_lg, post_lg = wm.obs_step(h, z, a_prev[:, t], embed[:, t],
                                                  is_first[:, t], gumbels[t], draws=draws)
            hs.append(h)
            zs.append(z)
            priors.append(prior_lg)
            posts.append(post_lg)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)             # [B,T,...]
        prior_lg, post_lg = torch.stack(priors, 1), torch.stack(posts, 1)
        recon, rlogits, clogit = wm.heads(torch.cat([hs, zs], -1))
        recon_loss = (recon - symlog(obs)).square().sum(-1).mean()
        rtarget = twohot(symlog(rew), self.bins)
        reward_loss = -(rtarget * torch.log_softmax(rlogits, -1)).sum(-1).mean()
        cont_loss = (torch.clamp_min(clogit, 0) - clogit * cont
                     + torch.log1p(torch.exp(-clogit.abs()))).mean()

        def kl(p_lg, q_lg):
            # KL(post||prior) per latent, summed over stoch dims
            return (p_lg.exp() * (p_lg - q_lg)).sum(-1).sum(-1)

        # free bits clip each state's KL before the mean
        free = torch.tensor(cfg.free_nats, device=obs.device)
        dyn = torch.maximum(free, kl(post_lg.detach(), prior_lg)).mean()
        rep = torch.maximum(free, kl(post_lg, prior_lg.detach())).mean()
        loss = (recon_loss + reward_loss + cont_loss
                + cfg.kl_dyn_scale * dyn + cfg.kl_rep_scale * rep)
        metrics = {"wm_recon": recon_loss, "wm_reward": reward_loss, "wm_cont": cont_loss,
                   "wm_kl_dyn": dyn, "wm_kl_rep": rep}
        return loss, hs, zs, metrics

    def _actor_logp_ent(self, feat, a):
        """Log-prob of the GIVEN actions under the actor at feat, and the
        entropy (REINFORCE needs the rollout's own actions)."""
        out = self.actor(feat)
        if self._discrete:
            logp_all = torch.log_softmax(out, -1)
            return (a * logp_all).sum(-1), self._actor_entropy(out, logp_all)
        d = out.shape[-1] // 2
        mean, log_std = out[..., :d], out[..., d:].clamp(-5, 2)
        a_c = a.clamp(-1 + 1e-6, 1 - 1e-6)
        pre = torch.atanh(a_c)
        base = -0.5 * ((pre - mean) / log_std.exp()).square() - log_std - 0.5 * LOG_2PI
        logp = (base - torch.log1p(-a_c.square() + 1e-6)).sum(-1)
        return logp, self._actor_entropy(out)

    @staticmethod
    def _step(optimizer, loss):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()

    def _update(self, batch, noise=None, draws: Optional[Dict] = None):
        """One update on a [B, T] batch (numpy or tensors: obs, action,
        reward, is_first, is_terminated); metrics are device tensors.
        `noise` as `_update_noise` draws it. `draws`, a dict when given,
        receives the perturbed logits (gumbel + logits, whose argmax is the
        sampled index) of every categorical draw: "post" [T, B, stoch,
        classes], "prior" [H, B T, stoch, classes] and, for a discrete
        actor, "act" [H, B T, A]."""
        cfg, dev = self.config, self.device
        b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}
        B, T = b["obs"].shape[:2]
        if noise is None:
            gen = torch.Generator(dev).manual_seed(cfg.seed * 7919 + self._updates)
            noise = self._update_noise(gen)
        noise = {k: torch.as_tensor(v, device=dev) for k, v in noise.items()}
        record = draws is not None
        post_draws, prior_draws, act_draws = ([], [], []) if record else (None, None, None)
        wl, hs, zs, metrics = self._wm_loss(b, noise["post"], post_draws)
        self._step(self.wm_opt, wl)

        # ---- imagination from every posterior state, under the updated world
        # model and the old actor and critic; no loss takes its gradient
        H, gamma, lam = cfg.horizon, cfg.gamma, cfg.lambda_
        with torch.no_grad():
            h, z = hs.detach().reshape(B * T, -1), zs.detach().reshape(B * T, -1)
            feats, acts, ents = [], [], []
            for t in range(H):
                feat = torch.cat([h, z], -1)
                out = self.actor(feat)
                a, ent = self._actor_action(out, noise["act"][t]), self._actor_entropy(out)
                if record and self._discrete:
                    act_draws.append(noise["act"][t] + out)
                h, z = self.wm.img_step(h, z, a, noise["prior"][t], prior_draws)
                feats.append(feat)
                acts.append(a)
                ents.append(ent)
            # feats[t] is the state the action at t was taken FROM
            all_feats = torch.stack(feats + [torch.cat([h, z], -1)])    # [H+1,N,F]
            feats, acts, ents = all_feats[:-1], torch.stack(acts), torch.stack(ents)
            rewards = self.wm.reward(all_feats[1:])                      # r after act
            conts = self.wm.cont(all_feats[1:])
            values = _critic_value(self.critic(all_feats), self.bins)   # [H+1,N]
            disc = gamma * conts
            rets, carry = [None] * H, values[-1]
            for t in reversed(range(H)):
                carry = rewards[t] + disc[t] * ((1 - lam) * values[t + 1] + lam * carry)
                rets[t] = carry
            rets = torch.stack(rets)                                     # [H,N]

            flat = rets.reshape(-1)
            p95, p5 = torch.quantile(flat, 0.95), torch.quantile(flat, 0.05)
            decay = cfg.return_norm_decay
            new_scale = decay * self.ret_scale + (1 - decay) * (p95 - p5)
            denom = torch.clamp_min(new_scale, 1.0)
            # weight imagined steps by survival probability
            live = torch.cat([torch.ones_like(conts[:1]), torch.cumprod(conts[:-1], 0)], 0)
            adv = (rets - values[:-1]) / denom
            tgt = twohot(symlog(rets), self.bins)
            ema_tgt = torch.softmax(self.critic_ema(feats), -1)

        # ---- actor (REINFORCE on the normalized advantage)
        logp, ent = self._actor_logp_ent(feats, acts)
        la = -(live * (logp * adv + cfg.entropy_scale * ent)).mean()
        self._step(self.actor_opt, la)

        # ---- critic (twohot CE to the lambda returns + EMA regularizer)
        logp_v = torch.log_softmax(self.critic(feats), -1)
        ce = -(tgt * logp_v).sum(-1)
        reg = -(ema_tgt * logp_v).sum(-1)
        lc = (live * (ce + cfg.critic_ema_scale * reg)).mean()
        self._step(self.critic_opt, lc)
        with torch.no_grad():
            ema = list(self.critic_ema.parameters())
            torch._foreach_mul_(ema, cfg.critic_ema_decay)
            torch._foreach_add_(ema, list(self.critic.parameters()),
                                alpha=1 - cfg.critic_ema_decay)
        self.ret_scale = new_scale

        if record:
            draws["post"], draws["prior"] = torch.stack(post_draws), torch.stack(prior_draws)
            if self._discrete:
                draws["act"] = torch.stack(act_draws)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(wm_loss=wl.detach(), actor_loss=la.detach(), critic_loss=lc.detach(),
                       imagined_return=rets.mean(), return_scale=new_scale,
                       actor_entropy=ents.mean())
        return metrics

    # ------------------------------------------------------------ collection
    def _collect(self, n_steps):
        """Arrival convention (the reference's episode replay): each row is
        an OBSERVATION with the reward received on arriving at it, the action
        chosen FROM it, and whether it is terminal. Terminal arrival
        observations get their own row (zero action): the only way the
        continue head sees a terminal example."""
        rows = {"obs": [], "action": [], "reward": [], "is_first": [], "is_terminated": []}

        def emit(obs, action, reward, is_first, is_terminal):
            rows["obs"].append(obs)
            rows["action"].append(action.astype(np.float32))
            rows["reward"].append(np.float32(reward))
            rows["is_first"].append(np.float32(is_first))
            rows["is_terminated"].append(np.float32(is_terminal))

        for _ in range(n_steps):
            obs = np.asarray(self._obs, np.float32).reshape(-1)
            self._h, self._z, a_dev = self._act(self._h, self._z, self._a_prev, obs,
                                                self._is_first)
            a = a_dev.cpu().numpy()
            if self._discrete:
                env_a = int(np.argmax(a))
            else:
                # tanh output in [-1, 1] -> env bounds
                env_a = self._act_low + (a + 1) / 2 * (self._act_high - self._act_low)
            nxt, r, term, trunc, _ = self._env.step(env_a)
            emit(obs, a, self._r_arrival, self._is_first, False)
            self._r_arrival = float(r)
            self._ep_ret += float(r)
            self._ep_len += 1
            self._a_prev = a_dev
            self._is_first = False
            self._obs = nxt
            if term or trunc:
                # final arrival row: reward of the last action, terminal flag
                # only for true termination (truncation may bootstrap)
                emit(np.asarray(nxt, np.float32).reshape(-1), np.zeros_like(a), r, False, term)
                self._ep_returns.append(self._ep_ret)
                self._ep_lens.append(self._ep_len)
                self._ep_ret, self._ep_len = 0.0, 0
                self._obs, _ = self._env.reset()
                self._is_first = True
                self._r_arrival = 0.0
                self._h = torch.zeros_like(self._h)
                self._z = torch.zeros_like(self._z)
                self._a_prev = torch.zeros_like(self._a_prev)
        self.env_steps += n_steps
        self._env_steps_iter += n_steps   # base-class lifetime accounting
        return {k: np.stack(v) for k, v in rows.items()}

    # -------------------------------------------------------------- training
    def training_step(self) -> Dict:
        cfg = self.config
        self.replay.add(self._collect(cfg.rollout_fragment_length))
        metrics = {"num_env_steps_sampled_this_iter": cfg.rollout_fragment_length,
                   "num_env_steps_sampled": self.env_steps}
        if self._ep_returns:
            metrics["episode_return_mean"] = float(np.mean(list(self._ep_returns)[-20:]))
            metrics["episode_len_mean"] = float(np.mean(list(self._ep_lens)[-20:]))
        if (self.env_steps < cfg.num_steps_sampled_before_learning_starts
                or len(self.replay) < cfg.batch_length_T + 1):
            return metrics
        last = {}
        for _ in range(cfg.train_intensity):
            last = self._update(self.replay.sample(cfg.batch_size_B, cfg.batch_length_T))
            self._updates += 1
        metrics["learner"] = _host_metrics([last])
        return metrics

    def evaluate(self) -> Dict:
        # the training env loop IS the policy rollout; report recent returns
        if not self._ep_returns:
            return {}
        recent = list(self._ep_returns)[-self.config.evaluation_duration:]
        return {"episodes_this_iter": len(recent),
                "episode_return_mean": float(np.mean(recent))}

    def stop(self):
        # this algorithm owns its env directly (no EnvRunner closes it)
        close = getattr(self._env, "close", None)
        if close is not None:
            close()
        super().stop()

    _NETS = ("wm", "actor", "critic", "critic_ema")

    def get_weights(self):
        """{"wm", "actor", "critic", "critic_ema"}: four state_dicts on the CPU."""
        return {name: {k: v.detach().to("cpu", copy=True)
                       for k, v in getattr(self, name).state_dict().items()}
                for name in self._NETS}

    def set_weights(self, weights):
        """Load the four nets; the optimizers' moments stay, as JAX keeps its
        opt_state."""
        for name in self._NETS:
            getattr(self, name).load_state_dict(weights[name])
