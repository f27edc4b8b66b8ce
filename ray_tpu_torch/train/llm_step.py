"""The Llama decoder's training step.

Counterpart of `bench.py:712-768` (`measure()`), the JAX package's
flagship training step: forward with `return_hidden` ->
`chunked_cross_entropy` on the hidden states and the lm_head weight ->
backward -> AdamW (optax's defaults, weight decay 1e-4), on a fresh host
batch every step taken from a ring of 8 batches drawn with
`np.random.default_rng(0).integers(0, vocab, (B, T + 1))`.

On the card attention goes through the flash kernels (forward, then dQ and
dK/dV in the backward) in every layer, and an entry point that finds no
card raises unless it was asked for `device="cpu"`, where the plain
PyTorch versions run. PyTorch runs the step eagerly: there is no
counterpart of `jax.jit` or of buffer donation (the optimizer updates the
params in place).

On a mesh (`mesh=`, a DeviceMesh with axes among dp, fsdp, tp and ep),
the counterpart of `jax.jit` over `llama_rules().tree_shardings` and
`data_sharding`: one program runs on every rank, one rank a card. Each
rank holds the shard-local model (`models/llama.py`), takes its rows of
the batch (split over dp and fsdp) and its blocks of every parameter and
AdamW moment. The loss is the global batch's mean: each rank's backward
starts from its own rows' mean; the fsdp gathers' backward has already
summed the fsdp-sharded gradients over fsdp, so they are all-reduced over
dp, the replicated ones (norm scales, the router) over dp and fsdp, one
flat bucket per dtype and axis set, as the dp learner group buckets its
gradient; then each is divided by dp x fsdp. The reported loss is the
pmean over dp and fsdp of the ranks' means, with equal rows on every
rank. tp and ep ranks hold the same rows, and their collectives make the
gradients of the parameters they share alike on each of them.
"""

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ray_tpu_torch.device import bind_card, resolve_device
from ray_tpu_torch.models.convert import (flax_to_state_dict, init_params, init_params_sharded,
                                          shard_state_dict)
from ray_tpu_torch.models.llama import Llama, LlamaConfig, llama_compute_flops
from ray_tpu_torch.ops.losses import chunked_cross_entropy
from ray_tpu_torch.ops.optim import make_optimizer
from ray_tpu_torch.parallel import xla_ops
from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import _entry_axes, _filter_axes, data_sharding, llama_rules
from ray_tpu_torch.train.ingest import iter_device_batches

BATCH_AXES = ("dp", "fsdp")     # the axes that split the batch (data_sharding)


class GradMean:
    """The mean over the batch axes (dp, fsdp) of a shard-local model's
    gradients, in place (module docstring). A param is fsdp-sharded where
    `llama_rules` names fsdp in its spec."""

    def __init__(self, model: Llama):
        place = model.place
        self.mesh = place.mesh
        self.n = place.size("dp") * place.size("fsdp")
        rules = llama_rules()
        buckets = {}
        for name, p in model.named_parameters():
            spec = _filter_axes(rules.spec_for(name.replace(".", "/"), p), self.mesh)
            sharded = any("fsdp" in _entry_axes(e) for e in spec)
            axes = tuple(a for a in (("dp",) if sharded else BATCH_AXES) if place.size(a) > 1)
            buckets.setdefault((axes, p.dtype), []).append(p)
        self.buckets = [(axes, params) for (axes, _), params in buckets.items()]

    @torch.no_grad()
    def __call__(self):
        for axes, params in self.buckets:
            params = [p for p in params if p.grad is not None]
            if not params:
                continue
            if not axes:
                for p in params if self.n > 1 else ():
                    p.grad /= self.n
                continue
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            for a in axes:
                dist.all_reduce(flat, group=self.mesh.get_group(a))
            flat /= self.n
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad = g.view_as(p)


def make_train_step(model: Llama, optimizer: torch.optim.Optimizer, chunk_size: int = 512,
                    mesh=None):
    """Returns step(tokens [B, T+1] int on the model's device) -> loss (a
    0-d f32 tensor, not synchronised). The chunk is min(chunk_size, T).

    For a shard-local model (`Llama(cfg, mesh=...)`), `tokens` are this
    rank's rows (a tensor, or the DTensor `iter_device_batches(sharding=
    data_sharding(mesh))` yields), the gradients are meaned over the batch
    axes (`GradMean`) and the loss is the global batch's. `mesh`, when
    given, must be the model's."""
    place = model.place
    if mesh is not None and (place is None or place.mesh is not mesh):
        raise ValueError("make_train_step's mesh must be the model's: build it with "
                         "Llama(cfg, mesh=mesh)")
    if place is not None and place.sp > 1:
        raise ValueError(f"the train step splits the batch over dp and fsdp and the model "
                         f"over tp and ep; {model.cfg.sp_axis}={place.sp} is not trained here")
    grad_mean = GradMean(model) if place is not None else None
    batch_axes = [] if place is None else [a for a in BATCH_AXES if place.size(a) > 1]

    def step(tokens: torch.Tensor) -> torch.Tensor:
        if isinstance(tokens, DTensor):
            tokens = tokens.to_local()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        hidden, _ = model(inputs, return_hidden=True)
        loss, _ = chunked_cross_entropy(hidden, model.head_weight(), labels,
                                        chunk_size=min(chunk_size, inputs.shape[1]))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if grad_mean is not None:
            grad_mean()
        optimizer.step()
        loss = loss.detach()
        for a in batch_axes:
            loss = xla_ops.pmean(loss, a, place.mesh)
        return loss
    return step


def train_state(model: Llama, optimizer: torch.optim.Optimizer, **extra):
    """(state, specs) of a trainer, for `Checkpoint.from_state(state,
    mesh=..., specs=specs)` and `to_state(target=state, mesh=...)`: the
    model's and the optimizer's state dicts and `extra`; `specs` gives each
    parameter and each of its AdamW moments its `llama_rules` spec on the
    model's mesh (the optimizer's state is keyed by parameter order, as
    `make_optimizer` takes `model.parameters()`)."""
    state = dict(model=model.state_dict(), optim=optimizer.state_dict(), **extra)
    if model.place is None:
        return state, None
    rules, mesh = llama_rules(), model.place.mesh
    spec = lambda name, p: _filter_axes(rules.spec_for(name.replace(".", "/"), p), mesh)
    named = list(model.named_parameters())
    specs = dict(model={k: spec(k, v) for k, v in state["model"].items()},
                 optim={"state": {i: {"exp_avg": spec(k, p), "exp_avg_sq": spec(k, p)}
                                  for i, (k, p) in enumerate(named)}})
    return state, specs


def host_batches(vocab: int, batch: int, seq: int, n: int = 8):
    """bench.py's ring of fresh host batches: int32 [batch, seq + 1]."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32) for _ in range(n)]


def build_llama_trainer(preset: str = "llama_1b", batch: int = 4, seq: int = 2048,
                        remat: Optional[bool] = None, device="cuda", seed: int = 0,
                        params=None, dtype: Optional[torch.dtype] = None, mesh=None,
                        overrides: Optional[dict] = None, lr: float = 1e-4):
    """(model, optimizer, step, host batches, device) as `train_llama` sets them up.

    `remat=None` takes bench.py's default: off for llama_1b at batch <= 4,
    on otherwise. `dtype=None` keeps bench.py's dtypes (bf16 activations;
    bf16 params for llama_1b, the preset's f32 otherwise); a dtype sets both.
    `params` is a flax param tree of numpy arrays (converted by
    `models/convert.py`); without it the weights are drawn from `seed`.
    `overrides` are further LlamaConfig fields; `lr` is AdamW's learning
    rate (a Tune sweep's knob).

    `mesh`: the shard-local model on it (module docstring), this rank's
    card bound first (`bind_card`). Its weights are this rank's blocks of
    the same seeded draw (`init_params_sharded`, each tensor drawn whole on
    the card) or of `params` (`shard_state_dict`). `batch` is the global
    batch, split over dp and fsdp.
    """
    if mesh is not None:
        bind_card(device)
    dev = resolve_device(device)
    if remat is None:
        remat = not (preset == "llama_1b" and batch <= 4)
    kw = dict(max_seq_len=seq, remat=remat,
              attn_impl="flash" if dev.type == "cuda" else "auto")
    if dtype is not None:
        kw.update(dtype=dtype, param_dtype=dtype)
    elif preset == "llama_1b":
        kw.update(param_dtype=torch.bfloat16)
    kw.update(overrides or {})
    cfg: LlamaConfig = getattr(LlamaConfig, preset)(**kw)
    model = Llama(cfg, device=dev, mesh=mesh)
    if params is not None:
        sd = flax_to_state_dict(params)
        model.load_state_dict(sd if mesh is None else shard_state_dict(sd, mesh))
    elif mesh is None:
        init_params(model, torch.Generator(device=dev).manual_seed(seed))
    else:
        whole = [(k, p.shape) for k, p in Llama(cfg, device="meta").named_parameters()]
        init_params_sharded(model, whole, torch.Generator(device=dev).manual_seed(seed), mesh)
    optimizer, _ = make_optimizer(model.parameters(), lr=lr, optimizer="adamw",
                                  weight_decay=1e-4)
    step = make_train_step(model, optimizer, chunk_size=512, mesh=mesh)
    return model, optimizer, step, host_batches(cfg.vocab_size, batch, seq), dev


def train_llama(preset: str = "llama_1b", batch: int = 4, seq: int = 2048,
                steps: int = 5, remat: Optional[bool] = None, device="cuda",
                seed: int = 0, params=None, warmup_steps: int = 2,
                dtype: Optional[torch.dtype] = None, mesh=None):
    """Train the Llama decoder for `warmup_steps` untimed and `steps` timed
    steps (bench.py runs two untimed steps before its timed loop).

    Returns {"losses": every step's loss in order, warm-up steps first,
    "ms_per_step", "tokens_per_s", "tflops_per_s" over the timed steps,
    "params_finite": no NaN or inf in the trained params, ...}. Times are
    host-clock times around work that ends in a device synchronise.

    With `mesh`, every rank of the mesh calls this (one program a rank):
    each step's batch comes through `iter_device_batches(sharding=
    data_sharding(mesh))`, this rank's rows; the losses are the global
    batch's, `params_finite` holds on every rank, tokens and TFLOP/s count
    the global batch, and the result also holds the mesh's axes, this
    card's peak memory (`peak_memory_bytes`, None on the CPU).
    """
    model, _, step, batches, dev = build_llama_trainer(
        preset, batch, seq, remat, device, seed, params, dtype, mesh)
    n = warmup_steps + steps
    ring = [batches[i % len(batches)] for i in range(n)]
    if mesh is None:
        feed = (torch.from_numpy(b).to(dev) for b in ring)
    else:
        feed = iter_device_batches(ring, prefetch=2, sharding=data_sharding(mesh))
    cuda = dev.type == "cuda"
    if cuda and mesh is not None:
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(next(feed)) for _ in range(warmup_steps)]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(next(feed)))
    sync()
    dt = time.perf_counter() - t0
    tokens = batch * seq * steps
    with torch.no_grad():
        finite = torch.tensor(float(all(bool(torch.isfinite(p).all())
                                        for p in model.parameters())), device=dev)
        for axis in () if mesh is None else mesh.mesh_dim_names:
            dist.all_reduce(finite, dist.ReduceOp.MIN, group=mesh.get_group(axis))
    out = dict(
        preset=preset, batch=batch, seq=seq, steps=steps, warmup_steps=warmup_steps,
        remat=model.cfg.remat, attn_impl=model.cfg.attn_impl, device=str(dev),
        param_dtype=str(model.cfg.param_dtype), losses=[float(x) for x in losses],
        params_finite=bool(finite),
        ms_per_step=dt / steps * 1e3 if steps else None,
        tokens_per_s=tokens / dt if steps else None,
        tflops_per_s=(llama_compute_flops(model.cfg, batch, seq) * steps / dt / 1e12
                      if steps else None))
    if mesh is not None:
        out.update(mesh=axis_sizes(mesh),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None)
    return out
