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
"""

import time
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.convert import flax_to_state_dict, init_params
from ray_tpu_torch.models.llama import Llama, LlamaConfig, llama_compute_flops
from ray_tpu_torch.ops.losses import chunked_cross_entropy
from ray_tpu_torch.ops.optim import make_optimizer


def head_weight(model: Llama) -> torch.Tensor:
    """The [V, D] head the loss multiplies with: lm_head, or the tied embedding."""
    return model.embed.embedding if model.cfg.tie_embeddings else model.lm_head.weight


def make_train_step(model: Llama, optimizer: torch.optim.Optimizer, chunk_size: int = 512):
    """Returns step(tokens [B, T+1] int on the model's device) -> loss (a
    0-d f32 tensor, not synchronised). The chunk is min(chunk_size, T)."""
    def step(tokens: torch.Tensor) -> torch.Tensor:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        hidden, _ = model(inputs, return_hidden=True)
        loss, _ = chunked_cross_entropy(hidden, head_weight(model), labels,
                                        chunk_size=min(chunk_size, inputs.shape[1]))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def host_batches(vocab: int, batch: int, seq: int, n: int = 8):
    """bench.py's ring of fresh host batches: int32 [batch, seq + 1]."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32) for _ in range(n)]


def build_llama_trainer(preset: str = "llama_1b", batch: int = 4, seq: int = 2048,
                        remat: Optional[bool] = None, device="cuda", seed: int = 0,
                        params=None, dtype: Optional[torch.dtype] = None):
    """(model, optimizer, step, host batches, device) as `train_llama` sets them up.

    `remat=None` takes bench.py's default: off for llama_1b at batch <= 4,
    on otherwise. `dtype=None` keeps bench.py's dtypes (bf16 activations;
    bf16 params for llama_1b, the preset's f32 otherwise); a dtype sets both.
    `params` is a flax param tree of numpy arrays (converted by
    `models/convert.py`); without it the weights are drawn from `seed`.
    """
    dev = resolve_device(device)
    if remat is None:
        remat = not (preset == "llama_1b" and batch <= 4)
    kw = dict(max_seq_len=seq, remat=remat,
              attn_impl="flash" if dev.type == "cuda" else "auto")
    if dtype is not None:
        kw.update(dtype=dtype, param_dtype=dtype)
    elif preset == "llama_1b":
        kw.update(param_dtype=torch.bfloat16)
    cfg: LlamaConfig = getattr(LlamaConfig, preset)(**kw)
    model = Llama(cfg, device=dev)
    if params is None:
        init_params(model, torch.Generator(device=dev).manual_seed(seed))
    else:
        model.load_state_dict(flax_to_state_dict(params))
    optimizer, _ = make_optimizer(model.parameters(), lr=1e-4, optimizer="adamw",
                                  weight_decay=1e-4)
    step = make_train_step(model, optimizer, chunk_size=512)
    return model, optimizer, step, host_batches(cfg.vocab_size, batch, seq), dev


def train_llama(preset: str = "llama_1b", batch: int = 4, seq: int = 2048,
                steps: int = 5, remat: Optional[bool] = None, device="cuda",
                seed: int = 0, params=None, warmup_steps: int = 2,
                dtype: Optional[torch.dtype] = None):
    """Train the Llama decoder for `warmup_steps` untimed and `steps` timed
    steps (bench.py runs two untimed steps before its timed loop).

    Returns {"losses": every step's loss in order, warm-up steps first,
    "ms_per_step", "tokens_per_s", "tflops_per_s" over the timed steps,
    "params_finite": no NaN or inf in the trained params, ...}. Times are
    host-clock times around work that ends in a device synchronise.
    """
    model, _, step, batches, dev = build_llama_trainer(
        preset, batch, seq, remat, device, seed, params, dtype)
    feed = lambda i: torch.from_numpy(batches[i % len(batches)]).to(dev)
    losses = [step(feed(i)) for i in range(warmup_steps)]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(warmup_steps, warmup_steps + steps):
        losses.append(step(feed(i)))
    sync()
    dt = time.perf_counter() - t0
    tokens = batch * seq * steps
    with torch.no_grad():
        params_finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    return dict(
        preset=preset, batch=batch, seq=seq, steps=steps, warmup_steps=warmup_steps,
        remat=model.cfg.remat, attn_impl=model.cfg.attn_impl, device=str(dev),
        param_dtype=str(model.cfg.param_dtype), losses=[float(x) for x in losses],
        params_finite=params_finite,
        ms_per_step=dt / steps * 1e3 if steps else None,
        tokens_per_s=tokens / dt if steps else None,
        tflops_per_s=(llama_compute_flops(model.cfg, batch, seq) * steps / dt / 1e12
                      if steps else None))
