"""Optimizer and learning-rate schedule factory.

Counterpart of `ray_tpu/ops/optim.py`, where one optax chain does clip ->
transform -> schedule. Here the transform is a torch optimizer, and a step
pre-hook on it does the rest before every `step()`: it clips the gradients
by their global norm as `optax.clip_by_global_norm` does (g / norm x
max_norm when the norm is not below max_norm; no epsilon; the norm is
summed in f32), then sets
the learning rate to schedule(n), n being the number of steps taken so far
(0 for the first, as optax counts). n is kept in each param group as
"schedule_count", so the optimizer's state_dict carries it, as optax's
state carries its count.

The updates follow optax's defaults (b1 0.9, b2 0.999, eps 1e-8): torch's
Adam and AdamW compute the same update (AdamW's decoupled weight decay is
lr x weight_decay x param, applied to the param before the step, as
optax.adamw adds weight_decay x param to the update), and SGD with momentum
keeps optax's trace (buf = momentum buf + g). Moments live in the param
dtype, as optax keeps them for bf16 params.

`lr_schedule` accepts:
- None                       -> constant `lr`
- {"type": "cosine", "warmup_steps": W, "decay_steps": N, "final_lr_scale": a}
- {"type": "linear", "warmup_steps": W, "decay_steps": N, "final_lr_scale": a}
- {"type": "constant", "warmup_steps": W}
- [[step, lr], ...]          -> piecewise linear interpolation
"""

import bisect
import math
from typing import Callable, Iterable, Optional, Sequence, Union

import torch

ScheduleSpec = Union[None, dict, Sequence]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps`, then end."""
    if steps <= 0:
        return lambda n: init
    return lambda n: init + (end - init) * min(max(n, 0), steps) / steps


def _join(pieces, bounds) -> Callable[[int], float]:
    """optax.join_schedules: piece i runs from bounds[i-1], on its own count."""
    def schedule(n):
        i = bisect.bisect_right(bounds, n)
        return pieces[i](n - (bounds[i - 1] if i else 0))
    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (exponent 1)."""
    def schedule(n):
        frac = min(max(n, 0), steps) / steps
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
    return schedule


def make_lr_schedule(lr: float, lr_schedule: ScheduleSpec = None) -> Callable[[int], float]:
    """Returns the schedule: step count -> learning rate (a float)."""
    if lr_schedule is None:
        return lambda n: lr
    if isinstance(lr_schedule, dict):
        kind = lr_schedule.get("type", "cosine")
        warmup = int(lr_schedule.get("warmup_steps", 0))
        if kind == "constant":
            if warmup:
                return _join([_linear(0.0, lr, warmup), lambda n: lr], [warmup])
            return lambda n: lr
        decay = int(lr_schedule["decay_steps"])
        end = lr * float(lr_schedule.get("final_lr_scale", 0.0))
        if kind == "cosine":
            # optax.warmup_cosine_decay_schedule
            if decay - warmup <= 0:
                raise ValueError(f"decay_steps {decay} must exceed warmup_steps {warmup}")
            alpha = end / lr if lr else 0.0
            return _join([_linear(0.0 if warmup else lr, lr, warmup),
                          _cosine(lr, decay - warmup, alpha)], [warmup])
        if kind == "linear":
            pieces, bounds = [], []
            if warmup:
                pieces.append(_linear(0.0, lr, warmup))
                bounds.append(warmup)
            pieces.append(_linear(lr, end, max(decay - warmup, 1)))
            pieces.append(lambda n: end)
            bounds.append(decay)
            return _join(pieces, bounds)
        raise ValueError(f"unknown lr_schedule type {kind!r}")

    points = sorted((int(s), float(v)) for s, v in lr_schedule)
    if not points:
        return lambda n: lr
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]

    def piecewise(n):  # numpy/jnp.interp: linear between points, flat outside
        if n <= xs[0]:
            return ys[0]
        if n >= xs[-1]:
            return ys[-1]
        i = bisect.bisect_right(xs, n)
        x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
        return y0 + (y1 - y0) * (n - x0) / (x1 - x0)

    return piecewise


@torch.no_grad()
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the square root of the sum of every element's
    square, each tensor summed in f32, then the tensors' sums. (The CPU
    kernel of torch.linalg.vector_norm drifts by ~1e-4 relative over a
    few million f32 elements; sum() stays within ~1e-8.)"""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm on the params' .grad, in place; returns the
    global norm (f32) before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:  # no host sync: both branches are computed on the device
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def make_optimizer(params, *, lr: float = 3e-4, lr_schedule: ScheduleSpec = None,
                   optimizer: str = "adam", grad_clip: Optional[float] = None,
                   weight_decay: float = 0.0, momentum: float = 0.9):
    """Returns (torch optimizer over `params`, schedule). The optimizer's
    pre-hook clips and sets the learning rate before every step."""
    params = list(params)
    schedule = make_lr_schedule(lr, lr_schedule)
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    def pre_step(optim, args, kwargs):
        if grad_clip:
            clip_by_global_norm(params, grad_clip)
        for group in optim.param_groups:
            n = group.get("schedule_count", 0)
            group["lr"] = schedule(n)
            group["schedule_count"] = n + 1

    opt.register_step_pre_hook(pre_step)
    return opt, schedule
