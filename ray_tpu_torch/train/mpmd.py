"""MPMD pipeline-parallel training over the port's actors: the
counterpart of `ray_tpu/train/mpmd.py`'s `PipelineStage`, `sgd`, the 1F1B
plan, `MPMDPipeline` and `build_pipeline`.

A `PipelineStage` owns its stage's parameters on its device, a forward
and a backward program and its optimizer state. A runner sends it each
microbatch's forward and backward in the 1F1B order of
`_one_f_one_b_plan` (warm-up forwards, one forward and one backward in
turn, then the remaining backwards) and moves the activations and the
gradients between stages.

The backward recomputes the stage's forward (JAX's `jax.vjp`
rematerialization): `forward` runs under `torch.no_grad()` and stashes
only the microbatch's input (and target); `backward` runs the stage again
under `torch.enable_grad()` and takes `torch.autograd.grad` for the
parameters and the input. A loss-owning last stage differentiates its
loss, with no gradient from upstream. The gradients accumulate over the
microbatches and `apply_grads` divides them by M.

`build_pipeline` makes one `PipelineStage` actor of the port's runtime a
stage and `MPMDPipeline` drives them: activations and gradients travel
as object refs through the store, and each op carries the previous op of
its stage as an `after` token, so the scheduler runs every stage's ops in
1F1B order.

Where the port differs from JAX's module:
- A stage takes an explicit `device` ("cuda" by default, and
  `build_pipeline(device=...)` passes it on); its ops run
  under that device, and `forward` and `backward` move their inputs to
  it. They do not wait for the device. Driven from one host thread, four
  llama_1b stages on four cards at B=1 barely overlapped: each card was
  busy about a quarter of the 1F1B step, which took longer than the whole
  model's step on one card (four NVIDIA H100s, `chip_smoke.py --cards 4`).
- Each op records JAX's `pipeline.fwd` / `pipeline.bwd` window, args
  {"stage", "mb"}, through the port's `util/tracing.py` (ring and ship
  outbox). JAX's window ends after `block_until_ready`; the port's stage
  does not wait, so on a card the window is a pair of CUDA events on the
  stage's stream (`tracing.DeviceClock`: the device's time for the op,
  with no host sync), placed on the wall-clock axis when the ring is read.
  On the CPU it is host time. Each stage's tid is (pid, stage), where
  JAX's is the pid of the stage's actor: in-process stages share a pid,
  and `tracing.bubble_stats` groups windows by tid.
- Parameters are a tree (dicts, lists, tuples) of tensors
  (`torch.utils._pytree`); a stage function may be
  `torch.func.functional_call` over an `nn.Module`.
"""

import contextlib
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.util import tracing

__all__ = ["PipelineStage", "sgd", "MPMDPipeline", "build_pipeline"]


class _SGD:
    """Minimal optax-protocol optimizer (init/update): the update is
    -lr * grad."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        lr = self.lr
        return pytree.tree_map(lambda g: -lr * g, grads), state


def sgd(lr: float = 0.1) -> _SGD:
    return _SGD(lr)


class PipelineStage:
    """One pipeline stage: forward and rematerialized backward, the
    accumulated gradient and the optimizer state.

    stage_fn: (params, x) -> y          (inter-stage activation contract)
    loss_fn:  (y, target) -> scalar     (last stage only, training)
    optimizer: optax-protocol object (init/update); required for
      ``apply_grads``.
    """

    def __init__(self, stage_index: int, num_stages: int,
                 stage_fn: Callable, params,
                 loss_fn: Optional[Callable] = None, optimizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.index = stage_index
        self.num_stages = num_stages
        self.is_first = stage_index == 0
        self.is_last = stage_index == num_stages - 1
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.params = pytree.tree_map(lambda p: torch.as_tensor(p).detach().to(self.device),
                                      params)
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.params) if optimizer else None
        self._stash: Dict[Any, tuple] = {}
        self._grad = None
        self._steps = 0
        self._peak_stash = 0
        self._clock = (tracing.DeviceClock(self.device) if self.device.type == "cuda"
                       else None)

    # ---------------------------------------------------------------- trace
    def _open(self):
        """The start of an op's window: a CUDA event on the stage's stream,
        host time on the CPU, None with tracing off."""
        if not tracing.enabled():
            return None
        return time.time() if self._clock is None else self._clock.start()

    def _ship(self, name: str, t0, mb) -> None:
        if t0 is None:
            return
        tid, args = (os.getpid(), self.index), {"stage": self.index, "mb": mb}
        if self._clock is None:
            tracing.ship_window(name, "pipeline", tracing.current_trace_id(), t0,
                                time.time(), tid=tid, args=args)
        else:
            self._clock.ship_window(name, "pipeline", tracing.current_trace_id(), t0,
                                    tid=tid, args=args)

    def _here(self):
        """Run on this stage's card (a kernel launches on the current device)."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _to_device(self, x):
        return None if x is None else torch.as_tensor(x).to(self.device)

    def _owns_loss(self) -> bool:
        return self.is_last and self.loss_fn is not None

    # ----------------------------------------------------------------- ops
    def forward(self, mb, x, target=None, stash: bool = True, after=None):
        """Run this stage's forward for microbatch ``mb``.

        Returns the activation (or the scalar loss at a loss-owning last
        stage). ``stash=True`` keeps the INPUT for the matching
        ``backward`` (remat); forward-only runs pass stash=False so
        nothing accumulates. ``after`` is an ignored sequencing token (a
        runner passes the previous op of this stage)."""
        t0 = self._open()
        x, target = self._to_device(x), self._to_device(target)
        with self._here(), torch.no_grad():
            if self._owns_loss() and target is not None:
                out = self.loss_fn(self.stage_fn(self.params, x), target)
            else:
                out = self.stage_fn(self.params, x)
        if stash:
            self._stash[mb] = (x, target)
            self._peak_stash = max(self._peak_stash, len(self._stash))
        self._ship("pipeline.fwd", t0, mb)
        return out

    def backward(self, mb, grad=None, after=None):
        """Backward for microbatch ``mb``: recompute the forward with
        autograd, accumulate the parameters' gradient, return the input's
        (None at stage 0, where nothing consumes it). ``after`` is the
        runner's sequencing token."""
        t0 = self._open()
        x, target = self._stash.pop(mb)
        leaves, spec = pytree.tree_flatten(self.params)
        with self._here(), torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in leaves]
            params = pytree.tree_unflatten(leaves, spec)
            wants_dx = x.is_floating_point()
            x_in = x.detach().requires_grad_() if wants_dx else x
            inputs = leaves + ([x_in] if wants_dx else [])
            if self._owns_loss():
                grads = torch.autograd.grad(self.loss_fn(self.stage_fn(params, x_in), target),
                                            inputs, allow_unused=True)
            else:
                grads = torch.autograd.grad(self.stage_fn(params, x_in), inputs,
                                            self._to_device(grad), allow_unused=True)
            dp = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads[:len(leaves)])]
            self._grad = dp if self._grad is None else [a + b for a, b in zip(self._grad, dp)]
        self._ship("pipeline.bwd", t0, mb)
        if self.is_first or not wants_dx:
            return None
        return grads[-1]

    def apply_grads(self, num_microbatches: int, after=None) -> dict:
        """Flush-phase optimizer step on the accumulated grad (mean over
        microbatches); zeroes the accumulator. ``after`` (the stage's
        last backward) gates it behind the drain."""
        if self._grad is None:
            raise RuntimeError(f"stage {self.index}: no accumulated grads")
        spec = pytree.tree_flatten(self.params)[1]
        with self._here(), torch.no_grad():
            g = pytree.tree_unflatten([a / num_microbatches for a in self._grad], spec)
            updates, self.opt_state = self.optimizer.update(g, self.opt_state, self.params)
            self.params = pytree.tree_map(torch.add, self.params, updates)
        self._grad = None
        self._steps += 1
        return {"stage": self.index, "step": self._steps,
                "stash_depth": len(self._stash)}

    # ------------------------------------------------------------- plumbing
    def ping(self) -> int:
        return self.index

    def warmup(self, x, target=None):
        """Run one forward and backward (kernel builds, allocator) outside a
        measured window, and forget them."""
        self.forward("_warm", x, target)
        g = None
        if not self._owns_loss():
            with self._here(), torch.no_grad():
                g = torch.zeros_like(self.stage_fn(self.params, self._to_device(x)))
        self.backward("_warm", g)
        self._grad = None
        self._peak_stash = 0
        return True

    def reset(self) -> int:
        """Drop stashed inputs/grads (forward-only runs, test cleanup)."""
        n = len(self._stash)
        self._stash.clear()
        self._grad = None
        return n

    def get_params(self):
        return self.params

    def stats(self) -> dict:
        return {"stage": self.index, "steps": self._steps,
                "stash_depth": len(self._stash),
                "peak_stash": self._peak_stash}


def _one_f_one_b_plan(stage_index: int, num_stages: int,
                      num_microbatches: int) -> List[tuple]:
    """Stage-local 1F1B op order: warmup forwards, steady 1F1B, cooldown
    backwards. The last stage has zero warmup (F0 B0 F1 B1 ...)."""
    S, M, i = num_stages, num_microbatches, stage_index
    w = min(S - 1 - i, M)
    ops = [("F", m) for m in range(w)]
    for k in range(M - w):
        ops.append(("F", w + k))
        ops.append(("B", k))
    ops.extend(("B", m) for m in range(M - w, M))
    return ops


class MPMDPipeline:
    """Driver-side runner over S `PipelineStage` actors.

    Build with ``build_pipeline``. ``train_step`` runs one 1F1B
    step; ``run_forward`` is the inference/parity path (same math as
    SPMD ``pipeline_apply``)."""

    def __init__(self, stages: Sequence, num_microbatches: Optional[int],
                 node_ids: Sequence[Optional[str]]):
        import ray_tpu_torch
        self._rt = ray_tpu_torch
        self.stages = list(stages)
        self.num_stages = len(self.stages)
        self.num_microbatches = num_microbatches
        self.node_ids = list(node_ids)
        self.last_stats: Dict[str, Any] = {}

    # ------------------------------------------------------------- forward
    def run_forward(self, microbatches) -> list:
        """Chain every microbatch through all stages (GPipe forward
        order); returns last-stage outputs. Intermediate refs are
        released as soon as their consumer is submitted."""
        rt = self._rt
        outs = []
        for m, x in enumerate(microbatches):
            ref = rt.put(x)
            for h in self.stages:
                nxt = h.forward.remote(m, ref, stash=False)
                del ref  # consumer pin keeps it alive until used
                ref = nxt
            outs.append(ref)
        vals = rt.get(outs)
        del outs
        return vals

    # ---------------------------------------------------------------- train
    def train_step(self, microbatches, targets) -> dict:
        """One 1F1B training step over M microbatches.

        Submission: repeatedly scan the stages round-robin, submitting
        each stage's next planned op once its input ref exists (the
        activation for a forward, the upstream grad for a backward).
        Execution order per actor is dep-readiness order, not submission
        order (a dep-free task would jump a dep-waiting one), so every
        op also carries the previous same-stage op's output ref as an
        ``after`` token: readiness itself then serializes each stage in
        exactly the 1F1B order, deadlock-free by construction, and
        ``apply_grads`` (gated on the last backward's ref) cannot
        overtake the drain. Activation and grad refs are dropped the
        moment their consumer is submitted, bounding live microbatch
        objects to ~S.
        """
        rt = self._rt
        S = self.num_stages
        M = len(microbatches)
        if targets is None:
            raise ValueError("train_step needs targets (and the pipeline a "
                             "loss_fn); use run_forward for inference")
        if len(targets) != M:
            raise ValueError(
                f"got {M} microbatches but {len(targets)} targets")
        plans = [deque(_one_f_one_b_plan(i, S, M)) for i in range(S)]
        acts: Dict[tuple, Any] = {}    # (stage, mb) -> activation-out ref
        grads: Dict[tuple, Any] = {}   # (stage, mb) -> input-grad ref
        tokens: List[Any] = [None] * S  # last submitted op's ref per stage
        losses: List[Any] = []
        peak_live = 0
        submitted = 0
        while any(plans):
            progressed = False
            for i, plan in enumerate(plans):
                if not plan:
                    continue
                h = self.stages[i]
                kind, m = plan[0]
                if kind == "F":
                    if i == 0:
                        src = rt.put(microbatches[m])
                    else:
                        src = acts.pop((i - 1, m), None)
                        if src is None:
                            continue  # producer not submitted yet
                    if i == S - 1:
                        tref = rt.put(targets[m])
                        ref = h.forward.remote(m, src, tref, after=tokens[i])
                        del tref
                    else:
                        ref = h.forward.remote(m, src, after=tokens[i])
                    del src  # the submitted task's pin owns it now
                    if i == S - 1:
                        losses.append(ref)
                    else:
                        acts[(i, m)] = ref
                else:  # "B"
                    if i == S - 1:
                        ref = h.backward.remote(m, after=tokens[i])
                    else:
                        g = grads.pop((i + 1, m), None)
                        if g is None:
                            continue
                        ref = h.backward.remote(m, g, after=tokens[i])
                        del g
                    if i != 0:  # dx at stage 0 is None; only the token holds it
                        grads[(i, m)] = ref
                tokens[i] = ref
                del ref
                plan.popleft()
                submitted += 1
                progressed = True
                peak_live = max(peak_live, len(acts) + len(grads))
            if not progressed:
                raise RuntimeError(
                    "1F1B schedule deadlock (bug): "
                    + repr([list(p)[:3] for p in plans]))
        # each apply_grads is gated on its stage's last backward via the
        # token; the get is the step barrier.
        apply_refs = [h.apply_grads.remote(M, after=tokens[i])
                      for i, h in enumerate(self.stages)]
        del tokens[:]
        stage_stats = rt.get(apply_refs)
        del apply_refs
        loss_vals = rt.get(losses)
        del losses
        mean_loss = float(sum(float(v) for v in loss_vals) / max(M, 1))
        self.last_stats = {
            "peak_live_refs": peak_live, "ops_submitted": submitted,
            "stages": stage_stats,
            "warmup_depths": [min(S - 1 - i, M) for i in range(S)]}
        return {"loss": mean_loss,
                "per_microbatch_loss": [float(v) for v in loss_vals],
                "stats": self.last_stats}

    # ------------------------------------------------------------- plumbing
    def stage_stats(self) -> list:
        return self._rt.get([h.stats.remote() for h in self.stages])

    def get_params(self) -> list:
        return self._rt.get([h.get_params.remote() for h in self.stages])

    def shutdown(self) -> None:
        """Release the actor handles; actor GC tears the stages down."""
        stages, self.stages = self.stages, []
        del stages


def build_pipeline(stage_fns: Sequence[Callable], stage_params: Sequence,
                   *, loss_fn: Optional[Callable] = None, optimizer=None,
                   node_ids: Optional[Sequence[str]] = None,
                   actor_options: Optional[dict] = None,
                   device="cuda") -> MPMDPipeline:
    """Create one `PipelineStage` actor of the port's runtime per stage and
    wire the runner.

    Placement: stage i gets ``NodeAffinitySchedulingStrategy(node_ids[i],
    soft=True)``; when ``node_ids`` is omitted, stages round-robin over
    the alive nodes. ``actor_options`` go to every stage's actor:
    ``{"num_gpus": 1}`` gives each stage a card of its own, which it sees
    as its only CUDA device. ``device`` is each stage's ("cuda" unless the
    caller asks for "cpu").
    """
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    S = len(stage_fns)
    if len(stage_params) != S:
        raise ValueError(
            f"{S} stage_fns but {len(stage_params)} stage_params")
    if node_ids is None:
        rows = [n for n in rt.nodes() if n.get("alive", True)]
        node_ids = [rows[i % len(rows)]["node_id"] for i in range(S)] \
            if rows else [None] * S
    elif len(node_ids) != S:
        raise ValueError(f"{S} stages but {len(node_ids)} node_ids")
    if optimizer is None and loss_fn is not None:
        optimizer = sgd()
    cls = rt.remote(PipelineStage)
    stages = []
    for i in range(S):
        opts = dict(actor_options or {})
        if node_ids[i] is not None:
            opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
                node_id=node_ids[i], soft=True)
        handle = cls.options(**opts).remote(
            i, S, stage_fns[i], stage_params[i],
            loss_fn=loss_fn if i == S - 1 else None,
            optimizer=optimizer, device=device)
        stages.append(handle)
    rt.get([h.ping.remote() for h in stages])
    return MPMDPipeline(stages, None, node_ids)
