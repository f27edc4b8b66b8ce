"""ray_tpu_torch.train.mpmd against ray_tpu.train.mpmd on the CPU, on
tests/test_mpmd.py's tanh stages and inputs (JAX's params carried across
as numpy):

- the 1F1B plan equals JAX's `_one_f_one_b_plan` over a grid of (S, M);
- `PipelineStage` in process, driven op by op alike in both packages:
  forward outputs, loss, input grads, params after `apply_grads` and the
  plumbing (stash, stats, reset, warmup) equal JAX's;
- `ray_tpu.train.mpmd.MPMDPipeline` over `ray_tpu.remote` actors of the
  port's stage (device="cpu"): `run_forward` equals JAX's pipeline's,
  and `train_step`'s loss and params equal test_mpmd's
  `_reference_step` (rtol 1e-5), with at most S + 1 live refs; also with
  fewer microbatches than stages."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.train import mpmd as tmpmd
from test_mpmd import _inputs, _mse, _reference_step, _tanh_stages


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _torch_stage_fns():
    """The tanh stage and the MSE loss in torch, as closures (so that an
    actor receives them by value)."""
    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, t):
        return ((y - t) ** 2).mean()
    return stage_fn, loss_fn


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 6])
def test_plan_matches_jax(n_stages):
    from ray_tpu.train.mpmd import _one_f_one_b_plan
    for m in (1, 2, 3, 4, 5, 8, 13):
        for i in range(n_stages):
            assert tmpmd._one_f_one_b_plan(i, n_stages, m) == _one_f_one_b_plan(i, n_stages, m)


def _drive(stages, mbs, tgts):
    """One step in process: every microbatch forward through the stages,
    then back (the order does not change the sums' terms); returns the
    losses, each stage's input grad of the first microbatch, and the
    apply_grads results."""
    losses, dxs = [], []
    for m, (x, t) in enumerate(zip(mbs, tgts)):
        for s in stages[:-1]:
            x = s.forward(m, x)
        losses.append(float(stages[-1].forward(m, x, t)))
        g = None
        for s in reversed(stages):
            g = s.backward(m, g)
            if m == 0:
                dxs.append(None if g is None else np.asarray(g))
    return losses, dxs, [s.apply_grads(len(mbs)) for s in stages]


def test_stage_in_process_matches_jax():
    from ray_tpu.train.mpmd import PipelineStage as JStage, sgd as jsgd
    S, d, M, lr = 3, 8, 4, 0.1
    params, jfn = _tanh_stages(S, d)
    mbs, tgts = _inputs(M, 4, d)
    tfn, tloss = _torch_stage_fns()
    jst = [JStage(i, S, jfn, params[i], loss_fn=_mse if i == S - 1 else None,
                  optimizer=jsgd(lr)) for i in range(S)]
    tst = [tmpmd.PipelineStage(i, S, tfn, _np(params[i]), loss_fn=tloss if i == S - 1 else None,
                               optimizer=tmpmd.sgd(lr), device="cpu") for i in range(S)]
    # plumbing: warmup leaves nothing behind; a forward-only run stashes nothing
    for j, t in zip(jst, tst):
        x0 = np.array(mbs[0])
        if j.index:
            x0 = np.zeros((4, d), np.float32)
        tgt = np.array(tgts[0]) if j.is_last else None
        assert t.warmup(x0, tgt) is True and j.warmup(x0, tgt) is True
        assert t.stats() == j.stats() and t.ping() == j.ping()
    out_t = tst[0].forward("f", np.array(mbs[0]), stash=False)
    out_j = jst[0].forward("f", mbs[0], stash=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-7)
    tst[0].forward("left", np.array(mbs[0]))
    jst[0].forward("left", mbs[0])
    assert tst[0].reset() == jst[0].reset() == 1

    want = _drive(jst, mbs, tgts)
    got = _drive(tst, [np.array(x) for x in mbs], [np.array(t) for t in tgts])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, w in zip(got[1], want[1]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    assert got[2] == want[2]
    for t, j in zip(tst, jst):
        for k, v in j.get_params().items():
            np.testing.assert_allclose(t.get_params()[k].numpy(), np.asarray(v), rtol=1e-5,
                                       atol=1e-7)
        assert t.stats() == j.stats()
    with pytest.raises(RuntimeError, match="no accumulated grads"):
        tst[0].apply_grads(M)


def _actor_pipeline(ray, S, params, lr=0.1, loss=True):
    """ray_tpu's MPMDPipeline over actors of the port's stage, as
    build_pipeline wires JAX's."""
    from ray_tpu.train.mpmd import MPMDPipeline
    tfn, tloss = _torch_stage_fns()
    cls = ray.remote(tmpmd.PipelineStage)
    stages = [cls.remote(i, S, tfn, _np(params[i]),
                         loss_fn=tloss if loss and i == S - 1 else None,
                         optimizer=tmpmd.sgd(lr), device="cpu") for i in range(S)]
    ray.get([h.ping.remote() for h in stages])
    return MPMDPipeline(stages, None, [None] * S)


def test_actor_pipeline_run_forward_matches_jax(ray_session):
    from ray_tpu.train.mpmd import build_pipeline
    S, d, M = 2, 8, 6
    params, jfn = _tanh_stages(S, d)
    mbs, _ = _inputs(M, 4, d)
    jpipe = build_pipeline([jfn] * S, params)
    tpipe = _actor_pipeline(ray_session, S, params, loss=False)
    try:
        want = jpipe.run_forward(mbs)
        got = tpipe.run_forward([np.array(x) for x in mbs])
    finally:
        jpipe.shutdown()
        tpipe.shutdown()
    np.testing.assert_allclose(np.stack([g.numpy() for g in got]), np.stack(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("S,M", [(2, 6), (3, 2)], ids=["S2-M6", "fewer-microbatches"])
def test_actor_pipeline_train_step_matches_reference(ray_session, S, M):
    d, lr = 8, 0.1
    params, jfn = _tanh_stages(S, d)
    mbs, tgts = _inputs(M, 4, d)
    pipe = _actor_pipeline(ray_session, S, params, lr)
    try:
        out = pipe.train_step([np.array(x) for x in mbs], [np.array(t) for t in tgts])
        got_params = pipe.get_params()
    finally:
        pipe.shutdown()
    ref_loss, ref_params = _reference_step(jfn, params, mbs, tgts, lr)
    assert out["loss"] == pytest.approx(ref_loss, rel=1e-5)
    for got, want in zip(got_params, ref_params):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5)
    assert out["stats"]["peak_live_refs"] <= S + 1, out["stats"]
    assert all(s["stash_depth"] == 0 for s in out["stats"]["stages"])


def _run_1f1b(stages, mbs, tgts):
    """One step in process in MPMDPipeline.train_step's order: scan the
    stages round-robin, running each stage's next planned op once its input
    exists."""
    from collections import deque
    S, M = len(stages), len(mbs)
    plans = [deque(tmpmd._one_f_one_b_plan(i, S, M)) for i in range(S)]
    acts, grads = {}, {}
    while any(plans):
        for i, plan in enumerate(plans):
            if not plan:
                continue
            kind, m = plan[0]
            if kind == "F":
                x = mbs[m] if i == 0 else acts.pop((i - 1, m), None)
                if x is None:
                    continue
                out = stages[i].forward(m, x, tgts[m] if i == S - 1 else None)
                if i < S - 1:
                    acts[(i, m)] = out
            else:
                g = None if i == S - 1 else grads.pop((i + 1, m), None)
                if i < S - 1 and g is None:
                    continue
                grads[(i, m)] = stages[i].backward(m, g)
            plan.popleft()
    return [s.apply_grads(M) for s in stages]


def test_stage_windows_match_jax_in_1f1b_order():
    """2 stages x M=4 in process: the port's pipeline.fwd / pipeline.bwd
    windows carry JAX's (name, stage, mb) sequence, each stage under its
    own tid, 2M windows a stage in bubble_stats; with RAY_TPU_TRACE=0
    none is recorded."""
    from ray_tpu.train.mpmd import PipelineStage as JStage, sgd as jsgd
    from ray_tpu.util import tracing as jtracing
    from ray_tpu_torch.util import tracing as ttracing
    S, d, M = 2, 8, 4
    params, jfn = _tanh_stages(S, d)
    mbs, tgts = _inputs(M, 4, d)
    tfn, tloss = _torch_stage_fns()
    jst = [JStage(i, S, jfn, params[i], loss_fn=_mse if i == S - 1 else None,
                  optimizer=jsgd(0.1)) for i in range(S)]
    tst = [tmpmd.PipelineStage(i, S, tfn, _np(params[i]), loss_fn=tloss if i == S - 1 else None,
                               optimizer=tmpmd.sgd(0.1), device="cpu") for i in range(S)]
    seqs = []
    try:
        for tracing, stages, xs, ts in ((jtracing, jst, mbs, tgts),
                                        (ttracing, tst, [np.array(x) for x in mbs],
                                         [np.array(t) for t in tgts])):
            tracing.clear()
            _run_1f1b(stages, xs, ts)
            evs = [e for e in tracing.events() if e["cat"] == "pipeline"]
            seqs.append(([(e["name"], e["args"]["stage"], e["args"]["mb"]) for e in evs],
                         evs, tracing.take_shipped()))
        (want, _, _), (got, evs, shipped) = seqs
        assert got == want and len(got) == 2 * S * M
        assert {e["tid"] for e in evs} == {(evs[0]["pid"], i) for i in range(S)}
        assert [(e["name"], e["args"]["stage"], e["args"]["mb"]) for e in shipped] == got
        stats = ttracing.bubble_stats(ttracing.to_chrome(evs), extra_cats=("pipeline",))
        assert [w["windows"] for w in stats["workers"].values()] == [2 * M] * S
        ttracing.clear()
        with pytest.MonkeyPatch.context() as m:
            m.setenv("RAY_TPU_TRACE", "0")
            ttracing.refresh()
            _run_1f1b(tst, [np.array(x) for x in mbs], [np.array(t) for t in tgts])
            assert ttracing.events() == []
    finally:
        ttracing.clear()
        ttracing.refresh()
