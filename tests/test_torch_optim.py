"""ray_tpu_torch.ops.optim against ray_tpu.ops.optim (optax) on the CPU:
each lr schedule at several step counts (1e-6 relative: float64 here,
float32 in jnp), and updates of adam, adamw and sgd, with and without
global-norm clipping and a schedule, on the same numpy-seeded params and
grads (f32; 1e-6 absolute after updates of size ~1e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import optim as joptim
from ray_tpu_torch.ops import optim as toptim

STEPS = [0, 1, 2, 5, 9, 10, 11, 37, 99, 100, 150]


@pytest.mark.parametrize("spec", [
    None,
    {"type": "cosine", "warmup_steps": 10, "decay_steps": 100, "final_lr_scale": 0.1},
    {"type": "cosine", "decay_steps": 100},
    {"type": "linear", "warmup_steps": 10, "decay_steps": 100, "final_lr_scale": 0.2},
    {"type": "linear", "decay_steps": 50},
    {"type": "constant", "warmup_steps": 10},
    {"type": "constant"},
    [[0, 1e-3], [10, 5e-4], [100, 1e-5]],
    [],
], ids=["none", "cosine_warmup", "cosine", "linear_warmup", "linear", "const_warmup",
        "const", "piecewise", "piecewise_empty"])
def test_schedule_matches_optax(spec):
    want = joptim.make_lr_schedule(1e-3, spec)
    got = toptim.make_lr_schedule(1e-3, spec)
    for n in STEPS:
        w = float(want(n))
        assert abs(got(n) - w) <= 1e-6 * max(abs(w), 1e-3), (n, got(n), w)


def _params_and_grads(seed, n_steps):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5), dtype=np.float32),
              "b": rng.standard_normal((5,), dtype=np.float32)}
    grads = [{k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in params.items()}
             for _ in range(n_steps)]
    return params, grads


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam", lr=1e-2),
    dict(optimizer="adamw", lr=1e-2, weight_decay=0.1),
    dict(optimizer="sgd", lr=1e-2, grad_clip=0.5),
    dict(optimizer="adam", lr=1e-2, grad_clip=100.0,
         lr_schedule={"type": "cosine", "warmup_steps": 1, "decay_steps": 4}),
], ids=["adam", "adamw", "sgd_clip", "adam_noclip_cosine"])
def test_updates_match_optax(kw):
    params, grads = _params_and_grads(0, 3)
    tx, _ = joptim.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, schedule = toptim.make_optimizer(list(tp.values()), **kw)
    assert schedule(0) == pytest.approx(float(joptim.make_lr_schedule(
        kw["lr"], kw.get("lr_schedule"))(0)))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=k)


def test_clip_by_global_norm_matches_optax():
    import optax
    _, (g,) = _params_and_grads(1, 1)
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in g.items()}, None)
    ps = [torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()]
    for p, v in zip(ps, g.values()):
        p.grad = torch.from_numpy(v.copy())
    norm = toptim.clip_by_global_norm(ps, 1.0)
    assert float(norm) == pytest.approx(float(optax.global_norm(
        {k: jnp.asarray(v) for k, v in g.items()})), rel=1e-6)
    for p, k in zip(ps, g):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6)


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        toptim.make_optimizer([torch.nn.Parameter(torch.zeros(2))], optimizer="lamb")
    with pytest.raises(ValueError):
        toptim.make_lr_schedule(1e-3, {"type": "exp", "decay_steps": 3})
