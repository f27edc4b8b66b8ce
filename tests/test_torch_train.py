"""ray_tpu_torch.train.llm_step against the JAX training step built as
bench.py:712-738 builds it (forward with return_hidden, chunked
cross-entropy on the lm_head kernel, value_and_grad, optax.adamw(1e-4)), on
the tiny preset in f32, from the same flax params (carried across by
models/convert.py) and the same host batches.

Tolerances (f32; summation order only): the loss 1e-5 relative; every
parameter's gradient GRAD_TOL relative to its largest |grad|; params after 1
and 3 AdamW steps PARAM_ATOL absolute (each step moves a param by up to
lr = 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops.losses import chunked_cross_entropy as j_chunked_ce
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops.optim import make_optimizer
from ray_tpu_torch.train import llm_step

B, T = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_ATOL = 1e-6
_CACHE = {}


def _jax_setup(attn_impl):
    """bench.py's model, params, optimizer and jitted step on the tiny preset."""
    if attn_impl in _CACHE:
        return _CACHE[attn_impl]
    cfg = jllama.LlamaConfig.tiny(param_dtype=jnp.float32, dtype=jnp.float32,
                                  max_seq_len=T, remat=False, attn_impl=attn_impl)
    model = jllama.Llama(cfg)
    batches = llm_step.host_batches(cfg.vocab_size, B, T)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(batches[0])[:2, :-1])
    opt = optax.adamw(1e-4)

    def loss_fn(params, tokens):
        hidden, _ = model.apply(params, tokens[:, :-1], return_hidden=True)
        w_head = params["params"]["lm_head"]["kernel"]
        loss, _ = j_chunked_ce(hidden, w_head, tokens[:, 1:], chunk_size=min(512, T))
        return loss

    @jax.jit
    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    _CACHE[attn_impl] = (params, opt.init(params), step, batches)
    return _CACHE[attn_impl]


def _port_model(params, attn_impl, remat=False):
    cfg = tllama.LlamaConfig.tiny(param_dtype=torch.float32, dtype=torch.float32,
                                  max_seq_len=T, remat=remat, attn_impl=attn_impl)
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return model


def _port_step(model):
    opt, _ = make_optimizer(model.parameters(), lr=1e-4, optimizer="adamw",
                            weight_decay=1e-4)
    return llm_step.make_train_step(model, opt, chunk_size=512)


def _check_params(model, jparams, what):
    want = flax_to_state_dict(jax.device_get(jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_step_matches_jax(attn_impl):
    """attn_impl="flash": Pallas forward and backward kernels (interpret mode)
    on the JAX side, the port's autograd Function (plain versions) here."""
    jparams, jstate, jstep, batches = _jax_setup(attn_impl)
    model = _port_model(jparams, attn_impl)
    step = _port_step(model)
    for i in range(3):
        jparams, jstate, jloss, jgrads = jstep(jparams, jstate, jnp.asarray(batches[i]))
        loss = step(torch.from_numpy(batches[i]))
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
        if i == 0:
            want = flax_to_state_dict(jax.device_get(jgrads))
            for name, p in model.named_parameters():
                w = want[name].numpy()
                err = np.abs(p.grad.numpy() - w).max()
                assert err <= GRAD_TOL * np.abs(w).max(), (name, err, np.abs(w).max())
        if i in (0, 2):
            _check_params(model, jparams, f"after {i + 1} steps")


def test_train_llama_matches_jax_losses():
    """The entry point with flax params: every step's loss (two warm-up
    steps, then timed ones) against the JAX loop on the same batch ring."""
    jparams, jstate, jstep, batches = _jax_setup("xla")
    want = []
    p, s = jparams, jstate
    for i in range(4):
        p, s, loss, _ = jstep(p, s, jnp.asarray(batches[i]))
        want.append(float(loss))
    got = llm_step.train_llama("tiny", B, T, steps=2, warmup_steps=2, device="cpu",
                               params=jax.device_get(jparams), dtype=torch.float32,
                               remat=False)
    assert got["remat"] is False and got["device"] == "cpu"
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
    assert got["tokens_per_s"] > 0 and got["ms_per_step"] > 0


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_gives_the_same_grads(attn_impl):
    jparams, _, _, batches = _jax_setup("xla")
    tokens = torch.from_numpy(batches[0])
    grads = []
    for remat in (False, True):
        model = _port_model(jparams, attn_impl, remat=remat)
        hidden, _ = model(tokens[:, :-1], return_hidden=True)
        loss, _ = llm_step.chunked_cross_entropy(hidden, model.lm_head.weight, tokens[:, 1:],
                                                  chunk_size=16)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-7 * float(g.abs().max()),
                                   msg=name)


def test_cpu_training_launches_no_kernel():
    counts = lambda: (tflash.LAUNCHES, tflash.BWD_DQ_LAUNCHES, tflash.BWD_DKV_LAUNCHES)
    before = counts()
    jparams, _, _, _ = _jax_setup("xla")
    model = _port_model(jparams, "flash", remat=True)
    _port_step(model)(torch.from_numpy(llm_step.host_batches(256, B, T)[0]))
    assert counts() == before


def test_host_batches_are_bench_draws():
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 256, (B, T + 1), dtype=np.int32) for _ in range(8)]
    got = llm_step.host_batches(256, B, T)
    assert len(got) == 8 and all(np.array_equal(g, w) for g, w in zip(got, want))


def test_bench_defaults():
    """remat off for llama_1b at batch <= 4 and on otherwise (bench.py:693);
    bf16 params for llama_1b; attention "auto" on the CPU."""
    model, opt, _, batches, dev = llm_step.build_llama_trainer(
        "tiny", 2, 16, device="cpu")
    assert model.cfg.remat is True and model.cfg.attn_impl == "auto"
    assert model.cfg.dtype == torch.bfloat16 and dev.type == "cpu"
    assert batches[0].shape == (2, 17)
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8


def test_train_llama_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llm_step.train_llama("tiny", 2, 16, steps=1)
