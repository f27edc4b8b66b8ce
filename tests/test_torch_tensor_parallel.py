"""Tensor-parallel serving (LLMConfig.tp) of ray_tpu_torch against
ray_tpu's LLMServer(tp=2) on the CPU: JAX's five cases
(tests/test_llm_tensor_parallel.py), on 2 gloo ranks, tiny preset, f32,
the same weights in both packages, plus moe_tiny at tp=2 and a follower
that fails.

One spawn of 2 ranks (the rank functions import no jax) serves every
case in turn: rank 0 drives each server, rank 1 follows; every rank
records the model-step calls it made, which must be the same sequence.
The JAX side runs in the test process on its 8 virtual CPU devices."""

import asyncio
import re
import sys
import threading

import pytest
import torch

from ray_tpu_torch.serve import llm as tllm
from test_torch_distributed import run_ranks

PROMPT = [5, 6, 7, 8] * 4
PAIR = [9, 3, 9, 3, 9, 3]


def _cfg(tp, preset="tiny", **kw):
    return dict(preset=preset, max_batch_slots=2, max_seq_len=128, tp=tp, dtype="float32",
                param_dtype="float32", **kw)


async def _pair(srv):
    return await asyncio.gather(srv.generate(PAIR, max_tokens=12),
                                srv.generate(list(reversed(PAIR)), max_tokens=12,
                                             temperature=0.7))


def _tp_rank(rank, world, store, sd_dense, sd_moe):
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import shard_state_dict
    from ray_tpu_torch.parallel import distributed as tdist
    tdist.initialize_multihost(store, num_processes=world, process_id=rank, device="cpu")
    dense = {k: torch.from_numpy(v) for k, v in sd_dense.items()}
    moe = {k: torch.from_numpy(v) for k, v in sd_moe.items()}
    out = {}

    def serve(name, params, drive, fail_follower=False, **kw):
        srv = tllm.LLMServer(tllm.LLMConfig(**_cfg(2, device="cpu", **kw)), params=params)
        calls = []
        real_call = srv._call
        srv._call = lambda n, a: (calls.append(n), real_call(n, a))[1]
        if fail_follower and rank == 1:
            def broken(*a):
                raise RuntimeError("follower lost its card")
            srv._decode_chunk = broken
        try:
            if rank == 0:
                out[name] = asyncio.run(drive(srv))
                out[name + "/stats"] = srv.stats()
                srv.shutdown()
            else:
                srv.follow()
        except RuntimeError as e:
            out[name] = f"raised: {e}" + (f" <- {e.__cause__}" if e.__cause__ else "")
        out[name + "/calls"] = calls
        return srv

    one = lambda srv: srv.generate(PROMPT, max_tokens=20)
    serve("greedy", dense, one)
    serve("pair", dense, _pair)
    serve("spec", dense, one, speculate=4)
    srv = serve("born", None, lambda s: s.generate(PROMPT, max_tokens=4))
    whole = tllm.LLMServer(tllm.LLMConfig(**_cfg(1, device="cpu"))).model.state_dict()
    mine = srv.model.state_dict()
    out["born/bitwise"] = all(torch.equal(mine[k], v)
                              for k, v in shard_state_dict(whole, srv.mesh).items())
    out["born/wq"] = tuple(mine["layers_0.attn.wq.weight"].shape)
    out["born/kv"] = tuple(srv.cache.k[0].shape)
    serve("moe", moe, one, preset="moe_tiny")
    out["jax_loaded"] = "jax" in sys.modules
    # last: a follower that fails. It reports its error to rank 0 and raises;
    # rank 0, held in the collective rank 1 left until rank 1's process
    # exits with the rank function, raises the report.
    serve("broken", dense, one, fail_follower=True)
    if rank == 0:
        dist.destroy_process_group()
    return out


def _jax(tp, params=None, preset="tiny", **kw):
    from ray_tpu.serve.llm import LLMConfig, LLMServer
    return LLMServer(LLMConfig(**_cfg(tp, preset, **kw)), params=params)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's results, the ranks' results) on the same weights; the ranks
    serve while JAX compiles."""
    import jax
    from ray_tpu_torch.models.convert import flax_to_state_dict
    params = {p: jax.device_get(_jax(1, preset=p).params) for p in ("tiny", "moe_tiny")}
    host = [{k: v.numpy() for k, v in flax_to_state_dict(params[p]).items()}
            for p in ("tiny", "moe_tiny")]
    got = []
    ranks = threading.Thread(target=lambda: got.append(run_ranks(
        _tp_rank, 2, tmp_path_factory.mktemp("tp"), *host, timeout=150)))
    ranks.start()
    try:
        tp2 = _jax(2, params["tiny"])
        want = {"tiny": asyncio.run(tp2.generate(PROMPT, max_tokens=20))["tokens"],
                "born": tp2, "pair": asyncio.run(_pair(_jax(2, params["tiny"])))}
        spec = _jax(2, params["tiny"], speculate=4)
        want["spec"] = asyncio.run(spec.generate(PROMPT, max_tokens=20))["tokens"]
        moe = _jax(2, params["moe_tiny"], "moe_tiny")
        want["moe_tiny"] = asyncio.run(moe.generate(PROMPT, max_tokens=20))["tokens"]
    finally:
        ranks.join()
    assert got, "the ranks failed (see the captured output)"
    return want, got[0]


def test_tp_matches_single_device_greedy(both):
    want, got = both
    assert got[0]["greedy"]["tokens"] == want["tiny"]
    assert got[0]["greedy/calls"] == got[1]["greedy/calls"]
    assert not any(r["jax_loaded"] for r in got)


def test_tp2_and_concurrent_requests(both):
    want, got = both
    greedy, sampled = got[0]["pair"]
    assert greedy["tokens"] == want["pair"][0]["tokens"]      # greedy request exact
    assert len(sampled["tokens"]) == 12                      # sampled request completes
    # every rank made the same calls, and no chunk's lockstep check fired
    assert got[0]["pair/calls"] == got[1]["pair/calls"]
    assert "_decode_chunk" in got[1]["pair/calls"]


def test_tp_composes_with_speculation(both):
    want, got = both
    assert got[0]["spec"]["tokens"] == want["spec"] == want["tiny"]
    st = got[0]["spec/stats"]["speculation"]
    assert st["spec_ticks"] + st["decode_ticks"] > 0
    assert got[0]["spec/calls"] == got[1]["spec/calls"]


def test_tp_validation():
    """JAX's errors, in JAX's order, before any weight is allocated; the
    port's world is its process group (one process here)."""
    from ray_tpu.serve.llm import LLMConfig, LLMServer
    cases = [(dict(tp=2, paged=True), "paged"), (dict(tp=3), "n_kv_heads"),
             (dict(tp=16, model_overrides=dict(n_heads=16, n_kv_heads=16)), "but only")]
    for kw, what in cases:
        with pytest.raises(ValueError, match=what) as want:
            LLMServer(LLMConfig(preset="tiny", **kw))
        with pytest.raises(ValueError, match=what) as got:
            tllm.LLMServer(tllm.LLMConfig(preset="tiny", device="cpu", **kw))
        if what == "but only":
            pat = r"tp=16 but only \d+ devices visible"
            assert re.fullmatch(pat, str(got.value)) and re.fullmatch(pat, str(want.value))
        else:
            assert str(got.value) == str(want.value)


def test_params_and_cache_born_sharded(both):
    """Each rank holds 1/tp of wq's heads and of the KV cache's kv-head
    axis, as JAX's shards do, and its blocks are bitwise those of the
    seeded tp=1 model."""
    want, got = both
    assert len(got[0]["born"]["tokens"]) == 4
    jsrv = want["born"]
    kv = jsrv.cache.k[0]
    jwq = jsrv.params["params"]["layers_0"]["attn"]["wq"]["kernel"]
    for res in got:
        assert res["born/bitwise"]
        assert res["born/kv"][2] == kv.addressable_shards[0].data.shape[2] == kv.shape[2] // 2
        assert res["born/wq"][::-1] == jwq.addressable_shards[0].data.shape


def test_moe_tiny_tp2_matches_jax(both):
    want, got = both
    assert got[0]["moe"]["tokens"] == want["moe_tiny"]
    assert got[0]["moe/calls"] == got[1]["moe/calls"]


def test_failing_follower_raises_on_rank_0(both):
    _, got = both
    assert got[1]["broken"] == "raised: follower lost its card"
    assert got[0]["broken"].startswith("raised: decode engine failed <- tp follower failed in "
                                       "_decode_chunk: rank 1: RuntimeError: follower lost "
                                       "its card")
