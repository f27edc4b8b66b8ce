"""The serving replica through each package's own runtime on the CPU: the
port's tiny-preset paged `LLMServer(device="cpu")` as a
`ray_tpu_torch.remote` actor against JAX's `LLMServer` as a
`ray_tpu.remote` actor, on JAX's f32 weights carried across by
models/convert.py. The port's weights reach its actor through the port's
object store (a state_dict of tensors as the creation argument). JAX's
actor builds the same params from the config's seed in its own process:
`ray_session` is shared by every test file an xdist worker runs, and a
store that earlier files left at its demotion threshold demoted a params
argument between restore and read until the actor's creation failed. The
prompts and waves are test_torch_llm_server.py's: greedy ids identical
request by request, with wave 2's radix hit on the port's side."""

import jax
import pytest

import ray_tpu_torch as rt
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm
from test_torch_llm_server import WAVES, _cfg


@pytest.fixture(scope="module")
def port_session():
    rt.init(num_cpus=2, num_gpus=0)
    yield rt
    rt.shutdown()


def _waves(get, actor):
    """Each wave's requests sent together, the next wave once it finished."""
    out = []
    for wave in WAVES:
        out += get([actor.generate.remote(list(p), max_tokens=8) for p in wave])
    return out


@pytest.mark.parametrize("chunk", [1, 8])
def test_llm_server_actor_matches_jax_actor(ray_session, port_session, chunk):
    params = jllm.LLMServer(_cfg(jllm, chunk, True)).params
    state = flax_to_state_dict(jax.device_get(params))
    ours = rt.remote(num_cpus=1)(tllm.LLMServer).remote(
        _cfg(tllm, chunk, True, device="cpu"), params=state)
    theirs = ray_session.remote(num_cpus=1)(jllm.LLMServer).remote(_cfg(jllm, chunk, True))
    got = _waves(rt.get, ours)
    want = _waves(ray_session.get, theirs)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert all(len(g["tokens"]) == 8 for g in got)
    stats = rt.get(ours.stats.remote())
    assert stats["prefix_hit_tokens"] > 0            # wave 2 hit wave 1's pages
    rt.kill(ours)
    ray_session.kill(theirs)

