"""The OpenAI HTTP app and PD through deployment handles:
`ray_tpu_torch.serve` against `ray_tpu.serve` on the CPU.

- `build_openai_app` over the tiny preset (vocab 260, the byte
  tokenizer's), f32, on one set of weights: JAX's app gets JAX's
  `(LLMConfig, params)`, the port's `(LLMConfig(device="cpu"),
  flax_to_state_dict(params))`; each runs in its package's session behind
  its own proxy. The models list, completions (unary and SSE), chat (unary
  and SSE), stop strings, tokenize / detokenize and the error shapes are
  equal field by field but for ids and timestamps; embeddings are held
  within 1e-5 of the largest |value|, as `tests/test_torch_llm_slo.py`
  holds `embed`.
- PD as two deployments of the port: a `PDServer` replica bound with a
  `PrefillServer` replica's handle gives JAX's greedy ids on the same
  weights, prefilling nothing itself.
- No fallback: an OpenAI ingress whose engine says `device="cuda"` on this
  card-less box fails its first request with the CUDA error and answers
  nothing else.
"""

import asyncio
import http.client
import json

import jax
import numpy as np
import pytest

import ray_tpu.serve as jserve
import ray_tpu_torch.serve as tserve
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import pd as tpd
from test_torch_serve import port_session  # noqa: F401 - the module's port session

MODEL = "tiny-lm"
JSON = {"Content-Type": "application/json"}


def _cfg(mod, **kw):
    base = dict(preset="tiny", max_batch_slots=4, max_seq_len=256, prefill_chunk=32,
                paged=True, page_size=16, seed=0, temperature=0.0,
                param_dtype="float32", dtype="float32", model_overrides={"vocab_size": 260})
    if mod is tllm:
        base["device"] = "cpu"
    base.update(kw)
    return mod.LLMConfig(**base)


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if body is None else
                 (body if isinstance(body, str) else json.dumps(body)), headers=JSON)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def _strip(obj):
    """The answer without its request id and timestamps."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _answer(status, ctype, data):
    """(status, content type, JSON or the SSE events' JSON), stripped."""
    if ctype.startswith("text/event-stream"):
        events = [ln[6:] for ln in data.decode().split("\n") if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        return status, ctype, [_strip(json.loads(e)) for e in events[:-1]]
    return status, ctype, _strip(json.loads(data))


@pytest.fixture(scope="module")
def jax_server():
    """JAX's server on the tiny preset: its weights are every engine's here."""
    return jllm.LLMServer(_cfg(jllm))


@pytest.fixture(scope="module")
def weights(jax_server):
    return jax_server.params, flax_to_state_dict(jax.device_get(jax_server.params))




@pytest.fixture(scope="module")
def apps(ray_session, port_session, weights):
    """Each package's OpenAI app on the same weights: its proxy's port."""
    jparams, sd = weights
    jserve.run(jserve.build_openai_app({MODEL: (_cfg(jllm), jparams)}), name="openai",
               route_prefix="/")
    tserve.run(tserve.build_openai_app({MODEL: (_cfg(tllm), sd)}), name="openai",
               route_prefix="/")
    yield {"jax": jserve.start(http_options={"port": 0}),
           "port": tserve.start(http_options={"port": 0})}
    jserve.shutdown()
    tserve.delete("openai")


def _on_both(apps, *request):
    want = _answer(*_req(apps["jax"], *request))
    got = _answer(*_req(apps["port"], *request))
    assert got == want
    return got


def test_models_list_and_card(apps):
    assert _on_both(apps, "GET", "/v1/models")[2]["data"] == [
        {"object": "model", "owned_by": "ray_tpu"}]
    assert _on_both(apps, "GET", f"/v1/models/{MODEL}")[0] == 200
    assert _on_both(apps, "GET", "/v1/models/nope")[2]["error"]["code"] == "model_not_found"


@pytest.mark.parametrize("body", [
    {"prompt": "hello", "max_tokens": 8},
    {"prompt": [[70, 71, 72, 73, 74, 75]], "max_tokens": 6},
    {"prompt": "the same prompt, a longer one: " * 3, "max_tokens": 12},
    {"prompt": "hello", "max_tokens": 8, "stream": True},
    {"prompt": "zz", "max_tokens": 6, "stream": True},
])
def test_completions_match_jax(apps, body):
    status, ctype, out = _on_both(apps, "POST", "/v1/completions", {"model": MODEL, **body})
    assert status == 200
    if body.get("stream"):
        assert ctype == "text/event-stream"
        assert out[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    else:
        assert out["object"] == "text_completion"
        assert out["usage"]["completion_tokens"] == body["max_tokens"]


@pytest.mark.parametrize("stream", [False, True])
def test_chat_completions_match_jax(apps, stream):
    body = {"model": MODEL, "max_tokens": 8, "stream": stream,
            "messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hi"}]}
    status, _, out = _on_both(apps, "POST", "/v1/chat/completions", body)
    assert status == 200
    if stream:
        assert out[0]["choices"][0]["delta"] == {"role": "assistant"}
    else:
        assert out["choices"][0]["message"]["role"] == "assistant"


def test_stop_strings_and_stream_vs_unary(apps):
    """A stop string cut from the greedy text, unary and streamed: the same
    cut text in both packages, and the stream's text the unary's."""
    base = {"model": MODEL, "prompt": "ab", "max_tokens": 8}
    full = _on_both(apps, "POST", "/v1/completions", base)[2]["choices"][0]["text"]
    stop = next((c for c in full[1:] if c != "�"), None) or full[-1:]
    unary = _on_both(apps, "POST", "/v1/completions", {**base, "stop": stop})[2]
    streamed = _on_both(apps, "POST", "/v1/completions", {**base, "stop": stop, "stream": True})[2]
    text = unary["choices"][0]["text"]
    assert stop not in text and unary["choices"][0]["finish_reason"] == "stop"
    assert "".join(c["choices"][0]["text"] for c in streamed) == text


def test_tokenize_detokenize_and_errors_match_jax(apps):
    toks = _on_both(apps, "POST", "/tokenize", {"model": MODEL, "prompt": "héllo ✓"})[2]
    assert toks["count"] == len(toks["tokens"]) == 10
    assert _on_both(apps, "POST", "/detokenize", {"model": MODEL, "tokens": toks["tokens"]})[2] \
        == {"prompt": "héllo ✓"}
    errors = [("POST", "/v1/completions", {"model": "missing", "prompt": "x"}),
              ("POST", "/v1/completions", "{nope"),
              ("POST", "/v1/completions", {"model": MODEL, "prompt": "x", "n": 3}),
              ("POST", "/v1/completions", {"model": MODEL, "prompt": ["a", "b"]}),
              ("POST", "/v1/chat/completions", {"model": MODEL, "messages": []}),
              ("POST", "/v1/embeddings", {"model": MODEL, "input": 42}),
              ("POST", "/v1/embeddings", {"model": MODEL, "input": ["ok", ""]}),
              ("PUT", "/v1/completions", {}),
              ("POST", "/v1/nothing", {})]
    got = [_on_both(apps, *e)[0] for e in errors]
    assert got == [404, 400, 400, 400, 400, 400, 400, 405, 404]


def test_embeddings_match_jax(apps):
    body = {"model": MODEL, "input": ["hello", "world", "a longer input to embed"]}
    want = json.loads(_req(apps["jax"], "POST", "/v1/embeddings", body)[2])
    got = json.loads(_req(apps["port"], "POST", "/v1/embeddings", body)[2])
    assert _strip({**got, "data": len(got["data"])}) == _strip({**want, "data": len(want["data"])})
    for g, w in zip(got["data"], want["data"]):
        gv, wv = np.asarray(g["embedding"]), np.asarray(w["embedding"])
        assert g["index"] == w["index"] and gv.shape == wv.shape == (64,)
        assert np.abs(gv - wv).max() <= 1e-5 * np.abs(wv).max()


PD_PROMPTS = [list(range(5, 25)), [7, 3, 11] * 9, list(range(60, 100)), list(range(5, 25)) + [9]]


def test_pd_deployments_match_jax_greedy_ids(port_session, jax_server, weights):
    """A PDServer replica whose prefill is a PrefillServer replica's handle
    (two processes of the port's runtime): JAX's greedy ids request by
    request, the PD replica prefilling nothing and the prefill replica
    decoding nothing."""
    _, sd = weights
    want = [asyncio.run(jax_server.generate(p, max_tokens=8))["tokens"] for p in PD_PROMPTS]
    prefill = tserve.deployment(tpd.PrefillServer, name="prefill").bind(_cfg(tllm), sd)
    app = tserve.deployment(tpd.PDServer, name="pd").bind(_cfg(tllm), sd, prefill=prefill)
    h = tserve.run(app, name="pd-app")
    try:
        got = [h.generate.remote(p, max_tokens=8).result(timeout_s=120)["tokens"]
               for p in PD_PROMPTS]
        streamed = list(h.options(stream=True).generate_stream.remote(PD_PROMPTS[1],
                                                                      max_tokens=8))
        pd_stats = h.stats.remote().result(timeout_s=60)
        pre_stats = tserve.get_deployment_handle("prefill", "pd-app").stats.remote().result(
            timeout_s=60)
    finally:
        tserve.delete("pd-app")
    assert got == want and streamed == want[1]
    assert pd_stats["pd_requests"] == len(PD_PROMPTS) + 1
    assert pd_stats["prefill"]["chunks"] == 0 and pre_stats["decode"]["tokens"] == 0
    assert pd_stats["kv_ship"]["attach_hits"] >= len(PD_PROMPTS)


def test_cuda_engine_without_a_card_fails_loudly(port_session):
    """No CPU fallback: the ingress's engine says cuda, this box has no card,
    so its replica fails at construction. The first request over HTTP
    answers 500 with that error, the first over the handle raises it (no
    replica survives to retry on), and the corpse is pruned: a later
    request answers 500 too."""
    app = tserve.build_openai_app({MODEL: _cfg(tllm, device="cuda")})
    h = tserve.run(app, name="nocard", route_prefix="/nocard")
    port = tserve.start(http_options={"port": 0})
    try:
        status, _, data = _req(port, "POST", "/nocard/v1/completions",
                               {"model": MODEL, "prompt": "x"})
        with pytest.raises(RuntimeError, match="no surviving replicas; the last one died: "
                                               "(.|\n)*no CUDA device is visible"):
            h.remote(tserve.Request("GET", "/v1/models")).result(timeout_s=60)
        after = _req(port, "GET", "/nocard/v1/models")
    finally:
        tserve.delete("nocard")
    assert status == 500 and b"no CUDA device is visible" in data
    # the proxy's handle reroutes once its refresh (0.5 s) sees the corpse pruned
    assert after[0] == 500 and (b"has no replicas" in after[2]
                                or b"no CUDA device is visible" in after[2])
