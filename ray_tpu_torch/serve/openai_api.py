"""OpenAI-compatible serving surface (reference: python/ray/llm/_internal/
serve/core/ingress/ingress.py route table — /v1/models, /v1/models/{id},
/v1/completions, /v1/chat/completions, /tokenize, /detokenize — and
core/configs/openai_api_models.py response shapes).

Re-design, not a port: the reference mounts FastAPI + pydantic request
models over vLLM/SGLang engines; here the surface is a single generator
ingress over this repo's own proxy, whose SSE framing (`data: {json}` per
event, `data: [DONE]` terminator) is already exactly OpenAI's wire format.
Per-request `stream` selection works because the proxy treats a generator
ingress whose first yield is a `Response` as unary (proxy.py
_respond_streaming). Engines are the port's LLMServer (continuous
batching, paged KV, the hand-written attention kernels on the card) —
either in-process or behind deployment handles, the same duality pd.py
uses. An engine given as an `(LLMConfig, params)` tuple takes the port's
state_dict as its params. An in-process engine is built in the ingress's
own replica: an `LLMConfig` whose device is `cuda` needs that replica to
hold a card, and fails its construction otherwise (no CPU fallback).

Text <-> ids: OpenAI endpoints speak text, LLMServer speaks token ids.
`build_openai_app` takes any object with encode/decode/eos_id (a HF
tokenizer loaded from a local path works); the default ByteTokenizer
(utf-8 bytes shifted past 4 reserved specials) keeps the surface fully
self-contained — no tokenizer download, works with vocab_size >= 260.
"""

import json
import time
import uuid
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple, Union

from .llm import LLMConfig, LLMServer
from .proxy import Request, Response


class ByteTokenizer:
    """utf-8 byte tokenizer: id = byte + n_specials. Specials: 0=pad 1=bos
    2=eos 3=unk. Self-contained (no vocab file), reversible for any text."""

    def __init__(self, n_specials: int = 4):
        self.n_specials = n_specials
        self.eos_id = 2 if n_specials >= 3 else None
        self.vocab_size = 256 + n_specials

    def encode(self, text: str) -> List[int]:
        off = self.n_specials
        return [b + off for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        off = self.n_specials
        # ids past the byte range (a model vocab larger than 260) decode to
        # nothing rather than raising — a sampled id 300 must not turn the
        # whole request into a 500
        return bytes(t - off for t in ids
                     if off <= t < off + 256).decode("utf-8",
                                                     errors="replace")


class _IncrementalDecoder:
    """Streaming text from streaming ids without splitting multi-byte
    chars: hold back bytes until they decode cleanly (a utf-8 sequence is
    at most 4 bytes, so the holdback never exceeds 3)."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = 0   # chars already returned

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        # trailing replacement char may be a split sequence, not real data:
        # withhold it until more bytes arrive
        while text.endswith("�"):
            text = text[:-1]
        fresh = text[self._emitted:]
        self._emitted = len(text)
        return fresh

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        fresh = text[self._emitted:]
        self._emitted = len(text)
        return fresh


def render_chat(messages: List[Dict[str, str]]) -> str:
    """Minimal generic chat template (models bring their own via the
    `chat_template` callable on build_openai_app)."""
    parts = []
    for m in messages:
        parts.append(f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


class OpenAIError(Exception):
    def __init__(self, status: int, message: str, err_type: str =
                 "invalid_request_error", code: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.body = {"error": {"message": message, "type": err_type,
                               "code": code}}


def _json_response(obj, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), status,
                    media_type="application/json")


def _first_stop_hit(text: str, stops: List[str]) -> Optional[int]:
    hits = [i for i in (text.find(s) for s in stops) if i >= 0]
    return min(hits) if hits else None


def _max_holdback(stops: List[str]) -> int:
    """Chars to withhold while streaming so a stop string split across
    chunks is never partially emitted."""
    return max((len(s) - 1 for s in stops), default=0)


class OpenAIIngress:
    """Generator ingress serving the OpenAI REST surface over named engines.

    `models` maps model id -> engine, where an engine is an LLMConfig
    (an LLMServer is constructed in-process), an LLMServer instance, or a
    serve DeploymentHandle to a deployment exposing LLMServer's generate /
    generate_stream. Deploy via `build_openai_app` or directly:

        app = serve.deployment(OpenAIIngress).bind(
            {"tiny-chat": LLMConfig(preset="tiny")})
        serve.run(app, route_prefix="/")
    """

    def __init__(self, models: Dict[str, Any], tokenizer=None,
                 chat_template=None):
        self._tok = tokenizer or ByteTokenizer()
        self._template = chat_template or render_chat
        self._created = int(time.time())
        self._engines: Dict[str, Any] = {}
        for name, engine in models.items():
            if isinstance(engine, LLMConfig):
                engine = LLMServer(engine)
            elif isinstance(engine, tuple):
                # (LLMConfig, params): a checkpoint — e.g. a merge_lora'd
                # adapter (models/lora.py) — served under its own model id.
                # NOTE: each tuple entry is a RESIDENT engine (full params
                # + its own KV cache); fine for a handful of model ids.
                # Many adapters over one base should instead use a
                # @serve.multiplexed loader calling merge_lora, so the
                # multiplex LRU bounds device memory.
                cfg_e, params_e = engine
                engine = LLMServer(cfg_e, params=params_e)
            self._engines[name] = engine

    # -- engine access --------------------------------------------------------
    def _engine(self, model: Optional[str]):
        if model is None:
            raise OpenAIError(400, "request is missing the 'model' field")
        eng = self._engines.get(model)
        if eng is None:
            raise OpenAIError(
                404, f"model {model!r} does not exist; available: "
                f"{sorted(self._engines)}", code="model_not_found")
        return eng

    async def _generate(self, eng, prompt_ids, **kw) -> Dict[str, Any]:
        if isinstance(eng, LLMServer):
            return await eng.generate(prompt_ids, **kw)
        import asyncio
        loop = asyncio.get_running_loop()
        # DeploymentHandle: .remote() does sync controller IO — keep it off
        # the loop (same pattern as pd.py _remote_prefill)
        resp = await loop.run_in_executor(
            None, lambda: eng.generate.remote(prompt_ids, **kw))
        return await resp

    async def _generate_stream(self, eng, prompt_ids,
                               **kw) -> AsyncIterator[int]:
        if isinstance(eng, LLMServer):
            async for tok in eng.generate_stream(prompt_ids, **kw):
                yield tok
            return
        import asyncio
        loop = asyncio.get_running_loop()
        gen = await loop.run_in_executor(
            None, lambda: eng.options(stream=True).generate_stream.remote(
                prompt_ids, **kw))
        it = iter(gen)
        _END = object()
        while True:
            tok = await loop.run_in_executor(None, lambda: next(it, _END))
            if tok is _END:
                return
            yield tok

    # -- request plumbing -----------------------------------------------------
    @staticmethod
    def _sampling_kwargs(body: Dict[str, Any]) -> Dict[str, Any]:
        if body.get("n", 1) not in (None, 1):
            raise OpenAIError(400, "n > 1 is not supported")
        return dict(temperature=body.get("temperature"),
                    top_p=body.get("top_p"),
                    top_k=body.get("top_k"))   # top_k: common extension

    @staticmethod
    def _stops(body) -> List[str]:
        stop = body.get("stop")
        if stop is None:
            return []
        return [stop] if isinstance(stop, str) else list(stop)

    def _finish(self, tokens: List[int], max_tokens: int,
                text: str, stops: List[str]) -> Tuple[str, str]:
        """Apply stop strings; returns (final_text, finish_reason)."""
        hit = _first_stop_hit(text, stops)
        if hit is not None:
            return text[:hit], "stop"
        return text, ("length" if len(tokens) >= max_tokens else "stop")

    # -- endpoints ------------------------------------------------------------
    def _models_payload(self, model_id: Optional[str] = None):
        cards = [{"id": name, "object": "model", "created": self._created,
                  "owned_by": "ray_tpu"} for name in sorted(self._engines)]
        if model_id is None:
            return {"object": "list", "data": cards}
        for c in cards:
            if c["id"] == model_id:
                return c
        raise OpenAIError(404, f"model {model_id!r} does not exist",
                          code="model_not_found")

    async def _completion_unary(self, body, chat: bool) -> Response:
        eng = self._engine(body.get("model"))
        prompt_text, prompt_ids = self._prompt_of(body, chat)
        max_tokens = int(body.get("max_tokens") or 16)
        logprobs = body.get("logprobs")
        want_logprobs = bool(logprobs)
        out = await self._generate(
            eng, prompt_ids, max_tokens=max_tokens, eos_id=self._tok.eos_id,
            logprobs=want_logprobs, **self._sampling_kwargs(body))
        toks = out["tokens"]
        text, finish = self._finish(toks, max_tokens,
                                    self._tok.decode(toks), self._stops(body))
        rid, created = f"{'chatcmpl' if chat else 'cmpl'}-" + \
            uuid.uuid4().hex[:24], int(time.time())
        usage = {"prompt_tokens": len(prompt_ids),
                 "completion_tokens": len(toks),
                 "total_tokens": len(prompt_ids) + len(toks)}
        if chat:
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": text},
                      "finish_reason": finish}
            if want_logprobs:
                choice["logprobs"] = {"content": [
                    {"token": self._tok.decode([t]), "logprob": lp}
                    for t, lp in zip(toks, out.get("logprobs", []))]}
            payload = {"id": rid, "object": "chat.completion",
                       "created": created, "model": body["model"],
                       "choices": [choice], "usage": usage}
        else:
            choice = {"index": 0, "text": text, "finish_reason": finish,
                      "logprobs": None}
            if want_logprobs:
                choice["logprobs"] = {
                    "tokens": [self._tok.decode([t]) for t in toks],
                    "token_logprobs": list(out.get("logprobs", []))}
            payload = {"id": rid, "object": "text_completion",
                       "created": created, "model": body["model"],
                       "choices": [choice], "usage": usage}
        return _json_response(payload)

    async def _completion_stream(self, body, chat: bool):
        eng = self._engine(body.get("model"))
        _text, prompt_ids = self._prompt_of(body, chat)
        max_tokens = int(body.get("max_tokens") or 16)
        stops = self._stops(body)
        holdback = _max_holdback(stops)
        rid = f"{'chatcmpl' if chat else 'cmpl'}-" + uuid.uuid4().hex[:24]
        created = int(time.time())

        def chunk(piece: Optional[str], finish: Optional[str]):
            if chat:
                delta = {} if piece is None else {"content": piece}
                return {"id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": body["model"],
                        "choices": [{"index": 0, "delta": delta,
                                     "finish_reason": finish}]}
            return {"id": rid, "object": "text_completion",
                    "created": created, "model": body["model"],
                    "choices": [{"index": 0, "text": piece or "",
                                 "finish_reason": finish}]}

        if chat:   # OpenAI streams the role in the first chunk
            first = chunk(None, None)
            first["choices"][0]["delta"] = {"role": "assistant"}
            yield first
        dec = _IncrementalDecoder(self._tok)
        pending = ""      # decoded but not yet emitted (stop holdback)
        n_toks = 0
        stopped = False
        agen = self._generate_stream(
            eng, prompt_ids, max_tokens=max_tokens, eos_id=self._tok.eos_id,
            **self._sampling_kwargs(body))
        try:
            async for tok in agen:
                n_toks += 1
                pending += dec.push(tok)
                hit = _first_stop_hit(pending, stops)
                if hit is not None:
                    if pending[:hit]:
                        yield chunk(pending[:hit], None)
                    stopped = True
                    break
                emit_upto = len(pending) - holdback
                if emit_upto > 0:
                    yield chunk(pending[:emit_upto], None)
                    pending = pending[emit_upto:]
        finally:
            # a stop-string break (or client disconnect) must close the
            # engine generator so its slot stops decoding and frees its KV
            # pages now, not at max_tokens
            await agen.aclose()
        if not stopped:
            pending += dec.flush()
            hit = _first_stop_hit(pending, stops)
            if hit is not None:
                pending, stopped = pending[:hit], True
            if pending:
                yield chunk(pending, None)
        finish = "stop" if (stopped or n_toks < max_tokens) else "length"
        yield chunk(None, finish)

    async def _embeddings(self, body) -> Response:
        """OpenAI embeddings shape (reference ingress "embeddings" route):
        input may be a string, a list of strings, or one token-id list."""
        eng = self._engine(body.get("model"))
        raw = body.get("input")
        if isinstance(raw, str):
            inputs = [raw]
        elif isinstance(raw, list) and raw and all(
                isinstance(t, int) for t in raw):
            inputs = [raw]
        elif isinstance(raw, list) and raw and all(
                isinstance(t, str) for t in raw):
            inputs = raw
        else:
            raise OpenAIError(400, "'input' must be a string, a list of "
                              "strings, or a token-id list")
        import asyncio

        id_lists = [item if isinstance(item, list)
                    else self._tok.encode(item) for item in inputs]
        for i, ids in enumerate(id_lists):
            if not ids:
                raise OpenAIError(400, f"'input' item {i} is empty")
        total = sum(len(ids) for ids in id_lists)
        if isinstance(eng, LLMServer):
            vecs = [await eng.embed(ids) for ids in id_lists]
        else:
            # remote handles: dispatch every call, then gather — batch
            # latency is bounded by engine throughput, not len(inputs)
            # serial round-trips
            loop = asyncio.get_running_loop()
            resps = [await loop.run_in_executor(
                None, lambda ids=ids: eng.embed.remote(ids))
                for ids in id_lists]
            vecs = await asyncio.gather(*resps)
        data = [{"object": "embedding", "index": i, "embedding": v}
                for i, v in enumerate(vecs)]
        return _json_response({
            "object": "list", "model": body["model"], "data": data,
            "usage": {"prompt_tokens": total, "total_tokens": total}})

    def _prompt_of(self, body, chat: bool) -> Tuple[str, List[int]]:
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise OpenAIError(400, "'messages' must be a non-empty list")
            text = self._template(messages)
            return text, self._tok.encode(text)
        prompt = body.get("prompt")
        if isinstance(prompt, list):   # OpenAI allows a batch; we serve 1
            if len(prompt) != 1:
                raise OpenAIError(400, "batched prompts are not supported; "
                                  "send one prompt per request")
            prompt = prompt[0]
        if isinstance(prompt, str):
            return prompt, self._tok.encode(prompt)
        if (isinstance(prompt, list) or isinstance(prompt, tuple)) \
                and all(isinstance(t, int) for t in prompt):
            return self._tok.decode(list(prompt)), list(prompt)
        raise OpenAIError(400, "'prompt' must be a string or token-id list")

    # -- dispatch -------------------------------------------------------------
    async def __call__(self, request: Request):
        """Generator ingress: unary answers yield ONE Response (the proxy
        writes plain HTTP); streams yield OpenAI chunk dicts (the proxy
        SSE-frames them and appends `data: [DONE]`)."""
        try:
            method, path = request.method.upper(), request.path.rstrip("/")
            if method == "GET" and path == "/v1/models":
                yield _json_response(self._models_payload())
                return
            if method == "GET" and path.startswith("/v1/models/"):
                yield _json_response(
                    self._models_payload(path[len("/v1/models/"):]))
                return
            if method != "POST":
                raise OpenAIError(405, f"{method} {path} is not supported")
            try:
                body = request.json()
            except Exception:
                raise OpenAIError(400, "request body is not valid JSON")
            if path == "/tokenize":
                # reference parity: core/ingress/ingress.py "tokenize" route
                _t, ids = self._prompt_of(body, chat=False)
                yield _json_response({"tokens": ids, "count": len(ids),
                                      "max_model_len": None})
                return
            if path == "/detokenize":
                ids = body.get("tokens")
                if not isinstance(ids, list):
                    raise OpenAIError(400, "'tokens' must be a list of ids")
                yield _json_response({"prompt": self._tok.decode(ids)})
                return
            if path == "/v1/embeddings":
                yield await self._embeddings(body)
                return
            if path in ("/v1/completions", "/v1/chat/completions"):
                chat = path.endswith("chat/completions")
                if body.get("stream"):
                    streamed = False
                    try:
                        async for item in self._completion_stream(body, chat):
                            streamed = True
                            yield item
                    except OpenAIError as e:
                        # after the first chunk the proxy has written an SSE
                        # head — the error must travel as a DICT chunk (a
                        # Response here would fail json.dumps in the proxy
                        # and mask the real error)
                        if streamed:
                            yield e.body
                        else:
                            yield _json_response(e.body, e.status)
                    except Exception as e:  # noqa: BLE001 - engine error
                        err = {"error": {"message": f"{type(e).__name__}: "
                                         f"{e}", "type": "internal_error",
                                         "code": None}}
                        if streamed:
                            yield err
                        else:
                            yield _json_response(err, 500)
                else:
                    yield await self._completion_unary(body, chat)
                return
            raise OpenAIError(404, f"no handler for {method} {path}")
        except OpenAIError as e:
            yield _json_response(e.body, e.status)
        except Exception as e:  # noqa: BLE001 - engine/user error → 500 JSON
            yield _json_response(
                {"error": {"message": f"{type(e).__name__}: {e}",
                           "type": "internal_error", "code": None}}, 500)

    def stats(self) -> Dict[str, Any]:
        out = {}
        for name, eng in self._engines.items():
            if isinstance(eng, LLMServer):
                out[name] = eng.stats()
        return out


def build_openai_app(models: Dict[str, Union[LLMConfig, Any]],
                     tokenizer=None, chat_template=None):
    """Bind an OpenAI-compatible app (reference:
    serve/core/ingress/builder.py build_openai_app). Returns a bound
    deployment for `serve.run(app, route_prefix="/")`."""
    from .deployment import deployment
    return deployment(OpenAIIngress).bind(models, tokenizer, chat_template)
