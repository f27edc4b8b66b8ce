"""Prefill/decode disaggregated serving.

Counterpart of `ray_tpu/serve/pd.py`. Decode is the orchestrator: the
decode server takes the request, asks a PREFILL server to compute the
prompt's KV and first token, installs the pages into its own paged cache
and runs every decode step itself, so that prompt-heavy and decode-heavy
load scale apart. The prefill replica is a `PrefillServer` in this process
or, as in JAX, a handle to one in another process (a serve
DeploymentHandle: each method's `.remote()` returns an awaitable). What
crosses the handle is plain data: headers and `prefill_wait` frames are
metadata, `prefill_fetch` returns bytes and `prefill_kv` CPU tensors.

Paged KV pages are the transfer unit, and the hand-off is a streaming data
plane (`serve/kv_transfer.py`), not an RPC payload:

  * prefill seals the pages it has finished into shm segments after each
    prefill chunk, and the RPC frames carry only segment metadata, so the
    decode side's pull of chunk i overlaps the prefill of chunk i+1;
  * the ship is prefix-aware at both ends: prefill reserves with the prefix
    cache and publishes each finished prompt (a hot system prompt is
    computed once per prefill replica), and the decode side reserves with
    the prefix cache FIRST, so only the pages it does not hold are shipped
    (`kv_ship_saved_pages`);
  * the decode side pulls each segment by same-host shm attach, else over
    ranged streams from the prefill replica's `KVDataServer`, else as raw
    bytes over the RPC.

On the card, prefill runs the flash forward kernel (B1) on each fresh
prompt's first chunk and decode runs the paged-decode kernel (B4) over the
installed pages. A sealed page is gathered on the device and copied once
into the segment; an installed segment is read through tensors that alias
it, copied once to the device and scattered into the pool in place.

Each streamed request is one trace (`util/tracing.py`, JAX's spans): the
decode side records its `serve.pd.queue` (slot reservation), one
`serve.pd.prefill` a wait for sealed segments, one `serve.pd.kv_ship` a
segment pulled and installed, and `serve.pd.first_decode` (activation to
the second token, polled off the tick loop); the prefill side records
`serve.pd.prefill_chunk` and `serve.pd.kv_seal` spans under the same
trace id.

RAY_TPU_KV_SHIP=0 restores the whole-KV-in-the-RPC hand-off (`prefill_kv`).
PD needs paged=True: the dense cache has no page identity to ship.
"""

import asyncio
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.serve import kv_transfer
from ray_tpu_torch.serve.llm import LLMConfig, LLMServer, _PrefillJob
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing


def _require_paged(server: LLMServer, who: str):
    if server.page_mgr is None:
        raise ValueError(f"{who} needs LLMConfig(paged=True): KV pages are "
                         "the prefill->decode transfer unit")


class _ShipJob:
    """Prefill-side state of one shipment: the segment list the decode side
    polls through prefill_wait, and the first-token result."""

    __slots__ = ("segments", "done", "token", "logprob", "error", "event", "task")

    def __init__(self):
        self.segments: List[Dict[str, Any]] = []
        self.done = False
        self.token: Optional[int] = None
        self.logprob: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.event = asyncio.Event()
        self.task: Optional[asyncio.Task] = None


class PrefillServer(LLMServer):
    """Prefill-only replica: computes a prompt's KV and first token, ships
    both, keeps nothing but its prefix cache."""

    def __init__(self, config: Optional[LLMConfig] = None, params=None):
        super().__init__(config, params)
        self._ship_writer = kv_transfer.ShipWriter()
        self._ship_jobs: Dict[str, _ShipJob] = {}
        self._kv_server: Optional[kv_transfer.KVDataServer] = None
        self._kv_loop: Optional[asyncio.AbstractEventLoop] = None

    # ---------------------------------------------------- streaming plane
    async def _ship_data_addr(self) -> Optional[str]:
        if not kv_transfer.data_server_enabled():
            return None
        loop = asyncio.get_running_loop()
        if self._kv_server is not None and self._kv_loop is not loop:
            # the listener belongs to an earlier (now closed) event loop
            self._kv_server.close()
            self._kv_server = None
        if self._kv_server is None:
            self._kv_server = kv_transfer.KVDataServer(self._ship_writer)
            await self._kv_server.start()
            self._kv_loop = loop
        return self._kv_server.addr

    async def prefill_begin(self, prompt_ids: List[int], skip_pages: int = 0,
                            trace_id: Optional[str] = None,
                            temperature: Optional[float] = None,
                            top_p: Optional[float] = None,
                            top_k: Optional[int] = None,
                            logprobs: bool = False) -> Dict[str, Any]:
        """Reserve a slot and start the chunked prefill with its per-chunk
        shipment in the background; returns the ship header at once (the
        segments follow through prefill_wait). The first `skip_pages` pages
        are never shipped: the decode side holds them in its prefix cache.
        The shipment's spans go under `trace_id`."""
        _require_paged(self, "PrefillServer")
        cfg = self.config
        prompt = list(prompt_ids)
        P = len(prompt)
        ps = cfg.page_size
        total_pages = -(-P // ps)
        skip_pages = max(0, min(int(skip_pages), total_pages - 1))
        # prefix-aware reservation: pages this replica already holds are not
        # computed again (pos starts at `cached`)
        slot_idx, cached = await self._reserve(prompt, P, use_prefix=True)
        ship_id = kv_transfer.new_ship_id()
        job = _ShipJob()
        self._ship_jobs[ship_id] = job
        _metrics.get_or_create(_metrics.Counter, "kv_ship_requests",
                               "PD requests served via the streaming KV plane").inc()
        if skip_pages:
            _metrics.get_or_create(
                _metrics.Counter, "kv_ship_saved_pages",
                "KV pages NOT shipped: decode already held them in its "
                "prefix cache").inc(skip_pages)
        job.task = asyncio.ensure_future(self._run_ship(
            ship_id, job, slot_idx, prompt, cached, skip_pages, trace_id,
            temperature, top_p, top_k, logprobs))
        L, Kh, _n, pg, D = self.cache.k_pages.shape
        return {"ship": True, "ship_id": ship_id,
                "layout": [int(L), int(Kh), int(pg), int(D)],
                "dtype": kv_transfer.dtype_name(self.cache.k_pages.dtype),
                "prompt_len": P, "page_size": ps,
                "skip_pages": skip_pages, "total_pages": total_pages,
                "prefill_cached_tokens": cached,
                "data_addr": await self._ship_data_addr()}

    async def _run_ship(self, ship_id: str, job: _ShipJob, slot_idx: int,
                        prompt: List[int], cached: int, skip_pages: int,
                        trace_id: Optional[str], temperature, top_p, top_k,
                        logprobs: bool):
        cfg = self.config
        ps = cfg.page_size
        total_pages = -(-len(prompt) // ps)
        published = skip_pages
        seg_index = 0
        try:
            pj = _PrefillJob(slot_idx=slot_idx, slot=None,
                             prompt=np.asarray(prompt, np.int32), pos=cached)
            last_logits = None
            while True:
                # seal every page the prefill has passed: the decode side's
                # pull of these overlaps the next chunk
                done_pages = total_pages if last_logits is not None else pj.pos // ps
                if done_pages > published:
                    with tracing.span("serve.pd.kv_seal", "serve", trace_id=trace_id,
                                      args={"pages": done_pages - published}):
                        seg = self._publish_pages(ship_id, seg_index, slot_idx, published,
                                                  done_pages - published)
                    job.segments.append(seg)
                    seg_index += 1
                    published = done_pages
                    job.event.set()
                if last_logits is not None:
                    break
                with tracing.span("serve.pd.prefill_chunk", "serve", trace_id=trace_id,
                                  args={"pos": pj.pos}):
                    last_logits = self._prefill_chunk(pj)
                await asyncio.sleep(0)   # let waiters and pulls interleave
            if cfg.prefix_cache:
                # the NEXT request sharing this prefix prefills its suffix only
                self.page_mgr.register_prefix(slot_idx, prompt)
            job.token, logprob = self._sample_first(last_logits, temperature, top_p,
                                                    top_k, logprobs)
            if logprobs:
                job.logprob = logprob
        except BaseException as e:  # noqa: BLE001 - surfaced by prefill_wait
            job.error = e
        finally:
            job.done = True
            self._release_slot(slot_idx)
            job.event.set()

    def _publish_pages(self, ship_id: str, seg_index: int, slot_idx: int,
                       page_start: int, n_pages: int) -> Dict[str, Any]:
        """Gather the slot's pages [page_start, page_start + n_pages) on the
        device ([L, Kh, n, ps, D] each for K and V) and seal them into one
        segment. Whole pages ship: attention masks by length, so the
        unfilled tail of the last page needs no zeroing."""
        rows = self._tensor(self.page_mgr.table_slice(slot_idx, page_start, n_pages),
                            torch.long)
        return self._ship_writer.publish(ship_id, seg_index,
                                         self.cache.k_pages[:, :, rows],
                                         self.cache.v_pages[:, :, rows], page_start)

    async def prefill_wait(self, ship_id: str, have: int = 0) -> Dict[str, Any]:
        """Wait until more than `have` segments are sealed (or the prefill
        finished); returns the new segments' metadata, never KV bytes."""
        job = self._ship_jobs.get(ship_id)
        if job is None:
            raise KeyError(f"unknown shipment {ship_id}")
        while len(job.segments) <= have and not job.done:
            job.event.clear()
            await job.event.wait()
        if job.error is not None:
            raise RuntimeError("prefill failed") from job.error
        out: Dict[str, Any] = {"segments": job.segments[have:], "done": job.done}
        if job.done:
            out["token"] = job.token
            if job.logprob is not None:
                out["logprob"] = job.logprob
        return out

    async def prefill_fetch(self, ship_id: str, oid: str) -> bytearray:
        """Raw segment bytes: the RPC fallback for a decode replica that can
        neither attach the segment nor reach the data server."""
        return self._ship_writer.read_segment(oid)

    async def prefill_drop(self, ship_id: str) -> bool:
        """Free a shipment's segments (decode installed them, or the request
        died)."""
        job = self._ship_jobs.pop(ship_id, None)
        if job is not None and job.task is not None and not job.done:
            job.task.cancel()
        self._ship_writer.drop_ship(ship_id)
        return True

    # ------------------------------------------------- legacy RPC hand-off
    async def prefill_kv(self, prompt_ids: List[int],
                         temperature: Optional[float] = None,
                         top_p: Optional[float] = None,
                         top_k: Optional[int] = None,
                         logprobs: bool = False) -> Dict[str, Any]:
        """The whole prompt KV in the reply (RAY_TPU_KV_SHIP=0, and for
        callers that want the tensors): k and v as [L, Kh, P, D] CPU
        tensors, with the prompt length and the first token."""
        _require_paged(self, "PrefillServer")
        prompt = list(prompt_ids)
        P = len(prompt)
        # plain allocation: the extraction reads raw pages; feasibility
        # (max_seq_len, pool capacity) raises in _reserve
        slot_idx, _ = await self._reserve(prompt, P, use_prefix=False)
        try:
            job = _PrefillJob(slot_idx=slot_idx, slot=None,
                              prompt=np.asarray(prompt, np.int32))
            last_logits = None
            while last_logits is None:
                last_logits = self._prefill_chunk(job)
                await asyncio.sleep(0)   # stay responsive between chunks
            first, flogp = self._sample_first(last_logits, temperature, top_p, top_k,
                                              logprobs)
            k, v = self._extract_kv(slot_idx, P)
        finally:
            self._release_slot(slot_idx)
        out = {"k": k, "v": v, "prompt_len": P, "token": first}
        if logprobs:
            out["logprob"] = flogp
        return out

    def _extract_kv(self, slot_idx: int, P: int):
        """The slot's pages as contiguous [L, Kh, P, D] CPU tensors."""
        n = -(-P // self.config.page_size)
        rows = self.cache.block_tables[slot_idx, :n].long()
        L, Kh, _p, pg, D = self.cache.k_pages.shape
        return tuple(pool[:, :, rows].reshape(L, Kh, n * pg, D)[:, :, :P].cpu()
                     for pool in (self.cache.k_pages, self.cache.v_pages))


async def _prefill_call(prefill, name: str, *a, **kw):
    """`prefill.<name>(*a, **kw)` awaited on a PrefillServer in this
    process; on anything else, a serve DeploymentHandle or an object shaped
    like one (a prefill replica in another process), `.remote()` runs in
    the loop's default executor, as it may do blocking I/O, and the
    response it returns is awaited. An error reaches the caller: nothing
    falls back to prefill in this process."""
    if isinstance(prefill, PrefillServer):
        return await getattr(prefill, name)(*a, **kw)
    loop = asyncio.get_running_loop()
    resp = await loop.run_in_executor(None, lambda: getattr(prefill, name).remote(*a, **kw))
    return await resp


class ShipSource:
    """The decode side's handle on one prefill replica's shipment API: a
    PrefillServer in this process, or a handle whose methods have
    `.remote()` (a serve DeploymentHandle). Only metadata and the
    RPC-fallback bytes cross it."""

    def __init__(self, prefill):
        self._p = prefill

    def _call(self, name: str, *a, **kw):
        return _prefill_call(self._p, name, *a, **kw)

    def begin(self, prompt, skip_pages, trace_id, temperature, top_p, top_k, logprobs):
        return self._call("prefill_begin", prompt, skip_pages=skip_pages,
                          trace_id=trace_id, temperature=temperature, top_p=top_p,
                          top_k=top_k, logprobs=logprobs)

    def wait(self, ship_id, have):
        return self._call("prefill_wait", ship_id, have)

    def fetch(self, ship_id, oid):
        return self._call("prefill_fetch", ship_id, oid)

    def drop(self, ship_id):
        return self._call("prefill_drop", ship_id)


class DecodeServer(LLMServer):
    """Decode replica that admits a request whose prompt KV was computed
    elsewhere: it installs the pages, skips prefill, and decodes with the
    inherited fused multi-token tick."""

    def __init__(self, config: Optional[LLMConfig] = None, params=None):
        super().__init__(config, params)
        self._ship_reader = kv_transfer.ShipReader()
        self._trace_polls = set()   # the first_decode polls in flight (the loop holds tasks weakly)

    def _pd_slo_tags(self) -> Dict[str, str]:
        return {"engine": self._slo_tags["engine"], "path": "pd"}

    async def _admit_with_kv(self, prompt: List[int], kv: Dict[str, Any],
                             max_tokens: int, eos_id, stream: bool,
                             temperature, top_p, top_k, logprobs,
                             t_request: Optional[float] = None):
        """Install shipped KV into a reserved slot and hand the request to
        the tick loop; returns (slot_idx, slot, finished_early). `kv` is the
        whole-KV dict of prefill_kv, or a streaming descriptor
        {"ship": True, "source": ShipSource}."""
        _require_paged(self, "DecodeServer")
        if t_request is None:
            t_request = time.monotonic()
        if kv.get("ship"):
            return await self._admit_streamed(
                prompt, kv["source"], max_tokens, eos_id, stream, temperature,
                top_p, top_k, logprobs, t_request)
        P = len(prompt)
        if kv["prompt_len"] != P:
            raise ValueError("kv prompt_len does not match prompt")
        slot_idx, _ = await self._reserve(prompt, P + max_tokens, use_prefix=False)
        try:
            self._install_kv(slot_idx, kv["k"], kv["v"], P)
        except BaseException:
            self._release_slot(slot_idx)
            raise
        first = int(kv["token"])
        logprob = float(kv["logprob"]) if logprobs and "logprob" in kv else None
        return self._finish_admit(slot_idx, P, max_tokens, eos_id, stream, temperature,
                                  top_p, top_k, logprobs, first, logprob, t_request)

    async def _admit_streamed(self, prompt: List[int], source: ShipSource,
                              max_tokens: int, eos_id, stream: bool, temperature,
                              top_p, top_k, logprobs, t_request: float):
        """Streaming admission: reserve with the prefix cache, ask prefill
        for the pages past the cached ones only, install segments as they
        are sealed."""
        P = len(prompt)
        ps = self.config.page_size
        trace_id = tracing.new_trace_id()
        t_q0 = time.time()
        # the reservation comes FIRST: its cached page count decides how many
        # leading pages prefill need not ship
        slot_idx, cached = await self._reserve(prompt, P + max_tokens, use_prefix=True)
        tracing.record_window("serve.pd.queue", "serve", trace_id, t_q0, time.time(),
                              args={"slot": slot_idx})
        skip_pages = cached // ps
        reader = self._ship_reader
        ship_id = None
        try:
            header = await source.begin(prompt, skip_pages, trace_id, temperature, top_p,
                                        top_k, logprobs)
            ship_id = header["ship_id"]
            L, Kh, pg, D = header["layout"]
            mL, mKh, _n, mpg, mD = (int(x) for x in self.cache.k_pages.shape)
            my_dtype = kv_transfer.dtype_name(self.cache.k_pages.dtype)
            if ((L, Kh, pg, D) != (mL, mKh, mpg, mD) or header["dtype"] != my_dtype
                    or header["prompt_len"] != P):
                raise ValueError(
                    f"shipment layout {header['layout']}/{header['dtype']} does not "
                    f"match this decode replica's cache [{mL},{mKh},{mpg},{mD}]/"
                    f"{my_dtype}")
            total_pages = header["total_pages"]
            data_addr = header.get("data_addr")
            have = 0
            installed = header["skip_pages"]
            res: Dict[str, Any] = {"done": False}
            while not res["done"]:
                t_w0 = time.time()
                res = await source.wait(ship_id, have)
                tracing.record_window("serve.pd.prefill", "serve", trace_id, t_w0, time.time())
                for seg in res["segments"]:
                    t_s0 = time.time()
                    att = await reader.fetch(
                        seg, (L, Kh, pg, D), header["dtype"], data_addr,
                        rpc_fetch=lambda oid: source.fetch(ship_id, oid))
                    try:
                        plen = min(P, (seg["page_start"] + seg["n_pages"]) * ps)
                        self._install_pages(slot_idx, seg["page_start"], seg["n_pages"],
                                            att.k, att.v, plen)
                    finally:
                        att.close()
                    installed = seg["page_start"] + seg["n_pages"]
                    tracing.record_window("serve.pd.kv_ship", "serve", trace_id, t_s0,
                                          time.time(), args={"pages": seg["n_pages"],
                                                             "bytes": seg["nbytes"]})
                have += len(res["segments"])
            if installed != total_pages:
                raise RuntimeError(f"shipment ended at page {installed}/{total_pages}")
        except BaseException:
            self._release_slot(slot_idx)
            if ship_id is not None:
                asyncio.ensure_future(source.drop(ship_id))
            raise
        asyncio.ensure_future(source.drop(ship_id))
        if self.config.prefix_cache:
            # the installed pages are final: publish them, so that the NEXT
            # request sharing this prefix ships only its suffix
            self.page_mgr.register_prefix(slot_idx, prompt)
        return self._finish_admit(slot_idx, P, max_tokens, eos_id, stream, temperature,
                                  top_p, top_k, logprobs, int(res["token"]),
                                  res.get("logprob"), t_request, trace_id)

    def _finish_admit(self, slot_idx: int, P: int, max_tokens: int, eos_id,
                      stream: bool, temperature, top_p, top_k, logprobs: bool,
                      first: int, logprob: Optional[float], t_request: float,
                      trace_id: Optional[str] = None):
        """The shared tail of both PD admissions: build the slot, emit the
        first token (sampled by prefill), observe PD TTFT, start decoding;
        with a trace id, record `serve.pd.first_decode` when the first
        decode tick lands the second token."""
        # prompt_ids=None: PD needs the paged cache and speculation the dense
        # one, so prompt-lookup drafting never runs here
        slot = self._make_slot(P, max_tokens, eos_id, stream, temperature, top_p,
                               top_k, logprobs, prompt_ids=None)
        slot.generated.append(first)
        if logprobs and logprob is not None:
            slot.logprobs.append(float(logprob))
        if slot.stream_queue is not None:
            slot.stream_queue.put_nowait(first)
        slot.first_token.set()
        # this path bypasses _admit, so its TTFT is observed here: the same
        # histogram, tagged path=pd
        self._m_ttft.observe(time.monotonic() - t_request, tags=self._pd_slo_tags())
        finished = max_tokens <= 1 or (eos_id is not None and first == eos_id)
        if finished:
            self._release_slot(slot_idx)
            slot.done_event.set()
            if slot.stream_queue is not None:
                slot.stream_queue.put_nowait(None)
        else:
            self._active[slot_idx] = slot
            self._ensure_tick_loop()
            if trace_id is not None and tracing.enabled():
                poll = asyncio.ensure_future(_first_decode_window(slot, trace_id, time.time()))
                self._trace_polls.add(poll)
                poll.add_done_callback(self._trace_polls.discard)
        return slot_idx, slot, finished

    async def generate_with_kv(self, prompt_ids: List[int], kv: Dict[str, Any],
                               max_tokens: int = 32, eos_id: Optional[int] = None,
                               temperature: Optional[float] = None,
                               top_p: Optional[float] = None,
                               top_k: Optional[int] = None, logprobs: bool = False,
                               t_request: Optional[float] = None) -> Dict[str, Any]:
        t0 = time.perf_counter()
        prompt = list(prompt_ids)
        _idx, slot, finished = await self._admit_with_kv(
            prompt, kv, max_tokens, eos_id, False, temperature, top_p, top_k,
            logprobs, t_request=t_request)
        ttft = time.perf_counter() - t0
        if not finished:
            await slot.done_event.wait()
            if slot.error is not None:
                raise RuntimeError("decode engine failed") from slot.error
        toks = slot.generated[:max_tokens]
        if eos_id is not None and eos_id in toks:
            toks = toks[:toks.index(eos_id)]
        out = {"tokens": toks, "ttft_s": ttft, "total_s": time.perf_counter() - t0}
        if len(toks) > 1:
            # per-token decode latency of the disaggregated path (the
            # colocated path observes it in _note_sync)
            self._m_tpot.observe((out["total_s"] - ttft) / (len(toks) - 1) * 1e3,
                                 tags=self._pd_slo_tags())
        if logprobs:
            out["logprobs"] = slot.logprobs[:len(toks)]
        return out

    def _install_kv(self, slot_idx: int, k, v, P: int) -> None:
        """Scatter [L, Kh, P, D] KV into this slot's pages, in place (an
        index_put_ into the pools: no copy of a pool)."""
        ps = self.config.page_size
        n = -(-P // ps)
        L, Kh, _p, D = k.shape
        rows = self.cache.block_tables[slot_idx, :n].long()

        def to_pages(x):
            x = torch.as_tensor(x)
            pad = x.new_zeros((L, Kh, n * ps - P, D))
            return torch.cat([x, pad], dim=2).reshape(L, Kh, n, ps, D).to(
                self.device, self.cache.k_pages.dtype)

        self.cache.k_pages[:, :, rows] = to_pages(k)
        self.cache.v_pages[:, :, rows] = to_pages(v)
        self.cache.lengths[slot_idx] = P

    def _install_pages(self, slot_idx: int, page_start: int, n_pages: int,
                       k_pages, v_pages, plen: int) -> None:
        """Scatter one segment's [L, Kh, n, ps, D] page blocks into the slot's
        pool rows [page_start, page_start + n_pages), in place. The blocks
        alias the shm segment; each is copied to the device once
        (synchronously, from pageable memory), so no alias outlives this
        call and the caller may close the segment."""
        rows = self._tensor(self.page_mgr.table_slice(slot_idx, page_start, n_pages),
                            torch.long)
        self.cache.k_pages[:, :, rows] = k_pages.to(self.device)
        self.cache.v_pages[:, :, rows] = v_pages.to(self.device)
        self.cache.lengths[slot_idx] = plen


async def _first_decode_window(slot, trace_id: str, t_act: float):
    """TTFT's tail: activation to the first decode tick landing token 2
    (token 1 was sampled on prefill). Polls the slot, off the tick loop."""
    while len(slot.generated) < 2 and not slot.done_event.is_set():
        await asyncio.sleep(0.002)
    tracing.record_window("serve.pd.first_decode", "serve", trace_id, t_act, time.time())


class PDServer(DecodeServer):
    """Decode-as-orchestrator deployment: holds the prefill replica (a
    PrefillServer in this process, or a handle to one elsewhere, such as a
    serve DeploymentHandle); every generate() streams the prompt KV from
    prefill and decodes here. With no prefill replica it serves colocated."""

    def __init__(self, config: Optional[LLMConfig] = None, params=None,
                 prefill=None):
        super().__init__(config, params)
        _require_paged(self, "PDServer")
        self._prefill = prefill
        self._ship_src: Optional[ShipSource] = None
        self.pd_requests = 0

    def _ship_source(self) -> ShipSource:
        if self._ship_src is None:
            self._ship_src = ShipSource(self._prefill)
        return self._ship_src

    def _remote_prefill(self, prompt: List[int], **kw):
        return _prefill_call(self._prefill, "prefill_kv", prompt, **kw)

    async def _pd_kv(self, prompt: List[int], **kw) -> Dict[str, Any]:
        """This request's kv argument: a streaming descriptor, or the
        whole-KV dict when RAY_TPU_KV_SHIP=0."""
        if kv_transfer.kv_ship_enabled():
            return {"ship": True, "source": self._ship_source()}
        return await self._remote_prefill(prompt, **kw)

    async def generate(self, prompt_ids: List[int], max_tokens: int = 32,
                       eos_id: Optional[int] = None,
                       temperature: Optional[float] = None,
                       top_p: Optional[float] = None,
                       top_k: Optional[int] = None,
                       logprobs: bool = False) -> Dict[str, Any]:
        if self._prefill is None:   # no prefill replica: colocated prefill
            return await super().generate(prompt_ids, max_tokens, eos_id,
                                          temperature=temperature, top_p=top_p,
                                          top_k=top_k, logprobs=logprobs)
        self.pd_requests += 1
        t_req = time.monotonic()
        kw = dict(temperature=temperature, top_p=top_p, top_k=top_k, logprobs=logprobs)
        kv = await self._pd_kv(list(prompt_ids), **kw)
        return await self.generate_with_kv(list(prompt_ids), kv, max_tokens, eos_id,
                                           t_request=t_req, **kw)

    async def generate_stream(self, prompt_ids: List[int], max_tokens: int = 32,
                              eos_id: Optional[int] = None,
                              temperature: Optional[float] = None,
                              top_p: Optional[float] = None,
                              top_k: Optional[int] = None):
        """Streaming rides the same disaggregation: prefill remotely, then
        stream the tokens of the local decode slot."""
        if self._prefill is None:
            async for tok in super().generate_stream(
                    prompt_ids, max_tokens, eos_id, temperature=temperature,
                    top_p=top_p, top_k=top_k):
                yield tok
            return
        self.pd_requests += 1
        t_req = time.monotonic()
        kw = dict(temperature=temperature, top_p=top_p, top_k=top_k)
        kv = await self._pd_kv(list(prompt_ids), logprobs=False, **kw)
        _idx, slot, _fin = await self._admit_with_kv(
            list(prompt_ids), kv, max_tokens, eos_id, True, temperature, top_p,
            top_k, False, t_request=t_req)
        emitted = 0
        while emitted < max_tokens:
            tok = await slot.stream_queue.get()
            if tok is None or (eos_id is not None and tok == eos_id):
                break
            emitted += 1
            yield tok
        if slot.error is not None:
            raise RuntimeError("decode engine failed") from slot.error

    def stats(self) -> Dict[str, Any]:
        s = super().stats()
        s["pd_requests"] = self.pd_requests
        s["kv_ship"] = _metrics.kv_ship_counters()
        return s
