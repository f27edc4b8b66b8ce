"""LLM serving replica: continuous batching over the port's Llama.

Counterpart of `ray_tpu/serve/llm.py`. B decode slots over a static-shape
KV cache (dense [B, Smax] rows or a paged pool with block tables).
Requests are admitted into free slots, their prompts are fed through the
model in chunks (power-of-two buckets), and each engine tick advances every
active slot by one fused decode chunk.

The fused decode chunk keeps the inner loop on the device: up to
`decode_chunk` [B, 1] steps run back to back (the JAX package's lax.scan is
a Python loop here) with sampling, per-slot EOS / max-token / max-seq-len
termination masking and logprob capture all on device tensors, and ONE
host sync per chunk, when the chunk's tokens are copied back. The loop
adapts: chunk 1 while prefill jobs are queued, `decode_chunk` in steady
state.

On CUDA the paged path runs the hand-written kernels: paged decode (B4) on
every decode step of every layer, flash forward (B1) on the first prefill
chunk of every fresh prompt and in `embed`.

Also as in the JAX engine: MoE presets serve dropless (capacity_factor
raised to E/K, so a token's experts never depend on its co-batched
traffic); prompt-lookup speculation on the dense cache (`speculate > 0`:
the continuation of the newest n-gram match in the request's own context
is verified in one [B, K+1] forward, exact for greedy requests); the SLO
histograms (TTFT, TPOT, batch occupancy, KV page use) in the port's
metrics registry, with `slo_snapshot` for windowed reads; `embed` (mean-
pooled final hidden states); and `prefix_digest` for an affinity router.
Later slices bring tensor parallelism (`tp > 1`) and KV stash demotion of
evicted prefix pages.
"""

import asyncio
import collections
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.convert import init_params
from ray_tpu_torch.models.llama import KVCache, Llama, LlamaConfig
from ray_tpu_torch.ops.paged_attention import PagedKVCache
from ray_tpu_torch.serve import radix_cache as _radix
from ray_tpu_torch.util import metrics as _metrics


@dataclasses.dataclass
class LLMConfig:
    preset: str = "tiny"            # LlamaConfig preset name
    max_batch_slots: int = 8        # concurrent decode slots (B)
    max_seq_len: int = 512          # Smax (prompt + generation)
    temperature: float = 0.0        # 0 -> greedy (per-request overridable)
    top_k: int = 0                  # 0 -> full softmax (per-request overridable)
    top_p: float = 1.0              # nucleus cutoff (per-request overridable)
    param_dtype: str = "bfloat16"
    dtype: Optional[str] = None     # activation dtype override (None = preset)
    seed: int = 0
    # paged KV cache (ops/paged_attention: B4 kernel over a block table).
    # Device memory for KV = num_pages * page_size instead of
    # B * max_seq_len; admission reserves prompt + max_tokens pages.
    paged: bool = False
    page_size: int = 64
    num_pages: Optional[int] = None  # default: full (B * ceil(Smax/page)) + 1
    # chunked prefill: prompts are fed `prefill_chunk` tokens per engine
    # tick, interleaved with decode chunks
    prefill_chunk: int = 128
    # fused multi-token decode: up to this many steps per host sync
    decode_chunk: int = 8
    # prefix caching (paged mode only): full prompt pages are
    # content-addressed and shared across requests with refcounts
    prefix_cache: bool = True
    # prompt-lookup speculation (dense cache only): K draft tokens per tick
    # from the newest earlier match of the context's last n-gram
    speculate: int = 0
    spec_ngram: int = 3
    tp: int = 1                     # tensor parallel degree (later slice)
    # extra LlamaConfig kwargs applied over the preset
    model_overrides: Optional[Dict[str, Any]] = None
    device: str = "cuda"            # "cpu" runs the plain PyTorch path


@dataclasses.dataclass
class _Slot:
    request_id: int
    prompt_len: int
    max_tokens: int
    generated: List[int]
    done_event: asyncio.Event
    stream_queue: Optional[asyncio.Queue] = None
    eos_id: Optional[int] = None
    error: Optional[BaseException] = None
    # per-request sampling params (None -> server config default)
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    want_logprobs: bool = False
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # the prompt, kept for prompt-lookup drafting (speculate > 0 only)
    prompt_ids: List[int] = dataclasses.field(default_factory=list)
    # incremental prompt-lookup state: ctx mirrors prompt + generated, and
    # spec_index maps each n-gram WITH a known continuation to that
    # continuation's start (O(1) draft lookup per tick)
    ctx: List[int] = dataclasses.field(default_factory=list)
    spec_index: Dict = dataclasses.field(default_factory=dict)
    # set when the first token exists (prefill complete); TTFT boundary
    first_token: asyncio.Event = dataclasses.field(default_factory=asyncio.Event)


@dataclasses.dataclass
class _PrefillJob:
    """A prompt being fed through the model chunk-by-chunk by the engine."""
    slot_idx: int
    slot: _Slot
    prompt: "np.ndarray"
    pos: int = 0


def _kv_demotion_requested() -> bool:
    """The JAX engine demotes radix-evicted pages into the object store by
    default (RAY_TPU_SPILL_KV); this port discards them unless asked."""
    return os.environ.get("RAY_TPU_SPILL_KV", "0") != "0"


class LLMServer:
    """`generate(prompt_ids, max_tokens)` -> token ids, on one device.

    `params` is a state_dict of the port's Llama (for example
    `models.convert.flax_to_state_dict(jax_params)`); None initializes
    seeded random weights on the device."""

    def __init__(self, config: Optional[LLMConfig] = None, params=None):
        self.config = cfg = config or LLMConfig()
        self.device = resolve_device(cfg.device)
        if cfg.tp > 1:
            raise NotImplementedError(
                "tp > 1 (tensor-parallel serving on torch.distributed): later slice")
        if cfg.speculate > 0 and cfg.paged:
            # checked before the weights and the page pool are allocated
            raise ValueError(
                "speculate requires paged=False: the paged decode kernel "
                "is single-position; the dense cache path verifies [B, K+1] "
                "windows natively (set paged=False or speculate=0)")
        preset = getattr(LlamaConfig, cfg.preset)
        overrides = dict(max_seq_len=cfg.max_seq_len,
                         param_dtype=getattr(torch, cfg.param_dtype))
        if cfg.dtype is not None:
            overrides["dtype"] = getattr(torch, cfg.dtype)
        if cfg.model_overrides:
            overrides.update(cfg.model_overrides)
        self.model_cfg = preset(**overrides)
        if self.model_cfg.n_experts > 0:
            # Serving is DROPLESS: with a training capacity_factor a token's
            # expert output could be zeroed by which OTHER requests share the
            # batch. cf = E/K makes C = ceil(cf K S / E) = S.
            dropless = self.model_cfg.n_experts / self.model_cfg.moe_top_k
            if self.model_cfg.capacity_factor < dropless:
                self.model_cfg = dataclasses.replace(self.model_cfg,
                                                     capacity_factor=dropless)
        if cfg.paged and cfg.prefix_cache and _kv_demotion_requested():
            raise NotImplementedError(
                "KV stash demotion of evicted prefix pages needs the object "
                "store: later slice (unset RAY_TPU_SPILL_KV)")
        B = cfg.max_batch_slots
        self.model = Llama(self.model_cfg, device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            init_params(self.model, gen)
        else:
            self.model.load_state_dict(params)
        self.model.requires_grad_(False)
        self.model.eval()

        if cfg.paged:
            mc = self.model_cfg
            max_pages = -(-cfg.max_seq_len // cfg.page_size)
            num_pages = cfg.num_pages or (B * max_pages + 1)
            self.page_mgr = _radix.make_page_manager(
                num_pages, cfg.page_size, B, max_pages,
                prefix_cache=cfg.prefix_cache)
            self.cache = PagedKVCache.init(
                mc.n_layers, mc.n_kv_heads, mc.head_dim, num_pages,
                cfg.page_size, B, max_pages, dtype=mc.dtype, device=self.device)
        else:
            self.page_mgr = None
            self.cache = KVCache.init(self.model_cfg, B, cfg.max_seq_len,
                                      device=self.device)
        self._active: Dict[int, _Slot] = {}   # slot idx -> request state
        self._spec_stats = {"spec_ticks": 0, "decode_ticks": 0,
                            "drafted": 0, "accepted": 0}
        # decode-chunk accounting: ONE host sync per chunk is the whole perf
        # story, so it is a recorded metric, not an inference
        self._decode_stats = {"host_syncs": 0, "tokens": 0,
                              "chunk_s_total": 0.0, "chunk_sizes": {}}
        # prefill accounting: chunks run, and how many were a fresh row's
        # chunk-local first chunk (the flash-kernel path on CUDA)
        self._prefill_stats = {"chunks": 0, "chunk_local": 0}
        self._m_syncs = _metrics.get_or_create(
            _metrics.Counter, "serve_decode_host_syncs",
            "decode engine host syncs (one per decode chunk / spec tick)")
        self._m_tokens = _metrics.get_or_create(
            _metrics.Counter, "serve_decode_tokens",
            "tokens emitted by the decode engine")
        self._m_chunk_ms = _metrics.get_or_create(
            _metrics.Histogram, "serve_decode_chunk_latency_ms",
            "wall latency of one fused decode chunk (ms)",
            boundaries=[1, 2, 5, 10, 20, 50, 100, 200, 500, 1000])
        # serving SLO histograms, tagged by engine flavor (paged and dense
        # replicas in one process keep separate series) and request path
        # (`local`: prefill and decode on this replica)
        self._slo_tags = {"engine": "paged" if cfg.paged else "dense",
                          "path": "local"}
        self._m_ttft = _metrics.get_or_create(
            _metrics.Histogram, "serve_ttft_s",
            "time to first token: admit -> first emitted token (s)",
            boundaries=[0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10],
            tag_keys=("engine", "path"))
        self._m_tpot = _metrics.get_or_create(
            _metrics.Histogram, "serve_tpot_ms",
            "per-token decode latency: host-sync wall time / tokens (ms)",
            boundaries=[0.5, 1, 2, 5, 10, 20, 50, 100, 200],
            tag_keys=("engine", "path"))
        self._m_occupancy = _metrics.get_or_create(
            _metrics.Histogram, "serve_batch_occupancy",
            "active slots / batch capacity, sampled per decode sync",
            boundaries=[0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0],
            tag_keys=("engine",))
        self._m_kv_util = _metrics.get_or_create(
            _metrics.Histogram, "serve_kv_page_util",
            "KV pages in use / page pool size, sampled per decode sync",
            boundaries=[0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0],
            tag_keys=("engine",))
        # windowed SLO reads: each slo_snapshot() call summarizes only the
        # observations since the previous call
        self._slo_window_state = {}
        self._free = list(range(B))
        self._req_counter = 0
        self._tick_task = None
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._prefill_q: "collections.deque[_PrefillJob]" = collections.deque()
        # signaled whenever capacity frees (slot or pages)
        self._capacity_event = asyncio.Event()

    # -- device programs ----------------------------------------------------
    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def _sample(self, logits, temps, top_ps, top_ks, hot: bool, want_logp: bool):
        """Per-request greedy / temperature / top-k / top-p next-token
        choice on device tensors. `hot` (host-known: any slot has
        temperature > 0) enables the sort/cumsum nucleus machinery, so an
        all-greedy batch pays one argmax. Returns (next_token [B] int32,
        logprob-or-zeros [B] f32)."""
        logits = logits.to(torch.float32)
        greedy = logits.argmax(dim=-1)
        if hot:
            V = logits.shape[-1]
            scaled = logits / temps.clamp_min(1e-6)[:, None]
            sorted_desc = scaled.sort(dim=-1, descending=True).values
            # top-k cutoff: value of the k-th largest (k == 0 keeps all; a
            # k past the vocabulary keeps all rather than indexing past it)
            k = torch.where(top_ks > 0, top_ks, V).clamp(max=V).long()
            kth = sorted_desc.gather(-1, (k - 1)[:, None])
            keep = scaled >= kth
            # top-p: smallest leading set of the sorted probs with mass
            # >= top_p; position j survives iff cum[j-1] < top_p
            probs = torch.softmax(sorted_desc, dim=-1)
            cum = probs.cumsum(dim=-1)
            kept = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                              cum[:, :-1] < top_ps[:, None]], dim=-1)
            n_keep = kept.sum(dim=-1)
            pth = sorted_desc.gather(-1, (n_keep - 1)[:, None])
            masked = torch.where(keep & (scaled >= pth), scaled, float("-inf"))
            # Gumbel-max draw from the device generator
            u = torch.rand(masked.shape, generator=self._gen, device=self.device)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            sampled = (masked - torch.log(-torch.log(u))).argmax(dim=-1)
            nxt = torch.where(temps > 0, sampled, greedy)
        else:
            nxt = greedy
        nxt = nxt.to(torch.int32)
        if want_logp:
            logp = torch.log_softmax(logits, dim=-1).gather(
                -1, nxt[:, None].long())[:, 0]
        else:
            logp = torch.zeros(nxt.shape, dtype=torch.float32, device=self.device)
        return nxt, logp

    @torch.no_grad()
    def _prefill_paged(self, tokens, slot: int, start: int, true_end: int,
                       chunk_local: bool):
        """Paged prefill of ONE CHUNK: the row's table was set at admission;
        tokens [start, true_end) run through the model, which writes the
        row's pages in place. `chunk_local` marks a fresh row's FIRST chunk.
        The returned logits row is only meaningful on the final chunk."""
        row_view = self.cache.replace(
            block_tables=self.cache.block_tables[slot:slot + 1],
            lengths=self._tensor([start], torch.int32))
        logits, _ = self.model(tokens, cache=row_view, paged_chunk_local=chunk_local)
        self.cache.lengths[slot] = true_end
        return logits[0, true_end - start - 1]

    @torch.no_grad()
    def _prefill_row(self, tokens, slot: int, start: int, true_end: int):
        """Write one CHUNK of a (padded) prompt's KV into `slot`'s dense row;
        tokens: [1, C] padded to a bucket, covering prompt positions
        [start, true_end)."""
        row_cache = KVCache(
            k=tuple(c[slot:slot + 1] for c in self.cache.k),
            v=tuple(c[slot:slot + 1] for c in self.cache.v),
            length=self._tensor([start], torch.int32))
        logits, _ = self.model(tokens, cache=row_cache)
        self.cache.length[slot] = true_end
        return logits[0, true_end - start - 1]

    @torch.no_grad()
    def _decode_chunk(self, last, active, temps, top_ps, top_ks, eos_ids,
                      budgets, rooms, hot: bool, want_logp: bool, n: int):
        """`n` decode steps on the device with no host sync: the same
        [B, 1] forward + _sample() per step, with per-slot termination
        folded in. A slot stops the step it hits its EOS id, its token
        budget, or its cache row's capacity; stopped slots stay frozen
        (length and last token pinned) while the rest continue.

        Returns (tokens [B, n], n_valid [B], logps [B, n]) on the device:
        tokens[i, j] is valid iff j < n_valid[i]. Steps after a slot stops
        still write one KV entry at its frozen length (masked on read,
        overwritten on slot reuse)."""
        paged = self.config.paged
        cache = self.cache
        emitted = torch.zeros_like(last)
        toks, logps = [], []
        for _ in range(n):
            logits, new_cache = self.model(last[:, None], cache=cache)
            nxt, logp = self._sample(logits[:, -1, :], temps, top_ps, top_ks,
                                     hot, want_logp)
            emitted = emitted + active.to(torch.int32)
            done = (nxt == eos_ids) | (emitted >= budgets) | (emitted >= rooms)
            still = active & ~done
            # slots not active THIS step must not advance their row
            if paged:
                new_cache = new_cache.replace(lengths=torch.where(
                    active, new_cache.lengths, cache.lengths))
            else:
                new_cache = KVCache(
                    k=new_cache.k, v=new_cache.v,
                    length=torch.where(active, new_cache.length, cache.length))
            last = torch.where(still, nxt, last)
            active = still
            cache = new_cache
            toks.append(nxt)
            logps.append(logp)
        self.cache = cache
        return torch.stack(toks, dim=1), emitted, torch.stack(logps, dim=1)

    @torch.no_grad()
    def _spec_step(self, tokens, active, temps, top_ps, top_ks, hot: bool,
                   want_logp: bool):
        """Verify K drafts and emit a bonus token in ONE [B, K+1] forward.

        tokens[:, 0] is each slot's last emitted token (its KV is written at
        the row's length, as in a decode step); tokens[:, 1:] are the
        drafts. Draft j+1 is accepted iff it equals the argmax of position
        j, so every accepted token is the one step-by-step greedy decode
        would give. n_emit = accepted run + 1 for greedy slots; sampled
        slots take position 0 through `_sample` and advance by one. KV
        written for rejected positions sits past the new length: masked on
        read and overwritten by the next tick's write. Returns (emit
        [B, K+1], n_emit [B], logps [B, K+1]) on the device."""
        cache = self.cache
        logits, new_cache = self.model(tokens, cache=cache)
        logits = logits.to(torch.float32)
        nxt0, logp0 = self._sample(logits[:, 0, :], temps, top_ps, top_ks, hot,
                                   want_logp)
        tgt = logits.argmax(dim=-1).to(torch.int32)              # [B, K+1]
        greedy = temps <= 0.0
        match = tokens[:, 1:] == tgt[:, :-1]                      # [B, K]
        n_acc = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
        n_emit = torch.where(greedy & active, n_acc + 1, torch.ones_like(n_acc))
        emit = tgt.clone()
        emit[:, 0] = torch.where(greedy, tgt[:, 0], nxt0)
        if want_logp:
            lp = torch.log_softmax(logits, dim=-1).gather(
                -1, emit[:, :, None].long())[..., 0]
            lp[:, 0] = torch.where(greedy, lp[:, 0], logp0)
        else:
            lp = torch.zeros(emit.shape, dtype=torch.float32, device=self.device)
        length = torch.where(active, cache.length + n_emit, cache.length)
        self.cache = KVCache(k=new_cache.k, v=new_cache.v,
                             length=length.to(torch.int32))
        return emit, n_emit.to(torch.int32), lp

    def _chunk_len(self) -> int:
        """Adaptive decode-chunk length for THIS tick. Chunk 1 while any
        prompt is still prefilling (a queued request must not wait N device
        steps for its next chunk); otherwise min(decode_chunk, most
        remaining tokens over active slots), bucketed DOWN to a power of
        two, same idiom as the prefill buckets."""
        cfg = self.config
        if cfg.decode_chunk <= 1 or self._prefill_q or cfg.speculate > 0:
            return 1
        rem = 1
        for slot in self._active.values():
            rem = max(rem, min(
                slot.max_tokens - len(slot.generated),
                cfg.max_seq_len - (slot.prompt_len + len(slot.generated))))
        n = min(cfg.decode_chunk, rem)
        return 1 << (max(n, 1).bit_length() - 1)

    def _note_sync(self, tokens: int, dt_s: float, chunk: Optional[int] = None):
        """Record one host sync of the decode engine (a fused chunk or a
        speculative verify tick) in stats() and the SLO histograms."""
        st = self._decode_stats
        st["host_syncs"] += 1
        st["tokens"] += tokens
        st["chunk_s_total"] += dt_s
        if chunk is not None:
            st["chunk_sizes"][chunk] = st["chunk_sizes"].get(chunk, 0) + 1
        self._m_syncs.inc()
        if tokens:
            self._m_tokens.inc(tokens)
            self._m_tpot.observe(dt_s / tokens * 1e3, tags=self._slo_tags)
        self._m_chunk_ms.observe(dt_s * 1e3)
        eng_tags = {"engine": self._slo_tags["engine"]}
        cap = len(self._active) + len(self._free)
        if cap:
            self._m_occupancy.observe(len(self._active) / cap, tags=eng_tags)
        if self.page_mgr is not None and self.page_mgr.num_pages:
            self._m_kv_util.observe(
                self.page_mgr.pages_in_use / self.page_mgr.num_pages, tags=eng_tags)

    def reconfigure(self, user_config: Optional[Dict[str, Any]]):
        """Serve `user_config` hook: adjust engine knobs that need neither a
        param reload nor a cache rebuild (`decode_chunk`)."""
        if not user_config:
            return
        if "decode_chunk" in user_config:
            n = int(user_config["decode_chunk"])
            if n < 1:
                raise ValueError(f"decode_chunk must be >= 1, got {n}")
            self.config.decode_chunk = n

    def _bucket(self, n: int) -> int:
        """Pad prompt lengths to power-of-two buckets, clamped to the cache
        row size."""
        b = 16
        while b < n:
            b *= 2
        return min(b, self.config.max_seq_len)

    # -- request admission ---------------------------------------------------
    def _make_slot(self, prompt_len: int, max_tokens: int,
                   eos_id: Optional[int], stream: bool, temperature,
                   top_p, top_k, logprobs: bool,
                   prompt_ids: Optional[List[int]] = None) -> _Slot:
        cfg = self.config
        return _Slot(request_id=self._req_counter, prompt_len=prompt_len,
                     max_tokens=max_tokens, generated=[],
                     done_event=asyncio.Event(),
                     stream_queue=asyncio.Queue() if stream else None,
                     eos_id=eos_id,
                     temperature=(cfg.temperature if temperature is None
                                  else temperature),
                     top_p=cfg.top_p if top_p is None else top_p,
                     top_k=cfg.top_k if top_k is None else top_k,
                     want_logprobs=logprobs, prompt_ids=prompt_ids or [])

    async def _admit(self, prompt_ids: List[int], max_tokens: int,
                     eos_id: Optional[int], stream: bool,
                     temperature: Optional[float] = None,
                     top_p: Optional[float] = None,
                     top_k: Optional[int] = None,
                     logprobs: bool = False) -> _Slot:
        P = len(prompt_ids)
        t_admit = time.monotonic()
        # feasibility (max_seq_len, page-pool capacity) raises in _reserve
        slot_idx, cached = await self._reserve(prompt_ids, P + max_tokens)
        # the prompt is kept only for prompt-lookup drafting
        slot = self._make_slot(P, max_tokens, eos_id, stream, temperature,
                               top_p, top_k, logprobs,
                               prompt_ids=(list(prompt_ids)
                                           if self.config.speculate > 0 else None))
        # the engine feeds the prompt through in chunks, interleaved with
        # decode ticks; a cached prefix starts the job past the shared pages
        self._prefill_q.append(_PrefillJob(
            slot_idx=slot_idx, slot=slot,
            prompt=np.asarray(list(prompt_ids), np.int32), pos=cached))
        self._ensure_tick_loop()
        await slot.first_token.wait()
        if slot.error is not None:
            raise RuntimeError("prefill failed") from slot.error
        # TTFT = admission (queueing for a slot or pages included) -> first
        # token; generate and generate_stream both come through here
        self._m_ttft.observe(time.monotonic() - t_admit, tags=self._slo_tags)
        return slot

    async def _reserve(self, prompt_ids, total_len: int, use_prefix: bool = True):
        """Wait for a free slot AND enough free pages (reserve the full
        request up front, so decode never runs out of pages), then
        allocate. Returns (slot_idx, cached_prefix_tokens)."""
        if total_len > self.config.max_seq_len:
            raise ValueError(
                f"request needs {total_len} tokens but max_seq_len is "
                f"{self.config.max_seq_len}")
        mgr = self.page_mgr
        if mgr is not None:
            need = -(-total_len // mgr.page_size)
            if need > min(mgr.num_pages - 1, mgr.max_pages_per_seq):
                raise ValueError(
                    f"request needs {need} KV pages but the pool can never "
                    f"hold more than "
                    f"{min(mgr.num_pages - 1, mgr.max_pages_per_seq)} "
                    f"per sequence (num_pages={mgr.num_pages}, "
                    f"page_size={mgr.page_size})")

        def fits():
            if mgr is None:
                return True
            if use_prefix and self.config.prefix_cache:
                return mgr.can_fit_prompt(list(prompt_ids), total_len)
            return mgr.can_fit(total_len)

        while not self._free or not fits():
            self._capacity_event.clear()
            await self._capacity_event.wait()
        slot_idx = self._free.pop()
        self._req_counter += 1
        cached = 0
        try:
            if mgr is not None:
                if use_prefix and self.config.prefix_cache:
                    row, cached = mgr.allocate_prefix(
                        slot_idx, list(prompt_ids), total_len)
                else:
                    row = mgr.allocate(slot_idx, total_len)
                # lengths[slot] must point PAST the shared prefix before the
                # next decode tick: every row is written at its length each
                # tick, and a 0 here would land garbage KV at position 0 of
                # a SHARED page. At `cached` the stray write hits the first
                # FRESH page and prefill chunk 1 overwrites it.
                self.cache.block_tables[slot_idx] = self._tensor(row, torch.int32)
                self.cache.lengths[slot_idx] = cached
        except BaseException:
            self._release_slot(slot_idx)
            raise
        return slot_idx, cached

    def _prefill_chunk(self, job: _PrefillJob):
        """Run ONE chunk of `job`'s prompt; returns final-chunk logits or
        None. Chunk shapes come from a fixed bucket set."""
        cfg = self.config
        P = len(job.prompt)
        start = job.pos
        n = min(cfg.prefill_chunk, P - start)
        final = start + n >= P
        # clamp the padded bucket to the row capacity
        bucket = (min(self._bucket(n), cfg.max_seq_len - start)
                  if final else cfg.prefill_chunk)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = job.prompt[start:start + n]
        tokens = self._tensor(padded)
        self._prefill_stats["chunks"] += 1
        if cfg.paged:
            # start == 0: a fresh row's first chunk, exact with chunk-local
            # attention (the flash kernel on CUDA, no page gather)
            chunk_local = start == 0
            self._prefill_stats["chunk_local"] += int(chunk_local)
            last_logits = self._prefill_paged(tokens, job.slot_idx, start,
                                              start + n, chunk_local)
        else:
            last_logits = self._prefill_row(tokens, job.slot_idx, start, start + n)
        job.pos += n
        return last_logits if final else None

    @staticmethod
    def _lookup_draft(ctx: List[int], k: int, n: int) -> List[int]:
        """Prompt-lookup draft: the continuation of the MOST RECENT earlier
        occurrence of the context's final n-gram ([] when none). The
        reference for the engine's incremental per-slot index, which has
        the same most-recent-match semantics at O(1) per tick."""
        L = len(ctx)
        if L <= n:
            return []
        tail = ctx[-n:]
        for i in range(L - n - 1, -1, -1):
            if ctx[i:i + n] == tail:
                return ctx[i + n:i + n + k]
        return []

    def _spec_drafts(self) -> Optional[Dict[int, List[int]]]:
        """{slot: draft} when THIS tick runs the speculative step, None for
        a plain decode tick. The verify forward writes K+1 entries on every
        row, mid-prefill rows included, and the dense write clamps its
        start to fit (a clamped write would overwrite valid KV), so every
        such row needs K+1 free positions; and at least one greedy slot
        needs a real n-gram hit, else the (K+1)-position forward buys
        nothing."""
        cfg = self.config
        K = cfg.speculate
        n = cfg.spec_ngram
        if K <= 0 or not self._active:
            return None
        for job in self._prefill_q:
            # a prefilling row's committed length is job.pos
            if job.pos + K + 1 > cfg.max_seq_len:
                return None
        drafts: Dict[int, List[int]] = {}
        for i, slot in self._active.items():
            if slot.prompt_len + len(slot.generated) + K + 1 > cfg.max_seq_len:
                return None
            if slot.temperature > 0:
                continue
            ctx = slot.ctx
            if len(ctx) != slot.prompt_len + len(slot.generated):
                # first spec tick for this slot (or an append outside
                # _emit_one, such as the first token): rebuild the index
                ctx = slot.ctx = slot.prompt_ids + slot.generated
                slot.spec_index = {
                    tuple(ctx[e - n:e]): e for e in range(n, len(ctx))}
            pos = slot.spec_index.get(tuple(ctx[-n:]))
            if pos is not None:
                drafts[i] = ctx[pos:pos + K]
        return drafts or None

    def _ensure_tick_loop(self):
        if self._tick_task is None or self._tick_task.done():
            self._tick_task = asyncio.get_running_loop().create_task(
                self._tick_loop())

    def _fail(self, slot: _Slot, error: BaseException):
        slot.error = error
        slot.first_token.set()
        slot.done_event.set()
        if slot.stream_queue is not None:
            slot.stream_queue.put_nowait(None)

    async def _tick_loop(self):
        try:
            await self._tick_loop_inner()
        except BaseException as e:  # noqa: BLE001 - fail every waiter loudly
            for job in list(self._prefill_q):
                self._fail(job.slot, e)
                self._release_slot(job.slot_idx)
            self._prefill_q.clear()
            for i, slot in list(self._active.items()):
                self._fail(slot, e)
                self._release_slot(i)
            self._active.clear()
            raise

    def _release_slot(self, i: int):
        """Return slot i to the pool; paged mode also frees its pages and
        zeroes its table row so inactive-slot decode writes land on the
        reserved placeholder page, never on another request's pages."""
        if self.page_mgr is not None:
            self.page_mgr.free(i)
            self.cache.block_tables[i] = 0
            self.cache.lengths[i] = 0
        self._free.append(i)
        self._capacity_event.set()  # wake admission waiters

    def _sampling_arrays(self):
        """Per-slot host arrays of this tick: (active mask, temperatures,
        top_p, top_k), with inactive slots greedy."""
        B = self.config.max_batch_slots
        mask = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        for i, slot in self._active.items():
            mask[i] = True
            temps[i] = slot.temperature
            top_ps[i] = slot.top_p
            top_ks[i] = slot.top_k
        return mask, temps, top_ps, top_ks

    def _emit_synced(self, toks, counts, logp):
        """The tick's ONE host sync: tokens [B, W], counts [B] and logprob
        bits [B, W] travel in a single int32 copy; then each active slot
        takes its first counts[i] tokens. Returns (finished slots, tokens
        emitted, counts as numpy)."""
        B, W = toks.shape
        packed = torch.cat([toks.reshape(-1), counts,
                            logp.reshape(-1).view(torch.int32)]).cpu().numpy()
        toks = packed[:B * W].reshape(B, W)
        counts = packed[B * W:B * W + B]
        logp = packed[B * W + B:].view(np.float32).reshape(B, W)
        finished = []
        emitted = 0
        for i, slot in self._active.items():
            for j in range(int(counts[i])):
                emitted += 1
                if self._emit_one(slot, int(toks[i, j]), float(logp[i, j])):
                    finished.append(i)
                    break
        return finished, emitted, counts

    def _spec_tick(self, drafts: Dict[int, List[int]]) -> List[int]:
        """One speculative verify tick for every active slot; returns the
        slots that finished."""
        cfg = self.config
        mask, temps, top_ps, top_ks = self._sampling_arrays()
        toks = np.zeros((cfg.max_batch_slots, cfg.speculate + 1), np.int32)
        for i, slot in self._active.items():
            toks[i, 0] = slot.generated[-1]
            d = drafts.get(i, [])
            toks[i, 1:1 + len(d)] = d
        any_logp = any(s.want_logprobs for s in self._active.values())
        t0 = time.perf_counter()
        emit, n_emit, logp = self._spec_step(
            self._tensor(toks), self._tensor(mask), self._tensor(temps),
            self._tensor(top_ps), self._tensor(top_ks), bool((temps > 0).any()),
            any_logp)
        finished, emitted, n_emit = self._emit_synced(emit, n_emit, logp)
        st = self._spec_stats
        st["spec_ticks"] += 1
        st["drafted"] += sum(len(d) for d in drafts.values())
        # a short draft's zero padding can match the argmax by chance (still
        # exact output) but is no acceptance
        st["accepted"] += sum(min(int(n_emit[i]) - 1, len(d)) for i, d in drafts.items())
        self._note_sync(emitted, time.perf_counter() - t0)
        return finished

    def _decode_tick(self) -> List[int]:
        """One fused decode chunk for every active slot; returns the slots
        that finished."""
        cfg = self.config
        B = cfg.max_batch_slots
        n = self._chunk_len()
        mask, temps, top_ps, top_ks = self._sampling_arrays()
        last = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)   # -1 never matches
        budget = np.zeros((B,), np.int32)
        room = np.zeros((B,), np.int32)
        for i, slot in self._active.items():
            last[i] = slot.generated[-1]
            if slot.eos_id is not None:
                eos[i] = slot.eos_id
            budget[i] = slot.max_tokens - len(slot.generated)
            room[i] = cfg.max_seq_len - (slot.prompt_len + len(slot.generated))
        any_logp = any(s.want_logprobs for s in self._active.values())
        t0 = time.perf_counter()
        toks, n_valid, logp = self._decode_chunk(
            self._tensor(last), self._tensor(mask), self._tensor(temps),
            self._tensor(top_ps), self._tensor(top_ks), self._tensor(eos),
            self._tensor(budget), self._tensor(room),
            bool((temps > 0).any()), any_logp, n)
        finished, emitted, _ = self._emit_synced(toks, n_valid, logp)
        self._spec_stats["decode_ticks"] += 1
        self._note_sync(emitted, time.perf_counter() - t0, chunk=n)
        return finished

    def _emit_one(self, slot: _Slot, tok: int, lp: float) -> bool:
        """Append one token to `slot`; True when the slot is done."""
        slot.generated.append(tok)
        if slot.ctx:   # incremental prompt-lookup index
            ctx = slot.ctx
            ctx.append(tok)
            L, n = len(ctx), self.config.spec_ngram
            if L > n:
                # the n-gram ending at L-2 gained a continuation (L-1)
                slot.spec_index[tuple(ctx[L - 1 - n:L - 1])] = L - 1
        if slot.want_logprobs:
            slot.logprobs.append(lp)
        if slot.stream_queue is not None:
            slot.stream_queue.put_nowait(tok)
        hit_eos = slot.eos_id is not None and tok == slot.eos_id
        total = slot.prompt_len + len(slot.generated)
        return (len(slot.generated) >= slot.max_tokens or hit_eos
                or total >= self.config.max_seq_len)

    def _start_decoding(self, job: _PrefillJob, last_logits):
        """The prompt is fully prefilled: publish its pages, sample its
        first token through the same policy as later ones, activate it."""
        if self.page_mgr is not None and self.config.prefix_cache:
            self.page_mgr.register_prefix(job.slot_idx, job.prompt.tolist())
        slot = job.slot
        with torch.no_grad():
            first, flogp = self._sample(
                last_logits[None], self._tensor([slot.temperature], torch.float32),
                self._tensor([slot.top_p], torch.float32),
                self._tensor([slot.top_k], torch.int32),
                slot.temperature > 0, slot.want_logprobs)
        first = int(first[0])
        slot.generated.append(first)
        if slot.want_logprobs:
            slot.logprobs.append(float(flogp[0]))
        if slot.stream_queue is not None:
            slot.stream_queue.put_nowait(first)
        self._active[job.slot_idx] = slot
        slot.first_token.set()

    async def _tick_loop_inner(self):
        """The continuous-batching engine: each iteration runs ONE fused
        decode chunk for every active slot AND (at most) one prefill chunk
        of the oldest queued prompt."""
        while self._active or self._prefill_q:
            if self._active:
                drafts = self._spec_drafts()
                finished = (self._spec_tick(drafts) if drafts is not None
                            else self._decode_tick())
                for i in finished:
                    slot = self._active.pop(i)
                    slot.done_event.set()
                    if slot.stream_queue is not None:
                        slot.stream_queue.put_nowait(None)
                    self._release_slot(i)
            if self._prefill_q:
                job = self._prefill_q[0]
                try:
                    last_logits = self._prefill_chunk(job)
                except Exception as e:  # noqa: BLE001 - fail the request
                    self._prefill_q.popleft()
                    self._fail(job.slot, e)
                    self._release_slot(job.slot_idx)
                else:
                    if last_logits is not None:  # prompt fully prefilled
                        self._prefill_q.popleft()
                        self._start_decoding(job, last_logits)
            await asyncio.sleep(0)  # let admits interleave between ticks

    # -- public api ----------------------------------------------------------
    async def generate(self, prompt_ids: List[int], max_tokens: int = 32,
                       eos_id: Optional[int] = None,
                       temperature: Optional[float] = None,
                       top_p: Optional[float] = None,
                       top_k: Optional[int] = None,
                       logprobs: bool = False) -> Dict[str, Any]:
        t0 = time.perf_counter()
        slot = await self._admit(list(prompt_ids), max_tokens, eos_id, False,
                                 temperature=temperature, top_p=top_p,
                                 top_k=top_k, logprobs=logprobs)
        ttft = time.perf_counter() - t0
        await slot.done_event.wait()
        if slot.error is not None:
            raise RuntimeError("decode engine failed") from slot.error
        toks = slot.generated[:max_tokens]
        if eos_id is not None and eos_id in toks:
            toks = toks[:toks.index(eos_id)]
        out = {"tokens": toks, "ttft_s": ttft,
               "total_s": time.perf_counter() - t0}
        if logprobs:
            out["logprobs"] = slot.logprobs[:len(toks)]
        return out

    async def generate_stream(self, prompt_ids: List[int],
                              max_tokens: int = 32,
                              eos_id: Optional[int] = None,
                              temperature: Optional[float] = None,
                              top_p: Optional[float] = None,
                              top_k: Optional[int] = None):
        slot = await self._admit(list(prompt_ids), max_tokens, eos_id, True,
                                 temperature=temperature, top_p=top_p,
                                 top_k=top_k)
        emitted = 0
        try:
            while emitted < max_tokens:
                tok = await slot.stream_queue.get()
                if tok is None or (eos_id is not None and tok == eos_id):
                    break
                emitted += 1
                yield tok
            if slot.error is not None:
                raise RuntimeError("decode engine failed") from slot.error
        finally:
            # consumer walked away early: shrink the budget so the tick loop
            # finishes and releases this slot next tick
            slot.max_tokens = min(slot.max_tokens, len(slot.generated))

    async def embed(self, prompt_ids: List[int]) -> List[float]:
        """Mean-pooled final-hidden-state embedding of the prompt. Pads to
        the prefill buckets; causal attention keeps pad rows past the
        prompt out of the pooled rows. On CUDA the forward runs the flash
        kernel (B1) in every layer."""
        P = len(prompt_ids)
        if P == 0:
            raise ValueError("cannot embed an empty prompt")
        if P > self.config.max_seq_len:
            raise ValueError(
                f"prompt has {P} tokens but max_seq_len is "
                f"{self.config.max_seq_len}")
        b = self._bucket(P)
        tokens = np.zeros((1, b), np.int32)
        tokens[0, :P] = prompt_ids
        with torch.no_grad():
            hidden, _ = self.model(self._tensor(tokens), return_hidden=True)
            mask = (torch.arange(b, device=self.device) < P)[None, :, None]
            pooled = ((hidden * mask.to(hidden.dtype)).sum(dim=1)
                      / torch.tensor(P, dtype=hidden.dtype, device=self.device))
        return [float(x) for x in pooled[0].to(torch.float32).cpu().numpy()]

    def prefix_digest(self, max_bytes: Optional[int] = None) -> Optional[Dict]:
        """Hot-prefix digest for an affinity router: the radix tree's
        borrowable chains, hashed and hit-counted, packed to <= 4 KiB by
        default (`serve/prefix_digest.py`). None for a dense or flat-cache
        engine."""
        if isinstance(self.page_mgr, _radix.RadixPageManager):
            return self.page_mgr.prefix_digest(max_bytes)
        return None

    def slo_snapshot(self) -> Dict[str, Any]:
        """Windowed SLO read for an autoscaler: TTFT/TPOT quantiles and
        batch occupancy over the observations since the LAST call (a
        cumulative p99 would mask a fresh breach). The histograms are the
        process's, shared by every replica in it."""
        ttft = _metrics.histogram_window("serve_ttft_s", self._slo_window_state)
        tpot = _metrics.histogram_window("serve_tpot_ms", self._slo_window_state)
        occ = _metrics.histogram_window("serve_batch_occupancy",
                                        self._slo_window_state)
        return {
            "ttft_p99_s": ttft["p99"] if ttft else None,
            "ttft_count": ttft["count"] if ttft else 0,
            "tpot_p99_ms": tpot["p99"] if tpot else None,
            "occupancy_mean": occ["mean"] if occ else None,
            "active": len(self._active),
            "free_slots": len(self._free),
        }

    def stats(self) -> Dict[str, Any]:
        s = {"active": len(self._active), "free_slots": len(self._free),
             "requests": self._req_counter}
        st = self._decode_stats
        s["decode"] = {
            "decode_chunk": self.config.decode_chunk,
            "host_syncs": st["host_syncs"],
            "tokens": st["tokens"],
            "tokens_per_sync": round(
                st["tokens"] / max(st["host_syncs"], 1), 2),
            "host_syncs_per_token": round(
                st["host_syncs"] / max(st["tokens"], 1), 5),
            "chunk_s_total": round(st["chunk_s_total"], 4),
            "chunk_ms_avg": round(
                st["chunk_s_total"] / max(st["host_syncs"], 1) * 1e3, 3),
            "chunk_sizes": dict(st["chunk_sizes"]),
        }
        s["prefill"] = dict(self._prefill_stats)
        if self.config.speculate > 0:
            sp = dict(self._spec_stats)
            sp["accept_rate"] = round(sp["accepted"] / max(sp["drafted"], 1), 4)
            s["speculation"] = sp
        if self.page_mgr is not None:
            mgr = self.page_mgr
            s["pages_in_use"] = mgr.pages_in_use
            s["pages_free"] = len(mgr.free_pages)
            s["prefix_cached_pages"] = mgr.cached_pages
            s["prefix_hit_tokens"] = mgr.prefix_hit_tokens
            s["prefix_query_tokens"] = mgr.prefix_query_tokens
            s["prefix_hit_rate"] = round(
                mgr.prefix_hit_tokens / max(mgr.prefix_query_tokens, 1), 4)
        s["slo"] = {
            "ttft_s": _metrics.histogram_summary("serve_ttft_s"),
            "tpot_ms": _metrics.histogram_summary("serve_tpot_ms"),
            "batch_occupancy": _metrics.histogram_summary("serve_batch_occupancy"),
            "kv_page_util": _metrics.histogram_summary("serve_kv_page_util"),
            # the JAX engine's restore histogram; never observed until KV
            # stash demotion is ported
            "spill_restore_ms": _metrics.histogram_summary("spill_restore_ms"),
        }
        if isinstance(self.page_mgr, _radix.RadixPageManager):
            mgr = self.page_mgr
            s["radix"] = mgr.node_stats()
            s["slo"]["radix"] = {
                "prefix_nodes": mgr.prefix_nodes,
                "prefix_hit_tokens": mgr.prefix_hit_tokens,
                "prefix_evicted_pages": mgr.evicted_pages,
            }
        return s
