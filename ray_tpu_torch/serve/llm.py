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
chunk of every fresh prompt. Later slices bring tensor parallelism
(`tp > 1`), speculative decoding (`speculate > 0`), MoE presets, KV stash
demotion of evicted prefix pages, the SLO metrics, `slo_snapshot`, `embed`
and `prefix_digest`.
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
    speculate: int = 0              # prompt-lookup drafts (later slice)
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
        if cfg.speculate > 0:
            raise NotImplementedError(
                "speculate > 0 (prompt-lookup speculation on the dense cache): "
                "later slice")
        preset = getattr(LlamaConfig, cfg.preset)
        overrides = dict(max_seq_len=cfg.max_seq_len,
                         param_dtype=getattr(torch, cfg.param_dtype))
        if cfg.dtype is not None:
            overrides["dtype"] = getattr(torch, cfg.dtype)
        if cfg.model_overrides:
            overrides.update(cfg.model_overrides)
        self.model_cfg = preset(**overrides)
        if self.model_cfg.n_experts > 0:
            raise NotImplementedError("MoE serving (dropless experts): later slice")
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
        # decode-chunk accounting: ONE host sync per chunk is the whole perf
        # story, so it is a recorded metric, not an inference
        self._decode_stats = {"host_syncs": 0, "tokens": 0,
                              "chunk_s_total": 0.0, "chunk_sizes": {}}
        # prefill accounting: chunks run, and how many were a fresh row's
        # chunk-local first chunk (the flash-kernel path on CUDA)
        self._prefill_stats = {"chunks": 0, "chunk_local": 0}
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
        """Record one host sync of the decode engine (a fused chunk)."""
        st = self._decode_stats
        st["host_syncs"] += 1
        st["tokens"] += tokens
        st["chunk_s_total"] += dt_s
        if chunk is not None:
            st["chunk_sizes"][chunk] = st["chunk_sizes"].get(chunk, 0) + 1

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
                   top_p, top_k, logprobs: bool) -> _Slot:
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
                     want_logprobs=logprobs)

    async def _admit(self, prompt_ids: List[int], max_tokens: int,
                     eos_id: Optional[int], stream: bool,
                     temperature: Optional[float] = None,
                     top_p: Optional[float] = None,
                     top_k: Optional[int] = None,
                     logprobs: bool = False) -> _Slot:
        P = len(prompt_ids)
        # feasibility (max_seq_len, page-pool capacity) raises in _reserve
        slot_idx, cached = await self._reserve(prompt_ids, P + max_tokens)
        slot = self._make_slot(P, max_tokens, eos_id, stream, temperature,
                               top_p, top_k, logprobs)
        # the engine feeds the prompt through in chunks, interleaved with
        # decode ticks; a cached prefix starts the job past the shared pages
        self._prefill_q.append(_PrefillJob(
            slot_idx=slot_idx, slot=slot,
            prompt=np.asarray(list(prompt_ids), np.int32), pos=cached))
        self._ensure_tick_loop()
        await slot.first_token.wait()
        if slot.error is not None:
            raise RuntimeError("prefill failed") from slot.error
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

    def _decode_tick(self) -> List[int]:
        """One fused decode chunk for every active slot; returns the slots
        that finished."""
        cfg = self.config
        B = cfg.max_batch_slots
        n = self._chunk_len()
        mask = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        last = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)   # -1 never matches
        budget = np.zeros((B,), np.int32)
        room = np.zeros((B,), np.int32)
        for i, slot in self._active.items():
            mask[i] = True
            temps[i] = slot.temperature
            top_ps[i] = slot.top_p
            top_ks[i] = slot.top_k
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
        # the chunk's ONE host sync: tokens, counts and logprob bits travel
        # in a single int32 copy
        packed = torch.cat([toks.reshape(-1), n_valid,
                            logp.reshape(-1).view(torch.int32)]).cpu().numpy()
        toks = packed[:B * n].reshape(B, n)
        n_valid = packed[B * n:B * n + B]
        logp = packed[B * n + B:].view(np.float32).reshape(B, n)
        finished = []
        emitted = 0
        for i, slot in self._active.items():
            for j in range(int(n_valid[i])):
                emitted += 1
                if self._emit_one(slot, int(toks[i, j]), float(logp[i, j])):
                    finished.append(i)
                    break
        self._note_sync(emitted, time.perf_counter() - t0, chunk=n)
        return finished

    def _emit_one(self, slot: _Slot, tok: int, lp: float) -> bool:
        """Append one token to `slot`; True when the slot is done."""
        slot.generated.append(tok)
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
                for i in self._decode_tick():
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
        if self.page_mgr is not None:
            mgr = self.page_mgr
            s["pages_in_use"] = mgr.pages_in_use
            s["pages_free"] = len(mgr.free_pages)
            s["prefix_cached_pages"] = mgr.cached_pages
            s["prefix_hit_tokens"] = mgr.prefix_hit_tokens
            s["prefix_query_tokens"] = mgr.prefix_query_tokens
            s["prefix_hit_rate"] = round(
                mgr.prefix_hit_tokens / max(mgr.prefix_query_tokens, 1), 4)
        if isinstance(self.page_mgr, _radix.RadixPageManager):
            s["radix"] = self.page_mgr.node_stats()
        return s
