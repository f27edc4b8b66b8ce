"""Paged attention: decode attention over a paged KV cache.

Counterpart of `ray_tpu/ops/paged_attention.py`. The memory model is the
same as the JAX package's (vLLM's PagedAttention):

- KV pages live as one pool per layer, `[L, Kh, P, page, D]` on the device.
- A block table `[B, max_pages]` int32 maps each sequence's logical pages
  to pool slots; `lengths[B]` counts valid tokens. Page 0 is the reserved
  placeholder that unused table entries point at.

`paged_attention` is the wrapper of the hand-written CUDA kernels in
`csrc/paged_decode.cu` (CUDA C++, sm_90a), which replace
`ray_tpu/ops/paged_attention.py::_decode_kernel` with flash-decoding: a
split pass, one CTA per (kv head, b, run of `pages_per_split` table
entries), holds the head's G query rows, reads its own block-table row,
double-buffers the pages that hold tokens into shared memory with
cp.async and keeps an online f32 softmax; it writes a partial
(max, sum, accumulator) per split, and a combine pass merges the splits by
log-sum-exp. The plan (`split_plan`) depends on shapes and the card's SM
count only, never on `lengths`, so a call reads nothing back to the host
and can be captured in a CUDA graph. Bound on the H100: device-memory
bytes, 2 * B * len * Kh * D * 2 bytes of bf16 K and V per layer.

A CPU tensor goes to `paged_attention_reference`, the plain PyTorch gather
version; a CUDA tensor launches the kernels or raises.
`paged_attention_split_reference` is the plain version of the split and
combine arithmetic.

Unlike the JAX package, whose arrays are immutable, the port writes new
K/V into the pool IN PLACE (`write_tokens`, `write_layer_tokens`); the
functions still return the cache so callers thread it the same way.
"""

import collections
import dataclasses
import hashlib
import math
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.ops import _build

# kernel launches since the counts were last reset (chip_smoke.py resets them)
LAUNCHES = 0          # split pass: one per call
COMBINE_LAUNCHES = 0  # combine pass: one per call whose plan has several splits
MAX_GROUP = 8         # query heads per kv head the kernel takes (csrc MAX_G)
# The kernel's shared memory holds 64-token tiles whatever the page size;
# this is the largest page its checks on the card cover.
MAX_PAGE_SIZE = 256
# The split plan's aim: as many CTAs as fit on an SM at G = 4 (128
# registers a thread); chip_smoke.py times the plans of 2, 3, 4 and 8
# (PERF.md §6).
CTAS_PER_SM = 4


def split_plan(batch: int, kv_heads: int, max_pages: int, sm_count: int):
    """(n_split, pages_per_split) of the split pass: enough splits of the
    block-table row that the batch's kv heads fill about CTAS_PER_SM CTAs
    per SM. Shapes only: a plan that read `lengths` would need a host sync
    on every call."""
    want = -(-CTAS_PER_SM * sm_count // (batch * kv_heads))
    per = -(-max_pages // max(1, min(max_pages, want)))
    return -(-max_pages // per), per


_SM_COUNT = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def paged_attention_reference(q, k_pages, v_pages, block_tables, lengths,
                              *, scale: Optional[float] = None) -> torch.Tensor:
    """Gather pages, then masked f32 attention: the plain version of the
    kernel. q: [B, H, D]; pools: [Kh, P, page, D]; returns [B, H, D]."""
    b, h, d = q.shape
    kh, _pool, page_size, _d = k_pages.shape
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = block_tables.long()
    s_max = tables.shape[1] * page_size
    # [Kh, B, max_pages, page, D] -> [B, Kh, S, D]
    k_seq = k_pages[:, tables].transpose(0, 1).reshape(b, kh, s_max, d)
    v_seq = v_pages[:, tables].transpose(0, 1).reshape(b, kh, s_max, d)
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_seq.float()) * scale
    mask = (torch.arange(s_max, device=q.device)[None, None, None, :]
            < lengths.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_seq.float())
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_split_reference(q, k_pages, v_pages, block_tables, lengths, *,
                                    pages_per_split: int,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """The kernels' split-and-combine arithmetic in plain PyTorch: each run
    of `pages_per_split` table entries gives a partial (max m, sum l,
    accumulator) in f32, m = -inf, l = 0 and a zero accumulator where the
    run holds no token; the partials merge by log-sum-exp. Same arguments
    and result as `paged_attention_reference`."""
    b, h, d = q.shape
    kh, _pool, page_size, _d = k_pages.shape
    g = h // kh
    max_pages = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n_split = -(-max_pages // pages_per_split)
    span = pages_per_split * page_size
    pad = n_split * span - max_pages * page_size   # past the table: no tokens
    tables = block_tables.long()
    k_seq = k_pages[:, tables].transpose(0, 1).reshape(b, kh, -1, d).float()
    v_seq = v_pages[:, tables].transpose(0, 1).reshape(b, kh, -1, d).float()
    v_seq = torch.nn.functional.pad(v_seq, (0, 0, 0, pad))
    s = torch.einsum("bkgd,bksd->bkgs", q.reshape(b, kh, g, d).float(), k_seq) * scale
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    mask = (torch.arange(n_split * span, device=q.device)[None, None, None, :]
            < lengths.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, float("-inf")).reshape(b, kh, g, n_split, span)
    m = s.amax(-1)                                          # [B, Kh, G, n_split]
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgns,bknsd->bkgnd", p, v_seq.reshape(b, kh, n_split, span, d))
    w = torch.exp(m - m.amax(-1, keepdim=True))             # split 0 holds a token
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def _check_inputs(q, k_pages, v_pages, block_tables, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention takes q [B, H, D] and pools [Kh, P, page, D]; "
                         f"got q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)}")
    b, h, d = q.shape
    kh, _pool, page, d_pool = k_pages.shape
    if d != d_pool or h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"paged kernel takes D equal in q and pools and at most "
                         f"{MAX_GROUP} query heads per kv head; got q {tuple(q.shape)}, "
                         f"pools {tuple(k_pages.shape)}")
    if d not in (16, 32, 64, 128) or not 0 < page <= MAX_PAGE_SIZE:
        raise ValueError(f"paged kernel takes head_dim 16/32/64/128 and page size "
                         f"<= {MAX_PAGE_SIZE}; got D={d}, page={page}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"paged kernel takes bf16 or f32 q and pools of one dtype, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"block_tables must be [B, max_pages] and lengths [B] for B={b}")
    if q.stride(-1) != 1:
        raise ValueError("paged kernel needs a contiguous last axis of q")
    # the kernel loads K/V rows with 16-byte vector loads
    vec = 16 // k_pages.element_size()
    for name, pool in (("k_pages", k_pages), ("v_pages", v_pages)):
        if (pool.stride(-1) != 1 or any(s % vec for s in pool.stride()[:3])
                or pool.data_ptr() % 16):
            raise ValueError(f"{name} rows must be contiguous and 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention; returns [B, H, D] in q's dtype.

    q: [B, H, D] (one decode token per sequence); k_pages/v_pages:
    [Kh, P, page, D]; block_tables: [B, max_pages] pool slots (unused entries
    must be valid pool indices, 0 is fine); lengths: [B] valid tokens per
    sequence, each >= 1. Sequences attend to their first `lengths` tokens.
    """
    devices = {x.device for x in (q, k_pages, v_pages, block_tables, lengths)}
    if len(devices) != 1:
        raise ValueError(f"paged_attention inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and q.requires_grad:
        raise NotImplementedError("paged decode has no backward kernel")
    _check_inputs(q, k_pages, v_pages, block_tables, lengths)
    b, h, d = q.shape
    kh, _pool, page, _d = k_pages.shape
    max_pages = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    n_split, per = split_plan(b, kh, max_pages, _sm_count(q.device))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    # partial (acc, m, l) per split; one split writes out itself
    ws = (torch.empty(b * n_split * h * (d + 2), dtype=torch.float32, device=q.device)
          if n_split > 1 else None)
    code_dtype = _build.DTYPE_CODES[q.dtype]
    stream = _build.stream_handle(q.device)
    lib = _build.load_library()
    code = lib.rtt_paged_decode_split(
        code_dtype, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, h, kh, d, page, max_pages, n_split, per,
        q.stride(0), q.stride(1), k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        out.stride(0), out.stride(1), float(scale), stream)
    _build.check(code, "paged_decode_split")
    global LAUNCHES, COMBINE_LAUNCHES
    LAUNCHES += 1
    if ws is not None:
        code = lib.rtt_paged_decode_combine(code_dtype, ws.data_ptr(), out.data_ptr(), b, h,
                                            kh, d, n_split, out.stride(0), out.stride(1),
                                            stream)
        _build.check(code, "paged_decode_combine")
        COMBINE_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Paged KV cache: page pool + per-sequence block tables. Page allocation is
# host-side bookkeeping (PageManager); the pools are written in place.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKVCache:
    """Per-layer page pools and shared block tables.

    k_pages/v_pages: [L, Kh, P, page, D]; block_tables: [B, max_pages] int32;
    lengths: [B] int32. Rows whose slot is free have length 0 and table
    entries 0.
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor

    @property
    def page_size(self):
        return self.k_pages.shape[3]

    @property
    def length(self):
        """Alias matching KVCache.length so the decoder's position math is
        cache-type agnostic."""
        return self.lengths

    def replace(self, **changes) -> "PagedKVCache":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def init(n_layers: int, n_kv_heads: int, head_dim: int, num_pages: int,
             page_size: int, batch_slots: int, max_pages_per_seq: int,
             dtype=torch.bfloat16, device="cuda") -> "PagedKVCache":
        shape = (n_layers, n_kv_heads, num_pages, page_size, head_dim)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            block_tables=torch.zeros((batch_slots, max_pages_per_seq),
                                     dtype=torch.int32, device=device),
            lengths=torch.zeros((batch_slots,), dtype=torch.int32, device=device))


def _slots(cache: PagedKVCache, positions: torch.Tensor):
    """(page ids, in-page offsets) of positions [B, T], flattened to [B*T]."""
    bsz, t = positions.shape
    ps = cache.page_size
    pos = positions.reshape(-1).long()
    rows = torch.arange(bsz, device=pos.device).repeat_interleave(t)
    # clamped like a JAX gather: a position past the table reads its last entry
    page_idx = (pos // ps).clamp(max=cache.block_tables.shape[1] - 1)
    page_ids = cache.block_tables[rows, page_idx].long()
    return page_ids, pos % ps


def write_tokens(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 positions: torch.Tensor) -> PagedKVCache:
    """Write new tokens of every layer into their pages, in place.

    k_new/v_new: [L, B, T, Kh, D]; positions: [B, T] absolute positions; the
    block table must already map position // page_size for every row. Does
    NOT advance `lengths`: the caller owns admission bookkeeping.
    """
    l, bsz, t, kh, d = k_new.shape
    page_ids, offs = _slots(cache, positions)
    kv = lambda x: x.reshape(l, bsz * t, kh, d).transpose(1, 2)  # [L, Kh, B*T, D]
    cache.k_pages[:, :, page_ids, offs] = kv(k_new).to(cache.k_pages.dtype)
    cache.v_pages[:, :, page_ids, offs] = kv(v_new).to(cache.v_pages.dtype)
    return cache


def write_layer_tokens(cache: PagedKVCache, layer_idx: int, k_new: torch.Tensor,
                       v_new: torch.Tensor, positions: torch.Tensor) -> PagedKVCache:
    """Write ONE layer's new K/V into its page slice, in place.

    k_new/v_new: [B, T, Kh, D]; positions: [B, T]. Decode (T == 1) writes one
    entry per row at that row's position; prefill (T > 1) scatters the
    chunk. Both are one indexed assignment into the layer's pool view.

    The JAX package rebinds the pool (a dynamic_update_slice per row that
    XLA aliases into the donated buffer); the port updates the pool in place,
    so N decode steps cost N small writes and never copy the pool. Inactive
    serving rows keep writing one entry at their frozen length; their table
    row is zeroed, so the write lands on placeholder page 0.
    """
    bsz, t, kh, d = k_new.shape
    page_ids, offs = _slots(cache, positions)
    kv = lambda x: x.reshape(bsz * t, kh, d).transpose(0, 1)     # [Kh, B*T, D]
    cache.k_pages[layer_idx][:, page_ids, offs] = kv(k_new).to(cache.k_pages.dtype)
    cache.v_pages[layer_idx][:, page_ids, offs] = kv(v_new).to(cache.v_pages.dtype)
    return cache


class PageManager:
    """Host-side page allocator (free list + per-slot table bookkeeping).

    Admission asks `can_fit(n_tokens)`, `allocate(slot, n_tokens)` assigns
    pool pages and returns the table row, `extend(slot)` grabs the next page
    when a decode crosses a page boundary, `free(slot)` returns pages to the
    pool.

    Prefix cache: FULL prompt pages are content-addressed by a chained hash
    of the token prefix they cover. `allocate_prefix` links a new request's
    table to every already-cached leading page (refcounted; shared pages are
    read-only by construction: prefill skips them and decode writes only at
    positions >= prompt_len, past every full prompt page). `register_prefix`
    publishes a freshly-prefilled prompt's full pages. Released pages with
    refcount 0 park in an LRU and are evicted back to the free list only
    under pool pressure.
    """

    def __init__(self, num_pages: int, page_size: int, batch_slots: int,
                 max_pages_per_seq: int, prefix_cache: bool = True):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        # page 0 is reserved as the masked placeholder for unused table slots
        self.free_pages = list(range(num_pages - 1, 0, -1))
        self.tables = [[] for _ in range(batch_slots)]
        self.prefix_cache_enabled = prefix_cache
        # content-addressed full prompt pages
        self._by_key: dict = {}          # chain-hash key -> page id
        self._key_of: dict = {}          # page id -> key
        self._refs: dict = {}            # page id -> live borrower count
        self._lru: "collections.OrderedDict" = collections.OrderedDict()
        #                                  # refcount-0 cached pages (evictable)
        self._shared_count = [0] * batch_slots  # leading shared pages per slot
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0

    # ---------------------------------------------------------- chain hashes
    def _prefix_keys(self, prompt_ids) -> list:
        """One chained key per FULL page of the prompt: key_i commits to all
        tokens [0, (i+1)*page_size), O(P) total."""
        ps = self.page_size
        toks = np.asarray(prompt_ids, np.int32)
        keys = []
        h = hashlib.blake2b(digest_size=16)
        for i in range(len(toks) // ps):
            h.update(toks[i * ps:(i + 1) * ps].tobytes())
            keys.append(h.hexdigest())
            h = hashlib.blake2b(h.digest(), digest_size=16)
        return keys

    def _evict_to_free(self, need: int) -> bool:
        """Evict LRU refcount-0 cached pages until >= `need` pages are free."""
        while len(self.free_pages) < need and self._lru:
            pid, _ = self._lru.popitem(last=False)
            key = self._key_of.pop(pid, None)
            if key is not None:
                self._by_key.pop(key, None)
            self._refs.pop(pid, None)
            self.free_pages.append(pid)
        return len(self.free_pages) >= need

    def _take_page(self):
        if not self.free_pages:
            self._evict_to_free(1)
        return self.free_pages.pop()

    def _available(self) -> int:
        return len(self.free_pages) + len(self._lru)

    def can_fit(self, n_tokens: int) -> bool:
        need = -(-n_tokens // self.page_size)
        return need <= self._available() and need <= self.max_pages_per_seq

    def can_fit_prompt(self, prompt_ids, n_tokens: int) -> bool:
        """can_fit that credits the prompt's cached-prefix pages: a
        prefix-hit request borrows those (refcounted, costing no free
        pages)."""
        if not self.prefix_cache_enabled:
            return self.can_fit(n_tokens)
        ps = self.page_size
        P = len(prompt_ids)
        shared = []
        for key in self._prefix_keys(prompt_ids):
            pid = self._by_key.get(key)
            if pid is None:
                break
            shared.append(pid)
        while shared and len(shared) * ps >= P:
            shared.pop()  # mirror allocate_prefix: one token must prefill
        need_total = -(-n_tokens // ps)
        need_fresh = need_total - len(shared)
        # matched pages parked in the LRU aren't evictable for THIS request
        # (borrowing pins them): don't double-count them as available
        lru_matched = sum(1 for pid in shared if pid in self._lru)
        return (need_fresh <= self._available() - lru_matched
                and need_total <= self.max_pages_per_seq)

    def allocate(self, slot: int, n_tokens: int):
        need = -(-n_tokens // self.page_size)
        if need > self._available():
            raise MemoryError(
                f"paged KV pool exhausted: need {need} pages, "
                f"{self._available()} free/evictable")
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {need} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}")
        assert not self.tables[slot], f"slot {slot} already allocated"
        pages = [self._take_page() for _ in range(need)]
        self.tables[slot] = pages
        self._shared_count[slot] = 0
        return self.table_row(slot)

    def allocate_prefix(self, slot: int, prompt_ids, n_tokens: int):
        """Like allocate, but the leading pages reuse any cached prefix.
        Returns (table_row, cached_token_count): prefill starts at
        cached_token_count. At least one prompt token is always left to
        prefill (the final-chunk logits come from running it)."""
        if not self.prefix_cache_enabled:
            return self.allocate(slot, n_tokens), 0
        ps = self.page_size
        P = len(prompt_ids)
        keys = self._prefix_keys(prompt_ids)
        self.prefix_query_tokens += P
        shared = []
        for key in keys:
            pid = self._by_key.get(key)
            if pid is None:
                break
            shared.append(pid)
        # a fully page-covered prompt must still prefill its last token
        while shared and len(shared) * ps >= P:
            shared.pop()
        need_fresh = -(-n_tokens // ps) - len(shared)
        total_need = len(shared) + need_fresh
        if total_need > self.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {total_need} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}")
        assert not self.tables[slot], f"slot {slot} already allocated"
        # pin shared pages BEFORE evicting for fresh ones: eviction scans the
        # LRU and could otherwise free the very pages being borrowed
        for pid in shared:
            self._refs[pid] = self._refs.get(pid, 0) + 1
            self._lru.pop(pid, None)  # borrowed pages leave the evictable set
        try:
            if need_fresh > len(self.free_pages) and not self._evict_to_free(
                    need_fresh):
                raise MemoryError(
                    f"paged KV pool exhausted: need {need_fresh} pages, "
                    f"{self._available()} free/evictable")
            fresh = [self.free_pages.pop() for _ in range(need_fresh)]
        except BaseException:
            for pid in shared:  # rollback the pins
                self._refs[pid] -= 1
                if self._refs[pid] <= 0:
                    self._refs[pid] = 0
                    self._lru[pid] = True
            raise
        self.tables[slot] = shared + fresh
        self._shared_count[slot] = len(shared)
        cached = len(shared) * ps
        self.prefix_hit_tokens += cached
        return self.table_row(slot), cached

    def register_prefix(self, slot: int, prompt_ids):
        """Publish this slot's freshly-written FULL prompt pages so later
        requests can share them. Called once prefill completes: the pages
        are final (decode writes land past the last full prompt page)."""
        if not self.prefix_cache_enabled:
            return
        keys = self._prefix_keys(prompt_ids)
        table = self.tables[slot]
        for i, key in enumerate(keys):
            if i < self._shared_count[slot]:
                continue  # was already shared at admission
            if key in self._by_key:
                continue  # a concurrent request published it first
            pid = table[i]
            self._by_key[key] = pid
            self._key_of[pid] = key
            self._refs[pid] = self._refs.get(pid, 0) + 1

    def extend(self, slot: int, new_len: int):
        """Ensure the slot's table covers new_len tokens; returns the row."""
        need = -(-new_len // self.page_size)
        while len(self.tables[slot]) < need:
            if not self.free_pages and not self._evict_to_free(1):
                raise MemoryError("paged KV pool exhausted during decode")
            if len(self.tables[slot]) >= self.max_pages_per_seq:
                raise ValueError("sequence exceeded max_pages_per_seq")
            self.tables[slot].append(self.free_pages.pop())
        return self.table_row(slot)

    def free(self, slot: int):
        """Return the slot's pages: cache-tracked pages decref (parking in
        the LRU at zero, NOT the free list: a future prompt may hit them);
        untracked pages go straight back to the free list."""
        for pid in self.tables[slot]:
            if pid in self._refs:
                self._refs[pid] -= 1
                if self._refs[pid] <= 0:
                    if pid in self._key_of:
                        self._refs[pid] = 0
                        self._lru[pid] = True  # evictable, newest-last
                    else:
                        self._refs.pop(pid, None)
                        self.free_pages.append(pid)
            else:
                self.free_pages.append(pid)
        self.tables[slot] = []
        self._shared_count[slot] = 0

    def table_row(self, slot: int):
        row = self.tables[slot]
        return row + [0] * (self.max_pages_per_seq - len(row))

    def table_slice(self, slot: int, start: int, n: int):
        """Page ids covering the slot's pages [start, start+n)."""
        row = self.tables[slot][start:start + n]
        if len(row) != n:
            raise IndexError(
                f"slot {slot} holds {len(self.tables[slot])} pages, "
                f"requested [{start}, {start + n})")
        return list(row)

    def shared_page_count(self, slot: int) -> int:
        """Leading pages this slot borrowed from the prefix cache."""
        return self._shared_count[slot]

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self.free_pages)

    @property
    def cached_pages(self) -> int:
        return len(self._by_key)
