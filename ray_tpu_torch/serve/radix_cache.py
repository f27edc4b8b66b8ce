"""Radix prefix index over token-block KV pages.

Counterpart of `ray_tpu/serve/radix_cache.py` (sglang's RadixAttention tree
cache, vLLM's automatic prefix caching), subclassing the port's own
`PageManager`:

  * one trie node per FULL page of tokens; two prompts share nodes up to
    their exact divergence point. Shared pages are read-only by
    construction (prefill skips them, decode writes land past the last full
    prompt page), so the branch point is where copy-on-write happens.
  * per-node hit accounting; the tree size and the hit-token, query-token,
    evicted, demoted and restored page tallies go to the port's metrics
    registry (`radix_*`, read by `util.metrics.radix_counters`); and
    `prefix_digest`, the hashed, hit-counted summary of the borrowable
    chains that an affinity router reads (`serve/prefix_digest.py`).
  * LRU-by-leaf eviction: only nodes with no RESIDENT children are eviction
    candidates, so the tree never creates unreachable descendants.
  * demotion instead of discard: an evicted page's KV is sealed into the
    KV stash (`demote_cb`; `serve/kv_transfer.py` `KVPageStash`, shm then
    disk), the node stays in the tree marked demoted, and a later request
    matching it restores the bytes into a fresh pool page (`restore_cb`)
    instead of recomputing its prefill. The serving engine wires the hooks
    (`serve/llm.py`) unless `RAY_TPU_SPILL_KV=0`.

`RAY_TPU_RADIX=0` selects the flat chained-hash manager instead, which
discards on eviction (only the tree keeps handles).
"""

import collections
import os

from ray_tpu_torch.ops.paged_attention import PageManager
from ray_tpu_torch.serve import prefix_digest as _pd
from ray_tpu_torch.util import metrics as _metrics


def radix_enabled() -> bool:
    return os.environ.get("RAY_TPU_RADIX", "1").lower() not in (
        "0", "false", "off")


def _count(name: str, value: float = 1.0):
    if value:
        _metrics.get_or_create(_metrics.Counter, name,
                               "radix prefix cache tally").inc(value)


class _Node:
    """One full page of tokens in the radix tree."""

    __slots__ = ("tokens", "parent", "children", "page", "handle", "hits")

    def __init__(self, tokens, parent):
        self.tokens = tokens      # tuple of page_size token ids
        self.parent = parent
        self.children = {}        # tokens tuple -> _Node
        self.page = None          # pool page id while resident
        self.handle = None        # opaque demoted-KV handle
        self.hits = 0

    @property
    def resident_children(self) -> int:
        return sum(1 for c in self.children.values() if c.page is not None)


class RadixPageManager(PageManager):
    """PageManager whose prefix cache is a radix tree with a demotion tier.

    Hooks (all optional; without them the tree still branch-shares and
    evicts leaf-first, it just discards instead of demoting):

      demote_cb(page_id, node) -> handle | None
          Extract the page's KV into durable storage, synchronously at
          eviction time, BEFORE the pool page can be reused. None: discard.
      restore_cb(handle, page_id) -> bool
          Load a demoted page's KV back at `page_id`. False: a miss, the
          match stops there.
      drop_cb(handle)
          The demoted payload will never be restored; release its storage.

    A hook that raises fails the allocation with the pool as it was; none
    is swallowed.
    """

    def __init__(self, num_pages: int, page_size: int, batch_slots: int,
                 max_pages_per_seq: int, prefix_cache: bool = True,
                 demote_cb=None, restore_cb=None, drop_cb=None,
                 demote_cap: int = None):
        super().__init__(num_pages, page_size, batch_slots,
                         max_pages_per_seq, prefix_cache)
        self._root = _Node((), None)
        self._node_of = {}  # page id -> resident published _Node
        self.demote_cb = demote_cb
        self.restore_cb = restore_cb
        self.drop_cb = drop_cb
        # demoted nodes, oldest-first (a second-chance tier, capped so the
        # handle table can't grow without bound)
        self._demoted = collections.OrderedDict()
        if demote_cap is None:
            demote_cap = int(os.environ.get("RAY_TPU_RADIX_DEMOTE_CAP", 4096))
        self._demote_cap = max(0, demote_cap)
        self.prefix_nodes = 0          # live tree nodes (resident + demoted)
        self.evicted_pages = 0         # pages taken off the tree by the LRU
        self.demoted_pages = 0         # of those, extracted by demote_cb
        self.restored_pages = 0        # demoted pages pulled back on a hit

    # ------------------------------------------------------------- tree walk
    def _page_tuples(self, prompt_ids) -> list:
        ps = self.page_size
        toks = [int(t) for t in prompt_ids]
        return [tuple(toks[i * ps:(i + 1) * ps])
                for i in range(len(toks) // ps)]

    def _walk(self, prompt_ids) -> list:
        """Maximal usable chain of tree nodes for this prompt: stops at the
        first page that is neither resident nor restorable (a hole breaks
        the chain: attention needs every leading page's KV)."""
        out = []
        cur = self._root
        restorable = self.restore_cb is not None
        for tokens in self._page_tuples(prompt_ids):
            node = cur.children.get(tokens)
            if node is None:
                break
            if node.page is None and (node.handle is None or not restorable):
                break
            out.append(node)
            cur = node
        return out

    def _maybe_remove(self, node):
        """Unlink pageless, payloadless, childless nodes up the spine."""
        while (node is not None and node is not self._root
               and node.page is None and node.handle is None
               and not node.children):
            parent = node.parent
            parent.children.pop(node.tokens, None)
            node.parent = None
            self.prefix_nodes -= 1
            node = parent
        self._set_nodes_gauge()

    def _set_nodes_gauge(self):
        _metrics.get_or_create(_metrics.Gauge, "radix_prefix_nodes",
                               "live radix prefix-tree nodes").set(self.prefix_nodes)

    # -------------------------------------------------------------- eviction
    def _evict_node(self, pid: int, node):
        """Take `pid` off the tree: demote its KV if a demotion hook is
        wired (extraction happens NOW, before the pool page is recycled),
        else discard the node. The page returns to the free list either
        way. A demotion that raises propagates before anything changed
        (the JAX tree discards the page quietly instead)."""
        if node.handle is None and self.demote_cb is not None:
            node.handle = self.demote_cb(pid, node)
        self._lru.pop(pid, None)
        self._refs.pop(pid, None)
        self._key_of.pop(pid, None)
        self._node_of.pop(pid, None)
        node.page = None
        self.evicted_pages += 1
        _count("radix_evicted_pages")
        if node.handle is not None:
            self.demoted_pages += 1
            _count("radix_demoted_pages")
            self._demoted[node] = True
            self._demoted.move_to_end(node)
            while len(self._demoted) > self._demote_cap:
                old, _ = self._demoted.popitem(last=False)
                self._drop_handle(old)
        else:
            self._maybe_remove(node)
        self.free_pages.append(pid)

    def _drop_handle(self, node):
        if node.handle is not None and self.drop_cb is not None:
            self.drop_cb(node.handle)
        node.handle = None
        self._maybe_remove(node)

    def _evict_to_free(self, need: int) -> bool:
        """Leaf-first LRU eviction: among refcount-0 resident pages, only
        those whose node has no resident children are candidates, so an
        interior page is never freed while a descendant still depends on
        it for prefix matching."""
        while len(self.free_pages) < need and self._lru:
            victim = None
            for pid in self._lru:  # oldest first
                node = self._node_of.get(pid)
                if node is None or node.resident_children == 0:
                    victim = pid
                    break
            if victim is None:
                # borrowed pages pin their whole ancestor chain, so a
                # resident leaf is always in the LRU before its ancestors;
                # reaching here means the invariant broke: fail safe by
                # taking the oldest (its node becomes a hole).
                victim, _ = next(iter(self._lru.items()))
            node = self._node_of.get(victim)
            if node is not None:
                self._evict_node(victim, node)
            else:  # flat-cache page (shouldn't happen under radix): discard
                self._lru.pop(victim, None)
                key = self._key_of.pop(victim, None)
                if key is not None:
                    self._by_key.pop(key, None)
                self._refs.pop(victim, None)
                self.free_pages.append(victim)
        return len(self.free_pages) >= need

    # ------------------------------------------------------------- admission
    def can_fit_prompt(self, prompt_ids, n_tokens: int) -> bool:
        if not self.prefix_cache_enabled:
            return self.can_fit(n_tokens)
        ps = self.page_size
        P = len(prompt_ids)
        matched = self._walk(prompt_ids)
        while matched and len(matched) * ps >= P:
            matched.pop()  # mirror allocate_prefix: one token must prefill
        live = [n for n in matched if n.page is not None]
        need_total = -(-n_tokens // ps)
        # demoted matches restore into a fresh page each, so only LIVE
        # matches are free; LRU-parked live matches aren't evictable for
        # this request (borrowing pins them)
        need_new = need_total - len(live)
        lru_matched = sum(1 for n in live if n.page in self._lru)
        return (need_new <= self._available() - lru_matched
                and need_total <= self.max_pages_per_seq)

    def allocate_prefix(self, slot: int, prompt_ids, n_tokens: int):
        """Borrow the prompt's resident chain, restore its demoted links,
        and allocate fresh pages for the rest. Returns
        (table_row, cached_token_count); prefill starts at
        cached_token_count."""
        if not self.prefix_cache_enabled:
            return self.allocate(slot, n_tokens), 0
        ps = self.page_size
        P = len(prompt_ids)
        self.prefix_query_tokens += P
        _count("radix_query_tokens", P)
        matched = self._walk(prompt_ids)
        while matched and len(matched) * ps >= P:
            matched.pop()  # a fully covered prompt still prefills its tail
        need_total = -(-n_tokens // ps)
        if need_total > self.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {need_total} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}")
        assert not self.tables[slot], f"slot {slot} already allocated"
        # pin the live chain BEFORE any eviction: _evict_to_free scans the
        # LRU and could otherwise free the very pages being borrowed
        pinned = []
        for n in matched:
            if n.page is not None:
                self._refs[n.page] = self._refs.get(n.page, 0) + 1
                self._lru.pop(n.page, None)
                pinned.append(n)
        restored = []
        fresh = []
        try:
            # restore demoted links in chain order; the first failure
            # truncates the usable match there (later pinned nodes unpin)
            usable = []
            for n in matched:
                if n.page is not None:
                    usable.append(n)
                    continue
                if not self.free_pages and not self._evict_to_free(1):
                    break
                pid = self.free_pages.pop()
                try:
                    ok = bool(self.restore_cb(n.handle, pid))
                except BaseException:   # propagates, the page back in the pool
                    self.free_pages.append(pid)
                    raise
                if not ok:
                    self.free_pages.append(pid)
                    break
                n.page = pid
                self._node_of[pid] = n
                self._key_of[pid] = n
                self._refs[pid] = 1
                self._demoted.pop(n, None)  # handle kept: re-demotion is free
                restored.append(n)
                usable.append(n)
            if len(usable) < len(matched):
                for n in matched[len(usable):]:
                    if n in pinned:
                        pinned.remove(n)
                        self._refs[n.page] -= 1
                        if self._refs[n.page] <= 0:
                            self._refs[n.page] = 0
                            self._lru[n.page] = True
                matched = usable
            need_fresh = need_total - len(matched)
            if need_fresh > len(self.free_pages) and not self._evict_to_free(
                    need_fresh):
                raise MemoryError(
                    f"paged KV pool exhausted: need {need_fresh} pages, "
                    f"{self._available()} free/evictable")
            fresh = [self.free_pages.pop() for _ in range(need_fresh)]
        except BaseException:
            for n in restored:  # un-restore: page back to pool, node demoted
                pid = n.page
                n.page = None
                self._node_of.pop(pid, None)
                self._key_of.pop(pid, None)
                self._refs.pop(pid, None)
                self._demoted[n] = True
                self.free_pages.append(pid)
            for n in pinned:  # rollback the borrow pins
                self._refs[n.page] -= 1
                if self._refs[n.page] <= 0:
                    self._refs[n.page] = 0
                    self._lru[n.page] = True
            raise
        self.tables[slot] = [n.page for n in matched] + fresh
        self._shared_count[slot] = len(matched)
        for n in matched:
            n.hits += 1
        self.restored_pages += len(restored)
        _count("radix_restored_pages", len(restored))
        cached = len(matched) * ps
        self.prefix_hit_tokens += cached
        _count("radix_hit_tokens", cached)
        return self.table_row(slot), cached

    def register_prefix(self, slot: int, prompt_ids):
        """Publish the slot's freshly-prefilled FULL prompt pages as tree
        nodes. A node another request published first keeps its page (this
        slot's private copy returns to the pool at free()); a demoted node
        re-attaches, since the fresh prefill recomputed exactly its KV."""
        if not self.prefix_cache_enabled:
            return
        table = self.tables[slot]
        cur = self._root
        for i, tokens in enumerate(self._page_tuples(prompt_ids)):
            if i >= len(table):
                break
            node = cur.children.get(tokens)
            if node is None:
                node = _Node(tokens, cur)
                cur.children[tokens] = node
                self.prefix_nodes += 1
            cur = node
            if node.page is not None:
                continue  # shared at admission or concurrently published
            if i < self._shared_count[slot]:
                continue  # borrowed chain: already accounted
            pid = table[i]
            node.page = pid
            self._node_of[pid] = node
            self._key_of[pid] = node
            self._refs[pid] = self._refs.get(pid, 0) + 1
            self._demoted.pop(node, None)
        self._set_nodes_gauge()

    # ------------------------------------------------------------ inspection
    @property
    def cached_pages(self) -> int:
        return len(self._node_of)

    def prefix_digest(self, max_bytes: int = None) -> dict:
        """{chained page hash -> hits} over every node a request could
        borrow (resident pages, and demoted ones when a restore hook is
        wired), packed to at most `max_bytes` (default
        RAY_TPU_PREFIX_DIGEST_BYTES=4096) by hottest-first truncation.
        Children of a hole are skipped: a prefix walk stops there anyway."""
        if max_bytes is None:
            max_bytes = _pd.digest_max_bytes()
        restorable = self.restore_cb is not None
        cand = []
        stack = [(self._root, 0, 0)]
        while stack:
            node, chain, depth = stack.pop()
            for child in node.children.values():
                if child.page is None and (child.handle is None or not restorable):
                    continue  # hole: nothing below it is borrowable
                ch = _pd.chain_hash(chain, child.tokens)
                cand.append((ch, child.hits, depth + 1))
                stack.append((child, ch, depth + 1))
        return _pd.build(cand, self.page_size, max_bytes)

    def node_stats(self) -> dict:
        """Flat tree accounting for stats()."""
        return {"prefix_nodes": self.prefix_nodes,
                "resident_pages": len(self._node_of),
                "demoted_nodes": len(self._demoted),
                "evicted_pages": self.evicted_pages,
                "demoted_pages": self.demoted_pages,
                "restored_pages": self.restored_pages}


def make_page_manager(num_pages: int, page_size: int, batch_slots: int,
                      max_pages_per_seq: int, prefix_cache: bool = True,
                      **hooks) -> PageManager:
    """Build the serving page manager: the radix tree by default, the flat
    chained-hash PageManager when `RAY_TPU_RADIX=0`."""
    if prefix_cache and radix_enabled():
        return RadixPageManager(num_pages, page_size, batch_slots,
                                max_pages_per_seq, prefix_cache, **hooks)
    return PageManager(num_pages, page_size, batch_slots,
                       max_pages_per_seq, prefix_cache)
