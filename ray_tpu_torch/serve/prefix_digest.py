"""Prefix-affinity digest: a compact summary of a replica's hot radix-cache
prefixes, for an affinity router.

The port's own copy of `ray_tpu/serve/prefix_digest.py` (which is plain
Python; the port imports no `ray_tpu` module). Publisher and scorer must
agree on the hash, so the chain hashing, the packing and the prefix match
are kept byte-for-byte as in the JAX package: a digest published by a port
replica scores the same as one from a JAX replica. The router's knobs
(`affinity_enabled`, `spill_threshold`) and its scoring (`score_replicas`)
are here too, read by the deployment handle (`serve/handle.py`).

Wire format: a digest is {"page_size": int, "entries": {hash: hits}} where
hash i of a prompt covers token pages 0..i (chained blake2b-64), so
membership of hash i implies the replica holds the ENTIRE leading prefix of
i+1 pages. Entries are truncated hottest-first; because a borrowed chain
bumps every ancestor, parent.hits >= child.hits, so hottest-first (depth
ascending on ties) truncation keeps the kept set prefix-closed and
consecutive-match scoring never breaks at an artificial hole.
"""

import hashlib
import os
import struct
from typing import Dict, List, Optional, Sequence

# packed wire cost: 8-byte chain hash + 4-byte hit count per entry, plus a
# small header (page_size + entry count) — digest_nbytes/pack agree on this
HEADER_BYTES = 16
ENTRY_BYTES = 12
DEFAULT_MAX_BYTES = 4096


def digest_max_bytes() -> int:
    try:
        return int(os.environ.get("RAY_TPU_PREFIX_DIGEST_BYTES",
                                  str(DEFAULT_MAX_BYTES)))
    except ValueError:
        return DEFAULT_MAX_BYTES


def affinity_enabled() -> bool:
    """`RAY_TPU_PREFIX_AFFINITY=0` escape hatch: handles fall back to pure
    p2c routing (read per pick so a bench can flip it mid-process)."""
    return os.environ.get("RAY_TPU_PREFIX_AFFINITY", "1").lower() not in (
        "0", "false", "off")


def spill_threshold() -> int:
    """Queue-depth gap (affinity target vs least-loaded replica) past which
    the router spills a prefix hit back to p2c, so one hot prefix can't
    hotspot a single replica."""
    try:
        return int(os.environ.get("RAY_TPU_PREFIX_SPILL", "4"))
    except ValueError:
        return 4


def max_entries(max_bytes: int) -> int:
    return max(0, (int(max_bytes) - HEADER_BYTES) // ENTRY_BYTES)


def chain_hash(prev: int, tokens: Sequence[int]) -> int:
    """64-bit chained hash of one token page given the previous page's
    chain hash (0 at the root). Stable across processes and runs — no
    PYTHONHASHSEED dependence."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(prev).to_bytes(8, "little"))
    h.update(struct.pack(f"<{len(tokens)}q", *(int(t) for t in tokens)))
    return int.from_bytes(h.digest(), "little")


def prompt_chain_hashes(prompt_ids: Sequence[int],
                        page_size: int) -> List[int]:
    """Chain hash of every FULL leading token page of the prompt; hash i
    covers pages 0..i."""
    toks = [int(t) for t in prompt_ids]
    out = []
    h = 0
    for i in range(len(toks) // page_size):
        h = chain_hash(h, toks[i * page_size:(i + 1) * page_size])
        out.append(h)
    return out


def build(candidates, page_size: int,
          max_bytes: Optional[int] = None) -> Dict:
    """Digest from (chain_hash, hits, depth) triples, truncated to fit
    `max_bytes` hottest-first (depth ascending on ties keeps truncation
    prefix-closed — see module docstring)."""
    if max_bytes is None:
        max_bytes = digest_max_bytes()
    ranked = sorted(candidates, key=lambda c: (-c[1], c[2]))
    cap = max_entries(max_bytes)
    entries = {}
    for h, hits, _depth in ranked[:cap]:
        entries[h] = hits
    return {"page_size": int(page_size), "entries": entries}


def digest_nbytes(digest: Optional[Dict]) -> int:
    """Packed wire size of a digest (what `pack` would produce)."""
    if not digest:
        return 0
    return HEADER_BYTES + ENTRY_BYTES * len(digest.get("entries", {}))


def pack(digest: Dict) -> bytes:
    """Canonical packed form — the size proof behind the <=4 KiB bound
    (tests assert len(pack(d)) == digest_nbytes(d))."""
    entries = digest.get("entries", {})
    out = [struct.pack("<qii", int(digest.get("page_size", 0)),
                       len(entries), 0)]
    for h, hits in sorted(entries.items()):
        out.append(struct.pack("<QI", h & (2 ** 64 - 1),
                               min(int(hits), 2 ** 32 - 1)))
    return b"".join(out)


def match_depth(digest: Optional[Dict], chain_hashes: Sequence[int]) -> int:
    """Deepest consecutive prefix match: number of leading page hashes
    present in the digest. Deterministic given a fixed digest set."""
    if not digest:
        return 0
    entries = digest.get("entries")
    if not entries:
        return 0
    depth = 0
    for h in chain_hashes:
        if h not in entries:
            break
        depth += 1
    return depth


def score_replicas(digests: Dict[int, Dict], prompt_ids: Sequence[int],
                   ) -> List[tuple]:
    """(matched_pages, replica_idx) for every replica with a digest, idx
    ascending — the handle layers load tie-breaks on top. Prompt hashes are
    computed once per distinct page size (one deployment normally has one)."""
    by_ps: Dict[int, List[int]] = {}
    out = []
    for idx in sorted(digests):
        dg = digests[idx]
        if not dg:
            continue
        ps = int(dg.get("page_size") or 0)
        if ps <= 0:
            continue
        hashes = by_ps.get(ps)
        if hashes is None:
            hashes = prompt_chain_hashes(prompt_ids, ps)
            by_ps[ps] = hashes
        out.append((match_depth(dg, hashes), idx))
    return out
