"""The KV stash and the shipment plane of the port (serve/kv_transfer.py,
_private/object_store.py) and their wiring into the radix cache and the
serving engine, against the JAX package on the CPU.

- RadixPageManager: a demoted page's payload comes back bit-identical on
  the next match and counts as cached tokens; a refused restore truncates
  the match (the counterparts of tests/test_radix_cache.py's cases), with
  the `radix_*` registry tallies.
- KVPageStash: put, spill past the shm budget, restore, in f32 and bf16,
  byte for byte, with the same tier accounting as JAX's stash.
- ShipWriter / ShipReader: one segment over each of the three rungs.
- LLMServer: a wave over families of long shared prefixes on a pool a
  quarter of its working set: ids equal JAX's and those of a pool that
  never evicts, restored pages bit-equal, radix_counters() and the stash's
  tier_stats() equal JAX's under the same environment.
- The demotion default and condition match JAX's: with RAY_TPU_SPILL_KV
  unset a radix server builds a stash; with RAY_TPU_RADIX=0 or
  RAY_TPU_SPILL_KV=0 it builds none, and nothing raises."""

import asyncio
from multiprocessing import shared_memory

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.serve import kv_transfer as jkv
from ray_tpu.serve import llm as jllm
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch._private import object_store as tstore
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.serve import kv_transfer as tkv
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.radix_cache import RadixPageManager
from ray_tpu_torch.util import metrics as tmetrics

PS = 4  # tokens per page of the manager-level cases


@pytest.fixture
def clean_registries():
    jmetrics.clear_registry()
    tmetrics.clear_registry()
    yield
    jmetrics.clear_registry()
    tmetrics.clear_registry()


def _mgr(num_pages=16, slots=8, max_seq=16, **hooks):
    return RadixPageManager(num_pages, PS, slots, max_seq, True, **hooks)


def _prompt(*pages, tail=1):
    """Token ids for len(pages) full pages plus `tail` extra tokens."""
    toks = []
    for p in pages:
        toks.extend(range(p * 100, p * 100 + PS))
    toks.extend(range(9000, 9000 + tail))
    return toks


def test_demote_restore_bit_identical(clean_registries):
    """An evicted page's payload is extracted at demotion and restored
    bit-identically into a fresh pool page on the next matching request;
    restored pages count as cached tokens."""
    device, stash = {}, {}
    seq = iter(range(10 ** 6))

    def demote(pid, node):
        h = next(seq)
        stash[h] = device.pop(pid).clone()
        return h

    def restore(h, pid):
        device[pid] = stash[h].clone()
        return True

    m = _mgr(num_pages=8, demote_cb=demote, restore_cb=restore,
             drop_cb=lambda h: stash.pop(h, None))
    a = _prompt(1, 2)
    m.allocate_prefix(0, a, len(a))
    for pid in m.tables[0]:
        device[pid] = torch.from_numpy(np.random.default_rng(pid).normal(size=(PS, 8)))
    payloads = [device[pid].clone() for pid in m.tables[0][:2]]
    m.register_prefix(0, a)
    m.free(0)

    # drain the pool: 7 pages needed, so every published page demotes
    big = _prompt(8, 9, 10, tail=4 * PS)
    m.allocate_prefix(1, big, 7 * PS)
    assert m.demoted_pages >= 2
    m.free(1)

    _, cached = m.allocate_prefix(2, a, len(a))
    assert cached == 2 * PS
    assert m.restored_pages == 2
    for want, pid in zip(payloads, m.tables[2][:2]):
        assert torch.equal(device[pid], want)
    got = tmetrics.radix_counters()
    assert got == {"prefix_nodes": m.prefix_nodes, "hit_tokens": 2 * PS,
                   "query_tokens": len(a) * 2 + len(big),
                   "evicted_pages": m.evicted_pages, "demoted_pages": m.demoted_pages,
                   "restored_pages": 2}


def test_restore_failure_truncates_match():
    """A refused restore degrades to a shorter cached prefix: the request
    prefills from the break instead of failing."""
    calls = []

    def restore(h, pid):
        calls.append(pid)
        return False

    m = _mgr(num_pages=8, demote_cb=lambda pid, node: "h", restore_cb=restore)
    a = _prompt(1, 2)
    m.allocate_prefix(0, a, len(a))
    m.register_prefix(0, a)
    m.free(0)
    big = _prompt(8, 9, 10, tail=4 * PS)
    m.allocate_prefix(1, big, 7 * PS)
    m.free(1)

    _, cached = m.allocate_prefix(2, a, len(a))
    assert calls and cached == 0          # restore refused: full prefill
    m.register_prefix(2, a)               # the fresh prefill re-publishes
    m.free(2)
    _, cached2 = m.allocate_prefix(3, a, len(a))
    assert cached2 == 2 * PS


@pytest.mark.parametrize("hook", ["demote", "restore"])
def test_hook_failure_raises_and_keeps_the_pool(hook):
    """A stash that fails is not carried on without: the hook's error
    reaches the caller, and no pool page is lost."""
    def broken(*a):
        raise OSError("stash unavailable")

    hooks = dict(demote_cb=lambda pid, node: "h", restore_cb=lambda h, pid: True)
    hooks[f"{hook}_cb"] = broken
    m = _mgr(num_pages=8, **hooks)
    a = _prompt(1, 2)
    m.allocate_prefix(0, a, len(a))
    m.register_prefix(0, a)
    m.free(0)
    big = _prompt(8, 9, 10, tail=4 * PS)
    if hook == "restore":
        m.allocate_prefix(1, big, 7 * PS)
        m.free(1)
    free = sorted(m.free_pages)
    with pytest.raises(OSError):
        m.allocate_prefix(2, big if hook == "demote" else a, 7 * PS)
    assert sorted(m.free_pages) == free and not m.tables[2]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kv_page_stash_roundtrip_two_tiers(dtype, clean_registries):
    """put -> (budget pressure: shm -> disk) -> get promotes and round-trips
    byte for byte; the tiers account as JAX's stash does on the same
    pages, and the spill I/O lands in the metrics."""
    gen = torch.Generator().manual_seed(0)
    k1 = torch.randn((2, 3, PS, 8), generator=gen).to(dtype)
    v1 = torch.randn((2, 3, PS, 8), generator=gen).to(dtype)
    k2, v2 = k1 * 2, v1 * 2
    one_page = 2 * k1.numel() * k1.element_size()
    stashes = (tkv.KVPageStash(budget_bytes=one_page + 16),
               jkv.KVPageStash(budget_bytes=one_page + 16))
    tstash, jstash = stashes
    try:
        h1 = tstash.put(k1, v1)
        jh1 = jstash.put(_to_numpy(k1), _to_numpy(v1))
        h2 = tstash.put(k2, v2)           # budget: h1 spills to disk
        jh2 = jstash.put(_to_numpy(k2), _to_numpy(v2))
        ts = tstash.tier_stats()
        assert ts == jstash.tier_stats()
        assert ts["disk_objects"] == 1 and ts["shm_objects"] == 1, ts
        assert h1["dtype"] == jh1["dtype"] and h1["nbytes"] == jh1["nbytes"]

        gk, gv = tstash.get(h1)           # disk -> shm promotion
        jstash.get(jh1)
        assert gk.dtype == dtype and torch.equal(gk, k1) and torch.equal(gv, v1)
        gk2, gv2 = tstash.get(h2)
        jstash.get(jh2)
        assert torch.equal(gk2, k2) and torch.equal(gv2, v2)
        assert tstash.tier_stats() == jstash.tier_stats()
        tiers = {m["name"]: m for m in tmetrics.collect()}
        assert tiers["store_tier_disk_objects"]["values"] == {(("owner", "kv_stash"),): 1.0}
        for kind in ("spill", "restore"):
            assert tmetrics._counter_total(f"{kind}_bytes_total") >= one_page
        ops = {dict(k)["op"] for k in tiers["spill_restore_ms"]["count"]}
        assert ops == {"spill", "restore"}
        for stash, handles in ((tstash, (h1, h2)), (jstash, (jh1, jh2))):
            for h in handles:
                stash.drop(h)
        assert tstash.tier_stats() == jstash.tier_stats() == {
            "shm_objects": 0, "shm_bytes": 0, "disk_objects": 0, "disk_bytes": 0}
    finally:
        for s in stashes:
            s.close()


def test_ship_segment_over_every_rung(monkeypatch):
    """One bf16 segment published by a ShipWriter reaches a ShipReader by
    same-host attach, by ranged streams from the KVDataServer, and by the
    RPC fetch, byte for byte; a dropped shipment's segment is gone."""
    writer, reader = tkv.ShipWriter(), tkv.ShipReader()
    gen = torch.Generator().manual_seed(1)
    L, Kh, n, ps, D = 2, 2, 3, 16, 16
    k = torch.randn((L, Kh, n, ps, D), generator=gen).bfloat16()
    v = torch.randn((L, Kh, n, ps, D), generator=gen).bfloat16()
    ship = tkv.new_ship_id()
    seg = writer.publish(ship, 0, k, v, page_start=1)
    assert seg["nbytes"] == 2 * k.numel() * 2 and seg["n_pages"] == n
    assert len(ship) == 12 and len(seg["oid"]) == len(seg["wire"]) == 16

    async def rpc(oid):
        return writer.read_segment(oid)

    async def pull(attach, data):
        monkeypatch.setenv("RAY_TPU_KV_ATTACH", "1" if attach else "0")
        server = tkv.KVDataServer(writer)
        addr = await server.start() if data else None
        try:
            att = await reader.fetch(seg, (L, Kh, ps, D), "bfloat16", addr, rpc_fetch=rpc)
            try:
                return torch.equal(att.k, k) and torch.equal(att.v, v)
            finally:
                att.close()
        finally:
            server.close()

    for attach, data, counter in ((True, True, "attach_hits"),
                                  (False, True, "stream_pulls"),
                                  (False, False, "rpc_pulls")):
        before = tmetrics.kv_ship_counters()[counter]
        assert asyncio.run(pull(attach, data)), counter
        assert tmetrics.kv_ship_counters()[counter] == before + 1, counter
    assert not tstore.StoreClient().exists(seg["wire"])   # the pulled copy was unlinked
    writer.drop_ship(ship)
    assert not tstore.StoreClient().exists(seg["oid"])
    writer.close()


def test_segment_namespace_and_tracker_filter(monkeypatch):
    """The port's segments have a name prefix of their own, and its
    resource_tracker filter hands every other name to the function it
    wrapped."""
    from ray_tpu._private import object_store as jstore
    assert tstore.seg_name("x").startswith("rtpt-")
    assert jstore.seg_name("x").startswith("rtpu-")
    seen = []
    monkeypatch.setattr(tstore, "_orig_register", lambda name, rtype: seen.append(name))
    tstore._filtered_register("/rtpt-0123", "shared_memory")
    tstore._filtered_register("/psm_0123", "shared_memory")
    tstore._filtered_register("/rtpt-0123", "semaphore")
    assert seen == ["/psm_0123", "/rtpt-0123"]
    store = tstore.StoreClient()
    oid = f"ns-check{tkv._proc_tag}"     # ids of this process only
    store.put_raw(oid, b"abc")
    try:
        shm = shared_memory.SharedMemory(name=tstore.seg_name(oid))
        assert bytes(shm.buf[:3]) == b"abc"
        shm.close()
    finally:
        store.delete_segment(oid)
    assert not store.exists(oid)


# --------------------------------------------------------- server level
F, PREFIX, TAIL = 4, 64, 4            # families, prefix tokens (4 pages), tail


def _srv_cfg(mod, **kw):
    cfg = dict(preset="tiny", max_batch_slots=2, max_seq_len=128, paged=True,
               page_size=16, prefill_chunk=32, seed=0, param_dtype="float32",
               dtype="float32")
    if mod is tllm:
        cfg["device"] = "cpu"
    cfg.update(kw)
    return mod.LLMConfig(**cfg)


def _families():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 256, PREFIX).tolist() for _ in range(F)]


def _visit(srv, fam, r, f):
    tail = [(7 * r + 3 * f + i) % 250 + 1 for i in range(TAIL)]
    return asyncio.run(srv.generate(fam + tail, max_tokens=2))["tokens"]


def _pages(srv, prompt):
    """(k, v) of the resident radix pages of `prompt`'s full pages."""
    pids = [n.page for n in srv.page_mgr._walk(prompt)]
    assert None not in pids
    idx = torch.tensor(pids)
    return srv.cache.k_pages[:, :, idx].clone(), srv.cache.v_pages[:, :, idx].clone()


def test_server_wave_demotes_restores_like_jax(monkeypatch, clean_registries):
    """Families of 4-page prefixes visited round-robin (one cold round, two
    more) on a pool of 5 usable pages, a quarter of the 16-page working
    set, with an shm budget of 4 pages so the stash also spills to disk."""
    page_bytes = 2 * 2 * 2 * 16 * 16 * 4       # k + v, [L=2, Kh=2, ps=16, D=16] f32
    monkeypatch.setenv("RAY_TPU_SPILL_STASH_BYTES", str(4 * page_bytes))
    monkeypatch.delenv("RAY_TPU_SPILL_KV", raising=False)
    monkeypatch.delenv("RAY_TPU_RADIX", raising=False)
    fams = _families()
    jsrv = jllm.LLMServer(_srv_cfg(jllm, num_pages=6))
    sd = flax_to_state_dict(jax.device_get(jsrv.params))
    tsrv = tllm.LLMServer(_srv_cfg(tllm, num_pages=6), params=sd)
    ids, counters, disk_seen, snaps = [], [], [], []
    for srv, mod in ((jsrv, jmetrics), (tsrv, tmetrics)):
        out, disk = [], 0
        for r in range(3):
            for f, fam in enumerate(fams):
                out.append(_visit(srv, fam, r, f))
                if srv is tsrv and f == 0 and r < 2:
                    snaps.append(_pages(srv, fam))   # cold, then restored
                disk = max(disk, srv.stats()["radix"]["stash"]["disk_objects"])
        ids.append(out)
        counters.append(mod.radix_counters())
        disk_seen.append(disk)
    assert ids[1] == ids[0]
    assert counters[1] == counters[0]
    assert counters[1]["demoted_pages"] > 0 and counters[1]["restored_pages"] > 0
    assert disk_seen[1] == disk_seen[0] > 0
    ts, js = tsrv.stats(), jsrv.stats()
    assert ts["radix"] == js["radix"]
    assert ts["radix"]["stash"].keys() == js["radix"]["stash"].keys()
    assert ts["slo"]["spill_restore_ms"]["count"] > 0
    (k0, v0), (k1, v1) = snaps
    assert torch.equal(k1, k0) and torch.equal(v1, v0)

    # a pool that never evicts: every re-visit is a resident hit
    resident = tllm.LLMServer(_srv_cfg(tllm, num_pages=F * 4 + 5), params=sd)
    want = [_visit(resident, fam, r, f) for r in range(3) for f, fam in enumerate(fams)]
    assert resident.stats()["radix"]["evicted_pages"] == 0
    assert ids[1] == want


@pytest.mark.parametrize("env,stash", [
    ({}, True),
    ({"RAY_TPU_SPILL_KV": "0"}, False),
    ({"RAY_TPU_RADIX": "0", "RAY_TPU_SPILL_KV": "1"}, False),
    ({"RAY_TPU_SPILL_KV": "1", "prefix_cache": False}, False),
], ids=["default", "spill-off", "flat-cache", "no-prefix-cache"])
def test_stash_default_and_condition_match_jax(env, stash, monkeypatch):
    """JAX builds the stash when prefix_cache, radix and demotion are all
    on, demotion by default; so does the port, and no combination raises."""
    monkeypatch.delenv("RAY_TPU_SPILL_KV", raising=False)
    monkeypatch.delenv("RAY_TPU_RADIX", raising=False)
    env = dict(env)
    prefix_cache = env.pop("prefix_cache", True)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jsrv = jllm.LLMServer(_srv_cfg(jllm, prefix_cache=prefix_cache))
    tsrv = tllm.LLMServer(_srv_cfg(tllm, prefix_cache=prefix_cache),
                          params=flax_to_state_dict(jax.device_get(jsrv.params)))
    assert (tsrv._kv_stash is not None) == (jsrv._kv_stash is not None) == stash
    ts, js = tsrv.stats(), jsrv.stats()
    assert ("stash" in ts.get("radix", {})) == ("stash" in js.get("radix", {})) == stash
    p = list(range(3, 40))
    assert _visit(tsrv, p, 0, 0) == _visit(jsrv, p, 0, 0)
