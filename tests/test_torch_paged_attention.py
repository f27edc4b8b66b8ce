"""ray_tpu_torch.ops.paged_attention against ray_tpu.ops.paged_attention on
the CPU: the gather reference and the kernels' split-and-combine arithmetic
(against the Pallas kernel in interpret mode too) on fragmented block
tables, the split plan and the kernels' input guards, the in-place page
writes against JAX's functional ones, and the host-side page managers (flat
and radix) driven through the same allocate / prefix / extend / free
sequence. Attention tolerance 2e-5 (f32; 1e-5 for the split arithmetic);
page writes and tables must be equal."""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu.serve import radix_cache as jradix
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve import radix_cache as tradix


def _random_paged(b, kh, g, d, page, max_pages, lengths, seed=0):
    """Pool + tables where each row's pages are a scrambled draw
    (the fragmented layout of tests/test_paged_attention.py)."""
    rng = np.random.default_rng(seed)
    pool = b * max_pages + 1
    k_pages = rng.normal(size=(kh, pool, page, d)).astype(np.float32)
    v_pages = rng.normal(size=(kh, pool, page, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, pool))
    tables = np.zeros((b, max_pages), np.int32)
    used = 0
    for i in range(b):
        need = -(-lengths[i] // page)
        tables[i, :need] = perm[used:used + need]
        used += need
    q = rng.normal(size=(b, kh * g, d)).astype(np.float32)
    return q, k_pages, v_pages, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("g", [1, 4])
def test_reference_matches_jax_fragmented(g):
    args = _random_paged(3, 2, g, 64, 8, 4, [1, 13, 32])
    want_ref = jpa.paged_attention_reference(*(jnp.asarray(a) for a in args))
    want_kernel = jpa.paged_attention(*(jnp.asarray(a) for a in args), interpret=True)
    t_args = [torch.from_numpy(a) for a in args]
    got = tpa.paged_attention_reference(*t_args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=2e-5)
    # a CPU tensor takes the plain version and launches nothing
    before = tpa.LAUNCHES
    assert torch.equal(tpa.paged_attention(*t_args), got)
    assert tpa.LAUNCHES == before


@pytest.mark.parametrize("per", [1, 3, 4], ids=["per1", "per3", "per_max"])
@pytest.mark.parametrize("g", [1, 4])
def test_split_reference_matches_jax_fragmented(g, per):
    """The kernels' split-and-combine arithmetic against the JAX gather
    reference and the Pallas kernel in interpret mode, on fragmented tables
    of 4 pages of 8 tokens: lengths 1 (every split after the first is
    empty), a page boundary (8), one past it (9) and a full table (32);
    pages_per_split 3 leaves the last split past the table's end.
    Tolerance 1e-5 (f32)."""
    args = _random_paged(4, 2, g, 64, 8, 4, [1, 8, 9, 32], seed=2)
    want_ref = jpa.paged_attention_reference(*(jnp.asarray(a) for a in args))
    want_kernel = jpa.paged_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = tpa.paged_attention_split_reference(*(torch.from_numpy(a) for a in args),
                                              pages_per_split=per)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=1e-5)


def test_split_plan_from_shapes_alone():
    """The plan reads shapes and the SM count, never `lengths` (a device
    tensor in the decode step: reading it would sync the host), covers the
    table with no split wholly past it, and a CPU call launches neither
    pass."""
    assert list(inspect.signature(tpa.split_plan).parameters) == [
        "batch", "kv_heads", "max_pages", "sm_count"]
    assert tpa.split_plan(8, 8, 32, 132) == (8, 4)    # serve batch: 512 CTAs on 132 SMs
    assert tpa.split_plan(66, 8, 32, 132) == (1, 32)  # the batch fills the card alone
    assert tpa.split_plan(1, 8, 4, 132) == (4, 1)     # at most one split per page
    for b, kh, mp, sm in itertools.product((1, 3, 8, 40), (1, 8), (1, 5, 32, 33), (1, 132)):
        n, per = tpa.split_plan(b, kh, mp, sm)
        assert n >= 1 and per >= 1 and n * per >= mp > (n - 1) * per
    args = [torch.from_numpy(a) for a in _random_paged(3, 2, 2, 16, 8, 4, [1, 13, 32])]
    before = (tpa.LAUNCHES, tpa.COMBINE_LAUNCHES)
    got = tpa.paged_attention(*args)
    assert (tpa.LAUNCHES, tpa.COMBINE_LAUNCHES) == before
    assert torch.equal(got, tpa.paged_attention_reference(*args))


@pytest.mark.parametrize("what", ["page", "group", "head_dim"])
def test_kernel_input_guards(what):
    """The kernel's limits: pages up to MAX_PAGE_SIZE tokens, at most
    MAX_GROUP query heads per kv head, head_dim 16/32/64/128."""
    page = tpa.MAX_PAGE_SIZE * 2 if what == "page" else 8
    g = tpa.MAX_GROUP + 1 if what == "group" else 2
    d = 48 if what == "head_dim" else 16
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in
                                  _random_paged(2, 1, g, d, page, 2, [1, page]))
    with pytest.raises(ValueError):
        tpa._check_inputs(q, kp, vp, tables, lengths)
    ok = [torch.from_numpy(a) for a in _random_paged(2, 1, 2, 16, tpa.MAX_PAGE_SIZE, 2,
                                                     [1, 300])]
    tpa._check_inputs(*ok)


def test_full_table_and_page_boundaries():
    """Lengths of 1, a non-multiple of the page and a full table."""
    args = _random_paged(4, 2, 2, 16, 8, 3, [1, 8, 9, 24], seed=1)
    want = jpa.paged_attention_reference(*(jnp.asarray(a) for a in args))
    got = tpa.paged_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _caches(l=2, kh=2, d=8, pages=16, page=4, b=3, mp=4, seed=0):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(l, kh, pages, page, d)).astype(np.float32)
    vp = rng.normal(size=(l, kh, pages, page, d)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, pages))[:mp] for _ in range(b)])
    tables = tables.astype(np.int32)
    lengths = np.zeros((b,), np.int32)
    jc = jpa.PagedKVCache(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp),
                          block_tables=jnp.asarray(tables), lengths=jnp.asarray(lengths))
    tc = tpa.PagedKVCache(k_pages=torch.from_numpy(kp.copy()),
                          v_pages=torch.from_numpy(vp.copy()),
                          block_tables=torch.from_numpy(tables),
                          lengths=torch.from_numpy(lengths))
    return jc, tc, rng


@pytest.mark.parametrize("t", [1, 6], ids=["decode", "prefill"])
def test_write_layer_tokens_matches_jax(t):
    jc, tc, rng = _caches()
    b, kh, d = 3, 2, 8
    k_new = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    v_new = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    starts = np.array([0, 5, 9])
    positions = (starts[:, None] + np.arange(t)[None, :]).astype(np.int32)
    jc = jpa.write_layer_tokens(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(positions))
    out = tpa.write_layer_tokens(tc, 1, torch.from_numpy(k_new),
                                 torch.from_numpy(v_new), torch.from_numpy(positions))
    assert out is tc  # the pool was updated in place
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))


def test_write_tokens_matches_jax():
    jc, tc, rng = _caches(seed=3)
    l, b, t, kh, d = 2, 3, 5, 2, 8
    k_new = rng.normal(size=(l, b, t, kh, d)).astype(np.float32)
    v_new = rng.normal(size=(l, b, t, kh, d)).astype(np.float32)
    positions = np.stack([np.arange(t) + s for s in (0, 3, 10)]).astype(np.int32)
    jc = jpa.write_tokens(jc, jnp.asarray(k_new), jnp.asarray(v_new),
                          jnp.asarray(positions))
    tpa.write_tokens(tc, torch.from_numpy(k_new), torch.from_numpy(v_new),
                     torch.from_numpy(positions))
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))


def test_paged_cache_init():
    c = tpa.PagedKVCache.init(2, 2, 8, num_pages=9, page_size=4, batch_slots=3,
                              max_pages_per_seq=2, dtype=torch.bfloat16, device="cpu")
    assert c.k_pages.shape == (2, 2, 9, 4, 8) and c.k_pages.dtype == torch.bfloat16
    assert c.block_tables.shape == (3, 2) and c.block_tables.dtype == torch.int32
    assert c.page_size == 4 and c.length is c.lengths


def _drive(mgr):
    """One allocate / prefix / register / extend / free / evict sequence;
    returns every observable along the way."""
    ps = mgr.page_size
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, 3 * ps).tolist()
    a = shared + rng.integers(0, 256, 2).tolist()
    b = shared[:2 * ps] + rng.integers(0, 256, ps + 1).tolist()
    seen = []
    row, cached = mgr.allocate_prefix(0, a, len(a) + 4)
    seen.append(("alloc0", row, cached))
    mgr.register_prefix(0, a)
    row, cached = mgr.allocate_prefix(1, b, len(b) + 4)
    seen.append(("alloc1", row, cached))
    mgr.register_prefix(1, b)
    seen.append(("extend0", mgr.extend(0, len(a) + 2 * ps)))
    mgr.free(0)
    row, cached = mgr.allocate_prefix(0, a, len(a) + 1)
    seen.append(("realloc0", row, cached))
    mgr.free(0)
    mgr.free(1)
    seen.append(("fit", mgr.can_fit(mgr.num_pages * ps), mgr.can_fit_prompt(a, len(a))))
    # pool pressure: a big fresh request evicts cached pages
    big = rng.integers(0, 256, 5 * ps).tolist()
    row, cached = mgr.allocate_prefix(2, big, len(big) + ps)
    seen.append(("big", row, cached))
    seen.append(("state", mgr.pages_in_use, mgr.cached_pages, mgr.prefix_hit_tokens,
                 mgr.prefix_query_tokens, sorted(mgr.free_pages),
                 mgr.shared_page_count(2), mgr.table_slice(2, 0, 2)))
    return seen


@pytest.mark.parametrize("kind", ["flat", "radix"])
def test_page_managers_match_jax(kind):
    args = (12, 4, 3, 8)
    if kind == "flat":
        jm, tm = jpa.PageManager(*args), tpa.PageManager(*args)
    else:
        jm, tm = jradix.RadixPageManager(*args), tradix.RadixPageManager(*args)
    assert _drive(tm) == _drive(jm)
    if kind == "radix":
        assert tm.node_stats() == jm.node_stats()


def test_page_manager_errors_match():
    jm, tm = jpa.PageManager(4, 4, 2, 2), tpa.PageManager(4, 4, 2, 2)
    for mgr in (jm, tm):
        with pytest.raises(ValueError):
            mgr.allocate(0, 12)       # 3 pages > max_pages_per_seq
        mgr.allocate(0, 8)
        with pytest.raises(MemoryError):
            mgr.allocate(1, 8)        # only one page left (page 0 reserved)


def test_make_page_manager_env(monkeypatch):
    assert isinstance(tradix.make_page_manager(8, 4, 2, 2), tradix.RadixPageManager)
    monkeypatch.setenv("RAY_TPU_RADIX", "0")
    assert not tradix.radix_enabled()
    mgr = tradix.make_page_manager(8, 4, 2, 2)
    assert type(mgr) is tpa.PageManager
