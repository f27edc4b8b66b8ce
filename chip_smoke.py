#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; a failing phase raises and the script exits non-zero:

1. device  - the card's name and power limit (nvidia-smi) and torch's view.
2. build   - nvcc builds every kernel under ray_tpu_torch/ops/csrc/.
3. kernels - each hand kernel against its plain PyTorch version on the
             card, on numpy-seeded inputs, with stated tolerances; then
             each is timed on the device (CUDA events around a CUDA-graph
             replay of back-to-back calls, host cost excluded; the eager
             per-call time is logged beside it) with its plain version, the
             least time the card could take (bound) and, where one exists,
             a single PyTorch call computing the same function.
4. model   - the llama_1b decoder in f32: logits through the kernels (paged
             prefill and decode) against logits through the plain dense
             cache path, on one prompt.
5. slice   - the paged LLMServer at llama_1b width and depth, seeded random
             weights, serving requests through generate and generate_stream
             under asyncio; the kernel launch counters are reset just
             before and read just after, and must match layers x calls.

It prints a `kernels` JSON line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Details go to chip_smoke_out/chip_smoke.json.
It needs one CUDA card and exits non-zero without one.
"""

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12               # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core rate
              "float32": 67e12}         # f32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max-abs vs the plain version in f32
OUT_DIR = Path(__file__).resolve().parent / "chip_smoke_out"


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, iters=100, warmup=3):
    """Device time of one fn() call: `iters` calls captured in one CUDA graph
    and replayed between two CUDA events, so the host's per-call cost (the
    Python wrapper and its checks) is not counted."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_eager_ms(fn, iters=100, warmup=10):
    """Time per call of back-to-back eager calls, host cost included: what
    the serving loop pays per launch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels
def flash_inputs(rng, b, t, h, kh, d, dtype, device="cuda"):
    import torch
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        device, dtype)
    return mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


def check_flash(rng, record, device="cuda"):
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for causal in (True, False):
            for g, kh in ((1, 32), (4, 8)):
                for t in (16, 100, 128, 2048):
                    q, k, v = flash_inputs(rng, 1, t, 32, kh, 64, dtype, device)
                    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
                    ref, ref_lse = fa.flash_attention_reference(
                        q.float(), k.float(), v.float(), causal, return_lse=True)
                    err = (out.float() - ref).abs().max().item()
                    lse_err = (lse - ref_lse).abs().max().item()
                    ok = err <= TOL[name] and lse_err <= TOL["float32"] * 10
                    record.append(dict(kernel="flash_fwd", dtype=name, causal=causal,
                                       group=g, T=t, max_abs_err=err,
                                       lse_max_abs_err=lse_err, ok=ok))
                    if not ok:
                        raise AssertionError(f"flash_fwd {name} causal={causal} G={g} "
                                             f"T={t}: err {err}, lse err {lse_err}")
                    worst = max(worst, err)
    for d in (16, 32, 128):  # the other head dims the kernel is built for
        q, k, v = flash_inputs(rng, 2, 100, 8, 2, d, torch.bfloat16, device)
        out = fa.flash_attention(q, k, v, causal=True)
        ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), True)
        err = (out.float() - ref).abs().max().item()
        record.append(dict(kernel="flash_fwd", dtype="bfloat16", causal=True, group=4,
                           T=100, head_dim=d, max_abs_err=err, ok=err <= TOL["bfloat16"]))
        if err > TOL["bfloat16"]:
            raise AssertionError(f"flash_fwd head_dim {d}: err {err}")
    if device == "cuda":  # no backward kernel yet: a grad-tracking call raises
        q, k, v = flash_inputs(rng, 1, 16, 32, 8, 64, torch.bfloat16, device)
        try:
            fa.flash_attention(q.requires_grad_(), k, v)
        except NotImplementedError:
            pass
        else:
            raise AssertionError("flash_attention ran a grad-tracking call")
    log(f"[kernels] flash_fwd: {len([r for r in record if r['kernel'] == 'flash_fwd'])} "
        f"cases within tolerance (f32 {TOL['float32']}, bf16 {TOL['bfloat16']}), "
        f"worst {worst:.3e}")
    return worst


def paged_inputs(rng, b, kh, g, d, page, max_pages, lengths, dtype, device="cuda"):
    """Pool + fragmented tables: each row's pages are a scrambled draw."""
    import torch
    pool = b * max_pages + 1
    k_pages = rng.standard_normal((kh, pool, page, d), dtype=np.float32)
    v_pages = rng.standard_normal((kh, pool, page, d), dtype=np.float32)
    perm = rng.permutation(np.arange(1, pool))
    tables = np.zeros((b, max_pages), np.int32)
    used = 0
    for i in range(b):
        need = -(-int(lengths[i]) // page)
        tables[i, :need] = perm[used:used + need]
        used += need
    q = rng.standard_normal((b, kh * g, d), dtype=np.float32)
    cu = lambda x, dt=dtype: torch.from_numpy(x).to(device, dt)
    return (cu(q), cu(k_pages), cu(v_pages), cu(tables, torch.int32),
            cu(np.asarray(lengths, np.int32), torch.int32))


def check_paged(rng, record, device="cuda"):
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    lengths = [1, 64, 100, 2048, 777, 129, 63, 1500]  # 2048 fills the table
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for g in (1, 4):
            q, kp, vp, tb, ln = paged_inputs(rng, 8, 8, g, 64, 64, 32, lengths, dtype,
                                             device)
            out = pa.paged_attention(q, kp, vp, tb, ln)
            ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), tb, ln)
            err = (out.float() - ref).abs().max().item()
            ok = err <= TOL[name]
            record.append(dict(kernel="paged_decode", dtype=name, group=g,
                               lengths=lengths, max_abs_err=err, ok=ok))
            if not ok:
                raise AssertionError(f"paged_decode {name} G={g}: err {err}")
            worst = max(worst, err)
    # other head dims, the largest group, another page size, f32
    for d, g, page in ((16, 2, 16), (32, 1, 32), (128, 8, 16)):
        lens = [1, 5, 17, 3 * page]
        q, kp, vp, tb, ln = paged_inputs(rng, 4, 2, g, d, page, 3, lens,
                                         torch.float32, device)
        out = pa.paged_attention(q, kp, vp, tb, ln)
        err = (out - pa.paged_attention_reference(q, kp, vp, tb, ln)).abs().max().item()
        record.append(dict(kernel="paged_decode", dtype="float32", group=g, head_dim=d,
                           page=page, lengths=lens, max_abs_err=err,
                           ok=err <= TOL["float32"]))
        if err > TOL["float32"]:
            raise AssertionError(f"paged_decode D={d} G={g} page={page}: err {err}")
    log(f"[kernels] paged_decode: 7 cases within tolerance, worst {worst:.3e}")
    return worst


def time_flash(rng, t):
    """B1 at a prefill chunk of the slice: B=1, H=32, Kh=8, D=64, bf16."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    b, h, kh, d = 1, 32, 8, 64
    q, k, v = flash_inputs(rng, b, t, h, kh, d, torch.bfloat16)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    eager_ms = time_eager_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                       iters=5 if t > 1024 else 20)
    # yardstick only: one library call on the same inputs ([B, H, T, D],
    # kv heads expanded outside the timed region)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bytes_moved = 2 * (2 * b * t * h * d + 2 * b * t * kh * d) + 4 * b * h * t
    flops = 4 * d * h * b * t * (t + 1) // 2
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    return dict(T=t, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def time_paged(rng, lengths):
    """B4 at the slice's decode batch: B=8, H=32, Kh=8, D=64, page 64, bf16."""
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    b, kh, g, d, page, max_pages = 8, 8, 4, 64, 64, 32
    q, kp, vp, tb, ln = paged_inputs(rng, b, kh, g, d, page, max_pages, lengths,
                                     torch.bfloat16)
    ms = time_ms(lambda: pa.paged_attention(q, kp, vp, tb, ln))
    eager_ms = time_eager_ms(lambda: pa.paged_attention(q, kp, vp, tb, ln))
    plain_ms = time_ms(lambda: pa.paged_attention_reference(q, kp, vp, tb, ln), iters=20)
    tokens = int(sum(lengths))
    bytes_moved = (2 * 2 * b * kh * g * d          # q in, out
                   + 2 * 2 * tokens * kh * d       # K and V of the valid tokens
                   + 4 * b * max_pages + 4 * b)    # tables, lengths
    flops = 4 * tokens * kh * g * d
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    return dict(lengths=list(lengths), ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


# ------------------------------------------------------------------ model
def check_model(server, device="cuda"):
    """llama_1b in f32: the kernel path (paged chunk-local prefill through
    B1, one decode step through B4) against the plain dense-cache path
    (decode_attention) on the same weights and a 100-token prompt."""
    import dataclasses
    import torch
    from ray_tpu_torch.models.llama import KVCache, Llama
    from ray_tpu_torch.ops.paged_attention import PagedKVCache

    cfg = dataclasses.replace(server.model_cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    model = Llama(cfg, device=device)
    model.load_state_dict(server.model.state_dict())
    model.requires_grad_(False)
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 100))).to(device)
    with torch.no_grad():
        dense = KVCache.init(cfg, 1, 256, device=device)
        logits_d, dense = model(prompt, cache=dense)
        nxt = logits_d[:, -1].argmax(-1, keepdim=True)
        step_d, _ = model(nxt, cache=dense)
        paged = PagedKVCache.init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 5, 64,
                                  1, 4, dtype=torch.float32, device=device)
        paged.block_tables[0] = torch.tensor([3, 1, 4, 2], dtype=torch.int32)
        logits_p, paged = model(prompt, cache=paged, paged_chunk_local=True)
        step_p, _ = model(nxt, cache=paged)
    err_prefill = (logits_p - logits_d).abs().max().item()
    err_step = (step_p - step_d).abs().max().item()
    finite = bool(torch.isfinite(logits_p).all() and torch.isfinite(step_p).all())
    tol = 1e-3
    log(f"[model] llama_1b f32 kernel path vs plain path: prefill logits max-abs "
        f"{err_prefill:.3e}, decode-step logits max-abs {err_step:.3e} (tol {tol})")
    if not (finite and err_prefill <= tol and err_step <= tol):
        raise AssertionError(f"model check failed: finite={finite}, "
                             f"prefill {err_prefill}, step {err_step}")
    del model, dense, paged
    return dict(prefill_max_abs_err=err_prefill, step_max_abs_err=err_step, tol=tol)


# ------------------------------------------------------------------ slice
def slice_prompts(vocab):
    """Wave 1: 8 fresh prompts (17..300 tokens; 129+ are multi-chunk),
    one of them opening with a 256-token prefix. Wave 2, after wave 1
    finished: that prefix again with another tail (a radix hit that
    prefills through the continuation path), and one fresh prompt."""
    rng = np.random.default_rng(1234)
    ids = lambda n: rng.integers(1, vocab, n).tolist()
    shared = ids(256)
    wave1 = [ids(n) for n in (17, 40, 64, 100, 128, 129, 200)] + [shared + ids(44)]
    wave2 = [shared + ids(30), ids(77)]
    return wave1, wave2


async def serve_wave(server, prompts, max_tokens):
    async def via_generate(p):
        t0 = time.perf_counter()
        out = await server.generate(p, max_tokens=max_tokens)
        return out["tokens"], out["ttft_s"], time.perf_counter() - t0

    async def via_stream(p):
        t0 = time.perf_counter()
        toks, ttft = [], None
        async for tok in server.generate_stream(p, max_tokens=max_tokens):
            if ttft is None:
                ttft = time.perf_counter() - t0
            toks.append(tok)
        return toks, ttft, time.perf_counter() - t0

    return await asyncio.gather(*[
        (via_generate if i % 2 == 0 else via_stream)(p) for i, p in enumerate(prompts)])


def run_slice(preset="llama_1b", device="cuda"):
    import torch
    from ray_tpu_torch.models.llama import llama_param_count
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    cfg = LLMConfig(preset=preset, paged=True, page_size=64, max_batch_slots=8,
                    max_seq_len=2048, decode_chunk=8, device=device, seed=0)
    t0 = time.perf_counter()
    server = LLMServer(cfg)
    mc = server.model_cfg
    log(f"[slice] {preset}: d_model {mc.d_model}, {mc.n_layers} layers, "
        f"{mc.n_heads}/{mc.n_kv_heads} heads, head_dim {mc.head_dim}, "
        f"{llama_param_count(mc) / 1e6:.1f}M params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    model_check = check_model(server, device)

    # warm-up request (cuBLAS handles, allocator); its stats are subtracted
    asyncio.run(serve_wave(server, [list(range(1, 50))], 8))
    before = server.stats()
    wave1, wave2 = slice_prompts(mc.vocab_size)
    max_tokens = 32

    fa.LAUNCHES = 0
    pa.LAUNCHES = 0
    t0 = time.perf_counter()
    res = asyncio.run(serve_wave(server, wave1, max_tokens))
    res += asyncio.run(serve_wave(server, wave2, max_tokens))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.LAUNCHES, "paged_decode": pa.LAUNCHES}
    after = server.stats()

    dec_a, dec_b = after["decode"], before["decode"]
    tokens = dec_a["tokens"] - dec_b["tokens"]
    syncs = dec_a["host_syncs"] - dec_b["host_syncs"]
    decode_s = dec_a["chunk_s_total"] - dec_b["chunk_s_total"]
    steps = sum(int(k) * (v - dec_b["chunk_sizes"].get(k, 0))
                for k, v in dec_a["chunk_sizes"].items())
    fresh = after["prefill"]["chunk_local"] - before["prefill"]["chunk_local"]
    hit = after["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    n_req = len(wave1) + len(wave2)
    L = mc.n_layers

    for toks, _, _ in res:
        if len(toks) != max_tokens or not all(0 <= t < mc.vocab_size for t in toks):
            raise AssertionError(f"bad request output: {len(toks)} tokens {toks[:8]}...")
    checks = {
        "flash launches == layers x fresh first chunks": launches["flash_fwd"] == L * fresh,
        "every fresh prompt took the chunk-local path": fresh == n_req - 1,
        "paged launches == layers x decode steps": launches["paged_decode"] == L * steps,
        "both kernels launched": launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
        "radix prefix hit of the shared 256 tokens": hit >= 256,
        "host syncs below tokens (fused chunks)": syncs < tokens,
    }
    for what, ok in checks.items():
        log(f"[slice] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: launches {launches}, steps {steps}, "
                             f"fresh {fresh}, hit {hit}, syncs {syncs}, tokens {tokens}")
    ttft = sorted(r[1] for r in res)
    summary = dict(requests=n_req, max_tokens=max_tokens,
                   prompt_lens=[len(p) for p in wave1 + wave2],
                   ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
                   decode_tokens=tokens, decode_host_syncs=syncs,
                   decode_steps=steps, decode_s=decode_s,
                   decode_tokens_per_s=tokens / decode_s if decode_s else None,
                   wall_s=wall, launches=launches, fresh_first_chunks=fresh,
                   prefix_hit_tokens=hit, model_check=model_check,
                   stats=after)
    log(f"[slice] {n_req} requests x {max_tokens} tokens in {wall:.2f} s: "
        f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms, decode "
        f"{summary['decode_tokens_per_s']:.1f} tokens/s over {syncs} host syncs "
        f"for {tokens} emitted tokens ({steps} steps)")
    log(f"[slice] stats: {json.dumps(after['decode'])}")
    if device == "cuda":
        summary["profile"] = profile_wave(server, mc.vocab_size)
    return summary


def profile_wave(server, vocab, max_tokens=16):
    """One more wave of 8 fresh prompts under torch.profiler: the device's
    busy share of the wall time and the kernels that fill it. The
    profiler's own cost is inside the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(99)
    prompts = [rng.integers(1, vocab, n).tolist()
               for n in (17, 40, 64, 100, 128, 129, 200, 300)]
    before = server.stats()["decode"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(serve_wave(server, prompts, max_tokens))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = server.stats()["decode"]
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    steps = sum(int(k) * (v - before["chunk_sizes"].get(k, 0))
                for k, v in after["chunk_sizes"].items())
    out = dict(wall_s=wall, device_kernel_s=device_us / 1e6,
               busy_share=(device_us / 1e6 / wall) if device_us else "not measured",
               launches=sum(e.count for e in kernels), decode_steps=steps,
               decode_s=after["chunk_s_total"] - before["chunk_s_total"],
               top=[dict(name=e.key[:90], calls=e.count,
                         device_ms=e.self_device_time_total / 1e3) for e in top])
    share = f"{out['busy_share']:.4f}" if device_us else "not measured"
    log(f"[profile] 8 requests x {max_tokens} tokens under torch.profiler: wall "
        f"{wall:.3f} s, device kernels {device_us / 1e6:.3f} s (busy share {share}), "
        f"{out['launches']} kernel launches, {steps} decode steps")
    for row in out["top"]:
        log(f"[profile]   {row['device_ms']:9.3f} ms {row['calls']:6d} x {row['name']}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{kind} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(_build.build_log)

    rng = np.random.default_rng(0)
    cases = []
    flash_err = check_flash(rng, cases)
    paged_err = check_paged(rng, cases)
    flash_t = {t: time_flash(rng, t) for t in (16, 128, 2048)}
    for t, r in flash_t.items():
        log(f"[kernels] flash_fwd T={t}: {r['ms']:.4f} ms (eager call {r['eager_ms']:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")

    summary = run_slice()
    # B4 timed at the slice's decode batch: prompt lengths + 16 generated
    paged_t = time_paged(rng, [n + 16 for n in summary["prompt_lens"][:8]])
    log(f"[kernels] paged_decode B=8: {paged_t['ms']:.4f} ms (eager call "
        f"{paged_t['eager_ms']:.4f}), plain "
        f"{paged_t['plain_ms']:.4f} ms, bound {paged_t['bound_ms']:.5f} ms "
        f"({paged_t['bound_by']})")

    main_t = flash_t[128]  # the default prefill_chunk bucket
    kernels = [
        dict(name="flash_fwd", route="cuda", source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:37",
             launches=summary["launches"]["flash_fwd"], max_abs_err=flash_err,
             ms=main_t["ms"], plain_ms=main_t["plain_ms"], bound_ms=main_t["bound_ms"],
             bound_by=main_t["bound_by"], library_ms=main_t["library_ms"]),
        dict(name="paged_decode", route="cuda",
             source="ray_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:38",
             launches=summary["launches"]["paged_decode"], max_abs_err=paged_err,
             ms=paged_t["ms"], plain_ms=paged_t["plain_ms"], bound_ms=paged_t["bound_ms"],
             bound_by=paged_t["bound_by"], library_ms=None),
    ]
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=_build.build_seconds, cases=cases,
        flash_timing=list(flash_t.values()), paged_timing=paged_t,
        slice=summary, kernels=kernels), indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
