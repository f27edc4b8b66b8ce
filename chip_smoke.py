#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; a failing phase raises and the script exits non-zero:

1. device  - the card's name and power limit (nvidia-smi) and torch's view.
2. build   - nvcc builds every kernel under ray_tpu_torch/ops/csrc/; then
             cuobjdump -sass counts the tensor-core instructions (HMMA,
             HGMMA) of every kernel: the bf16 flash forward and dQ kernels
             must have HGMMA (wgmma) and dK/dV HMMA (mma.sync) at every
             head dim, the f32 ones none, and no bf16 instantiation of a
             scalar flash body may exist; ptxas's registers and spill bytes
             per kernel are kept, and the bf16 dQ kernel must not spill.
3. kernels - each hand kernel against its plain PyTorch version on the
             card, on numpy-seeded inputs, with stated tolerances (the
             flash forward, its dQ and dK/dV backward kernels, paged
             decode's split and combine passes, with splits that hold no
             token); the bf16 forward on the same bf16 inputs, with a
             mean limit that a control (scores rounded to bf16 before the
             softmax) must miss at long T (also at Mixtral's D=128, G=4,
             T 16/128/2048; paged decode also at D=128, G=4, page 64);
             the backward ones also against
             a control without the bf16 roundings that their limit must
             reject; a grad-tracking call launches forward, dQ and dK/dV
             once each. The flash kernels are checked again at the
             training shape, and dQ, dK and dV twice on the same inputs
             must be bit-equal.
             Then each is timed on the device (CUDA events
             around a CUDA-graph replay of back-to-back calls, host cost
             excluded; the eager per-call time is logged beside it) with
             its plain version, the least time the card could take (bound)
             and, where one exists, a single PyTorch call computing the
             same function. Paged decode is timed at the serving batch and
             at a long shape (B=8, lengths 2048), and at both under the
             split plans that aim at 2, 3, 4 and 8 CTAs an SM.
4. model   - the llama_1b decoder in f32: logits through the kernels (paged
             prefill and decode) against logits through the plain dense
             cache path, on one prompt.
5. slice   - the paged LLMServer at llama_1b width and depth, seeded random
             weights, serving requests through generate and generate_stream
             under asyncio; the kernel launch counters are reset just
             before and read just after, and must match layers x calls
             (no backward launch; a combine pass after every split pass
             whose plan has several splits); stats()["slo"] must hold TTFT
             and TPOT summaries, slo_snapshot() must count the waves'
             requests, and a prefix digest must exist after the radix hit.
             One more wave runs under torch.profiler.
6. moe     - the MoE serving path at Mixtral-8x7B width (d_model 4096,
             32/8 heads, head_dim 128, ffn 14336, 8 experts top-2, vocab
             32000), depth cut to 8 of its 32 layers: (a) 2 layers in f32,
             logits and every token's top-2 expert ids through the kernels
             (B1 at D=128, G=4 on the first prefill chunk, B4 on a decode
             step) against the plain dense-cache path; (b) the paged
             LLMServer (bf16 weights from seed 0, dropless experts) serving
             the slice's two waves, with the same launch-count checks as
             the slice (path `serve_moe`), the SLO metrics (stats()["slo"],
             slo_snapshot()), a prefix digest, peak memory, and one wave
             under torch.profiler with the MoE einsums' share of device
             time; (c) B1 (B=1, T=128, H=32, Kh=8, D=128) and B4 (B=8, D=128,
             the wave's lengths) timed with their plain versions and SDPA.
7. replica - at llama_1b width: speculate=4 against speculate=0 on a
             repeating prompt (dense, f32: equal greedy ids, accept rate
             logged), embed of 300 tokens through B1 against the plain
             path, and a merged LoRA adapter served for one request.
8. train   - the training step (ray_tpu_torch.train): (a) llama_1b width
             with 2 layers in f32, every parameter's gradient through the
             kernels against the plain attention path (and a TF32 control
             that the limit must reject), and the bf16 loss head at B=4,
             T=2048 against the same head widened to f32; (b) train_llama at
             llama_1b width and depth, B=4, T=2048, bf16, 2 warm-up and
             10 timed steps, counters reset before and read after (forward,
             dQ and dK/dV each 16 per step), finite losses and params; (c)
             one step with remat (forward 32 per step) whose loss matches
             (b)'s first; (d) one step under torch.profiler, in which the
             flash forward's, dQ's and dK/dV's device time must be the
             tensor-core kernels', 16 calls each.

It prints a `kernels` JSON line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Details go to chip_smoke_out/chip_smoke.json.
It needs one CUDA card and exits non-zero without one.
"""

import asyncio
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H100_SXM = "NVIDIA H100 80GB HBM3"      # the card the rates below are for
HBM_BYTES_PER_S = 3.35e12               # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core rate (bounds and MFU)
              "float32": 67e12}         # f32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max-abs vs the plain version
# bf16 forward vs its plain version on the same bf16 inputs: mean |err| over
# mean |out|. The kernel rounds P to bf16 before P V; a control that rounds
# the scores to bf16 before the softmax must miss this limit where rows are
# long (T >= FWD_CONTROL_MIN_T): at short T the scores stay near 1 in size
# and their rounding is no larger than P's.
FWD_MEAN_TOL = 2e-3
FWD_CONTROL_MIN_T = 1024
# backward kernels vs their plain version, per gradient: max |err| over max
# |grad|, and mean |err| over mean |grad|. The mean limit is the one that
# a backward without the dS and P roundings (the control) must exceed.
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
BWD_MEAN_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
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


# ------------------------------------------------------------------ build
def kernel_label(symbol):
    """(kernel, dtype, head dim) from a mangled kernel symbol, e.g.
    ...19flash_fwd_tc_kernelILi64EE... -> ("flash_fwd_tc_kernel", "bfloat16", 64).
    The tensor-core kernels take bf16 only; the scalar ones name their
    element type first (f = float)."""
    m = re.search(r"(?<=\d)((?:flash|paged)_[a-z_]*?_kernel)I(.*)", symbol)
    if m is None:
        return symbol, None, None
    name, args = m.groups()
    d = re.search(r"Li(\d+)E", args)
    dtype = ("float32" if args.startswith("f") else
             "bfloat16" if args.startswith("13__nv_bfloat16") or "_tc_" in name else None)
    return name, dtype, int(d.group(1)) if d else None


def tensor_core_counts(lib_path):
    """Tensor-core instructions per kernel of the built library, from
    cuobjdump -sass: {(kernel, dtype, head dim): {"HMMA": n, "HGMMA": n}}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_label(line.split("Function :", 1)[1].strip())
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None and (m := re.search(r"\b(HG?MMA)\b", line)):
            counts[fn][m.group(1)] += 1
    return counts


# the bf16 flash kernels and the tensor-core instruction each must use
TC_KERNELS = {"flash_fwd_tc_kernel": "HGMMA", "flash_bwd_dq_tc_kernel": "HGMMA",
              "flash_bwd_dkv_tc_kernel": "HMMA"}
SCALAR_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def check_tensor_cores(lib_path):
    """The bf16 flash kernels run on the tensor cores (forward and dQ
    wgmma, dK/dV mma.sync) at every head dim; the f32 routes do not; no
    bf16 instantiation of a scalar flash body exists. Returns the counts;
    raises on a miss."""
    counts = tensor_core_counts(lib_path)
    flash = {k: n for k, n in counts.items() if k[0].startswith("flash_")}
    for (name, dtype, d), n in sorted(flash.items(), key=lambda kv: str(kv[0])):
        log(f"[build]   {n['HMMA']:5d} HMMA {n['HGMMA']:5d} HGMMA in {name}<{dtype}, D={d}>")
    problems = [k for k, n in flash.items() if k[0] in TC_KERNELS
                and (n[TC_KERNELS[k[0]]] == 0 or k[1] != "bfloat16")]
    problems += [k for k, n in flash.items() if k[0] not in TC_KERNELS and sum(n.values())]
    problems += [k for k in flash if k[0] in SCALAR_KERNELS and k[1] != "float32"]
    for want in TC_KERNELS:
        have = sorted(k[2] for k in flash if k[0] == want)
        if have != [16, 32, 64, 128]:
            problems.append((want, "head dims", tuple(have)))
    if problems:
        raise AssertionError(f"tensor-core evidence failed for {problems}")
    return {f"{k[0]}<{k[1]},{k[2]}>": n for k, n in counts.items()}


def ptxas_report(build_log):
    """Registers and spill bytes per kernel from the build's ptxas -v
    report: {"kernel<dtype,D[,G]>": {"registers": n, "spill_stores": n,
    "spill_loads": n}} (G: the paged kernel's group bucket)."""
    report, fn = {}, None
    for line in build_log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name, dtype, _ = kernel_label(m.group(1))
            ints = re.findall(r"Li(\d+)E", m.group(1))
            fn = report.setdefault(f"{name}<{','.join([str(dtype)] + ints)}>", {})
        elif fn is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            fn.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn is not None and (m := re.search(r"Used (\d+) registers", line)):
            fn["registers"] = int(m.group(1))
            fn = None
    return report


def check_spills(report):
    """The bf16 dQ kernel keeps its tiles and sums in registers: 0 spill
    bytes at every head dim. Logs the tensor-core and paged kernels'
    registers; raises on a spill."""
    rows = {k: v for k, v in report.items()
            if any(k.startswith(n + "<") for n in TC_KERNELS) or k.startswith("paged_")}
    for k, v in sorted(rows.items()):
        log(f"[build]   {v.get('registers')} registers, {v.get('spill_stores')} / "
            f"{v.get('spill_loads')} spill bytes (stores / loads) in {k}")
    dq = {k: v for k, v in rows.items() if k.startswith("flash_bwd_dq_tc_kernel<")}
    if len(dq) != 4 or any(v.get("spill_stores") or v.get("spill_loads") for v in dq.values()):
        raise AssertionError(f"flash_bwd_dq_tc_kernel registers/spills: {dq}")
    return rows


# ---------------------------------------------------------------- kernels
def flash_inputs(rng, b, t, h, kh, d, dtype, device="cuda"):
    import torch
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        device, dtype)
    return mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


def fwd_control(q, k, v, causal):
    """The plain forward with the scores rounded to bf16 before the softmax
    (f32 softmax and P V after it, out rounded to q's dtype once)."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    b, t, h, d = q.shape
    s = fa._grouped_scores(q, k, causal, 1.0 / d ** 0.5).to(torch.bfloat16).float()
    out = torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def check_fwd(tag, q, k, v, causal, out, lse):
    """The forward kernel's out and lse against the plain version on the
    same inputs: out within TOL max-abs (both round out once), lse within
    1e-3; in bf16 also the mean error over the mean |out| within
    FWD_MEAN_TOL, with the control's reading beside it, which must miss that
    limit where T >= FWD_CONTROL_MIN_T. Returns the readings; raises on a
    miss."""
    from ray_tpu_torch.ops import flash_attention as fa
    name = str(q.dtype).split(".")[1]
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal, return_lse=True)
    r = dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
             lse_max_abs_err=(lse - ref_lse).abs().max().item())
    ok = r["max_abs_err"] <= TOL[name] and r["lse_max_abs_err"] <= TOL["float32"] * 10
    if name == "bfloat16":
        r["mean_rel_err"] = mean_rel_err(out, ref)
        ctl = fwd_control(q, k, v, causal)
        r["control_max_abs_err"] = (ctl.float() - ref.float()).abs().max().item()
        r["control_mean_rel_err"] = mean_rel_err(ctl, ref)
        ok = ok and r["mean_rel_err"] <= FWD_MEAN_TOL
        if q.shape[1] >= FWD_CONTROL_MIN_T:
            ok = ok and r["control_mean_rel_err"] > FWD_MEAN_TOL
        del ctl
    if not ok:
        raise AssertionError(f"flash_fwd {tag}: readings {r} (limits max-abs {TOL[name]}, "
                             f"lse {TOL['float32'] * 10}, bf16 mean {FWD_MEAN_TOL})")
    return r


def check_flash(rng, record, device="cuda"):
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    worst = 0.0
    cases = [(dt, causal, g, kh, t, 64, 1, 32) for dt in (torch.float32, torch.bfloat16)
             for causal in (True, False) for g, kh in ((1, 32), (4, 8))
             for t in (16, 100, 128, 2048)]
    # the other head dims the kernel is built for
    cases += [(torch.bfloat16, True, 4, 2, 100, d, 2, 8) for d in (16, 32, 128)]
    # the MoE serving shapes (Mixtral: D = 128, 32 query heads over 8 kv
    # heads), on inputs of their own so that the cases above and every
    # later check keep the inputs they had before these were added
    cases += [(torch.bfloat16, True, 4, 8, t, 128, 1, 32) for t in (16, 128, 2048)]
    moe_rng = np.random.default_rng(128)
    for dtype, causal, g, kh, t, d, b, h in cases:
        name = str(dtype).split(".")[1]
        src = moe_rng if (d, h) == (128, 32) else rng
        q, k, v = flash_inputs(src, b, t, h, kh, d, dtype, device)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        r = check_fwd(f"{name} causal={causal} G={g} T={t} D={d}", q, k, v, causal, out,
                      lse)
        record.append(dict(kernel="flash_fwd", dtype=name, causal=causal, group=g, T=t,
                           head_dim=d, ok=True, **r))
        worst = max(worst, r["max_abs_err"])
    bf = [r for r in record if r["kernel"] == "flash_fwd" and r["dtype"] == "bfloat16"]
    long_rows = [r for r in bf if r["T"] >= FWD_CONTROL_MIN_T]
    if device == "cuda":  # a grad-tracking call: forward, dQ, dK/dV once each
        q, k, v = (x.requires_grad_() for x in
                   flash_inputs(rng, 1, 100, 32, 8, 64, torch.bfloat16, device))
        before = flash_counts()
        fa.flash_attention(q, k, v).float().square().sum().backward()
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(flash_counts(), before)]
        if launched != [1, 1, 1]:
            raise AssertionError(f"grad-tracking call launched fwd/dq/dkv {launched}")
    log(f"[kernels] flash_fwd: {len(cases)} cases within tolerance (max-abs f32 "
        f"{TOL['float32']}, bf16 {TOL['bfloat16']}; bf16 mean {FWD_MEAN_TOL}), worst "
        f"max-abs {worst:.3e}; bf16 mean worst {max(r['mean_rel_err'] for r in bf):.3e}; "
        f"control (scores rounded to bf16) mean least {min(r['control_mean_rel_err'] for r in bf):.3e} "
        f"over all bf16 cases, {min(r['control_mean_rel_err'] for r in long_rows):.3e} "
        f"where T >= {FWD_CONTROL_MIN_T}")
    return worst


def flash_counts():
    from ray_tpu_torch.ops import flash_attention as fa
    return [fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES]


def reset_flash_counts():
    from ray_tpu_torch.ops import flash_attention as fa
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0


def rel_err(got, want):
    """max |got - want| over the largest |want| (f32)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def mean_rel_err(got, want):
    """mean |got - want| over the mean |want| (f32)."""
    return ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()


def check_bwd(tag, name, got, want, control=None):
    """dq, dk, dv of the kernels (`got`) against the plain backward
    (`want`): each gradient's max error over its largest |grad| within
    BWD_TOL and its mean error over its mean |grad| within BWD_MEAN_TOL.
    `control`, for bf16: the plain backward without the dS and P roundings
    (f32 operands, outputs rounded once), which must miss the mean limit on
    at least one gradient, so that the limit would catch a kernel that
    drops them. Returns the readings; raises on a miss."""
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    means = [mean_rel_err(a, b) for a, b in zip(got, want)]
    out = dict(rel_err=errs, mean_rel_err=means,
               max_abs_err=[(a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want)])
    ok = max(errs) <= BWD_TOL[name] and max(means) <= BWD_MEAN_TOL[name]
    if control is not None:
        out["control_rel_err"] = [rel_err(a, b) for a, b in zip(control, want)]
        out["control_mean_rel_err"] = [mean_rel_err(a, b) for a, b in zip(control, want)]
        ok = ok and max(out["control_mean_rel_err"]) > BWD_MEAN_TOL[name]
    if not ok:
        raise AssertionError(f"flash_bwd {tag}: dq/dk/dv readings {out} (limits max "
                             f"{BWD_TOL[name]}, mean {BWD_MEAN_TOL[name]})")
    return out


def bwd_control(q, k, v, out, lse, do, causal):
    """The plain backward without the dS and P roundings: every operand in
    f32, each gradient rounded to the input dtype once at the end."""
    from ray_tpu_torch.ops import flash_attention as fa
    f = lambda x: x.float()
    return [g.to(q.dtype) for g in fa.flash_attention_bwd_reference(
        f(q), f(k), f(v), f(out), lse, f(do), causal)]


def check_flash_bwd(rng, record, device="cuda"):
    """B2 (dQ) and B3 (dK/dV) against flash_attention_bwd_reference on the
    same q, k, v, out, lse and dO, within the limits of `check_bwd`; f32
    differs in summation order only, bf16 also by the bf16 outputs."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}   # max, mean
    control = [1.0, 1.0]     # the control's smallest readings over the bf16 cases
    max_abs = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(dt, causal, g, t, 64) for dt in (torch.float32, torch.bfloat16)
             for causal in (True, False) for g in (1, 4) for t in (16, 100, 128, 2048)]
    cases += [(torch.bfloat16, True, 4, 100, d) for d in (16, 32, 128)]
    for dtype, causal, g, t, d in cases:
        name = str(dtype).split(".")[1]
        h = 32 if d == 64 else 8
        q, k, v = flash_inputs(rng, 1 if t == 2048 else 2, t, h, h // g, d, dtype, device)
        do = flash_inputs(rng, q.shape[0], t, h, 1, d, dtype, device)[0]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        ctl = bwd_control(q, k, v, out, lse, do, causal) if name == "bfloat16" else None
        r = check_bwd(f"{name} causal={causal} G={g} T={t} D={d}", name, got, want, ctl)
        record.append(dict(kernel="flash_bwd", dtype=name, causal=causal, group=g, T=t,
                           head_dim=d, ok=True, **r))
        worst[name] = [max(worst[name][0], *r["rel_err"]),
                       max(worst[name][1], *r["mean_rel_err"])]
        if ctl is not None:
            control = [min(control[0], max(r["control_rel_err"])),
                       min(control[1], max(r["control_mean_rel_err"]))]
        max_abs["flash_bwd_dq"] = max(max_abs["flash_bwd_dq"], r["max_abs_err"][0])
        max_abs["flash_bwd_dkv"] = max(max_abs["flash_bwd_dkv"], *r["max_abs_err"][1:])
    log(f"[kernels] flash_bwd dq + dkv: {len(cases)} cases within tolerance (max / mean "
        f"error over max / mean |grad|: f32 {BWD_TOL['float32']} / "
        f"{BWD_MEAN_TOL['float32']}, bf16 {BWD_TOL['bfloat16']} / "
        f"{BWD_MEAN_TOL['bfloat16']}); worst f32 {worst['float32']}, bf16 "
        f"{worst['bfloat16']}; control without dS/P roundings, least over the bf16 "
        f"cases: {control}; max-abs {max_abs}")
    return max_abs, dict(worst=worst, control_least=control)


def time_flash_train(rng, record):
    """B1, B2, B3 at the training shape: B=4, T=2048, H=32, Kh=8, D=64,
    bf16, causal. First each is held against its plain version on these
    inputs (B1 as in `check_fwd`, B2 and B3 as in `check_bwd`), and dQ, dK
    and dV computed twice must be bit-equal. Bounds count each
    input read once and each output written once, and the matrix products'
    flops inside the causal area (exp and elementwise work not counted).
    The plain backward computes dQ, dK and dV together; so does the
    library yardstick, the aten flash-attention backward on kv heads
    expanded to 32 (its dK/dV are per query head: the sum over the group of
    4 is not in its time). The f32 routes (scalar FMAs, off both main
    paths) are timed on the same inputs widened to f32."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    b, t, h, kh, d = 4, 2048, 32, 8, 64
    scale = 1.0 / d ** 0.5
    q, k, v = flash_inputs(rng, b, t, h, kh, d, torch.bfloat16)
    do = flash_inputs(rng, b, t, h, 1, d, torch.bfloat16)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fwd_r = check_fwd("train shape", q, k, v, True, out, lse)
    record.append(dict(kernel="flash_fwd", dtype="bfloat16", causal=True, group=4, B=b,
                       T=t, head_dim=d, ok=True, **fwd_r))
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    bit_equal = [torch.equal(a, b_) for a, b_ in zip(got, again)]
    if not all(bit_equal):
        raise AssertionError(f"flash_bwd dq/dk/dv: two runs on the same inputs differ "
                             f"(bit-equal {bit_equal})")
    bit_equal = all(bit_equal)
    del again
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    bwd = check_bwd("train shape", "bfloat16", got, want,
                    bwd_control(q, k, v, out, lse, do, True))
    record.append(dict(kernel="flash_bwd", dtype="bfloat16", causal=True, group=4, B=b,
                       T=t, head_dim=d, ok=True, bit_equal_rerun=bit_equal, **bwd))
    fmt = lambda xs: [f"{x:.3e}" for x in xs]
    log(f"[kernels] train shape vs plain: flash_fwd max-abs {fwd_r['max_abs_err']:.3e}, "
        f"mean {fwd_r['mean_rel_err']:.3e} (control mean {fwd_r['control_mean_rel_err']:.3e}, "
        f"lse {fwd_r['lse_max_abs_err']:.3e}); dq/dk/dv max {fmt(bwd['rel_err'])}, mean "
        f"{fmt(bwd['mean_rel_err'])} (control max {fmt(bwd['control_rel_err'])}, mean "
        f"{fmt(bwd['control_mean_rel_err'])}); dQ/dK/dV rerun bit-equal {bit_equal}")
    del got, want
    err = fwd_r["max_abs_err"]
    delta = fa.bwd_delta(out, do)
    fwd = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
    dq = lambda: fa.launch_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dkv = lambda: fa.launch_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    plain_fwd = time_ms(lambda: fa.flash_attention_reference(q, k, v, True), iters=3)
    plain_bwd = time_eager_ms(
        lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True), iters=3,
        warmup=1)
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                       iters=20)
    o, l, cq, ck, mq, mk, seed, offset, _ = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale)
    sdpa_bwd = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, o, l, cq, ck, mq, mk, 0.0, True, seed, offset, scale=scale),
        iters=20)
    n_q, n_kv = b * t * h * d, b * t * kh * d       # elements of q (= out, do) and k (= v)
    pairs = b * h * t * (t + 1) // 2                # (query, key) pairs in the causal area
    stats = 4 * b * h * t                           # bytes of lse (and of delta)
    rows = {}
    for name, fn, nbytes, flops, plain, lib, max_abs in (
            ("flash_fwd", fwd, 2 * (2 * n_q + 2 * n_kv) + stats, 4 * d * pairs,
             plain_fwd, sdpa_fwd, err),
            ("flash_bwd_dq", dq, 2 * (3 * n_q + 2 * n_kv) + 2 * stats, 6 * d * pairs,
             plain_bwd, sdpa_bwd, bwd["max_abs_err"][0]),
            ("flash_bwd_dkv", dkv, 2 * (2 * n_q + 4 * n_kv) + 2 * stats, 8 * d * pairs,
             plain_bwd, sdpa_bwd, max(bwd["max_abs_err"][1:]))):
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        rows[name] = dict(shape="B=4 T=2048 H=32 Kh=8 D=64 bf16 causal",
                          ms=time_ms(fn, iters=20), eager_ms=time_eager_ms(fn, iters=20),
                          plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=max_abs)
        r = rows[name]
        log(f"[kernels] {name} train shape: {r['ms']:.4f} ms (eager call "
            f"{r['eager_ms']:.4f}), plain {plain:.4f} ms, library {lib:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
    # the f32 routes, off both main paths
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    out32, lse32 = fa.flash_attention_fwd(q32, k32, v32, causal=True)
    delta32 = fa.bwd_delta(out32, do32)
    rows["f32_route"] = dict(
        shape="B=4 T=2048 H=32 Kh=8 D=64 f32 causal",
        flash_fwd_ms=time_ms(lambda: fa.flash_attention_fwd(q32, k32, v32, causal=True),
                             iters=5),
        flash_bwd_dq_ms=time_ms(lambda: fa.launch_bwd_dq(q32, k32, v32, do32, lse32,
                                                         delta32, True, scale), iters=5),
        flash_bwd_dkv_ms=time_ms(lambda: fa.launch_bwd_dkv(q32, k32, v32, do32, lse32,
                                                           delta32, True, scale), iters=5))
    log(f"[kernels] f32 routes (scalar FMAs) at the train shape: flash_fwd "
        f"{rows['f32_route']['flash_fwd_ms']:.4f} ms, flash_bwd_dq "
        f"{rows['f32_route']['flash_bwd_dq_ms']:.4f} ms, flash_bwd_dkv "
        f"{rows['f32_route']['flash_bwd_dkv_ms']:.4f} ms")
    return rows


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


def paged_cases(rng):
    """(dtype, B, Kh, G, D, page, max_pages, lengths) of the B4 checks."""
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    f32, bf16 = torch.float32, torch.bfloat16
    serve = [1, 64, 100, 2048, 777, 129, 63, 1500]  # 2048 fills the table
    cases = [(dt, 8, 8, g, 64, 64, 32, serve) for dt in (bf16, f32) for g in (1, 4)]
    # other head dims, the largest group, other page sizes, groups that are
    # not a power of two (the kernel rounds G up for its registers)
    cases += [(f32, 4, 2, g, d, page, 3, [1, 5, 17, 3 * page])
              for d, g, page in ((16, 2, 16), (32, 1, 32), (128, 8, 16), (64, 3, 64))]
    cases.append((bf16, 3, 2, 6, 64, 32, 8, [1, 100, 256]))
    # the MoE serving shape: Mixtral's D = 128 and G = 4, page 64 (drawn
    # from its own inputs in check_paged)
    cases.append((bf16, 8, 8, 4, 128, 64, 32, serve))
    # one split per page (B x Kh small): length 1 leaves every split but the
    # first without a token, 640 fills a 40-page table; G = 8, D = 128,
    # page 16; the largest page; a batch that fills the card with one split
    for dt in (bf16, f32):
        cases += [(dt, 2, 2, 8, 128, 16, 40, [1, 640]),
                  (dt, 4, 2, 4, 64, 64, 32, [1, 65, 2048, 1000]),
                  (dt, 2, 1, 8, 128, pa.MAX_PAGE_SIZE, 4, [300, 4 * pa.MAX_PAGE_SIZE]),
                  (dt, 72, 8, 4, 64, 64, 4, rng.integers(1, 257, 72).tolist())]
    return cases


def check_paged(rng, record, device="cuda"):
    """B4 against paged_attention_reference within TOL on every case of
    `paged_cases`; each call launches one split pass and, where its plan has
    several splits, one combine pass. The plain version of the split
    arithmetic (paged_attention_split_reference, on the plan's
    pages_per_split) is read beside it."""
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    worst, n_multi = 0.0, 0
    cases = paged_cases(rng)
    moe_rng = np.random.default_rng(129)
    for dtype, b, kh, g, d, page, max_pages, lens in cases:
        name = str(dtype).split(".")[1]
        src = moe_rng if (d, g) == (128, 4) else rng
        q, kp, vp, tb, ln = paged_inputs(src, b, kh, g, d, page, max_pages, lens, dtype,
                                         device)
        sms = pa._sm_count(q.device) if device == "cuda" else 132  # CPU: no launch
        n_split, per = pa.split_plan(b, kh, max_pages, sms)
        before = (pa.LAUNCHES, pa.COMBINE_LAUNCHES)
        out = pa.paged_attention(q, kp, vp, tb, ln)
        launched = (pa.LAUNCHES - before[0], pa.COMBINE_LAUNCHES - before[1])
        want = (1, int(n_split > 1)) if device == "cuda" else (0, 0)
        f = lambda x: x.float()
        ref = pa.paged_attention_reference(f(q), f(kp), f(vp), tb, ln)
        split_ref = pa.paged_attention_split_reference(f(q), f(kp), f(vp), tb, ln,
                                                       pages_per_split=per)
        err = (out.float() - ref).abs().max().item()
        ok = err <= TOL[name] and launched == want
        record.append(dict(kernel="paged_decode", dtype=name, B=b, kv_heads=kh, group=g,
                           head_dim=d, page=page, max_pages=max_pages, lengths=list(lens),
                           n_split=n_split, pages_per_split=per, launched=launched,
                           max_abs_err=err,
                           split_ref_max_abs_err=(out.float() - split_ref).abs().max().item(),
                           ok=ok))
        if not ok:
            raise AssertionError(f"paged_decode {record[-1]}")
        worst = max(worst, err)
        n_multi += n_split > 1
    log(f"[kernels] paged_decode: {len(cases)} cases within tolerance ({n_multi} with "
        f"several splits, some holding no token), worst max-abs {worst:.3e}")
    return worst


def time_flash(rng, t, d=64):
    """B1 at a prefill chunk of a serving path: B=1, H=32, Kh=8, bf16, head
    dim `d` (64: llama_1b; 128: Mixtral)."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    b, h, kh = 1, 32, 8
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
    return dict(T=t, head_dim=d, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def time_paged(rng, lengths, copies=1, d=64):
    """B4 at a serving decode batch: B=8, H=32, Kh=8, page 64, max_pages 32,
    bf16, head dim `d` (64: llama_1b; 128: Mixtral). With copies > 1 the timed calls take turns over that
    many input sets (own pools and tables), so that K and V come from device
    memory and not from the 50 MB L2 cache. Only wrapper calls are timed, so
    the same function times the kernel of another commit's package."""
    import itertools
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    b, kh, g, page, max_pages = 8, 8, 4, 64, 32
    sets = [paged_inputs(rng, b, kh, g, d, page, max_pages, lengths, torch.bfloat16)
            for _ in range(copies)]
    turns = itertools.cycle(sets)
    ms = time_ms(lambda: pa.paged_attention(*next(turns)))
    eager_ms = time_eager_ms(lambda: pa.paged_attention(*next(turns)))
    plain_ms = time_ms(lambda: pa.paged_attention_reference(*next(turns)), iters=20)
    tokens = int(sum(lengths))
    bytes_moved = (2 * 2 * b * kh * g * d          # q in, out
                   + 2 * 2 * tokens * kh * d       # K and V of the valid tokens
                   + 4 * b * max_pages + 4 * b)    # tables, lengths
    flops = 4 * tokens * kh * g * d
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    plan = getattr(pa, "split_plan", None)
    return dict(lengths=list(lengths), copies=copies, head_dim=d, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                plan=plan(b, kh, max_pages, pa._sm_count(sets[0][0].device)) if plan else None)


def sweep_paged_plan(rng, serve_lengths):
    """B4 at the serving and the long lengths (as `time_paged`) under the
    split plans that aim at 2, 3, 4 and 8 CTAs an SM (CTAS_PER_SM, whose
    value the wrapper uses is the plan's aim)."""
    from ray_tpu_torch.ops import paged_attention as pa
    keep, rows = pa.CTAS_PER_SM, []
    try:
        for k in (2, 3, 4, 8):
            pa.CTAS_PER_SM = k
            serve, long = time_paged(rng, serve_lengths), time_paged(rng, [2048] * 8, copies=4)
            rows.append(dict(ctas_per_sm=k, plan=serve["plan"], serve_ms=serve["ms"],
                             long_ms=long["ms"]))
    finally:
        pa.CTAS_PER_SM = keep
    log(f"[kernels] paged_decode plans (CTAs an SM, (n_split, pages_per_split), serve ms, "
        f"long ms; the wrapper aims at {keep}): "
        + "; ".join(f"{r['ctas_per_sm']} {r['plan']} {r['serve_ms']:.4f} {r['long_ms']:.4f}"
                    for r in rows))
    return rows


# ------------------------------------------------------------------ model
def check_model(server, device="cuda"):
    """llama_1b in f32: the kernel path (paged chunk-local prefill through
    B1, one decode step through B4) against the plain dense-cache path
    (decode_attention) on the same weights and a 100-token prompt."""
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
    from ray_tpu_torch.models.llama import llama_param_count
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
    summary = serve_and_count(server, "slice", device)
    summary["model_check"] = model_check
    if device == "cuda":
        summary["profile"] = profile_wave(server, mc.vocab_size)
    return summary


def serve_and_count(server, tag, device="cuda"):
    """The two waves of `slice_prompts` (10 requests x 32 tokens, through
    generate and generate_stream) after a warm-up request, with the kernel
    launch counters reset just before and read just after; then the checks
    of what the path launched (B1 per fresh first chunk, B4 per decode
    step, its combine pass per its split plan, no backward), of the radix
    hit and of the SLO metrics (TTFT and TPOT summaries in stats()["slo"],
    slo_snapshot()'s window counting the waves' requests, a prefix digest
    after the hit). Returns the summary; raises on a failed check."""
    import torch
    from ray_tpu_torch.ops import paged_attention as pa

    mc = server.model_cfg
    # warm-up request (cuBLAS handles, allocator); its stats are subtracted
    asyncio.run(serve_wave(server, [list(range(1, 50))], 8))
    before = server.stats()
    server.slo_snapshot()             # the next window starts here
    wave1, wave2 = slice_prompts(mc.vocab_size)
    max_tokens = 32

    reset_flash_counts()
    pa.LAUNCHES = pa.COMBINE_LAUNCHES = 0
    t0 = time.perf_counter()
    res = asyncio.run(serve_wave(server, wave1, max_tokens))
    res += asyncio.run(serve_wave(server, wave2, max_tokens))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), flash_counts()),
                    paged_decode=pa.LAUNCHES, paged_decode_combine=pa.COMBINE_LAUNCHES)
    after = server.stats()
    snap = server.slo_snapshot()
    digest = server.prefix_digest()
    # the decode step's split plan (batch slots x kv heads over the table)
    slots, max_pages = server.cache.block_tables.shape
    n_split = (pa.split_plan(slots, mc.n_kv_heads, max_pages,
                             pa._sm_count(server.cache.block_tables.device))[0]
               if device == "cuda" else 1)

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
        f"a combine after every paged launch ({n_split} splits a call)":
            launches["paged_decode_combine"] == (launches["paged_decode"] if n_split > 1
                                                 else 0),
        "both kernels launched": launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
        "no backward kernel launched (no grad in serving)":
            launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
        "radix prefix hit of the shared 256 tokens": hit >= 256,
        "host syncs below tokens (fused chunks)": syncs < tokens,
        "stats()['slo'] has TTFT and TPOT summaries":
            bool(after["slo"]["ttft_s"]) and bool(after["slo"]["tpot_ms"]),
        f"slo_snapshot() counts the waves' {n_req} requests": snap["ttft_count"] == n_req,
        "a prefix digest after the radix hit": bool(digest and digest["entries"]),
    }
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: launches {launches}, steps {steps}, "
                             f"fresh {fresh}, hit {hit}, syncs {syncs}, tokens {tokens}, "
                             f"slo snapshot {snap}, digest {digest}")
    ttft = sorted(r[1] for r in res)
    summary = dict(requests=n_req, max_tokens=max_tokens,
                   prompt_lens=[len(p) for p in wave1 + wave2],
                   ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
                   decode_tokens=tokens, decode_host_syncs=syncs,
                   decode_steps=steps, decode_s=decode_s,
                   decode_tokens_per_s=tokens / decode_s if decode_s else None,
                   host_syncs_per_token=syncs / tokens,
                   wall_s=wall, launches=launches, paged_n_split=n_split,
                   fresh_first_chunks=fresh, prefix_hit_tokens=hit,
                   slo_snapshot=snap, prefix_digest_entries=len(digest["entries"]),
                   stats=after)
    log(f"[{tag}] {n_req} requests x {max_tokens} tokens in {wall:.2f} s: "
        f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms, decode "
        f"{summary['decode_tokens_per_s']:.1f} tokens/s over {syncs} host syncs "
        f"for {tokens} emitted tokens ({steps} steps, {syncs / tokens:.4f} syncs a token)")
    log(f"[{tag}] stats: {json.dumps(after['decode'])}; slo ttft_s "
        f"{json.dumps(after['slo']['ttft_s'])}, tpot_ms {json.dumps(after['slo']['tpot_ms'])}; "
        f"slo_snapshot {json.dumps(snap)}; digest {len(digest['entries'])} entries")
    return summary


# ------------------------------------------------------------------ moe
# Mixtral-8x7B at full width (LlamaConfig.mixtral_8x7b, from
# mistralai/Mixtral-8x7B-v0.1's config.json), 8 of its 32 layers: the whole
# model (93 GB in bf16) does not fit on one card
MOE_PRESET = "mixtral_8x7b"
MOE_LAYERS = 8


def check_moe_model(device="cuda", preset=MOE_PRESET, n_layers=2, tol=1e-3):
    """Mixtral width, 2 layers, f32, dropless (capacity_factor E/K, as the
    server sets it): the logits through the kernels (paged prefill whose
    first chunk runs B1 at D=128, G=4, then one decode step through B4)
    against the plain dense-cache path on one 100-token prompt, with
    check_model's tolerance; and the routing, the top-2 expert ids of every
    token in every layer, equal between the two paths."""
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import KVCache, Llama, LlamaConfig
    from ray_tpu_torch.ops.paged_attention import PagedKVCache

    cfg = getattr(LlamaConfig, preset)(n_layers=n_layers, dtype=torch.float32,
                                       param_dtype=torch.float32, max_seq_len=256)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    model = init_params(Llama(cfg, device=device), torch.Generator(device=device).manual_seed(0))
    model.requires_grad_(False)
    ids = lambda: [blk.moe.last_gate_idx.clone() for blk in model.blocks()]
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 100))).to(device)
    before = flash_counts()
    with torch.no_grad():
        dense = KVCache.init(cfg, 1, 256, device=device)
        logits_d, dense = model(prompt, cache=dense)
        ids_d = ids()
        nxt = logits_d[:, -1].argmax(-1, keepdim=True)
        step_d, _ = model(nxt, cache=dense)
        ids_d += ids()
        paged = PagedKVCache.init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 5, 64,
                                  1, 4, dtype=torch.float32, device=device)
        paged.block_tables[0] = torch.tensor([3, 1, 4, 2], dtype=torch.int32)
        logits_p, paged = model(prompt, cache=paged, paged_chunk_local=True)
        ids_p = ids()
        step_p, _ = model(nxt, cache=paged)
        ids_p += ids()
    launched = [a - b for a, b in zip(flash_counts(), before)]
    err_prefill = (logits_p - logits_d).abs().max().item()
    err_step = (step_p - step_d).abs().max().item()
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(ids_p, ids_d))
    want = [n_layers, 0, 0] if device == "cuda" else [0, 0, 0]
    finite = bool(torch.isfinite(logits_p).all() and torch.isfinite(step_p).all())
    log(f"[moe] {preset} x {n_layers} layers f32 kernel path vs plain path: prefill "
        f"logits max-abs {err_prefill:.3e}, decode-step logits max-abs {err_step:.3e} (tol "
        f"{tol}); top-2 expert ids differ for {flips} of {101 * n_layers} (token, layer) "
        f"pairs; fwd/dq/dkv launched {launched} (want {want})")
    if not (finite and err_prefill <= tol and err_step <= tol and flips == 0
            and launched == want):
        raise AssertionError(f"moe model check failed: finite={finite}, prefill "
                             f"{err_prefill}, step {err_step}, flips {flips}, "
                             f"launched {launched}")
    del model, dense, paged
    return dict(prefill_max_abs_err=err_prefill, step_max_abs_err=err_step, tol=tol,
                expert_id_flips=flips)


def run_moe(rng, device="cuda", preset=MOE_PRESET, n_layers=MOE_LAYERS):
    """The MoE serving path: (a) the f32 2-layer model check; (b) the paged
    LLMServer at Mixtral width with MOE_LAYERS layers, bf16 weights from
    seed 0, through `serve_and_count` and one profiled wave; (c) B1 and B4
    timed at its shapes."""
    import gc
    import torch
    from ray_tpu_torch.models.llama import llama_param_count
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    out = dict(model_check=check_moe_model(device, preset))
    cuda = device == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = LLMConfig(preset=preset, paged=True, page_size=64, max_batch_slots=8,
                    max_seq_len=2048, prefill_chunk=128, decode_chunk=8, device=device,
                    seed=0, model_overrides={"n_layers": n_layers})
    t0 = time.perf_counter()
    server = LLMServer(cfg)
    mc = server.model_cfg
    params = llama_param_count(mc)
    log(f"[moe] {preset} at {mc.n_layers} layers: d_model {mc.d_model}, "
        f"{mc.n_heads}/{mc.n_kv_heads} heads, head_dim {mc.head_dim}, ffn {mc.ffn_dim}, "
        f"{mc.n_experts} experts top-{mc.moe_top_k}, capacity_factor {mc.capacity_factor} "
        f"(dropless), {params:,} params, built in {time.perf_counter() - t0:.1f} s")
    summary = serve_and_count(server, "moe", device)
    out.update(summary, params=params, n_layers=mc.n_layers)
    if not cuda:
        return out
    peak = torch.cuda.max_memory_allocated()
    log(f"[moe] peak device memory {peak / 2**30:.2f} GiB")
    prof = profile_wave(server, mc.vocab_size, tag="moe", ranges=("moe_einsums",))
    prof["moe_einsums_ms"] = prof["ranges"]["moe_einsums"]["device_ms"]
    prof["moe_einsums_share"] = (prof["moe_einsums_ms"] / 1e3 / prof["device_kernel_s"]
                                 if prof["moe_einsums_ms"] else "not measured")
    log(f"[moe] MoE einsums (dispatch, three expert products, combine): "
        f"{prof['moe_einsums_ms']:.3f} ms of device time, share "
        f"{prof['moe_einsums_share']}")
    out.update(peak_memory_bytes=peak, profile=prof)
    serve_lengths = [n + 16 for n in summary["prompt_lens"][:8]]
    del server
    gc.collect()
    torch.cuda.empty_cache()
    out["flash_timing"] = time_flash(rng, 128, d=128)
    out["paged_timing"] = time_paged(rng, serve_lengths, d=128)
    for what, r in (("flash_fwd B=1 T=128 H=32 Kh=8 D=128", out["flash_timing"]),
                    ("paged_decode B=8 H=32 Kh=8 D=128 serve lengths", out["paged_timing"])):
        lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"
        log(f"[moe] {what}: {r['ms']:.4f} ms (eager call {r['eager_ms']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    return out


# ------------------------------------------------------------------ replica
def run_replica(device="cuda", preset="llama_1b"):
    """The rest of the LLM replica at llama_1b width: (a) a dense f32 server
    with speculate=4 against the same weights with speculate=0 on a prompt
    that repeats itself (greedy ids equal, and speculative ticks must have
    run; f32, so that the [B, K+1] and [B, 1] products cannot round a
    near-tie apart). A random model's greedy output does not repeat the
    prompt's n-grams, so the prompt is P + O + P, where O is the plain
    server's continuation of P: after the second P the model's output
    tends to follow O, which the lookup drafts; (b) embed on a
    300-token prompt in bf16 through B1 (n_layers launches) against the
    same weights through attn_impl="xla", within TOL["bfloat16"] of the
    largest |value|; (c) a merged LoRA adapter served through
    LLMServer(params=...) for one request."""
    import gc
    import torch
    from ray_tpu_torch.models import lora as lora_mod
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    out = {}
    f32 = dict(preset=preset, max_batch_slots=2, max_seq_len=512, device=device,
               seed=0, param_dtype="float32", dtype="float32")
    plain = LLMServer(LLMConfig(**f32))
    spec = LLMServer(LLMConfig(speculate=4, **f32), params=plain.model.state_dict())
    vocab = plain.model_cfg.vocab_size
    rng = np.random.default_rng(21)
    head = rng.integers(1, vocab, 16).tolist() * 4
    prompt = head + asyncio.run(plain.generate(head, max_tokens=48))["tokens"] + head
    want = asyncio.run(plain.generate(prompt, max_tokens=48))["tokens"]
    got = asyncio.run(spec.generate(prompt, max_tokens=48))["tokens"]
    st = spec.stats()["speculation"]
    out["speculation"] = dict(st, equal=got == want, tokens=len(got), prompt_len=len(prompt))
    log(f"[replica] speculate=4 vs 0, {preset} f32 dense, {len(prompt)}-token repeating "
        f"prompt, 48 tokens: ids equal {got == want}; {st}")
    if got != want or st["spec_ticks"] == 0:
        raise AssertionError(f"speculation: ids {got} vs {want}, stats {st}")
    del plain, spec

    bf16 = dict(preset=preset, max_batch_slots=1, max_seq_len=512, device=device, seed=0)
    srv = LLMServer(LLMConfig(**bf16))
    ref_srv = LLMServer(LLMConfig(model_overrides={"attn_impl": "xla"}, **bf16),
                        params=srv.model.state_dict())
    prompt = rng.integers(1, vocab, 300).tolist()
    before = flash_counts()
    vec = np.asarray(asyncio.run(srv.embed(prompt)))
    launched = [a - b for a, b in zip(flash_counts(), before)]
    ref = np.asarray(asyncio.run(ref_srv.embed(prompt)))
    err = float(np.abs(vec - ref).max() / np.abs(ref).max())
    layers = srv.model_cfg.n_layers if device == "cuda" else 0
    out["embed"] = dict(rel_err=err, tol=TOL["bfloat16"], launched=launched,
                        dim=len(vec), finite=bool(np.isfinite(vec).all()))
    log(f"[replica] embed of 300 tokens (bucket 512), bf16: flash vs plain path max "
        f"error {err:.3e} of max |value| (tol {TOL['bfloat16']}); fwd/dq/dkv launched "
        f"{launched} (want [{layers}, 0, 0])")
    if not (err <= TOL["bfloat16"] and launched == [layers, 0, 0] and out["embed"]["finite"]):
        raise AssertionError(f"embed check failed: {out['embed']}")
    del ref_srv

    base = srv.model.state_dict()
    gen = torch.Generator(device=device).manual_seed(5)
    adapter = lora_mod.init_lora(gen, base, rank=8)
    with torch.no_grad():
        for f in adapter["factors"].values():
            f["b"].normal_(0.0, 0.02, generator=gen)
    merged = lora_mod.merge_lora(base, adapter)
    changed = sum(not torch.equal(merged[k], base[k]) for k in adapter["factors"])
    del srv
    lora_srv = LLMServer(LLMConfig(**bf16), params=merged)
    toks = asyncio.run(lora_srv.generate(prompt[:40], max_tokens=16))["tokens"]
    out["lora"] = dict(targets=len(adapter["factors"]), changed=changed,
                       params=lora_mod.lora_param_count(adapter), tokens=len(toks))
    log(f"[replica] LoRA rank 8 over {len(adapter['factors'])} weights "
        f"({out['lora']['params']:,} params), merged ({changed} weights changed) and served: "
        f"{len(toks)} tokens")
    if not (changed == len(adapter["factors"]) and len(toks) == 16
            and all(0 <= t < vocab for t in toks)):
        raise AssertionError(f"LoRA serve failed: {out['lora']}, tokens {toks}")
    del lora_srv, merged, base
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def profile_call(fn, device="cuda", ranges=()):
    """fn() under torch.profiler: wall time, the device's busy share of it
    (summed kernel time over wall time; the profiler's own cost is inside
    the wall time), the kernels that fill it, and for each named
    record_function range in `ranges` the device time of the kernels
    launched inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows, less the ranges that annotate host calls on the device
    # timeline (such as Optimizer.step#AdamW.step), which would count twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    row = lambda e: dict(name=e.key[:90], calls=e.count,
                         device_ms=e.self_device_time_total / 1e3)
    # a CPU range's device_time_total sums the kernels of the ops inside it
    spans = {name: dict(calls=0, device_ms=0.0) for name in ranges}
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            spans[e.key]["calls"] += e.count
            spans[e.key]["device_ms"] += e.device_time_total / 1e3
    return dict(wall_s=wall, device_kernel_s=device_us / 1e6,
                busy_share=(device_us / 1e6 / wall) if device_us else "not measured",
                launches=sum(e.count for e in kernels), top=[row(e) for e in top],
                flash=[row(e) for e in kernels if "flash_" in e.key], ranges=spans)


def log_profile(tag, what, out):
    share = (f"{out['busy_share']:.4f}" if out["device_kernel_s"] else "not measured")
    log(f"[{tag}] {what} under torch.profiler: wall {out['wall_s']:.3f} s, device "
        f"kernels {out['device_kernel_s']:.3f} s (busy share {share}), "
        f"{out['launches']} kernel launches")
    for row in out["top"]:
        log(f"[{tag}]   {row['device_ms']:9.3f} ms {row['calls']:6d} x {row['name']}")


def profile_wave(server, vocab, max_tokens=16, tag="profile", ranges=()):
    """One more wave of 8 fresh prompts under torch.profiler."""
    rng = np.random.default_rng(99)
    prompts = [rng.integers(1, vocab, n).tolist()
               for n in (17, 40, 64, 100, 128, 129, 200, 300)]
    before = server.stats()["decode"]
    out = profile_call(lambda: asyncio.run(serve_wave(server, prompts, max_tokens)),
                       ranges=ranges)
    after = server.stats()["decode"]
    out["decode_steps"] = sum(int(k) * (v - before["chunk_sizes"].get(k, 0))
                              for k, v in after["chunk_sizes"].items())
    out["decode_s"] = after["chunk_s_total"] - before["chunk_s_total"]
    log_profile(tag, f"8 requests x {max_tokens} tokens ({out['decode_steps']} "
                f"decode steps)", out)
    return out


# ------------------------------------------------------------------ train
def check_train_grads(device="cuda", tol=1e-4):
    """llama_1b width with 2 layers, f32, B=2, T=256: every parameter's
    gradient with attention through the kernels (forward, dQ, dK/dV)
    against the plain path (attn_impl="xla", autograd through
    mha_reference) on the same weights and batch. Tolerance: max error
    over the parameter's largest |grad| <= tol (the two paths differ in
    summation order only). Control: the plain path again with TF32 matrix
    products (10-bit mantissas), a lower-precision f32 path that must miss
    the limit."""
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.ops.losses import chunked_cross_entropy

    grads, losses = [], []
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 32000, (2, 257))).to(device)
    for impl, tf32 in (("flash", False), ("xla", False), ("xla", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        cfg = LlamaConfig.llama_1b(n_layers=2, dtype=torch.float32,
                                   param_dtype=torch.float32, attn_impl=impl)
        model = Llama(cfg, device=device)
        init_params(model, torch.Generator(device=device).manual_seed(3))
        before = flash_counts()
        hidden, _ = model(tokens[:, :-1], return_hidden=True)
        loss, _ = chunked_cross_entropy(hidden, model.lm_head.weight, tokens[:, 1:],
                                        chunk_size=256)
        loss.backward()
        launched = [a - b for a, b in zip(flash_counts(), before)]
        want = [2, 2, 2] if impl == "flash" else [0, 0, 0]
        if launched != want:
            raise AssertionError(f"attn_impl={impl}: fwd/dq/dkv launched {launched}")
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
        del model, hidden
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {n: rel_err(grads[0][n], g) for n, g in grads[1].items()}
    ctl = {n: rel_err(grads[2][n], g) for n, g in grads[1].items()}
    worst, ctl_worst = max(errs, key=errs.get), max(ctl, key=ctl.get)
    log(f"[train] llama_1b x 2 layers f32 B=2 T=256: loss kernels {losses[0]:.6f} vs "
        f"plain {losses[1]:.6f}; {len(errs)} parameter grads, worst {errs[worst]:.3e} "
        f"relative ({worst}; tol {tol}); control (plain path, TF32 products): loss "
        f"{losses[2]:.6f}, worst {ctl[ctl_worst]:.3e} ({ctl_worst})")
    if (errs[worst] > tol or abs(losses[0] - losses[1]) > 1e-5 * abs(losses[1])
            or ctl[ctl_worst] <= tol):
        raise AssertionError(f"train grads: {worst} err {errs[worst]}, control "
                             f"{ctl[ctl_worst]}, losses {losses}")
    return dict(loss_kernels=losses[0], loss_plain=losses[1], worst_param=worst,
                worst_rel_err=errs[worst], tol=tol, control_loss=losses[2],
                control_worst_param=ctl_worst, control_worst_rel_err=ctl[ctl_worst])


def check_head_bf16(device="cuda", b=4, t=2048, tol=1e-2):
    """The llama_1b step's loss head in bf16, B=4, T=2048, chunk 512:
    chunked_cross_entropy on bf16 hidden states and a bf16 lm_head weight
    (logits from a bf16 product with f32 output, dlogits cast to bf16
    before both backward products) against the same function on the
    operands widened to f32 (f32 products throughout). Limits: the loss
    within 1e-5 relative (the forward differs in summation order only), each
    gradient within tol of its largest |grad| (dlogits and both gradients
    rounded to bf16)."""
    import torch
    from ray_tpu_torch.ops.losses import chunked_cross_entropy

    gen = torch.Generator(device=device).manual_seed(11)
    hidden = torch.randn((b, t, 2048), generator=gen, device=device).bfloat16()
    w_head = (0.02 * torch.randn((32000, 2048), generator=gen, device=device)).bfloat16()
    labels = torch.randint(0, 32000, (b, t), generator=gen, device=device)
    res = []
    for dt in (torch.bfloat16, torch.float32):
        h = hidden.detach().to(dt).requires_grad_()
        w = w_head.detach().to(dt).requires_grad_()
        loss, aux = chunked_cross_entropy(h, w, labels, chunk_size=512)
        loss.backward()
        res.append((loss.item(), aux["accuracy"].item(), h.grad, w.grad))
        del h, w
    (loss16, acc16, dh16, dw16), (loss32, acc32, dh32, dw32) = res
    loss_err = abs(loss16 - loss32) / abs(loss32)
    dh_err, dw_err = rel_err(dh16, dh32), rel_err(dw16, dw32)
    log(f"[train] loss head bf16 vs f32-widened, B={b} T={t} chunk 512: loss {loss16:.6f} "
        f"vs {loss32:.6f} (rel {loss_err:.2e}, tol 1e-5), accuracy {acc16} vs {acc32}, "
        f"d hidden {dh_err:.3e}, d lm_head {dw_err:.3e} of max |grad| (tol {tol})")
    if loss_err > 1e-5 or dh_err > tol or dw_err > tol:
        raise AssertionError(f"bf16 head: loss rel {loss_err}, dh {dh_err}, dw {dw_err}")
    return dict(loss_bf16=loss16, loss_f32=loss32, loss_rel_err=loss_err,
                dhidden_rel_err=dh_err, dw_head_rel_err=dw_err, tol=tol)


def run_train(device="cuda", steps=10, warmup=2):
    """The training slice: train_llama("llama_1b", 4, 2048), its launch
    counts, throughput and peak memory; then one step under remat; then one
    step under torch.profiler."""
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import train_llama
    from ray_tpu_torch.train.llm_step import build_llama_trainer

    layers = LlamaConfig.llama_1b().n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    res = train_llama("llama_1b", 4, 2048, steps=steps, warmup_steps=warmup, device=device)
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), flash_counts()))
    peak = torch.cuda.max_memory_allocated()
    n = steps + warmup
    # MFU only on the card whose dense bf16 rate PEAK_FLOPS holds
    peak_flops = PEAK_FLOPS["bfloat16"] if torch.cuda.get_device_name() == H100_SXM else None
    mfu = res["tflops_per_s"] * 1e12 / peak_flops if peak_flops else "not measured"
    checks = {
        f"fwd, dq, dkv each launched {layers} x {n} steps":
            all(c == layers * n for c in launches.values()),
        "every loss finite": all(np.isfinite(res["losses"])),
        "params finite": res["params_finite"],
        "remat off (bench.py default at B=4)": res["remat"] is False,
    }
    for what, ok in checks.items():
        log(f"[train] {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[train] llama_1b B=4 T=2048 bf16: {res['ms_per_step']:.1f} ms/step, "
        f"{res['tokens_per_s']:.0f} tokens/s, {res['tflops_per_s']:.2f} TFLOP/s, MFU "
        f"{mfu if isinstance(mfu, str) else f'{mfu:.4f}'} (peak bf16 "
        f"{peak_flops}), peak memory {peak / 2**30:.2f} GiB, losses "
        f"{[round(x, 4) for x in res['losses']]}")
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: launches {launches}, res {res}")
    out = dict(res, launches=launches, peak_memory_bytes=peak, mfu=mfu,
               peak_bf16_flops=peak_flops)

    # (c) remat: the block forward runs again in the backward
    torch.cuda.empty_cache()
    reset_flash_counts()
    rem = train_llama("llama_1b", 4, 2048, steps=1, warmup_steps=0, remat=True,
                      device=device)
    rem_launches = flash_counts()
    rem_err = abs(rem["losses"][0] - res["losses"][0]) / abs(res["losses"][0])
    log(f"[train] remat step: fwd/dq/dkv launched {rem_launches} (want "
        f"[{2 * layers}, {layers}, {layers}]), loss {rem['losses'][0]:.6f} vs "
        f"{res['losses'][0]:.6f} without remat (rel {rem_err:.2e}, tol 1e-5), "
        f"{rem['ms_per_step']:.1f} ms/step")
    if rem_launches != [2 * layers, layers, layers] or rem_err > 1e-5:
        raise AssertionError(f"remat step: launches {rem_launches}, loss err {rem_err}")
    out["remat_step"] = dict(launches=rem_launches, loss=rem["losses"][0], rel_err=rem_err,
                        ms_per_step=rem["ms_per_step"])

    # (d) one step under the profiler, after one warm step
    torch.cuda.empty_cache()
    model, _, step, batches, dev = build_llama_trainer("llama_1b", 4, 2048, device=device)
    feed = lambda i: torch.from_numpy(batches[i]).to(dev)
    step(feed(0))
    prof = profile_call(lambda: step(feed(1)))
    log_profile("train", "one llama_1b step (B=4, T=2048)", prof)
    out["profile"] = prof
    # the step's flash kernels by name: forward, dQ and dK/dV are the
    # tensor-core kernels, 16 calls each, and the scalar bodies do not run
    by_kernel = {}
    for r in prof["flash"]:
        name = re.search(r"flash_\w+_kernel", r["name"]).group(0)
        calls, ms = by_kernel.get(name, (0, 0.0))
        by_kernel[name] = (calls + r["calls"], ms + r["device_ms"])
    for name, (calls, ms) in sorted(by_kernel.items()):
        log(f"[train]   {ms:9.3f} ms {calls:6d} x {name}")
    want = {name: layers for name in TC_KERNELS}
    if {n: c for n, (c, _) in by_kernel.items()} != want:
        raise AssertionError(f"profiled step's flash kernels {by_kernel}, want calls {want}")
    del model, step
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
    build_seconds = _build.build_seconds
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(_build.build_log)
    mma_counts = check_tensor_cores(_build.build())
    registers = check_spills(ptxas_report(_build.build_log))

    rng = np.random.default_rng(0)
    cases = []
    flash_err = check_flash(rng, cases)
    bwd_err, bwd_readings = check_flash_bwd(rng, cases)  # max-abs error of each kernel
    paged_err = check_paged(rng, cases)
    flash_t = {t: time_flash(rng, t) for t in (16, 128, 2048)}
    for t, r in flash_t.items():
        log(f"[kernels] flash_fwd T={t}: {r['ms']:.4f} ms (eager call {r['eager_ms']:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    train_t = time_flash_train(rng, cases)

    summary = run_slice()
    # B4 timed at the slice's decode batch (prompt lengths + 16 generated)
    # and at the long shape (every row a full 2048-token table), the latter
    # over 4 input sets (135 MB of K and V, more than the L2 cache holds)
    serve_lengths = [n + 16 for n in summary["prompt_lens"][:8]]
    paged_t = time_paged(rng, serve_lengths)
    paged_long = time_paged(rng, [2048] * 8, copies=4)
    paged_plans = sweep_paged_plan(rng, serve_lengths)
    for what, r in (("serve lengths", paged_t), ("long, lengths 2048", paged_long)):
        log(f"[kernels] paged_decode B=8 {what}: {r['ms']:.4f} ms (eager call "
            f"{r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), plan (n_split, pages_per_split) "
            f"{r['plan']}")

    import gc
    gc.collect()
    torch.cuda.empty_cache()   # the llama_1b server is gone; Mixtral needs the room
    moe = run_moe(rng)
    replica = run_replica()

    train = dict(grads=check_train_grads(), head_bf16=check_head_bf16(), **run_train())

    # one row per kernel; launches counted on each main path that was driven
    # (serve slice and train slice), timings at the training shape for the
    # flash kernels (the serving shapes are in chip_smoke.json and PERF.md),
    # max-abs error over the checked cases and the training shape
    def flash_row(name, source, replaces, err):
        t = train_t[name]
        by_path = {"serve": summary["launches"][name], "serve_moe": moe["launches"][name],
                   "train": train["launches"][name]}
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=max(err, t["max_abs_err"]), ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])

    kernels = [
        flash_row("flash_fwd", "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                  "ray_tpu/ops/flash_attention.py:37", flash_err),
        flash_row("flash_bwd_dq", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                  "ray_tpu/ops/flash_attention.py:138", bwd_err["flash_bwd_dq"]),
        flash_row("flash_bwd_dkv", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                  "ray_tpu/ops/flash_attention.py:175", bwd_err["flash_bwd_dkv"]),
        dict(name="paged_decode", route="cuda",
             source="ray_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:38",
             launches=summary["launches"]["paged_decode"] + moe["launches"]["paged_decode"],
             launches_by_path={"serve": summary["launches"]["paged_decode"],
                               "serve_moe": moe["launches"]["paged_decode"]},
             combine_launches=(summary["launches"]["paged_decode_combine"]
                               + moe["launches"]["paged_decode_combine"]),
             max_abs_err=paged_err, ms=paged_t["ms"], plain_ms=paged_t["plain_ms"],
             bound_ms=paged_t["bound_ms"], bound_by=paged_t["bound_by"], library_ms=None),
    ]
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=build_seconds, tensor_core_instructions=mma_counts,
        ptxas=registers, cases=cases, bwd_readings=bwd_readings,
        flash_timing=list(flash_t.values()), train_kernel_timing=train_t,
        paged_timing=paged_t, paged_timing_long=paged_long, paged_plans=paged_plans,
        slice=summary, moe=moe, replica=replica, train=train,
        kernels=kernels),
        indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
