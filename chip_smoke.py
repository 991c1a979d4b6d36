#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Ten phases; a failure in any of them exits non-zero and prints no result.

1. device  -- requires CUDA; prints the card's name and power limit.
2. build   -- builds every kernel of `paddle_tpu_torch/csrc` with nvcc.
3. kernels -- holds each kernel against its plain PyTorch version on the
              card, in bf16, at the serving and training paths' shapes
              (decode and chunk prefill for the paged kernels, int8 pages
              for K4, the lock-step prefill for K6), and times kernel,
              plain version and (where one exists) the PyTorch library call
              with CUDA events; then every other variant the wrappers
              launch, untimed, on every kernel path their dispatch rules
              pick (K1/K6: wgmma + TMA, mma.sync, FMA; K2/K4/K5: the
              tensor-core chunk window, the FMA page walk).  K5
              (context-parallel decode) is timed beside K2 over the same
              global arena; the chunk windows of K2, K4 and K5 are timed
              apart.
4. slice   -- serves a full-width, full-depth Llama-2-7B (bf16, random
              weights from a seeded generator) through the paged engine
              behind `POST /generate`, checks the token counts and that every
              prefill and decode step launched the two kernels, then
              teacher-forces the generated sequences through the full-sequence
              forward and compares logits.
5. prefix  -- the same model behind prefix-cached engines, in full precision
              and over int8 pages: requests sharing a system prompt hit the
              cache, copy its tail page and chunk-prefill their suffix; checks
              token counts, hits and copies, the launches of K1, K2 and K4
              (every chunk prefill on the tensor-core path), logits against
              the teacher-forced forward, and prints the int8 run's greedy
              agreement with the full-precision run.
6. generate -- the same model's lock-step `generate`: greedy over four
              500-token prompts, beam search, seeded sampling twice, a short
              prompt; K6 launched once per layer by every prefill of 64+
              tokens and never otherwise, no other kernel; prefill and
              decode logits against the teacher-forced forward; then a
              `GenerationPredictor` behind `POST /generate`.
7. dense   -- the same model behind the dense slot-pool engine
              (`paged=False`) over HTTP: token counts, K1 once per layer per
              prefill and no other kernel, logits against the teacher-forced
              forward, decode tokens/s and TTFT beside the paged slice's.
8. cp      -- the same model behind long-document engines (slots 4, the
              4096-token context): questions about one 3000-token document
              share its pages through the prefix cache, beside two fresh
              prompts, over HTTP; at cp=1, then cp=2 (the page audit every
              step), cp=2 with speculative decoding (spec_k=2), and the
              same over int8 pages.  Checks token counts, /healthz, the 400
              answer to a prompt past the context, K5 launched once per
              shard per layer per paged attention (no K2 or K4 under cp;
              every chunk prefill on the tensor-core path),
              logits against the teacher-forced forward; prints the greedy
              agreement between runs, speculation counters, decode
              tokens/s and TTFT, and a profiled cp=2 decode step.
9. train   -- trains Llama-2-7B's widths at 8 layers (bf16 AMP O2, AdamW with
              float32 master weights) for 6 steps on one repeated batch of
              4 x 2048 tokens: finite and falling losses, K1 (on its wgmma
              path) and K3 launched once per layer per step, every weight
              moved; step time,
              tokens/s, peak memory and a profiled step.
              Then 2 steps of 2 layers with activation recompute (K1 twice
              per layer per step).
10. grads  -- one step's gradients of a 2-layer model at the same widths
              with the kernels against the same step with attention through
              the plain forward under autograd.

Every phase prints its wall time.  The line before the last is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor
# FLOP/s and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12

# bf16 tolerances, kernel vs plain version on the same inputs: |kernel -
# plain| <= KERNEL_ATOL + KERNEL_RTOL * |plain| elementwise.  Both sides
# accumulate in f32 but round the probabilities and the output to bf16 at
# different points (online vs dense softmax), so they may land one bf16 ulp
# apart: up to 2^-7 relative, hence rtol 2e-2; atol covers outputs near 0.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2e-2
LSE_ATOL = 1e-3
# float32 (accepted for parity): the same sums re-associated, no rounding
# of p, so far tighter
F32_ATOL = 1e-4
F32_RTOL = 1e-4
# per (slot, head): ||kernel - plain|| / ||plain|| over all rows and dims.
# Outputs of a long context are small (|out| ~ 0.03 at 2000 keys), where
# the atol above holds loosely.  At the K2 shapes below, reading one
# 128-key page twice in place of another moves this norm by 0.50-0.75 for
# every slot past one page (the plain version, so computed); bf16 rounding
# moves it by ~3e-3.
REL_NORM_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# bf16 slice: logits of the paged engine (K1 over the bucket, K2 over pages)
# against the teacher-forced full-sequence forward (K1 over the whole
# sequence).  Different matmul shapes round differently through 32 bf16
# layers; the bound is on max|diff| / max|logit| per request.
LOGIT_REL_TOL = 0.1

SLICE_PROMPTS = [(20, 64), (77, 48), (200, 32), (333, 40), (500, 32), (45, 64)]
# the prefix phase: 8 requests share a 300-token system prompt (2 full
# 128-row pages and a 44-row tail, so every hit copies the tail page), each
# with its own suffix, 32 new tokens each
PREFIX_SYS_LEN = 300
PREFIX_SUFFIXES = [20, 45, 77, 100, 130, 160, 185, 200]
PREFIX_NEW = 32

# the generate phase: lock-step greedy over GEN_BATCH prompts of GEN_LEN
# tokens (a 640-row cache: K6 over 500 rows at pos 0), beam search over one
# BEAM_LEN-token prompt, seeded sampling, and a prompt too short for K6
GEN_BATCH = 4
GEN_LEN = 500
GEN_NEW = 64
BEAM_LEN = 128
BEAM_NEW = 32
BEAMS = 4
SHORT_LEN = 20
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)
PREDICTOR_LENS = [70, 100, 130]

# the cp phase: questions about one 3000-token document (23 full 128-row
# pages and a 56-row tail) share its pages through the prefix cache; the
# first question commits alone, the other three hit the cache beside two
# fresh prompts; every request gets 32 new tokens; a 4100-token prompt is
# past the 4096-token context.  Runs, one engine at a time: (label, cp,
# spec_k, kv_quant, page audit every step)
CP_DOC_LEN = 3000
CP_QUESTIONS = [120, 40, 150, 200]
CP_FRESH = [1500, 3500]
CP_NEW = 32
CP_OVERFLOW = 4100
CP_RUNS = [("a cp1", 1, 0, "none", False), ("b cp2", 2, 0, "none", True),
           ("c cp2 spec2", 2, 2, "none", False),
           ("d cp2 spec2 int8", 2, 2, "int8", False)]

# K5's timed case: 8 slots at per-slot positions drawn from 3000-4000 of a
# 4096-token context (numpy.random.default_rng(5).integers(3000, 4001, 8))
K5_DECODE_POS = [3671, 3805, 3022, 3808, 3469, 3515, 3630, 3286]

# the training slice: Llama-2-7B widths at 8 layers (AdamW's float32 state
# for all 32 would not fit one card), batch 4 x 2048 tokens, bf16 O2
TRAIN_LAYERS = 8
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 6


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median milliseconds of `fn()` over `iters` runs, each bracketed by
    its own CUDA events, after `warmup` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_norm_err(out, ref):
    """Largest ||out - ref|| / ||ref|| over the (batch, head) slices of two
    [b, s, h, d] tensors."""
    b, h = ref.shape[0], ref.shape[2]
    o = out.float().transpose(1, 2).reshape(b * h, -1)
    r = ref.float().transpose(1, 2).reshape(b * h, -1)
    return ((o - r).norm(dim=1) / r.norm(dim=1)).max().item()


def close(out, ref):
    """Finite, elementwise within the dtype's tolerance of the plain
    version, and within REL_NORM_TOL per (batch, head)."""
    import torch

    name = str(ref.dtype).removeprefix("torch.")
    atol, rtol = ((KERNEL_ATOL, KERNEL_RTOL) if name == "bfloat16"
                  else (F32_ATOL, F32_RTOL))
    o, r = out.float(), ref.float()
    return (bool(torch.isfinite(o).all())
            and bool(((o - r).abs() <= atol + rtol * r.abs()).all())
            and rel_norm_err(out, ref) <= REL_NORM_TOL[name])


def _main(counts):
    """The launch counts that are not zero, for a log line."""
    return {name: n for name, n in counts.items() if n}


def bound(nbytes, flops, peak_flop_s=PEAK_BF16_FLOP_S):
    """The least milliseconds the card could take: the larger of the bytes
    over the memory rate and the operations over `peak_flop_s`."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"device {torch.cuda.get_device_name(0)} "
                  f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    return smi


def _ptxas_summary(report):
    """One line per compiled kernel from `ptxas -v`: its name, registers and
    spills, and the head of its mangled name (which tells the template
    instances apart)."""
    import re

    out, name, spill = [], None, ""
    for line in report.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name, spill = found.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif name and (found := re.search(r"Used (\d+) registers", line)):
            short = re.search(r"([a-z][a-z_]*_kernel)", name)
            out.append(f"{short.group(1) if short else name}: {found.group(1)} "
                       f"registers, {spill} [{name[:72]}]")
            name = None
    return out


def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    secs = time.perf_counter() - t0
    for line in _ptxas_summary(_build.build.ptxas_report):
        log("build", "ptxas: " + line)
    log("build", f"built {path.name} from "
                 f"{[p.name for p in _build.sources()]} in {secs:.2f} s")
    return secs


def _k1_case(b, s, h, hk, d=128, seed=0, dtype="bfloat16", causal=True,
             timed=True):
    """K1 against its plain version; with `timed`, also kernel, plain and
    library times and the bound (the causal bf16 serving shapes)."""
    import torch
    from torch.nn import functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(b, s, heads, d, generator=g, device="cuda",
                                   dtype=getattr(torch, dtype))
    q, k, v = mk(h), mk(hk), mk(hk)
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal, 1.0 / d ** 0.5)
    err = (out.float() - ref_out.float()).abs().max().item()
    rel = rel_norm_err(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    ok = close(out, ref_out) and lse_err <= LSE_ATOL
    shape = (f"flash_fwd {dtype} b={b} s={s} h={h} hk={hk} d={d} "
             f"causal={causal} path {fa.flash_path(s, d, q.dtype)}: max_abs_err "
             f"{err:.3e}, rel_norm_err {rel:.3e}, lse_err {lse_err:.3e}")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    rep = h // hk
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
    ms = time_ms(lambda: fa.flash_forward(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_forward_plain(q, k, v, True, 1.0 / d ** 0.5))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    nbytes = 2 * (q.numel() * 2 + k.numel() * 2) + 4 * lse.numel()
    flops = 4 * d * h * b * s * (s + 1) // 2  # causal (q, k) pairs
    bms, by = bound(nbytes, flops)
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
                   f"library_ms {lib_ms:.4f}, bound_ms {bms:.5f} ({by}) -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)


def _paged_inputs(b, sq, h, hk, pos, d, ps, max_len, seed, dtype, quant,
                  overrun):
    """q, arenas, (scales), tables and pos of a paged case on the card.  The
    arenas hold random rows, quantized by the engine's own quantizer under
    int8; page 0 is scratch, zero (scale 0) as in a fresh arena.  Tables are
    a random permutation of the other pages; with `overrun`, entries past
    each slot's page of `pos` point at scratch, so the window's later rows
    read it."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.paging import check_table_bounds
    from paddle_tpu_torch.models.llama import _quantize_kv_rows

    P = -(-max_len // ps)
    pages = b * P + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    ak = torch.randn(pages, ps, hk, d, generator=g, device="cuda", dtype=dt)
    av = torch.randn(pages, ps, hk, d, generator=g, device="cuda", dtype=dt)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda", dtype=dt)
    scales = ()
    if quant:
        (ak, ks), (av, vs) = _quantize_kv_rows(ak), _quantize_kv_rows(av)
        for t in (ak, av, ks, vs):
            t[0] = 0
        scales = (ks, vs)
    rng = np.random.default_rng(seed)
    tables_np = rng.permutation(np.arange(1, pages)).astype(np.int32).reshape(b, P)
    if overrun:
        for s_, p in enumerate(pos):
            tables_np[s_, p // ps + 1:] = 0
    check_table_bounds(tables_np, pages)
    tables = torch.from_numpy(tables_np).cuda()
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q, ak, av, scales, tables, pos_t


def _k2_case(b, sq, h, hk, pos, d=128, ps=128, max_len=2048, seed=1,
             dtype="bfloat16", timed=True, quant=False, overrun=False,
             library=False):
    """K2 (or, with `quant`, K4 over an int8 arena) against its plain
    version; with `timed`, also kernel and plain times and the bound, and
    with `library` the time of PyTorch's SDPA over the gathered live K/V
    with the kernel's mask (K2 only: no PyTorch call reads int8 pages)."""
    import torch
    from torch.nn import functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    q, ak, av, scales, tables, pos_t = _paged_inputs(
        b, sq, h, hk, pos, d, ps, max_len, seed, dtype, quant, overrun)
    name = "paged_decode_fused_q8" if quant else "paged_decode_fused"
    kernel = fa.paged_decode_fused_q8 if quant else fa.paged_decode_fused
    plain = fa.paged_decode_q8_plain if quant else fa.paged_decode_plain
    args = (q, ak, av, *scales, tables, pos_t, max_len)
    out = kernel(*args)
    torch.cuda.synchronize()
    scale = 1.0 / d ** 0.5
    ref = plain(*args, scale)
    err = (out.float() - ref.float()).abs().max().item()
    rel = rel_norm_err(out, ref)
    ok = close(out, ref)
    path = fa.paged_path((h // hk) * sq, d, q.dtype)
    shape = (f"{name} {dtype} b={b} sq={sq} h={h} hk={hk} d={d} ps={ps} "
             f"pos={pos}{' overrun' if overrun else ''} path {path}: max_abs_err "
             f"{err:.3e}, rel_norm_err {rel:.3e}")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args, scale))
    lib_ms = None
    if library:
        # one live prefix per slot: the gathered K/V [b, hk, live, d] and
        # the kernel's mask (row w sees jid <= pos + w)
        live = max(pos) + sq
        kg = fa.paged_gather_kv(ak, tables, live).transpose(1, 2).contiguous()
        vg = fa.paged_gather_kv(av, tables, live).transpose(1, 2).contiguous()
        jid = torch.arange(live, device="cuda")
        w = torch.arange(sq, device="cuda")
        mask = jid[None, None, None, :] <= pos_t.view(b, 1, 1, 1) + w.view(1, 1, sq, 1)
        qt = q.transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=h != hk))
    # bytes this data needs: each slot's live K/V rows of every kv head (and
    # their float32 scales under int8), q, out, tables and pos; operations
    # over the visible (row, key) pairs, at the peak of the units that run
    # them: the bf16 tensor peak for K2 and for the tensor-core chunk window
    # (int8 pages too: it converts them to bf16 exactly), the float32 peak
    # for K4's FMA page walk (its products are float32, as the reference's
    # are)
    live = [min(p + sq, max_len) for p in pos]
    row_bytes = d + 4 if quant else d * 2
    nbytes = (sum(live) * hk * row_bytes * 2 + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + b * 4)
    visible = sum(min(p + w + 1, max_len) for p in pos for w in range(sq))
    flops = 4 * d * h * visible
    f32_units = quant and path == "fma"
    bms, by = bound(nbytes, flops, PEAK_F32_FLOP_S if f32_units else PEAK_BF16_FLOP_S)
    lib_txt = "null" if lib_ms is None else f"{lib_ms:.4f}"
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
                   f"library_ms {lib_txt}, bound_ms {bms:.5f} ({by}) -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)


def _k3_case(b, s, h, hk, d=128, seed=6, dtype="bfloat16", causal=True,
             timed=True):
    """K3 against its plain version on K1's out and lse, dq, dk and dv each
    within the dtype's tolerance; with `timed`, also kernel, plain and
    library times (the backward of PyTorch's SDPA alone, through
    torch.autograd.grad) and the bound."""
    import torch
    from torch.nn import functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(b, s, heads, d, generator=gen, device="cuda",
                                   dtype=getattr(torch, dtype))
    q, k, v, g = mk(h), mk(hk), mk(hk), mk(h)
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    args = (q, k, v, out, lse, g, causal, scale)
    got = fa.flash_backward(*args)
    torch.cuda.synchronize()
    ref = fa.flash_backward_plain(*args)
    errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
    rels = [rel_norm_err(x, r) for x, r in zip(got, ref)]
    ok = all(close(x, r) for x, r in zip(got, ref))
    shape = (f"flash_bwd {dtype} b={b} s={s} h={h} hk={hk} d={d} causal={causal}: "
             f"max_abs_err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, "
             f"rel_norm_err {rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e}")
    del ref
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=max(errs))
    ms = time_ms(lambda: fa.flash_backward(*args))
    plain_ms = time_ms(lambda: fa.flash_backward_plain(*args), iters=5, warmup=1)
    rep = h // hk
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(rep, 1).detach().requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(rep, 1).detach().requires_grad_()
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt,
                                                 retain_graph=True))
    # each input read once (q, k, v, out, g, lse), each output written once
    # (dq, dk, dv); five products of 2*d FLOP per visible (q, k) pair
    nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * lse.numel()
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    bms, by = bound(nbytes, 10 * d * pairs)
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
                   f"library_ms {lib_ms:.4f}, bound_ms {bms:.5f} ({by}) -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _k6_case(b, sq, h, hk, d=128, L=640, pos=0, seed=14, dtype="bfloat16",
             timed=True):
    """K6 against its plain version over a static cache written up to
    pos + sq (later rows zero, as a fresh cache); with `timed`, also kernel,
    plain and library times (PyTorch's SDPA with the boolean mask j <= pos +
    i over the whole cache) and the bound."""
    import torch
    from torch.nn import functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda", dtype=dt)
    k = torch.zeros(b, L, hk, d, device="cuda", dtype=dt)
    v = torch.zeros(b, L, hk, d, device="cuda", dtype=dt)
    live = min(pos + sq, L)
    k[:, :live] = torch.randn(b, live, hk, d, generator=g, device="cuda", dtype=dt)
    v[:, :live] = torch.randn(b, live, hk, d, generator=g, device="cuda", dtype=dt)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = fa.dense_decode(q, k, v, pos_t)
    torch.cuda.synchronize()
    ref = fa.decode_attention_plain(q, k, v, pos_t)
    err = (out.float() - ref.float()).abs().max().item()
    rel = rel_norm_err(out, ref)
    ok = close(out, ref)
    shape = (f"dense_decode {dtype} b={b} sq={sq} h={h} hk={hk} d={d} L={L} "
             f"pos={pos}: max_abs_err {err:.3e}, rel_norm_err {rel:.3e}")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    ms = time_ms(lambda: fa.dense_decode(q, k, v, pos_t))
    plain_ms = time_ms(lambda: fa.decode_attention_plain(q, k, v, pos_t))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    i = torch.arange(sq, device="cuda")[:, None]
    j = torch.arange(L, device="cuda")[None, :]
    mask = j <= pos + i
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=h != hk))
    # bytes: q and out, and each sequence's live K/V rows of every kv head;
    # operations: 4 d FLOP per visible (row, key) pair at the bf16 peak
    nbytes = 2 * q.numel() * q.element_size() + 2 * b * live * hk * d * k.element_size()
    visible = sum(min(pos + r + 1, L) for r in range(sq))
    bms, by = bound(nbytes, 4 * d * h * b * visible)
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
                   f"library_ms {lib_ms:.4f}, bound_ms {bms:.5f} ({by}) -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)


def _cp_inputs(b, sq, h, hk, pos, d, ps, max_len, cp, seed, dtype, quant,
               device="cuda"):
    """q, global arenas, (scales), tables and pos of a cp case: the engine's
    round-robin layout, shard s owning pages [s*per_shard, (s+1)*per_shard)
    with its scratch page (zero, scale 0) first and sequence page j of
    every slot on shard j % cp, a random permutation of the shard's pages.
    Under int8 the rows are quantized by the engine's own quantizer."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.paging import check_table_bounds
    from paddle_tpu_torch.models.llama import _quantize_kv_rows

    P = -(-(-(-max_len // ps)) // cp) * cp
    per = b * (P // cp) + 1
    pages = cp * per
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda *shape: torch.randn(*shape, generator=g, device=device, dtype=dt)
    ak, av, q = mk(pages, ps, hk, d), mk(pages, ps, hk, d), mk(b, sq, h, d)
    scales = ()
    if quant:
        (ak, ks), (av, vs) = _quantize_kv_rows(ak), _quantize_kv_rows(av)
        scales = (ks, vs)
    for t in (ak, av, *scales):
        t[::per] = 0  # every shard's scratch page
    rng = np.random.default_rng(seed)
    tables_np = np.zeros((b, P), np.int32)
    for s in range(cp):
        ids = rng.permutation(np.arange(s * per + 1, (s + 1) * per))
        tables_np[:, s::cp] = ids.reshape(b, P // cp)
    check_table_bounds(tables_np, pages)
    tables = torch.from_numpy(tables_np).to(device)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
    return q, ak, av, scales, tables, pos_t


def _cp_run(q, ak, av, scales, local, pos_t, max_len, cp, scale, partials):
    """One shard-by-shard pass of K5's function: `partials` (the kernel's
    wrapper or its plain version) per shard over its slice of the arena,
    then the combine.  Returns (output [b, sq, h, d], per-shard partials)."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    per = ak.shape[0] // cp
    parts = []
    for s, (loc, base) in enumerate(local):
        sl = slice(s * per, (s + 1) * per)
        sc = (scales[0][sl], scales[1][sl]) if scales else (None, None)
        parts.append(partials(q, ak[sl], av[sl], loc, base, pos_t, max_len,
                              scale, *sc))
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    b, sq, h, d = q.shape
    out = fa.cp_softmax_combine(acc, m, l).reshape(b, h, sq, d)
    return out.permute(0, 2, 1, 3).to(q.dtype), parts


def _partials_ok(got, ref, dtype):
    """K5's per-shard partials against the plain version's: on every row
    that sees a key, m within 1e-3, l within 1e-3 relative (both sum the
    same float32 exponentials) and acc / l within `close()`'s tolerance of
    the plain acc / l (the normalised shard output, whose rounding both
    tolerance families describe); on a row that sees none, m = -1e30 in
    both (its l and acc are the masked scores' leftovers, which only the
    merge's e^(m - m*) = 0 removes, and are not compared)."""
    import torch

    name = str(dtype).removeprefix("torch.")
    atol, rtol = ((KERNEL_ATOL, KERNEL_RTOL) if name == "bfloat16"
                  else (F32_ATOL, F32_RTOL))
    ok = True
    for (a, m, l), (ra, rm, rl) in zip(got, ref):
        seen = rm > -1e29  # [b, hk, R, 1]
        ok &= bool(torch.isfinite(a).all() and torch.isfinite(m).all()
                   and torch.isfinite(l).all())
        ok &= bool((m[~seen] == rm[~seen]).all())
        ok &= bool(((m - rm).abs()[seen] <= 1e-3).all())
        ok &= bool(((l - rl).abs()[seen] <= 1e-3 * rl[seen]).all())
        o = torch.where(seen, a / l.clamp(min=1e-30), 0.0)
        r = torch.where(seen, ra / rl.clamp(min=1e-30), 0.0)
        ok &= bool(((o - r).abs() <= atol + rtol * r.abs()).all())
    return ok


def _k5_case(b, sq, h, hk, pos, d=128, ps=128, max_len=4096, cp=2, seed=20,
             dtype="bfloat16", quant=False, timed=True, device="cuda"):
    """K5 (`paged_decode_partials`, one launch per shard, then the combine)
    against its plain version over a global arena in the cp layout: the
    combined output against `paged_decode_plain` (or its int8 version)
    over the global arena and tables, and each shard's partials against
    `paged_decode_partials_plain`.  With `timed`, also K5's time (every
    shard's launch plus the combine, the cp tables derived beforehand as
    the engine derives them once per table upload), K2's over the same
    global arena and tables (no PyTorch call reads pages: this is what cp
    costs on one card), the plain version's and the bound."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    q, ak, av, scales, tables, pos_t = _cp_inputs(
        b, sq, h, hk, pos, d, ps, max_len, cp, seed, dtype, quant, device)
    local = fa.cp_local_tables(tables, cp, ak.shape[0] // cp, ps)
    scale = 1.0 / d ** 0.5
    kw = dict(k_scale=scales[0], v_scale=scales[1]) if quant else {}
    out = fa.paged_decode_cp(q, ak, av, tables, pos_t, max_len, cp, local=local, **kw)
    _, parts = _cp_run(q, ak, av, scales, local, pos_t, max_len, cp, scale,
                       fa.paged_decode_partials)
    if device == "cuda":
        torch.cuda.synchronize()
    plain, plain_parts = _cp_run(q, ak, av, scales, local, pos_t, max_len, cp,
                                 scale, fa.paged_decode_partials_plain)
    glob = (fa.paged_decode_q8_plain(q, ak, av, *scales, tables, pos_t, max_len, scale)
            if quant
            else fa.paged_decode_plain(q, ak, av, tables, pos_t, max_len, scale))
    err = (out.float() - glob.float()).abs().max().item()
    rel = rel_norm_err(out, glob)
    parts_ok = _partials_ok(parts, plain_parts, q.dtype)
    ok = close(out, glob) and close(plain, glob) and parts_ok
    name = "paged_decode_fused_cp_q8" if quant else "paged_decode_fused_cp"
    rows = (h // hk) * sq
    path = fa.paged_path(rows, d, q.dtype)
    shape = (f"{name} {dtype} b={b} sq={sq} h={h} hk={hk} d={d} ps={ps} cp={cp} "
             f"max_len={max_len} pos={pos} path {path} splits/shard="
             f"{fa.paged_splits(path, b, hk, rows, tables.shape[1] // cp, ps)}: "
             f"max_abs_err {err:.3e}, rel_norm_err {rel:.3e} vs the global "
             f"plain version, partials {'ok' if parts_ok else 'WRONG'}")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    ms = time_ms(lambda: fa.paged_decode_cp(q, ak, av, tables, pos_t, max_len, cp,
                                            local=local, **kw))
    plain_ms = time_ms(lambda: _cp_run(q, ak, av, scales, local, pos_t, max_len,
                                       cp, scale, fa.paged_decode_partials_plain))
    k2_ms = (None if quant else
             time_ms(lambda: fa.paged_decode_fused(q, ak, av, tables, pos_t, max_len)))
    # bytes: q, each slot's live K/V rows of every kv head (scales under
    # int8), the local tables, page_base and pos read once, every shard's
    # partials written once, the output written once; operations over the
    # visible (row, key) pairs at the bf16 tensor peak (the float32 peak for
    # the FMA page walk over int8 pages)
    live = [min(p + sq, max_len) for p in pos]
    row_bytes = d + 4 if quant else d * 2
    R = (h // hk) * sq
    nbytes = (sum(live) * hk * row_bytes * 2 + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + tables.shape[1] * 4 + cp * b * 4
              + cp * b * hk * R * (d + 2) * 4)
    visible = sum(min(p + w + 1, max_len) for p in pos for w in range(sq))
    bms, by = bound(nbytes, 4 * d * h * visible,
                    PEAK_F32_FLOP_S if quant and path == "fma" else PEAK_BF16_FLOP_S)
    k2_txt = "n/a" if k2_ms is None else f"{k2_ms:.4f}"
    log("kernels", f"{shape}, kernel_ms {ms:.4f} ({cp} launches + combine), "
                   f"k2_same_arena_ms {k2_txt}, plain_ms {plain_ms:.4f}, "
                   f"library_ms null, bound_ms {bms:.5f} ({by}) -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None, k2_same_arena_ms=k2_ms)


# The chunk window's tensor-core path (rows = rep * sq >= 16, bf16, d 64 or
# 128), each case over bf16 and over int8 pages: the smallest tile, 16 + 1
# rows, one full tile, a ragged second tile, the largest bucket, GQA rep 4
# x sq 64, d 64 at page size 64, and a window running into scratch page 0
# with 16-row pages (a key tile spans four pages)
CHUNK_CASES = (
    dict(b=2, sq=16, h=32, hk=32, pos=[700, 5]),
    dict(b=2, sq=17, h=32, hk=32, pos=[300, 40]),
    dict(b=1, sq=64, h=32, hk=32, pos=[1000]),
    dict(b=2, sq=65, h=32, hk=32, pos=[129, 1500]),
    dict(b=1, sq=512, h=32, hk=32, pos=[300]),
    dict(b=2, sq=64, h=32, hk=8, pos=[1000, 44]),
    dict(b=2, sq=40, h=8, hk=2, pos=[900, 40], d=64, ps=64, max_len=1024),
    dict(b=3, sq=16, h=8, hk=2, pos=[14, 30, 7], d=64, ps=16, max_len=256,
         overrun=True),
)


def phase_kernels():
    """Each kernel against its plain version: timed at the main paths' bf16
    shapes, then untimed over every other variant the wrappers launch on
    the card (float32, head_dim 64 and 256, non-causal, GQA, ragged, the
    largest shared memory, each kernel path of `flash_path` and
    `paged_path`).  Returns ({name: record at the headline shape}, all_ok);
    the record's max_abs_err is the worst over the bf16 cases of that
    entry."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    log("kernels", f"tolerances: |kernel - plain| <= atol + rtol |plain| with "
                   f"(atol, rtol) = ({KERNEL_ATOL}, {KERNEL_RTOL}) in bf16, "
                   f"({F32_ATOL}, {F32_RTOL}) in f32; lse within {LSE_ATOL}; "
                   f"rel_norm_err per (batch, head) <= {REL_NORM_TOL}")
    ok_all = True

    def case(fn, errs, **kw):
        nonlocal ok_all
        ok, rec = fn(**kw)
        ok_all &= ok
        if kw.get("dtype", "bfloat16") == "bfloat16" and errs is not None:
            errs.append(rec["max_abs_err"])
        return rec

    # K1: the serving prefill buckets (s 16 on mma.sync, 128 and 512 on
    # wgmma) timed, then ragged GQA, non-causal and d 64 on both paths
    errs1 = []
    k1 = {s: case(_k1_case, errs1, b=1, s=s, h=32, hk=32) for s in (16, 128, 512)}
    for kw in (dict(b=1, s=300, h=32, hk=8),                  # ragged, GQA
               dict(b=1, s=128, h=32, hk=32, causal=False),
               dict(b=2, s=300, h=16, hk=4, d=64, causal=False),
               dict(b=1, s=512, h=16, hk=16, d=64),
               dict(b=2, s=16, h=8, hk=2, d=64),
               dict(b=1, s=2048, h=8, hk=8, causal=False)):
        case(_k1_case, errs1, seed=3, timed=False, **kw)
    decode_pos = [1999, 1500, 1024, 700, 300, 128, 127, 5]
    errs2 = []
    k2 = case(_k2_case, errs2, b=8, sq=1, h=32, hk=32, pos=decode_pos)
    case(_k2_case, errs2, b=4, sq=4, h=32, hk=8, pos=[1000, 513, 64, 0], seed=2)
    # the chunk prefill of a prefix-cache hit: a 256-row suffix bucket at
    # position 300 on the tensor-core path, timed beside SDPA on the
    # gathered K/V; then every chunk case untimed
    errs2c, errs4c = [], []
    k2c = case(_k2_case, errs2c, b=1, sq=256, h=32, hk=32, pos=[300], seed=9,
               library=True)
    for kw in CHUNK_CASES:
        case(_k2_case, errs2c, seed=10, timed=False, **kw)
    # K4: int8 pages at the decode case and the chunk window, timed, then
    # the chunk cases and its other variants untimed
    errs4 = []
    k4 = case(_k2_case, errs4, b=8, sq=1, h=32, hk=32, pos=decode_pos, seed=11,
              quant=True)
    k4c = case(_k2_case, errs4c, b=1, sq=256, h=32, hk=32, pos=[300], seed=12,
               quant=True)
    for kw in CHUNK_CASES:
        case(_k2_case, errs4c, seed=13, timed=False, quant=True, **kw)
    for kw in (
        dict(b=4, sq=4, h=32, hk=8, pos=[1000, 513, 64, 0]),        # GQA, sq 4
        dict(b=4, sq=1, h=32, hk=8, pos=[1500, 700, 129, 3], dtype="float32"),
        dict(b=2, sq=2, h=8, hk=2, pos=[900, 40], d=64, ps=64, max_len=1024),
        # scalar tile loads (d bytes not a multiple of 16), 2 splits
        dict(b=2, sq=1, h=4, hk=2, pos=[700, 10], d=36, ps=16, max_len=1024),
        # windows running past the mapped pages into scratch page 0, on
        # the FMA page walk (12 rows; CHUNK_CASES has the tensor-core one)
        dict(b=3, sq=3, h=8, hk=2, pos=[14, 30, 7], d=64, ps=16, max_len=256,
             overrun=True),
        # float32 q at 64 rows: the FMA page walk
        dict(b=1, sq=64, h=8, hk=8, pos=[300], d=64, ps=64, max_len=1024,
             dtype="float32"),
    ):
        case(_k2_case, errs4, seed=13, timed=False, quant=True, **kw)
    # the other variants: each line is one kernel instantiation or mode
    for kw in (
        dict(b=1, s=128, h=32, hk=32, dtype="float32"),   # f32 FMA, d 128
        dict(b=1, s=100, h=8, hk=2, d=256, dtype="float32"),  # f32 FMA, d 256
        dict(b=1, s=200, h=16, hk=4, d=256),              # bf16 FMA, d 256
        dict(b=2, s=130, h=32, hk=8, d=64),               # wgmma<64>
        dict(b=2, s=100, h=32, hk=8, causal=False),       # non-causal mma<128>
        dict(b=1, s=150, h=8, hk=8, d=64, causal=False, dtype="float32"),
        dict(b=1, s=70, h=4, hk=2, d=36),                 # mma<64>, scalar loads
        dict(b=1, s=200, h=8, hk=2, d=100),               # mma<128>, d not 64/128
    ):
        case(_k1_case, errs1, seed=4, timed=False, **kw)
    for kw in (
        dict(b=4, sq=1, h=32, hk=8, pos=[1500, 700, 129, 3], dtype="float32"),
        # largest shared memory (a 64-row tile at d 256), then a partial
        # second tile whose first row sits mid-window (rep 32 x sq 3 = 96)
        dict(b=2, sq=3, h=32, hk=1, pos=[900, 40], d=256, ps=64, max_len=1024),
        # scalar tile loads (d * 2 bytes not a multiple of 16), 2 splits
        dict(b=2, sq=1, h=4, hk=2, pos=[700, 10], d=36, ps=16, max_len=1024),
        # 15 rows: the last shape below the tensor-core path
        dict(b=2, sq=15, h=8, hk=8, pos=[400, 9], d=64, ps=64, max_len=1024),
        # a float32 chunk: the FMA page walk at 64 rows
        dict(b=1, sq=64, h=8, hk=8, pos=[300], d=64, ps=64, max_len=1024,
             dtype="float32"),
    ):
        case(_k2_case, errs2, seed=5, timed=False, **kw)
    # the training path: K1 and K3 at the slice's shape, timed
    k1_train = case(_k1_case, errs1, b=TRAIN_BATCH, s=TRAIN_SEQ, h=32, hk=32, seed=7)
    errs3 = []
    k3 = case(_k3_case, errs3, b=TRAIN_BATCH, s=TRAIN_SEQ, h=32, hk=32)
    for kw in (
        dict(b=1, s=128, h=32, hk=32, dtype="float32"),    # f32 FMA, d 128
        dict(b=2, s=256, h=32, hk=8),                      # GQA
        dict(b=1, s=300, h=16, hk=4),                      # ragged, GQA
        dict(b=2, s=200, h=8, hk=8, causal=False),         # non-causal
        dict(b=2, s=130, h=8, hk=2, d=64),                 # d 64
        dict(b=1, s=100, h=8, hk=2, d=256),                # bf16 FMA, d 256
        dict(b=1, s=100, h=8, hk=2, d=256, dtype="float32"),
        dict(b=1, s=70, h=4, hk=2, d=36),                  # d not a power of 2
        dict(b=1, s=150, h=8, hk=8, d=64, causal=False, dtype="float32"),
    ):
        case(_k3_case, errs3, seed=8, timed=False, **kw)
    # K6: the lock-step prefill of the generate phase (wgmma), timed, then
    # GQA, ragged sq at pos > 0 on both tensor-core paths, float32 and the
    # FMA path at d 256, untimed
    errs6 = []
    k6 = case(_k6_case, errs6, b=GEN_BATCH, sq=GEN_LEN, h=32, hk=32, L=640)
    for kw in (
        dict(b=1, sq=64, h=8, hk=2, d=64, L=128, pos=30),     # GQA, mma<64>
        dict(b=1, sq=130, h=32, hk=32, L=384, pos=200),       # ragged, pos > 0
        dict(b=2, sq=77, h=16, hk=4, L=256, pos=10),          # ragged tile
        dict(b=2, sq=200, h=16, hk=4, d=64, L=512, pos=250),  # wgmma<64>, GQA
        dict(b=1, sq=100, h=8, hk=2, L=256, pos=50, dtype="float32"),
        dict(b=1, sq=96, h=8, hk=2, d=256, L=256, pos=40),    # bf16 FMA, d 256
        dict(b=1, sq=70, h=4, hk=2, d=256, L=128, pos=5, dtype="float32"),
    ):
        case(_k6_case, errs6, seed=15, timed=False, **kw)
    # K6 at pos 0 over a cache as long as the prompt is K1's computation:
    # the two entry points must give the same bits, on each K1 path
    for dtype, sq in (("bfloat16", 300), ("bfloat16", 100), ("float32", 300)):
        g = torch.Generator(device="cuda").manual_seed(16)
        q, k, v = (torch.randn(1, sq, heads, 128, generator=g, device="cuda",
                               dtype=getattr(torch, dtype)) for heads in (32, 8, 8))
        same = torch.equal(fa.dense_decode(q, k, v, 0), fa.flash_forward(q, k, v)[0])
        ok_all &= same
        log("kernels", f"dense_decode {dtype} at pos 0, L = sq = {sq}, GQA, path "
                       f"{fa.flash_path(sq, 128, q.dtype)}: equal to flash_fwd bit "
                       f"for bit: {same} -> {'ok' if same else 'FAIL'}")
    # K5: cp=2 decode at the cp phase's context (per-slot pos 3000-4000 of
    # 4096, 4 splits per shard), timed beside K2 over the same arena; its
    # chunk window (a hit's 256-row chunk prefill at pos 3000), timed; then
    # the variants the cp engine launches, untimed
    errs5, errs5c = [], []
    k5 = case(_k5_case, errs5, b=8, sq=1, h=32, hk=32, pos=K5_DECODE_POS)
    k5c = case(_k5_case, errs5c, b=1, sq=256, h=32, hk=32, pos=[3000])
    for kw in (
        dict(b=4, sq=1, h=32, hk=8, pos=[3500, 1700, 129, 3], dtype="float32"),
        dict(b=8, sq=1, h=32, hk=32, pos=K5_DECODE_POS, quant=True),     # int8
        dict(b=8, sq=3, h=32, hk=32, pos=K5_DECODE_POS),    # a verify window
        dict(b=4, sq=3, h=32, hk=32, pos=[3100, 2000, 900, 1], quant=True),
        dict(b=4, sq=3, h=32, hk=8, d=64, pos=[3999, 2100, 700, 64]),    # GQA
        dict(b=4, sq=1, h=32, hk=32, pos=[3900, 3000, 1000, 5], cp=4),
        # pos < page_size: shard 1 sees no key; one split per shard
        dict(b=4, sq=1, h=32, hk=32, pos=[1000, 300, 100, 0], max_len=1024),
    ):
        case(_k5_case, errs5 if not kw.get("quant") else None, seed=21,
             timed=False, **kw)
    for kw in (
        # chunk windows: the slot at pos 0 sees no key of shard 1 (nor, at
        # cp 4, of shards 1-3), pos 100 only some rows do
        dict(b=4, sq=64, h=32, hk=32, pos=[3000, 1000, 100, 0]),
        dict(b=4, sq=64, h=32, hk=32, pos=[3000, 1000, 100, 0], quant=True),
        dict(b=2, sq=64, h=32, hk=32, pos=[1000, 0], cp=4),
        dict(b=2, sq=64, h=32, hk=32, pos=[1000, 40], cp=4, quant=True),
        dict(b=2, sq=16, h=32, hk=8, d=64, pos=[2000, 10]),            # GQA
    ):
        case(_k5_case, errs5c, seed=22, timed=False, **kw)
    torch.cuda.empty_cache()
    worst = lambda rec, errs: dict(rec, max_abs_err=max(errs))
    return {"flash_fwd": worst(k1[512], errs1),
            "flash_fwd_wgmma": worst(k1_train, errs1),
            "paged_decode_fused": worst(k2, errs2),
            "paged_decode_fused_mma": worst(k2c, errs2c),
            "paged_decode_fused_q8": worst(k4, errs4),
            "paged_decode_fused_q8_mma": worst(k4c, errs4c),
            "flash_bwd": worst(k3, errs3),
            "dense_decode": worst(k6, errs6),
            "paged_decode_fused_cp": worst(k5, errs5),
            "paged_decode_fused_cp_mma": worst(k5c, errs5c)}, ok_all


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def phase_slice(smi, cfg, device="cuda", dtype="bfloat16",
                prompts_spec=SLICE_PROMPTS, **engine_kw):
    """Serve `cfg` through the engine behind POST /generate, then check the
    outputs.  Returns (all checks passed, kernel launch counts of the served
    run, the model, the served run's serving summary)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.paging import kv_page_bytes
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=0)
    engine = ContinuousBatchingEngine(model, seed=0, device=device, **engine_kw)
    engine.warmup()
    arena = cfg.num_hidden_layers * engine.pool_pages * kv_page_bytes(
        engine.page_size, cfg.num_key_value_heads, cfg.head_dim,
        model.lm_head.weight.element_size(),
    )
    log("slice", f"Llama {cfg.hidden_size} hidden x {cfg.num_hidden_layers} "
                 f"layers, {dtype} ({sum(p.numel() for p in model.parameters())} "
                 f"params), arena {engine.pool_pages} pages x "
                 f"{engine.page_size} rows = {arena / 2**30:.2f} GiB, built + "
                 f"warmed in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]

    # -- the main path: concurrent POST /generate ---------------------------
    profiler.reset_kernel_launch_counts()
    profiler.reset_serving()
    results, wall = _serve_batches(
        engine, [[(p, new) for p, (_, new) in zip(prompts, prompts_spec)]])
    counts = profiler.kernel_launch_counts()
    summary = profiler.serving_summary()

    layers = cfg.num_hidden_layers
    gen = []
    tokens_ok = True
    for i, (p, (n, new)) in enumerate(zip(prompts, prompts_spec)):
        toks = results[i]["tokens"]
        tokens_ok &= len(toks) == n + new and toks[:n] == p.tolist()
        gen.append(np.asarray(toks[n:], np.int32))
    want_k1 = len(prompts) * layers
    want_k2 = summary["decode_steps"] * layers
    counts_ok = (counts["flash_fwd"] == want_k1
                 and counts["paged_decode_fused"] == want_k2)
    ok = tokens_ok and counts_ok
    decode_tokens = summary["tokens"] - summary["requests"]
    decode_tps = decode_tokens / summary["decode_busy_s"]
    peak_gib = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
                else "not measured")
    log("slice", f"served {len(prompts)} requests over HTTP in {wall:.3f} s: "
                 f"token counts {'ok' if tokens_ok else 'WRONG'}; launches {_main(counts)} "
                 f"(expected flash_fwd {want_k1} = {len(prompts)} prefills x "
                 f"{layers} layers, paged_decode_fused {want_k2} = "
                 f"{summary['decode_steps']} decode steps x {layers}) -> "
                 f"{'ok' if counts_ok else 'FAIL'}; prefills on K1's wgmma path "
                 f"{counts['flash_fwd_wgmma'] // max(1, layers)} of {len(prompts)} "
                 f"(buckets of 128+ rows)")
    log("slice", f"ttft_p50_ms {summary['ttft_p50_ms']:.3f} ttft_p95_ms "
                 f"{summary['ttft_p95_ms']:.3f} decode_tokens_per_s "
                 f"{decode_tps:.2f} (batch of up to {engine.slots}) "
                 f"occupancy_mean {summary['occupancy_mean']:.3f} "
                 f"peak_mem_gib {peak_gib} | {smi}")

    # -- correctness: the engine's logits vs teacher-forced forward --------
    reqs = [engine.submit(p, max_new_tokens=new, keep_logits=True)
            for p, (_, new) in zip(prompts, prompts_spec)]
    engine.run_until_idle()
    agree, total, worst, finite = _teacher_forced(model, device, prompts, gen,
                                                  reqs, "slice")
    logits_ok = worst <= LOGIT_REL_TOL and finite
    ok &= logits_ok
    log("slice", f"teacher-forced greedy agreement {agree}/{total} = "
                 f"{agree / total:.4f}; worst logits rel err {worst:.4f} (tol "
                 f"{LOGIT_REL_TOL}) -> {'ok' if logits_ok else 'FAIL'}")
    if on_card:
        profile_decode(engine, cfg, rng)
    return ok, counts, model, summary


def _teacher_forced(model, device, prompts, gen, reqs, phase):
    """Logits of each engine request (`keep_logits`) against the model's
    full-sequence forward over prompt + generated tokens.  Returns (greedy
    agreement count, token count, worst max|diff| / max|logit|, all
    finite)."""
    import numpy as np
    import torch

    agree = total = 0
    worst = 0.0
    finite = True
    for p, g, r in zip(prompts, gen, reqs):
        out = r.wait(1)
        seq = np.concatenate([p, out[p.size:-1]])[None]
        with torch.no_grad():
            ref = model(torch.from_numpy(seq).to(device))[0, p.size - 1:].float()
        eng = torch.stack(r.logits)
        finite &= bool(torch.isfinite(eng).all())
        rel = ((eng - ref).abs().max() / ref.abs().max()).item()
        worst = max(worst, rel)
        agree += int((ref.argmax(-1).cpu().numpy() == out[p.size:]).sum())
        total += out.size - p.size
        log(phase, f"prompt {p.size}: direct run tokens == HTTP tokens: "
                   f"{np.array_equal(out[p.size:], g)}; logits max|diff|/"
                   f"max|logit| {rel:.4f}")
    return agree, total, worst, finite


def _serve_batches(engine, batches):
    """POST each batch of (prompt, max_new_tokens) to /generate, the
    requests of a batch concurrently and each batch after the previous one
    finished.  Returns (responses in order, wall seconds)."""
    from paddle_tpu_torch.inference import serve

    server = serve(engine, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    results = []
    t0 = time.perf_counter()
    try:
        for batch in batches:
            got = [None] * len(batch)

            def client(i, batch=batch, got=got):
                p, new = batch[i]
                got[i] = _post(url, {"input_ids": p.tolist(), "max_new_tokens": new})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(batch))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            if any(t.is_alive() for t in threads) or None in got:
                raise RuntimeError("a /generate request did not complete")
            results += got
    finally:
        server.stop()
    return results, time.perf_counter() - t0


def phase_prefix(smi, model, kv_quant, device="cuda", sys_len=PREFIX_SYS_LEN,
                 suffixes=PREFIX_SUFFIXES, new_tokens=PREFIX_NEW,
                 plain_spec=SLICE_PROMPTS, **engine_kw):
    """Prefix-cached serving of `model` with `kv_quant` pages behind POST
    /generate: one request with a shared system prompt of `sys_len` tokens
    and its own suffix, alone so that it commits, then the others sharing
    the prompt together; under int8 then the `plain_spec` mix with no shared
    prefix.  Checks token counts, prefix hits and copy-on-write copies (each
    >= the requests that came after the first), and the kernel launches of
    the run, then holds logits of a direct run against the teacher-forced
    forward.  Returns (all checks passed, launch counts, generated tokens of
    the shared-prefix requests)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.paging import kv_page_bytes

    cfg = model.config
    layers = cfg.num_hidden_layers
    phase = f"prefix {kv_quant}"
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(model, seed=0, device=device,
                                      prefix_cache=True, kv_quant=kv_quant,
                                      **engine_kw)
    engine.warmup()
    arena = layers * engine.pool_pages * kv_page_bytes(
        engine.page_size, cfg.num_key_value_heads, cfg.head_dim,
        model.lm_head.weight.element_size(), kv_quant)
    log(phase, f"engine kv_quant={kv_quant}: arena {engine.pool_pages} pages x "
               f"{engine.page_size} rows = {arena / 2**30:.2f} GiB, built + "
               f"warmed in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    system = rng.integers(1, cfg.vocab_size, size=sys_len)
    shared = [np.concatenate([system, rng.integers(1, cfg.vocab_size, size=n)])
              .astype(np.int32) for n in suffixes]
    plain = ([rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
              for n, _ in plain_spec] if kv_quant == "int8" else [])
    spec = ([(p, new_tokens) for p in shared]
            + [(p, new) for p, (_, new) in zip(plain, plain_spec)])
    batches = [spec[:1], spec[1:len(shared)]] + ([spec[len(shared):]] if plain else [])

    # -- the main path: POST /generate --------------------------------------
    profiler.reset_kernel_launch_counts()
    profiler.reset_serving()
    profiler.reset_paging()
    results, wall = _serve_batches(engine, batches)
    counts = profiler.kernel_launch_counts()
    summary = profiler.serving_summary()
    paging = profiler.paging_summary()

    gen = []
    tokens_ok = True
    for r, (p, new) in zip(results, spec):
        toks = r["tokens"]
        tokens_ok &= len(toks) == p.size + new and toks[:p.size] == p.tolist()
        gen.append(np.asarray(toks[p.size:], np.int32))
    hits, cows = paging.get("prefix_hits", 0), paging.get("cow_copies", 0)
    sharing_ok = hits >= len(shared) - 1 and cows >= len(shared) - 1
    fresh = len(spec) - hits  # every miss is a fresh prefill
    want_k1 = fresh * layers
    want_paged = (hits + summary["decode_steps"]) * layers
    paged_name = "paged_decode_fused_q8" if kv_quant == "int8" else "paged_decode_fused"
    other = "paged_decode_fused" if kv_quant == "int8" else "paged_decode_fused_q8"
    on_card = torch.device(device).type == "cuda"
    want_tc = hits * layers if on_card else 0  # every chunk prefill
    tc_ok = counts[paged_name + "_mma"] == want_tc
    counts_ok = (counts["flash_fwd"] == want_k1 and counts[paged_name] == want_paged
                 and counts[other] == 0 and tc_ok)
    ok = tokens_ok and sharing_ok and counts_ok
    log(phase, f"served {len(spec)} requests over HTTP in {wall:.3f} s: token "
               f"counts {'ok' if tokens_ok else 'WRONG'}; prefix hits {hits}, "
               f"COW copies {cows}, prefill tokens saved "
               f"{paging.get('prefill_tokens_saved', 0)}, commits "
               f"{paging.get('cache_commits', 0)} (want hits and copies >= "
               f"{len(shared) - 1}) -> {'ok' if sharing_ok else 'FAIL'}")
    log(phase, f"launches {_main(counts)} (expected flash_fwd {want_k1} = {fresh} "
               f"fresh prefills x {layers} layers, {paged_name} {want_paged} = "
               f"({hits} chunk prefills + {summary['decode_steps']} decode steps) x "
               f"{layers}, {other} 0) -> {'ok' if counts_ok else 'FAIL'}")
    log(phase, f"chunk prefills on the tensor-core path: "
               f"{counts[paged_name + '_mma'] // max(1, layers)} of {hits} "
               f"({counts[paged_name + '_mma']} launches, expected {want_tc}) -> "
               f"{'ok' if tc_ok else 'FAIL'}")
    decode_tps = (summary["tokens"] - summary["requests"]) / summary["decode_busy_s"]
    log(phase, f"ttft_p50_ms {summary['ttft_p50_ms']:.3f} ttft_p95_ms "
               f"{summary['ttft_p95_ms']:.3f} decode_tokens_per_s {decode_tps:.2f} "
               f"(batch of up to {engine.slots}) arena_gib {arena / 2**30:.2f} "
               f"pages {engine.pool_pages} | {smi}")

    # -- correctness: a direct run's logits vs the teacher-forced forward ---
    prompts = [p for p, _ in spec]
    reqs = [engine.submit(p, max_new_tokens=new, keep_logits=True) for p, new in spec]
    engine.run_until_idle()
    agree, total, worst, finite = _teacher_forced(model, device, prompts, gen,
                                                  reqs, phase)
    logits_ok = worst <= LOGIT_REL_TOL and finite
    ok &= logits_ok
    log(phase, f"teacher-forced greedy agreement {agree}/{total} = "
               f"{agree / total:.4f}; worst logits rel err {worst:.4f} (tol "
               f"{LOGIT_REL_TOL}) -> {'ok' if logits_ok else 'FAIL'}")
    if torch.device(device).type == "cuda":
        if kv_quant == "int8":
            profile_decode(engine, cfg, rng)
        else:
            profile_prefix_hit(engine, [
                np.concatenate([system, rng.integers(1, cfg.vocab_size, size=n)])
                .astype(np.int32) for n in (64, 128, 200)])
    return ok, counts, gen[:len(shared)]


def _post_status(url, body):
    """POST and return (HTTP status, JSON body), error statuses included."""
    import urllib.error

    try:
        return 200, _post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _profile_cp_decode(engine, cfg, rng, prompt_len):
    """`profile_decode` of a cp engine with the cross-shard combine inside
    a profiler range, so its device time shows apart from the kernels'."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    real = fa.cp_softmax_combine

    def combine(*args, **kw):
        with torch.profiler.record_function("cp_softmax_combine"):
            return real(*args, **kw)

    fa.cp_softmax_combine = combine
    try:
        profile_decode(engine, cfg, rng, prompt_len=prompt_len)
    finally:
        fa.cp_softmax_combine = real


def phase_cp(smi, model, device="cuda", doc_len=CP_DOC_LEN,
             questions=CP_QUESTIONS, fresh=CP_FRESH, new_tokens=CP_NEW,
             overflow_len=CP_OVERFLOW, runs=CP_RUNS, profile_len=CP_DOC_LEN,
             **engine_kw):
    """Long-document serving of `model` behind POST /generate, one engine
    at a time: for each (label, cp, spec_k, kv_quant, audit) of `runs`,
    request 1 (the document + its first question) alone so that it
    commits, then the other questions (prefix hits: chunk prefills of their
    suffixes through the pages) with two fresh prompts together, then one
    prompt past the context, which must be answered 400 with the engine's
    per-shard geometry.  Checks token counts, /healthz, the kernel launches
    of the run (K5 once per shard per layer per paged attention under cp,
    no K2 or K4 there), and a direct run's logits against the
    teacher-forced forward; prints the greedy agreement between runs, the
    speculation counters, decode tokens/s and TTFT, and profiles the first
    cp run's decode step.  Returns (all checks passed, launch counts of
    every run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.paging import kv_page_bytes

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(2)
    doc = rng.integers(1, cfg.vocab_size, size=doc_len)
    shared = [np.concatenate([doc, rng.integers(1, cfg.vocab_size, size=n)])
              .astype(np.int32) for n in questions]
    others = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in fresh]
    spec = [(p, new_tokens) for p in shared + others]
    batches = [spec[:1], spec[1:]]
    overflow = rng.integers(1, cfg.vocab_size, size=overflow_len).astype(np.int32)
    ok_all, all_counts, gens, profiled = True, [], {}, False
    for label, cp, spec_k, quant, audit in runs:
        phase = f"cp {label}"
        t0 = time.perf_counter()
        engine = ContinuousBatchingEngine(model, seed=0, device=device, cp=cp,
                                          spec_k=spec_k, kv_quant=quant,
                                          prefix_cache=True, **engine_kw)
        engine.warmup()
        arena = layers * engine.pool_pages * kv_page_bytes(
            engine.page_size, cfg.num_key_value_heads, cfg.head_dim,
            model.lm_head.weight.element_size(), quant)
        log(phase, f"engine cp={cp} spec_k={spec_k} kv_quant={quant} audit={audit}: "
                   f"arena {engine.pool_pages} pages x {engine.page_size} rows "
                   f"= {arena / 2**30:.2f} GiB, {engine.pages_per_seq // cp} "
                   f"pages per shard per sequence, built + warmed in "
                   f"{time.perf_counter() - t0:.1f} s")
        core.set_flags({"FLAGS_serve_debug_invariants": audit})

        # -- the main path: POST /generate ----------------------------------
        profiler.reset_kernel_launch_counts()
        profiler.reset_serving()
        profiler.reset_paging()
        profiler.reset_speculation()
        try:
            results, wall = _serve_batches(engine, batches)
        finally:
            core.set_flags({"FLAGS_serve_debug_invariants": False})
        counts = profiler.kernel_launch_counts()
        summary = profiler.serving_summary()
        paging = profiler.paging_summary()
        spec_sum = profiler.speculation_summary()
        all_counts.append(counts)
        health = engine.healthz()
        server = serve(engine, port=0, block=False)
        try:
            code, body = _post_status(
                f"http://127.0.0.1:{server.server_address[1]}/generate",
                {"input_ids": overflow.tolist(), "max_new_tokens": new_tokens})
        finally:
            server.stop()

        gen = []
        tokens_ok = True
        for r, (p, new) in zip(results, spec):
            toks = r["tokens"]
            tokens_ok &= len(toks) == p.size + new and toks[:p.size] == p.tolist()
            gen.append(np.asarray(toks[p.size:], np.int32))
        gens[label] = gen
        cap = body.get("capacity", {})
        per_shard = engine.pages_per_seq // cp
        overflow_ok = (code == 400 and body.get("type") == "ContextOverflow"
                       and cap.get("cp") == cp
                       and cap.get("pages_per_shard") == per_shard
                       and cap.get("tokens_per_shard") == per_shard * engine.page_size)
        # the reference's mesh_shape keeps only the axes larger than 1
        health_ok = (health["cp"] == cp and health["tp"] == 1
                     and health["mesh_shape"] == ({"cp": cp} if cp > 1 else {})
                     and (cp == 1 or len(health["page_free_by_shard"]) == cp))
        hits = paging.get("prefix_hits", 0)
        misses = paging.get("prefix_lookups", 0) - hits
        steps = summary["decode_steps"]
        want = dict.fromkeys(counts, 0)
        paged = "paged_decode_fused" + ("_cp" if cp > 1 else "") + (
            "_q8" if quant == "int8" else "")
        if on_card:
            want["flash_fwd"] = misses * layers
            # every fresh prompt here is past 128 tokens: K1's wgmma path
            want["flash_fwd_wgmma"] = misses * layers
            want[paged] = cp * layers * (steps + hits)
            # every chunk prefill on the tensor-core path, every decode or
            # verify step (1 or 3 rows) on the FMA page walk
            want[paged + "_mma"] = cp * layers * hits
        counts_ok = counts == want and hits == len(shared) - 1
        ok = tokens_ok and overflow_ok and health_ok and counts_ok
        log(phase, f"served {len(spec)} requests over HTTP in {wall:.3f} s: token "
                   f"counts {'ok' if tokens_ok else 'WRONG'}; prefix hits {hits}, "
                   f"COW copies {paging.get('cow_copies', 0)}, prefill tokens "
                   f"saved {paging.get('prefill_tokens_saved', 0)}; healthz cp "
                   f"{health['cp']} tp {health['tp']} mesh_shape {health['mesh_shape']} "
                   f"tokens_per_step {health['tokens_per_step']} "
                   f"page_free_by_shard {health.get('page_free_by_shard')} -> "
                   f"{'ok' if health_ok else 'FAIL'}")
        log(phase, f"launches {_main(counts)} (expected {_main(want)}: flash_fwd = "
                   f"{misses} fresh prefills x {layers} layers, the paged kernel = "
                   f"{cp} shards x {layers} layers x ({steps} "
                   f"{'verify' if spec_k else 'decode'} steps + {hits} chunk "
                   f"prefills)) -> {'ok' if counts_ok else 'FAIL'}")
        log(phase, f"chunk prefills on the tensor-core path: "
                   f"{counts[paged + '_mma'] // max(1, cp * layers)} of {hits} "
                   f"({counts[paged + '_mma']} launches, expected "
                   f"{want[paged + '_mma']}); fresh prefills on K1's wgmma path "
                   f"{counts['flash_fwd_wgmma'] // max(1, layers)} of {misses}")
        log(phase, f"{overflow_len}-token prompt: HTTP {code} {body.get('type')} "
                   f"capacity {cap} -> {'ok' if overflow_ok else 'FAIL'}")
        decode_tps = (summary["tokens"] - summary["requests"]) / summary["decode_busy_s"]
        log(phase, f"ttft_p50_ms {summary['ttft_p50_ms']:.3f} ttft_p95_ms "
                   f"{summary['ttft_p95_ms']:.3f} decode_tokens_per_s "
                   f"{decode_tps:.2f} (batch of up to {engine.slots}) speculation "
                   f"{spec_sum or 'off'} | {smi}")

        # -- correctness: a direct run's logits vs the teacher-forced forward
        prompts = [p for p, _ in spec]
        reqs = [engine.submit(p, max_new_tokens=new, keep_logits=True)
                for p, new in spec]
        engine.run_until_idle()
        agree, total, worst, finite = _teacher_forced(model, device, prompts, gen,
                                                      reqs, phase)
        logits_ok = worst <= LOGIT_REL_TOL and finite
        ok &= logits_ok
        log(phase, f"teacher-forced greedy agreement {agree}/{total} = "
                   f"{agree / total:.4f}; worst logits rel err {worst:.4f} (tol "
                   f"{LOGIT_REL_TOL}) -> {'ok' if logits_ok else 'FAIL'}")
        if on_card and cp > 1 and not profiled:
            _profile_cp_decode(engine, cfg, rng, profile_len)
            profiled = True
        ok_all &= ok
        del engine, reqs
        if on_card:
            _free()
    labels = [r[0] for r in runs]
    for a, b in zip(labels, labels[1:]):
        same = sum(int((x == y).sum()) for x, y in zip(gens[a], gens[b]))
        total = sum(x.size for x in gens[a])
        log("cp", f"greedy tokens of {b} equal to {a}'s, per position: "
                  f"{same}/{total} = {same / total:.4f}")
    return ok_all, all_counts


def _gen_run(what, fn, layers, expect_k6, on_card, wgmma=False):
    """One lock-step call of the main path, its launch counts read just
    after it: K6 `expect_k6` times (each on the wgmma path with `wgmma`), no
    other kernel.  Returns (output, ok, counts, wall seconds)."""
    import torch

    from paddle_tpu_torch import profiler

    profiler.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = profiler.kernel_launch_counts()
    want = dict.fromkeys(counts, 0)
    want["dense_decode"] = expect_k6 if on_card else 0
    want["dense_decode_wgmma"] = want["dense_decode"] if wgmma else 0
    ok = counts == want
    log("generate", f"{what}: {wall:.3f} s, launches {counts} (expected "
                    f"dense_decode {want['dense_decode']}"
                    f"{f' = {layers} layers' if want['dense_decode'] else ''}"
                    f"{' on the wgmma path' if want['dense_decode_wgmma'] else ''}, "
                    f"every other kernel 0) -> {'ok' if ok else 'FAIL'}")
    return out, ok, counts, wall


def phase_generate(smi, model, device="cuda", batch=GEN_BATCH, prompt_len=GEN_LEN,
                   new_tokens=GEN_NEW, beam_len=BEAM_LEN, beam_new=BEAM_NEW,
                   beams=BEAMS, short_len=SHORT_LEN,
                   predictor_lens=PREDICTOR_LENS):
    """Lock-step generation on `model`: greedy over `batch` prompts of
    `prompt_len` tokens, beam search, seeded sampling twice, a short prompt;
    each call's launches read just after it (K6 once per layer for a prefill
    of 64+ rows, nothing else); prefill and one decode step's logits against
    the teacher-forced forward; then a GenerationPredictor behind POST
    /generate.  Returns (all checks passed, the summed launch counts of the
    calls)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference import GenerationPredictor, serve
    from paddle_tpu_torch.models.llama import StaticKVCache
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(batch, prompt_len))
                           .astype(np.int32)).to(device)
    runs, ok = [], True

    def run(what, fn, expect_k6, rows=0):
        nonlocal ok
        wgmma = fa.flash_path(rows, cfg.head_dim, model.lm_head.weight.dtype) == "wgmma"
        out, good, counts, wall = _gen_run(what, fn, layers, expect_k6, on_card,
                                           wgmma)
        ok &= good
        runs.append(counts)
        return out, wall

    out, wall = run(f"greedy, {batch} x {prompt_len} tokens + {new_tokens}",
                    lambda: model.generate(ids, max_new_tokens=new_tokens), layers,
                    prompt_len)
    shape_ok = (tuple(out.shape) == (batch, prompt_len + new_tokens)
                and torch.equal(out[:, :prompt_len], ids)
                and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    ok &= shape_ok
    log("generate", f"greedy: shape {tuple(out.shape)}, prompt kept, ids in the "
                    f"vocabulary -> {'ok' if shape_ok else 'FAIL'}; "
                    f"{batch * new_tokens / wall:.2f} tokens/s over the call "
                    f"(prefill included) | {smi}")
    greedy = out

    ids_b = ids[:1, :beam_len].contiguous()
    out_b, _ = run(f"beam search, {beams} beams, {beam_len} tokens + {beam_new}",
                   lambda: model.generate(ids_b, max_new_tokens=beam_new,
                                          num_beams=beams), layers, beam_len)
    beam_ok = tuple(out_b.shape) == (1, beam_len + beam_new)
    ok &= beam_ok
    sampled = []
    for i in range(2):
        o, _ = run(f"sampling {SAMPLING} run {i + 1}",
                   lambda: model.generate(ids, max_new_tokens=new_tokens,
                                          **SAMPLING), layers, prompt_len)
        sampled.append(o)
    same = torch.equal(sampled[0], sampled[1])
    ok &= same and beam_ok
    log("generate", f"beam output shape {tuple(out_b.shape)} -> "
                    f"{'ok' if beam_ok else 'FAIL'}; the two seeded sampling runs "
                    f"equal: {same}; sampled tokens equal to greedy's "
                    f"{(sampled[0][:, prompt_len:] == greedy[:, prompt_len:]).float().mean().item():.3f}")
    ids_s = ids[:1, :short_len].contiguous()
    run(f"greedy, {short_len}-token prompt (below K6's 64 rows)",
        lambda: model.generate(ids_s, max_new_tokens=16), 0)

    # -- correctness: prefill and one decode step vs the teacher-forced
    # forward over prompt + the greedy token
    cache_len = -(-(prompt_len + 1) // 128) * 128
    caches = [StaticKVCache(1, cache_len, cfg.num_key_value_heads, cfg.head_dim,
                            model.lm_head.weight.dtype, model.device)
              for _ in range(layers)]
    seq = greedy[:1, :prompt_len + 1]
    with torch.no_grad():
        pos0 = torch.zeros((), dtype=torch.int32, device=model.device)
        pf = model.lm_head(model.llama(seq[:, :prompt_len], caches=caches,
                                       pos=pos0)[:, -1]).float()
        dec = model.lm_head(model.llama(seq[:, prompt_len:], caches=caches,
                                        pos=pos0 + prompt_len)[:, -1]).float()
        ref = model(seq)[0, prompt_len - 1:].float()
    del caches
    rels = [((x[0] - r).abs().max() / r.abs().max()).item()
            for x, r in ((pf, ref[0]), (dec, ref[1]))]
    finite = bool(torch.isfinite(pf).all() and torch.isfinite(dec).all())
    logits_ok = finite and max(rels) <= LOGIT_REL_TOL
    ok &= logits_ok
    log("generate", f"logits vs the teacher-forced forward, max|diff|/max|logit|: "
                    f"prefill {rels[0]:.3e}, decode step {rels[1]:.3e} (tol "
                    f"{LOGIT_REL_TOL}); greedy token {int(seq[0, -1])} == argmax of "
                    f"the forward {int(ref[0].argmax())} -> {'ok' if logits_ok else 'FAIL'}")

    # -- GenerationPredictor behind POST /generate --------------------------
    pred = GenerationPredictor(model, max_new_tokens=32).warmup(prompt_len=70)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in predictor_lens]
    server = serve(pred, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    profiler.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    try:
        http = [_post(url, {"input_ids": p.tolist()})["tokens"] for p in prompts]
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    counts = profiler.kernel_launch_counts()
    runs.append(counts)
    want = dict.fromkeys(counts, 0)
    want["dense_decode"] = len(prompts) * layers if on_card else 0
    want["dense_decode_wgmma"] = layers * sum(
        fa.flash_path(n, cfg.head_dim, model.lm_head.weight.dtype) == "wgmma"
        for n in predictor_lens) if on_card else 0
    direct = [pred.generate(p).tolist() for p in prompts]
    http_ok = http == direct and counts == want
    ok &= http_ok
    log("generate", f"GenerationPredictor behind POST /generate: {len(prompts)} "
                    f"requests of {predictor_lens} tokens + 32 in {wall:.3f} s; "
                    f"HTTP tokens == direct tokens: {http == direct}; launches "
                    f"{counts} (expected dense_decode {want['dense_decode']}) -> "
                    f"{'ok' if http_ok else 'FAIL'}")
    total = {name: sum(c[name] for c in runs) for name in runs[0]}
    return ok, total


def phase_dense(smi, model, paged_summary, device="cuda", prompts_spec=SLICE_PROMPTS,
                **engine_kw):
    """The dense slot-pool engine (`paged=False`) on `model` behind POST
    /generate with the slice's traffic: token counts, launches (K1 once per
    layer per prefill, nothing else), logits against the teacher-forced
    forward, decode tokens/s and TTFT beside the paged slice's
    `paged_summary`.  Returns (all checks passed, launch counts)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(model, seed=0, device=device, paged=False,
                                      **engine_kw)
    engine.warmup()
    pool = 2 * layers * engine._caches[0].k.numel() * engine._caches[0].k.element_size()
    log("dense", f"dense slot pool {engine.slots} slots x {engine.max_len} rows = "
                 f"{pool / 2**30:.2f} GiB, built + warmed in "
                 f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)  # the slice's prompts
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]
    profiler.reset_kernel_launch_counts()
    profiler.reset_serving()
    results, wall = _serve_batches(
        engine, [[(p, new) for p, (_, new) in zip(prompts, prompts_spec)]])
    counts = profiler.kernel_launch_counts()
    summary = profiler.serving_summary()
    gen, tokens_ok = [], True
    for r, p, (n, new) in zip(results, prompts, prompts_spec):
        toks = r["tokens"]
        tokens_ok &= len(toks) == n + new and toks[:n] == p.tolist()
        gen.append(np.asarray(toks[n:], np.int32))
    want = dict.fromkeys(counts, 0)
    want["flash_fwd"] = len(prompts) * layers if on_card else 0
    # prefills of 128+ bucket rows take K1's wgmma path
    buckets = [engine._bucket_for(n) for n, _ in prompts_spec]
    want["flash_fwd_wgmma"] = layers * sum(
        fa.flash_path(b, cfg.head_dim, model.lm_head.weight.dtype) == "wgmma"
        for b in buckets) if on_card else 0
    counts_ok = counts == want
    ok = tokens_ok and counts_ok
    log("dense", f"served {len(prompts)} requests over HTTP in {wall:.3f} s: token "
                 f"counts {'ok' if tokens_ok else 'WRONG'}; launches {counts} "
                 f"(expected flash_fwd {want['flash_fwd']} = {len(prompts)} "
                 f"prefills x {layers} layers, every other kernel 0) -> "
                 f"{'ok' if counts_ok else 'FAIL'}")

    def rates(sm):
        return ((sm["tokens"] - sm["requests"]) / sm["decode_busy_s"],
                sm["ttft_p50_ms"], sm["ttft_p95_ms"])

    d_tps, d_p50, d_p95 = rates(summary)
    p_tps, p_p50, p_p95 = rates(paged_summary)
    log("dense", f"decode_tokens_per_s dense {d_tps:.2f} | paged slice {p_tps:.2f}; "
                 f"ttft_p50_ms dense {d_p50:.3f} | paged {p_p50:.3f}; ttft_p95_ms "
                 f"dense {d_p95:.3f} | paged {p_p95:.3f} (batch of up to "
                 f"{engine.slots}, one run) | {smi}")
    reqs = [engine.submit(p, max_new_tokens=new, keep_logits=True)
            for p, (_, new) in zip(prompts, prompts_spec)]
    engine.run_until_idle()
    agree, total, worst, finite = _teacher_forced(model, device, prompts, gen,
                                                  reqs, "dense")
    logits_ok = worst <= LOGIT_REL_TOL and finite
    ok &= logits_ok
    log("dense", f"teacher-forced greedy agreement {agree}/{total} = "
                 f"{agree / total:.4f}; worst logits rel err {worst:.4f} (tol "
                 f"{LOGIT_REL_TOL}) -> {'ok' if logits_ok else 'FAIL'}")
    if on_card:
        profile_decode(engine, cfg, rng)
    return ok, counts


def _device_profile(run, steps):
    """Run `run()` `steps` times under torch.profiler.  Returns (wall us,
    {kernel name: device us}, {annotated range: device us}); the kernel
    dict is empty when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, spans = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # a user annotation (the optimizer's step range) spans kernels that
        # are counted on their own: keep it apart
        if getattr(ev, "is_user_annotation", False):
            spans[ev.key] = spans.get(ev.key, 0.0) + ev.device_time_total
        else:
            us = getattr(ev, "self_device_time_total", 0.0)
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us
    return wall_us, kernels, spans


# device time by kind of kernel, matched on the kernel's name
KERNEL_GROUPS = (
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "splitKreduce")),
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K3 flash_bwd", ("flash_bwd", "delta_kernel")),
    # the chunk windows (16+ rows) of K2, K4 and K5 run paged_chunk_mma_kernel;
    # below 16 rows K4 is paged_decode_kernel over int8 ("signed char")
    # pages; K5 is the same templates (K2's under full precision, K4's
    # under int8) and no step runs both, so under cp these rows are K5; all
    # share the split combine kernel
    ("K2/K4/K5 chunk window (tensor cores)", ("paged_chunk_mma_kernel",)),
    ("K4/K5-int8 paged_decode_q8", ("paged_decode_kernel<__nv_bfloat16, signed char",
                                    "paged_decode_kernel<float, signed char")),
    ("K2/K5 paged_decode", ("paged_decode_kernel<",)),
    ("K2/K4/K5 split combine", ("combine_kernel<",)),
)


def _log_profile(what, wall_us, kernels, spans, steps, top=8):
    """Print the step's wall time, the device's busy time and idle share,
    the device time by kind of kernel, annotated ranges, and the top
    kernels ("not measured" when the profiler saw no device time)."""
    busy = sum(kernels.values())
    if busy <= 0:
        log("profile", "device time not measured (the profiler saw no kernels)")
        return
    log("profile", f"{what}: wall {wall_us / steps / 1e3:.3f} ms/step, device "
                   f"busy {busy / steps / 1e3:.3f} ms/step, idle share "
                   f"{1 - busy / wall_us:.3f}")
    groups = {label: 0.0 for label, _ in KERNEL_GROUPS}
    other = 0.0
    for name, us in kernels.items():
        label = next((lb for lb, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), None)
        if label is None:
            other += us
        else:
            groups[label] += us
    parts = [f"{lb} {us / steps / 1e3:.3f}" for lb, us in groups.items() if us]
    log("profile", "  device ms/step by kind: " + ", ".join(parts)
                   + f", other (elementwise, reductions, copies) "
                   f"{other / steps / 1e3:.3f}")
    for name, us in spans.items():
        log("profile", f"  span of {name}: {us / steps / 1e3:.3f} ms/step on the device")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        log("profile", f"  {us / busy:6.3f} of device time, "
                       f"{us / steps / 1e3:.4f} ms/step: {name[:90]}")


def profile_prefix_hit(engine, prompts):
    """Where a prefix hit's time to first token goes: each prompt (sharing
    a committed prefix) submitted alone and admitted by one engine step --
    its chunk prefill through the pages, then one decode step -- under
    torch.profiler."""
    pending = iter(prompts)
    reqs = []

    def admit():
        reqs.append(engine.submit(next(pending), max_new_tokens=2))
        engine.step()

    wall_us, kernels, spans = _device_profile(admit, len(prompts))
    engine.run_until_idle()
    for r in reqs:
        r.wait(1)
    _log_profile(f"prefix-hit admission (chunk prefill of "
                 f"{[p.size for p in prompts]}-token prompts + one decode step)",
                 wall_us, kernels, spans, len(prompts))


def profile_decode(engine, cfg, rng, prompt_len=256, steps=8):
    """Where a decode step's time goes: every slot busy at ~prompt_len
    tokens, `steps` steps under torch.profiler."""
    reqs = [engine.submit(rng.integers(1, cfg.vocab_size, size=prompt_len),
                          max_new_tokens=steps + 4)
            for _ in range(engine.slots)]
    engine.step()  # admits every slot (prefills) and decodes once
    engine.step()
    # each step ends in the host fetch of the step's tokens
    wall_us, kernels, spans = _device_profile(engine.step, steps)
    engine.run_until_idle()
    for r in reqs:  # a request that failed would leave its slot out
        r.wait(1)
    _log_profile(f"decode step, {engine.slots} slots at ~{prompt_len} tokens",
                 wall_us, kernels, spans, steps)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# 2-layer gradient check: per parameter ||g_kernel - g_plain|| / ||g_plain||.
# Both runs are bf16 O2 and differ only in attention.  The kernel path
# rounds p and ds to bf16 as the reference's backward does (a 2^-9 relative
# rounding of each entry) and K1/K3 agree with their plain versions within
# a relative norm of 1e-2; the plain path's autograd keeps p and ds in
# float32.  A rehearsal on the CPU at tiny size (both sides plain, so only
# the rounding differs) gave 7.4e-3 on the worst parameter; 5e-2 leaves
# room for the longer sums at full width while a wrong gradient gives ~1.
GRAD_REL_TOL = 5e-2


def _train_model(cfg, device, seed=0, lr=1e-4, weight_decay=0.01):
    """The user's set-up (reference bench.py:189-202): a float32 Llama on
    the card, train mode, AdamW, then bf16 O2 with float32 master weights."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=seed).train()
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.named_parameters(),
                          weight_decay=weight_decay)
    return amp.decorate(model, opt, level="O2", dtype="bfloat16")


def _train_step(model, opt, ids):
    loss, _ = model(ids, labels=ids)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def phase_train(smi, cfg, device="cuda", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                steps=TRAIN_STEPS, seed=0, profile=True):
    """Train `cfg` for `steps` AdamW steps (bf16 O2) on one repeated batch
    drawn from `seed`, then check losses, launch counts and that every
    weight moved; with `profile`, profile one more step.  Returns (all
    checks passed, kernel launch counts of the training run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt = _train_model(cfg, device, seed=seed)
    layers = cfg.num_hidden_layers
    n_params = sum(p.numel() for p in model.parameters())
    log("train", f"Llama {cfg.hidden_size} hidden x {layers} layers "
                 f"({n_params} params), bf16 O2 + AdamW masters, recompute "
                 f"{cfg.use_recompute}, batch {batch} x {seq} tokens, built in "
                 f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    ).to(device)
    before = {name: opt.state[p].get("master_weight", p).detach().to("cpu", copy=True)
              for name, p in model.named_parameters()}

    # -- the main path: model(ids, labels=ids) -> backward -> AdamW ---------
    profiler.reset_kernel_launch_counts()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(_train_step(model, opt, ids).item())
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = profiler.kernel_launch_counts()

    finite = all(np.isfinite(losses))
    falls = losses[-1] < losses[0]
    fwd_per_step = 2 if cfg.use_recompute else 1
    want_fwd, want_bwd = fwd_per_step * layers * steps, layers * steps
    # every training-shape K1 launch takes the wgmma path
    want_wgmma = want_fwd if on_card else 0
    counts_ok = (counts["flash_fwd"] == want_fwd and counts["flash_bwd"] == want_bwd
                 and counts["flash_fwd_wgmma"] == want_wgmma)
    moved = [name for name, p in model.named_parameters()
             if not torch.equal(opt.state[p].get("master_weight", p).detach().cpu(),
                                before[name])]
    moved_ok = len(moved) == len(before)
    step_s = statistics.median(secs[1:])
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    log("train", "losses " + " ".join(f"{x:.4f}" for x in losses)
                 + f": finite {finite}, last < first {falls}")
    log("train", f"launches {_main(counts)} (expected flash_fwd {want_fwd} = "
                 f"{fwd_per_step} x {layers} layers x {steps} steps, each on the "
                 f"wgmma path: flash_fwd_wgmma {want_wgmma}; flash_bwd "
                 f"{want_bwd}) -> {'ok' if counts_ok else 'FAIL'}; weights moved "
                 f"{len(moved)}/{len(before)} -> {'ok' if moved_ok else 'FAIL'}")
    log("train", f"step_ms median of steps 2-{steps} {step_s * 1e3:.1f} (all: "
                 + " ".join(f"{x * 1e3:.1f}" for x in secs)
                 + f"), tokens_per_s {batch * seq / step_s:.1f}, peak_mem_gib "
                 f"{peak} | {smi}")
    if on_card and profile:
        # the step's matmuls: 2 FLOP per weight per token forward, 4 backward
        gemm_params = sum(m.weight.numel() for m in model.modules()
                          if isinstance(m, torch.nn.Linear))
        gemm_ms, _ = bound(0, 6 * gemm_params * batch * seq)
        log("profile", f"training step GEMMs: {6 * gemm_params * batch * seq:.3e} "
                       f"FLOP, bound {gemm_ms:.2f} ms at {PEAK_BF16_FLOP_S:.3g} FLOP/s")
        wall_us, kernels, spans = _device_profile(
            lambda: _train_step(model, opt, ids), 1)
        _log_profile(f"training step, batch {batch} x {seq}, {layers} layers",
                     wall_us, kernels, spans, 1, top=12)
    return finite and falls and counts_ok and moved_ok, counts


def grad_check(cfg, device="cuda", batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=1):
    """One step's parameter gradients with K1/K3, and again with attention
    through `flash_forward_plain` under autograd (a check, not the main
    path): per parameter ||g_kernel - g_plain|| / ||g_plain|| <=
    GRAD_REL_TOL.  Returns (ok, worst ratio)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import flash_attention as fa

    model, _ = _train_model(cfg, device, seed=seed)
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    ).to(device)

    def grads():
        loss, _ = model(ids, labels=ids)
        loss.backward()
        out = {n: p.grad.detach().float() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    fa.reset_launch_counts()
    kernel = grads()
    k3_kernel = fa.launch_counts["flash_bwd"]
    sdpa = llama.sdpa
    llama.sdpa = lambda q, k, v, causal=False, scale=None: fa.flash_forward_plain(
        q, k, v, causal, 1.0 / q.shape[-1] ** 0.5)[0]
    try:
        plain = grads()
    finally:
        llama.sdpa = sdpa
    k3_plain = fa.launch_counts["flash_bwd"] - k3_kernel
    ratios = {n: ((kernel[n] - plain[n]).norm() / plain[n].norm()).item()
              for n in kernel}
    worst = max(ratios, key=ratios.get)
    on_card = torch.device(device).type == "cuda"
    paths_ok = k3_plain == 0 and k3_kernel == (cfg.num_hidden_layers if on_card else 0)
    ok = (all(np.isfinite(list(ratios.values()))) and ratios[worst] <= GRAD_REL_TOL
          and paths_ok)
    log("train", f"grad check, {cfg.num_hidden_layers} layers, batch {batch} x "
                 f"{seq}: worst ||g_kernel - g_plain|| / ||g_plain|| "
                 f"{ratios[worst]:.3e} ({worst}), median "
                 f"{statistics.median(ratios.values()):.3e} (tol {GRAD_REL_TOL}); "
                 f"flash_bwd launches kernel pass {k3_kernel}, plain pass "
                 f"{k3_plain} -> {'ok' if ok else 'FAIL'}")
    return ok, ratios[worst]


def _free():
    """Release the previous phase's model before the next one builds."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _timed(phase, fn, *args, **kw):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        log(phase, f"phase wall time {time.perf_counter() - t0:.1f} s")


def main():
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        smi = _timed("device", phase_device)
        _timed("build", phase_build)
        kernels, kernels_ok = _timed("kernels", phase_kernels)
        from paddle_tpu_torch.models.llama import LlamaConfig

        serving = dict(slots=8, max_len=2048, page_size=128,
                       prefill_buckets=[32, 64, 128, 256, 512])
        slice_ok, counts, model, slice_summary = _timed(
            "slice", phase_slice, smi, LlamaConfig.llama2_7b(), **serving)
        _free()
        # the prefix cache in full precision, then over int8 pages: one
        # engine (and arena) at a time, the same model
        prefix_ok, prefix_counts, prefix_gen = True, [], {}
        for quant in ("none", "int8"):
            ok, c, gen = _timed(f"prefix {quant}", phase_prefix, smi, model,
                                quant, **serving)
            prefix_ok &= ok
            prefix_counts.append(c)
            prefix_gen[quant] = gen
            _free()
        same = sum(int((a == b).sum()) for a, b in zip(prefix_gen["none"],
                                                       prefix_gen["int8"]))
        total = sum(a.size for a in prefix_gen["none"])
        log("prefix", f"int8 greedy tokens equal to full precision's, per "
                      f"position: {same}/{total} = {same / total:.4f}")
        gen_ok, gen_counts = _timed("generate", phase_generate, smi, model)
        _free()
        dense_ok, dense_counts = _timed("dense", phase_dense, smi, model,
                                        slice_summary, **serving)
        _free()
        cp_ok, cp_counts = _timed("cp", phase_cp, smi, model, slots=4,
                                  max_len=4096, page_size=128,
                                  prefill_buckets=[32, 64, 128, 256, 512])
        del model
        _free()
        train_ok, train_counts = _timed(
            "train", phase_train, smi,
            LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS))
        _free()
        # activation recompute: K1 runs twice per layer per step
        recompute_ok, _ = _timed(
            "train", phase_train, smi,
            LlamaConfig.llama2_7b(num_hidden_layers=2, use_recompute=True),
            steps=2, profile=False)
        _free()
        grad_ok, _ = _timed("grads", grad_check,
                            LlamaConfig.llama2_7b(num_hidden_layers=2))
    except Exception:
        traceback.print_exc()
        return 1
    if not (kernels_ok and slice_ok and prefix_ok and gen_ok and dense_ok
            and cp_ok and train_ok and recompute_ok and grad_ok):
        print("chip_smoke: a phase failed (see the lines above)", file=sys.stderr)
        return 1
    # launches: the serving, generation and training runs' counts, each read
    # just after its path ran
    runs = [counts, *prefix_counts, gen_counts, dense_counts, *cp_counts,
            train_counts]
    launches = {name: sum(c[name] for c in runs) for name in kernels}
    # K5's two variants are one kernel of the record, on each path
    launches["paged_decode_fused_cp"] += sum(c["paged_decode_fused_cp_q8"]
                                             for c in runs)
    launches["paged_decode_fused_cp_mma"] += sum(c["paged_decode_fused_cp_q8_mma"]
                                                 for c in runs)
    # (record name, source, the Pallas kernel it replaces); a `_wgmma` or
    # `_mma` entry is its kernel's tensor-core path, timed at its main-path
    # shape (K1 at the training shape, the chunk windows at a hit's 256-row
    # chunk prefill), with the launches that took it
    entries = (
        ("flash_fwd", "flash_fwd.cu", 186),
        ("flash_fwd_wgmma", "flash_fwd.cu", 186),
        ("paged_decode_fused", "paged_decode.cu", 813),
        ("paged_decode_fused_mma", "paged_decode.cu", 813),
        ("paged_decode_fused_q8", "paged_decode.cu", 961),
        ("paged_decode_fused_q8_mma", "paged_decode.cu", 961),
        ("flash_bwd", "flash_bwd.cu", 415),
        ("dense_decode", "flash_fwd.cu", 649),
        ("paged_decode_fused_cp", "paged_decode.cu", 1172),
        ("paged_decode_fused_cp_mma", "paged_decode.cu", 1172),
    )
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
         "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
         "launches": launches[name], **kernels[name]}
        for name, src, line in entries
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
