#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Four phases; a failure in any of them exits non-zero and prints no result.

1. device  -- requires CUDA; prints the card's name and power limit.
2. build   -- builds every kernel of `paddle_tpu_torch/csrc` with nvcc.
3. kernels -- holds each kernel against its plain PyTorch version on the
              card, in bf16, at the serving path's shapes, and times kernel,
              plain version and (where one exists) the PyTorch library call
              with CUDA events.
4. slice   -- serves a full-width, full-depth Llama-2-7B (bf16, random
              weights from a seeded generator) through the paged engine
              behind `POST /generate`, checks the token counts and that every
              prefill and decode step launched the two kernels, then
              teacher-forces the generated sequences through the full-sequence
              forward and compares logits.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12

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


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
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


def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    secs = time.perf_counter() - t0
    for line in _build.build.ptxas_report.splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())
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
             f"causal={causal}: max_abs_err {err:.3e}, rel_norm_err {rel:.3e}, "
             f"lse_err {lse_err:.3e}")
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


def _k2_case(b, sq, h, hk, pos, d=128, ps=128, max_len=2048, seed=1,
             dtype="bfloat16", timed=True):
    """K2 against its plain version; with `timed`, also kernel and plain
    times and the bound."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.paging import check_table_bounds
    from paddle_tpu_torch.ops import flash_attention as fa

    P = -(-max_len // ps)
    pages = b * P + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    ak = torch.randn(pages, ps, hk, d, generator=g, device="cuda", dtype=dt)
    av = torch.randn(pages, ps, hk, d, generator=g, device="cuda", dtype=dt)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda", dtype=dt)
    rng = np.random.default_rng(seed)
    tables_np = rng.permutation(np.arange(1, pages)).astype(np.int32).reshape(b, P)
    check_table_bounds(tables_np, pages)
    tables = torch.from_numpy(tables_np).cuda()
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    args = (q, ak, av, tables, pos_t, max_len)
    out = fa.paged_decode_fused(*args)
    torch.cuda.synchronize()
    scale = 1.0 / d ** 0.5
    ref = fa.paged_decode_plain(*args, scale)
    err = (out.float() - ref.float()).abs().max().item()
    rel = rel_norm_err(out, ref)
    ok = close(out, ref)
    shape = (f"paged_decode_fused {dtype} b={b} sq={sq} h={h} hk={hk} d={d} "
             f"ps={ps} pos={pos}: max_abs_err {err:.3e}, rel_norm_err {rel:.3e}")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    ms = time_ms(lambda: fa.paged_decode_fused(*args))
    plain_ms = time_ms(lambda: fa.paged_decode_plain(*args, scale))
    # bytes this data needs: each slot's live K/V rows of every kv head,
    # q, out, tables and pos; operations over the visible (row, key) pairs
    live = [min(p + sq, max_len) for p in pos]
    nbytes = (sum(live) * hk * d * 2 * 2 + 2 * q.numel() * 2
              + tables.numel() * 4 + b * 4)
    visible = sum(min(p + w + 1, max_len) for p in pos for w in range(sq))
    flops = 4 * d * h * visible
    bms, by = bound(nbytes, flops)
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
                   f"library_ms null, bound_ms {bms:.5f} ({by}) -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None)


def phase_kernels():
    """Each kernel against its plain version: timed at the main path's bf16
    shapes, then untimed over every other variant the wrappers launch on
    the card (float32, head_dim 64 and 256, non-causal, the largest shared
    memory).  Returns ({name: record at the headline shape}, all_ok); the
    record's max_abs_err is the worst over the bf16 cases."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    log("kernels", f"tolerances: |kernel - plain| <= atol + rtol |plain| with "
                   f"(atol, rtol) = ({KERNEL_ATOL}, {KERNEL_RTOL}) in bf16, "
                   f"({F32_ATOL}, {F32_RTOL}) in f32; lse within {LSE_ATOL}; "
                   f"rel_norm_err per (batch, head) <= {REL_NORM_TOL}")
    ok_all = True
    k1 = {}
    for s in (16, 128, 512):
        ok, rec = _k1_case(1, s, 32, 32)
        ok_all &= ok
        k1[s] = rec
    ok, rec = _k1_case(1, 300, 32, 8, seed=3)  # ragged, GQA
    ok_all &= ok
    errs1 = [r["max_abs_err"] for r in k1.values()] + [rec["max_abs_err"]]
    ok, k2 = _k2_case(8, 1, 32, 32, [1999, 1500, 1024, 700, 300, 128, 127, 5])
    ok_all &= ok
    ok, rec2 = _k2_case(4, 4, 32, 8, [1000, 513, 64, 0], seed=2)  # GQA, sq 4
    ok_all &= ok
    # the other variants: each line is one kernel instantiation or mode
    for kw in (
        dict(b=1, s=128, h=32, hk=32, dtype="float32"),   # f32 FMA, d 128
        dict(b=1, s=100, h=8, hk=2, d=256, dtype="float32"),  # f32 FMA, d 256
        dict(b=1, s=200, h=16, hk=4, d=256),              # bf16 FMA, d 256
        dict(b=2, s=130, h=32, hk=8, d=64),               # bf16 mma<64>
        dict(b=2, s=200, h=32, hk=8, causal=False),       # non-causal mma<128>
        dict(b=1, s=150, h=8, hk=8, d=64, causal=False, dtype="float32"),
        dict(b=1, s=70, h=4, hk=2, d=36),                 # mma<64>, scalar loads
    ):
        ok, _ = _k1_case(seed=4, timed=False, **kw)
        ok_all &= ok
    for kw in (
        dict(b=4, sq=1, h=32, hk=8, pos=[1500, 700, 129, 3], dtype="float32"),
        # largest shared memory: rep * sq = 64 rows at d 256
        dict(b=2, sq=2, h=32, hk=1, pos=[900, 40], d=256, ps=64, max_len=1024),
        # scalar tile loads (d * 2 bytes not a multiple of 16), 2 splits
        dict(b=2, sq=1, h=4, hk=2, pos=[700, 10], d=36, ps=16, max_len=1024),
    ):
        ok, _ = _k2_case(seed=5, timed=False, **kw)
        ok_all &= ok
    torch.cuda.empty_cache()
    head1 = dict(k1[512], max_abs_err=max(errs1))
    head2 = dict(k2, max_abs_err=max(k2["max_abs_err"], rec2["max_abs_err"]))
    return {"flash_fwd": head1, "paged_decode_fused": head2}, ok_all


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
    run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference import serve
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
    server = serve(engine, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    results = [None] * len(prompts)

    def client(i):
        results[i] = _post(url, {"input_ids": prompts[i].tolist(),
                                 "max_new_tokens": prompts_spec[i][1]})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    server.stop()
    counts = profiler.kernel_launch_counts()
    summary = profiler.serving_summary()
    if any(t.is_alive() for t in threads) or None in results:
        raise RuntimeError("a /generate request did not complete")

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
                 f"token counts {'ok' if tokens_ok else 'WRONG'}; launches {counts} "
                 f"(expected flash_fwd {want_k1} = {len(prompts)} prefills x "
                 f"{layers} layers, paged_decode_fused {want_k2} = "
                 f"{summary['decode_steps']} decode steps x {layers}) -> "
                 f"{'ok' if counts_ok else 'FAIL'}")
    log("slice", f"ttft_p50_ms {summary['ttft_p50_ms']:.3f} ttft_p95_ms "
                 f"{summary['ttft_p95_ms']:.3f} decode_tokens_per_s "
                 f"{decode_tps:.2f} (batch of up to {engine.slots}) "
                 f"occupancy_mean {summary['occupancy_mean']:.3f} "
                 f"peak_mem_gib {peak_gib} | {smi}")

    # -- correctness: the engine's logits vs teacher-forced forward --------
    reqs = [engine.submit(p, max_new_tokens=new, keep_logits=True)
            for p, (_, new) in zip(prompts, prompts_spec)]
    engine.run_until_idle()
    agree = total = 0
    worst = 0.0
    finite = True
    for p, g, r in zip(prompts, gen, reqs):
        out = r.wait(1)
        same = np.array_equal(out[p.size:], g)
        seq = np.concatenate([p, out[p.size:-1]])[None]
        with torch.no_grad():
            ref = model(torch.from_numpy(seq).to(device))[0, p.size - 1:].float()
        eng = torch.stack(r.logits)
        finite &= bool(torch.isfinite(eng).all())
        rel = ((eng - ref).abs().max() / ref.abs().max()).item()
        worst = max(worst, rel)
        agree += int((ref.argmax(-1).cpu().numpy() == out[p.size:]).sum())
        total += out.size - p.size
        log("slice", f"prompt {p.size}: direct run tokens == HTTP tokens: "
                     f"{same}; logits max|diff|/max|logit| {rel:.4f}")
    logits_ok = worst <= LOGIT_REL_TOL and finite
    ok &= logits_ok
    log("slice", f"teacher-forced greedy agreement {agree}/{total} = "
                 f"{agree / total:.4f}; worst logits rel err {worst:.4f} (tol "
                 f"{LOGIT_REL_TOL}) -> {'ok' if logits_ok else 'FAIL'}")
    if on_card:
        profile_decode(engine, cfg, rng)
    return ok, counts


def profile_decode(engine, cfg, rng, prompt_len=256, steps=8):
    """Where a decode step's time goes: every slot busy at ~prompt_len
    tokens, `steps` steps under torch.profiler.  Prints the step's wall
    time, the device's busy and idle shares, and the kernels by device
    time.  Reports "not measured" when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(engine.slots):
        engine.submit(rng.integers(1, cfg.vocab_size, size=prompt_len),
                      max_new_tokens=steps + 4)
    engine.step()  # admits every slot (prefills) and decodes once
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()  # ends in the host fetch of the step's tokens
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.run_until_idle()
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0.0)
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us
    busy = sum(kernels.values())
    if busy <= 0:
        log("profile", "device time not measured (the profiler saw no kernels)")
        return
    log("profile", f"decode step, {engine.slots} slots at ~{prompt_len} tokens: "
                   f"wall {wall_us / steps / 1e3:.3f} ms/step, device busy "
                   f"{busy / steps / 1e3:.3f} ms/step, idle share "
                   f"{1 - busy / wall_us:.3f}")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log("profile", f"  {us / busy:6.3f} of device time, "
                       f"{us / steps / 1e3:.4f} ms/step: {name[:90]}")


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
        smi = phase_device()
        phase_build()
        kernels, kernels_ok = phase_kernels()
        from paddle_tpu_torch.models.llama import LlamaConfig

        slice_ok, counts = phase_slice(
            smi, LlamaConfig.llama2_7b(), slots=8, max_len=2048,
            page_size=128, prefill_buckets=[32, 64, 128, 256, 512],
        )
    except Exception:
        traceback.print_exc()
        return 1
    if not (kernels_ok and slice_ok):
        print("chip_smoke: a phase failed (see the lines above)", file=sys.stderr)
        return 1
    record = {"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:186",
         "launches": counts["flash_fwd"], **kernels["flash_fwd"]},
        {"name": "paged_decode_fused", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_decode.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:813",
         "launches": counts["paged_decode_fused"],
         **kernels["paged_decode_fused"]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
