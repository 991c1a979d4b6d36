#!/usr/bin/env python3
"""Time two checkouts of the port's attention kernels on one CUDA card, in
turns.

    python3 ab_kernels.py OLD_DIR NEW_DIR [--train] [--bert]

Each checkout runs in a process of its own, so its kernels build from its
own sources into its own build directory, in the order old, new, new, old,
on the same inputs made from fixed seeds by that checkout's `chip_smoke`
helpers:

- K1 (`flash_forward`) and K3 (`flash_backward`) at the training shape
  (b 4, s 2048, h 32, d 128, causal), K3 at s 512, and both without a
  mask at BERT-base's shape (b 32, s 384, h 12, d 64, not causal);
- K2 and K4 (`paged_decode_fused`, `_q8`) at the serving decode step (b 8,
  sq 1, h 32, pos up to 1999 of 2048, page size 128);
- K5 on one card (`paged_decode_cp`, cp 2) at the long-document decode
  step (b 8, pos 3022-3808 of 4096), the cp tables derived beforehand.

One JSON line per kernel and turn: the wrapper's median time over CUDA
events (host time included) and its device time per call (torch.profiler:
the summed durations of the kernels it launched).  With --train, also the
median step time of steps 2-4 of the training slice (Llama-2-7B's widths at
8 layers, batch 4 x 2048, bf16 O2 + AdamW); with --bert, the median step
time of steps 2-10 of the bert phase's training (BERT-base, 32 x 384, bf16
O2 + AdamW, no dropout), whose step is bound by the host.  Compare times
only within one call: two calls may land on cards with other power limits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _child(tree, train, bert):
    sys.path.insert(0, tree)
    import statistics
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa

    def device_ms(fn, iters=10):
        from torch.profiler import ProfilerActivity, profile

        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total", 0.0)
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False))
        return us / iters / 1e3 if us > 0 else None

    def emit(name, fn):
        print("AB " + json.dumps({"tree": tree, "kernel": name,
                                  "ms": cs.time_ms(fn), "device_ms": device_ms(fn)}),
              flush=True)

    for b, s, h, d, causal in ((4, 2048, 32, 128, True), (4, 512, 32, 128, True),
                               (32, 384, 12, 64, False)):
        g = torch.Generator(device="cuda").manual_seed(6)
        q, k, v, go = (torch.randn(b, s, h, d, generator=g, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_forward(q, k, v, causal=causal)
        shape = f"b={b} s={s} h={h} d={d} causal={causal}"
        if s != 512:
            emit(f"flash_fwd {shape}", lambda: fa.flash_forward(q, k, v, causal=causal))
        emit(f"flash_bwd {shape}",
             lambda: fa.flash_backward(q, k, v, out, lse, go, causal, d ** -0.5))
    pos = [1999, 1500, 1024, 700, 300, 128, 127, 5]
    for quant in (False, True):
        q, ak, av, scales, tables, pos_t = cs._paged_inputs(
            8, 1, 32, 32, pos, 128, 128, 2048, 1, "bfloat16", quant, False)
        fn = fa.paged_decode_fused_q8 if quant else fa.paged_decode_fused
        emit("paged_decode_fused_q8" if quant else "paged_decode_fused",
             lambda: fn(q, ak, av, *scales, tables, pos_t, 2048))
    q, ak, av, _, tables, pos_t = cs._cp_inputs(
        8, 1, 32, 32, cs.K5_DECODE_POS, 128, 128, 4096, 2, 20, "bfloat16", False)
    per = ak.shape[0] // 2
    stacked = getattr(fa, "cp_stacked_tables", None)
    local = (stacked or fa.cp_local_tables)(tables, 2, per, 128)
    emit("paged_decode_fused_cp cp=2",
         lambda: fa.paged_decode_cp(q, ak, av, tables, pos_t, 4096, 2, local=local))
    if train:
        from paddle_tpu_torch.models.llama import LlamaConfig

        del q, ak, av
        torch.cuda.empty_cache()
        model, opt = cs._train_model(LlamaConfig.llama2_7b(num_hidden_layers=8),
                                     "cuda")
        ids = torch.from_numpy(np.random.default_rng(0).integers(
            1, 32000, size=(4, 2048)).astype(np.int32)).cuda()
        secs = []
        for _ in range(4):
            t0 = time.perf_counter()
            cs._train_step(model, opt, ids).item()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print("AB " + json.dumps({"tree": tree, "kernel": "training step",
                                  "ms": statistics.median(secs[1:]) * 1e3}),
              flush=True)
        del model, opt
        torch.cuda.empty_cache()
    if bert:
        from paddle_tpu_torch.models.bert import BertConfig

        cfg = BertConfig.bert_base(hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
        model, opt = cs._bert_model(cfg, "cuda")
        inputs = cs._bert_inputs(cfg, "cuda", cs.BERT_BATCH, cs.BERT_SEQ, 0)
        secs = []
        for _ in range(10):
            t0 = time.perf_counter()
            cs._bert_step(model, opt, inputs).item()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print("AB " + json.dumps({"tree": tree, "kernel": "BERT training step",
                                  "ms": statistics.median(secs[1:]) * 1e3,
                                  "all_ms": [x * 1e3 for x in secs]}), flush=True)


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        _child(args[1], "--train" in args, "--bert" in args)
        return 0
    flags = [a for a in args if a in ("--train", "--bert")]
    trees = [a for a in args if a not in flags]
    if len(trees) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(t) for t in trees)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tree in (old, new, new, old):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree] + flags
        if subprocess.run(cmd, cwd=tree).returncode != 0:
            print(f"ab_kernels: the run of {tree} failed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
