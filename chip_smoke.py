#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Twenty-seven phases, and the serving, training and amp ones again in float16
(below); a failure in any of them exits non-zero and prints no result.

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
              tensor-core chunk window, the FMA page walk); K1 and K3 with
              segment ids and key bias on each of their paths, timed at
              BERT's shape beside SDPA with the equivalent boolean mask.  K5
              (context-parallel decode) is timed beside K2 over the same
              global arena; the chunk windows of K2, K4 and K5 are timed
              apart.  Then K1 and K3 with the ring operands: q_offset over
              rectangular keys (the gathered form's launch, rank 7 of 8 at
              bench_longcontext_32k's shape: 4096 rows against 32768 keys, 8
              heads of 128) timed beside SDPA with the equivalent boolean
              mask; K1 with float32 out and with the carry, K3 with delta
              (a rotating hop: 2048 rows against 2048 keys), timed; then
              each on every path (wgmma, mma.sync, FMA).  K2 over the page
              view of a dense static cache (`decode_attention` outside K6's
              shapes) at the generate phase's decode step and the dense
              pool's, timed beside the float32 dense math it replaces and
              SDPA over the dense cache with the mask j <= pos.  Then the
              optimizer's kernels: adam_fused (one launch over every
              tensor) at the train phase's 8-layer parameters (bf16 with
              float32 masters, float32 norms) and at BERT-base's, against
              adam_multi_plain (parameters, masters, moments and beta
              powers equal bit for bit, parameters equal to the masters
              rounded), decay terms larger than the update among the
              variants, timed
              beside torch.optim.AdamW(fused=True) over float32 tensors of
              the same shapes; a set found_inf changes nothing, bit for
              bit; every decay mode, dtype, unaligned and ragged tensor
              untimed; unscale_fused over the train phase's gradients,
              bit for bit against its plain version, clean and with one
              inf, timed beside torch._amp_foreach_non_finite_check_and_
              unscale_.  Then every K1-K6 case above that runs in bf16
              again in float16 at the same shapes, at the float16
              tolerance, one case per kernel timed (the `_f16` records),
              and adam_fused and unscale_fused over float16 parameters
              and gradients, timed.
4. ring    -- bench_longcontext_32k's attention (one 32768-token sequence, 8
              heads of 128, R = 8 ranks of the sep axis on the card): forward
              and backward of full-sequence causal K1 + K3, then
              `ring_attention_array` in the gathered and the rotating
              zig-zag forms, then non-causal K1 + K3 and the non-causal
              Pallas-hop ring; each ring form against its flash run (outputs,
              gradients) with the launches its form implies; prints
              attention_32k_fwd_bwd_ms, each form's ms (all ranks and per
              rank) and ring_vs_split_flash.
5. slice   -- serves a full-width, full-depth Llama-2-7B (bf16, random
              weights from a seeded generator) through the paged engine
              behind `POST /generate`, checks the token counts and that every
              prefill and decode step launched the two kernels, then
              teacher-forces the generated sequences through the full-sequence
              forward and compares logits; one request posted twice with
              `X-Idempotency-Key` generates once, `X-Deadline-Ms: 0` answers
              504.
6. prefix  -- the same model behind prefix-cached engines, in full precision
              and over int8 pages: requests sharing a system prompt hit the
              cache, copy its tail page and chunk-prefill their suffix; checks
              token counts, hits and copies, the launches of K1, K2 and K4
              (every chunk prefill on the tensor-core path), logits against
              the teacher-forced forward, and prints the int8 run's greedy
              agreement with the full-precision run.
7. generate -- the same model's lock-step `generate` on its captured
              steps (`model._gen_fns`, CUDA graphs): greedy over four
              500-token prompts, beam search, seeded sampling, a short
              prompt, each called twice (the second traces nothing, gives
              the first's tokens, and its tokens/s is printed); a third
              sampling seed differs; K6 launched once per layer by every
              prefill of 64+ tokens, K2 over the caches' page view by every
              other step, no other kernel; one greedy and one beam decode
              step replayed equal to eager bit for bit; prefill and decode
              logits against the teacher-forced forward; then a warmed
              `GenerationPredictor` behind `POST /generate`.
8. dense   -- the same model behind the dense slot-pool engine
              (`paged=False`) over HTTP: token counts, K1 once per layer per
              prefill and K2 over the pool's page view once per layer per
              decode step, no other kernel, logits against the
              teacher-forced forward, decode tokens/s, TTFT and the graph
              pool beside the paged slice's, a profiled decode step.
9. fault   -- the serving fault domain on the same model behind a warmed
              paged engine (prefix cache off, so every pass prefills
              afresh): the slice's six requests unfaulted over POST
              /generate under `serve(supervise=True)` with the watchdog
              armed (K1 and K2 counted; decode tokens/s and a profiled
              decode step beside PR 12's), then drills under
              `EngineSupervisor`, each checked against the unfaulted
              pass's tokens bit for bit: a 512-token request evicted at its
              deadline (DeadlineExceeded, its slot to the queued request;
              the lag from deadline to resolve), a cancelled queued and
              slotted request, a prefill hang ended by the watchdog (one
              warm restart, no new trace, no replay of the woken thread;
              the ms from the trip to the first token after it), a NaN
              poisoned slot (one NonFiniteLogits), a crashed scheduler
              loop, the restart budget spent (fail_all: every request
              EngineRestarted), a deadline under the drain estimate
              (DeadlineUnattainable), and `server.drain()` with POSTs in
              flight (they finish; a new one answers 503 with Retry-After;
              /healthz reads draining); every request resolves exactly
              once.
10. obs    -- the observability spine on the same model behind a warmed
              paged engine (prefix cache off) under `serve(supervise=True)`:
              the slice's six requests with FLAGS_trace off, then on with
              client X-Trace-Id / X-Parent-Span (the same tokens bit for
              bit, no new trace, the same host fetches per decode step,
              every id echoed, each /trace/<id> one serve.handle under the
              client's span with engine.queue/prefill/decode/fetch; K1 and
              K2 counted; decode tokens/s with trace off and on); /metrics
              scraped around the traced pass (the kept name list, requests
              and tokens moved by the traffic, dispatch counts per compiled
              shape > 0 and unmoved, no fallback); a prefill hang under the
              supervisor writes a watchdog flight dump, then the restart's;
              a profiled decode window with trace on runs the kernels per
              step of one with trace off.
11. lora   -- multi-tenant LoRA on the same model: 16 random adapters
              (rank 8, all seven targets) through an arena of the default
              capacity 8.  The slice's six requests over POST /generate,
              four of them on adapters (K1 and K2 counted); all 16
              adapters twice through the 8-slot arena (every reload's
              tokens equal its first's bit for bit, the page and LoRA
              audits every step); base rows equal a no-LoRA engine's and
              two adapter rows an engine holding that adapter alone, bit
              for bit; the mix under spec_k 4 equal to plain decode or a
              near tie; a per-adapter prefix hit (the chunk window under
              LoRA) and a miss under another adapter; `adapter` over HTTP,
              an unknown one answered 404, a burst that parks on a full
              arena; first-token logits against an eager float32 forward
              with the adapter merged into the weights; no new trace.
              Records the decode step with eight adapters co-batched
              beside the base engine's (ms, tokens/s, kernels per step),
              the arena's bytes and one upload's ms.
12. sessions -- multi-turn KV sessions on the same model: a 14-turn
              conversation (a 300-token system prompt, 40 user and 32
              generated tokens a turn) through a session engine and a
              stateless one: each turn's tokens equal or a near tie, its
              first-token logits against the teacher-forced forward, >=
              90% of turns 2-14's prompt tokens reused, 14 binds, no new
              trace, every chunk prefill on K2's tensor-core path; a turn
              over POST /generate with `session_id`; a warm restart keeps
              the session; a small pool evicts the idle session whole
              under sessionless traffic.  Records TTFT per turn of both
              engines and the pages pinned.
13. disagg -- disaggregated prefill/decode on the same model: a
              colocated, a prefill-role and a decode-role engine, each
              behind `serve()`.  Five requests (prompts of 64-377
              tokens, two under a 300-token system prompt, so the second
              takes a prefix hit on the prefill side; 32 tokens each) go
              to the colocated server, then through the three hops by
              hand: POST /reserve to the decode server, /prefill to the
              prefill server, /generate with the handoff and the
              reservation to the decode server.  Checks: tokens equal the
              colocated engine's bit for bit; the import graph traced once
              at warmup on the decode role alone and no new trace on any
              engine; K1 on the fresh prefills, K2's chunk window on the
              hits and its walk on the decode steps, counted exactly; one
              replay of the import graph equal to an eager import and to
              its tiles; each reservation held until its admission and 0
              after it, a short one reclaimed at its TTL; /prefill with two
              prompts answered 400; the decode server's paddle_disagg_*
              equal to the phase's own counts.  Then the same over int8
              pages (K4) for three of the requests, whose wire bytes are
              (128 + 4) / 256 of the bf16 pass's.  Records wire bytes per
              token, export, serialize, hop, stage and import times,
              disaggregated against colocated TTFT and decode tokens/s.
14. fleet  -- the serving fleet (`paddle_tpu_torch.serving`) on the same
              model, every replica an in-process `serve()` over its own
              engine and arena: the slice's six requests straight to one
              replica, then through `serve_router`'s POST /generate over
              two (each answer equal bit for bit), then keyed through a
              bare and a journaled router; the preferred replica stopped at
              the stream's midpoint (every request once, the same tokens);
              a keyed double submit and an in-flight join generate once;
              `router.crash`, a `RouterStandby` takeover from the stale
              heartbeat, the completed key replayed from the journal with
              no new admission; a colocated replica and a prefill/decode
              pair behind one router (two prompts of 64 and 128 tokens, bit
              for bit the colocated answers), in bf16 and over int8 pages
              (K4); a four-turn chat pinned to one replica and repinned
              when it drains, an adapter request landing on the replica
              that holds it; the autoscaler taking one replica to two and
              back under a stepped `Workload` through `run_soak`; two tiny
              `ReplicaProcess` workers on the card, one SIGKILLed under
              load (every request once, each 200 an in-process engine's
              tokens, both reaped).  K1, K2 and K4 counted; every
              in-process engine free of new traces under its traffic.
              Records the hop on 60 rounds of one-token requests (routed
              minus direct and journaled minus bare, paired medians with
              their quartiles), the takeover seconds over three crash ->
              takeover cycles, spawn-to-ready over three spawns, TTFT
              through the router disaggregated against colocated.
15. tp     -- tensor-parallel serving of the same model with every rank on
              the card, named explicitly (`devices=["cuda"] * tp`), the tp
              models' weights views of the loaded ones (`tp_twin`), prefix
              cache off: the slice's six requests at tp 1, 2 and 4 (tp 4
              over POST /generate): tokens equal to tp 1's or parting at a
              near tie, K1 once per rank per layer per prefill and K2 once
              per rank per layer per decode step (tp x 32 a step), no other
              kernel, no retrace, prefill and decode replays equal to eager;
              a warm restart at tp 4 (same tokens, same arenas, no trace);
              int8 pages at tp 4 against int8 at tp 1 (K4 per rank); the
              dense pool at tp 4 on two requests; a float32 Llama of 2
              layers at full width, tp 4 against tp 1, tokens identical.
              Prints decode ms and kernels per step at tp 1, 2 and 4, the
              rank reduces' share of a tp-4 step and K2/K4 launches per
              step.  On one card tp 4 is a parity gate, not a speed figure.
16. cp     -- the same model behind long-document engines (slots 4, the
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
17. train  -- trains Llama-2-7B's widths at 8 layers (bf16 AMP O2, AdamW with
              float32 master weights) for 6 steps on one repeated batch of
              4 x 2048 tokens: finite and falling losses, K1 (on its wgmma
              path) and K3 launched once per layer per step, adam_fused
              once per step, every weight moved; step time,
              tokens/s, peak memory and a profiled step with AdamW's span.
              Then 2 steps of 2 layers with activation recompute (K1 twice
              per layer per step).
18. fit    -- the training loop through the entry points a user calls
              (`paddle_tpu_torch.Model`, `io.DataLoader`): the train
              phase's model (8 layers, bf16 O2, AdamW) through `Model.fit`
              over 32 seeded sequences of 2048 tokens, batch 4, shuffled
              from a seeded torch.Generator, two worker processes,
              `prefetch_to_device=2`, log_freq 4, FLAGS_max_inflight_steps
              2: finite, falling losses equal bit for bit to a hand-written
              loop's on a model from the same seed over the same batches
              (built after the first is freed), one host fetch per window,
              paddle_train_steps_total and _inflight_max on /metrics, K1,
              K3 and adam_fused launches equal to the hand loop's; then
              `evaluate` over 4 held-out batches (K1 only; its mean loss
              equal to a no_grad loop's); step time and tokens/s beside
              the hand loop's, host time blocked per step.  Then, at 2
              layers, exactly-once resume (a checkpoint with the loader's
              position after step 4 of 8; a model from another seed resumes
              it and its steps 5-8 equal the uninterrupted run's bit for
              bit; bytes, save and load seconds), a divergence drill (SGD
              at 1e30, NonFiniteLossError within max_bad_steps + log_freq
              steps), and bench_bert's BERT-base through `BucketSampler`
              (128, 256, 384) and `padded_collate` (192 lengths 64-384):
              three batch shapes, masked K1 and K3 every step, no
              fallback; examples/s beside the bert phase's padded figure.
              No worker process is left after any of them.
19. grads  -- one step's gradients of a 2-layer model at the same widths
              with the kernels against the same step with attention through
              the plain forward under autograd.
20. amp    -- the reference's O1 recipe on Llama-2-7B's widths at 2 layers,
              float32 parameters, batch 2 x 2048: auto_cast O1 bf16, a
              dynamic GradScaler, LinearWarmup into CosineAnnealingDecay,
              ClipGradByGlobalNorm(1.0) and AdamW for 6 steps, step 4's
              gradients given one inf: finite, falling losses; the inf
              step leaves every parameter, moment and power bit for bit
              and halves the scale; each step at its scheduler's rate;
              K1 and K3 once per layer per step on their wgmma paths,
              adam_fused and unscale_fused once per step.  Then SGD,
              Momentum, Adagrad, RMSProp, Adamax and Lamb two steps each:
              finite, every weight moved, step ms.
21. bert   -- bench_bert's BERT-base SQuAD fine-tuning (bf16 O2, AdamW at
              3e-5, dropout 0) for 6 steps on one batch of 32 x 384 tokens
              padded from lengths 192-384: finite and falling losses, K1 and
              K3 launched once per layer per step on their wgmma paths with
              segment ids and no fallback, adam_fused once per step, step
              time, examples/s, peak memory and a profiled step with
              AdamW's span; an encoder layer with the padding
              as a key-padding attn_mask (K1's key bias) against segment ids
              on the valid rows; then a 2-layer model's gradients with the
              kernels against attention through the plain forward.
22. jit    -- the bench legs' training steps as bench.py writes them, under
              `jit.to_static` (each captured once as a CUDA graph): (a)
              bench_llama's, Llama-2-7B's widths at 8 layers, 4 x 2048,
              bf16 O2, AdamW; (b) bench_bert's, BERT-base 32 x 384 padded,
              bf16 O2, AdamW; (c) bench_resnet50's, ResNet-50 NHWC 128 x
              224, bf16 O2, Momentum, under cudnn.deterministic; (d) the
              Llama at 2 layers, 2 x 1024, fp16 O2 under a dynamic
              GradScaler, step 2's gradient given an inf; (e) BERT-base
              at 2 layers with its dropout on and a StepDecay rate stepped
              between calls.  Each: 4 captured steps from the seed against
              4 eager ones of a fresh build, losses and every parameter,
              master, moment, power, buffer and scaler counter bit for
              bit; one trace, no retrace; K1, K3, adam_fused and
              unscale_fused launches per replay equal to eager's per step;
              eager and captured step ms in turns, the first call's
              seconds, the graph pool's bytes and the peak memory.  Then
              (f) `static.nn.cond` and `while_loop` inside captured steps,
              one capture each, their branches and loop bodies in the
              graph's IF and WHILE nodes (csrc/graph_cond.cu): cond's
              value and gradient both ways with a counter in each branch
              (only the taken one moves), a sqrt of a negative in the
              untaken branch (the gradient stays finite), a branch that
              returns a captured tensor (its gradient passes), a loop
              whose trip count is an input (5, 3, 0, 7 passes from one
              capture), a bounded loop's gradients through a captured
              weight; each exact.  (g) FLAGS_check_nan_inf on the Llama of
              (d) in bf16 O2 with AdamW (K1, K3): three builds, the flag
              off, on, off again, 3 captured steps each; losses equal bit
              for bit, a NaN input raising FloatingPointError naming the
              compiled step and the loss's add, the kernels per captured
              step with the flag off again equal to before it was on; the
              flag-on warm run's backward, an eager step and a K3 launch
              over an allocator whose free blocks were all filled with NaN
              raise nothing, and K3 under a NaN gradient raises naming
              flash_bwd.
23. export -- the inference export: (a) BERT-base sequence
              classification (12 layers, 768 wide, 12 heads) in bf16 at 32
              x 128 with key padding, `jit.save` with InputSpecs, then
              `jit.load` in a fresh process that imports only the port:
              12 `paddle_tpu_torch::flash_fwd` nodes and no inlined
              attention in the graph, outputs equal to the live forward
              bit for bit, exactly 12 K1 launches a run, one trace for
              three runs, a replay equal to the program's eager run;
              jit.load's seconds and Predictor.run's ms beside the eager
              program; (b) `serve(prefix)`: four POST /predict equal to
              Predictor.run bit for bit, GET /health; (c) a tiny float32
              BERT exported on the CPU, run on the card: K1 launched,
              outputs within K1's float32 tolerances of the CPU's; (d)
              Llama-2-7B's widths at 2 layers, bf16, logits at 1 x 512,
              exported on the card: equal to the live forward bit for bit,
              2 K1 launches a run.  K1 is first held against its plain
              version at (a)'s shape and timed there beside SDPA with the
              equivalent mask (the `flash_fwd_export` record), and the
              registered op's host cost per call against its body called
              directly.
24. gpt    -- GPT-3 13B (`models/gpt.py`, BASELINE's fifth configuration)
              at full width and depth (40 layers of 40 heads of 128,
              hidden 5120, FFN 20480, vocab 50304), bf16, seeded weights
              built on the card: the generate phase's checks on it (greedy
              4 x 500 + 64, beam search with 2 beams, seeded sampling, a
              20-token prompt, each twice; K6 and K2 launches exactly; a
              replay against eager bit for bit; a warmed
              `GenerationPredictor` behind POST /generate), then the
              greedy tokens against the argmax of one full forward (K1)
              over the generated sequence, a differing token a near tie;
              prefill ms (one replay), decode ms a step (replays),
              generated tokens/s, peak memory.
25. moe    -- the GShard mixture of experts (`incubate/moe.py`): (b)
              GPT-3 13B's widths at 2 layers, layer 1 an MoE of 8 experts
              (top-2, capacity factor 2.0), bf16 O2, AdamW, 2 x 2048 tokens:
              4 captured steps against 4 eager ones of a fresh build, bit
              for bit (loss, aux loss, dropped fraction, every parameter and
              optimizer state), one trace, K1, K3 and adam_fused in each
              replay, falling losses, aux > 0; two eager steps with
              `use_recompute` equal to the plain ones; a greedy `generate`
              of the model checked as in the generate phase.  (c)
              bench_moe's step (bench.py:2229-2253: d 1024, hidden 4096, 8
              experts, top-2, 8 x 1024 tokens, float32 with TF32 off, AdamW)
              under `to_static`: against an eager twin bit for bit, one
              trace, step ms and tokens/s (median of 3 windows of 12 steps),
              aux and dropped fraction, the dispatch and combine einsums'
              share of an eager step's device time (CUDA-event time when
              the profiler sees none); the routing functions on the
              card against the CPU (tied bf16 logits among them) and the
              layer against float64 on the CPU.
26. longcontext -- long-context training through the Llama's
              `context_parallel_degree` on a sep mesh (ring attention, every
              rank on the card): Llama-2-7B's widths at 4 layers, one
              sequence of 32768 tokens over R = 8 (K/V 512 MiB a layer: the
              rotating zig-zag form), bf16 O2 + AdamW, 3 steps: finite and
              falling losses, exactly R (2R + 1) K1 and K3 launches per
              layer per step (2R - 1 per rank with the carry, every K3 with
              delta), every one on the wgmma path, no plain attention,
              adam_fused once per step; step time, tokens/s, peak memory, a
              profiled step.  Then 2 layers,
              16384 tokens over R = 4 (K/V exactly 256 MiB: the gathered
              form, one K1 and one K3 with q_offset per rank), 2 steps; then
              one step's gradients of 2 layers at 32768 tokens over R = 8
              against context_parallel_degree 1 (full-sequence K1/K3).
27. vision -- the conv nets on the port's conv, pool and batch-norm
              layers (torch ops on cuDNN; no Pallas kernel of the
              reference is on this path): (a) bench_resnet50's recipe,
              ResNet-50 at batch 128 x 224 x 224, 1000 classes,
              Momentum(0.1, 0.9), bf16 O2 with float32 masters, fed float32
              images, eager, NHWC then NCHW: finite, falling losses;
              images/s (median of 3 windows of 20 steps after warm-up),
              step ms, time to the first step, peak memory, and one step
              profiled in its parts -- device time of conv forward, conv
              backward, batch norm, elementwise and optimizer kernels, and
              the layout-conversion kernels per step; (e) VGG-16 with batch
              norm, batch 32, bf16 O2: two steps with finite losses, peak
              memory; (b) a seeded float32 ResNet-50 at batch 4 with TF32
              off: the card's logits (eval and train-mode batch norm), loss
              and conv1.weight gradient against the same model on the CPU,
              and NHWC against NCHW on the card, each within 2e-3 by
              relative norm (train-mode gradients 1e-1: the batch norms'
              backward over four images leaves float32 itself ~2e-2 from
              exact); (c) bench_lenet_eager: LeNet, batch 16, Adam
              1e-3, steps/s over 30 steps after 2 warm-ups, time to the
              first step, adam_fused once per step; (d) bench_hapi_async's
              LeNet half: `Model.fit` over 512 rows, batch 32, Adam and
              Accuracy, at FLAGS_max_inflight_steps 1 and 2 (median of 3
              epochs each, record_step's dispatch and host-blocked ms and
              in-flight depth), then fit's losses equal bit for bit to a
              hand loop's under cudnn.deterministic, adam_fused once per
              step.  cudnn.benchmark is on for (a) and (e).

The float16 phases (their log lines read "[fp16 <phase>]"):
- serve (after cp_f32) -- Llama-2-7B in float16 at full width and depth:
  the slice phase's traffic and checks, the range of the residual
  stream through the 32 layers, a comparison line beside the bf16
  slice's figures (decode tokens/s, TTFT, the profiled decode step, peak
  memory), the prefix phase over int8 pages (K4 with a float16 q), the
  greedy lock-step `generate` (K6, K2 over the page view) and one cp=2
  run of the cp phase (K5).
- train (after grads) -- the train phase's shape in fp16 O2 under a
  dynamic GradScaler (2^15), 8 steps, step 4 given one inf: every skipped
  step unchanged bit for bit with the scale halved, losses of the applied
  steps finite and falling, K1 and K3 with float16 operands on their
  wgmma paths, adam_fused and unscale_fused once per step.
- amp (after amp) -- the amp phase's O1 run with auto_cast(dtype=
  "float16"), the other optimizers aside.
The record's `_f16` entries count the launches of these runs.

Every serving phase (slice, prefix, dense, fault, obs, lora, sessions,
disagg, fleet, tp, cp, cp_f32) runs on the
engine's CUDA graphs: it prints `compile_counts()` after warmup and again
after its traffic and fails if they differ (0 new traces under traffic;
the fleet checks each in-process replica's engine so).  Each but the fleet,
whose replicas run the configurations of the phases before it, also
prints the host fetches per decode step and decode tokens/s over the
decode window's wall clock, and holds one replay of each
step that an admission ran -- fresh prefill, chunk prefill, decode or
verify -- against an eager run of the same body on the same static
inputs, bit for bit (cp_f32 and fault aside; lora holds a mixed-adapter
fresh prefill and decode, a verify and an adapter's chunk prefill, sessions a
session turn's chunk prefill, disagg the decode role's import alone).  The profiled steps print the host's time until the
last step returned and the kernels per step beside wall, busy and idle.

Every phase prints its wall time.  The line before the last is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 (and fp16)
# tensor FLOP/s and float32 FLOP/s outside the tensor cores
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
# float16: the same two rounding points at float16's ulp, 2^-10 relative
# (8x finer than bf16's), so a few ulps: rtol 4e-3 and atol 2e-3, each
# tighter than bf16's
FP16_ATOL = 2e-3
FP16_RTOL = 4e-3
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
REL_NORM_TOL = {"bfloat16": 1e-2, "float16": 2e-3, "float32": 1e-4}
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
# the greedy call's generated tokens/s and the dense pool's decode tokens/s
# and graph pool MiB when both ran eager steps over the float32 dense math
# (this script's generate and dense phases before the steps were captured
# and the dense attention moved onto K2; NVIDIA H100 80GB HBM3, 700 W):
# the "was" each phase prints beside its own figure
GEN_TOKENS_PER_S_WAS = 86.03
DENSE_TOKENS_PER_S_WAS = 80.55
DENSE_GRAPH_POOL_MIB_WAS = 602
# the slice's profiled paged decode step (8 slots at ~256 tokens) and its
# decode tokens/s in PR 12's final run (NVIDIA H100 80GB HBM3, 700 W): the
# fault phase prints its own beside them
SLICE_DECODE_STEP_MS_WAS = 11.919
SLICE_DECODE_TPS_WAS = 428.43

# the fault phase's drills: the watchdog deadline of every armed region,
# how long the injected prefill hang blocks (past the deadline, so the
# watchdog ends it and the hung thread wakes after the restart), the
# deadline of the request evicted mid-flight, and its new tokens
FAULT_STEP_TIMEOUT_S = 2.0
FAULT_HANG_S = 5.0
FAULT_EVICT_DEADLINE_S = 0.3
FAULT_EVICT_NEW = 512

# the obs phase: the client's span, the parent of every traced request's
# serve.handle
OBS_CLIENT_SPAN = "c1c1c1c1c1c1c1c1"
# after the first trace-off and trace-on passes: the FLAGS_trace of each
# further timed pass
OBS_PASSES = (True, False, False, True, True, False)
# profiled decode windows of each FLAGS_trace setting, at most: torch.profiler
# can lose kernel records of a window (one full run counted 2081.9 kernels a
# step with trace off against 2087.5 with it on, the two equal in every other
# run), and a lost record only lowers a count, so while the two largest
# counts differ both settings are profiled again
OBS_PROFILE_WINDOWS = 3

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

# the cp_f32 phase: the cp phase's traffic with the model and its arenas in
# float32, through (label, cp, spec_k) engines, each held against the first.
# A first divergence passes as a near tie when the first run's top-2 logit
# gap there is at most F32_TIE_REL of max|logit|: float32 re-associated sums
# (split and shard merges in another order) move logits by ~1e-6 relative,
# so a gap 1000x that is still a tie, while a wrong page or mask moves
# logits by whole units
CP_F32_RUNS = [("a cp1", 1, 0), ("b cp2", 2, 0), ("c cp2 spec2", 2, 2)]
F32_TIE_REL = 1e-3

# the lora phase: LORA_ADAPTERS random adapters (make_random, rank
# LORA_RANK, seed i, all seven targets) in an arena of the default
# capacity (8) at rank_max LORA_RANK; the main co-batch gives the slice's
# prompts the adapters of LORA_MIX (None: the base model); the churn runs
# every adapter once per round, each with its own LORA_CHURN_LEN-token
# prompt and LORA_CHURN_NEW new tokens, LORA_CHURN_ROUNDS rounds; then the
# mix under spec_k LORA_SPEC_K
LORA_ADAPTERS = 16
LORA_RANK = 8
LORA_MIX = (None, "a0", "a1", None, "a2", "a3")
LORA_CHURN_LEN = 64
LORA_CHURN_NEW = 16
LORA_CHURN_ROUNDS = 2
LORA_SPEC_K = 4
# the sessions phase: a SESSION_TURNS-turn conversation after a
# PREFIX_SYS_LEN-token system prompt, SESSION_USER user tokens and
# SESSION_NEW generated per turn (~1.3k tokens of context by the last
# turn); at least SESSION_REUSE_MIN of turns 2-N's prompt tokens come from
# the session's pages.  The drill: a SESSION_DRILL_POOL-page pool (one
# scratch) under SESSION_DRILL_LEN-token sessionless prompts
SESSION_TURNS = 14
SESSION_USER = 40
SESSION_NEW = 32
SESSION_REUSE_MIN = 0.90
SESSION_DRILL_POOL = 8
SESSION_DRILL_LEN = 600
# bf16 near ties, the form of F32_TIE_REL: a first divergence passes when
# the top-2 logit gap there is at most this share of max|logit|.  Two runs
# whose logits differ by at most D (max|diff| / max|logit|) can swap their
# top two tokens only where the gap is at most 2D, so each bound is twice
# the largest D measured on the card before it was set, rounded up (the
# phases print D every run; NVIDIA H100 80GB HBM3, 700 W): SESSION_TIE_REL
# from the first-token logits of a chunk-prefilled turn against the
# fresh-prefilled one (0.0112-0.0168 over turns 2-20), SPEC_TIE_REL from
# the verify window's logits against plain decode's on the same tokens
# (0.0110-0.0164 over the mix's six requests).  A wrong page, mask or
# adapter row moves logits by whole units (the adapter's own effect on
# the first token is ~0.3)
SESSION_TIE_REL = 0.04
SPEC_TIE_REL = 0.04
# the tp phase: tp 2 and 4 (every rank on the one card) against tp 1 on the
# slice's traffic; the dense pool on its first TP_DENSE_PROMPTS requests; a
# float32 Llama of TP_F32_LAYERS layers at full width, tokens identical.
# TP_TIE_REL has SESSION_TIE_REL's form and rule: twice the largest D
# measured on the card before it was set, rounded up (the phase prints D
# every run: 0.0151-0.0187 over the six requests at tp 2, tp 4 and tp 4
# over int8 pages; NVIDIA H100 80GB HBM3, 700 W).  The row-parallel reduce
# sums the ranks' bf16 partials in float32 where tp 1's GEMM rounds one
# product, which moves logits as a reordered bf16 sum does
TP_DEGREES = (2, 4)
TP_DENSE_PROMPTS = 2
TP_F32_LAYERS = 2
TP_TIE_REL = 0.04
# the tp phase's tp x cp part: the cp phase's document traffic (CP_DOC_LEN
# tokens, CP_QUESTIONS, TP_CP_FRESH fresh prompts) at tp TP_CP[0] x cp
# TP_CP[1] against tp 1 x cp TP_CP[1], prefix cache on in both; then int8
# pages with spec_k TP_CP_SPEC_K; then float32 at TP_F32_LAYERS layers
# against tp 1 x cp 1
TP_CP = (2, 2)
TP_CP_FRESH = CP_FRESH
TP_CP_SPEC_K = 2
# the tp phase's roles part: prompts of TP_ROLE_LENS tokens (64: half a
# page; 200: a page and a partial one) through in-process handoffs between
# tp 1 and tp 2 prefill and decode engines of TP_ROLE_ENGINE's geometry,
# TP_ROLE_NEW tokens each, prefix cache off
TP_ROLE_LENS = (64, 200)
TP_ROLE_NEW = 16
TP_ROLE_ENGINE = dict(slots=2, max_len=512, page_size=128,
                      prefill_buckets=[32, 64, 128, 256])
# the disagg phase: five requests, each through the three hops by hand
# (POST /reserve to the decode server, /prefill to the prefill server,
# /generate with the handoff to the decode server); a DISAGG_SYS_LEN-token
# system prompt under two of them (the second takes a prefix hit on the
# prefill side), prompts of 64-377 tokens (256: two whole pages),
# DISAGG_NEW generated each.  A handoff costs ~15 ms of JSON on the host
# per prompt token (PERF.md), so the prompts stay short.  The int8 pair
# serves those of DISAGG_INT8 (the hit among them).  A
# reservation of DISAGG_TTL_S seconds is left to lapse
DISAGG_SYS_LEN = 300
DISAGG_SPEC = (64, ("sys", 45), ("sys", 77), 256, 96)
DISAGG_NEW = 32
DISAGG_INT8 = (0, 1, 2)
DISAGG_TTL_S = 0.2

# K5's timed case: 8 slots at per-slot positions drawn from 3000-4000 of a
# 4096-token context (numpy.random.default_rng(5).integers(3000, 4001, 8))
K5_DECODE_POS = [3671, 3805, 3022, 3808, 3469, 3515, 3630, 3286]

# the training slice: Llama-2-7B widths at 8 layers (AdamW's float32 state
# for all 32 would not fit one card), batch 4 x 2048 tokens, bf16 O2
TRAIN_LAYERS = 8
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 6

# the bert phase: bench_bert's BERT-base SQuAD fine-tuning (bench.py:2288),
# batch 32 x 384 (lengths 192-384, padded), 6 AdamW steps at lr 3e-5
BERT_BATCH = 32
BERT_SEQ = 384
BERT_VOCAB = 30522
BERT_STEPS = 6
BERT_LR = 3e-5
# AdamW's span of a profiled step when AdamW ran as per-parameter torch
# ops, before adam_fused (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5)
ADAMW_SPAN_WAS = {("train", 8): 115.814, ("bert", 12): 74.241,
                  ("longcontext", 4): 65.668}
# a key whose bias is above this is live in `_bool_mask` (the padding bias
# is -1e30, a live key's finite)
NEG_BIAS_LIVE = -1e29

# K1 and K3 with segment ids and key bias, untimed, on every path
# `flash_path` picks: wgmma (bf16, d 64 or 128, 128+ rows) with BERT's
# padding ids, a padding bias (and a batch row with no live key), both,
# packed sequences (a row's own keys only in the last tiles) with and
# without the causal fence (varlen), GQA on a ragged length; mma.sync at s
# 64 and 127; the FMA kernels in float32 and at d 256
MASKED_CASES = (
    dict(b=4, s=384, h=12, hk=12, kind="pad"),
    dict(b=4, s=384, h=12, hk=12, kind="kbias", dead_row=True),
    dict(b=4, s=384, h=12, hk=12, kind="both"),
    dict(b=2, s=384, h=12, hk=12, kind="packed"),
    dict(b=2, s=384, h=12, hk=12, kind="packed", causal=True),
    dict(b=2, s=300, h=16, hk=4, kind="pad"),
    dict(b=2, s=256, h=16, hk=4, d=128, kind="both", causal=True),
    dict(b=2, s=64, h=8, hk=8, kind="pad"),
    dict(b=2, s=127, h=8, hk=2, kind="kbias", dead_row=True),
    dict(b=2, s=127, h=8, hk=8, kind="packed", causal=True),
    dict(b=2, s=100, h=8, hk=8, d=128, kind="both"),
    dict(b=2, s=200, h=8, hk=2, kind="both", dtype="float32"),
    dict(b=2, s=130, h=8, hk=8, kind="kbias", dead_row=True, dtype="float32"),
    dict(b=2, s=130, h=8, hk=8, kind="packed", causal=True, dtype="float32"),
    dict(b=1, s=100, h=4, hk=2, d=256, kind="pad"),
)


# a prefix of every log line's phase while a phase runs again at another
# dtype (`labelled`)
_LABEL = [""]


def log(phase, msg):
    line = f"[{_LABEL[0]}{phase}] {msg}"
    print(line, flush=True)
    if "FAIL" in msg:  # a failed check: on stderr too, whose tail is kept
        print(f"chip_smoke FAIL {line}", file=sys.stderr, flush=True)


class labelled:
    """Within the block, log lines read "[<prefix><phase>]"."""

    def __init__(self, prefix):
        self.prefix = prefix

    def __enter__(self):
        self.saved, _LABEL[0] = _LABEL[0], self.prefix

    def __exit__(self, *exc):
        _LABEL[0] = self.saved


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


def device_ms(fn, iters=10, warmup=2):
    """The device time of `fn()` per call: the summed durations of the
    kernels it launches, from torch.profiler over `iters` calls after
    `warmup`, without the wrapper's host time.  torch.profiler can lose a
    window's kernel records, so a window with no device time is profiled
    once more.  Returns (ms, {kernel name: ms per call}); (None, {}) when
    neither window saw device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(ev, "is_user_annotation", False)):
                us = getattr(ev, "self_device_time_total", 0.0)
                if us > 0:
                    kernels[ev.key] = kernels.get(ev.key, 0.0) + us / iters / 1e3
        total = sum(kernels.values())
        if total > 0:
            return total, kernels
    return None, kernels


def _dev_txt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _parts_txt(kernels):
    """Each kernel of a call by the short name of its template, with its
    device ms per call."""
    import re

    out = []
    for name, ms in kernels.items():
        short = re.search(r"(\w+_kernel)", name)
        out.append(f"{short.group(1) if short else name[:40]} {ms:.4f}")
    return ", ".join(out)


def rel_norm_err(out, ref):
    """Largest ||out - ref|| / ||ref|| over the (batch, head) slices of two
    [b, s, h, d] tensors."""
    b, h = ref.shape[0], ref.shape[2]
    o = out.float().transpose(1, 2).reshape(b * h, -1)
    r = ref.float().transpose(1, 2).reshape(b * h, -1)
    return ((o - r).norm(dim=1) / r.norm(dim=1)).max().item()


def tolerances(name):
    """(atol, rtol) of kernel vs plain version for inputs of dtype `name`."""
    return {"bfloat16": (KERNEL_ATOL, KERNEL_RTOL),
            "float16": (FP16_ATOL, FP16_RTOL)}.get(name, (F32_ATOL, F32_RTOL))


def parity_matmuls():
    """Full-precision matmuls for the plain versions and parity checks:
    no TF32 (torch.matmul's and cuDNN's), and no float16 GEMM that reduces
    its split-K partials in float16 (cuBLAS's reduced-precision reduction,
    on by default)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def close(out, ref, dtype=None):
    """Finite, elementwise within the dtype's tolerance of the plain
    version, and within REL_NORM_TOL per (batch, head).  `dtype`: the name
    of the inputs' dtype when it is not the output's (a float32 output of
    bf16 inputs rounds p to bf16 as a bf16 output does)."""
    import torch

    name = dtype or str(ref.dtype).removeprefix("torch.")
    atol, rtol = tolerances(name)
    o, r = out.float(), ref.float()
    return (bool(torch.isfinite(o).all())
            and bool(((o - r).abs() <= atol + rtol * r.abs()).all())
            and rel_norm_err(out, ref) <= REL_NORM_TOL[name])


def worst_excess(out, ref):
    """Where `out` is furthest past the elementwise tolerance of `close`:
    (excess over atol + rtol |ref|, out, ref, index), for a failure's log
    line."""
    import torch

    atol, rtol = tolerances(str(ref.dtype).removeprefix("torch."))
    o, r = out.float(), ref.float()
    excess = (o - r).abs() - (atol + rtol * r.abs())
    i = int(excess.argmax())
    idx = tuple(int(x) for x in torch.unravel_index(torch.tensor(i), excess.shape))
    return excess.flatten()[i].item(), o.flatten()[i].item(), r.flatten()[i].item(), idx


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
    dev, _ = device_ms(lambda: fa.flash_forward(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_forward_plain(q, k, v, True, 1.0 / d ** 0.5))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    nbytes = 2 * (q.numel() * 2 + k.numel() * 2) + 4 * lse.numel()
    flops = 4 * d * h * b * s * (s + 1) // 2  # causal (q, k) pairs
    bms, by = bound(nbytes, flops)
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)}, "
                   f"plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f}, bound_ms "
                   f"{bms:.5f} ({by}) -> {'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)


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
    dev, parts = device_ms(lambda: kernel(*args))
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
    # them: the bf16 tensor peak for the chunk window (int8 pages too: it
    # converts them to bf16 exactly) and the decode walk (bf16 q: the
    # tensor peak bounds the same products), the float32 peak for the FMA
    # page walk (float32 products, as the reference's are)
    live = [min(p + sq, max_len) for p in pos]
    row_bytes = d + 4 if quant else d * ak.element_size()
    nbytes = (sum(live) * hk * row_bytes * 2 + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + b * 4)
    visible = sum(min(p + w + 1, max_len) for p in pos for w in range(sq))
    flops = 4 * d * h * visible
    f32_units = path == "fma"
    bms, by = bound(nbytes, flops, PEAK_F32_FLOP_S if f32_units else PEAK_BF16_FLOP_S)
    lib_txt = "null" if lib_ms is None else f"{lib_ms:.4f}"
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)} "
                   f"({_parts_txt(parts)}), plain_ms {plain_ms:.4f}, library_ms "
                   f"{lib_txt}, bound_ms {bms:.5f} ({by}) -> {'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _k2_tp_case(b, sq, h, hk, pos, tp=4, d=128, ps=128, max_len=2048, seed=70,
                dtype="bfloat16", quant=False):
    """K2 per head shard (`paged_decode_tp`; with `quant`, K4's
    `paged_decode_q8_tp` over int8 pages): a decode step's q heads and arena
    split over `tp` ranks on the card, each rank's output against the plain
    version on its shard (`paged_decode_plain`, `paged_decode_q8_plain`).
    Times one shard's launch (kernel, device and plain ms; bound per shard
    in bytes) and the call over every rank; no PyTorch call reads pages."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    q, ak, av, scales, tables, pos_t = _paged_inputs(
        b, sq, h, hk, pos, d, ps, max_len, seed, dtype, quant, False)
    split = lambda t: [c.contiguous() for c in t.chunk(tp, dim=2)]  # noqa: E731
    qs, ks, vs = split(q), split(ak), split(av)
    sc = [split(s) for s in scales]
    name = "paged_decode_tp_q8" if quant else "paged_decode_tp"
    if quant:
        call = lambda: fa.paged_decode_q8_tp(qs, ks, vs, *sc, tables, pos_t, max_len)  # noqa: E731
        one = lambda: fa.paged_decode_fused_q8(qs[0], ks[0], vs[0], sc[0][0], sc[1][0],  # noqa: E731
                                               tables, pos_t, max_len)
        plain = lambda r: fa.paged_decode_q8_plain(  # noqa: E731
            qs[r], ks[r], vs[r], sc[0][r], sc[1][r], tables, pos_t, max_len, d ** -0.5)
    else:
        call = lambda: fa.paged_decode_tp(qs, ks, vs, tables, pos_t, max_len)  # noqa: E731
        one = lambda: fa.paged_decode_fused(qs[0], ks[0], vs[0], tables, pos_t,  # noqa: E731
                                            max_len)
        plain = lambda r: fa.paged_decode_plain(  # noqa: E731
            qs[r], ks[r], vs[r], tables, pos_t, max_len, d ** -0.5)
    before = fa.launch_counts[name]
    outs = call()
    torch.cuda.synchronize()
    launched = fa.launch_counts[name] - before
    ok, err = launched == tp, 0.0
    for r, out in enumerate(outs):
        ref = plain(r)
        err = max(err, (out.float() - ref.float()).abs().max().item())
        ok &= close(out, ref)
    hr, kr = h // tp, hk // tp
    shape = (f"{name} {dtype} b={b} sq={sq} h={h} hk={hk} over tp={tp} ranks "
             f"({hr} q heads, {kr} kv heads each) d={d} ps={ps} pos={pos}: "
             f"{launched} launches, max_abs_err {err:.3e}")
    ms = time_ms(one)
    dev, parts = device_ms(one)
    plain_ms = time_ms(lambda: plain(0))
    all_ms = time_ms(call)
    # one shard's bytes: its live K/V rows of its kv heads (and their
    # float32 scales under int8), its q and out blocks, tables and pos
    live = [min(p + sq, max_len) for p in pos]
    row_bytes = d + 4 if quant else d * ak.element_size()
    nbytes = (sum(live) * kr * row_bytes * 2 + 2 * qs[0].numel() * q.element_size()
              + tables.numel() * 4 + b * 4)
    visible = sum(min(p + w + 1, max_len) for p in pos for w in range(sq))
    bms, by = bound(nbytes, 4 * d * hr * visible)
    log("kernels", f"{shape}; one shard: kernel_ms {ms:.4f}, device_ms "
                   f"{_dev_txt(dev)} ({_parts_txt(parts)}), plain_ms {plain_ms:.4f}, "
                   f"library_ms null (no PyTorch call reads pages), bound_ms "
                   f"{bms:.5f} ({by}); all {tp} shards {all_ms:.4f} ms -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None, all_shards_ms=all_ms)


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
    shape = (f"flash_bwd {dtype} b={b} s={s} h={h} hk={hk} d={d} causal={causal} "
             f"path {fa.flash_path(s, d, q.dtype)}: "
             f"max_abs_err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, "
             f"rel_norm_err {rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e}")
    del ref
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=max(errs))
    ms = time_ms(lambda: fa.flash_backward(*args))
    dev, parts = device_ms(lambda: fa.flash_backward(*args))
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
    lib_dev, _ = device_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt,
                                                       retain_graph=True))
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)} "
                   f"({_parts_txt(parts)}), plain_ms {plain_ms:.4f}, library_ms "
                   f"{lib_ms:.4f} "
                   f"(device {_dev_txt(lib_dev)}), bound_ms {bms:.5f} ({by}) -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=max(errs), ms=ms, device_ms=dev,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)


def bert_batch(batch=None, seq=None, vocab=None, seed=0):
    """bench_bert's batch (bench.py:2316-2324): numpy's RandomState(seed)
    draws the token ids, lengths uniform in [seq // 2, seq], then the start
    and the end positions, each uniform in [0, seq // 2).  Returns (ids
    [batch, seq] int32, lengths [batch], starts [batch], ends [batch])."""
    import numpy as np

    batch, seq = batch or BERT_BATCH, seq or BERT_SEQ
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab or BERT_VOCAB, (batch, seq)).astype(np.int32)
    lens = rng.randint(seq // 2, seq + 1, (batch,))
    starts = rng.randint(0, seq // 2, (batch,))
    return ids, lens, starts, rng.randint(0, seq // 2, (batch,))


def _masking(kind, b, s, seed, dead_row=False, device="cuda"):
    """(segments [b, s] int32 or None, kbias [b, s] float32 or None) of a
    masked K1/K3 case, from numpy's generator `seed`:
    - "pad": BERT's ids (`BertModel.to_segs`): valid tokens 0, pad position
      j gets j + 1; lengths bench_bert's at its shape, else uniform in
      [s // 2, s];
    - "kbias": the same padding as a key bias: -1e30 on pad keys, N(0, 1)
      on valid ones; with `dead_row`, batch row 0 has -1e30 on every key (a
      row with no live key: the output is the mean of V);
    - "both": the padding ids and a finite N(0, 1) bias on every key (with
      the padding bias a pad row, whose only key of its id is itself, would
      have no live key);
    - "packed": packed sequences (varlen): row r's boundaries at s // 3 + r
      and s - s // 5 - r, so the last sequence's rows find their own keys
      only in the last key tiles (every earlier tile fully masked)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    j = np.arange(s)[None, :]
    if b == BERT_BATCH and s == BERT_SEQ:
        lens = bert_batch()[1]
    else:
        lens = rng.integers(s // 2, s + 1, b)
    valid = j < lens[:, None]
    segs = bias = None
    if kind in ("pad", "both"):
        segs = np.where(valid, 0, j + 1)
    if kind in ("kbias", "both"):
        bias = rng.standard_normal((b, s))
        if kind == "kbias":
            bias = np.where(valid, bias, -1e30)
        if dead_row:
            bias[0] = -1e30
    if kind == "packed":
        r = np.arange(b)[:, None]
        segs = (j >= s // 3 + r).astype(np.int64) + (j >= s - s // 5 - r)
    to = lambda x, dt: None if x is None else torch.tensor(x, dtype=dt, device=device)
    return to(segs, torch.int32), to(bias, torch.float32)


def _bool_mask(segments, kbias, causal):
    """The [b, 1, s, s] boolean mask (True: attend) equivalent to segments,
    a padding bias and the causal fence, for PyTorch's SDPA."""
    import torch

    ref = segments if segments is not None else kbias
    b, s = ref.shape
    mask = torch.ones(b, 1, s, s, dtype=torch.bool, device=ref.device)
    if segments is not None:
        mask &= (segments[:, None, :, None] == segments[:, None, None, :])
    if kbias is not None:
        mask &= (kbias > NEG_BIAS_LIVE)[:, None, None, :]
    if causal:
        mask &= torch.ones(s, s, dtype=torch.bool, device=ref.device).tril()
    return mask


def _masked_case(b, s, h, hk, kind, d=64, causal=False, dtype="bfloat16",
                 seed=30, dead_row=False, timed=False):
    """K1 and K3 with segment ids and/or a key bias against their plain
    versions on the same inputs (out and lse; dq, dk, dv), K3 twice bit for
    bit; with `timed` (BERT's shape), kernel, device, plain and library
    times of both -- the library call is PyTorch's SDPA with the equivalent
    boolean [b, 1, s, s] mask, and its backward -- and their bounds.
    With `dead_row` (batch row 0 has no live key) that row's dq, dk and dv
    are held by the per-(batch, head) norm alone: p is 1 on all its keys,
    so its ds are O(1) on every key where a live row's are O(1 / s), and
    its dq and dk are sums of s such terms that cancel, in which one bf16
    rounding of ds that falls the other way moves an entry near 0 past the
    elementwise bound (float32 holds it elementwise).
    Returns (ok, forward record, backward record)."""
    import torch
    from torch.nn import functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(b, s, heads, d, generator=gen, device="cuda",
                                   dtype=getattr(torch, dtype))
    q, k, v, g = mk(h), mk(hk), mk(hk), mk(h)
    segs, kbias = _masking(kind, b, s, seed, dead_row)
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_forward(q, k, v, causal, scale, segs, kbias)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal, scale, segs, kbias)
    f_err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    f_ok = close(out, ref_out) and lse_err <= LSE_ATOL
    args = (q, k, v, out, lse, g, causal, scale, segs, kbias)
    got = fa.flash_backward(*args)
    again = fa.flash_backward(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ref = fa.flash_backward_plain(*args)
    errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
    rels = [rel_norm_err(x, r) for x, r in zip(got, ref)]
    lo = 1 if dead_row and dtype in ("bfloat16", "float16") else 0

    def held(x, r):
        if not lo:
            return close(x, r)
        return (close(x[lo:], r[lo:])
                and rel_norm_err(x[:lo], r[:lo]) <= REL_NORM_TOL[dtype])

    b_ok = same and all(held(x, r) for x, r in zip(got, ref))
    del ref, again
    path = fa.flash_path(s, d, q.dtype)
    shape = (f"{dtype} b={b} s={s} h={h} hk={hk} d={d} causal={causal} "
             f"{kind}{' dead row' if dead_row else ''} path {path}")
    fwd = (f"flash_fwd masked {shape}: max_abs_err {f_err:.3e}, rel_norm_err "
           f"{rel_norm_err(out, ref_out):.3e}, lse_err {lse_err:.3e}")
    bwd = (f"flash_bwd masked {shape}: max_abs_err dq/dk/dv "
           f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, rel_norm_err "
           f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e}, two calls equal bit for "
           f"bit {same}")
    frec, brec = dict(max_abs_err=f_err), dict(max_abs_err=max(errs))
    if timed:
        bool_mask = _bool_mask(segs, kbias, causal)
        rep = h // hk
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt = k.transpose(1, 2).repeat_interleave(rep, 1).detach().requires_grad_()
        vt = v.transpose(1, 2).repeat_interleave(rep, 1).detach().requires_grad_()
        fwd_call = lambda: fa.flash_forward(q, k, v, causal, scale, segs, kbias)
        lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bool_mask)
        lib_out = lib_fwd()
        gt = g.transpose(1, 2)
        lib_bwd = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt,
                                              retain_graph=True)
        # the pairs this data lets through (every pair is still computed:
        # no key tile is skipped); bytes: q, k, v, out (K1) and also g, dq,
        # dk, dv (K3) once, lse, the ids and the bias
        live = int(bool_mask.sum().item()) * h
        mask_bytes = sum(4 * t.numel() for t in (segs, kbias) if t is not None)
        t_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
        f_bound = bound(t_bytes + 4 * lse.numel() + mask_bytes, 4 * d * live)
        b_bound = bound(2 * t_bytes + 4 * lse.numel() + mask_bytes, 10 * d * live)
        # the same calls without segment ids or bias: what the mask costs
        plain_out, plain_lse = fa.flash_forward(q, k, v, causal, scale)
        unmasked = {
            "flash_fwd": device_ms(lambda: fa.flash_forward(q, k, v, causal, scale))[0],
            "flash_bwd": device_ms(lambda: fa.flash_backward(
                q, k, v, plain_out, plain_lse, g, causal, scale))[0]}
        for what, rec, call, plain, lib, (bms, by) in (
                ("flash_fwd", frec, fwd_call,
                 lambda: fa.flash_forward_plain(q, k, v, causal, scale, segs, kbias),
                 lib_fwd, f_bound),
                ("flash_bwd", brec, lambda: fa.flash_backward(*args),
                 lambda: fa.flash_backward_plain(*args), lib_bwd, b_bound)):
            ms = time_ms(call)
            dev, parts = device_ms(call)
            plain_ms = time_ms(plain, iters=5, warmup=1)
            lib_ms = time_ms(lib)
            lib_dev, _ = device_ms(lib)
            rec.update(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms)
            text = (f", kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)} "
                    f"({_parts_txt(parts)}, unmasked on the same inputs "
                    f"{_dev_txt(unmasked[what])}), plain_ms {plain_ms:.4f}, "
                    f"library_ms {lib_ms:.4f} (device {_dev_txt(lib_dev)}; SDPA "
                    f"with the boolean mask), bound_ms {bms:.5f} ({by}, {live} "
                    f"live pairs)")
            if what == "flash_fwd":
                fwd += text
            else:
                bwd += text
    if not f_ok:
        fwd += f"; worst past tolerance {worst_excess(out, ref_out)}"
    if not b_ok:
        ref = fa.flash_backward_plain(*args)
        bwd += "; worst past tolerance dq/dk/dv " + " / ".join(
            str(worst_excess(x[lo:], r[lo:])) for x, r in zip(got, ref))
    log("kernels", f"{fwd} -> {'ok' if f_ok else 'FAIL'}")
    log("kernels", f"{bwd} -> {'ok' if b_ok else 'FAIL'}")
    return f_ok and b_ok, frec, brec


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
    dev, _ = device_ms(lambda: fa.dense_decode(q, k, v, pos_t))
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
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)}, "
                   f"plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f}, bound_ms "
                   f"{bms:.5f} ({by}) -> {'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _k2_dense_case(b, sq, h, hk, pos, L, d=128, seed=18, dtype="bfloat16",
                   timed=True):
    """K2 over the page view of a dense static cache, as `decode_attention`
    runs it for every shape K6 does not take (the generate phase's decode
    steps and short prefills, the dense pool's decode), against its plain
    version `decode_attention_plain` (the whole cache upcast to float32, the
    route it replaces).  `pos`: one position (lock-step) or one per slot
    (the dense pool); the cache is written up to pos + sq, later rows zero.
    With `timed`, also kernel, device, plain and library times (PyTorch's
    SDPA over the dense cache with the boolean mask j <= pos + i) and the
    byte bound (the K/V rows up to each slot's position)."""
    import torch
    from torch.nn import functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    per_row = isinstance(pos, (list, tuple))
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda", dtype=dt)
    k = torch.zeros(b, L, hk, d, device="cuda", dtype=dt)
    v = torch.zeros(b, L, hk, d, device="cuda", dtype=dt)
    live = [min(p + sq, L) for p in (pos if per_row else [pos] * b)]
    for s_, n in enumerate(live):
        k[s_, :n] = torch.randn(n, hk, d, generator=g, device="cuda", dtype=dt)
        v[s_, :n] = torch.randn(n, hk, d, generator=g, device="cuda", dtype=dt)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    table = fa.dense_page_table(b, L, "cuda")

    def kernel():
        return fa.decode_attention(q, k, v, pos_t, table=table)

    before = fa.launch_counts["paged_decode_fused"]
    out = kernel()
    torch.cuda.synchronize()
    launched = fa.launch_counts["paged_decode_fused"] - before
    ref = fa.decode_attention_plain(q, k, v, pos_t)
    err = (out.float() - ref.float()).abs().max().item()
    rel = rel_norm_err(out, ref)
    ok = close(out, ref) and launched == 1
    path = fa.paged_path((h // hk) * sq, d, q.dtype)
    shape = (f"paged_decode_fused over a dense view {dtype} b={b} sq={sq} h={h} "
             f"hk={hk} d={d} L={L} ps={fa.dense_page_size(L)} pos="
             f"{pos} path {path}: K2 launches {launched}, max_abs_err {err:.3e}, "
             f"rel_norm_err {rel:.3e}")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    ms = time_ms(kernel)
    dev, parts = device_ms(kernel)
    plain_ms = time_ms(lambda: fa.decode_attention_plain(q, k, v, pos_t))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    i = torch.arange(sq, device="cuda")[:, None]
    j = torch.arange(L, device="cuda")[None, :]
    mask = j[None, None] <= pos_t.view(-1, 1, 1, 1) + i  # [b or 1, 1, sq, L]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=h != hk))
    # bytes this data needs: each slot's K/V rows up to its position, q,
    # out, the table and pos; operations over the visible pairs at the
    # bf16 tensor peak (as for K2's decode walk)
    nbytes = (sum(live) * hk * d * k.element_size() * 2
              + 2 * q.numel() * q.element_size() + table.numel() * 4 + pos_t.numel() * 4)
    visible = sum(min(p + w + 1, L) for p in (pos if per_row else [pos] * b)
                  for w in range(sq))
    bms, by = bound(nbytes, 4 * d * h * visible,
                    PEAK_F32_FLOP_S if path == "fma" else PEAK_BF16_FLOP_S)
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)} "
                   f"({_parts_txt(parts)}), plain_ms {plain_ms:.4f} (the float32 "
                   f"dense math it replaces), library_ms {lib_ms:.4f}, bound_ms "
                   f"{bms:.5f} ({by}) -> {'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)


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

    atol, rtol = tolerances(str(dtype).removeprefix("torch."))
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
    """K5 on one card (`paged_decode_cp`: one launch over every shard, then
    the split combine) against its plain version over a global arena in
    the cp layout: the output against `paged_decode_plain` (or its int8
    version) over the global arena and tables, and each shard's partials
    (`paged_decode_partials`, the across-card form) against
    `paged_decode_partials_plain`.  With `timed`, also K5's time (the cp
    tables stacked beforehand, as the engine stacks them once per table
    upload) and device time, K2's over the same global arena and tables (no
    PyTorch call reads pages: this is what cp costs on one card), the plain
    version's and the bound."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    q, ak, av, scales, tables, pos_t = _cp_inputs(
        b, sq, h, hk, pos, d, ps, max_len, cp, seed, dtype, quant, device)
    local = fa.cp_local_tables(tables, cp, ak.shape[0] // cp, ps)
    stacked = fa.cp_stacked_tables(tables, cp, ak.shape[0] // cp, ps)
    scale = 1.0 / d ** 0.5
    kw = dict(k_scale=scales[0], v_scale=scales[1]) if quant else {}
    out = fa.paged_decode_cp(q, ak, av, tables, pos_t, max_len, cp, local=stacked,
                             **kw)
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
             f"{fa.paged_splits(path, b, hk, rows, tables.shape[1] // cp, ps, cp)}: "
             f"max_abs_err {err:.3e}, rel_norm_err {rel:.3e} vs the global "
             f"plain version, partials {'ok' if parts_ok else 'WRONG'}")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    run = lambda: fa.paged_decode_cp(q, ak, av, tables, pos_t, max_len, cp,
                                     local=stacked, **kw)
    ms = time_ms(run)
    dev, parts = device_ms(run)
    plain_ms = time_ms(lambda: _cp_run(q, ak, av, scales, local, pos_t, max_len,
                                       cp, scale, fa.paged_decode_partials_plain))
    k2 = lambda: fa.paged_decode_fused(q, ak, av, tables, pos_t, max_len)
    k2_ms, k2_dev = (None, None) if quant else (time_ms(k2), device_ms(k2)[0])
    # bytes: q, each slot's live K/V rows of every kv head (scales under
    # int8), the local tables, page_base and pos read once, the output
    # written once (the splits' and shards' partials are the kernel's
    # choice, not the function's); operations over the visible (row, key)
    # pairs at the bf16 tensor peak (the float32 peak for the FMA page walk)
    live = [min(p + sq, max_len) for p in pos]
    row_bytes = d + 4 if quant else d * ak.element_size()
    R = (h // hk) * sq
    nbytes = (sum(live) * hk * row_bytes * 2 + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + tables.shape[1] * 4 + b * 4)
    visible = sum(min(p + w + 1, max_len) for p in pos for w in range(sq))
    bms, by = bound(nbytes, 4 * d * h * visible,
                    PEAK_F32_FLOP_S if path == "fma" else PEAK_BF16_FLOP_S)
    k2_txt = "n/a" if k2_ms is None else f"{k2_ms:.4f} (device {_dev_txt(k2_dev)})"
    log("kernels", f"{shape}, kernel_ms {ms:.4f} (one launch + combine), "
                   f"device_ms {_dev_txt(dev)} ({_parts_txt(parts)}), "
                   f"k2_same_arena_ms {k2_txt}, "
                   f"plain_ms {plain_ms:.4f}, library_ms null, bound_ms "
                   f"{bms:.5f} ({by}) -> {'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    k2_same_arena_ms=k2_ms, k2_same_arena_device_ms=k2_dev)


def _k5_tp_case(b, sq, h, hk, pos, tp=2, d=128, ps=128, max_len=4096, cp=2,
                seed=72, dtype="bfloat16", quant=False):
    """K5 per head shard (`paged_decode_cp_tp`, over int8 pages with
    `quant`): a tp x cp decode step's q heads and cp arena split over `tp`
    ranks on the card, every rank's arena in the cp page layout, the ranks
    sharing one set of stacked local tables; each rank's output against
    the plain version over its shard (`paged_decode_plain` or its int8
    version over the rank's global arena).  Times one shard's launch
    (kernel, device and plain ms, the plain being the per-shard
    partials and combine the wrapper runs on the CPU; bound per shard)
    and the call over every rank; no PyTorch call reads pages."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    q, ak, av, scales, tables, pos_t = _cp_inputs(
        b, sq, h, hk, pos, d, ps, max_len, cp, seed, dtype, quant)
    split = lambda t: [c.contiguous() for c in t.chunk(tp, dim=2)]  # noqa: E731
    qs, ks, vs = split(q), split(ak), split(av)
    sc = [split(x) for x in scales] if quant else [[None] * tp, [None] * tp]
    per = ak.shape[0] // cp
    stacked = fa.cp_stacked_tables(tables, cp, per, ps)
    local = fa.cp_local_tables(tables, cp, per, ps)
    scale = d ** -0.5
    name = "paged_decode_cp_tp_q8" if quant else "paged_decode_cp_tp"
    call = lambda: fa.paged_decode_cp_tp(  # noqa: E731
        qs, ks, vs, tables, pos_t, max_len, cp, None,
        *(sc if quant else (None, None)), local=stacked)
    one = lambda: fa.paged_decode_cp(qs[0], ks[0], vs[0], tables, pos_t, max_len,  # noqa: E731
                                     cp, None, sc[0][0], sc[1][0], stacked)

    def plain(r):
        if quant:
            return fa.paged_decode_q8_plain(qs[r], ks[r], vs[r], sc[0][r], sc[1][r],
                                            tables, pos_t, max_len, scale)
        return fa.paged_decode_plain(qs[r], ks[r], vs[r], tables, pos_t, max_len, scale)

    before = fa.launch_counts[name]
    outs = call()
    torch.cuda.synchronize()
    launched = fa.launch_counts[name] - before
    ok, err = launched == tp, 0.0
    for r, out in enumerate(outs):
        ref = plain(r)
        err = max(err, (out.float() - ref.float()).abs().max().item())
        ok &= close(out, ref)
    hr, kr = h // tp, hk // tp
    shape = (f"{name} {dtype} b={b} sq={sq} h={h} hk={hk} cp={cp} over tp={tp} "
             f"ranks ({hr} q heads, {kr} kv heads each, its arena in {cp} page "
             f"shards) d={d} ps={ps} max_len={max_len} pos={pos}: {launched} "
             f"launches, max_abs_err {err:.3e}")
    ms = time_ms(one)
    dev, parts = device_ms(one)
    sc0 = (sc[0][0], sc[1][0]) if quant else ()
    plain_ms = time_ms(lambda: _cp_run(qs[0], ks[0], vs[0], sc0, local, pos_t,
                                       max_len, cp, scale,
                                       fa.paged_decode_partials_plain))
    all_ms = time_ms(call)
    # one shard's bytes: its live K/V rows of its kv heads (float32 scales
    # under int8), its q and out blocks, the local tables, page_base, pos
    live = [min(p + sq, max_len) for p in pos]
    row_bytes = d + 4 if quant else d * ak.element_size()
    nbytes = (sum(live) * kr * row_bytes * 2 + 2 * qs[0].numel() * q.element_size()
              + tables.numel() * 4 + tables.shape[1] * 4 + b * 4)
    visible = sum(min(p + w + 1, max_len) for p in pos for w in range(sq))
    path = fa.paged_path((hr // kr) * sq, d, q.dtype)
    bms, by = bound(nbytes, 4 * d * hr * visible,
                    PEAK_F32_FLOP_S if path == "fma" else PEAK_BF16_FLOP_S)
    log("kernels", f"{shape}; one shard: kernel_ms {ms:.4f}, device_ms "
                   f"{_dev_txt(dev)} ({_parts_txt(parts)}), plain_ms {plain_ms:.4f}, "
                   f"library_ms null (no PyTorch call reads pages), bound_ms "
                   f"{bms:.5f} ({by}); all {tp} shards {all_ms:.4f} ms -> "
                   f"{'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None, all_shards_ms=all_ms)


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


# The decode walk (rows = rep * sq < 16, bf16 q, d 64 or 128), each case
# over bf16 and over int8 pages: a verify window (3 rows), GQA rep 4 (4
# rows), rep 4 x sq 3 (12 rows: two 8-row tiles), d 64 with 16-row pages (a
# 64-key stage spans four pages), a window running into scratch page 0, 15
# rows, 8 rows, and a slot at pos 0 (one key)
WALK_CASES = (
    dict(b=4, sq=3, h=32, hk=32, pos=[1000, 513, 64, 0]),
    dict(b=4, sq=1, h=32, hk=8, pos=[1500, 700, 129, 3]),
    dict(b=4, sq=3, h=32, hk=8, pos=[1000, 513, 64, 0]),
    dict(b=2, sq=1, h=8, hk=2, pos=[900, 40], d=64, ps=16, max_len=1024),
    dict(b=3, sq=3, h=8, hk=2, pos=[14, 30, 7], d=64, ps=16, max_len=256,
         overrun=True),
    dict(b=2, sq=15, h=8, hk=8, pos=[400, 9], d=64, ps=64, max_len=1024),
    dict(b=2, sq=2, h=8, hk=2, pos=[900, 40], d=64, ps=64, max_len=1024),
    dict(b=2, sq=1, h=32, hk=32, pos=[0, 700]),
)

# The FMA page walk (float32 q, or d not 64/128), each case over bf16 or
# float32 pages and over int8 pages: GQA, the largest shared memory (a
# 64-row tile at d 256, then a partial second tile whose first row sits
# mid-window: rep 32 x sq 3 = 96), scalar tile loads (d bytes not a
# multiple of 16, 2 splits), a float32 chunk of 64 rows, and a window
# running into scratch page 0
FMA_CASES = (
    dict(b=4, sq=1, h=32, hk=8, pos=[1500, 700, 129, 3], dtype="float32"),
    dict(b=2, sq=3, h=32, hk=1, pos=[900, 40], d=256, ps=64, max_len=1024),
    dict(b=2, sq=1, h=4, hk=2, pos=[700, 10], d=36, ps=16, max_len=1024),
    dict(b=1, sq=64, h=8, hk=8, pos=[300], d=64, ps=64, max_len=1024,
         dtype="float32"),
    dict(b=3, sq=3, h=8, hk=2, pos=[14, 30, 7], d=64, ps=16, max_len=256,
         overrun=True, dtype="float32"),
)

# K3's variants beside the timed shapes: on the wgmma kernels GQA (hk 8),
# ragged s (300, 1000), d 64, non-causal and one 128-row tile; on
# mma.sync s 16 and 127 (below the wgmma tile) and d 36; the FMA kernels
# (float32, d 256)
K3_CASES = (
    dict(b=2, s=256, h=32, hk=8),
    dict(b=1, s=300, h=16, hk=4),
    dict(b=2, s=1000, h=32, hk=8, d=64),
    dict(b=1, s=1000, h=32, hk=8),
    dict(b=2, s=200, h=8, hk=8, causal=False),
    dict(b=2, s=300, h=16, hk=16, d=64, causal=False),
    dict(b=2, s=128, h=32, hk=8),
    dict(b=2, s=130, h=8, hk=2, d=64),
    dict(b=2, s=16, h=8, hk=2),
    dict(b=1, s=127, h=8, hk=8, d=64),
    dict(b=1, s=70, h=4, hk=2, d=36),
    dict(b=1, s=100, h=8, hk=2, d=256),
    dict(b=1, s=128, h=32, hk=32, dtype="float32"),
    dict(b=1, s=100, h=8, hk=2, d=256, dtype="float32"),
    dict(b=1, s=150, h=8, hk=8, d=64, causal=False, dtype="float32"),
)


# K1's variants beside the timed shapes: ragged GQA, non-causal, d 64 on
# both tensor-core paths (seed 3); then one line per kernel instantiation
# or mode (seed 4): the FMA kernels (float32 at d 128 and 256, bf16 at d
# 256), wgmma<64>, non-causal mma<128>, mma<64> with scalar loads, mma<128>
# at d not 64 or 128
K1_CASES = (
    dict(b=1, s=300, h=32, hk=8, seed=3),
    dict(b=1, s=128, h=32, hk=32, causal=False, seed=3),
    dict(b=2, s=300, h=16, hk=4, d=64, causal=False, seed=3),
    dict(b=1, s=512, h=16, hk=16, d=64, seed=3),
    dict(b=2, s=16, h=8, hk=2, d=64, seed=3),
    dict(b=1, s=2048, h=8, hk=8, causal=False, seed=3),
    dict(b=1, s=128, h=32, hk=32, dtype="float32", seed=4),
    dict(b=1, s=100, h=8, hk=2, d=256, dtype="float32", seed=4),
    dict(b=1, s=200, h=16, hk=4, d=256, seed=4),
    dict(b=2, s=130, h=32, hk=8, d=64, seed=4),
    dict(b=2, s=100, h=32, hk=8, causal=False, seed=4),
    dict(b=1, s=150, h=8, hk=8, d=64, causal=False, dtype="float32", seed=4),
    dict(b=1, s=70, h=4, hk=2, d=36, seed=4),
    dict(b=1, s=200, h=8, hk=2, d=100, seed=4),
)

# K3 twice on the same inputs, bit for bit: the training shape, ragged GQA
# at d 64, non-causal, and mma.sync at s 16
K3_REPEATS = (
    dict(b=TRAIN_BATCH, s=TRAIN_SEQ, h=32, hk=32),
    dict(b=2, s=1000, h=32, hk=8, d=64),
    dict(b=2, s=300, h=16, hk=4, causal=False),
    dict(b=2, s=16, h=8, hk=2),
)

# K6's variants: GQA on mma<64>, ragged sq at pos > 0, a ragged tile,
# wgmma<64> with GQA, float32, the FMA path at d 256 (bf16 and float32)
K6_CASES = (
    dict(b=1, sq=64, h=8, hk=2, d=64, L=128, pos=30),
    dict(b=1, sq=130, h=32, hk=32, L=384, pos=200),
    dict(b=2, sq=77, h=16, hk=4, L=256, pos=10),
    dict(b=2, sq=200, h=16, hk=4, d=64, L=512, pos=250),
    dict(b=1, sq=100, h=8, hk=2, L=256, pos=50, dtype="float32"),
    dict(b=1, sq=96, h=8, hk=2, d=256, L=256, pos=40),
    dict(b=1, sq=70, h=4, hk=2, d=256, L=128, pos=5, dtype="float32"),
)

# K2 over a dense cache's page view beside the timed decode steps: a short
# lock-step prefill (the chunk window), a one-page cache (L not a multiple
# of 128) and float32 (the FMA walk)
K2_DENSE_CASES = (
    dict(b=1, sq=SHORT_LEN, h=32, hk=32, pos=0, L=128),
    dict(b=2, sq=7, h=32, hk=8, pos=[190, 3], L=200),
    dict(b=3, sq=1, h=32, hk=32, pos=[600, 5, 0], L=640, dtype="float32"),
)

# K5's variants the cp engine launches, untimed, at cp 2 and 4: on the
# decode walk (int8, a verify window, GQA, cp 4, a slot whose pos is under
# one page so shard 1 sees no key); the FMA page walk in float32; the
# chunk windows (the slot at pos 0 sees no key of shard 1, nor at cp 4 of
# shards 1-3; pos 100 only some rows do)
K5_WALK_CASES = (
    dict(b=8, sq=1, h=32, hk=32, pos=K5_DECODE_POS, quant=True),
    dict(b=8, sq=3, h=32, hk=32, pos=K5_DECODE_POS),
    dict(b=4, sq=3, h=32, hk=32, pos=[3100, 2000, 900, 1], quant=True),
    dict(b=4, sq=3, h=32, hk=8, d=64, pos=[3999, 2100, 700, 64]),
    dict(b=4, sq=1, h=32, hk=32, pos=[3900, 3000, 1000, 5], cp=4),
    dict(b=4, sq=3, h=32, hk=8, pos=[3900, 2000, 1000, 5], cp=4, quant=True),
    dict(b=4, sq=1, h=32, hk=32, pos=[1000, 300, 100, 0], max_len=1024),
)
K5_FMA_CASES = (
    dict(b=4, sq=1, h=32, hk=8, pos=[3500, 1700, 129, 3], dtype="float32"),
    dict(b=4, sq=3, h=32, hk=8, pos=[3500, 1700, 129, 3], dtype="float32",
         cp=4),
    dict(b=4, sq=1, h=32, hk=8, pos=[3500, 1700, 129, 3], dtype="float32",
         quant=True),
)
K5_CHUNK_CASES = (
    dict(b=4, sq=64, h=32, hk=32, pos=[3000, 1000, 100, 0]),
    dict(b=4, sq=64, h=32, hk=32, pos=[3000, 1000, 100, 0], quant=True),
    dict(b=2, sq=64, h=32, hk=32, pos=[1000, 0], cp=4),
    dict(b=2, sq=64, h=32, hk=32, pos=[1000, 40], cp=4, quant=True),
    dict(b=2, sq=16, h=32, hk=8, d=64, pos=[2000, 10]),
)


# ring attention at bench_longcontext_32k's shape (bench.py:2347): one
# sequence of 32768 tokens, 8 heads of 128, R = 8 ranks of the sep axis
RING_SEQ = 32768
RING_HEADS = 8
RING_R = 8

# the ring operands of K1 and K3 on every path they launch, untimed, at
# S = 2048 over R = 4 (c = 256): wgmma (bf16, d 128 and 64, GQA), mma.sync
# (bf16, d 96), FMA (float32; bf16 at d 256)
RING_CASES = (
    dict(h=8, hk=8),
    dict(h=8, hk=2),
    dict(h=4, hk=4, d=64),
    dict(h=4, hk=4, d=96),
    dict(h=4, hk=4, dtype="float32"),
    dict(h=4, hk=2, d=256),
)


def _ring_inputs(S, R, h, hk, d, dtype, seed):
    """Rank R-1's q shard in the zig-zag layout ([1, 2c, h, d]: chunks R-1
    and R of c = S / 2R) with its q block starts, all S keys, and a g."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda rows, heads: torch.randn(1, rows, heads, d, generator=gen,
                                         device="cuda", dtype=getattr(torch, dtype))
    c = S // (2 * R)
    starts = ra._zigzag_starts(S, R, R - 1, "cuda")
    return mk(2 * c, h), mk(S, hk), mk(S, hk), mk(2 * c, h), starts


def _ring_pairs(starts, s, lk, h):
    """(q, k) pairs a causal call with these q block starts computes."""
    from paddle_tpu_torch.ops import flash_attention as fa

    pos = fa.q_positions(s, starts, starts.device)
    return int((pos.clamp(max=lk - 1) + 1).sum().item()) * h


def _ring_bool_mask(starts, s, lk):
    """The [1, 1, s, lk] boolean mask (True: attend) of a causal call with
    these q block starts, for PyTorch's SDPA."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    pos = fa.q_positions(s, starts, starts.device)
    return (pos[:, None] >= torch.arange(lk, device=pos.device)[None, :])[None, None]


def _ring_offset_case(S, R, h, hk, d=128, dtype="bfloat16", seed=40, timed=False):
    """K1 and K3 with `q_offset` over rectangular keys (the gathered form's
    launch: rank R-1's 2c zig-zag rows against all S keys, causal) against
    their plain versions; with `timed`, kernel, device, plain and library
    times -- the library call is SDPA with the equivalent boolean mask --
    and the bounds.  Returns (ok, K1 record, K3 record)."""
    import torch
    from torch.nn import functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, g, starts = _ring_inputs(S, R, h, hk, d, dtype, seed)
    scale = 1.0 / d ** 0.5
    s = q.shape[1]
    out, lse = fa.flash_forward(q, k, v, True, scale, q_offset=starts)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, True, scale, q_offset=starts)
    f_err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    f_ok = close(out, ref_out, dtype) and lse_err <= LSE_ATOL
    del ref_out, ref_lse
    args = (q, k, v, out, lse, g, True, scale)
    got = fa.flash_backward(*args, q_offset=starts)
    again = fa.flash_backward(*args, q_offset=starts)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    ref = fa.flash_backward_plain(*args, q_offset=starts)
    errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
    rels = [rel_norm_err(x, r) for x, r in zip(got, ref)]
    b_ok = same and all(close(x, r, dtype) for x, r in zip(got, ref))
    del ref
    path = fa.flash_path(s, d, q.dtype)
    shape = (f"{dtype} s={s} lk={S} h={h} hk={hk} d={d} causal, q_offset "
             f"(rank {R - 1} of {R}) path {path}")
    fwd = (f"flash_fwd offset {shape}: max_abs_err {f_err:.3e}, lse_err "
           f"{lse_err:.3e}")
    bwd = (f"flash_bwd offset {shape}: max_abs_err dq/dk/dv "
           f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, rel_norm_err "
           f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e}, two calls equal bit for "
           f"bit {same}")
    frec, brec = dict(max_abs_err=f_err), dict(max_abs_err=max(errs))
    if timed:
        mask = _ring_bool_mask(starts, s, S)
        rep = h // hk
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt = k.transpose(1, 2).repeat_interleave(rep, 1).detach().requires_grad_()
        vt = v.transpose(1, 2).repeat_interleave(rep, 1).detach().requires_grad_()
        lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_out = lib_fwd()
        gt = g.transpose(1, 2)
        lib_bwd = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt,
                                              retain_graph=True)
        pairs = _ring_pairs(starts, s, S, h)
        qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
        # K1: q, k, v read, out written, lse; K3: q, out, g, dq and k, v,
        # dk, dv, lse; the starts
        f_bound = bound(2 * qb + 2 * kb + 4 * lse.numel() + 4 * starts.numel(),
                        4 * d * pairs)
        b_bound = bound(4 * qb + 4 * kb + 4 * lse.numel() + 4 * starts.numel(),
                        10 * d * pairs)
        for what, rec, call, plain, lib, (bms, by) in (
                ("flash_fwd", frec,
                 lambda: fa.flash_forward(q, k, v, True, scale, q_offset=starts),
                 lambda: fa.flash_forward_plain(q, k, v, True, scale,
                                                q_offset=starts),
                 lib_fwd, f_bound),
                ("flash_bwd", brec,
                 lambda: fa.flash_backward(*args, q_offset=starts),
                 lambda: fa.flash_backward_plain(*args, q_offset=starts),
                 lib_bwd, b_bound)):
            ms = time_ms(call)
            dev, parts = device_ms(call)
            plain_ms = time_ms(plain, iters=3, warmup=1)
            lib_ms = time_ms(lib)
            lib_dev, _ = device_ms(lib)
            rec.update(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms)
            text = (f", kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)} "
                    f"({_parts_txt(parts)}), plain_ms {plain_ms:.4f}, library_ms "
                    f"{lib_ms:.4f} (device {_dev_txt(lib_dev)}; SDPA with the "
                    f"boolean mask), bound_ms {bms:.5f} ({by}, {pairs} pairs)")
            if what == "flash_fwd":
                fwd += text
            else:
                bwd += text
        del lib_out, mask
    log("kernels", f"{fwd} -> {'ok' if f_ok else 'FAIL'}")
    log("kernels", f"{bwd} -> {'ok' if b_ok else 'FAIL'}")
    return f_ok and b_ok, frec, brec


def _ring_hop_case(c, h, hk, d=128, dtype="bfloat16", seed=41, timed=False):
    """A rotating-ring hop: q of c rows after a causal diagonal hop (K1 with
    float32 out, no carry), then K1 over the next c keys with the carry
    (float32 out), then K3 of that hop with the delta of the merged result;
    each against its plain version.  With `timed`, the carry K1 and the
    delta K3 are timed (no one PyTorch call computes either: library
    none).  Returns (ok, K1 carry record, K3 delta record)."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(1, c, heads, d, generator=gen, device="cuda",
                                   dtype=getattr(torch, dtype))
    q, k0, v0, k, v, g = mk(h), mk(hk), mk(hk), mk(hk), mk(hk), mk(h)
    scale = 1.0 / d ** 0.5
    f32 = torch.float32
    first = fa.flash_forward(q, k0, v0, True, scale, out_dtype=f32)
    ref_first = fa.flash_forward_plain(q, k0, v0, True, scale, out_dtype=f32)
    out, lse = fa.flash_forward(q, k, v, False, scale, carry=first, out_dtype=f32)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, False, scale, carry=first,
                                              out_dtype=f32)
    errs_f = [(first[0] - ref_first[0]).abs().max().item(),
              (out - ref_out).abs().max().item()]
    lse_err = max((first[1] - ref_first[1]).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
    f_ok = (first[0].dtype == f32 and out.dtype == f32
            and close(first[0], ref_first[0], dtype)
            and close(out, ref_out, dtype) and lse_err <= LSE_ATOL)
    gq = g.to(q.dtype)
    delta = (gq.float() * out).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_backward(q, k, v, None, lse, gq, False, scale, delta=delta)
    again = fa.flash_backward(q, k, v, None, lse, gq, False, scale, delta=delta)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ref = fa.flash_backward_plain(q, k, v, None, lse, gq, False, scale, delta=delta)
    errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
    rels = [rel_norm_err(x, r) for x, r in zip(got, ref)]
    b_ok = same and all(close(x, r, dtype) for x, r in zip(got, ref))
    path = fa.flash_path(c, d, q.dtype)
    shape = f"{dtype} s=lk={c} h={h} hk={hk} d={d} path {path}"
    fwd = (f"flash_fwd carry {shape}: float32 out of a causal hop max_abs_err "
           f"{errs_f[0]:.3e}, then a full hop merged onto it max_abs_err "
           f"{errs_f[1]:.3e}, lse_err {lse_err:.3e}")
    bwd = (f"flash_bwd delta {shape}: max_abs_err dq/dk/dv "
           f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, rel_norm_err "
           f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e}, two calls equal bit for "
           f"bit {same}")
    frec, brec = dict(max_abs_err=max(errs_f)), dict(max_abs_err=max(errs))
    if timed:
        qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
        hop_pairs = h * c * c
        # K1: q, k, v; the carry (f32 out, lse) read, out and lse written
        f_bound = bound(qb + 2 * kb + 2 * 4 * out.numel() + 2 * 4 * lse.numel(),
                        4 * d * hop_pairs)
        # K3: q, g, dq, k, v, dk, dv; lse and delta read
        b_bound = bound(3 * qb + 4 * kb + 2 * 4 * lse.numel(), 10 * d * hop_pairs)
        for what, rec, call, plain, (bms, by) in (
                ("flash_fwd", frec,
                 lambda: fa.flash_forward(q, k, v, False, scale, carry=first,
                                          out_dtype=f32),
                 lambda: fa.flash_forward_plain(q, k, v, False, scale,
                                                carry=first, out_dtype=f32),
                 f_bound),
                ("flash_bwd", brec,
                 lambda: fa.flash_backward(q, k, v, None, lse, gq, False, scale,
                                           delta=delta),
                 lambda: fa.flash_backward_plain(q, k, v, None, lse, gq, False,
                                                 scale, delta=delta),
                 b_bound)):
            ms = time_ms(call)
            dev, parts = device_ms(call)
            plain_ms = time_ms(plain, iters=5, warmup=1)
            rec.update(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=None)
            text = (f", kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)} "
                    f"({_parts_txt(parts)}), plain_ms {plain_ms:.4f}, library "
                    f"none, bound_ms {bms:.5f} ({by})")
            if what == "flash_fwd":
                fwd += text
            else:
                bwd += text
    log("kernels", f"{fwd} -> {'ok' if f_ok else 'FAIL'}")
    log("kernels", f"{bwd} -> {'ok' if b_ok else 'FAIL'}")
    return f_ok and b_ok, frec, brec


def ring_kernel_cases(timed=True):
    """The ring operands: K1 and K3 with q_offset (rectangular), K1 with
    float32 out and with the carry, K3 with delta.  Timed at the ring
    shape (`RING_*`), then untimed on every path (`RING_CASES`).  Returns
    (ok, {record name: record})."""
    ok_all = True
    recs = {}
    if timed:
        ok, recs["flash_fwd_offset"], recs["flash_bwd_offset"] = _ring_offset_case(
            RING_SEQ, RING_R, RING_HEADS, RING_HEADS, timed=True)
        ok_all &= ok
        ok, recs["flash_fwd_carry"], recs["flash_bwd_delta"] = _ring_hop_case(
            RING_SEQ // (2 * RING_R), RING_HEADS, RING_HEADS, timed=True)
        ok_all &= ok
    errs = {name: [] for name in ("flash_fwd_offset", "flash_bwd_offset",
                                  "flash_fwd_carry", "flash_bwd_delta")}
    for kw in RING_CASES:
        ok, f1, b1 = _ring_offset_case(2048, 4, seed=42, **kw)
        ok2, f2, b2 = _ring_hop_case(256, seed=43, **kw)
        ok_all &= ok and ok2
        if kw.get("dtype", "bfloat16") == "bfloat16":
            for name, rec in (("flash_fwd_offset", f1), ("flash_bwd_offset", b1),
                              ("flash_fwd_carry", f2), ("flash_bwd_delta", b2)):
                errs[name].append(rec["max_abs_err"])
    for name, rec in recs.items():
        rec["max_abs_err"] = max([rec["max_abs_err"], *errs[name]])
    return ok_all, recs


# ---------------------------------------------------------------------------
# the optimizer's kernels: adam_fused and unscale_fused
# ---------------------------------------------------------------------------

# adam_fused against adam_multi_plain on the same inputs: parameters,
# masters, moments and beta powers equal bit for bit (torch.equal).  Both
# round once per float32 operation in the same order (the kernel's
# intrinsics are never contracted into FMAs, and torch's division and sqrt
# round as IEEE does), so any difference is a fault of the kernel: a decay
# term of 6e-8 on a weight of 0.02 or a moment of 1e-8 is a fault, which a
# tolerance of a few ulps plus an absolute term would hide.
ADAM_FLOPS = 16  # float32 operations of one element's update
AMP_LR = 3e-4


def llama_param_specs(cfg):
    """(shape, stays float32) of each parameter of `cfg`'s LlamaForCausalLM
    in its order: under bf16 O2 the RMSNorm weights stay float32, every
    other tensor is bf16 with a float32 master."""
    h, inter, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    layer = [((h, h), False), ((kv, h), False), ((kv, h), False), ((h, h), False),
             ((inter, h), False), ((inter, h), False), ((h, inter), False),
             ((h,), True), ((h,), True)]
    return ([((vocab, h), False)] + layer * cfg.num_hidden_layers
            + [((h,), True), ((vocab, h), False)])


def bert_param_specs(cfg):
    """The same for `cfg`'s BertForQuestionAnswering (its LayerNorms stay
    float32), read from a model built on the CPU."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering

    model = amp.decorate(BertForQuestionAnswering(cfg, device="cpu"), level="O2")
    return [(tuple(p.shape), p.dtype == torch.float32) for p in model.parameters()]


def _adam_lists(specs, seed, device="cuda", low=None, masters=True,
                mode="decoupled", wd=0.01, w_scale=0.02):
    """Random Adam state over `specs` as a training step holds it: each
    tensor that does not stay float32 in `low` (default bf16) with a
    float32 master (or none, `masters=False`), the others float32; weights
    of scale `w_scale`; moments and beta powers as after three steps; decay
    `wd` in `mode` on the low-precision tensors.  Returns the list
    arguments of `adam_multi`."""
    import torch

    low = low or torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda shape, scale: torch.randn(shape, generator=g, device=device) * scale
    out = {k: [] for k in ("params", "grads", "masters", "moments1", "moments2",
                           "beta1_pows", "beta2_pows", "decays")}
    for shape, keep in specs:
        w = rnd(shape, w_scale)
        dtype = torch.float32 if keep else low
        out["params"].append(w if keep else w.to(dtype))
        out["masters"].append(None if keep or not masters or dtype == torch.float32
                              else w)
        out["grads"].append(rnd(shape, 1e-3).to(dtype))
        out["moments1"].append(rnd(shape, 1e-4))
        out["moments2"].append(rnd(shape, 1e-4).square())
        out["beta1_pows"].append(torch.full((), 0.9 ** 3, device=device))
        out["beta2_pows"].append(torch.full((), 0.999 ** 3, device=device))
        out["decays"].append((0.0 if keep else wd, mode))
    return out


def _adam_clone(d):
    return {k: [t.clone() if hasattr(t, "clone") else t for t in v]
            for k, v in d.items()}


def _adam_state_tensors(d):
    return [t for k in ("params", "masters", "moments1", "moments2", "beta1_pows",
                        "beta2_pows") for t in d[k] if t is not None]


def _adam_compare(got, ref):
    """(all equal bit for bit, max |got - ref|, tensors that differ) over
    params, masters, moments and powers; a parameter with a master must
    also equal it rounded to the parameter's dtype."""
    import torch

    ok, err, differ = True, 0.0, 0
    for a, b in zip(_adam_state_tensors(got), _adam_state_tensors(ref)):
        same = torch.equal(a, b)
        differ += not same
        ok &= same and bool(torch.isfinite(a.float()).all())
        err = max(err, (a.float() - b.float()).abs().max().item())
    for p, w in zip(got["params"], got["masters"]):
        if w is not None:
            ok &= torch.equal(p, w.to(p.dtype))
    return ok, err, differ


def _adam_run(d, lr, found_inf=None, table=None, plain=False):
    from paddle_tpu_torch.ops import optim

    args = (d["params"], d["grads"], d["masters"], d["moments1"], d["moments2"],
            d["beta1_pows"], d["beta2_pows"], d["decays"], lr, 0.9, 0.999, 1e-8)
    if plain:
        optim.adam_multi_plain(*args, found_inf=found_inf)
    else:
        optim.adam_multi(*args, found_inf=found_inf, table=table)


def _adam_case(what, specs, seed, timed=True, low=None):
    """adam_fused over `specs` (`low`, default bf16, with float32 masters,
    float32 norms)
    against adam_multi_plain on a copy of the same state: one step, held
    by `_adam_compare`; with `timed`, kernel and plain times, the byte
    bound (28 B per element) and torch.optim.AdamW(fused=True) over float32
    tensors of the same shapes.  Returns (ok, record)."""
    import torch

    from paddle_tpu_torch.ops import optim

    got = _adam_lists(specs, seed, low=low)
    ref = _adam_clone(got)
    lr = torch.full((), AMP_LR, device="cuda")
    table = optim.MultiTensorTable()
    _adam_run(got, lr, table=table)
    torch.cuda.synchronize()
    _adam_run(ref, lr, plain=True)
    ok, err, differ = _adam_compare(got, ref)
    n = sum(p.numel() for p in got["params"])
    shape = (f"adam_fused {what}: {len(specs)} tensors, {n} elements, one launch: "
             f"params, masters, moments and powers equal to the plain version "
             f"bit for bit ({differ} of {len(_adam_state_tensors(got))} tensors "
             f"differ, max_abs_err {err:.3e}), params == masters rounded")
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    plain_ms = time_ms(lambda: _adam_run(ref, lr, plain=True), iters=3, warmup=1)
    del ref
    torch.cuda.empty_cache()
    ms = time_ms(lambda: _adam_run(got, lr, table=table), iters=10, warmup=2)
    dev, _ = device_ms(lambda: _adam_run(got, lr, table=table), iters=5, warmup=1)
    args = [got[k] for k in ("params", "grads", "masters", "moments1", "moments2",
                             "beta1_pows", "beta2_pows", "decays")]
    t0 = time.perf_counter()
    for _ in range(20):
        optim.adam_entries(*args)
    pack_ms = (time.perf_counter() - t0) / 20 * 1e3
    bms, by = bound(28 * n, ADAM_FLOPS * n, PEAK_F32_FLOP_S)
    # the library's fused AdamW over float32 tensors of the same shapes
    params = [w if w is not None else p for p, w in zip(got["params"], got["masters"])]
    del got
    for p in params:
        p.grad = torch.randn(p.shape, device="cuda") * 1e-3
    lib = torch.optim.AdamW(params, lr=AMP_LR, weight_decay=0.01, fused=True)
    lib_ms = time_ms(lib.step, iters=5, warmup=2)
    del lib, params
    torch.cuda.empty_cache()
    log("kernels", f"{shape}, kernel_ms {ms:.4f} (the host's packing of the "
                   f"entries {pack_ms:.4f} of it), device_ms {_dev_txt(dev)}, "
                   f"plain_ms {plain_ms:.4f}, library_ms (torch AdamW fused, "
                   f"float32) {lib_ms:.4f}, bound_ms {bms:.5f} ({by}, 28 B per "
                   f"element) -> {'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _adam_skip_case(what, specs, seed):
    """A set found_inf: one launch writes nothing, bit for bit."""
    import torch

    from paddle_tpu_torch.ops import optim

    d = _adam_lists(specs, seed)
    before = [t.clone() for t in _adam_state_tensors(d)]
    _adam_run(d, torch.full((), AMP_LR, device="cuda"),
              found_inf=torch.ones((), dtype=torch.int32, device="cuda"),
              table=optim.MultiTensorTable())
    same = all(torch.equal(a, b) for a, b in zip(_adam_state_tensors(d), before))
    log("kernels", f"adam_fused {what} with found_inf set: every param, master, "
                   f"moment and power unchanged bit for bit: {same} -> "
                   f"{'ok' if same else 'FAIL'}")
    return same


def _adam_variants():
    """Every other variant the wrapper launches, untimed: decay modes (L2,
    L1, decoupled L1), decay terms larger than the update (weights of
    scale 1, coefficient 0.1, decoupled and L2), bf16 and fp16 without
    masters, fp16 with masters, float32 only, unaligned storage (views one
    element into a buffer), and sizes that leave vector tails and span
    chunks.  Returns (ok, max_abs_err)."""
    import torch

    from paddle_tpu_torch.ops import optim

    sizes = [((1,), True), ((7,), False), ((8,), False), ((3, 5), True),
             ((optim.CHUNK + 9,), False), ((2, optim.CHUNK + 3), False)]
    cases = [dict(mode=m) for m in ("l2", "l1", "decoupled_l1")] + [
        dict(w_scale=1.0, wd=0.1), dict(w_scale=1.0, wd=0.1, mode="l2"),
        dict(masters=False), dict(low=torch.float16),
        dict(low=torch.float16, masters=False), dict(low=torch.float32),
        dict(unaligned=True)]
    ok, worst = True, 0.0
    lr = torch.full((), AMP_LR, device="cuda")
    for i, kw in enumerate(cases):
        unaligned = kw.pop("unaligned", False)
        got = _adam_lists(sizes, 60 + i, **kw)
        if unaligned:
            for k in ("params", "grads", "masters", "moments1", "moments2"):
                got[k] = [None if t is None else
                          torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)
                          for t in got[k]]
        ref = _adam_clone(got)
        _adam_run(got, lr, table=optim.MultiTensorTable())
        _adam_run(ref, lr, plain=True)
        good, err, differ = _adam_compare(got, ref)
        ok &= good
        worst = max(worst, err)
        log("kernels", f"adam_fused variant {kw}{' unaligned' if unaligned else ''}: "
                       f"bit for bit ({differ} tensors differ, max_abs_err "
                       f"{err:.3e}) -> {'ok' if good else 'FAIL'}")
    return ok, worst


def _grad_lists(specs, seed, low=None, device="cuda"):
    import torch

    low = low or torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(shape, generator=g, device=device) * 32.0).to(
        torch.float32 if keep else low) for shape, keep in specs]


def _unscale_case(what, specs, seed, timed=True, low=None):
    """unscale_fused over `specs`' gradients (`low`, default bf16, float32
    norms) against
    unscale_multi_plain on copies: once clean (found_inf stays 0), once
    with one inf injected (found_inf 1), equal bit for bit (one multiply by
    the inverse rounded to the gradient's dtype on both sides); with
    `timed`, times, the byte bound (4 B per bf16 element, 8 per float32)
    and torch._amp_foreach_non_finite_check_and_unscale_.  Returns (ok,
    record)."""
    import torch

    from paddle_tpu_torch.ops import optim

    got = _grad_lists(specs, seed, low=low)
    ref = [g.clone() for g in got]
    scale = torch.full((), 2.0 ** 15, device="cuda")
    table = optim.MultiTensorTable()
    ok, err = True, 0.0
    for inject in (False, True):
        if inject:
            got[len(got) // 2].view(-1)[123] = float("inf")
            ref[len(ref) // 2].view(-1)[123] = float("inf")
        f_got = torch.zeros((), dtype=torch.int32, device="cuda")
        f_ref = torch.zeros((), dtype=torch.int32, device="cuda")
        optim.unscale_multi(got, scale, f_got, table=table)
        optim.unscale_multi_plain(ref, scale, f_ref)
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max([err] + [(a.float() - b.float()).nan_to_num(0.0, 0.0, 0.0)
                           .abs().max().item() for a, b in zip(got, ref)])
        ok &= same and int(f_got) == int(inject) == int(f_ref)
    n = sum(g.numel() for g in got)
    nbytes = sum(2 * g.numel() * g.element_size() for g in got)
    shape = (f"unscale_fused {what}: {len(got)} gradients, {n} elements, one "
             f"launch: equal to the plain version bit for bit, found_inf 0 clean "
             f"and 1 with one inf")
    del ref
    if not timed:
        log("kernels", f"{shape} -> {'ok' if ok else 'FAIL'}")
        return ok, dict(max_abs_err=err)
    flag = torch.zeros((), dtype=torch.int32, device="cuda")
    one = torch.ones((), device="cuda")  # scale 1: the gradients stay as they are
    ms = time_ms(lambda: optim.unscale_multi(got, one, flag, table=table))
    dev, _ = device_ms(lambda: optim.unscale_multi(got, one, flag, table=table))
    plain_ms = time_ms(lambda: optim.unscale_multi_plain(got, one, flag), iters=3,
                       warmup=1)
    # the library call takes float32 and fp16, not bf16: fp16 gradients of
    # the same shapes move the same bytes
    half = [g.half() if g.dtype == torch.bfloat16 else g for g in got]
    found_f = torch.zeros(1, device="cuda")
    inv = torch.ones(1, device="cuda")
    lib_ms = time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
        half, found_f, inv))
    del half
    bms, by = bound(nbytes, 2 * n, PEAK_F32_FLOP_S)
    lib_dtype = ("fp16 in place of bf16" if low in (None, torch.bfloat16)
                 else "float16")
    log("kernels", f"{shape}, kernel_ms {ms:.4f}, device_ms {_dev_txt(dev)}, "
                   f"plain_ms {plain_ms:.4f}, library_ms "
                   f"(_amp_foreach_non_finite_check_and_unscale_, {lib_dtype}) "
                   f"{lib_ms:.4f}, "
                   f"bound_ms {bms:.5f} ({by}) -> {'ok' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _unscale_variants():
    """unscale_fused on float32, bf16 and fp16 gradients, an unaligned view,
    tails, with and without a nan: against the plain version, bit for
    bit, and the flag."""
    import torch

    from paddle_tpu_torch.ops import optim

    sizes = [((1,), True), ((7,), False), ((optim.CHUNK + 9,), False),
             ((3, 5), True)]
    ok = True
    scale = torch.full((), 1024.0, device="cuda")
    for i, low in enumerate((torch.bfloat16, torch.float16, torch.float32)):
        for bad in (False, True):
            got = _grad_lists(sizes, 70 + i, low=low)
            got[2] = torch.cat([got[2][:1], got[2]])[1:]  # unaligned storage
            if bad:
                got[1].view(-1)[3] = float("nan")
            ref = [g.clone() for g in got]
            f_got = torch.zeros((), dtype=torch.int32, device="cuda")
            f_ref = torch.zeros((), dtype=torch.int32, device="cuda")
            optim.unscale_multi(got, scale, f_got, table=optim.MultiTensorTable())
            optim.unscale_multi_plain(ref, scale, f_ref)
            same = all(torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
                       for a, b in zip(got, ref))
            good = same and int(f_got) == int(f_ref) == int(bad)
            ok &= good
            log("kernels", f"unscale_fused variant {low} nan {bad} -> "
                           f"{'ok' if good else 'FAIL'}")
    return ok


def optim_kernel_cases(timed=True):
    """adam_fused over the train phase's parameters (Llama-2-7B's widths at
    TRAIN_LAYERS layers) and over BERT-base's, timed; found_inf skips bit
    for bit; every other variant untimed; then unscale_fused over the
    train phase's gradients, timed, and its variants.  Returns ({record
    name: record}, ok)."""
    import torch

    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.models.llama import LlamaConfig

    llama = llama_param_specs(LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS))
    bert = bert_param_specs(BertConfig.bert_base())
    ok, rec = _adam_case(f"Llama-2-7B widths x {TRAIN_LAYERS} layers (the train "
                         f"phase's parameters)", llama, seed=80, timed=timed)
    torch.cuda.empty_cache()
    ok_b, rec_b = _adam_case("BERT-base (the bert phase's parameters)", bert,
                             seed=81, timed=timed)
    ok &= ok_b
    ok &= _adam_skip_case("BERT-base", bert, seed=82)
    ok &= _adam_skip_case("one Llama-2-7B layer", llama[1:10], seed=83)
    ok_v, err_v = _adam_variants()
    ok &= ok_v
    torch.cuda.empty_cache()
    ok_u, rec_u = _unscale_case("the train phase's gradients", llama, seed=84,
                                timed=timed)
    ok &= ok_u & _unscale_variants()
    torch.cuda.empty_cache()
    # the fp16_train phase's: float16 parameters with float32 masters, and
    # float16 gradients (the library call then takes them as they are)
    ok16, rec16 = _adam_case(f"float16, Llama-2-7B widths x {TRAIN_LAYERS} "
                             f"layers", llama, seed=85, timed=timed,
                             low=torch.float16)
    torch.cuda.empty_cache()
    ok_u16, rec_u16 = _unscale_case("float16, the train phase's gradients", llama,
                                    seed=86, timed=timed, low=torch.float16)
    ok &= ok16 and ok_u16
    torch.cuda.empty_cache()
    worst = max(rec["max_abs_err"], rec_b["max_abs_err"], err_v)
    return {"adam_fused": dict(rec, max_abs_err=worst),
            "adam_fused_bert": dict(rec_b, max_abs_err=worst),
            "unscale_fused": rec_u, "adam_fused_f16": rec16,
            "unscale_fused_f16": rec_u16}, ok


def _k3_repeat(b, s, h, hk, d=128, causal=True, seed=17, dtype="bfloat16"):
    """K3 twice on the same inputs: dq, dk and dv must be equal bit for bit
    (no float atomics, a fixed order of every sum)."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(b, s, heads, d, generator=gen, device="cuda",
                              dtype=getattr(torch, dtype)) for heads in (h, hk, hk, h))
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    first = fa.flash_backward(q, k, v, out, lse, g, causal)
    second = fa.flash_backward(q, k, v, out, lse, g, causal)
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    log("kernels", f"flash_bwd {dtype} b={b} s={s} h={h} hk={hk} d={d} "
                   f"causal={causal} path {fa.flash_path(s, d, q.dtype)}: two "
                   f"calls equal bit for bit (dq, dk, dv): {same} -> "
                   f"{'ok' if same else 'FAIL'}")
    return same


def phase_kernels():
    """Each kernel against its plain version: timed at the main paths'
    shapes (bf16; the FMA page walks at the same decode steps in float32),
    then untimed over every other variant the wrappers launch on the card
    (float32, head_dim 64 and 256, non-causal, GQA, ragged, the largest
    shared memory, each kernel path of `flash_path` and `paged_path`, cp 2
    and 4), with K3 held bit for bit across two calls; then K1's and K3's
    ring operands (`ring_kernel_cases`).  Returns ({name:
    record at the headline shape}, all_ok); the record's max_abs_err is the
    worst over the bf16 cases of that entry (over every case of an FMA
    page-walk entry)."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    parity_matmuls()  # the plain versions in f32
    log("kernels", f"tolerances: |kernel - plain| <= atol + rtol |plain| with "
                   f"(atol, rtol) = ({KERNEL_ATOL}, {KERNEL_RTOL}) in bf16, "
                   f"({F32_ATOL}, {F32_RTOL}) in f32; lse within {LSE_ATOL}; "
                   f"rel_norm_err per (batch, head) <= {REL_NORM_TOL}")
    ok_all = True

    fma_errs = ()  # the FMA paths' lists keep every dtype's errors

    def case(fn, errs, **kw):
        nonlocal ok_all
        ok, rec = fn(**kw)
        ok_all &= ok
        if errs is not None and (kw.get("dtype", "bfloat16") == "bfloat16"
                                 or any(errs is e for e in fma_errs)):
            errs.append(rec["max_abs_err"])
        return rec

    # K1: the serving prefill buckets (s 16 on mma.sync, 128 and 512 on
    # wgmma) timed, then ragged GQA, non-causal and d 64 on both paths
    errs1 = []
    k1 = {s: case(_k1_case, errs1, b=1, s=s, h=32, hk=32) for s in (16, 128, 512)}
    for kw in K1_CASES:
        case(_k1_case, errs1, timed=False, **kw)
    decode_pos = [1999, 1500, 1024, 700, 300, 128, 127, 5]
    # K2 and K4 each on their three paths: the decode walk (bf16 q, under
    # 16 rows: every decode and verify step), timed at the decode step; the
    # FMA page walk (float32 q, other d), timed at the same step in
    # float32; the tensor-core chunk window, timed at a prefix hit's
    # 256-row chunk prefill beside SDPA on the gathered K/V (K2).  Then
    # every other case untimed, each over bf16 and over int8 pages.
    errs2w, errs2, errs2c, errs4w, errs4, errs4c = [], [], [], [], [], []
    fma_errs = (errs2, errs4)
    k2w = case(_k2_case, errs2w, b=8, sq=1, h=32, hk=32, pos=decode_pos)
    k4w = case(_k2_case, errs4w, b=8, sq=1, h=32, hk=32, pos=decode_pos, seed=11,
               quant=True)
    k2 = case(_k2_case, errs2, b=8, sq=1, h=32, hk=32, pos=decode_pos,
              dtype="float32", seed=3)
    k4 = case(_k2_case, errs4, b=8, sq=1, h=32, hk=32, pos=decode_pos,
              dtype="float32", seed=4, quant=True)
    k2c = case(_k2_case, errs2c, b=1, sq=256, h=32, hk=32, pos=[300], seed=9,
               library=True)
    k4c = case(_k2_case, errs4c, b=1, sq=256, h=32, hk=32, pos=[300], seed=12,
               quant=True)
    # K2 and K4 per head shard: the tp phase's decode step (tp 4, 8 of the
    # 32 heads and 8 kv heads per rank), each rank against its plain version
    k2tp = case(_k2_tp_case, None, b=8, sq=1, h=32, hk=32, pos=decode_pos, tp=4)
    k4tp = case(_k2_tp_case, None, b=8, sq=1, h=32, hk=32, pos=decode_pos, tp=4,
                quant=True, seed=71)
    for quant, (ew, ec, ef) in ((False, (errs2w, errs2c, errs2)),
                                (True, (errs4w, errs4c, errs4))):
        for kw in WALK_CASES:
            case(_k2_case, ew, seed=10, timed=False, quant=quant, **kw)
        for kw in CHUNK_CASES:
            case(_k2_case, ec, seed=10, timed=False, quant=quant, **kw)
        for kw in FMA_CASES:
            case(_k2_case, ef, seed=5, timed=False, quant=quant, **kw)
    # the training path: K1 and K3 at the slice's shape (both on their
    # wgmma kernels), timed; K3 at s 512 timed too; then K3's other
    # variants untimed, and two calls held bit for bit
    k1_train = case(_k1_case, errs1, b=TRAIN_BATCH, s=TRAIN_SEQ, h=32, hk=32, seed=7)
    errs3 = []
    k3w = case(_k3_case, errs3, b=TRAIN_BATCH, s=TRAIN_SEQ, h=32, hk=32)
    k3 = case(_k3_case, errs3, b=TRAIN_BATCH, s=512, h=32, hk=32, seed=9)
    for kw in K3_CASES:
        case(_k3_case, errs3, seed=8, timed=False, **kw)
    for kw in K3_REPEATS:
        ok_all &= _k3_repeat(**kw)
    # K1 and K3 with segment ids and key bias: BERT's shape (the bert
    # phase's attention, wgmma at d 64), timed, then every other variant
    ok, k1m, k3m = _masked_case(BERT_BATCH, BERT_SEQ, 12, 12, "pad", timed=True)
    ok_all &= ok
    errs1m, errs3m = [k1m["max_abs_err"]], [k3m["max_abs_err"]]
    for kw in MASKED_CASES:
        ok, frec, brec = _masked_case(seed=31, **kw)
        ok_all &= ok
        if kw.get("dtype", "bfloat16") == "bfloat16":
            errs1m.append(frec["max_abs_err"])
            errs3m.append(brec["max_abs_err"])
    # K6: the lock-step prefill of the generate phase (wgmma), timed, then
    # GQA, ragged sq at pos > 0 on both tensor-core paths, float32 and the
    # FMA path at d 256, untimed
    errs6 = []
    k6 = case(_k6_case, errs6, b=GEN_BATCH, sq=GEN_LEN, h=32, hk=32, L=640)
    for kw in K6_CASES:
        case(_k6_case, errs6, seed=15, timed=False, **kw)
    # K2 over a dense cache's page view: the generate phase's last decode
    # step (4 sequences at 563 of a 640-row cache) and the dense pool's
    # decode step (8 slots of 2048 rows at the K2 case's positions), timed;
    # then a short lock-step prefill (the chunk window), a one-page cache
    # (L not a multiple of 128) and float32 (the FMA walk), untimed
    errs2d = []
    k2d_gen = case(_k2_dense_case, errs2d, b=GEN_BATCH, sq=1, h=32, hk=32,
                   pos=GEN_LEN + GEN_NEW - 1, L=640)
    k2d = case(_k2_dense_case, errs2d, b=8, sq=1, h=32, hk=32, pos=decode_pos,
               L=2048)
    for kw in K2_DENSE_CASES:
        case(_k2_dense_case, errs2d, seed=19, timed=False, **kw)
    for dtype, sq in (("bfloat16", 300), ("bfloat16", 100), ("float32", 300)):
        ok_all &= _k6_is_k1(dtype, sq)
    # GPT-3 13B's shapes (the gpt and moe phases), timed: K1 and K3 at the
    # MoE GPT's training step (MOE_GPT_BATCH x MOE_GPT_SEQ, 40 heads of 128,
    # multi-head), K6 at 13B generate's prefill (GEN_BATCH x GEN_LEN rows of
    # a 640-row cache) and K2 over the page view at its last decode step
    k1_gpt = case(_k1_case, errs1, b=MOE_GPT_BATCH, s=MOE_GPT_SEQ, h=40, hk=40,
                  seed=60)
    k3_gpt = case(_k3_case, errs3, b=MOE_GPT_BATCH, s=MOE_GPT_SEQ, h=40, hk=40,
                  seed=61)
    k6_gpt = case(_k6_case, errs6, b=GEN_BATCH, sq=GEN_LEN, h=40, hk=40, L=640,
                  seed=62)
    k2d_gpt = case(_k2_dense_case, errs2d, b=GEN_BATCH, sq=1, h=40, hk=40,
                   pos=GEN_LEN + GEN_NEW - 1, L=640, seed=63)
    torch.cuda.empty_cache()
    # K5 (every shard in one launch): cp=2 decode at the cp phase's context
    # (per-slot pos 3000-4000 of 4096) on the decode walk, timed beside K2
    # over the same arena; the same in float32 (the FMA page walk, the
    # cp_f32 phase's path); its chunk window (a hit's 256-row chunk prefill
    # at pos 3000), timed; then the variants the cp engine launches,
    # untimed, at cp 2 and 4
    errs5w, errs5, errs5c = [], [], []
    fma_errs += (errs5,)
    k5w = case(_k5_case, errs5w, b=8, sq=1, h=32, hk=32, pos=K5_DECODE_POS)
    k5 = case(_k5_case, errs5, b=8, sq=1, h=32, hk=32, pos=K5_DECODE_POS,
              dtype="float32", seed=23)
    k5c = case(_k5_case, errs5c, b=1, sq=256, h=32, hk=32, pos=[3000])
    for kw in K5_WALK_CASES:
        case(_k5_case, errs5w if not kw.get("quant") else None, seed=21,
             timed=False, **kw)
    for kw in K5_FMA_CASES:
        case(_k5_case, errs5, seed=21, timed=False, **kw)
    for kw in K5_CHUNK_CASES:
        case(_k5_case, errs5c, seed=22, timed=False, **kw)
    # K5 per head shard: the tp x cp decode step (tp 2 x cp 2: 16 of the 32
    # heads and 16 kv heads per rank, each rank's arena in two page
    # shards), each rank against its plain version
    k5tp = case(_k5_tp_case, None, b=8, sq=1, h=32, hk=32, pos=K5_DECODE_POS,
                tp=TP_CP[0], cp=TP_CP[1])
    k5tp8 = case(_k5_tp_case, None, b=8, sq=1, h=32, hk=32, pos=K5_DECODE_POS,
                 tp=TP_CP[0], cp=TP_CP[1], quant=True, seed=73)
    # the ring operands of K1 and K3: timed at the ring's shapes, then on
    # every path
    ring_ok, ring_recs = ring_kernel_cases(timed=True)
    ok_all &= ring_ok
    torch.cuda.empty_cache()
    # the optimizer's kernels at the train and bert phases' parameters
    optim_recs, optim_ok = optim_kernel_cases(timed=True)
    ok_all &= optim_ok
    torch.cuda.empty_cache()
    # every case above again in float16
    fp16_recs, fp16_ok = fp16_kernel_cases()
    ok_all &= fp16_ok
    worst = lambda rec, errs: dict(rec, max_abs_err=max(errs))
    return {**ring_recs, **optim_recs, **fp16_recs,
            "flash_fwd": worst(k1[512], errs1),
            "flash_fwd_wgmma": worst(k1_train, errs1),
            "paged_decode_fused": worst(k2, errs2),
            "paged_decode_fused_walk": worst(k2w, errs2w),
            "paged_decode_fused_mma": worst(k2c, errs2c),
            "paged_decode_fused_q8": worst(k4, errs4),
            "paged_decode_fused_q8_walk": worst(k4w, errs4w),
            "paged_decode_fused_q8_mma": worst(k4c, errs4c),
            "paged_decode_tp": k2tp,
            "paged_decode_tp_q8": k4tp,
            "flash_bwd": worst(k3, errs3),
            "flash_bwd_wgmma": worst(k3w, errs3),
            "flash_fwd_masked": worst(k1m, errs1m),
            "flash_bwd_masked": worst(k3m, errs3m),
            "dense_decode": worst(k6, errs6),
            "paged_decode_fused_dense_pool": worst(k2d, errs2d),
            "paged_decode_fused_dense_generate": worst(k2d_gen, errs2d),
            "flash_fwd_gpt": worst(k1_gpt, errs1),
            "flash_bwd_gpt": worst(k3_gpt, errs3),
            "dense_decode_gpt": worst(k6_gpt, errs6),
            "paged_decode_fused_dense_gpt": worst(k2d_gpt, errs2d),
            "paged_decode_fused_cp": worst(k5, errs5),
            "paged_decode_fused_cp_walk": worst(k5w, errs5w),
            "paged_decode_fused_cp_mma": worst(k5c, errs5c),
            "paged_decode_cp_tp": k5tp,
            "paged_decode_cp_tp_q8": k5tp8}, ok_all


def _k6_is_k1(dtype, sq):
    """K6 at pos 0 over a cache as long as the prompt is K1's computation:
    the two entry points must give the same bits, on each K1 path."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v = (torch.randn(1, sq, heads, 128, generator=g, device="cuda",
                           dtype=getattr(torch, dtype)) for heads in (32, 8, 8))
    same = torch.equal(fa.dense_decode(q, k, v, 0), fa.flash_forward(q, k, v)[0])
    log("kernels", f"dense_decode {dtype} at pos 0, L = sq = {sq}, GQA, path "
                   f"{fa.flash_path(sq, 128, q.dtype)}: equal to flash_fwd bit "
                   f"for bit: {same} -> {'ok' if same else 'FAIL'}")
    return same


def fp16_kernel_cases():
    """Every K1-K6 case above that runs in bf16, again in float16 at the
    same shapes (the float32 cases aside; bf16 over int8 pages becomes an
    fp16 q over int8 pages), each against its plain version at FP16_ATOL /
    FP16_RTOL, on the path the bf16 case took: K1 at s 16/128/512 and the
    training shape, its variants, with segment ids and key bias, with the
    ring operands; K3 likewise and twice bit for bit; K6 and K6 = K1 at pos
    0; K2 over pages (walk, chunk window, FMA at other d) and over a dense
    cache's page view; K4 and K5 on their walks and chunk windows.  One
    case per kernel is timed at its main-path shape beside its bound and
    SDPA in float16 where one call computes the same function, and so is
    K4's chunk window (the fp16_serve phase's prefix hits).  Returns
    ({record name: record}, all_ok); a record's max_abs_err is the worst
    over its kernel's float16 cases."""
    import torch

    half = "float16"
    ok_all = True
    errs = {}

    def case(fn, name, **kw):
        nonlocal ok_all
        ok, rec = fn(dtype=half, **kw)
        ok_all &= ok
        errs.setdefault(name, []).append(rec["max_abs_err"])
        return rec

    def bf16_only(cases):
        return [kw for kw in cases if kw.get("dtype", "bfloat16") == "bfloat16"]

    log("kernels", f"float16 cases: (atol, rtol) = ({FP16_ATOL}, {FP16_RTOL}), "
                   f"rel_norm_err per (batch, head) <= {REL_NORM_TOL['float16']}")
    recs = {}
    # K1: the prefill buckets (s 512 timed) and the training shape, then
    # the variants
    recs["flash_fwd_f16"] = case(_k1_case, "flash_fwd_f16", b=1, s=512, h=32, hk=32)
    for kw in (dict(b=1, s=16, h=32, hk=32), dict(b=1, s=128, h=32, hk=32),
               dict(b=TRAIN_BATCH, s=TRAIN_SEQ, h=32, hk=32, seed=7),
               *bf16_only(K1_CASES)):
        case(_k1_case, "flash_fwd_f16", timed=False, **kw)
    # K3: the training shape timed, s 512 and the variants, twice bit for bit
    recs["flash_bwd_f16"] = case(_k3_case, "flash_bwd_f16", b=TRAIN_BATCH,
                                 s=TRAIN_SEQ, h=32, hk=32)
    for kw in (dict(b=TRAIN_BATCH, s=512, h=32, hk=32, seed=9),
               *bf16_only(K3_CASES)):
        kw = dict(kw)
        case(_k3_case, "flash_bwd_f16", seed=kw.pop("seed", 8), timed=False, **kw)
    for kw in K3_REPEATS:
        ok_all &= _k3_repeat(dtype=half, **kw)
    torch.cuda.empty_cache()
    # K1 and K3 with segment ids and key bias (BERT's shape and the
    # variants), and with the ring operands
    for kw in (dict(b=BERT_BATCH, s=BERT_SEQ, h=12, hk=12, kind="pad"),
               *bf16_only(MASKED_CASES)):
        kw = dict(kw)
        ok, frec, brec = _masked_case(seed=kw.pop("seed", 31), dtype=half, **kw)
        ok_all &= ok
        errs["flash_fwd_f16"].append(frec["max_abs_err"])
        errs["flash_bwd_f16"].append(brec["max_abs_err"])
    for kw in bf16_only(RING_CASES):
        ok, f1, b1 = _ring_offset_case(2048, 4, seed=42, dtype=half, **kw)
        ok2, f2, b2 = _ring_hop_case(256, seed=43, dtype=half, **kw)
        ok_all &= ok and ok2
        errs["flash_fwd_f16"] += [f1["max_abs_err"], f2["max_abs_err"]]
        errs["flash_bwd_f16"] += [b1["max_abs_err"], b2["max_abs_err"]]
    torch.cuda.empty_cache()
    # K6: the lock-step prefill timed, the variants, K6 = K1 at pos 0
    recs["dense_decode_f16"] = case(_k6_case, "dense_decode_f16", b=GEN_BATCH,
                                    sq=GEN_LEN, h=32, hk=32, L=640)
    for kw in bf16_only(K6_CASES):
        case(_k6_case, "dense_decode_f16", seed=15, timed=False, **kw)
    for sq in (300, 100):
        ok_all &= _k6_is_k1(half, sq)
    # K2 and K4: the decode walk timed at the decode step, K4's chunk
    # window at a hit's 256-row chunk prefill; K2's chunk window beside
    # SDPA untimed; then every walk, chunk and FMA case over float16 and
    # over int8 pages, and K2 over a dense cache's page view
    decode_pos = [1999, 1500, 1024, 700, 300, 128, 127, 5]
    recs["paged_decode_fused_f16"] = case(
        _k2_case, "paged_decode_fused_f16", b=8, sq=1, h=32, hk=32, pos=decode_pos,
        library=True)
    recs["paged_decode_fused_q8_f16"] = case(
        _k2_case, "paged_decode_fused_q8_f16", b=8, sq=1, h=32, hk=32,
        pos=decode_pos, seed=11, quant=True)
    recs["paged_decode_fused_q8_mma_f16"] = case(
        _k2_case, "paged_decode_fused_q8_mma_f16", b=1, sq=256, h=32, hk=32,
        pos=[300], seed=12, quant=True)
    case(_k2_case, "paged_decode_fused_f16", b=1, sq=256, h=32, hk=32, pos=[300],
         seed=9, timed=False)
    for quant, name in ((False, "paged_decode_fused_f16"),
                        (True, "paged_decode_fused_q8_f16")):
        for kw in (*WALK_CASES, *CHUNK_CASES, *bf16_only(FMA_CASES)):
            case(_k2_case, name, seed=10, timed=False, quant=quant, **kw)
    for kw in (dict(b=GEN_BATCH, sq=1, h=32, hk=32, pos=GEN_LEN + GEN_NEW - 1,
                    L=640),
               dict(b=8, sq=1, h=32, hk=32, pos=decode_pos, L=2048),
               *bf16_only(K2_DENSE_CASES)):
        case(_k2_dense_case, "paged_decode_fused_f16", seed=19, timed=False, **kw)
    torch.cuda.empty_cache()
    # K5: cp=2 decode at the cp phase's context on the walk, timed, then
    # the walk and chunk variants
    recs["paged_decode_fused_cp_f16"] = case(
        _k5_case, "paged_decode_fused_cp_f16", b=8, sq=1, h=32, hk=32,
        pos=K5_DECODE_POS)
    for kw in (*K5_WALK_CASES, *K5_CHUNK_CASES):
        case(_k5_case, "paged_decode_fused_cp_f16", seed=22, timed=False, **kw)
    torch.cuda.empty_cache()
    for name, rec in recs.items():
        rec["max_abs_err"] = max(errs[name])
    return recs, ok_all


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _post_full(url, body, headers=None):
    """POST and return (HTTP status, response headers, JSON body), error
    statuses included."""
    import urllib.error

    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def _get_full(url):
    """GET and return (HTTP status, JSON body), error statuses included."""
    try:
        with urllib.request.urlopen(url, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_http_fields(phase, engine, prompt, new_tokens=8):
    """The request fields of /generate beyond the generation's own, over
    HTTP on `engine`: one request with `X-Idempotency-Key` posted twice
    generates once (admissions counted at `submit`) and its replay carries
    `X-Idempotency-Replay: hit` and the same body; `X-Deadline-Ms: 0`
    answers 504 DeadlineExceeded and admits nothing.  Returns whether
    both held."""
    from paddle_tpu_torch.inference import serve

    admitted = []
    real = engine.submit

    def submit(*a, **kw):
        admitted.append(1)
        return real(*a, **kw)

    engine.submit = submit
    server = serve(engine, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    body = {"input_ids": prompt.tolist(), "max_new_tokens": new_tokens}
    key = {"X-Idempotency-Key": f"{phase}-once"}
    try:
        first = _post_full(url, body, key)
        again = _post_full(url, body, key)
        late = _post_full(url, body, {"X-Deadline-Ms": "0"})
    finally:
        server.stop()
        del engine.submit
    keyed_ok = (first[0] == again[0] == 200 and first[2] == again[2]
                and first[1].get("X-Idempotency-Replay") is None
                and again[1].get("X-Idempotency-Replay") == "hit"
                and len(admitted) == 1)
    late_ok = (late[0] == 504 and late[2]["type"] == "DeadlineExceeded"
               and late[2]["retriable"] is False and len(admitted) == 1)
    log(phase, f"POST /generate with one X-Idempotency-Key twice: statuses "
               f"{first[0]}, {again[0]}, replay header "
               f"{again[1].get('X-Idempotency-Replay')!r}, equal bodies "
               f"{first[2] == again[2]}, admissions {len(admitted)} (expected 1); "
               f"X-Deadline-Ms: 0 answered {late[0]} {late[2].get('type')} -> "
               f"{'ok' if keyed_ok and late_ok else 'FAIL'}")
    return keyed_ok and late_ok


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
        parity_matmuls()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=0)
    engine = ContinuousBatchingEngine(model, seed=0, device=device, **engine_kw)
    engine.warmup()
    warm = _warm_counts("slice", engine)
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
    replays = engine._decode_g.replay_count
    results, wall = _serve_batches(
        engine, [[(p, new) for p, (_, new) in zip(prompts, prompts_spec)]])
    counts = profiler.kernel_launch_counts()
    decode_steps = engine._decode_g.replay_count - replays
    summary = profiler.serving_summary()
    graphs_ok = _no_retrace("slice", engine, warm)

    layers = cfg.num_hidden_layers
    gen = []
    tokens_ok = True
    for i, (p, (n, new)) in enumerate(zip(prompts, prompts_spec)):
        toks = results[i]["tokens"]
        tokens_ok &= len(toks) == n + new and toks[:n] == p.tolist()
        gen.append(np.asarray(toks[n:], np.int32))
    want_k1 = len(prompts) * layers
    want_k2 = summary["decode_steps"] * layers
    # every decode step on the decode walk
    want_walk = want_k2 if on_card else 0
    counts_ok = (counts["flash_fwd"] == want_k1
                 and counts["paged_decode_fused"] == want_k2
                 and counts["paged_decode_fused_walk"] == want_walk)
    ok = tokens_ok and counts_ok and graphs_ok
    decode_tps, fetches = _decode_rates(summary)
    peak_gib = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
                else "not measured")
    log("slice", f"served {len(prompts)} requests over HTTP in {wall:.3f} s: "
                 f"token counts {'ok' if tokens_ok else 'WRONG'}; launches {_main(counts)} "
                 f"(expected flash_fwd {want_k1} = {len(prompts)} prefills x "
                 f"{layers} layers, paged_decode_fused {want_k2} = "
                 f"{summary['decode_steps']} decode steps x {layers}, each on the "
                 f"decode walk: paged_decode_fused_walk {want_walk}) -> "
                 f"{'ok' if counts_ok else 'FAIL'}; prefills on K1's wgmma path "
                 f"{counts['flash_fwd_wgmma'] // max(1, layers)} of {len(prompts)} "
                 f"(buckets of 128+ rows)")
    log("slice", f"ttft_p50_ms {summary['ttft_p50_ms']:.3f} ttft_p95_ms "
                 f"{summary['ttft_p95_ms']:.3f} decode_tokens_per_s "
                 f"{decode_tps:.2f} over the decode window of "
                 f"{summary['decode_window_s']:.3f} s (batch of up to "
                 f"{engine.slots}) host fetches per decode step {fetches:.3f} "
                 f"({summary['host_fetches']} in {summary['decode_steps']} steps) "
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
    ok &= check_replay("slice", engine, [
        rng.integers(1, cfg.vocab_size, size=min(100, engine.max_len // 4))
        .astype(np.int32)])
    ok &= check_http_fields("slice", engine, prompts[0])
    if on_card:
        summary = dict(summary, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       decode_profile=profile_decode(engine, cfg, rng))
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
    finished; an item may carry a third element, a dict of further body
    fields (`adapter`, `session_id`).  Returns (responses in order, wall
    seconds)."""
    from paddle_tpu_torch.inference import serve

    server = serve(engine, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    results = []
    t0 = time.perf_counter()
    try:
        for batch in batches:
            got = [None] * len(batch)

            def client(i, batch=batch, got=got):
                p, new, *extra = batch[i]
                got[i] = _post(url, {"input_ids": p.tolist(), "max_new_tokens": new,
                                     **(extra[0] if extra else {})})

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


def _warm_counts(phase, engine):
    """Print the engine's compile counts right after warmup() and the size
    of its graph pool; return the counts."""
    counts = engine.compile_counts()
    log(phase, f"compile_counts after warmup {counts}; graph pool "
               f"{engine.graph_pool_bytes() / 2**20:.1f} MiB")
    return counts


def _no_retrace(phase, engine, warm):
    """compile_counts() after the traffic against `warm`: the reference's
    "0 recompiles under traffic"."""
    after = engine.compile_counts()
    ok = after == warm
    log(phase, f"compile_counts after traffic {after} -> "
               f"{'ok, 0 new traces' if ok else 'FAIL'}")
    return ok


def _decode_rates(summary):
    """(decode tokens/s over the decode window's wall clock, host fetches of
    decode tokens per decode step)."""
    window = summary["decode_window_s"]
    decoded = summary["tokens"] - summary["requests"]
    return (decoded / window if window > 0 else 0.0,
            summary["host_fetches"] / max(1, summary["decode_steps"]))


def check_replay(phase, engine, prompts, new_tokens=8, kws=None, want=()):
    """Replay against eager: submit `prompts` (a fresh prompt, then any
    prefix-cache hits), each with its `kws` entry as more submit arguments
    (an adapter, a session id), and admit them with one engine step (their prefills,
    a hit's COW copy, one decode or verify step).  Then each executable
    that step ran -- the COW copy aside, which is not idempotent -- replays
    once beside one eager run of its body on the same static inputs, while
    the admitted requests still hold the pages both write alike.  Same
    shapes and kernels, so anything but bit-identical tokens and logits is
    a capture fault.  Returns whether every one was and every executable
    named in `want` was among them."""
    import torch

    graphs = engine.step_graphs()
    before = {n: g.trace_count + g.replay_count for n, g in graphs.items()}
    kws = kws or [{}] * len(prompts)
    reqs = [engine.submit(p, max_new_tokens=new_tokens, **kw)
            for p, kw in zip(prompts, kws)]
    engine.step()
    ok, parts = True, []
    for name, g in graphs.items():
        if name == "copy" or g.trace_count + g.replay_count == before[name]:
            continue
        replayed, eager = g.compare_eager(g.last_key)
        same = all(torch.equal(a, b) for a, b in zip(replayed, eager))
        ok &= same
        want = set(want) - {name}
        key = "" if g.last_key is None else f" {g.last_key}"
        parts.append(f"{name}{key} {'bit-identical' if same else 'DIFFERS'}")
    engine.run_until_idle()
    for r in reqs:
        r.wait(1)
    ok &= bool(parts) and not want
    log(phase, f"replay vs eager on the same static inputs: {'; '.join(parts)}"
               f"{f'; {sorted(want)} did not run' if want else ''} "
               f"-> {'ok' if ok else 'FAIL'}")
    return ok


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
    warm = _warm_counts(phase, engine)
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
    graphs_ok = _no_retrace(phase, engine, warm)

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
    # every decode step on the decode walk
    want_walk = summary["decode_steps"] * layers if on_card else 0
    tc_ok = (counts[paged_name + "_mma"] == want_tc
             and counts[paged_name + "_walk"] == want_walk)
    counts_ok = (counts["flash_fwd"] == want_k1 and counts[paged_name] == want_paged
                 and counts[other] == 0 and tc_ok)
    ok = tokens_ok and sharing_ok and counts_ok and graphs_ok
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
               f"({counts[paged_name + '_mma']} launches, expected {want_tc}); "
               f"decode steps on the decode walk: "
               f"{counts[paged_name + '_walk'] // max(1, layers)} of "
               f"{summary['decode_steps']} ({counts[paged_name + '_walk']} "
               f"launches, expected {want_walk}) -> {'ok' if tc_ok else 'FAIL'}")
    decode_tps, fetches = _decode_rates(summary)
    log(phase, f"ttft_p50_ms {summary['ttft_p50_ms']:.3f} ttft_p95_ms "
               f"{summary['ttft_p95_ms']:.3f} decode_tokens_per_s {decode_tps:.2f} "
               f"over the decode window of {summary['decode_window_s']:.3f} s "
               f"(batch of up to {engine.slots}) host fetches per decode step "
               f"{fetches:.3f} arena_gib {arena / 2**30:.2f} "
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
    n = min(100, engine.max_len // 4)
    ok &= check_replay(phase, engine, [
        rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
        np.concatenate([system, rng.integers(1, cfg.vocab_size, size=n)])
        .astype(np.int32)])
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
    status, _, payload = _post_full(url, body)
    return status, payload


def _cp_traffic(cfg, doc_len, questions, fresh):
    """The cp phase's traffic: (its generator, drawn on after it; the
    document; the document with each question appended; the fresh
    prompts), np.int32."""
    import numpy as np

    rng = np.random.default_rng(2)
    doc = rng.integers(1, cfg.vocab_size, size=doc_len)
    shared = [np.concatenate([doc, rng.integers(1, cfg.vocab_size, size=n)])
              .astype(np.int32) for n in questions]
    others = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in fresh]
    return rng, doc, shared, others


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
    of the run (K5 once per layer per paged attention under cp, every shard
    in one launch, no K2 or K4 there; every decode or verify step on the
    decode walk), and a direct run's logits against the
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
    rng, doc, shared, others = _cp_traffic(cfg, doc_len, questions, fresh)
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
        warm = _warm_counts(phase, engine)
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
        graphs_ok = _no_retrace(phase, engine, warm)
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
            # one launch per layer per paged attention, every shard in it
            want[paged] = layers * (steps + hits)
            # every chunk prefill on the tensor-core path, every decode or
            # verify step (1 or 3 rows) on the decode walk
            want[paged + "_mma"] = layers * hits
            want[paged + "_walk"] = layers * steps
        counts_ok = counts == want and hits == len(shared) - 1
        ok = tokens_ok and overflow_ok and health_ok and counts_ok and graphs_ok
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
                   f"{layers} layers x ({steps} "
                   f"{'verify' if spec_k else 'decode'} steps + {hits} chunk "
                   f"prefills), each launch over all {cp} shards) -> "
                   f"{'ok' if counts_ok else 'FAIL'}")
        log(phase, f"chunk prefills on the tensor-core path: "
                   f"{counts[paged + '_mma'] // max(1, layers)} of {hits} "
                   f"({counts[paged + '_mma']} launches, expected "
                   f"{want[paged + '_mma']}); {'verify' if spec_k else 'decode'} "
                   f"steps on the decode walk {counts[paged + '_walk'] // max(1, layers)} "
                   f"of {steps}; fresh prefills on K1's wgmma path "
                   f"{counts['flash_fwd_wgmma'] // max(1, layers)} of {misses}")
        log(phase, f"{overflow_len}-token prompt: HTTP {code} {body.get('type')} "
                   f"capacity {cap} -> {'ok' if overflow_ok else 'FAIL'}")
        decode_tps, fetches = _decode_rates(summary)
        log(phase, f"ttft_p50_ms {summary['ttft_p50_ms']:.3f} ttft_p95_ms "
                   f"{summary['ttft_p95_ms']:.3f} decode_tokens_per_s "
                   f"{decode_tps:.2f} over the decode window of "
                   f"{summary['decode_window_s']:.3f} s (batch of up to "
                   f"{engine.slots}) host fetches per "
                   f"{'verify' if spec_k else 'decode'} step {fetches:.3f} "
                   f"speculation {spec_sum or 'off'} | {smi}")

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
        n = min(100, engine.max_len // 4)
        ok &= check_replay(phase, engine, [
            rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
            np.concatenate([doc, rng.integers(1, cfg.vocab_size, size=n)])
            .astype(np.int32)])
        if on_card and cp > 1 and not profiled:
            profile_decode(engine, cfg, rng, prompt_len=profile_len)
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


def _top2_gap(model, device, prompt, gen, at):
    """The top-2 logit gap, and max|logit|, of the teacher-forced forward
    over prompt + gen at generated position `at`."""
    import numpy as np
    import torch

    seq = np.concatenate([prompt, gen[:at]])[None]
    with torch.no_grad():
        row = model(torch.from_numpy(seq).to(device))[0, -1].float()
    top = row.topk(2).values
    return (top[0] - top[1]).item(), row.abs().max().item()


def phase_cp_f32(smi, model, device="cuda", doc_len=CP_DOC_LEN,
                 questions=CP_QUESTIONS, fresh=CP_FRESH, new_tokens=CP_NEW,
                 runs=CP_F32_RUNS, **engine_kw):
    """Context parallelism and speculation held in float32 (F4): `model`
    (float32, and so its arenas) serves the cp phase's traffic behind POST
    /generate through each engine of `runs`, one at a time.  For each run
    after the first, per-position greedy agreement with the first run, and
    at each request's first divergence the top-2 logit gap of the first
    run's teacher-forced forward.  Passes when every request's tokens are
    identical or its first divergence is a near tie: gap <= F32_TIE_REL x
    max|logit| there.  Returns (ok, launch counts of every run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    _, _, shared, others = _cp_traffic(cfg, doc_len, questions, fresh)
    spec = [(p, new_tokens) for p in shared + others]
    batches = [spec[:1], spec[1:]]
    log("cp_f32", f"Llama {cfg.hidden_size} hidden x {layers} layers in "
                  f"{model.lm_head.weight.dtype} (arenas too); near-tie rule: "
                  f"top-2 gap <= {F32_TIE_REL} x max|logit| | {smi}")
    ok_all, all_counts, gens = True, [], {}
    for label, cp, spec_k in runs:
        phase = f"cp_f32 {label}"
        engine = ContinuousBatchingEngine(model, seed=0, device=device, cp=cp,
                                          spec_k=spec_k, prefix_cache=True,
                                          **engine_kw)
        engine.warmup()
        warm = _warm_counts(phase, engine)
        profiler.reset_kernel_launch_counts()
        results, wall = _serve_batches(engine, batches)
        counts = profiler.kernel_launch_counts()
        all_counts.append(counts)
        graphs_ok = _no_retrace(phase, engine, warm)
        gen, tokens_ok = [], True
        for r, (p, new) in zip(results, spec):
            toks = r["tokens"]
            tokens_ok &= len(toks) == p.size + new and toks[:p.size] == p.tolist()
            gen.append(np.asarray(toks[p.size:], np.int32))
        gens[label] = gen
        k5 = counts["paged_decode_fused_cp"]
        # under cp every paged attention is K5 (never K2); cp=1 runs K2
        paths_ok = (not on_card or (k5 > 0 and counts["paged_decode_fused"] == 0
                                    if cp > 1 else
                                    counts["paged_decode_fused"] > 0 and k5 == 0))
        ok = tokens_ok and paths_ok and graphs_ok
        log(phase, f"engine cp={cp} spec_k={spec_k}: served {len(spec)} requests "
                   f"in {wall:.3f} s, token counts {'ok' if tokens_ok else 'WRONG'}; "
                   f"launches {_main(counts)} -> {'ok' if paths_ok else 'FAIL'}")
        ok_all &= ok
        del engine
        if on_card:
            _free()
    base = runs[0][0]
    for label, _, _ in runs[1:]:
        same = total = 0
        for i, ((p, _), a, b) in enumerate(zip(spec, gens[base], gens[label])):
            same += int((a == b).sum())
            total += a.size
            diff = np.flatnonzero(a != b)
            if diff.size == 0:
                continue
            at = int(diff[0])
            gap, top = _top2_gap(model, device, p, a, at)
            tie = gap <= F32_TIE_REL * top
            ok_all &= tie
            log("cp_f32", f"{label} vs {base}, request {i} (prompt {p.size}): first "
                          f"divergence at generated position {at}: top-2 gap "
                          f"{gap:.6e}, max|logit| {top:.4f}, gap / max|logit| "
                          f"{gap / top:.3e} -> {'near tie' if tie else 'FAIL'}")
        log("cp_f32", f"greedy tokens of {label} equal to {base}'s, per position: "
                      f"{same}/{total} = {same / total:.4f}")
    return ok_all, all_counts


# the fp16_serve phase's context-parallel run: (label, cp, spec_k,
# kv_quant, page audit every step), as CP_RUNS
FP16_CP_RUNS = [("cp2", 2, 0, "none", False)]


def activation_ranges(model, ids):
    """max|x| of the residual stream after each decoder layer and of the
    logits, in one forward over `ids` (forward hooks).  Returns (per-layer
    maxima, logits' max, index of the first layer whose output is not
    finite or None)."""
    import torch

    maxima = []

    def hook(_mod, _inp, out):
        maxima.append(out.float().abs().max().item())

    hooks = [layer.register_forward_hook(hook) for layer in model.llama.layers]
    try:
        with torch.no_grad():
            logits = model(ids)
    finally:
        for h in hooks:
            h.remove()
    first_bad = next((i for i, m in enumerate(maxima) if not m < float("inf")), None)
    return maxima, logits.float().abs().max().item(), first_bad


def phase_fp16_serve(smi, cfg, bf16, serving, cp_kw, device="cuda", sizes=None):
    """Llama-2-7B in float16 at full width and depth (seeded weights) on
    the serving main paths, with the bf16 phases' checks: the slice's six
    requests behind POST /generate on the engine's CUDA graphs (K1 once per
    layer per prefill, K2 once per layer per decode step on the decode
    walk, 0 new traces, one replay per step bit for bit against eager,
    logits against the teacher-forced float16 forward), the prefix traffic
    over int8 pages (K4 with a float16 q: every chunk prefill on its
    tensor-core window, every decode step on the walk), lock-step greedy
    `generate` over 4 x 500 tokens + 64 (K6 for the prefill, K2 over the
    caches' page view for the decode steps), and the cp phase's traffic at
    cp 2 (K5).  First, the range of the residual stream through the 32
    layers in float16 (float16 tops out at 65504).  Prints decode tokens/s,
    TTFT, the profiled decode step and peak memory beside the bf16 slice's
    (`bf16`, its serving summary).  `sizes`: {"slice" | "prefix" |
    "generate" | "cp": keyword arguments of that phase} (a rehearsal's
    small shapes; the defaults are the bf16 phases').  Returns (all passed,
    launch counts of every run)."""
    import numpy as np
    import torch

    sizes = sizes or {}
    ok, counts, model, summary = phase_slice(smi, cfg, device=device,
                                             dtype="float16", **serving,
                                             **sizes.get("slice", {}))
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                        size=(1, min(512, serving["max_len"])))
                           .astype(np.int32)).to(device)
    maxima, logit_max, first_bad = activation_ranges(model, ids)
    finite = first_bad is None and logit_max < float("inf")
    ok &= finite
    log("range", f"float16 forward of {ids.shape[1]} tokens: max|residual| "
                 f"after layers 1, 8, 16, 24, 32: "
                 + ", ".join(f"{maxima[i]:.1f}" for i in (0, 7, 15, 23, 31)
                             if i < len(maxima))
                 + f"; largest {max(maxima):.1f} (float16 max 65504), max|logit| "
                 f"{logit_max:.2f}; first non-finite layer "
                 f"{'none' if first_bad is None else first_bad + 1} -> "
                 f"{'ok' if finite else 'FAIL'}")
    if "decode_profile" in summary:
        tps16, _ = _decode_rates(summary)
        tps, _ = _decode_rates(bf16)
        prof16 = summary["decode_profile"] or {}
        prof = bf16.get("decode_profile") or {}

        def fig(d, key, fmt):
            return format(d[key], fmt) if key in d else "not measured"

        log("compare", f"float16 vs bfloat16, the slice's traffic on one card: "
                       f"decode_tokens_per_s {tps16:.2f} vs {tps:.2f}; ttft_p50_ms "
                       f"{summary['ttft_p50_ms']:.3f} vs {bf16['ttft_p50_ms']:.3f}; "
                       f"ttft_p95_ms {summary['ttft_p95_ms']:.3f} vs "
                       f"{bf16['ttft_p95_ms']:.3f}; decode step wall_ms "
                       f"{fig(prof16, 'wall_ms', '.3f')} vs {fig(prof, 'wall_ms', '.3f')}, "
                       f"busy_ms {fig(prof16, 'busy_ms', '.3f')} vs "
                       f"{fig(prof, 'busy_ms', '.3f')}, idle_share "
                       f"{fig(prof16, 'idle_share', '.3f')} vs "
                       f"{fig(prof, 'idle_share', '.3f')}; peak_mem_gib "
                       f"{summary['peak_gib']:.2f} vs {bf16['peak_gib']:.2f} | {smi}")
    runs = [counts]
    _free()
    good, c, _ = _timed("prefix int8", phase_prefix, smi, model, "int8",
                        device=device, **serving, **sizes.get("prefix", {}))
    ok &= good
    runs.append(c)
    _free()
    good, c = _timed("generate", phase_generate, smi, model, device=device,
                     greedy_only=True, **sizes.get("generate", {}))
    ok &= good
    runs.append(c)
    _free()
    good, cs = _timed("cp", phase_cp, smi, model, device=device,
                      runs=FP16_CP_RUNS, **cp_kw, **sizes.get("cp", {}))
    ok &= good
    runs += cs
    del model
    return ok, runs


def _kv_heads(cfg):
    """Llama's kv heads, or GPT's: multi-head, one per query head."""
    return getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)


def _decoder(model):
    """The decoder stack of a causal LM of the port (Llama's or GPT's):
    called with (ids, caches=, pos=), it returns the final hidden states."""
    return model.llama if hasattr(model, "llama") else model.gpt


def _moe_dropped(model):
    """Assignments the MoE layers of `model` dropped in their last forward
    (0 for a model without MoE layers)."""
    layers = model.moe_layers() if hasattr(model, "moe_layers") else []
    return sum(int(m.drop_stats["dropped_tokens"].item()) for m in layers)


def _gen_expect(cfg, dtype, s0, cache_len, steps, traced):
    """The launches of one lock-step call on the card: per layer, K6 for a
    prefill of s0 rows where `takes_dense_decode` takes it, else K2 over
    the cache's page view (on the path `paged_path` picks), and K2 for each
    of the steps - 1 decode steps; a key the call traced runs its step once
    more (the warm run before capture).  `traced`: (prefill traced, decode
    traced)."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import flash_attention as fa

    want = dict.fromkeys(profiler.kernel_launch_counts(), 0)
    layers, d = cfg.num_hidden_layers, cfg.head_dim
    rep = cfg.num_attention_heads // _kv_heads(cfg)

    def add(sq, n):
        if fa.takes_dense_decode(sq, d, cache_len, False):
            want["dense_decode"] += n * layers
            if fa.flash_path(sq, d, dtype) == "wgmma":
                want["dense_decode_wgmma"] += n * layers
            return
        want["paged_decode_fused"] += n * layers
        path = fa.paged_path(rep * sq, d, dtype)
        if path != "fma":
            want[f"paged_decode_fused_{path}"] += n * layers

    add(s0, 1 + traced[0])
    if steps > 1:
        add(1, steps - 1 + traced[1])
    return want


def _gen_run(what, fn, model, key, s0, steps, on_card):
    """One lock-step call of the main path (`steps` tokens after an s0-row
    prompt, through `model._gen_fns[key]`), its launch counts read just
    after it and held to `_gen_expect`'s, exactly: no other kernel, and no
    attention outside K6 and K2.  Returns (output, ok, counts, wall
    seconds, keys traced)."""
    import torch

    from paddle_tpu_torch import profiler

    fns = getattr(model, "_gen_fns", None)
    before = fns[key].trace_count if fns and key in fns else 0
    profiler.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = profiler.kernel_launch_counts()
    traced = model._gen_fns[key].trace_count - (before if model._gen_fns is fns else 0)
    cache_len = model._gen_caches[0].max_len
    want = (_gen_expect(model.config, model.lm_head.weight.dtype, s0, cache_len,
                        steps, (traced >= 1, traced >= 2))
            if on_card else dict.fromkeys(counts, 0))
    ok = counts == want
    log("generate", f"{what}: {wall:.3f} s, {traced} new traces of {key!r}, "
                    f"launches {_main(counts)} (expected {_main(want)}, every "
                    f"other kernel 0) -> {'ok' if ok else 'FAIL'}")
    return out, ok, counts, wall, traced


def _replay_vs_eager(model, key, shape, state=()):
    """One replay of `model._gen_fns[key]` at input shape `shape` beside an
    eager run of its body on the same static inputs; True when bit for bit
    equal."""
    import torch

    replayed, eager = model._gen_fns[key].compare_eager(shape, state)
    same = all(torch.equal(x, y) for x, y in zip(replayed, eager))
    log("generate", f"replay vs eager of {key!r} at {shape}: "
                    f"{'bit-identical' if same else 'DIFFERS'} -> "
                    f"{'ok' if same else 'FAIL'}")
    return same


def phase_generate(smi, model, device="cuda", batch=GEN_BATCH, prompt_len=GEN_LEN,
                   new_tokens=GEN_NEW, beam_len=BEAM_LEN, beam_new=BEAM_NEW,
                   beams=BEAMS, short_len=SHORT_LEN,
                   predictor_lens=PREDICTOR_LENS, greedy_only=False, kept=None):
    """Lock-step generation on `model`, every strategy on its captured
    steps (`model._gen_fns`): greedy over `batch` prompts of `prompt_len`
    tokens, beam search, seeded sampling, a short prompt, each called
    twice: the first call traces the prefill and decode shapes, the second
    traces nothing and gives the same tokens.  Each call's launches are
    read just after it (`_gen_expect`: K6 once per layer for a prefill of
    64+ rows, K2 over the page view for the rest, nothing else); one greedy
    and one beam decode step replay equal to eager bit for bit; prefill and
    one decode step's logits against the teacher-forced forward; then a
    warmed GenerationPredictor behind POST /generate; `greedy_only` stops
    after the greedy calls and their checks.  `model` is a Llama or a GPT;
    for an MoE GPT whose teacher-forced forward dropped assignments (the
    capacity of a longer sequence is shared by more tokens), the decode
    step's logits are printed but not held to the bound.  `kept`, a dict,
    receives the greedy call's output ("greedy") and wall seconds
    ("greedy_s").  Returns (all checks passed, the summed launch counts of
    the calls)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference import GenerationPredictor, serve
    from paddle_tpu_torch.models.llama import StaticKVCache

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(batch, prompt_len))
                           .astype(np.int32)).to(device)
    runs, ok = [], True

    def twice(what, fn, key, s0, steps):
        """Call 1 traces both shapes, call 2 none and repeats its tokens.
        Returns (call 2's output, call 2's wall seconds)."""
        nonlocal ok
        outs = []
        for call in (1, 2):
            out, good, counts, wall, traced = _gen_run(
                f"{what}, call {call}", fn, model, key, s0, steps, on_card)
            ok &= good and traced == (2 if call == 1 else 0)
            runs.append(counts)
            outs.append(out)
        same = torch.equal(outs[0], outs[1])
        ok &= same
        log("generate", f"{what}: call 2 traced nothing and gave call 1's "
                        f"tokens: {same} -> {'ok' if same else 'FAIL'}")
        return outs[1], wall

    out, wall = twice(f"greedy, {batch} x {prompt_len} tokens + {new_tokens}",
                      lambda: model.generate(ids, max_new_tokens=new_tokens),
                      "greedy", prompt_len, new_tokens)
    shape_ok = (tuple(out.shape) == (batch, prompt_len + new_tokens)
                and torch.equal(out[:, :prompt_len], ids)
                and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    ok &= shape_ok
    pool = sum(g.pool_bytes for g in model._gen_fns.values())
    log("generate", f"greedy: shape {tuple(out.shape)}, prompt kept, ids in the "
                    f"vocabulary -> {'ok' if shape_ok else 'FAIL'}; warm call "
                    f"{batch * new_tokens / wall:.2f} generated tokens/s over the "
                    f"call (prefill included"
                    + (f"; eager steps: {GEN_TOKENS_PER_S_WAS}" if hasattr(model, "llama")
                       else "") + f"); graph pool {pool / 2**20:.1f} MiB | {smi}")
    ok &= _replay_vs_eager(model, "greedy", (batch, 1))
    greedy = out
    if kept is not None:
        kept.update(greedy=greedy, greedy_s=wall)

    # -- correctness: prefill and one decode step vs the teacher-forced
    # forward over prompt + the greedy token
    cache_len = -(-(prompt_len + 1) // 128) * 128
    caches = [StaticKVCache(1, cache_len, _kv_heads(cfg), cfg.head_dim,
                            model.lm_head.weight.dtype, model.device)
              for _ in range(layers)]
    seq = greedy[:1, :prompt_len + 1]
    decoder = _decoder(model)
    with torch.no_grad():
        pos0 = torch.zeros((), dtype=torch.int32, device=model.device)
        pf = model.lm_head(decoder(seq[:, :prompt_len], caches=caches,
                                   pos=pos0)[:, -1]).float()
        dec = model.lm_head(decoder(seq[:, prompt_len:], caches=caches,
                                    pos=pos0 + prompt_len)[:, -1]).float()
        ref = model(seq)[0, prompt_len - 1:].float()
        dropped = _moe_dropped(model)
    del caches
    rels = [((x[0] - r).abs().max() / r.abs().max()).item()
            for x, r in ((pf, ref[0]), (dec, ref[1]))]
    finite = bool(torch.isfinite(pf).all() and torch.isfinite(dec).all())
    held = rels if not dropped else rels[:1]
    logits_ok = finite and max(held) <= LOGIT_REL_TOL
    ok &= logits_ok
    log("generate", f"logits vs the teacher-forced forward, max|diff|/max|logit|: "
                    f"prefill {rels[0]:.3e}, decode step {rels[1]:.3e} (tol "
                    f"{LOGIT_REL_TOL}"
                    + (f"; the forward's MoE layers dropped {dropped} assignments, "
                       "so the decode step is not held" if dropped else "")
                    + f"); greedy token {int(seq[0, -1])} == argmax of "
                    f"the forward {int(ref[0].argmax())} -> {'ok' if logits_ok else 'FAIL'}")
    if greedy_only:
        return ok, {name: sum(c[name] for c in runs) for name in runs[0]}

    ids_b = ids[:1, :beam_len].contiguous()
    beam_key = ("beam", beams, None)
    out_b, _ = twice(f"beam search, {beams} beams, {beam_len} tokens + {beam_new}",
                     lambda: model.generate(ids_b, max_new_tokens=beam_new,
                                            num_beams=beams),
                     beam_key, beam_len, beam_new)
    beam_ok = tuple(out_b.shape) == (1, beam_len + beam_new)
    ok &= beam_ok
    # after the last step the step index points past the sequence buffer:
    # replay the last step again (column beam_new - 1), the caches restored
    # between the two runs (the step reorders them in place)
    model._gen_fns[beam_key].inputs(((beams, 1), beam_new))["ti"].fill_(beam_new - 1)
    ok &= _replay_vs_eager(model, beam_key, ((beams, 1), beam_new),
                           [t for c in model._gen_caches for t in (c.k, c.v)])
    sampled, _ = twice(f"sampling {SAMPLING}",
                       lambda: model.generate(ids, max_new_tokens=new_tokens,
                                              **SAMPLING),
                       ("sample", SAMPLING["top_k"], SAMPLING["top_p"]),
                       prompt_len, new_tokens)
    other_seed = dict(SAMPLING, seed=SAMPLING["seed"] + 1)
    o, good, counts, _, _ = _gen_run(
        f"sampling, seed {other_seed['seed']}",
        lambda: model.generate(ids, max_new_tokens=new_tokens, **other_seed),
        model, ("sample", SAMPLING["top_k"], SAMPLING["top_p"]), prompt_len,
        new_tokens, on_card)
    runs.append(counts)
    differ = not torch.equal(o, sampled)
    ok &= good and differ and beam_ok
    log("generate", f"beam output shape {tuple(out_b.shape)} -> "
                    f"{'ok' if beam_ok else 'FAIL'}; seed {other_seed['seed']} "
                    f"differs from seed {SAMPLING['seed']}: {differ}; sampled "
                    f"tokens equal to greedy's "
                    f"{(sampled[:, prompt_len:] == greedy[:, prompt_len:]).float().mean().item():.3f}")
    ids_s = ids[:1, :short_len].contiguous()
    twice(f"greedy, {short_len}-token prompt (below K6's 64 rows: K2's chunk "
          f"window)", lambda: model.generate(ids_s, max_new_tokens=16),
          "greedy", short_len, 16)

    # -- GenerationPredictor behind POST /generate, warmed at the first
    # request's geometry (which then traces nothing)
    pred = GenerationPredictor(model, max_new_tokens=32).warmup(
        prompt_len=predictor_lens[0])
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in predictor_lens]
    server = serve(pred, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    http = []
    try:
        for i, p in enumerate(prompts):
            out, good, counts, _, traced = _gen_run(
                f"POST /generate of {p.size} tokens + 32",
                lambda p=p: _post(url, {"input_ids": p.tolist()})["tokens"],
                model, "greedy", p.size, 32, on_card)
            ok &= good and (traced == 0 if i == 0 else True)
            runs.append(counts)
            http.append(out)
    finally:
        server.stop()
    direct = [pred.generate(p).tolist() for p in prompts]
    http_ok = http == direct
    ok &= http_ok
    log("generate", f"GenerationPredictor behind POST /generate: {len(prompts)} "
                    f"requests of {predictor_lens} tokens + 32; the warmed geometry "
                    f"traced nothing; HTTP tokens == direct tokens: {http_ok} -> "
                    f"{'ok' if http_ok else 'FAIL'}")
    total = {name: sum(c[name] for c in runs) for name in runs[0]}
    return ok, total


def phase_dense(smi, model, paged_summary, device="cuda", prompts_spec=SLICE_PROMPTS,
                **engine_kw):
    """The dense slot-pool engine (`paged=False`) on `model` behind POST
    /generate with the slice's traffic: token counts, launches (K1 once per
    layer per prefill, K2 over the pool's page view once per layer per
    decode step, nothing else), logits against the teacher-forced forward,
    decode tokens/s, TTFT and the graph pool beside the paged slice's
    `paged_summary`, then a profiled decode step (wall, busy, idle, kernels
    per step).  Returns (all checks passed, launch counts)."""
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
    warm = _warm_counts("dense", engine)
    pool = 2 * layers * engine._caches[0].k.numel() * engine._caches[0].k.element_size()
    log("dense", f"dense slot pool {engine.slots} slots x {engine.max_len} rows = "
                 f"{pool / 2**30:.2f} GiB, built + warmed in "
                 f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)  # the slice's prompts
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]
    profiler.reset_kernel_launch_counts()
    profiler.reset_serving()
    replays = engine._decode_g.replay_count
    results, wall = _serve_batches(
        engine, [[(p, new) for p, (_, new) in zip(prompts, prompts_spec)]])
    counts = profiler.kernel_launch_counts()
    decode_steps = engine._decode_g.replay_count - replays
    summary = profiler.serving_summary()
    graphs_ok = _no_retrace("dense", engine, warm)
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
    # every decode step attends each layer's pool through K2 over its page
    # view (one row per slot: the decode walk in bf16)
    path = fa.paged_path(cfg.num_attention_heads // cfg.num_key_value_heads,
                         cfg.head_dim, model.lm_head.weight.dtype)
    want["paged_decode_fused"] = decode_steps * layers if on_card else 0
    if path != "fma":
        want[f"paged_decode_fused_{path}"] = want["paged_decode_fused"]
    counts_ok = counts == want and decode_steps > 0
    ok = tokens_ok and counts_ok and graphs_ok
    log("dense", f"served {len(prompts)} requests over HTTP in {wall:.3f} s: token "
                 f"counts {'ok' if tokens_ok else 'WRONG'}; launches {_main(counts)} "
                 f"(expected flash_fwd {want['flash_fwd']} = {len(prompts)} "
                 f"prefills x {layers} layers, paged_decode_fused "
                 f"{want['paged_decode_fused']} = {decode_steps} decode steps x "
                 f"{layers} layers over the page view ({path}), every other "
                 f"kernel 0) -> {'ok' if counts_ok else 'FAIL'}")

    def rates(sm):
        return _decode_rates(sm)[0], sm["ttft_p50_ms"], sm["ttft_p95_ms"]

    d_tps, d_p50, d_p95 = rates(summary)
    p_tps, p_p50, p_p95 = rates(paged_summary)
    log("dense", f"decode_tokens_per_s over the decode window dense {d_tps:.2f} "
                 f"(on the float32 dense math: {DENSE_TOKENS_PER_S_WAS}) | paged "
                 f"slice {p_tps:.2f}; graph pool "
                 f"{engine.graph_pool_bytes() / 2**20:.1f} MiB (on the dense math: "
                 f"{DENSE_GRAPH_POOL_MIB_WAS}); host fetches per decode step "
                 f"{_decode_rates(summary)[1]:.3f}; "
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
    ok &= check_replay("dense", engine, [
        rng.integers(1, cfg.vocab_size, size=min(100, engine.max_len // 4))
        .astype(np.int32)])
    if on_card:
        profile_decode(engine, cfg, rng)
    return ok, counts


class _FaultRun:
    """Bookkeeping of the fault phase over one engine: every landing
    (slot, request) and every terminal transition, counted per request by
    wrapping the engine's `_land_locked` and `_resolve`."""

    def __init__(self, engine):
        self.engine = engine
        self.landed = []  # (slot, request id)
        self.resolved = {}  # request id -> terminal transitions
        land, resolve = engine._land_locked, engine._resolve

        def land_spy(s, req, tok, logits):
            self.landed.append((s, req.id))
            return land(s, req, tok, logits)

        def resolve_spy(req, reason):
            if not req.finished.is_set():
                self.resolved[req.id] = self.resolved.get(req.id, 0) + 1
            return resolve(req, reason)

        engine._land_locked, engine._resolve = land_spy, resolve_spy
        self.reqs = []

    def submit(self, prompt, new, **kw):
        r = self.engine.submit(prompt, max_new_tokens=new, **kw)
        self.reqs.append(r)
        return r

    def finish(self, reqs, timeout=300):
        """Wait for `reqs` (bounded); {request: tokens or the error}."""
        out = {}
        for r in reqs:
            try:
                out[r] = r.wait(timeout)[r.prompt.size:]
            except Exception as e:  # a typed fault, checked by the caller
                out[r] = e
        return out

    def exactly_once(self):
        return (all(self.resolved.get(r.id) == 1 for r in self.reqs)
                and all(r.finished.is_set() for r in self.reqs))


def _first_token_times(reqs):
    """on_token callbacks stamping each request's first token (monotonic
    clock) into a dict by request index."""
    first = {}

    def stamp(i):
        def on_token(tok):
            first.setdefault(i, time.monotonic())
        return on_token

    return first, [stamp(i) for i in range(len(reqs))]


def phase_fault(smi, model, device="cuda", prompts_spec=SLICE_PROMPTS,
                step_timeout=FAULT_STEP_TIMEOUT_S, hang_s=FAULT_HANG_S,
                evict_deadline=FAULT_EVICT_DEADLINE_S, evict_new=FAULT_EVICT_NEW,
                **engine_kw):
    """The serving fault domain on `model` (the slice's, full width) behind
    a warmed paged engine with the prefix cache off (every pass prefills
    afresh, so a pass's greedy tokens are the unfaulted pass's bit for
    bit):

    0. the unfaulted pass: the slice's six requests over POST /generate
       under `serve(supervise=True)` with the watchdog armed (the main
       path: K1 per prefill, K2 per decode step, counted), its decode
       tokens/s, then a profiled decode step;
    1. deadline eviction: a request of `evict_new` tokens with a deadline
       of `evict_deadline` s beside the six and a filler ends in
       DeadlineExceeded with tokens done, a queued request takes its slot,
       the six keep their tokens; the lag from deadline to resolve;
    2. cancel: a queued request and a slotted one;
    3. prefill hang under EngineSupervisor: one restart, the six keep their
       tokens, no new trace; the hung thread wakes after the restart and
       no replay of it lands (replay and launch counts unchanged); the ms
       from the watchdog's trip to the first token after the restart;
    4. NaN poison: exactly one request NonFiniteLogits, the others keep
       their tokens, the poison input all-False again on the card;
    5. loop crash: the supervisor restarts the thread;
    6. the restart budget: past it, fail_all resolves every request as
       EngineRestarted (then the engine is restored);
    7. an unattainable deadline: DeadlineUnattainable with retry_after_s;
    8. HTTP drain: in-flight POSTs finish, a new POST answers 503 with
       Retry-After, /healthz reads draining.

    Every request of the phase resolves exactly once.  Returns (all
    checks passed, launch counts of the unfaulted pass)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.fault import EngineSupervisor, injection as finj
    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.inference.engine import (
        ContinuousBatchingEngine,
        DeadlineExceeded,
        DeadlineUnattainable,
        EngineRestarted,
        NonFiniteLogits,
        RequestCancelled,
    )

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(model, seed=0, device=device,
                                      prefix_cache=False, **engine_kw)
    engine.warmup()
    warm = _warm_counts("fault", engine)
    log("fault", f"engine built + warmed in {time.perf_counter() - t0:.1f} s "
                 f"(prefix cache off)")
    rng = np.random.default_rng(0)  # the slice's prompts
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]
    news = [new for _, new in prompts_spec]
    fcore.set_flags({"FLAGS_serve_step_timeout_sec": step_timeout,
                     "FLAGS_fault_hang_sec": hang_s})
    run = _FaultRun(engine)
    ok = True

    def check(what, cond, detail=""):
        nonlocal ok
        ok &= bool(cond)
        log("fault", f"{what}: {detail} -> {'ok' if cond else 'FAIL'}")

    def same(outs, reqs):
        return all(isinstance(outs[r], np.ndarray) and np.array_equal(outs[r], b)
                   for r, b in zip(reqs, base))

    def extra(n, new, seed):
        """A prompt of n tokens (at most a quarter of the context) and its
        new tokens (at most half)."""
        n, new = min(n, engine.max_len // 4), min(new, engine.max_len // 2)
        return np.random.default_rng(seed).integers(
            1, cfg.vocab_size, size=n).astype(np.int32), new

    try:
        # -- 0. the unfaulted pass over HTTP: the main path -------------------
        profiler.reset_kernel_launch_counts()
        profiler.reset_serving()
        replays = engine._decode_g.replay_count
        server = serve(engine, port=0, block=False, supervise=True,
                       handle_signals=False)
        url = f"http://127.0.0.1:{server.server_address[1]}/generate"
        got = [None] * len(prompts)

        def client(i):
            got[i] = _post(url, {"input_ids": prompts[i].tolist(),
                                 "max_new_tokens": news[i]})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        finally:
            server.stop()
        counts = profiler.kernel_launch_counts()
        decode_steps = engine._decode_g.replay_count - replays
        summary = profiler.serving_summary()
        base = [np.asarray(g["tokens"][p.size:], np.int32) if g else None
                for g, p in zip(got, prompts)]
        tokens_ok = all(b is not None and b.size == n
                        for b, n in zip(base, news))
        want_k1 = len(prompts) * layers if on_card else 0
        want_k2 = decode_steps * layers if on_card else 0
        counts_ok = (counts["flash_fwd"] == want_k1 and decode_steps > 0
                     and counts["paged_decode_fused"] == want_k2)
        check("unfaulted pass over POST /generate", tokens_ok and counts_ok,
              f"token counts {'ok' if tokens_ok else 'WRONG'}, launches "
              f"{_main(counts)} (expected flash_fwd {want_k1}, "
              f"paged_decode_fused {want_k2} = {decode_steps} decode steps x "
              f"{layers} layers)")
        tps, _ = _decode_rates(summary)
        step_ms = summary["decode_window_s"] / max(1, summary["decode_steps"]) * 1e3
        log("fault", f"decode_tokens_per_s {tps:.2f} (PR 12's slice: "
                     f"{SLICE_DECODE_TPS_WAS}); decode window per step "
                     f"{step_ms:.3f} ms; EWMA step time from the flushes "
                     f"{(engine._step_ewma_s or 0) * 1e3:.3f} ms (the dispatch "
                     f"time per step {summary['decode_busy_s'] / max(1, summary['decode_steps']) * 1e3:.3f} ms); "
                     f"the watchdog armed at {step_timeout} s, under "
                     f"EngineSupervisor | {smi}")
        if on_card:
            log("fault", f"profiled decode step below (PR 12's slice: wall "
                         f"{SLICE_DECODE_STEP_MS_WAS} ms)")
            profile_decode(engine, cfg, rng)
        ok &= _no_retrace("fault", engine, warm)

        engine.start()
        sup = EngineSupervisor(engine, poll_interval=0.02, max_restarts=8,
                               backoff=0.0).start()

        # -- 1. deadline eviction at step granularity -------------------------
        victim = run.submit(*extra(100, evict_new, 101),
                            deadline_s=evict_deadline)
        reqs = [run.submit(p, n) for p, n in zip(prompts, news)]
        filler = run.submit(*extra(60, 64, 102))
        queued = run.submit(*extra(90, 32, 103))
        outs = run.finish([victim, *reqs, filler, queued])
        err = outs[victim]
        v_slot = [s for s, rid in run.landed if rid == victim.id]
        took = [s for s, rid in run.landed if rid == queued.id]
        evicted = (isinstance(err, DeadlineExceeded) and err.tokens_done > 0
                   and victim.finish_reason == "timeout")
        check("deadline eviction", evicted and same(outs, reqs)
              and v_slot == took and isinstance(outs[queued], np.ndarray),
              f"{type(err).__name__} tokens_done "
              f"{getattr(err, 'tokens_done', None)} of {victim.max_new_tokens}, the queued "
              f"request took slot {took} (the victim's {v_slot}), co-batched "
              f"tokens equal the unfaulted pass's: {same(outs, reqs)}")
        lag = (victim._finish_t - victim._deadline_t) * 1e3
        log("fault", f"eviction lag from deadline to resolve {lag:.3f} ms | {smi}")

        # -- 2. cancel: a queued request and a slotted one --------------------
        first, stamps = _first_token_times([0])
        slotted = run.submit(*extra(70, 512, 104), on_token=stamps[0])
        reqs = [run.submit(p, n) for p, n in zip(prompts, news)]
        fill = run.submit(*extra(50, 64, 105))
        waiting = run.submit(*extra(40, 16, 106)).cancel()
        t_end = time.monotonic() + 120
        while len(slotted.tokens) < 2 and time.monotonic() < t_end:
            time.sleep(0.002)
        slotted.cancel()
        outs = run.finish([slotted, waiting, *reqs, fill])
        e_s, e_w = outs[slotted], outs[waiting]
        check("cancel", isinstance(e_s, RequestCancelled) and e_s.tokens_done >= 2
              and isinstance(e_w, RequestCancelled) and e_w.tokens_done == 0
              and waiting.id not in [rid for _, rid in run.landed]
              and same(outs, reqs),
              f"slotted: {type(e_s).__name__} tokens_done "
              f"{getattr(e_s, 'tokens_done', None)}; queued: {type(e_w).__name__} "
              f"tokens_done {getattr(e_w, 'tokens_done', None)}, never landed; "
              f"co-batched tokens equal: {same(outs, reqs)}")

        # -- 3. prefill hang -> watchdog -> one warm restart ------------------
        restarts = engine.restart_count
        hung_thread = engine._thread
        finj.arm("serve.prefill.hang:1")
        first, stamps = _first_token_times(prompts)
        reqs = [run.submit(p, n, on_token=f)
                for p, n, f in zip(prompts, news, stamps)]
        outs = run.finish(reqs)
        graphs = engine.step_graphs().values()
        replayed = sum(g.replay_count for g in graphs)
        launched = profiler.kernel_launch_counts()
        hung_thread.join(hang_s + 30)  # wakes, meets the fence, ends
        fenced = (not hung_thread.is_alive()
                  and sum(g.replay_count for g in graphs) == replayed
                  and profiler.kernel_launch_counts() == launched)
        events = finj.recent_events()
        trip = [e["t"] for e in events if e["kind"] == "watchdog"]
        restart_t = [e["t"] for e in events if e["kind"] == "engine"
                     and "restart #" in e["detail"]]
        after = [t for t in first.values() if restart_t and t > restart_t[-1]]
        traced = engine.compile_counts() == warm
        check("prefill hang", engine.restart_count == restarts + 1
              and same(outs, reqs) and traced and fenced,
              f"restarts {engine.restart_count - restarts} (expected 1), tokens "
              f"equal the unfaulted pass's: {same(outs, reqs)}, compile_counts "
              f"unchanged: {traced}, the hung thread ended without a replay "
              f"(replays {replayed}, launches unchanged): {fenced}")
        if trip and after:
            log("fault", f"restart latency from the watchdog's trip to the first "
                         f"token after the restart {(min(after) - trip[-1]) * 1e3:.3f} "
                         f"ms (trip at {step_timeout} s into the hang) | {smi}")
        else:
            check("restart latency", False, "no trip or no token after the restart")

        # -- 4. NaN poison of one slot ----------------------------------------
        finj.arm("serve.decode.nan:1")
        reqs = [run.submit(p, n) for p, n in zip(prompts, news)]
        outs = run.finish(reqs)
        bad = [r for r in reqs if isinstance(outs[r], NonFiniteLogits)]
        rest = [(r, b) for r, b in zip(reqs, base) if r not in bad]
        kept = all(isinstance(outs[r], np.ndarray) and np.array_equal(outs[r], b)
                   for r, b in rest)
        reset = not bool(engine._decode_g.inputs(None)["poison"].any())
        check("NaN poison", len(bad) == 1 and kept and reset,
              f"{len(bad)} request NonFiniteLogits (expected 1), the other "
              f"{len(rest)} equal the unfaulted pass's: {kept}, poison input "
              f"all-False after the step: {reset}")

        # -- 5. loop crash -> the supervisor restarts the thread -------------
        restarts = engine.restart_count
        finj.arm("serve.loop.crash:1")
        reqs = [run.submit(p, n) for p, n in zip(prompts, news)]
        outs = run.finish(reqs)
        check("loop crash", engine.restart_count == restarts + 1
              and same(outs, reqs),
              f"restarts {engine.restart_count - restarts} (expected 1), tokens "
              f"equal: {same(outs, reqs)}")
        sup.stop()

        # -- 6. the restart budget, then fail_all ----------------------------
        budget = EngineSupervisor(engine, poll_interval=0.02, max_restarts=1,
                                  backoff=0.0)
        restarts = engine.restart_count
        finj.arm("serve.loop.crash:*")
        budget.start()
        reqs = [run.submit(p, n) for p, n in zip(prompts, news)]
        outs = run.finish(reqs)
        budget.stop()
        finj.disarm()
        failed = all(isinstance(outs[r], EngineRestarted)
                     and r.finish_reason == "restarted" for r in reqs)
        check("restart budget", budget.dead and failed
              and engine.restart_count == restarts + 1
              and engine.healthz()["status"] == "dead",
              f"supervisor dead {budget.dead} after {engine.restart_count - restarts} "
              f"restart, every request EngineRestarted: {failed}")
        engine._dead = False  # restore the engine for the checks below
        engine.start()

        # -- 7. a deadline below the drain estimate --------------------------
        reqs = [run.submit(p, n) for p, n in zip(prompts, news)]
        est = engine.estimate_drain_s()
        try:
            engine.submit(prompts[0], max_new_tokens=8, deadline_s=est / 2)
            refused = None
        except DeadlineUnattainable as e:
            refused = e
        outs = run.finish(reqs)
        check("unattainable deadline", refused is not None and est > 0
              and refused.retry_after_s > est / 2 and same(outs, reqs),
              f"deadline {est / 2:.4f} s under the estimate {est:.4f} s: "
              f"{type(refused).__name__} retry_after_s "
              f"{getattr(refused, 'retry_after_s', None)}")
        engine.stop()

        # -- 8. HTTP drain ----------------------------------------------------
        server = serve(engine, port=0, block=False, supervise=True,
                       handle_signals=False)
        port = server.server_address[1]
        url = f"http://127.0.0.1:{port}/generate"
        got = [None] * len(prompts)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        try:
            for t in threads:
                t.start()
            t_end = time.monotonic() + 120
            while engine.active_slots < len(prompts) and time.monotonic() < t_end:
                time.sleep(0.002)
            drain = server.drain(grace=300)
            shed = _post_full(url, {"input_ids": prompts[0].tolist(),
                                    "max_new_tokens": 4})
            health = _get_full(f"http://127.0.0.1:{port}/healthz")
            for t in threads:
                t.join(600)
            drain.join(600)
        finally:
            server.stop()
        finished = all(g is not None and np.array_equal(
            np.asarray(g["tokens"][p.size:], np.int32), b)
            for g, p, b in zip(got, prompts, base))
        check("HTTP drain", finished and shed[0] == 503
              and shed[1].get("Retry-After") is not None
              and health[0] == 503 and health[1]["status"] == "draining",
              f"in-flight POSTs finished with the unfaulted tokens: {finished}; "
              f"a new POST answered {shed[0]} {shed[2].get('type')} Retry-After "
              f"{shed[1].get('Retry-After')}; /healthz {health[0]} "
              f"{health[1].get('status')}")
        check("exactly once", run.exactly_once(),
              f"{len(run.reqs)} requests, each resolved once")
        ok &= _no_retrace("fault", engine, warm)
    finally:
        finj.disarm()
        fcore.set_flags({"FLAGS_serve_step_timeout_sec": 0.0,
                         "FLAGS_fault_hang_sec": 3600.0})
        engine.stop()
    return ok, counts


def _obs_samples(text):
    """{name{labels}: value} of a /metrics scrape (every sample parses) and
    the metric names of its TYPE lines, in order."""
    samples, names = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            names.append(line.split()[2])
        elif line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            samples[key] = float(val)
    return samples, names


def _obs_metric(samples, name, **labels):
    """One sample's value; labels besides the replica's, by name."""
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    for key, val in samples.items():
        if key.startswith(name + "{") and (not want or want in key):
            return val
    raise KeyError(f"{name} {labels} not in the scrape")


def _profile_decode_kernels(engine, cfg, rng, trace=None, prompt_len=256, steps=8):
    """`profile_decode` with each request's trace context: returns (kernels
    per decode step, wall ms per step, idle share) and prints the profile."""
    reqs = [engine.submit(rng.integers(1, cfg.vocab_size, size=prompt_len),
                          max_new_tokens=steps + 4, trace=trace)
            for _ in range(engine.slots)]
    engine.step()
    engine.step()
    wall_us, kernels, spans, stats = _device_profile(engine.step, steps)
    engine.run_until_idle()
    for r in reqs:
        r.wait(1)
    _log_profile(f"decode step, {engine.slots} slots at ~{prompt_len} tokens, "
                 f"trace {'on' if trace else 'off'}", wall_us, kernels, spans,
                 steps, stats=stats)
    busy = sum(kernels.values())
    return (stats["kernels"] / steps, wall_us / steps / 1e3,
            1 - busy / wall_us if wall_us > 0 else 0.0)


def phase_obs(smi, model, device="cuda", prompts_spec=SLICE_PROMPTS,
              step_timeout=FAULT_STEP_TIMEOUT_S, hang_s=FAULT_HANG_S,
              **engine_kw):
    """The observability spine on `model` (the slice's, full width) behind a
    warmed paged engine with the prefix cache off (so a pass's greedy tokens
    repeat bit for bit), under `serve(supervise=True)`.  Each pass posts
    the slice's six requests to /generate while the scheduler is held, then
    lets it go, so every pass admits all six in its first step and runs the
    same decode steps and fetches:

    1. trace off: the tokens, decode tokens/s, host fetches per decode
       step, compile_counts();
    2. trace on (FLAGS_trace), each request with a client X-Trace-Id and
       X-Parent-Span: the same tokens bit for bit, no new trace, the same
       host fetches per step, every reply echoing its id, and each
       /trace/<id> one serve.handle root under the client's span with
       engine.queue, engine.prefill, engine.decode and engine.fetch below.
       This pass is the main path: the launch counts are set to 0 before
       it and read after it (K1 six prefills x layers, K2 decode steps x
       layers).  Then three more passes each way (`OBS_PASSES`), each with
       the same tokens, steps and fetches: decode tokens/s with trace off
       and on (four passes each, interleaved), each pass's host ms per
       decode step and the garbage collector's passes;
    3. /metrics scraped before and after step 2: every line parses, the
       name set is `obs.metrics.METRIC_NAMES`, requests_total moves by 6 and
       tokens_total by the tokens served, the per-compiled-shape dispatch
       counts of flash_fwd and paged_decode_fused are > 0 and do not move
       (nothing traced), every fallback count is 0;
    4. flight: a prefill hang past the watchdog's deadline under the
       supervisor, PADDLE_OBS_DIR set: a `watchdog-serve.prefill` dump whose
       header parses and whose events hold the injected hang and the
       watchdog's trip, then an `engine-restart-1` dump, and the six
       requests give step 1's tokens;
    5. profiled decode windows with trace off, then on: the same kernels
       per step (the largest count of each setting over up to
       OBS_PROFILE_WINDOWS windows); their wall and idle share.

    Returns (all checks passed, the launch counts of step 2)."""
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.fault import injection as finj
    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.obs import flight, metrics, trace

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(model, seed=0, device=device,
                                      prefix_cache=False, **engine_kw)
    engine.warmup()
    warm = _warm_counts("obs", engine)
    log("obs", f"engine built + warmed in {time.perf_counter() - t0:.1f} s "
               f"(prefix cache off)")
    rng = np.random.default_rng(0)  # the slice's prompts
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]
    news = [new for _, new in prompts_spec]
    ok = True

    def check(what, cond, detail=""):
        nonlocal ok
        ok &= bool(cond)
        log("obs", f"{what}: {detail} -> {'ok' if cond else 'FAIL'}")

    server = serve(engine, port=0, block=False, supervise=True,
                   handle_signals=False)
    base_url = f"http://127.0.0.1:{server.server_address[1]}"

    def scrape():
        with urllib.request.urlopen(base_url + "/metrics", timeout=60) as resp:
            return _obs_samples(resp.read().decode())

    def serve_pass(traced, scrapes=None, notes=None):
        """The six requests, admitted together, with the launch counts and
        the serving gauges set to 0 first; `scrapes` (a list) gets /metrics
        just before the traffic and just after it, `notes` (a list) the
        pass's host ms per decode step (dispatch to record) and the Python
        garbage collector's passes and ms.  Returns (generated tokens,
        reply headers, client trace ids, decode steps, serving summary,
        launch counts); the scheduler is left stopped, every step of the
        pass recorded."""
        tids = [trace.new_trace_id() for _ in prompts]
        got = [None] * len(prompts)
        step_ms, gc_ms, gc_runs, gc_t0 = [], [0.0], [0, 0, 0], [0.0]
        record_tick = profiler.record_serving_tick

        def tick(occupancy, queue_depth, busy_s, t0=None):
            step_ms.append(busy_s * 1e3)
            record_tick(occupancy, queue_depth, busy_s, t0=t0)

        def on_gc(phase, info):
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            else:
                gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3
                gc_runs[info["generation"]] += 1

        def client(i):
            headers = ({trace.HDR_TRACE: tids[i], trace.HDR_PARENT: OBS_CLIENT_SPAN}
                       if traced else None)
            got[i] = _post_full(base_url + "/generate",
                                {"input_ids": prompts[i].tolist(),
                                 "max_new_tokens": news[i]}, headers)

        engine.stop()  # hold the scheduler while the six queue
        profiler.reset_kernel_launch_counts()
        profiler.reset_serving()
        if scrapes is not None:
            scrapes.append(scrape())
        replays = engine._decode_g.replay_count
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        t_end = time.monotonic() + 120
        while engine.pending < len(prompts) and time.monotonic() < t_end:
            time.sleep(0.002)
        profiler.record_serving_tick = tick
        gc.callbacks.append(on_gc)
        try:
            engine.start()
            for t in threads:
                t.join(600)
            # the last step records after its flush resolved the requests
            engine.stop()
        finally:
            profiler.record_serving_tick = record_tick
            gc.callbacks.remove(on_gc)
        if any(t.is_alive() for t in threads) or None in got:
            raise RuntimeError("obs: a /generate request did not complete")
        if notes is not None:
            notes.append((step_ms, gc_runs, gc_ms[0]))
        counts = profiler.kernel_launch_counts()
        if scrapes is not None:
            scrapes.append(scrape())
        toks = [np.asarray(b["tokens"][p.size:], np.int32) if s == 200 else None
                for (s, _, b), p in zip(got, prompts)]
        return (toks, [h for _, h, _ in got], tids,
                engine._decode_g.replay_count - replays,
                profiler.serving_summary(), counts)

    def tree_of(tid):
        """/trace/<tid> once its serve.handle span (recorded after the
        reply's bytes are out) is in; bounded."""
        t_end = time.monotonic() + 30
        while True:
            status, doc = _get_full(f"{base_url}/trace/{tid}")
            if status == 200 and any(r["name"] == "serve.handle"
                                     for r in doc["spans"]):
                return doc["spans"]
            if time.monotonic() > t_end:
                return doc.get("spans", [])
            time.sleep(0.01)

    (ROOT / "build").mkdir(exist_ok=True)
    obs_dir = tempfile.mkdtemp(prefix="obs_flight_", dir=ROOT / "build")
    old_obs_dir = os.environ.get("PADDLE_OBS_DIR")
    counts = {}
    try:
        # -- 1. trace off --------------------------------------------------
        fcore.set_flags({"FLAGS_trace": False})
        notes = {False: [], True: []}
        base, _, _, steps_off, sum_off, _ = serve_pass(False, notes=notes[False])
        tps_off, fetch_off = _decode_rates(sum_off)
        tokens_ok = all(b is not None and b.size == n for b, n in zip(base, news))
        check("trace off: six requests over POST /generate", tokens_ok,
              f"{steps_off} decode steps, host fetches per decode step "
              f"{fetch_off:.4f}, decode_tokens_per_s {tps_off:.2f}")
        ok &= _no_retrace("obs", engine, warm)

        # -- 2. trace on, with client trace context, and 3. /metrics --------
        fcore.set_flags({"FLAGS_trace": True})
        trace.reset()
        recorded = trace.stats()["spans_recorded"]
        scrapes = []
        toks, hdrs, tids, steps_on, sum_on, counts = serve_pass(True, scrapes,
                                                                notes[True])
        (before, names_before), (after, names_after) = scrapes
        tps_on, fetch_on = _decode_rates(sum_on)
        same = all(t is not None and np.array_equal(t, b) for t, b in zip(toks, base))
        check("trace on: the same tokens bit for bit", same,
              f"{sum(t is not None and np.array_equal(t, b) for t, b in zip(toks, base))}"
              f"/{len(base)} requests equal")
        check("trace on: no new trace, the same fetches per step",
              engine.compile_counts() == warm and fetch_on == fetch_off
              and steps_on == steps_off,
              f"compile_counts {engine.compile_counts()}, host fetches per "
              f"decode step {fetch_on:.4f} (off {fetch_off:.4f}), decode steps "
              f"{steps_on} (off {steps_off})")
        echoed = all(h.get(trace.HDR_TRACE) == t for h, t in zip(hdrs, tids))
        check("every reply echoes its X-Trace-Id", echoed, f"{len(tids)} replies")
        want = {"engine.queue", "engine.prefill", "engine.decode", "engine.fetch"}
        shapes = []
        for tid in tids:
            roots = tree_of(tid)
            kids = {c["name"] for r in roots for c in r["children"]}
            shapes.append(len(roots) == 1 and roots[0]["name"] == "serve.handle"
                          and roots[0]["parent_id"] == OBS_CLIENT_SPAN
                          and want <= kids)
        check("each /trace/<id>: one serve.handle under the client's span, "
              "engine.queue/prefill/decode/fetch below", all(shapes),
              f"{sum(shapes)}/{len(tids)} trees; spans recorded "
              f"{trace.stats()['spans_recorded'] - recorded}, dropped "
              f"{trace.stats()['spans_dropped']}")
        # four passes each way in the order off, on | on, off, off, on, on,
        # off, so that a drift over the phase cancels
        rates = {False: [tps_off], True: [tps_on]}
        for traced in OBS_PASSES:
            fcore.set_flags({"FLAGS_trace": traced})
            more, _, _, steps, summary, _ = serve_pass(traced, notes=notes[traced])
            rate, fetch = _decode_rates(summary)
            rates[traced].append(rate)
            check(f"trace {'on' if traced else 'off'} again: the same tokens, "
                  f"steps and fetches",
                  all(t is not None and np.array_equal(t, b)
                      for t, b in zip(more, base))
                  and steps == steps_off and fetch == fetch_off,
                  f"decode steps {steps}, host fetches per step {fetch:.4f}")
        fcore.set_flags({"FLAGS_trace": True})
        for traced in (False, True):
            for i, (ms, runs, gms) in enumerate(notes[traced]):
                ms = sorted(ms)
                log("obs", f"trace {'on' if traced else 'off'} pass {i + 1}: "
                           f"decode_tokens_per_s {rates[traced][i]:.2f}; the host's "
                           f"ms per decode step (dispatch to record) median "
                           f"{statistics.median(ms):.3f}, p90 "
                           f"{ms[int(0.9 * (len(ms) - 1))]:.3f}, max {ms[-1]:.3f}; "
                           f"gc passes by generation {runs}, {gms:.3f} ms")
        off, on = (statistics.mean(rates[k]) for k in (False, True))
        log("obs", f"decode_tokens_per_s means over {len(rates[False])} passes "
                   f"each: trace off {off:.2f}, on {on:.2f} "
                   f"({on / max(off, 1e-9) - 1:+.4f}); host fetches per decode "
                   f"step off {fetch_off:.4f}, on {fetch_on:.4f} | {smi}")
        want_k1 = len(prompts) * layers if on_card else 0
        want_k2 = steps_on * layers if on_card else 0
        check("launch counts of the traced pass",
              counts["flash_fwd"] == want_k1 and counts["paged_decode_fused"] == want_k2
              and steps_on > 0,
              f"{_main(counts)} (expected flash_fwd {want_k1} = 6 prefills x "
              f"{layers} layers, paged_decode_fused {want_k2} = {steps_on} decode "
              f"steps x {layers} layers)")
        served = sum(int(t.size) for t in toks if t is not None)
        moved_req = (_obs_metric(after, "paddle_serving_requests_total")
                     - _obs_metric(before, "paddle_serving_requests_total"))
        moved_tok = (_obs_metric(after, "paddle_serving_tokens_total")
                     - _obs_metric(before, "paddle_serving_tokens_total"))
        check("/metrics: names and serving counters",
              names_before == names_after == list(metrics.METRIC_NAMES)
              and moved_req == len(prompts) and moved_tok == served,
              f"{len(names_after)} names (the kept list's {len(metrics.METRIC_NAMES)}), "
              f"{len(after)} samples; requests_total moved {moved_req:g} (expected "
              f"{len(prompts)}), tokens_total {moved_tok:g} (expected {served})")
        pallas = {k: (_obs_metric(before, "paddle_flash_pallas_calls_total", kernel=k),
                      _obs_metric(after, "paddle_flash_pallas_calls_total", kernel=k))
                  for k in ("flash_fwd", "paged_decode_fused")}
        fallbacks = [v for k, v in after.items()
                     if k.startswith("paddle_flash_fallbacks_total")]
        pallas_ok = all(a == b and (a > 0 or not on_card) for b, a in pallas.values())
        check("/metrics: kernel dispatches per compiled shape, no fallback",
              pallas_ok and len(fallbacks) == 9 and not any(fallbacks),
              f"flash_fwd {pallas['flash_fwd'][1]:g}, paged_decode_fused "
              f"{pallas['paged_decode_fused'][1]:g} (warmup's traces; unchanged "
              f"by the traffic, which traced nothing); {len(fallbacks)} fallback "
              f"reasons, all 0: {not any(fallbacks)}")
        log("obs", f"obs buffers: spans recorded "
                   f"{_obs_metric(after, 'paddle_obs_spans_recorded_total'):g}, "
                   f"buffered {_obs_metric(after, 'paddle_obs_spans_buffered'):g}, "
                   f"dropped {_obs_metric(after, 'paddle_obs_spans_dropped_total'):g}; "
                   f"flight events {_obs_metric(after, 'paddle_flight_events_total'):g}")

        # -- 4. flight: a watchdog trip and the supervisor's restart --------
        os.environ["PADDLE_OBS_DIR"] = obs_dir
        fcore.set_flags({"FLAGS_serve_step_timeout_sec": step_timeout,
                         "FLAGS_fault_hang_sec": hang_s})
        restarts = engine.restart_count
        finj.arm("serve.prefill.hang:1")
        toks, _, _, _, _, _ = serve_pass(True)
        finj.disarm()
        dumps = {}
        for path in sorted(pathlib.Path(obs_dir).glob("flight-*.jsonl")):
            lines = [json.loads(l) for l in path.read_text().splitlines()]
            dumps[lines[0]["reason"]] = (path.name, lines[0], lines[1:])
        trip = dumps.get("watchdog-serve.prefill")
        kinds = {e["kind"] for e in trip[2]} if trip else set()
        order = sorted(dumps, key=lambda r: dumps[r][0])
        check("flight: watchdog dump, then the restart's",
              trip is not None and trip[1]["kind"] == "header"
              and {"hang", "watchdog"} <= kinds
              and "serve.prefill" in trip[1]["armed"]
              and order[:2] == ["watchdog-serve.prefill", "engine-restart-1"]
              and engine.restart_count == restarts + 1,
              f"dumps {[dumps[r][0] for r in order]}; the trip's header "
              f"{sorted(trip[1]) if trip else None}, its ring's kinds "
              f"{sorted(kinds)}; restarts {engine.restart_count - restarts}")
        same = all(t is not None and np.array_equal(t, b) for t, b in zip(toks, base))
        check("flight: the six requests after the restart", same,
              "tokens equal trace off's")

        # -- 5. profiled decode windows, trace off then on, after every
        # timed pass ---------------------------------------------------------
        fcore.set_flags({"FLAGS_serve_step_timeout_sec": 0.0,
                         "FLAGS_fault_hang_sec": 3600.0})
        if on_card:
            engine.stop()  # the profiles drive the steps themselves
            offs, ons = [], []
            while len(offs) < OBS_PROFILE_WINDOWS and (
                    not offs or max(k for k, *_ in ons) != max(k for k, *_ in offs)):
                fcore.set_flags({"FLAGS_trace": False})
                offs.append(_profile_decode_kernels(engine, cfg, rng))
                fcore.set_flags({"FLAGS_trace": True})
                ons.append(_profile_decode_kernels(
                    engine, cfg, rng, trace=(trace.new_trace_id(), OBS_CLIENT_SPAN)))
            k_off, wall_off, idle_off = max(offs, key=lambda w: w[0])
            k_on, wall_on, idle_on = max(ons, key=lambda w: w[0])
            check("profiled decode step: kernels per step trace on = off",
                  k_on == k_off,
                  f"{k_on:.1f} (off {k_off:.1f}; the largest of {len(ons)} "
                  f"window(s) each: on {[round(w[0], 3) for w in ons]}, off "
                  f"{[round(w[0], 3) for w in offs]}); wall {wall_on:.3f} ms/step "
                  f"(off {wall_off:.3f}), idle share {idle_on:.3f} (off "
                  f"{idle_off:.3f}) | {smi}")
        ok &= _no_retrace("obs", engine, warm)
    finally:
        finj.disarm()
        fcore.set_flags({"FLAGS_trace": False, "FLAGS_serve_step_timeout_sec": 0.0,
                         "FLAGS_fault_hang_sec": 3600.0})
        if old_obs_dir is None:
            os.environ.pop("PADDLE_OBS_DIR", None)
        else:
            os.environ["PADDLE_OBS_DIR"] = old_obs_dir
        server.stop()
        trace.reset()
        flight.reset()
        shutil.rmtree(obs_dir, ignore_errors=True)
    return ok, counts


def _first_divergence(a, b):
    """Index of the first generated position where token arrays a and b
    differ, or None."""
    import numpy as np

    n = min(a.size, b.size)
    diff = np.flatnonzero(a[:n] != b[:n])
    if diff.size:
        return int(diff[0])
    return None if a.size == b.size else n


def _row_gap(row):
    """(top-2 gap, max|logit|) of one float32 logits row."""
    top = row.float().topk(2).values
    return (top[0] - top[1]).item(), row.abs().max().item()


def _rel_diff(a, b):
    """max|a - b| / max|b| of two logits tensors."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _gather_record(arena, rows):
    """Milliseconds of one decode step's gathers of `rows` slots' factors:
    as `lora_delta_add` makes them (A, B and scale per (layer, target), 3
    x 7 x layers `index_select`s) and as one `index_select` of the arena's
    `[capacity+1, row]` buffer, which gathers the same bytes.  Each is
    captured in a CUDA graph, as the step graphs run it, and timed by
    replay; with the bytes bound of the copy (each gathered row read once
    and written once).  Returns (per-stack ms, one-gather ms, bound ms)."""
    import torch

    ids = (torch.arange(rows, device=arena.device) % arena.capacity + 1).to(torch.int32)

    def per_stack():
        for A, B in arena._stacks.values():
            A.index_select(0, ids)
            B.index_select(0, ids)
            arena._scale.index_select(0, ids)

    def one_gather():
        arena._rows.index_select(0, ids)

    times = []
    for fn in (per_stack, one_gather):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        times.append(time_ms(g.replay))
        del g
    bound_ms = bound(2 * rows * arena.row_elems * 4, 0)[0]
    return times[0], times[1], bound_ms


def _lora_oracle(model, adapter, ids, merged=None):
    """First-token logits [V] float32 of an eager forward of `model` with
    `adapter` merged into float32 weights (W + scale * (A @ B)^T per
    target, nn.Linear's [out, in] layout) over prompt `ids`, the
    independent oracle of the adapter's delta path.  `merged` (a float32
    model of the same config from an earlier call, else built here) takes
    the model's weights first.  Returns (logits, merged)."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    dev = model.device
    if merged is None:
        merged = LlamaForCausalLM(model.config, device=dev, dtype="float32")
    with torch.no_grad():
        merged.load_state_dict(model.state_dict())
        for (layer, target), (A, B) in adapter.weights.items():
            blk = merged.llama.layers[layer]
            lin = getattr(blk.self_attn if target.endswith(("q_proj", "k_proj",
                                                            "v_proj", "o_proj"))
                          else blk.mlp, target)
            delta = torch.from_numpy(A).to(dev) @ torch.from_numpy(B).to(dev)
            lin.weight.add_(delta.T, alpha=adapter.scale)
        logits = merged(torch.from_numpy(ids)[None].to(dev))[0, -1].float()
    return logits, merged


def phase_lora(smi, model, device="cuda", prompts_spec=SLICE_PROMPTS,
               n_adapters=LORA_ADAPTERS, rank=LORA_RANK, mix=LORA_MIX,
               churn_len=LORA_CHURN_LEN, churn_new=LORA_CHURN_NEW,
               rounds=LORA_CHURN_ROUNDS, spec_k=LORA_SPEC_K,
               sys_len=PREFIX_SYS_LEN, suffixes=PREFIX_SUFFIXES[:3], **engine_kw):
    """Multi-tenant LoRA serving on `model` (the serving phases', full
    width): `n_adapters` random adapters (`make_random`, rank `rank`, seed
    i, all seven targets) in a registry, an arena of the default capacity
    (FLAGS_serve_lora_capacity, 8) at rank_max `rank`.  The main engine
    (prefix cache off, so a request's tokens repeat bit for bit wherever it
    runs) is warmed, then:

    1. the main path: the slice's prompts over POST /generate, co-batched
       with the adapters of `mix` (None: the base model); K1 and K2
       counted;
    2. churn: every adapter once per round (its own prompt), `rounds`
       rounds through the 8-slot arena, submitted together, the page audit
       and the LoRA clause every step: evictions and loads, each reload's
       tokens equal to its first round's bit for bit;
    3. the mix again, keeping logits (the plain-decode run speculation is
       held against), and a profiled decode step with eight adapters
       co-batched;
    then no new trace.  A no-LoRA engine serves the slice's prompts (its
    base rows equal to the main path's bit for bit) and profiles the same
    decode step.  A LoRA engine at spec_k `spec_k` (warmed, on the same
    arena) serves the mix: no new trace, its tokens equal to plain
    decode's or a near tie at the first divergence (SPEC_TIE_REL of the
    plain run's own logits).  A solo engine (an arena of capacity 1,
    prefix cache on) holds one adapter at a time: two of the main path's
    adapter rows again, equal bit for bit; a shared `sys_len`-token prompt
    with each of `suffixes` under one adapter twice (a prefix hit: the
    chunk window under LoRA) and then under another (a miss); over HTTP one request with `adapter`, one with
    an unknown adapter (404 AdapterUnknown, not retriable) and a burst of
    three adapters at once, which park on the full arena and all answer
    200; /metrics' paddle_lora_loads_total and _evictions_total > 0.
    Last, the oracle: the first-token logits of a fresh and of a
    prefix-hit adapter request against an eager float32 forward with the
    adapter merged into the weights, within LOGIT_REL_TOL.  Records the
    arena's bytes, one upload's time, decode tokens/s and ms per step with
    eight adapters against the base engine, kernels per decode step with
    and without LoRA.  Returns (all checks passed, the main path's launch
    counts, the solo engine's launch counts)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.lora import AdapterArena, AdapterRegistry, make_random

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    ok = True

    def check(what, cond, detail=""):
        nonlocal ok
        ok &= bool(cond)
        log("lora", f"{what}: {detail} -> {'ok' if cond else 'FAIL'}")

    t0 = time.perf_counter()
    reg = AdapterRegistry(cfg)
    for i in range(n_adapters):
        make_random(reg, f"a{i}", rank=rank, seed=i)
    arena = AdapterArena(reg, rank_max=rank, device=device)
    log("lora", f"{n_adapters} adapters of rank {rank} on all 7 targets x {layers} "
                f"layers registered in {time.perf_counter() - t0:.1f} s; arena "
                f"capacity {arena.capacity} (+ the base slot) x rank_max "
                f"{arena.rank_max}: {arena.nbytes} bytes = "
                f"{arena.nbytes / 2**30:.3f} GiB | {smi}")
    rng = np.random.default_rng(0)  # the slice's prompts
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]
    news = [new for _, new in prompts_spec]
    churn = [rng.integers(1, cfg.vocab_size, size=churn_len).astype(np.int32)
             for _ in range(n_adapters)]

    # -- the main engine ---------------------------------------------------
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(model, seed=0, device=device, lora=arena,
                                      prefix_cache=False, **engine_kw)
    engine.warmup()
    warm = _warm_counts("lora", engine)
    slots = engine.slots
    log("lora", f"engine (lora=arena, prefix cache off) built + warmed in "
                f"{time.perf_counter() - t0:.1f} s")
    profiler.reset_kernel_launch_counts()
    profiler.reset_serving()
    profiler.reset_lora()
    results, wall = _serve_batches(engine, [[
        (p, new, {"adapter": a} if a else {})
        for p, new, a in zip(prompts, news, mix)]])
    counts = profiler.kernel_launch_counts()
    summary = profiler.serving_summary()
    main_gen = [np.asarray(r["tokens"][p.size:], np.int32) for r, p in zip(results, prompts)]
    tokens_ok = all(r["tokens"][:p.size] == p.tolist() and g.size == new
                    for r, p, g, new in zip(results, prompts, main_gen, news))
    # launches read 0 off the card (CPU tensors run the plain versions)
    want_k1 = len(prompts) * layers if on_card else 0
    want_k2 = summary["decode_steps"] * layers if on_card else 0
    want_walk = want_k2
    check("main path: the slice's prompts over POST /generate, adapters "
          f"{list(mix)} co-batched",
          tokens_ok and counts["flash_fwd"] == want_k1
          and counts["paged_decode_fused"] == want_k2
          and counts["paged_decode_fused_walk"] == want_walk,
          f"served in {wall:.3f} s, token counts {'ok' if tokens_ok else 'WRONG'}; "
          f"launches {_main(counts)} (expected flash_fwd {want_k1} = "
          f"{len(prompts)} prefills x {layers}, paged_decode_fused {want_k2} = "
          f"{summary['decode_steps']} decode steps x {layers}, each on the walk)")
    distinct = len({g.tobytes() for g, a in zip(main_gen, mix) if a})
    log("lora", f"main path: {distinct} distinct generations among "
                f"{sum(a is not None for a in mix)} adapter rows; decode_tokens_per_s "
                f"{_decode_rates(summary)[0]:.2f}, ttft_p50_ms "
                f"{summary['ttft_p50_ms']:.3f} | {smi}")

    # -- churn: every adapter through the 8-slot arena, twice over ---------
    fcore.set_flags({"FLAGS_serve_debug_invariants": True})
    profiler.reset_lora()
    firsts, reload_ok, rounds_log = {}, True, []
    try:
        for rnd in range(rounds):
            t1 = time.perf_counter()
            reqs = [engine.submit(p, max_new_tokens=churn_new, adapter=f"a{i}")
                    for i, p in enumerate(churn)]
            engine.run_until_idle()
            for i, r in enumerate(reqs):
                out = r.wait(1)[churn_len:]
                if rnd:
                    reload_ok &= np.array_equal(out, firsts[i])
                else:
                    firsts[i] = out
            rounds_log.append(f"round {rnd + 1} {time.perf_counter() - t1:.2f} s")
    finally:
        fcore.set_flags({"FLAGS_serve_debug_invariants": False})
    churned = profiler.lora_summary()
    health = engine.healthz()["lora"]
    check(f"churn: {n_adapters} adapters x {rounds} rounds through "
          f"{arena.capacity} arena slots, the page and LoRA audits every step",
          reload_ok and churned.get("evictions", 0) >= n_adapters
          and churned.get("loads", 0) >= n_adapters + arena.capacity
          and health["resident"] == arena.capacity,
          f"{', '.join(rounds_log)}; {churned}; every reload's tokens equal "
          f"its first round's: {reload_ok}; healthz lora {health}")
    # fresh prefills and a decode step of base, a1 and a2 rows, one replay
    # of each against eager: the adapters input and the arena's rows as the
    # graphs read them
    replay_rng = np.random.default_rng(1)
    replay_prompts = [replay_rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
                      for n in (min(100, engine.max_len // 4),) * 3]
    replay_kws = [{"adapter": a} for a in (None, "a1", "a2")]
    ok &= check_replay("lora", engine, replay_prompts, kws=replay_kws,
                       want=("prefill", "decode"))
    # the mix again with its logits: what speculation is held against
    mix_reqs = [engine.submit(p, max_new_tokens=new, adapter=a, keep_logits=True)
                for p, new, a in zip(prompts, news, mix)]
    engine.run_until_idle()
    plain = [(r.wait(1)[p.size:], torch.stack(r.logits)) for r, p in zip(mix_reqs, prompts)]
    again = all(np.array_equal(g, m) for (g, _), m in zip(plain, main_gen))
    check("the mix again by submit: the main path's tokens", again,
          "bit for bit equal to the HTTP run's")
    upload_ms = None
    lora_prof = None
    if on_card:
        # one upload of a non-resident adapter into an evicted slot, the
        # engine idle
        ad = next(reg.resolve(n) for n in reg.names()
                  if arena.slot_of(reg.resolve(n).adapter_id) is None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        slot = arena.acquire(ad)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t1) * 1e3
        arena.release(slot)
        lora_prof = profile_decode(engine, cfg, rng,
                                   adapters=[f"a{i}" for i in range(slots)])
        stack_ms, row_ms, gather_bound = _gather_record(arena, slots)
        log("lora", f"record: one decode step's factor gathers for {slots} "
                    f"rows, each in a CUDA graph: per (layer, target) stack "
                    f"({3 * 7 * layers} index_selects) {stack_ms:.4f} ms; one "
                    f"gather of the arena's rows {row_ms:.4f} ms; bytes bound "
                    f"{gather_bound:.4f} ms | {smi}")
    ok &= _no_retrace("lora", engine, warm)
    del engine, mix_reqs
    if on_card:
        _free()

    # -- the base engine: the same prompts without LoRA ---------------------
    base = ContinuousBatchingEngine(model, seed=0, device=device,
                                    prefix_cache=False, **engine_kw)
    reqs = [base.submit(p, max_new_tokens=new) for p, new in zip(prompts, news)]
    base.run_until_idle()
    base_gen = [r.wait(1)[p.size:] for r, p in zip(reqs, prompts)]
    rows = [i for i, a in enumerate(mix) if a is None]
    check("base rows equal a no-LoRA engine's",
          all(np.array_equal(base_gen[i], main_gen[i]) for i in rows),
          f"rows {rows} bit for bit; the adapter rows differ from the base "
          f"model's on {sum(not np.array_equal(base_gen[i], main_gen[i]) for i, a in enumerate(mix) if a)}"
          f" of {sum(a is not None for a in mix)}")
    base_prof = profile_decode(base, cfg, rng) if on_card else None
    del base, reqs
    if on_card:
        _free()
    if lora_prof and base_prof:
        lt = slots / lora_prof["wall_ms"] * 1e3
        bt = slots / base_prof["wall_ms"] * 1e3
        log("lora", f"record: decode step with {slots} adapters co-batched "
                    f"{lora_prof['wall_ms']:.3f} ms ({lt:.2f} tokens/s), "
                    f"{lora_prof['kernels_per_step']:.0f} kernels/step, busy "
                    f"{lora_prof['busy_ms']:.3f} ms; base engine "
                    f"{base_prof['wall_ms']:.3f} ms ({bt:.2f} tokens/s), "
                    f"{base_prof['kernels_per_step']:.0f} kernels/step, busy "
                    f"{base_prof['busy_ms']:.3f} ms; the delta adds "
                    f"{lora_prof['wall_ms'] - base_prof['wall_ms']:.3f} ms and "
                    f"{lora_prof['kernels_per_step'] - base_prof['kernels_per_step']:.0f} "
                    f"kernels per step; arena {arena.nbytes} bytes; one "
                    f"adapter's upload {upload_ms:.3f} ms | {smi}")

    # -- speculation over the mix -------------------------------------------
    spec = ContinuousBatchingEngine(model, seed=0, device=device, lora=arena,
                                    prefix_cache=False, spec_k=spec_k, **engine_kw)
    spec.warmup()
    spec_warm = spec.compile_counts()
    profiler.reset_speculation()
    reqs = [spec.submit(p, max_new_tokens=new, adapter=a, keep_logits=True)
            for p, new, a in zip(prompts, news, mix)]
    spec.run_until_idle()
    same, ties, spec_ok, diffs = 0, [], True, []
    for i, (r, p, (g, lg)) in enumerate(zip(reqs, prompts, plain)):
        out = r.wait(1)[p.size:]
        at = _first_divergence(out, g)
        # the verify window's logits against plain decode's, on the
        # positions both runs reached with the same tokens
        n = g.size if at is None else at + 1
        diffs.append(_rel_diff(torch.stack(r.logits[:n]), lg[:n]))
        if at is None:
            same += 1
            continue
        gap, top = _row_gap(lg[at])
        tie = gap <= SPEC_TIE_REL * top
        spec_ok &= tie
        ties.append(f"request {i} ({mix[i]}) at {at}: gap/max|logit| "
                    f"{gap / top:.3e} {'near tie' if tie else 'FAIL'}")
    log("lora", f"verify-window logits against plain decode's, max|diff|/"
                f"max|logit| per request: {[round(d, 5) for d in diffs]}, max "
                f"{max(diffs):.5f} (SPEC_TIE_REL {SPEC_TIE_REL})")
    check(f"spec_k={spec_k} over the mix: plain decode's tokens",
          spec_ok and spec.compile_counts() == spec_warm,
          f"{same}/{len(reqs)} requests equal bit for bit; {ties or 'no divergence'}; "
          f"speculation {profiler.speculation_summary()}; compile_counts "
          f"{spec.compile_counts()} (warm {spec_warm})")
    ok &= check_replay("lora", spec, replay_prompts, kws=replay_kws,
                       want=("prefill", "verify"))
    ok &= _no_retrace("lora", spec, spec_warm)
    del spec, reqs
    if on_card:
        _free()

    # -- the solo engine: one adapter resident at a time ---------------------
    solo_arena = AdapterArena(reg, capacity=1, rank_max=rank, device=device)
    solo = ContinuousBatchingEngine(model, seed=0, device=device, lora=solo_arena,
                                    prefix_cache=True, **engine_kw)
    # warmed, so that no launch below is a trace's (a trace on the card
    # counts its warm run and its replay)
    solo.warmup()
    solo_warm = solo.compile_counts()
    profiler.reset_kernel_launch_counts()
    profiler.reset_lora()
    kept = {}
    alone_ok, alone = True, []
    for i, a in enumerate(mix):
        if a is None or len(alone) == 2:
            continue
        r = solo.submit(prompts[i], max_new_tokens=news[i], adapter=a,
                        keep_logits=True)
        solo.run_until_idle()
        out = r.wait(1)[prompts[i].size:]
        alone_ok &= np.array_equal(out, main_gen[i]) and solo_arena.resident() == [a]
        alone.append(a)
        kept[("fresh", a)] = (prompts[i], r.logits[0].clone())
    check("each adapter row alone on a capacity-1 arena: the co-batched row",
          alone_ok, f"adapters {alone} bit for bit")
    system = rng.integers(1, cfg.vocab_size, size=sys_len)
    shared = [np.concatenate([system, rng.integers(1, cfg.vocab_size, size=n)])
              .astype(np.int32) for n in suffixes]
    profiler.reset_paging()
    before = dict(profiler.kernel_launch_counts())
    for k, (p, a) in enumerate(zip(shared, ("a4", "a4", "a5"))):
        r = solo.submit(p, max_new_tokens=4, adapter=a, keep_logits=True)
        solo.run_until_idle()
        r.wait(1)
        if k == 1:  # the hit
            kept[("hit", a)] = (p, r.logits[0].clone())
    paging = profiler.paging_summary()
    after = profiler.kernel_launch_counts()
    mma = after["paged_decode_fused_mma"] - before.get("paged_decode_fused_mma", 0)
    want_mma = layers if on_card else 0
    check("per-adapter prefix cache: a shared prompt under a4 twice, then a5",
          paging.get("prefix_hits") == 1 and paging.get("prefix_lookups") == 3
          and mma == want_mma,
          f"hits {paging.get('prefix_hits')} of {paging.get('prefix_lookups')} "
          f"lookups (only a4's second), the hit's chunk window on the "
          f"tensor-core path: {mma} launches (expected {want_mma})")
    solo_counts = profiler.kernel_launch_counts()
    # a4's prefix hit again: one replay of its chunk prefill against eager
    ok &= check_replay("lora", solo, [np.concatenate([
        system, replay_rng.integers(1, cfg.vocab_size, size=suffixes[0])])
        .astype(np.int32)], kws=[{"adapter": "a4"}], want=("chunk_prefill",))
    # a burst of three adapters at once on one arena slot: two park
    loads0 = profiler.lora_summary().get("loads", 0)
    results, wall = _serve_batches(solo, [[
        (prompts[k], 8, {"adapter": f"a{7 + k}"}) for k in range(3)]])
    burst_ok = all(len(r.get("tokens", [])) == prompts[k].size + 8
                   for k, r in enumerate(results))
    loads = profiler.lora_summary().get("loads", 0) - loads0
    server = serve(solo, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body = _post_status(url + "/generate", {
            "input_ids": prompts[0].tolist(), "max_new_tokens": 8, "adapter": "a6"})
        check("POST /generate with adapter", code == 200
              and len(body.get("tokens", [])) == prompts[0].size + 8, f"HTTP {code}")
        code, body = _post_status(url + "/generate", {
            "input_ids": prompts[0].tolist(), "max_new_tokens": 8,
            "adapter": "no-such-adapter"})
        check("POST /generate with an unknown adapter",
              code == 404 and body.get("type") == "AdapterUnknown"
              and body.get("retriable") is False, f"HTTP {code} {body.get('type')}")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
            samples, _ = _obs_samples(resp.read().decode())
        m_loads = _obs_metric(samples, "paddle_lora_loads_total")
        m_evict = _obs_metric(samples, "paddle_lora_evictions_total")
        check("arena-full burst: three adapters at once on one arena slot",
              burst_ok and loads == 3 and m_loads > 0 and m_evict > 0,
              f"all answered 200 in {wall:.3f} s (parked, none failed): "
              f"{burst_ok}; loads {loads}; /metrics paddle_lora_loads_total "
              f"{m_loads:g}, paddle_lora_evictions_total {m_evict:g}; healthz "
              f"lora {solo.healthz()['lora']}")
    finally:
        server.stop()
    ok &= _no_retrace("lora", solo, solo_warm)
    del solo, solo_arena
    if on_card:
        _free()

    # -- the oracle: merged float32 weights --------------------------------
    merged, worst, parts = None, 0.0, []
    for key in (("fresh", alone[0]), ("hit", "a4")):
        p, got = kept[key]
        ref, merged = _lora_oracle(model, reg.resolve(key[1]), p, merged)
        with torch.no_grad():
            plain_row = model(torch.from_numpy(p)[None].to(device))[0, -1].float()
        err = _rel_diff(got, ref)
        worst = max(worst, err)
        parts.append(f"{key[0]} {key[1]} (prompt {p.size}): rel err {err:.4f}, the "
                     f"adapter's own effect {_rel_diff(plain_row, ref):.4f}")
    del merged
    if on_card:
        _free()
    check("first-token logits against an eager float32 forward with the "
          "adapter merged into the weights", worst <= LOGIT_REL_TOL,
          f"{'; '.join(parts)} (max|diff| / max|logit|, tol {LOGIT_REL_TOL})")
    return ok, counts, solo_counts


def _session_turn(engine, prompt, new, sid=None):
    """One turn submitted and run to its end; returns the request."""
    req = engine.submit(prompt, max_new_tokens=new, session_id=sid, keep_logits=True)
    engine.run_until_idle()
    req.wait(1)
    return req


def phase_sessions(smi, model, device="cuda", sys_len=PREFIX_SYS_LEN,
                   turns=SESSION_TURNS, user=SESSION_USER, new_tokens=SESSION_NEW,
                   drill_pool=SESSION_DRILL_POOL, drill_len=SESSION_DRILL_LEN,
                   **engine_kw):
    """Multi-turn KV sessions on `model` (the serving phases', full width):
    a session engine (prefix cache on, warmed) and a stateless engine
    (prefix_cache=False) answer the same `turns`-turn conversation: a
    `sys_len`-token system prompt, then per turn `user` user tokens from a
    seeded stream and `new_tokens` generated; each turn's transcript is the
    session engine's own output plus the next user tokens.  Checks, per
    turn: the two engines' tokens equal, or a near tie at the first
    divergence (the teacher-forced forward's top-2 gap within
    SESSION_TIE_REL of max|logit|); the session's first-token logits
    against the teacher-forced forward within LOGIT_REL_TOL; and over the
    conversation: >= SESSION_REUSE_MIN of turns 2-N's prompt tokens reused,
    `turns` binds, no new trace, K1 once per layer per fresh prefill and
    every chunk prefill on K2's tensor-core path.  Prints the first-token
    logit difference of each chunk-prefilled turn against the fresh one.
    Then a turn over POST /generate with `session_id`, a warm restart (the
    next turn reuses all but the last emitted token) and a small-pool
    drill: sessionless traffic evicts the idle session whole and its next
    turn answers as the stateless engine does.  Records TTFT per turn of
    both engines and the pages pinned.  Returns (all checks passed, the
    conversation's launch counts)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    ok = True

    def check(what, cond, detail=""):
        nonlocal ok
        ok &= bool(cond)
        log("sessions", f"{what}: {detail} -> {'ok' if cond else 'FAIL'}")

    def agree(got, ref, prompt):
        """(passed, verdict) of a turn's generated tokens against the
        stateless engine's: equal, or a near tie at the first divergence."""
        a, b = np.asarray(got, np.int32), np.asarray(ref, np.int32)
        at = _first_divergence(a, b)
        if at is None:
            return True, "equal"
        gap, top = _top2_gap(model, device, prompt, b, at)
        tie = gap <= SESSION_TIE_REL * top
        return tie, (f"{'near tie' if tie else 'FAIL'} at {at} (gap/max|logit| "
                     f"{gap / top:.3e})")

    t0 = time.perf_counter()
    sess = ContinuousBatchingEngine(model, seed=0, device=device,
                                    prefix_cache=True, **engine_kw)
    sess.warmup()
    warm = _warm_counts("sessions", sess)
    stateless = ContinuousBatchingEngine(model, seed=0, device=device,
                                         prefix_cache=False, **engine_kw)
    stateless.warmup()
    log("sessions", f"session and stateless engines built + warmed in "
                    f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(3)
    system = rng.integers(1, cfg.vocab_size, size=sys_len).astype(np.int32)
    users = [rng.integers(1, cfg.vocab_size, size=user).astype(np.int32)
             for _ in range(turns + 2)]
    profiler.reset_kernel_launch_counts()
    replays = (sess._decode_g.replay_count, stateless._decode_g.replay_count)
    conv = np.concatenate([system, users[0]])
    tokens_ok = logits_ok = True
    prompt_total = reused = 0
    ttft_s, ttft_0, diffs, verdicts, worst = [], [], [], [], 0.0
    served = []
    for t in range(turns):
        r = _session_turn(sess, conv, new_tokens, sid="chat")
        f = _session_turn(stateless, conv, new_tokens)
        served.append((conv, r, f))
        conv = np.concatenate([r.wait(1), users[t + 1]])
    # read before the teacher-forced forwards below launch K1 too
    counts = profiler.kernel_launch_counts()
    steps = (sess._decode_g.replay_count - replays[0]
             + stateless._decode_g.replay_count - replays[1])
    for t, (prompt, r, f) in enumerate(served):
        good, verdict = agree(r.tokens, f.tokens, prompt)
        tokens_ok &= good
        verdicts.append(verdict)
        with torch.no_grad():
            ref = model(torch.from_numpy(prompt)[None].to(device))[0, -1].float()
        err = _rel_diff(r.logits[0], ref)
        worst = max(worst, err)
        logits_ok &= err <= LOGIT_REL_TOL
        if t:
            prompt_total += prompt.size
            reused += r.session_reused_tokens
            diffs.append(_rel_diff(r.logits[0], f.logits[0]))
        ttft_s.append(r.ttft_s * 1e3)
        ttft_0.append(f.ttft_s * 1e3)
    del served
    st = sess.healthz()["sessions"]
    share = reused / max(1, prompt_total)
    check(f"{turns} turns: the stateless engine's tokens", tokens_ok,
          "; ".join(f"{i + 1} {v}" for i, v in enumerate(verdicts)))
    check("first-token logits against the teacher-forced forward", logits_ok,
          f"worst max|diff|/max|logit| {worst:.4f} (tol {LOGIT_REL_TOL})")
    log("sessions", f"first-token logits, chunk-prefilled turn against the fresh "
                    f"one, max|diff|/max|logit| per turn 2-{turns}: "
                    f"{[round(d, 5) for d in diffs]}, max {max(diffs):.5f} "
                    f"(SESSION_TIE_REL {SESSION_TIE_REL})")
    check(f"prompt tokens of turns 2-{turns} reused", share >= SESSION_REUSE_MIN
          and st["session_binds_total"] == turns
          and st["session_prefill_tokens_saved_total"] == reused,
          f"{reused}/{prompt_total} = {share:.4f} (min {SESSION_REUSE_MIN}); "
          f"healthz sessions {st}")
    # the session's first turn and every stateless one prefill afresh; the
    # launches read 0 off the card
    want_k1 = (1 + turns) * layers if on_card else 0
    want_mma = (turns - 1) * layers if on_card else 0
    want_k2 = (turns - 1 + steps) * layers if on_card else 0
    check("launches of the conversation",
          counts["flash_fwd"] == want_k1 and counts["paged_decode_fused"] == want_k2
          and counts["paged_decode_fused_mma"] == want_mma,
          f"{_main(counts)} (expected flash_fwd {want_k1} = {1 + turns} fresh "
          f"prefills x {layers}, paged_decode_fused {want_k2} = ({turns - 1} "
          f"chunk prefills + {steps} decode steps) x {layers}, the chunk "
          f"prefills on the tensor-core path: {want_mma})")
    ok &= _no_retrace("sessions", sess, warm)
    log("sessions", f"record: ttft_ms per turn, session "
                    f"{[round(x, 2) for x in ttft_s]}; stateless "
                    f"{[round(x, 2) for x in ttft_0]}; means over turns 2-{turns} "
                    f"{statistics.mean(ttft_s[1:]):.3f} vs "
                    f"{statistics.mean(ttft_0[1:]):.3f}; pages pinned "
                    f"{st['session_pages_pinned']} of {sess.pool_pages} "
                    f"({sess.page_size} rows each), {conv.size} tokens of "
                    f"transcript | {smi}")

    # -- a turn over POST /generate, then a warm restart -------------------
    saved0 = sess._sessions.tokens_saved_total
    prev = sess._sessions.tokens("chat").size
    results, _ = _serve_batches(sess, [[(conv, new_tokens, {"session_id": "chat"})]])
    f = _session_turn(stateless, conv, new_tokens)
    good, verdict = agree(results[0]["tokens"][conv.size:], f.tokens, conv)
    http_reused = sess._sessions.tokens_saved_total - saved0
    check("a turn over POST /generate with session_id", good
          and http_reused == prev and sess._sessions.get("chat")["turns"] == turns + 1,
          f"{verdict} against the stateless engine; reused {http_reused} "
          f"(the session's {prev} committed tokens)")
    conv = np.concatenate([np.asarray(results[0]["tokens"], np.int32), users[turns]])
    last = sess._sessions.tokens("chat").size
    sess.restart(reason="sessions drill")
    r = _session_turn(sess, conv, new_tokens, sid="chat")
    f = _session_turn(stateless, conv, new_tokens)
    good, verdict = agree(r.tokens, f.tokens, conv)
    check("warm restart keeps the session",
          good and r.session_reused_tokens == last == conv.size - user - 1,
          f"the next turn reused {r.session_reused_tokens} (all but the last "
          f"emitted token: {conv.size - user - 1}); {verdict}")
    # the next turn's chunk prefill on the session's pages, one replay
    # against eager
    ok &= check_replay("sessions", sess, [
        np.concatenate([r.wait(1), users[turns + 1]])],
        kws=[{"session_id": "chat"}], want=("chunk_prefill",))
    ok &= _no_retrace("sessions", sess, warm)
    del sess, stateless
    if on_card:
        _free()

    # -- the small-pool drill ----------------------------------------------
    small = ContinuousBatchingEngine(model, seed=0, device=device,
                                     prefix_cache=True, pool_pages=drill_pool,
                                     **engine_kw)
    fresh = ContinuousBatchingEngine(model, seed=0, device=device,
                                     prefix_cache=False, pool_pages=drill_pool,
                                     **engine_kw)
    turn1 = np.concatenate([system, users[0]])
    r1 = _session_turn(small, turn1, new_tokens, sid="idle")
    pinned = small._sessions.pages_pinned()
    for k in range(2):
        _session_turn(small, rng.integers(1, cfg.vocab_size, size=drill_len)
                      .astype(np.int32), new_tokens)
    st = small.healthz()["sessions"]
    conv = np.concatenate([r1.wait(1), users[1]])
    r = _session_turn(small, conv, new_tokens, sid="idle")
    f = _session_turn(fresh, conv, new_tokens)
    good, verdict = agree(r.tokens, f.tokens, conv)
    check(f"small pool ({drill_pool} pages): sessionless traffic evicts the "
          "idle session whole",
          st["sessions_resident"] == 0 and st["session_evictions_total"] == 1
          and r.session_reused_tokens == 0 and good,
          f"{pinned} pages pinned, then two {drill_len}-token requests: "
          f"healthz sessions {st}; the next turn reused "
          f"{r.session_reused_tokens} tokens and answers as a fresh engine: "
          f"{verdict}")
    del small, fresh
    if on_card:
        _free()
    return ok, counts


def check_import_replay(phase, engine):
    """One replay of the decode-role engine's import graph against an eager
    run of its body on the same static inputs (the tiles and page the last
    import left), bit for bit, and both against the tiles: the destination
    page is overwritten with ones before each, so each must write it whole.
    The page's rows past its committed rows are garbage to every reader,
    so the check leaves the engine as it was.  Returns whether it held."""
    import torch

    from paddle_tpu_torch.inference.paging import split_kv_heads

    g = engine._import_g
    inp = g.inputs(None)
    dst = int(inp["dst"][0])
    names = [n for n in ("k", "v", "k_scale", "v_scale") if f"{n}_tiles" in inp]
    # under tp each layer's entry is the ranks' arenas, rank r holding its
    # head block of the whole-head tiles
    layers = [x if isinstance(x, list) else [x] for x in engine._arenas]

    def scribble():
        for ranks in layers:
            for a in ranks:
                for n in names:
                    getattr(a, n)[dst].fill_(1)

    def read():
        return [getattr(a, n)[dst].clone() for ranks in layers for a in ranks
                for n in names]

    scribble()
    g(None)
    replayed = read()
    scribble()
    with torch.no_grad():
        g.body(**inp)
    eager = read()
    want = [split_kv_heads(inp[f"{n}_tiles"][i:i + 1], len(ranks))[r][0]
            for i, ranks in enumerate(layers) for r in range(len(ranks))
            for n in names]
    same = all(torch.equal(a, b) for a, b in zip(replayed, eager))
    whole = all(torch.equal(a, b) for a, b in zip(replayed, want))
    log(phase, f"import replay vs eager on page {dst} ({'/'.join(names)} of "
               f"{len(engine._arenas)} layers x {len(layers[0])} ranks): replay == eager "
               f"{same}, == the tiles {whole} -> "
               f"{'ok' if same and whole else 'FAIL'}")
    return same and whole


def _disagg_prompts(cfg, spec, sys_len, seed=11):
    """The phase's prompts: `spec` entries are a length or ("sys", n), a
    suffix of n tokens after the shared system prompt."""
    import numpy as np

    rng = np.random.default_rng(seed)
    draw = lambda n: rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)  # noqa: E731
    system = draw(sys_len)
    return [np.concatenate([system, draw(x[1])]) if isinstance(x, tuple) else draw(x)
            for x in spec]


def _disagg_pass(phase, smi, model, prompts, n_hits, kv_quant, device,
                 new_tokens, ttl_s, **engine_kw):
    """Three engines on `model` behind serve(): colocated, prefill role and
    decode role, warmed.  Each prompt goes to the colocated server's
    /generate, then through the three hops by hand; `n_hits` of them take a
    prefix hit on the colocated and prefill engines; a reservation of
    `ttl_s` is left to lapse before the last.  Returns (checks passed,
    launch counts of the pass, {figure: value})."""
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference import engine as engine_mod
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.obs import flight

    layers = model.config.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    ok = True

    def check(what, cond, detail=""):
        nonlocal ok
        ok &= bool(cond)
        log(phase, f"{what}: {detail} -> {'ok' if cond else 'FAIL'}")

    t0 = time.perf_counter()
    engines = {role: ContinuousBatchingEngine(model, seed=0, device=device,
                                              role=role, kv_quant=kv_quant,
                                              **engine_kw).warmup()
               for role in ("colocated", "prefill", "decode")}
    co, pre, dec = engines["colocated"], engines["prefill"], engines["decode"]
    warm = {role: _warm_counts(f"{phase} {role}", e) for role, e in engines.items()}
    check("the import graph only on the decode role",
          warm["decode"].get("import") == 1
          and "import" not in warm["colocated"] and "import" not in warm["prefill"],
          f"import traces {warm['decode'].get('import')}")
    log(phase, f"three engines built + warmed in {time.perf_counter() - t0:.1f} s")

    # what the hops cost: the export's gather and copy, its serialization,
    # the decode side's staging and import, each timed where it runs
    times = {k: [] for k in ("export", "serialize", "stage", "import")}

    def timed(what, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times[what].append((time.perf_counter() - t) * 1e3)
        return run

    pre._export_rows_locked = timed("export", pre._export_rows_locked)
    serialize = engine_mod.serialize_kv_handoff
    engine_mod.serialize_kv_handoff = timed("serialize", serialize)
    dec._stage_handoff = timed("stage", dec._stage_handoff)
    dec._import_into_paged = timed("import", dec._import_into_paged)
    handles = {"colocated": [], "decode": []}
    for role in handles:
        real = engines[role].submit

        def submit(*a, _real=real, _into=handles[role], **kw):
            h = _real(*a, **kw)
            _into.append(h)
            return h

        engines[role].submit = submit
    servers = {role: serve(e, port=0, block=False) for role, e in engines.items()}
    url = {role: f"http://127.0.0.1:{srv.server_address[1]}"
           for role, srv in servers.items()}
    profiler.reset_kernel_launch_counts()
    profiler.reset_disagg()
    replays0 = {role: e._decode_g.replay_count for role, e in engines.items()}
    rows = []
    try:
        for i, p in enumerate(prompts):
            t_co = time.perf_counter()
            code, _, body = _post_full(url["colocated"] + "/generate", {
                "input_ids": p.tolist(), "max_new_tokens": new_tokens})
            assert code == 200, (code, body)
            ref = body["tokens"]
            if i == len(prompts) - 1:
                # a reservation nobody consumes lapses: the next one's
                # purge returns its headroom
                code, _, orphan = _post_full(url["decode"] + "/reserve", {
                    "prompt_len": int(p.size), "max_new_tokens": new_tokens,
                    "ttl_s": ttl_s})
                held = dec.healthz()["reserved_pages"]
                time.sleep(2 * ttl_s)
            t_dis = time.perf_counter()
            code, _, rsv = _post_full(url["decode"] + "/reserve", {
                "prompt_len": int(p.size), "max_new_tokens": new_tokens})
            assert code == 200, (code, rsv)
            reserved = dec.healthz()["reserved_pages"]
            t1 = time.perf_counter()
            code, _, pf = _post_full(url["prefill"] + "/prefill",
                                     {"input_ids": p.tolist()})
            assert code == 200, (code, pf)
            t2 = time.perf_counter()
            body = {"input_ids": p.tolist(), "max_new_tokens": new_tokens,
                    "handoff": pf["handoff"], "reservation": rsv["reservation"]}
            code, _, got = _post_full(url["decode"] + "/generate", body)
            assert code == 200, (code, got)
            t3 = time.perf_counter()
            h_co, h_dec = handles["colocated"][-1], handles["decode"][-1]
            rows.append(dict(
                L=int(p.size), same=got["tokens"] == ref,
                wire=pf["handoff"]["payload_bytes"], pages=-(-p.size // dec.page_size),
                rsv_pages=rsv["pages"], reserved=reserved,
                after=dec.healthz()["reserved_pages"],
                prefill_hop_ms=(t2 - t1) * 1e3, generate_hop_ms=(t3 - t2) * 1e3,
                ttft_co=(h_co._submit_t + h_co.ttft_s - t_co) * 1e3,
                ttft_dis=(h_dec._submit_t + h_dec.ttft_s - t_dis) * 1e3,
                dec_s=(h_dec._finish_t - h_dec._submit_t - h_dec.ttft_s),
                co_s=(h_co._finish_t - h_co._submit_t - h_co.ttft_s),
                n=len(h_dec.tokens)))
        counts = profiler.kernel_launch_counts()
        steps = {role: e._decode_g.replay_count - replays0[role]
                 for role, e in engines.items()}
        code, _, batch = _post_full(url["prefill"] + "/prefill",
                                    {"input_ids": [prompts[0].tolist()] * 2})
        check("POST /prefill with two prompts", code == 400
              and batch.get("type") == "ValueError", f"answered {code} {batch.get('type')}")
        with urllib.request.urlopen(url["decode"] + "/metrics", timeout=60) as r:
            samples, _ = _obs_samples(r.read().decode())
    finally:
        for srv in servers.values():
            srv.stop()
        engine_mod.serialize_kv_handoff = serialize
    expired = [e for e in flight.events() if e["kind"] == "disagg"
               and e["detail"] == "reserve_expired"
               and e.get("rid") == orphan.get("reservation")]
    check("disaggregated tokens equal the colocated engine's, bit for bit",
          all(r["same"] for r in rows),
          "; ".join(f"{r['L']} {'equal' if r['same'] else 'DIFFER'}" for r in rows))
    check("reservations: held until the admission, 0 after it",
          all(r["reserved"] == r["rsv_pages"] > 0 and r["after"] == 0 for r in rows),
          "; ".join(f"{r['L']}: {r['reserved']}/{r['rsv_pages']} -> {r['after']}"
                    for r in rows))
    check(f"a {ttl_s} s reservation left to lapse", orphan.get("pages") == held
          and rows[-1]["reserved"] == rows[-1]["rsv_pages"] and len(expired) >= 1,
          f"held {held} pages, then the next reservation alone "
          f"({rows[-1]['reserved']}); reserve_expired records {len(expired)}")
    n_fresh = len(prompts) - n_hits
    dec_steps = steps["colocated"] + steps["decode"] + steps["prefill"]
    want = {"flash_fwd": 2 * n_fresh * layers,
            "paged_decode_fused": (2 * n_hits + dec_steps) * layers,
            "paged_decode_fused_mma": 2 * n_hits * layers,
            "paged_decode_fused_walk": dec_steps * layers}
    if kv_quant == "int8":
        want = {k.replace("paged_decode_fused", "paged_decode_fused_q8"): v
                for k, v in want.items() if k != "flash_fwd"}
        want["flash_fwd"] = 2 * n_fresh * layers
    if not on_card:
        want = dict.fromkeys(want, 0)
    check("launches of the pass", all(counts.get(k, 0) == v for k, v in want.items()),
          f"{_main(counts)} (expected {want}: {n_fresh} fresh prefills and "
          f"{n_hits} prefix hit on the colocated and the prefill engines, "
          f"{dec_steps} decode steps of the colocated ({steps['colocated']}) "
          f"and decode ({steps['decode']}) engines, every hit on the chunk "
          "window, every decode step on the walk)")
    for role, e in engines.items():
        ok &= _no_retrace(f"{phase} {role}", e, warm[role])
    disagg = {k: _obs_metric(samples, f"paddle_disagg_{k}_total", role="decode")
              for k in ("exports", "imports", "import_pages", "handoff_bytes")}
    mine = {"exports": len(rows), "imports": len(rows),
            "import_pages": sum(r["pages"] for r in rows),
            "handoff_bytes": sum(r["wire"] for r in rows)}
    check("paddle_disagg_* on the decode server's /metrics", disagg == mine,
          f"{disagg} (the phase's own counts {mine})")
    ok &= check_import_replay(phase, dec)
    per_tok = {r["wire"] / r["L"] for r in rows}
    imp_ms = time_ms(lambda: dec._import_g(None), iters=10) if on_card else 0.0
    figs = {"wire": {r["L"]: r["wire"] for r in rows}}
    med = lambda xs: statistics.median(xs) if xs else 0.0  # noqa: E731
    log(phase, f"record: wire bytes per prompt token {sorted(per_tok)}; per "
               "request (prompt tokens: export gather + copy ms, serialize ms, "
               "/prefill hop ms, decode-side stage ms, import host ms, "
               "/generate hop ms): " + "; ".join(
                   f"{r['L']}: {times['export'][i]:.2f}, {times['serialize'][i]:.1f}, "
                   f"{r['prefill_hop_ms']:.1f}, {times['stage'][i]:.1f}, "
                   f"{times['import'][i]:.2f}, {r['generate_hop_ms']:.1f}"
                   for i, r in enumerate(rows)) + f" | {smi}")
    log(phase, f"record: one import page (replay of the import graph, "
               f"{layers} layers' K/V tiles, CUDA events) "
               f"{imp_ms:.4f} ms; TTFT ms, disaggregated (from /reserve to "
               f"the decode side's first token) against colocated (from its "
               f"POST): " + "; ".join(f"{r['L']}: {r['ttft_dis']:.1f} vs "
                                      f"{r['ttft_co']:.1f}" for r in rows)
               + f"; medians {med([r['ttft_dis'] for r in rows]):.1f} vs "
                 f"{med([r['ttft_co'] for r in rows]):.1f} | {smi}")
    dec_tps = sum(r["n"] - 1 for r in rows) / max(1e-9, sum(r["dec_s"] for r in rows))
    co_tps = sum(r["n"] - 1 for r in rows) / max(1e-9, sum(r["co_s"] for r in rows))
    log(phase, f"record: decode tokens/s of one request at a time after its "
               f"first token, decode role {dec_tps:.2f}, colocated "
               f"{co_tps:.2f} | {smi}")
    figs.update(import_page_ms=imp_ms, dec_tps=dec_tps, co_tps=co_tps)
    del engines, co, pre, dec
    return ok, counts, figs


def phase_disagg(smi, model, device="cuda", spec=DISAGG_SPEC,
                 sys_len=DISAGG_SYS_LEN, new_tokens=DISAGG_NEW,
                 int8=DISAGG_INT8, ttl_s=DISAGG_TTL_S, **engine_kw):
    """Disaggregated prefill/decode on `model` (the serving phases', full
    width and depth): `_disagg_pass` in the model's dtype over the prompts
    of `spec`, then over int8 pages over those at the indices `int8`, whose
    wire bytes must be (head_dim + 4) / (head_dim x the dtype's bytes) of
    the first pass's for the same prompts (an int8 row's head ships its
    elements and a float32 scale: 0.5156 for Llama-2-7B in bf16).  Returns
    (all checks passed, [launch counts of each pass])."""
    import torch

    on_card = torch.device(device).type == "cuda"
    prompts = _disagg_prompts(model.config, spec, sys_len)
    # every system-prompt request after the first takes a hit
    hits = lambda part: max(0, sum(isinstance(x, tuple) for x in part) - 1)  # noqa: E731
    ok, counts, figs = _disagg_pass("disagg", smi, model, prompts, hits(spec),
                                    "none", device, new_tokens, ttl_s, **engine_kw)
    if on_card:
        _free()
    ok8, counts8, figs8 = _disagg_pass("disagg int8", smi, model,
                                       [prompts[i] for i in int8],
                                       hits([spec[i] for i in int8]), "int8",
                                       device, new_tokens, ttl_s, **engine_kw)
    if on_card:
        _free()
    hd = model.config.head_dim
    expect = (hd + 4) / (hd * model.lm_head.weight.element_size())
    ratio = {L: figs8["wire"][L] / figs["wire"][L] for L in figs8["wire"]}
    ratio_ok = all(abs(x - expect) < 1e-9 for x in ratio.values())
    log("disagg int8", f"wire bytes against the first pass's for the same "
                       f"prompts {ratio} (expected {expect:.4f}) -> "
                       f"{'ok' if ratio_ok else 'FAIL'}")
    return ok and ok8 and ratio_ok, [counts, counts8]


# the fleet phase: the slice's six requests through the router's HTTP front
# door over two in-process replicas; the disaggregated pairs' requests of
# 64-128 prompt tokens (a handoff crosses router memory as JSON, ~15 ms of
# host time per prompt token over two hops, PERF.md); a four-turn chat of
# FLEET_CHAT_USER user tokens and FLEET_CHAT_NEW new ones a turn; the
# autoscaler's stepped soak (FLEET_SOAK: a burst the first replica's slots
# cannot absorb, then a trickle that lets the spawn drain away)
FLEET_PAIR_SPEC = (64, 128)
FLEET_PAIR_NEW = 32
FLEET_CHAT_USER = 24
FLEET_CHAT_NEW = 16
FLEET_SOAK = dict(rate_hz=4.0, duration_s=8.0, steps=((0.0, 1.0), (0.5, 8.0), (3.5, 0.25)),
                  prompt_len=(16, 64), max_new_tokens=24, seed=5)
FLEET_WORKER_PROMPTS = 12  # per load thread, two threads
# the hop's timing: one-token requests on a prompt of this many tokens (a
# warmed bucket), this many rounds of each leg pair
FLEET_HOP = (24, 60)
# takeovers after the first, and spawns after the autoscaler's
FLEET_REPEATS = (2, 2)


def _fleet_serve(engine):
    from paddle_tpu_torch.inference import serve

    srv = serve(engine, port=0, block=False, supervise=False, handle_signals=False)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _admissions(engine, into, tag):
    """Count the engine's admissions under `tag` in `into` (a list)."""
    real = engine.submit

    def submit(*a, **kw):
        into.append(tag)
        return real(*a, **kw)

    engine.submit = submit


def _p50(xs):
    return statistics.median(xs) if xs else 0.0


def phase_fleet(smi, model, device="cuda", prompts_spec=SLICE_PROMPTS,
                pair_spec=FLEET_PAIR_SPEC, pair_new=FLEET_PAIR_NEW,
                chat_user=FLEET_CHAT_USER, chat_new=FLEET_CHAT_NEW, soak=FLEET_SOAK,
                small=None, worker_prompts=FLEET_WORKER_PROMPTS,
                obs_dir=ROOT / "build" / "fleet", **engine_kw):
    """The serving fleet (`paddle_tpu_torch.serving`) in front of `model`
    (the serving phases', full width and depth), every replica an
    in-process `serve()` over its own engine and arena on that one model,
    the prefix cache off where tokens are compared (so a request's tokens
    repeat bit for bit on any replica):

    (a) the slice's prompts posted one at a time straight to replica B, then
        through `serve_router`'s POST /generate over [A, B] (A wins ties),
        then keyed through a bare router and a journaled one: every answer
        equal to B's direct one, bit for bit; then the hop timed on
        one-token requests (`FLEET_HOP`: prompt length, rounds), each round a
        direct/routed pair and a bare/journaled keyed pair, each pair in
        turns;
    (b) the same stream with A's server stopped at its midpoint: every
        request answered once, 200, the same tokens, the tail failed over;
    (c) on the journaled router: a keyed double submit and an in-flight
        join generate once (admissions counted); `router.crash` kills it,
        a keyed caller sees RouterCrashed, a `RouterStandby` takes over
        from the stale heartbeat and replays the key from the journal with
        no new admission, then serves a new one; then `FLEET_REPEATS[0]` more
        crash -> takeover cycles, each successor replaying the key;
    (d) one router over a colocated replica and a prefill/decode pair in the
        model's dtype: `pair_spec` prompts through the three hops, equal
        bit for bit to the colocated replica's answers; the same over an
        int8 colocated replica and int8 pair (K4);
    (e) over two replicas with the prefix cache and an adapter arena: a
        four-turn chat pinned to one replica (pin hits, one repin once that
        replica is admin-drained), and an adapter request landing on the
        replica that holds it resident;
    (f) an `Autoscaler` over one replica whose spawn builds an in-process
        replica, under a stepped `Workload` through `run_soak`: the fleet
        goes 1 -> 2 -> 1 and every request resolves once; then
        `FLEET_REPEATS[1]` more spawns timed to a ready probe;
    (g) two tiny `ReplicaProcess` workers on `device`, one SIGKILLed under
        load: every request resolved once, each 200 equal to an in-process
        tiny engine's, both processes reaped.

    `small` sizes the engines of (d)-(f) (the serving dict with a shorter
    context).  Every in-process engine's compile counts after its traffic
    equal those after its warmup (checked before its server stops).
    Records the hop's routed-minus-direct and journaled-minus-bare paired
    medians with their quartiles, the takeover and spawn-to-ready seconds
    over their repeats and TTFT through the router (disaggregated against
    colocated).  Returns (all checks passed, [the launch counts of
    (a)-(f)])."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.fault import injection as inj
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
    from paddle_tpu_torch.lora import AdapterArena, AdapterRegistry, make_random
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (Autoscaler, Replica, ReplicaProcess, Router,
                                          RouterCrashed, RouterStandby, Workload,
                                          run_soak, serve_router)

    cfg = model.config
    on_card = torch.device(device).type == "cuda"
    small = dict(engine_kw, max_len=512, prefill_buckets=[32, 64, 128, 256]) \
        if small is None else small
    ok = True
    figs = {}
    warm = {}  # id(engine) -> its compile counts after warmup
    obs_env = os.environ.get("PADDLE_OBS_DIR")
    os.environ["PADDLE_OBS_DIR"] = str(obs_dir)  # the crash drill's flight dump
    if obs_dir.exists():
        shutil.rmtree(obs_dir)
    obs_dir.mkdir(parents=True)

    def check(what, cond, detail=""):
        nonlocal ok
        ok &= bool(cond)
        log("fleet", f"{what}: {detail} -> {'ok' if cond else 'FAIL'}")

    def engine(**kw):
        e = ContinuousBatchingEngine(model, seed=0, device=device,
                                     **{**engine_kw, **kw}).warmup()
        warm[id(e)] = _warm_counts("fleet", e)
        return e

    def no_retrace(*es):
        nonlocal ok
        for e in es:
            ok &= _no_retrace("fleet", e, warm.pop(id(e)))

    def post(url, body, key=None):
        return _post_full(url + "/generate", body,
                          {"X-Idempotency-Key": key} if key else None)

    def timed_post(url, body, key=None):
        t = time.perf_counter()
        code, hdrs, out = post(url, body, key)
        return code, hdrs, out, (time.perf_counter() - t) * 1e3

    def median_quartiles(xs):
        q1, q2, q3 = statistics.quantiles(xs, n=4)
        return q2, q1, q3

    rng = np.random.default_rng(0)  # the slice's prompts
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]
    bodies = [{"input_ids": p.tolist(), "max_new_tokens": n}
              for p, (_, n) in zip(prompts, prompts_spec)]
    profiler.reset_kernel_launch_counts()
    profiler.reset_router()
    profiler.reset_disagg()
    profiler.reset_autoscale()

    # -- (a)-(c): two replicas behind the front door -------------------------
    t0 = time.perf_counter()
    admitted = []
    engines = {rid: engine(prefix_cache=False) for rid in ("A", "B")}
    for rid, e in engines.items():
        _admissions(e, admitted, rid)
    servers = {rid: _fleet_serve(e) for rid, e in engines.items()}
    url = {rid: u for rid, (_, u) in servers.items()}
    log("fleet", f"two replicas built + warmed in {time.perf_counter() - t0:.1f} s")
    jroot, hbroot = obs_dir / "journal", obs_dir / "hb"
    fronts, routers, standbys = [], [], []
    try:
        bare = Router([Replica("A", url["A"]), Replica("B", url["B"])],
                      probe_interval=3600)
        journaled = Router([Replica("A", url["A"]), Replica("B", url["B"])],
                           probe_interval=0.1, journal=str(jroot), heartbeat=str(hbroot))
        routers += [bare, journaled]
        front = serve_router(bare, port=0, block=False, probe=False)
        jfront = serve_router(journaled, port=0, block=False, probe=False)
        fronts += [front, jfront]
        bare.probe_once()
        journaled.probe_once()
        furl = f"http://127.0.0.1:{front.server_address[1]}"
        jurl = f"http://127.0.0.1:{jfront.server_address[1]}"
        direct, routed, keyed, jkeyed = [], [], [], []
        del admitted[:]
        for i, b in enumerate(bodies):
            direct.append(post(url["B"], b))
            routed.append(post(furl, b))
            keyed.append(post(furl, b, f"bare-{i}"))
            jkeyed.append(post(jurl, b, f"ha-{i}"))
        check("direct answers", all(c == 200 for c, *_ in direct),
              f"statuses {[c for c, *_ in direct]}")
        want = [out["tokens"] for _, _, out in direct]
        check("(a) the slice's requests through serve_router, bit for bit the "
              "direct answers", [o["tokens"] for _, _, o in routed] == want
              and all(c == 200 for c, *_ in routed)
              and len(admitted) == 4 * len(bodies),
              f"statuses {[c for c, *_ in routed]}, admissions {len(admitted)}")
        check("(a) keyed through the bare and the journaled router",
              [o["tokens"] for _, _, o in keyed] == want
              and [o["tokens"] for _, _, o in jkeyed] == want,
              f"journal seq {journaled.journal.seq}")
        # the hop: one-token requests, each round a direct/routed pair and a
        # bare/journaled keyed pair (fresh keys), each pair in turns (ABBA)
        # so that drift between requests cancels in the paired differences
        hop_len, hop_rounds = FLEET_HOP
        hop_body = {"input_ids": np.random.default_rng(1).integers(
            1, cfg.vocab_size, size=hop_len).tolist(), "max_new_tokens": 1}
        legs = {k: [] for k in ("direct", "routed", "bare", "journaled")}
        hop_answers = set()
        for i in range(hop_rounds):
            for pair in ((("direct", url["B"], None), ("routed", furl, None)),
                         (("bare", furl, f"hop-bare-{i}"),
                          ("journaled", jurl, f"hop-ha-{i}"))):
                for leg, u, key in (pair if i % 2 == 0 else pair[::-1]):
                    code, _, out, dt = timed_post(u, hop_body, key)
                    legs[leg].append(dt)
                    hop_answers.add((code, tuple(out.get("tokens", ()))))
        check("(a) the hop's one-token requests: one answer on every leg, 200",
              len(hop_answers) == 1 and next(iter(hop_answers))[0] == 200,
              f"{len(hop_answers)} distinct answers over {4 * hop_rounds} requests")
        p50 = {k: _p50(v) for k, v in legs.items()}
        hop_q = median_quartiles([r - d for r, d in zip(legs["routed"], legs["direct"])])
        jrn_q = median_quartiles([j - b for j, b in zip(legs["journaled"], legs["bare"])])
        figs.update(direct_p50_ms=p50["direct"], routed_p50_ms=p50["routed"],
                    bare_keyed_p50_ms=p50["bare"], journaled_p50_ms=p50["journaled"],
                    router_overhead_p50_ms=p50["routed"] - p50["direct"],
                    routed_minus_direct_paired_ms=hop_q,
                    journaled_minus_bare_paired_ms=jrn_q)
        log("fleet", f"record: the hop over {hop_rounds} rounds of one-token requests "
                     f"({hop_len}-token prompt, each pair in turns) p50 ms: direct "
                     f"{p50['direct']:.3f}, through serve_router {p50['routed']:.3f} "
                     f"(router_overhead_p50_ms {figs['router_overhead_p50_ms']:.3f}); "
                     f"paired routed - direct median {hop_q[0]:+.3f} ms, quartiles "
                     f"[{hop_q[1]:+.3f}, {hop_q[2]:+.3f}]; keyed through a bare router "
                     f"{p50['bare']:.3f}, through a journaled one {p50['journaled']:.3f}; "
                     f"paired journaled - bare median {jrn_q[0]:+.3f} ms, quartiles "
                     f"[{jrn_q[1]:+.3f}, {jrn_q[2]:+.3f}] | {smi}")
        journaled.start()  # the probe loop beats the heartbeat the standby reads

        # (c) exactly once through the journaled front door, then its crash
        del admitted[:]
        again = post(jurl, bodies[0], "ha-0")
        first_join = []

        def join():
            first_join.append(post(jurl, bodies[1], "join"))

        threads = [threading.Thread(target=join) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        replays = sorted(h.get("X-Idempotency-Replay") or "" for _, h, _ in first_join)
        check("(c) a keyed double submit and an in-flight join generate once",
              again[1].get("X-Idempotency-Replay") == "hit" and again[2]["tokens"] == want[0]
              and len(admitted) == 1 and replays in (["", "join"], ["", "hit"])
              and all(o["tokens"] == want[1] for _, _, o in first_join),
              f"replay headers {again[1].get('X-Idempotency-Replay')}, {replays}; "
              f"admissions {admitted}")

        def crash_and_take_over(dying):
            """router.crash on `dying` (the one router whose probe loop
            runs, so the one that draws the fault), a standby
            declaring it dead from the stale heartbeat, its successor (which
            beats the same slot).  Returns (seconds from the arming to a
            successor, RouterCrashed seen by a caller, declared dead,
            successor)."""
            standby = RouterStandby(str(jroot), str(hbroot), timeout=0.5,
                                    poll_interval=0.02,
                                    router_kwargs={"probe_interval": 0.1})
            standbys.append(standby)
            assert standby.primary_alive()
            crashes = profiler.router_summary()["crashes"]
            inj.arm("router.crash:1")
            t_crash = time.perf_counter()
            while profiler.router_summary()["crashes"] == crashes and \
                    time.perf_counter() - t_crash < 10:
                time.sleep(0.01)
            try:
                dying.handle_generate(dict(bodies[2]), idem_key="ha-2")
                crashed = False
            except RouterCrashed:
                crashed = True
            dead = standby.wait_for_death(timeout=10.0)
            successor = standby.takeover()
            routers.append(successor)
            took = time.perf_counter() - t_crash
            inj.disarm()
            return took, crashed, dead, successor

        took, crashed, dead, successor = crash_and_take_over(journaled)
        takeovers = [took]
        del admitted[:]
        code, body, hdrs = successor.handle_generate(dict(bodies[2]), idem_key="ha-2")
        fresh = successor.handle_generate(dict(bodies[3]), idem_key="ha-new")
        check("(c) router.crash -> RouterStandby takeover replays from the journal",
              crashed and dead and code == 200 and body["tokens"] == want[2]
              and hdrs.get("X-Idempotency-Replay") == "hit" and fresh[0] == 200
              and fresh[1]["tokens"] == want[3] and admitted == ["A"]
              and successor.healthz()["takeovers"] == 1,
              f"crashed {crashed}, declared dead {dead}, replay {code} "
              f"{hdrs.get('X-Idempotency-Replay')}, admissions after {admitted}")
        chain = []
        del admitted[:]
        for _ in range(FLEET_REPEATS[0]):
            took, crashed, dead, successor = crash_and_take_over(successor)
            takeovers.append(took)
            code, body, hdrs = successor.handle_generate(dict(bodies[2]), idem_key="ha-2")
            chain.append(crashed and dead and code == 200 and body["tokens"] == want[2]
                         and hdrs.get("X-Idempotency-Replay") == "hit")
        check(f"(c) {FLEET_REPEATS[0]} more crash -> takeover cycles, each successor "
              "replaying the key", all(chain) and admitted == [],
              f"cycles {chain}, admissions {admitted}")
        figs["takeover_s"] = statistics.median(takeovers)
        figs["takeover_samples_s"] = takeovers
        log("fleet", f"record: takeover from router.crash to a serving successor over "
                     f"{len(takeovers)} cycles: median {figs['takeover_s']:.3f} s, "
                     f"samples {[round(t, 3) for t in takeovers]} (standby timeout 0.5 s, "
                     f"probe interval 0.1 s, journal seq {successor.journal.seq}) | {smi}")

        # (b) A stopped at the stream's midpoint: the second half goes
        # through a router whose last probe read both ready (A wins the
        # tie), so it tries A until A's breaker opens
        first = Router([Replica("A", url["A"]), Replica("B", url["B"])],
                       probe_interval=3600, retry_backoff=0.01)
        second = Router([Replica("A", url["A"]), Replica("B", url["B"])],
                        probe_interval=3600, retry_backoff=0.01)
        routers += [first, second]
        first.probe_once()
        second.probe_once()
        before = dict(profiler.router_summary())
        half = len(bodies) // 2
        answers = [first.handle_generate(dict(b)) for b in bodies[:half]]
        no_retrace(engines["A"])
        servers["A"][0].stop()
        answers += [second.handle_generate(dict(b)) for b in bodies[half:]]
        g = profiler.router_summary()
        moved = {k: g[k] - before[k] for k in ("requests", "retries", "failovers",
                                               "breaker_trips")}
        check("(b) the preferred replica stopped mid-stream: every request once, "
              "the same tokens", [s for s, _, _ in answers] == [200] * len(bodies)
              and [o["tokens"] for _, o, _ in answers] == want
              and moved["failovers"] >= 1, f"counters {moved}")
        no_retrace(engines["B"])
    finally:
        inj.disarm()
        for standby in standbys:
            standby.stop()
        for r in routers:
            r.stop()
        for f in fronts:
            f.shutdown()
            f.server_close()
        for srv, _ in servers.values():
            srv.stop()
    del engines, servers
    if on_card:
        _free()

    # -- (d): a colocated replica and prefill/decode pairs behind a router ----
    pair_prompts = [np.random.default_rng(40 + i).integers(
        1, cfg.vocab_size, size=n).astype(np.int32) for i, n in enumerate(pair_spec)]
    pair_bodies = [{"input_ids": p.tolist(), "max_new_tokens": pair_new}
                   for p in pair_prompts]
    ttft = {}
    for quant in ("none", "int8"):
        handles = {"colocated": [], "decode": []}
        engines = {role: engine(role=role, kv_quant=quant, prefix_cache=False,
                                **{k: v for k, v in small.items() if k != "kv_quant"})
                   for role in ("colocated", "prefill", "decode")}
        for role in handles:
            real = engines[role].submit

            def submit(*a, _real=real, _into=handles[role], **kw):
                h = _real(*a, **kw)
                _into.append(h)
                return h

            engines[role].submit = submit
        servers = {role: _fleet_serve(e) for role, e in engines.items()}
        url = {role: u for role, (_, u) in servers.items()}
        try:
            co = Router([Replica("c", url["colocated"])], probe_interval=3600)
            co.probe_once()
            pair = Router([Replica(role[0], url[role]) for role in
                           ("colocated", "prefill", "decode")], probe_interval=3600,
                          retry_backoff=0.05)
            pair.probe_once()
            rows = []
            before = profiler.disagg_summary().get("pair_picks", 0)
            for b in pair_bodies:
                t_co = time.perf_counter()
                c1, o1, _ = co.handle_generate(dict(b))
                h_co = handles["colocated"][-1]
                t_dis = time.perf_counter()
                c2, o2, _ = pair.handle_generate(dict(b))
                h_dec = handles["decode"][-1]
                rows.append(dict(L=len(b["input_ids"]), same=c1 == c2 == 200
                                 and o1["tokens"] == o2["tokens"],
                                 ttft_co=(h_co._submit_t + h_co.ttft_s - t_co) * 1e3,
                                 ttft_dis=(h_dec._submit_t + h_dec.ttft_s - t_dis) * 1e3,
                                 wall_dis=(time.perf_counter() - t_dis) * 1e3))
            picks = profiler.disagg_summary().get("pair_picks", 0) - before
            label = ("int8" if quant == "int8"
                     else str(model.lm_head.weight.dtype).removeprefix("torch."))
            check(f"(d) {label}: the prefill/decode pair behind the router, bit for "
                  "bit the colocated replica", all(r["same"] for r in rows)
                  and picks == len(rows) and len(handles["decode"]) == len(rows),
                  "; ".join(f"{r['L']} {'equal' if r['same'] else 'DIFFER'}"
                            for r in rows) + f"; pair picks {picks}")
            ttft[label] = rows
            log("fleet", f"record: {label} TTFT ms through the router, "
                         "disaggregated (three hops to the decode side's first "
                         "token) against colocated: " + "; ".join(
                             f"{r['L']}: {r['ttft_dis']:.1f} vs {r['ttft_co']:.1f} "
                             f"(pipeline wall {r['wall_dis']:.1f})" for r in rows)
                  + f"; medians {_p50([r['ttft_dis'] for r in rows]):.1f} vs "
                    f"{_p50([r['ttft_co'] for r in rows]):.1f} | {smi}")
            no_retrace(*engines.values())
            pair.stop()
            co.stop()
        finally:
            for srv, _ in servers.values():
                srv.stop()
        del engines, servers, handles
        if on_card:
            _free()
    figs["ttft"] = ttft

    # -- (e): session pins and an adapter-resident pick -----------------------
    reg = AdapterRegistry(cfg)
    make_random(reg, "a1", rank=8, seed=1)
    admitted = []
    engines = {rid: engine(lora=AdapterArena(reg, rank_max=8, device=device), **small)
               for rid in ("r0", "r1")}
    for rid, e in engines.items():
        _admissions(e, admitted, rid)
    servers = {rid: _fleet_serve(e) for rid, e in engines.items()}
    try:
        router = Router([Replica(rid, u) for rid, (_, u) in servers.items()],
                        probe_interval=3600, retry_backoff=0.01)
        router.probe_once()
        before = dict(profiler.router_summary())
        chat_rng = np.random.default_rng(7)
        convo, statuses = [], []
        for turn in range(5):
            if turn == 4:
                router.replicas[0].set_admin_draining(True)  # the pin breaks
            convo = convo + chat_rng.integers(1, cfg.vocab_size, size=chat_user).tolist()
            code, out, _ = router.handle_generate({"input_ids": convo,
                                                   "max_new_tokens": chat_new,
                                                   "session_id": "chat"})
            statuses.append(code)
            convo = out["tokens"] if code == 200 else convo
        g = profiler.router_summary()
        hits = g["session_pin_hits"] - before.get("session_pin_hits", 0)
        repins = g["session_repins"] - before.get("session_repins", 0)
        check("(e) a four-turn chat pinned to one replica, repinned once it drains",
              statuses == [200] * 5 and admitted == ["r0"] * 4 + ["r1"]
              and (hits, repins) == (3, 1) and router.healthz()["session_pins_by_replica"]
              == {"r1": 1}, f"statuses {statuses}, turns on {admitted}, pin hits "
              f"{hits}, repins {repins}")
        router.replicas[0].set_admin_draining(False)
        p = np.random.default_rng(9).integers(1, cfg.vocab_size, size=48).tolist()
        code, _, _ = _post_full(servers["r1"][1] + "/generate",
                                   {"input_ids": p, "max_new_tokens": 8, "adapter": "a1"})
        router.probe_once()
        del admitted[:]
        q = np.random.default_rng(10).integers(1, cfg.vocab_size, size=40).tolist()
        code2, out, _ = router.handle_generate({"input_ids": q, "max_new_tokens": 8,
                                                "adapter": "a1"})
        resident = router.replicas[1].snapshot()["lora_adapters"]
        check("(e) an adapter request lands on the replica holding it resident",
              code == code2 == 200 and admitted == ["r1"] and "a1" in resident
              and "a1" not in router.replicas[0].snapshot()["lora_adapters"],
              f"resident on r1 {resident}, admitted on {admitted}")
        no_retrace(*engines.values())
        router.stop()
    finally:
        for srv, _ in servers.values():
            srv.stop()
    del engines, servers
    if on_card:
        _free()

    # -- (f): the autoscaler 1 -> 2 -> 1 under a stepped workload -------------
    admitted = []
    spawned = {}
    ready_at = {}
    live = {"r0": engine(prefix_cache=False, **small)}  # rid -> engine
    _admissions(live["r0"], admitted, "r0")
    servers = {"r0": _fleet_serve(live["r0"])}
    router = Router([Replica("r0", servers["r0"][1])], probe_interval=0.05,
                    retry_backoff=0.02)

    def spawn(idx, tp):
        t = time.perf_counter()
        rid = f"as{idx}"
        live[rid] = engine(prefix_cache=False, **small)
        _admissions(live[rid], admitted, rid)
        servers[rid] = _fleet_serve(live[rid])
        spawned[rid] = t
        return Replica(rid, servers[rid][1])

    def stop(rep):
        no_retrace(live.pop(rep.rid))
        servers.pop(rep.rid)[0].stop()

    done = threading.Event()

    def watch():
        while not done.wait(0.01):
            for rep in router.replicas:
                if rep.rid in spawned and rep.rid not in ready_at and rep.state == "ready":
                    ready_at[rep.rid] = time.perf_counter()

    asc = Autoscaler(router, spawn_fn=spawn, stop_fn=stop, min_replicas=1,
                     max_replicas=2, interval=0.1, up_ticks=1, down_ticks=3,
                     up_cooldown=0.0, down_cooldown=1.0, up_drain_s=1e9,
                     up_queue_depth=0.5, up_miss_rate=1.0, min_page_free=0.0,
                     down_drain_s=1e9, tp_max=1, devices_total=1, drain_grace=30.0)
    watcher = threading.Thread(target=watch, daemon=True)
    try:
        router.start()
        watcher.start()
        asc.start()
        wl = Workload(vocab=cfg.vocab_size, **soak)
        report = run_soak(router, wl, threads=16)
        # the spawn runs inside a tick and may outlast the soak: wait for
        # the cycle's end (a scale-down back to one replica), not a sleep
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and not (
                profiler.autoscale_summary().get("scale_downs", 0) >= 1
                and len(router.replicas) == 1):
            time.sleep(0.05)
        s = report.summary()
        g = profiler.autoscale_summary()
        served = sorted(set(admitted))
        check("(f) the autoscaler scales 1 -> 2 -> 1 under the stepped workload, "
              "every request once", report.exactly_once and s["status_counts"]
              == {200: s["offered"]} and g.get("scale_ups") == 1
              and g.get("scale_downs") == 1 and g.get("replicas_peak") == 2
              and len(router.replicas) == 1,
              f"offered {s['offered']}, statuses {s['status_counts']}, "
              f"autoscaler {g}, replicas that served {served}")
        log("fleet", f"record: soak p50 {s['latency_p50_ms']} ms, p95 "
                     f"{s['latency_p95_ms']} ms over {s['offered']} requests in "
                     f"{s['wall_s']} s | {smi}")
        asc.stop()  # no scale-down races the check
        no_retrace(*live.values())
    finally:
        done.set()
        asc.stop()
        router.stop()
        for srv, _ in list(servers.values()):
            srv.stop()
    spawn_ready = [ready_at[r] - spawned[r] for r in spawned if r in ready_at]
    servers.clear()
    live.clear()
    if on_card:
        _free()
    # spawn-to-ready again outside the autoscaler: each spawn probed until
    # it reads ready, then stopped and freed before the next
    for k in range(FLEET_REPEATS[1]):
        t = time.perf_counter()
        rep = spawn(100 + k, 1)
        try:
            while rep.probe(timeout=5.0) is None or rep.state != "ready":
                if time.perf_counter() - t > 300:
                    break
                time.sleep(0.01)
            spawn_ready.append(time.perf_counter() - t if rep.state == "ready"
                               else float("nan"))
        finally:
            stop(rep)
        del rep
        if on_card:
            _free()
    figs["spawn_to_ready_s"] = statistics.median(spawn_ready) if spawn_ready \
        else float("nan")
    figs["spawn_to_ready_samples_s"] = spawn_ready
    check(f"(f) {1 + FLEET_REPEATS[1]} spawns read ready",
          len(spawn_ready) == 1 + FLEET_REPEATS[1] and all(x == x for x in spawn_ready),
          f"{len(spawn_ready)} samples")
    log("fleet", f"record: spawn-to-ready (engine build + warmup + serve() until a "
                 f"probe reads ready) over {len(spawn_ready)} spawns (the autoscaler's, "
                 f"then {FLEET_REPEATS[1]} alone): median {figs['spawn_to_ready_s']:.3f} s, "
                 f"samples {[round(x, 3) for x in spawn_ready]} | {smi}")
    counts = profiler.kernel_launch_counts()
    want = ("flash_fwd", "paged_decode_fused", "paged_decode_fused_q8")
    check("K1, K2 and K4 launched on the fleet's path (a)-(f)",
          all(counts.get(k, 0) > 0 for k in want) or not on_card,
          f"{ {k: counts.get(k, 0) for k in want} }")

    # -- (g): two tiny ReplicaProcess workers, one SIGKILLed ------------------
    tiny = LlamaForCausalLM(LlamaConfig.tiny(), device=device, seed=1234)
    local = ContinuousBatchingEngine(tiny, device=device, slots=2, max_len=64,
                                     prefill_buckets=[8, 16], queue_depth=32, seed=0)
    extra = () if on_card else ("--device", "cpu")
    procs = []
    for i in range(2):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        procs.append(ReplicaProcess(i, port, log_dir=str(obs_dir / "workers"),
                                    extra_args=extra))
    reps = [Replica(f"w{i}", p.url, process=p) for i, p in enumerate(procs)]
    router = Router(reps, probe_interval=0.1, retry_backoff=0.02)
    t0 = time.perf_counter()
    results, mu = [], threading.Lock()
    try:
        for p in procs:
            p.start()
        while time.perf_counter() - t0 < 300:
            router.probe_once()
            if all(r.state == "ready" for r in reps) or not all(p.alive() for p in procs):
                break
            time.sleep(0.2)
        boot_s = time.perf_counter() - t0
        booted = all(r.state == "ready" for r in reps)
        check("(g) two tiny workers ready", booted, f"{boot_s:.1f} s from spawn")
        if booted:
            router.start()
            load_rng = np.random.RandomState(7)

            def load(k):
                for i in range(worker_prompts):
                    time.sleep(float(load_rng.exponential(0.05)))
                    p = np.random.RandomState(1000 * k + i).randint(1, 250, size=6)
                    code, out, _ = router.handle_generate({"input_ids": p.tolist(),
                                                           "max_new_tokens": 4})
                    with mu:
                        results.append((p, code, out))

            threads = [threading.Thread(target=load, args=(k,)) for k in range(2)]
            for th in threads:
                th.start()
            time.sleep(0.3)
            inj.arm("router.replica.kill:1")
            for th in threads:
                th.join(600)
            inj.disarm()
            good = [(p, out) for p, code, out in results if code == 200]
            typed = all(out.get("type") for _, code, out in results if code != 200)
            same = all(out["tokens"] == local.generate(p.astype(np.int32),
                                                       max_new_tokens=4).tolist()
                       for p, out in good)
            killed = sum(not p.alive() for p in procs)
            check("(g) one worker SIGKILLed under load: every request once",
                  len(results) == 2 * worker_prompts and killed == 1 and typed and same
                  and len(good) >= len(results) - 4,
                  f"{len(results)} answers, {len(good)} 200 (each the in-process "
                  f"tiny engine's tokens: {same}), {killed} worker killed")
    finally:
        inj.disarm()
        router.stop()
        for p in procs:
            p.terminate()
    check("(g) every worker process reaped", not any(p.alive() for p in procs)
          and all(p.container.proc is None or p.container.proc.returncode is not None
                  for p in procs),
          f"exit codes {[p.container.proc and p.container.proc.returncode for p in procs]}")
    del tiny, local
    if obs_env is None:
        os.environ.pop("PADDLE_OBS_DIR", None)
    else:
        os.environ["PADDLE_OBS_DIR"] = obs_env
    g = profiler.router_summary()
    log("fleet", f"router counters {({k: v for k, v in g.items() if v})}; disagg "
                 f"{profiler.disagg_summary()}")
    return ok, [counts]


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------


def tp_twin(model, tp):
    """A tensor-parallel Llama (`tensor_parallel_degree` tp) over `model`'s
    own weights: built at the same config and dtype, then its parameters
    replaced by `model`'s tensors (`load_state_dict(assign=True)`), so the
    two share every weight and the ranks' blocks are views of them."""
    import dataclasses

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = dataclasses.replace(model.config, tensor_parallel_degree=tp)
    twin = LlamaForCausalLM(cfg, device=model.device,
                            dtype=model.lm_head.weight.dtype, seed=0)
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


def _tp_engine(model, tp, device, prefix_cache=False, **kw):
    """A warmed paged (or dense) engine at degree tp over `model` (a twin
    at tp > 1), every rank on `device`, named explicitly; prefix cache
    off unless asked for, so tokens compare across engines (the parity
    rule)."""
    from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine

    extra = dict(tp=tp, devices=[device] * tp) if tp > 1 else {}
    engine = ContinuousBatchingEngine(model, seed=0, device=device,
                                      prefix_cache=prefix_cache, **extra, **kw)
    engine.warmup()
    return engine


def _tp_run(engine, prompts, news, logits=False):
    """The requests submitted together, served to the end; (generated
    tokens per request, kept logits per request or None)."""
    import numpy as np

    reqs = [engine.submit(p, max_new_tokens=n, keep_logits=logits)
            for p, n in zip(prompts, news)]
    engine.run_until_idle()
    outs = [np.asarray(r.wait(1)[p.size:], np.int32) for r, p in zip(reqs, prompts)]
    return outs, [r.logits if logits else None for r in reqs]


def _tp_parity(phase, base, base_logits, got, got_logits=None, tie_rel=None):
    """Tokens of a tp run against the tp-1 run's: equal, or, with
    `tie_rel`, parting first where tp 1's top-2 logit gap is at most
    tie_rel x max|logit| (a near tie; None: no tie allowed).  With
    `got_logits`, prints D: max|diff| / max|logit| of the two runs' logits
    over the positions both reached with the same tokens.  Returns (ok,
    requests equal bit for bit, the printed divergences)."""
    import torch

    ok, same, notes, diffs = True, 0, [], []
    for i, (b, g) in enumerate(zip(base, got)):
        at = _first_divergence(g, b)
        if got_logits is not None:
            n = b.size if at is None else at + 1
            diffs.append(_rel_diff(torch.stack(got_logits[i][:n]),
                                   torch.stack(base_logits[i][:n])))
        if at is None:
            same += 1
            continue
        gap, top = _row_gap(base_logits[i][at])
        tie = tie_rel is not None and gap <= tie_rel * top
        ok &= tie
        notes.append(f"request {i} at {at}: top-2 gap {gap:.4f}, gap/max|logit| "
                     f"{gap / top:.3e} {'near tie' if tie else 'FAIL'}")
    if diffs:
        log(phase, f"logits against tp 1's, max|diff|/max|logit| per request: "
                   f"{', '.join(f'{d:.3e}' for d in diffs)}; max {max(diffs):.3e}")
    return ok, same, notes


def _tp_counts_ok(phase, counts, want, on_card):
    """The run's launch counts against `want` (every other kernel 0); on
    the CPU every count is 0."""
    expect = dict.fromkeys(counts, 0)
    if on_card:
        expect.update(want)
    ok = counts == expect
    log(phase, f"launches {_main(counts)} (expected {_main(expect)}) -> "
               f"{'ok' if ok else 'FAIL'}")
    return ok


def _reduce_ms(engine, cfg):
    """Milliseconds of one decode step's rank reduces and lm_head gather
    alone, at the step's shapes (slots x hidden partials of every rank,
    two reduces per layer, then the vocabulary gather), replayed as one
    CUDA graph: CUDA-event median of 20 replays."""
    import torch

    mesh, S = engine._mesh, engine.slots
    dt = engine.model.lm_head.weight.dtype
    dev = engine.device
    parts = [torch.randn(S, 1, cfg.hidden_size, device=dev, dtype=dt)
             for _ in range(mesh.mp)]
    blocks = [torch.randn(S, cfg.vocab_size // mesh.mp, device=dev, dtype=dt)
              for _ in range(mesh.mp)]

    def body():
        for _ in range(2 * cfg.num_hidden_layers):
            mesh.reduce(parts)
        mesh.all_gather(blocks)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    return time_ms(g.replay)


def phase_tp(smi, model, device="cuda", prompts_spec=SLICE_PROMPTS,
             degrees=TP_DEGREES, dense_prompts=TP_DENSE_PROMPTS,
             f32_layers=TP_F32_LAYERS, **engine_kw):
    """Tensor-parallel serving of `model` (the slice's Llama-2-7B, bf16, full
    width and depth) with every rank on the one card, named explicitly
    (`devices=[device] * tp`); the tp models are `tp_twin`s over the loaded
    weights.  Prefix cache off (tokens compare across engines).  Checks:
    at tp 1, then each degree of `degrees`, the slice's requests (at the
    last degree through POST /generate, the others submitted directly):
    tokens equal to tp 1's or parting at a near tie (TP_TIE_REL), K1 once
    per rank per layer per prefill, K2 once per rank per layer per decode
    step (the `paged_decode_tp` count too: tp x layers a step), no other
    kernel, no retrace, a prefill and a decode replay equal to eager bit
    for bit; a warm restart at the last degree gives the same tokens and
    traces nothing.  Then int8 pages at the last degree against int8 at
    tp 1 (K4 per rank); the dense pool at the last degree against tp 1's
    on `dense_prompts` requests (K2 per rank over its caches' page views);
    and a float32 Llama of `f32_layers` layers at full width, tp 1 against
    the last degree, tokens identical.  Prints decode ms a step and kernels
    per step at each degree (a profiled step), the reduce's share of the
    step, and K2/K4 launches per step.  Returns (all passed, the launch
    counts of every run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n, _ in prompts_spec]
    news = [new for _, new in prompts_spec]
    ok_all, all_counts, steps_ms = True, [], {}
    saved_mesh = tmesh.get_mesh()

    def check(phase, good, what):
        nonlocal ok_all
        ok_all &= bool(good)
        log(phase, f"{what} -> {'ok' if good else 'FAIL'}")

    try:
        # -- tp 1: the tokens every degree is held to ------------------------
        t0 = time.perf_counter()
        base_eng = _tp_engine(model, 1, device, **engine_kw)
        base, base_lg = _tp_run(base_eng, prompts, news, logits=True)
        prof = profile_decode(base_eng, cfg, rng) if on_card else None
        steps_ms[1] = prof
        del base_eng
        _free()
        log("tp 1", f"engine built, warmed and served in {time.perf_counter() - t0:.1f} s")
        last = degrees[-1]
        for tp in degrees:
            phase = f"tp {tp}"
            t0 = time.perf_counter()
            twin = tp_twin(model, tp)
            engine = _tp_engine(twin, tp, device, **engine_kw)
            warm = _warm_counts(phase, engine)
            health = engine.healthz()
            check(phase, health["tp"] == tp and health["mesh_shape"] == {"mp": tp},
                  f"/healthz tp {health['tp']}, mesh_shape {health['mesh_shape']}, "
                  f"devices {[str(d) for d in engine._mesh.devices]}")
            # -- the main path: the slice's requests -------------------------
            profiler.reset_kernel_launch_counts()
            profiler.reset_serving()
            if tp == last:
                results, wall = _serve_batches(
                    engine, [[(p, n) for p, n in zip(prompts, news)]])
                got = [np.asarray(r["tokens"][p.size:], np.int32)
                       for r, p in zip(results, prompts)]
            else:
                t1 = time.perf_counter()
                got, _ = _tp_run(engine, prompts, news)
                wall = time.perf_counter() - t1
            counts = profiler.kernel_launch_counts()
            summary = profiler.serving_summary()
            all_counts.append(counts)
            steps = summary["decode_steps"]
            ok_all &= _no_retrace(phase, engine, warm)
            ok_all &= _tp_counts_ok(phase, counts, {
                "flash_fwd": tp * len(prompts) * layers,
                "flash_fwd_wgmma": counts["flash_fwd_wgmma"] if on_card else 0,
                "paged_decode_fused": tp * layers * steps,
                "paged_decode_fused_walk": tp * layers * steps,
                "paged_decode_tp": tp * layers * steps}, on_card)
            log(phase, f"K2 launches per decode step {counts['paged_decode_tp'] / max(1, steps):.1f} "
                       f"(tp x layers = {tp * layers}) over {steps} steps; served "
                       f"{len(prompts)} requests in {wall:.3f} s"
                       f"{' over POST /generate' if tp == last else ''}")
            # the same traffic again with logits kept: D and the tie rule
            again, lg = _tp_run(engine, prompts, news, logits=True)
            good, same, notes = _tp_parity(phase, base, base_lg, got, lg, TP_TIE_REL)
            check(phase, good and all(np.array_equal(a, b) for a, b in zip(got, again)),
                  f"tokens against tp 1's: {same}/{len(prompts)} requests equal bit "
                  f"for bit; {notes or 'no divergence'} (TP_TIE_REL {TP_TIE_REL}); "
                  f"the run with kept logits repeats the first")
            ok_all &= check_replay(phase, engine, [prompts[0]], want=("prefill", "decode"))
            if on_card:
                steps_ms[tp] = profile_decode(engine, cfg, rng)
            if tp == last:
                # -- a warm restart keeps the rank arenas and the graphs -------
                ptrs = [[a.k.data_ptr() for a in ranks] for ranks in engine._arenas]
                engine.restart(reason="tp-drill")
                after, _ = _tp_run(engine, prompts[:1], news[:1])
                check(phase, np.array_equal(after[0], got[0])
                      and engine.compile_counts() == warm
                      and [[a.k.data_ptr() for a in r] for r in engine._arenas] == ptrs,
                      f"warm restart: request 0's tokens equal before and after, "
                      f"compile_counts {engine.compile_counts()}, the same arenas")
                if on_card:
                    red = _reduce_ms(engine, cfg)
                    wall_ms = steps_ms[tp]["wall_ms"] if steps_ms[tp] else float("nan")
                    log(phase, f"the reduce alone at the step's shapes ({2 * layers} "
                               f"rank reduces of {engine.slots} x {cfg.hidden_size} "
                               f"and the lm_head gather, one CUDA graph): "
                               f"{red:.4f} ms, {red / wall_ms:.3f} of the profiled "
                               f"decode step's {wall_ms:.3f} ms | {smi}")
            del engine, twin
            _free()
            log(phase, f"degree done in {time.perf_counter() - t0:.1f} s")
        parts = [f"tp {tp}: {p['wall_ms']:.3f} ms/step, {p['kernels_per_step']:.0f} "
                 f"kernels/step" for tp, p in steps_ms.items() if p]
        log("tp", f"decode step (8 slots at ~256 tokens) {'; '.join(parts) or 'not measured'} "
                  f"| {smi}")

        # -- int8 pages: K4 per rank ----------------------------------------
        phase = f"tp {last} int8"
        q1 = _tp_engine(model, 1, device, kv_quant="int8", **engine_kw)
        base8, base8_lg = _tp_run(q1, prompts, news, logits=True)
        del q1
        _free()
        twin = tp_twin(model, last)
        engine = _tp_engine(twin, last, device, kv_quant="int8", **engine_kw)
        warm = _warm_counts(phase, engine)
        profiler.reset_kernel_launch_counts()
        profiler.reset_serving()
        got8, lg8 = _tp_run(engine, prompts, news, logits=True)
        counts = profiler.kernel_launch_counts()
        steps = profiler.serving_summary()["decode_steps"]
        all_counts.append(counts)
        ok_all &= _no_retrace(phase, engine, warm)
        ok_all &= _tp_counts_ok(phase, counts, {
            "flash_fwd": last * len(prompts) * layers,
            "flash_fwd_wgmma": counts["flash_fwd_wgmma"] if on_card else 0,
            "paged_decode_fused_q8": last * layers * steps,
            "paged_decode_fused_q8_walk": last * layers * steps,
            "paged_decode_tp_q8": last * layers * steps}, on_card)
        good, same, notes = _tp_parity(phase, base8, base8_lg, got8, lg8, TP_TIE_REL)
        check(phase, good, f"tokens against int8 tp 1's: {same}/{len(prompts)} equal "
                           f"bit for bit; {notes or 'no divergence'}; K4 launches per "
                           f"step {counts['paged_decode_tp_q8'] / max(1, steps):.1f}")
        ok_all &= check_replay(phase, engine, [prompts[0]], want=("prefill", "decode"))
        del engine, twin
        _free()

        # -- the dense slot pool --------------------------------------------
        phase = f"tp {last} dense"
        dp, dn = prompts[:dense_prompts], news[:dense_prompts]
        d1 = _tp_engine(model, 1, device, paged=False, **engine_kw)
        based, based_lg = _tp_run(d1, dp, dn, logits=True)
        del d1
        _free()
        twin = tp_twin(model, last)
        engine = _tp_engine(twin, last, device, paged=False, **engine_kw)
        warm = _warm_counts(phase, engine)
        profiler.reset_kernel_launch_counts()
        profiler.reset_serving()
        gotd, _ = _tp_run(engine, dp, dn)
        counts = profiler.kernel_launch_counts()
        steps = profiler.serving_summary()["decode_steps"]
        all_counts.append(counts)
        ok_all &= _no_retrace(phase, engine, warm)
        ok_all &= _tp_counts_ok(phase, counts, {
            "flash_fwd": last * len(dp) * layers,
            "flash_fwd_wgmma": counts["flash_fwd_wgmma"] if on_card else 0,
            "paged_decode_fused": last * layers * steps,
            "paged_decode_fused_walk": last * layers * steps}, on_card)
        good, same, notes = _tp_parity(phase, based, based_lg, gotd, None, TP_TIE_REL)
        check(phase, good, f"tokens against the tp 1 dense pool's: {same}/{len(dp)} "
                           f"equal bit for bit; {notes or 'no divergence'}")
        ok_all &= check_replay(phase, engine, [prompts[0]], want=("prefill", "decode"))
        del engine, twin
        _free()

        # -- float32 at full width, f32_layers layers: identical tokens -------
        phase = f"tp {last} float32"
        tmesh.set_mesh(saved_mesh)  # a plain Llama: no 'mp' mesh installed
        f32 = LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_layers=f32_layers),
                               device=device, dtype="float32", seed=0)
        f1 = _tp_engine(f32, 1, device, **engine_kw)
        basef, basef_lg = _tp_run(f1, prompts, news, logits=True)
        del f1
        _free()
        twin = tp_twin(f32, last)
        engine = _tp_engine(twin, last, device, **engine_kw)
        warm = _warm_counts(phase, engine)
        profiler.reset_kernel_launch_counts()
        profiler.reset_serving()
        gotf, lgf = _tp_run(engine, prompts, news, logits=True)
        counts = profiler.kernel_launch_counts()
        steps = profiler.serving_summary()["decode_steps"]
        all_counts.append(counts)
        ok_all &= _no_retrace(phase, engine, warm)
        ok_all &= _tp_counts_ok(phase, counts, {
            "flash_fwd": last * len(prompts) * f32_layers,
            "paged_decode_fused": last * f32_layers * steps,
            "paged_decode_tp": last * f32_layers * steps}, on_card)
        good, same, notes = _tp_parity(phase, basef, basef_lg, gotf, lgf)
        check(phase, good and same == len(prompts),
              f"float32, {f32_layers} layers, TF32 and reduced-precision reductions "
              f"off: {same}/{len(prompts)} requests' tokens identical to tp 1's; "
              f"{notes or 'no divergence'}")
        del engine, twin, f32
        _free()
    finally:
        tmesh.set_mesh(saved_mesh)
    return ok_all, all_counts


def _tp_cp_run(engine, batches):
    """Each batch of (prompt, max_new_tokens) submitted together with
    logits kept and served to its end before the next (the first commits
    the document); (generated tokens, kept logits, requests), per request
    in order."""
    import numpy as np

    outs, logits, reqs = [], [], []
    for batch in batches:
        rs = [engine.submit(p, max_new_tokens=n, keep_logits=True) for p, n in batch]
        engine.run_until_idle()
        for r, (p, _) in zip(rs, batch):
            outs.append(np.asarray(r.wait(1)[p.size:], np.int32))
            logits.append(r.logits)
        reqs += rs
    return outs, logits, reqs


def _tp_cp_counts(tp, layers, misses, hits, steps, quant=False, wgmma=True):
    """The launches of a tp x cp run: K1 once per rank per layer per fresh
    prefill, K5 per head shard once per rank per layer per paged attention
    (each decode or verify step on the decode walk, each chunk prefill of
    a hit on the tensor-core window; both on the FMA walk in float32)."""
    k5 = "paged_decode_fused_cp" + ("_q8" if quant else "")
    want = {"flash_fwd": tp * misses * layers,
            k5: tp * layers * (steps + hits),
            "paged_decode_cp_tp" + ("_q8" if quant else ""): tp * layers * (steps + hits)}
    if wgmma:  # bf16: fresh prompts past 128 rows, chunks past 16
        want.update({"flash_fwd_wgmma": tp * misses * layers,
                     k5 + "_mma": tp * layers * hits, k5 + "_walk": tp * layers * steps})
    return want


def phase_tp_cp(smi, model, device="cuda", degrees=TP_CP, doc_len=CP_DOC_LEN,
                questions=CP_QUESTIONS, fresh=TP_CP_FRESH, new_tokens=CP_NEW,
                spec_k=TP_CP_SPEC_K, f32_layers=TP_F32_LAYERS, **engine_kw):
    """The tp phase's tp x cp part (K5 per head shard): the cp phase's
    document traffic (the first question alone so that it commits, then
    the others, prefix hits through their chunk windows, beside the fresh
    prompts), logits kept, through tp 1 x cp and tp x cp engines over
    `model` (a `tp_twin` at tp), prefix cache on in both, every rank on
    `device`.  Checks: both took the same hits; tokens equal to tp 1 x
    cp's up to the first parting and a near tie there (TP_TIE_REL); K5
    per head shard once per rank per layer per paged attention and no K2
    or K4; no retrace; /healthz's mesh; a prefill, a hit's chunk prefill
    and a decode replay equal to eager bit for bit.  Then int8 pages with
    spec_k at tp x cp (K4's pages through K5: launches, no retrace, a
    verify replay, logits against the teacher-forced forward within
    LOGIT_REL_TOL), and a float32 Llama of `f32_layers` layers at full
    width, tp x cp against tp 1 x cp 1, tokens identical.  Prints decode
    ms a step and kernels per step at tp x cp (a profiled step).  Returns
    (all passed, the launch counts of each tp x cp run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    tp, cp = degrees
    cfg = model.config
    layers = cfg.num_hidden_layers
    on_card = torch.device(device).type == "cuda"
    rng, doc, shared, others = _cp_traffic(cfg, doc_len, questions, fresh)
    spec = [(p, new_tokens) for p in shared + others]
    batches = [spec[:1], spec[1:]]
    ok_all, all_counts = True, []
    saved_mesh = tmesh.get_mesh()
    tag = f"tp {tp} x cp {cp}"

    def check(phase, good, what):
        nonlocal ok_all
        ok_all &= bool(good)
        log(phase, f"{what} -> {'ok' if good else 'FAIL'}")

    def reset():
        profiler.reset_kernel_launch_counts()
        profiler.reset_serving()
        profiler.reset_paging()
        profiler.reset_speculation()

    def served(phase, engine, warm, want_counts):
        """The run's counts, steps and hits after `_tp_cp_run`; checks the
        launches and that nothing traced."""
        nonlocal ok_all
        counts = profiler.kernel_launch_counts()
        steps = profiler.serving_summary()["decode_steps"]
        hits = profiler.paging_summary().get("prefix_hits", 0)
        all_counts.append(counts)
        ok_all &= _no_retrace(phase, engine, warm)
        ok_all &= _tp_counts_ok(phase, counts, want_counts(hits, steps), on_card)
        return counts, steps, hits

    try:
        # -- tp 1 x cp: the tokens tp x cp is held to -------------------------
        t0 = time.perf_counter()
        base_eng = _tp_engine(model, 1, device, prefix_cache=True, cp=cp, **engine_kw)
        reset()
        base, base_lg, _ = _tp_cp_run(base_eng, batches)
        base_hits = profiler.paging_summary().get("prefix_hits", 0)
        del base_eng
        _free()
        log(tag, f"tp 1 x cp {cp}: built, warmed and served {len(spec)} requests "
                 f"({base_hits} prefix hits) in {time.perf_counter() - t0:.1f} s")

        # -- tp x cp: the main path -------------------------------------------
        phase = tag
        t0 = time.perf_counter()
        twin = tp_twin(model, tp)
        engine = _tp_engine(twin, tp, device, prefix_cache=True, cp=cp, **engine_kw)
        warm = _warm_counts(phase, engine)
        health = engine.healthz()
        check(phase, health["tp"] == tp and health["cp"] == cp
              and health["mesh_shape"] == {"cp": cp, "mp": tp}
              and len(health["page_free_by_shard"]) == cp,
              f"/healthz tp {health['tp']} cp {health['cp']} mesh_shape "
              f"{health['mesh_shape']} page_free_by_shard "
              f"{health['page_free_by_shard']}, {engine.pool_pages} pages per rank "
              f"arena, devices {[str(d) for d in engine._mesh.devices]}")
        reset()
        got, lg, _ = _tp_cp_run(engine, batches)
        misses = len(spec) - base_hits
        counts, steps, hits = served(phase, engine, warm, lambda h, st: _tp_cp_counts(
            tp, layers, len(spec) - h, h, st))
        check(phase, hits == base_hits == len(shared) - 1,
              f"prefix hits {hits} at tp {tp} x cp {cp}, {base_hits} at tp 1 x cp "
              f"{cp} (expected {len(shared) - 1}): both ran K5's chunk window on "
              f"the same requests, {misses} fresh prefills")
        log(phase, f"K5 per head shard: {counts['paged_decode_cp_tp']} launches over "
                   f"{steps} decode steps and {hits} chunk prefills (tp x layers = "
                   f"{tp * layers} each: {tp * layers * (steps + hits)})")
        good, same, notes = _tp_parity(phase, base, base_lg, got, lg, TP_TIE_REL)
        check(phase, good, f"tokens against tp 1 x cp {cp}'s: {same}/{len(spec)} "
                           f"requests equal bit for bit; {notes or 'no divergence'} "
                           f"(TP_TIE_REL {TP_TIE_REL})")
        n = min(100, engine.max_len // 4)
        ok_all &= check_replay(phase, engine, [
            rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
            np.concatenate([doc, rng.integers(1, cfg.vocab_size, size=n)])
            .astype(np.int32)], want=("prefill", "chunk_prefill", "decode"))
        prof = profile_decode(engine, cfg, rng, prompt_len=doc_len) if on_card else None
        log(phase, f"decode step ({engine.slots} slots at ~{doc_len} tokens): "
                   + (f"{prof['wall_ms']:.3f} ms/step, {prof['kernels_per_step']:.0f} "
                      f"kernels/step" if prof else "not measured") + f" | {smi}")
        del engine
        _free()
        log(phase, f"done in {time.perf_counter() - t0:.1f} s")

        # -- int8 pages with speculation --------------------------------------
        phase = f"{tag} int8 spec{spec_k}"
        t0 = time.perf_counter()
        engine = _tp_engine(twin, tp, device, prefix_cache=True, cp=cp,
                            kv_quant="int8", spec_k=spec_k, **engine_kw)
        warm = _warm_counts(phase, engine)
        reset()
        got8, _, reqs = _tp_cp_run(engine, batches)
        counts, steps, hits = served(phase, engine, warm, lambda h, st: _tp_cp_counts(
            tp, layers, len(spec) - h, h, st, quant=True))
        spec_sum = profiler.speculation_summary()
        agree, total, worst, finite = _teacher_forced(
            model, device, [p for p, _ in spec], got8, reqs, phase)
        same = sum(int((a == b).sum()) for a, b in zip(got8, got))
        check(phase, worst <= LOGIT_REL_TOL and finite and hits == base_hits,
              f"teacher-forced greedy agreement {agree}/{total}; worst logits rel "
              f"err {worst:.4f} (tol {LOGIT_REL_TOL}); {hits} prefix hits; "
              f"tokens equal to bf16 tp {tp} x cp {cp}'s per position "
              f"{same}/{sum(g.size for g in got)}; speculation {spec_sum}")
        ok_all &= check_replay(phase, engine, [spec[-1][0][:200]], want=("verify",))
        del engine, reqs, twin
        _free()
        log(phase, f"done in {time.perf_counter() - t0:.1f} s")

        # -- float32 at full width, f32_layers layers: identical tokens -------
        phase = f"{tag} float32"
        t0 = time.perf_counter()
        tmesh.set_mesh(saved_mesh)  # a plain Llama: no 'mp' mesh installed
        f32 = LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_layers=f32_layers),
                               device=device, dtype="float32", seed=0)
        f1 = _tp_engine(f32, 1, device, prefix_cache=True, **engine_kw)
        basef, basef_lg, _ = _tp_cp_run(f1, batches)
        del f1
        _free()
        twin = tp_twin(f32, tp)
        engine = _tp_engine(twin, tp, device, prefix_cache=True, cp=cp, **engine_kw)
        warm = _warm_counts(phase, engine)
        reset()
        gotf, lgf, _ = _tp_cp_run(engine, batches)
        served(phase, engine, warm, lambda h, st: _tp_cp_counts(
            tp, f32_layers, len(spec) - h, h, st, wgmma=False))
        good, same, notes = _tp_parity(phase, basef, basef_lg, gotf, lgf)
        check(phase, good and same == len(spec),
              f"float32, {f32_layers} layers: tp {tp} x cp {cp} against tp 1 x cp 1, "
              f"{same}/{len(spec)} requests' tokens identical; "
              f"{notes or 'no divergence'}")
        del engine, twin, f32
        _free()
        log(phase, f"done in {time.perf_counter() - t0:.1f} s")
    finally:
        tmesh.set_mesh(saved_mesh)
    return ok_all, all_counts


def _handoff(pre, dec, prompt, new_tokens, logits=False):
    """One in-process handoff: `prompt` prefilled with one token and its
    rows exported by the prefill engine, then imported and decoded by the
    decode engine.  Returns (generated tokens, the payload, the decode
    request)."""
    import numpy as np

    h = pre.submit(prompt, max_new_tokens=1, export_kv=True)
    pre.run_until_idle()
    h.wait(60)
    payload = h.kv_export
    req = dec.submit(prompt, max_new_tokens=new_tokens, handoff=payload,
                     keep_logits=logits)
    dec.run_until_idle()
    return np.asarray(req.wait(60)[prompt.size:], np.int32), payload, req


def phase_tp_roles(smi, model, device="cuda", tp=TP_CP[0], lens=TP_ROLE_LENS,
                   new_tokens=TP_ROLE_NEW, f32_layers=TP_F32_LAYERS,
                   engine_kw=TP_ROLE_ENGINE):
    """The tp phase's roles part: tensor-parallel engines in the
    disaggregated roles, prefix cache off, every rank on `device`, handoffs
    in process (export at the prefill engine's finish, `submit(handoff=)`
    on the decode engine).  In `model`'s dtype: a tp prefill role handing
    off to a tp decode role gives a colocated tp engine's tokens bit for
    bit; tp -> 1 and 1 -> tp give a colocated engine of the decode side's
    degree's tokens up to the first parting and a near tie there
    (TP_TIE_REL); the decode side launches K2 per head shard (tp x layers
    a step) or K2 (layers a step); one import replay equals eager bit for
    bit.  Over int8 pages one tp -> 1 pair, tied the same way.  Then a
    float32 Llama of `f32_layers` layers at full width: every pair's tokens
    identical to a colocated tp 1 engine's.  Wire bytes per prompt token
    equal tp 1's: 2 x layers x kv_heads x head_dim x the element's bytes
    (524,288 for Llama-2-7B in bf16).  Prints the per-stage handoff ms of
    every pair in `model`'s dtype, a tp 1 -> tp 1 pair among them.  Returns
    (all passed, [the launch counts of the part])."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.inference import engine as engine_mod
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = model.config
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    ok_all = True
    saved_mesh = tmesh.get_mesh()

    def check(phase, good, what):
        nonlocal ok_all
        ok_all &= bool(good)
        log(phase, f"{what} -> {'ok' if good else 'FAIL'}")

    def wire(mdl, quant):
        c = mdl.config
        row = c.head_dim + 4 if quant == "int8" else \
            c.head_dim * mdl.lm_head.weight.element_size()
        return 2 * c.num_hidden_layers * _kv_heads(c) * row

    def run_pass(label, models, quant, pairs, identical, timed=False):
        """Engines at each degree of `models` (colocated, prefill, decode as
        the pairs need), each pair's handoffs against the colocated engine
        of the decode side's degree (of tp 1 with `identical`); with
        `timed`, each pair's per-stage handoff ms."""
        nonlocal ok_all
        phase = f"tp roles {label}"
        t0 = time.perf_counter()
        need = {(a, "prefill") for a, _ in pairs} | {(b, "decode") for _, b in pairs}
        need |= {(1 if identical else b, "colocated") for _, b in pairs}
        eng = {(d, role): _tp_engine(models[d], d, device, role=role, kv_quant=quant,
                                     **engine_kw)
               for d, role in sorted(need)}
        warm = {k: e.compile_counts() for k, e in eng.items()}
        base = {}
        for (d, role), e in eng.items():
            if role == "colocated":
                base[d] = _tp_run(e, prompts, [new_tokens] * len(prompts), logits=True)
        times = {pair: {k: [] for k in ("export", "serialize", "stage", "import")}
                 for pair in pairs}
        cur = [None]
        serialize = engine_mod.serialize_kv_handoff
        if timed:
            # what the hops cost at each pair's degrees: the export's gather,
            # join and copy, its serialization, the decode side's staging and
            # import (the tp 1 -> tp 1 pair is the baseline of the join)
            def timed_fn(what, fn):
                def run(*a, **kw):
                    t = time.perf_counter()
                    try:
                        return fn(*a, **kw)
                    finally:
                        times[cur[0]][what].append((time.perf_counter() - t) * 1e3)
                return run

            for (d, role), e in eng.items():
                if role == "prefill":
                    e._export_rows_locked = timed_fn("export", e._export_rows_locked)
                elif role == "decode":
                    e._stage_handoff = timed_fn("stage", e._stage_handoff)
                    e._import_into_paged = timed_fn("import", e._import_into_paged)
            engine_mod.serialize_kv_handoff = timed_fn("serialize", serialize)
        try:
            for a, b in pairs:
                pre, dec = eng[(a, "prefill")], eng[(b, "decode")]
                cur[0] = (a, b)
                ref, ref_lg = base[1 if identical else b]
                c0, r0 = profiler.kernel_launch_counts(), dec._decode_g.replay_count
                got, per_tok = [], set()
                for p in prompts:
                    toks, payload, _ = _handoff(pre, dec, p, new_tokens)
                    got.append(toks)
                    per_tok.add(payload["payload_bytes"] / p.size)
                c1, steps = profiler.kernel_launch_counts(), dec._decode_g.replay_count - r0
                layers = models[b].config.num_hidden_layers
                key = ("paged_decode_tp" if b > 1 else "paged_decode_fused") + (
                    "_q8" if quant == "int8" else "")
                want = (b if b > 1 else 1) * layers * steps if on_card else 0
                counted = c1[key] - c0[key]
                good, same, notes = _tp_parity(phase, ref, ref_lg, got, None,
                                               None if (identical or a == b) else TP_TIE_REL)
                check(phase, good and (same == len(prompts) if identical or a == b else True)
                      and counted == want and per_tok == {wire(models[b], quant)},
                      f"tp {a} prefill -> tp {b} decode: {same}/{len(prompts)} "
                      f"requests' tokens equal a colocated tp "
                      f"{1 if identical else b} engine's bit for bit; "
                      f"{notes or 'no divergence'}; wire bytes per prompt token "
                      f"{sorted(per_tok)} (tp 1's: {wire(models[b], quant)}); decode "
                      f"side {key} launches {counted} over {steps} steps "
                      f"(expected {want})")
        finally:
            engine_mod.serialize_kv_handoff = serialize
        for (d, role), e in eng.items():
            ok_all &= _no_retrace(f"{phase} tp {d} {role}", e, warm[(d, role)])
            if role == "decode" and d > 1:
                ok_all &= check_import_replay(f"{phase} tp {d}", e)
        if timed:
            for a, b in pairs:
                t = times[(a, b)]
                log(phase, f"handoff ms at tp {a} -> tp {b}, per request (prompt "
                           f"tokens: export gather + join + copy, serialize, "
                           f"decode-side stage, import): " + "; ".join(
                               f"{L}: {t['export'][i]:.2f}, {t['serialize'][i]:.2f}, "
                               f"{t['stage'][i]:.2f}, {t['import'][i]:.2f}"
                               for i, L in enumerate(lens)) + f" | {smi}")
        del eng, base
        _free()
        log(phase, f"done in {time.perf_counter() - t0:.1f} s")

    profiler.reset_kernel_launch_counts()
    try:
        twin = tp_twin(model, tp)
        models = {1: model, tp: twin}
        run_pass(str(model.lm_head.weight.dtype).removeprefix("torch."), models,
                 "none", [(tp, tp), (tp, 1), (1, tp), (1, 1)], False, timed=True)
        run_pass("int8", models, "int8", [(tp, 1)], False)
        del twin, models
        _free()
        tmesh.set_mesh(saved_mesh)  # a plain Llama: no 'mp' mesh installed
        f32 = LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_layers=f32_layers),
                               device=device, dtype="float32", seed=0)
        run_pass("float32", {1: f32, tp: tp_twin(f32, tp)}, "none",
                 [(tp, tp), (tp, 1), (1, tp)], True)
        del f32
        _free()
        counts = profiler.kernel_launch_counts()
    finally:
        tmesh.set_mesh(saved_mesh)
    return ok_all, [counts]


def _device_profile(run, steps):
    """Run `run()` `steps` times under torch.profiler.  Returns (wall us,
    {kernel name: device us}, {annotated range: device us}, {"host_us":
    the host's time until the last call returned, before the final sync,
    "kernels": kernels run}); the kernel dict is empty when the profiler
    saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        host_us = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, spans, n = {}, {}, 0
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
            n += ev.count
    return wall_us, kernels, spans, {"host_us": host_us, "kernels": n}


# device time by kind of kernel, matched on the kernel's name
KERNEL_GROUPS = (
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "splitKreduce")),
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K3 flash_bwd", ("flash_bwd", "delta_kernel")),
    # the chunk windows (16+ rows) of K2, K4 and K5 run paged_chunk_mma_kernel,
    # their decode and verify steps (under 16 rows, bf16 q) the decode walk,
    # float32 the FMA page walk (paged_decode_kernel; over int8 "signed
    # char" pages K4's); K5 is the same templates with every shard in one
    # launch, and no step runs both K2 and K5, so under cp these rows are
    # K5; all share the split combine kernel
    ("K2/K4/K5 chunk window (tensor cores)", ("paged_chunk_mma_kernel",)),
    ("K2/K4/K5 decode walk", ("paged_walk_kernel",)),
    ("K4/K5-int8 FMA walk", ("paged_decode_kernel<__nv_bfloat16, signed char",
                             "paged_decode_kernel<__half, signed char",
                             "paged_decode_kernel<float, signed char")),
    ("K2/K5 FMA walk", ("paged_decode_kernel<",)),
    ("K2/K4/K5 split combine", ("combine_kernel<",)),
    ("adam_fused", ("adam_multi_kernel", "adam_pows_kernel")),
    ("unscale_fused", ("unscale_multi_kernel",)),
)


def _log_profile(what, wall_us, kernels, spans, steps, top=8, stats=None):
    """Print the step's wall time, the device's busy time and idle share,
    the host's time until the last step returned and the kernels a step
    ran (`stats` of `_device_profile`), the device time by kind of kernel,
    annotated ranges, and the top kernels ("not measured" when the
    profiler saw no device time)."""
    busy = sum(kernels.values())
    if busy <= 0:
        log("profile", "device time not measured (the profiler saw no kernels)")
        return None
    extra = ""
    if stats:
        n = stats["kernels"] / steps
        idle_us = (wall_us - busy) / steps
        extra = (f"; host until the last step returned "
                 f"{stats['host_us'] / steps / 1e3:.3f} ms/step; {n:.0f} "
                 f"kernels/step, idle {idle_us / max(n, 1):.2f} us per kernel")
    log("profile", f"{what}: wall {wall_us / steps / 1e3:.3f} ms/step, device "
                   f"busy {busy / steps / 1e3:.3f} ms/step, idle share "
                   f"{1 - busy / wall_us:.3f}{extra}")
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
    return dict(wall_ms=wall_us / steps / 1e3, busy_ms=busy / steps / 1e3,
                idle_share=1 - busy / wall_us,
                kernels_per_step=stats["kernels"] / steps if stats else None)


def _log_adamw_span(phase, spans, was_ms=None):
    """AdamW's range on the device (torch's `Optimizer.step#AdamW.step`
    annotation) per profiled step, beside an earlier run's figure."""
    ms = sum(us for name, us in spans.items() if "Optimizer.step" in name) / 1e3
    was = f" (as per-parameter torch ops: {was_ms} ms)" if was_ms else ""
    log(phase, f"AdamW's span {ms:.3f} ms on the device, one adam_fused launch{was}")


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

    wall_us, kernels, spans, stats = _device_profile(admit, len(prompts))
    engine.run_until_idle()
    for r in reqs:
        r.wait(1)
    _log_profile(f"prefix-hit admission (chunk prefill of "
                 f"{[p.size for p in prompts]}-token prompts + one decode step)",
                 wall_us, kernels, spans, len(prompts), stats=stats)


def profile_decode(engine, cfg, rng, prompt_len=256, steps=8, adapters=None):
    """Where a decode step's time goes: every slot busy at ~prompt_len
    tokens, `steps` steps under torch.profiler; `adapters` names each
    slot's LoRA adapter (an engine with `lora=`)."""
    adapters = adapters or [None] * engine.slots
    reqs = [engine.submit(rng.integers(1, cfg.vocab_size, size=prompt_len),
                          max_new_tokens=steps + 4, adapter=a)
            for a in adapters]
    engine.step()  # admits every slot (prefills) and decodes once
    engine.step()
    # each step ends in the host fetch of the step's tokens
    wall_us, kernels, spans, stats = _device_profile(engine.step, steps)
    engine.run_until_idle()
    for r in reqs:  # a request that failed would leave its slot out
        r.wait(1)
    lora = sum(a is not None for a in adapters)
    return _log_profile(f"decode step, {engine.slots} slots at ~{prompt_len} tokens"
                        + (f", {lora} of them on LoRA adapters" if lora else ""),
                        wall_us, kernels, spans, steps, stats=stats)


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


def _train_step(model, opt, ids, labels=None):
    loss, _ = model(ids, labels=ids if labels is None else labels)
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
        parity_matmuls()
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
    # and every K3 launch the wgmma kernels
    want_bwd_wgmma = want_bwd if on_card else 0
    # and every AdamW step one adam_fused launch (no unscale: no scaler)
    want_adam = steps if on_card else 0
    counts_ok = (counts["flash_fwd"] == want_fwd and counts["flash_bwd"] == want_bwd
                 and counts["flash_fwd_wgmma"] == want_wgmma
                 and counts["flash_bwd_wgmma"] == want_bwd_wgmma
                 and counts["adam_fused"] == want_adam
                 and counts["unscale_fused"] == 0)
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
                 f"{want_bwd}, each on its wgmma kernels: flash_bwd_wgmma "
                 f"{want_bwd_wgmma}; adam_fused {want_adam} = one per step) -> "
                 f"{'ok' if counts_ok else 'FAIL'}; weights moved "
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
        wall_us, kernels, spans, stats = _device_profile(
            lambda: _train_step(model, opt, ids), 1)
        _log_profile(f"training step, batch {batch} x {seq}, {layers} layers",
                     wall_us, kernels, spans, 1, top=12, stats=stats)
        _log_adamw_span("train", spans, ADAMW_SPAN_WAS.get(("train", layers)))
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


# ---------------------------------------------------------------------------
# the training loop: hapi.Model.fit over the io DataLoader, checkpoints
# ---------------------------------------------------------------------------

FIT_SEQS = 32  # training sequences: 8 steps of TRAIN_BATCH
FIT_EVAL_SEQS = 16  # held out: 4 evaluate batches
FIT_VOCAB = 4000  # token ids drawn from [1, FIT_VOCAB): a distribution to learn
FIT_LOG_FREQ = 4
FIT_RESUME_LAYERS = 2  # the 8-layer state would be a ~26 GB checkpoint
FIT_RESUME_AT = 4  # steps before the checkpoint of the resume drill
FIT_LOADER_SEED = 7
FIT_BERT_SEQS = 192
FIT_BERT_BOUNDS = (128, 256, 384)
FIT_BERT_LENS = (64, 384)
FIT_CKPT = ROOT / "build" / "fit_ckpt"  # inside the checkout, gitignored
_FIGURES = {}  # figures a later phase prints beside its own


def _fit_tokens(cfg, n, seq, seed):
    """n rows of `seq` token ids from [1, FIT_VOCAB) and their next-token
    labels (the last position ignored), int32 numpy."""
    import numpy as np

    ids = np.random.default_rng(seed).integers(
        1, min(FIT_VOCAB, cfg.vocab_size), size=(n, seq)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((n, 1), -100, np.int32)], axis=1)
    return ids, labels


def _fit_loader(ids, labels, device, batch, seed=FIT_LOADER_SEED, shuffle=True,
                workers=2, prefetch=2):
    """The user's loader: a seeded shuffle, two worker processes and the
    device prefetch stage."""
    import torch

    from paddle_tpu_torch import io

    return io.DataLoader(io.TensorDataset([ids, labels]), batch_size=batch,
                         shuffle=shuffle, generator=torch.Generator().manual_seed(seed),
                         num_workers=workers, prefetch_to_device=prefetch, device=device)


def _step_log():
    """A callback keeping each step's loss (a float at a fetch, else the
    tensor, left on the card) and the host time at each step's end."""
    from paddle_tpu_torch.hapi import Callback

    class StepLog(Callback):
        def __init__(self):
            self.losses, self.t, self.after_first = [], [], None

        def on_train_batch_begin(self, step, logs=None):
            if step == 1:  # record_step has counted step 0 (first use costs)
                from paddle_tpu_torch import profiler

                self.after_first = profiler.metrics_snapshot()["step"]

        def on_train_batch_end(self, step, logs=None):
            self.t.append(time.perf_counter())
            self.losses.append(logs["loss"])

        def values(self):
            return [x if isinstance(x, float) else x.item() for x in self.losses]

        def step_s(self):
            gaps = [b - a for a, b in zip(self.t, self.t[1:])]
            return statistics.median(gaps) if gaps else float("nan")

    return StepLog()


def _train_metrics():
    """The paddle_train_* values of the /metrics renderer."""
    from paddle_tpu_torch.obs import metrics

    return {line.split()[0]: float(line.split()[1])
            for line in metrics.render().splitlines()
            if line.startswith("paddle_train_")}


def phase_fit(smi, cfg, device="cuda", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              n_train=FIT_SEQS, n_eval=FIT_EVAL_SEQS, seed=0):
    """`Model.fit` on the train phase's model (bf16 O2, AdamW) over a
    seeded, shuffled DataLoader with two workers and device prefetch, one
    epoch, log_freq 4, FLAGS_max_inflight_steps 2, the loss `sequence_ce`
    over next-token labels; then `evaluate` over held-out batches; then a
    hand-written loop (`_train_step`) on a model from the same seed over
    the same batches, built after the first is freed.  Checks: finite,
    falling losses equal to the hand loop's bit for bit; one host fetch
    per window; paddle_train_steps_total and _inflight_max on /metrics;
    K1, K3 and adam_fused launches equal the hand loop's; evaluate
    launches K1 only and its mean loss equals a no_grad loop's; no worker
    left.  Returns (ok, counts of the fit run, counts of evaluate)."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from paddle_tpu_torch import Model, profiler
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.models._utils import sequence_ce

    on_card = torch.device(device).type == "cuda"
    if on_card:
        parity_matmuls()
        torch.cuda.reset_peak_memory_stats()
    layers = cfg.num_hidden_layers
    ids, labels = _fit_tokens(cfg, n_train, seq, seed)
    eval_ids, eval_labels = _fit_tokens(cfg, n_eval, seq, seed + 1)
    steps, eval_steps = n_train // batch, n_eval // batch
    core.set_flags({"FLAGS_max_inflight_steps": 2})

    # -- the main path: Model.fit, then Model.evaluate ------------------------
    t0 = time.perf_counter()
    net, opt = _train_model(cfg, device, seed=seed)
    model = Model(net)
    model.prepare(opt, sequence_ce)
    log("fit", f"Llama {cfg.hidden_size} hidden x {layers} layers, bf16 O2 + AdamW "
               f"masters, built in {time.perf_counter() - t0:.1f} s; {n_train} "
               f"sequences x {seq} tokens, batch {batch}, shuffled from a seeded "
               f"torch.Generator, 2 workers, prefetch_to_device 2")
    loader = _fit_loader(ids, labels, device, batch)
    steplog = _step_log()
    profiler.reset()
    profiler.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    hist = model.fit(loader, epochs=1, log_freq=FIT_LOG_FREQ, verbose=0,
                     callbacks=[steplog])
    if on_card:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = profiler.kernel_launch_counts()
    train = _train_metrics()
    snap = profiler.metrics_snapshot()["step"]
    fit_losses = steplog.values()
    after_first = steplog.after_first
    fetches = model.fetches
    eval_loader = _fit_loader(eval_ids, eval_labels, device, batch, shuffle=False)
    profiler.reset_kernel_launch_counts()
    result = model.evaluate(eval_loader, verbose=0)
    eval_counts = profiler.kernel_launch_counts()
    with torch.no_grad():  # the same batches by hand, for the mean
        hand_eval = []
        for lo in range(0, n_eval, batch):
            x = torch.from_numpy(eval_ids[lo:lo + batch]).to(device)
            y = torch.from_numpy(eval_labels[lo:lo + batch]).to(device)
            hand_eval.append(net(x, labels=y)[0])
        hand_mean = float(torch.stack(hand_eval).float().cpu().numpy().mean())
    peak_fit = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    fit_step_s = steplog.step_s()
    del net, opt, model, loader, eval_loader, steplog
    _free()

    # -- the comparison: the same steps by hand, a model from the same seed ---
    net, opt = _train_model(cfg, device, seed=seed)
    hand_loader = _fit_loader(ids, labels, device, batch)
    profiler.reset_kernel_launch_counts()
    hand_losses, secs = [], []
    for x, y in hand_loader:
        t0 = time.perf_counter()
        hand_losses.append(_train_step(net, opt, x, y).item())
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    hand_counts = profiler.kernel_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    del net, opt, hand_loader
    left = mp.active_children()

    finite = all(np.isfinite(fit_losses)) and len(fit_losses) == steps
    falls = finite and fit_losses[-1] < fit_losses[0]
    same = fit_losses == hand_losses
    worst = max((abs(a - b) for a, b in zip(fit_losses, hand_losses)), default=0.0)
    want_windows = math.ceil(steps / FIT_LOG_FREQ) + (1 if (steps - 1) % FIT_LOG_FREQ else 0)
    fetch_ok = fetches == want_windows
    metrics_ok = (train.get("paddle_train_steps_total") == steps
                  and 0 <= train.get("paddle_train_inflight_max", -1) <= 2)
    keys = ("flash_fwd", "flash_bwd", "adam_fused")
    want_fit = {"flash_fwd": layers * steps, "flash_bwd": layers * steps,
                "adam_fused": steps} if on_card else dict.fromkeys(keys, 0)
    counts_ok = all(fit_counts[k] == hand_counts[k] == want_fit[k] for k in keys)
    eval_ok = (eval_counts["flash_fwd"] == (layers * eval_steps if on_card else 0)
               and eval_counts["flash_bwd"] == 0 and eval_counts["adam_fused"] == 0
               and result["loss"] == hand_mean)
    mem_ok = not on_card or peak < 80.0
    log("fit", "losses " + " ".join(f"{x:.4f}" for x in fit_losses)
               + f" (epoch mean {hist[0]:.4f}): finite {finite}, last < first {falls}")
    log("fit", f"hand loop over the same batches: " + " ".join(f"{x:.4f}" for x in hand_losses)
               + f"; equal bit for bit {same} (worst |difference| {worst:.3e}) -> "
               + ("ok" if same else "FAIL"))
    log("fit", f"host fetches {fetches} for {steps} steps at log_freq {FIT_LOG_FREQ} "
               f"(one per window: {want_windows}) -> {'ok' if fetch_ok else 'FAIL'}; "
               f"/metrics paddle_train_steps_total {train.get('paddle_train_steps_total')}"
               f", paddle_train_inflight_max {train.get('paddle_train_inflight_max')} "
               f"(<= 2) -> {'ok' if metrics_ok else 'FAIL'}")
    log("fit", f"launches fit {_main(fit_counts)}, hand loop {_main(hand_counts)} "
               f"(expected {want_fit}) -> {'ok' if counts_ok else 'FAIL'}")
    log("fit", f"evaluate over {eval_steps} batches: mean loss {result['loss']:.6f}, "
               f"no_grad loop {hand_mean:.6f}; launches {_main(eval_counts)} "
               f"(flash_fwd {layers * eval_steps if on_card else 0}, no flash_bwd "
               f"or adam_fused) -> {'ok' if eval_ok else 'FAIL'}")
    hand_step_s = statistics.median(secs[1:])
    first = after_first or dict.fromkeys(snap, 0)
    per = max(snap["steps"] - first["steps"], 1)
    split = {k: (snap[k] - first[k]) / per * 1e3
             for k in ("host_blocked_s", "dispatch_s", "wall_s")}
    log("fit", f"fit step_ms median of steps 2-{steps} {fit_step_s * 1e3:.1f} "
               f"(whole fit {fit_s:.2f} s), tokens_per_s {batch * seq / fit_step_s:.1f}; "
               f"hand loop step_ms {hand_step_s * 1e3:.1f} (all: "
               + " ".join(f"{x * 1e3:.1f}" for x in secs)
               + f"), tokens_per_s {batch * seq / hand_step_s:.1f}; record_step per "
               f"step over steps 2-{steps}: host blocked on the ring "
               f"{split['host_blocked_s']:.2f} ms, dispatch {split['dispatch_s']:.2f} "
               f"ms, wall {split['wall_s']:.2f} ms (step 1: dispatch "
               f"{first['dispatch_s'] * 1e3:.2f} ms), inflight max "
               f"{snap['inflight_max']}; peak_mem_gib fit {peak_fit:.2f}, both "
               f"{peak:.2f} (< 80 -> {'ok' if mem_ok else 'FAIL'}); workers left "
               f"{len(left)} | {smi}")
    ok = (finite and falls and same and fetch_ok and metrics_ok and counts_ok
          and eval_ok and mem_ok and not left)
    return ok, fit_counts, eval_counts


def phase_fit_resume(smi, cfg, device="cuda", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     n_train=FIT_SEQS, seed=0, root=FIT_CKPT):
    """Exactly-once resume: an 8-step fit that commits a checkpoint (model,
    optimizer, loader position) after step FIT_RESUME_AT, then a model from
    another seed and a loader from another generator seed `load_latest`
    and fit on: their steps equal the uninterrupted run's bit for bit.
    Prints the bytes written and the seconds to save and to load; deletes
    the checkpoints.  Returns ok."""
    import numpy as np
    import torch

    from paddle_tpu_torch import Model
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.hapi import Callback
    from paddle_tpu_torch.models._utils import sequence_ce

    on_card = torch.device(device).type == "cuda"
    ids, labels = _fit_tokens(cfg, n_train, seq, seed)
    shutil.rmtree(root, ignore_errors=True)
    saved = {}

    class SaveAt(Callback):
        def __init__(self, net, opt, loader):
            self.net, self.opt, self.loader = net, opt, loader

        def on_train_batch_end(self, step, logs=None):
            if step + 1 != FIT_RESUME_AT:
                return
            t0 = time.perf_counter()
            path = checkpoint.save_checkpoint(
                {"model": self.net.state_dict(), "opt": self.opt.state_dict()},
                str(root), step=FIT_RESUME_AT, data_loader=self.loader)
            saved["s"] = time.perf_counter() - t0
            saved["bytes"] = sum(f.stat().st_size for f in pathlib.Path(path).iterdir())
            saved["consumed"] = self.loader.state_dict()["batches_consumed"]

    net, opt = _train_model(cfg, device, seed=seed)
    model = Model(net)
    model.prepare(opt, sequence_ce)
    loader = _fit_loader(ids, labels, device, batch)
    steplog = _step_log()
    model.fit(loader, epochs=1, log_freq=FIT_LOG_FREQ, verbose=0,
              callbacks=[steplog, SaveAt(net, opt, loader)])
    whole = steplog.values()
    del net, opt, model, loader, steplog
    _free()

    net, opt = _train_model(cfg, device, seed=seed + 1)  # overwritten by the load
    loader = _fit_loader(ids, labels, device, batch, seed=FIT_LOADER_SEED + 1000)
    state = {"model": net.state_dict(), "opt": opt.state_dict()}
    t0 = time.perf_counter()
    step = checkpoint.load_latest(state, str(root), data_loader=loader)
    opt.load_state_dict(state["opt"])
    if on_card:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model = Model(net)
    model.prepare(opt, sequence_ce)
    steplog = _step_log()
    model.fit(loader, epochs=1, log_freq=FIT_LOG_FREQ, verbose=0, callbacks=[steplog])
    resumed = steplog.values()
    del net, opt, model, loader, steplog, state
    shutil.rmtree(root, ignore_errors=True)

    ok = (step == FIT_RESUME_AT and saved.get("consumed") == FIT_RESUME_AT
          and resumed == whole[FIT_RESUME_AT:] and all(np.isfinite(whole)))
    log("fit", f"resume drill, {cfg.num_hidden_layers} layers: uninterrupted "
               + " ".join(f"{x:.4f}" for x in whole)
               + f"; resumed from step {step} (loader at batch {saved.get('consumed')}) "
               + " ".join(f"{x:.4f}" for x in resumed)
               + f"; steps {FIT_RESUME_AT + 1}-{len(whole)} equal bit for bit "
               f"{resumed == whole[FIT_RESUME_AT:]} -> {'ok' if ok else 'FAIL'}")
    log("fit", f"checkpoint {saved.get('bytes', 0)} bytes, save "
               f"{saved.get('s', float('nan')):.2f} s "
               f"({saved.get('bytes', 0) / max(saved.get('s', 1e-9), 1e-9) / 1e9:.2f} GB/s), "
               f"load {load_s:.2f} s "
               f"({saved.get('bytes', 0) / max(load_s, 1e-9) / 1e9:.2f} GB/s); "
               f"removed {not root.exists()} | {smi}")
    return ok


def phase_fit_diverge(smi, cfg, device="cuda", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      n_train=FIT_SEQS, seed=0, max_bad=3, log_freq=2):
    """`fit(max_bad_steps=3, log_freq=2)` on a model under SGD at 1e30 (bf16
    O2): NonFiniteLossError within max_bad + log_freq steps of the first
    non-finite loss, and no worker left.  Returns ok."""
    import multiprocessing as mp

    import numpy as np

    from paddle_tpu_torch import Model, amp, optimizer
    from paddle_tpu_torch.fault import NonFiniteLossError
    from paddle_tpu_torch.models._utils import sequence_ce
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ids, labels = _fit_tokens(cfg, n_train, seq, seed)
    net = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=seed).train()
    opt = optimizer.SGD(learning_rate=1e30, parameters=net.named_parameters())
    net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
    model = Model(net)
    model.prepare(opt, sequence_ce)
    from paddle_tpu_torch.hapi import Callback

    seen = []

    class Read(Callback):  # a check, not the path: reads every step's loss
        def on_train_batch_end(self, step, logs=None):
            seen.append(float(logs["loss"]))

    raised = None
    try:
        model.fit(_fit_loader(ids, labels, device, batch), epochs=2, log_freq=log_freq,
                  max_bad_steps=max_bad, verbose=0, callbacks=[Read()])
    except NonFiniteLossError as e:
        raised = e
    ran = len(seen) + (raised is not None)
    bad = [i for i, v in enumerate(seen) if not np.isfinite(v)]
    first = bad[0] if bad else None
    left = mp.active_children()
    ok = (raised is not None and first is not None
          and ran - first <= max_bad + log_freq and not left)
    del net, opt, model
    log("fit", f"divergence drill, SGD at 1e30: losses "
               + " ".join(f"{x:.3g}" for x in seen)
               + f"; NonFiniteLossError {'raised' if raised else 'NOT raised'} after "
               f"{ran} steps, the first non-finite at step {first} (bound "
               f"{max_bad} + {log_freq}); workers left {len(left)} -> "
               f"{'ok' if ok else 'FAIL'} | {smi}")
    return ok


def _bert_fit_rows(cfg, n, lens, seed):
    """n (ids, [start, end]) rows, lengths uniform in `lens`."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = rng.randint(lens[0], lens[1] + 1, size=n)
    rows = []
    for n_tok in lengths:
        toks = rng.randint(1, cfg.vocab_size, size=n_tok).astype(np.int32)
        start = rng.randint(0, n_tok)
        end = min(n_tok - 1, start + rng.randint(0, 30))
        rows.append((toks, np.array([start, end], np.int64)))
    return rows, lengths


def _bert_fit_collate(bounds):
    """padded_collate, then [[ids, padding mask], [start, end] labels]."""
    import torch

    from paddle_tpu_torch import io

    pad = io.padded_collate(bounds)

    def collate(batch):
        ids, label, lens = pad(batch)
        mask = (torch.arange(ids.shape[1])[None, :] < lens[:, None]).to(torch.int32)
        return [[ids, mask], label]

    return collate


def _qa_net(qa):
    """BertForQuestionAnswering taking (ids, mask), recording each batch's
    shape (host metadata, no fetch)."""
    import torch

    class QA(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.qa, self.shapes = qa, []

        def forward(self, ids, mask):
            self.shapes.append(tuple(ids.shape))
            return self.qa(ids, attention_mask=mask)

    return QA()


def _qa_loss(out, label):
    """The QA head's loss (models/bert.py: the mean of the start and end
    cross-entropies) on [b, 2] labels."""
    from paddle_tpu_torch.nn import functional as F

    start, end = out
    return (F.cross_entropy(start, label[:, 0]) + F.cross_entropy(end, label[:, 1])) / 2


def phase_fit_bert(smi, cfg, device="cuda", n=FIT_BERT_SEQS, bounds=FIT_BERT_BOUNDS,
                   lens=FIT_BERT_LENS, batch=BERT_BATCH, seed=0, workers=2, prefetch=2):
    """bench_bert's BERT-base (bf16 O2, AdamW at 3e-5) through `Model.fit`
    over `BucketSampler(bucket_boundaries=bounds, batch_size=batch,
    shuffle=True)` and `padded_collate` (n seeded lengths uniform in
    `lens`), one epoch, `workers` worker processes, `prefetch` batches of
    device prefetch (0: none).  Checks: every batch
    one of the bounds' shapes, all of them seen; no attention fallback;
    masked K1 and K3 once per layer per step; finite losses.  Returns (ok,
    counts of the fit run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import Model, io, profiler
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = torch.device(device).type == "cuda"
    if on_card:
        parity_matmuls()
    qa, opt = _bert_model(cfg, device, seed)
    net = _qa_net(qa)
    model = Model(net)
    model.prepare(opt, _qa_loss)
    rows, lengths = _bert_fit_rows(cfg, n, lens, seed)
    sampler = io.BucketSampler(lengths=lengths, bucket_boundaries=bounds,
                               batch_size=batch, shuffle=True, seed=seed)
    loader = io.DataLoader(rows, batch_sampler=sampler, collate_fn=_bert_fit_collate(bounds),
                           num_workers=workers, prefetch_to_device=prefetch, device=device)
    steps = len(sampler)
    steplog = _step_log()
    profiler.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    model.fit(loader, epochs=1, log_freq=FIT_LOG_FREQ, verbose=0, callbacks=[steplog])
    if on_card:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = profiler.kernel_launch_counts()
    fallbacks = dict(fa.fallback_counts)
    losses = steplog.values()
    layers = cfg.num_hidden_layers
    shapes = sorted(set(net.shapes))
    want_shapes = sorted((batch, b) for b in bounds)
    shapes_ok = shapes == want_shapes and len(net.shapes) == steps
    want = layers * steps if on_card else 0
    counts_ok = (all(counts[f"flash_{k}"] == want
                     for k in ("fwd", "fwd_masked", "bwd", "bwd_masked"))
                 and counts["adam_fused"] == (steps if on_card else 0)
                 and not any(fallbacks.values()))
    finite = all(np.isfinite(losses)) and len(losses) == steps
    step_s = steplog.step_s()
    tokens = int(sum(lengths))
    _FIGURES["fit_bert_examples_per_s"] = batch / step_s
    del qa, opt, net, model, loader
    log("fit", f"BERT through BucketSampler{tuple(bounds)} + padded_collate, "
               f"{workers} workers, prefetch_to_device {prefetch}: {n} "
               f"lengths uniform in {lens[0]}-{lens[1]} ({tokens} tokens), {steps} "
               f"steps of {batch}; shapes {shapes} (expected {want_shapes}) -> "
               f"{'ok' if shapes_ok else 'FAIL'}")
    log("fit", f"losses " + " ".join(f"{x:.4f}" for x in losses)
               + f": finite {finite}; launches {_main(counts)}, fallbacks "
               f"{fallbacks} (expected flash_fwd, _masked, flash_bwd, _masked {want}"
               f" = {layers} layers x {steps} steps; adam_fused one per step; no "
               f"fallback) -> {'ok' if counts_ok else 'FAIL'}")
    log("fit", f"bucketed step_ms median {step_s * 1e3:.1f} (whole fit {fit_s:.2f} "
               f"s), examples_per_s {batch / step_s:.1f}, tokens_per_s (unpadded) "
               f"{tokens / steps / step_s:.1f} | {smi}")
    return shapes_ok and counts_ok and finite, counts


# ---------------------------------------------------------------------------
# AMP O1 with loss scaling, a schedule and clipping; the other optimizers
# ---------------------------------------------------------------------------

AMP_LAYERS, AMP_BATCH, AMP_SEQ, AMP_STEPS = 2, 2, 2048, 6
AMP_INF_STEP = 4  # 1-based: this step's gradients get one inf after backward
OTHER_OPTIMIZERS = (("SGD", dict(learning_rate=1e-2)),
                    ("Momentum", dict(learning_rate=1e-3, momentum=0.9)),
                    ("Adagrad", dict(learning_rate=1e-4)),
                    ("RMSProp", dict(learning_rate=1e-5, centered=True, momentum=0.5)),
                    ("Adamax", dict(learning_rate=1e-4)),
                    ("Lamb", dict(learning_rate=1e-4)))


class attention_dtypes:
    """Within the block, the dtype of q in every K1 and K3 call, by kernel:
    {"flash_fwd": {dtypes}, "flash_bwd": {dtypes}} (the wrappers looked up
    by `FlashAttention` at call time, wrapped for the block)."""

    def __enter__(self):
        from paddle_tpu_torch.ops import flash_attention as fa

        self.seen = {"flash_fwd": set(), "flash_bwd": set()}
        self.saved = fa.flash_forward, fa.flash_backward

        def wrap(name, fn):
            def inner(q, *args, **kw):
                self.seen[name].add(str(q.dtype).removeprefix("torch."))
                return fn(q, *args, **kw)
            return inner

        fa.flash_forward = wrap("flash_fwd", self.saved[0])
        fa.flash_backward = wrap("flash_bwd", self.saved[1])
        return self.seen

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import flash_attention as fa

        fa.flash_forward, fa.flash_backward = self.saved


def _amp_state(model, opt):
    """Every parameter and every piece of optimizer state, cloned."""
    out = [p.detach().clone() for p in model.parameters()]
    for st in opt.state.values():
        out += [t.clone() for t in st.values() if hasattr(t, "clone")]
    return out


def phase_amp(smi, cfg, device="cuda", batch=AMP_BATCH, seq=AMP_SEQ,
              steps=AMP_STEPS, seed=0, dtype="bfloat16", others=True):
    """The reference's O1 recipe: a float32 Llama trained under
    `auto_cast(level="O1", dtype=dtype)` with a dynamic `GradScaler`,
    `LinearWarmup` into `CosineAnnealingDecay`, `ClipGradByGlobalNorm(1.0)`
    and AdamW, `steps` steps on one repeated batch; step AMP_INF_STEP's
    gradients get one inf after backward.  Checks finite losses that fall,
    that the inf step changes no parameter, moment or power (bit for bit)
    and halves the scale, that every step ran at its scheduler's rate, and
    the launches: K1 and K3 once per layer per step on their wgmma paths
    (the white ops feed attention q, k, v in `dtype`, which a probe of the
    first step's K1 and K3 calls confirms), adam_fused and unscale_fused
    once per step.  Then, with `others`, SGD, Momentum, Adagrad, RMSProp,
    Adamax and Lamb each take two O1 steps of the same model: finite
    losses, every weight moved, step ms.  Returns (ok, launch counts of
    the AdamW run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, optimizer, profiler
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    on_card = torch.device(device).type == "cuda"
    if on_card:
        parity_matmuls()
        torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=seed).train()
    lr = optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(AMP_LR, steps), 2, AMP_LR / 10,
                            AMP_LR)
    opt = optimizer.AdamW(learning_rate=sched, parameters=model.named_parameters(),
                          grad_clip=ClipGradByGlobalNorm(1.0),
                          apply_decay_param_fun=lambda n: "norm" not in n)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(device)
    log("amp", f"Llama {cfg.hidden_size} hidden x {layers} layers, float32 "
               f"parameters, auto_cast O1 {dtype} + GradScaler (dynamic, 2^15) + "
               f"LinearWarmup(CosineAnnealingDecay) + ClipGradByGlobalNorm(1.0) + "
               f"AdamW, batch {batch} x {seq}, one inf at step {AMP_INF_STEP}")

    def step(inject):
        with amp.auto_cast(level="O1", dtype=dtype):
            loss, _ = model(ids, labels=ids)
        scaler.scale(loss).backward()
        if inject:
            next(model.parameters()).grad.view(-1)[7] = float("inf")
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    # -- the main path ------------------------------------------------------
    profiler.reset_kernel_launch_counts()
    losses, secs, rates, scales = [], [], [], []
    skip_same = False
    for i in range(1, steps + 1):
        want_lr = sched()
        scale_before = float(scaler.get_loss_scaling())
        before = _amp_state(model, opt) if i == AMP_INF_STEP else None
        t0 = time.perf_counter()
        with attention_dtypes() as seen:
            losses.append(step(i == AMP_INF_STEP).item())
        if i == 1:
            first_seen = seen
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rates.append((want_lr, opt._lr_t.item()))
        scales.append(float(scaler.get_loss_scaling()))
        if before is not None:
            skip_same = (all(torch.equal(a, b) for a, b in
                             zip(before, _amp_state(model, opt)))
                         and scaler.last_found_inf
                         and scales[-1] == scale_before / 2)
            del before
        sched.step()
    counts = profiler.kernel_launch_counts()
    kept = [x for i, x in enumerate(losses, 1) if i != AMP_INF_STEP]
    finite = all(np.isfinite(losses))
    falls = kept[-1] < kept[0]
    rates_ok = all(np.float32(a) == np.float32(b) for a, b in rates)
    scale = 1 if on_card else 0
    want = dict(flash_fwd=layers * steps, flash_fwd_wgmma=layers * steps,
                flash_bwd=layers * steps, flash_bwd_wgmma=layers * steps,
                adam_fused=steps, unscale_fused=steps)
    counts_ok = all(counts[k] == n * scale for k, n in want.items())
    want_seen = {"flash_fwd": {dtype}, "flash_bwd": {dtype}}
    dtypes_ok = first_seen == want_seen
    step_s = statistics.median(secs[1:])
    log("amp", f"step 1's attention operands by kernel {first_seen} (expected "
               f"{want_seen}) -> {'ok' if dtypes_ok else 'FAIL'}")
    log("amp", "losses " + " ".join(f"{x:.4f}" for x in losses)
               + f": finite {finite}, last < first (the inf step aside) {falls}")
    log("amp", f"step {AMP_INF_STEP} (one inf): every parameter, moment and power "
               f"unchanged bit for bit, last_found_inf, scale halved: "
               f"{skip_same}; scales " + " ".join(f"{x:g}" for x in scales)
               + f" -> {'ok' if skip_same else 'FAIL'}")
    log("amp", "rates (scheduler, device scalar): "
               + " ".join(f"{a:.3e}/{b:.3e}" for a, b in rates)
               + f" -> {'ok' if rates_ok else 'FAIL'}")
    log("amp", f"launches {_main(counts)} (expected {want} on the card: K1 and K3 "
               f"once per layer per step on their wgmma paths, adam_fused and "
               f"unscale_fused once per step, the inf step too) -> "
               f"{'ok' if counts_ok else 'FAIL'}")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    log("amp", f"step_ms median of steps 2-{steps} {step_s * 1e3:.1f} (all: "
               + " ".join(f"{x * 1e3:.1f}" for x in secs)
               + f"), tokens_per_s {batch * seq / step_s:.1f}, peak_mem_gib {peak} | {smi}")
    ok = finite and falls and skip_same and rates_ok and counts_ok and dtypes_ok
    del opt, scaler

    # -- the other optimizers, two O1 steps each -------------------------------
    for name, kw in OTHER_OPTIMIZERS if others else ():
        other = getattr(optimizer, name)(parameters=model.named_parameters(), **kw)
        before = [p.detach().clone() for p in model.parameters()]
        o_losses, o_secs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            with amp.auto_cast(level="O1", dtype=dtype):
                loss, _ = model(ids, labels=ids)
            loss.backward()
            other.step()
            other.clear_grad()
            o_losses.append(loss.item())
            o_secs.append(time.perf_counter() - t0)
        moved = sum(not torch.equal(a, p.detach())
                    for a, p in zip(before, model.parameters()))
        good = all(np.isfinite(o_losses)) and moved == len(before)
        ok &= good
        log("amp", f"{name} {kw}: losses " + " ".join(f"{x:.4f}" for x in o_losses)
                   + f", weights moved {moved}/{len(before)}, step_ms "
                   + " ".join(f"{x * 1e3:.1f}" for x in o_secs)
                   + f" -> {'ok' if good else 'FAIL'}")
        del other, before
    del model
    return ok, counts


# fp16 O2 training: the train phase's shape, 8 steps, step 4's gradients
# given one inf after backward (a step whose gradients overflow on their
# own is skipped too)
FP16_TRAIN_STEPS = 8
FP16_INF_STEP = 4


def phase_fp16_train(smi, cfg, device="cuda", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=FP16_TRAIN_STEPS, seed=0):
    """fp16 O2 training of `cfg`: a float32 Llama decorated with
    `amp.decorate(level="O2", dtype="float16")` (float32 masters), AdamW
    (adam_fused) and a dynamic `GradScaler` at the reference's defaults
    (2^15, x2 after 2000 good steps, /2 after each bad one), `steps` steps
    on one repeated batch; step FP16_INF_STEP's gradients get one inf after
    backward.  Each step unscales first and reads the scaler's flag, so a
    step about to be skipped -- the injected inf or an overflow the scaler
    finds by itself -- is snapshotted and must leave every parameter,
    master, moment and power unchanged bit for bit and halve the scale.
    Checks: losses finite on every applied step and falling; K1 and K3
    once per layer per step on their wgmma paths with float16 q (a probe of
    step 1's calls), adam_fused and unscale_fused once per step.  Prints
    step ms, tokens/s, the skip pattern and peak memory.  Returns (all
    passed, launch counts)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, optimizer, profiler
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    on_card = torch.device(device).type == "cuda"
    if on_card:
        parity_matmuls()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=seed).train()
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                          weight_decay=0.01)
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler()
    layers = cfg.num_hidden_layers
    n16 = sum(p.numel() for p in model.parameters() if p.dtype == torch.float16)
    log("train", f"Llama {cfg.hidden_size} hidden x {layers} layers, fp16 O2 "
                 f"({n16} of {sum(p.numel() for p in model.parameters())} params "
                 f"in float16) + float32 masters + AdamW + GradScaler (dynamic, "
                 f"init {float(scaler.get_loss_scaling()):g}), batch {batch} x "
                 f"{seq}, one inf at step {FP16_INF_STEP}, built in "
                 f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(device)

    # -- the main path: forward, scaled backward, unscale, AdamW, update ----
    profiler.reset_kernel_launch_counts()
    losses, secs, scales, skipped, first_seen = [], [], [], [], None
    skips_ok = True
    for i in range(1, steps + 1):
        scale_before = float(scaler.get_loss_scaling())
        t0 = time.perf_counter()
        with attention_dtypes() as seen:
            loss, _ = model(ids, labels=ids)
            scaler.scale(loss).backward()
        if i == FP16_INF_STEP:
            next(model.parameters()).grad.view(-1)[7] = float("inf")
        scaler.unscale_(opt)
        found = bool(scaler._found_inf)
        before = _amp_state(model, opt) if found else None
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.item())
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        scales.append(float(scaler.get_loss_scaling()))
        first_seen = first_seen or seen
        if found:
            skipped.append(i)
            same = all(torch.equal(a, b) for a, b in zip(before, _amp_state(model, opt)))
            skips_ok &= same and scaler.last_found_inf and scales[-1] == scale_before / 2
            log("train", f"step {i} skipped: every parameter, master, moment and "
                         f"power unchanged bit for bit {same}, scale "
                         f"{scale_before:g} -> {scales[-1]:g}")
            del before
    counts = profiler.kernel_launch_counts()
    applied = [x for i, x in enumerate(losses, 1) if i not in skipped]
    finite = all(np.isfinite(applied))
    falls = len(applied) >= 2 and applied[-1] < applied[0]
    skips_ok &= FP16_INF_STEP in skipped
    scale = 1 if on_card else 0
    want = dict(flash_fwd=layers * steps, flash_fwd_wgmma=layers * steps,
                flash_bwd=layers * steps, flash_bwd_wgmma=layers * steps,
                adam_fused=steps, unscale_fused=steps)
    counts_ok = all(counts[k] == n * scale for k, n in want.items())
    want_seen = {"flash_fwd": {"float16"}, "flash_bwd": {"float16"}}
    dtypes_ok = first_seen == want_seen
    good = [x for i, x in enumerate(secs, 1) if i > 1 and i not in skipped]
    step_s = statistics.median(good or secs)
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    log("train", "losses " + " ".join(f"{x:.4f}" for x in losses)
                 + f": applied steps finite {finite}, last < first {falls}")
    log("train", f"skip pattern {['skip' if i in skipped else 'step' for i in range(1, steps + 1)]}"
                 f", scales " + " ".join(f"{x:g}" for x in scales)
                 + f"; every skip unchanged bit for bit with the scale halved, "
                 f"the injected one among them -> {'ok' if skips_ok else 'FAIL'}")
    log("train", f"step 1's attention operands by kernel {first_seen} (expected "
                 f"{want_seen}) -> {'ok' if dtypes_ok else 'FAIL'}; launches "
                 f"{_main(counts)} (expected {want} on the card: K1 and K3 once "
                 f"per layer per step on their wgmma paths, adam_fused and "
                 f"unscale_fused once per step, skipped steps too) -> "
                 f"{'ok' if counts_ok else 'FAIL'}")
    log("train", f"step_ms median of applied steps 2-{steps} {step_s * 1e3:.1f} "
                 f"(all: " + " ".join(f"{x * 1e3:.1f}" for x in secs)
                 + f"), tokens_per_s {batch * seq / step_s:.1f}, peak_mem_gib "
                 f"{peak} | {smi}")
    del model, opt, scaler
    return finite and falls and skips_ok and counts_ok and dtypes_ok, counts


# ---------------------------------------------------------------------------
# BERT-base SQuAD fine-tuning
# ---------------------------------------------------------------------------


def _bert_model(cfg, device, seed=0, lr=BERT_LR):
    """bench_bert's set-up (bench.py:2299-2304): a float32
    BertForQuestionAnswering in train mode, AdamW at `lr` (weight decay
    0.01), then bf16 O2 with float32 masters (LayerNorms stay float32)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering

    model = BertForQuestionAnswering(cfg, device=device, dtype="float32",
                                     seed=seed).train()
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.named_parameters())
    return amp.decorate(model, opt, level="O2", dtype="bfloat16")


def _bert_inputs(cfg, device, batch, seq, seed):
    """bench_bert's batch on `device`: ids, the [b, s] padding mask, start
    and end positions (`bert_batch`)."""
    import numpy as np
    import torch

    ids, lens, starts, ends = bert_batch(batch, seq, cfg.vocab_size, seed)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return to(ids), to(mask), to(starts.astype(np.int64)), to(ends.astype(np.int64))


def _bert_step(model, opt, inputs):
    ids, mask, starts, ends = inputs
    loss, _, _ = model(ids, attention_mask=mask, start_positions=starts,
                       end_positions=ends)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def phase_bert(smi, cfg, device="cuda", batch=BERT_BATCH, seq=BERT_SEQ,
               steps=BERT_STEPS, seed=0, profile=True):
    """bench_bert's training loop (bench.py:2288): BERT-base SQuAD, bf16 O2,
    AdamW at 3e-5, dropout 0, `steps` steps on one padded batch.  Checks
    finite, falling losses, and that every layer's attention ran K1 and K3
    once per step on the wgmma path with segment ids, with no fallback to
    the plain path; prints the step time (median of steps 2-`steps`),
    examples/s, peak memory and, with `profile`, a profiled step.  Returns
    (ok, kernel launch counts of the training run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = torch.device(device).type == "cuda"
    if on_card:
        parity_matmuls()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt = _bert_model(cfg, device, seed)
    inputs = _bert_inputs(cfg, device, batch, seq, seed)
    layers = cfg.num_hidden_layers
    n_params = sum(p.numel() for p in model.parameters())
    tokens = int(inputs[1].sum())
    log("bert", f"BertForQuestionAnswering {cfg.hidden_size} hidden x {layers} "
                f"layers x {cfg.num_attention_heads} heads ({n_params} params), "
                f"bf16 O2 + AdamW lr {BERT_LR}, batch {batch} x {seq} ({tokens} "
                f"tokens, the rest padding), built in {time.perf_counter() - t0:.1f} s")

    # -- the main path: model(...) -> backward -> AdamW -------------------
    profiler.reset_kernel_launch_counts()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(_bert_step(model, opt, inputs).item())
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = profiler.kernel_launch_counts()
    fallbacks = dict(fa.fallback_counts)

    finite = all(np.isfinite(losses))
    falls = losses[-1] < losses[0]
    want = layers * steps
    want_card = want if on_card else 0
    want_adam = steps if on_card else 0
    counts_ok = (all(counts[f"flash_{k}"] == want_card
                     for k in ("fwd", "fwd_wgmma", "fwd_masked", "bwd",
                               "bwd_wgmma", "bwd_masked"))
                 and counts["adam_fused"] == want_adam
                 and counts["unscale_fused"] == 0
                 and not any(fallbacks.values()))
    step_s = statistics.median(secs[1:])
    _FIGURES["bert_examples_per_s"] = batch / step_s
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    log("bert", "losses " + " ".join(f"{x:.4f}" for x in losses)
                + f": finite {finite}, last < first {falls}")
    log("bert", f"launches {_main(counts)}, fallbacks {fallbacks} (expected "
                f"flash_fwd and flash_bwd {want_card} = {layers} layers x {steps} "
                f"steps on the card, each on the wgmma path with segment ids: "
                f"_wgmma and _masked {want_card}; adam_fused {want_adam} = one per "
                f"step; no fallback) -> "
                f"{'ok' if counts_ok else 'FAIL'}")
    log("bert", f"step_ms median of steps 2-{steps} {step_s * 1e3:.1f} (all: "
                + " ".join(f"{x * 1e3:.1f}" for x in secs)
                + f"), examples_per_s {batch / step_s:.1f}, tokens_per_s (padded) "
                f"{batch * seq / step_s:.1f}, peak_mem_gib {peak} | {smi}")
    if on_card and profile:
        gemm_params = sum(m.weight.numel() for m in model.modules()
                          if isinstance(m, torch.nn.Linear))
        gemm_ms, _ = bound(0, 6 * gemm_params * batch * seq)
        log("profile", f"BERT step GEMMs: {6 * gemm_params * batch * seq:.3e} "
                       f"FLOP, bound {gemm_ms:.2f} ms at {PEAK_BF16_FLOP_S:.3g} FLOP/s")
        wall_us, kernels, spans, stats = _device_profile(
            lambda: _bert_step(model, opt, inputs), 1)
        _log_profile(f"BERT training step, batch {batch} x {seq}, {layers} layers",
                     wall_us, kernels, spans, 1, top=12, stats=stats)
        _log_adamw_span("bert", spans, ADAMW_SPAN_WAS.get(("bert", layers)))
    ok = finite and falls and counts_ok
    ok &= _bert_kbias_check(model, cfg, inputs, on_card)
    return ok, counts


def _bert_kbias_check(model, cfg, inputs, on_card):
    """One BertEncoderLayer forward with the padding as a key-padding
    attn_mask (K1's key bias) against the same layer with segment ids (the
    main path's form), on the valid rows of the batch, within the bf16
    tolerance (pad rows differ by design: with the bias they see every
    valid key, with the ids only themselves)."""
    import torch

    from paddle_tpu_torch.models.bert import to_segs
    from paddle_tpu_torch.ops import flash_attention as fa

    _, mask, _, _ = inputs
    layer = model.bert.encoder[0]
    gen = torch.Generator(device=mask.device).manual_seed(3)
    x = torch.randn(*mask.shape, cfg.hidden_size, generator=gen, device=mask.device,
                    dtype=layer.linear1.weight.dtype)
    bias = torch.where(mask > 0, 0.0, -1e30)[:, None, None, :]
    fa.reset_launch_counts()
    with torch.no_grad():
        by_bias = layer(x, attn_mask=bias)
        by_segs = layer(x, segment_ids=to_segs(mask))
    masked = fa.launch_counts["flash_fwd_masked"] == (2 if on_card else 0)
    live = mask > 0
    o, r = by_bias[live].float(), by_segs[live].float()
    err = (o - r).abs().max().item()
    ok = (bool(torch.isfinite(o).all()) and masked
          and bool(((o - r).abs() <= KERNEL_ATOL + KERNEL_RTOL * r.abs()).all()))
    log("bert", f"encoder layer 0, key-padding attn_mask (key bias) vs segment "
                f"ids on the {int(live.sum())} valid rows: max_abs_err {err:.3e}, "
                f"both on K1: {masked} -> {'ok' if ok else 'FAIL'}")
    return ok


# parameters whose gradient is 0 in exact arithmetic: a key projection's
# bias adds the same q.b to all of a query's scores, which the softmax
# cancels; the span classifier's bias and the last LayerNorm's bias get the
# sum over positions of p - onehot, which is 0.  Their gradients are
# round-off, so the ratio below is not defined for them.
def _bert_zero_grad(name, layers):
    return (name.endswith("attn.k_proj.bias") or name == "classifier.bias"
            or name == f"bert.encoder.{layers - 1}.norm2.bias")


def bert_grad_check(cfg, device="cuda", batch=BERT_BATCH, seq=BERT_SEQ, seed=1):
    """One step's gradients of a 2-layer BERT at BERT-base's widths with
    K1/K3 and segment ids, and again with attention through
    `flash_forward_plain` (the same ids) under autograd: per parameter
    ||g_kernel - g_plain|| / ||g_plain|| <= GRAD_REL_TOL (parameters whose
    exact gradient is 0 left out, see `_bert_zero_grad`).  Returns (ok,
    worst ratio)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.nn import functional as nnf
    from paddle_tpu_torch.ops import flash_attention as fa

    model, _ = _bert_model(cfg, device, seed)
    inputs = _bert_inputs(cfg, device, batch, seq, seed)
    ids, mask, starts, ends = inputs

    def grads():
        loss, _, _ = model(ids, attention_mask=mask, start_positions=starts,
                           end_positions=ends)
        loss.backward()
        out = {n: p.grad.detach().float() for n, p in model.named_parameters()
               if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    def plain_sdpa(q, k, v, mask=None, causal=False, scale=None, segment_ids=None):
        segs = None if segment_ids is None else segment_ids.to(torch.int32)
        return fa.flash_forward_plain(q, k, v, causal, 1.0 / q.shape[-1] ** 0.5,
                                      segs)[0]

    fa.reset_launch_counts()
    kernel = grads()
    k3_kernel = fa.launch_counts["flash_bwd_masked"]
    sdpa = nnf.sdpa
    nnf.sdpa = plain_sdpa
    try:
        plain = grads()
    finally:
        nnf.sdpa = sdpa
    k3_plain = fa.launch_counts["flash_bwd"] - k3_kernel
    layers = cfg.num_hidden_layers
    ratios = {n: ((kernel[n] - plain[n]).norm() / plain[n].norm()).item()
              for n in kernel if not _bert_zero_grad(n, layers)}
    worst = max(ratios, key=ratios.get)
    on_card = torch.device(device).type == "cuda"
    paths_ok = k3_plain == 0 and k3_kernel == (layers if on_card else 0)
    ok = (all(np.isfinite(list(ratios.values()))) and ratios[worst] <= GRAD_REL_TOL
          and paths_ok and set(kernel) == set(plain))
    log("bert", f"grad check, {layers} layers, batch {batch} x {seq}: worst "
                f"||g_kernel - g_plain|| / ||g_plain|| {ratios[worst]:.3e} "
                f"({worst}), median {statistics.median(ratios.values()):.3e} (tol "
                f"{GRAD_REL_TOL}; {len(kernel) - len(ratios)} parameters with an "
                f"exact gradient of 0 left out); flash_bwd launches kernel pass "
                f"{k3_kernel} (with segment ids), plain pass {k3_plain} -> "
                f"{'ok' if ok else 'FAIL'}")
    return ok, ratios[worst]


# ---------------------------------------------------------------------------
# ring (context-parallel) attention and long-context training
# ---------------------------------------------------------------------------

# the long-context training cells: Llama-2-7B's widths with the sep axis's
# R ranks on the card.  32768 tokens over R = 8: K/V of 512 MiB per layer
# (bf16, 32 heads of 128), over the 256 MiB budget, so the rotating
# zig-zag form; depth cut to 4 layers (the 8-layer train phase peaks at
# 40.63 GiB with 8192 tokens).  Then 16384 tokens over R = 4 at 2 layers:
# K/V of exactly 256 MiB, the gathered form.
LC_SEQ, LC_R, LC_LAYERS, LC_STEPS = 32768, 8, 4, 3
LC2_SEQ, LC2_R, LC2_LAYERS, LC2_STEPS = 16384, 4, 2, 2


def _ring_launches(form, R, calls=1):
    """The K1/K3 launches `calls` ring calls of `form` make over R ranks:
    gathered one K1 and one K3 per rank, each with q_offset; rotating 2R + 1
    of each per rank, 2R - 1 K1 with the carry, every K3 with delta; the
    Pallas-hop ring (not causal) R of each per rank, R - 1 K1 with the
    carry; flash (no ring) one of each."""
    per = {"gathered": dict(fwd=R, offset=R, carry=0, delta=0),
           "rotating": dict(fwd=R * (2 * R + 1), offset=0, carry=R * (2 * R - 1),
                            delta=R * (2 * R + 1)),
           "hops": dict(fwd=R * R, offset=0, carry=R * (R - 1), delta=R * R),
           "flash": dict(fwd=1, offset=0, carry=0, delta=0)}[form]
    return {"flash_fwd": calls * per["fwd"], "flash_bwd": calls * per["fwd"],
            "flash_fwd_offset": calls * per["offset"],
            "flash_bwd_offset": calls * per["offset"],
            "flash_fwd_carry": calls * per["carry"],
            "flash_bwd_delta": calls * per["delta"]}


def _launches_ok(counts, want, on_card):
    """Every count of `want` as expected (0 on the CPU), every K1/K3 launch
    on its wgmma path, and no attention fell back to the plain path."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as ra
    from paddle_tpu_torch.ops import flash_attention as fa

    scale = 1 if on_card else 0
    ok = all(counts[name] == n * scale for name, n in want.items())
    ok &= counts["flash_fwd_wgmma"] == counts["flash_fwd"]
    ok &= counts["flash_bwd_wgmma"] == counts["flash_bwd"]
    return ok and not any(fa.fallback_counts.values()) and ra.form_counts["plain"] == 0


def phase_ring(smi, S=RING_SEQ, h=RING_HEADS, d=128, R=RING_R, seed=50,
               device="cuda", iters=5):
    """bench_longcontext_32k's attention (bench.py:2347-2455) through the
    port: q, k, v [1, S, h, d] bf16, loss = mean(out^2), forward and
    backward, in five ways -- full-sequence causal K1 + K3 ("flash", the
    reference's baseline), `ring_attention_array` over a sep axis of R in
    the gathered zig-zag form, in the rotating form (the gathered-KV budget
    set to 0, as tests/test_longcontext_moe.py:278 does), then non-causal
    K1 + K3 and the non-causal Pallas-hop ring.  Each ring form against its
    flash run (outputs at the kernels' bf16 tolerance, gradients per (b,
    head) within REL_NORM_TOL), the launches of each run against the form,
    then `attention_32k_fwd_bwd_ms` (flash), each form's ms over all R
    ranks (one after another on the card) and per rank (over R), and
    `ring_vs_split_flash` = per rank / (flash / R).  Returns (ok, the runs'
    launch counts)."""
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as ra
    from paddle_tpu_torch.ops import flash_attention as fa

    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(1, S, h, d, generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))

    def step(fn):
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        out = fn(qs, ks, vs)
        grads = torch.autograd.grad((out.float() ** 2).mean(), (qs, ks, vs))
        return out.detach(), grads

    ring = lambda causal: (lambda *x: ra.ring_attention_array(*x, "sep", causal))
    flash = lambda causal: (lambda *x: fa.sdpa(*x, None, causal))
    ways = (("flash", True, flash(True), None), ("gathered", True, ring(True), None),
            ("rotating", True, ring(True), 0), ("flash", False, flash(False), None),
            ("hops", False, ring(False), None))
    saved = mesh.get_mesh(), ra._GATHERED_KV_MAX_BYTES
    mesh.build_mesh(sep=R, device=device)
    ok_all, runs, ms, ref = True, [], {}, {}
    try:
        for form, causal, fn, budget in ways:
            ra._GATHERED_KV_MAX_BYTES = saved[1] if budget is None else budget
            profiler.reset_kernel_launch_counts()
            ra.reset_form_counts()
            out, grads = step(fn)  # the main path's run
            if on_card:
                torch.cuda.synchronize()
            counts = profiler.kernel_launch_counts()
            forms = dict(ra.form_counts)
            runs.append(counts)
            name = form if form != "flash" else f"flash causal={causal}"
            ok = _launches_ok(counts, _ring_launches(form, R), on_card)
            ok &= form == "flash" or forms[form] == 1
            text = f"{name}: launches {_main(counts)}, forms {_main(forms)}"
            if form == "flash":
                ref[causal] = (out, grads)
            else:
                r_out, r_grads = ref[causal]
                err = (out.float() - r_out.float()).abs().max().item()
                g_rel = [rel_norm_err(x, r) for x, r in zip(grads, r_grads)]
                held = close(out, r_out) and max(g_rel) <= REL_NORM_TOL["bfloat16"]
                ok &= held
                text += (f"; against flash: out max_abs_err {err:.3e}, rel_norm_err "
                         f"{rel_norm_err(out, r_out):.3e}, grads rel_norm_err dq/dk/dv "
                         + "/".join(f"{x:.3e}" for x in g_rel))
            del out, grads
            if on_card:
                ms[name] = time_ms(lambda: step(fn), iters=iters, warmup=1)
                dev, _ = device_ms(lambda: step(fn), iters=2, warmup=0)
                text += f"; fwd+bwd ms {ms[name]:.3f} (device {_dev_txt(dev)})"
            log("ring", f"{text} -> {'ok' if ok else 'FAIL'}")
            ok_all &= ok
    finally:
        mesh.set_mesh(saved[0])
        ra._GATHERED_KV_MAX_BYTES = saved[1]
    if on_card:
        t_flash = ms["flash causal=True"]
        metrics = {"attention_32k_fwd_bwd_ms": t_flash}
        for form, base in (("gathered", t_flash), ("rotating", t_flash),
                           ("hops", ms["flash causal=False"])):
            metrics[f"ring_{form}_ms"] = ms[form]
            metrics[f"ring_{form}_per_rank_ms"] = ms[form] / R
            metrics[f"ring_vs_split_flash_{form}"] = (ms[form] / R) / (base / R)
        metrics["ring_vs_split_flash"] = metrics["ring_vs_split_flash_gathered"]
        log("ring", f"S {S}, h {h}, d {d}, R {R} (all ranks on one card, one "
                    f"after another; per rank = all / R; the non-causal hop ring "
                    f"against non-causal flash): {json.dumps(metrics)} | {smi}")
    return ok_all, runs


def phase_longcontext(smi, cfg, R, seq, steps, form, device="cuda", seed=0,
                      profile=True):
    """Long-context training (the reference's context parallelism:
    `LlamaConfig.context_parallel_degree` on a sep mesh of R): `cfg` for
    `steps` AdamW steps (bf16 O2) on one sequence of `seq` tokens, the
    attention of every layer through ring attention in `form`.  Checks
    finite and falling losses and the exact launches the form implies
    (`_ring_launches`, once per layer per step, every one on the wgmma
    path, no plain attention); prints step time, tokens/s, peak memory and,
    with `profile`, a profiled step.  Returns (ok, launch counts)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as ra

    phase = f"longcontext {seq}"
    on_card = torch.device(device).type == "cuda"
    if on_card:
        parity_matmuls()
        torch.cuda.reset_peak_memory_stats()
    saved = mesh.get_mesh()
    mesh.build_mesh(sep=R, device=device)
    try:
        model, opt = _train_model(cfg, device, seed=seed)
        layers = cfg.num_hidden_layers
        kv_mib = seq * cfg.hidden_size * 2 * 2 / 2**20
        log(phase, f"Llama {cfg.hidden_size} hidden x {layers} layers, "
                   f"context_parallel_degree {cfg.context_parallel_degree} on a "
                   f"sep mesh of {R}, one sequence of {seq} tokens (K/V {kv_mib:.0f} "
                   f"MiB a layer against the {ra._GATHERED_KV_MAX_BYTES / 2**20:.0f} "
                   f"MiB budget: the {form} form), bf16 O2 + AdamW")
        rng = np.random.default_rng(seed)
        ids = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, size=(1, seq)).astype(np.int32)).to(device)
        profiler.reset_kernel_launch_counts()
        ra.reset_form_counts()
        losses, secs = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(_train_step(model, opt, ids).item())
            if on_card:
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = profiler.kernel_launch_counts()
        forms = dict(ra.form_counts)
        want = _ring_launches(form, R, calls=layers * steps)
        want["adam_fused"] = steps  # one launch per AdamW step
        counts_ok = (_launches_ok(counts, want, on_card)
                     and forms == dict(dict.fromkeys(ra.FORMS, 0),
                                       **{form: layers * steps}))
        finite = all(np.isfinite(losses))
        falls = losses[-1] < losses[0]
        step_s = statistics.median(secs[1:])
        peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
                else "not measured")
        log(phase, "losses " + " ".join(f"{x:.4f}" for x in losses)
                   + f": finite {finite}, last < first {falls}")
        log(phase, f"launches {_main(counts)}, forms {_main(forms)} (expected "
                   f"{want} on the card, each on the wgmma path, no plain "
                   f"attention) -> {'ok' if counts_ok else 'FAIL'}")
        log(phase, f"step_ms median of steps 2-{steps} {step_s * 1e3:.1f} (all: "
                   + " ".join(f"{x * 1e3:.1f}" for x in secs)
                   + f"), tokens_per_s {seq / step_s:.1f}, peak_mem_gib {peak} | {smi}")
        if on_card and profile:
            wall_us, kernels, spans, stats = _device_profile(
                lambda: _train_step(model, opt, ids), 1)
            _log_profile(f"long-context training step, {seq} tokens over R {R}, "
                         f"{layers} layers", wall_us, kernels, spans, 1, top=12,
                         stats=stats)
            _log_adamw_span(phase, spans, ADAMW_SPAN_WAS.get(("longcontext", layers)))
    finally:
        mesh.set_mesh(saved)
    return finite and falls and counts_ok, counts


def longcontext_grad_check(cfg, R, seq, device="cuda", seed=1):
    """One step's parameter gradients of `cfg` (context_parallel_degree R)
    through ring attention on a sep mesh of R, against the same weights and
    tokens with context_parallel_degree 1 (full-sequence K1/K3): per
    parameter ||g_ring - g_flash|| / ||g_flash|| <= GRAD_REL_TOL.  Returns
    (ok, worst ratio)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as ra

    saved = mesh.get_mesh()
    mesh.build_mesh(sep=R, device=device)
    try:
        model, _ = _train_model(cfg, device, seed=seed)
        ids = torch.from_numpy(np.random.default_rng(seed).integers(
            1, cfg.vocab_size, size=(1, seq)).astype(np.int32)).to(device)

        def grads():
            loss, _ = model(ids, labels=ids)
            loss.backward()
            out = {n: p.grad.detach().float() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            return out

        ra.reset_form_counts()
        ring = grads()
        ring_forms = dict(ra.form_counts)
        model.config.context_parallel_degree = 1
        flash = grads()
        flash_forms = dict(ra.form_counts)
    finally:
        mesh.set_mesh(saved)
    ratios = {n: ((ring[n] - flash[n]).norm() / flash[n].norm()).item() for n in ring}
    worst = max(ratios, key=ratios.get)
    layers = cfg.num_hidden_layers
    forms_ok = (sum(ring_forms.values()) == layers and ring_forms["plain"] == 0
                and flash_forms == ring_forms)
    ok = (all(np.isfinite(list(ratios.values()))) and ratios[worst] <= GRAD_REL_TOL
          and forms_ok)
    log(f"longcontext {seq}", f"grad check, {layers} layers, {seq} tokens over R "
                              f"{R} ({_main(ring_forms)}) against "
                              f"context_parallel_degree 1: worst ||g_ring - "
                              f"g_flash|| / ||g_flash|| {ratios[worst]:.3e} "
                              f"({worst}), median "
                              f"{statistics.median(ratios.values()):.3e} (tol "
                              f"{GRAD_REL_TOL}) -> {'ok' if ok else 'FAIL'}")
    return ok, ratios[worst]


# ---------------------------------------------------------------------------
# vision: the conv nets (LeNet, ResNet-50, VGG-16) on cuDNN
# ---------------------------------------------------------------------------

RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000  # bench_resnet50 :230
RESNET_WINDOWS, RESNET_WINDOW_STEPS, RESNET_WARMUP = 3, 20, 3
PARITY_BATCH = 4
# card against CPU in float32 (TF32 off), ||card - cpu|| / ||cpu||: two conv
# algorithms over fifty layers sum in other orders (float32 rounds at 6e-8);
# a wrong layer gives ~1.  Train-mode gradients are looser: the batch
# norms' backward over four images cancels, and a CPU rehearsal put every
# conv gradient of either layout 1.5e-2 to 3.0e-2 from a float64 run
VISION_PARITY_TOL = 2e-3
VISION_TRAIN_GRAD_TOL = 1e-1
LENET_BATCH, LENET_STEPS, LENET_WARMUP = 16, 30, 2  # bench_lenet_eager :296
FIT_LENET_ROWS, FIT_LENET_BATCH, FIT_LENET_EPOCHS = 512, 32, 3  # bench_hapi_async :391
VGG_BATCH, VGG_STEPS = 32, 2
# a conv layout conversion (cuDNN's own transposes)
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "NCHWToNHWC", "NHWCToNCHW")
CONV_KERNELS = ("conv", "xmma", "implicit", "fprop", "dgrad", "wgrad", "winograd",
                "cutlass", "gemm", "nvjet", "cudnn")
BN_KERNELS = ("batch_norm", "bn_fw", "bn_bw", "BatchNorm")


def _kernels_of(fn):
    """(fn(), {kernel name: (device us, launches)}) of one call under
    torch.profiler, the call synchronised."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0:
                t, n = kernels.get(ev.key, (0.0, 0))
                kernels[ev.key] = (t + us, n + ev.count)
    return out, kernels


def _kind(name):
    if any(k in name for k in LAYOUT_KERNELS):
        return "layout"
    if any(k in name for k in BN_KERNELS):
        return "bn"
    if any(k in name for k in CONV_KERNELS):
        return "conv"
    return "elementwise"


def _profile_conv_step(phase, model, opt, x, y, smi):
    """One training step profiled in its three parts (forward and loss,
    backward, optimizer step), device time by kind: conv forward, conv
    backward (cuDNN and the fc GEMM), batch norm, elementwise (ReLU, adds,
    pools, the loss, casts, copies), optimizer, and the layout-conversion
    kernels per step.  Returns the figures, or None when the profiler saw
    no device time."""
    from paddle_tpu_torch import nn as pnn

    ce = pnn.CrossEntropyLoss()
    loss, fwd = _kernels_of(lambda: ce(model(x), y))
    _, bwd = _kernels_of(loss.backward)
    _, step = _kernels_of(lambda: (opt.step(), opt.clear_grad()))
    if not (fwd or bwd or step):
        log(phase, "device time by kind not measured (the profiler saw no kernels)")
        return None
    kinds = {}
    for part, kernels in (("forward", fwd), ("backward", bwd)):
        for name, (us, n) in kernels.items():
            kind = _kind(name)
            key = f"conv {part}" if kind == "conv" else kind
            t, c = kinds.get(key, (0.0, 0))
            kinds[key] = (t + us, c + n)
    kinds["optimizer"] = (sum(us for us, _ in step.values()),
                          sum(n for _, n in step.values()))
    busy = sum(t for t, _ in kinds.values())
    order = ("conv forward", "conv backward", "bn", "elementwise", "layout", "optimizer")
    log(phase, "  device ms per step by kind (launches): " + ", ".join(
        f"{k} {kinds.get(k, (0.0, 0))[0] / 1e3:.3f} ({kinds.get(k, (0.0, 0))[1]})"
        for k in order) + f"; busy {busy / 1e3:.3f} ms | {smi}")
    layout = kinds.get("layout", (0.0, 0))[1]
    copies = sum(n for kernels in (fwd, bwd) for name, (_, n) in kernels.items()
                 if "copy" in name)
    log(phase, f"  layout-conversion kernels per step (cuDNN nchwToNhwc / "
               f"nhwcToNchw): {layout}; torch copy kernels in forward and "
               f"backward: {copies}")
    every = {}
    for kernels in (fwd, bwd, step):
        for name, (us, n) in kernels.items():
            t, c = every.get(name, (0.0, 0))
            every[name] = (t + us, c + n)
    for name, (us, n) in sorted(every.items(), key=lambda kv: -kv[1][0])[:6]:
        log(phase, f"  {us / busy:6.3f} of device time, {us / 1e3:.4f} ms, {n} "
                   f"launches: {name[:90]}")
    return {k: v[0] / 1e3 for k, v in kinds.items()} | {"layout_kernels": layout}


def _resnet_case(smi, layout, device="cuda", batch=RESNET_BATCH, size=RESNET_SIZE,
                 classes=RESNET_CLASSES, windows=RESNET_WINDOWS,
                 window_steps=RESNET_WINDOW_STEPS, warmup=RESNET_WARMUP):
    """bench_resnet50's recipe in `layout`: resnet50, Momentum(0.1, 0.9),
    bf16 O2 with masters, one repeated seeded batch, trained eagerly (the
    bench wraps the step in to_static: the jit phase runs it so).  Prints
    images/s (median of `windows` windows of `window_steps` steps after
    `warmup`), step ms, time to the first step, peak memory, and a
    profiled step.  Returns ok: every loss finite, the last window's below
    the first step's."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.vision.models import resnet50

    phase = f"vision resnet50 {layout}"
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = resnet50(num_classes=classes, data_format=layout, device=device)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    ce = pnn.CrossEntropyLoss()
    rng = np.random.RandomState(0)
    shape = (batch, 3, size, size) if layout == "NCHW" else (batch, size, size, 3)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, classes, (batch,)).astype(np.int64)).to(device)
    built = time.perf_counter() - t0

    def step():
        loss = ce(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    t0 = time.perf_counter()
    losses = [step().item()]
    t_first = time.perf_counter() - t0
    for _ in range(warmup):
        losses.append(step().item())
    rates, step_ms = [], []
    for _ in range(windows):
        window = []
        t0 = time.perf_counter()
        for _ in range(window_steps):
            window.append(step())
        losses.extend(torch.stack(window).detach().float().cpu().tolist())
        dt = time.perf_counter() - t0
        rates.append(batch * window_steps / dt)
        step_ms.append(dt / window_steps * 1e3)
    finite = bool(np.all(np.isfinite(losses)))
    last = float(np.mean(losses[-window_steps:]))
    falls = finite and last < losses[0]
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    log(phase, f"batch {batch} x {shape[1:]} float32 images, {classes} classes, bf16 "
               f"O2 + Momentum masters, eager; built in {built:.2f} s; time to the "
               f"first step {t_first:.3f} s; losses first {losses[0]:.4f}, last "
               f"window mean {last:.4f}: finite {finite}, falling {falls} -> "
               f"{'ok' if falls else 'FAIL'} | {smi}")
    log(phase, f"images_per_s median of {windows} windows of {window_steps} steps "
               f"{statistics.median(rates):.1f} (windows: "
               + " ".join(f"{r:.1f}" for r in rates)
               + f"), step_ms {statistics.median(step_ms):.2f}, peak_mem_gib {peak}"
               f" | {smi}")
    if on_card:
        _profile_conv_step(phase, model, opt, x, y, smi)
    return falls


def _vision_parity(smi, device="cuda", batch=PARITY_BATCH, size=RESNET_SIZE):
    """A seeded float32 resnet50 on the card (TF32 off) against the same
    model on the CPU, in eval and in train mode (batch statistics): the
    logits, the loss and conv1.weight's gradient; and the card's NHWC
    model (the same weights) against its NCHW one.  Each within
    VISION_PARITY_TOL by ||a - b|| / ||b||, train-mode gradients within
    VISION_TRAIN_GRAD_TOL."""
    import copy

    import numpy as np
    import torch

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.vision.models import resnet50

    parity_matmuls()
    ce = pnn.CrossEntropyLoss()
    cpu = resnet50(device="cpu")
    card = copy.deepcopy(cpu).to(device)
    nhwc = resnet50(device=device, data_format="NHWC")
    nhwc.load_state_dict(card.state_dict())
    rng = np.random.RandomState(1)
    x = rng.rand(batch, 3, size, size).astype(np.float32)
    y = torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(np.int64))
    inputs = {"cpu": (cpu, torch.from_numpy(x)),
              "card": (card, torch.from_numpy(x).to(device)),
              "card NHWC": (nhwc, torch.from_numpy(x.transpose(0, 2, 3, 1).copy()).to(device))}

    def run(name, train):
        model, xin = inputs[name]
        model.train(train)
        model.zero_grad(set_to_none=True)
        out = model(xin)
        loss = ce(out, y.to(out.device))
        loss.backward()
        return out.detach().cpu(), loss.detach().cpu(), model.conv1.weight.grad.cpu()

    rel = lambda a, b: float((a - b).norm() / b.norm())
    ok = True
    for train in (False, True):
        got = {name: run(name, train) for name in inputs}
        grad_tol = VISION_TRAIN_GRAD_TOL if train else VISION_PARITY_TOL
        for a, b in (("card", "cpu"), ("card NHWC", "card")):
            errs = {"logits": rel(got[a][0], got[b][0]), "loss": rel(got[a][1], got[b][1]),
                    "conv1.weight grad": rel(got[a][2], got[b][2])}
            good = (errs["logits"] <= VISION_PARITY_TOL and errs["loss"] <= VISION_PARITY_TOL
                    and errs["conv1.weight grad"] <= grad_tol)
            ok &= good
            log("vision parity", f"{'train' if train else 'eval'}, batch {batch}, "
                                 f"float32, TF32 off: {a} against {b}: " + ", ".join(
                                     f"{k} {v:.3e}" for k, v in errs.items())
                + f" (tol {VISION_PARITY_TOL}, the gradient {grad_tol}) -> "
                + ("ok" if good else "FAIL"))
    return ok


def _lenet_eager(smi, device="cuda", batch=LENET_BATCH, steps=LENET_STEPS,
                 warmup=LENET_WARMUP):
    """bench_lenet_eager: LeNet, Adam 1e-3, one seeded batch, eager steps.
    Prints steps/s over `steps` after `warmup`, time to the first step,
    and adam_fused's launches over the timed steps (one per step on the
    card).  Returns (ok, launch counts of the timed steps)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer, profiler
    from paddle_tpu_torch.vision.models import LeNet

    on_card = torch.device(device).type == "cuda"
    model = LeNet(device=device)
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.named_parameters())
    ce = pnn.CrossEntropyLoss()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, 1, 28, 28).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, 10, (batch,)).astype(np.int64)).to(device)

    def step():
        loss = ce(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    t0 = time.perf_counter()
    first = step().item()
    t_first = time.perf_counter() - t0
    for _ in range(warmup):
        step()
    profiler.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        last = step()
    last = last.item()
    dt = time.perf_counter() - t0
    counts = profiler.kernel_launch_counts()
    want = steps if on_card else 0
    ok = math.isfinite(last) and last < first and counts["adam_fused"] == want
    log("vision lenet", f"batch {batch} x 1x28x28, Adam 1e-3, eager: steps_per_s "
                        f"{steps / dt:.1f} over {steps} steps after {warmup} warm-ups, "
                        f"time to the first step {t_first:.3f} s; loss {first:.4f} -> "
                        f"{last:.4f}; adam_fused launches {counts['adam_fused']} "
                        f"(one per step: {want}) -> {'ok' if ok else 'FAIL'} | {smi}")
    return ok, counts


def _lenet_rows(n, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(rng.rand(1, 28, 28).astype(np.float32), np.int64(rng.randint(0, 10)))
            for _ in range(n)]


def _lenet_fit_model(device):
    from paddle_tpu_torch import Model, metric, optimizer
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.vision.models import LeNet

    net = LeNet(device=device)
    model = Model(net)
    model.prepare(optimizer.Adam(learning_rate=1e-3, parameters=net.named_parameters()),
                  pnn.CrossEntropyLoss(), metric.Accuracy())
    return model


def _lenet_fit(smi, device="cuda", n=FIT_LENET_ROWS, batch=FIT_LENET_BATCH,
               epochs=FIT_LENET_EPOCHS):
    """bench_hapi_async's LeNet half: `Model.fit` over `n` rows, batch
    `batch`, Adam and Accuracy, at FLAGS_max_inflight_steps 1 and 2 (a
    warm-up epoch, then the median steps/s of `epochs` one-epoch fits, the
    record_step figures over them); then, under cudnn.deterministic, fit's
    per-step losses against a hand loop's over the same batches from the
    same seed, bit for bit, and adam_fused once per step.  Returns (ok,
    launch counts of the checked fit)."""
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.io import DataLoader

    on_card = torch.device(device).type == "cuda"
    rows = _lenet_rows(n)
    steps = n // batch
    rates = {}
    try:
        for inflight in (1, 2):
            core.set_flags({"FLAGS_max_inflight_steps": inflight})
            model = _lenet_fit_model(device)
            model.fit(rows, batch_size=batch, epochs=1, verbose=0, shuffle=False)
            profiler.reset()
            secs = []
            for _ in range(epochs):
                t0 = time.perf_counter()
                model.fit(rows, batch_size=batch, epochs=1, verbose=0, shuffle=False)
                secs.append(time.perf_counter() - t0)
            snap = profiler.metrics_snapshot()["step"]
            per = max(snap["steps"], 1)
            rates[inflight] = steps / statistics.median(secs)
            log("vision fit", f"FLAGS_max_inflight_steps {inflight}: steps_per_s "
                              f"{rates[inflight]:.1f} (median of {epochs} epochs of "
                              f"{steps} steps, batch {batch}); record_step per step: "
                              f"dispatch {snap['dispatch_s'] / per * 1e3:.3f} ms, host "
                              f"blocked {snap['host_blocked_s'] / per * 1e3:.3f} ms, "
                              f"inflight max {snap['inflight_max']} | {smi}")
    finally:
        core.set_flags({"FLAGS_max_inflight_steps": 2})
    log("vision fit", f"async (2) against sync (1): {rates[2] / rates[1]:.3f}x | {smi}")

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        model = _lenet_fit_model(device)
        steplog = _step_log()
        profiler.reset_kernel_launch_counts()
        model.fit(rows, batch_size=batch, epochs=1, verbose=0, shuffle=False,
                  callbacks=[steplog])
        counts = profiler.kernel_launch_counts()
        fit_losses = steplog.values()
        hand = _lenet_fit_model(device)
        net, opt, ce = hand.network, hand._optimizer, hand._loss
        hand_losses = []
        for x, y in DataLoader(rows, batch_size=batch, shuffle=False):
            loss = ce(net(x.to(device)), y.to(device))
            loss.backward()
            opt.step()
            opt.clear_grad()
            hand_losses.append(loss.item())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    want = steps if on_card else 0
    same = fit_losses == hand_losses and len(fit_losses) == steps
    ok = same and counts["adam_fused"] == want
    log("vision fit", f"cudnn.deterministic: fit's {len(fit_losses)} losses equal "
                      f"to a hand loop's bit for bit {same} (first "
                      f"{fit_losses[0]:.6f}, last {fit_losses[-1]:.6f}); adam_fused "
                      f"launches {counts['adam_fused']} (one per step: {want}) -> "
                      f"{'ok' if ok else 'FAIL'}")
    return ok, counts


def _vgg_case(smi, device="cuda", batch=VGG_BATCH, size=RESNET_SIZE, steps=VGG_STEPS):
    """vgg16 with batch norm, 1000 classes, bf16 O2 + Momentum masters:
    `steps` training steps on a seeded batch; finite losses, peak memory."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.vision.models import vgg16

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = vgg16(batch_norm=True, device=device)
    opt = optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                             parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    ce = pnn.CrossEntropyLoss()
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.rand(batch, 3, size, size).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(np.int64)).to(device)
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = ce(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        secs.append(time.perf_counter() - t0)
    ok = bool(np.all(np.isfinite(losses)))
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    log("vision vgg16", f"vgg16 with batch norm, batch {batch} x 3x{size}x{size}, bf16 "
                        f"O2 + Momentum: losses " + " ".join(f"{v:.4f}" for v in losses)
        + f" finite -> {'ok' if ok else 'FAIL'}; step seconds "
        + " ".join(f"{s:.3f}" for s in secs) + f"; peak_mem_gib {peak} | {smi}")
    return ok


def phase_vision(smi, device="cuda", resnet=None, parity=None, lenet=None, fit=None,
                 vgg=None):
    """The vision slice on the card: (a) ResNet-50 training at
    bench_resnet50's geometry in NHWC, then NCHW; (b) card parity of a
    float32 ResNet-50 against the CPU and NHWC against NCHW; (c) LeNet
    eager; (d) LeNet through Model.fit, sync against async; (e) VGG-16
    with batch norm.  The keyword dicts resize a case (a rehearsal on the
    CPU).  cudnn.benchmark is on for (a) and (e).  Returns (ok, launch
    counts of the LeNet runs)."""
    import torch

    ok = True
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for layout in ("NHWC", "NCHW"):
            ok &= _resnet_case(smi, layout, device, **(resnet or {}))
            _free()
        ok &= _vgg_case(smi, device, **(vgg or {}))
        _free()
    finally:
        torch.backends.cudnn.benchmark = saved
    ok &= _vision_parity(smi, device, **(parity or {}))
    _free()
    lenet_ok, lenet_counts = _lenet_eager(smi, device, **(lenet or {}))
    fit_ok, fit_counts = _lenet_fit(smi, device, **(fit or {}))
    return ok and lenet_ok and fit_ok, [lenet_counts, fit_counts]


# ---------------------------------------------------------------------------
# jit: whole training steps captured by to_static
# ---------------------------------------------------------------------------

JIT_STEPS = 4  # captured steps held against as many eager steps
JIT_ROUNDS, JIT_WINDOW = 3, 3  # timing: rounds of an eager and a captured window
JIT_SMALL_LAYERS, JIT_SMALL_BATCH, JIT_SMALL_SEQ = 2, 2, 1024  # paths (d) and (e)
JIT_INF_STEP = 2  # 1-based: (d)'s step whose gradient gets an inf
JIT_KERNELS = ("flash_fwd", "flash_bwd", "adam_fused", "unscale_fused")


class _JitRun:
    """One path of the jit phase: `step(*batch)` the bench's step as
    written, `state()` the (name, tensor) pairs the equality holds, and
    `between(i)` what runs on the host after call i (a scheduler step)."""

    def __init__(self, step, state, between=None):
        self.step, self.state = step, state
        self.between = between or (lambda i: None)


def _opt_state(model, opt):
    """Every parameter and its optimizer state (master, moments, powers,
    velocity), and every buffer (batch-norm statistics), by name."""
    out = []
    for name, p in model.named_parameters():
        out.append((name, p))
        out += [(f"{name}.{k}", v) for k, v in sorted(opt.state[p].items())
                if hasattr(v, "shape")]
    out += list(model.named_buffers())
    return out


def _scaler_state(scaler):
    return [("scaler.scale", scaler._scale), ("scaler.good", scaler._good_steps),
            ("scaler.bad", scaler._bad_steps), ("scaler.last_found", scaler._last_found)]


def _jit_llama(cfg, device, dtype="bfloat16", scaler_kw=None, sched=None):
    """`bench_llama`'s step (bench.py:196-202) on `cfg`: AdamW, O2 in
    `dtype`; with `scaler_kw` a dynamic GradScaler around it and an added
    `poison` ([1] float32, 0 or inf) on the first gradient entry; with
    `sched` a scheduler for the rate, stepped after every call."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=0).train()
    rate = sched() if sched is not None else 1e-4
    opt = optimizer.AdamW(learning_rate=rate, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    if scaler_kw is None:
        def step(ids):
            loss, _ = model(ids, labels=ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        between = (lambda i: rate.step()) if sched is not None else None
        return _JitRun(step, lambda: _opt_state(model, opt), between)
    scaler = amp.GradScaler(**scaler_kw)
    first = next(model.parameters())

    def step(ids, poison):
        loss, _ = model(ids, labels=ids)
        scaler.scale(loss).backward()
        first.grad.view(-1)[:1].add_(poison.to(first.grad.dtype))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    return _JitRun(step, lambda: _opt_state(model, opt) + _scaler_state(scaler))


def _jit_bert(cfg, device, sched=None):
    """`bench_bert`'s step (bench.py:2307-2313): BERT-base QA, bf16 O2,
    AdamW at 3e-5 (or `sched`, stepped after every call)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering

    model = BertForQuestionAnswering(cfg, device=device, dtype="float32",
                                     seed=0).train()
    opt = optimizer.AdamW(learning_rate=sched if sched is not None else BERT_LR,
                          parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")

    def step(ids, mask, starts, ends):
        loss, _, _ = model(ids, attention_mask=mask, start_positions=starts,
                           end_positions=ends)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    between = (lambda i: sched.step()) if sched is not None else None
    return _JitRun(step, lambda: _opt_state(model, opt), between)


def _jit_resnet(device, batch, size):
    """`bench_resnet50`'s step (bench.py:253-259): ResNet-50 NHWC,
    Momentum(0.1, 0.9), bf16 O2."""
    import torch

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.vision.models import resnet50

    torch.manual_seed(0)
    model = resnet50(num_classes=RESNET_CLASSES, data_format="NHWC", device=device)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    ce = pnn.CrossEntropyLoss()

    def step(x, y):
        loss = ce(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return _JitRun(step, lambda: _opt_state(model, opt))


def _jit_counts(counts, calls):
    return {k: counts.get(k, 0) / calls for k in JIT_KERNELS}


def _step_outputs(out):
    """A step's outputs as one float32 row: the loss, then whatever else
    it returns (an MoE step's aux loss and dropped fraction)."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    return torch.stack([x.detach().float().reshape(()) for x in outs])[None]


def _jit_path(smi, what, build, batches, on_card, want=(), rounds=JIT_ROUNDS,
              window=JIT_WINDOW, kept=None, label="jit"):
    """One path: `len(batches)` eager steps of a fresh build, their losses
    (and any other outputs of the step) and state kept on the host; then
    the same from a fresh build under `jit.to_static`, held to them bit
    for bit, with one trace, no retrace and the eager launches per step
    (on the card at least one of each kernel in `want`); then eager and
    captured windows in turns on the captured build.  `kept`, a dict,
    receives the eager twin's outputs per step ("eager": [steps, outputs]).
    Log lines read "[<label> <what>]".  Returns (ok, launch counts of the
    captured calls after the trace)."""
    import torch

    from paddle_tpu_torch import jit, profiler

    phase = f"{label} {what}"
    n = len(batches)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def run(fn, hooks):
        outs = []
        for i, b in enumerate(batches):
            if i == 1:
                profiler.reset_kernel_launch_counts()
            outs.append(_step_outputs(fn(*b)))
            hooks.between(i)
        sync()
        return torch.cat(outs).cpu(), profiler.kernel_launch_counts()

    # the eager twin
    path = build()
    eager_losses, eager_counts = run(path.step, path)
    if kept is not None:
        kept["eager"] = eager_losses
    eager_state = [(name, t.detach().to("cpu", copy=True)) for name, t in path.state()]
    del path
    _free()
    # the same from the seed, captured
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    path = build()
    static = jit.to_static(path.step)
    t0 = time.perf_counter()
    first = _step_outputs(static(*batches[0]))
    sync()
    first_s = time.perf_counter() - t0
    path.between(0)
    losses = [first]
    profiler.reset_kernel_launch_counts()
    for i, b in enumerate(batches[1:], 1):
        losses.append(_step_outputs(static(*b)))
        path.between(i)
    sync()
    counts = profiler.kernel_launch_counts()
    losses = torch.cat(losses).cpu()
    same_losses = torch.equal(losses, eager_losses)
    state = path.state()
    diff = [name for (name, t), (ename, e) in zip(state, eager_state)
            if name != ename or not torch.equal(t.detach().cpu(), e)]
    same_state = not diff and len(state) == len(eager_state)
    per_eager = _jit_counts(eager_counts, n - 1)
    per_replay = _jit_counts(counts, n - 1)
    counts_ok = per_replay == per_eager and all(
        per_replay[k] > 0 for k in want if on_card)
    traces_ok = static.trace_count == 1
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    extra = (f" (other outputs of the last step {losses[-1, 1:].tolist()})"
             if losses.shape[1] > 1 else "")
    log(phase, f"{n} steps, losses " + " ".join(f"{x:.6f}" for x in losses[:, 0].tolist())
               + f"{extra}: equal to eager bit for bit {same_losses}; state tensors equal "
               f"{len(state) - len(diff)}/{len(eager_state)} (every parameter, "
               f"master, moment, power, buffer, scaler counter)"
               + (f", first differing {diff[:3]}" if diff else "")
               + f"; trace_count {static.trace_count}; launches per replay "
               f"{per_replay} against eager per step {per_eager} -> "
               f"{'ok' if same_losses and same_state and counts_ok and traces_ok else 'FAIL'}")
    del eager_state
    # eager and captured windows in turns, on the captured build
    times = {"eager": [], "to_static": []}
    fns = {"eager": path.step, "to_static": static}
    for r in range(rounds):
        for mode in (("eager", "to_static") if r % 2 == 0 else ("to_static", "eager")):
            t0 = time.perf_counter()
            for i in range(window):
                fns[mode](*batches[i % n])
            sync()
            times[mode].append((time.perf_counter() - t0) / window * 1e3)
    retraced = static.trace_count != 1
    eager_ms = statistics.median(times["eager"])
    static_ms = statistics.median(times["to_static"])
    log(phase, f"step_ms eager {eager_ms:.3f} to_static {static_ms:.3f} (ratio "
               f"{eager_ms / static_ms:.3f}; medians of {rounds} windows of {window} "
               f"steps in turns: eager " + " ".join(f"{x:.3f}" for x in times["eager"])
               + ", to_static " + " ".join(f"{x:.3f}" for x in times["to_static"])
               + f"); first call {first_s:.3f} s (warm run and capture); graph pool "
               f"{static.pool_bytes} bytes; peak_mem_gib {peak}; retrace after the "
               f"windows {retraced} -> {'FAIL' if retraced else 'ok'} | {smi}")
    del static, path
    return same_losses and same_state and counts_ok and traces_ok and not retraced, counts


def phase_jit(smi, device="cuda", llama=None, bert=None, resnet=None, small=None,
              rounds=JIT_ROUNDS, window=JIT_WINDOW, steps=JIT_STEPS):
    """The reference's training steps written as bench.py writes them, under
    `jit.to_static` (each captured once as a CUDA graph on the card):
    (a) Llama-2-7B's widths at the train phase's 8 layers, 4 x 2048, bf16 O2,
    AdamW; (b) BERT-base SQuAD, 32 x 384, padded lengths, bf16 O2, AdamW;
    (c) ResNet-50 NHWC bf16 O2 at 128 x 224, Momentum, cuDNN autotuned in
    the warm run; (d) fp16 O2 with a dynamic GradScaler, step JIT_INF_STEP's
    gradient an inf; (e) BERT with its dropout on and a StepDecay rate
    stepped between calls.  Each path holds `steps` captured steps to as
    many eager ones bit for bit (`_jit_path`).  Then (f) `static.nn.cond`
    and `while_loop` inside captured steps (`_control_flow`) and (g)
    FLAGS_check_nan_inf on a captured step of `small`'s Llama
    (`_nan_check`).  Returns (ok, {path: launch counts of its captured
    calls after the trace})."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.optimizer import lr

    on_card = torch.device(device).type == "cuda"
    llama = llama or dict(cfg=LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS),
                          batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    small = small or dict(cfg=LlamaConfig.llama2_7b(num_hidden_layers=JIT_SMALL_LAYERS),
                          batch=JIT_SMALL_BATCH, seq=JIT_SMALL_SEQ,
                          bert=BertConfig.bert_base(num_hidden_layers=JIT_SMALL_LAYERS))
    bert = bert or dict(cfg=BertConfig.bert_base(hidden_dropout_prob=0.0,
                                                 attention_probs_dropout_prob=0.0),
                        batch=BERT_BATCH, seq=BERT_SEQ)
    resnet = resnet or dict(batch=RESNET_BATCH, size=RESNET_SIZE)
    if on_card:
        parity_matmuls()
    rng = np.random.default_rng(0)

    def ids(cfg, batch, seq):
        return torch.from_numpy(
            rng.integers(1, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(device)

    oks, counts = {}, {}
    kw = dict(on_card=on_card, rounds=rounds, window=window)
    # (a) bench_llama
    tok = ids(llama["cfg"], llama["batch"], llama["seq"])
    ok, c = _jit_path(smi, "a llama", lambda: _jit_llama(llama["cfg"], device),
                      [(tok,)] * steps, want=("flash_fwd", "flash_bwd", "adam_fused"),
                      **kw)
    oks["a"] = ok
    counts["a"] = c
    del tok
    _free()
    # (b) bench_bert
    inputs = _bert_inputs(bert["cfg"], device, bert["batch"], bert["seq"], seed=0)
    ok, c = _jit_path(smi, "b bert", lambda: _jit_bert(bert["cfg"], device),
                      [inputs] * steps, want=("flash_fwd", "flash_bwd", "adam_fused"),
                      **kw)
    oks["b"] = ok
    counts["b"] = c
    _free()
    # (c) bench_resnet50, cuDNN deterministic so that the twins can agree
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic = True
    try:
        r = np.random.RandomState(0)
        x = torch.from_numpy(r.rand(resnet["batch"], resnet["size"], resnet["size"],
                                    3).astype(np.float32)).to(device)
        y = torch.from_numpy(r.randint(0, RESNET_CLASSES, (resnet["batch"],))
                             .astype(np.int64)).to(device)
        ok, c = _jit_path(smi, "c resnet50", lambda: _jit_resnet(
            device, resnet["batch"], resnet["size"]), [(x, y)] * steps, **kw)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    oks["c"] = ok
    counts["c"] = c
    del x, y
    _free()
    # (d) fp16 O2, a dynamic GradScaler, one inf
    tok = ids(small["cfg"], small["batch"], small["seq"])
    poison = [torch.full((1,), float("inf") if i + 1 == JIT_INF_STEP else 0.0,
                         device=device) for i in range(steps)]
    ok, c = _jit_path(smi, "d fp16 scaler", lambda: _jit_llama(
        small["cfg"], device, "float16", dict(init_loss_scaling=2.0 ** 15)),
        [(tok, p) for p in poison], on_card=on_card, want=JIT_KERNELS, rounds=1,
        window=2)
    oks["d"] = ok
    counts["d"] = c
    _free()
    # (e) a StepDecay rate stepped between calls, BERT's dropout on
    bcfg = small["bert"]
    inputs = _bert_inputs(bcfg, device, bert["batch"], bert["seq"], seed=1)
    ok, c = _jit_path(smi, "e stepdecay dropout", lambda: _jit_bert(
        bcfg, device, lr.StepDecay(1e-4, step_size=1, gamma=0.5)),
        [inputs] * steps, on_card=on_card,
        want=("flash_fwd", "flash_bwd", "adam_fused"), rounds=1, window=2)
    oks["e"] = ok
    counts["e"] = c
    _free()
    # (f) static control flow in captured steps: the conditional nodes
    oks["f"], _ = _control_flow(device)
    _free()
    # (g) FLAGS_check_nan_inf on a captured bf16 O2 Llama step
    oks["g"], counts["g"] = _nan_check(smi, small["cfg"], device, small["batch"],
                                       small["seq"])
    _free()
    total = {k: sum(c.get(k, 0) for c in counts.values()) for k in counts["a"]}
    log("jit", f"paths {oks}; launches of the captured calls {_main(total)} -> "
               f"{'ok' if all(oks.values()) else 'FAIL'}")
    return all(oks.values()), counts


# ---------------------------------------------------------------------------
# static control flow and the NaN check inside captured steps (jit f and g)
# ---------------------------------------------------------------------------

JIT_LOOP_TRIPS = (5, 3, 0, 7)  # the unbounded loop's trip counts, one capture
JIT_BOUNDED_TRIPS = (3, 2, 4, 5)  # asked of while_loop(max_iters=JIT_MAX_ITERS)
JIT_MAX_ITERS = 4
JIT_NAN_STEPS = 3  # captured steps of each of (g)'s three builds


def _control_flow(device="cuda"):
    """(f) `static.nn.cond` and `while_loop` inside `jit.to_static` steps,
    the counterparts of the reference's tests/test_jit.py:175-360.  On the
    card each step is captured once, its branches and loop bodies in the
    graph's conditional nodes (csrc/graph_cond.cu), and replayed for every
    predicate value and trip count; a counter tensor in each branch and
    loop body counts what executed.  Holds, every call against its exact
    value: cond's output and the weight's gradient both ways, with only the
    taken branch's counter moving; a NaN-prone untaken branch (sqrt of a
    negative) leaving the gradient finite and the taken branch's; a branch
    returning a captured tensor passing its gradient; an unbounded loop
    whose trip count is an input giving x * 2^n for each n, its body run n
    times; a bounded loop (max_iters) giving the values and gradients of a
    captured weight and of the loop's initial value, its body run only on
    live passes; trace_count 1 for each step.  Returns (ok, lines)."""
    import torch

    from paddle_tpu_torch import jit, static

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    f32 = lambda v, rg=False: torch.tensor(v, dtype=torch.float32, device=device,
                                          requires_grad=rg)
    counter = lambda: torch.zeros((), dtype=torch.int32, device=device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    checks = []

    def check(what, got, want, fn):
        sync()
        good = got == want and fn.trace_count == 1
        checks.append(good)
        log("jit f control", f"{what}: {got} against {want}, trace_count "
                             f"{fn.trace_count} -> {'ok' if good else 'FAIL'}")

    # cond both ways, a counter in each branch
    w = f32([2.0], True)
    hits = [counter(), counter()]

    def branch(k, scale, y):
        def run():
            hits[k].add_(1)
            return y * scale
        return run

    @jit.to_static
    def both(x):
        y = (x * w).sum()
        out = static.nn.cond(y > 0, branch(0, 3.0, y), branch(1, 5.0, y))
        out.backward()
        return out

    got, want, n = [], [], [0, 0]
    for xv in (1.0, -1.0, 1.0, -1.0, -1.0):
        out = both(f32([xv]))
        n[xv < 0] += 1
        got.append((out.item(), w.grad.item(), hits[0].item(), hits[1].item()))
        want.append((6.0 if xv > 0 else -10.0, 3.0 if xv > 0 else -5.0, n[0], n[1]))
        w.grad = None
    check("cond (out, dw, true runs, false runs) per call", got, want, both)

    # the untaken branch's gradient would be NaN
    xn = f32([-4.0], True)

    @jit.to_static
    def sqrt_or_double(sign):
        s = (xn * sign).sum()
        out = static.nn.cond(s > 0, lambda: torch.sqrt(s), lambda: s * 2.0)
        out.backward()
        return out

    got, want = [], []
    for sign in (-1.0, 1.0, -1.0, 1.0):
        out = sqrt_or_double(f32([sign]))
        got.append((out.item(), xn.grad.item()))
        want.append((2.0, -0.25) if sign < 0 else (-8.0, 2.0))
        xn.grad = None
    check("cond with sqrt of a negative untaken (out, dx)", got, want, sqrt_or_double)

    # a branch returning a captured tensor unchanged
    xa, ya = f32([3.0], True), f32([5.0], True)

    @jit.to_static
    def pick(sign):
        s = (xa * sign).sum()
        out = static.nn.cond(s > 0, lambda: xa, lambda: ya)
        (out * 2.0).sum().backward()
        return out

    got, want = [], []
    for sign in (1.0, -1.0, 1.0):
        out = pick(f32([sign]))
        taken = xa if sign > 0 else ya
        got.append((out.item(), taken.grad.item()))
        want.append((3.0 if sign > 0 else 5.0, 2.0))
        xa.grad = ya.grad = None
    check("cond returning a captured tensor (out, its grad)", got, want, pick)

    # an unbounded loop, its trip count an input
    passes = counter()

    @jit.to_static
    def doubling(x, n):
        def body(i, a):
            passes.add_(1)
            return [i + 1, a * 2.0]

        _, acc = static.nn.while_loop(lambda i, a: i < n, body, [counter(), x])
        return acc

    got, want, total = [], [], 0
    for n in JIT_LOOP_TRIPS:
        out = doubling(f32(1.0), i32(n))
        total += n
        got.append((out.item(), passes.item()))
        want.append((2.0 ** n, total))
    check("while_loop (x * 2^n, body passes so far) per trip count", got, want, doubling)

    # a bounded, differentiable loop through a captured weight
    wl, xl = f32(2.0, True), f32(3.0, True)
    live = counter()

    @jit.to_static
    def powers(n):
        def body(i, a):
            live.add_(1)
            return [i + 1, a * wl]

        _, acc = static.nn.while_loop(lambda i, a: i < n, body, [counter(), xl],
                                      max_iters=JIT_MAX_ITERS)
        acc.backward()
        return acc

    got, want, total = [], [], 0
    for n in JIT_BOUNDED_TRIPS:
        out = powers(i32(n))
        k = min(n, JIT_MAX_ITERS)
        total += k
        got.append((out.item(), wl.grad.item(), xl.grad.item(), live.item()))
        want.append((3.0 * 2.0 ** k, 3.0 * k * 2.0 ** (k - 1), 2.0 ** k, total))
        wl.grad = xl.grad = None
    check(f"while_loop(max_iters={JIT_MAX_ITERS}) (acc, dw, dx0, live passes so far)",
          got, want, powers)
    return all(checks), checks


def _jit_llama_poisoned(cfg, device, nan_fill=False):
    """`bench_llama`'s step (bf16 O2, AdamW) with a float input added to
    the loss: 0 for a clean step, NaN to poison one.  With `nan_fill`, a
    hook on the loss runs `_poison_allocator` at the start of each eager
    backward, so K3 and the backward's other kernels allocate their
    outputs from blocks full of NaN."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=0).train()
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")

    def step(ids, poison):
        loss, _ = model(ids, labels=ids)
        loss = loss + poison
        if nan_fill:
            loss.register_hook(lambda g: _poison_allocator(device))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


def _poison_allocator(device, large=64, small=256):
    """Make the caching allocator's free blocks all float32 NaN (read as
    bfloat16, NaN in every other element): the cache emptied, then `large`
    blocks of 64 MiB and `small` of 512 KiB (the small-block pool) filled
    and freed, past every dispatch mode (FLAGS_check_nan_inf's too: the
    fill itself is NaN).  Nothing inside a capture, whose pool is the
    graph's own."""
    import torch
    from torch.utils._python_dispatch import _disable_current_modes

    if torch.cuda.is_current_stream_capturing():
        return
    with _disable_current_modes():
        torch.cuda.empty_cache()
        blocks = [torch.full((16 << 20,), float("nan"), device=device)
                  for _ in range(large)]
        blocks += [torch.full((128 << 10,), float("nan"), device=device)
                   for _ in range(small)]
        del blocks


def _nan_eager(built, ids, clean, cfg, device, batch, seq):
    """(g)'s eager legs, the flag on, over an allocator full of NaN: an
    eager training step (`built` poisons at its backward's start) and a K3
    launch on clean inputs (their kernels' outputs allocated with
    `empty_like` from those blocks, written by pointer) raise nothing; K3
    under a gradient with one NaN raises naming flash_bwd.  Returns (the
    clean legs' error or None, what the NaN gradient raised or None)."""
    import torch

    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.ops import flash_attention as fa

    core.set_flags({"FLAGS_check_nan_inf": False})
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, g = (torch.randn(batch, seq, cfg.num_attention_heads, cfg.head_dim,
                              generator=gen, device=device, dtype=torch.bfloat16)
                  for _ in range(4))
    out, lse = fa.flash_forward(q, k, v, causal=True)
    bad = g.clone()
    bad[0, 0, 0, 0] = float("nan")
    core.set_flags({"FLAGS_check_nan_inf": True})
    clean_err = raised = None
    try:
        float(built(ids, clean).detach())
        _poison_allocator(device)
        fa.flash_backward(q, k, v, out, lse, g, causal=True)
    except FloatingPointError as e:
        clean_err = str(e)
    try:
        fa.flash_backward(q, k, v, out, lse, bad, causal=True)
    except FloatingPointError as e:
        raised = str(e)
    return clean_err, raised


def _nan_check(smi, cfg, device="cuda", batch=JIT_SMALL_BATCH, seq=JIT_SMALL_SEQ,
               steps=JIT_NAN_STEPS):
    """(g) FLAGS_check_nan_inf on a captured training step (the reference's
    tests/test_nan_check_compiled.py): Llama-2-7B's widths at 2 layers, bf16
    O2, AdamW, so K1 and K3 run.  Three builds from one seed, each traced
    once and run `steps` clean steps: the flag off, on, off again; on the
    card the flag-on build's warm run does its backward over an allocator
    full of NaN (`_poison_allocator` from a hook on the loss), so what the
    check reads must be what operators and kernels wrote.  Holds the flag-on losses equal to the flag-off ones
    bit for bit (the checks read, never write); a poisoned input then
    raising FloatingPointError naming the compiled step and the operator
    (the loss's add); on the card `_nan_eager`'s legs; the flag off after
    use launching per captured step as many kernels as before it was ever
    on (no mode, no extra kernel), the flag on more.  Returns (ok, launch
    counts of the clean flag-on replays)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import jit, profiler
    from paddle_tpu_torch.framework import core

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(batch, seq))
                           .astype(np.int32)).to(device)
    clean = torch.zeros(1, device=device)
    poison = torch.full((1,), float("nan"), device=device)  # made before the flag is on
    runs, eager = {}, (None, "not run")
    for label, flag in (("off", False), ("on", True), ("off again", False)):
        built = _jit_llama_poisoned(cfg, device, nan_fill=flag and on_card)
        step = jit.to_static(built)
        core.set_flags({"FLAGS_check_nan_inf": flag})
        losses = [step(ids, clean).float() for _ in range(steps)]
        sync()
        profiler.reset_kernel_launch_counts()
        if on_card:
            _, _, _, stats = _device_profile(lambda: step(ids, clean), 2)
            per_step = stats["kernels"] / 2
        else:
            step(ids, clean)
            per_step = "not measured"
        counts = profiler.kernel_launch_counts()
        raised = None
        if flag:
            try:
                step(ids, poison)
                sync()
            except FloatingPointError as e:
                raised = str(e)
        runs[label] = dict(losses=torch.stack(losses).reshape(-1).cpu(), kernels=per_step,
                           traces=step.trace_count, counts=counts, raised=raised)
        if flag and on_card:
            eager = _nan_eager(built, ids, clean, cfg, device, batch, seq)
        del step, built
        _free()
    core.set_flags({"FLAGS_check_nan_inf": False})
    off, on, again = runs["off"], runs["on"], runs["off again"]
    same = torch.equal(off["losses"], on["losses"]) and torch.equal(off["losses"],
                                                                    again["losses"])
    raised = on["raised"] or ""
    named = "compiled step" in raised and "add" in raised
    kernels_ok = not on_card or (again["kernels"] == off["kernels"]
                                 and on["kernels"] > off["kernels"])
    launches_ok = (not on_card or all(on["counts"].get(k, 0) > 0
                                      for k in ("flash_fwd", "flash_bwd")))
    traces_ok = all(r["traces"] == 1 for r in runs.values())
    eager_ok = not on_card or (eager[0] is None and "'flash_bwd'" in (eager[1] or ""))
    ok = same and named and kernels_ok and launches_ok and traces_ok and eager_ok
    log("jit g nan", f"{steps} clean steps each, losses off "
                     + " ".join(f"{x:.6f}" for x in off["losses"].tolist())
                     + f": flag on equal bit for bit, flag off again too {same}; "
                     f"poisoned input raised {raised!r}; eager over NaN-filled allocator "
                     f"blocks: a step and K3 raised {eager[0]!r} (want None), K3 under "
                     f"a NaN gradient raised {eager[1]!r}; kernels per captured step "
                     f"off {off['kernels']}, on {on['kernels']}, off again "
                     f"{again['kernels']}; launches per flag-on step "
                     f"{_main(on['counts'])}; trace_count "
                     f"{[r['traces'] for r in runs.values()]} -> "
                     f"{'ok' if ok else 'FAIL'} | {smi}")
    return ok, on["counts"]


# ---------------------------------------------------------------------------
# the inference export
# ---------------------------------------------------------------------------

# the export phase: BERT-base (12 layers, 768 wide, 12 heads) sequence
# classification in bf16 at EXPORT_BATCH x EXPORT_SEQ with key padding,
# exported with jit.save and loaded in a fresh process; EXPORT_REQUESTS
# POST /predict; a tiny BERT exported on the CPU served on the card; and
# Llama-2-7B's widths at EXPORT_LLAMA_LAYERS layers, logits at 1 x
# EXPORT_LLAMA_SEQ
EXPORT_BATCH, EXPORT_SEQ = 32, 128
EXPORT_REQUESTS = 4
EXPORT_TIMED = 10  # Predictor runs timed, and as many eager forwards
EXPORT_LLAMA_LAYERS, EXPORT_LLAMA_SEQ = 2, 512
EXPORT_DIR = ROOT / "build" / "export"  # inside the checkout, gitignored
# aten operators that would mean attention was traced into plain math
INLINED_ATTENTION = ("aten.einsum", "aten.bmm", "aten.baddbmm", "aten._softmax",
                     "aten.softmax", "aten.logsumexp", "aten._scaled_dot_product")

# the fresh process of (a): loads the artifact with jit.load alone, checks
# its graph, runs it, and reports as one JSON line
_EXPORT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
root, prefix, inputs, out_path = sys.argv[1:5]
sys.path.insert(0, root)
import numpy as np
import torch
from paddle_tpu_torch import jit
from paddle_tpu_torch.ops import flash_attention as fa
torch.cuda.init()
import_s = time.perf_counter() - t0
t0 = time.perf_counter()
p = jit.load(prefix)
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
nodes = [n for n in p.program.graph.nodes if n.op == "call_function"]
flash = sum(n.target is torch.ops.paddle_tpu_torch.flash_fwd.default for n in nodes)
inlined = sorted({str(n.target) for n in nodes
                  if str(n.target).startswith(tuple(json.loads(sys.argv[5])))})
arrays = [np.load(f"{inputs}_{i}.npy") for i in range(len(p.get_input_names()))]
first = p.run(arrays)
fa.reset_launch_counts()
out = p.run(arrays)
launches = dict(fa.launch_counts)
again = p.run(arrays)
replayed, eager = p.compare_eager()
times = {"predictor": [], "eager": []}
dev = [torch.from_numpy(a).to("cuda") for a in arrays]
for _ in range(3):
    p.run(arrays)
for mode in ("predictor", "eager") * 2:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(int(sys.argv[6]) // 2):
        if mode == "predictor":
            p.run(arrays)
        else:
            with torch.no_grad():
                p._module(*dev)
    torch.cuda.synchronize()
    times[mode].append((time.perf_counter() - t) / (int(sys.argv[6]) // 2) * 1e3)
np.save(out_path, out[0])
print(json.dumps({
    "import_s": import_s, "load_s": load_s, "flash_nodes": flash, "inlined": inlined,
    "launches": launches.get("flash_fwd", 0),
    "masked": launches.get("flash_fwd_masked", 0),
    "traces": p.trace_count,
    "runs_equal": all(np.array_equal(a, b) for a, b in zip(first, out))
                  and all(np.array_equal(a, b) for a, b in zip(out, again)),
    "replay_equals_eager": all(torch.equal(a, b) for a, b in zip(replayed, eager)),
    "predictor_ms": times["predictor"], "eager_ms": times["eager"],
    "modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu")),
}))
"""


def _classifier(model):
    """A BERT sequence classifier taking (ids, mask) positionally, the
    inputs of the exported program."""
    import torch

    class Classify(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, ids, mask):
            return self.model(ids, attention_mask=mask)

    return Classify(model)


def _padded_batch(vocab, batch, seq, seed):
    """Token ids and a key-padding mask (row 0 full, the rest from a
    quarter to all of `seq` tokens), as int32 arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)
    lens = rng.integers(seq // 4, seq + 1, size=batch)
    lens[0] = seq
    mask = (np.arange(seq)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


def _op_dispatch_cost(smi, b, s, h, d, rounds=3):
    """The registered op's host cost per call: K1 (bf16, unmasked) through
    `paddle_tpu_torch::flash_fwd` (the dispatcher, as an exported program
    calls it) against `flash_forward`, which computes through the op's body
    directly, `rounds` rounds in turns, each the median of `time_ms`'s
    calls (CUDA events around each call, so the host's launch is
    included)."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    via, direct = [], []
    for _ in range(rounds):
        via.append(time_ms(lambda: fa.flash_fwd_op(q, k, v, False, d ** -0.5, None, None)))
        direct.append(time_ms(lambda: fa.flash_forward(q, k, v, causal=False)))
    log("export", f"K1 b={b} s={s} h={h} d={d} unmasked: through the registered op "
                  f"{statistics.median(via):.4f} ms a call, through flash_forward (the "
                  f"op's body, directly) {statistics.median(direct):.4f} (rounds in turns: "
                  f"{[round(x, 4) for x in via]} and {[round(x, 4) for x in direct]}) | {smi}")


def phase_export(smi, device="cuda", bert=None, tiny=None, llama=None,
                 requests=EXPORT_REQUESTS, timed=EXPORT_TIMED):
    """The inference export (`jit.save`, `inference.export`, `Predictor`,
    `jit.load`, `serve`'s /predict), each leg failing the phase:
    (a) BERT-base sequence classification, 12 layers, bf16, batch 32 x 128
        with key padding (so K1 runs with segment ids): the live model's
        eager forward, then `jit.save` with InputSpecs and `jit.load` in a
        fresh process that imports `paddle_tpu_torch` alone (no jax, no
        paddle_tpu): its graph holds 12 `paddle_tpu_torch::flash_fwd` nodes
        and no inlined attention, its outputs equal the live forward's bit
        for bit, a run launches K1 exactly 12 times, a second run of the
        signature traces nothing and a replay equals an eager run of the
        program bit for bit; prints jit.load's seconds in the child and the
        Predictor's ms per run (host arrays in and out) beside an eager
        run of the program's module;
    (b) `serve(prefix)`: EXPORT_REQUESTS POST /predict, each output equal
        to `Predictor.run` on the same inputs bit for bit, GET /health 200;
    (c) a tiny BERT (float32) exported on the CPU, served on the card by
        `Predictor`: K1 launched, outputs within K1's float32 tolerances
        of the CPU's;
    (d) Llama-2-7B's widths at 2 layers, bf16, logits at 1 x 512: exported
        on the card, equal to the live eager forward bit for bit, K1
        launched twice (causal) a run.
    On the card K1 is first held against its plain version at (a)'s shape
    and timed there (the `flash_fwd_export` record), and the registered
    op's host cost per call is timed (`_op_dispatch_cost`).  Returns (ok, launch
    counts of every run of the exported programs, that record)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa

    no_dropout = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    bert = bert or dict(cfg=BertConfig.bert_base(**no_dropout), batch=EXPORT_BATCH,
                        seq=EXPORT_SEQ, dtype="bfloat16")
    tiny = tiny or dict(cfg=BertConfig.tiny(**no_dropout), batch=4, seq=64)
    llama = llama or dict(cfg=LlamaConfig.llama2_7b(num_hidden_layers=EXPORT_LLAMA_LAYERS),
                          seq=EXPORT_LLAMA_SEQ, dtype="bfloat16")
    on_card = torch.device(device).type == "cuda"
    parity_matmuls()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    oks, runs, record = {}, [], {}
    if on_card:
        # K1 at (a)'s shape, BERT's padding ids, against its plain version,
        # timed beside SDPA with the equivalent boolean mask
        oks["kernel"], record, _ = _masked_case(bert["batch"], bert["seq"],
                                                bert["cfg"].num_attention_heads,
                                                bert["cfg"].num_attention_heads,
                                                "pad", timed=True)
        _op_dispatch_cost(smi, bert["batch"], bert["seq"], bert["cfg"].num_attention_heads,
                          bert["cfg"].hidden_size // bert["cfg"].num_attention_heads)

    def read(run):
        fa.reset_launch_counts()
        out = run()
        runs.append(dict(fa.launch_counts))
        return out

    # (a) jit.save, jit.load in a fresh process
    cfg, layers = bert["cfg"], bert["cfg"].num_hidden_layers
    model = _classifier(BertForSequenceClassification(cfg, device=device,
                                                      dtype=bert["dtype"], seed=0))
    ids, mask = _padded_batch(cfg.vocab_size, bert["batch"], bert["seq"], seed=0)
    with torch.no_grad():
        live = model(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
    live = live.float().cpu().numpy()
    prefix = str(EXPORT_DIR / "bert")
    t0 = time.perf_counter()
    spec = [jit.InputSpec([bert["batch"], bert["seq"]], "int32")] * 2
    jit.save(model, prefix, input_spec=spec)
    save_s = time.perf_counter() - t0
    for i, a in enumerate((ids, mask)):
        np.save(f"{prefix}_in_{i}.npy", a)
    if on_card:
        proc = subprocess.run(
            [sys.executable, "-c", _EXPORT_CHILD, str(ROOT), prefix, f"{prefix}_in",
             f"{prefix}_out.npy", json.dumps(INLINED_ATTENTION), str(timed)],
            capture_output=True, text=True, timeout=600, env=dict(os.environ))
        if proc.returncode != 0:
            log("export a", f"the fresh process failed (exit {proc.returncode}): "
                            f"{proc.stderr[-3000:]} -> FAIL")
            child = None
        else:
            child = json.loads(proc.stdout.strip().splitlines()[-1])
    else:  # the CPU rehearsal: the same checks in this process
        p = jit.load(prefix, device=device)
        nodes = [n for n in p.program.graph.nodes if n.op == "call_function"]
        out = p.run([ids, mask])
        np.save(f"{prefix}_out.npy", out[0])
        child = dict(import_s="not measured", load_s="not measured", traces=p.trace_count,
                     launches=0, masked=0,
                     flash_nodes=sum(n.target is torch.ops.paddle_tpu_torch.flash_fwd.default
                                     for n in nodes),
                     inlined=sorted({str(n.target) for n in nodes
                                     if str(n.target).startswith(INLINED_ATTENTION)}),
                     runs_equal=True, replay_equals_eager=True, modules=[],
                     predictor_ms=["not measured"], eager_ms=["not measured"])
    if child is None:
        oks["a"] = False
    else:
        got = np.load(f"{prefix}_out.npy")
        same = got.shape == live.shape and np.array_equal(got, live)
        want = layers if on_card else 0
        oks["a"] = (same and child["flash_nodes"] == layers and not child["inlined"]
                    and child["launches"] == want and child["masked"] == want
                    and child["traces"] == 1 and child["runs_equal"]
                    and child["replay_equals_eager"] and not child["modules"])
        med = lambda xs: statistics.median(xs) if isinstance(xs[0], float) else xs[0]
        secs = lambda x: x if isinstance(x, str) else f"{x:.2f} s"
        load = (f"{secs(child['load_s'])} (after {secs(child['import_s'])} to import "
                f"torch and the port and start CUDA)")
        log("export a", f"BERT-base {cfg.num_hidden_layers} layers {bert['dtype']} "
                        f"{bert['batch']} x {bert['seq']} with key padding: jit.save "
                        f"{save_s:.2f} s; in a fresh process jit.load {load}, "
                        f"graph flash_fwd nodes {child['flash_nodes']} (want {layers}), "
                        f"inlined attention {child['inlined'] or 'none'}, modules of jax "
                        f"or paddle_tpu {child['modules'] or 'none'}; outputs equal to "
                        f"the live forward bit for bit {same}; K1 launches a run "
                        f"{child['launches']} (masked {child['masked']}, want {want}); "
                        f"traces after three runs {child['traces']}, runs equal "
                        f"{child['runs_equal']}, replay equal to eager "
                        f"{child['replay_equals_eager']}; Predictor.run ms "
                        f"{med(child['predictor_ms'])} against the program's eager "
                        f"forward {med(child['eager_ms'])} (medians of "
                        f"{child['predictor_ms']} and {child['eager_ms']}) -> "
                        f"{'ok' if oks['a'] else 'FAIL'} | {smi}")
        if on_card:
            runs.append({"flash_fwd": child["launches"],
                         "flash_fwd_masked": child["masked"]})
    del model
    _free()

    # (b) serve(prefix): POST /predict against Predictor.run of the
    # server's own Predictor (the artifact is loaded once)
    if on_card:
        server = inference.serve(prefix, port=0, block=False, handle_signals=False)
        pred = server.predictor
    else:  # serve(prefix) would load on the card
        pred = jit.load(prefix, device=device)
        server = inference.serve(pred, port=0, block=False, handle_signals=False)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        same = []
        for r in range(requests):
            rid, rmask = _padded_batch(cfg.vocab_size, bert["batch"], bert["seq"],
                                       seed=100 + r)
            body = _post(f"{url}/predict", {"inputs": [rid.tolist(), rmask.tolist()]})
            served = np.asarray(body["outputs"][0], np.float32)
            direct = read(lambda: pred.run([rid, rmask]))[0]
            same.append(served.shape == direct.shape and np.array_equal(served, direct))
        health = _get_full(f"{url}/health")[0]
    finally:
        server.stop()
    oks["b"] = all(same) and health == 200
    log("export b", f"serve(prefix): {requests} POST /predict equal to Predictor.run "
                    f"bit for bit {same}; GET /health {health} -> "
                    f"{'ok' if oks['b'] else 'FAIL'}")
    del pred, server
    _free()

    # (c) exported on the CPU, served on the card
    tcfg = tiny["cfg"]
    cpu_model = _classifier(BertForSequenceClassification(tcfg, device="cpu", seed=1))
    tids, tmask = _padded_batch(tcfg.vocab_size, tiny["batch"], tiny["seq"], seed=2)
    with torch.no_grad():
        cpu_out = cpu_model(torch.from_numpy(tids), torch.from_numpy(tmask))
    tprefix = str(EXPORT_DIR / "tiny_cpu")
    inference.export(cpu_model, tprefix, [tids, tmask])
    tpred = inference.Predictor(tprefix, device=device)
    out = read(lambda: tpred.run([tids, tmask]))[0]
    launched = runs[-1].get("flash_fwd", 0)
    near = close(torch.from_numpy(out)[:, None, None], cpu_out[:, None, None])
    err = float(np.abs(out - cpu_out.numpy()).max())
    oks["c"] = near and (launched > 0 or not on_card)
    log("export c", f"tiny BERT (float32, {tcfg.num_hidden_layers} layers) exported on "
                    f"the CPU, run on {device}: K1 launches {launched}, max |card - cpu| "
                    f"{err:.3e} (within K1's float32 tolerances {near}) -> "
                    f"{'ok' if oks['c'] else 'FAIL'}")
    del tpred, cpu_model
    _free()

    # (d) Llama-2-7B's widths, 2 layers, exported on the card
    lcfg = llama["cfg"]
    lm = LlamaForCausalLM(lcfg, device=device, dtype=llama["dtype"], seed=0).eval()
    lids = np.random.default_rng(4).integers(1, lcfg.vocab_size, size=(1, llama["seq"])
                                             ).astype(np.int32)
    with torch.no_grad():
        lt = torch.from_numpy(lids).to(device)
        fa.reset_launch_counts()
        llive = lm(lt).float().cpu().numpy()
        want_launches = fa.launch_counts["flash_fwd"]
    lprefix = str(EXPORT_DIR / "llama")
    t0 = time.perf_counter()
    inference.export(lm, lprefix, [lt], with_weights=False)
    export_s = time.perf_counter() - t0
    del lm, lt
    _free()
    lpred = inference.Predictor(lprefix, device=device)
    lpred.run([lids])
    lout = read(lambda: lpred.run([lids]))[0]
    lsame = lout.shape == llive.shape and np.array_equal(lout, llive)
    launched = runs[-1].get("flash_fwd", 0)
    oks["d"] = lsame and launched == want_launches and (launched == EXPORT_LLAMA_LAYERS
                                                        or not on_card)
    log("export d", f"Llama-2-7B widths, {lcfg.num_hidden_layers} layers, {llama['dtype']}, "
                    f"logits at 1 x {llama['seq']}: inference.export {export_s:.2f} s, "
                    f"logits equal to the live forward bit for bit {lsame}, K1 launches a "
                    f"run {launched} (eager {want_launches}) -> "
                    f"{'ok' if oks['d'] else 'FAIL'}")
    del lpred
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    _free()
    total = {k: sum(c.get(k, 0) for c in runs) for k in fa.launch_counts}
    log("export", f"legs {oks}; launches of the exported programs {_main(total)} -> "
                  f"{'ok' if all(oks.values()) else 'FAIL'}")
    return all(oks.values()), total, record


# ---------------------------------------------------------------------------
# GPT-3 13B and the mixture of experts
# ---------------------------------------------------------------------------

# the gpt phase: GPT-3 13B at full width and depth (models/gpt.py
# `gpt3_13b`: vocab 50304, hidden 5120, 40 layers of 40 heads, FFN 20480,
# 2048 positions), bf16, seeded weights, through the generate phase's
# geometry with GPT_BEAMS beams; then the greedy tokens against the argmax
# of one full forward (K1) over the generated sequence: a token that
# differs must be a near tie, the forward's top logit within GPT_TIE_REL
# of max|logit| above the generated token's (the form of SESSION_TIE_REL:
# twice the largest teacher-forced logit difference the generate checks
# print, rounded up); GPT_DECODE_TIMED decode replays timed
GPT_BEAMS = 2
GPT_TIE_REL = 0.04
GPT_DECODE_TIMED = 32
# the moe phase: (b) GPT-3 13B's widths at MOE_GPT_LAYERS layers, layer 1 an
# MoE of MOE_GPT_EXPERTS experts (top-2, capacity factor 2.0), bf16 O2,
# AdamW, MOE_GPT_BATCH x MOE_GPT_SEQ tokens, MOE_GPT_STEPS steps captured
# against as many eager ones; (c) bench_moe's step (bench.py:2229-2253):
# d 1024, hidden 4096, 8 experts, top-2, capacity factor 1.25, batch 8 x
# 1024, float32, AdamW at 1e-4, BENCH_MOE["steps"] steps a window, median of
# BENCH_MOE["windows"] windows; its MoELayer on BENCH_MOE_F64_TOKENS tokens
# against a float64 CPU run, max|diff| / max|out| <= BENCH_MOE_F64_TOL
# (float32 products over d and the hidden width, TF32 off)
MOE_GPT_LAYERS = 2
MOE_GPT_EXPERTS = 8
MOE_GPT_BATCH = 2
MOE_GPT_SEQ = 2048
MOE_GPT_STEPS = 4
MOE_GPT_RECOMPUTE_STEPS = 2
BENCH_MOE = dict(d_model=1024, d_hidden=4096, experts=8, batch=8, seq=1024,
                 steps=12, windows=3)
BENCH_MOE_F64_TOKENS = 512
BENCH_MOE_F64_TOL = 1e-4


def _gpt_argmax_check(model, greedy, s0):
    """The greedy tokens after the prompt against the argmax of one full
    forward over the generated sequence (the reference's check,
    tests/test_models.py:393-396), row by row: equal, or a near tie (the
    forward's top logit at most GPT_TIE_REL of max|logit| above the
    generated token's).  Returns (ok, the forward's launch counts, a line's
    text)."""
    import torch

    from paddle_tpu_torch import profiler

    profiler.reset_kernel_launch_counts()
    with torch.no_grad():
        rows = model(greedy[:, :-1])[:, s0 - 1:].float()  # [b, n, V]
    torch.cuda.synchronize()
    counts = profiler.kernel_launch_counts()
    gen = greedy[:, s0:].long()
    top = rows.max(-1).values
    picked = rows.gather(-1, gen[..., None])[..., 0]
    gap = (top - picked) / rows.abs().amax(-1)
    differ = rows.argmax(-1) != gen
    worst = gap[differ].max().item() if bool(differ.any()) else 0.0
    finite = bool(torch.isfinite(rows).all())
    ok = finite and worst <= GPT_TIE_REL
    return ok, counts, (f"greedy tokens equal to the full forward's argmax "
                        f"{int((~differ).sum())}/{differ.numel()}, the others near "
                        f"ties (largest gap {worst:.3e} of max|logit|, bound "
                        f"{GPT_TIE_REL}); logits finite {finite}")


def _gpt_step_ms(model, greedy, s0, batch):
    """Milliseconds of one replay of greedy's prefill step at `s0` rows
    (median of 5) and of one decode step (the median over 3 windows of
    GPT_DECODE_TIMED replays from position s0), on CUDA events.  The
    greedy call is made again first, at its geometry (the predictor's
    calls replaced it): its tokens must equal `greedy`'s.  Returns
    (prefill ms, decode ms, tokens equal)."""
    import torch

    again = model.generate(greedy[:, :s0].contiguous(),
                           max_new_tokens=greedy.shape[1] - s0)
    step = model._gen_fns["greedy"]
    ids = greedy[:, :s0].contiguous()
    zero = torch.zeros((), dtype=torch.int32, device=model.device)
    prefill = time_ms(lambda: step((batch, s0), toks=ids, pos=zero), iters=5,
                      warmup=1)
    at = torch.tensor(s0, dtype=torch.int32, device=model.device)
    tok = greedy[:, s0:s0 + 1].contiguous()

    def window():
        step((batch, 1), toks=tok, pos=at)
        for _ in range(GPT_DECODE_TIMED - 1):
            step((batch, 1))

    decode = time_ms(window, iters=3, warmup=1) / GPT_DECODE_TIMED
    return prefill, decode, torch.equal(again, greedy)


def phase_gpt(smi, cfg=None, device="cuda", batch=GEN_BATCH, prompt_len=GEN_LEN,
              new_tokens=GEN_NEW, beams=GPT_BEAMS):
    """GPT-3 13B serving at full width and depth (bf16, seeded weights,
    built on the card): `phase_generate`'s greedy, beam search, seeded
    sampling, short prompt and POST /generate checks on the GPT (K6 once
    per layer for every prefill of 64+ rows, K2 over the caches' page view
    for the rest), then the greedy tokens against one full forward (K1);
    prints prefill ms, decode ms a step, generated tokens/s, peak memory
    and the launches.  Returns (ok, the launch counts of the generate calls
    and the forward)."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = cfg or GPTConfig.gpt3_13b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device, dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log("gpt", f"GPT-3 13B: {n} parameters ({2 * n / 1e9:.2f} GB in bf16), "
               f"{cfg.num_hidden_layers} layers of {cfg.num_attention_heads} heads "
               f"of {cfg.head_dim}, hidden {cfg.hidden_size}, FFN "
               f"{cfg.intermediate_size}, vocab {cfg.vocab_size}; seeded weights "
               f"built on the card in {time.perf_counter() - t0:.1f} s")
    kept = {}
    with labelled("gpt "):
        ok, counts = phase_generate(smi, model, device, batch=batch,
                                    prompt_len=prompt_len, new_tokens=new_tokens,
                                    beams=beams, kept=kept)
    greedy = kept["greedy"]
    good, fwd, text = _gpt_argmax_check(model, greedy, prompt_len)
    want = {"flash_fwd": cfg.num_hidden_layers, "flash_fwd_wgmma": cfg.num_hidden_layers}
    fwd_ok = _main(fwd) == want
    ok &= good and fwd_ok
    log("gpt", f"{text}; the forward over {tuple(greedy[:, :-1].shape)} launched "
               f"{_main(fwd)} (expected {want}) -> "
               f"{'ok' if good and fwd_ok else 'FAIL'}")
    prefill_ms, decode_ms, same = _gpt_step_ms(model, greedy, prompt_len, batch)
    ok &= same
    total = {k: counts.get(k, 0) + fwd.get(k, 0) for k in counts}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("gpt", f"greedy again at its geometry (new caches, new captures): the "
               f"same tokens {same} -> {'ok' if same else 'FAIL'}")
    log("gpt", f"GPT-3 13B generate, batch {batch} x {prompt_len} tokens + "
               f"{new_tokens}: prefill_ms {prefill_ms:.3f} (one replay), "
               f"decode_ms_per_step {decode_ms:.3f} (replays of the captured "
               f"step), generated_tokens_per_s "
               f"{batch * new_tokens / kept['greedy_s']:.2f} (the warm greedy call, "
               f"prefill included), peak_mem_gib {peak:.2f}; launches K1 "
               f"{total['flash_fwd']}, K6 {total['dense_decode']}, K2 "
               f"{total['paged_decode_fused']} | {smi}")
    del model, greedy, kept
    return ok, total


def _moe_gpt(cfg, device, seed=0, steps_kept=None):
    """The MoE GPT's training step as bench_llama writes its own
    (bench.py:196-202): a float32 model on the card, AdamW at 1e-4, bf16
    O2; the step returns the loss, the MoE layer's aux loss and its
    dropped fraction."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(cfg, device=device, dtype="float32", seed=seed).train()
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    (moe,) = model.moe_layers()

    def step(ids):
        loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss, moe.aux_loss, moe.drop_stats["dropped_fraction"]

    return _JitRun(step, lambda: _opt_state(model, opt))


def _bench_moe(device, bench, seed=0):
    """bench_moe's model, optimizer and step (bench.py:2242-2253) at the
    geometry of `bench` (BENCH_MOE's keys)."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.incubate.moe import MoELayer

    torch.manual_seed(seed)
    moe = MoELayer(d_model=bench["d_model"], d_hidden=bench["d_hidden"],
                   num_experts=bench["experts"], top_k=2, device=device)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=moe.named_parameters())

    def step(x):
        out = moe(x)
        loss = (out.float() ** 2).mean() + 0.01 * moe.aux_loss
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss, moe.aux_loss, moe.drop_stats["dropped_fraction"]

    return moe, opt, step


def _routing_card_vs_cpu(device, tokens, experts):
    """The routing functions on the card against the CPU on the same
    logits: random float32 logits (top-1 and top-2, tight and ample
    capacity, expert choice) and bf16 logits on a coarse grid, where most
    rows tie.  The dispatch tensors, slots used and drop counts must be
    equal; the combine weights and aux loss (a float32 softmax each side)
    within 1e-6, and their bitwise equality is printed.  Returns (ok, a
    line's text)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate.moe import route_tokens

    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.standard_normal((tokens, experts)).astype(np.float32))
    coarse = (torch.round(base * 2) / 2).bfloat16()
    cases = [(base, 1, tokens // experts // 2, False), (base, 2, tokens // 2, False),
             (base, 2, 2 * tokens // experts, False), (coarse, 2, tokens // experts, False),
             (coarse, 1, tokens // experts, False), (base, 2, tokens // experts, True),
             (coarse, 2, tokens // experts, True)]
    ok, bitwise, worst = True, 0, 0.0
    for lg, k, cap, ec in cases:
        cpu = route_tokens(lg, k, cap, ec)
        card = [x.cpu() if isinstance(x, torch.Tensor) else tuple(y.cpu() for y in x)
                for x in route_tokens(lg.to(device), k, cap, ec)]
        (cd, cc, ca, (cdr, cu)), (gd, gc, ga, (gdr, gu)) = cpu, card
        ok &= (torch.equal(cd, gd) and torch.equal(cu, gu) and torch.equal(cdr, gdr))
        err = max((cc - gc).abs().max().item(), (ca - ga).abs().item())
        worst = max(worst, err)
        ok &= err <= 1e-6
        bitwise += int(torch.equal(cc, gc) and torch.equal(ca, ga))
    return ok, (f"routing on the card vs the CPU over {len(cases)} cases ({tokens} "
                f"tokens, {experts} experts; top-1, top-2, expert choice; float32 "
                f"and tied bf16 logits): dispatch, slots and drops equal; combine "
                f"and aux within {worst:.3e} (bound 1e-6), bit for bit in "
                f"{bitwise}/{len(cases)}")


def _bench_moe_f64(moe, x, device):
    """bench_moe's MoELayer on the card (float32, TF32 off) against a copy
    in float64 on the CPU, on the first BENCH_MOE_F64_TOKENS tokens.
    Returns (max|diff| / max|out|, dropped assignments on the card)."""
    import copy

    import torch

    xs = x.reshape(1, -1, x.shape[-1])[:, :BENCH_MOE_F64_TOKENS].contiguous()
    with torch.no_grad():
        out = moe(xs).double().cpu()
        dropped = int(moe.drop_stats["dropped_tokens"].item())
        ref = copy.deepcopy(moe).to("cpu", torch.float64)(xs.cpu().double())
    return ((out - ref).abs().max() / ref.abs().max()).item(), dropped


def _einsum_share(moe, x, step):
    """Ms of bench_moe's dispatch and combine einsums at the step's shapes
    (dispatch forward; combine forward and its backward to the expert
    outputs and the combine weights), alone on the step's own routing
    tensors, against an eager step's (`step(x)`): device ms from
    torch.profiler, or, when it saw no device time for either (it can
    lose a window's records), CUDA-event ms of both, the einsums' GEMMs
    being long enough for the host to stay ahead.  Returns (einsum ms,
    step ms, share, "device" or "events")."""
    import torch

    flat = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        disp, comb, _, _, _ = moe.gate(flat)
        eo = moe.experts(torch.einsum("td,tec->ecd", flat, disp))
    eo = eo.requires_grad_()
    comb = comb.requires_grad_()
    g = torch.randn_like(flat)

    def einsums():
        torch.einsum("td,tec->ecd", flat, disp)
        out = torch.einsum("ecd,tec->td", eo, comb)
        torch.autograd.grad(out, (eo, comb), g)

    ein, _ = device_ms(einsums, iters=3, warmup=1)
    whole, _ = device_ms(lambda: step(x), iters=3, warmup=1)
    how = "device"
    if ein is None or whole is None:
        ein = time_ms(einsums, iters=5, warmup=1)
        whole = time_ms(lambda: step(x), iters=5, warmup=1)
        how = "events"
    return ein, whole, ein / whole, how


def phase_moe(smi, device="cuda", cfg=None, batch=MOE_GPT_BATCH, seq=MOE_GPT_SEQ,
              steps=MOE_GPT_STEPS, bench=None):
    """(b) A 13B-width MoE GPT (`cfg`, default gpt3_13b with MOE_GPT_LAYERS
    layers and MOE_GPT_EXPERTS experts: layer 0 dense, layer 1 MoE) trained
    in bf16 O2 with AdamW under `jit.to_static`: `_jit_path`'s captured
    steps against an eager twin bit for bit (losses, aux, dropped fraction,
    every parameter and optimizer state), one trace, K1, K3 and adam_fused
    in each replay, eager and captured windows in turns; falling losses
    and aux > 0; MOE_GPT_RECOMPUTE_STEPS eager steps with use_recompute
    equal to the plain twin's bit for bit; then a greedy `generate` of the
    model (bf16) checked as the generate phase checks it.  (c) bench_moe's
    step under `to_static`: captured against eager bit for bit, one trace,
    step ms, tokens/s, aux and dropped fraction; the einsums' share of the
    step's device time; the routing on the card against the CPU; the layer
    against float64.  Returns (ok, {"train": launches of the captured
    calls, "generate": of the generate calls, "bench": of bench_moe's
    captured calls})."""
    import dataclasses

    import numpy as np
    import torch

    from paddle_tpu_torch import jit, profiler
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or GPTConfig.gpt3_13b(num_hidden_layers=MOE_GPT_LAYERS,
                                    moe_num_experts=MOE_GPT_EXPERTS)
    bench = bench or BENCH_MOE
    parity_matmuls()  # TF32 off: float32 products in float32
    log("moe", f"TF32 for matmuls: {torch.backends.cuda.matmul.allow_tf32}, for "
               f"cuDNN: {torch.backends.cudnn.allow_tf32}")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(batch, seq))
                           .astype(np.int32)).to(device)
    counts, oks, kept = {}, {}, {}
    # (b) the MoE GPT's captured step against its eager twin
    ok, counts["train"] = _jit_path(
        smi, f"b moe gpt {batch} x {seq}", lambda: _moe_gpt(cfg, device),
        [(ids,)] * steps, on_card, want=("flash_fwd", "flash_bwd", "adam_fused"),
        kept=kept, label="moe")
    eager = kept["eager"]  # [steps, (loss, aux, dropped fraction)]
    falling = bool(eager[-1, 0] < eager[0, 0]) and bool((eager[:, 1] > 0).all())
    oks["train"] = ok and falling
    log("moe", f"b: eager losses {eager[:, 0].tolist()}, falling and aux > 0 "
               f"{falling}; aux per step {eager[:, 1].tolist()}, dropped fraction "
               f"per step {eager[:, 2].tolist()} -> {'ok' if falling else 'FAIL'}")
    _free()
    # recompute against the plain twin, eager
    run = _moe_gpt(dataclasses.replace(cfg, use_recompute=True), device)
    rc = torch.cat([_step_outputs(run.step(ids))
                    for _ in range(MOE_GPT_RECOMPUTE_STEPS)]).cpu()
    same = torch.equal(rc, eager[:MOE_GPT_RECOMPUTE_STEPS])
    oks["recompute"] = same
    log("moe", f"b: {MOE_GPT_RECOMPUTE_STEPS} eager steps with use_recompute: "
               f"outputs {rc.tolist()} equal to the plain twin's bit for bit {same} "
               f"-> {'ok' if same else 'FAIL'}")
    del run
    _free()
    # a greedy generate of the same model, checked as the generate phase's
    model = GPTForCausalLM(cfg, device=device, dtype="bfloat16", seed=0)
    with labelled("moe "):
        oks["generate"], counts["generate"] = phase_generate(
            smi, model, device, greedy_only=True)
    del model
    _free()
    # (c) bench_moe's step
    d, b, s = bench["d_model"], bench["batch"], bench["seq"]
    x = torch.from_numpy(np.random.RandomState(0).randn(b, s, d).astype(np.float32)
                         ).to(device)
    moe_e, _, eager_step = _bench_moe(device, bench)
    moe, _, step = _bench_moe(device, bench)
    static = jit.to_static(step)
    t0 = time.perf_counter()
    first = _step_outputs(static(x))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    twins = [(first, _step_outputs(eager_step(x)))]
    counts["bench"] = {}
    for _ in range(2):  # the captured calls' launches alone
        profiler.reset_kernel_launch_counts()
        got = _step_outputs(static(x))
        for k, v in profiler.kernel_launch_counts().items():
            counts["bench"][k] = counts["bench"].get(k, 0) + v
        twins.append((got, _step_outputs(eager_step(x))))
    torch.cuda.synchronize()
    same = all(torch.equal(a, e) for a, e in twins) and all(
        torch.equal(p, q) for p, q in zip(moe.parameters(), moe_e.parameters()))
    del moe_e, eager_step
    rates, step_ms = [], []
    for _ in range(bench["windows"]):
        t0 = time.perf_counter()
        for _ in range(bench["steps"]):
            out = static(x)
        aux, dropf = out[1].item(), out[2].item()  # syncs the window
        wall = time.perf_counter() - t0
        rates.append(b * s * bench["steps"] / wall)
        step_ms.append(wall / bench["steps"] * 1e3)
    ein_ms, whole_ms, share, how = _einsum_share(moe, x, step)
    traced = static.trace_count
    per_replay = _jit_counts(counts["bench"], 2)
    oks["bench"] = same and traced == 1 and (per_replay["adam_fused"] == 1
                                             or not on_card)
    log("moe", f"c bench_moe (d {d}, hidden {bench['d_hidden']}, "
               f"{bench['experts']} experts, top-2, capacity "
               f"{moe.gate.capacity(b * s)}, {b} x {s} tokens, float32, AdamW): 3 "
               f"captured steps equal to an eager twin's bit for bit {same}; "
               f"trace_count {traced}; launches per replay {_main(per_replay)}; "
               f"first call {first_s:.3f} s; step_ms {statistics.median(step_ms):.3f} "
               f"(windows " + " ".join(f"{t:.3f}" for t in step_ms) + "), "
               f"moe_gshard_tokens_per_sec {statistics.median(rates):.1f}, aux_loss "
               f"{aux:.6f}, dropped_fraction {dropf:.6f}; {how} ms of an eager "
               f"step {whole_ms:.4f}, of the dispatch and combine einsums alone "
               f"{ein_ms:.4f} (share {share:.3f}) -> "
               f"{'ok' if oks['bench'] else 'FAIL'} | {smi}")
    good, text = _routing_card_vs_cpu(device, b * s, bench["experts"])
    rel, dropped = _bench_moe_f64(moe, x, device)
    f64_ok = rel <= BENCH_MOE_F64_TOL
    oks["parity"] = good and f64_ok
    log("moe", f"c: {text} -> {'ok' if good else 'FAIL'}; MoELayer on "
               f"{BENCH_MOE_F64_TOKENS} tokens against float64 on the CPU: "
               f"max|diff|/max|out| {rel:.3e} (bound {BENCH_MOE_F64_TOL}; {dropped} "
               f"assignments dropped) -> {'ok' if f64_ok else 'FAIL'}")
    del static, step, moe, x
    log("moe", f"paths {oks} -> {'ok' if all(oks.values()) else 'FAIL'}")
    return all(oks.values()), counts


def _free():
    """Release the previous phase's model before the next one builds."""
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
        ring_ok, ring_counts = _timed("ring", phase_ring, smi)
        _free()
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
        fault_ok, fault_counts = _timed("fault", phase_fault, smi, model,
                                        **serving)
        _free()
        obs_ok, obs_counts = _timed("obs", phase_obs, smi, model, **serving)
        _free()
        lora_ok, lora_counts, lora_solo_counts = _timed(
            "lora", phase_lora, smi, model, **serving)
        _free()
        # buckets up to the context: the stateless engine prefills the
        # whole ~1.3k-token transcript of the last turns in a warmed one
        sessions_ok, sessions_counts = _timed(
            "sessions", phase_sessions, smi, model,
            **dict(serving, prefill_buckets=[32, 64, 128, 256, 512, 1024, 2047]))
        _free()
        disagg_ok, disagg_counts = _timed("disagg", phase_disagg, smi, model,
                                          **serving)
        _free()
        # the serving fleet: the router, its journal and standby, the
        # disaggregated pairs, session pins, the autoscaler, worker processes
        fleet_ok, fleet_counts = _timed("fleet", phase_fleet, smi, model, **serving)
        _free()
        # tensor-parallel serving: tp 2 and 4 with every rank on the card,
        # over the loaded weights
        tp_ok, tp_counts = _timed("tp", phase_tp, smi, model, **serving)
        _free()
        # tp engines in the disaggregated roles: tp 2 and tp 1 pairs
        roles_ok, roles_counts = _timed("tp", phase_tp_roles, smi, model)
        _free()
        # buckets up to the context: every prompt of the traffic lands in a
        # warmed one, so none traces under traffic
        cp_kw = dict(slots=4, max_len=4096, page_size=128,
                     prefill_buckets=[32, 64, 128, 256, 512, 2048, 4095])
        cp_ok, cp_counts = _timed("cp", phase_cp, smi, model, **cp_kw)
        _free()
        # tensor x context parallelism: K5 per head shard, the cp traffic
        tpcp_ok, tpcp_counts = _timed("tp", phase_tp_cp, smi, model, **cp_kw)
        _free()
        # F4: the same traffic in float32, the model and its arenas too
        model.float()
        _free()
        f32_ok, f32_counts = _timed("cp_f32", phase_cp_f32, smi, model, **cp_kw)
        del model
        _free()
        # the serving paths again with the model in float16
        with labelled("fp16 "):
            serve16_ok, serve16_counts = _timed(
                "serve", phase_fp16_serve, smi, LlamaConfig.llama2_7b(),
                slice_summary, serving, cp_kw)
        _free()
        train_ok, train_counts = _timed(
            "train", phase_train, smi,
            LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS))
        _free()
        # the training loop: Model.fit over the DataLoader, evaluate, the
        # resume and divergence drills, bucketed BERT
        fit_ok, fit_counts, eval_counts = _timed(
            "fit", phase_fit, smi, LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS))
        _free()
        resume_ok = _timed("fit", phase_fit_resume, smi,
                           LlamaConfig.llama2_7b(num_hidden_layers=FIT_RESUME_LAYERS))
        _free()
        diverge_ok = _timed("fit", phase_fit_diverge, smi,
                            LlamaConfig.llama2_7b(num_hidden_layers=FIT_RESUME_LAYERS))
        _free()
        from paddle_tpu_torch.models.bert import BertConfig

        no_dropout = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        fit_bert_ok, fit_bert_counts = _timed("fit", phase_fit_bert, smi,
                                              BertConfig.bert_base(**no_dropout))
        _free()
        # activation recompute: K1 runs twice per layer per step
        recompute_ok, _ = _timed(
            "train", phase_train, smi,
            LlamaConfig.llama2_7b(num_hidden_layers=2, use_recompute=True),
            steps=2, profile=False)
        _free()
        grad_ok, _ = _timed("grads", grad_check,
                            LlamaConfig.llama2_7b(num_hidden_layers=2))
        _free()
        with labelled("fp16 "):
            train16_ok, train16_counts = _timed(
                "train", phase_fp16_train, smi,
                LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS))
        _free()
        amp_ok, amp_counts = _timed("amp", phase_amp, smi, LlamaConfig.llama2_7b(
            num_hidden_layers=AMP_LAYERS))
        _free()
        # O1 with float16 white ops: K1 and K3 take float16 operands
        with labelled("fp16 "):
            amp16_ok, amp16_counts = _timed(
                "amp", phase_amp, smi, LlamaConfig.llama2_7b(
                    num_hidden_layers=AMP_LAYERS), dtype="float16", others=False)
        _free()
        bert_ok, bert_counts = _timed("bert", phase_bert, smi,
                                      BertConfig.bert_base(**no_dropout))
        log("fit", f"BERT examples_per_s: bucketed through fit "
                   f"{_FIGURES['fit_bert_examples_per_s']:.1f}, the bert phase's "
                   f"padded {BERT_SEQ} {_FIGURES['bert_examples_per_s']:.1f}")
        _free()
        bert_grad_ok, _ = _timed("bert", bert_grad_check, BertConfig.bert_base(
            num_hidden_layers=2, **no_dropout))
        _free()
        # the training steps of bench_llama, bench_bert and bench_resnet50
        # (and fp16 with a GradScaler, a stepped schedule) under to_static
        jit_ok, jit_counts = _timed("jit", phase_jit, smi)
        _free()
        # the inference export: BERT-base through jit.save and jit.load in a
        # fresh process, /predict, a CPU export on the card, Llama's widths
        export_ok, export_counts, kernels["flash_fwd_export"] = _timed(
            "export", phase_export, smi)
        _free()
        # GPT-3 13B at full width and depth: lock-step generate and POST
        # /generate; then the 13B-width MoE GPT's captured training step and
        # bench_moe's
        gpt_ok, gpt_counts = _timed("gpt", phase_gpt, smi)
        _free()
        moe_ok, moe_counts = _timed("moe", phase_moe, smi)
        _free()
        # long-context training: the rotating zig-zag form at 32768 tokens
        # over R = 8, then the gathered form at 16384 over R = 4, then one
        # step's gradients against full-sequence attention
        lc = lambda seq, layers, cp: LlamaConfig.llama2_7b(
            num_hidden_layers=layers, context_parallel_degree=cp,
            max_position_embeddings=seq)
        lc_ok, lc_counts = _timed("longcontext", phase_longcontext, smi,
                                  lc(LC_SEQ, LC_LAYERS, LC_R), LC_R, LC_SEQ,
                                  LC_STEPS, "rotating")
        _free()
        lc2_ok, lc2_counts = _timed("longcontext", phase_longcontext, smi,
                                    lc(LC2_SEQ, LC2_LAYERS, LC2_R), LC2_R, LC2_SEQ,
                                    LC2_STEPS, "gathered", profile=False)
        _free()
        lc_grad_ok, _ = _timed("longcontext", longcontext_grad_check,
                               lc(LC_SEQ, 2, LC_R), LC_R, LC_SEQ)
        _free()
        # the conv nets: ResNet-50 and VGG-16 training, card parity, LeNet
        # eager and through Model.fit (adam_fused)
        vision_ok, vision_counts = _timed("vision", phase_vision, smi)
    except Exception:
        traceback.print_exc()
        return 1
    # the float16 main paths' launches, read just after each of their runs
    runs16 = [*serve16_counts, train16_counts, amp16_counts, jit_counts["d"]]
    launches16 = {f"{base}_f16": sum(c.get(base, 0) for c in runs16)
                  for base in ("flash_fwd", "flash_bwd", "dense_decode",
                               "paged_decode_fused", "paged_decode_fused_q8",
                               "paged_decode_fused_q8_mma", "paged_decode_fused_cp",
                               "adam_fused", "unscale_fused")}
    idle16 = [name for name, n in launches16.items() if n == 0]
    log("fp16", f"float16 launches on the main paths {launches16}; kernels not "
                f"launched: {idle16 or 'none'} -> {'FAIL' if idle16 else 'ok'}")
    results = {
        "kernels": kernels_ok, "slice": slice_ok, "prefix": prefix_ok,
        "generate": gen_ok, "dense": dense_ok, "fault": fault_ok, "obs": obs_ok,
        "lora": lora_ok, "sessions": sessions_ok, "disagg": disagg_ok,
        "fleet": fleet_ok, "tp": tp_ok, "tp roles": roles_ok, "tp x cp": tpcp_ok,
        "cp": cp_ok, "cp_f32": f32_ok, "train": train_ok,
        "train recompute": recompute_ok, "grads": grad_ok, "fit": fit_ok,
        "fit resume": resume_ok, "fit diverge": diverge_ok, "fit bert": fit_bert_ok,
        "amp": amp_ok, "bert": bert_ok, "bert grads": bert_grad_ok, "ring": ring_ok,
        "longcontext": lc_ok, "longcontext gathered": lc2_ok,
        "longcontext grads": lc_grad_ok, "fp16 serve": serve16_ok,
        "fp16 train": train16_ok, "fp16 amp": amp16_ok, "vision": vision_ok,
        "jit": jit_ok, "export": export_ok, "gpt": gpt_ok, "moe": moe_ok,
        "fp16 launches": not idle16,
    }
    failed = [name for name, good in results.items() if not good]
    if failed:
        print(f"chip_smoke: a phase failed (see the lines above): {', '.join(failed)}",
              file=sys.stderr)
        return 1
    # launches: the serving, generation and training runs' counts, each read
    # just after its path ran; `paged_decode_tp` and `_q8` are K2's and K4's
    # launches through the per-shard wrappers (the tp phase), timed per
    # shard at the tp phase's decode step; `paged_decode_cp_tp` and `_q8`
    # K5's per head shard (its tp x cp part), timed per shard at the cp
    # decode step
    runs = [counts, *prefix_counts, gen_counts, dense_counts, fault_counts,
            obs_counts, lora_counts, lora_solo_counts, sessions_counts,
            *disagg_counts, *fleet_counts, *tp_counts, *roles_counts,
            *tpcp_counts, *cp_counts,
            *f32_counts, train_counts, fit_counts, eval_counts, fit_bert_counts,
            amp_counts, bert_counts, *ring_counts, lc_counts, lc2_counts,
            *vision_counts, *(jit_counts[p] for p in "abceg"), gpt_counts,
            *moe_counts.values(), export_counts]
    launches = {name: sum(c.get(name, 0) for c in runs) for name in kernels}
    launches.update(launches16)
    # adam_fused at BERT's parameters: the bert phase's, the bucketed BERT
    # fit's and the jit phase's BERT steps' launches; the other entry the
    # Llama runs' (train, fit, amp, longcontext, jit), LeNet's (vision:
    # eager and through Model.fit) and the moe phase's (the MoE GPT,
    # bench_moe)
    launches["adam_fused_bert"] = (bert_counts["adam_fused"] + fit_bert_counts["adam_fused"]
                                   + jit_counts["b"]["adam_fused"]
                                   + jit_counts["e"]["adam_fused"])
    launches["adam_fused"] -= launches["adam_fused_bert"]
    # K5's two variants are one kernel of the record, on each path
    for path in ("", "_mma", "_walk"):
        launches["paged_decode_fused_cp" + path] += sum(
            c["paged_decode_fused_cp_q8" + path] for c in runs)
    # K2 over a dense cache's page view: every K2 launch of the generate and
    # dense phases (neither runs a paged cache)
    launches["paged_decode_fused_dense_generate"] = gen_counts["paged_decode_fused"]
    launches["paged_decode_fused_dense_pool"] = dense_counts["paged_decode_fused"]
    # GPT-3 13B's shapes: K1 of the gpt phase's forward and the MoE GPT's
    # captured steps, K3 of those steps, K6 and K2 of both GPTs' generate
    gpt_runs = (gpt_counts, moe_counts["train"], moe_counts["generate"])
    for name, base in (("flash_fwd_gpt", "flash_fwd"), ("flash_bwd_gpt", "flash_bwd"),
                       ("dense_decode_gpt", "dense_decode"),
                       ("paged_decode_fused_dense_gpt", "paged_decode_fused")):
        launches[name] = sum(c.get(base, 0) for c in gpt_runs)
    # K1 in the exported programs: the export phase's launches, timed at
    # (a)'s shape
    launches["flash_fwd_export"] = export_counts.get("flash_fwd", 0)
    # (record name, source, the Pallas kernel it replaces); a `_wgmma`,
    # `_mma` or `_walk` entry is one path of its kernel, timed at its
    # main-path shape (K1 and K3 at the training shape, the chunk windows at
    # a hit's 256-row chunk prefill, the walks at a decode step), with the
    # launches that took it; a `_masked` entry is K1's or K3's launches with
    # segment ids or a key bias, timed at BERT's shape; an `_offset`,
    # `_carry` or `_delta` entry is K1's or K3's launches with that ring
    # operand, timed at the ring's shape (bench_longcontext_32k: the gathered
    # form's launch for q_offset, a rotating hop for the carry and delta);
    # a `_dense_*` entry is K2 over a dense cache's page view, timed at the
    # generate phase's decode step or the dense pool's, with that phase's
    # K2 launches; a `_gpt` entry is timed at GPT-3 13B's shape on the gpt
    # and moe phases' paths (40 heads of 128), with their launches;
    # `flash_fwd_export` is K1 inside the exported programs, timed at the
    # export phase's BERT-base shape (32 x 128, 12 heads of 64, padding
    # ids), with that phase's launches; the plain entry is timed at its
    # headline shape and counts all its kernel's launches
    entries = (
        ("flash_fwd", "flash_fwd.cu", 186),
        ("flash_fwd_wgmma", "flash_fwd.cu", 186),
        ("paged_decode_fused", "paged_decode.cu", 813),
        ("paged_decode_fused_walk", "paged_decode.cu", 813),
        ("paged_decode_fused_mma", "paged_decode.cu", 813),
        ("paged_decode_fused_q8", "paged_decode.cu", 961),
        ("paged_decode_fused_q8_walk", "paged_decode.cu", 961),
        ("paged_decode_fused_q8_mma", "paged_decode.cu", 961),
        ("paged_decode_tp", "paged_decode.cu", 1116),
        ("paged_decode_tp_q8", "paged_decode.cu", 1148),
        ("paged_decode_cp_tp", "paged_decode.cu", 1411),
        ("paged_decode_cp_tp_q8", "paged_decode.cu", 1411),
        ("flash_bwd", "flash_bwd.cu", 415),
        ("flash_bwd_wgmma", "flash_bwd.cu", 415),
        ("flash_fwd_masked", "flash_fwd.cu", 186),
        ("flash_bwd_masked", "flash_bwd.cu", 415),
        ("flash_fwd_offset", "flash_fwd.cu", 186),
        ("flash_fwd_carry", "flash_fwd.cu", 186),
        ("flash_bwd_offset", "flash_bwd.cu", 415),
        ("flash_bwd_delta", "flash_bwd.cu", 415),
        ("dense_decode", "flash_fwd.cu", 649),
        ("paged_decode_fused_dense_generate", "paged_decode.cu", 813),
        ("paged_decode_fused_dense_pool", "paged_decode.cu", 813),
        ("flash_fwd_gpt", "flash_fwd.cu", 186),
        ("flash_bwd_gpt", "flash_bwd.cu", 415),
        ("dense_decode_gpt", "flash_fwd.cu", 649),
        ("paged_decode_fused_dense_gpt", "paged_decode.cu", 813),
        ("flash_fwd_export", "flash_fwd.cu", 186),
        ("paged_decode_fused_cp", "paged_decode.cu", 1172),
        ("paged_decode_fused_cp_walk", "paged_decode.cu", 1172),
        ("paged_decode_fused_cp_mma", "paged_decode.cu", 1172),
    )
    # the float16 instantiations of K1-K6 (and K4's chunk window), each timed
    # at its kernel's main-path shape in float16, with the launches of the
    # float16 main paths (fp16_serve, fp16_train, the fp16 O1 amp run)
    entries += (
        ("flash_fwd_f16", "flash_fwd.cu", 186),
        ("flash_bwd_f16", "flash_bwd.cu", 415),
        ("dense_decode_f16", "flash_fwd.cu", 649),
        ("paged_decode_fused_f16", "paged_decode.cu", 813),
        ("paged_decode_fused_q8_f16", "paged_decode.cu", 961),
        ("paged_decode_fused_q8_mma_f16", "paged_decode.cu", 961),
        ("paged_decode_fused_cp_f16", "paged_decode.cu", 1172),
    )
    # the optimizer's kernels replace XLA fusions of the reference's step;
    # `adam_fused_bert` is adam_fused timed at BERT-base's parameters, with
    # the bert phase's launches
    entries += (
        ("adam_fused", "optim.cu", "paddle_tpu/optimizer/__init__.py:376"),
        ("adam_fused_bert", "optim.cu", "paddle_tpu/optimizer/__init__.py:376"),
        ("unscale_fused", "optim.cu", "paddle_tpu/amp/__init__.py:228"),
        ("adam_fused_f16", "optim.cu", "paddle_tpu/optimizer/__init__.py:376"),
        ("unscale_fused_f16", "optim.cu", "paddle_tpu/amp/__init__.py:228"),
    )
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
         "replaces": (line if isinstance(line, str)
                      else f"paddle_tpu/ops/flash_attention.py:{line}"),
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
