#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compile csrc/*.cu with nvcc, one process per source at once.
3. kernels — each Hopper kernel against its plain PyTorch version on the
   card at the main path's shapes, with times, the least time the card
   could take (bound) and a one-call PyTorch yardstick (library). Kernel
   and library times are the median (min-max beside it) of 5 CUDA-event
   windows over calls replayed from a CUDA graph, with the eager median
   beside them (`Timing`). quant_matmul with f32 X (three bf16 planes in
   the kernel) and bf16 X (the bf16 decode and serve paths) at M=1, 8 and
   1024, bounded by bytes or bf16 products. flash_attention at B=8, T=128
   (quantize and decode) and B=1, T=512 (serve prefill) in bf16, and
   in f32 (the CUDA-core kernel) at B=8, T=128 beside SDPA at f32;
   the two paged-attention kernels at the serve shapes (8 slots, 28/4
   heads, head_dim 128, 16-token pages, up to 4096 tokens a slot): bf16
   pages and, for int8 / 4-bit codes, the kernel the wrapper's dispatch
   rule names (printed: tensor cores for bf16 q, CUDA cores for f32 q);
   f32 q over f32 pages timed too.
4. quantize — qwen2-7b at full width, n_layers cut 28 -> 2 (the only
   reduction): calibration 8x128, comq_blocked, 4-bit per-channel, greedy,
   3 sweeps, lambda 0.9; the launcher's JSON summary.
5. decode  — serving_params -> prefill of the 8x128 eval batch -> 16 greedy
   decode steps from the packed codes (bf16, the main path), held against
   the same steps run with the plain versions on the card (teacher-forced);
   then the same kernel-vs-plain comparison at f32 compute, which carries
   the precision gate (LOGITS_REL). Launch counts are reset before phase 4
   and read right after the main-path decode.
6. w_down  — one 18944x3584 w_down solve with the panel kernel against the
   same solve with the plain panel version.
7. paged decode — the phase-4 packed model admits the 8 eval prompts at
   mixed lengths (64-128, seeded) through write_prefill and decodes 16
   steps with decode_step_paged and per-slot positions, at kv_bits 0, 8
   and 4, held against the same steps with the plain versions, each
   started from the kernel run's pool (lockstep, teacher-forced; bf16,
   then f32 for the precision gate); a free-running plain run is printed
   beside it.
8. serve  — serve.Runtime on the packed model, greedy, bf16, 8 slots,
   16-token pages: 16 requests (prompts 64-512 tokens, seeded; buckets
   128/256/512), 32 new tokens each, 8 submitted up front and the rest one
   per decode step, at kv_bits 0, 8 and 4 (the serve path: launch counts
   are reset before these runs and read right after; at kv_bits 8 and 4
   every quantized-pool launch must be on the tensor-core kernel). Then at f32 and
   kv_bits 0: each request's tokens equal its solo run through the same
   runtime, and a pool too small for all lifetimes preempts.

9. policy — (a) the launcher's run with --policy
   "0.mlp.w_down=8,1.attn.wk=2,1.mlp.w_gate=3,kv=8" (2/3/4/8-bit leaves,
   codes packed 4, 2 and 1 per byte, int8 KV): per-leaf bits, the summary
   (no guard event, mixed_policy, improvement > 0), 16 greedy steps on the
   static engine with the int8 cache against the plain versions
   (lockstep, teacher-forced, each plain step reading the kernel run's
   own int8 cache rows, the new row included; bf16 printed, f32 under the
   precision gate; bf16 over a bf16 cache under the coarse gate), and the
   phase-8
   traffic through serve.Runtime at kv_bits 8; quant_matmul must launch
   at cpb 1, 2 and 4. (c) the same quantize with --no-guards, then with
   guards again, gives the same codes bit for bit; the three quantize
   times are printed.
   (b) --bits-budget 3.5 --policy kv=4: the allocation histogram, at most
   3.5 bits a parameter, and 8 requests served at kv_bits 4.
   Phase 3 also holds comq_panel at the 2- and 8-bit code ranges and
   quant_matmul at 8-bit w_down and 2-bit wk shapes.
10. moe — granite-moe-3b-a800m at full width (d_model 1536, 24/8 heads,
   head_dim 64, 40 experts top-8, d_ff 512 an expert, vocab 49155),
   n_layers cut 32 -> 4 (the only reduction). First its kernels: comq_panel
   over 40 experts in one launch at B=256, n=512 / 1024 / 1536 against the
   plain version and against 40 single-expert launches (bit for bit),
   flash and both paged kernels at 24/8 heads, hd 64, quant_matmul at
   K=1536, N=1536 / 512. Then the MoE path, counted: the launcher's
   quantize (comq_blocked, 4-bit per-channel; per-expert Grams and one
   panel launch a panel for all experts; seconds per layer), decode from
   the packed codes against the plain versions (bf16, then f32 under the
   precision gate), the phase-8 traffic at kv_bits 0, 8 and 4, and at f32
   mixed == solo for all 16 requests.
11. hybrid — hymba-1.5b at full width (d_model 1600, 25/5 heads, head_dim
   64, d_ff 5504, vocab 32001, a 1024-token window, a parallel Mamba
   branch of d_inner 3200 and state 16), n_layers cut 32 -> 4 (the only
   reduction). First its kernels: flash at 25/5 heads with the window
   (B=8, T=128; B=1, T=2048, where the window binds; SDPA with the window
   as a mask is the yardstick), quant_matmul at the decode projections
   (M=8, K=1600 into N=1600 / 320 / 5504, K=5504 into N=1600), the panel
   at n=6400 and 5504. Then the hybrid path, counted: the launcher's
   quantize (the SSM leaves w_in / w_out among the solved ones, the SSM
   state carried across layers; seconds per layer), decode from the
   packed codes against the plain versions (8x128, and a B=1 prompt of
   1016 tokens whose 16 steps cross position 1024 on the ring cache;
   bf16 and f32 gated with every layer in lockstep — hidden and SSM
   state — and printed free-running: with the plain versions alone, a
   1e-6 change of the quant_matmul outputs moves this model's f32 logits
   by ~1e-2 of max|logit|, `tools/decode_sensitivity.py`), and the static
   Engine (what `launch.serve` runs for this family) on 8 prompts of 128
   tokens, 32 greedy tokens: tok/s at bf16, and at f32 the plain
   versions' greedy tokens with the layers in lockstep equal the
   kernels' (free-running agreement printed). Last a quantize at full
   depth (32 layers): wall time, seconds per layer and peak device
   memory; gated on a finite improvement > 0.
12. audio — musicgen-large at full width (d_model 2048, 32/32 heads: MHA,
   group 1; head_dim 64, d_ff 8192 in a plain GELU MLP, vocab 2048,
   layernorm), n_layers cut 48 -> 4. First its kernels: the panel at
   n=2048 / 6144 / 8192, flash at 32/32 heads (B=8, T=128; B=1, T=512),
   quant_matmul at the decode projections (M=8: K=2048 into N=2048 /
   8192, K=8192 into N=2048), both paged kernels at 32/32 heads, hd 64
   (the tensor-core ones pad the group of 1 to a 16-row fragment). Then
   the audio path, counted: the launcher's quantize (seconds per layer),
   decode from the packed codes against the plain versions (8x128; bf16
   and f32 gated with the layers in lockstep, free-running printed, as
   for hymba), the phase-8 traffic at kv_bits 0, 8 and 4; then at f32
   mixed == solo for all 16 requests and a small pool that preempts, and
   a quantize at full depth (48 layers: wall time, seconds per layer,
   peak memory; improvement > 0).
13. rwkv — rwkv6-7b at full width (d_model 4096, 64 wkv heads of 64, d_ff
   14336, vocab 65536, LoRA 64/64/32, layernorm, attention-free), n_layers
   cut 32 -> 4. First the panel at n=4096 / 14336 and the plain chunked
   wkv timed against the one-pass recurrence's bound (no kernel in either
   package). Then the rwkv path, counted: the launcher's quantize (eight
   projections a layer, the RWKV state carried across layers; TF32 must
   be off), the recurrence's two forms from the packed codes at f32
   (prefill 8x128 in chunks of 16 plus 16 decode steps, and a B=1 prompt
   of 1000 tokens in chunks of 1 plus 16 steps, each against one forward
   over the same tokens, within 1e-2 of max|logit|), and the static Engine
   (what `launch.serve` runs for this family) on 8 prompts of 128 tokens,
   32 greedy tokens: tok/s at bf16.
14. vlm — llama-3.2-vision-90b at full width (d_model 8192, 64/8 heads:
   group 8, head_dim 128, d_ff 28672, vocab 128256, 1601 image tokens of
   width 1280), n_layers cut 100 -> 5: one group of 4 self layers and 1
   gated cross layer (the depth must divide into groups of 5, and two
   groups would pass the card's memory). First its kernels: the panel at
   n=1024 / 8192 / 28672, flash causal at B=8, T=128 and non-causal over
   the 1601 image keys at Tq=128 (prefill) and Tq=1 (decode), SDPA with
   GQA as the yardstick. Then the vlm path, counted: the launcher's
   quantize with 8 images of seeded bf16 features (every cross leaf
   solved; the cross gates are zero at init, so the loss gap cannot see
   the cross layer), then with both gates at 0.5 decode from the
   materialized codes (JAX serves a VLM materialized) against the plain
   versions (gated in lockstep at both types, each layer's output and
   the logits; free-running printed) and the static Engine on 8 prompts
   of 128 tokens with their images, 32 greedy tokens: tok/s at bf16;
   peak device memory.
15. encoder — vit-base-16 at full width and depth (12 layers, d_model
   768, 12/12 heads, d_ff 3072, 1000 classes, layernorm, non-causal).
   First its kernel: flash non-causal at B=8, T=197. Then the encoder
   path, counted: logits and loss of 8 seeded images of 197 patch
   embeddings, dense and 4-bit fake-quantized (`fake_quantize_params`;
   every QT leaf dequantized a layer at a time, as in JAX), kernels
   against the plain versions at bf16 and f32, gated with the layers in
   lockstep (each layer's output and the logits), free-running printed.

16. durability — runs right after phase 9, while the phase-4 model is on
   the card. (a) qwen2-7b at full width, n_layers cut 28 -> 3,
   comq_blocked 4-bit per-channel, calibration 8x128 (seed 0): a clean
   quantize_model, a journaled one, and one killed after layer 1
   (`kill:2`) under `quantize_supervised(restarts=3)`: QT trees, report
   rows and .qpk bytes equal the clean run's; check_integrity covers
   every leaf; resumed_leaves are layers 0-1's; the resumed attempt
   launches comq_panel only past the kill, as often as the clean run did
   there; its peak device memory is at most 1.1x the clean run's. Wall
   times and peaks printed. (b) granite-moe-3b-a800m, 3 layers, policy
   first=8, kill:1: the same oracle. (c) ci.yml's "Quantize fault smoke"
   through the port's launcher on the card (subprocesses, no --device):
   cmp of the two .qpk files, each --out-dir step_0 restored to the .qpk
   arrays. (d) ckpt_write:1 (the torn spill is never journaled; the
   resume completes, codes equal) and nan_tap:1 (a nonfinite_tap guard
   event, a finite run). (e) the phase-8 traffic at f32 on the phase-4
   model: a journaled Runtime killed at its 20th step (and, so that some
   requests have retired, at its 40th), recovered through recover_runtime
   under run_with_restarts(max_restarts=2): 16/16 requests
   token-identical to an uninterrupted run, none retired before the kill
   re-run, replayed == in flight at the kill; decode_step:5,
   page_alloc:3+7 and callback:2 each finish all 16 (decode_step and
   callback token-identical; the callback error on one request only);
   the kill run at bf16 kv_bits 0 and 8 printed, not gated.
17. observability — runs right after phase 16, on the phase-4 model. (a)
   qwen2-7b at full width, n_layers cut 28 -> 2, comq_blocked 4-bit
   per-channel, calibration 8x128: quantize_model untraced, traced (a
   live obs.Tracer and MetricsRegistry), traced, untraced: QT trees equal
   bit for bit; one leaf_solve span per tap group (their leaves are the
   report's rows) and one layer span per layer; every wall_seconds > 0
   traced and 0.0 untraced, their sum at most the report's wall; the
   quant.* counters and histogram counts equal the report's; the walks'
   seconds printed. (b) the phase-8 traffic at bf16 kv_bits 0 and 8 and
   the f32 small pool, each untraced then traced: tokens identical
   request for request, every timeline rebuilt from the trace validates
   and carries the delivered tokens, the registry's tokens, preemptions
   and retirements equal the runtime's, and the small pool preempts and
   resumes. (c) the per-step hook sequence of a live tracer and registry
   at 16 live slots (the decode_step span, which enters record_function
   only while a profiler is attached, none here; 16
   token_events, 3 gauges), microbenchmarked, over the median untraced
   bf16 step wall of (b): < 2% (JAX's budget, benchmarks/serve_bench.py).
   (d) under torch.profiler (CPU and CUDA) a traced 1-layer quantize and
   4 traced decode steps: a comq_panel kernel inside a leaf_solve
   annotation and a paged-attention kernel inside a decode_step one (by
   the launch's correlation id, or the kernel's interval). (e) ci.yml's
   "Observability smoke" through the port's launchers in subprocesses on
   the card (no --device): both exit 0, repro_torch.obs.validate passes
   the quantize trace and, with --timelines --require-preempt, the serve
   trace; metrics.jsonl and metrics.prom are non-empty; the report runs.

18. distribution — runs last, with the parent's allocator emptied; three
   SPMD worlds on the card, each `python -m torch.distributed.run
   --standalone` over this script's `--dist-worker` mode, every rank's
   peak memory printed: (a) nccl, a world of one, qwen2-7b at full width
   and 1 layer (phase 4's calibration) on a (1, 1) mesh, as
   `--shard-data --shard-solve 1` builds it: the .qpk bytes equal the
   meshless run's and dist.bytes_all_reduced equals Σ m²·4 over the
   walk's Grams; (f) compressed_all_reduce: out + new_e == g. Then gloo,
   2 ranks sharing the card: one all-reduce of an 18944² Gram timed
   (through host memory); (b) model 2 and (c) data 2 (one all-reduce a
   tap Gram, counted by `analysis.census`): JAX's Σ err_after (2%) and
   loss gap (0.15) gates
   against the meshless walk; (b) holds every leaf of the model-sharded
   walk bit-identical to the one-rank walk (codes, z_lo, scales; JAX's
   tests/test_dist.py:416: each rank solves only its own columns, over
   the solver's fixed 128-column tiles, so a column rounds alike in a
   shard and in the whole W), each rank's walk seconds and peak memory
   printed beside the meshless run's; (c) holds layer 0's attn_in
   leaves bit for bit what one rank computes from the same Gram sums,
   and its per-leaf code agreement with the meshless walk is printed,
   not gated: every Gram of a 1024-token calibration is rank-deficient
   at these widths, so the Gram's summation order moves codes; (e)
   Runtime(mesh=) over model 2 on phase 4's
   packed model from its .qpk, the phase-8 traffic: f32 kv_bits 0 and 8
   tokens equal the meshless runtime's 16/16, bf16 kv_bits 4 printed, no
   collective inside decode_step (the census under its record_function
   scope), each rank's paged launches; (f) over
   gloo: the mean within a grid step of the exact mean, residuals
   v - q·scale exact. Last gloo, 4 ranks on a (2, 2) mesh: (d) qwen2-7b with (c)'s
   gates, then granite-moe-3b-a800m at 1 of 32 layers: (c)'s gates, every
   MoE layer's kept (token, slot) set the replicated rule's on the walk's
   own routing (equal to the meshless walk's where the routing is), and
   layer 0's experts at a capacity factor of 0.75 on the same inputs:
   the kept set is the replicated rule's (and one rank's routing of the
   whole batch, where the routed ids agree).

19. training — runs after phase 18: qwen2-7b at full width (d_model 3584,
   28/4 heads, head_dim 128, d_ff 18944, vocab 152064, QKV bias, untied
   embeddings), n_layers cut 28 -> 4. (a) the flash-attention backward
   kernel against the plain version's autograd at the families' shapes
   (qwen B=8 T=128 and B=1 T=512, granite's group 3 at hd 64, hymba's
   window of 1024 at T=2048, musicgen's group 1, the VLM's non-causal
   Tq=128 over Tk=1601, vit's non-causal 197), bf16 and f32: dQ, dK, dV
   and the forward's LSE gated; both timed beside the bound, the plain
   backward and SDPA's autograd backward at the same dtype (a yardstick;
   graph replay, as the kernel's, and eager), and the bf16 forward
   with and without its LSE write, beside SDPA's flash forward that also
   returns the LSE (K/V expanded to H heads); then the fused AdamW update
   (csrc/adamw.cu) against its plain version at qwen's, granite's and
   hymba's leaf shapes (a ragged last block of 64 at hymba's 1600, a 0-d
   leaf), f32 and int8 moments, the clip factor folded in: m and v (int8:
   codes, scales and EF bytes) bit for bit, params within 1e-6 of |p| +
   10 lr; timed beside its bound, the plain version and
   torch._fused_adamw_ over the same f32 leaf (a yardstick the port never
   calls); then the int8 path's divisions (a corrected multiply by a
   reciprocal taken once) against __fdiv_rn over all 2^32 numerators at
   each of ~920 divisors (3, 127, 255; c1 and c2 of steps 1-1000; block
   scales: all-ones mantissas, powers of two, the range's edges,
   absmax / 127 and / 3, 240 random): the update's bit for bit, the
   encode's unless both are below 2^-40, 0 mismatches or the phase
   fails. (b) one step's loss and per-leaf
   gradients (make_train_step's own gradient function, 8 x 128 from
   SyntheticLM), kernels against plain versions from the same params, at
   bf16 and f32 compute: every leaf must have a finite nonzero gradient,
   the loss within 1e-3 (f32) / 1e-2 (bf16), each backward launch within
   the backward's tolerance of the plain autograd on the step's own
   tensors, and every leaf's gradient with the layers in lockstep (each
   layer's backward from the kernel run's input and output cotangent):
   at most REF_K (f32 8x, bf16 2x) the plain versions' distance from a
   reference with the attention in f64, and at f32 a control (the
   attention's inputs and gradients rounded to bf16) must fail that
   gate. (c) the Trainer through launch.train's code path at JAX's
   tests/test_train.py:23 settings (lr 3e-3, warmup 5, 30 steps of 8 x
   64, no remat, f32 moments; the training path, counted): the Trainer's
   step captured once as a CUDA graph ("train.step", one capture a run,
   checked for every Trainer run of the phase) and replayed; every loss
   finite and the mean of the last 5 below the mean of the first 5, the
   AdamW kernel launched once a leaf a step; the drop, step wall p50, peak
   memory and straggler events printed, beside the same run through the
   plain versions (the step called directly) and a held-out batch's loss
   at the init and after each run. The same run with the step called
   directly (the same kernels): its 30 losses and final params bit for bit
   the replayed run's; both step walls printed, then the step eager and
   replayed on a fresh state (`train_step_timings`: walls and profiler
   device time). (e) COMQ (comq_blocked) and RTN at
   3 bits per channel on a model that learned: JAX's tests/test_system.py
   on the card (h2o-danube-1.8b's smoke config, 60 steps of 8 x 64
   through launch.train's code path; its loss must drop by more than
   0.8): COMQ's KL divergence from the float model's next-token
   distributions at most RTN's, and its loss within 1.0 of the float
   model's; the eval losses printed, and the same readings for (c)'s
   model (printed only: it learns too little for either). (f) the same
   run with int8 moments (replayed; the AdamW kernel once a leaf a step):
   the CUDA adamw_update equals the CPU one from
   the same state and gradient (codes, scales, EF planes bit for bit;
   params within f32 rounding); the loss gap to (c), JAX's
   10%-of-the-change figure and the optimizer bytes a parameter
   printed. (d) (f)'s run killed at step 7
   with a checkpoint every 5, resumed by run_with_restarts to step 10
   (under (f)'s 30-step schedule; each attempt's Trainer captures its
   step once and the resume loads into the captured state's tensors):
   every loss of both attempts equals (f)'s. Only (d)'s step-5
   checkpoint is written:
   nothing reads the others. (g) the other families, each from
   init_params(seed=0) at full width: granite-moe-3b-a800m, hymba-1.5b
   (1 x 2048, so its window of 1024 binds), musicgen-large and rwkv6-7b
   at 2 layers each, vit-base-16 whole (its lm_loss from patch
   embeddings and labels): 3 make_train_step steps (the training path,
   counted; every loss finite, the forward and backward kernels launched
   once a layer a step, the AdamW kernel once a leaf a step), each step's
   wall, the peak memory and the
   backward kernel's device time in the last step printed; then (b)'s
   bf16 gates on the first batch — every leaf a finite nonzero gradient,
   the loss within 1e-2, each backward launch, every leaf in lockstep
   within REF_K (an MoE layer's pairs routed as the kernel replay routed
   them, its aux loss's cotangent carried; a recurrent state passed to a
   layer carried into its replays); rwkv6's kernels and plain versions
   bit-identical (no kernel in its VJP); granite's plain versions run
   twice, their spread printed beside the kernels-vs-plain gap.

20. analysis — runs right after phase 17, on the phase-4 model. (a)
   `python -m repro_torch.analysis.cli --gate` on the card, in a process
   of its own: the lint of src/repro_torch; every registry entry's
   contract (the collective census, the in-place audit of the pool and
   the train state with the card's peak allocation) and its kernels
   launched (the decode steps the paged kernels and quant_matmul, prefill
   flash_attention, the solver comq_panel, train.step the flash
   backward), the dist.* entries and the sharded decode step in a gloo
   world of 2 ranks sharing the card; the runtime's signature budgets
   over a mixed, staggered run. (b) one decode step of the 2-layer qwen,
   8 slots at 4000 tokens on 16-token pages, bf16 and int8 pages:
   count_cost's bytes beside decode_step_bytes(mode="pallas"), the
   bf16-over-int8 ratio of the two within ANALYSIS_RATIO_BAND. (c) that
   step's roofline_terms beside its CUDA-event time and the card.
   Every kernel bound of phases 3-19 is `roofline.kernels.bound_ms` of
   the kernel's cost function.

21. tensor-parallel padding — runs last, after phase 19. (a) the kernels
   at the padded head maps, against their plain versions with phase 3's
   and 19(a)'s gates and timings: flash forward (bf16 timed, f32
   checked) and backward at hymba-1.5b's map at tp = 16 (25 heads padded
   to 32 over 5 KV heads: KV head 0 serves 12, the others 5), B=8 T=128
   and B=1 T=2048 with the window of 1024; both paged kernels at
   qwen2-7b's map at tp = 3 (28 -> 30 over 4: groups 9/7/7/7) with phase
   3's page layout; SDPA over K/V expanded by the map beforehand (not
   timed) the library yardstick. (b) hymba at BuildPlan(tp=16), n_layers
   32 -> 4, from init_params(seed=0): a prefill of 8x128 and 16 decode
   steps and one training step of 1x2048 (the padded path, counted),
   then decode against the plain versions (bf16 and f32, the layers in
   lockstep under the precision gates) and the step's gradient as
   19(g)'s. (c) qwen2-7b at BuildPlan(tp=3), n_layers 28 -> 2, 4-bit RTN
   codes: the phase-8 traffic through the paged Runtime at kv_bits 0, 8
   and 4 (counted; all 16 requests run to their length), then phase 7's
   paged decode against the plain versions in lockstep. (d) phase
   19(d)'s step-5 state restored with `restore(shardings=)` through
   `Trainer(shard_state_fn=)` on an nccl world of one: the resumed
   losses equal the unsharded resume's bit for bit. (e) the dry run of
   qwen2-7b at its four shapes on both production meshes, on the meta
   device in processes that see no card (started with the phase):
   per_device_total_gb and the roofline report's rows (collectives n/a).

22. the serving steps as CUDA graphs — the Runtime's and the Engine's
   decode steps are captured once per signature and replayed every step
   (analysis.retrace.guard_graph), so every serve run of phases 8-21
   replays, and each replay adds the launches its capture recorded to the
   counts. (a) on phase 4's 2-layer qwen, right after phase 20, at bf16
   kv_bits 0, 8 and 4 and f32 kv_bits 0: a step replayed against a direct
   decode_step_paged call on the same inputs from the same pool (the
   logits' max|d|/max|logit| printed, the first op that differs named
   where they do; the pools gated equal), then (c) the phase-8 traffic
   through a Runtime whose step is called directly and through one that
   replays (both runs' tok/s, TTFT p50, ITL p50/p99 printed; tokens gated
   equal request for request) and (d) one capture of serve.decode_step
   and the graph pool's bytes. (b) in phase 20: its full-width step
   eager and replayed (CUDA events) against the bound. (e) in phases 11,
   13 and 14: the static Engine eager and replayed for hymba, rwkv6 and
   the VLM (tok/s; tokens gated equal; one capture of
   serve.engine.decode_step for every position); 11(d)'s lockstep gate
   runs on replays through DecodeTape's card-side tape. (f) in phases 10
   and 12: granite's and musicgen's traffic eager and replayed (tokens
   gated equal, one capture). Every number is printed beside the card's
   name and power limit.

Launch counts: the quantize-and-decode path (phases 4-5), the serve path
(phase 8), the policy path (phase 9a), the durability runs (phase 16:
its quantize walks, then its serve runs), the observability runs (phase
17 a, b and d), the MoE path (phase 10), the
hybrid path (phase 11 b-d), the audio path (phase 12), the rwkv path
(phase 13), the vlm path (phase 14), the encoder path (phase 15) and
every rank's runs of phase 18 (its sharded walks and runtime) and the
training path (phase 19 b-c), each family's steps (19g) and the padded
paths (21 b, c) are each counted from 0; the forward kernels and the backward kernel must launch
on the training path, once a layer a step on each family's; every
forward kernel must launch on the main path as a
whole, each of the five on the MoE and audio paths, the three of the
static engine on the hybrid path, comq_panel on the rwkv path, comq_panel
and flash on the vlm path (its single-query launches, the cross layers'
decode, also counted apart), flash on the encoder path.
Then one JSON line of the kernels (the expert-batched panel launch and
hymba's, musicgen's, rwkv's, the VLM's and the encoder's new shapes as
entries of their own, with their path's launches; the backward at
granite's, hymba's, musicgen's and vit's shapes with their steps'
launches; the head-map variants of phase 21 with the padded paths'
launches; the fused AdamW update at qwen's w_down with f32 and with
int8 moments, with the training path's launches), and last the device
line.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WINDOWS = 5                        # CUDA-event windows per kernel time

# tolerances (each kernel's source states the same)
PANEL_MIN_CODE_AGREEMENT = 0.999
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 8e-3, 1e-3
FLASH_F32_TOL = 1e-4                # |d| <= TOL * |want| + TOL
QMM_REL = 1e-3                      # max|Δ| <= QMM_REL * max|Y|
# decode logits, kernels vs plain versions, teacher-forced: max|Δ| <=
# REL * max|logits|. This random-init model amplifies rounding-level
# changes of projection outputs into much larger logit changes (PERF.md),
# so at bf16 every flipped rounding shows: the f32 run carries the
# precision gate and the bf16 main-path run a coarse one.
LOGITS_REL = {"bfloat16": 1e-1, "float32": 1e-2}
WDOWN_REL = 1e-3
LOSS_GAP = 0.15
PROMPT, STEPS = 128, 16
# paged attention vs its plain version (the kernel source states the same)
PAGED_BF16_RTOL, PAGED_BF16_ATOL, PAGED_F32_ATOL = 8e-3, 1e-3, 1e-4
# serve phase
SERVE_SLOTS, SERVE_BS, SERVE_NEW, SERVE_REQS = 8, 16, 32, 16
SERVE_BUCKETS = (128, 256, 512)
SMALL_POOL = 64            # pages: too few for the 16 lifetimes, so it preempts
SLICE1 = ("comq_panel", "flash_attention", "quant_matmul")
SERVE_NEW_KERNELS = ("paged_attention", "paged_attention_quant")
SERVE_PATH = ("flash_attention", "quant_matmul") + SERVE_NEW_KERNELS
# the five forward kernels: every path but training's launches only these
INFER_KERNELS = SLICE1 + SERVE_NEW_KERNELS
# phase 9: a per-leaf policy with all four widths (2-bit wk is cpb 4,
# 3-bit w_gate cpb 2, 8-bit w_down cpb 1) and int8 KV, and a budget
POLICY = "0.mlp.w_down=8,1.attn.wk=2,1.mlp.w_gate=3,kv=8"
BUDGET = 3.5
POLICY_PATH = SLICE1 + ("paged_attention_quant",)
# phase 10: the MoE family at full width, depth cut to MOE_LAYERS
MOE_ARCH, MOE_LAYERS = "granite-moe-3b-a800m", 4
MOE_HEADS = (24, 8, 64)                # query heads, KV heads, head_dim
MOE_PANEL_N = (512, 1024, 1536)        # w_gate / w_up alone, fused, w_down
MOE_PATH = SLICE1 + SERVE_NEW_KERNELS
# phase 11: the hybrid family at full width, depth cut to HYBRID_LAYERS; a
# quantize at full depth (HYBRID_FULL_LAYERS) closes it
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_FULL_LAYERS = "hymba-1.5b", 4, 32
HYBRID_HEADS = (25, 5, 64)             # query heads, KV heads, head_dim
HYBRID_WINDOW = 1024
HYBRID_LONG = 1016     # a B=1 prompt whose 16 decode steps cross 1024
HYBRID_PANEL = ((6400, 4), (5504, 4))  # w_in's columns; w_gate / w_up's
HYBRID_PATH = SLICE1   # the static engine: no paged kernel, as in JAX
# phase 12: the audio decoder at full width, depth cut to AUDIO_LAYERS; a
# quantize at full depth (AUDIO_FULL_LAYERS) closes it
AUDIO_ARCH, AUDIO_LAYERS, AUDIO_FULL_LAYERS = "musicgen-large", 4, 48
AUDIO_HEADS = (32, 32, 64)             # MHA: query group 1
AUDIO_PANEL = ((2048, 4), (6144, 4), (8192, 4))   # wo / w_down; qkv; w_up
AUDIO_PATH = SLICE1 + SERVE_NEW_KERNELS
# phase 13: the attention-free family at full width, depth cut
RWKV_ARCH, RWKV_LAYERS = "rwkv6-7b", 4
RWKV_PANEL = ((4096, 4), (14336, 4))   # time-mix leaves; channel-mix w_k
RWKV_LONG = 1000       # a B=1 prompt of 1000 tokens: chunks of 1 in prefill
RWKV_PATH = ("comq_panel",)   # decode dequantizes every leaf, as in JAX
# phase 14: the VLM at full width, depth cut to one group (4 self layers +
# 1 gated cross layer): n_layers must divide into groups of 5, and 10
# layers' f32 weights, their materialized copy and the codes pass 80 GB
VLM_ARCH, VLM_LAYERS = "llama-3.2-vision-90b", 5
VLM_HEADS = (64, 8, 128)               # query heads, KV heads, head_dim
# wk / wv; wq, wo, w_down, xattn.wq / wo; w_gate, w_up (greedy order: the
# blocked solver fuses no columns, so each leaf is its own panel)
VLM_PANEL = ((1024, 4), (8192, 4), (28672, 4))
VLM_GATE = 0.5          # the cross gates for the decode and Engine gates
VLM_PATH = ("comq_panel", "flash_attention")   # JAX serves it unpacked
# phase 15: the encoder at full width and depth
ENC_ARCH, ENC_T = "vit-base-16", 197   # 196 patches + cls
ENC_PATH = ("flash_attention",)   # QT leaves dequantized, as in JAX


class CheckFailed(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn(i) over `iters` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Timing:
    """Per-call device time over WINDOWS CUDA-event windows of `iters`
    calls each: `ms` the median, `lo`/`hi` the min and max. The calls are
    replayed from one CUDA graph, so the card runs them back to back and
    the host's Python dispatch (~10-30 us a wrapper call, more than these
    kernels take) does not pace it; `eager_ms` is the median of the same
    windows launched from Python. `how` says which `ms` is ("graph", or
    "eager" with the reason if the calls could not be captured)."""

    def __init__(self, torch, fn, iters: int):
        fn(0)
        torch.cuda.synchronize()
        self.eager = self._windows(
            torch, lambda: [fn(i) for i in range(iters)], iters)
        self.eager_ms = statistics.median(self.eager)
        try:
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(0)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                for i in range(iters):
                    fn(i)
            graph.replay()
            torch.cuda.synchronize()
            times, self.how = self._windows(torch, graph.replay, iters), "graph"
            del graph
        except RuntimeError as e:   # capture refused: print why, keep eager
            times, self.how = self.eager, f"eager ({type(e).__name__}: {e})"
        self.ms = statistics.median(times)
        self.lo, self.hi = min(times), max(times)

    @staticmethod
    def _windows(torch, run, iters):
        out = []
        for _ in range(WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / iters)
        return out

    def __str__(self):
        return (f"{self.ms:.4f} [{self.lo:.4f}-{self.hi:.4f}, {self.how}; "
                f"eager {self.eager_ms:.4f}]")


def autograd_graph_ms(torch, forward, inputs, grad_out, iters: int):
    """(ms, how): the per-call device time of torch.autograd.grad(out,
    inputs, grad_out) over `out = forward()`, replayed from one CUDA graph
    as `Timing` does (median of WINDOWS CUDA-event windows). The forward
    runs once on the capture stream, as autograd issues a backward's
    kernels on its forward's stream. `how` is "graph", or "eager" with
    the reason where the capture was refused."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()

        def backward():
            return torch.autograd.grad(out, inputs, grad_out,
                                       retain_graph=True)

        backward()
    side.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                backward()
        graph.replay()
        torch.cuda.synchronize()
        ms, how = statistics.median(Timing._windows(torch, graph.replay,
                                                    iters)), "graph"
        del graph
    except RuntimeError as e:   # capture refused: print why, time eagerly
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda i: backward(), iters)
        how = f"eager ({type(e).__name__}: {e})"
    return ms, how


@contextlib.contextmanager
def plain_kernels(ops, modules):
    """Route the dispatch to the plain versions for a reference run on the
    card (only this script does this; the package never does)."""
    from repro_torch.kernels import adamw
    saved = {name: getattr(ops, name) for name in
             ("comq_panel_dq", "flash_attention", "quant_matmul",
              "paged_attention", "paged_attention_quant",
              "adamw_update_leaf")}
    panel, flash, qmm, paged = modules
    ops.adamw_update_leaf = adamw.adamw_leaf_plain
    ops.comq_panel_dq = panel.comq_panel_dq_plain
    ops.flash_attention = flash.flash_attention_plain
    ops.quant_matmul = qmm.quant_matmul_plain
    ops.paged_attention = paged.paged_attention_plain
    ops.paged_attention_quant = paged.paged_attention_quant_plain
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

QWEN_PANEL_CASES = ((512, 4), (3584, 4), (18944, 4), (3584, 2), (3584, 8))


def check_panel(torch, panel, dev, results, cases=QWEN_PANEL_CASES):
    """`cases` ((n, bits)): by default 4-bit codes at qwen's n (512 / 3584
    / 18944 columns), then the 2- and 8-bit code ranges a policy solves
    at, n=3584: qf and δ scale with the range, so at 8 bits δ is 17x finer
    than at 4 and far more steps land near a rounding boundary (the
    kernel's exact redo)."""
    from repro_torch.roofline import kernels as kc
    gen = torch.Generator(device=dev).manual_seed(1)
    B = 256
    for n, bits in cases:
        spread = (2 ** bits - 1) / 15
        x = torch.randn(4 * B, B, generator=gen, device=dev)
        h_bb = (x.T @ x) / (4 * B) + 0.1 * torch.eye(B, device=dev)
        s0 = torch.randn(B, n, generator=gen, device=dev)
        qf = torch.randn(B, n, generator=gen, device=dev) * 3 * spread
        delta = (torch.rand(n, generator=gen, device=dev) * 0.15
                 + 0.05) / spread
        z_lo = torch.full((n,), -2.0 ** (bits - 1), device=dev)
        z_hi = torch.full((n,), 2.0 ** (bits - 1) - 1, device=dev)
        hdiag = torch.diagonal(h_bb).contiguous()
        args = (h_bb, s0, qf, delta, z_lo, z_hi, hdiag)
        qk, dk = panel.comq_panel_dq_cuda(*args)
        qp, dp = panel.comq_panel_dq_plain(*args)
        torch.cuda.synchronize()
        agree = float((qk == qp).float().mean())
        err = float((qk - qp).abs().max())
        clipped = float(((qk == z_lo) | (qk == z_hi)).float().mean())
        t = Timing(torch, lambda i: panel.comq_panel_dq_cuda(*args), 20)
        plain_ms = cuda_ms(torch, lambda i: panel.comq_panel_dq_plain(*args),
                           3)
        bms, by = kc.bound_ms(kc.comq_panel(B, n))
        say(f"kernel comq_panel B={B} n={n} bits={bits} codes "
            f"[{int(z_lo[0])}, {int(z_hi[0])}]: code agreement {agree:.6f} "
            f"(need >= {PANEL_MIN_CODE_AGREEMENT}), max|dq code| {err}, "
            f"codes at a clip {clipped:.3f}, ms {t}, plain_ms "
            f"{plain_ms:.3f}, bound_ms {bms:.4f} ({by}), library_ms null")
        check(agree >= PANEL_MIN_CODE_AGREEMENT,
              f"comq_panel n={n} bits={bits}: code agreement {agree}")
        key = ("comq_panel", n) if bits == 4 else ("comq_panel", n, bits)
        results[key] = dict(ms=t.ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by, library_ms=None, max_abs_err=err)


def expand_heads(torch, k, head_map):
    """K or V (B, T, KV, hd) expanded to one row a query head by the
    head map (a host tuple): the library yardstick's input, made outside
    its timed window."""
    idx = torch.tensor(head_map, device=k.device)
    return k[:, :, idx].contiguous()


def check_flash(torch, flash, dev, results, heads=(28, 4, 128), tag=(),
                shapes=((8, PROMPT), (1, SERVE_BUCKETS[-1])), window=0,
                causal=True, head_map=None):
    """bf16 (the main path, tensor cores) at `shapes` ((B, T), or (B, Tq,
    Tk) for Tq != Tk: by default the quantize/decode shape B=8, T=128 and
    the serve-prefill shape B=1, T=512), each timed; then the f32
    (CUDA-core) kernel at the first shape, checked and timed beside SDPA
    at f32. `heads` is (H,
    KV, hd); `window` the sliding window (0: full causal); `causal=False`
    attends every query to every key (the encoder, the VLM's cross
    layers); `head_map` a tensor-parallel plan's uneven map (a host
    tuple; SDPA then runs over K/V expanded by it beforehand, the
    expansion not timed); `tag` extends the result keys."""
    import torch.nn.functional as F

    from repro_torch.roofline import kernels as kc
    gen = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd = heads
    kind = f"causal window {window}" if causal else "non-causal"
    if head_map is not None:
        kind += f", head map {head_map}"
    hm = dict(head_map=head_map)
    for shape in shapes:
        B, Tq, Tk = shape if len(shape) == 3 else (*shape, shape[1])
        q = torch.randn(B, Tq, H, hd, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Tk, KV, hd, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Tk, KV, hd, generator=gen, device=dev).bfloat16()
        got = flash.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window, **hm).float()
        want = flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, **hm).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        ok = bool((diff <= FLASH_BF16_RTOL * want.abs()
                   + FLASH_BF16_ATOL).all())
        t = Timing(torch, lambda i: flash.flash_attention_cuda(
            q, k, v, causal=causal, window=window, **hm), 50)
        plain_ms = cuda_ms(torch, lambda i: flash.flash_attention_plain(
            q, k, v, causal=causal, window=window, **hm), 10)
        lib = None
        lib_note = (f"scaled_dot_product_attention, GQA, "
                    f"{'causal' if causal else 'non-causal'}")
        kl, vl = k, v
        if head_map is not None:
            kl, vl = (expand_heads(torch, x, head_map) for x in (k, v))
            lib_note = (f"scaled_dot_product_attention over K/V expanded "
                        f"by the map beforehand (not timed), "
                        f"{'causal' if causal else 'non-causal'}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kl, vl))
        # the window as a boolean mask (SDPA has no window argument)
        mask = (flash.attention_mask(Tq, Tk, True, window, dev) if window
                else None)
        if window:
            lib_note += f", window {window} as a boolean mask"
        try:
            lib = Timing(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None,
                enable_gqa=head_map is None), 50)
        except TypeError:   # torch without enable_gqa: no one-call yardstick
            lib_note = "torch has no enable_gqa"
        bms, by = kc.bound_ms(kc.flash_attention_of(q, k, causal=causal,
                                                    window=window))
        say(f"kernel flash_attention B={B} Tq={Tq} Tk={Tk} H={H} KV={KV} "
            f"hd={hd} bf16 {kind}: max|d| {err:.3e} (tol "
            f"{FLASH_BF16_RTOL}*|want|+"
            f"{FLASH_BF16_ATOL}), ms {t}, plain_ms {plain_ms:.4f}, "
            f"bound_ms {bms:.4f} ({by}), library_ms {lib} ({lib_note})")
        check(ok, f"flash_attention B={B} Tq={Tq} Tk={Tk} {kind} disagrees "
              f"with its plain version ({err})")
        results[("flash_attention",) + tuple(shape) + tag] = dict(
            ms=t.ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib.ms if lib else None, max_abs_err=err)
    # the f32 instantiation (CUDA cores), the precision path of phase 5
    B, Tq, Tk = shapes[0] if len(shapes[0]) == 3 else (*shapes[0],
                                                       shapes[0][1])
    q = torch.randn(B, Tq, H, hd, generator=gen, device=dev)
    k, v = (torch.randn(B, Tk, KV, hd, generator=gen, device=dev)
            for _ in range(2))
    got = flash.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     **hm)
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       **hm)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    t = Timing(torch, lambda i: flash.flash_attention_cuda(
        q, k, v, causal=causal, window=window, **hm), 20)
    plain_ms = cuda_ms(torch, lambda i: flash.flash_attention_plain(
        q, k, v, causal=causal, window=window, **hm), 5)
    kl, vl = ((expand_heads(torch, x, head_map) for x in (k, v))
              if head_map is not None else (k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kl, vl))
    mask = flash.attention_mask(Tq, Tk, True, window, dev) if window else None
    try:
        lib = Timing(torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=head_map is None), 20).ms
    except TypeError:   # torch without enable_gqa
        lib = None
    bms, by = kc.bound_ms(kc.flash_attention_of(q, k, causal=causal,
                                                window=window))
    say(f"kernel flash_attention B={B} Tq={Tq} Tk={Tk} H={H} KV={KV} "
        f"hd={hd} f32 {kind}: max|d| {err:.3e} (tol {FLASH_F32_TOL}"
        f"*|want|+{FLASH_F32_TOL}), ms {t}, plain_ms {plain_ms:.4f}, "
        f"bound_ms {bms:.4f} ({by}), library_ms "
        f"{'null' if lib is None else f'{lib:.4f}'} (SDPA at f32, as the "
        f"bf16 row's)")
    check(bool((diff <= FLASH_F32_TOL * want.abs() + FLASH_F32_TOL).all()),
          f"flash_attention f32 disagrees with its plain version ({err})")
    results[("flash_attention_f32", B, Tq, Tk) + tag] = dict(
        ms=t.ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib, max_abs_err=err)


def qwen_qmm_cases(torch):
    """(M, K, N, bits, X dtype) of phase 3: f32 X (three bf16 planes in
    the kernel) at the decode shapes (M=1 and 8), at M=1024 and at
    8-/2-bit; bf16 X (what the bf16 decode and serve paths hand over) at
    the decode shapes and M=1024; the policy's widths at model shapes."""
    shapes = ((3584, 18944), (18944, 3584), (3584, 512))
    cases = [(M, K, N, 4, torch.float32) for M in (8, 1024)
             for K, N in shapes]
    cases += [(8, 3584, 3584, 8, torch.float32),
              (8, 3584, 18944, 2, torch.float32),
              (1, 3584, 18944, 4, torch.float32)]
    cases += [(M, K, N, 4, torch.bfloat16) for M, (K, N) in
              [(8, s) for s in shapes] + [(1, shapes[0]), (1024, shapes[0])]]
    # 8-bit w_down (cpb 1) and 2-bit wk (cpb 4, 128 code bytes a row)
    cases += [(8, 18944, 3584, 8, torch.bfloat16),
              (8, 3584, 512, 2, torch.bfloat16)]
    return cases


def check_qmm(torch, qmm, dev, results, cases):
    """quant_matmul against its plain version at `cases` ((M, K, N, bits,
    X dtype)). The bound is the least time once codes are exact in bf16:
    max(bytes / HBM rate, 2*M*K*N / bf16 peak)."""
    from repro_torch.core.quantizer import pack_codes, unpack_codes
    from repro_torch.roofline import kernels as kc
    gen = torch.Generator(device=dev).manual_seed(3)
    for M, K, N, bits, xdt in cases:
        u = torch.randint(0, 2 ** bits, (K, N), generator=gen, device=dev,
                          dtype=torch.uint8)
        codes, cpb = pack_codes(u, bits)
        x = torch.randn(M, K, generator=gen, device=dev).to(xdt)
        scale = torch.rand(N, generator=gen, device=dev) * 0.04 + 0.01
        z = torch.randint(-(2 ** (bits - 1)), 0, (N,), generator=gen,
                          device=dev).float()
        got = qmm.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
        want = qmm.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        # rotate code copies past the 50 MB L2 so each launch streams codes
        # from HBM, as a decode step does
        n_copy = min(64, max(2, math.ceil(128e6 / codes.numel())))
        copies = [codes.clone() for _ in range(n_copy)]
        t = Timing(torch, lambda i: qmm.quant_matmul_cuda(
            x, copies[i % n_copy], scale, z, cpb=cpb), 20)
        plain_ms = cuda_ms(torch, lambda i: qmm.quant_matmul_plain(
            x, copies[i % n_copy], scale, z, cpb=cpb), 5)
        w = (unpack_codes(codes, cpb).float() + z) * scale
        xf = x.float()
        lib = Timing(torch, lambda i: torch.matmul(xf, w), 10)
        del copies, w, xf
        cost = kc.quant_matmul_of(x, codes, cpb=cpb)
        bms, by = kc.bound_ms(cost)
        xname = str(xdt)[6:]
        say(f"kernel quant_matmul M={M} K={K} N={N} bits={bits} cpb={cpb} "
            f"x={xname}: max|d|/max|y| {rel:.3e} (tol {QMM_REL}), ms {t}, "
            f"plain_ms {plain_ms:.4f}, bound_ms {bms:.4f} ({by}), "
            f"library_ms {lib} (torch.matmul, f32 X on the dequantized f32 "
            f"weight)")
        if (M, K, N, bits, xdt) == (8, 3584, 18944, 4, torch.float32):
            say(f"  for continuity: the f32-FMA bound of PRs 11-13 at this "
                f"shape, {kc.bound_ms(cost, kind='f32')[0]:.4f} "
                f"ms")
        check(rel <= QMM_REL, f"quant_matmul {M}x{K}x{N} cpb={cpb} "
              f"x={xname}: {rel}")
        results[("quant_matmul", M, K, N, cpb, xname)] = dict(
            ms=t.ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib.ms, max_abs_err=err)


def check_paged(torch, paged, dev, results, heads=(28, 4, 128), tag=(),
                head_map=None):
    """Both paged-attention kernels against their plain versions at the
    serve shapes: bf16 (main path) and f32 q, window 0 and 1024, bf16 /
    f32 pages and int8 / 4-bit codes; times at window 0 for bf16 q and
    for f32 q over f32 pages. `heads` is
    (H, KV, hd); `head_map` a tensor-parallel plan's uneven map (a host
    tuple); `tag` extends the result keys."""
    import torch.nn.functional as F

    from repro_torch.roofline import kernels as kc
    from repro_torch.serve.kv_cache import kv_encode, kv_scale_of
    gen = torch.Generator(device=dev).manual_seed(4)
    (H, KV, hd), B, BS, MAXB = heads, 8, 16, 256
    NB = B * MAXB
    lens = torch.randint(1, MAXB * BS + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[3] = 0
    lens_l = [int(n) for n in lens.cpu()]
    bt = torch.randperm(NB, generator=gen, device=dev).reshape(B, MAXB).to(
        torch.int32)
    q32 = torch.randn(B, H, hd, generator=gen, device=dev)
    k32 = torch.randn(NB, BS, KV, hd, generator=gen, device=dev)
    v32 = torch.randn(NB, BS, KV, hd, generator=gen, device=dev)
    say(f"paged inputs: B={B} H={H} KV={KV} hd={hd} BS={BS} MAXB={MAXB} "
        f"NB={NB}, lengths {lens_l}")

    def quantized(pool, kv_bits):
        scale = kv_scale_of(pool.abs().amax(dim=(1, 3)), kv_bits)
        return kv_encode(pool, scale[:, None], kv_bits), scale.contiguous()

    variants = [("paged_attention", 0, k32.bfloat16(), v32.bfloat16(),
                 None, None)]
    for kv_bits in (8, 4):
        kq, ks = quantized(k32, kv_bits)
        vq, vs = quantized(v32, kv_bits)
        variants.append(("paged_attention_quant", kv_bits, kq, vq, ks, vs))
        say(f"paged_attention_quant kv_bits={kv_bits} dispatch: bf16 q -> "
            f"{paged.quant_kernel(torch.bfloat16, kv_bits, hd, BS)}, f32 q "
            f"-> {paged.quant_kernel(torch.float32, kv_bits, hd, BS)}")

    hm = dict(head_map=head_map)
    for name, kv_bits, kp, vp, ks, vs in variants:
        def kernel(q, kp, vp, window):
            if kv_bits:
                return paged.paged_attention_quant_cuda(
                    q, kp, vp, ks, vs, bt, lens, window=window,
                    kv_bits=kv_bits, **hm)
            return paged.paged_attention_cuda(q, kp, vp, bt, lens,
                                              window=window, **hm)

        def plain(q, kp, vp, window):
            if kv_bits:
                return paged.paged_attention_quant_plain(
                    q, kp, vp, ks, vs, bt, lens, window=window,
                    kv_bits=kv_bits, **hm)
            return paged.paged_attention_plain(q, kp, vp, bt, lens,
                                               window=window, **hm)

        for dtype in (torch.bfloat16, torch.float32):
            q = q32.to(dtype)
            kpp, vpp = kp, vp
            if not kv_bits and dtype == torch.float32:
                kpp, vpp = k32, v32      # the f32 check runs f32 pages
            tc = bool(kv_bits) and paged.quant_kernel(
                dtype, kv_bits, hd, BS) == paged.TENSOR_CORE
            check(tc == (bool(kv_bits) and dtype == torch.bfloat16),
                  f"{name} kv_bits={kv_bits} {dtype}: dispatched to "
                  f"{'tensor' if tc else 'CUDA'} cores")
            for window in (0, 1024):
                tc0 = paged.launches_quant_tc
                got = kernel(q, kpp, vpp, window)
                check(paged.launches_quant_tc - tc0 == tc,
                      f"{name} kv_bits={kv_bits} {dtype}: the wrapper did "
                      f"not launch the kernel its dispatch rule names")
                want = plain(q, kpp, vpp, window)
                torch.cuda.synchronize()
                zero_ok = bool((got[3] == 0).all())
                d = (got.float() - want.float()).abs()
                err = float(d.max())
                if dtype == torch.bfloat16:
                    ok = bool((d <= PAGED_BF16_RTOL * want.float().abs()
                               + PAGED_BF16_ATOL).all())
                    tol = f"{PAGED_BF16_RTOL}*|want|+{PAGED_BF16_ATOL}"
                else:
                    ok = err <= PAGED_F32_ATOL
                    tol = f"{PAGED_F32_ATOL}"
                label = (f"kernel {name} kv_bits={kv_bits} "
                         f"{str(dtype)[6:]} window={window}"
                         + (" (tensor cores)" if tc else ""))
                say(f"{label}: max|d| {err:.3e} (tol {tol}), zero-length "
                    f"slot exact 0: {zero_ok}")
                check(ok and zero_ok, f"{label} disagrees with its plain "
                      f"version ({err}, zero slot {zero_ok})")
                # timed: bf16 q, and the f32 path over f32 pages; window 0
                if window != 0 or (dtype != torch.bfloat16 and kv_bits):
                    continue
                f32 = dtype != torch.bfloat16
                # rotate pool copies past the 50 MB L2, as a decode step
                # finds the pages
                pool_bytes = 2 * kpp.numel() * kpp.element_size()
                n_copy = max(2, math.ceil(160e6 / pool_bytes))
                copies = [(kpp.clone(), vpp.clone()) for _ in range(n_copy)]
                t = Timing(torch, lambda i: kernel(
                    q, *copies[i % n_copy], 0), 50)
                plain_ms = cuda_ms(torch, lambda i: plain(
                    q, *copies[i % n_copy], 0), 5)
                del copies
                pages, keys = kc.live_extent(lens_l, 0, BS)
                cost = kc.paged_attention(
                    B, H, KV, hd, BS, kpp.shape[3] * kpp.element_size(),
                    MAXB, pages, keys, q_bytes=q.element_size(),
                    kv_bits=kv_bits)
                bms, by = kc.bound_ms(cost)
                lib, lib_note = None, ("no one-call PyTorch equivalent "
                                       "over int codes")
                if not kv_bits:
                    lib_note = ("scaled_dot_product_attention(enable_gqa) "
                                "over K/V gathered beforehand into (B, KV, "
                                "S, hd) with a length mask; the gather is "
                                "not timed")
                    S = MAXB * BS
                    idx = (bt.long()[:, :, None] * BS + torch.arange(
                        BS, device=dev)).reshape(B, S)
                    pools = (kpp, vpp)
                    if head_map is not None:   # one K/V row a query head
                        pools = tuple(expand_heads(torch, p, head_map)
                                      for p in pools)
                        lib_note = lib_note.replace(
                            "(B, KV, S, hd)", "(B, H, S, hd) by the head "
                            "map")
                    gath = [tuple(p.reshape(NB * BS, -1, hd)[idx]
                                  .permute(0, 2, 1, 3).contiguous()
                                  for p in pools) for _ in range(2)]
                    mask = (torch.arange(S, device=dev)[None]
                            < lens[:, None])[:, None, None, :]
                    q4 = q[:, :, None, :]
                    try:
                        lib = Timing(
                            torch, lambda i: F.scaled_dot_product_attention(
                                q4, *gath[i % 2], attn_mask=mask,
                                enable_gqa=head_map is None), 20)
                    except TypeError:   # torch without enable_gqa
                        lib_note = "torch has no enable_gqa"
                    del gath
                say(f"{label}: ms {t}, plain_ms {plain_ms:.4f}, "
                    f"bound_ms {bms:.4f} ({by}; {pages} live pages, "
                    f"{cost.bytes / 1e6:.2f} MB), library_ms {lib} "
                    f"({lib_note})")
                results[(name, kv_bits) + (("float32",) if f32 else ())
                        + tag] = dict(
                    ms=t.ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib.ms if lib else None, max_abs_err=err)
    r = {k: results[("paged_attention_quant", k) + tag]["ms"]
         for k in (8, 4)}
    say(f"paged bf16 q, H={H} KV={KV} hd={hd}, same run: tensor-core kernel "
        f"for codes int8 {r[8]:.4f} ms, 4-bit {r[4]:.4f} ms; bf16 pages "
        f"{results[('paged_attention', 0) + tag]['ms']:.4f} ms")


def panel_stack(torch, dev, gen, E, B, n):
    """E random 4-bit panels: h_bb (E, B, B), s0 / qf (E, B, n), delta /
    z_lo / z_hi (E, n), hdiag (E, B)."""
    x = torch.randn(E, 4 * B, B, generator=gen, device=dev)
    h_bb = (torch.bmm(x.transpose(1, 2), x) / (4 * B)
            + 0.1 * torch.eye(B, device=dev))
    return (h_bb, torch.randn(E, B, n, generator=gen, device=dev),
            torch.randn(E, B, n, generator=gen, device=dev) * 3,
            torch.rand(E, n, generator=gen, device=dev) * 0.15 + 0.05,
            torch.full((E, n), -8.0, device=dev),
            torch.full((E, n), 7.0, device=dev),
            torch.diagonal(h_bb, dim1=1, dim2=2).contiguous())


def check_panel_batched(torch, panel, dev, results, E: int):
    """comq_panel over E experts in one launch (the MoE solve's launch) at
    B=256 and the expert leaves' n: against the plain version (each
    expert's sweep) and against E single-expert launches of the kernel,
    which must give the same result bit for bit; timed beside the E
    single launches."""
    from repro_torch.roofline import kernels as kc
    gen = torch.Generator(device=dev).manual_seed(11)
    B = 256
    for n in MOE_PANEL_N:
        args = panel_stack(torch, dev, gen, E, B, n)
        qk, dk = panel.comq_panel_dq_cuda(*args)
        qp, _ = panel.comq_panel_dq_plain(*args)
        singles = [panel.comq_panel_dq_cuda(*(a[e].contiguous()
                                              for a in args))
                   for e in range(E)]
        torch.cuda.synchronize()
        agree = float((qk == qp).float().mean())
        err = float((qk - qp).abs().max())
        same = all(torch.equal(qk[e], q1) and torch.equal(dk[e], d1)
                   for e, (q1, d1) in enumerate(singles))
        del singles
        t = Timing(torch, lambda i: panel.comq_panel_dq_cuda(*args), 20)
        parts = [tuple(a[e].contiguous() for a in args) for e in range(E)]
        loop = Timing(torch, lambda i: [panel.comq_panel_dq_cuda(*pa)
                                        for pa in parts], 5)
        plain_ms = cuda_ms(torch, lambda i: panel.comq_panel_dq_plain(
            *args), 1)
        cost = kc.comq_panel(B, n, E)
        bms, by = kc.bound_ms(cost)
        say(f"kernel comq_panel batched E={E} B={B} n={n} 4-bit: code "
            f"agreement with plain {agree:.6f} (need >= "
            f"{PANEL_MIN_CODE_AGREEMENT}), max|dq code| {err}; equal to {E} "
            f"single launches bit for bit: {same}; ms {t}; {E} single "
            f"launches ms {loop}; plain_ms {plain_ms:.3f}; bound_ms "
            f"{bms:.4f} ({by}, {cost.bytes / 1e6:.1f} MB); library_ms null")
        check(agree >= PANEL_MIN_CODE_AGREEMENT,
              f"batched comq_panel E={E} n={n}: code agreement {agree}")
        check(same, f"batched comq_panel E={E} n={n} differs from {E} "
              f"single launches")
        results[("comq_panel_batched", E, n)] = dict(
            ms=t.ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=None, max_abs_err=err)
        del args, parts


class DecodeTape:
    """What a decode run decided, in call order, to hold a second run of
    the same steps to it: each layer's input hidden state, a hybrid
    layer's input SSM state, and each MoE routing choice (expert ids).

    The random-init model amplifies any rounding difference from layer to
    layer: with the plain versions only, multiplying every attention
    output by (1 + 1e-3 noise) moves the 4-layer MoE model's logits by
    ~0.3 of max|logit| at bf16 and ~0.14 at f32, and by ~4e-3 / ~4e-4 in
    lockstep (`tools/moe_sensitivity.py`, PERF.md). So at bf16 (ulp 4e-3)
    a free-running comparison of kernels against plain versions measures
    the model, not the kernels. Modes: `record` (the kernel run); `free`
    (a run on its own, counting the routing choices that differ from the
    recorded ones); `lockstep` (every layer starts from the recorded
    hidden state and routes as recorded, with the weights from its own
    logits: each layer's kernels against the plain versions, as phase 7
    runs quantized pages in lockstep). In lockstep a hybrid layer also
    starts from the recorded SSM state, as it does from the hidden state:
    the recurrent state carries a rounding difference to every later
    token of the layer. A VLM's cross layers are held the same way
    (`cross_layer_full`, which a cross decode step also runs). In lockstep
    the logits see only the last layer's work, so each layer's output is
    also held against the recorded one (`check_layers`).

    A serve.Engine's decode step is a CUDA graph: its Python runs at the
    warm-up and the capture only, and each replay runs the ops these hooks
    captured. So a `layer_decode` call with a device position (the
    Engine's step) keeps its tape on the card: with `base`, the prompt
    length, step pos - base's input, SSM state and output go to row
    pos - base of a buffer per layer (made at the warm-up, before the
    capture), and in lockstep each layer reads its row and writes its
    output to a second buffer, which `check_layers` holds to the first
    after the run.

    An Engine's prefill is a CUDA graph too: a signature's first call (each
    run here builds its own Engine) runs the prefill eagerly as its
    warm-up, which the tape records or holds as any call, and then
    captures it, which the tape leaves alone (`_capturing`: a capture runs
    nothing, and its result is not that call's)."""

    def __init__(self, torch, tfm, moe_mod, base=None, steps=SERVE_NEW):
        self.torch, self.tfm, self.moe = torch, tfm, moe_mod
        self.xs, self.ys, self.ids, self.states = [], [], [], []
        self.flips = self.pairs = 0
        self.held, self.worst, self.worst_at = 0, 0.0, None
        self.base, self.steps = base, steps
        self.dev_rows = {}    # (what, layer) -> (steps, *shape) buffer
        self.dev_calls = 0

    def _row(self, what, j, t):
        """The card-side tape's buffer `what` of layer j, shaped for t."""
        key = (what, j)
        if key not in self.dev_rows:
            self.dev_rows[key] = self.torch.zeros(
                (self.steps, *t.shape), dtype=t.dtype, device=t.device)
        return self.dev_rows[key]

    def _capturing(self, x) -> bool:
        """Whether a CUDA-graph capture is recording the call that gave
        `x` (a layer of a captured prefill)."""
        return x.is_cuda and self.torch.cuda.is_current_stream_capturing()

    def _device_layer(self, mode, real, p, x, a, k):
        """One layer_decode call of a captured step (see the class
        docstring): every op here is captured and runs at each replay."""
        cfg, pos = a[0], a[3]
        if mode not in ("record", "lockstep"):
            return real(p, x, *a, **k)
        if cfg.family == "vlm" or self.base is None:
            raise RuntimeError("the card-side tape holds the decode layers "
                               "of a non-VLM Engine with a `base` only")
        j = self.dev_calls % cfg.n_layers
        self.dev_calls += 1
        idx = (pos - self.base).reshape(1)
        st = k.get("ssm_state")
        if mode == "record":
            self._row("x", j, x).index_copy_(0, idx, x[None])
            if st is not None:
                for f, t in zip(st._fields, st):
                    self._row(f"ssm.{f}", j, t).index_copy_(0, idx, t[None])
        elif mode == "lockstep":
            x = self._row("x", j, x).index_select(0, idx)[0]
            if st is not None:
                k["ssm_state"] = type(st)(*(
                    self._row(f"ssm.{f}", j, t).index_select(0, idx)[0]
                    for f, t in zip(st._fields, st)))
        out = real(p, x, *a, **k)
        self._row("y" if mode == "record" else "y_lock", j,
                  out[0]).index_copy_(0, idx, out[0][None])
        return out

    def _hold_device(self):
        """Hold the lockstep run's card-side outputs to the recorded ones,
        step by step over the rows the run wrote."""
        for (what, j), lock in sorted(self.dev_rows.items()):
            if what != "y_lock":
                continue
            want = self.dev_rows[("y", j)]
            for s in range(lock.shape[0]):
                w = want[s].float()
                if not bool((w != 0).any()):
                    continue         # a row no step wrote
                gap = (float((lock[s].float() - w).abs().max())
                       / max(float(w.abs().max()), 1e-30))
                self.held += 1
                if gap >= self.worst:
                    self.worst, self.worst_at = gap, (
                        f"captured step {s} layer {j} (layer_decode)")

    @contextlib.contextmanager
    def mode(self, mode: str):
        torch, tfm, moe = self.torch, self.tfm, self.moe
        real = {"layer_full": tfm.layer_full,
                "layer_decode": tfm.layer_decode,
                "cross_layer_full": tfm.cross_layer_full}
        real_route = moe.route_slots
        layer_i, route_i = iter(range(1 << 30)), iter(range(1 << 30))

        def stepped(name):
            def layer(p, x, *a, **k):
                if (name == "layer_decode" and len(a) > 3
                        and isinstance(a[3], torch.Tensor)):
                    return self._device_layer(mode, real[name], p, x, a, k)
                if self._capturing(x):
                    return real[name](p, x, *a, **k)
                i = None
                if mode == "record":
                    self.xs.append(x)
                    self.states.append(k.get("ssm_state"))
                elif mode == "lockstep":
                    i = next(layer_i)
                    x = self.xs[i]
                    if self.states[i] is not None:
                        k["ssm_state"] = self.states[i]
                out = real[name](p, x, *a, **k)
                y = out[0] if isinstance(out, tuple) else out
                if mode == "record":
                    self.ys.append(y)
                elif i is not None:
                    self.hold(i, name, y)
                return out
            return layer

        def routed(x, router, n_real, top_k, capacity, offset=None):
            if self._capturing(x):
                return real_route(x, router, n_real, top_k, capacity, offset)
            if mode == "record":
                out = real_route(x, router, n_real, top_k, capacity, offset)
                self.ids.append(out[2])
                return out
            rec = self.ids[next(route_i)]
            if mode == "free":
                out = real_route(x, router, n_real, top_k, capacity, offset)
                self.flips += int((torch.sort(out[2], -1)[0]
                                   != torch.sort(rec, -1)[0]).sum())
                self.pairs += rec.numel()
                return out
            logits = x.float() @ router.float()
            weights = torch.softmax(logits.gather(1, rec), dim=-1)
            return (logits, weights, rec,
                    *moe.slots_for(rec, router.shape[-1], capacity, offset))

        if mode == "lockstep":
            self.held, self.worst, self.worst_at = 0, 0.0, None
            for key in [k for k in self.dev_rows if k[0] == "y_lock"]:
                del self.dev_rows[key]
        self.dev_calls = 0
        for name in real:
            setattr(tfm, name, stepped(name))
        moe.route_slots = routed
        try:
            yield
        finally:
            for name, fn in real.items():
                setattr(tfm, name, fn)
            moe.route_slots = real_route

    def hold(self, i: int, name: str, y):
        """One lockstep layer call's output against the recorded one."""
        want = self.ys[i].float()
        gap = (float((y.float() - want).abs().max())
               / max(float(want.abs().max()), 1e-30))
        self.held += 1
        if gap >= self.worst:
            self.worst, self.worst_at = gap, f"call {i} ({name})"

    def check_layers(self, label: str, what: str):
        """Gate the last lockstep run's layer outputs: the worst max|d| /
        max|recorded output| under the precision gate of `label`."""
        self._hold_device()
        say(f"{what} {label}, layers in lockstep: {self.held} layer outputs "
            f"held, worst max|d|/max|out| {self.worst:.3e} at "
            f"{self.worst_at} (tol {LOGITS_REL[label]})")
        check(self.held > 0 and self.worst <= LOGITS_REL[label],
              f"{what} {label}: a layer output in lockstep differs from the "
              f"kernel run's by {self.worst} ({self.worst_at})")


@contextlib.contextmanager
def layer_clock(torch, pipeline, out: list):
    """Time each layer of a staged quantize_model walk (synchronized before
    and after it) into `out`."""
    real = pipeline._quantize_layer_staged

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.time()
        res = real(*a, **k)
        torch.cuda.synchronize()
        out.append(time.time() - t0)
        return res

    pipeline._quantize_layer_staged = timed
    try:
        yield
    finally:
        pipeline._quantize_layer_staged = real


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

def _cache_copy(cache):
    snap = {"kv": [type(c)(*(None if t is None else t.clone() for t in c))
                   for c in cache["kv"]]}
    if "ssm" in cache:
        snap["ssm"] = list(cache["ssm"])
    return snap


def run_decode(torch, sp, cfg, plan, tokens, feed=None, snapshots=None,
               lockstep=None, vision_embeds=None, after=None):
    """prefill of the (B, T) prompts (a VLM's with `vision_embeds`) +
    STEPS greedy decode steps; with `feed`, teacher-forced on those
    tokens. `snapshots` (a list) collects a copy of the cache before each
    step (a hybrid model's SSM states are new tensors every step, so they
    are kept as they are), `after` one after each step; with `lockstep`
    (such a list) step i runs from lockstep[i]. Returns (per-step logits,
    tokens fed)."""
    from repro_torch.models import decode_step, prefill
    logits, cache = prefill(sp, cfg, plan, tokens,
                            vision_embeds=vision_embeds)
    outs, fed = [logits.float()], []
    for i in range(STEPS):
        tok = feed[i] if feed is not None else outs[-1].argmax(-1)
        fed.append(tok)
        if snapshots is not None:
            snapshots.append(_cache_copy(cache))
        if lockstep is not None:
            cache = lockstep[i]
        logits, cache = decode_step(sp, cfg, plan, cache, tok[:, None],
                                    tokens.shape[1] + i)
        if after is not None:
            after.append(_cache_copy(cache))
        outs.append(logits.float())
    torch.cuda.synchronize()
    return outs, fed


@contextlib.contextmanager
def kernel_cache_rows():
    """For a lockstep plain rerun started from the kernel run's caches
    *after* each step: the step's cache write is skipped, so every row the
    plain step attends over, the step's new row included, is the kernel
    run's own (int8 codes and scales)."""
    from repro_torch.models import transformer as tfm
    real = tfm.cache_insert
    tfm.cache_insert = lambda cache, k_new, v_new, pos: cache
    try:
        yield
    finally:
        tfm.cache_insert = real


def compare_decode(torch, ops, modules, rerun, outs, label, what="decode",
                   gate=True, vocab=None):
    """Re-run the teacher-forced steps with the plain versions on the card
    (`rerun()` returns their per-step logits) and hold each step's logits
    against `outs` (with gate=False the gap is printed, not gated). With
    `vocab`, over the first `vocab` columns only: a padded vocab's
    columns are -1e30 (`unembed` at tp > 1), which would make the
    divisor 1e30."""
    with torch.no_grad(), plain_kernels(ops, modules):
        ref_outs = rerun()
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs, ref_outs)):
        a, b = a[..., :vocab], b[..., :vocab]
        d = (a - b).abs()
        rel = float(d.max()) / float(b.abs().max())
        worst = max(worst, rel)
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        tol = LOGITS_REL[label] if gate else "none: reported"
        say(f"{what} {label} step {i}: max|d logits| {float(d.max()):.4e} "
            f"mean {float(d.mean()):.3e} (rel {rel:.3e}, tol {tol}), greedy "
            f"token agreement {agree:.3f}")
    if gate:
        check(worst <= LOGITS_REL[label],
              f"{what} logits ({label}) vs plain: rel {worst}")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          f"non-finite {what} logits ({label})")


# ---------------------------------------------------------------------------
# phases 7-8: paged decode and the serving runtime
# ---------------------------------------------------------------------------

def run_paged_decode(torch, sp, cfg, plan, tokens, lens, feed=None,
                     snapshots=None, lockstep=None):
    """Prefill the B prompts tokens[b, :lens[b]] (one right-padded batch),
    scatter each slot's rows into its pages with write_prefill, then STEPS
    decode_step_paged steps with per-slot positions; with `feed`,
    teacher-forced on those tokens. `snapshots` (a list) collects a copy
    of the pool before each step; with `lockstep` (such a list) step i
    runs from lockstep[i] instead of this run's own pool. Returns
    (per-step logits, fed, final pool)."""
    from repro_torch.models import decode_step_paged, forward
    from repro_torch.serve.kv_cache import (blocks_for, init_paged_cache,
                                            write_prefill)
    dev = tokens.device
    B, T = tokens.shape[0], max(lens)
    maxb = blocks_for(T + STEPS, SERVE_BS)
    pool = init_paged_cache(cfg, plan, B * maxb, SERVE_BS, device=dev)
    bt = torch.arange(B * maxb, dtype=torch.int32, device=dev).reshape(
        B, maxb)
    logits, _, cache = forward(sp, cfg, plan.replace(prefill_cache_len=T),
                               tokens[:, :T], make_cache=True)
    for b in range(B):
        kpos = cache["kv"][0].pos[b]
        write_prefill(pool, torch.stack([c.k[b] for c in cache["kv"]]),
                      torch.stack([c.v[b] for c in cache["kv"]]),
                      torch.where(kpos < lens[b], kpos, -1), bt[b],
                      kv_bits=plan.kv_bits)
    last = torch.tensor(lens, device=dev) - 1
    outs, fed = [logits[torch.arange(B, device=dev), last].float()], []
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    for i in range(STEPS):
        tok = feed[i] if feed is not None else outs[-1].argmax(-1)
        fed.append(tok)
        if snapshots is not None:
            snapshots.append({k: v.clone() for k, v in pool.items()})
        if lockstep is not None:
            pool = lockstep[i]
        lg, pool = decode_step_paged(sp, cfg, plan, pool, bt, tok[:, None],
                                     pos + i)
        outs.append(lg.float())
    torch.cuda.synchronize()
    return outs, fed, pool


def pool_gap(torch, a, b) -> str:
    """How far two pools of the same run drifted: codes that differ (and
    by how many units), or the largest page difference."""
    if "k_scale" not in a:
        gap = max(float((a[n].float() - b[n].float()).abs().max())
                  for n in ("k", "v"))
        return f"max|d page| {gap:.3e}"
    diff = n = worst = 0
    for name in ("k", "v"):
        x, y = a[name], b[name]
        if x.dtype == torch.uint8:     # nibble pairs: compare each code
            x = torch.stack([x & 15, x >> 4], -1)
            y = torch.stack([y & 15, y >> 4], -1)
        d = (x.int() - y.int()).abs()
        diff += int((d > 0).sum())
        n += d.numel()
        worst = max(worst, int(d.max()))
    return f"{diff} of {n} codes differ (max {worst} units)"


def serve_prompts(vocab: int):
    import numpy as np
    rs = np.random.RandomState(6)
    lens = rs.randint(64, SERVE_BUCKETS[-1] + 1, SERVE_REQS)
    return [rs.randint(0, vocab, (int(n),)).astype(np.int32) for n in lens]


def serve_config(num_blocks=None):
    from repro_torch.serve import ServeConfig, blocks_for
    maxb = blocks_for(SERVE_BUCKETS[-1] + SERVE_NEW, SERVE_BS)
    return ServeConfig(max_slots=SERVE_SLOTS, block_size=SERVE_BS,
                       num_blocks=num_blocks or SERVE_SLOTS * maxb,
                       buckets=SERVE_BUCKETS, max_blocks_per_slot=maxb)


def serve_traffic(torch, dev, sp, cfg, plan, prompts, sc, label,
                  eager=False, rt=None):
    """Drive one Runtime (`rt`, or a new one): SERVE_SLOTS requests up
    front, the rest one per decode step, then drain. Checks every request
    ran to its length and the pool ends clean; prints the run's metrics.
    With `eager`, the reference run of phase 22: every program called
    directly (`eager_steps`). Returns (runtime, requests)."""
    import numpy as np

    from repro_torch.analysis.retrace import capture_seconds
    from repro_torch.serve import Runtime, paged_cache_bytes
    if rt is None:
        rt = Runtime(sp, cfg, plan, sc, device=dev)
    if eager:
        eager_steps(rt)
    t0 = time.time()
    reqs = [rt.submit(p, max_new_tokens=SERVE_NEW)
            for p in prompts[:SERVE_SLOTS]]
    for p in prompts[SERVE_SLOTS:]:
        rt.step()
        reqs.append(rt.submit(p, max_new_tokens=SERVE_NEW))
    rt.run()
    wall = time.time() - t0
    ntok = sum(len(r.out_tokens) for r in reqs)
    itl = np.asarray([dt for r in reqs for dt in r.itl])
    captured = getattr(rt._decode, "__comq_graphs__", None)
    say(f"serve {label}: {len(reqs)} requests, {ntok} tokens in {wall:.3f} "
        f"s: tok_per_s {ntok / wall:.1f}, ttft_p50_s "
        f"{float(np.percentile([r.ttft for r in reqs], 50)):.4f}, "
        f"itl_p50_s {float(np.percentile(itl, 50)):.4f}, itl_p99_s "
        f"{float(np.percentile(itl, 99)):.4f}, decode_steps {rt.steps}, "
        f"preemptions {rt.scheduler.preemptions}, cache_bytes "
        f"{paged_cache_bytes(cfg, plan, sc.num_blocks, sc.block_size)}"
        + ("" if captured is None else
           f", warm-up and capture {capture_seconds(rt._decode):.3f} s"))
    check(all(r.finish_reason == "length"
              and len(r.out_tokens) == SERVE_NEW for r in reqs),
          f"serve {label}: a request did not run to its length: "
          f"{[(r.finish_reason, len(r.out_tokens)) for r in reqs]}")
    rt.allocator.check_integrity()
    check(rt.allocator.num_free == rt.allocator.num_blocks
          and rt.scheduler.idle, f"serve {label}: pool or queue not clean")
    return rt, reqs



# ---------------------------------------------------------------------------
# phase 22: the serving steps as CUDA graphs (its parts run in phases 8,
# 10-14 and 20, where their models are on the card)
# ---------------------------------------------------------------------------

GRAPH_STEP = "serve.decode_step"
ENGINE_STEP = "serve.engine.decode_step"
ENGINE_PREFILL = "serve.engine.prefill"
PREFILL_ITERS = 10        # CUDA-event timed calls a prefill bucket


def eager_steps(rt):
    """`rt` with its decode step, prefill buckets and prefill writes called
    directly (`decode_step_paged` on the step's inputs moved to the card;
    the prefill and write programs on their inputs, already there): the
    reference a replay is held to. Only this script does this (as
    `plain_kernels` swaps the kernels); the runtime has no such switch."""
    import functools

    from repro_torch.models.model import decode_step_paged
    from repro_torch.serve.runtime import _prefill_forward, _write_rows
    dev = rt.device

    def direct(params, cfg, plan, pool, bt, tok, pos):
        return decode_step_paged(params, cfg, plan, pool, bt, tok.to(dev),
                                 pos.to(dev))
    rt._decode = direct
    rt._prefill_fn = lambda bucket: functools.partial(
        _prefill_forward, rt.params, rt.cfg,
        rt.plan.replace(prefill_cache_len=bucket))
    rt._write_fn = lambda cache_len: functools.partial(
        _write_rows, rt.pool, rt.kv_bits)
    return rt


def replay_vs_direct(torch, dev, sp, cfg, plan, prompts, label, card):
    """22(a): a Runtime past its capture (SERVE_SLOTS requests admitted,
    3 steps replayed), its last step replayed once more and called
    directly on the same inputs from the same pool: the logits' max|d| /
    max|logit| and whether the two pools agree bit for bit (rewriting a
    step's own rows is idempotent). Returns the logits' gap."""
    from repro_torch.models.model import decode_step_paged
    from repro_torch.serve import Runtime
    rt = Runtime(sp, cfg, plan, serve_config(), device=dev)
    for p in prompts[:SERVE_SLOTS]:
        rt.submit(p, max_new_tokens=SERVE_NEW)
    for _ in range(4):
        rt.step()
    args = (rt.params, rt.cfg, rt.plan, rt.pool, rt._bt_dev, rt._h_tok,
            rt._h_pos)
    start = {k: v.clone() for k, v in rt.pool.items()}
    replay = rt._decode(*args)[0].float().clone()
    after = {k: v.clone() for k, v in rt.pool.items()}
    for k, v in rt.pool.items():
        v.copy_(start[k])
    direct = decode_step_paged(*args[:5], rt._h_tok.to(dev),
                               rt._h_pos.to(dev))[0].float()
    torch.cuda.synchronize()
    gap = float((replay - direct).abs().max()) / float(direct.abs().max())
    pools = all(torch.equal(after[k], rt.pool[k]) for k in after)
    say(f"graphs {label}: a step replayed vs called directly on the "
        f"same inputs: logits max|d|/max|logit| {gap:.3e} "
        f"({'bit-identical' if gap == 0 else 'they differ'}), pools "
        f"{'equal' if pools else 'differ'} ({card})")
    check(pools, f"graphs {label}: the replay's pool writes differ from "
          "the direct call's")
    del rt
    return gap


def serve_graph_vs_eager(torch, dev, sp, cfg, plan, prompts, label, card):
    """22(a, c, d, f): the phase-8 traffic through a Runtime whose step is
    called directly (`eager_steps`) and through one that replays its
    graph, both runs' metrics lines printed: the tokens equal request for
    request, one capture (`compile_count`), the graph pool's bytes."""
    import numpy as np

    from repro_torch.analysis.retrace import capture_seconds, compile_count
    with torch.no_grad():
        _, ref = serve_traffic(torch, dev, sp, cfg, plan, prompts,
                               serve_config(), f"{label} eager", eager=True)
        rt, got = serve_traffic(torch, dev, sp, cfg, plan, prompts,
                                serve_config(), f"{label} replayed")
        # the same traffic again on the captured Runtime: no capture in it
        _, warm = serve_traffic(torch, dev, sp, cfg, plan, prompts,
                                serve_config(), f"{label} replayed, warm",
                                rt=rt)
        caps, pool = compile_count(GRAPH_STEP), rt.graph_pool_bytes()
        secs = capture_seconds(rt._decode)
        prefill_caps = {b: compile_count(f"serve.prefill[{b}]")
                        for b in sorted(rt._prefills)}
        write_caps = {c: compile_count(f"serve.prefill_write[{c}]")
                      for c in sorted(rt._writes)}
        secs_prefill = sum(capture_seconds(f.func) for f in (
            *rt._prefills.values(), *rt._writes.values()))
        del rt
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(got, ref))
    same_warm = sum(a.out_tokens == b.out_tokens for a, b in zip(warm, ref))
    say(f"graphs {label}: replayed tokens == eager for {same}/{len(ref)} "
        f"requests; captures of {GRAPH_STEP} {caps} (warm-up and capture "
        f"{secs:.3f} s, host clock); graph pool "
        f"{'not measured' if pool is None else f'{pool} bytes'} ({card})")

    def pct(reqs, q, what):
        vals = ([r.ttft for r in reqs] if what == "ttft"
                else [dt for r in reqs for dt in r.itl])
        return float(np.percentile(vals, q))
    say(f"graphs (g) {label}: prefill and write replayed against called "
        f"directly (eager: every program direct): TTFT p50 eager "
        f"{pct(ref, 50, 'ttft'):.4f} s, replayed {pct(got, 50, 'ttft'):.4f}"
        f" s (captures inside), warm {pct(warm, 50, 'ttft'):.4f} s; ITL p99"
        f" eager {pct(ref, 99, 'itl'):.4f} s, replayed "
        f"{pct(got, 99, 'itl'):.4f} s, warm {pct(warm, 99, 'itl'):.4f} s "
        f"(host clock); warm tokens == eager for {same_warm}/{len(ref)}; "
        f"captures a prefill "
        f"bucket {prefill_caps}, a write cache length {write_caps} (warm-up"
        f" and capture {secs_prefill:.3f} s); shared graph pool "
        f"{'not measured' if pool is None else f'{pool} bytes'} ({card})")
    check(same == len(ref) and same_warm == len(ref),
          f"graphs {label}: a replayed request's tokens differ from the "
          "eager step's")
    check(caps == 1, f"graphs {label}: {caps} captures, want 1")
    check(prefill_caps and write_caps and all(
        n == 1 for n in (*prefill_caps.values(), *write_caps.values())),
        f"graphs (g) {label}: captures a bucket {prefill_caps}, a cache "
        f"length {write_caps}, want 1 each")
    return pool


def prefill_replay_vs_direct(torch, dev, sp, cfg, plan, prompts, label,
                             card):
    """22(g): each prefill bucket of a fresh Runtime, on a prompt of the
    phase-8 traffic that falls in it: the bucket's graph and its write's
    replayed (each past its capture) against the programs called directly
    on the same inputs: the logits row, the cache rows and positions, and
    the pool the write leaves, bit for bit; then the prefill's ms replayed
    and called directly (CUDA events, PREFILL_ITERS calls; a replay's
    time includes its inputs' copies), and the write's. Returns {bucket:
    (eager ms, replayed ms)}."""
    import numpy as np

    from repro_torch.serve import Runtime
    from repro_torch.serve.runtime import _prefill_forward, _write_rows
    rt = Runtime(sp, cfg, plan, serve_config(), device=dev)
    table = rt._upload(np.arange(rt.maxb, dtype=np.int32))
    times, same = {}, {}
    for bucket in SERVE_BUCKETS:
        prompt = next(p for p in prompts
                      if rt.scheduler.bucket_for(len(p)) == bucket)
        plan_b = rt.plan.replace(prefill_cache_len=bucket)
        fn = rt._prefill_fn(bucket)
        for _ in range(2):                 # the capture's call, then a replay
            out = rt._prefill(prompt, bucket)
        replay = [t.clone() for t in out[:4]]
        tokens, tlen = next(iter(
            fn.func.__comq_graphs__.values())).args[3:5]
        direct = _prefill_forward(rt.params, rt.cfg, plan_b, tokens.clone(),
                                  tlen.clone())
        rows = all(torch.equal(a, b) for a, b in zip(replay, direct))
        write = rt._write_fn(int(replay[1].shape[1]))
        start = {k: v.clone() for k, v in rt.pool.items()}
        for _ in range(2):                 # the capture's call, then a replay
            for k, v in rt.pool.items():
                v.copy_(start[k])
            write(*replay[1:], out[4], table)
        after = {k: v.clone() for k, v in rt.pool.items()}
        for k, v in rt.pool.items():
            v.copy_(start[k])
        _write_rows(rt.pool, rt.kv_bits, *replay[1:], out[4], table)
        pools = all(torch.equal(after[k], rt.pool[k]) for k in after)
        same[bucket] = (rows, pools)
        ms_eager = cuda_ms(torch, lambda i: _prefill_forward(
            rt.params, rt.cfg, plan_b, tokens, tlen), PREFILL_ITERS)
        ms_graph = cuda_ms(torch, lambda i: fn(tokens, tlen), PREFILL_ITERS)
        w_eager = cuda_ms(torch, lambda i: _write_rows(
            rt.pool, rt.kv_bits, *replay[1:], out[4], table), PREFILL_ITERS)
        w_graph = cuda_ms(torch, lambda i: write(*replay[1:], out[4], table),
                          PREFILL_ITERS)
        times[bucket] = (ms_eager, ms_graph)
        say(f"graphs (g) {label} prefill[{bucket}] (a {len(prompt)}-token "
            f"prompt): replayed vs called directly: logits row, cache rows "
            f"and positions {'bit-identical' if rows else 'differ'}, the "
            f"write's pool {'equal' if pools else 'differs'}; prefill "
            f"{ms_eager:.4f} ms called directly, {ms_graph:.4f} ms "
            f"replayed; write {w_eager:.4f} / {w_graph:.4f} ms (CUDA "
            f"events, mean of {PREFILL_ITERS}) ({card})")
    pool = rt.graph_pool_bytes()
    say(f"graphs (g) {label}: a Runtime's {len(SERVE_BUCKETS)} prefill "
        f"graphs and {len(rt._writes)} write graphs share a graph pool of "
        f"{'not measured' if pool is None else f'{pool} bytes'} ({card})")
    check(all(r and p for r, p in same.values()),
          f"graphs (g) {label}: a replayed prefill or write differs from the "
          f"direct call: {same}")
    del rt
    return times


def eager_engine(eng):
    """`eng` with its prefill and decode step run directly (the same
    programs, eager): the reference a replay is held to; only this script
    does this."""
    from repro_torch.serve.engine import _decode_into, _prefill_batch
    eng._prefill = _prefill_batch
    eng._decode = _decode_into
    return eng


def engine_graph_vs_eager(torch, dev, sp, cfg, prompts, what, card, **kw):
    """22(e): the static Engine on `prompts` (a warm 2-token run, then
    SERVE_NEW tokens timed), eager then replayed: tok/s of each (prefill
    included), the tokens equal, one capture for every position, the
    graph pool's bytes. Prints the replayed run on the phase's own serve
    line. Returns the replayed tokens."""
    from repro_torch.analysis.retrace import (capture_seconds, compile_count,
                                              graph_pool_bytes)
    from repro_torch.models import BuildPlan
    from repro_torch.serve import Engine
    runs = {}
    with torch.no_grad():
        for how in ("eager", "replayed"):
            eng = Engine(sp, cfg, BuildPlan(), max_len=PROMPT + SERVE_NEW,
                         device=dev)
            if how == "eager":
                eager_engine(eng)
            eng.generate_batch(prompts, max_new_tokens=2, **kw)   # warm
            torch.cuda.synchronize()
            t0 = time.time()
            out = eng.generate_batch(prompts, max_new_tokens=SERVE_NEW, **kw)
            runs[how] = (out, time.time() - t0)
            if how == "replayed":
                caps, pool = (compile_count(ENGINE_STEP),
                              graph_pool_bytes(eng._decode))
                secs = capture_seconds(eng._decode)
                pcaps = compile_count(ENGINE_PREFILL)
                psecs = capture_seconds(eng._prefill)
            del eng
    out, wall = runs["replayed"]
    say(f"{what} serve bf16 (static Engine): {out.size} tokens in "
        f"{wall:.3f} s: tok_per_s {out.size / wall:.1f} (prefill "
        f"{SERVE_SLOTS}x{PROMPT} included)")
    ref, eager_wall = runs["eager"]
    same = int((out == ref).all(axis=1).sum())
    say(f"graphs (e) {what} Engine: tok_per_s eager "
        f"{ref.size / eager_wall:.1f}, replayed {out.size / wall:.1f}; "
        f"replayed tokens == eager for "
        f"{same}/{len(ref)} requests; captures of {ENGINE_STEP} {caps} "
        f"for the warm batch's step and the timed batch's {SERVE_NEW - 1} "
        f"(positions {PROMPT}-{PROMPT + SERVE_NEW - 2}; warm-up and "
        f"capture {secs:.3f} s, host clock); graph pool "
        f"{'not measured' if pool is None else f'{pool} bytes'} ({card})")
    say(f"graphs (g) {what} Engine: the prefill replayed too (eager: "
        f"called directly); captures of {ENGINE_PREFILL} {pcaps} for both "
        f"batches (warm-up and capture {psecs:.3f} s); the prefill and "
        f"decode graphs share that pool ({card})")
    check(same == len(ref), f"graphs (e) {what}: the replayed Engine's "
          "tokens differ from the eager step's")
    check(caps == 1, f"graphs (e) {what}: {caps} captures, want 1")
    check(pcaps == 1, f"graphs (g) {what}: {pcaps} prefill captures, "
          "want 1")
    return out


def first_differing_op(torch, dev, rt):
    """Where a replay's logits part from the direct call's: a step whose
    every floating aten output is cloned, captured by a guard_graph of its
    own (its warm-up runs it directly, the replay fills the capture's
    clones), both lists compared in call order. Returns the first op whose
    outputs differ (the kernels' own outputs show at the op that reads
    them), or None."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.analysis.retrace import guard_graph
    from repro_torch.models.model import decode_step_paged
    runs = []

    class Keep(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name
            if (isinstance(out, torch.Tensor) and out.is_floating_point()
                    and not name.startswith(("aten::empty",
                                             "aten::new_empty"))):
                runs[-1].append((name, out.clone()))
            return out

    def step(*a):
        runs.append([])
        with Keep():
            return decode_step_paged(*a)

    g = guard_graph(step, name="chip_smoke.first_differing_op",
                    copy_argnums=(5, 6), device=dev)
    args = (rt.params, rt.cfg, rt.plan, rt.pool, rt._bt_dev, rt._h_tok,
            rt._h_pos)
    g(*args)                 # runs[0] direct (the warm-up), runs[1] captured
    g(*args)                 # the replay fills runs[1]
    torch.cuda.synchronize()
    for i, ((op, a), (_, b)) in enumerate(zip(runs[0], runs[1])):
        if not torch.equal(a, b):
            return f"{op} (output {i} of {len(runs[0])})"
    return None


def phase_graphs(torch, dev, sp, cfg, prompts, card):
    """Phase 22 (a, c, d, g) on phase 4's packed 2-layer qwen at full
    width, bf16 at kv_bits 0, 8 and 4 and f32 at 0: a step replayed
    against a direct call on the same inputs (`replay_vs_direct`; where
    they differ, the first op that does), each prefill bucket and its
    write likewise, with their ms (`prefill_replay_vs_direct`), then the
    phase-8 traffic with every program called directly and replayed
    (`serve_graph_vs_eager`: tokens, metrics, one capture a signature,
    the pool's bytes). Returns {label: graph pool bytes}."""
    from repro_torch.models import BuildPlan
    t0 = time.time()
    cfg32 = cfg.replace(compute_dtype="float32")
    pools = {}
    for label, c, plan in (
            ("bf16 kv_bits=0", cfg, BuildPlan()),
            ("bf16 kv_bits=8", cfg, BuildPlan(kv_bits=8)),
            ("bf16 kv_bits=4", cfg, BuildPlan(kv_bits=4)),
            ("f32 kv_bits=0", cfg32, BuildPlan(cache_dtype=torch.float32))):
        with torch.no_grad():
            gap = replay_vs_direct(torch, dev, sp, c, plan, prompts,
                                   f"(a) {label}", card)
            if gap:
                from repro_torch.serve import Runtime
                rt = Runtime(sp, c, plan, serve_config(), device=dev)
                for p in prompts[:SERVE_SLOTS]:
                    rt.submit(p, max_new_tokens=SERVE_NEW)
                rt.step()
                say(f"graphs (a) {label}: the first op whose replayed "
                    f"output differs: {first_differing_op(torch, dev, rt)}")
                del rt
            prefill_replay_vs_direct(torch, dev, sp, c, plan, prompts,
                                     label, card)
        pools[label] = serve_graph_vs_eager(torch, dev, sp, c, plan,
                                            prompts, f"(a) {label}", card)
    say(f"graphs: phase 22 (a, c, d, g) in {time.time() - t0:.1f} s")
    return pools


# ---------------------------------------------------------------------------
# phase 9: mixed-precision policies
# ---------------------------------------------------------------------------

def leaf_bits(qparams):
    """{"layer.mod.leaf": bits} of a quantize_model output."""
    return {f"{l}.{mod}.{leaf}": v["bits"]
            for l, lp in sorted(qparams["__qlayers__"].items(),
                                key=lambda kv: int(kv[0]))
            for mod, leaves in lp.items() if isinstance(leaves, dict)
            for leaf, v in leaves.items() if isinstance(v, dict)}


def same_codes(torch, qa, qb) -> bool:
    """Codes, scales and zero-points of two quantize_model outputs equal
    bit for bit."""
    ta, tb = qa["__qlayers__"], qb["__qlayers__"]
    n = 0
    for l, lp in ta.items():
        for mod, leaves in lp.items():
            if not isinstance(leaves, dict):
                continue
            for leaf, a in leaves.items():
                if not isinstance(a, dict):
                    continue
                b = tb[l][mod][leaf]
                if not all(torch.equal(a[k], b[k])
                           for k in ("codes", "scale", "z_lo")):
                    return False
                n += 1
    return n > 0


def phase_policy(torch, dev, cfg, cfg32, ops, kernels, prompts, qmm,
                 paged):
    """Quantize under a per-leaf policy that puts 2/3/4/8-bit leaves on
    the card, decode and serve it from its packed codes; a bits-per-param
    budget; the same policy with guards off. Returns the launch counts of
    run (a)'s path (quantize + decode + serve)."""
    from repro_torch.core.apply import serving_params
    from repro_torch.core.policy import alloc_bits_per_param
    from repro_torch.launch.quantize import quantize_and_eval
    common = dict(method="comq_blocked", calib_batch=8, calib_seq=PROMPT,
                  device=dev)

    # (a) the per-leaf policy, quantize + decode + serve counted
    ops.reset_launch_counts()
    run = quantize_and_eval(cfg, policy=POLICY, **common)
    s = run.summary
    bits = leaf_bits(run.qparams)
    say(f"policy (a) {POLICY!r}: per-leaf bits {bits}")
    say(f"policy (a) quantize: {json.dumps(s)}")
    imp = s["comq_vs_rtn_error_improvement"]
    check(s["mixed_policy"] is True and s["guard_events"] == 0
          and math.isfinite(imp) and imp > 0,
          f"policy (a): mixed_policy {s['mixed_policy']}, guard_events "
          f"{s['guard_events']}, improvement {imp}")
    check(sorted(set(bits.values())) == [2, 3, 4, 8],
          f"policy (a) did not put all four widths on the card: {bits}")
    plan = run.plan
    check(plan.cache_quant and plan.kv_bits == 8,
          f"policy (a): kv=8 did not reach the plan ({plan})")
    sp = serving_params(run.qparams, cfg)
    packing = {f"{i}.{mod}.{leaf}": (q.bits, q.cpb)
               for i, lp in enumerate(sp["layers"])
               for mod, leaves in lp.items() if isinstance(leaves, dict)
               for leaf, q in leaves.items() if hasattr(q, "cpb")}
    say(f"policy (a) packed leaves (bits, codes per byte): {packing}")
    check({c for _, c in packing.values()} == {1, 2, 4},
          f"policy (a): the packed model does not hold cpb 1, 2 and 4: "
          f"{packing}")
    # 16 greedy steps on the static engine with the int8 cache, against
    # the plain versions in lockstep. Over the int8 cache each plain step
    # reads the kernel run's own cache rows, the step's new row included
    # (it starts from the kernel run's cache after the step, and its own
    # write is skipped): each new K/V row takes its own absmax scale, so a
    # last-bit difference of the row's largest entry would re-round all its
    # codes and enter the comparison as a code flip, not a kernel error.
    # f32 carries the precision gate; the bf16 int8-cache gap is printed,
    # and the same steps over a bf16 cache carry phase 5's coarse gate
    dplan = plan.replace(prefill_cache_len=PROMPT + STEPS)
    for label, cache, c, pl in (
            ("bfloat16", "int8", cfg, dplan),
            ("bfloat16", "bf16", cfg, dplan.replace(cache_quant=False)),
            ("float32", "int8", cfg32,
             dplan.replace(cache_dtype=torch.float32))):
        snaps, after = [], []
        own_rows = cache == "int8"
        t0 = time.time()
        with torch.no_grad():
            outs, fed = run_decode(torch, sp, c, pl, run.eval_tokens,
                                   snapshots=snaps,
                                   after=after if own_rows else None)
        say(f"policy (a) decode {label}, {cache} cache: prefill "
            f"8x{PROMPT} + {STEPS} steps in {time.time() - t0:.2f} s wall")

        def rerun():
            with (kernel_cache_rows() if own_rows
                  else contextlib.nullcontext()):
                return run_decode(torch, sp, c, pl, run.eval_tokens,
                                  feed=fed,
                                  lockstep=after if own_rows else snaps)[0]

        compare_decode(torch, ops, kernels, rerun, outs, label,
                       what=f"policy (a) decode {cache} cache"
                       + (" (the kernel run's cache rows)" if own_rows
                          else ""),
                       gate=(label, cache) != ("bfloat16", "int8"))
        if own_rows:
            # the former form of this lockstep, printed: each plain step
            # from the kernel run's cache before the step, writing its own
            # new row (its own absmax scale and codes)
            with torch.no_grad(), plain_kernels(ops, kernels):
                former = run_decode(torch, sp, c, pl, run.eval_tokens,
                                    feed=fed, lockstep=snaps)[0]
            worst = max(float((a - b).abs().max()) / float(b.abs().max())
                        for a, b in zip(outs, former))
            say(f"policy (a) decode {label}, {cache} cache, the former "
                f"lockstep (each plain step writing its own new row): worst "
                f"step rel {worst:.3e} (printed)")
        del snaps, after
        with torch.no_grad(), plain_kernels(ops, kernels):
            free, _ = run_decode(torch, sp, c, pl, run.eval_tokens, feed=fed)
        worst = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(outs, free))
        say(f"policy (a) decode {label}, {cache} cache, free-running plain "
            f"run: worst step rel {worst:.3e}")
    with torch.no_grad():
        n0, tc0 = paged.launches_quant, paged.launches_quant_tc
        serve_traffic(torch, dev, sp, cfg, plan, prompts, serve_config(),
                      "policy (a) bf16 kv_bits=8")
        n, tc = paged.launches_quant - n0, paged.launches_quant_tc - tc0
    check(n > 0 and tc == n, f"policy (a) serve: {tc} of {n} quantized-pool "
          f"launches on tensor cores")
    counts = ops.launch_counts()
    by_cpb = dict(qmm.launches_by_cpb)
    say(f"policy (a) path launches (quantize + decode + serve): {counts}; "
        f"quant_matmul by codes per byte {by_cpb}")
    check(all(by_cpb[c] > 0 for c in (1, 2, 4)),
          f"policy (a): quant_matmul did not launch at cpb 1, 2 and 4: "
          f"{by_cpb}")
    check(all(counts[k] > 0 for k in POLICY_PATH),
          f"a kernel of the policy path never launched: {counts}")
    del sp

    # (c) the same quantize with guards off: the same codes, bit for bit;
    # then guards on once more, so each setting has a run after a warm one
    off = quantize_and_eval(cfg, policy=POLICY, guards=False, **common)
    same = same_codes(torch, run.qparams, off.qparams)
    off_s = off.seconds
    del off
    again = quantize_and_eval(cfg, policy=POLICY, **common)
    same_again = same_codes(torch, run.qparams, again.qparams)
    say(f"policy (c) guards off: codes equal to guards on: {same}; a second "
        f"guards-on run: {same_again}. quantize_model seconds "
        f"(synchronized, host clock): guards on {run.seconds:.3f}, then off "
        f"{off_s:.3f}, then on {again.seconds:.3f}")
    check(same and same_again,
          "policy (c): guards-off or repeated codes differ from run (a)'s")
    del run, again

    # (b) a bits-per-param budget with 4-bit pages
    run = quantize_and_eval(cfg, bits_budget=BUDGET, policy="kv=4", **common)
    bpp = alloc_bits_per_param(run.alloc, run.sizes)
    say(f"policy (b) --bits-budget {BUDGET}: {bpp:.4f} bits/param, per-leaf "
        f"bits {leaf_bits(run.qparams)}")
    say(f"policy (b) quantize: {json.dumps(run.summary)}")
    check(bpp <= BUDGET + 1e-9, f"policy (b): {bpp} bits/param > {BUDGET}")
    check(run.plan.kv_bits == 4 and not run.plan.cache_quant,
          f"policy (b): kv=4 did not reach the plan ({run.plan})")
    with torch.no_grad():
        serve_traffic(torch, dev, serving_params(run.qparams, cfg), cfg,
                      run.plan, prompts[:SERVE_SLOTS], serve_config(),
                      "policy (b) bf16 kv_bits=4")
    return counts


def quantize_counted(torch, ops, cfg, dev, what):
    """The launcher's quantize of `cfg` (comq_blocked, 4-bit per-channel)
    with each layer timed; gated on improvement, loss gap and no guard
    event. Returns the QuantizeRun."""
    from repro_torch.core import pipeline
    from repro_torch.launch.quantize import quantize_and_eval
    per_layer = []
    t0 = time.time()
    with layer_clock(torch, pipeline, per_layer):
        run = quantize_and_eval(cfg, method="comq_blocked", calib_batch=8,
                                calib_seq=PROMPT, device=dev)
    s = run.summary
    say(f"{what} quantize: {json.dumps(s)}")
    say(f"{what} quantize: quantize_model {run.seconds:.3f} s "
        f"(synchronized); per layer (synchronized) "
        f"{[round(x, 3) for x in per_layer]} s; {time.time() - t0:.1f} s "
        f"wall incl. init and eval; launches so far {ops.launch_counts()}")
    imp = s["comq_vs_rtn_error_improvement"]
    check(math.isfinite(imp) and imp > 0,
          f"{what} comq_vs_rtn_error_improvement {imp}")
    gap = abs(s["quant_loss"] - s["fp_loss"])
    check(gap <= LOSS_GAP, f"{what} |quant_loss - fp_loss| = {gap} > "
          f"{LOSS_GAP}")
    check(s["guard_events"] == 0,
          f"{what} quantize: {s['guard_events']} guard events")
    return run


def quantize_full_depth(torch, dev, cfg, what):
    """A quantize of `cfg` at its full depth, outside the counts: wall
    time, seconds per layer and peak device memory; gated on a finite
    improvement > 0."""
    from repro_torch.core import pipeline
    from repro_torch.launch.quantize import quantize_and_eval
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    per_layer = []
    t0 = time.time()
    with layer_clock(torch, pipeline, per_layer):
        deep = quantize_and_eval(cfg, method="comq_blocked", calib_batch=8,
                                 calib_seq=PROMPT, device=dev)
    wall = time.time() - t0
    s = deep.summary
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"{what} quantize, {cfg.n_layers} layers: {json.dumps(s)}")
    say(f"{what} quantize, {cfg.n_layers} layers: quantize_model "
        f"{deep.seconds:.3f} s (synchronized), {wall:.1f} s wall incl. init "
        f"and eval; per layer (synchronized) "
        f"{[round(x, 3) for x in per_layer]} s; max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB, {(peak - held) / 2 ** 30:.2f} GiB above "
        f"the {held / 2 ** 30:.2f} GiB held before the run")
    imp = s["comq_vs_rtn_error_improvement"]
    check(math.isfinite(imp) and imp > 0,
          f"{what} full-depth comq_vs_rtn_error_improvement {imp}")


def check_moe_kernels(torch, dev, kernels, results, cfg):
    """The kernels at the MoE model's shapes: the expert-batched panel,
    flash and the paged kernels at its heads, quant_matmul at its
    attention projections (M=8)."""
    panel, flash, qmm, paged = kernels
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    check(heads == MOE_HEADS, f"{cfg.name}: heads {heads}")
    check_panel_batched(torch, panel, dev, results, cfg.moe.n_experts)
    check_flash(torch, flash, dev, results, heads, ("moe",))
    K = cfg.d_model
    check_qmm(torch, qmm, dev, results,
              [(8, K, N, 4, xdt)
               for N in (K, cfg.n_kv_heads * cfg.resolved_head_dim)
               for xdt in (torch.bfloat16, torch.float32)])
    check_paged(torch, paged, dev, results, heads, ("moe",))


def phase_moe(torch, dev, ops, kernels, cfg, card):
    """The counted MoE path on `cfg` (granite-moe-3b-a800m at full width,
    depth cut): quantize (per-expert blocked COMQ, one panel launch a
    panel for all experts), decode from the packed codes against the plain
    versions, and the phase-8 traffic served at kv_bits 0, 8 and 4; then
    mixed == solo at f32. Returns (the path's launch counts, its batched
    panel launches)."""
    from repro_torch.core.apply import serving_params
    from repro_torch.models import BuildPlan
    from repro_torch.serve import Runtime
    panel, flash, qmm, paged = kernels

    # quantize
    ops.reset_launch_counts()
    run = quantize_counted(torch, ops, cfg, dev, "moe")
    say(f"moe quantize: batched panel launches {panel.launches_batched}")
    check(panel.launches_batched > 0,
          "moe quantize: the expert-batched panel never launched")
    qt = run.qparams["__qlayers__"]["0"]["moe"]["w_down"]
    say(f"moe w_down QTensor: codes {tuple(qt['codes'].shape)}, scale "
        f"{tuple(qt['scale'].shape)}, {qt['bits']} bits")

    # decode from the packed codes (bf16, the main path), then the same
    # steps at f32 compute, each against the plain versions (DecodeTape):
    # gated layer by layer in lockstep at both types, and free-running at
    # f32 (the precision gate); the bf16 free-running gap is printed
    sp = serving_params(run.qparams, cfg)
    cfg32 = cfg.replace(compute_dtype="float32")
    decode_vs_plain(torch, ops, kernels, sp, cfg,
                    BuildPlan(prefill_cache_len=PROMPT + STEPS),
                    run.eval_tokens, "moe decode", gate_free=("float32",))

    # serve the phase-8 traffic
    prompts = serve_prompts(cfg.vocab_size)
    with torch.no_grad():
        for kv_bits in (0, 8, 4):
            n0, tc0 = paged.launches_quant, paged.launches_quant_tc
            serve_traffic(torch, dev, sp, cfg, BuildPlan(kv_bits=kv_bits),
                          prompts, serve_config(),
                          f"moe bf16 kv_bits={kv_bits}")
            if kv_bits:
                n = paged.launches_quant - n0
                tc = paged.launches_quant_tc - tc0
                check(n > 0 and tc == n, f"moe serve kv_bits={kv_bits}: "
                      f"{tc} of {n} quantized-pool launches on tensor cores")
    counts = ops.launch_counts()
    batched = panel.launches_batched
    say(f"moe path launches (quantize + decode + serve): {counts}; "
        f"expert-batched comq_panel launches {batched}")
    check(all(counts[k] > 0 for k in MOE_PATH),
          f"a kernel of the moe path never launched: {counts}")
    # 22(f): the traffic replayed against the eager step (group 3)
    serve_graph_vs_eager(torch, dev, sp, cfg, BuildPlan(), prompts,
                         "(f) moe bf16 kv_bits=0", card)

    # f32: each request's tokens equal its solo run
    p32 = BuildPlan(cache_dtype=torch.float32)
    with torch.no_grad():
        _, reqs = serve_traffic(torch, dev, sp, cfg32, p32, prompts,
                                serve_config(), "moe f32 kv_bits=0 mixed")
        solo_rt = Runtime(sp, cfg32, p32, serve_config(), device=dev)
        solo = [solo_rt.generate([p], max_new_tokens=SERVE_NEW)[0].tolist()
                for p in prompts]
    same = sum(r.out_tokens == t for r, t in zip(reqs, solo))
    say(f"moe serve f32: mixed == solo for {same}/{len(solo)} requests")
    check(same == len(solo), "moe serve f32: a mixed-traffic request "
          "differs from its solo run")
    return counts, batched


# ---------------------------------------------------------------------------
# phase 11: the hybrid family (parallel SSM heads)
# ---------------------------------------------------------------------------

def check_hybrid_kernels(torch, dev, kernels, results, cfg):
    """The three kernels of the hybrid path at hymba's shapes: flash at
    25/5 heads, hd 64, window 1024 (B=8, T=128 and B=1, T=2048, where the
    window binds), quant_matmul at the decode projections (M=8: K=1600
    into N=1600 / 320 / 5504, K=5504 into N=1600), the panel at w_in's
    6400 and w_gate's 5504 columns."""
    panel, flash, qmm, _ = kernels
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    check(heads == HYBRID_HEADS and cfg.sliding_window == HYBRID_WINDOW,
          f"{cfg.name}: heads {heads}, window {cfg.sliding_window}")
    check_panel(torch, panel, dev, results, HYBRID_PANEL)
    time_plain_scan(torch, dev, cfg)
    check_flash(torch, flash, dev, results, heads, ("hymba",),
                shapes=((8, PROMPT), (1, 2 * HYBRID_WINDOW)),
                window=HYBRID_WINDOW)
    d, kvd = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim
    check_qmm(torch, qmm, dev, results,
              [(8, K, N, 4, xdt)
               for K, N in ((d, d), (d, kvd), (d, cfg.d_ff), (cfg.d_ff, d))
               for xdt in (torch.bfloat16, torch.float32)])


def time_plain_scan(torch, dev, cfg):
    """The chunked selective scan (`models.ssm._ssm_recurrence`, plain
    PyTorch in both packages: JAX runs `lax.associative_scan`, no Pallas
    kernel) at hymba's width: 8x128 (calibration, one chunk of 128) and
    8x512 (prefill, one chunk of 512); mean of 5 eager calls, peak device
    memory of one call, and the least time of the one-pass recurrence:
    x (bf16) in, y (f32) and h out once, the x / dt / B / C projections
    and ~7 f32 operations a (token, channel, state) element."""
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.roofline import kernels as kc
    gen = torch.Generator(device=dev).manual_seed(9)
    p = ssm_mod.init_ssm(gen, cfg, dev)
    sel = {k: p[k] for k in ("w_xproj", "w_dt", "b_dt", "a_log")}
    _, di, n, dt_rank, _ = ssm_mod._dims(cfg)
    for B, T in ((8, PROMPT), (8, 4 * PROMPT)):
        xi = torch.randn(B, T, di, generator=gen, device=dev).bfloat16()
        h0 = torch.zeros(B, di, n, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = cuda_ms(torch, lambda i: ssm_mod._ssm_recurrence(
            sel, xi, h0, cfg=cfg, chunk=T), 5)
        peak = torch.cuda.max_memory_allocated(dev) - base
        bms, by = kc.bound_ms(kc.ssm_scan(
            B, T, di, n, dt_rank, sum(v.numel() for v in sel.values())))
        say(f"plain selective scan B={B} T={T} d_inner={di} N={n} (one "
            f"chunk): ms {ms:.4f} (eager mean), bound_ms {bms:.4f} ({by}), "
            f"peak memory above its inputs {peak / 2 ** 20:.0f} MiB; no "
            f"kernel in either package (ROADMAP Queue B, B4)")
        del xi, h0


def decode_vs_plain(torch, ops, kernels, sp, cfg, plan, tokens, what,
                    gate_free=(), vision_embeds=None):
    """Decode from the packed codes (bf16, then f32 compute with an f32
    cache), each against the plain versions with the layers in lockstep
    (hidden state, a hybrid layer's SSM state and an MoE layer's routing
    from the kernel run, `DecodeTape`) under the precision gates, and
    free-running, gated only for the types in `gate_free`, else printed:
    hymba moves its f32 logits by ~1e-2 of max|logit| when the
    quant_matmul outputs alone change by 1e-6 with the plain versions
    only (`tools/decode_sensitivity.py`, PERF.md §6), the size of
    the kernel's own f32 difference, and every random-init model here
    does so at bf16, so there the free-running gap measures the model."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    cfg32 = cfg.replace(compute_dtype="float32")
    plan32 = plan.replace(cache_dtype=torch.float32)
    fed = None
    for label, c, pl in (("bfloat16", cfg, plan),
                         ("float32", cfg32, plan32)):
        tape = DecodeTape(torch, tfm, moe_mod)
        t0 = time.time()
        with torch.no_grad(), tape.mode("record"):
            outs, fed = run_decode(torch, sp, c, pl, tokens, feed=fed,
                                   vision_embeds=vision_embeds)
        say(f"{what} {label}: prefill {tokens.shape[0]}x{tokens.shape[1]} "
            f"+ {STEPS} steps in {time.time() - t0:.2f} s wall")

        def rerun(mode, c=c, pl=pl, tape=tape):
            with tape.mode(mode):
                return run_decode(torch, sp, c, pl, tokens, feed=fed,
                                  vision_embeds=vision_embeds)[0]
        compare_decode(torch, ops, kernels, lambda: rerun("free"), outs,
                       label, what=f"{what}, free-running",
                       gate=label in gate_free, vocab=cfg.vocab_size)
        if tape.pairs:
            say(f"{what} {label}, free-running plain run: {tape.flips} of "
                f"{tape.pairs} routed (token, expert) pairs differ from the "
                f"kernel run's")
        compare_decode(torch, ops, kernels, lambda: rerun("lockstep"), outs,
                       label, what=f"{what}, layers in lockstep",
                       vocab=cfg.vocab_size)
        tape.check_layers(label, what)
        del outs, tape


def phase_hybrid(torch, dev, ops, kernels, cfg, card):
    """The counted hybrid path on `cfg` (hymba-1.5b at full width, depth
    cut): quantize (blocked COMQ over the attention, SSM and MLP leaves;
    the SSM state carried from layer to layer), decode from the packed
    codes against the plain versions (8x128, and one B=1 prompt whose
    steps cross the 1024 window on the ring cache), and serve through the
    static Engine (the engine `launch.serve` runs for this family). Then a
    quantize at full depth, outside the count. Returns the path's launch
    counts."""
    import numpy as np
    from repro_torch.core.apply import serving_params
    from repro_torch.models import BuildPlan
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Engine

    # (b) quantize
    ops.reset_launch_counts()
    run = quantize_counted(torch, ops, cfg, dev, "hybrid")
    for name in ("w_in", "w_out"):
        qt = run.qparams["__qlayers__"]["0"]["ssm"][name]
        say(f"hybrid ssm.{name} QTensor: codes {tuple(qt['codes'].shape)}, "
            f"{qt['bits']} bits")

    # (c) decode from the packed codes: the 8x128 eval batch, then one
    # prompt of HYBRID_LONG tokens on a ring cache of the window's 1024
    # rows, whose steps write positions 1016-1031
    sp = serving_params(run.qparams, cfg)
    ssm0 = sp["layers"][0]["ssm"]
    ms = cuda_ms(torch, lambda i: (ssm0["w_in"].dequant(torch.bfloat16),
                                   ssm0["w_out"].dequant(torch.bfloat16)),
                 20)
    say(f"hybrid decode: w_in {ssm0['w_in'].shape} + w_out "
        f"{ssm0['w_out'].shape} dequantized to bf16 (every decode step, "
        f"every layer, as in JAX): {ms:.4f} ms a layer (eager mean)")
    decode_vs_plain(torch, ops, kernels, sp, cfg,
                    BuildPlan(prefill_cache_len=PROMPT + STEPS),
                    run.eval_tokens, "hybrid decode")
    gen = torch.Generator(device=dev).manual_seed(8)
    long = torch.randint(0, cfg.vocab_size, (1, HYBRID_LONG), generator=gen,
                         device=dev)
    decode_vs_plain(torch, ops, kernels, sp, cfg, BuildPlan(), long,
                    f"hybrid decode B=1 T={HYBRID_LONG} (ring of "
                    f"{HYBRID_WINDOW})")

    # (d) serve through the static Engine: 8 prompts of 128 tokens,
    # replayed against the eager step (22e)
    prompts = np.random.RandomState(6).randint(
        0, cfg.vocab_size, (SERVE_SLOTS, PROMPT)).astype(np.int32)
    engine_graph_vs_eager(torch, dev, sp, cfg, prompts, "hybrid", card)
    with torch.no_grad():
        # f32: the plain versions' greedy tokens with every layer in
        # lockstep with the kernel run (gated), and free-running (printed:
        # a logit gap of ~1e-2 flips near-ties, and a flipped token
        # changes the rest of its request)
        cfg32 = cfg.replace(compute_dtype="float32")
        p32 = BuildPlan(cache_dtype=torch.float32)

        def engine_tokens():
            return Engine(sp, cfg32, p32, max_len=PROMPT + SERVE_NEW,
                          device=dev).generate_batch(
                              prompts, max_new_tokens=SERVE_NEW)
        tape = DecodeTape(torch, tfm, moe_mod, base=PROMPT)
        with tape.mode("record"):
            got = engine_tokens()
        with plain_kernels(ops, kernels):
            free = engine_tokens()
            with tape.mode("lockstep"):
                lock = engine_tokens()
    for name, want in (("free-running", free), ("layers in lockstep", lock)):
        say(f"hybrid serve f32, {name}: kernel tokens == plain versions' "
            f"tokens for {int((got == want).all(axis=1).sum())}/"
            f"{len(prompts)} requests ({int((got == want).sum())}/"
            f"{got.size} tokens)")
    check(bool((got == lock).all()),
          "hybrid serve f32: with the layers in lockstep the plain "
          "versions' greedy tokens differ from the kernels'")
    tape.check_layers("float32", "hybrid serve")
    counts = ops.launch_counts()
    say(f"hybrid path launches (quantize + decode + serve): {counts}")
    check(all(counts[k] > 0 for k in HYBRID_PATH),
          f"a kernel of the hybrid path never launched: {counts}")
    del sp, run

    # (e) quantize at full depth
    quantize_full_depth(torch, dev, cfg.replace(n_layers=HYBRID_FULL_LAYERS),
                        "hybrid")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the audio decoder (musicgen-large: MHA, layernorm, GELU MLP)
# ---------------------------------------------------------------------------

def check_audio_kernels(torch, dev, kernels, results, cfg):
    """The five kernels at musicgen's shapes: the panel at n=2048 / 6144 /
    8192, flash and the paged pair at 32/32 heads, hd 64 (group 1: the
    tensor-core paged kernels pad one query row a KV head to a 16-row
    fragment), quant_matmul at the decode projections (M=8: K=2048 into
    N=2048 / 8192, K=8192 into N=2048)."""
    panel, flash, qmm, paged = kernels
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    check(heads == AUDIO_HEADS, f"{cfg.name}: heads {heads}")
    check_panel(torch, panel, dev, results, AUDIO_PANEL)
    check_flash(torch, flash, dev, results, heads, ("musicgen",))
    d, f = cfg.d_model, cfg.d_ff
    check_qmm(torch, qmm, dev, results,
              [(8, K, N, 4, xdt) for K, N in ((d, d), (d, f), (f, d))
               for xdt in (torch.bfloat16, torch.float32)])
    check_paged(torch, paged, dev, results, heads, ("musicgen",))


def phase_audio(torch, dev, ops, kernels, cfg, card):
    """The counted audio path on `cfg` (musicgen-large at full width,
    depth cut): quantize, decode from the packed codes against the plain
    versions (8x128; gated with the layers in lockstep at both types,
    free-running printed, as for hymba), the phase-8 traffic served at
    kv_bits 0, 8 and 4; then, outside the count, mixed == solo at f32, a
    small pool that preempts, and a quantize at full depth. Returns the
    path's launch counts."""
    from repro_torch.core.apply import serving_params
    from repro_torch.models import BuildPlan
    from repro_torch.serve import Runtime
    panel, flash, qmm, paged = kernels

    ops.reset_launch_counts()
    run = quantize_counted(torch, ops, cfg, dev, "audio")
    sp = serving_params(run.qparams, cfg)
    # f32 free-running is gated too: this model's gap on the H100 is
    # ~1e-3 of max|logit| (PERF.md §6), as qwen's is; bf16's is printed
    decode_vs_plain(torch, ops, kernels, sp, cfg,
                    BuildPlan(prefill_cache_len=PROMPT + STEPS),
                    run.eval_tokens, "audio decode", gate_free=("float32",))
    prompts = serve_prompts(cfg.vocab_size)
    with torch.no_grad():
        for kv_bits in (0, 8, 4):
            n0, tc0 = paged.launches_quant, paged.launches_quant_tc
            serve_traffic(torch, dev, sp, cfg, BuildPlan(kv_bits=kv_bits),
                          prompts, serve_config(),
                          f"audio bf16 kv_bits={kv_bits}")
            if kv_bits:
                n = paged.launches_quant - n0
                tc = paged.launches_quant_tc - tc0
                check(n > 0 and tc == n, f"audio serve kv_bits={kv_bits}: "
                      f"{tc} of {n} quantized-pool launches on tensor cores")
    counts = ops.launch_counts()
    say(f"audio path launches (quantize + decode + serve): {counts}")
    check(all(counts[k] > 0 for k in AUDIO_PATH),
          f"a kernel of the audio path never launched: {counts}")
    # 22(f): the traffic replayed against the eager step (group 1)
    serve_graph_vs_eager(torch, dev, sp, cfg, BuildPlan(), prompts,
                         "(f) audio bf16 kv_bits=0", card)

    # f32: each request's tokens equal its solo run; a small pool preempts
    cfg32 = cfg.replace(compute_dtype="float32")
    p32 = BuildPlan(cache_dtype=torch.float32)
    with torch.no_grad():
        _, reqs = serve_traffic(torch, dev, sp, cfg32, p32, prompts,
                                serve_config(), "audio f32 kv_bits=0 mixed")
        solo_rt = Runtime(sp, cfg32, p32, serve_config(), device=dev)
        solo = [solo_rt.generate([p], max_new_tokens=SERVE_NEW)[0].tolist()
                for p in prompts]
        same = sum(r.out_tokens == t for r, t in zip(reqs, solo))
        say(f"audio serve f32: mixed == solo for {same}/{len(solo)} requests")
        check(same == len(solo), "audio serve f32: a mixed-traffic request "
              "differs from its solo run")
        rt, reqs = serve_traffic(torch, dev, sp, cfg32, p32, prompts,
                                 serve_config(num_blocks=SMALL_POOL),
                                 f"audio f32 kv_bits=0 pool of {SMALL_POOL} "
                                 f"pages")
        check(rt.scheduler.preemptions > 0,
              "audio serve f32: the small pool never preempted")
        same = sum(r.out_tokens == t for r, t in zip(reqs, solo))
        say(f"audio serve f32 under preemption: {same}/{len(solo)} requests "
            f"equal their solo runs")
    del sp, run
    quantize_full_depth(torch, dev, cfg.replace(n_layers=AUDIO_FULL_LAYERS),
                        "audio")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the attention-free family (rwkv6-7b)
# ---------------------------------------------------------------------------

def time_plain_wkv(torch, dev, cfg):
    """The chunked wkv (`models.rwkv._wkv_scan`, plain PyTorch in both
    packages: JAX runs einsums under `lax.scan`, no Pallas kernel) at
    rwkv's width for one layer: 8x128 in chunks of 16 (calibration and
    prefill), 8x1 (a decode step) and 1x1000 in chunks of 1 (a prefill
    whose length 16 does not divide); mean of eager calls, against the
    least time of the one-pass recurrence: r, k, v and log w in and the
    output out once (f32), the state in and out, and ~5 f32 operations a
    (token, head, k, v) element."""
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.roofline import kernels as kc
    gen = torch.Generator(device=dev).manual_seed(12)
    d, H, hd = rwkv_mod._dims(cfg)
    for B, T, C, iters in ((8, PROMPT, 16, 10), (8, 1, 1, 50),
                           (1, RWKV_LONG, 1, 1)):
        r, k, v = (torch.randn(B, T, H, hd, generator=gen, device=dev)
                   for _ in range(3))
        logw = -torch.rand(B, T, H, hd, generator=gen, device=dev) * 5 - 1e-6
        u = torch.randn(H, hd, generator=gen, device=dev)
        s0 = torch.randn(B, H, hd, hd, generator=gen, device=dev)
        ms = cuda_ms(torch, lambda i: rwkv_mod._wkv_scan(
            r, k, v, logw, u, s0, chunk=C), iters)
        bms, by = kc.bound_ms(kc.wkv(B, T, H, hd, d))
        say(f"plain wkv B={B} T={T} chunk {C} H={H} hd={hd} (one layer): "
            f"ms {ms:.4f} (eager mean of {iters}), bound_ms {bms:.4f} "
            f"({by}); no kernel in either package (ROADMAP Queue B)")
        del r, k, v, logw, s0


def rwkv_forms_agree(torch, sp, cfg, tokens, what):
    """f32: prefill of tokens[:, :-STEPS] plus STEPS teacher-forced decode
    steps (chunks of 1) against one forward over all the tokens: each
    step's logits within LOGITS_REL of max|logit|."""
    from repro_torch.models import BuildPlan, decode_step, forward, prefill
    plan = BuildPlan()
    T = tokens.shape[1] - STEPS
    t0 = time.time()
    with torch.no_grad():
        want = forward(sp, cfg, plan, tokens)[0].float()
        logits, cache = prefill(sp, cfg, plan, tokens[:, :T])
        got = [logits.float()]
        for i in range(STEPS):
            logits, cache = decode_step(sp, cfg, plan, cache,
                                        tokens[:, T + i:T + i + 1], T + i)
            got.append(logits.float())
    torch.cuda.synchronize()
    got = torch.stack(got[:-1], 1)
    ref = want[:, T - 1:T + STEPS - 1]
    rel = float((got - ref).abs().max()) / float(ref.abs().max())
    say(f"{what}: prefill {tokens.shape[0]}x{T} + {STEPS} decode steps vs "
        f"one forward over {T + STEPS} tokens, f32: max|d logits|/max|logit| "
        f"{rel:.3e} (tol {LOGITS_REL['float32']}), greedy agreement "
        f"{float((got.argmax(-1) == ref.argmax(-1)).float().mean()):.3f}; "
        f"{time.time() - t0:.2f} s wall")
    check(rel <= LOGITS_REL["float32"], f"{what}: rel {rel}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")


def phase_rwkv(torch, dev, ops, kernels, cfg, card):
    """The counted attention-free path on `cfg` (rwkv6-7b at full width,
    depth cut): quantize (the eight projections of each layer through
    comq_panel, the RWKV state carried from layer to layer), the
    recurrence's chunked and one-step forms against each other from the
    packed codes, and the static Engine (what `launch.serve` runs for
    this family; every projection dequantized each step, as in JAX).
    Returns the path's launch counts."""
    import numpy as np
    from repro_torch.core.apply import serving_params
    panel = kernels[0]

    ops.reset_launch_counts()
    run = quantize_counted(torch, ops, cfg, dev, "rwkv")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "rwkv: TF32 matmuls are on; the wkv's exponent-scaled operands "
          "need full f32")
    check(panel.launches > 0, "rwkv quantize: comq_panel never launched")
    for mod, leaf in (("tm", "w_r"), ("cm", "w_k"), ("cm", "w_v")):
        qt = run.qparams["__qlayers__"]["0"][mod][leaf]
        say(f"rwkv {mod}.{leaf} QTensor: codes {tuple(qt['codes'].shape)}, "
            f"{qt['bits']} bits")
    sp = serving_params(run.qparams, cfg)
    cfg32 = cfg.replace(compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (8, PROMPT + STEPS),
                         generator=gen, device=dev)
    rwkv_forms_agree(torch, sp, cfg32, toks,
                     f"rwkv decode 8x{PROMPT} (chunks of 16)")
    toks = torch.randint(0, cfg.vocab_size, (1, RWKV_LONG + STEPS),
                         generator=gen, device=dev)
    rwkv_forms_agree(torch, sp, cfg32, toks,
                     f"rwkv decode 1x{RWKV_LONG} (chunks of 1)")

    prompts = np.random.RandomState(6).randint(
        0, cfg.vocab_size, (SERVE_SLOTS, PROMPT)).astype(np.int32)
    out = engine_graph_vs_eager(torch, dev, sp, cfg, prompts, "rwkv", card)
    check(out.shape == (SERVE_SLOTS, SERVE_NEW)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"rwkv serve: tokens {out.shape}")
    tm0 = sp["layers"][0]
    ms = cuda_ms(torch, lambda i: [tm0[m][k].dequant(torch.bfloat16)
                                   for m, k in (("tm", "w_r"), ("tm", "w_k"),
                                                ("tm", "w_v"), ("tm", "w_g"),
                                                ("tm", "w_o"), ("cm", "w_k"),
                                                ("cm", "w_v"), ("cm", "w_r"))],
                 10)
    say(f"rwkv decode: the eight projections dequantized to bf16 (every "
        f"decode step, every layer, as in JAX): {ms:.4f} ms a layer (eager "
        f"mean)")
    counts = ops.launch_counts()
    say(f"rwkv path launches (quantize + decode + serve): {counts}")
    check(all(counts[k] > 0 for k in RWKV_PATH),
          f"a kernel of the rwkv path never launched: {counts}")
    del sp, run
    return counts


# ---------------------------------------------------------------------------
# phase 14: the VLM (llama-3.2-vision-90b: gated cross-attention layers)
# ---------------------------------------------------------------------------

def check_vlm_kernels(torch, dev, kernels, results, cfg):
    """The two kernels of the VLM path at its shapes: the panel at n=1024
    / 8192 / 28672, flash at 64/8 heads (group 8), hd 128: causal self-
    attention (B=8, T=128) and the cross layers' non-causal attention over
    the 1601 image tokens, in prefill (Tq=128) and decode (Tq=1)."""
    panel, flash, qmm, paged = kernels
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    check(heads == VLM_HEADS, f"{cfg.name}: heads {heads}")
    check_panel(torch, panel, dev, results, VLM_PANEL)
    check_flash(torch, flash, dev, results, heads, ("vlm",),
                shapes=((8, PROMPT),))
    nv = cfg.cross_attn.n_vision_tokens
    check_flash(torch, flash, dev, results, heads, ("vlm",),
                shapes=((8, PROMPT, nv), (8, 1, nv)), causal=False)


def gated(torch, params, gate: float):
    """`params` with both gates of every cross layer set to `gate` (they
    are zero at init, so a cross layer starts as the identity and nothing
    downstream sees the cross-attention)."""
    cross = [{**cp, "gate_attn": torch.full_like(cp["gate_attn"], gate),
              "gate_mlp": torch.full_like(cp["gate_mlp"], gate)}
             for cp in params["groups"]["cross"]]
    return {**params, "groups": {**params["groups"], "cross": cross}}


def phase_vlm(torch, dev, ops, kernels, cfg, card):
    """The counted VLM path on `cfg` (llama-3.2-vision-90b at full width,
    one group): the launcher's quantize with 8 images of 1601 features
    (every self and cross leaf through the panel; the loss gap cannot see
    the cross layer, whose gates are zero at init), then, with the gates
    at VLM_GATE, decode from the materialized codes against the plain
    versions (JAX serves a VLM materialized: `serving_params` refuses it;
    gated in lockstep at both types, free-running printed) and the static
    Engine with the images. Returns the path's launch counts."""
    import numpy as np
    from repro_torch.core import materialize
    from repro_torch.models import BuildPlan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    ops.reset_launch_counts()
    run = quantize_counted(torch, ops, cfg, dev, "vlm")
    spg = cfg.cross_attn.every - 1
    cross = sorted(r.name for r in run.report.layers if r.layer == spg)
    say(f"vlm quantize: cross layer (index {spg}) leaves {cross}; guard "
        f"events {len(run.report.guard_events)}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    check(cross == ["cross.mlp.w_down", "cross.mlp.w_gate", "cross.mlp.w_up",
                    "cross.xattn.wo", "cross.xattn.wq"],
          f"vlm quantize: cross leaves {cross}")
    table = run.qparams["__qlayers__"]
    check(all(math.isfinite(r.err_after) for r in run.report.layers)
          and "cross_0" in table and table["cross_0"]["xattn"]["wk"].dtype
          == torch.float32, "vlm quantize: a cross leaf missing or "
          "non-finite, or xattn.wk quantized")
    ve, ev = run.vision_embeds, run.eval_tokens
    mat = gated(torch, materialize(run.qparams, cfg), VLM_GATE)
    del run, table
    decode_vs_plain(torch, ops, kernels, mat, cfg,
                    BuildPlan(prefill_cache_len=PROMPT + STEPS), ev,
                    f"vlm decode (gates {VLM_GATE})", vision_embeds=ve)
    prompts = np.random.RandomState(6).randint(
        0, cfg.vocab_size, (SERVE_SLOTS, PROMPT)).astype(np.int32)
    out = engine_graph_vs_eager(
        torch, dev, mat, cfg, prompts, f"vlm (materialized, gates "
        f"{VLM_GATE}, {ve.shape[1]} image tokens a prompt)", card,
        vision_embeds=ve)
    check(out.shape == (SERVE_SLOTS, SERVE_NEW)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"vlm serve: tokens {out.shape}")
    counts = ops.launch_counts()
    counts["flash_attention/decode"] = kernels[1].launches_single_query
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"vlm path launches (quantize + decode + serve; flash_attention/"
        f"decode: its Tq = 1 share, the cross layers' decode): {counts}; "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB, "
        f"{(peak - held) / 2 ** 30:.2f} GiB above the "
        f"{held / 2 ** 30:.2f} GiB held before the phase")
    check(all(counts[k] > 0 for k in VLM_PATH + ("flash_attention/decode",)),
          f"a kernel of the vlm path never launched: {counts}")
    del mat
    return counts


# ---------------------------------------------------------------------------
# phase 15: the encoder (vit-base-16: non-causal, from patch embeddings)
# ---------------------------------------------------------------------------

def check_encoder_kernels(torch, dev, kernels, results, cfg):
    """flash non-causal at 12/12 heads, hd 64 over 8 images of 197 tokens
    (the encoder's only kernel: its forward dequantizes every QT leaf, as
    the JAX package's does)."""
    panel, flash, qmm, paged = kernels
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    check_flash(torch, flash, dev, results, heads, ("vit",),
                shapes=((8, ENC_T, ENC_T),), causal=False)


def phase_encoder(torch, dev, ops, kernels, cfg):
    """The counted encoder path on `cfg` (vit-base-16 at full width and
    depth): logits and loss of 8 images of 197 patch embeddings (seeded),
    dense and 4-bit fake-quantized (`fake_quantize_params`, as JAX runs
    it; every QT leaf dequantized a layer at a time), each at bf16 and f32
    against the plain versions with every layer in lockstep (each layer
    from the kernel run's input, `DecodeTape`) under the precision gates,
    and free-running, printed: the 12 random-init layers amplify a
    rounding difference as the decoders' do (`tools/encoder_sensitivity.py`:
    a 1e-7 change of the input moves the f32 logits by ~0.2 of
    max|logit| with the plain versions alone). Returns the path's launch
    counts."""
    from repro_torch.core.apply import fake_quantize_params
    from repro_torch.models import BuildPlan, forward, init_params, lm_loss
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    ops.reset_launch_counts()
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    embeds = torch.randn(8, ENC_T, cfg.d_model, generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                           device=dev)
    fq = fake_quantize_params(params, cfg, BuildPlan(), bits=4)

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    for name, p in (("dense", params), ("fake-quantized 4-bit", fq)):
        for label in ("bfloat16", "float32"):
            c = cfg.replace(compute_dtype=label)

            def logits():
                return forward(p, c, BuildPlan(), None, embeds=embeds)[0]
            tape = DecodeTape(torch, tfm, moe_mod)
            with torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.time()
                with tape.mode("record"):
                    got = logits()
                torch.cuda.synchronize()
                ms = (time.time() - t0) * 1e3
                loss = float(lm_loss(p, c, BuildPlan(),
                                     {"embeds": embeds, "labels": labels})[0])
                with plain_kernels(ops, kernels):
                    free = logits()
                    with tape.mode("lockstep"):
                        lock = logits()
            top1 = float((got.argmax(-1) == free.argmax(-1)).float().mean())
            say(f"encoder {name} {label}: logits {tuple(got.shape)}, "
                f"max|logit| {float(got.abs().max()):.4f}, kernels vs plain "
                f"max|d|/max|logit|: layers in lockstep {rel(got, lock):.3e} "
                f"(tol {LOGITS_REL[label]}), free-running "
                f"{rel(got, free):.3e} (reported); top-1 agreement "
                f"free-running {top1:.3f}; loss {loss:.4f}; forward "
                f"{ms:.1f} ms wall")
            check(rel(got, lock) <= LOGITS_REL[label] and math.isfinite(loss)
                  and bool(torch.isfinite(got).all()),
                  f"encoder {name} {label}: lockstep rel {rel(got, lock)}, "
                  f"loss {loss}")
            tape.check_layers(label, f"encoder {name}")
            del tape
    counts = ops.launch_counts()
    say(f"encoder path launches (dense + fake-quantized forwards): {counts}")
    check(all(counts[k] > 0 for k in ENC_PATH),
          f"a kernel of the encoder path never launched: {counts}")
    del params, fq
    return counts


# ---------------------------------------------------------------------------
# phase 16: durability — journal, resume and fault injection
# ---------------------------------------------------------------------------

DUR_LAYERS = 3            # qwen2-7b and granite-moe-3b-a800m, depth cut
DUR_KILL = 2              # kill after layer 1: layers 0-1 journaled
DUR_MOE_POLICY, DUR_MOE_KILL = "first=8", 1
DUR_MEM_RATIO = 1.1       # supervised peak <= this x the clean run's
# Runtime.step occurrences to kill at: 12 steps into the drain (nothing
# retired yet), and 32 (the first 8 requests retired)
DUR_SERVE_KILLS = (20, 40)
CI_SMOKE = ("--arch", "qwen2-7b", "--smoke", "--bits", "4", "--method",
            "comq_blocked", "--sweeps", "2", "--calib-batch", "2",
            "--calib-seq", "48")        # ci.yml's "Quantize fault smoke"


def host_equal(a, b) -> bool:
    """Two host trees (`ckpt.to_host`) with the same structure, dtypes and
    values, bit for bit."""
    import numpy as np
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(host_equal(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def report_rows(report):
    return [(r.layer, r.name, r.err_before, r.err_after, r.guard)
            for r in report.layers]


def write_qpk(path: Path, table) -> bytes:
    from repro_torch.ckpt import pack_tree, save_packed_ckpt
    save_packed_ckpt(str(path), pack_tree(table))
    return path.read_bytes()


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def durable_quantize(torch, panel, dev, cfg, spec, kill, work, what, card,
                     full=False):
    """One configuration's quantize under phase 16's oracle: a clean run, a
    journaled uninterrupted run, and a journaled run killed at the `kill`-th
    layer end under `quantize_supervised(restarts=3)` — trees, report rows
    and .qpk bytes identical; the journal's integrity; the resumed attempt
    launching comq_panel only for the layers past the kill (as many times as
    the clean run did there). With `full` (the dense run), the peak-memory
    gate and a ckpt_write and a nan_tap fault. Prints wall times and peak
    memory."""
    import shutil
    import numpy as np
    from repro_torch.ckpt import to_host
    from repro_torch.core import quantize_model
    from repro_torch.ft import FaultInjector, InjectedFault, QuantJournal
    from repro_torch.launch.quantize import _randint, quantize_supervised
    from repro_torch.models import BuildPlan, init_params
    params = init_params(cfg, seed=0, device=dev)
    tokens = _randint(0, (8, PROMPT), cfg.vocab_size, dev)
    plan = BuildPlan()
    marks = []

    def mark(layer):
        marks.append((layer, panel.launches, time.time()))

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0, torch.cuda.max_memory_allocated()

    gib = 2.0 ** 30
    held = torch.cuda.memory_allocated()
    start = panel.launches
    (q, rep), t_clean, peak_clean = timed(lambda: quantize_model(
        params, cfg, plan, tokens, spec, method="comq_blocked",
        progress_cb=mark))
    clean = list(marks)
    ref, rows = to_host(q["__qlayers__"]), report_rows(rep)
    ref_qpk = write_qpk(work / "clean.qpk", q["__qlayers__"])
    del q, rep
    n_leaves = len(rows)

    jd = work / "journal_clean"
    (q, rep), t_journal, _ = timed(lambda: quantize_model(
        params, cfg, plan, tokens, spec, method="comq_blocked",
        journal=str(jd)))
    check(host_equal(to_host(q["__qlayers__"]), ref)
          and report_rows(rep) == rows,
          f"{what}: a journaled run differs from the clean run")
    spilled = dir_bytes(jd / "leaves")
    del q, rep
    shutil.rmtree(jd)

    marks.clear()
    jd = work / "journal_kill"
    inj = FaultInjector({"kill": [kill]})
    (q, rep), t_sup, peak_sup = timed(lambda: quantize_supervised(
        params, cfg, plan, tokens, spec, method="comq_blocked",
        journal=str(jd), restarts=3, injector=inj, progress_cb=mark))
    t_end = time.time()
    at_kill = marks[kill - 1]
    resumed_launches = marks[-1][1] - at_kill[1]
    replayed_launches = marks[2 * kill - 1][1] - at_kill[1]
    clean_after = clean[-1][1] - clean[kill - 1][1]
    same_tree = host_equal(to_host(q["__qlayers__"]), ref)
    same_rows = report_rows(rep) == rows
    same_qpk = write_qpk(work / "resumed.qpk", q["__qlayers__"]) == ref_qpk
    st = QuantJournal.replay(str(jd))
    verified = QuantJournal.check_integrity(str(jd))
    before_kill = sum(r[0] < kill for r in rows)
    say(f"{what}: clean quantize_model {t_clean:.3f} s, journaled "
        f"{t_journal:.3f} s ({(t_journal - t_clean) / cfg.n_layers:.3f} s a "
        f"layer more; {spilled / 2 ** 20:.1f} MiB of spills), killed at "
        f"layer end {kill} and resumed under run_with_restarts "
        f"{t_sup:.3f} s (resumed attempt {t_end - at_kill[2]:.3f} s); on "
        f"{card}")
    say(f"{what}: comq_panel launches clean {clean[-1][1] - start} (after "
        f"layer {kill - 1}: {clean_after}), resumed attempt "
        f"{resumed_launches} ({replayed_launches} while re-applying layers "
        f"0-{kill - 1}); faults fired {inj.fired}; resumed_leaves "
        f"{rep.resumed_leaves} of {n_leaves}; check_integrity {verified} of "
        f"{len(st.leaves)} journaled")
    say(f"{what}: peak device memory clean {peak_clean / gib:.2f} GiB, "
        f"supervised {peak_sup / gib:.2f} GiB (ratio "
        f"{peak_sup / peak_clean:.4f}; {held / gib:.2f} GiB held before the "
        f"phase); trees {same_tree}, report rows {same_rows}, .qpk bytes "
        f"{same_qpk}")
    check(same_tree and same_rows and same_qpk,
          f"{what}: the resumed run differs from the clean run (trees "
          f"{same_tree}, rows {same_rows}, .qpk {same_qpk})")
    check(st.done and verified == len(st.leaves) == n_leaves,
          f"{what}: journal integrity {verified} of {len(st.leaves)}")
    check(rep.resumed_leaves == before_kill > 0,
          f"{what}: resumed {rep.resumed_leaves} leaves, expected "
          f"{before_kill}")
    check(inj.fired == [("kill", kill)], f"{what}: faults {inj.fired}")
    check(resumed_launches == clean_after > 0 and replayed_launches == 0,
          f"{what}: the resumed attempt launched comq_panel "
          f"{resumed_launches} times ({replayed_launches} on re-applied "
          f"layers); the clean run {clean_after} past the kill")
    if full:
        check(peak_sup <= DUR_MEM_RATIO * peak_clean,
              f"{what}: supervised peak {peak_sup} > {DUR_MEM_RATIO} x the "
              f"clean run's {peak_clean}")
    del q, rep
    shutil.rmtree(jd)

    if full:
        # ckpt_write: the torn spill is never journaled; a resume completes
        jd = work / "journal_torn"
        inj = FaultInjector({"ckpt_write": [1]})
        try:
            quantize_model(params, cfg, plan, tokens, spec,
                           method="comq_blocked", journal=str(jd),
                           injector=inj)
            check(False, f"{what}: the ckpt_write fault did not fire")
        except InjectedFault:
            pass
        st = QuantJournal.replay(str(jd))
        torn = sorted(p.name for p in (jd / "leaves").glob("*.tmp"))
        check(len(torn) == 1 and not st.leaves
              and not (jd / "leaves" / torn[0][:-4]).exists(),
              f"{what}: ckpt_write left {torn}, journal {list(st.leaves)}")
        q, rep = quantize_model(params, cfg, plan, tokens, spec,
                                method="comq_blocked", journal=str(jd),
                                resume=True)
        ok = host_equal(to_host(q["__qlayers__"]), ref)
        say(f"{what}: ckpt_write:1 left {torn[0]} unjournaled; the resume "
            f"completed ({QuantJournal.check_integrity(str(jd))} leaves "
            f"verified), codes equal to the clean run: {ok}")
        check(ok, f"{what}: the run resumed after ckpt_write differs")
        del q, rep
        shutil.rmtree(jd)
        # nan_tap: a guard event, a finite run
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            q, rep = quantize_model(params, cfg, plan, tokens, spec,
                                    method="comq_blocked",
                                    injector=FaultInjector({"nan_tap": [1]}))
        kinds = sorted({(e.layer, e.name, e.kind) for e in rep.guard_events})
        finite = (all(np.isfinite(r.err_after) for r in rep.layers)
                  and all(bool(torch.isfinite(v["scale"]).all())
                          for lp in q["__qlayers__"].values()
                          for leaves in lp.values()
                          for v in leaves.values() if isinstance(v, dict)))
        say(f"{what}: nan_tap:1 guard events {kinds}; finite {finite}")
        check(("nonfinite_tap" in {k for _, _, k in kinds}) and finite,
              f"{what}: nan_tap gave {kinds}, finite {finite}")
        del q, rep
    del params, tokens
    return t_clean, t_journal, t_sup, peak_clean, peak_sup


def ci_fault_smoke(work):
    """ci.yml's "Quantize fault smoke", as CI writes it, on the card: the
    port's launcher clean and with --inject kill:2 --restarts 3 (no
    --device: both on the card); the .qpk files compared byte for byte,
    and each --out-dir step_0 restored to the .qpk's arrays."""
    import filecmp
    import os
    import numpy as np
    from repro_torch.ckpt import CheckpointManager, load_packed_ckpt
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {"ref": ("--out-dir", str(work / "q_ref"), "--save-packed",
                    str(work / "ref.qpk")),
            "fault": ("--out-dir", str(work / "q_fault"), "--journal",
                      str(work / "qjournal"), "--inject", "kill:2",
                      "--restarts", "3", "--save-packed",
                      str(work / "fault.qpk"))}
    for name, extra in runs.items():
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m",
                            "repro_torch.launch.quantize", *CI_SMOKE,
                            *extra], env=env, cwd=str(work),
                           capture_output=True, text=True, timeout=600)
        check(p.returncode == 0, f"CI fault smoke {name}: exit "
              f"{p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
        say(f"CI fault smoke {name} ({time.time() - t0:.1f} s wall): "
            f"{p.stdout.strip().splitlines()[-1]}")
    same = filecmp.cmp(work / "ref.qpk", work / "fault.qpk", shallow=False)
    say(f"CI fault smoke: cmp ref.qpk fault.qpk -> "
        f"{'identical' if same else 'DIFFER'} "
        f"({(work / 'ref.qpk').stat().st_size} bytes)")
    check(same, "CI fault smoke: the resumed .qpk differs from the clean one")
    tree = load_packed_ckpt(str(work / "ref.qpk"))["tree"]
    for d in ("q_ref", "q_fault"):
        out, _ = CheckpointManager(str(work / d)).restore(0, tree)
        check(host_equal(out, tree), f"CI fault smoke: {d}/step_0 restores "
              "to other arrays than the .qpk holds")
    say("CI fault smoke: both step_0 checkpoints restore to the .qpk arrays")


def staggered(rt, prompts, reqs, retry=()):
    """SERVE_SLOTS of `prompts` ((prompt, submit kwargs) pairs) up front,
    the rest one per step, then drained; each request is appended to
    `reqs` as it is submitted (so a killed run leaves them there). A step
    that raises one of `retry` runs again (the in-process retry of a
    transient fault). Returns the number of retried steps."""
    retried = 0

    def step():
        nonlocal retried
        while True:
            try:
                return rt.step()
            except retry:
                retried += 1

    for p, kw in prompts[:SERVE_SLOTS]:
        reqs.append(rt.submit(p, max_new_tokens=SERVE_NEW, **kw))
    for p, kw in prompts[SERVE_SLOTS:]:
        step()
        reqs.append(rt.submit(p, max_new_tokens=SERVE_NEW, **kw))
    while not rt.scheduler.idle:
        step()
    return retried


def serve_killed(torch, dev, sp, cfg, plan, prompts, jd, kill):
    """The serve launcher's supervised run on the phase-8 traffic: a
    journaled Runtime killed at its `kill`-th step, recovered through
    recover_runtime under run_with_restarts(max_restarts=2); the dead
    attempt's runtime is dropped before the next allocates. Returns
    (tokens by rid, in flight at the kill, the recovery's journal state,
    rids the recovered runtime completed, the final journal state, wall
    seconds)."""
    import gc
    from repro_torch.ft import (FaultInjector, Journal, SimulatedKill,
                                run_with_restarts)
    from repro_torch.serve import Runtime, recover_runtime
    inj = FaultInjector({"kill": [kill]})
    box = {"first": []}

    def attempt(_):
        prev = box.pop("rt", None)
        if prev is not None:
            prev.journal.close()
            del prev
            gc.collect()
        if Journal.replay(str(jd)).records:
            rt, st = recover_runtime(sp, cfg, plan, str(jd), serve_config(),
                                     injector=inj, device=dev)
            box["rt"], box["state"] = rt, st
            for p in prompts[st.max_rid + 1:]:
                rt.submit(p, max_new_tokens=SERVE_NEW)
            rt.run()
            return
        rt = Runtime(sp, cfg, plan, serve_config(), journal=Journal(str(jd)),
                     injector=inj, device=dev)
        box["rt"] = rt
        staggered(rt, [(p, {}) for p in prompts], box["first"])

    t0 = time.time()
    run_with_restarts(attempt, lambda: len(Journal.replay(str(jd)).completed),
                      max_restarts=2, exceptions=(SimulatedKill,),
                      backoff_s=0.0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    rt = box.pop("rt")
    rt.journal.close()
    check(inj.fired == [("kill", kill)], f"serve kill: faults {inj.fired}")
    final = Journal.replay(str(jd))
    tokens = {rid: final.completed_tokens(rid) for rid in final.completed}
    inflight = sum(r.state != "done" for r in box["first"])
    redone = {r.rid for r in rt.scheduler.completed}
    return tokens, inflight, box["state"], redone, final, wall


def phase_durability(torch, dev, ops, kernels, sp, cfg, prompts, smi):
    """Phase 16: the quantize walk and the paged runtime journaled,
    killed, resumed and fault-injected on the card. Returns the launch
    counts of its quantize runs plus its serve runs."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core import QuantSpec, parse_policy
    from repro_torch.ft import FaultInjector, InjectedFault
    from repro_torch.models import BuildPlan
    from repro_torch.serve import Runtime
    panel = kernels[0]
    cfg32 = cfg.replace(compute_dtype="float32")
    work = ROOT / "build" / "durability"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    say(f"durability: card {smi}")
    t_phase = time.time()
    spec = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
                     order="greedy")

    # a, b, d: the quantize walks (counted)
    ops.reset_launch_counts()
    dense = get_config("qwen2-7b").replace(n_layers=DUR_LAYERS)
    durable_quantize(torch, panel, dev, dense, spec, DUR_KILL, work,
                     "durability qwen2-7b", smi, full=True)
    moe = get_config(MOE_ARCH).replace(n_layers=DUR_LAYERS)
    durable_quantize(torch, panel, dev, moe,
                     parse_policy(DUR_MOE_POLICY, spec), DUR_MOE_KILL, work,
                     f"durability {MOE_ARCH} policy {DUR_MOE_POLICY}", smi)
    q_counts = ops.launch_counts()
    say(f"durability quantize path launches: {q_counts}")
    check(q_counts["comq_panel"] > 0 and q_counts["flash_attention"] > 0,
          f"durability: the quantize walks did not launch: {q_counts}")

    # c: the CI gate, through the launcher, on the card
    ci_fault_smoke(work)

    # e: serve (counted): kill and recover at f32, faults that do not kill
    ops.reset_launch_counts()
    plan32 = BuildPlan(cache_dtype=torch.float32)
    with torch.no_grad():
        _, ref_reqs = serve_traffic(torch, dev, sp, cfg32, plan32, prompts,
                                    serve_config(), "f32 kv_bits=0 "
                                    "uninterrupted")
        want = {r.rid: r.out_tokens for r in ref_reqs}
        for kill in DUR_SERVE_KILLS:
            tokens, inflight, st, redone, final, wall = serve_killed(
                torch, dev, sp, cfg32, plan32, prompts,
                work / f"serve_f32_{kill}", kill)
            same = sum(tokens.get(rid) == t for rid, t in want.items())
            replayed = sum(r["ev"] == "replayed" for r in final.records)
            say(f"serve f32 kill at step {kill} ({wall:.3f} s wall incl. "
                f"recovery): {len(st.completed)} retired before the kill, "
                f"{inflight} in flight, {replayed} replayed; {same}/"
                f"{len(want)} requests token-identical to the uninterrupted "
                "run")
            check(same == len(want), f"serve f32 kill at step {kill}: a "
                  "recovered request's tokens differ from the uninterrupted "
                  "run")
            check(redone == set(st.inflight)
                  and not redone & set(st.completed),
                  f"serve f32 kill at step {kill}: the recovery ran "
                  f"{sorted(redone)}, in flight {sorted(st.inflight)}")
            check(replayed == inflight == len(st.inflight) > 0,
                  f"serve f32 kill at step {kill}: replayed {replayed}, in "
                  f"flight at the kill {inflight}, journal in flight "
                  f"{len(st.inflight)}")
        check(len(st.completed) > 0, f"serve f32: nothing retired before "
              f"the kill at step {kill}")

        for spec_, label in (({"decode_step": [5]}, "decode_step:5"),
                             ({"page_alloc": [3, 7]}, "page_alloc:3+7"),
                             ({"callback": [2]}, "callback:2")):
            inj = FaultInjector(spec_)
            rt = Runtime(sp, cfg32, plan32, serve_config(), injector=inj,
                         device=dev)
            seen = {}

            def cb(r, t):
                seen[r.rid] = seen.get(r.rid, 0) + 1

            reqs = []
            retried = staggered(rt, [(p, {"stream_cb": cb})
                                     for p in prompts], reqs,
                                retry=(InjectedFault,))
            finished = sum(len(r.out_tokens) == SERVE_NEW for r in reqs)
            same = sum(r.out_tokens == want[r.rid] for r in reqs)
            errs = {r.rid: len(r.cb_errors) for r in reqs if r.cb_errors}
            short = {r.rid for r in reqs if seen.get(r.rid) != SERVE_NEW}
            say(f"serve f32 {label}: fired {inj.fired}, steps retried "
                f"{retried}, {finished}/{len(reqs)} finished, {same}/"
                f"{len(reqs)} token-identical to the uninterrupted run, "
                f"preemptions {rt.scheduler.preemptions}, callback errors "
                f"{errs}")
            check(inj.fired and finished == len(reqs),
                  f"serve f32 {label}: fired {inj.fired}, {finished} "
                  "finished")
            rt.allocator.check_integrity()
            if label != "page_alloc:3+7":      # no re-prefill: same steps
                check(same == len(reqs), f"serve f32 {label}: tokens differ")
            if label == "callback:2":
                check(len(errs) == 1 and short == set(errs),
                      f"serve f32 callback: errors {errs}, short streams "
                      f"{short}")
            del rt

        # printed, not gated: the kill run at bf16, and over int8 pages
        for label, plan in (("bf16 kv_bits=0", BuildPlan()),
                            ("bf16 kv_bits=8", BuildPlan(kv_bits=8))):
            _, refs = serve_traffic(torch, dev, sp, cfg, plan, prompts,
                                    serve_config(), f"{label} uninterrupted")
            tokens, inflight, st, _, _, wall = serve_killed(
                torch, dev, sp, cfg, plan, prompts,
                work / f"serve_{label.replace(' ', '_')}",
                DUR_SERVE_KILLS[0])
            same = sum(tokens.get(r.rid) == r.out_tokens for r in refs)
            say(f"serve {label} kill at step {DUR_SERVE_KILLS[0]} "
                f"({wall:.3f} s wall): {inflight} in flight replayed; "
                f"{same}/{len(refs)} "
                "requests token-identical to the uninterrupted run (printed)")
    s_counts = ops.launch_counts()
    say(f"durability serve path launches: {s_counts}")
    check(all(s_counts[n] > 0 for n in SERVE_PATH),
          f"durability: a kernel of the serve runs never launched: "
          f"{s_counts}")
    shutil.rmtree(work)
    say(f"durability: phase 16 took {time.time() - t_phase:.1f} s wall")
    return {n: q_counts[n] + s_counts[n] for n in q_counts}



# ---------------------------------------------------------------------------
# phase 17: observability
# ---------------------------------------------------------------------------

OBS_LAYERS = 2            # qwen2-7b depth cut for the traced walks (phase 4's)
OBS_HOOK_SLOTS = 16       # live slots in the hook microbenchmark
OBS_HOOK_REPS = 10000     # calls a timing, each from an empty tracer
OBS_BUDGET = 0.02         # hook cost / median untraced step wall (JAX's)
OBS_PROFILE_STEPS = 4
CI_OBS_QUANT = ("--arch", "qwen2-7b", "--smoke", "--bits", "4", "--sweeps",
                "1", "--calib-batch", "2", "--calib-seq", "32")
CI_OBS_SERVE = ("--arch", "qwen2-7b", "--smoke", "--engine", "paged",
                "--num-requests", "6", "--prompt-len", "24", "--max-new",
                "12", "--num-blocks", "8", "--admission", "preempt",
                "--stagger", "2", "--priorities", "0,0,1,1,2,2")
# ci.yml's "Observability smoke" (its launchers and flags, on the port)


def obs_serve(torch, dev, sp, cfg, plan, prompts, sc, **rt_kw):
    """The phase-8 traffic through one Runtime (`staggered`), each step
    timed on the host clock (a step ends in its token pull). Returns
    (runtime, requests, step walls)."""
    from repro_torch.serve import Runtime
    rt = Runtime(sp, cfg, plan, sc, device=dev, **rt_kw)
    walls, step = [], rt.step

    def timed_step():
        t0 = time.perf_counter()
        out = step()
        walls.append(time.perf_counter() - t0)
        return out

    rt.step = timed_step
    reqs = []
    staggered(rt, [(p, {}) for p in prompts], reqs)
    check(all(len(r.out_tokens) == SERVE_NEW for r in reqs),
          "obs serve: a request did not run to its length")
    return rt, reqs, walls


def check_timelines(rt, reqs, tracer, registry, what):
    """Every request's timeline rebuilds from the trace, validates and
    carries the delivered tokens; the registry's counts equal the
    runtime's. Returns the number of requests preempted and resumed."""
    from repro_torch.obs import (reconstruct_timelines, validate_timeline,
                                 validate_trace)
    check(validate_trace(tracer.to_chrome_trace()) == [],
          f"{what}: the trace fails the schema")
    tls = reconstruct_timelines(tracer.events)
    check(sorted(tls) == sorted(r.rid for r in reqs),
          f"{what}: timelines for {sorted(tls)}")
    for r in reqs:
        tl = tls[r.rid]
        probs = validate_timeline(tl)
        check(tl.complete and not probs, f"{what}: rid {r.rid}: {probs}")
        check([t for _, t in tl.tokens] == list(r.out_tokens),
              f"{what}: rid {r.rid}'s timeline tokens differ from its "
              "stream")
    snap = registry.snapshot()
    want = {"serve.tokens_emitted": sum(len(r.out_tokens) for r in reqs),
            "serve.preemptions": rt.scheduler.preemptions,
            "serve.requests_retired": len(reqs)}
    got = {k: snap[k] for k in want}
    check(got == want, f"{what}: registry {got}, runtime {want}")
    both = sum(bool(tl.preempts and tl.resumes) for tl in tls.values())
    say(f"{what}: {len(tls)} timelines valid, {both} preempted and resumed; "
        f"registry {got} == the runtime's")
    return both


def annotated_kernels(path, annotation, kernel_part):
    """From a torch.profiler Chrome trace: the kernels whose name holds
    `kernel_part`, and how many of them fall inside an `annotation` user
    annotation — by their launch's correlation id (the launch call's CPU
    time inside the annotation), or, where no launch call was recorded,
    by the kernel's own interval. Returns (kernels, by correlation, by
    interval, annotations, event categories)."""
    doc = json.loads(Path(path).read_text())
    evs = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    cats = {}
    for e in evs:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in evs if e.get("cat") == "user_annotation"
             and e.get("name") == annotation]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in evs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and kernel_part in e.get("name", "")]

    def inside(t0, t1=None):
        t1 = t0 if t1 is None else t1
        return any(a <= t0 and t1 <= b for a, b in spans)

    by_corr = by_time = 0
    for k in kernels:
        corr = k.get("args", {}).get("correlation")
        if corr in launch_ts:
            by_corr += inside(launch_ts[corr])
        else:
            by_time += inside(float(k["ts"]),
                              float(k["ts"]) + float(k.get("dur", 0)))
    return len(kernels), by_corr, by_time, len(spans), cats


def phase_observability(torch, dev, ops, kernels, sp, cfg, prompts, smi):
    """Phase 17: the quantize walk and the paged runtime traced and metered
    on the card. Returns the launch counts of (a), (b) and (d)."""
    import gc
    import shutil
    import statistics as stats
    from repro_torch.ckpt import to_host
    from repro_torch.configs import get_config
    from repro_torch.core import QuantSpec, quantize_model
    from repro_torch.launch.quantize import _randint
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serve import Runtime
    work = ROOT / "build" / "observability"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    say(f"observability: card {smi}")
    t_phase = time.time()
    ops.reset_launch_counts()

    # a: the traced walk at full width against untraced ones
    dense = get_config("qwen2-7b").replace(n_layers=OBS_LAYERS)
    params = init_params(dense, seed=0, device=dev)
    tokens = _randint(0, (8, PROMPT), dense.vocab_size, dev)
    spec = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
                     order="greedy")
    walks = []
    for traced in (False, True, True, False):
        tr, reg = ((Tracer(run="quantize"), MetricsRegistry(run="quantize"))
                   if traced else (None, None))
        torch.cuda.synchronize()
        t0 = time.time()
        q, rep = quantize_model(params, dense, BuildPlan(), tokens, spec,
                                method="comq_blocked", tracer=tr,
                                metrics=reg)
        torch.cuda.synchronize()
        walks.append((traced, time.time() - t0, to_host(q["__qlayers__"]),
                      rep, tr, reg))
        del q
    ref = walks[0][2]
    for traced, secs, tree, rep, tr, reg in walks:
        check(host_equal(tree, ref), "observability: a traced walk's QT "
              "trees differ from the untraced one's")
        walls = [r.wall_seconds for r in rep.layers]
        if not traced:
            check(all(w == 0.0 for w in walls),
                  "observability: an untraced walk measured a leaf wall")
            continue
        check(all(w > 0.0 for w in walls) and sum(walls) <= rep.wall_seconds,
              f"observability: leaf walls {sum(walls)} s, walk "
              f"{rep.wall_seconds} s")
        spans = [e for e in tr.events if e["ph"] == "X"]
        solves = [e["args"] for e in spans if e["name"] == "leaf_solve"]
        n_layer = sum(e["name"] == "layer" for e in spans)
        # one span per tap group: the spans' leaves are the report's rows
        leaves = sorted((a["layer"], nm) for a in solves
                        for nm in a["leaves"].split(","))
        check(len(solves) == 4 * OBS_LAYERS and n_layer == OBS_LAYERS
              and leaves == sorted((r.layer, r.name) for r in rep.layers),
              f"observability: {len(solves)} leaf_solve spans, {n_layer} "
              "layer spans")
        snap = reg.snapshot()
        want = {"quant.layers_done": OBS_LAYERS,
                "quant.leaves_solved": len(rep.layers),
                "quant.guard_events": len(rep.guard_events),
                "quant.resumed_leaves": rep.resumed_leaves}
        got = {k: snap[k] for k in want}
        check(got == want, f"observability: counters {got}, report {want}")
        check(all(snap[h]["count"] == len(rep.layers) for h in (
            "quant.leaf_err_after", "quant.leaf_dispatch_seconds",
            "quant.leaf_wall_seconds")), "observability: histogram counts")
    plain_s = [s for t, s, *_ in walks if not t]
    traced_s = [s for t, s, *_ in walks if t]
    rep = walks[1][3]
    say(f"observability a: qwen2-7b {OBS_LAYERS} layers, untraced walks "
        f"{[round(s, 4) for s in plain_s]} s, traced "
        f"{[round(s, 4) for s in traced_s]} s (synchronized); traced extra "
        f"a layer {(sum(traced_s) - sum(plain_s)) / (2 * OBS_LAYERS):.4f} s; "
        f"report.wall_seconds traced {rep.wall_seconds:.4f} s, leaf walls "
        f"sum {sum(r.wall_seconds for r in rep.layers):.4f} s, dispatch sum "
        f"{sum(r.dispatch_seconds for r in rep.layers):.4f} s; QT trees "
        f"identical; {4 * OBS_LAYERS} leaf_solve + {OBS_LAYERS} layer "
        "spans; counters == report")
    del walks, ref

    # b: traced serve at full width against untraced runs, in turns
    plan32 = BuildPlan(cache_dtype=torch.float32)
    cfg32 = cfg.replace(compute_dtype="float32")
    step_walls = None
    with torch.no_grad():
        for label, c, plan, sc in (
                ("bf16 kv_bits=0", cfg, BuildPlan(), serve_config()),
                ("bf16 kv_bits=8", cfg, BuildPlan(kv_bits=8), serve_config()),
                (f"f32 pool of {SMALL_POOL} pages", cfg32, plan32,
                 serve_config(num_blocks=SMALL_POOL))):
            walls = {False: [], True: []}
            ref = None
            for traced in (False, True, True, False):
                tr, reg = ((Tracer(run="serve"), MetricsRegistry(run="serve"))
                           if traced else (None, None))
                rt, reqs, w = obs_serve(torch, dev, sp, c, plan, prompts, sc,
                                        tracer=tr, metrics=reg)
                walls[traced] += w
                toks = [r.out_tokens for r in reqs]
                ref = toks if ref is None else ref
                same = sum(a == b for a, b in zip(ref, toks))
                check(same == len(reqs), f"observability: serve {label}: "
                      f"{same}/{len(reqs)} requests' tokens equal the "
                      "untraced run's")
                if not traced:
                    continue
                both = check_timelines(rt, reqs, tr, reg,
                                       f"observability b: serve {label}")
                if label.startswith("f32"):
                    check(rt.scheduler.preemptions > 0 and both > 0,
                          f"observability: the small pool preempted "
                          f"{rt.scheduler.preemptions}, resumed {both}")
                # a decode step's hooks are its span and a token event a
                # live slot (the first tokens come from the prefills):
                # what (c) replays
                slots = sum(e["args"]["slots"] for e in tr.events
                            if e["name"] == "decode_step")
                n_tok = sum(e["name"] == "token" for e in tr.events)
                check(n_tok == slots + len(reqs), f"observability: "
                      f"{n_tok} token events for {slots} slot-steps")
                del rt, reqs
            say(f"observability b: serve {label}: untraced, traced, traced, "
                f"untraced: tokens identical request for request; median "
                f"step wall untraced {stats.median(walls[False]) * 1e3:.4f} "
                f"ms, traced {stats.median(walls[True]) * 1e3:.4f} ms "
                f"({len(walls[False]) // 2} steps a run)")
            if step_walls is None:
                step_walls = walls[False]

    # c: the per-step hook sequence's cost against the untraced step, and
    # its parts
    tr, reg = Tracer(run="hooks"), MetricsRegistry(run="hooks")
    m_tok = reg.counter("serve.tokens_emitted")
    m_free = reg.gauge("serve.pool_free_blocks")
    m_occ = reg.gauge("serve.pool_live_occupancy")
    m_kvb = reg.gauge("serve.pool_kv_bytes")

    def span(i, device=True):
        with tr.span("decode_step", device=device, step=i,
                     slots=OBS_HOOK_SLOTS):
            pass

    def token_hooks(i):
        now_us = time.time() * 1e6
        for s in range(OBS_HOOK_SLOTS):
            tr.token_event(s, i, 42, now_us)
            m_tok.inc()

    def gauges(i):
        m_free.set(8)
        m_occ.set(0.5)
        m_kvb.set(123456)

    def annotated(i):
        with torch.profiler.record_function("decode_step"):
            pass

    def hooks(i):
        span(i)
        token_hooks(i)
        gauges(i)

    hooks(0)
    check(len(tr.events) == 1 + OBS_HOOK_SLOTS, "observability: the hook "
          f"replay emits {len(tr.events)} events a step")

    def per_call(fn, collect=True):
        """Seconds a call of fn, over OBS_HOOK_REPS calls from an empty
        tracer (a trace's growth makes its appends dearer) after a full
        collection (so no earlier phase's garbage is charged to it); with
        collect=False, with Python's cyclic collector off."""
        nonlocal tr
        tr = Tracer(run="hooks")
        gc.collect()
        if not collect:
            gc.disable()
        try:
            t0 = time.perf_counter()
            for i in range(OBS_HOOK_REPS):
                fn(i)
            return (time.perf_counter() - t0) / OBS_HOOK_REPS
        finally:
            gc.enable()

    hook_s = per_call(hooks)
    parts = {"span (device=True)": per_call(span),
             "span (device=False)": per_call(lambda i: span(i, False)),
             "record_function (entered under a profiler only)":
                 per_call(lambda i: annotated(i)),
             f"{OBS_HOOK_SLOTS} token_events": per_call(token_hooks),
             "3 gauges": per_call(gauges),
             "all, cyclic collector off": per_call(hooks, collect=False)}
    med = stats.median(step_walls)
    share = hook_s / med
    say(f"observability c: hook sequence ({OBS_HOOK_SLOTS} slots, the span "
        f"(device=True: record_function entered only under a profiler, "
        f"none here), {OBS_HOOK_SLOTS} token_events, 3 gauges) "
        f"{hook_s * 1e6:.3f} us a step (parts: "
        + ", ".join(f"{k} {v * 1e6:.3f} us" for k, v in parts.items())
        + f"); median untraced step wall {med * 1e3:.4f} ms (bf16 "
        f"kv_bits=0, {len(step_walls)} steps); share {share:.5f} (budget "
        f"{OBS_BUDGET})")
    check(share < OBS_BUDGET, f"observability: hooks cost {share:.4f} of a "
          f"step, over the {OBS_BUDGET} budget")
    del tr, reg

    # d: the device bridge under torch.profiler
    from torch.profiler import ProfilerActivity, profile
    one = dense.replace(n_layers=1)
    p1 = dict(params, layers=params["layers"][:1])
    rt = Runtime(sp, cfg, BuildPlan(), serve_config(), device=dev,
                 tracer=Tracer(run="profile"))
    with torch.no_grad():
        for p in prompts[:SERVE_SLOTS]:
            rt.submit(p, max_new_tokens=SERVE_NEW)
        rt.step()                   # the admissions' prefills
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            quantize_model(p1, one, BuildPlan(), tokens, spec,
                           method="comq_blocked", tracer=Tracer(run="p"))
            for _ in range(OBS_PROFILE_STEPS):
                rt.step()
            torch.cuda.synchronize()
    path = work / "profile.trace.json"
    prof.export_chrome_trace(str(path))
    del rt, p1
    found = {}
    for ann, part in (("leaf_solve", "comq_panel"),
                      ("decode_step", "paged_")):
        n, by_corr, by_time, n_ann, cats = annotated_kernels(path, ann, part)
        found[ann] = by_corr + by_time
        say(f"observability d: {n_ann} {ann} annotations; {n} {part}* "
            f"kernels, {by_corr} inside one by launch correlation, "
            f"{by_time} by kernel interval")
        check(n_ann > 0 and found[ann] > 0, f"observability: no {part} "
              f"kernel inside a {ann} annotation (trace categories {cats})")
    dev_us = {e.key: e.device_time_total for e in prof.key_averages()
              if "comq_panel" in e.key or "paged_" in e.key}
    say(f"observability d: profiler device time by kernel (us) {dev_us}")
    counts = ops.launch_counts()
    say(f"observability path launches: {counts}")
    check(all(counts[n] > 0 for n in INFER_KERNELS),
          f"observability: a kernel of the traced path never launched: "
          f"{counts}")

    # e: ci.yml's Observability smoke through the port's launchers
    import glob
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*argv, what):
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m", *argv], env=env,
                           cwd=str(work), capture_output=True, text=True,
                           timeout=600)
        check(p.returncode == 0, f"CI obs smoke {what}: exit {p.returncode}"
              f"\n{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
        lines = p.stdout.strip().splitlines()
        say(f"CI obs smoke {what} ({time.time() - t0:.1f} s wall): "
            f"{lines[-1] if lines else ''}")
        return p.stdout

    q, s = work / "obs_q", work / "obs_s"
    run("repro_torch.launch.quantize", *CI_OBS_QUANT, "--out-dir",
        str(q / "ckpt"), "--trace", str(q / "trace"), "--metrics",
        str(q / "metrics"), what="quantize")
    run("repro_torch.launch.serve", *CI_OBS_SERVE, "--trace",
        str(s / "trace"), "--metrics", str(s / "metrics"), what="serve")
    run("repro_torch.obs.validate",
        *sorted(glob.glob(str(q / "trace" / "*.trace.json"))),
        what="validate quantize trace")
    out = run("repro_torch.obs.validate", "--timelines", "--require-preempt",
              *sorted(glob.glob(str(s / "trace" / "*.trace.json"))),
              what="validate --timelines --require-preempt")
    say(f"CI obs smoke: {out.strip().splitlines()[-1]}")
    for f in (q / "metrics" / "metrics.jsonl", s / "metrics" / "metrics.prom"):
        check(f.is_file() and f.stat().st_size > 0,
              f"CI obs smoke: {f.name} empty or missing")
    rep_out = run("repro_torch.obs.report", str(s / "trace"),
                  what="report")
    check("== requests ==" in rep_out, "CI obs smoke: the report has no "
          "requests section")
    shutil.rmtree(work)
    say(f"observability: phase 17 took {time.time() - t_phase:.1f} s wall")
    return counts


# ---------------------------------------------------------------------------
# phase 18: distribution (SPMD worlds under torch.distributed.run)
# ---------------------------------------------------------------------------

DIST_LAYERS = 2           # the sharded runtime serves phase 4's 2-layer qwen
# the sharded walks' depth (qwen2-7b and granite-moe-3b-a800m): one layer
# holds every tap group's leaf shapes (cut from 2 for the script's time)
DIST_WALK_LAYERS = 1
DIST_ERR_REL = 0.02       # JAX's Σ err_after gate (tests/test_dist.py)
DIST_TIMEOUT = 900        # seconds a world may take
# a qwen rank: 6.2 GB of f32 weights, 1.9 GB of eval copy, codes, the
# 18944^2 Gram and its permuted copy (1.44 GB each), eval logits
DIST_PEAK_PREDICTED_GIB = 14.0


def dist_tap_bytes(cfg) -> int:
    """Σ m²·4 over one dense walk's tap Grams: attn_in, wo_in, mlp_in,
    down_in a layer."""
    hd = cfg.resolved_head_dim
    return 4 * cfg.n_layers * (2 * cfg.d_model ** 2
                               + (cfg.n_heads * hd) ** 2 + cfg.d_ff ** 2)


def dist_leaves(torch, qa, qb):
    """{leaf: (code agreement, codes, z_lo and scales all bit-equal)}
    between two quantize_model outputs."""
    out = {}
    for l, lp in qb["__qlayers__"].items():
        for mod, leaves in lp.items():
            if not isinstance(leaves, dict):
                continue
            for leaf, b in leaves.items():
                if not isinstance(b, dict) or not b.get("__qtensor__"):
                    continue
                a = qa["__qlayers__"][l][mod][leaf]
                agree = float((a["codes"].cpu() == b["codes"].cpu())
                              .float().mean())
                same = all(torch.equal(a[k].cpu(), b[k].cpu())
                           for k in ("codes", "z_lo", "scale"))
                out[f"{l}.{mod}.{leaf}"] = (agree, same)
    return out


def dist_quantize(torch, dev, cfg, mesh, ops, res, key, **kw):
    """quantize_and_eval on this rank (comq_blocked, calibration
    8 x PROMPT, phase 4's spec) with a metrics registry; with a mesh its
    launches add to res["counts"]. Returns the run."""
    from repro_torch.launch.quantize import quantize_and_eval
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    run = quantize_and_eval(cfg, method="comq_blocked", calib_batch=8,
                            calib_seq=PROMPT, device=dev, mesh=mesh,
                            metrics=reg, **kw)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if mesh is not None:
        for n, v in ops.launch_counts().items():
            res["counts"][n] = res["counts"].get(n, 0) + v
    res[key] = {"walk_s": run.seconds, "wall_s": wall, "peak_gib": peak,
                "s_per_layer": run.seconds / cfg.n_layers,
                "summary": run.summary,
                "err_after": sum(r.err_after for r in run.report.layers),
                "bytes": reg.counter("dist.bytes_all_reduced").value,
                "launches": ops.launch_counts()}
    return run


def dist_control(torch, cfg, run, ref, ndata: int, tp: int):
    """Layer 0's attn_in leaves computed on this rank alone as a (ndata,
    tp) mesh computes them, with no collective: the Gram the sum of the
    ndata batch slices' Grams in rank order, each leaf solved column slice
    by column slice as the tp model ranks solve it (JAX's pad, the visit
    order of the whole W). Returns {leaf: (bit-equal to the sharded walk's
    leaf, code agreement with the meshless walk's)}: how far the summation
    order alone moves the codes."""
    import torch.nn.functional as F

    from repro_torch.core.calibrate import gram_from_tap
    from repro_torch.core.comq_hessian import shared_order
    from repro_torch.core.pipeline import _w2d, make_qtensor
    from repro_torch.dist.calibrate import _local_solve
    from repro_torch.dist.sharding import column_slice
    from repro_torch.models import BuildPlan, embed_tokens
    from repro_torch.models.transformer import layer_full
    lp = ref.params["layers"][0]
    out = {}
    with torch.no_grad():
        x = embed_tokens(ref.params, cfg, BuildPlan(), ref.calib_tokens)
        h = None
        for part in x.chunk(ndata):
            taps = {}
            layer_full(lp, part, cfg, BuildPlan(), False, taps=taps)
            g = gram_from_tap(taps["attn_in"])
            h = g if h is None else h + g
        for leaf in ("wq", "wk", "wv"):
            w = lp["attn"][leaf]
            w2d = _w2d(w, h.shape[0]).float()
            n = w2d.shape[1]
            perm = shared_order(h, w2d, run.spec)
            parts = []
            for r in range(tp):
                lo, hi, n_pad = column_slice(n, r, tp)
                wp = F.pad(w2d, (0, n_pad - n))
                parts.append(_local_solve(h, wp[:, lo:hi].contiguous(), perm,
                                          run.spec, "comq_blocked", 256))
            q, delta, z_lo = (torch.cat([p[i] for p in parts], -1)[..., :n]
                              for i in range(3))
            qt = make_qtensor(q, delta, z_lo, w.shape, bits=run.spec.bits)
            sh = run.qparams["__qlayers__"]["0"]["attn"][leaf]
            me = ref.qparams["__qlayers__"]["0"]["attn"][leaf]
            out[f"0.attn.{leaf}"] = (
                all(torch.equal(qt[k].cpu(), sh[k].cpu())
                    for k in ("codes", "z_lo", "scale")),
                float((qt["codes"].cpu() == me["codes"].cpu())
                      .float().mean()))
    return out


def dist_gates(torch, cfg, run, ref, res, key, ndata: int, tp: int):
    """The gates of a sharded walk against the meshless one: JAX's Σ
    err_after (2%) and loss gap, and then
    - a model-sharded walk (ndata 1): every leaf bit for bit the meshless
      walk's (codes, z_lo, scales; JAX's tests/test_dist.py:416), since a
      rank solves its columns over the solver's fixed column tiles;
    - a walk over a data axis: layer 0's attn_in leaves bit for bit those
      of `dist_control`. Per-leaf code agreement with the meshless walk
      (JAX's > 0.99 at smoke size) is recorded beside the control's: with
      1024 calibration tokens against 3584 or 18944 columns every Gram is
      rank-deficient, and the Gram's summation order alone moves codes."""
    leaves = dist_leaves(torch, run.qparams, ref.qparams)
    e, e0 = res[key]["err_after"], res[key + "_single"]["err_after"]
    s = run.summary
    res[key]["leaves"] = leaves
    res[key]["worst_agreement"] = min(a for a, _ in leaves.values())
    res[key]["err_rel"] = abs(e - e0) / e0
    res[key]["loss_gap"] = abs(s["quant_loss"] - s["fp_loss"])
    if ndata == 1:
        res[key]["control"] = {}
        exact = len(leaves) > 0 and all(same for _, same in leaves.values())
    else:
        control = dist_control(torch, cfg, run, ref, ndata, tp)
        res[key]["control"] = control
        exact = all(same for same, _ in control.values())
    res[key]["gates"] = (res[key]["err_rel"] < DIST_ERR_REL
                         and res[key]["loss_gap"] <= LOSS_GAP and exact)


def dist_walk(torch, dev, dist, cfg, mesh, ops, res, key, ndata: int,
              tp: int, keep_params: bool = False, between=None):
    """A sharded walk on every rank, then `between()`, then on rank 0 the
    meshless walk and `dist_gates`. The sharded run is cut to its codes
    (and, with keep_params, its params) before the meshless run, so that
    rank 0 holds one model at a time. Returns the cut run."""
    import gc
    from types import SimpleNamespace
    run = dist_quantize(torch, dev, cfg, mesh, ops, res, key)
    if between is not None:
        between()
    table = torch.utils._pytree.tree_map(
        lambda a: a.cpu() if isinstance(a, torch.Tensor) else a,
        run.qparams["__qlayers__"])
    cut = SimpleNamespace(qparams={"__qlayers__": table},
                          summary=run.summary, spec=run.spec,
                          calib_tokens=run.calib_tokens,
                          params=run.params if keep_params else None)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        ref = dist_quantize(torch, dev, cfg, None, ops, res, key + "_single")
        dist_gates(torch, cfg, cut, ref, res, key, ndata, tp)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return cut


def dist_compressed(torch, dev, dist, res, key):
    """compressed_all_reduce over the world on seeded leaves: the mean, the
    carried residual, and the exact mean and grid step for the gates."""
    from repro_torch.dist import compressed_all_reduce, init_error_state
    r, n = dist.get_rank(), dist.get_world_size()
    gen = torch.Generator(device=dev).manual_seed(100 + r)
    g = {"w": torch.randn(4096, 512, generator=gen, device=dev),
         "b": torch.randn(4096, generator=gen, device=dev) * 1e-3}
    out, new_e = compressed_all_reduce(g, init_error_state(g))
    row = {}
    for k in g:
        parts = [torch.empty_like(g[k]) for _ in range(n)]
        dist.all_gather(parts, g[k])
        exact = torch.stack(parts).mean(dim=0)
        # the shared grid, as the all-reduce derives it (f32 on the card)
        amax = torch.stack([p.abs().max() for p in parts]).max()
        scale = torch.clamp(amax / 127.0, min=1e-30)
        q = torch.clamp(torch.round(g[k] / scale), -127.0, 127.0)
        row[k] = {"identity": float((out[k] + new_e[k] - g[k]).abs().max()),
                  "g_max": float(g[k].abs().max()),
                  "mean_err": float((out[k] - exact).abs().max()),
                  "step": float(scale),
                  "residual_exact": bool(torch.equal(new_e[k],
                                                     g[k] - q * scale))}
    res[key] = row


def dist_gram_allreduce(torch, dev, dist, res):
    """Seconds of one gloo all-reduce of an 18944² f32 Gram on the card
    (gloo copies it through host memory)."""
    h = torch.ones(18944, 18944, device=dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.time()
        dist.all_reduce(h)
        torch.cuda.synchronize(dev)
        times.append(time.time() - t0)
    res["gram_allreduce_s"] = times
    del h


def dist_serve(torch, dev, dist, ops, res, qpk):
    """(e) Runtime(mesh=) over the model axis on phase 4's packed model
    from its .qpk: the phase-8 traffic at f32 kv 0 and 8 (tokens against
    the meshless runtime's, on rank 0), then bf16 kv 4; paged launches
    counted, and the collectives by `analysis.census`: those inside
    decode_step (under its record_function scope) and the token gathers."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.census import Census
    from repro_torch.ckpt.quantized import load_packed_ckpt, unpack_tree
    from repro_torch.configs import get_config
    from repro_torch.core.apply import serving_params
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.serve import Runtime
    from repro_torch.serve import runtime as rt_mod
    cfg = get_config("qwen2-7b").replace(n_layers=DIST_LAYERS)
    params = init_params(cfg, seed=0, device=dev)
    table = unpack_tree(torch.utils._pytree.tree_map(
        lambda a: torch.as_tensor(a, device=dev)
        if isinstance(a, np.ndarray) else a, load_packed_ckpt(qpk)["tree"]))
    sp = serving_params({**params, "__qlayers__": table}, cfg)
    del params, table
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("model",))
    prompts = serve_prompts(cfg.vocab_size)
    orig = rt_mod.decode_step_paged

    def step(*a, **k):
        with torch.profiler.record_function("decode_step_paged"):
            return orig(*a, **k)

    rt_mod.decode_step_paged = step
    out = {}
    try:
        for label, c, plan in (
                ("f32 kv_bits=0", cfg.replace(compute_dtype="float32"),
                 BuildPlan(cache_dtype=torch.float32)),
                ("f32 kv_bits=8", cfg.replace(compute_dtype="float32"),
                 BuildPlan(cache_dtype=torch.float32, kv_bits=8)),
                ("bf16 kv_bits=4", cfg, BuildPlan(kv_bits=4))):
            toks = {}
            for tag, m in (("mesh", mesh), ("single", None)):
                if tag == "single" and dist.get_rank() != 0:
                    continue
                rt = Runtime(sp, c, plan, serve_config(), device=dev,
                             mesh=m)
                ops.reset_launch_counts()
                t0 = time.time()
                with Census() as census:
                    reqs = [rt.submit(p, max_new_tokens=SERVE_NEW)
                            for p in prompts[:SERVE_SLOTS]]
                    for p in prompts[SERVE_SLOTS:]:
                        rt.step()
                        reqs.append(rt.submit(p, max_new_tokens=SERVE_NEW))
                    rt.run()
                wall = time.time() - t0
                toks[tag] = [list(r.out_tokens) for r in reqs]
                if tag == "mesh":
                    counts = ops.launch_counts()
                    for n, v in counts.items():
                        res["counts"][n] = res["counts"].get(n, 0) + v
                    out[label] = {"wall_s": wall, "steps": rt.steps,
                                  "in_step": sum(census.within(
                                      "decode_step_paged").values()),
                                  "gathers": census.counts.get("all_gather",
                                                               0),
                                  "launches": counts,
                                  "pool_blocks": int(rt.pool["k"].shape[1])}
            out[label]["tokens"] = toks["mesh"]
            if "single" in toks:
                out[label]["equal"] = sum(
                    a == b for a, b in zip(toks["mesh"], toks["single"]))
    finally:
        rt_mod.decode_step_paged = orig
    res["serve"] = out


def dist_worker(task: str, out_dir: str, backend: str, qpk: str) -> int:
    """One rank of a phase-18 world (`chip_smoke.py --dist-worker TASK
    OUT_DIR BACKEND QPK` under torch.distributed.run): runs TASK and writes
    this rank's numbers to OUT_DIR/rank{R}.json."""
    import faulthandler

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import dist as rd
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.quantize import set_precision
    # a rank still running near the world's limit prints every thread's
    # stack to its log and exits, so a stuck world ends with the reason
    faulthandler.dump_traceback_later(DIST_TIMEOUT - 60, exit=True)
    set_precision()
    dev, started = rd.init_world(backend, timeout_s=DIST_TIMEOUT)
    r = dist.get_rank()
    res = {"rank": r, "world": dist.get_world_size(), "backend": backend,
           "counts": {}}
    qwen = get_config("qwen2-7b").replace(n_layers=DIST_WALK_LAYERS)
    if task == "world1":
        # (a) --shard-data --shard-solve 1 on a world of one, then meshless
        mesh = rd.calib_mesh(model=1)
        a = dist_quantize(torch, dev, qwen, mesh, ops, res, "a",
                          save_packed=str(Path(out_dir) / "mesh.qpk"))
        del a
        dist_quantize(torch, dev, qwen, None, ops, res, "a_single",
                      save_packed=str(Path(out_dir) / "single.qpk"))
        res["a"]["qpk_equal"] = ((Path(out_dir) / "mesh.qpk").read_bytes()
                                 == (Path(out_dir) / "single.qpk")
                                 .read_bytes())
        res["a"]["expected_bytes"] = dist_tap_bytes(qwen)
        dist_compressed(torch, dev, dist, res, "f")
    elif task == "world2":
        dist_gram_allreduce(torch, dev, dist, res)
        # (b) model 2: the column-sharded walk against the meshless one
        mesh = rd.calib_mesh(model=2, data=1)
        dist_walk(torch, dev, dist, qwen, mesh, ops, res, "b", 1, 2)
        # (c) data 2: one all-reduce a tap Gram, by the collective census
        from repro_torch.analysis.census import Census
        mesh = rd.calib_mesh(model=1, data=2)
        with Census() as census:
            dist_walk(torch, dev, dist, qwen, mesh, ops, res, "c", 2, 1)
        res["c"]["all_reduces"] = census.counts.get("all_reduce", 0)
        res["c"]["census"] = census.counts
        res["c"]["taps"] = 4 * qwen.n_layers
        dist_serve(torch, dev, dist, ops, res, qpk)
        dist_compressed(torch, dev, dist, res, "f")
    elif task == "world4":
        from repro_torch.models import moe as moe_mod
        mesh = rd.calib_mesh(model=2)           # (2, 2)
        dist_walk(torch, dev, dist, qwen, mesh, ops, res, "d", 2, 2)
        kept = []
        orig = moe_mod.slots_for

        def recording(ids, e_pad, capacity, offset=None):
            pos, slot = orig(ids, e_pad, capacity, offset)
            kept.append({"kept": (pos < capacity).cpu().numpy().tolist(),
                         "ids": ids.cpu().numpy().tolist(),
                         "e_pad": e_pad, "capacity": capacity})
            return pos, slot

        moe_mod.slots_for = recording
        moe = get_config(MOE_ARCH).replace(n_layers=DIST_WALK_LAYERS)
        # the walk routes once a layer; the eval forwards after it route
        # the whole eval batch on every rank, and then rank 0's meshless
        # walk routes once a layer again
        def walk_routes():
            res["d_moe"]["kept"] = kept[:moe.n_layers]
            del kept[:]

        run = dist_walk(torch, dev, dist, moe, mesh, ops, res, "d_moe", 2, 2,
                        keep_params=True, between=walk_routes)
        if r == 0:
            res["d_moe_single"] = {**res["d_moe_single"],
                                   "kept": kept[:moe.n_layers]}
        # global routing where capacity binds: layer 0's experts on the same
        # inputs (the calibration batch's embeddings, this rank's slice)
        # at a capacity factor of 0.75, against one rank routing them all
        import dataclasses

        from repro_torch.dist import axis_group, axis_size, shard_batch
        from repro_torch.models import BuildPlan, embed_tokens
        tight = moe.replace(moe=dataclasses.replace(moe.moe,
                                                    capacity_factor=0.75))
        with torch.no_grad():
            x = embed_tokens(run.params, tight, BuildPlan(),
                             run.calib_tokens)
            p0 = run.params["layers"][0]["moe"]
            ndata = axis_size(mesh, "data")
            moe_mod.apply_moe(p0, shard_batch(mesh, x), tight,
                              moe.moe.n_experts, taps={},
                              capacity_multiple=ndata,
                              group=axis_group(mesh, "data"))
            res["d_route"] = kept[-1:]
            if r == 0:
                moe_mod.apply_moe(p0, x, tight, moe.moe.n_experts, taps={},
                                  capacity_multiple=ndata)
                res["d_route_single"] = kept[-1:]
        moe_mod.slots_for = orig
        del run
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with open(Path(out_dir) / f"rank{r}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    rd.close_world(started)
    return 0


def dist_agreement(row, what: str) -> None:
    """Print a data-sharded walk's per-leaf code agreement with the
    meshless walk, and layer 0's attn_in control (the summation order
    alone, no distribution)."""
    say(f"  {what}: per-leaf code agreement with the meshless walk "
        + ", ".join(f"{k} {a:.4f}" for k, (a, _) in
                    sorted(row["leaves"].items())))
    say(f"  {what}: layer 0 attn_in computed on one rank as the mesh "
        f"computes it: "
        + ", ".join(f"{k} bit-equal to the sharded walk's {same}, agreement "
                    f"with the meshless walk {a:.4f}"
                    for k, (same, a) in sorted(row["control"].items())))


def dist_world(task: str, n: int, backend: str, qpk: Path, work: Path):
    """Run one phase-18 world of n ranks; returns their results, rank order."""
    import os
    out = work / task
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # the ranks share the card: segments that grow in place keep what each
    # holds close to what it uses
    env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.time()
    logs = work / f"{task}_logs"
    # a session of its own, so that a world past its time limit is ended
    # whole (the agent and its ranks), not only the agent
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "--log-dir", str(logs), "--redirects", "3",
         str(ROOT / "chip_smoke.py"), "--dist-worker", task, str(out),
         backend, str(qpk)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        _, stderr = proc.communicate(timeout=DIST_TIMEOUT)
        code = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        _, stderr = proc.communicate()
        code = f"nothing: ended past its {DIST_TIMEOUT} s limit"
    wall = time.time() - t0
    if code != 0:
        say(stderr[-3000:])
        for err in sorted(logs.rglob("*.log")):
            lines = [ln for ln in err.read_text().splitlines()
                     if "socket.cpp" not in ln]
            say(f"--- {err.relative_to(logs)} ---")
            say("\n".join(lines[-40:]))
    check(code == 0, f"distribution world {task} ({n} ranks, {backend}) "
          f"exited {code}")
    say(f"distribution world {task}: {n} ranks over {backend}, {wall:.1f} s "
        "wall incl. process start")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(n)]


def phase_distribution(torch, ops, qpk: Path, card: str):
    """Phase 18: three SPMD worlds on the card (torch.distributed.run): a
    world of one over nccl (a, f), two ranks over gloo sharing the card
    (b, c, e, f), four over gloo (d). Returns the ranks' launch counts."""
    import gc
    import tempfile

    import numpy as np

    from repro_torch.kernels import quant_matmul
    # this process runs no kernel from here on: drop quant_matmul's
    # split-K workspaces and the earlier phases' reference cycles, and
    # hand the cached blocks back to the card for the ranks
    quant_matmul._WORKSPACE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    tensors = [t for t in gc.get_objects()
               if isinstance(t, torch.Tensor) and t.is_cuda]
    live = sorted((t.numel() * t.element_size(), tuple(t.shape))
                  for t in tensors)
    for t in sorted(tensors, key=lambda t: -t.numel())[:2]:
        held = [sorted(map(str, r))[:6] if isinstance(r, dict)
                else type(r).__name__ for r in gc.get_referrers(t)
                if r is not tensors]
        say(f"distribution: {tuple(t.shape)} held by {held}")
    del tensors
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    say(f"distribution: predicted peak per qwen rank <= "
        f"{DIST_PEAK_PREDICTED_GIB} GiB; this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, reserves "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB, its largest "
        f"live tensors {[(round(b / 2 ** 30, 2), sh) for b, sh in live[-4:]]}"
        f" ({card})")
    counts = {}

    def add(ranks):
        for r in ranks:
            for n, v in r["counts"].items():
                counts[n] = counts.get(n, 0) + v
            say(f"distribution {r['backend']} rank {r['rank']}/{r['world']}:"
                f" peak {r['peak_gib']:.2f} GiB ({card})")

    # (a) and (f) on nccl, a world of one
    w1 = dist_world("world1", 1, "nccl", qpk, work)
    add(w1)
    a, a1 = w1[0]["a"], w1[0]["a_single"]
    say(f"distribution (a) nccl world 1, mesh (1, 1): .qpk equal to the "
        f"meshless run's: {a['qpk_equal']}; dist.bytes_all_reduced "
        f"{a['bytes']:.0f} (expected {a['expected_bytes']}); walk "
        f"{a['walk_s']:.3f} s vs meshless {a1['walk_s']:.3f} s ({card})")
    check(a["qpk_equal"], "(a) the world-of-one .qpk differs from the "
          "meshless run's")
    check(a["bytes"] == a["expected_bytes"],
          f"(a) dist.bytes_all_reduced {a['bytes']} != "
          f"{a['expected_bytes']}")
    for k, row in w1[0]["f"].items():
        say(f"distribution (f) nccl world 1, leaf {k}: max|out + new_e - g| "
            f"{row['identity']:.3e} (max|g| {row['g_max']:.3e})")
        check(row["identity"] <= 1e-6 * max(row["g_max"], 1e-30),
              f"(f) out + new_e != g on one rank: {row}")

    # (b), (c), (e), (f) on gloo, two ranks sharing the card
    w2 = dist_world("world2", 2, "gloo", qpk, work)
    add(w2)
    times = ", ".join(f"{t:.3f}" for t in w2[0]["gram_allreduce_s"])
    say(f"distribution gloo all-reduce of one 18944^2 f32 Gram (1.44 GB, "
        f"through host memory): {times} s ({card})")
    b, b1 = w2[0]["b"], w2[0]["b_single"]
    leaves = b["leaves"]
    same = sum(s for _, s in leaves.values())
    ranks = ", ".join(f"rank {r['rank']} {r['b']['walk_s']:.3f} s, peak "
                      f"{r['b']['peak_gib']:.2f} GiB" for r in w2)
    say(f"distribution (b) gloo world 2, model 2: {same}/{len(leaves)} "
        f"leaves bit-identical (codes, z_lo, scales) to the one-rank walk "
        f"(gated: every leaf; each rank solves only its own 128-column "
        f"tiles), worst code agreement {b['worst_agreement']:.6f}, err_after "
        f"rel {b['err_rel']:.3e}, |quant_loss - fp_loss| "
        f"{b['loss_gap']:.4f}; walk {ranks} vs meshless {b1['walk_s']:.3f} "
        f"s, peak {b1['peak_gib']:.2f} GiB ({card})")
    check(b["gates"], f"(b) the column-sharded walk fails its gates: err "
          f"rel {b['err_rel']}, loss gap {b['loss_gap']}, "
          f"{len(leaves) - same} of {len(leaves)} leaves differ from the "
          f"one-rank walk's: "
          f"{sorted(k for k, (_, s) in leaves.items() if not s)}")
    c, c1 = w2[0]["c"], w2[0]["c_single"]
    say(f"distribution (c) gloo world 2, data 2: worst code agreement "
        f"{c['worst_agreement']:.6f} (printed, not gated), err_after rel "
        f"{c['err_rel']:.3e}, "
        f"|quant_loss - fp_loss| {c['loss_gap']:.4f}, all-reduces "
        f"{c['all_reduces']} for {c['taps']} tap Grams (census "
        f"{c['census']}), bytes "
        f"{c['bytes']:.0f}; walk {c['s_per_layer']:.3f} s a layer vs "
        f"meshless {c1['s_per_layer']:.3f} ({card})")
    dist_agreement(c, "(c) qwen2-7b")
    check(c["gates"], f"(c) the data-sharded walk fails its gates: err rel "
          f"{c['err_rel']}, loss gap {c['loss_gap']}, control "
          f"{c['control']}")
    check(all(r["c"]["all_reduces"] == r["c"]["taps"] for r in w2),
          "(c) not one all-reduce per tap Gram")
    serve = w2[0]["serve"]
    for label, row in serve.items():
        say(f"distribution (e) Runtime(mesh=) model 2, {label}: "
            f"{row.get('equal', '-')}/{len(row['tokens'])} requests equal "
            f"the meshless runtime's; {row['steps']} steps in "
            f"{row['wall_s']:.3f} s; collectives inside decode_step "
            f"{row['in_step']}, token gathers {row['gathers']}; rank 0 "
            f"launches {row['launches']}; pages a rank {row['pool_blocks']}"
            f" ({card})")
        if label == "bf16 kv_bits=4":
            say(f"  (e) bf16 kv_bits=4 tokens, first 2 requests: "
                f"{row['tokens'][:2]}")
    for r in w2:
        for label, row in r["serve"].items():
            check(row["in_step"] == 0, f"(e) rank {r['rank']} {label}: "
                  f"{row['in_step']} collectives inside decode_step")
            check(row["launches"]["paged_attention"]
                  + row["launches"]["paged_attention_quant"] > 0,
                  f"(e) rank {r['rank']} {label}: no paged launch")
            check(row["tokens"] == serve[label]["tokens"],
                  f"(e) {label}: ranks disagree on the tokens")
    for label in ("f32 kv_bits=0", "f32 kv_bits=8"):
        check(serve[label]["equal"] == SERVE_REQS,
              f"(e) {label}: {serve[label]['equal']}/{SERVE_REQS} requests "
              "equal the meshless runtime's")
    for r in w2:
        for k, row in r["f"].items():
            check(row["mean_err"] <= row["step"] and row["residual_exact"],
                  f"(f) gloo world 2 rank {r['rank']} leaf {k}: {row}")
    steps = max(r["f"][k]["mean_err"] / r["f"][k]["step"]
                for r in w2 for k in r["f"])
    say(f"distribution (f) gloo world 2: mean within {steps:.3f} grid steps "
        "of the exact mean; residuals v - q*scale exact")

    # (d) gloo, four ranks on a (2, 2) mesh
    w4 = dist_world("world4", 4, "gloo", qpk, work)
    add(w4)
    for key, what in (("d", "qwen2-7b"), ("d_moe", MOE_ARCH)):
        d, d1 = w4[0][key], w4[0][key + "_single"]
        dist_agreement(d, f"(d) {what}")
        say(f"distribution (d) gloo world 4, mesh (2, 2), {what}: worst code "
            f"agreement {d['worst_agreement']:.6f} (printed, not gated), "
            f"err_after rel "
            f"{d['err_rel']:.3e}, |quant_loss - fp_loss| "
            f"{d['loss_gap']:.4f}; walk {d['s_per_layer']:.3f} s a layer vs "
            f"meshless {d1['s_per_layer']:.3f} ({card})")
        check(d["gates"], f"(d) {what} fails its gates: err rel "
              f"{d['err_rel']}, loss gap {d['loss_gap']}, control "
              f"{d['control']}")
    # data rank 0 is world ranks 0-1, data rank 1 ranks 2-3; each routing
    # call's masks and ids side by side in token order
    from repro_torch.models.moe import slots_for
    single = w4[0]["d_moe_single"]["kept"] + w4[0]["d_route_single"]
    sharded = w4[0]["d_moe"]["kept"] + w4[0]["d_route"]
    others = w4[2]["d_moe"]["kept"] + w4[2]["d_route"]
    check(len(sharded) == len(single) > 1, "(d) no MoE routing recorded")
    for layer, (a, b, want) in enumerate(zip(sharded, others, single)):
        if layer == len(single) - 1:
            layer = "0 at capacity factor 0.75, the same inputs"
        got = np.concatenate([np.asarray(a["kept"]), np.asarray(b["kept"])])
        ids = torch.tensor(np.concatenate([np.asarray(a["ids"]),
                                           np.asarray(b["ids"])]))
        pos, _ = slots_for(ids, a["e_pad"], a["capacity"])
        rule = (pos < a["capacity"]).numpy()
        ref = np.asarray(want["kept"])
        same_ids = np.array_equal(ids.numpy(), np.asarray(want["ids"]))
        say(f"distribution (d) {MOE_ARCH} layer {layer}: kept set == the "
            f"replicated rule on the sharded walk's routing: "
            f"{np.array_equal(got, rule)}; == the meshless walk's: "
            f"{np.array_equal(got, ref)} (agreement "
            f"{float((got == ref).mean()):.6f}, routed ids equal: "
            f"{same_ids}, {int((~ref).sum())} pairs dropped, capacity "
            f"{a['capacity']})")
        check(np.array_equal(got, rule), f"(d) layer {layer}: the sharded "
              "kept set is not the replicated rule's")
        check(not same_ids or np.array_equal(got, ref), f"(d) layer "
              f"{layer}: same routing, another kept set")
        if isinstance(layer, str):
            check(int((~ref).sum()) > 0, "(d) capacity did not bind")
    return counts


# ---------------------------------------------------------------------------
# phase 19: training (qwen2-7b at full width, the flash backward kernel)
# ---------------------------------------------------------------------------

# (B, Tq, Tk, H, KV, hd, causal, window, tag) of the backward kernel's
# check: qwen (training and serve-prefill shapes), granite's group 3 at hd
# 64, hymba's window where it binds, musicgen's group 1, the VLM's cross
# layer over the image, vit's non-causal 197 tokens
BWD_CASES = ((8, 128, 128, 28, 4, 128, True, 0, "qwen"),
             (1, 512, 512, 28, 4, 128, True, 0, "qwen"),
             (8, 128, 128, 24, 8, 64, True, 0, "granite"),
             (1, 2048, 2048, 25, 5, 64, True, 1024, "hymba"),
             (8, 128, 128, 32, 32, 64, True, 0, "musicgen"),
             (8, 128, 1601, 64, 8, 128, False, 0, "vlm"),
             (8, 197, 197, 12, 12, 64, False, 0, "vit"))
# the backward's tolerance (kernels/flash_attention.py): per gradient,
# |d| <= REL_MAX * max|want| + REL * |want|; the LSE within 1e-4 +
# 1e-5 * |lse|
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 8e-3)}
# (b) on the step's near-hard attention, where a rounding-level change
# moves dS = P (dP - D) by O(1) of itself in either implementation: the
# kernels' distance from a reference (the attention in f64) at most K
# times the plain versions' own, plus floor x the reference's size — per
# backward launch (max norms) and per leaf with the layers in lockstep
# (2-norms). Measured on an H100 80GB HBM3 at 700 W: bf16 1.05 a launch,
# ≤ 1.01 a leaf; f32 3.18 a launch, ≤ 1.1 a layer leaf and 6.6 for the
# embedding (layer 0's input cotangent, scattered); the f32 control
# (`bf16_attention`) a median 26 a leaf, 45 of 49 leaves over the gate
REF_K = {"float32": (8.0, 1e-6), "bfloat16": (2.0, 1e-4)}
TRAIN_ARCH, TRAIN_LAYERS = "qwen2-7b", 4
TRAIN_BATCH, TRAIN_SEQ = 8, PROMPT       # (b)'s step: 8 x 128
# (c), (d), (f): JAX's test_loss_decreases_end_to_end settings
# (tests/test_train.py:23): lr 3e-3, warmup 5, 30 steps of 8 x 64, no remat.
# Nothing here is tuned: they are the JAX test's, at full width
FIT_STEPS, FIT_LR, FIT_WARMUP, FIT_BATCH, FIT_SEQ = 30, 3e-3, 5, 8, 64
# (b): kernels vs plain versions from the same params. One step's loss
# (relative) is gated, every backward launch, and each layer's backward
# with the layers in lockstep: the same input and the same upstream
# cotangent (the kernel run's) through the kernels, the plain versions
# and the reference (REF_K; the embedding's gradient through layer 0's
# input cotangent; the head's VJP holds no kernel). The free-running
# per-leaf gaps are printed: the random init's attention is near-hard
# (score std ~128 at qwen's widths, ROADMAP "Known behaviours"), so a
# rounding-level change moves every layer's gradient by O(1) of its norm
# through the stack
TRAIN_LOSS_REL = {"float32": 1e-3, "bfloat16": 1e-2}
# (d): a kill at step 7 with a checkpoint every 5 steps, int8 moments (the
# smaller checkpoint), resumed by run_with_restarts against (f)'s run
TRAIN_KILL, TRAIN_CKPT_EVERY, TRAIN_RESUMED_TO = 7, 5, 10
COMQ_BITS = 3            # JAX's test_comq_beats_rtn_on_trained_model
# (e): COMQ against RTN at COMQ_BITS bits per channel on a model that
# learned: JAX's tests/test_system.py on the card (LEARN_ARCH's smoke
# config, LEARN_STEPS steps of 8 x 64 at FIT_LR, warmup 5; its last loss
# more than LEARN_DROP below its first). Gated on each quantized model's
# KL divergence from the float model's next-token distributions over the
# held-out batch (COMQ's at most RTN's) and on COMQ's loss within 1.0 of
# the float model's. The eval losses JAX's test compares are printed:
# their gap is ~0.01 nats, so its sign can follow the training run's
# rounding, while the KL ratio stays far below 1 (tools/
# trained_comq_vs_rtn.py, PERF.md §6). (c)'s model is quantized too,
# printed only: 30 steps move its held-out loss by ~0.05 nats, so its
# eval-loss verdict flips with the backward's summation order, and with
# 512 calibration tokens against inputs of up to 18944 dims COMQ's KL
# there is ~1.1x RTN's in every retrained variant
LEARN_ARCH, LEARN_STEPS, LEARN_DROP = "h2o-danube-1.8b", 60, 0.8
# (f): the CUDA adamw_update against the CPU one on these leaves of the
# int8-moment run's state, with its next gradient
TRAIN_OPT_LEAVES = ("layers.0.attn", "layers.0.mlp.w_down",
                    "layers.3.ln2")
TRAIN_PATH = ("flash_attention", "flash_attention_bwd")
# (a) the fused AdamW update (csrc/adamw.cu) against its plain version at
# the families' leaf shapes, f32 and int8 moments: (tag, leaf shape) —
# qwen's w_down and a norm, granite's expert stack, hymba's w_down (last
# dim 1600: a ragged last block of 64) and its norm, a 0-d leaf, and
# "tiny" inputs at hymba's width (`adamw_case_scales`: blocks whose update
# and encode take the int8 kernel's IEEE-division paths)
ADAMW_CASES = (("qwen", (18944, 3584)), ("qwen", (3584,)),
               ("granite", (40, 1536, 512)), ("hymba", (5504, 1600)),
               ("hymba", (1600,)), ("0-d", ()), ("tiny", (64, 1600)))
ADAMW_ROW = ("qwen", (18944, 3584))     # the kernels line's shape
ADAMW_P_REL = 1e-6     # params: max |d| / (|p| + 10 lr), as (f) holds them
ADAMW_ITERS = 10
# (a): the division probe's bias corrections, steps 1 to this (from step
# ~340 on, c1 and c2 of the default betas are exactly 1)
ADAMW_PROBE_STEPS = 1000
# (g): one family a row (arch, layers or None for the whole model, batch,
# sequence, its BWD_CASES tag): full width, depth cut, FAMILY_STEPS train
# steps counted and timed, then (b)'s gates at bf16 compute (the step's
# own). hymba's step is 1 x 2048, so its window of 1024 binds (19a's
# shape); vit runs whole on 8 images of 197 tokens
FAMILY_TRAIN = (("granite-moe-3b-a800m", 2, 8, PROMPT, "granite"),
                ("hymba-1.5b", 2, 1, 2 * HYBRID_WINDOW, "hymba"),
                ("musicgen-large", 2, 8, PROMPT, "musicgen"),
                ("rwkv6-7b", 2, 8, PROMPT, None),
                ("vit-base-16", None, 8, ENC_T, "vit"))
FAMILY_STEPS = 3         # the first warms up; walls are read from the rest
TRAIN_BUDGET_S = 270     # phase 19's share of the script's time
TRAIN_EXTRA = ()         # more launch.train flags (a CPU dry run: --device)


def adamw_case_scales(torch, tag, shape, dev):
    """(g, m, v) scales of (a)'s inputs, element by element: 1e-2, 1e-3,
    1e-5; for the "tiny" case, each third 256-block (rows and blocks in
    order, from the first) takes g 1e-20, m and v 1e-30 (v numerators
    under 2^-100, subnormal g^2, scales under 2^-60: the block's update
    is taken again with IEEE divisions, and its encode with them), and
    the next g and m 1e-18 (an m absmax under 1e-17: IEEE divisions in
    its encode only)."""
    d = shape[-1] if shape else 1
    rows = math.prod(shape) // d if shape else 1
    nb = -(-d // 256)
    kind = (torch.arange(rows, device=dev)[:, None] * nb
            + torch.arange(d, device=dev)[None] // 256) % 3
    scales = torch.tensor([1e-2, 1e-3, 1e-5], device=dev).expand(
        rows, d, 3).clone()
    if tag == "tiny":
        scales[kind == 0] = torch.tensor([1e-20, 1e-30, 1e-30], device=dev)
        scales[kind == 1] = torch.tensor([1e-18, 1e-18, 1e-5], device=dev)
    return [scales[..., i].reshape(shape) for i in range(3)]


def check_adamw(torch, dev, results, card):
    """(a) The fused AdamW update against its plain version on the card at
    ADAMW_CASES, f32 and int8 moments, the clip factor folded in: m, v
    (int8: codes, scales and EF bytes) bit for bit, params within
    ADAMW_P_REL; timed (graph replay) beside its bound, the plain
    version and, for f32 moments, `torch._fused_adamw_` over the same
    leaf (a yardstick the port never calls: decoupled weight decay, its
    own rounding)."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import bias_corrections
    from repro_torch.roofline import kernels as cost
    gen = torch.Generator(device=dev).manual_seed(21)
    step = torch.full((), 7, dtype=torch.int32, device=dev)
    lr, c1, c2 = bias_corrections(step, AdamWConfig(), FIT_LR)
    factor = torch.full((), 0.625, dtype=torch.float32, device=dev)
    for tag, shape in ADAMW_CASES:
        sg, sm, sv = adamw_case_scales(torch, tag, shape, dev)
        p, g, m = (torch.randn(shape, generator=gen, device=dev) * sc
                   for sc in (1.0, sg, sm))
        v = torch.rand(shape, generator=gen, device=dev) * sv
        for moments in ("float32", "int8"):
            cfg = AdamWConfig(moment_dtype=moments)
            start = (p, m, v) if moments == "float32" else (
                p, kadamw.encode_m(m), kadamw.encode_v(v))
            kw = dict(lr=lr, c1=c1, c2=c2, cfg=cfg, factor=factor)
            got, want, work, slow = (pytree.tree_map(torch.clone, start)
                                     for _ in range(4))
            kadamw.adamw_leaf_cuda(got[0], g, *got[1:], **kw)
            kadamw.adamw_leaf_plain(want[0], g, *want[1:], **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(
                pytree.tree_leaves(got[1:]), pytree.tree_leaves(want[1:])))
            d = (got[0] - want[0]).abs()
            err = float(d.max())
            rel = float((d / (want[0].abs() + 10 * FIT_LR)).max())
            t = Timing(torch, lambda i: kadamw.adamw_leaf_cuda(
                work[0], g, *work[1:], **kw), ADAMW_ITERS)
            plain_ms = cuda_ms(torch, lambda i: kadamw.adamw_leaf_plain(
                slow[0], g, *slow[1:], **kw), 3)
            lib = None
            if moments == "float32":
                st = [torch.full((), 7.0, device=dev)]
                lib = Timing(torch, lambda i: torch._fused_adamw_(
                    [slow[0]], [g], [slow[1]], [slow[2]], [], st, lr=FIT_LR,
                    beta1=cfg.b1, beta2=cfg.b2, weight_decay=cfg.weight_decay,
                    eps=cfg.eps, amsgrad=False, maximize=False),
                    ADAMW_ITERS).ms
            bms, by = cost.bound_ms(cost.adamw_update_of(p, start[1]))
            results[("adamw", tag, shape, moments)] = dict(
                max_abs_err=err, ms=t.ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib)
            say(f"training (a) adamw {tag} {shape} {moments} moments: "
                f"moments{' and codes' if moments == 'int8' else ''} "
                f"bit-equal {same}, params max|d| {err:.3e}, rel "
                f"{rel:.3e} (tol {ADAMW_P_REL}); kernel {t} ms, plain "
                f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"torch._fused_adamw_ "
                f"{'none' if lib is None else f'{lib:.4f}'} ms ({card})")
            check(same and rel <= ADAMW_P_REL, f"(a) adamw {tag} {shape} "
                  f"{moments}: moments equal {same}, params rel {rel}")
            del got, want, work, slow
        del p, g, m, v


def adamw_probe_divisors(torch, dev):
    """{set name: f32 divisors} for `check_adamw_division`: the int8
    path's constant divisors; the bias corrections c1 and c2 of steps
    1-ADAMW_PROBE_STEPS as the step computes them on the card (from
    step ~340 on, both are exactly 1.0 at the default betas, which the
    set holds); and block-scale divisors: mantissas of all ones and
    powers of two across the exponents, the smallest normal scales and
    the edges of the corrected multiply's divisor range [2^-100, 2^100],
    absmax / 127 and its / 3 for sampled absmaxes, and random divisors
    over every exponent (16 of them negative)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import bias_corrections

    def as_f32(bits):
        return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
            torch.float32)

    steps = torch.arange(1, ADAMW_PROBE_STEPS + 1, dtype=torch.int32,
                         device=dev)
    _, c1, c2 = bias_corrections(steps, AdamWConfig(), FIT_LR)
    gen = torch.Generator().manual_seed(33)
    ones = as_f32([(e << 23) | 0x7FFFFF for e in range(1, 255, 3)])
    twos = as_f32([e << 23 for e in range(1, 255, 3)])
    edges = as_f32([0x00800000, 0x00800001, 0x00FFFFFF, 0x01000000,
                    0x0D7FFFFF, 0x0D800000, 0x0D800001, 0x717FFFFF,
                    0x71800000, 0x71800001, 0x7F7FFFFF])
    absmax = torch.exp2(torch.rand(48, generator=gen) * 120 - 80) * (
        1 + torch.rand(48, generator=gen))
    by127 = absmax / torch.tensor(127.0)
    expo = torch.randint(1, 255, (240,), generator=gen)
    mant = torch.randint(0, 1 << 23, (240,), generator=gen)
    rand = as_f32(((expo << 23) | mant).tolist())
    rand[:16] = -rand[:16]
    return {"constants (3, 127, 255)": torch.tensor([3.0, 127.0, 255.0]),
            f"c1, c2 of steps 1-{ADAMW_PROBE_STEPS}":
                torch.unique(torch.cat([c1, c2]).cpu()),
            "block scales (all-ones mantissas, powers of two, edges, "
            "absmax/127 and /3, random)":
                torch.unique(torch.cat([ones, twos, edges, by127,
                                        by127 / torch.tensor(3.0), rand]))}


def check_adamw_division(torch, dev, results, card):
    """(a) The int8 path's divisions (csrc/adamw.cu: a corrected multiply
    by a reciprocal taken once) against __fdiv_rn on the card, for every
    f32 numerator (all 2^32 bit patterns) at each divisor of
    `adamw_probe_divisors`, in both of `adamw.div_probe`'s modes: the
    update's c1 / c2 quotients bit for bit; the encode's where a block
    scale admits it, bit for bit unless both are below 2^-40 (codes 0).
    One mismatch fails the phase."""
    from repro_torch.kernels import adamw as kadamw
    total = 0
    for name, divisors in adamw_probe_divisors(torch, dev).items():
        divisors = divisors.to(dev)
        for mode in kadamw.PROBE_MODES:
            t0 = time.time()
            found = [kadamw.div_probe(chunk, mode)
                     for chunk in divisors.split(64)]
            bad = torch.cat([b for b, _ in found]).cpu()
            first = torch.cat([f for _, f in found]).cpu()
            n_bad = int(bad.sum())
            total += n_bad
            where = [(float(d), hex(int(f))) for d, f, b in zip(
                divisors.cpu(), first, bad) if int(b)][:5]
            say(f"training (a) adamw division probe ({mode}), {name}: "
                f"{divisors.numel()} divisors x 2^32 numerators, {n_bad} "
                f"mismatches with __fdiv_rn"
                + (f" (divisor, least numerator's bits: {where})" if where
                   else "") + f", {time.time() - t0:.1f} s ({card})")
            results[("adamw_probe", name, mode)] = dict(
                divisors=divisors.numel(), mismatches=n_bad)
    check(total == 0, f"(a) the int8 path's division differs from "
          f"__fdiv_rn for {total} (divisor, numerator) pairs")


def check_flash_bwd(torch, flash, dev, results, card, cases=BWD_CASES,
                    head_map=None):
    """(a) The backward kernel against the plain version's autograd at the
    families' shapes, bf16 and f32: dQ, dK, dV and the forward's LSE under
    BWD_TOL. Both are timed (CUDA events, graph replay) beside the bound,
    the plain backward and the autograd backward of
    F.scaled_dot_product_attention at the same dtype (a yardstick the
    port never calls; graph replay, and eager); bf16 with the split plan
    of its dK/dV kernel (flash.plan_bwd); at qwen's training shape the
    bf16 forward is timed with and without its LSE write. `head_map` (a
    host tuple) maps the query
    heads of every case unevenly (SDPA then runs over K/V expanded by
    it, the expansion outside the timed window)."""
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import headmap
    from repro_torch.roofline import kernels as kc
    gen = torch.Generator(device=dev).manual_seed(19)
    hm = dict(head_map=head_map)
    for B, Tq, Tk, H, KV, hd, causal, window, tag in cases:
        kind = (f"causal window {window}" if causal and window else
                "causal" if causal else "non-causal")
        if head_map is not None:
            kind += (f", head map of groups "
                     f"{headmap.group_sizes(head_map, H, KV)}")
        for dt in (torch.bfloat16, torch.float32):
            label = str(dt).split(".")[1]
            q = torch.randn(B, Tq, H, hd, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(B, Tk, KV, hd, generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            do = torch.randn(B, Tq, H, hd, generator=gen, device=dev).to(dt)
            _, lse = flash._forward(q, k, v, causal, window, with_lse=True,
                                    **hm)
            got = flash.flash_attention_bwd_cuda(q, k, v, do, lse,
                                                 causal=causal,
                                                 window=window, **hm)
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            out = flash.flash_attention_plain(*leaves, causal=causal,
                                              window=window, **hm)
            want = torch.autograd.grad(out, leaves, do, retain_graph=True)
            want_lse = flash.attention_lse_plain(q, k, causal=causal,
                                                 window=window, **hm)
            torch.cuda.synchronize()
            rel_max, rel = BWD_TOL[label]
            errs, ok = [], True
            for a, b in zip(got, want):
                a, b = a.float(), b.float()
                d = (a - b).abs()
                errs.append(float(d.max()))
                ok &= bool((d <= rel_max * float(b.abs().max())
                            + rel * b.abs()).all())
            lse_err = float((lse - want_lse).abs().max())
            ok &= bool(((lse - want_lse).abs()
                        <= 1e-4 + 1e-5 * want_lse.abs()).all())
            msg = (f"kernel flash_attention_bwd B={B} Tq={Tq} Tk={Tk} H={H} "
                   f"KV={KV} hd={hd} {label} {kind} ({tag}): max|d| dq "
                   f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} lse "
                   f"{lse_err:.3e} (tol {rel_max}*max|want|+{rel}*|want|)")
            bf16 = dt == torch.bfloat16      # f32: the CUDA-core pair
            t = Timing(torch, lambda i: flash.flash_attention_bwd_cuda(
                q, k, v, do, lse, causal=causal, window=window, **hm),
                20 if bf16 else 10)
            plain_ms = cuda_ms(torch, lambda i: torch.autograd.grad(
                out, leaves, do, retain_graph=True), 5)
            # SDPA's backward replayed from a graph, as the kernel is
            # (its eager CUDA-event time is mostly the host's)
            lib, lib_eager = None, None
            lib_note = "SDPA backward (autograd), GQA"
            kl, vl = k, v
            if head_map is not None:
                kl, vl = (expand_heads(torch, x, head_map)
                          for x in (k, v))
                lib_note = ("SDPA backward (autograd) over K/V "
                            "expanded by the map beforehand")
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                          for x in (q, kl, vl))
            mask = (flash.attention_mask(Tq, Tk, True, window, dev)
                    if window else None)
            dot = do.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None,
                    enable_gqa=head_map is None)

            try:
                ref = sdpa()
                lib_eager = cuda_ms(torch, lambda i: torch.autograd.grad(
                    ref, (qt, kt, vt), dot, retain_graph=True), 10)
                del ref
                lib, how = autograd_graph_ms(torch, sdpa, (qt, kt, vt),
                                             dot, 10)
                lib_note += f", {how}"
            except (TypeError, RuntimeError) as e:
                lib_note = f"none ({type(e).__name__}: {e})"
            # reads q, dO, k, v and the LSE, writes dQ, dK, dV (bf16)
            bms, by = kc.bound_ms(kc.flash_attention_bwd_of(
                q, k, causal=causal, window=window))
            group = (0 if head_map is None
                     else headmap.max_group(head_map, H, KV))
            plan = flash.plan_bwd(B, Tq, Tk, H, KV, hd,
                                  build.sm_count(dev.index or 0), group)
            fmt = lambda x: "null" if x is None else f"{x:.4f}"
            if bf16:      # the split plan is the tensor-core kernels'
                msg += (f", nsplit {plan.nsplit}, dkdv blocks "
                        f"{plan.blocks}")
            msg += (f", ms {t}, plain_ms {plain_ms:.4f} "
                    f"(eager), bound_ms {bms:.4f} ({by}), library_ms "
                    f"{fmt(lib)} ({lib_note}; eager {fmt(lib_eager)}) "
                    f"({card})")
            results[("flash_attention_bwd" + ("" if bf16 else "_f32"),
                     B, Tq, Tk, tag)] = dict(
                ms=t.ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib, max_abs_err=max(errs))
            if bf16 and tag == "qwen" and Tq == PROMPT:
                with_lse = Timing(torch, lambda i: flash._forward(
                    q, k, v, True, 0, with_lse=True), 50)
                without = Timing(torch, lambda i: flash._forward(
                    q, k, v, True, 0, with_lse=False), 50)
                # the yardstick that also writes the log-sum-exp:
                # SDPA's flash forward over K/V expanded to H heads
                # (it takes no GQA), timed with its expansion outside
                qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (
                    q, k.repeat_interleave(H // KV, dim=2),
                    v.repeat_interleave(H // KV, dim=2)))
                sdpa = torch.ops.aten._scaled_dot_product_flash_attention
                try:
                    lse_lib = Timing(torch, lambda i: sdpa(
                        qh, kh, vh, 0.0, True), 50)
                except (RuntimeError, TypeError) as e:
                    lse_lib = f"none ({type(e).__name__}: {e})"
                say(f"flash_attention forward B={B} T={Tq} bf16: with "
                    f"LSE {with_lse}, without {without}; library "
                    f"(aten._scaled_dot_product_flash_attention, LSE "
                    f"out, K/V expanded to {H} heads) {lse_lib} "
                    f"({card})")
                results[("flash_attention_lse", B, Tq)] = with_lse.ms
                del qh, kh, vh
            say(msg)
            check(ok, f"flash_attention_bwd ({tag}, {label}) disagrees with "
                  f"the plain version's autograd: {errs}, lse {lse_err}")
            del q, k, v, do, lse, got, want, out, leaves


def leaf_rel_norms(torch, got, want):
    """({leaf path: ||got - want|| / ||want||}, [leaves of `got` without a
    finite nonzero gradient]) over two gradient trees."""
    rels, missing = {}, []
    for (path, a), b in zip(torch.utils._pytree.tree_flatten_with_path(got)[0],
                            torch.utils._pytree.tree_leaves(want)):
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        if not (bool(torch.isfinite(a).all()) and float(a.norm()) > 0):
            missing.append(name)
        rels[name] = float((a - b).norm()) / max(float(b.norm()), 1e-30)
    return rels, missing


class SaveFilter:
    """Within it the Trainer writes only the checkpoints whose step
    `keep(step)` accepts; the others (a run's final save, which nothing
    here reads) skip the device-to-host copy and the write. A run started
    within takes `hook` as its failure_hook (it records the step the next
    save is for, then calls `then`)."""

    def __init__(self, keep, then=None):
        self.keep, self.then, self.step = keep, then, None

    def hook(self, step):
        self.step = step
        if self.then is not None:
            self.then(step)

    def __enter__(self):
        from repro_torch.ckpt import CheckpointManager
        from repro_torch.train import trainer
        self.real = trainer.train_state_to_numpy, CheckpointManager.save
        to_np, save = self.real

        def state_to_numpy(state, **kw):
            return to_np(state, **kw) if kw or self.keep(self.step) else None

        def maybe_save(mgr, step, tree, **kw):
            return None if tree is None else save(mgr, step, tree, **kw)

        trainer.train_state_to_numpy = state_to_numpy
        CheckpointManager.save = maybe_save
        return self

    def __exit__(self, *exc):
        from repro_torch.ckpt import CheckpointManager
        from repro_torch.train import trainer
        trainer.train_state_to_numpy, CheckpointManager.save = self.real


def attention_f64(q, k, v, *, causal=True, window=0, head_map=None):
    """The plain version's masked softmax attention computed in f64, the
    output in q's dtype: (b)'s reference. An uneven `head_map` (a host
    tuple) expands K/V to one row a query head."""
    import torch

    from repro_torch.kernels.flash_attention import attention_mask
    if head_map is not None:
        k, v = (expand_heads(torch, x, head_map) for x in (k, v))
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.double()) / math.sqrt(hd)
    mask = attention_mask(Tq, Tk, causal, window, q.device)
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.double())
    return out.reshape(B, Tq, H, hd).to(q.dtype)


@contextlib.contextmanager
def f64_attention(ops, kernels):
    """The plain versions, with every attention in f64."""
    with plain_kernels(ops, kernels):
        ops.flash_attention = attention_f64
        yield


@contextlib.contextmanager
def bf16_attention(torch, ops):
    """(b)'s control: the kernels, with the attention's inputs and their
    gradients rounded to bf16 (an f32 step whose attention runs at bf16
    precision), which the lockstep gate must refuse."""
    real = ops.flash_attention

    def rounded(q, k, v, **kw):
        r = lambda t: t.to(torch.bfloat16).to(t.dtype)
        return real(r(q), r(k), r(v), **kw)

    ops.flash_attention = rounded
    try:
        yield
    finally:
        ops.flash_attention = real


@contextlib.contextmanager
def routing(torch, log, replay):
    """MoE routing in a lockstep replay: the kernel run's replay records
    each chunk's (ids, pos, slot) in `log`; a replay with `replay` set
    routes every pair as recorded (the router logits and the softmax
    over the picked ones still computed from its own input, so the
    router's gradient), so a rounding-level change of the attention
    cannot move a pair to another expert or across the capacity."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod.route_slots
    done = []

    def recording(x, router, n_real, top_k, capacity, offset=None):
        out = real(x, router, n_real, top_k, capacity, offset)
        log.append(out[2:])
        return out

    def forced(x, router, n_real, top_k, capacity, offset=None):
        ids, pos, slot = log[len(done)]
        done.append(ids)
        logits = x.float() @ router.float()
        weights = torch.softmax(logits.gather(-1, ids), dim=-1)
        return logits, weights, ids, pos, slot

    moe_mod.route_slots = forced if replay else recording
    try:
        yield
    finally:
        moe_mod.route_slots = real


def lockstep_grads(torch, ops, kernels, cfg, params, batch, plan=None):
    """(b)'s gate: one step's gradient with the layers in lockstep. The
    kernel run records each layer's input, its keyword arguments (a
    recurrent state, where a caller passes one) and the cotangents of its
    output and of its MoE aux loss; then each layer's backward runs from
    that same input and those cotangents three times: through the
    kernels, through the plain versions, and as the reference (the plain
    versions at f32 compute with the attention in f64, from f32 copies of
    the same inputs, params and cotangents), an MoE layer's pairs routed
    as the kernel replay routed them (`routing`). The input leaf's
    gradient comes from each run's layer-0 input cotangent: the token
    embedding's scattered over the tokens, an encoder's pos_embed summed
    over the batch. At f32 compute a fourth run is the control
    (`bf16_attention`). Returns ({leaf: {"kr" / "pr" / "cr": ||kernels -
    ref|| / ||plain - ref|| / ||control - ref||, "ref": ||ref||}},
    [leaves of the kernel run without a finite nonzero gradient], [leaves
    whose VJP holds no kernel])."""
    from torch.utils import _pytree as pytree

    from repro_torch.models import BuildPlan, lm_loss
    from repro_torch.models import transformer as tfm
    # each layer runs once (a tensor-parallel plan keeps its padding)
    plan = (plan or BuildPlan()).replace(remat=False)
    ref_cfg = cfg.replace(compute_dtype="float32")
    flat, spec = pytree.tree_flatten(params)
    cast = [p.detach().to(torch.bfloat16).requires_grad_(True)
            for p in flat]          # the train step's working copy
    tree = pytree.tree_unflatten(cast, spec)
    real = tfm.layer_full
    xs, kws, cots, aux_cots = [], [], [], []

    def keep(store, i):
        return lambda g: store.__setitem__(i, g.detach())

    def recording(lp, x, *a, **kw):
        xs.append(x.detach())
        kws.append(kw)
        out = real(lp, x, *a, **kw)
        i = len(cots)
        cots.append(None)
        aux_cots.append(None)
        out[0].register_hook(keep(cots, i))
        if out[2] is not None and out[2].requires_grad:
            out[2].register_hook(keep(aux_cots, i))
        return out

    tfm.layer_full = recording
    try:
        loss, _ = lm_loss(tree, cfg, plan, batch)
        grads = torch.autograd.grad(loss, cast)
    finally:
        tfm.layer_full = real
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in pytree.tree_flatten_with_path(params)[0]]
    missing = [n for n, g in zip(names, grads)
               if not (bool(torch.isfinite(g).all()) and float(g.norm()) > 0)]
    source = "pos_embed" if cfg.family == "encoder" else "embed"
    head = [n for n in names if not n.startswith(("layers.", source))]
    del grads, loss

    modes = ("kernels", "plain", "ref") + (
        ("control",) if cfg.compute_dtype == "float32" else ())

    def row(got):
        r = got["ref"].float()
        out = {key: float((got[m].float() - r).norm()) for key, m in
               (("kr", "kernels"), ("pr", "plain"), ("cr", "control"))
               if m in got}
        return {**out, "ref": float(r.norm())}

    def f32(v):
        return v.float() if isinstance(v, torch.Tensor) else v

    out_rels, g0 = {}, {}
    for i, lp in enumerate(tree["layers"]):
        leaves, lspec = pytree.tree_flatten(lp)
        got, routed = {}, []
        for mode in modes:
            c, lv, x, kw = cfg, leaves, xs[i], kws[i]
            cot, aux_cot = cots[i], aux_cots[i]
            ctx = contextlib.nullcontext()
            if mode == "ref":
                c, x, cot = ref_cfg, x.float(), cot.float()
                kw = pytree.tree_map(f32, kw)
                lv = [t.detach().float().requires_grad_(True) for t in lv]
                ctx = f64_attention(ops, kernels)
            elif mode == "plain":
                ctx = plain_kernels(ops, kernels)
            elif mode == "control":
                ctx = bf16_attention(torch, ops)
            x = x.clone().requires_grad_(True)
            with ctx, routing(torch, routed, replay=mode != "kernels"):
                out = real(pytree.tree_unflatten(lv, lspec), x, c, plan,
                           False, **kw)
                outs, out_cots = [out[0]], [cot]
                if aux_cot is not None:
                    outs.append(out[2])
                    out_cots.append(aux_cot)
                got[mode] = torch.autograd.grad(outs, [x] + lv, out_cots)
            if i == 0:
                g0[mode] = got[mode][0]
        lnames = [n for n in names if n.startswith(f"layers.{i}.")]
        for j, n in enumerate(lnames, start=1):
            out_rels[n] = row({m: got[m][j] for m in got})
        del got
    if source == "embed":
        tok = batch["tokens"].reshape(-1)
        src = {m: torch.zeros(params["embed"].shape, device=g.device)
               .index_add_(0, tok, g.reshape(tok.numel(), -1).float())
               for m, g in g0.items()}
    else:
        src = {}
        for m, g in g0.items():
            src[m] = torch.zeros(params["pos_embed"].shape, device=g.device)
            src[m][:g.shape[1]] = g.float().sum(dim=0)
    out_rels[source] = row(src)
    return out_rels, missing, head


def fit_args(tmp: Path, *extra, arch=TRAIN_ARCH, steps=FIT_STEPS):
    """launch.train's flags for (c), (d), (e) and (f): JAX's test settings
    (the card by default)."""
    from repro_torch.launch import train
    return train.build_parser().parse_args(
        ["--arch", arch, "--steps", str(steps), "--batch",
         str(FIT_BATCH), "--seq", str(FIT_SEQ), "--lr", str(FIT_LR),
         "--ckpt-dir", str(tmp), "--ckpt-every", "100", *extra,
         *TRAIN_EXTRA])


@contextlib.contextmanager
def eager_trainer():
    """The Trainer with its step called directly (`make_train_step`'s
    function, eager) in place of the graph it captures and replays: the
    reference a replay is held to. Only this script does this (as
    `plain_kernels` swaps the kernels); the Trainer has no such switch."""
    from repro_torch.train import trainer as tr
    real = tr.Trainer._step_program
    tr.Trainer._step_program = lambda self: self.direct_step
    try:
        yield
    finally:
        tr.Trainer._step_program = real


def fit(torch, cfg, args, what, card, failure_hook=None, eager=False,
        **run_kw):
    """One run of launch.train's code path (`train.train`) on `cfg`, with
    JAX's test warmup and synchronous checkpoints: the step captured once
    as a CUDA graph and replayed (one capture is checked), or with
    `eager` called directly. Step walls are read between consecutive
    calls of the failure hook (each step ends in the host pulling its
    metrics, so they are synchronized). Returns (out, losses); out
    ["step_walls"] holds the walls."""
    import dataclasses

    from repro_torch.analysis.retrace import compile_count, reset_guards
    from repro_torch.launch import train
    from repro_torch.train.trainer import STEP_NAME
    run_cfg = dataclasses.replace(train.run_config(args),
                                  warmup_steps=FIT_WARMUP, async_ckpt=False,
                                  **run_kw)
    ends = []

    def hook(step):
        ends.append(time.perf_counter())
        if failure_hook is not None:
            failure_hook(step)

    reset_guards(STEP_NAME)
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with eager_trainer() if eager else contextlib.nullcontext():
            trainer, out, line = train.train(cfg, run_cfg, args,
                                             failure_hook=hook)
    finally:
        torch.cuda.synchronize()
    wall = time.time() - t0
    losses = [m["loss"] for m in out["metrics"]]
    walls = [b - a for a, b in zip(ends, ends[1:])]
    captures = compile_count(STEP_NAME)
    say(f"training {what}: {json.dumps(line)}; {len(losses)} steps in "
        f"{wall:.1f} s, step wall p50 {statistics.median(walls):.4f} s (min "
        f"{min(walls):.4f}, max {max(walls):.4f}; from step end to step "
        f"end; the step {'called directly' if eager else 'replayed'}, "
        f"{captures} capture(s) of {STEP_NAME}), straggler events "
        f"{len(trainer.watchdog.events)} ({card})")
    check(captures == (0 if eager else 1), f"{what}: {captures} captures "
          f"of {STEP_NAME}, not {0 if eager else 1}")
    out["step_walls"] = walls
    return out, losses


def profiled_ms(torch, fn, n):
    """(device ms a call, host ms a call, [(kernel, ms a call)] largest
    first) from torch.profiler over n calls of fn(i): the device time is
    the sum of the kernels' times (one stream, so their union)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / n
    kernel = torch.autograd.DeviceType.CUDA     # kernels, not the ops
    rows = [(e.key, e.self_device_time_total / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == kernel and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), host, rows


STEP_WARMUP, STEP_TIMED, STEP_PROFILED = 2, 5, 3


def train_step_timings(torch, cfg, moments, B, T, dev, work: Path, what,
                       card, modes=("eager", "replayed")):
    """A Trainer's step on `cfg` from `init_params(seed=0)` (lr FIT_LR,
    warmup FIT_WARMUP, no remat, `moments` AdamW moments, B x T batches
    of `family_batch`), called directly ("eager") and replayed from its
    CUDA graph ("replayed", the Trainer's own program), in turn on one
    state: STEP_WARMUP steps (the capture among them), the wall of each
    of STEP_TIMED steps (host clock, each ending in a synchronize), then
    torch.profiler over STEP_PROFILED steps. Prints a line a mode, with
    the AdamW kernels' bound a step (`roofline.kernels.adamw_update_of`
    summed over the state's leaves), and returns {mode: (wall p50 ms,
    device ms, kernel rows)}."""
    from torch.utils import _pytree as pytree
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import BuildPlan
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline import kernels as cost
    from repro_torch.train import Trainer
    from repro_torch.train.trainer import BATCH_KEYS
    trainer = Trainer(cfg, BuildPlan(remat=False),
                      RunConfig(arch=cfg.name, learning_rate=FIT_LR,
                                warmup_steps=FIT_WARMUP,
                                total_steps=FIT_STEPS, ckpt_dir=str(work)),
                      adamw_cfg=AdamWConfig(moment_dtype=moments),
                      device=dev)
    state = trainer.init_state()
    leaves = pytree.tree_leaves(state["params"])
    firsts = pytree.tree_leaves(
        state["opt"]["m"], is_leaf=lambda x: isinstance(x, dict) and "q" in x)
    adamw_bound = sum(cost.bound_ms(cost.adamw_update_of(p, m))[0]
                      for p, m in zip(leaves, firsts))
    n_params = sum(p.numel() for p in leaves)
    n = STEP_WARMUP + STEP_TIMED + STEP_PROFILED
    batches = [[b[k] for k in BATCH_KEYS] for b in
               (family_batch(torch, cfg, B, T, dev, i) for i in range(n))]
    programs = {"eager": trainer.direct_step,
                "replayed": trainer._step_program()}
    out = {}
    for mode in modes:
        step = programs[mode]
        for i in range(STEP_WARMUP):
            step(state, *batches[i])
        walls = []
        for i in range(STEP_WARMUP, STEP_WARMUP + STEP_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, *batches[i])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        loss = float(m["loss"])
        dms, host, rows = profiled_ms(
            torch, lambda i: step(state, *batches[n - STEP_PROFILED + i]),
            STEP_PROFILED)
        wall = statistics.median(walls)
        top = ", ".join(f"{k[:40]} {v:.3f}" for k, v in rows[:8])
        say(f"{what} {mode}: step wall p50 {wall:.3f} ms over {STEP_TIMED} "
            f"(host clock, synchronized; walls "
            f"{[round(w, 3) for w in walls]}), loss {loss:.4f}; profiler "
            f"device time {dms:.3f} ms a step over {STEP_PROFILED} "
            f"({host:.3f} ms wall a step under the profiler, {len(rows)} "
            f"kernels): device share {dms / wall:.3f} of the wall; largest "
            f"kernels (ms a step): {top}; AdamW bound {adamw_bound:.3f} ms "
            f"a step ({len(leaves)} leaves, {n_params} parameters); {card}")
        out[mode] = (wall, dms, rows)
    del state, trainer, programs, batches
    return out


def held_out(torch, cfg, dev):
    """(e)'s held-out batch and calibration tokens (JAX's test: stream
    steps 9999 and 5000, 8 x 64)."""
    from repro_torch.data import SyntheticLM
    gen = SyntheticLM(cfg.vocab_size, seed=0)
    ev = {k: torch.from_numpy(v).to(dev) for k, v in
          gen.sample(FIT_BATCH, FIT_SEQ, 9999).items()}
    calib = torch.from_numpy(gen.sample(FIT_BATCH, FIT_SEQ,
                                        5000)["tokens"]).to(dev)
    return ev, calib


def learned_model(torch, work: Path, card, what="(e) the learned model",
                  *extra):
    """(e)'s model that learned: LEARN_ARCH's smoke config trained through
    launch.train's code path at JAX's test_system settings (`extra`: more
    launch.train flags). Returns (cfg, params, losses)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(LEARN_ARCH)
    with SaveFilter(lambda step: False) as unsaved:
        out, losses = fit(torch, cfg, fit_args(work, "--smoke", *extra,
                                               arch=LEARN_ARCH,
                                               steps=LEARN_STEPS),
                          what, card, failure_hook=unsaved.hook)
    return cfg, out["state"]["params"], losses


def comq_vs_rtn(torch, params, cfg, ev, calib):
    """(e)'s readings on a trained model: the held-out batch's loss of the
    float model, and by method (comq_blocked, the at-scale COMQ solver,
    and rtn; COMQ_BITS bits per channel) the quantized model's loss and
    its KL divergence from the float model's next-token distributions,
    the mean over the batch's tokens. Returns (base, losses, kls)."""
    import gc

    from repro_torch.core import QuantSpec, materialize, quantize_model
    from repro_torch.models import BuildPlan, forward, lm_loss

    def scored(p):
        with torch.no_grad():
            loss = float(lm_loss(p, cfg, BuildPlan(), ev)[0])
            logits = forward(p, cfg, BuildPlan(), ev["tokens"])[0]
        return loss, torch.log_softmax(logits.float(), dim=-1)

    base, ref = scored(params)
    losses, kls = {}, {}
    for method in ("comq_blocked", "rtn"):
        spec = QuantSpec(bits=COMQ_BITS, granularity="per_channel", lam=0.9,
                         sweeps=3, order="greedy")
        with torch.no_grad():
            qp, _ = quantize_model(params, cfg, BuildPlan(), calib, spec,
                                   method=method)
            losses[method], logp = scored(materialize(qp, cfg))
            kls[method] = float((ref.exp() * (ref - logp)).sum(-1).mean())
        del qp, logp
        gc.collect()
    return base, losses, kls


def step_grads(torch, flash, ops, kernels, cfg, params, batch, label, card,
               what="(b)", n_attn=TRAIN_LAYERS, plan=None):
    """(b) at one compute type: the step's loss and gradients through the
    kernels and through the plain versions from the same params; every
    backward launch of the kernel run (`n_attn` of them) against the plain
    autograd and the f64 reference on its own tensors; then each leaf's
    gradient with the layers in lockstep (REF_K). A family's step (g)
    too: with no kernel in its VJP (rwkv) the two runs must be
    bit-identical; an MoE model's plain run is repeated, and the spread of
    the two plain runs printed beside the kernels-vs-plain gap."""
    from repro_torch.models import BuildPlan
    from repro_torch.train.train_step import _loss_and_grads
    plan = plan or BuildPlan()
    real_bwd = flash.flash_attention_bwd_cuda
    calls = []

    def recording(q, k, v, do, lse, **kw):
        out = real_bwd(q, k, v, do, lse, **kw)
        calls.append((q, k, v, do, lse, kw, out))
        return out

    flash.flash_attention_bwd_cuda = recording
    try:
        lk, gk = _loss_and_grads(cfg, plan, 1, params, batch)
    finally:
        flash.flash_attention_bwd_cuda = real_bwd
    with plain_kernels(ops, kernels):
        lp, gp = _loss_and_grads(cfg, plan, 1, params, batch)
    torch.cuda.synchronize()
    rels, missing = leaf_rel_norms(torch, gk, gp)
    leaves = torch.utils._pytree.tree_leaves
    identical = bool(torch.equal(lk, lp)) and all(
        torch.equal(a, b) for a, b in zip(leaves(gk), leaves(gp)))
    del gk
    if cfg.moe is not None:
        # the plain versions twice: the spread the gather's backward (an
        # accumulating index_put) leaves between identical runs
        with plain_kernels(ops, kernels):
            lp2, gp2 = _loss_and_grads(cfg, plan, 1, params, batch)
        torch.cuda.synchronize()
        rerun, _ = leaf_rel_norms(torch, gp2, gp)
        same = bool(torch.equal(lp2, lp)) and all(
            torch.equal(a, b) for a, b in zip(leaves(gp2), leaves(gp)))
        rworst = max(rerun, key=rerun.get)
        kworst = max(rels, key=rels.get)
        say(f"training {what} {label}, plain versions run twice: loss "
            f"{float(lp):.6f} vs {float(lp2):.6f}, bit-identical {same}; "
            f"leaf rel-norm spread max {rerun[rworst]:.3e} ({rworst}), "
            f"median {statistics.median(rerun.values()):.3e}; kernels vs "
            f"plain max {rels[kworst]:.3e} ({kworst}), median "
            f"{statistics.median(rels.values()):.3e} (printed) ({card})")
        del gp2
    del gp
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    by_grad, calls_ok = [0.0, 0.0, 0.0], True

    def plain_grads(q, k, v, do, kw, attend=flash.flash_attention_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(attend(*leaves, **kw), leaves, do)

    for q, k, v, do, lse, kw, got in calls:
        # the step's near-hard attention (dP ~ D, so dS = P (dP - D)
        # cancels): the kernel and the plain graph are each held against
        # the same attention in f64 on the same (upcast) tensors, the
        # kernel at most REF_K x as far as the plain version
        want = plain_grads(q, k, v, do, kw)
        ref = plain_grads(*(t.double() for t in (q, k, v, do)), kw,
                          attend=attention_f64)
        k_ref, floor = REF_K[label]
        for i, (a, b, r) in enumerate(zip(got, want, ref)):
            top = float(r.abs().max())
            ek = float((a.double() - r).abs().max())
            ep = float((b.double() - r).abs().max())
            by_grad[i] = max(by_grad[i], ek / max(ep, 1e-300))
            calls_ok &= ek <= k_ref * ep + floor * top
        want_lse = flash.attention_lse_plain(q, k, **kw)
        calls_ok &= bool(((lse - want_lse).abs()
                          <= 1e-4 + 1e-5 * want_lse.abs()).all())
    n_calls = len(calls)
    del calls
    call_err = max(by_grad)
    call_rule = (f"max|kernel - ref| / max|plain - ref| dq / dk / dv "
                 f"{by_grad[0]:.3e} / {by_grad[1]:.3e} / {by_grad[2]:.3e} "
                 f"(ref: the attention in f64; tol {REF_K[label][0]} + "
                 f"{REF_K[label][1]}*max|ref| / max|plain - ref|)")
    worst = max(rels, key=rels.get)
    say(f"training {what} {label} compute, one step's loss and gradients, "
        f"kernels vs plain versions from the same params: loss "
        f"{float(lk):.6f} vs {float(lp):.6f} (rel {loss_rel:.3e}, tol "
        f"{TRAIN_LOSS_REL[label]}); {len(rels)} leaves, each with a finite "
        f"nonzero gradient: {not missing}; kernels and plain bit-identical "
        f"{identical}; the step's {n_calls} backward "
        f"launches vs the plain autograd on their own tensors: worst "
        f"{call_rule}; free-running leaf rel-norms (printed): worst "
        f"{rels[worst]:.3e} ({worst}) ({card})")
    check(not missing, f"{what} {label}: leaves without a gradient on the "
          f"card: {missing}")
    check(identical or not cfg.attn_free, f"{what} {label}: no kernel lies "
          f"on the VJP, yet the kernels' and the plain versions' gradients "
          f"differ")
    check(n_calls == n_attn and loss_rel <= TRAIN_LOSS_REL[label]
          and calls_ok, f"{what} {label}: kernels vs plain loss rel "
          f"{loss_rel}, {n_calls} backward launches, on the step's tensors "
          f"{call_err}")
    # each leaf's distance from the reference at most REF_K times the
    # plain versions' own, plus floor x the reference's norm (for the key
    # bias, whose exact gradient is 0 — q·bk shifts all of a query's
    # scores, which the softmax ignores — the norm of its layer's wk
    # gradient, the same key cotangents weighted)
    lr_, lmissing, head = lockstep_grads(torch, ops, kernels, cfg, params,
                                         batch, plan)
    k_ref, floor = REF_K[label]
    got = {k: v["kr"] for k, v in lr_.items()}
    tols = {k: k_ref * v["pr"] + floor * lr_[
        k.replace(".attn.bk", ".attn.wk")]["ref"] for k, v in lr_.items()}
    rule = (f"{k_ref} x the plain versions' distance from the reference "
            f"(f32 compute, attention in f64) + {floor} x its norm")
    lworst = max(got, key=lambda k: got[k] / tols[k])
    top = sorted(got, key=lambda k: -got[k] / tols[k])[:6]
    shown = {k: (float("%.3e" % (lr_[k]["kr"] / lr_[k]["ref"])),
                 float("%.3e" % (lr_[k]["pr"] / lr_[k]["ref"])),
                 float("%.3f" % (got[k] / tols[k]))) for k in top}
    say(f"training {what} {label}, the layers in lockstep (each layer's "
        f"backward from the kernel run's input and output cotangent): "
        f"{len(got)} leaves, tol {rule}; closest to their tolerance "
        f"(kernels' / plain's distance from the reference over its norm, "
        f"kernels' distance / tol): {shown}; head leaves {head}: no kernel "
        f"in their VJP ({card})")
    check(not lmissing and len(got) + len(head) == len(rels),
          f"{what} {label}, lockstep: leaves without a gradient {lmissing}")
    check(all(got[k] <= tols[k] for k in got),
          f"{what} {label}: a leaf's gradient with the layers in lockstep "
          f"is {got[lworst]} ({lworst}), above {tols[lworst]}")
    # REF_K's readings: the kernels' distance from the reference over the
    # plain versions', against the control's (the attention at bf16
    # precision in the f32 step), which the gate must refuse
    ratio = {k: v["kr"] / max(v["pr"], 1e-300) for k, v in lr_.items()}
    kmax = max(ratio, key=ratio.get)
    say(f"training {what} {label}, REF_K readings: kernels' distance from "
        f"the reference / the plain versions', per leaf: max {ratio[kmax]:.3f} "
        f"({kmax}), median {statistics.median(ratio.values()):.3f} (limit "
        f"{k_ref}) ({card})")
    if "cr" in next(iter(lr_.values())):
        cratio = {k: v["cr"] / max(v["pr"], 1e-300) for k, v in lr_.items()}
        over = {k: lr_[k]["cr"] / tols[k] for k in lr_}
        cmin = min(cratio, key=cratio.get)
        say(f"training {what} {label}, the control (attention inputs and "
            f"gradients rounded to bf16): its distance / the plain "
            f"versions', per leaf: min {cratio[cmin]:.3f} ({cmin}), median "
            f"{statistics.median(cratio.values()):.3f}, max "
            f"{max(cratio.values()):.3f}; leaves above the tolerance "
            f"{sum(v > 1 for v in over.values())} of {len(over)} ({card})")
        check(any(v > 1 for v in over.values()),
              f"{what} {label}: the bf16 control passes the lockstep gate "
              f"(worst {max(over.values())} of its tolerance)")


class KernelClock:
    """Within it, CUDA events bracket every flash forward (with LSE) and
    backward launch; `ms()` sums their device times since `reset()`."""

    def __init__(self, torch, flash):
        self.torch, self.flash = torch, flash
        self.spans = {"forward": [], "backward": []}

    def _timed(self, fn, key):
        def timed(*a, **k):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.spans[key].append((start, end))
            return out
        return timed

    def __enter__(self):
        self.real = self.flash._forward, self.flash.flash_attention_bwd_cuda
        self.flash._forward = self._timed(self.real[0], "forward")
        self.flash.flash_attention_bwd_cuda = self._timed(self.real[1],
                                                          "backward")
        return self

    def __exit__(self, *exc):
        self.flash._forward, self.flash.flash_attention_bwd_cuda = self.real

    def reset(self):
        for spans in self.spans.values():
            spans.clear()

    def ms(self):
        self.torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.spans.items()}


def family_batch(torch, cfg, B, T, dev, step):
    """A family step's batch: SyntheticLM's stream at `step`, or for the
    encoder patch embeddings and class labels from a seed."""
    if cfg.family == "encoder":
        gen = torch.Generator(device=dev).manual_seed(19 + step)
        return {"embeds": torch.randn(B, T, cfg.d_model, generator=gen,
                                      device=dev),
                "labels": torch.randint(0, cfg.vocab_size, (B,),
                                        generator=gen, device=dev)}
    from repro_torch.data import SyntheticLM
    return {k: torch.from_numpy(v).to(dev) for k, v in
            SyntheticLM(cfg.vocab_size, seed=0).sample(B, T, step).items()}


def family_step(torch, flash, ops, kernels, arch, layers, B, T, dev, card):
    """(g) one family from `init_params(cfg, seed=0)` at full width:
    FAMILY_STEPS steps of make_train_step (bf16 working copy, f32 moments,
    no remat, as launch.train runs it; the training path, counted), each
    wall, the peak memory and the flash kernels' device time in the last
    step; then (b)'s gates on the first batch at bf16 (`step_grads`).
    Returns the steps' launch counts."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    full = get_config(arch)
    cfg = full if layers is None else full.replace(n_layers=layers)
    cut = ("whole" if layers is None
           else f"n_layers {full.n_layers} -> {layers}")
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        params))
    heads = ("attention-free" if cfg.attn_free else
             f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
             f"{cfg.resolved_head_dim}")
    n_attn = 0 if cfg.attn_free else cfg.n_layers
    say(f"training (g) {arch} at full width ({cfg.family}: d_model "
        f"{cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab/classes "
        f"{cfg.vocab_size}), {cut}: {n_params} parameters; batch {B}x{T}")
    step = make_train_step(cfg, BuildPlan(remat=False),
                           RunConfig(arch=arch, learning_rate=FIT_LR,
                                     warmup_steps=1, total_steps=FIT_STEPS),
                           AdamWConfig())
    state = init_train_state(params, AdamWConfig())
    batches = [family_batch(torch, cfg, B, T, dev, i)
               for i in range(FAMILY_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2 ** 30
    walls, losses = [], []
    ops.reset_launch_counts()
    with KernelClock(torch, flash) as clock:
        for batch in batches:
            clock.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        kms = clock.ms()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del state, step
    wall = statistics.median(walls[1:])
    last = walls[-1] * 1e3
    say(f"training (g) {arch}: {FAMILY_STEPS} steps, losses "
        f"{[round(x, 4) for x in losses]}; step walls "
        f"{[round(w, 4) for w in walls]} s (p50 after the first "
        f"{wall:.4f}); the last step's flash forward {kms['forward']:.4f} "
        f"ms and backward {kms['backward']:.4f} ms of {last:.1f} ms "
        f"({kms['backward'] / last:.2%} backward); peak "
        f"device memory {peak:.2f} GiB, {peak - held:.2f} above the "
        f"{held:.2f} held before the steps; launches {counts} ({card})")
    check(all(math.isfinite(x) for x in losses),
          f"(g) {arch}: a non-finite loss {losses}")
    want = {n: n_attn * FAMILY_STEPS for n in TRAIN_PATH}
    want["adamw"] = len(torch.utils._pytree.tree_leaves(params)) * \
        FAMILY_STEPS
    check(all(counts[n] == want[n] for n in want),
          f"(g) {arch}: the steps launched {counts}, not {want}")
    step_grads(torch, flash, ops, kernels, cfg, params, batches[0],
               "bfloat16", card, what=f"(g) {arch}", n_attn=n_attn)
    del params, batches
    return counts


def opt_parity(torch, state, grads, acfg, card):
    """(f)'s gate: adamw_update on the card and on the CPU from the same
    state and gradient (TRAIN_OPT_LEAVES): int8 codes, scales and EF
    planes bit for bit, params within f32 rounding."""
    from torch.utils import _pytree as pytree

    from repro_torch.optim import adamw_update

    def pick(tree):
        out = {}
        for prefix in TRAIN_OPT_LEAVES:
            node = tree
            for part in prefix.split("."):
                node = node[int(part)] if isinstance(node, list) else \
                    node[part]
            out[prefix] = node
        return out

    p, g = pick(state["params"]), pick(grads)
    st = {"step": state["opt"]["step"], "m": pick(state["opt"]["m"]),
          "v": pick(state["opt"]["v"])}
    lr = torch.tensor(FIT_LR, dtype=torch.float32)
    cpu = lambda t: t.detach().cpu()
    gp, gs = adamw_update(g, st, p, acfg, lr.to(st["step"].device))
    cp, cs = adamw_update(pytree.tree_map(cpu, g), pytree.tree_map(cpu, st),
                          pytree.tree_map(cpu, p), acfg, lr)
    codes_equal, n_codes, p_err = True, 0, 0.0
    for a, b in zip(pytree.tree_leaves((gs["m"], gs["v"])),
                    pytree.tree_leaves((cs["m"], cs["v"]))):
        codes_equal &= torch.equal(a.cpu(), b)
        n_codes += a.numel()
    for a, b in zip(pytree.tree_leaves(gp), pytree.tree_leaves(cp)):
        # f32 rounding of the update: the bias corrections' powers come
        # from two libraries' pow, a last bit apart at most
        p_err = max(p_err, float(((a.cpu() - b).abs()
                                  / (b.abs() + 10 * FIT_LR)).max()))
    n = sum(t.numel() for t in pytree.tree_leaves(p))
    say(f"training (f) adamw_update, int8 moments, on the card vs the CPU "
        f"from the same state and gradient ({n} parameters of "
        f"{list(TRAIN_OPT_LEAVES)}): {n_codes} moment codes, scales and EF "
        f"bytes bit-equal {codes_equal}; params max |d| / (|p| + 10 lr) "
        f"{p_err:.3e} ({card})")
    check(codes_equal and p_err <= 1e-6, f"(f) adamw_update on the card "
          f"differs from the CPU's: codes equal {codes_equal}, params rel "
          f"{p_err}")


def phase_training(torch, dev, ops, kernels, results, card):
    """Phase 19. Returns the training path's launch counts ((c)'s Trainer
    run through launch.train's code path), each family's steps' (g), by
    arch, and (d)'s checkpoint directory with the resumed attempt's
    losses (phase 21 restores it through shardings= against them)."""
    import gc
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.ft import run_with_restarts
    from repro_torch.models import BuildPlan, init_params, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import _loss_and_grads
    flash = kernels[1]
    t_phase = time.time()
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    say(f"training: {TRAIN_ARCH} at full width (d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"QKV bias, untied embeddings), n_layers 28 -> {TRAIN_LAYERS} "
        f"({card})")

    def took(what, t):
        say(f"training: {what} took {time.time() - t:.1f} s wall")
        gc.collect()
        torch.cuda.empty_cache()
        return time.time()

    # (a) the backward kernel, and the fused AdamW update
    check_flash_bwd(torch, flash, dev, results, card)
    check_adamw(torch, dev, results, card)
    check_adamw_division(torch, dev, results, card)
    t_part = took("(a)", t_phase)

    # (b) one step, kernels against the plain versions from the same params
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticLM(cfg.vocab_size, seed=0).sample(
                 TRAIN_BATCH, TRAIN_SEQ, 0).items()}
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        params))
    say(f"training (b): {n_params} parameters at {TRAIN_LAYERS} layers "
        f"({n_params * 4 / 2 ** 30:.2f} GiB of f32 master), batch "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} of SyntheticLM")
    for label in ("bfloat16", "float32"):
        step_grads(torch, flash, ops, kernels,
                   cfg.replace(compute_dtype=label), params, batch, label,
                   card)
        gc.collect()
        torch.cuda.empty_cache()
    del params, batch
    t_part = took("(b)", t_part)

    # (c)'s witness: the same run through the plain versions (their
    # autograd graph for the backward), so that (c)'s curve can be read
    # against one the kernels did not make; and a held-out batch's loss
    # (the (e) eval batch) at the init and after each run, which no batch
    # to batch spread moves
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    ev = held_out(torch, cfg, dev)[0]

    def eval_loss(p):
        with torch.no_grad():
            return float(lm_loss(p, cfg, BuildPlan(), ev)[0])

    p0 = init_params(cfg, seed=0, device=dev)
    held = {"init": eval_loss(p0)}
    del p0
    with plain_kernels(ops, kernels), \
            SaveFilter(lambda step: False) as unsaved:
        out, lplain = fit(torch, cfg, fit_args(work / "w"),
                          "(c) witness, plain versions", card,
                          failure_hook=unsaved.hook, eager=True)
    held["plain"] = eval_loss(out["state"]["params"])
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the Trainer through launch.train's code path, f32 moments, its
    # step captured once and replayed: the training path, counted. Nothing
    # reads its final checkpoint
    torch.cuda.reset_peak_memory_stats(dev)
    held32 = torch.cuda.memory_allocated(dev) / 2 ** 30
    ops.reset_launch_counts()
    with SaveFilter(lambda step: False) as unsaved:
        out, l32 = fit(torch, cfg, fit_args(work / "c"), "(c) f32 moments",
                       card, failure_hook=unsaved.hook)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_leaves = len(torch.utils._pytree.tree_leaves(out["state"]["params"]))
    check(counts["adamw"] == n_leaves * FIT_STEPS,
          f"(c) the AdamW kernel launched {counts['adamw']} times, not once "
          f"a leaf a step ({n_leaves} x {FIT_STEPS})")
    first5, last5 = statistics.mean(l32[:5]), statistics.mean(l32[-5:])
    say(f"training (c) losses {[round(x, 4) for x in l32]}; mean of the "
        f"first 5 {first5:.4f}, of the last 5 {last5:.4f} (drop "
        f"{first5 - last5:.4f}; first - last {l32[0] - l32[-1]:.4f}); peak "
        f"device memory {peak:.2f} GiB, {peak - held32:.2f} above the "
        f"{held32:.2f} held before the run; training path launches {counts} "
        f"({card})")
    check(all(math.isfinite(x) for x in l32), f"(c) a non-finite loss: {l32}")
    check(last5 < first5, f"(c) the mean of the last 5 losses {last5} is "
          f"not below the first 5's {first5}")
    check(all(counts[n] > 0 for n in TRAIN_PATH),
          f"a kernel of the training path never launched: {counts}")
    trained = out["state"]["params"]
    replayed_walls = out["step_walls"]
    del out
    # the same run with the step called directly, the same kernels: every
    # loss and the final params bit for bit the replayed run's
    with SaveFilter(lambda step: False) as unsaved:
        out, leager = fit(torch, cfg, fit_args(work / "c2"),
                          "(c) f32 moments, the step called directly", card,
                          failure_hook=unsaved.hook, eager=True)
    same_params = all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(out["state"]["params"]),
        torch.utils._pytree.tree_leaves(trained)))
    say(f"training (c) replayed vs called directly: {FIT_STEPS} losses "
        f"bit-equal {leager == l32}, final params bit-equal {same_params}; "
        f"step wall p50 replayed {statistics.median(replayed_walls):.4f} s, "
        f"direct {statistics.median(out['step_walls']):.4f} s ({card})")
    check(leager == l32 and same_params, f"(c) the replayed run differs "
          f"from the direct one: losses {l32} vs {leager}, params equal "
          f"{same_params}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    train_step_timings(torch, cfg, "float32", FIT_BATCH, FIT_SEQ, dev,
                       work / "t", "training (c) the step", card)
    gc.collect()
    torch.cuda.empty_cache()
    held["kernels"] = eval_loss(trained)
    gaps = [abs(a - b) for a, b in zip(l32, lplain)]
    say(f"training (c) witness, the plain versions' losses "
        f"{[round(x, 4) for x in lplain]}; mean of the first 5 "
        f"{statistics.mean(lplain[:5]):.4f}, of the last 5 "
        f"{statistics.mean(lplain[-5:]):.4f}; |kernels - plain| a step: "
        f"max {max(gaps):.4f} (step {gaps.index(max(gaps))}), mean "
        f"{statistics.mean(gaps):.4f}; held-out loss (8 x 64, stream step "
        f"9999): init {held['init']:.6f}, after 30 steps kernels "
        f"{held['kernels']:.6f}, plain {held['plain']:.6f} ({card})")
    t_part = took("(c)", t_part)

    # (e) COMQ vs RTN at 3 bits (JAX's test_comq_beats_rtn_on_trained_model
    # on test_system's trained model): on (c)'s model, printed, then on one
    # that learned, gated
    def compare(what, params, cfg_e, ev_e, calib_e):
        base, losses, kls = comq_vs_rtn(torch, params, cfg_e, ev_e, calib_e)
        say(f"training (e) {what} at {COMQ_BITS} bits per-channel: KL "
            f"from the float model COMQ {kls['comq_blocked']:.6g}, RTN "
            f"{kls['rtn']:.6g} (ratio "
            f"{kls['comq_blocked'] / kls['rtn']:.4f}); eval loss float "
            f"{base:.6f}, COMQ {losses['comq_blocked']:.6f}, RTN "
            f"{losses['rtn']:.6f} (COMQ - RTN "
            f"{losses['comq_blocked'] - losses['rtn']:+.6f}) ({card})")
        return base, losses, kls

    compare("(c)'s model (printed)", trained, cfg, ev,
            held_out(torch, cfg, dev)[1])
    cfg_l, learned, l_losses = learned_model(torch, work / "e", card)
    say(f"training (e) the learned model ({cfg_l.name}): losses first "
        f"{l_losses[0]:.4f}, last {l_losses[-1]:.4f} (drop "
        f"{l_losses[0] - l_losses[-1]:.4f}, gate {LEARN_DROP})")
    check(l_losses[-1] < l_losses[0] - LEARN_DROP, f"(e) the smoke model "
          f"learned too little: losses {l_losses[0]} -> {l_losses[-1]}")
    base, losses, kls = compare("the learned model", learned, cfg_l,
                                *held_out(torch, cfg_l, dev))
    check(kls["comq_blocked"] <= kls["rtn"], f"(e) the learned model: "
          f"COMQ's KL from the float model {kls['comq_blocked']} > RTN's "
          f"{kls['rtn']}")
    check(losses["comq_blocked"] - base < 1.0, f"(e) COMQ's loss "
          f"{losses['comq_blocked']} is 1.0 or more above the float "
          f"model's {base}")
    del learned
    t_part = took("(e)", t_part)

    # (f) the same run with int8 moments (its final checkpoint unread)
    acfg8 = AdamWConfig(moment_dtype="int8")
    torch.cuda.reset_peak_memory_stats(dev)
    held8 = torch.cuda.memory_allocated(dev) / 2 ** 30    # (c)'s params too
    ops.reset_launch_counts()
    with SaveFilter(lambda step: False) as unsaved:
        out, l8 = fit(torch, cfg, fit_args(work / "f", "--moment-dtype",
                                           "int8"),
                      "(f) int8 moments", card, failure_hook=unsaved.hook)
    counts["adamw@int8"] = ops.launch_counts()["adamw"]
    check(counts["adamw@int8"] == n_leaves * FIT_STEPS, f"(f) the AdamW "
          f"kernel launched {counts['adamw@int8']} times, not "
          f"{n_leaves} x {FIT_STEPS}")
    peak8 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    state = out["state"]
    del out
    opt_bytes = sum(t.numel() * t.element_size() for t in
                    torch.utils._pytree.tree_leaves((state["opt"]["m"],
                                                     state["opt"]["v"])))
    # JAX's test_int8_moments_track_f32 figure on this run: max |p8 - p32|
    # over max |p32 - p0| (it gates < 0.1 on its own gradients)
    p0 = init_params(cfg, seed=0, device=dev)
    diff = scale = 0.0
    for a, b, c in zip(*(torch.utils._pytree.tree_leaves(t)
                         for t in (state["params"], trained, p0))):
        diff = max(diff, float((a - b).abs().max()))
        scale = max(scale, float((b - c).abs().max()))
    del p0, trained
    gaps = [abs(a - b) for a, b in zip(l8, l32)]
    say(f"training (f) losses {[round(x, 4) for x in l8]}; |int8 - f32| a "
        f"step up to {max(gaps):.4f} (step {gaps.index(max(gaps))}), last "
        f"{gaps[-1]:.4f}; max|p8 - p32| / max|p32 - p0| {diff / scale:.4f} "
        f"(JAX's figure; it gates 0.1 on its own gradients; printed); "
        f"optimizer state {opt_bytes / n_params:.4f} bytes a parameter (f32 "
        f"moments: 8); peak device memory {peak8:.2f} GiB, "
        f"{peak8 - held8:.2f} above the {held8:.2f} held before the run (f32 "
        f"moments: {peak - held32:.2f} above) ({card})")
    check(all(math.isfinite(x) for x in l8), f"(f) a non-finite loss: {l8}")
    nb = {k: torch.from_numpy(v).to(dev) for k, v in
          SyntheticLM(cfg.vocab_size, seed=0).sample(
              FIT_BATCH, FIT_SEQ, FIT_STEPS).items()}
    _, grads = _loss_and_grads(cfg, BuildPlan(remat=False), 1,
                               state["params"], nb)
    opt_parity(torch, state, grads, acfg8, card)
    del state, grads
    t_part = took("(f)", t_part)

    # (d) a kill at step TRAIN_KILL with a checkpoint every
    # TRAIN_CKPT_EVERY steps, resumed by run_with_restarts: the first
    # attempt's losses and the resumed one's equal (f)'s uninterrupted run
    # (the same config, schedule and stream). Only the checkpoint the
    # restart reads is written
    from repro_torch.launch import train
    killed = {"done": False}
    histories, made = [], []

    class Recorded(train.Trainer):
        """The launcher's Trainer, kept for its loss history."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def bomb(step):
        if step == TRAIN_KILL and not killed["done"]:
            killed["done"] = True
            raise RuntimeError("injected node failure")

    def attempt(resume_step):
        gc.collect()
        torch.cuda.empty_cache()
        n = len(made)
        try:
            # the loop stops at TRAIN_RESUMED_TO, the schedule is (f)'s
            out, _ = fit(torch, cfg, fit_args(work / "d", "--moment-dtype",
                                              "int8", "--steps",
                                              str(TRAIN_RESUMED_TO)),
                         f"(d) attempt from step {resume_step}", card,
                         failure_hook=saves.hook, total_steps=FIT_STEPS,
                         ckpt_every=TRAIN_CKPT_EVERY)
            return out["final_step"]
        finally:
            histories.append((resume_step, [m["loss"] for m in
                                            made[n].metrics_log]))

    t0 = time.time()
    train.Trainer = Recorded
    try:
        with SaveFilter(lambda step: step == TRAIN_CKPT_EVERY,
                        then=bomb) as saves:
            final = run_with_restarts(
                attempt,
                lambda: CheckpointManager(str(work / "d")).latest_step(),
                max_restarts=2)
    finally:
        train.Trainer = Recorded.__mro__[1]
    wall = time.time() - t0
    (first_from, first), (resumed_from, resumed) = histories
    diff = max(abs(a - b) for a, b in zip(
        first + resumed, l8[:len(first)]
        + l8[resumed_from:resumed_from + len(resumed)]))
    say(f"training (d) killed at step {TRAIN_KILL}, checkpoints every "
        f"{TRAIN_CKPT_EVERY}: attempts from step {first_from} ({len(first)} "
        f"steps) and {resumed_from} ({len(resumed)} steps), final step "
        f"{final} in {wall:.1f} s wall; max |d| of the losses against the "
        f"uninterrupted run (f): {diff:.3e} ({card})")
    check(killed["done"] and final == TRAIN_RESUMED_TO
          and resumed_from == TRAIN_CKPT_EVERY and first == l8[:TRAIN_KILL]
          and resumed == l8[TRAIN_CKPT_EVERY:TRAIN_RESUMED_TO],
          f"(d) the resumed run's losses differ from the uninterrupted "
          f"run's (max |d| {diff})")
    # (d)'s step-5 checkpoint, moved (not copied: the machine's disk
    # counts every byte written) for phase 21 (d)'s elastic restore
    ckpt19 = (Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt19_")) / "d",
              resumed)
    shutil.move(str(work / "d"), str(ckpt19[0]))
    shutil.rmtree(work, ignore_errors=True)
    t_part = took("(d)", t_part)

    # (g) the other families, one at a time
    families = {}
    for arch, layers, B, T, _ in FAMILY_TRAIN:
        families[arch] = family_step(torch, flash, ops, kernels, arch,
                                     layers, B, T, dev, card)
        t_part = took(f"(g) {arch}", t_part)
    spent = time.time() - t_phase
    say(f"training: phase 19 took {spent:.1f} s wall (budget "
        f"{TRAIN_BUDGET_S} s)")
    return counts, families, ckpt19


# ---------------------------------------------------------------------------
# phase 20: analysis (the contract gate on the card; a decode step's bytes
# and roofline)
# ---------------------------------------------------------------------------

ANALYSIS_GATE_TIMEOUT = 900      # seconds the gate's process may take
# (b), (c): phase 4's 2-layer qwen at full width, 8 slots each holding
# ANALYSIS_LIVE tokens on 16-token pages of its own
ANALYSIS_SLOTS, ANALYSIS_BS, ANALYSIS_MAXB = 8, 16, 256
ANALYSIS_LIVE = 4000
# predicted-over-counted bf16 / int8 decode-step bytes (PERF.md §6):
# both sides share the weights and the KV pages; they differ by the
# embedding table (predicted, not read), the lm_head's bf16 copy and the
# eager int8 append's f32 page passes (counted, not predicted)
ANALYSIS_RATIO_BAND = (0.9, 1.1)
ANALYSIS_STEP_ITERS = 20


def analysis_gate(card, work: Path):
    """(a) `python -m repro_torch.analysis.cli --gate` on the card, in its
    own process: the lint, every registry entry's contract (its census and
    in-place audit) with its kernels launched, and the runtime's
    signature budgets. Returns its --json results."""
    import os
    out = work / "gate.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.cli", "--gate",
         "--json", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=ANALYSIS_GATE_TIMEOUT)
    res = json.loads(out.read_text()) if out.exists() else {}
    for line in proc.stdout.splitlines():
        say(f"  gate: {line}")
    if proc.returncode != 0:
        say(proc.stderr[-3000:])
    say(f"analysis (a) gate on the card: exit {proc.returncode}, "
        f"{time.time() - t0:.1f} s wall incl. process start ({card})")
    check(proc.returncode == 0 and res.get("failures") == 0,
          f"(a) the analysis gate failed: exit {proc.returncode}")
    contracts = res["contracts"]
    check(len(contracts) == 9 and not any(
        r["skipped"] or r["violations"] for r in contracts.values()),
          f"(a) a registry entry was skipped or violated: {contracts}")
    return res


def phase_analysis(torch, dev, ops, sp, cfg, card):
    """Phase 20. (a) the contract gate on the card; (b) one decode step of
    phase 4's 2-layer qwen at full width (ANALYSIS_SLOTS slots at
    ANALYSIS_LIVE tokens, bf16 and int8 pages): count_cost's bytes beside
    decode_step_bytes(mode="pallas"), and the bf16-over-int8 ratio of the
    two gated within ANALYSIS_RATIO_BAND; (c) that step's roofline_terms
    beside its device time (CUDA events). Returns the gate's results."""
    import tempfile

    from repro_torch.models import BuildPlan
    from repro_torch.models.model import decode_step_paged
    from repro_torch.roofline.analysis import H100, count_cost, \
        roofline_terms
    from repro_torch.roofline.kv_bytes import (decode_step_bytes,
                                               decode_step_inputs)
    from repro_torch.serve import Runtime, ServeConfig
    gate = analysis_gate(card, Path(tempfile.mkdtemp(
        prefix="chip_smoke_analysis_")))
    sc = ServeConfig(max_slots=ANALYSIS_SLOTS, block_size=ANALYSIS_BS,
                     num_blocks=ANALYSIS_SLOTS * ANALYSIS_MAXB,
                     buckets=(PROMPT,), max_blocks_per_slot=ANALYSIS_MAXB)
    rows = {}
    for kv_bits in (0, 8):
        plan = BuildPlan(kv_bits=kv_bits)
        rt = Runtime(sp, cfg, plan, sc, device=dev)
        args = (rt.params, cfg, rt.plan, rt.pool,
                *decode_step_inputs(rt, ANALYSIS_LIVE))
        ops.reset_launch_counts()
        with torch.no_grad():
            cost = count_cost(decode_step_paged, *args)
            torch.cuda.synchronize()
            counted = ops.launch_counts()
            ms = cuda_ms(torch, lambda i: decode_step_paged(*args),
                         ANALYSIS_STEP_ITERS)
            # 22(b): the same step replayed from the runtime's graph (its
            # first call captures; each replay rewrites the same rows)
            replay_ms = cuda_ms(torch, lambda i: rt._decode(*args),
                                ANALYSIS_STEP_ITERS)
        pred = decode_step_bytes(
            sp, cfg, plan, max_slots=ANALYSIS_SLOTS, block_size=ANALYSIS_BS,
            max_blocks_per_slot=ANALYSIS_MAXB, num_blocks=sc.num_blocks,
            mode="pallas", live_tokens=ANALYSIS_LIVE)
        terms = roofline_terms(cost, H100, kind="bf16")
        label = f"kv_bits={kv_bits} ({'int8' if kv_bits else 'bf16'} pages)"
        attn = "paged_attention_quant" if kv_bits else "paged_attention"
        check(counted[attn] == cfg.n_layers and counted["quant_matmul"] > 0,
              f"(b) {label}: the counted step launched {counted}")
        say(f"analysis (b) decode step {label}, {ANALYSIS_SLOTS} slots x "
            f"{ANALYSIS_LIVE} tokens: count_cost bytes {cost.bytes_accessed:.0f}"
            f", flops {cost.flops:.0f}; decode_step_bytes(pallas) total "
            f"{pred['total']:.0f} (weights {pred['weights']:.0f}, kv "
            f"{pred['kv_total']:.0f}, logits {pred['logits']:.0f}), per "
            f"token {pred['per_token']:.0f}; launches {counted}")
        say(f"analysis (c) decode step {label}: roofline_terms compute_s "
            f"{terms['compute_s']:.6e}, memory_s {terms['memory_s']:.6e}, "
            f"collective_s {terms['collective_s']:.6e}, dominant "
            f"{terms['dominant']}, bound {terms['bound_s'] * 1e3:.4f} ms; "
            f"measured {ms:.4f} ms a step (CUDA events, mean of "
            f"{ANALYSIS_STEP_ITERS}), {terms['bound_s'] * 1e3 / ms:.3f} of "
            f"the bound ({card})")
        bound = terms["bound_s"] * 1e3
        say(f"graphs (b) decode step {label}: eager {ms:.4f} ms, replayed "
            f"{replay_ms:.4f} ms a step (CUDA events, mean of "
            f"{ANALYSIS_STEP_ITERS}); bound {bound:.4f} ms: eager "
            f"{bound / ms:.3f}, replayed {bound / replay_ms:.3f} of it; "
            f"graph pool {rt.graph_pool_bytes()} bytes ({card})")
        rows[kv_bits] = (cost.bytes_accessed, pred["total"])
        del rt, args
        torch.cuda.empty_cache()
    measured = rows[0][0] / rows[8][0]
    predicted = rows[0][1] / rows[8][1]
    rr = predicted / measured
    lo, hi = ANALYSIS_RATIO_BAND
    say(f"analysis (b) bf16 / int8 decode-step bytes: predicted "
        f"{predicted:.4f}, counted {measured:.4f}, ratio_of_ratios {rr:.4f} "
        f"(gate [{lo}, {hi}])")
    check(lo <= rr <= hi, f"(b) ratio_of_ratios {rr} outside [{lo}, {hi}]")
    return gate


# ---------------------------------------------------------------------------
# phase 21: tensor-parallel padding (the head-map kernels, padded models,
# the elastic restore, the dry run)
# ---------------------------------------------------------------------------

# (arch, tp, layers): hymba's 25 heads over 5 pad to 32 at tp = 16, an
# uneven map (KV head 0 serves 12 heads, the others 5); qwen2-7b's 28 over
# 4 pad to 30 at tp = 3 (groups of 9, 7, 7, 7)
PAD_HYMBA = ("hymba-1.5b", 16, 4)
PAD_QWEN = ("qwen2-7b", 3, 2)
PAD_FLASH_SHAPES = ((8, PROMPT), (1, 2 * HYBRID_WINDOW))
PAD_BWD_CASES = ((8, PROMPT, PROMPT, 32, 5, 64, True, HYBRID_WINDOW,
                  "hymba-tp16"),
                 (1, 2 * HYBRID_WINDOW, 2 * HYBRID_WINDOW, 32, 5, 64, True,
                  HYBRID_WINDOW, "hymba-tp16"))
PAD_BUDGET_S = 90        # phase 21's share of the script's time
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRYRUN_TIMEOUT = 600     # seconds the dry run's processes may take
# the kernels line's head-map rows: (name, source, results key, replaces)
PAD_ENTRIES = (
    ("flash_attention@hymba-1.5b/tp16", "flash_attention",
     ("flash_attention", 8, PROMPT, "hymba-tp16"),
     "src/repro/kernels/flash_attention.py:95"),
    ("flash_attention@hymba-1.5b/tp16/long", "flash_attention",
     ("flash_attention", 1, 2 * HYBRID_WINDOW, "hymba-tp16"),
     "src/repro/kernels/flash_attention.py:95"),
    ("flash_attention_bwd@hymba-1.5b/tp16", "flash_attention_bwd",
     ("flash_attention_bwd", 8, PROMPT, PROMPT, "hymba-tp16"),
     "src/repro/kernels/flash_attention.py:95"),
    ("flash_attention_bwd@hymba-1.5b/tp16/long", "flash_attention_bwd",
     ("flash_attention_bwd", 1, 2 * HYBRID_WINDOW, 2 * HYBRID_WINDOW,
      "hymba-tp16"), "src/repro/kernels/flash_attention.py:95"),
    ("paged_attention@qwen2-7b/tp3", "paged_attention",
     ("paged_attention", 0, "qwen-tp3"),
     "src/repro/kernels/paged_attention.py:219"),
    ("paged_attention_quant@qwen2-7b/tp3", "paged_attention",
     ("paged_attention_quant", 8, "qwen-tp3"),
     "src/repro/kernels/paged_attention.py:175"),
    ("paged_attention_quant@qwen2-7b/tp3/4bit", "paged_attention",
     ("paged_attention_quant", 4, "qwen-tp3"),
     "src/repro/kernels/paged_attention.py:175"),
)


def start_dryrun(work: Path):
    """(e)'s processes, one per qwen2-7b shape on both meshes, on the meta
    device with no card visible; they run while (a)-(d) use the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return [(shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-7b", "--shape", shape, "--both-meshes", "--out-dir",
         str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for shape in DRYRUN_SHAPES]


def finish_dryrun(procs, work: Path, card):
    """(e): every cell ran, and the roofline report reads every file (the
    collective column n/a: nothing was counted there)."""
    import contextlib as cl
    import io

    from repro_torch.roofline import report
    for shape, proc in procs:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        for line in out.strip().splitlines():
            say(f"phase 21 (e) dry run {shape}: {line}")
        check(proc.returncode == 0, f"(e) the dry run of qwen2-7b {shape} "
              f"exited {proc.returncode}")
    cells = report.load(str(work))
    for d in cells:
        mem = d.get("memory", {})
        say(f"phase 21 (e) {d['arch']} {d['shape']} {d['mesh']} on meta: "
            f"per_device_total_gb {mem.get('per_device_total_gb')} "
            f"(arguments {mem.get('argument_bytes')} + outputs "
            f"{mem.get('output_bytes')} - aliases {mem.get('alias_bytes')} "
            f"bytes; temporaries not counted), counted flops/device "
            f"{d.get('counted', {}).get('flops_per_device')}, count "
            f"{d.get('count_s')} s")
        check("error" not in d and mem.get("per_device_total_gb", 0) > 0,
              f"(e) {d.get('_file')}: {d.get('error')}")
    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        report.main(["--dir", str(work)])
    rows = [l for l in buf.getvalue().splitlines() if l.startswith("|")]
    for line in rows:
        say(f"phase 21 (e) report: {line}")
    body = rows[2:]
    check(len(cells) == 2 * len(DRYRUN_SHAPES) and len(body) == len(cells)
          and all(l.split("|")[7].strip() == "n/a" for l in body),
          f"(e) the report read {len(body)} of {len(cells)} cells")


def phase_padding(torch, dev, ops, kernels, results, card, ckpt19):
    """Phase 21. (a) the head-map kernels against their plain versions,
    (b) hymba at tp = 16 and (c) qwen2-7b at tp = 3 on the card (each
    path counted from 0), (d) the elastic restore of phase 19's state
    (`ckpt19`: its (d)'s checkpoint directory and unsharded resumed
    losses), (e) the dry run on meta. Returns {"total": the padded
    paths' launches by kernel, "entries": the launches of each
    PAD_ENTRIES row}."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.apply import fake_quantize_params
    from repro_torch.kernels import headmap
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.models.attention import kernel_head_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    _, flash, _, paged = kernels
    t_phase = time.time()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_pad_"))
    procs = start_dryrun(work / "dryrun")

    def took(what, t):
        say(f"phase 21: {what} took {time.time() - t:.1f} s wall")
        gc.collect()
        torch.cuda.empty_cache()
        return time.time()

    try:
        # (a) the kernels at the padded maps
        arch, tp, layers = PAD_HYMBA
        full = get_config(arch)
        hplan = BuildPlan(tp=tp)
        hp, kv, hd = (hplan.heads_padded(full), full.n_kv_heads,
                      full.resolved_head_dim)
        hmap = kernel_head_map(full.n_heads, hp, kv)
        say(f"phase 21 (a) {arch} at tp={tp}: {full.n_heads} -> {hp} query "
            f"heads over {kv} KV heads, map {hmap} (groups "
            f"{headmap.group_sizes(hmap, hp, kv)}) ({card})")
        check_flash(torch, flash, dev, results, heads=(hp, kv, hd),
                    tag=("hymba-tp16",), shapes=PAD_FLASH_SHAPES,
                    window=HYBRID_WINDOW, head_map=hmap)
        check_flash_bwd(torch, flash, dev, results, card,
                        cases=PAD_BWD_CASES, head_map=hmap)
        qarch, qtp, qlayers = PAD_QWEN
        qfull = get_config(qarch)
        qplan = BuildPlan(tp=qtp)
        qhp = qplan.heads_padded(qfull)
        qmap = kernel_head_map(qfull.n_heads, qhp, qfull.n_kv_heads)
        say(f"phase 21 (a) {qarch} at tp={qtp}: {qfull.n_heads} -> {qhp} "
            f"query heads over {qfull.n_kv_heads}, groups "
            f"{headmap.group_sizes(qmap, qhp, qfull.n_kv_heads)}")
        check_paged(torch, paged, dev, results,
                    heads=(qhp, qfull.n_kv_heads, qfull.resolved_head_dim),
                    tag=("qwen-tp3",), head_map=qmap)
        t_part = took("(a)", t_phase)

        # (b) hymba at tp = 16, depth cut: a prefill of 8 x PROMPT and
        # STEPS decode steps and one training step, counted; then each
        # against the plain versions
        cfg = full.replace(n_layers=layers)
        params = init_params(cfg, hplan, seed=0, device=dev)
        say(f"phase 21 (b) {arch} at BuildPlan(tp={tp}), n_layers "
            f"{full.n_layers} -> {layers}: heads {hp}/{kv}, vocab "
            f"{full.vocab_size} -> {hplan.vocab_padded(cfg)}, "
            f"{sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))}"
            f" parameters")
        gen = torch.Generator(device=dev).manual_seed(21)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_SLOTS, PROMPT),
                               generator=gen, device=dev)
        dplan = hplan.replace(prefill_cache_len=PROMPT + STEPS)
        batch = family_batch(torch, cfg, 1, 2 * HYBRID_WINDOW, dev, 0)
        step = make_train_step(cfg, hplan.replace(remat=False),
                               RunConfig(arch=arch, learning_rate=FIT_LR,
                                         warmup_steps=1,
                                         total_steps=FIT_STEPS),
                               AdamWConfig())
        state = init_train_state(params, AdamWConfig())
        ops.reset_launch_counts()
        with torch.no_grad():
            outs, _ = run_decode(torch, params, cfg, dplan, tokens)
        _, m = step(state, batch)
        loss = float(m["loss"])
        counts_b = ops.launch_counts()
        del state, step, outs
        say(f"phase 21 (b) path: prefill {SERVE_SLOTS}x{PROMPT} + {STEPS} "
            f"decode steps, one train step of 1x{2 * HYBRID_WINDOW} (loss "
            f"{loss:.4f}); launches {counts_b}")
        check(math.isfinite(loss) and counts_b["flash_attention"] > 0
              and counts_b["flash_attention_bwd"] == layers,
              f"(b) the padded hymba path launched {counts_b}")
        decode_vs_plain(torch, ops, kernels, params, cfg, dplan, tokens,
                        f"phase 21 (b) {arch} tp={tp} decode")
        step_grads(torch, flash, ops, kernels, cfg, params, batch,
                   "bfloat16", card, what=f"phase 21 (b) {arch} tp={tp}",
                   n_attn=layers, plan=hplan)
        del params, batch
        t_part = took("(b)", t_part)

        # (c) qwen2-7b at tp = 3, depth cut, 4-bit fake-quantized: phase 8's
        # traffic through the paged Runtime at kv_bits 0, 8 and 4 (counted;
        # every request runs to its length), then phase 7's paged decode
        # against the plain versions in lockstep
        qcfg = qfull.replace(n_layers=qlayers)
        dense = init_params(qcfg, qplan, seed=0, device=dev)
        sp = fake_quantize_params(dense, qcfg, qplan, bits=4,
                                  quantize_embed=False)
        del dense
        say(f"phase 21 (c) {qarch} at BuildPlan(tp={qtp}), n_layers "
            f"{qfull.n_layers} -> {qlayers}, 4-bit RTN codes "
            f"(fake_quantize_params): heads {qhp}/{qfull.n_kv_heads}, vocab "
            f"{qfull.vocab_size} -> {qplan.vocab_padded(qcfg)}")
        prompts = serve_prompts(qcfg.vocab_size)
        tokens = torch.randint(0, qcfg.vocab_size, (SERVE_SLOTS, PROMPT),
                               generator=gen, device=dev)
        ops.reset_launch_counts()
        with torch.no_grad():
            for kv_bits in (0, 8, 4):
                serve_traffic(torch, dev, sp, qcfg,
                              qplan.replace(kv_bits=kv_bits), prompts,
                              serve_config(),
                              f"phase 21 (c) tp={qtp} bf16 kv_bits={kv_bits}")
        counts_c = ops.launch_counts()
        say(f"phase 21 (c) serve path launches: {counts_c}")
        check(all(counts_c[n] > 0 for n in SERVE_PATH),
              f"(c) a kernel of the padded serve path never launched: "
              f"{counts_c}")
        lens = [int(n) for n in np.random.RandomState(5).randint(
            64, PROMPT + 1, SERVE_SLOTS)]
        q32 = qcfg.replace(compute_dtype="float32")
        for kv_bits in (0, 8, 4):
            for label, c, pl in (
                    ("bfloat16", qcfg, qplan.replace(kv_bits=kv_bits)),
                    ("float32", q32, qplan.replace(
                        cache_dtype=torch.float32, kv_bits=kv_bits))):
                snaps = []
                with torch.no_grad():
                    outs, fed, _ = run_paged_decode(
                        torch, sp, c, pl, tokens, lens, snapshots=snaps)
                compare_decode(torch, ops, kernels, lambda: run_paged_decode(
                    torch, sp, c, pl, tokens, lens, feed=fed,
                    lockstep=snaps)[0], outs, label,
                    what=f"phase 21 (c) tp={qtp} paged decode "
                         f"kv_bits={kv_bits}, lockstep",
                    vocab=qcfg.vocab_size)
                del snaps, outs
        del sp
        t_part = took("(c)", t_part)

        # (d) phase 19 (d)'s step-5 state restored through
        # restore(shardings=) on an nccl world of one: the resumed losses
        # equal 19 (d)'s unsharded resume's. It reads 19 (d)'s directory
        # and writes no checkpoint (a 4-layer state is ~12 GB)
        ckpt_dir, plain = ckpt19
        from repro_torch import dist as rd
        from repro_torch.dist.sharding import P, NamedSharding
        from repro_torch.launch import train
        from repro_torch.train.trainer import Trainer
        tcfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)

        def resumed(name, **kw):
            args = fit_args(ckpt_dir, "--moment-dtype", "int8", "--steps",
                            str(TRAIN_RESUMED_TO))
            rc = dataclasses.replace(
                train.run_config(args), warmup_steps=FIT_WARMUP,
                async_ckpt=False, total_steps=FIT_STEPS,
                ckpt_every=TRAIN_CKPT_EVERY)
            with SaveFilter(lambda step: False) as saves:
                t = Trainer(tcfg, BuildPlan(remat=args.remat), rc,
                            adamw_cfg=AdamWConfig(moment_dtype="int8"),
                            failure_hook=saves.hook, device=dev, **kw)
                out = t.run_loop(total_steps=TRAIN_RESUMED_TO,
                                 seq_len=FIT_SEQ, global_batch=FIT_BATCH)
            check(out["final_step"] == TRAIN_RESUMED_TO,
                  f"(d) {name} ended at step {out['final_step']}")
            return [m["loss"] for m in t.metrics_log]

        _, started = rd.init_world("nccl", dev)
        try:
            mesh = rd.calib_mesh(model=1, data=1)

            def shard(state):
                return torch.utils._pytree.tree_map(
                    lambda t: NamedSharding(mesh, P("data") if t.dim()
                                            else P()), state)
            sharded = resumed("sharded", shard_state_fn=shard)
        finally:
            rd.close_world(started)
        say(f"phase 21 (d) phase 19's step-{TRAIN_CKPT_EVERY} state restored "
            f"with shardings= (every leaf Shard(0) over the data axis of an "
            f"nccl world of one): resumed losses {sharded}; 19 (d)'s "
            f"unsharded resume {plain}; bit-identical {sharded == plain} "
            f"({card})")
        check(len(plain) == TRAIN_RESUMED_TO - TRAIN_CKPT_EVERY
              and sharded == plain, "(d) the elastic resume's losses differ "
              "from the unsharded resume's")
        t_part = took("(d)", t_part)

        # (e) the dry run, started with the phase
        finish_dryrun(procs, work / "dryrun", card)
        took("(e) (waiting for the dry run)", t_part)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(ckpt19[0].parent, ignore_errors=True)
    spent = time.time() - t_phase
    say(f"phase 21 took {spent:.1f} s wall (budget {PAD_BUDGET_S} s) "
        f"({card})")
    total = {n: counts_b.get(n, 0) + counts_c.get(n, 0)
             for n in set(counts_b) | set(counts_c)}
    entries = {}
    for name, source, key, _ in PAD_ENTRIES:
        counts = counts_b if "hymba" in name else counts_c
        kernel = name.split("@")[0]
        entries[name] = counts[kernel]
    return {"total": total, "entries": entries}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch — run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import comq_quantize_blocked
    from repro_torch.core.apply import serving_params
    from repro_torch.core.calibrate import gram_from_tap
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import comq_panel as panel
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.launch.quantize import quantize_and_eval, set_precision
    from repro_torch.models import BuildPlan, embed_tokens
    from repro_torch.models.transformer import layer_full
    from repro_torch.serve import Runtime

    set_precision()
    dev = torch.device("cuda", 0)
    t_all = time.time()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"device: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    # 2. build
    t0 = time.time()
    secs = build.build()
    say(f"build: {time.time() - t0:.1f} s wall; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in build.SOURCES:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    say(f"chip_smoke: phase 2 (build) done at {time.time() - t_all:.1f} s")

    # 3. each kernel against its plain version
    results = {}
    check_panel(torch, panel, dev, results)
    check_flash(torch, flash, dev, results)
    check_qmm(torch, qmm, dev, results, qwen_qmm_cases(torch))
    check_paged(torch, paged, dev, results)

    say(f"chip_smoke: phase 3 done at {time.time() - t_all:.1f} s")

    # 4. quantize (main path, counted)
    cfg = get_config("qwen2-7b").replace(n_layers=2)
    say(f"reduced: n_layers 28 -> 2 (all widths full: d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})")
    ops.reset_launch_counts()
    t0 = time.time()
    run = quantize_and_eval(cfg, method="comq_blocked", calib_batch=8,
                            calib_seq=PROMPT, device=dev)
    s = run.summary
    say(f"quantize: {json.dumps(s)}")
    # phase 4's packed model, for phase 18's sharded runtime
    import tempfile
    qpk = Path(tempfile.mkdtemp(prefix="chip_smoke_qpk_")) / "phase4.qpk"
    write_qpk(qpk, run.qparams["__qlayers__"])
    say(f"quantize: {time.time() - t0:.1f} s wall incl. init and eval; "
        f"launches so far {ops.launch_counts()}")
    imp = s["comq_vs_rtn_error_improvement"]
    check(math.isfinite(imp) and imp > 0,
          f"comq_vs_rtn_error_improvement {imp}")
    gap = abs(s["quant_loss"] - s["fp_loss"])
    check(gap <= LOSS_GAP, f"|quant_loss - fp_loss| = {gap} > {LOSS_GAP}")
    counts = ops.launch_counts()
    check(counts["comq_panel"] > 0 and counts["flash_attention"] > 0,
          f"quantize did not launch the kernels: {counts}")

    # 5. decode from the packed codes (main path, counted)
    sp = serving_params(run.qparams, cfg)
    plan = BuildPlan(prefill_cache_len=PROMPT + STEPS)
    t0 = time.time()
    with torch.no_grad():
        outs, fed = run_decode(torch, sp, cfg, plan, run.eval_tokens)
    say(f"decode: prefill 8x{PROMPT} + {STEPS} steps in "
        f"{time.time() - t0:.2f} s wall")
    path_counts = ops.launch_counts()
    say(f"quantize + decode path launches: {path_counts}")
    check(all(path_counts[n] > 0 for n in SLICE1),
          f"a kernel of the quantize + decode path never launched: "
          f"{path_counts}")
    kernels = (panel, flash, qmm, paged)
    compare_decode(torch, ops, kernels, lambda: run_decode(
        torch, sp, cfg, plan, run.eval_tokens, feed=fed)[0], outs,
        "bfloat16")
    # the same steps at f32 compute with an f32 cache (outside the counted
    # main path)
    cfg32 = cfg.replace(compute_dtype="float32")
    plan32 = plan.replace(cache_dtype=torch.float32)
    with torch.no_grad():
        outs32, _ = run_decode(torch, sp, cfg32, plan32, run.eval_tokens,
                               feed=fed)
    compare_decode(torch, ops, kernels, lambda: run_decode(
        torch, sp, cfg32, plan32, run.eval_tokens, feed=fed)[0], outs32,
        "float32")
    del outs, outs32

    # 6. one w_down leaf: panel kernel vs plain panel version
    with torch.no_grad():
        lp = run.params["layers"][0]
        taps = {}
        x = embed_tokens(run.params, cfg, BuildPlan(), run.calib_tokens)
        layer_full(lp, x, cfg, BuildPlan(), False, taps=taps)
        h = gram_from_tap(taps["down_in"])
        del taps, x
        w = lp["mlp"]["w_down"]
        spec = run.spec
        errs = {}
        for label, fn in (("kernel", None),
                          ("plain", panel.comq_panel_dq_plain)):
            torch.cuda.synchronize()
            t0 = time.time()
            r = comq_quantize_blocked(h, w, spec, panel_fn=fn)
            torch.cuda.synchronize()
            errs[label] = float(r.errors[-1])
            say(f"w_down {tuple(w.shape)} solve with {label} panel: error "
                f"trajectory {[round(float(e), 4) for e in r.errors]}, "
                f"{time.time() - t0:.2f} s wall")
        rel = abs(errs["kernel"] - errs["plain"]) / errs["plain"]
        say(f"w_down final error kernel vs plain: rel {rel:.3e} (tol "
            f"{WDOWN_REL})")
        check(rel <= WDOWN_REL, f"w_down final error differs by {rel}")
        del h, r

    say(f"chip_smoke: phase 4-6 done at {time.time() - t_all:.1f} s")

    # 7. paged decode, kernels vs plain versions, teacher-forced. The gate
    # is lockstep: step i of the plain run starts from the kernel run's
    # pool before step i, so it measures each step's kernels. A free-running
    # plain run is printed beside it: with quantized pages, a K/V value that
    # lands within rounding of a code boundary can take the other code in
    # the two runs and stay in the pool, which moves later logits by far
    # more than the kernels' own difference (PERF.md, PR 12).
    lens = [int(n) for n in np.random.RandomState(5).randint(64, PROMPT + 1,
                                                             8)]
    say(f"paged decode: prompt lengths {lens}")
    for kv_bits in (0, 8, 4):
        for label, c, pl in (
                ("bfloat16", cfg, BuildPlan(kv_bits=kv_bits)),
                ("float32", cfg32, BuildPlan(cache_dtype=torch.float32,
                                             kv_bits=kv_bits))):
            snaps = []
            with torch.no_grad():
                outs, fed, pool = run_paged_decode(
                    torch, sp, c, pl, run.eval_tokens, lens, snapshots=snaps)
            compare_decode(torch, ops, kernels, lambda: run_paged_decode(
                torch, sp, c, pl, run.eval_tokens, lens, feed=fed,
                lockstep=snaps)[0], outs, label,
                what=f"paged decode kv_bits={kv_bits}")
            del snaps
            with torch.no_grad(), plain_kernels(ops, kernels):
                free, _, free_pool = run_paged_decode(
                    torch, sp, c, pl, run.eval_tokens, lens, feed=fed)
            worst = max(float((a - b).abs().max()) / float(b.abs().max())
                        for a, b in zip(outs, free))
            say(f"paged decode kv_bits={kv_bits} {label}, free-running plain "
                f"run: worst step rel {worst:.3e}; final pools: "
                f"{pool_gap(torch, pool, free_pool)}")

    say(f"chip_smoke: phase 7 done at {time.time() - t_all:.1f} s")

    # 8. serve (the serve path, counted), then f32 token identity
    prompts = serve_prompts(cfg.vocab_size)
    say(f"serve prompts: lengths {[len(p) for p in prompts]}")
    ops.reset_launch_counts()
    with torch.no_grad():
        for kv_bits in (0, 8, 4):
            n0, tc0 = paged.launches_quant, paged.launches_quant_tc
            serve_traffic(torch, dev, sp, cfg, BuildPlan(kv_bits=kv_bits),
                          prompts, serve_config(), f"bf16 kv_bits={kv_bits}")
            if kv_bits:
                n = paged.launches_quant - n0
                tc = paged.launches_quant_tc - tc0
                say(f"serve bf16 kv_bits={kv_bits}: paged_attention_quant "
                    f"launches {n}, {tc} of them on the tensor-core kernel")
                check(n > 0 and tc == n, f"serve bf16 kv_bits={kv_bits}: "
                      f"{tc} of {n} quantized-pool launches on tensor cores")
    serve_counts = ops.launch_counts()
    say(f"serve path launches: {serve_counts}")
    check(all(serve_counts[n] > 0 for n in SERVE_PATH),
          f"a kernel of the serve path never launched: {serve_counts}")
    totals = {n: path_counts[n] + serve_counts[n] for n in INFER_KERNELS}
    say(f"main path launches (quantize + decode + serve): {totals}")
    check(all(v > 0 for v in totals.values()),
          f"a kernel of the main path never launched: {totals}")
    plan32 = BuildPlan(cache_dtype=torch.float32)
    with torch.no_grad():
        _, reqs = serve_traffic(torch, dev, sp, cfg32, plan32, prompts,
                                serve_config(), "f32 kv_bits=0 mixed")
        solo_rt = Runtime(sp, cfg32, plan32, serve_config(), device=dev)
        solo = [solo_rt.generate([p], max_new_tokens=SERVE_NEW)[0].tolist()
                for p in prompts]
        same = sum(r.out_tokens == t for r, t in zip(reqs, solo))
        say(f"serve f32: mixed == solo for {same}/{len(solo)} requests")
        check(same == len(solo), "serve f32: a mixed-traffic request "
              "differs from its solo run")
        rt, reqs = serve_traffic(torch, dev, sp, cfg32, plan32, prompts,
                                 serve_config(num_blocks=SMALL_POOL),
                                 f"f32 kv_bits=0 pool of {SMALL_POOL} pages")
        check(rt.scheduler.preemptions > 0,
              "serve f32: the small pool never preempted")
        same = sum(r.out_tokens == t for r, t in zip(reqs, solo))
        tok = sum(a == b for r, t in zip(reqs, solo)
                  for a, b in zip(r.out_tokens, t))
        say(f"serve f32 under preemption: {same}/{len(solo)} requests and "
            f"{tok}/{SERVE_NEW * len(solo)} tokens equal their solo runs")

    say(f"chip_smoke: phase 8 done at {time.time() - t_all:.1f} s")

    # 9. mixed-precision policies (the policy path, counted)
    policy_counts = phase_policy(torch, dev, cfg, cfg32, ops, kernels,
                                 prompts, qmm, paged)
    del run

    say(f"chip_smoke: phase 9 done at {time.time() - t_all:.1f} s")

    # 16. durability (its quantize and serve runs counted), while the
    # phase-4 model is still on the card
    dur_counts = phase_durability(torch, dev, ops, kernels, sp, cfg, prompts,
                                  card)

    say(f"chip_smoke: phase 16 done at {time.time() - t_all:.1f} s")

    # 17. observability (its traced runs counted), on the phase-4 model
    obs_counts = phase_observability(torch, dev, ops, kernels, sp, cfg,
                                     prompts, card)

    say(f"chip_smoke: phase 17 done at {time.time() - t_all:.1f} s")

    # 20. analysis: the contract gate on the card, then the phase-4 model's
    # decode-step bytes and roofline (not counted in the kernels line)
    t0 = time.time()
    phase_analysis(torch, dev, ops, sp, cfg, card)
    say(f"analysis: phase 20 in {time.time() - t0:.1f} s")
    # 22. the serving steps as CUDA graphs, on the phase-4 model (its (b)
    # ran in phase 20, its (e) and (f) run in phases 10-14)
    phase_graphs(torch, dev, sp, cfg, prompts, card)
    # the phase-4 model's last holders (~6.6 GiB: phase 8's runtimes serve
    # sp, phase 6 kept layer 0), so that phase 18's ranks find the card
    del sp, rt, solo_rt, reqs, lp, w, outs, free, pool, free_pool

    say(f"chip_smoke: phase 20 done at {time.time() - t_all:.1f} s")

    # 10. the MoE family: its kernels, then the MoE path, counted
    moe_cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    say(f"moe reduced: n_layers 32 -> {MOE_LAYERS} (all widths full: "
        f"d_model {moe_cfg.d_model}, heads {moe_cfg.n_heads}/"
        f"{moe_cfg.n_kv_heads}, head_dim {moe_cfg.resolved_head_dim}, d_ff "
        f"{moe_cfg.d_ff} an expert, {moe_cfg.moe.n_experts} experts top-"
        f"{moe_cfg.moe.top_k}, vocab {moe_cfg.vocab_size})")
    check_moe_kernels(torch, dev, kernels, results, moe_cfg)
    moe_counts, moe_batched = phase_moe(torch, dev, ops, kernels, moe_cfg,
                                        card)

    say(f"chip_smoke: phase 10 done at {time.time() - t_all:.1f} s")

    # 11. the hybrid family: its kernels, then the hybrid path, counted
    hyb_cfg = get_config(HYBRID_ARCH).replace(n_layers=HYBRID_LAYERS)
    say(f"hybrid reduced: n_layers 32 -> {HYBRID_LAYERS} (all widths full: "
        f"d_model {hyb_cfg.d_model}, heads {hyb_cfg.n_heads}/"
        f"{hyb_cfg.n_kv_heads}, head_dim {hyb_cfg.resolved_head_dim}, d_ff "
        f"{hyb_cfg.d_ff}, vocab {hyb_cfg.vocab_size}, window "
        f"{hyb_cfg.sliding_window}, SSM d_inner "
        f"{hyb_cfg.ssm.expand * hyb_cfg.d_model} state "
        f"{hyb_cfg.ssm.state_dim}); then {HYBRID_FULL_LAYERS} layers for "
        f"the full-depth quantize")
    check_hybrid_kernels(torch, dev, kernels, results, hyb_cfg)
    hyb_counts = phase_hybrid(torch, dev, ops, kernels, hyb_cfg, card)

    say(f"chip_smoke: phase 11 done at {time.time() - t_all:.1f} s")

    # 12. the audio decoder: its kernels, then the audio path, counted
    audio_cfg = get_config(AUDIO_ARCH).replace(n_layers=AUDIO_LAYERS)
    say(f"audio reduced: n_layers {AUDIO_FULL_LAYERS} -> {AUDIO_LAYERS} "
        f"(all widths full: d_model {audio_cfg.d_model}, heads "
        f"{audio_cfg.n_heads}/{audio_cfg.n_kv_heads}, head_dim "
        f"{audio_cfg.resolved_head_dim}, d_ff {audio_cfg.d_ff}, vocab "
        f"{audio_cfg.vocab_size}, {audio_cfg.norm_type}, {audio_cfg.act}); "
        f"then {AUDIO_FULL_LAYERS} layers for the full-depth quantize")
    check_audio_kernels(torch, dev, kernels, results, audio_cfg)
    audio_counts = phase_audio(torch, dev, ops, kernels, audio_cfg, card)

    say(f"chip_smoke: phase 12 done at {time.time() - t_all:.1f} s")

    # 13. the attention-free family: its panels, the plain wkv, then the
    # rwkv path, counted
    rwkv_cfg = get_config(RWKV_ARCH).replace(n_layers=RWKV_LAYERS)
    say(f"rwkv reduced: n_layers 32 -> {RWKV_LAYERS} (all widths full: "
        f"d_model {rwkv_cfg.d_model}, {rwkv_cfg.n_heads} wkv heads of "
        f"{rwkv_cfg.rwkv.head_dim}, d_ff {rwkv_cfg.d_ff}, vocab "
        f"{rwkv_cfg.vocab_size}, LoRA {rwkv_cfg.rwkv.decay_lora}/"
        f"{rwkv_cfg.rwkv.gate_lora}/{rwkv_cfg.rwkv.token_shift_lora})")
    check_panel(torch, panel, dev, results, RWKV_PANEL)
    time_plain_wkv(torch, dev, rwkv_cfg)
    rwkv_counts = phase_rwkv(torch, dev, ops, kernels, rwkv_cfg, card)

    say(f"chip_smoke: phase 13 done at {time.time() - t_all:.1f} s")

    # 14. the VLM: its kernels, then the vlm path, counted
    vlm_cfg = get_config(VLM_ARCH).replace(n_layers=VLM_LAYERS)
    ca = vlm_cfg.cross_attn
    say(f"vlm reduced: n_layers 100 -> {VLM_LAYERS}, one group of "
        f"{ca.every - 1} self layers + 1 gated cross layer (n_layers must "
        f"divide into groups of {ca.every}; two groups' f32 weights, their "
        f"materialized copy and the codes pass the card's 80 GB); all "
        f"widths full: d_model {vlm_cfg.d_model}, heads {vlm_cfg.n_heads}/"
        f"{vlm_cfg.n_kv_heads}, head_dim {vlm_cfg.resolved_head_dim}, d_ff "
        f"{vlm_cfg.d_ff}, vocab {vlm_cfg.vocab_size}, {ca.n_vision_tokens} "
        f"image tokens of width {ca.vision_dim}")
    check_vlm_kernels(torch, dev, kernels, results, vlm_cfg)
    vlm_counts = phase_vlm(torch, dev, ops, kernels, vlm_cfg, card)

    say(f"chip_smoke: phase 14 done at {time.time() - t_all:.1f} s")

    # 15. the encoder: its kernels, then the encoder path, counted
    enc_cfg = get_config(ENC_ARCH)
    say(f"encoder: {ENC_ARCH} at full width and depth (n_layers "
        f"{enc_cfg.n_layers}, d_model {enc_cfg.d_model}, heads "
        f"{enc_cfg.n_heads}/{enc_cfg.n_kv_heads}, d_ff {enc_cfg.d_ff}, "
        f"{enc_cfg.vocab_size} classes, {ENC_T} tokens an image)")
    check_encoder_kernels(torch, dev, kernels, results, enc_cfg)
    enc_counts = phase_encoder(torch, dev, ops, kernels, enc_cfg)

    say(f"chip_smoke: phase 15 done at {time.time() - t_all:.1f} s")

    # 18. distribution: SPMD worlds sharing the card, each rank's launches
    # counted
    t0 = time.time()
    dist_counts = phase_distribution(torch, ops, qpk, card)
    say(f"distribution: phase 18 in {time.time() - t0:.1f} s; the ranks' "
        f"launches {dist_counts}")
    check(all(dist_counts.get(n, 0) > 0 for n in totals),
          f"a kernel never launched on the distributed path: {dist_counts}")

    say(f"chip_smoke: phase 18 done at {time.time() - t_all:.1f} s")

    # 19. training: the backward kernel, then the training path, counted
    train_counts, families, ckpt19 = phase_training(torch, dev, ops, kernels,
                                                    results, card)

    say(f"chip_smoke: phase 19 done at {time.time() - t_all:.1f} s")

    # 21. tensor-parallel padding: the head-map kernels, padded models on
    # the card (their paths counted), the elastic restore, the dry run
    pad_counts = phase_padding(torch, dev, ops, kernels, results, card,
                               ckpt19)

    say(f"chip_smoke: phase 21 done at {time.time() - t_all:.1f} s")

    # kernels line: launches on the main path as a whole
    src = "src/repro_torch/csrc/{}.cu"
    launches = {n: totals[n] + policy_counts[n] + dur_counts[n]
                + obs_counts[n] + moe_counts[n] + hyb_counts[n] + audio_counts[n]
                + rwkv_counts[n] + vlm_counts[n] + enc_counts[n]
                + dist_counts.get(n, 0) for n in totals}
    launches["flash_attention"] += train_counts["flash_attention"]
    launches["flash_attention_bwd"] = train_counts["flash_attention_bwd"]
    for n, v in pad_counts["total"].items():
        launches[n] = launches.get(n, 0) + v
    for n, v in pad_counts["entries"].items():
        launches[n] = v
    launches["adamw"] = (launches.get("adamw", 0) + train_counts["adamw"]
                         + sum(c["adamw"] for c in families.values()))
    launches["adamw@int8"] = train_counts["adamw@int8"]
    for arch, counts in families.items():
        launches["flash_attention"] += counts["flash_attention"]
        launches["flash_attention_bwd"] += counts["flash_attention_bwd"]
        launches[f"flash_attention_bwd@{arch}"] = counts[
            "flash_attention_bwd"]
    launches["comq_panel_batched"] = moe_batched
    for arch, path, counts in ((HYBRID_ARCH, HYBRID_PATH, hyb_counts),
                               (AUDIO_ARCH, AUDIO_PATH, audio_counts),
                               (RWKV_ARCH, RWKV_PATH, rwkv_counts),
                               (VLM_ARCH, VLM_PATH, vlm_counts),
                               (ENC_ARCH, ENC_PATH, enc_counts)):
        for n in path:
            launches[f"{n}@{arch}"] = counts[n]
    launches[f"flash_attention@{VLM_ARCH}/decode"] = vlm_counts[
        "flash_attention/decode"]
    entries = [
        ("comq_panel", "comq_panel", results[("comq_panel", 18944)],
         "src/repro/kernels/comq_panel.py:79"),
        ("flash_attention", "flash_attention",
         results[("flash_attention", 8, PROMPT)],
         "src/repro/kernels/flash_attention.py:95"),
        ("quant_matmul", "quant_matmul",
         results[("quant_matmul", 8, 3584, 18944, 2, "bfloat16")],
         "src/repro/kernels/quant_matmul.py:94"),
        ("paged_attention", "paged_attention",
         results[("paged_attention", 0)],
         "src/repro/kernels/paged_attention.py:219"),
        ("paged_attention_quant", "paged_attention",
         results[("paged_attention_quant", 8)],
         "src/repro/kernels/paged_attention.py:175"),
        # the expert-batched launch of the panel kernel (phase 10)
        ("comq_panel_batched", "comq_panel",
         results[("comq_panel_batched", 40, 1024)],
         "src/repro/kernels/comq_panel.py:79"),
        # hymba's new shapes (phase 11), with the hybrid path's launches
        # (also counted in the kernel's own row above)
        (f"comq_panel@{HYBRID_ARCH}", "comq_panel",
         results[("comq_panel", 6400)],
         "src/repro/kernels/comq_panel.py:79"),
        (f"flash_attention@{HYBRID_ARCH}", "flash_attention",
         results[("flash_attention", 1, 2 * HYBRID_WINDOW, "hymba")],
         "src/repro/kernels/flash_attention.py:95"),
        (f"quant_matmul@{HYBRID_ARCH}", "quant_matmul",
         results[("quant_matmul", 8, 1600, 5504, 2, "bfloat16")],
         "src/repro/kernels/quant_matmul.py:94"),
        # musicgen's new shapes (phase 12), with the audio path's launches
        (f"comq_panel@{AUDIO_ARCH}", "comq_panel",
         results[("comq_panel", 8192)],
         "src/repro/kernels/comq_panel.py:79"),
        (f"flash_attention@{AUDIO_ARCH}", "flash_attention",
         results[("flash_attention", 8, PROMPT, "musicgen")],
         "src/repro/kernels/flash_attention.py:95"),
        (f"quant_matmul@{AUDIO_ARCH}", "quant_matmul",
         results[("quant_matmul", 8, 2048, 8192, 2, "bfloat16")],
         "src/repro/kernels/quant_matmul.py:94"),
        (f"paged_attention@{AUDIO_ARCH}", "paged_attention",
         results[("paged_attention", 0, "musicgen")],
         "src/repro/kernels/paged_attention.py:219"),
        (f"paged_attention_quant@{AUDIO_ARCH}", "paged_attention",
         results[("paged_attention_quant", 8, "musicgen")],
         "src/repro/kernels/paged_attention.py:175"),
        # rwkv's widest panel (phase 13), with the rwkv path's launches
        (f"comq_panel@{RWKV_ARCH}", "comq_panel",
         results[("comq_panel", 14336)],
         "src/repro/kernels/comq_panel.py:79"),
        # the VLM's widest panel and its cross layers' non-causal flash in
        # prefill and decode (phase 14), with the vlm path's launches
        (f"comq_panel@{VLM_ARCH}", "comq_panel",
         results[("comq_panel", 28672)],
         "src/repro/kernels/comq_panel.py:79"),
        (f"flash_attention@{VLM_ARCH}", "flash_attention",
         results[("flash_attention", 8, PROMPT,
                  vlm_cfg.cross_attn.n_vision_tokens, "vlm")],
         "src/repro/kernels/flash_attention.py:95"),
        (f"flash_attention@{VLM_ARCH}/decode", "flash_attention",
         results[("flash_attention", 8, 1,
                  vlm_cfg.cross_attn.n_vision_tokens, "vlm")],
         "src/repro/kernels/flash_attention.py:95"),
        # the encoder's non-causal flash (phase 15), with the encoder
        # path's launches
        (f"flash_attention@{ENC_ARCH}", "flash_attention",
         results[("flash_attention", 8, ENC_T, ENC_T, "vit")],
         "src/repro/kernels/flash_attention.py:95"),
        # the gradient of flash_attention (phase 19), with the training
        # path's launches: the JAX package has no backward kernel (XLA
        # differentiates its checkpointed pair-scan), so it replaces the
        # forward kernel's differentiation
        ("flash_attention_bwd", "flash_attention_bwd",
         results[("flash_attention_bwd", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
                  "qwen")],
         "src/repro/kernels/flash_attention.py:95"),
    ]
    # the families' backward shapes (19a), with their steps' launches (g)
    entries += [(f"flash_attention_bwd@{arch}", "flash_attention_bwd",
                 results[("flash_attention_bwd", B, T, T, tag)],
                 "src/repro/kernels/flash_attention.py:95")
                for arch, _, B, T, tag in FAMILY_TRAIN if tag]
    # the head-map variants (phase 21 a), with the padded paths' launches
    # (b: hymba at tp = 16; c: qwen2-7b at tp = 3)
    entries += [(name, source, results[key], where)
                for name, source, key, where in PAD_ENTRIES]
    # the fused AdamW update (19a) at qwen's w_down, with the training
    # path's launches (f32 moments: 19c, 19g and 21b's step; int8: 19f):
    # no Pallas kernel, it replaces XLA's fusion of the JAX update
    entries += [(name, "adamw", results[("adamw", *ADAMW_ROW, moments)],
                 "src/repro/optim/adamw.py:154")
                for name, moments in (("adamw", "float32"),
                                      ("adamw@int8", "int8"))]
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src.format(source),
         "replaces": where, "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, source, r, where in entries]}))
    say(f"chip_smoke: all phases passed in {time.time() - t_all:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--dist-worker"]:
            code = dist_worker(*sys.argv[2:6])
        else:
            code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
