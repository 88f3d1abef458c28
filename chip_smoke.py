#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (``nvcc``); without a card, or run
from a directory that lacks ``src/repro_torch``, it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package.

Phases, each raising on a failed check:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/kernels/csrc/*.cu`` (``edge_latency.cu``,
   ``flash_attention.cu``, ``ssd_scan.cu``, ``ssd_scan_bwd.cu``,
   ``rmsnorm.cu``) compiled with
   ``nvcc`` for ``sm_90a``, all in parallel; per kernel its ptxas
   registers and spills and, from ``cuobjdump -sass``, its tensor-core
   instructions and warpgroup syncs;
2. kernels: each CUDA kernel against its plain PyTorch version computed in
   float64 on the card, ≤1e-5 relative (max |err| / max |want|), bitwise
   equal on a repeat launch — at the serving shapes, at V ∈ {7, 129, 300}
   × E ∈ {1, 33, 130, 0} × shared / per-scenario scenario batch (× R ∈
   {1, 8} for the structured kernel) and on all-negative operands; kernel,
   plain and library times at the serving shapes beside the roofline bound
   (for K1 the split-TF32 tensor-core bound of its route beside the FP32
   CUDA-core one, and its error with the 32-deep stage sums);
3. serve_dense: ``WhatIfService`` on a 12-operator DAG, dense fleets of
   V = 4096 devices, S = 4 scenarios; three tenants send score, rank and
   joint queries totalling 1024 rows (one full chunk);
4. serve_structured: the same DAG on a ``RegionFleetFamily`` of
   V = 131 072 devices in R = 8 regions, S = 4, 256 rows over three
   queries.

Each serving phase checks served scores bitwise against a direct
``score_grid`` with the same dq/β, eight (scenario, placement) pairs
against the float64 oracle (``repro_torch.core.costmodel``) at ≤1e-5, and
that its kernel launched; the structured phase also checks that two
``score_grid`` calls are bitwise equal.

2b. single_tile: K4a and K4b (the whole-V references) through their
   dispatch routes at tests/test_kernel_blocking.py's inputs (B 2, E 5,
   V 64, R 4), at E ∈ {1, 33} and at V ∈ {1, 37, 128, the largest V the
   kernel accepts}, shared and per-scenario: K4a bitwise equal to K1 and
   K4b to K2, both ≤1e-5 relative to the float64 plain version, bitwise
   on a repeat launch, and the size refusal above the largest V; kernel
   (also alone, from the profiler), blocked and plain times at V 64 and
   at the largest V (K4b also with a
   per-batch scenario, and at its largest V for R 8), each timed case
   bitwise equal to the blocked kernel;
2c. block_policy: the block policy (``repro_torch.kernels.autotune``) at
   serve_dense's K1 shape (B 1024, E 21, V 4096, shared com), the
   controller's (B 65, E 2, V 4096) and serve_structured's K2 shape (B 256,
   E 21, V 131 072, R 8): every candidate config's launch bitwise equal to
   the default config's, its launcher's tile count equal to
   ``block_geometry``'s, its predicted and measured ms; the default ≤1e-5
   of the float64 plain version; the race of the top three through
   ``get_config(timer=)`` (CUDA events, timed interleaved in 3 rounds of
   a b c c b a), the analytic pick within 5 % of
   the race's winner at the two serving shapes, and the decision table —
   which the serving phases then read.  Every candidate of K1 (K2) also
   bitwise equal to K4a (K4b) at the single_tile phase's shapes;
2d. quality: ``quality_scores_torch`` (ROADMAP A11) on a 65 536 × 256 int64
   window (stuck, fully missing, half missing and long-run rows planted) on
   the card, ≤1e-6 of its CPU route and ≤1e-5 of the numpy
   ``quality_scores``, with its ms;
3b. serve_multi_dense: the serve_dense instance registered with all five
   §3.1 objectives (``ObjectiveSet.of(*OBJECTIVES)``, unit weights) and
   per-scenario speeds; four queries (score; rank by ε-constraint,
   minimize latency_f with network_movement_cost capped at its median;
   pareto; joint) over the same three tenants, 1024 rows, one chunk;
4b. serve_multi_structured: the serve_structured family with the same set
   and queries, 256 rows.

Each multi-objective phase checks every served per-objective grid and
score bitwise against a direct ``score_grid(objectives=...)`` over the
rows as dispatched (the padded chunk), eight (scenario, placement) cells
of every objective against ``ObjectiveSet.scalar_values`` on that
scenario's fleet at ≤1e-5 relative (abs 1e-6), the pareto front and the
ε-rank against ``pareto_front`` / ``epsilon_constraint`` on the direct
grids, and that K1 (K2) launched S times in the one dispatch; the
structured phase checks that two ``score_grid(objectives=...)`` calls are
bitwise equal.

5. flash_attention: K5 against its plain version on the card — float32
   inputs against the float64 plain version at ≤1e-5 relative, bfloat16
   inputs against the plain version on the same inputs in float32 math at
   ≤1e-2 relative (one bfloat16 ulp of the largest output: both round a
   float32 result once) — causal and full, at the tests/test_kernels.py
   shapes, at ragged S ∈ {100, 1000} and at the serving shape (one
   lm_score shard: 11 rows × 2048 tokens × 16 heads of 128), bitwise equal
   on a repeat launch; the P·V numerics decision (the kernel's bf16 p
   against p split into bf16 hi + lo, emulated in torch); K5's time and
   TFLOP/s, plain, ``scaled_dot_product_attention`` (timed as a yardstick
   only, never called by the port) and the roofline bound at the serving
   shape;
6. lm_score: the streaming job of ``examples/geo_placement.py`` (ingest →
   clean → dq_check → lm_score → window_mean; 12 devices in 3 regions,
   uniform placement) with OLMo-1B at its published widths
   (``attention_impl="pallas"``, seeded random weights made on the card)
   as the LM-scoring operator: two engine batches of 128 rows × 2048 tokens
   with 5 % dropout rows.  It checks that K5 launched 16 times (once per
   layer) in every lm_score shard call, that the scores are finite, that
   one shard's scores agree with the same forward with
   ``attention_impl="reference"`` within 1e-2 relative (bfloat16
   activations through 16 layers), and that ``rows_out`` is what the
   engine's counts predict; it prints per-batch wall time, tokens/s, peak
   memory and a ``torch.profiler`` breakdown of a third batch (K5, K6, K7,
   float32 and bf16 GEMMs, conv/elementwise kernels, copies, other, idle
   share);
7. ssm kernels: K6 (SSD chunked scan) and K7 (RMSNorm) against their plain
   versions on the card, with the bars of phase 5 — float32 inputs against
   the float64 plain version at ≤1e-5 (for K6, or the plain version's own
   float32 error on the same inputs where that is larger: its cumsum
   differences lose digits over a 256-row chunk), bfloat16 inputs at ≤1e-2
   against the plain version in float32 math — bitwise equal on a repeat
   launch.  K6 at the tests/test_kernels.py shapes, ragged L (in one chunk
   and over several chunks at P = 64, N = 128, chunk 256), with slow decay
   at L 2048 (8 chunks) and a ragged L 1900, and the serving shape of one
   lm_score shard (b 11, L 2048, H 64, P 64, N 128, chunk 256; x, B, C read
   as strided views of one conv output, as the model passes them), once
   more with slow decay.  For each slow-decay input it prints the share of
   y that states older than one chunk carry (the plain version against
   itself on two-chunk windows), so a kernel that lost them would fail.
   Every bfloat16 case must take K6's tensor-core route; at the serving
   shape it prints the launches per pass, the CTAs, each pass's device
   time, the bytes the design moves beside the bound, and the numerics
   candidates (w⊙x, M, S rounded to bf16 once, as bf16 hi + lo, or to
   TF32, emulated in torch) against the plain version; K7 at vectorised,
   scalar and unaligned rows, at the widths of other Mamba2 sizes, and at
   the serving shapes (22 528 rows × 2048, the block norm, and × 4096, the
   gate norm).  Kernel (K7 also alone, from the profiler), plain and bound
   times at the serving shapes, and
   ``torch.nn.functional.rms_norm`` for K7 (timed as a yardstick only,
   never called by the port; there is no single PyTorch call for the scan);
7b. ssd_bwd: K6's backward (``csrc/ssd_scan_bwd.cu``) against its plain
   version (``ref.ssd_scan_bwd_plain``) on model-like operands: float32
   against the float64 plain version at ≤1e-5, bfloat16 against the plain
   version in float32 math at ≤1e-2, each of dx, dB, dC, ddt, dA, dD
   norm-wise; at Mamba2-1.3B's and Zamba2-1.2B's training shapes (4 ×
   2048, 64 heads of 64, N 128 / 64, chunk 256), a ragged L, one chunk and
   the smoke widths, on both routes; bitwise on repeat, one launch of each
   of its four passes a call, a planted fault (dy one row late) failing;
   ms, the device alone and each pass's device ms, the forward's ms, plain
   ms and the bound at the training shapes (no single PyTorch call
   computes it); the library's registers, spill bytes and HGMMA per kernel,
   failing where the bf16 states or chunk kernel spills or has no HGMMA;
   the bf16 route's six roundings emulated on the card (bf16, hi + lo and
   TF32 candidates); the float32 route timed per pass at the training
   shape beside the bf16 route's passes;
8. lm_score_mamba2: the job of phase 6 with Mamba2-1.3B at its published
   widths (48 layers, d 2048, d_inner 4096, 64 SSM heads of 64, state 128,
   chunk 256, vocab 50432 padded; seeded random weights made on the card)
   after the OLMo model is freed.  It checks that K6 launched 48 times and
   K7 97 times (2 per layer + the final norm) in every shard call, finite
   scores, one shard's scores against the same forward with K6/K7 swapped
   for their plain versions (inside the check only) within 1e-2, and the
   row counts; it prints what phase 6 prints.
8b. lm_score_zamba2: the job with Zamba2-1.2B at its published widths
   (arXiv:2411.15242: 38 Mamba2 layers, d 2048, d_inner 4096, 64 SSM
   heads of 64, state 64, chunk 256; one shared attention block of 32
   heads of 64 and a d_ff 8192 SwiGLU at ⌈38/6⌉ = 7 sites; vocab 32 000),
   K5's route: K5 7, K6 38 and K7 91 (2 a layer, 2 a site, the final norm)
   launches in every shard call, one shard within 1e-2 of the plain route
   (reference attention, K6/K7's plain versions), and K5, K6 and K7 held
   against their plain versions on the operands one shard hands them
   (phase 5's bars, bitwise on repeat), with their times beside the plain
   versions', the bounds and (K5) ``scaled_dot_product_attention``'s.
8c. lm_score_moe: the job with Arctic-480B at its published widths (d
   7168, 56 heads of 128 on 8 kv heads, 128 experts top-2 of d_ff 4864,
   the dense residual MLP, vocab 32 000; bf16 weights made on the card)
   cut to 2 of its 35 layers (26.8 GB of experts a layer), K5's route:
   K5 2 and K7 5 launches in every shard call, one shard within 1e-2 of
   the plain route (reference attention, K7's plain version), the row
   counts, the share of (token, choice) pairs capacity dropped in each
   layer, a profile split (K5, K7, the f32 head / router / combine, the
   bf16 GEMMs and ``aten::bmm``'s own share, routing and gathers,
   elementwise), and K5 (11, 2048, 56, 128) and K7 22 528 × 7168 held on
   one shard's operands after the model is freed, timed beside the plain
   versions, the bounds, SDPA and ``F.rms_norm``.
8d. lm_forward: one forward (no cache, K5's route) at 2 × 512 tokens of
   Llama-3.2-Vision-11B (40 layers, d 4096, 32 heads of 128 on 8 kv heads,
   8 gated cross blocks to 1601 seeded image embeddings, gates opened),
   Whisper-large-v3 (32 + 32 layers, d 1280, 20 heads of 64, 1500 seeded
   frame embeddings) and Grok-1 (d 6144, 48 heads of 128, 8 experts of
   d_ff 32 768) cut to 4 of 64 layers: K5 40 / 32 / 4 and K7 89 / 162 /
   9 launches, each row's score (its mean next-token cross-entropy)
   within 1e-2 of the plain route's, K5 and K7 held on the forward's
   operands (timed).

9. search_dense: ``BatchedProblem`` on a ``random_fleet`` of 8 regions ×
   512 devices (V 4096, an ``ExplicitFleet``), the DAG of phase 3, β 1 and
   a ``DQCoupling``: ``random_search`` of 4096 candidates in 1024-row
   chunks (5 dispatches: the uniform seed and 4 chunks, each K1 at B 1024,
   E 21, V 4096), then ``simulated_annealing`` of 2048 steps in blocks of
   64 from its winner (32 dispatches).  It checks the dispatches and K1
   launches, one 1024-row chunk and one 64-row anneal path against the
   plain version in float64 on the card (≤1e-5), each winner's F against
   the float64 oracle (its batched score ≤1e-5), F at most the uniform
   placement's (within the float32 selection's 1e-5) and the winner
   feasible under the coupling; it prints the walls, placements × dq
   scored per second and the profile of one 1024-candidate search;
10. search_greedy: ``greedy_transfer`` with δ = 1/64 on an 8 × 8
   ``random_fleet`` (V 64; from the uniform start every device is a
   source, so a neighbourhood is up to 4032 moves, K1 at bucket 4096), on
   the card and on the CPU route: F within 1e-5 of the CPU route's and at
   most the uniform placement's, the winner feasible, a full
   neighbourhood against the plain version; it prints whether the moves
   were identical;
11. robust_structured: ``region_scenario_batch`` (S 4, V 131 072, 8
   regions, the generator's stragglers and outages) and min–max search
   over 256 candidates with a per-scenario dq: ``robust_placement``'s
   grid (its winning and uniform columns against the float64 oracle in
   every scenario, the worst case equal to ``grid.max(0).min()``), then
   ``scenario_robust_search`` without warm starts (1 dispatch, K2 × 4,
   the same winner, F the oracle's worst case), then with
   ``co_optimize_dq`` and a coupling (profiled); it prints generation
   time, walls, cells/s and peak memory;
12. streaming_reoptimize: the job of phase 6 without the LM operator, on
   its 12-device fleet and placement problem: ``greedy_transfer``, device
   5 degraded 10× and re-optimized, device 11 lost, one batch; rows stay
   on the simplex, the straggler's mass does not rise, and no kernel is
   launched (the compute-extension problem takes the scalar loop).

13. adaptive_dense: ``benchmarks/bench_adaptive.py``'s drifting world
   (source → normalize → threshold; degrade 0.06, loss 0.01, outage on
   0.05 / off 0.06, selectivity drift 0.10) at 8 regions × 512 devices
   (V 4096), 8192 rows/tick from the uniform placement, 28 ticks (the
   --smoke trace of 32, cut so the phase stays near a minute), through
   ``AdaptiveController`` with bench_adaptive.py's ``CONTROLLER`` (window
   4, cooldown 2, threshold 0.5, amortize 5; 64 candidates, 4 robust
   scenarios) and ``observed="work"``.  Each re-optimization is one
   ``score_grid`` dispatch: 4 K1 launches (B ≈ 65, E 2, V 4096) against the
   believed fleet and three jittered copies.  It checks 4 K1 launches per
   dispatch, eight cells of every re-optimization grid against the float64
   oracle (≤1e-5), every candidate and the final placement on the simplex,
   and the same world, seed and trace through the CPU route in the same
   process: the same reconfiguration and refit ticks and the same final x,
   unless two candidates' scores tie within 1e-5 (then it prints the two
   scores and their gap and compares nothing after that re-optimization).
   It prints the wall, ticks/s, the wall split from the ``obs`` spans
   (engine, world events, oracle, refit, re-optimization), the dispatches,
   refits and reconfigurations, the cumulative adaptive (with charges),
   static and oracle F, peak memory and the profile of one
   re-optimization;
14. belief_cold_start: ``benchmarks/bench_belief.py``'s cold start at the
   same V: the ridge prior fit on the card from the training tuples of
   three disjoint training fleets (replay windows of their uniform
   placement with the slow speed tier slowed 8×) against the same fit
   with ``device="cpu"`` (≤1e-5); the cold-start controller (bench_belief's
   ``BLIND`` with ``use_belief``, ``belief_sampling``, ``probe_epsilon``
   0.1 and the prior) on a fleet whose slow tier degrades at tick 0, 16
   ticks, 4 K1 launches per dispatch; ``use_belief=True`` with every belief
   knob passive on phase 13's world, bitwise its legacy run; and
   ``belief_robust_search`` with 4 posterior scenarios and 64 candidates
   (no greedy warm starts: a neighbourhood at V 4096 has 1.7·10⁷ moves), one
   dispatch of 4 K1 launches, its winner's worst case within 1e-5 of the
   oracle's.  The training fleets replay their uniform placement instead of
   the reference's per-event greedy re-placement (the compute-extension
   greedy takes the scalar loop, hours at V 4096).

15. projected_gradient: the loss of ``projected_gradient`` and its
   gradient at seeded points (three temperatures) on the card against
   the CPU route (≤1e-5), on the paper's worked example with its
   coupling and on phase 9's DAG at 8 regions × 8 devices; from one
   shared start the same dq and, for the paper problem, F within
   ``PG_PAPER_F`` (the V 64 trajectory is not determined by float32: both
   runs are held at most at the uniform placement's F); then phase 9's
   problem at V 4096, 100 steps × 3 temperatures timed through
   ``obs.time_once``: the loss falls, the result on the simplex and
   feasible, its F against the uniform placement's printed, steps/s, peak
   memory, a profile of one step.  It raises if TF32 matmuls are on.
16. lm_serve: ``serve_wave`` with 8 prompts of 512 tokens and 64
   generated on OLMo-1B, Granite-8B (36 layers, d 4096, GQA 32/8, vocab
   49 152, f32 weights), Qwen3-32B at its widths cut to 8 of 64 layers
   (131 GB of f32 parameters do not fit) and Mamba2-1.3B, seeded random
   weights: K7 launched once per RMSNorm of the prefill and of every
   decode step, K6 once per Mamba2 layer in the prefill, no K5 (a cache
   routes attention to ``_sdpa_chunked``); prefill and 8 teacher-forced
   decode steps against the plain K6/K7 route, over the first 2 layers and
   at full depth, within 1e-2, or the plain route's own bf16 error against
   float32 activations at that depth where larger; it
   prints prefill s, decode ms/step and tokens/s, peak memory and the
   profile of one decode step.  Zamba2-1.2B is served too (K7 91 a
   prefill and a decode step, K6 38 a prefill, no K5); so are Arctic-480B
   (2 layers) and Grok-1 (4 layers), K7 5 / 9 a step, Llama-3.2-Vision
   with 1601 seeded image embeddings and opened gates (K7 89 a step), and
   Whisper-large-v3 with 1500 seeded frame embeddings (K7 162 a prefill,
   97 a decode step), each with the cached cross keys and values held
   bitwise unchanged across decode steps.
16b. lm_train: the single-card trainer (ROADMAP A13c) on Granite-8B at its
   published widths (d 4096, 32 heads on 8 kv heads, d_ff 14 336, vocab
   49 152; f32 parameters, bf16 activations, full remat) cut to 18 of its
   36 layers, 4 × 2048 tokens a step from the synthetic stream with a
   quarter of the rows quality-checked, 8 AdamW steps (f32 moments, lr
   3e-4): step 1's gradient finite and non-zero for every parameter; K7's
   backward held on the operands the step hands it (f32 dx ≤1e-5 to the
   float64 plain version, bf16 dx one bf16 ulp of the plain version, dw
   ≤1e-4, bitwise on repeat) and timed beside ``F.rms_norm``'s backward
   and its bound; step 1's loss, global and per-parameter gradient norms
   against the plain K6/K7 route over 2 layers and the cut depth (≤1e-2
   or the plain route's own bf16 error), a planted backward fault (dw × 2)
   failing both; every step's launches (K7 2L+1 + 2L recomputed, its
   backward 2L+1, no K5 or K6); tokens/s, the model-FLOPs share of the
   bf16 peak, peak memory (under 90 % of the card's), the AdamW update's
   share, the profile of one step; K5 under grad and ``run_training`` on
   the flash route raise, K6 under grad differentiates through one launch
   of its backward; granite's smoke config dies at step 6 and resumes
   from 5 to the uninterrupted run's parameters.  Then Mamba2-1.3B (48
   layers) and Zamba2-1.2B (38) whole at their published widths, the same
   checks and measures (no resumption): K6 2 × its layers a step (one
   recomputed) and its backward once a layer, K7 and its backward, a
   second planted fault (K6's dB × 2).
16c. lm_mesh: the mesh planner (ROADMAP A13d) on Granite-8B
   at its published widths cut to 4 of 36 layers, on a one-card ("data",
   "model") (1, 1) ``DeviceMesh`` over a world-size-1 ``nccl`` group
   (FileStore rendezvous, destroyed at the phase's end): the parameters as
   DTensors laid out by ``param_specs()`` + ``fsdp_specs``; step 1's loss,
   gradient norm and every gradient against the unsharded
   ``make_grad_fn`` from the same weights and batch; prefill 8 × 512 and
   8 forced decode steps, the logits against the unsharded serving steps;
   a scoring forward of 4 × 2048 tokens on K5's route against the
   unsharded one; K7 (forward and backward) and K5 launches of each,
   equal between the routes (the kernels run on the local shards); 3
   AdamW steps of 4 × 2048 tokens on each route in turn, one copy at a
   time: the losses and the updated parameters, ms per step and peak
   memory, and the prefill's and a decode step's ms; every compared value
   **bitwise** the unsharded route's.  Then the second half
   (``MESH_FAMILIES``), each held bitwise against its unsharded route with
   launches equal: Mamba2-1.3B whole (prefill + decode, a 4 × 2048
   scoring forward and 3 AdamW steps: K6 and its backward on each
   device's heads, K7 and its backward), Grok-1 at its
   published widths cut to 1 of 64 layers (step 1's forward and backward
   of 2 × 512 tokens: K7 and its backward; prefill + decode; 2 AdamW
   steps with 8-bit moments on the expert leaves, one route after the
   other), Zamba2-1.2B whole (prefill + decode and 3 AdamW steps),
   Whisper-large-v3 whole and Llama-3.2-Vision-11B at 24 of 40 layers
   (prefill + decode with their image / frame inputs, each phase's wall
   under 60 s); the sharded
   route's launches by family and run are printed.
16d. mesh_dryrun: ``python -m repro_torch.launch.dryrun --arch granite-8b
   --shape train_4k --mesh single --layers 18`` and ``--arch arctic-480b
   --variant moe_ep=data --layers 3`` on the host (256 ranks of torch's
   ``fake`` process group each, fake tensors; both started after the
   build, read here; cut in depth to keep each wall under 120 s):
   per-device bytes and ``fits`` at 80 GB, the three roofline terms and
   the collective summary — estimates for H100 constants —
   ``choose_layout``'s pick for the same arch, shape and 256 devices (the
   MoE branch for Arctic), and the dry run's own wall time.
17. perf_record: ``repro_torch.obs.perfbridge.perf_record`` of one
   lm_score shard (11 × 2048 tokens) of OLMo-1B, Mamba2-1.3B,
   Zamba2-1.2B and Arctic-480B at 2 layers (its expert slots against the
   (token, choice) pairs it routes), and (after phase 3) of one
   serve_dense dispatch: counted
   FLOPs and bytes (aten ops through ``repro_torch.perf.counts``, the
   kernels' launches reporting their terms), analytic FLOPs, the useful
   fraction, ``mfu_bound``, the measured model-FLOPs share of the bf16
   tensor-core peak and the roofline fraction; the card's count against
   the plain route's count of the same work on fake CPU tensors (equal
   outside the kernels; K5 the causal half; K6 less the upper triangle;
   K1 equal).  It also holds the disarmed counting hooks to ≤5 % over no
   hooks on a host-bound loop of K7 dispatches at a decode step's shape
   (``benchmarks/bench_obs.py``'s bar).
18. compile_span: a span around K7's first use in a fresh build
   directory records its ``nvcc`` build and load (``compile_s`` > 0,
   ``obs.bench.measure``'s ``n_recompiles`` 2), a later call none.

Phase 5 also holds K5 at head dim 8 and at B·H 65 536 (ROADMAP C4), and
phase 7 K6's final state at the case shapes and the serving shapes
(against the plain version's, y bitwise as without it).

The launch counts are set to 0 just before a phase drives its main path
(the service, the engine, a search) and read just after it.  The last lines are the
card, one JSON object listing every ported kernel and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
REL = 1e-5
SEED = 0
# NVIDIA H100 SXM data sheet at its full 700 W limit: FP32 on the CUDA
# cores (K2's route) and HBM3 bandwidth; K1/K4a (split TF32) and K5
# (bf16) are priced at their tensor-core rates by repro_torch.perf.roofline
PEAK_FP32 = 67e12
HBM_BW = 3.35e12

N_OPS, EDGE_PROB = 12, 0.3
S = 4
DENSE_V, DENSE_ROWS = 4096, (512, 256, 256)          # one 1024-row chunk
STRUCT_V, STRUCT_R, STRUCT_ROWS = 131_072, 8, (128, 64, 64)
# the multi-objective phases: four queries over the same three tenants
MULTI_TENANTS = ("a", "b", "c", "a")
MULTI_DENSE_ROWS = (384, 256, 256, 128)              # one 1024-row chunk
MULTI_STRUCT_ROWS = (96, 64, 64, 32)
# K4a / K4b: test_kernel_blocking.py's inputs (B 2, E 5, V 64, R 4)
TILE_B, TILE_E, TILE_V, TILE_R = 2, 5, 64, 4
TILE_ES, TILE_VS = (1, 33), (1, 37, 128)       # + the largest V accepted
TILE_TIMED = (4, 1024)          # (B, E) of the timed calls: 4096 edge rows
TILE_R8 = 8                     # K4b also timed at its largest V for R = 8
# the block policy's shapes: (label, kind, B, E, V, R), one shared
# scenario; the analytic pick is held within BLOCK_SLACK of the race's
# winner at the serving shapes
BLOCK_SHAPES = (("serve_dense", "dense", 1024, 21, 4096, None),
                ("controller", "dense", 65, 2, 4096, None),
                ("serve_structured", "structured", 256, 21, 131_072, 8))
BLOCK_GATED = ("serve_dense", "serve_structured")
# each raced config is timed in BLOCK_ROUNDS rounds of the order a b c c b
# a (a median of BLOCK_REPS single calls each), so the card's drift over
# the race falls on every config alike
BLOCK_REPS, BLOCK_ROUNDS, BLOCK_SLACK = 10, 3, 0.05
QUALITY_SHAPE = (65_536, 256)
QUALITY_CPU_TOL, QUALITY_NUMPY_TOL = 1e-6, 1e-5
SOURCES = {"edge_latency_dense": "src/repro_torch/kernels/csrc/edge_latency.cu",
           "edge_latency_structured":
               "src/repro_torch/kernels/csrc/edge_latency.cu",
           "edge_latency_dense_single_tile":
               "src/repro_torch/kernels/csrc/edge_latency.cu",
           "edge_latency_structured_single_tile":
               "src/repro_torch/kernels/csrc/edge_latency.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "rmsnorm_bwd": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"}
REPLACES = {"edge_latency_dense": "src/repro/kernels/edge_latency.py:160",
            "edge_latency_structured": "src/repro/kernels/edge_latency.py:246",
            "edge_latency_dense_single_tile":
                "src/repro/kernels/edge_latency.py:311",
            "edge_latency_structured_single_tile":
                "src/repro/kernels/edge_latency.py:357",
            "flash_attention": "src/repro/kernels/flash_attention.py:76",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:70",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:30",
            # K7's gradient: the Pallas kernel has none (JAX cannot
            # differentiate it; the reference trains through rms_norm)
            "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:30",
            # K6's gradient: the Pallas kernel has none either (the
            # reference trains through jax.grad of ssd_chunked)
            "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:70"}
# K5 cases: the tests/test_kernels.py shapes and ragged S, (B, S, H, D)
ATTN_SHAPES = [(1, 128, 1, 64), (2, 128, 4, 64), (1, 256, 2, 128),
               (2, 96, 3, 32), (1, 384, 2, 64), (1, 100, 2, 64),
               (1, 1000, 2, 128)]
BF16_REL = 1e-2      # one bfloat16 ulp of the largest output
# lm_score: OLMo-1B's context length (arXiv:2402.00838) per row
LM_ARCH, LM_ROWS, LM_SEQ, LM_BATCHES, LM_DROPOUT = "olmo_1b", 128, 2048, 2, 0.05
# one shard's scores, kernels vs the plain route (chunked attention; K6/K7's
# plain versions), bf16 activations through 16 (OLMo) or 48 (Mamba2) layers
LM_REF_REL = 1e-2
SSM_ARCH = "mamba2_1_3b"
# K6 cases (b, L, H, P, N, chunk): the tests/test_kernels.py shapes, a
# ragged L in one chunk, and ragged multi-chunk L at the model's P, N, chunk
SSD_CASES = [(2, 64, 8, 16, 16, 16), (1, 128, 4, 32, 8, 16),
             (2, 32, 2, 8, 4, 16), (1, 20, 5, 8, 16, 8),
             (2, 300, 6, 64, 128, 256), (1, 700, 3, 64, 128, 256)]
# K6 cases with slow decay (dt = softplus(z - 6), A = -0.05 (1 + jitter)),
# where states older than one chunk carry a large share of y: 8 chunks at
# the model's P, N, chunk, and a ragged L
SSD_SLOW_CASES = [(1, 2048, 4, 64, 128, 256), (2, 1900, 3, 64, 128, 256)]
# K6's backward against its plain version, (b, L, H, P, N, chunk, dtype):
# Mamba2-1.3B's training shape (4 x 2048, 64 heads of 64, N 128, chunk 256)
# and Zamba2-1.2B's (N 64), a ragged L, one chunk (L < chunk and L = chunk)
# and the smoke widths, on both routes; the first two and the float32 one
# at the model's widths are timed (SSD_BWD_TIMED)
SSD_BWD_CASES = [(4, 2048, 64, 64, 128, 256, "bfloat16"),
                 (4, 2048, 64, 64, 64, 256, "bfloat16"),
                 (2, 1900, 6, 64, 128, 256, "bfloat16"),
                 (2, 200, 5, 64, 128, 256, "bfloat16"),
                 (2, 20, 5, 8, 16, 8, "bfloat16"),
                 (1, 2048, 8, 64, 128, 256, "float32"),
                 (2, 1900, 6, 64, 128, 256, "float32"),
                 (2, 256, 5, 64, 64, 256, "float32"),
                 (2, 20, 5, 8, 16, 8, "float32")]
SSD_BWD_TIMED = (0, 1, 5)
# the operand roundings K6's tensor-core route could take (emulated)
SSD_CANDIDATES = ("bf16", "bf16_hilo", "tf32")
# K6's chunk-parallel grid at the serving shape: at least this many CTAs
# (the sequential design had one per (batch, 4 heads): 176)
SSD_MIN_CTAS = 1000
# K7 cases (rows, D, offset): vectorised and scalar rows (D % 8 != 0 for
# bf16, D = 37), an offset of one element (rows not 16-byte aligned), and
# the widths of other Mamba2 sizes (780m 1536 / 3072, 2.7B 2560 / 5120)
# and 8192, which the rows kernel takes at 6 to 32 vectors per lane (more
# rows than one pass of its grid at 3072)
RMS_CASES = [(1, 64, 0), (3, 100, 0), (7, 2048, 0), (5, 128, 0),
             (33, 4096, 0), (9, 37, 0), (4, 256, 1), (6, 1536, 0),
             (5, 2560, 0), (9001, 3072, 0), (3, 5120, 0), (2, 8192, 0)]
# the search phases: a random_fleet of 8 regions × 512 (serve_dense's V)
# searched by random_search in 1024-row chunks (serve_dense's K1 shape) and
# block annealing; greedy on 8 × 8 devices; min–max robust search over a
# generated family at serve_structured's V and S
SEARCH_PER_REGION, SEARCH_CANDIDATES, SEARCH_BATCH = 512, 4096, 1024
ANNEAL_STEPS, ANNEAL_BLOCK = 2048, 64
GREEDY_PER_REGION = 8
ROBUST_CANDIDATES = 256
# the closed loop (phases 13-14): benchmarks/bench_adaptive.py's drifting
# world and controller, and benchmarks/bench_belief.py's cold start, at 8
# regions x 512 devices (V 4096, the dense path's target) with rows enough
# that every device of the uniform start sees some
ADAPT_PER_REGION, ADAPT_RATE, ADAPT_TICKS = 512, 8192.0, 28
# bench_adaptive.py's --smoke trace length; phase 13 cuts it to
# ADAPT_TICKS so the phase (its CPU route included) stays near a minute
ADAPT_SMOKE_TICKS = 32
ADAPT_DRIFT = dict(degrade_prob=0.06, loss_prob=0.01, outage_on_prob=0.05,
                   outage_off_prob=0.06, selectivity_drift_std=0.10)
BELIEF_TICKS, BELIEF_TRAIN_TICKS, BELIEF_FACTOR = 16, 6, 8.0
BELIEF_TRAIN_SEEDS = (10, 11, 12)
BELIEF_SCENARIOS, BELIEF_CANDIDATES = 4, 64
# AdaptiveConfig keywords: bench_adaptive.py's CONTROLLER (n_candidates 64,
# robust_scenarios 4 by default) and bench_belief.py's BLIND
CONTROLLER = dict(window=4, cooldown=2, drift_threshold=0.5,
                  amortize_ticks=5.0)
BELIEF_BLIND = dict(window=3, cooldown=2, drift_threshold=0.3,
                    amortize_ticks=20.0, n_candidates=32, oracle_candidates=16)
# the tenth slice.  K5 at B·H = 65 536 (one past the old grid-y limit of
# 65 535) with a short S; Mamba2's chunk (K6's final state at the serving
# shapes); projected_gradient's card-vs-CPU problem (8 regions x 8) and
# main path (phase 9's V 4096) with its steps per temperature
ATTN_WIDE = (4096, 32, 16, 64)
SSM_CHUNK = 256
PG_SMALL_PER_REGION, PG_STEPS = 8, 100
# the paper problem from one start, card vs CPU route: exp and the sums
# round differently on the two devices and Adam's restarts amplify an ulp
# (ROADMAP Queue C); an H100 read them 1.321e-6 apart in F, above 1e-6
PG_PAPER_F = 1e-5
# lm_serve: 8 prompts of 512 tokens, 64 generated; 8 teacher-forced decode
# steps held against the plain K6/K7 route; qwen3-32b cut to 8 of its 64
# layers (131 GB of float32 parameters at full depth, 21.8 GB at 8)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_FORCED = 8, 512, 64, 8
SERVE_ARCHS = (("olmo_1b", None), ("granite_8b", None), ("qwen3_32b", 8),
               ("mamba2_1_3b", None), ("zamba2_1_2b", None),
               ("arctic_480b", 2), ("grok_1_314b", 4),
               ("llama_3_2_vision_11b", None), ("whisper_large_v3", None))
# lm_serve's logits are held against the plain K6/K7 route on the model
# cut to its first layers, where bf16 drift is smaller than at full depth,
# to LM_REF_REL or, where larger, the plain route's own bf16 error at that
# depth (an H100 read granite / qwen3 / mamba2 at 4.9e-3 / 4.8e-3 / 4.3e-3
# over one layer, 8.0e-3 / 8.0e-3 / 6.4e-3 over two, 9.3e-3 / 1.11e-2 /
# 1.25e-2 over four; zamba2 at 1.170e-2 over two layers, which are three
# blocks: the first site's shared block runs before them)
SERVE_STRICT_LAYERS = 2
# the eleventh slice: the perf records' timed samples and the reference's
# disabled-telemetry bar (benchmarks/bench_obs.py); zamba2 served and
# scored at its published widths (arXiv:2411.15242)
PERF_SAMPLES = 11
MAX_DISABLED_OVERHEAD = 0.05
# the gate's hot loop: K7 dispatches at a decode step's shape (8 rows of
# d 2048, bf16), where the host's cost per call is the step's (lm_serve's
# decode profile reads the card idle 78-89 % of a step); 60 pairs, since
# the ratio of the medians of 20 has read 1.0068 and 1.0544 on the H100's
# shared host, where the disarmed sites cost 0.45 µs of a 24 µs call
HOOK_CALLS, HOOK_SAMPLES = 500, 60
HYBRID_ARCH = "zamba2_1_2b"
# the twelfth slice: the MoE decoder scored at its published widths with
# Arctic-480B cut to 2 of its 35 layers (26.8 GB of bf16 experts a layer;
# 55 GB in all), and one forward each of the VLM (full depth: 40 GB of
# float32 parameters), Whisper (whole) and Grok-1 (4 of 64 layers: 9.7 GB
# a layer) on K5's route at 2 x 512 tokens; lm_serve serves the same cuts
MOE_ARCH, MOE_LAYERS = "arctic_480b", 2
FORWARD_ARCHS = (("llama_3_2_vision_11b", None), ("whisper_large_v3", None),
                 ("grok_1_314b", 4))
FORWARD_BATCH, FORWARD_SEQ = 2, 512
# (arch, layers kept or None) of phase 17's perf records
PERF_ARCHS = (("olmo_1b", None), ("mamba2_1_3b", None), ("zamba2_1_2b", None),
              (MOE_ARCH, MOE_LAYERS))
# the thirteenth slice: the single-card trainer.  Granite-8B at its published
# widths cut in depth (16 B a float32 parameter for the parameter, its
# gradient and two AdamW moments: 123 GiB whole), 4 x 2048 tokens a step,
# bf16 activations, full remat, float32 moments (as run_training picks for
# float32 parameters).  The cut is the deepest whose measured peak stays
# under TRAIN_MEM_SHARE of the card: an H100 80GB HBM3 (79.18 GiB) read
# 63.34 GiB at 16 layers and 69.84 GiB (88.2 %) at 18; each layer adds
# 3.25 GiB, so 19 would pass 90 %.  Step 1 is held against the plain K7
# route over the first 2 layers and at the cut depth; granite's smoke
# config dies at step 6 and resumes from 5
TRAIN_ARCH, TRAIN_LAYERS = "granite_8b", 18
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_LR, TRAIN_DQ = 3e-4, 0.25
TRAIN_STRICT_LAYERS = 2
TRAIN_MASK_SCAN = 1000    # batches scanned for the first with a masked row
TRAIN_MEM_SHARE = 0.9     # the cut's measured peak stays under this share
RESUME_STEPS, RESUME_EVERY, RESUME_DIE = 10, 5, 6
# the sixteenth slice: K6's backward, so the Mamba2 and hybrid families
# train on the card.  Mamba2-1.3B (48 layers) and Zamba2-1.2B (38) whole at
# their published widths: 16 B a float32 parameter for the parameter, its
# gradient and two AdamW moments is ≈ 21-23 GB, so no depth cut; the same
# 4 x 2048 tokens a step and 8 steps as Granite's cut
TRAIN_SSM_ARCHS = ("mamba2_1_3b", "zamba2_1_2b")
RESUME_BATCH, RESUME_SEQ = 2, 64
# K7's backward against its plain version: dw (float32, a sum over rows)
DW_REL = 1e-4
# the fourteenth slice: the mesh planner.  Granite-8B at its published
# widths cut to 4 of 36 layers (the phase holds an unsharded and a sharded
# copy, each with its gradients), on a one-card ("data", "model") (1, 1)
# mesh over a world-size-1 process group: 3 AdamW steps of 4 x 2048
# tokens on each route in turn, prefill 8 x 512 and 8 decode steps, a
# scoring forward on K5's route; then the dry run of granite_8b x
# train_4k x single on 256 fake ranks, on the host beside the card's
# phases, cut to 18 of 36 layers: at 36 its wall was 133.6 s on the
# H100's host (its counted run 115.7 s), over the 120 s it is held to
MESH_ARCH, MESH_LAYERS = "granite_8b", 4
MESH_BATCH, MESH_SEQ, MESH_STEPS = 4, 2048, 3
DRYRUN_CELL = ("granite-8b", "train_4k", "single", "")
DRYRUN_LAYERS = 18
DRYRUN_WALL = 120.0
DRYRUN_TIMEOUT = 900.0    # the child is killed past this
# the fifteenth slice: the mesh planner's second half on the same (1, 1)
# mesh, each family held bitwise against its unsharded route with launches
# equal: (arch, layers kept or None, what runs).  Mamba2-1.3B whole: a
# scoring forward, prefill and decode (K6 and K7 on local shards) and
# AdamW steps (K6's and K7's backward on local shards).  Grok-1 at its
# published widths cut to 1 of 64 layers: its experts are 9.7 GB of bf16 a
# layer, and step 1's gradients hold two copies (13.1 GB each with the
# embedding and the head) and both routes' bf16 gradients; at 2 layers
# those take 90 GB.  Its MESH_MOE_STEPS AdamW steps (K7 and its backward,
# 8-bit moments on the expert leaves) run one route after the other, one
# copy at a time: 8-bit AdamW on one 1.6e9-element expert leaf takes
# ≈ 38 GB of float32 temporaries, which do not fit beside two copies.
# Zamba2-1.2B whole: prefill, decode and AdamW steps.  Whisper-large-v3
# whole, Llama-3.2-Vision-11B cut to 24 of 40 layers (two copies of 40 GB
# of float32 parameters do not fit; 24 take ≈ 50 GB): prefill and decode,
# each phase's wall held under MESH_FAMILY_WALL
MESH_FAMILIES = (("mamba2_1_3b", None, ("serve", "score", "train")),
                 ("grok_1_314b", 1, ("grad", "serve", "train")),
                 ("zamba2_1_2b", None, ("serve", "train")),
                 ("llama_3_2_vision_11b", 24, ("serve",)),
                 ("whisper_large_v3", None, ("serve",)))
MESH_MOE_BATCH, MESH_MOE_SEQ, MESH_MOE_STEPS = 2, 512, 2
MESH_FAMILY_WALL = 60.0
# 16d's second cell: Arctic-480B x train_4k on 256 fake ranks with its
# experts over the data axis (moe_ep=data), cut in depth for its wall
DRYRUN_MOE_CELL = ("arctic-480b", "train_4k", "single", "moe_ep=data")
DRYRUN_MOE_LAYERS = 3
# profiler groups: float32 GEMMs (the dt projection and the head) first
F32_GEMM = ("f32f32", "sgemm", "nvjet_sss", "nvjet_tss")
GEMM = ("gemm", "cutlass", "xmma", "cublas", "nvjet")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def kernel_label(sym: str) -> str:
    """``name<args>`` for a mangled kernel symbol: the last source name of
    its nested name and its integer / bool template arguments."""
    i, name = (3 if sym.startswith("_ZN") else 2), sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        name, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
    if not sym.startswith("I", i):
        return name
    args = re.findall(r"L[ib](\d+)E", sym[i:sym.find("EE", i) + 2])
    return f"{name}<{', '.join(args)}>"


def kernel_resources(log: str, sass: str) -> dict[str, dict]:
    """Per kernel of one library, from its ``ptxas -v`` log and its
    ``cuobjdump -sass`` listing: registers, spill bytes (stores + loads),
    the tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) and the
    warpgroup syncs (WARPGROUP.ARRIVE before a wgmma batch reads
    registers, WARPGROUP.DEPBAR where a thread waits for wgmmas), and any
    ptxas remark on wgmma (serialized wgmmas are reported so)."""
    out: dict[str, dict] = {}

    def entry(sym):
        return out.setdefault(kernel_label(sym), {
            "registers": None, "spill_bytes": None, "HGMMA": 0, "HMMA": 0,
            "WARPGROUP.ARRIVE": 0, "WARPGROUP.DEPBAR": 0, "remarks": []})

    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )(\S+?)'?$",
                      line.strip())
        if m:
            cur = entry(m.group(1))
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                             r"loads", line)) and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and cur:
            cur["registers"] = int(m.group(1))
        if "wgmma" in line:
            sym = re.search(r"'(_Z\w+)'", line)
            (entry(sym.group(1)) if sym else cur or entry("?"))[
                "remarks"].append(line.strip())
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        sym, _, body = block.partition("\n")
        k = entry(sym.strip())
        for op in ("HGMMA", "HMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR"):
            k[op] = len(re.findall(rf"\b{re.escape(op)}\b", body))
    return out


def rel_err(got, want) -> tuple[float, float]:
    """(max |got − want| / max |want|, max |got − want|) in float64."""
    got, want = got.double(), want.double()
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got - want).abs().max())
    return err / max(float(want.abs().max()), 1e-30), err


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up.
    Each call sits between its own two events, so a small kernel's time
    includes the part of its wrapper's host time (the checks, the launch)
    that the device waits for; :func:`kernel_device_ms` leaves it out."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# spin kernels that open every profiled session (see device_events), and
# the readings a check that must hold every launch takes at most
PROFILE_PAD, PROFILE_ATTEMPTS = 256, 3


def device_events(torch, fn, op_ms: dict | None = None
                  ) -> tuple[float, dict[str, list]]:
    """One call of ``fn`` under ``torch.profiler``: its wall ms and, per
    device kernel or copy name, [summed ms, count].  With ``op_ms``, also
    fills it with each host op's own device ms (the kernels it launched
    itself), by op name.

    The profiler on the card's machine (torch 2.11 + CUDA 12.8) drops the
    first device events of a session, more the longer the process has run.
    So each session starts with ``PROFILE_PAD`` spin kernels, left out of
    the result, for it to drop instead."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "spin_kernel" not in e.name:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
        elif op_ms is not None:
            own = getattr(e, "self_device_time_total", 0.0)
            if own:
                op_ms[e.name] = op_ms.get(e.name, 0.0) + own / 1e3
    return wall_ms, per_name


def kernel_device_ms(torch, fn, reps: int, key: str) -> float:
    """Device ms per call of ``fn`` spent in the kernels whose names hold
    ``key``, from one profiled run of ``reps`` calls after a warm-up: the
    kernel's own time, without the host time :func:`time_ms` includes.
    Every call launches such a kernel, so a run that recorded fewer than
    ``reps`` of them lost events and is taken again."""
    fn()
    for _ in range(PROFILE_ATTEMPTS):
        _, per_name = device_events(torch,
                                    lambda: [fn() for _ in range(reps)])
        hits = [(t, c) for name, (t, c) in per_name.items() if key in name]
        if sum(c for _, c in hits) >= reps:
            return sum(t for t, _ in hits) / reps
    check(False, f"the profiler recorded fewer than {reps} {key} kernels "
                 f"in {PROFILE_ATTEMPTS} runs")


def device_ms_per_call(torch, fn, reps: int) -> float:
    """The device time of one call of ``fn`` — every kernel and copy it
    launches, without the host's time — from one profiled run of ``reps``
    calls after a warm-up."""
    fn()
    _, per_name = device_events(torch, lambda: [fn() for _ in range(reps)])
    return sum(t for t, _ in per_name.values()) / reps


def device_profile(torch, fn, groups: dict | None = None,
                   op_ms: dict | None = None) -> str:
    """Wall time of one profiled call of ``fn``, the summed device time of
    its kernels and copies (one stream, so the sum is the busy time), the
    idle share, the device time of each group of ``groups`` (name →
    substrings of kernel names; the first group that matches takes a
    kernel, the rest is "other") and the largest device consumers; with
    ``op_ms``, each host op's own device ms (:func:`device_events`)."""
    return profile_text(*device_events(torch, fn, op_ms), groups)


def profile_text(wall_ms: float, per_name: dict,
                 groups: dict | None = None) -> str:
    """:func:`device_profile`'s summary of ``per_name`` over ``wall_ms``."""
    if not per_name:
        return f"wall {wall_ms:.1f} ms; the profiler recorded no device events"
    busy = sum(v[0] for v in per_name.values())
    text = (f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle "
            f"{max(0.0, 1 - busy / wall_ms):.1%}")
    if groups:
        sums = {g: [0.0, 0] for g in (*groups, "other")}
        for name, (t, c) in per_name.items():
            g = next((g for g, keys in groups.items()
                      if any(k in name.lower() for k in keys)), "other")
            sums[g][0] += t
            sums[g][1] += c
        text += "; " + ", ".join(f"{g} {t:.1f} ms x{c}"
                                 for g, (t, c) in sums.items())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    return text + "; top: " + "; ".join(
        f"{n[:48]} {t:.2f} ms x{c}" for n, (t, c) in top)


def placements(torch, gen, rows: int, n_ops: int, V: int, density: float):
    """(rows, n_ops, V) float32 host placements made on the card: each
    operator on a random ~``density`` share of the devices with
    exponential (Dirichlet(1)) weights, rows summing to 1."""
    u = torch.rand((rows, n_ops, V), generator=gen, device=DEVICE)
    w = torch.rand((rows, n_ops, V), generator=gen, device=DEVICE)
    w = -torch.log1p(-w) * (u < density)
    first = torch.randint(0, V, (rows, n_ops, 1), generator=gen,
                          device=DEVICE)
    w.scatter_(-1, first, 1.0)                  # never an empty row
    return (w / w.sum(-1, keepdim=True)).cpu().numpy()


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def attention_p_split(torch, q, k, v):
    """Causal attention on bf16 (B, S, H, D) operands in float32 math with
    each softmax weight p split into bf16 hi + lo and multiplied by v as
    two products: what K5 would compute had it kept ~16 bits of p."""
    D, S = q.shape[-1], q.shape[1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * D ** -0.5
    s = s.masked_fill(torch.ones((S, S), dtype=torch.bool,
                                 device=q.device).triu(1), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    del p
    out = (hi @ vf + lo @ vf) / (hi + lo).sum(-1, keepdim=True)
    return out.transpose(1, 2).bfloat16()


def attention_phase(torch, dev, serving: tuple) -> dict:
    """K5 against its plain version at every case shape and at ``serving``
    (B, S, H, D); its times there.  Returns the kernel line's numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.perf.roofline import flash_attention_terms

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def operands(shape, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    def hold(q, k, v, causal, what):
        out = fa.flash_attention(q, k, v, causal=causal)
        again = fa.flash_attention(q, k, v, causal=causal)
        if q.dtype == torch.float32:
            want = ref.flash_attention_plain(q.double(), k.double(),
                                             v.double(), causal=causal)
            bar = REL
        else:
            want = ref.flash_attention_plain(q, k, v, causal=causal)
            bar = BF16_REL
        sync(torch, dev)
        rel, err = rel_err(out, want)
        check(out.shape == q.shape and out.dtype == q.dtype,
              f"flash_attention {what}: {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out).all()),
              f"flash_attention {what}: non-finite output")
        check(rel <= bar, f"flash_attention {what}: rel err {rel:.3e} > {bar}")
        check(torch.equal(out, again),
              f"flash_attention {what}: repeat launch differs")
        return rel, err

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for shape in ATTN_SHAPES:
        for dtype in worst:
            for causal in (True, False):
                rel, _ = hold(*operands(shape, dtype), causal,
                              f"{shape} {dtype} causal={causal}")
                worst[dtype] = max(worst[dtype], rel)
                cases += 1
    q, k, v = operands(serving, torch.float32)
    rel32, _ = hold(q, k, v, True, f"serving {serving} float32")
    del q, k, v
    q, k, v = operands(serving, torch.bfloat16)
    rel, err = hold(q, k, v, True, f"serving {serving} bfloat16")
    # the P·V numerics decision at the serving shape: the kernel rounds each
    # weight p to bf16 once; the alternative splits p into bf16 hi + lo (two
    # P·V products), emulated here in torch on the same inputs
    split_rel, _ = rel_err(attention_p_split(torch, q, k, v),
                           ref.flash_attention_plain(q, k, v, causal=True))
    print(f"flash_attention P·V: p rounded to bf16 once (one bf16 product, "
          f"l sums the rounded weights), rel err {rel:.3e} at the serving "
          f"shape; p as bf16 hi + lo (two products, emulated) "
          f"{split_rel:.3e}; bar {BF16_REL}: the single product is taken")
    print(f"flash_attention: {cases} case shapes plus the serving shape "
          f"within bounds and bitwise on repeat; worst rel err float32 "
          f"{max(worst[torch.float32], rel32):.3e} (bar {REL}), bfloat16 "
          f"{max(worst[torch.bfloat16], rel):.3e} (bar {BF16_REL})")
    # SDPA takes (B, H, S, D): its operands are laid out for it up front
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    terms = flash_attention_terms(*serving, torch.bfloat16, causal=True)
    r = {"max_abs_err": err, "rel_err": rel,
         "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10),
         "plain_ms": time_ms(
             lambda: ref.flash_attention_plain(q, k, v, causal=True), 5),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True), 10),
         "bound_ms": terms.step_time_s * 1e3, "bound_by": terms.bound_by,
         "flops": terms.flops, "bytes": terms.bytes,
         "shape": "B={} S={} H={} D={} bf16 causal".format(*serving)}
    print(f"kernel flash_attention [{r['shape']}]: {r['ms']:.3f} ms "
          f"({terms.flops / r['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']}; "
          f"{r['bound_ms'] / r['ms']:.1%} of it)")
    return r


def ssd_operands(torch, gen, dev, b, L, H, P, N, dtype, model_like=False,
                 slow=False):
    """x (b, L, H, P) and B, C (b, L, N) in ``dtype``, dt (b, L, H), A, D
    (H,) float32.  Case inputs follow tests/test_kernels.py (dt =
    softplus(z)/2, A = −exp(0.3 z)); ``model_like`` ones follow the Mamba2
    forward (dt = softplus(z − 2), A = −linspace(1, 16, H)) and are read as
    views of one (b, L, H·P + 2N) tensor, the conv output the model
    slices them from.  ``slow``: dt = softplus(z − 6), A = −0.05·(1 + 0.1u),
    so states older than one chunk still carry weight (with the other
    decays exp(total) over a chunk is below 1e-14)."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if model_like:
        conv = randn(b, L, H * P + 2 * N).to(dtype)
        x = conv[..., :H * P].reshape(b, L, H, P)
        B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
        dt = F.softplus(randn(b, L, H) - 2.0)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        x = randn(b, L, H, P).to(dtype)
        B, C = (randn(b, L, N) * 0.5).to(dtype), (randn(b, L, N) * 0.5).to(dtype)
        dt = F.softplus(randn(b, L, H)) * 0.5
        A = -torch.exp(randn(H) * 0.3)
    if slow:
        dt = F.softplus(randn(b, L, H) - 6.0)
        A = -0.05 * (1.0 + 0.1 * torch.rand(H, generator=gen, device=dev))
    return x, B, C, dt, A, randn(H)


def older_state_share(torch, plain, args) -> float:
    """How much of y the states older than one chunk carry: max |y − y₂| /
    max |y| in float64, with y₂ the plain version run on two-chunk windows
    (chunk c's rows from a run over chunks c − 1 and c).  A kernel that
    dropped those states would be this far off."""
    x, B, C, dt, A, D, chunk = args
    L = x.shape[1]
    Q = min(chunk, L)
    f64 = [t.double() for t in (x, B, C, dt, A, D)]
    y = plain(*f64, chunk)
    y2 = y.clone()
    for c0 in range(Q, L, Q):
        w = slice(c0 - Q, min(c0 + Q, L))
        y2[:, c0:w.stop] = plain(*(t[:, w] for t in f64[:4]), *f64[4:],
                                 chunk)[:, Q:]
    return float((y - y2).abs().max() / y.abs().max())


def operand_rounding(torch, operand, ct):
    """The rounding of a tensor-core operand that is not an input, in
    ``ct``: None keeps it, "bf16" rounds it to bfloat16 once, "bf16_hilo"
    splits it into bf16 hi + lo (two products), "tf32" rounds it to TF32
    (``cvt.rna``: half an ulp up, the low 13 bits off)."""
    def rnd(t):
        if operand is None:
            return t
        if operand == "tf32":
            b = t.float().contiguous().view(torch.int32)
            return ((b + 0x1000) & ~0x1FFF).view(torch.float32).to(ct)
        hi = t.to(torch.bfloat16).to(ct)
        if operand == "bf16":
            return hi
        return hi + (t - hi).to(torch.bfloat16).to(ct)
    return rnd


def ssd_three_pass(torch, x, B, C, dt, A, D, chunk, operand=None):
    """K6's tensor-core route in torch: chunk states s_c = Bᵀ(w ⊙ x), state
    passing S_{c+1} = exp(total_c)·S_c + s_c, output M·x + exp(cum_i)·C·S_c
    + D·x, in x's promoted dtype (float32 for bf16).  ``operand`` rounds
    the three tensor-core operands that are not inputs (w ⊙ x, M and S)
    before their products: "bf16" (the kernel's choice), "bf16_hilo" (hi +
    lo, two products) or "tf32"; None keeps them exact.  Returns y in x's
    dtype."""
    dtype, ct = x.dtype, torch.promote_types(x.dtype, torch.float32)
    rnd = operand_rounding(torch, operand, ct)
    F = torch.nn.functional
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    n = -(-L // Q)
    pad = n * Q - L
    x, B, C, dt = (F.pad(t.to(ct), (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, B, C, dt))
    A, D = A.to(ct), D.to(ct)
    xs, Bs, Cs = x.view(b, n, Q, H, P), B.view(b, n, Q, N), C.view(b, n, Q, N)
    dts = dt.view(b, n, Q, H)
    dA = dts * A
    cum = torch.cumsum(dA, 2)
    rev = torch.flip(torch.cumsum(torch.flip(dA, [2]), 2), [2]) - dA
    s = torch.einsum("bcjN,bcjhp->bchNp", Bs,
                     rnd((torch.exp(rev) * dts)[..., None] * xs))
    S = torch.zeros((b, n, H, N, P), dtype=ct, device=x.device)
    for c in range(1, n):
        S[:, c] = torch.exp(cum[:, c - 1, -1])[..., None, None] \
            * S[:, c - 1] + s[:, c - 1]
    del s
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(n):
        CB = torch.einsum("biN,bjN->bij", Cs[:, c], Bs[:, c])
        M = CB[..., None] * torch.where(
            mask[None, :, :, None],
            torch.exp(cum[:, c, :, None, :] - cum[:, c, None, :, :]), 0.0) \
            * dts[:, c, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", rnd(M), xs[:, c])
        del M
        y = y + torch.exp(cum[:, c])[..., None] * torch.einsum(
            "biN,bhNp->bihp", Cs[:, c], rnd(S[:, c]))
        ys.append(y + D[:, None] * xs[:, c])
    return torch.cat(ys, 1)[:, :L].to(dtype)


# the six operands of the backward's bf16 route that are not inputs
SSD_BWD_ROUNDED = ("w*x", "e*dy", "M", "dG", "S", "dS")


def ssd_bwd_passes(torch, x, B, C, dt, A, D, dy, chunk, operand=None,
                   rounded=SSD_BWD_ROUNDED):
    """K6's backward as its tensor-core route computes it, in torch:
    the cumsums in float64; chunk states s_c = Bᵀ(w ⊙ x) and ds_c =
    Cᵀ(e ⊙ dy) (w_j = exp(total − cum_j)·dt_j, e_i = exp(cum_i)); state
    passing S_c, dS_{c+1} and ⟨S_c, dS_{c+1}⟩; per chunk Gᵀ = B Cᵀ, Dᵀ =
    x dyᵀ, M = G ⊙ L ⊙ dt_j (the forward's), dx = Mᵀ dy + w_j B_j·dS +
    D dy, dG summed over each chunk CTA's block of heads
    (``ssd_scan.BWD_TC_HB``) and rounded once, dB = dGᵀ C
    + Σ_h w_j x_j dSᵀ, dC = dG B + Σ_h e_i dy_i Sᵀ, dw = x · (B dS), the
    row sums of T = G ⊙ L ⊙ dt_j ⊙ (dy·x) and column sums of G ⊙ L ⊙
    (dy·x) in float64, then dcum's reverse cumsum, ddt, dA, dD.  ``operand`` rounds the operands named in
    ``rounded`` (of ``SSD_BWD_ROUNDED``) as :func:`operand_rounding` does;
    None keeps every product exact.  Computes in x's promoted dtype
    (float32 for bf16) and returns (dx, dB, dC, ddt, dA, dD) in the
    operands' dtypes, as ``ref.ssd_scan_bwd_plain`` does."""
    from repro_torch.kernels.ssd_scan import BWD_TC_HB
    F = torch.nn.functional
    ct = torch.promote_types(x.dtype, torch.float32)
    f64 = torch.float64
    keep = operand_rounding(torch, None, ct)
    rnd = {k: operand_rounding(torch, operand, ct) if k in rounded else keep
           for k in SSD_BWD_ROUNDED}
    dtypes = (x.dtype, B.dtype, C.dtype, dt.dtype, A.dtype, D.dtype)
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    n = -(-L // Q)
    pad = n * Q - L
    HB = BWD_TC_HB
    nhb = -(-H // HB)
    x, B, C, dt, dy = (F.pad(t.to(ct), (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, B, C, dt, dy))
    xs, ys = x.view(b, n, Q, H, P), dy.view(b, n, Q, H, P)
    Bs, Cs, dts = B.view(b, n, Q, N), C.view(b, n, Q, N), dt.view(b, n, Q, H)
    cum = torch.cumsum(dts.to(f64) * A.to(f64), 2)              # (b, n, Q, H)
    total = cum[:, :, -1]                                        # (b, n, H)
    dec = torch.exp((total[:, :, None] - cum).to(ct))
    w, e = dec * dts, torch.exp(cum.to(ct))
    # pass 1: the chunk states and their gradients' chunk shares
    s = torch.einsum("bcjN,bcjhp->bchNp", Bs, rnd["w*x"](w[..., None] * xs))
    ds = torch.einsum("bciN,bcihp->bchNp", Cs, rnd["e*dy"](e[..., None] * ys))
    # pass 2: S_c and dS_{c+1} (index c), and <S_c, dS_{c+1}> unrounded
    tot = torch.exp(total.to(ct))[..., None, None]
    S, dS = torch.zeros_like(s), torch.zeros_like(ds)
    for c in range(1, n):
        S[:, c] = tot[:, c - 1] * S[:, c - 1] + s[:, c - 1]
    for c in range(n - 2, -1, -1):
        dS[:, c] = tot[:, c + 1] * dS[:, c + 1] + ds[:, c + 1]
    del s, ds
    hss = (S * dS).sum((-2, -1))                                 # (b, n, H)
    S, dS = rnd["S"](S), rnd["dS"](dS)
    # pass 3: every gradient of a chunk
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (b,n,i,j,H)
    Lm = torch.exp(diff.masked_fill(~mask[:, :, None], float("-inf"))
                   .to(ct))
    del diff
    G = torch.einsum("bciN,bcjN->bcij", Cs, Bs)
    Dd = torch.einsum("bcihp,bcjhp->bcijh", ys, xs)
    R = G[..., None] * Lm
    M = R * dts[:, :, None]
    RD = (R * Dd).to(f64)
    dcr = (RD * dts[:, :, None].to(f64)).sum(3)                  # (b,n,i,H)
    dcc = RD.sum(2)                                              # (b,n,j,H)
    del R, RD
    U = torch.einsum("bcjN,bchNp->bcjhp", Bs, dS)
    dx = torch.einsum("bcijh,bcihp->bcjhp", rnd["M"](M), ys) \
        + w[..., None] * U + D.to(ct)[:, None] * ys
    del M
    dGh = F.pad(Lm * dts[:, :, None] * Dd, (0, nhb * HB - H))
    dG = rnd["dG"](dGh.view(b, n, Q, Q, nhb, HB).sum(-1))
    del Lm, Dd, dGh
    dB = torch.einsum("bcijk,bciN->bcjN", dG, Cs) + torch.einsum(
        "bcjh,bcjhp,bchNp->bcjN", w, xs, dS)
    dC = torch.einsum("bcijk,bcjN->bciN", dG, Bs) + torch.einsum(
        "bcih,bcihp,bchNp->bciN", e, ys, S)
    dws = (xs * U).sum(-1)                                       # (b,n,j,H)
    dcs = e * (ys * torch.einsum("bciN,bchNp->bcihp", Cs, S)).sum(-1)
    dtot = torch.exp(total.to(ct)).to(f64) * hss.to(f64) \
        + (w * dws).to(f64).sum(2)
    dcum = dcr - dts.to(f64) * dcc + dcs.to(f64) - (w * dws).to(f64)
    dcum[:, :, -1] += dtot
    da = dcum.flip(2).cumsum(2).flip(2)
    ddt = dcc + (dec * dws).to(f64) + A.to(f64) * da
    dA = (dts.to(f64) * da).sum((0, 1, 2))
    dD = (xs * ys).sum((0, 1, 2, 4))
    return tuple(t.reshape(b, n * Q, *t.shape[3:])[:, :L].to(d)
                 if t.dim() > 1 else t.to(d)
                 for t, d in zip((dx, dB, dC, ddt, dA, dD), dtypes))


def ssd_design_bytes(b, L, H, P, N, Q) -> float:
    """Bytes K6's three bf16 passes move at (b, L, H, P, N, Q): pass 1 reads
    x, B and dt and writes the float32 chunk states and the cumsums; pass 2
    reads the states and the chunk totals and writes the bf16 carried-in
    states (N rounded up to 16, 64 columns); pass 3 reads x, B, C, dt and
    the cumsums, the carried-in states once per 64-row tile, and writes
    y."""
    n = -(-L // Q)
    x, bc, d = 2.0 * b * L * H * P, 2.0 * b * L * N, 4.0 * b * L * H
    cum, s = 4.0 * b * n * H * Q, 4.0 * b * (n - 1) * H * N * P
    sb = 2.0 * b * (n - 1) * H * (-(-N // 16) * 16) * 64
    return (x + bc + d + s + cum) + (s + 4.0 * b * n * H + sb) \
        + (x + 2 * bc + d + cum + sb * -(-Q // 64) + x)


def ssm_kernels_phase(torch, dev, shard_rows: int, seq: int, cfg) -> dict:
    """K6 and K7 against their plain versions at the case shapes, a ragged
    L and the serving shapes of one lm_score shard of ``cfg`` (Mamba2),
    bitwise on repeat; their times there.  Returns the kernel line's
    numbers for both."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.perf.roofline import rmsnorm_terms, ssd_scan_terms

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = {}
    routes = {}                   # K6's route for each dtype, over all cases

    def hold(name, kernel, plain, args, widen, what):
        """``widen``: the f32 bar becomes the plain version's own float32
        error against float64 on these inputs where that is larger."""
        before = dict(sk.route_launches)
        out, again = kernel(*args), kernel(*args)
        if name == "ssd_scan":
            took = [k for k in sk.ROUTES
                    if sk.route_launches[k] - before[k] == 2]
            check(len(took) == 1, f"ssd_scan {what}: routes {took}")
            routes.setdefault(str(args[0].dtype), set()).add(took[0])
        f32 = args[0].dtype == torch.float32
        if f32:
            want = plain(*(a.double() if torch.is_tensor(a) else a
                           for a in args))
            bar = REL
            if widen:
                own, _ = rel_err(plain(*args), want)
                bar = max(REL, own)
        else:
            want, bar = plain(*args), BF16_REL
        sync(torch, dev)
        rel, err = rel_err(out, want)
        check(out.shape == args[0].shape and out.dtype == args[0].dtype,
              f"{name} {what}: {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name} {what}: non-finite")
        check(rel <= bar, f"{name} {what}: rel err {rel:.3e} > {bar:.3e}")
        check(torch.equal(out, again), f"{name} {what}: repeat launch differs")
        key = (name, "float32" if f32 else "bfloat16")
        worst[key] = max(worst.get(key, 0.0), rel)
        return rel, err, bar

    cases = 0
    for b, L, H, P, N, Q in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = (*ssd_operands(torch, gen, dev, b, L, H, P, N, dtype), Q)
            hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain, args, True,
                 f"(b={b} L={L} H={H} P={P} N={N} Q={Q}) {dtype}")
            cases += 1
    for b, L, H, P, N, Q in SSD_SLOW_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = (*ssd_operands(torch, gen, dev, b, L, H, P, N, dtype,
                                  slow=True), Q)
            what = f"(b={b} L={L} H={H} P={P} N={N} Q={Q}) {dtype} slow decay"
            rel, _, bar = hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain,
                               args, True, what)
            print(f"ssd_scan {what}: rel err {rel:.3e} (bar {bar:.3e}); "
                  f"states older than one chunk carry "
                  f"{older_state_share(torch, ref.ssd_scan_plain, args):.3e}"
                  f" of y")
            cases += 1
    for rows, D, offset in RMS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.randn(rows * D + offset, generator=gen,
                               device=dev).to(dtype)
            x = flat[offset:].view(rows, D)     # offset 1: unaligned rows
            w = torch.randn(D, generator=gen, device=dev)
            hold("rmsnorm", rk.rmsnorm, ref.rmsnorm_plain, (x, w), False,
                 f"({rows}, {D}) offset {offset} {dtype}")
            cases += 1

    out = {}
    # K6 at the serving shape: one shard's SSD, as the model calls it
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    serving = (shard_rows, seq, H, P, N)
    args = (*ssd_operands(torch, gen, dev, *serving, torch.float32,
                          model_like=True), Q)
    rel32, _, bar32 = hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain, args,
                           True, f"serving {serving} float32")
    del args
    print(f"ssd_scan serving float32: rel err {rel32:.3e} against float64, "
          f"bar {bar32:.3e} (1e-5, or the plain float32 version's own error "
          f"on the same inputs where larger)")
    args = (*ssd_operands(torch, gen, dev, *serving, torch.bfloat16,
                          model_like=True, slow=True), Q)
    rel, _, _ = hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain, args,
                     False, f"serving {serving} bfloat16 slow decay")
    print(f"ssd_scan serving bfloat16, slow decay: rel err {rel:.3e} (bar "
          f"{BF16_REL}); states older than one chunk carry "
          f"{older_state_share(torch, ref.ssd_scan_plain, args):.3e} of y")
    del args
    args = (*ssd_operands(torch, gen, dev, *serving, torch.bfloat16,
                          model_like=True), Q)
    before = dict(sk.route_launches)
    rel, err, _ = hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain, args,
                       False, f"serving {serving} bfloat16")
    per_call = {k: (sk.route_launches[k] - before[k]) // 2
                for k in sk.route_launches}
    check(per_call["tensor_cores"] == 1 and per_call["output"] == 1,
          f"ssd_scan serving bfloat16 took {per_call}, not the tensor cores")
    b_, n_, hb_ = shard_rows, -(-seq // Q), -(-H // 2)
    ctas = {"chunk_states": b_ * n_ * hb_,
            "output": b_ * n_ * hb_ * -(-Q // 64)}
    check(ctas["output"] >= SSD_MIN_CTAS,
          f"ssd_scan output grid {ctas['output']} < {SSD_MIN_CTAS} CTAs")
    # the numerics decision at the serving shape: the operands the tensor
    # cores multiply (w ⊙ x, M, S) rounded as each candidate would, in
    # torch on the same inputs, against the plain version in float32 math
    # (no output rounding on either side)
    f32_args = [t.float() for t in args[:6]]
    want32 = ref.ssd_scan_plain(*f32_args, Q)
    cand = {op: rel_err(ssd_three_pass(torch, *f32_args, Q, op), want32)[0]
            for op in SSD_CANDIDATES}
    out_round = rel_err(want32.bfloat16(), want32)[0]
    del f32_args, want32
    terms = ssd_scan_terms(*serving, Q, torch.bfloat16)
    design = ssd_design_bytes(*serving, Q)
    out["ssd_scan"] = {
        "max_abs_err": err, "rel_err": rel,
        "ms": time_ms(lambda: sk.ssd_scan(*args), 10),
        "plain_ms": time_ms(lambda: ref.ssd_scan_plain(*args), 3),
        "library_ms": None, "bound_ms": terms.step_time_s * 1e3,
        "bound_by": terms.bound_by, "flops": terms.flops,
        "bytes": terms.bytes,
        "shape": "b={} L={} H={} P={} N={} Q={} bf16 x/B/C (views of one "
                 "conv output), f32 dt".format(*serving, Q)}
    # each pass's device time, over three warm calls
    _, per_pass = device_events(
        torch, lambda: [sk.ssd_scan(*args) for _ in range(3)])
    pass_ms = {}
    for name, (t, _) in per_pass.items():
        m = re.search(r"ssd_scan_[a-z0-9]+_kernel", name)
        key = m.group(0) if m else name[:40]
        pass_ms[key] = pass_ms.get(key, 0.0) + t / 3
    print(f"ssd_scan serving bfloat16: route tensor_cores; launches per call "
          f"{ {k: per_call[k] for k in sk.PASSES} }; CTAs {ctas}; device ms "
          f"per pass " + ", ".join(f"{k} {v:.4f}" for k, v in
                                   pass_ms.items()))
    print(f"ssd_scan serving bfloat16: the design moves "
          f"{design / 1e6:.1f} MB ({design / HBM_BW * 1e3:.3f} ms at "
          f"{HBM_BW / 1e12:.2f} TB/s) beside the function's "
          f"{terms.bytes / 1e6:.1f} MB bound ({terms.step_time_s * 1e3:.3f}"
          f" ms, {terms.bound_by})")
    print(f"ssd_scan numerics at the serving shape, against the plain version"
          f" in float32 math, operands w⊙x, M, S rounded as: " + ", ".join(
              f"{op} {v:.3e}" for op, v in cand.items())
          + f" (emulated); the output's own bf16 rounding {out_round:.3e}; "
          f"the kernel (bf16 once, bf16 output) {rel:.3e}, bar {BF16_REL}")
    print("ssd_scan routes over every case: " + ", ".join(
        f"{d} -> {sorted(r)}" for d, r in sorted(routes.items())))
    check(routes.get("torch.bfloat16") == {"tensor_cores"},
          f"ssd_scan: a bfloat16 case left the tensor cores: {routes}")
    del args
    # K7 at the serving shapes: the block norm (d) and the gate norm (d_inner)
    times = {}
    for D, what in ((cfg.d_model, "block"), (cfg.d_inner, "gate")):
        rows = shard_rows * seq
        x = torch.randn((rows, D), generator=gen, device=dev)
        w = torch.randn(D, generator=gen, device=dev)
        hold("rmsnorm", rk.rmsnorm, ref.rmsnorm_plain, (x, w), False,
             f"serving ({rows}, {D}) float32")
        x = x.bfloat16()
        rel, err, _ = hold("rmsnorm", rk.rmsnorm, ref.rmsnorm_plain, (x, w),
                           False, f"serving ({rows}, {D}) bfloat16")
        # yardsticks only, never called by the port: rms_norm on the same
        # inputs (float32 w), and with a bf16 w, which may take a fused path
        wb = w.bfloat16()
        try:
            F.rms_norm(x, (D,), weight=w, eps=1e-6)
            wl, lib_w = w, "float32 w"
        except RuntimeError:
            wl, lib_w = wb, "bfloat16 w (refuses float32 w)"
        terms = rmsnorm_terms(rows, D, torch.bfloat16)
        times[what] = {
            "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(lambda: rk.rmsnorm(x, w), 20),
            "device_ms": kernel_device_ms(torch, lambda: rk.rmsnorm(x, w),
                                          20, "rmsnorm"),
            "plain_ms": time_ms(lambda: ref.rmsnorm_plain(x, w), 10),
            "library_ms": time_ms(lambda: F.rms_norm(
                x, (D,), weight=wl, eps=1e-6), 20),
            "library": f"torch.nn.functional.rms_norm, {lib_w}; with a "
                       f"bfloat16 w " + "{:.3f} ms".format(time_ms(
                           lambda: F.rms_norm(x, (D,), weight=wb, eps=1e-6),
                           20)),
            "bound_ms": terms.step_time_s * 1e3, "bound_by": terms.bound_by,
            "flops": terms.flops, "bytes": terms.bytes,
            "shape": f"rows={rows} D={D} bf16 ({what} norm)"}
        del x, w, wb, wl
    out["rmsnorm"] = times["block"]
    out["rmsnorm_gate"] = times["gate"]
    print(f"ssm kernels: {cases} case shapes plus the serving shapes within "
          f"bounds and bitwise on repeat; worst rel err " + ", ".join(
              f"{k} {d} {v:.3e}" for (k, d), v in sorted(worst.items())))
    for k, r in out.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.3f} ({r['library']})"
        dev_t = "" if "device_ms" not in r else \
            (f" (the kernel alone {r['device_ms']:.4f} ms, "
             f"{r['bound_ms'] / r['device_ms']:.1%} of the bound)")
        print(f"kernel {k} [{r['shape']}]: {r['ms']:.4f} ms{dev_t}, plain "
              f"{r['plain_ms']:.3f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.1%} of it), rel err "
              f"{r['rel_err']:.3e}")
    return out


def tile_cases(operands, vmax: dict) -> list[tuple]:
    """The single_tile phase's cases, (kind, what, operands): B 2, E 5,
    V 64, R 4 and E ∈ TILE_ES, V ∈ TILE_VS and the largest V each kernel
    accepts, shared and per-batch, ``operands(kind, B, E, V, shared)``
    drawing them."""
    cases = []
    for kind in ("dense", "structured"):
        shapes = [(TILE_E, TILE_V)] + [(E, TILE_V) for E in TILE_ES] \
            + [(TILE_E, V) for V in (*TILE_VS, vmax[kind])]
        for shared in (True, False):
            for E, V in shapes:
                what = (f"B={TILE_B} E={E} V={V}"
                        + ("" if kind == "dense" else f" R={TILE_R}")
                        + f" shared={shared}")
                cases.append((kind, what,
                              operands(kind, TILE_B, E, V, shared)))
    return cases


def single_tile_phase(torch, dev) -> dict:
    """K4a/K4b through their dispatch routes at every case shape (the
    phase's main path, launches counted from 0), then held against K1/K2
    bitwise, against the float64 plain version at ≤1e-5 and against a
    repeat launch; the size refusal; times at V 64 and at the largest V
    (K4b also with a per-batch scenario, and at its largest V for R 8),
    each timed case bitwise equal to the blocked kernel.  Returns each
    kernel's line numbers (the largest V, shared) and the launches."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.perf.roofline import (
        edge_latency_single_tile_terms,
        edge_latency_structured_single_tile_terms)

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    names = {"dense": "edge_latency_dense_single_tile",
             "structured": "edge_latency_structured_single_tile"}
    route = {"dense": dispatch.edge_latency_single_tile,
             "structured": dispatch.edge_latency_structured_single_tile}
    blocked = {"dense": kernels.edge_latency_dense,
               "structured": kernels.edge_latency_structured}
    single = {"dense": kernels.edge_latency_dense_single_tile,
              "structured": kernels.edge_latency_structured_single_tile}
    plain = {"dense": ref.edge_latency_dense_single_tile_plain,
             "structured": ref.edge_latency_structured_single_tile_plain}
    vmax = {"dense": kernels.single_tile_max_v(),
            "structured": kernels.single_tile_max_v(TILE_R)}

    def operands(kind, B, E, V, shared, R=TILE_R):
        bc = 1 if shared else B
        if kind == "dense":
            return randn(B, E, V), randn(B, E, V), randn(bc, V, V)
        return (randn(B, E, V), randn(B, E, V), randn(B, E, R),
                randn(bc, R, V), randn(bc, 1, V))

    cases = tile_cases(operands, vmax)
    sync(torch, dev)
    kernels.reset_launches()
    outs = [route[kind](*args) for kind, _, args in cases]
    sync(torch, dev)
    launched = {names[k]: kernels.launches[names[k]] for k in names}
    for kind, name in names.items():
        n = sum(1 for k, _, _ in cases if k == kind)
        check(launched[name] == n,
              f"single_tile: {name} launched {launched[name]} times for "
              f"{n} cases")
    worst = {name: 0.0 for name in names.values()}
    for (kind, what, args), out in zip(cases, outs):
        name = names[kind]
        check(torch.equal(out, blocked[kind](*args)),
              f"{name} {what}: differs from the blocked kernel")
        check(torch.equal(out, single[kind](*args)),
              f"{name} {what}: repeat launch differs")
        rel, _ = rel_err(out, plain[kind](*(a.double() for a in args)))
        check(rel <= REL, f"{name} {what}: rel err {rel:.3e} > {REL}")
        worst[name] = max(worst[name], rel)
    for kind, name in names.items():
        V = vmax[kind] + 1
        try:
            single[kind](*operands(kind, 1, 1, V, True))
        except ValueError as e:
            check("shared memory" in str(e), f"{name}: refusal says {e}")
        else:
            raise AssertionError(f"{name} accepted V={V} over its limit")
    print(f"single_tile: {len(cases)} cases through the dispatch routes, "
          f"launches {launched}; K4a == K1 and K4b == K2 bitwise, repeats "
          f"bitwise, worst rel err to float64 " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f"; largest V accepted: K4a {vmax['dense']}, K4b "
            f"{vmax['structured']} (R={TILE_R}); V+1 refused")

    # timed: (kind, V, R, shared scenario, the kernel line's case); each
    # also held bitwise against the blocked kernel
    report = {}
    B, E = TILE_TIMED
    r8_max = kernels.single_tile_max_v(TILE_R8)
    timed = [("dense", TILE_V, None, True, False),
             ("dense", vmax["dense"], None, True, True),
             ("structured", TILE_V, TILE_R, True, False),
             ("structured", vmax["structured"], TILE_R, True, True),
             ("structured", vmax["structured"], TILE_R, False, False),
             ("structured", r8_max, TILE_R8, True, False)]
    for kind, V, R, shared, line in timed:
        name = names[kind]
        args = operands(kind, B, E, V, shared, R)
        out = single[kind](*args)
        shape = (f"B={B} E={E} V={V}" + ("" if R is None else f" R={R}")
                 + (" shared" if shared else " per-batch"))
        check(torch.equal(out, blocked[kind](*args)),
              f"{name} timed {shape}: differs from the blocked kernel")
        rel, err = rel_err(out, plain[kind](*(a.double() for a in args)))
        check(rel <= REL, f"{name} timed {shape}: rel err {rel:.3e} > {REL}")
        if kind == "dense":
            terms = edge_latency_single_tile_terms(B, E, V, 1)
            xi, xj, com = args
            lib = time_ms(lambda: (xi * torch.einsum(
                "buv,bev->beu", com, xj)).amax(-1), 10)
        else:
            terms = edge_latency_structured_single_tile_terms(
                B, E, V, R, 1 if shared else B)
            lib = None
        r = {"max_abs_err": err, "rel_err": rel,
             "ms": time_ms(lambda: single[kind](*args), 20),
             "device_ms": kernel_device_ms(
                 torch, lambda: single[kind](*args), 20, "single_tile"),
             "blocked_ms": time_ms(lambda: blocked[kind](*args), 20),
             "plain_ms": time_ms(lambda: plain[kind](*args), 10),
             "library_ms": lib, "bound_ms": terms.step_time_s * 1e3,
             "bound_by": terms.bound_by, "shape": shape}
        lib_s = "n/a" if lib is None else f"{lib:.4f}"
        print(f"kernel {name} [{shape}]: {r['ms']:.4f} ms (the kernel "
              f"alone {r['device_ms']:.4f}), blocked "
              f"{r['blocked_ms']:.4f} ms (bitwise equal), plain "
              f"{r['plain_ms']:.4f} ms, library {lib_s} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.1%} of it, the kernel alone "
              f"{r['bound_ms'] / r['device_ms']:.1%})")
        if line:
            report[name] = r
        del args, out
    return {"report": report, "launches": launched}


def interleaved_ms(fns, rounds: int, reps: int) -> list[float]:
    """Each of ``fns`` timed by :func:`time_ms` in ``rounds`` rounds of the
    order 0 … n-1, n-1 … 0 (parent, change, change, parent): the median of
    its 2·rounds readings, so a drift of the card's clock over the
    measurement weighs on every function alike."""
    readings = [[] for _ in fns]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for _ in range(rounds):
        for i in order:
            readings[i].append(time_ms(fns[i], reps))
    return [statistics.median(r) for r in readings]


def config_pair(kind: str, cfg) -> tuple[int, int]:
    """The fields of a block-policy config that ``kind`` reads."""
    return (cfg.stages, cfg.group) if kind == "dense" \
        else (cfg.rows, cfg.unroll)


def block_policy_phase(torch, dev, card: str = "") -> dict:
    """The block policy (K3) on the card at :data:`BLOCK_SHAPES`: each
    candidate config held bitwise against the default and its launcher's
    tiles against ``block_geometry``; the default against the float64 plain
    version; each candidate's predicted and measured ms; the race of the
    top three through ``get_config(timer=)``, whose decisions stay in the
    table for the serving phases; the analytic pick within
    :data:`BLOCK_SLACK` of the race's winner at :data:`BLOCK_GATED`; every
    candidate bitwise K4a / K4b at the single_tile shapes.  Returns the
    per-shape summary and the table's rows."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import edge_latency as kernels

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(kind, B, E, V, shared, R=TILE_R):
        bc = 1 if shared else B
        if kind == "dense":
            return randn(B, E, V), randn(B, E, V), randn(bc, V, V)
        return (randn(B, E, V), randn(B, E, V), randn(B, E, R),
                randn(bc, R, V), randn(bc, 1, V))

    names = {"dense": "edge_latency_dense",
             "structured": "edge_latency_structured"}
    blocked = {"dense": kernels.edge_latency_dense,
               "structured": kernels.edge_latency_structured}
    plain = {"dense": ref.edge_latency_dense_plain,
             "structured": ref.edge_latency_structured_plain}
    autotune.clear_table()
    summary = {}
    for label, kind, B, E, V, R in BLOCK_SHAPES:
        t0 = time.perf_counter()
        name, run = names[kind], blocked[kind]
        args = operands(kind, B, E, V, True, R)
        bucket = autotune.ShapeKey.of("cuda", kind, B, E, V, R).b_bucket
        ranked = autotune.rank(kind, bucket, E, V, R)
        default = run(*args)
        sync(torch, dev)
        geometry = kernels.block_geometry(kind, E, V, R, None, B=B)
        check(kernels.last_launch[name]["tiles"] == geometry.tiles,
              f"block_policy {label}: the launcher's "
              f"{kernels.last_launch[name]} tiles, block_geometry's "
              f"{geometry.tiles}")
        rel, _ = rel_err(default, plain[kind](*(a.double() for a in args)))
        check(rel <= REL, f"block_policy {label}: the default config's rel "
                          f"err {rel:.3e} > {REL}")
        rows = []
        for cfg in ranked:
            out = run(*args, config=cfg)
            sync(torch, dev)
            pair = config_pair(kind, cfg)
            g = kernels.block_geometry(kind, E, V, R, cfg, B=B)
            got = kernels.last_launch[name]
            check(got["tiles"] == g.tiles,
                  f"block_policy {label} {pair}: the launcher's tiles "
                  f"{got['tiles']}, block_geometry's {g.tiles}")
            check(torch.equal(out, default),
                  f"block_policy {label} {pair}: differs from the default "
                  f"config")
            rows.append({"config": pair, "ctas": got["ctas"],
                         "predicted_ms": 1e3 * autotune.predict_seconds(
                             kind, bucket, E, V, R, cfg),
                         "ms": time_ms(lambda: run(*args, config=cfg),
                                       BLOCK_REPS)})
        # the race: the top three timed interleaved, then handed to
        # get_config through its timer, which records the order it asks
        top = [config_pair(kind, c)
               for c in ranked[:autotune.EMPIRICAL_TOP_K]]
        race_ms = dict(zip(top, interleaved_ms(
            [lambda c=c: run(*args, config=c)
             for c in ranked[:autotune.EMPIRICAL_TOP_K]],
            BLOCK_ROUNDS, BLOCK_REPS)))
        raced = {}

        def timer(cfg):
            raced[config_pair(kind, cfg)] = race_ms[config_pair(kind, cfg)]
            return raced[config_pair(kind, cfg)] / 1e3

        chosen = autotune.get_config(kind, B, E, V, R, backend="cuda",
                                     timer=timer)
        check(list(raced) == top, f"block_policy {label}: raced "
                                  f"{list(raced)}, the top three {top}")
        pick, winner = top[0], min(raced, key=raced.get)
        check(config_pair(kind, chosen) == winner,
              f"block_policy {label}: get_config chose "
              f"{config_pair(kind, chosen)}, the race {winner}")
        gap = raced[pick] / raced[winner] - 1.0
        if label in BLOCK_GATED:
            check(gap <= BLOCK_SLACK,
                  f"block_policy {label}: the analytic pick {pick} "
                  f"{raced[pick]:.4f} ms is {gap:.1%} over the race's "
                  f"winner {winner} {raced[winner]:.4f} ms "
                  f"(slack {BLOCK_SLACK:.0%})")
        wall = time.perf_counter() - t0
        fields = "(stages, group)" if kind == "dense" else "(rows, unroll)"
        print(f"block_policy {label} [{kind} B={B} E={E} V={V}"
              + ("" if R is None else f" R={R}")
              + f" shared; {card}]: {fields} candidates, best predicted "
              f"first: " + "; ".join(
                  f"{r['config']} {r['ms']:.4f} ms (predicted "
                  f"{r['predicted_ms']:.4f}, {r['ctas']} CTAs)"
                  for r in rows)
              + f"; raced {', '.join(f'{p} {t:.4f}' for p, t in raced.items())}"
              f" ms; analytic pick {pick}, race winner {winner} (pick "
              f"{gap:+.1%}); all bitwise the default, tiles == "
              f"block_geometry's; default rel err {rel:.3e}; {wall:.1f} s")
        summary[label] = {"kind": kind, "candidates": rows, "raced": raced,
                          "pick": pick, "winner": winner, "gap": gap}
        del args, default, out
        torch.cuda.empty_cache()

    # every candidate against the single-tile kernels
    vmax = {"dense": kernels.single_tile_max_v(),
            "structured": kernels.single_tile_max_v(TILE_R)}
    single = {"dense": kernels.edge_latency_dense_single_tile,
              "structured": kernels.edge_latency_structured_single_tile}
    cases = tile_cases(operands, vmax)
    n = 0
    every = {kind: [autotune.KernelConfig(**dict(zip(
        ("stages", "group") if kind == "dense" else ("rows", "unroll"),
        pair))) for pair in pairs] for kind, pairs in (
        ("dense", kernels.DENSE_CONFIGS),
        ("structured", kernels.STRUCTURED_CONFIGS))}
    for kind, what, args in cases:
        want = single[kind](*args)
        for cfg in every[kind]:
            check(torch.equal(blocked[kind](*args, config=cfg), want),
                  f"block_policy: {names[kind]} {config_pair(kind, cfg)} "
                  f"{what} differs from the single-tile kernel")
            n += 1
    sync(torch, dev)
    rows = autotune.table_rows()
    print(f"block_policy: {n} (case, config) pairs bitwise K4a / K4b at the "
          f"single_tile shapes; decision table {json.dumps(rows)}")
    return {"summary": summary, "table": rows}


def quality_phase(torch, np, dev) -> dict:
    """``quality_scores_torch`` (A11) on the card at :data:`QUALITY_SHAPE`
    against its CPU route and the numpy ``quality_scores``."""
    import warnings

    from repro_torch.streaming.quality import (quality_scores,
                                               quality_scores_torch)
    rng = np.random.default_rng(SEED + 6)
    B, S = QUALITY_SHAPE
    toks = rng.integers(-1, 30, (B, S))
    toks[0] = 7                      # a stuck sensor
    toks[1] = -1                     # a fully missing row
    toks[2, ::2] = -1                # half missing
    toks[3, 10:200] = 5              # one long run
    on_card = torch.as_tensor(toks, device=dev)
    got = quality_scores_torch(on_card)
    sync(torch, dev)
    check(got.device.type == dev.type and got.dtype == torch.float32
          and got.shape == (B,), f"quality: {got.dtype} {tuple(got.shape)} "
                                 f"on {got.device}")
    check(bool(torch.isfinite(got).all()), "quality: non-finite scores")
    ms = time_ms(lambda: quality_scores_torch(on_card), 10)
    cpu = quality_scores_torch(toks, device="cpu")
    with warnings.catch_warnings():  # the fully missing row's empty means
        warnings.simplefilter("ignore", RuntimeWarning)
        want = quality_scores(toks)
    got = got.cpu()
    err_cpu = float((got - cpu).abs().max())
    err_np = float(np.abs(got.numpy().astype(np.float64) - want).max())
    check(err_cpu <= QUALITY_CPU_TOL, f"quality: {err_cpu:.3e} from the CPU "
                                      f"route > {QUALITY_CPU_TOL}")
    check(err_np <= QUALITY_NUMPY_TOL, f"quality: {err_np:.3e} from numpy's "
                                       f"quality_scores > "
                                       f"{QUALITY_NUMPY_TOL}")
    check(float(got[1]) == 0.0 and float(got[0]) < float(got.median()),
          "quality: the missing row does not score 0 or the stuck row does "
          "not score low")
    mb = toks.nbytes / 2 ** 20
    print(f"quality: quality_scores_torch on {B} x {S} int64 ({mb:.0f} MiB) "
          f"on the card {ms:.4f} ms; max |card - CPU route| {err_cpu:.3e} "
          f"(bar {QUALITY_CPU_TOL}), max |card - numpy| {err_np:.3e} (bar "
          f"{QUALITY_NUMPY_TOL})")
    return {"ms": ms, "err_cpu": err_cpu, "err_numpy": err_np}


def serve_multi_phase(torch, np, dev, phase: str, graph, pack, xs,
                      rows: tuple, speed, kernel: str, oracle_fleet,
                      profile: bool = True) -> dict:
    """``WhatIfService`` with all five §3.1 objectives on ``pack`` (see
    the module docstring, phases 3b/4b): four queries from three tenants
    in one chunk, launches counted from 0 around submit → drain, every
    served grid and score against a direct ``score_grid(objectives=)``
    over the padded chunk, the oracle, the decision layer.  Returns the
    launches, peak memory, the oracle's worst error, and the padded chunk,
    evaluator and set for a caller's further checks."""
    from repro_torch.core.objectives import (OBJECTIVES, ObjectiveGrids,
                                             ObjectiveSet)
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.search.decision import (candidate_values,
                                             epsilon_constraint,
                                             joint_dq_scores, pareto_front,
                                             split_dq_term)
    from repro_torch.serve import (AdmissionConfig, QueryResult, WhatIfQuery,
                                   WhatIfService)
    from repro_torch.serve.bucketing import (dq_denominator, finish_scores,
                                             next_pow2, pad_rows)
    from repro_torch.sim import BatchedEvaluator

    obj = ObjectiveSet.of(*OBJECTIVES)
    svc = WhatIfService(graph, device=dev,
                        admission=AdmissionConfig(p99_budget_s=1e6))
    fids = {svc.register_fleet(t, pack, objectives=obj, speed=speed)
            for t in set(MULTI_TENANTS)}
    check(len(fids) == 1, f"{phase}: equal packs got different ids")
    (fid,) = fids
    n = sum(rows)
    check(n <= svc.max_chunk_rows, f"{phase}: {n} rows are not one chunk")
    cuts = np.cumsum((0,) + rows)
    sl = [slice(int(cuts[i]), int(cuts[i + 1])) for i in range(len(rows))]
    padded = pad_rows(xs[:n], next_pow2(n))           # the rows as dispatched
    ev = BatchedEvaluator.shared(graph, device=dev)
    direct = ev.score_grid(padded, pack, objectives=obj,
                           speed=speed).to_host()
    S = direct.scalarized.shape[0]

    def raw_of(i):
        return ObjectiveGrids(names=obj.names,
                              grids={k: g[:, sl[i]]
                                     for k, g in direct.grids.items()},
                              scalarized=direct.scalarized[:, sl[i]],
                              weights=obj.weights)

    cap = float(np.median(candidate_values(raw_of(1))[
        :, obj.names.index("network_movement_cost")]))
    dqv = np.linspace(0.0, 1.0, 5)
    queries = [
        WhatIfQuery(kind="score", placements=xs[sl[0]], dq=0.3, beta=0.7),
        WhatIfQuery(kind="rank", placements=xs[sl[1]],
                    dq=np.linspace(0.1, 0.8, S), beta=1.3, top_k=5,
                    minimize="latency_f",
                    eps_caps={"network_movement_cost": cap}),
        WhatIfQuery(kind="pareto", placements=xs[sl[2]]),
        WhatIfQuery(kind="joint", placements=xs[sl[3]], dq_values=dqv,
                    beta=0.5),
    ]
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    tickets = [svc.submit(t, fid, q) for t, q in zip(MULTI_TENANTS, queries)]
    completed = svc.drain()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    buckets = svc.stats.snapshot()["buckets"]
    n_disp = sum(b["dispatches"] for b in buckets)
    check(completed == len(queries),
          f"{phase}: {completed} queries completed")
    check(n_disp == 1, f"{phase}: {n_disp} dispatches for one chunk")
    check(launched[kernel] == S * n_disp,
          f"{phase}: {kernel} launched {launched[kernel]} times, want "
          f"{S} per dispatch")
    mail = {t: svc.poll(t) for t in set(MULTI_TENANTS)}
    results = []
    for t, tk in zip(MULTI_TENANTS, tickets):
        (res,) = [m for m in mail[t] if isinstance(m, QueryResult)
                  and m.query_id == tk.query_id]
        results.append(res)

    for i, (q, res) in enumerate(zip(queries, results)):
        raw = raw_of(i)
        lat, rest, w_lat = split_dq_term(raw)
        lat = np.asarray(lat, dtype=np.float32)
        rest = np.asarray(rest, dtype=np.float32)
        what = f"{phase} {q.kind}"
        if q.kind == "joint":
            want, want_idx = joint_dq_scores(lat, dqv, q.beta, rest=rest,
                                             w_lat=w_lat)
            check(np.array_equal(res.scores, want)
                  and np.array_equal(res.dq_idx, want_idx),
                  f"{what}: scores or dq choice differ from the direct grid")
            finished = raw.grids
        else:
            check(np.array_equal(res.scores, finish_scores(
                lat, rest, w_lat, q.dq, q.beta)),
                f"{what}: scores differ from the direct grid's")
            denom = dq_denominator(q.dq, q.beta, S)
            finished = {k: g / denom if k == "latency_f" else g
                        for k, g in raw.grids.items()}
        for k in obj.names:
            check(np.array_equal(res.grids[k], finished[k]),
                  f"{what}: served {k} grid differs from the direct one")
        og = ObjectiveGrids(names=obj.names, grids=finished,
                            scalarized=res.scores, weights=obj.weights)
        if q.kind == "pareto":
            front = pareto_front(og)
            check(np.array_equal(res.front.indices, front.indices)
                  and np.array_equal(res.front.values, front.values),
                  f"{what}: front differs from pareto_front")
        if q.kind == "rank":
            best, masked = epsilon_constraint(og, q.minimize, q.eps_caps)
            check(res.best == best and np.array_equal(res.worst, masked)
                  and np.array_equal(res.top, np.argsort(
                      masked, kind="stable")[:q.top_k])
                  and not res.infeasible,
                  f"{what}: ε-rank differs from epsilon_constraint")
    # the device's own dq/β finish of latency_f equals the host's
    q = queries[0]
    on_card = ev.score_grid(padded, pack, dq=q.dq, beta=q.beta,
                            objectives=obj, speed=speed).to_host()
    check(np.array_equal(results[0].grids["latency_f"],
                         on_card.grids["latency_f"][:, sl[0]]),
          f"{phase}: host and device dq/β finish of latency_f differ")
    # float64 oracle: every objective on eight cells of the score query
    worst_oracle = 0.0
    rng = np.random.default_rng(SEED + 4)
    for k in range(8):
        s, p = k % S, int(rng.integers(0, rows[0]))
        want = obj.scalar_values(graph, oracle_fleet(s),
                                 xs[sl[0]][p].astype(np.float64),
                                 dq=q.dq, beta=q.beta)
        for name, v in want.items():
            got = float(results[0].grids[name][s, p])
            err = abs(got - v)
            check(err <= max(REL * abs(v), 1e-6),
                  f"{phase}: oracle {name} ({s}, {p}) {got} vs {v}")
            worst_oracle = max(worst_oracle, err / max(abs(v), 1e-30))
    cells = S * n
    ms = [b["p50"] * 1e3 for b in buckets]
    mem = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
    print(f"{phase}: {completed} queries ({', '.join(q.kind for q in queries)}"
          f"), {n} rows x {S} scenarios x {len(obj.names)} objectives in "
          f"{n_disp} dispatch; {completed / wall:.2f} queries/s, "
          f"{cells / wall:.0f} cells/s, wall {wall * 1e3:.1f} ms, "
          f"ms/dispatch {', '.join(f'{m:.1f}' for m in ms)}; peak memory "
          f"{mem}; launches {launched}; served grids and scores == direct "
          f"bitwise; front, ε-rank, joint == decision layer; oracle worst "
          f"rel err {worst_oracle:.3e}; ε cap network_movement_cost "
          f"{cap:.6g}, front of {len(results[2].front)}")
    if profile:
        groups = {"K1": ("edge_latency_dense",),
                  "K2": ("edge_latency_structured",),
                  "movement SGEMM": GEMM + ("sgemm", "gemv"),
                  "elementwise": ("elementwise", "vectorized", "unrolled",
                                  "reduce", "cat", "index", "gather",
                                  "scatter"),
                  "copies": ("memcpy", "memset")}
        prof = device_profile(torch, lambda: (
            [svc.submit(t, fid, q) for t, q in zip(MULTI_TENANTS, queries)],
            svc.drain()), groups)
        print(f"{phase} profile (a second, profiled round): {prof}")
    return {"launches": launched, "peak": peak, "oracle_rel": worst_oracle,
            "padded": padded, "ev": ev, "obj": obj}


def example_fleet(np, ExplicitFleet):
    """examples/geo_placement.py's fleet: 3 regions × 4 devices, WAN costs
    between regions, region 0 twice as fast."""
    rng = np.random.default_rng(0)
    n_dev, n_regions = 12, 3
    region = np.repeat(np.arange(n_regions), n_dev // n_regions)
    wan = np.array([[0.02, 1.5, 2.5], [1.5, 0.02, 1.0], [2.5, 1.0, 0.02]])
    com = wan[np.ix_(region, region)] + rng.uniform(0, 0.05, (n_dev, n_dev))
    com = (com + com.T) / 2
    np.fill_diagonal(com, 0.0)
    speed = np.where(region == 0, 2.0, 1.0)
    return ExplicitFleet(com_cost=com, speed=speed, region=region), speed


def expected_launches(cfg, mode: str = "forward") -> dict[str, int]:
    """Launches of each LM kernel in one call of ``cfg``'s model: ``mode``
    "forward" (one lm_score shard call), "prefill" or "decode" (one
    serving step).  K5 once per causal self-attention (the hybrid: per
    shared-block site) in a forward on the "pallas" attention route,
    never in a serving step (a cache routes attention to
    ``_sdpa_chunked``) and never for an encoder or a cross-attention
    (the reference hard-codes the chunked route there); K6 once per
    Mamba2 layer in a forward or a prefill (a decode step runs the
    recurrence); K7 for every RMSNorm with a weight: block and final
    norms, qk-norms, Mamba2's gate norms, the shared block's two norms per
    site, a VLM's cross-block norms, the audio model's three norms a
    decoder layer and — outside a decode step — its encoder's two a layer
    and ``enc_norm``.  ``mode`` "train" is one training step: every
    forward K6 and K7 launch, again for each inside a recomputed block
    (``cfg.remat`` "full" or "dots": every Mamba2 layer's scan, and every
    norm but the final norm, the VLM's cross norms and the encoder's
    ``enc_norm``), one K6 backward per forward scan, one K7 backward per
    forward norm, and no K5 (training takes the reference attention)."""
    if mode == "train":
        fwd = expected_launches(cfg.replace(attention_impl="reference"))
        outside = (cfg.norm_type == "rmsnorm") * (
            2 if cfg.family == "audio" else 1 + (
                -(-cfg.n_layers // cfg.cross_attn_every)
                if cfg.family == "vlm" else 0))
        again = 0 if cfg.remat == "none" else fwd["rmsnorm"] - outside
        scan = fwd.get("ssd_scan", 0)
        return {"flash_attention": 0,
                "ssd_scan": scan * (1 if cfg.remat == "none" else 2),
                "ssd_scan_bwd": scan,
                "rmsnorm": fwd["rmsnorm"] + again,
                "rmsnorm_bwd": fwd["rmsnorm"]}
    L, rms = cfg.n_layers, cfg.norm_type == "rmsnorm"
    flash = cfg.attention_impl == "pallas" and mode == "forward"
    scan = L if mode != "decode" else 0
    if cfg.family == "ssm":
        return {"ssd_scan": scan, "rmsnorm": (2 * L + 1) if rms else L}
    if cfg.family == "hybrid":
        sites = -(-L // cfg.shared_attn_every)
        return {"flash_attention": sites if flash else 0,
                "ssd_scan": scan,
                "rmsnorm": (2 * L + 2 * sites + 1) if rms else L}
    if cfg.family == "audio":
        enc = 0 if mode == "decode" else 2 * cfg.encoder_layers + 1
        return {"flash_attention": L if flash else 0,
                "rmsnorm": (3 * L + 1 + enc) if rms else 0}
    cross = -(-L // cfg.cross_attn_every) if cfg.family == "vlm" else 0
    return {"flash_attention": L if flash else 0,
            "rmsnorm": ((2 * L + cross + 1) if rms else 0)
            + (2 * L if cfg.qk_norm else 0)}


# the LM kernels a forward, a prefill or a decode step can launch (K6's
# and K7's backward run only in training)
LM_FORWARD_KERNELS = ("flash_attention", "ssd_scan", "rmsnorm")


def lm_launches() -> dict[str, int]:
    """The LM kernels' launch counts, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    return {**fa.launches, **sk.launches, **rk.launches}


def reset_lm_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    for mod in (fa, sk, rk):
        mod.reset_launches()


@contextlib.contextmanager
def swapped_ssm_kernels(ssd=None, rms=None, rms_bwd=None, ssd_bwd=None):
    """K6, K7, K7's backward and K6's backward swapped for ``ssd``,
    ``rms``, ``rms_bwd`` and ``ssd_bwd`` (by default their plain versions,
    uncounted) inside the block, restored after it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    saved = sk.ssd_scan, sk.ssd_scan_bwd, rk.rmsnorm, rk.rmsnorm_bwd
    sk.ssd_scan = ssd or ref.ssd_scan_plain
    sk.ssd_scan_bwd = ssd_bwd or ref.ssd_scan_bwd_plain
    rk.rmsnorm = rms or ref.rmsnorm_plain
    rk.rmsnorm_bwd = rms_bwd or ref.rmsnorm_bwd_plain
    try:
        yield
    finally:
        sk.ssd_scan, sk.ssd_scan_bwd, rk.rmsnorm, rk.rmsnorm_bwd = saved


def plain_ssm_kernels():
    """K6, K7 and their backward swapped for their plain versions
    (uncounted) inside the block, restored after it."""
    return swapped_ssm_kernels()


def wrong_ssm_kernels(torch, cfg) -> dict:
    """The planted faults that lm_serve's logits check must catch, for the
    kernels ``cfg`` runs: K7 scaling each row by the RMS of the row before
    it (an off-by-one in a multi-row loop), and K6 dropping its final
    state (decode then starts from zero).  Each is its plain version with
    the fault: name → (ssd, rms) for :func:`swapped_ssm_kernels`."""
    from repro_torch.kernels import ref

    def rows_shifted(x, w, eps=1e-6):
        f = x.float().reshape(-1, x.shape[-1])
        r = torch.rsqrt((f * f).mean(dim=-1, keepdim=True) + eps)
        return (f * r.roll(1, 0) * w.float()).reshape(x.shape).to(x.dtype)

    def state_dropped(x, B, C, dt, A, D, chunk, final_state=False,
                      state_out=None):
        y, S = ref.ssd_scan_plain(x, B, C, dt, A, D, chunk, True)
        S = (S if state_out is None else state_out).zero_()
        return (y, S) if final_state or state_out is not None else y

    out = {}
    if cfg.norm_type == "rmsnorm" or cfg.qk_norm:
        out["K7 rows shifted"] = (None, rows_shifted)
    if cfg.family in ("ssm", "hybrid"):
        out["K6 state dropped"] = (state_dropped, None)
    return out


@contextlib.contextmanager
def plain_route(model, kernels: bool = True):
    """``model``'s attention on the chunked reference route inside the
    block and, with ``kernels``, K6 / K7 swapped for their plain versions
    (uncounted); restored after it."""
    saved = model.cfg
    model.cfg = saved.replace(attention_impl="reference")
    try:
        with plain_ssm_kernels() if kernels else contextlib.nullcontext():
            yield
    finally:
        model.cfg = saved


@contextlib.contextmanager
def depth_cut(model, layers: int):
    """``model`` cut to its first ``layers`` blocks inside the block (its
    cache too; an encoder-decoder's encoder to as many layers), restored
    after it.  A VLM keeps the cross blocks its first groups use."""
    cfg = model.cfg
    if cfg.family == "audio":
        saved = {"encoder": model.encoder, "decoder": model.decoder}
        cut = cfg.replace(n_layers=layers, encoder_layers=layers)
    else:
        saved = {"blocks": model.blocks}
        cut = cfg.replace(n_layers=layers)
    for name, mods in saved.items():
        setattr(model, name, mods[:layers])
    model.cfg = cut
    try:
        yield
    finally:
        for name, mods in saved.items():
            setattr(model, name, mods)
        model.cfg = cfg


def seeded_model(torch, cfg, dev):
    """``cfg``'s model on ``dev`` with random weights from ``SEED``, drawn
    in place on the card; a VLM's gates opened to seeded values in
    ±[0.3, 0.9] (``init_params`` leaves them at 0, where the cross path
    adds nothing)."""
    from repro_torch.models import build_model
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for s, cb in enumerate(getattr(model, "cross", ())):
            u = float(torch.rand((), generator=gen))
            cb.gate.fill_((0.3 + 0.6 * u) * (-1) ** s)
    return model


def model_extras(torch, cfg, batch: int, dev) -> dict:
    """The stub frontends' inputs for ``batch`` rows, as ``serve.main``
    makes them: seeded float32 image (VLM) or frame (audio) embeddings on
    ``dev``; none for a text model."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    if cfg.family == "vlm":
        return {"image_embeds": torch.randn(
            (batch, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device=dev)}
    if cfg.family == "audio":
        return {"audio_frames": torch.randn(
            (batch, cfg.n_audio_frames, cfg.d_model), generator=gen,
            device=dev)}
    return {}


@contextlib.contextmanager
def recorded_drops(drops: list, tokens: int):
    """Inside the block every MoE layer appends to ``drops`` the share of
    its real (token, choice) pairs — the first ``tokens`` tokens, not the
    padding of the last group — that capacity dropped."""
    from repro_torch.models import moe
    saved = moe._route

    def route(p, xg, cfg, C):
        out = saved(p, xg, cfg, C)
        keep = out[4].reshape(-1, cfg.moe_top_k)[:tokens]
        drops.append(float((~keep).float().mean()))
        return out

    moe._route = route
    try:
        yield
    finally:
        moe._route = saved


def coupling_for(np, DQCoupling, n_ops: int, V: int):
    """The search phases' DQ coupling: caps of 4× the uniform placement's
    column mass at dq 0, falling to 1.5× at dq 1, so the dq knob trades
    against capacity and the +inf mask is exercised."""
    u = n_ops / V
    return DQCoupling(cap0=np.full(V, 4.0 * u), load=np.full(V, 2.5 * u))


def plain_latency(torch, eng, xs):
    """Float64 critical-path latencies of the placements ``xs`` through the
    plain dense version on ``eng``'s device (the check of K1 inside
    ``BatchedProblem``)."""
    from repro_torch.core.torchmodel import critical_path_dp, edge_endpoints
    from repro_torch.kernels import ref
    ev = eng._ev
    x = torch.as_tensor(xs, dtype=torch.float32, device=ev.device).double()
    xi, xj = edge_endpoints(x, ev._src, ev._dst, ev._sel.double())
    elat = ref.edge_latency_dense_plain(xi, xj, eng._pack.double())
    links = ev._links(x)
    return critical_path_dp(ev.graph, elat if links is None else elat + links)


def hold_chunk(torch, np, phase: str, eng, xs) -> float:
    """``eng``'s batched latencies of ``xs`` (one K1 dispatch) against
    :func:`plain_latency`, ≤ REL relative; returns the error."""
    got, _ = eng.raw_values(xs)
    want = plain_latency(torch, eng, xs)
    rel, _ = rel_err(torch.as_tensor(got), want.cpu())
    check(got.shape == (len(xs),) and bool(np.isfinite(got).all()),
          f"{phase}: non-finite or mis-shaped chunk latencies")
    check(rel <= REL, f"{phase}: chunk of {len(xs)} rel err {rel:.3e} to "
                      f"the plain version > {REL}")
    return rel


def search_dense_phase(torch, np, dev, graph, per_region: int,
                       n_candidates: int, batch: int, steps: int,
                       block: int, profile: bool = True) -> dict:
    """Batched search on a dense fleet (phase 9): ``random_search`` and
    block ``simulated_annealing`` through ``BatchedProblem`` on K1, with
    the dispatch and launch counts, one chunk of each shape held against
    the plain version, the winner against the oracle, the uniform
    placement and the coupling."""
    from repro_torch.core.optimizers import (DQCoupling, PlacementProblem,
                                             _dq_grid)
    from repro_torch.core.placement import uniform_placement
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.search import (BatchedProblem, anneal_path,
                                    random_placements, random_search,
                                    simulated_annealing)
    from repro_torch.sim.scenarios import ScenarioConfig, random_fleet

    rng = np.random.default_rng(SEED + 9)
    t0 = time.perf_counter()
    fleet = random_fleet(rng, ScenarioConfig(
        n_regions=(8, 8), devices_per_region=(per_region, per_region)))
    V = fleet.n_devices
    prob = PlacementProblem(graph, fleet, beta=1.0,
                            dq=coupling_for(np, DQCoupling, graph.n_ops, V))
    eng = BatchedProblem(prob, device=dev)
    setup_s = time.perf_counter() - t0
    avail = prob.availability()
    uni = uniform_placement(graph.n_ops, avail)
    uni_F = min(prob.score(uni, d) for d in _dq_grid(prob))
    phase = "search_dense"
    # the main path: counts from 0 around each search
    sync(torch, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rs = random_search(prob, rng, n_candidates=n_candidates, batch=batch,
                       engine=eng)
    sync(torch, dev)
    rs_s = time.perf_counter() - t0
    rs_launched = kernels.launches["edge_latency_dense"]
    n_disp = 1 + -(-n_candidates // batch)
    check(rs.dispatches == n_disp and rs_launched == n_disp,
          f"{phase}: random_search made {rs.dispatches} dispatches and "
          f"{rs_launched} K1 launches, want {n_disp} of each")
    kernels.reset_launches()
    t0 = time.perf_counter()
    sa = simulated_annealing(prob, rng, steps=steps, block=block,
                             x0=rs.x, dq0=rs.dq_fraction, engine=eng)
    sync(torch, dev)
    sa_s = time.perf_counter() - t0
    sa_launched = kernels.launches["edge_latency_dense"]
    n_disp = -(-steps // block)
    check(sa.dispatches == n_disp and sa_launched == n_disp,
          f"{phase}: simulated_annealing made {sa.dispatches} dispatches "
          f"and {sa_launched} K1 launches, want {n_disp} of each")
    # every shape the searches gave K1, against the plain version
    chunk = random_placements(avail, np.random.default_rng(SEED + 10),
                              batch, 0.5)
    rel_chunk = hold_chunk(torch, np, phase, eng, chunk)
    path, _ = anneal_path(rs.x, rs.dq_fraction, avail,
                          np.random.default_rng(SEED + 11), block, 1.0)
    rel_path = hold_chunk(torch, np, phase, eng, path)
    del chunk, path
    for name, res in (("random_search", rs), ("simulated_annealing", sa)):
        want = prob.score(res.x, res.dq_fraction)
        check(res.F == want, f"{phase}: {name} F {res.F} is not the oracle's "
                             f"{want}")
        err = abs(res.history[-1] - want) / want
        check(err <= REL, f"{phase}: {name} batched best {res.history[-1]} "
                          f"vs oracle {want}: rel err {err:.3e} > {REL}")
        check(res.F <= uni_F * (1 + REL),
              f"{phase}: {name} F {res.F} above the uniform placement's "
              f"{uni_F}")
        check(prob.feasible(res.x, res.dq_fraction),
              f"{phase}: {name}'s winner violates the coupling")
    prof = "not measured (no card)"
    if profile:
        prof = device_profile(torch, lambda: random_search(
            prob, np.random.default_rng(SEED + 12), n_candidates=batch,
            batch=batch, engine=eng), {
                "K1 hi/lo split": ("split",),
                "K1": ("edge_latency_dense",),
                "copies": ("memcpy", "memset")})
    print(f"{phase}: random_fleet V = {V} (8 regions x {per_region}), "
          f"E = {graph.n_edges}, beta 1, DQCoupling; set-up {setup_s:.2f} s;"
          f" random_search {n_candidates} candidates in batches of {batch}: "
          f"{rs.dispatches} dispatches, {rs_launched} K1 launches, wall "
          f"{rs_s:.2f} s, {rs.evals / rs_s:.0f} placements x dq scored/s, "
          f"F {rs.F:.6g} (dq {rs.dq_fraction}); simulated_annealing "
          f"{steps} steps in blocks of {block} from its winner: "
          f"{sa.dispatches} dispatches, {sa_launched} K1 launches, wall "
          f"{sa_s:.2f} s, {sa.evals / sa_s:.0f} placements scored/s, F "
          f"{sa.F:.6g} (dq {sa.dq_fraction}); uniform F {uni_F:.6g}; "
          f"K1 vs plain (float64): {batch}-row chunk {rel_chunk:.3e}, "
          f"{block}-row anneal path {rel_path:.3e}")
    print(f"{phase} profile (one random_search of {batch} candidates): "
          f"{prof}")
    return {"launches": {"random_search": rs_launched,
                         "simulated_annealing": sa_launched},
            "rs": rs, "sa": sa, "uniform_F": uni_F}


def search_greedy_phase(torch, np, dev, graph, per_region: int) -> dict:
    """``greedy_transfer`` on a small dense fleet (phase 10) with δ = 1/V,
    so every device of the uniform start is a source and a neighbourhood
    is up to V·(V − 1) moves, on the card and on the CPU route."""
    from repro_torch.core.optimizers import DQCoupling, PlacementProblem
    from repro_torch.core.placement import uniform_placement
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.search import (BatchedProblem, greedy_transfer,
                                    transfer_neighborhood)
    from repro_torch.sim.scenarios import ScenarioConfig, random_fleet

    phase = "search_greedy"
    fleet = random_fleet(np.random.default_rng(SEED + 13), ScenarioConfig(
        n_regions=(8, 8), devices_per_region=(per_region, per_region)))
    V = fleet.n_devices
    prob = PlacementProblem(graph, fleet, beta=1.0,
                            dq=coupling_for(np, DQCoupling, graph.n_ops, V))
    uni = uniform_placement(graph.n_ops, prob.availability())
    uni_F = prob.score(uni, 0.0)
    runs = {}
    for where in (dev, torch.device("cpu")):
        eng = BatchedProblem(prob, device=where)
        sync(torch, dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = greedy_transfer(prob, deltas=(1.0 / V,), engine=eng)
        sync(torch, dev)
        runs[where.type] = (res, time.perf_counter() - t0,
                            kernels.launches["edge_latency_dense"],
                            sorted(eng._seen_buckets), eng)
    res, wall, launched, buckets, eng = runs[dev.type]
    cpu_res = runs["cpu"][0]
    check(res.dispatches > 0 and launched == res.dispatches,
          f"{phase}: {res.dispatches} dispatches, {launched} K1 launches")
    err = abs(res.F - cpu_res.F) / cpu_res.F
    check(err <= REL, f"{phase}: F {res.F} vs the CPU route's {cpu_res.F}: "
                      f"rel err {err:.3e} > {REL}")
    check(res.F <= uni_F, f"{phase}: F {res.F} above uniform {uni_F}")
    check(prob.feasible(res.x, res.dq_fraction),
          f"{phase}: the winner violates the coupling")
    # the largest neighbourhood the descent scored, against the plain version
    moves = transfer_neighborhood(uni, prob.availability(), 0, 1.0 / V)
    rel = hold_chunk(torch, np, phase, eng, moves)
    same = np.array_equal(res.x, cpu_res.x) and \
        res.dq_fraction == cpu_res.dq_fraction
    print(f"{phase}: random_fleet V = {V} (8 regions x {per_region}), delta "
          f"1/{V}: {res.dispatches} dispatches (buckets {buckets}), "
          f"{launched} K1 launches, {res.evals} evals, wall {wall:.2f} s "
          f"(CPU route {runs['cpu'][1]:.2f} s); F {res.F:.6g} vs CPU route "
          f"{cpu_res.F:.6g} (rel {err:.3e}), uniform {uni_F:.6g}; moves "
          f"identical to the CPU route: {same}; K1 vs plain (float64) on a "
          f"{len(moves)}-move neighbourhood {rel:.3e}")
    return {"launches": launched, "res": res, "cpu": cpu_res, "same": same}


def robust_structured_phase(torch, np, dev, graph, V: int, S: int,
                            n_candidates: int, profile: bool = True) -> dict:
    """Min–max robust search over a generated structured family (phase
    11): ``region_scenario_batch`` → ``robust_placement`` (the grid
    against the oracle) → ``scenario_robust_search`` with per-scenario dq
    (one dispatch, K2 × S) and with ``co_optimize_dq`` and a coupling."""
    from repro_torch.core import costmodel
    from repro_torch.core.optimizers import DQCoupling
    from repro_torch.core.placement import uniform_placement
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.search import robust_placement, scenario_robust_search
    from repro_torch.sim.scenarios import (ScenarioConfig,
                                           region_scenario_batch)

    phase = "robust_structured"
    rng = np.random.default_rng(SEED + 17)
    t0 = time.perf_counter()
    scens = region_scenario_batch(rng, S, ScenarioConfig(n_regions=(8, 8)),
                                  graph=graph, n_devices=V)
    gen_s = time.perf_counter() - t0
    dq = np.linspace(0.1, 0.7, S)
    kw = dict(n_candidates=n_candidates, beta=1.0, dq=dq, device=dev)
    t0 = time.perf_counter()
    x, worst, grid = robust_placement(graph, scens,
                                      np.random.default_rng(SEED + 19), **kw)
    grid_s = time.perf_counter() - t0
    check(grid.shape == (S, n_candidates) and bool(np.isfinite(grid).all()),
          f"{phase}: non-finite or mis-shaped grid {grid.shape}")
    g64 = grid.astype(np.float64)
    k = int(np.argmin(g64.max(0)))
    check(worst == float(g64.max(0).min()) and worst == float(g64[:, k].max()),
          f"{phase}: worst-case score {worst} is not grid.max(0).min()")

    def oracle(s, xp):
        lat = costmodel.latency(graph, scens[s].fleet, xp)
        return costmodel.objective_F(lat, float(dq[s]), 1.0)

    # the winning column and the uniform placement's (candidate 0) in every
    # scenario, against the float64 oracle
    uni = uniform_placement(graph.n_ops, np.ones((graph.n_ops, V), bool))
    worst_oracle = 0.0
    for p, xp in ((k, x), (0, uni)):
        for s in range(S):
            want = oracle(s, xp)
            err = abs(float(grid[s, p]) - want) / want
            check(err <= REL, f"{phase}: grid cell ({s}, {p}) rel err "
                              f"{err:.3e} to the oracle > {REL}")
            worst_oracle = max(worst_oracle, err)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = scenario_robust_search(graph, scens,
                                 np.random.default_rng(SEED + 19),
                                 warm_start=False, **kw)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launched = kernels.launches["edge_latency_structured"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    check(res.dispatches == 1 and launched == S,
          f"{phase}: {res.dispatches} dispatches, {launched} K2 launches; "
          f"want 1 and {S}")
    check(np.array_equal(res.x, x) and res.history == [worst],
          f"{phase}: scenario_robust_search did not pick robust_placement's "
          f"winner {worst}: {res.history}")
    fs = [oracle(s, res.x) for s in range(S)]
    check(res.F == max(fs), f"{phase}: F {res.F} is not the oracle's "
                            f"worst case {max(fs)}")
    coupling = coupling_for(np, DQCoupling, graph.n_ops, V)
    co_kw = dict(kw, co_optimize_dq=True, dq_coupling=coupling)
    out = {}

    def co_search():
        out["co"] = scenario_robust_search(
            graph, scens, np.random.default_rng(SEED + 19),
            warm_start=False, **co_kw)

    kernels.reset_launches()
    t0 = time.perf_counter()
    if profile:
        prof = device_profile(torch, co_search, {
            "K2": ("edge_latency_structured",), "mass (cuBLAS)": GEMM,
            "copies": ("memcpy", "memset")})
    else:
        co_search()
        prof = "not measured (no card)"
    co_s = time.perf_counter() - t0
    co = out["co"]
    co_launched = kernels.launches["edge_latency_structured"]
    check(co.dispatches == 1 and co_launched == S,
          f"{phase}: co_optimize_dq made {co.dispatches} dispatches and "
          f"{co_launched} K2 launches; want 1 and {S}")
    check(bool(np.isfinite(co.history[0])) and co.F > 0,
          f"{phase}: co_optimize_dq worst case {co.history}")
    check(bool((co.x.sum(axis=0) <= coupling.caps(co.dq_fraction)
                + 1e-7).all()),
          f"{phase}: the co-optimized winner violates the coupling at its "
          f"worst scenario's dq {co.dq_fraction}")
    mem = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
    print(f"{phase}: region_scenario_batch S = {S}, V = {V}, R = "
          f"{scens[0].fleet.n_regions}, E = {graph.n_edges}: generation "
          f"{gen_s:.2f} s; robust_placement {n_candidates} candidates "
          f"(candidate draw + one dispatch) {grid_s:.2f} s, winner column "
          f"and uniform column vs oracle worst rel err {worst_oracle:.3e}; "
          f"scenario_robust_search (dq {np.round(dq, 3).tolist()}, no warm "
          f"start): {res.dispatches} dispatch, {launched} K2 launches, wall "
          f"{wall:.2f} s, {S * n_candidates / wall:.0f} cells/s, peak "
          f"memory {mem}, worst-case F {res.F:.6g}; co_optimize_dq with a "
          f"coupling (profiled): {co.dispatches} dispatch, {co_launched} K2 "
          f"launches, wall {co_s:.2f} s, worst-case F {co.F:.6g} at dq "
          f"{co.dq_fraction}")
    print(f"{phase} profile (the co-optimized search): {prof}")
    return {"launches": launched, "res": res, "co": co, "peak": peak,
            "oracle_rel": worst_oracle}


def streaming_reoptimize_phase(np) -> dict:
    """The example's streaming job without the LM operator (phase 12):
    greedy placement, a straggler re-optimized, a device lost, one batch —
    host only, on the scalar float64 loop of the compute-extension
    problem."""
    from repro_torch.core import CostConfig, DQCoupling, ExplicitFleet, \
        PlacementProblem, greedy_transfer
    from repro_torch.core.placement import uniform_placement
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.streaming import (StreamGraph, StreamingEngine, map_op,
                                       quality_op, source, window_agg)

    phase = "streaming_reoptimize"
    fleet, speed = example_fleet(np, ExplicitFleet)
    ops = [source("ingest"),
           map_op("clean", lambda r: np.clip(r, 0, 99), work=0.5),
           quality_op("dq_check", threshold=0.4, work=2.0),
           window_agg("window_mean", window=8, work=0.5)]
    g = StreamGraph(ops, [(0, 1), (1, 2), (2, 3)])
    n = fleet.n_devices
    prob = PlacementProblem(g.meta, fleet,
                            CostConfig(alpha=0.002, include_compute=True),
                            beta=1.0, dq=DQCoupling(cap0=np.full(n, 1.0),
                                                    load=np.full(n, 0.05)))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = greedy_transfer(prob)
    greedy_s = time.perf_counter() - t0
    uni_F = prob.score(uniform_placement(g.meta.n_ops, prob.availability()),
                       0.0)
    eng = StreamingEngine(g, fleet, res.x, alpha=0.002, device_speed=speed)
    rng = np.random.default_rng(SEED + 21)

    def batch():
        b = rng.integers(0, 100, (256, 32)).astype(float)
        b[rng.random(256) < 0.05] = -1            # sensor dropouts
        return b

    rep0 = eng.run_batch(batch())
    before = eng.x[:, 5].sum()
    t0 = time.perf_counter()
    res2 = eng.degrade_and_replace(5, 10.0, beta=1.0)
    degrade_s = time.perf_counter() - t0
    after = eng.x[:, 5].sum()
    t0 = time.perf_counter()
    res3 = eng.remove_device(11, beta=1.0)
    remove_s = time.perf_counter() - t0
    rep = eng.run_batch(batch())
    check(res.dispatches == res2.dispatches == res3.dispatches == 0
          and not any(kernels.launches.values()),
          f"{phase}: the scalar re-optimization dispatched "
          f"{kernels.launches}")
    check(res.F <= uni_F, f"{phase}: greedy F {res.F} above uniform {uni_F}")
    check(after <= before + 1e-12, f"{phase}: mass on the straggler rose "
                                   f"from {before} to {after}")
    for name, x in (("degrade", res2.x), ("remove", res3.x),
                    ("engine", eng.x)):
        check(bool((x >= 0).all()) and bool(np.allclose(x.sum(axis=1), 1.0,
                                                        atol=1e-9)),
              f"{phase}: {name} placement rows left the simplex")
    check(eng.fleet.n_devices == n - 1 and eng.x.shape == (g.meta.n_ops,
                                                           n - 1),
          f"{phase}: {eng.fleet.n_devices} devices after the loss")
    check(rep.rows_in == 256 and np.isfinite(rep.modeled_latency),
          f"{phase}: batch after the loss {rep.rows_in} rows, modeled "
          f"latency {rep.modeled_latency}")
    print(f"{phase}: greedy F {res.F:.6g} (uniform {uni_F:.6g}, dq "
          f"{res.dq_fraction}) in {greedy_s:.2f} s; device 5 degraded 10x: "
          f"re-optimized F {res2.F:.6g} in {degrade_s:.2f} s, its mass "
          f"{before:.3f} -> {after:.3f}; device 11 lost: F {res3.F:.6g} in "
          f"{remove_s:.2f} s; modeled latency {rep0.modeled_latency:.6g} -> "
          f"{rep.modeled_latency:.6g}, rows_out {rep.rows_out}; 0 "
          f"dispatches, no kernel launched (host only)")
    return {"res": res, "degrade": res2, "remove": res3,
            "mass": (before, after)}


def stream_graph():
    """tests/test_adaptive.py's stream graph: source → normalize →
    threshold (selectivity 0.7)."""
    from repro_torch.streaming.operators import (StreamGraph, filter_op,
                                                 map_op, source)
    ops = [source(),
           map_op("normalize", lambda r: (r - r.mean()) / (r.std() + 1e-9)),
           filter_op("threshold", lambda r: r[:, 0] > -0.5,
                     selectivity=0.7)]
    return StreamGraph(ops, [(0, 1), (1, 2)])


def adaptive_world(np, per_region: int, ticks: int, seed: int):
    """benchmarks/bench_adaptive.py's drifting world at 8 regions ×
    ``per_region`` devices: a fresh engine (uniform placement,
    ``observed="work"``) and its trace of Markov region outages,
    stragglers, losses and selectivity drift."""
    from repro_torch.core.placement import uniform_placement
    from repro_torch.sim.scenarios import (ScenarioConfig, random_trace,
                                           scenario_batch)
    from repro_torch.streaming.engine import StreamingEngine

    rng = np.random.default_rng(seed)
    sg = stream_graph()
    cfg = ScenarioConfig(trace_len=ticks, base_rate=ADAPT_RATE,
                         n_regions=(8, 8),
                         devices_per_region=(per_region, per_region),
                         **ADAPT_DRIFT)
    s = scenario_batch(rng, 1, cfg, graph=sg.meta)[0]
    trace = random_trace(rng, s.n_devices, cfg,
                         n_regions=int(np.asarray(s.fleet.region).max()) + 1,
                         n_ops=sg.meta.n_ops)
    x0 = uniform_placement(sg.meta.n_ops,
                           np.ones((sg.meta.n_ops, s.n_devices), bool))
    return StreamingEngine(sg, s.fleet, x0, observed="work"), trace


@contextlib.contextmanager
def watched_grids(np, log: list, oracle: bool):
    """Every ``BatchedEvaluator.score_grid`` of the block appends its host
    grid to ``log``; its candidate rows must lie on the simplex, and with
    ``oracle`` eight (scenario, candidate) cells — the incumbent, the
    uniform fallback, the min–max winner and five more — are held against
    the float64 oracle on the fleets as packed, ≤ REL relative."""
    from repro_torch.core import costmodel
    from repro_torch.core.devices import ExplicitFleet
    from repro_torch.sim import batched

    inner = batched.BatchedEvaluator.score_grid

    def score_grid(self, placements, coms, *args, **kw):
        out = inner(self, placements, coms, *args, **kw)
        grid = out.cpu().numpy()
        xs = np.asarray(placements)
        check(bool(np.allclose(xs.sum(axis=2), 1.0, atol=1e-5))
              and bool((xs >= 0).all()),
              "a re-optimization candidate left the simplex")
        entry = {"grid": grid, "rel": 0.0}
        if oracle:
            S, P = grid.shape
            cells = [(0, 0), (1 % S, P - 1),
                     (2 % S, int(np.argmin(grid.max(axis=0))))]
            cells += [(k % S, (k * P) // 8) for k in range(3, 8)]
            for s, p in cells:
                want = costmodel.latency(
                    self.graph, ExplicitFleet(
                        com_cost=np.asarray(coms[s], np.float64)),
                    xs[p].astype(np.float64), self.cfg)
                err = abs(float(grid[s, p]) - want) / want
                check(err <= REL, f"re-optimization grid cell ({s}, {p}) "
                                  f"rel err {err:.3e} to the oracle > {REL}")
                entry["rel"] = max(entry["rel"], err)
        log.append(entry)
        return out

    batched.BatchedEvaluator.score_grid = score_grid
    try:
        yield log
    finally:
        batched.BatchedEvaluator.score_grid = inner


@contextlib.contextmanager
def span_walls():
    """A fresh, enabled ``repro_torch.obs`` registry for the block; yields a
    dict filled on exit with the summed wall seconds per span name and the
    registry's counters."""
    from repro_torch import obs
    from repro_torch.obs.registry import MetricsRegistry

    prev = obs.set_registry(MetricsRegistry(enabled=True))
    obs.clear_trace()
    out: dict = {}
    try:
        yield out
    finally:
        reg = obs.set_registry(prev)
        for ev in obs.trace_events():
            if ev.get("ph") == "X":
                out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e6
        out["counters"] = {row["name"]: row["value"]
                           for row in reg.snapshot()
                           if row["type"] == "counter"}
        obs.clear_trace()


def wall_split(walls: dict, wall: float) -> str:
    """engine / events / oracle / refit / re-optimization / other seconds
    of one run from its span walls."""
    parts = {"engine": walls.get("engine.run_batch", 0.0),
             "events": walls.get("adapt.event", 0.0),
             "oracle": walls.get("adapt.oracle", 0.0),
             "refit": walls.get("adapt.refit", 0.0),
             "re-optimization": walls.get("adapt.reoptimize", 0.0)}
    parts["other"] = max(wall - sum(parts.values()), 0.0)
    return ", ".join(f"{k} {v:.2f} s" for k, v in parts.items())


def first_divergence(np, card: list, cpu: list):
    """The first re-optimization whose min–max winner differs between two
    runs' grid logs: (index, card winner, CPU winner, their card scores),
    or None."""
    for k, (a, b) in enumerate(zip(card, cpu)):
        wa, wb = a["grid"].max(axis=0), b["grid"].max(axis=0)
        ia, ib = int(np.argmin(wa)), int(np.argmin(wb))
        if ia != ib:
            return k, ia, ib, float(wa[ia]), float(wa[ib])
    return None


def profiled_reoptimize(torch, np, ctl) -> str:
    """One more re-optimization of ``ctl``, timed on the host clock, with
    its one dispatch under ``torch.profiler``: all of its device work (the
    host draws the fleets and candidates before the dispatch).  The idle
    share is over the whole re-optimization."""
    from repro_torch.sim import batched

    inner = batched.BatchedEvaluator.score_grid
    seen = []

    def score_grid(self, *args, **kw):
        out = []
        seen.append(device_events(
            torch, lambda: out.append(inner(self, *args, **kw))))
        return out[0]

    batched.BatchedEvaluator.score_grid = score_grid
    want = ctl.cfg.robust_scenarios
    try:
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            seen.clear()
            t0 = time.perf_counter()
            ctl._reoptimize(np.random.default_rng(SEED + 25))
            sync(torch, ctl.device)
            wall_ms = (time.perf_counter() - t0) * 1e3
            (dispatch_ms, per_name), = seen
            if sum(c for name, (_, c) in per_name.items()
                   if "edge_latency_dense_k" in name) >= want:
                break
    finally:
        batched.BatchedEvaluator.score_grid = inner
    return (f"(reading {attempt}) " + profile_text(wall_ms, per_name, {
        "K1 hi/lo split": ("split",), "K1": ("edge_latency_dense",),
        "copies": ("memcpy", "memset")})
        + f"; the dispatch itself {dispatch_ms:.1f} ms")


def adaptive_dense_phase(torch, np, dev, per_region: int, ticks: int,
                         profile: bool = True) -> dict:
    """The closed loop on bench_adaptive.py's drifting world at V 4096
    (phase 13): the controller on the card, its K1 launches per dispatch,
    its grids against the float64 oracle, the same world through the CPU
    route (the same decisions), the wall split and one re-optimization
    profiled."""
    from repro_torch.adapt import (AdaptiveConfig, AdaptiveController,
                                   run_adaptive)
    from repro_torch.kernels import edge_latency as kernels

    phase = "adaptive_dense"
    cfg = AdaptiveConfig(**CONTROLLER)
    eng, trace = adaptive_world(np, per_region, ticks, SEED + 23)
    V = eng.fleet.n_devices
    card_log, cpu_log = [], []
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctl = AdaptiveController(eng, cfg, name=phase, device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with span_walls() as walls, watched_grids(np, card_log, oracle=True):
        rep = ctl.run(trace, np.random.default_rng(SEED + 24))
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launched = kernels.launches["edge_latency_dense"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    n_ticks = rep.n_ticks
    S = cfg.robust_scenarios
    check(rep.controller_dispatches == len(card_log) > 0,
          f"{phase}: {rep.controller_dispatches} dispatches, "
          f"{len(card_log)} grids")
    check(launched == S * rep.controller_dispatches,
          f"{phase}: {launched} K1 launches for {rep.controller_dispatches} "
          f"dispatches; want {S} each")
    check(bool(np.isfinite(rep.f_adaptive).all())
          and bool(np.isfinite(rep.f_static).all()),
          f"{phase}: non-finite F series")
    check(bool((eng.x >= 0).all())
          and bool(np.allclose(eng.x.sum(axis=1), 1.0, atol=1e-9)),
          f"{phase}: the final placement left the simplex")
    B = int(np.mean([g["grid"].shape[1] for g in card_log]))
    # the same world, seed and trace through the CPU route
    eng_cpu, trace_cpu = adaptive_world(np, per_region, ticks, SEED + 23)
    t0 = time.perf_counter()
    with watched_grids(np, cpu_log, oracle=False):
        rep_cpu = run_adaptive(eng_cpu, trace_cpu,
                               np.random.default_rng(SEED + 24), cfg,
                               name=phase, device="cpu")
    cpu_wall = time.perf_counter() - t0
    div = first_divergence(np, card_log, cpu_log)
    if div is None:
        check(rep.reconfig_ticks == rep_cpu.reconfig_ticks
              and rep.refit_ticks == rep_cpu.refit_ticks
              and np.array_equal(eng.x, eng_cpu.x),
              f"{phase}: the card and the CPU route decided differently "
              f"(reconfigs {rep.reconfig_ticks} vs {rep_cpu.reconfig_ticks}"
              f", refits {rep.refit_ticks} vs {rep_cpu.refit_ticks})")
        same = "identical to the CPU route (reconfig and refit ticks, final x)"
    else:
        k, ia, ib, sa, sb = div
        gap = abs(sa - sb) / sa
        check(gap <= REL, f"{phase}: re-optimization {k} picked candidate "
                          f"{ia} on the card and {ib} on the CPU route, "
                          f"scores {sa!r} / {sb!r} (gap {gap:.3e} > {REL})")
        same = (f"a near tie at re-optimization {k}: candidates {ia} / {ib} "
                f"score {sa!r} / {sb!r} (gap {gap:.3e}); nothing compared "
                f"after it")
    prof = "not measured (no card)"
    if profile:
        prof = profiled_reoptimize(torch, np, ctl)
    mem = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
    worst = max(g["rel"] for g in card_log)
    cut = "" if ticks >= ADAPT_SMOKE_TICKS else \
        f" (trace_len cut from {ADAPT_SMOKE_TICKS})"
    print(f"{phase}: drifting world of 8 regions x {per_region} (V {V}), "
          f"{ticks} ticks{cut} at {ADAPT_RATE:.0f} rows/tick, {len(trace)} "
          f"events"
          f"; wall {wall:.2f} s, {n_ticks / wall:.2f} ticks/s ("
          f"{wall_split(walls, wall)}); {rep.controller_dispatches} "
          f"dispatches (B ~{B}, E 2, V {V}), {launched} K1 launches, "
          f"{rep.n_refits} refits at {rep.refit_ticks}, {rep.n_reconfigs} "
          f"reconfigurations at {rep.reconfig_ticks}; cumulative F: adaptive "
          f"with charges {rep.cum_adaptive:.6g}, static {rep.cum_static:.6g},"
          f" oracle {rep.cum_oracle:.6g}; grid cells vs oracle worst rel err "
          f"{worst:.3e}; peak memory {mem}; CPU route wall {cpu_wall:.2f} s,"
          f" decisions {same}")
    print(f"{phase} profile (one re-optimization): {prof}")
    return {"rep": rep, "cpu": rep_cpu, "launches": launched,
            "dispatches": rep.controller_dispatches, "peak": peak,
            "x": eng.x, "per_region": per_region, "ticks": ticks}


def slow_tier(np, fleet):
    from repro_torch.belief import speed_percentile
    pct = speed_percentile(np.asarray(fleet.effective_speed()))
    return np.flatnonzero(pct < 1.0 / 3.0)


def belief_cold_start_phase(torch, np, dev, per_region: int, ticks: int,
                            legacy: dict) -> dict:
    """bench_belief.py's cold start at V 4096 (phase 14): the prior fit on
    the card (against the CPU fit), the cold-start belief controller on a
    slow-tier trace, the passive belief against phase 13's legacy run
    bitwise, and belief-robust search on the controller's posterior."""
    from repro_torch.adapt import (AdaptiveConfig, AdaptiveController,
                                   run_adaptive)
    from repro_torch.belief import apply_degrade, device_features, fit_prior
    from repro_torch.core.calibration import ReplayWindow
    from repro_torch.core.devices import ExplicitFleet
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.search import belief_robust_search
    from repro_torch.sim import merge_tuples, replay_trace, training_tuples
    from repro_torch.sim.scenarios import TraceEvent
    from repro_torch.streaming.engine import StreamingEngine

    phase = "belief_cold_start"

    def rate_ticks(n):
        return [TraceEvent(t=k, kind="rate", rate=ADAPT_RATE)
                for k in range(n)]

    # -- the prior: replay windows of three disjoint training fleets --------
    t0 = time.perf_counter()
    parts = []
    for seed in BELIEF_TRAIN_SEEDS:
        eng, _ = adaptive_world(np, per_region, 1, seed)
        base = ExplicitFleet(
            com_cost=np.asarray(eng.fleet.com_matrix(), np.float64).copy(),
            speed=np.asarray(eng.fleet.effective_speed(), np.float64).copy(),
            region=np.asarray(eng.fleet.region).copy())
        d = np.ones(base.n_devices)
        d[slow_tier(np, base)] = BELIEF_FACTOR
        world = StreamingEngine(eng.graph, apply_degrade(base, d), eng.x,
                                observed="work")
        rep = replay_trace(world, rate_ticks(BELIEF_TRAIN_TICKS),
                           np.random.default_rng(seed))
        parts.append(training_tuples(eng.graph.meta, base,
                                     ReplayWindow.from_report(rep, world.x)))
    corpus = merge_tuples(parts)
    train_v = base.n_devices
    harvest_s = time.perf_counter() - t0
    kw = dict(device_features=corpus.device_features,
              device_log_degrade=corpus.device_log_degrade,
              device_weights=corpus.device_weights)
    sync(torch, dev)
    t0 = time.perf_counter()
    prior = fit_prior(**kw, device=dev)
    fit_ms = (time.perf_counter() - t0) * 1e3
    prior_cpu = fit_prior(**kw, device="cpu")
    coef_rel = float(np.abs(prior.w_device - prior_cpu.w_device).max()
                     / np.abs(prior_cpu.w_device).max())
    check(coef_rel <= REL, f"{phase}: the card's prior coefficients rel err "
                           f"{coef_rel:.3e} to the CPU fit > {REL}")
    bitwise = np.array_equal(prior.w_device, prior_cpu.w_device)
    # -- the cold start: the slow tier degraded from tick 0 -----------------
    eng, _ = adaptive_world(np, per_region, 1, SEED + 30)
    slow = slow_tier(np, eng.fleet)
    pred_slow = float(np.median(
        prior.predict_degrade(device_features(eng.fleet))[slow]))
    trace = [TraceEvent(t=0, kind="degrade", rate=0.0, device=int(u),
                        factor=BELIEF_FACTOR) for u in slow] \
        + rate_ticks(ticks)
    cfg = AdaptiveConfig(**BELIEF_BLIND, use_belief=True,
                         belief_sampling=True, probe_epsilon=0.1)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctl = AdaptiveController(eng, cfg, name=phase, prior=prior, device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with span_walls() as walls:
        rep = ctl.run(trace, np.random.default_rng(SEED + 31))
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launched = kernels.launches["edge_latency_dense"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    S = cfg.robust_scenarios
    check(rep.controller_dispatches > 0
          and launched == S * rep.controller_dispatches,
          f"{phase}: {launched} K1 launches for {rep.controller_dispatches} "
          f"dispatches; want {S} each")
    check(bool(np.isfinite(rep.f_adaptive).all()),
          f"{phase}: non-finite F series")
    probes = int(walls["counters"].get("belief.probes", 0))
    # -- the passive belief on phase 13's world: bitwise its legacy run -----
    eng13, trace13 = adaptive_world(np, legacy["per_region"],
                                    legacy["ticks"], SEED + 23)
    t0 = time.perf_counter()
    passive = run_adaptive(eng13, trace13, np.random.default_rng(SEED + 24),
                           AdaptiveConfig(**CONTROLLER, use_belief=True),
                           name="adaptive_dense", device=dev)
    passive_s = time.perf_counter() - t0
    a = legacy["rep"]
    check(a.reconfig_ticks == passive.reconfig_ticks
          and a.refit_ticks == passive.refit_ticks
          and a.controller_dispatches == passive.controller_dispatches
          and a.final_com_scale == passive.final_com_scale
          and np.array_equal(a.f_adaptive, passive.f_adaptive)
          and np.array_equal(a.f_static, passive.f_static)
          and np.array_equal(a.f_oracle, passive.f_oracle)
          and np.array_equal(a.reconfig_costs, passive.reconfig_costs)
          and np.array_equal(a.drift, passive.drift, equal_nan=True)
          and np.array_equal(legacy["x"], eng13.x),
          f"{phase}: use_belief=True with every knob passive is not bitwise "
          f"the legacy run of adaptive_dense")
    # -- belief-robust search on the controller's posterior ------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = belief_robust_search(ctl.graph, ctl.belief, ctl.believed,
                               np.random.default_rng(SEED + 32),
                               n_scenarios=BELIEF_SCENARIOS,
                               n_candidates=BELIEF_CANDIDATES,
                               warm_start=False, device=dev)
    sync(torch, dev)
    search_s = time.perf_counter() - t0
    search_launched = kernels.launches["edge_latency_dense"]
    check(res.dispatches == 1 and search_launched == BELIEF_SCENARIOS,
          f"{phase}: belief_robust_search made {res.dispatches} dispatches "
          f"and {search_launched} K1 launches; want 1 and "
          f"{BELIEF_SCENARIOS}")
    win_rel = abs(res.history[0] - res.F) / res.F
    check(win_rel <= REL, f"{phase}: the winner's worst case {res.history[0]}"
                          f" vs the oracle's {res.F}: rel err {win_rel:.3e}")
    mem = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
    print(f"{phase}: prior from {len(BELIEF_TRAIN_SEEDS)} training fleets of "
          f"V {train_v} ({corpus.n_device_rows} device rows, "
          f"harvest {harvest_s:.2f} s), fit on the card {fit_ms:.1f} ms, "
          f"coefficients vs the CPU fit rel err {coef_rel:.3e} (bitwise "
          f"{bitwise}), predicted "
          f"slow-tier degrade {pred_slow:.3f} (planted {BELIEF_FACTOR}); "
          f"cold start ({len(slow)} slow devices degraded at tick 0, {ticks} "
          f"ticks): wall {wall:.2f} s ({wall_split(walls, wall)}), "
          f"{rep.controller_dispatches} dispatches, {launched} K1 launches, "
          f"{probes} probes adopted, {rep.n_refits} refits, "
          f"{rep.n_reconfigs} reconfigurations; cumulative F: adaptive with "
          f"charges {rep.cum_adaptive:.6g}, static {rep.cum_static:.6g}, "
          f"oracle {rep.cum_oracle:.6g}; peak memory {mem}; passive belief "
          f"on adaptive_dense's world bitwise its legacy run "
          f"({passive_s:.2f} s); belief_robust_search ({BELIEF_SCENARIOS} "
          f"posterior scenarios, {BELIEF_CANDIDATES} candidates): "
          f"{res.dispatches} dispatch, {search_launched} K1 launches, "
          f"{search_s:.2f} s, worst-case F {res.F:.6g} (grid vs oracle "
          f"{win_rel:.3e})")
    return {"rep": rep, "launches": launched, "probes": probes,
            "prior": prior, "prior_cpu": prior_cpu, "search": res,
            "passive": passive, "peak": peak}


@contextlib.contextmanager
def recorded_lm_inputs(seen: dict, stage: dict | None = None):
    """Inside the block K5, K6 and K7 still launch, and ``seen`` keeps the
    first operands each is handed for every shape and dtype, keyed
    ``(kernel, shape, dtype)``, as ``(part of the run, operands,
    keywords)`` with the part read from ``stage["now"]``.  K7's x is
    copied; K5's and K6's operands are kept as they are (nothing writes
    them after the call)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    saved = fa.flash_attention, sk.ssd_scan, rk.rmsnorm
    stage = stage or {"now": ""}

    def keep(name, t, operands, kw=None):
        key = (name, tuple(t.shape), t.dtype)
        if key not in seen:
            seen[key] = (stage["now"], operands(), kw or {})

    def attn(q, k, v, causal=True):
        keep("flash_attention", q, lambda: (q, k, v), {"causal": causal})
        return saved[0](q, k, v, causal=causal)

    def ssd(*args, **kw):
        keep("ssd_scan", args[0], lambda: args[:7])
        return saved[1](*args, **kw)

    def rms(x, w, eps=1e-6):
        keep("rmsnorm", x, lambda: (x.clone(), w.clone(), eps))
        return saved[2](x, w, eps)

    fa.flash_attention, sk.ssd_scan, rk.rmsnorm = attn, ssd, rms
    try:
        yield
    finally:
        fa.flash_attention, sk.ssd_scan, rk.rmsnorm = saved


def hold_path_kernels(torch, dev, phase: str, run, stage: dict | None = None,
                      timed: bool = True) -> dict:
    """K5, K6 and K7 on the operands one ``run()`` of a path hands them
    (:func:`recorded_lm_inputs`), held by :func:`hold_recorded`."""
    seen = {}
    with recorded_lm_inputs(seen, stage):
        run()
    return hold_recorded(torch, dev, phase, seen, timed)


def hold_recorded(torch, dev, phase: str, seen: dict,
                  timed: bool = True) -> dict:
    """K5, K6 and K7 on recorded operands (:func:`recorded_lm_inputs`),
    one per shape and dtype, against their plain versions: float32
    against the float64 plain version at ``REL`` (K6: or the plain
    version's own float32 error), bfloat16 against the plain version in
    float32 math at ``BF16_REL``.  K6 is held on y and its final state,
    and its repeat writes the state into a NaN-filled buffer as a cache
    hands it; every kernel is bitwise on repeat.  With ``timed``, each
    kernel's, its plain version's and its bound's ms at that shape, and
    the library call's (timed as a yardstick only): for K5
    ``scaled_dot_product_attention``, for K7 ``F.rms_norm`` (float32 w,
    or bf16 w where it refuses float32).  Returns, per key, the part of
    the run it came from and the numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.perf import roofline
    out = {}
    for key, (st, args, kw) in seen.items():
        name, shape, dtype = key
        what = " ".join(filter(None, (phase, st, name, str(shape),
                                      str(dtype)[6:])))
        f32 = dtype == torch.float32
        wide = tuple(a.double() if f32 and torch.is_tensor(a) else a
                     for a in args)
        library = None
        if name == "flash_attention":
            kernel = lambda: fa.flash_attention(*args, **kw)  # noqa: E731
            plain = lambda: ref.flash_attention_plain(*args, **kw)  # noqa
            got, again = kernel(), kernel()
            want = ref.flash_attention_plain(*wide, **kw)
            terms = roofline.flash_attention_terms(*shape, dtype,
                                                   kw["causal"])
            bar = REL if f32 else BF16_REL
            # SDPA takes (B, H, S, D) with kv at q's heads: laid out for
            # it up front
            qt, kt, vt = (t.transpose(1, 2) for t in args[:3])
            rep = qt.shape[1] // kt.shape[1]
            qt, kt, vt = (t.repeat_interleave(r, dim=1).contiguous()
                          for t, r in ((qt, 1), (kt, rep), (vt, rep)))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=kw["causal"])
        elif name == "rmsnorm":
            kernel = lambda: rk.rmsnorm(*args)  # noqa: E731
            plain = lambda: ref.rmsnorm_plain(*args)  # noqa: E731
            got, again = kernel(), kernel()
            want = ref.rmsnorm_plain(*wide)
            D = shape[-1]
            terms = roofline.rmsnorm_terms(args[0].numel() // D, D, dtype)
            bar = REL if f32 else BF16_REL
            x, w, eps = args
            try:
                F.rms_norm(x, (D,), weight=w, eps=eps)
                wl = w
            except RuntimeError:
                wl = w.to(x.dtype)
            library = lambda: F.rms_norm(x, (D,), weight=wl,  # noqa: E731
                                         eps=eps)
        else:
            kernel = lambda: sk.ssd_scan(*args)  # noqa: E731
            plain = lambda: ref.ssd_scan_plain(*args)  # noqa: E731
            b_, L_, H, P = shape
            N = args[1].shape[-1]
            got = sk.ssd_scan(*args, final_state=True)
            again = sk.ssd_scan(*args, state_out=torch.full(
                (b_, H, N, P), float("nan"), device=dev))
            want = ref.ssd_scan_plain(*wide, final_state=True)
            terms = roofline.ssd_scan_terms(b_, L_, H, P, N, args[6], dtype)
            bar = BF16_REL
            if f32:
                own = ref.ssd_scan_plain(*args, final_state=True)
                bar = max(REL, *(rel_err(o, w)[0] for o, w in zip(own,
                                                                  want)))
                del own
        sync(torch, dev)
        got, again, want = (t if isinstance(t, tuple) else (t,)
                            for t in (got, again, want))
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        rel, err = max(e[0] for e in errs), max(e[1] for e in errs)
        del want
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{what}: non-finite")
        check(rel <= bar, f"{what}: rel err {rel:.3e} > {bar:.3e}")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{what}: repeat differs")
        del got, again
        r = {"stage": st, "rel_err": rel, "max_abs_err": err, "bar": bar,
             "bound_ms": terms.step_time_s * 1e3, "bound_by": terms.bound_by,
             "library_ms": None}
        if timed:
            r["ms"] = time_ms(kernel, 5)
            r["plain_ms"] = time_ms(plain, 3)
            if library is not None:
                r["library_ms"] = time_ms(library, 5)
        out[key] = r
        lib = ("" if r["library_ms"] is None else
               f", {'sdpa' if name == 'flash_attention' else 'F.rms_norm'} "
               f"{r['library_ms']:.4f} ms")
        print(f"{what}: rel err {rel:.3e} (bar {bar:.0e}), bitwise on repeat"
              + (f"; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, "
                 f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                 if timed else ""))
    return out


def lm_score_phase(torch, np, dev, cfg, rows: int, seq: int, batches: int,
                   profile: bool = True, hold: bool = False) -> dict:
    """The example's streaming job with ``cfg`` as the LM-scoring operator
    (see the module docstring, phases 6, 8, 8b and 8c).  With ``hold``,
    the LM kernels are also held against their plain versions on the
    operands one shard hands them (:func:`hold_recorded`, after the model
    is freed: K5's plain version of an Arctic shard takes 30 GB).
    Returns the launches of the family's main kernel (K5, or K6 for
    Mamba2 and the hybrid) and of every LM kernel on the main path, the
    share of (token, choice) pairs capacity dropped in each MoE layer of
    one shard, and the phase's numbers."""
    from repro_torch.core.devices import ExplicitFleet
    from repro_torch.core.placement import uniform_placement
    from repro_torch.streaming import (StreamGraph, StreamingEngine, map_op,
                                       model_op, quality_op, quality_scores,
                                       source, window_agg)

    ssm = cfg.family in ("ssm", "hybrid")
    phase = {"ssm": "lm_score_mamba2", "hybrid": "lm_score_zamba2",
             "moe": "lm_score_moe"}.get(cfg.family, "lm_score")
    main_kernel = "ssd_scan" if ssm else "flash_attention"
    want_per_call = expected_launches(cfg)
    fleet, speed = example_fleet(np, ExplicitFleet)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = seeded_model(torch, cfg, dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    lm = model_op("lm_score", model, work=50.0)
    score_fn = lm.fn
    shards = []          # (rows, scores, LM kernel launches) per shard call

    def counted(shard_rows):
        before = lm_launches()
        out = score_fn(shard_rows)
        after = lm_launches()
        shards.append((shard_rows, out,
                       {k: after[k] - before[k] for k in want_per_call}))
        return out

    lm.fn = counted
    vocab = cfg.vocab
    ops = [source("ingest"),
           map_op("clean", lambda r: np.clip(r, 0, vocab - 1), work=0.5),
           quality_op("dq_check", threshold=0.4, work=2.0),
           lm,
           window_agg("window_mean", window=8, work=0.5)]
    g = StreamGraph(ops, [(0, 1), (1, 2), (2, 3), (3, 4)])
    x = uniform_placement(g.meta.n_ops, fleet.availability(g.meta.n_ops))
    eng = StreamingEngine(g, fleet, x, alpha=0.002, device_speed=speed)
    rng = np.random.default_rng(SEED)
    data = []
    for _ in range(batches + profile):
        batch = rng.integers(0, vocab, (rows, seq)).astype(float)
        batch[rng.random(rows) < LM_DROPOUT] = -1     # sensor dropouts
        data.append(batch)

    sync(torch, dev)
    reset_lm_launches()
    reports, walls, peaks = [], [], []
    for batch in data[:batches]:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        reports.append(eng.run_batch(batch))
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else None)
    launched = {k: lm_launches()[k] for k in want_per_call}
    from repro_torch.kernels import ssd_scan as sk
    k6_routes = {k: v for k, v in sk.route_launches.items() if v}

    calls = len(shards)
    check(calls > 0, f"{phase}: the scoring operator never ran")
    for k, n in want_per_call.items():
        got = sorted({c[k] for _, _, c in shards})
        check(got == [n], f"{phase}: {k} launches per shard call {got}, "
                          f"want {n}")
        check(launched[k] == n * calls,
              f"{phase}: {launched[k]} {k} launches for {calls} shard calls")
    check(launched[main_kernel] > 0, f"{phase}: {main_kernel} never launched")
    for _, out, _ in shards:
        check(out.dtype == np.float32 and out.ndim == 2 and out.shape[1] == 1
              and bool(np.isfinite(out).all()),
              f"{phase}: scores not finite float32 (n, 1)")
    lm_ix = [op.name for op in g.ops].index("lm_score")
    for batch, rep in zip(data, reports):
        clean = np.clip(batch, 0, vocab - 1)
        n_scored = int((quality_scores(clean.astype(np.int64)) >= 0.4).sum())
        want_out = sum(len(r) // 8 for r in eng._split_rows(
            np.arange(n_scored), eng.x[lm_ix + 1]).values())
        check(int(rep.op_rows_in[lm_ix]) == n_scored
              and rep.rows_out == {"window_mean": want_out},
              f"{phase}: rows {rep.op_rows_in.tolist()} -> {rep.rows_out}, "
              f"want {n_scored} scored -> {want_out}")

    # one shard against the same forward through the plain route: the
    # chunked reference attention (on K5's route) and, but for the dense
    # decoder, K6/K7's plain versions — the same model with its config
    # swapped, since an Arctic cut holds 55 GB of weights
    shard_rows, got, _ = shards[0]
    flash = cfg.attention_impl == "pallas"
    plain_norms = cfg.family != "dense"
    what = " and ".join(
        (["flash vs reference attention"] if flash else [])
        + (["K6/K7 vs their plain versions"] if ssm else [])
        + (["K7 vs its plain version"] if plain_norms and not ssm else []))
    with plain_route(model, kernels=plain_norms):
        want = model_op("reference", model).fn(shard_rows)
    ref_rel = float(np.abs(got.astype(np.float64) - want).max()
                    / np.abs(want.astype(np.float64)).max())
    check(ref_rel <= LM_REF_REL,
          f"{phase}: {what} rel err {ref_rel:.3e} > {LM_REF_REL}")
    seen, drops = {}, []
    if hold:
        with recorded_lm_inputs(seen):
            score_fn(shard_rows)
    if cfg.moe_experts:
        with recorded_drops(drops, len(shard_rows) * seq):
            score_fn(shard_rows)
        check(len(drops) == cfg.n_layers,
              f"{phase}: {len(drops)} MoE layers routed, want "
              f"{cfg.n_layers}")

    tokens = [int(r.op_rows_in[lm_ix]) * seq for r in reports]
    for i, (rep, wall, peak, tok) in enumerate(zip(reports, walls, peaks,
                                                   tokens)):
        mem = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
        print(f"{phase} batch {i}: {rep.rows_in} rows x {seq} tokens -> "
              f"{rep.rows_out}; lm_score {tok} tokens; wall {wall:.3f} s, "
              f"{tok / wall:.0f} tokens/s; peak memory {mem}; modeled "
              f"latency {rep.modeled_latency:.4f}")
    width = ", ".join(
        ([f"{cfg.n_heads} heads of {cfg.hd}"] if cfg.family != "ssm" else [])
        + ([f"{cfg.moe_experts} experts top-{cfg.moe_top_k} of d_ff "
            f"{cfg.d_ff}" + (" and a dense residual MLP"
                             if cfg.moe_dense_residual else "")]
           if cfg.moe_experts else [])
        + ([f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of "
            f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}"] if ssm else [])
        + ([f"one shared attention block at "
            f"{-(-cfg.n_layers // max(cfg.shared_attn_every, 1))} sites "
            f"(every {cfg.shared_attn_every} layers)"]
           if cfg.family == "hybrid" else []))
    print(f"{phase}: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{width}, vocab {cfg.vocab_padded}) weights made in {init_s:.1f} "
          f"s; {calls} shard calls, launches {launched} ({want_per_call} "
          f"per call); {what} on a shard of {len(shard_rows)} rows: rel "
          f"err {ref_rel:.3e} (bar {LM_REF_REL})"
          + (f"; K6 routes and passes {k6_routes}" if ssm else ""))
    if cfg.moe_experts:
        from repro_torch.models.moe import capacity
        grp, n_grp, cap = capacity(cfg, len(shard_rows) * seq)
        print(f"{phase}: one shard of {len(shard_rows)} x {seq} tokens in "
              f"{n_grp} groups of {grp} (the last padded), capacity C {cap} a "
              f"group and expert; (token, choice) pairs dropped by capacity"
              f" per layer " + ", ".join(f"{d:.4%}" for d in drops))
    if profile:
        groups = {"K6": ("ssd_scan",), "K7": ("rmsnorm",),
                  "K5": ("flash_attention",),
                  "f32 GEMM (dt projection, head)": F32_GEMM,
                  "bf16 GEMM": GEMM,
                  "conv/elementwise": ("elementwise", "vectorized",
                                       "unrolled", "cat", "reduce"),
                  "copies": ("memcpy", "memset")}
        if cfg.moe_experts:
            groups = {"K5": ("flash_attention",), "K7": ("rmsnorm",),
                      "f32 GEMM (the head, the router, the combine)":
                          F32_GEMM,
                      "bf16 GEMM (experts, projections)": GEMM,
                      "routing and gathers": ("sort", "scan", "scatter",
                                              "gather", "index"),
                      "elementwise": ("elementwise", "vectorized",
                                      "unrolled", "cat", "reduce"),
                      "copies": ("memcpy", "memset")}
        op_ms = {}
        prof = device_profile(torch, lambda: eng.run_batch(data[-1]), groups,
                              op_ms)
        if cfg.moe_experts:
            prof += (f"; by op: aten::bmm (the experts' three GEMMs and "
                     f"the combine) {op_ms.get('aten::bmm', 0.0):.1f} ms, "
                     f"aten::mm (projections, head, router) "
                     f"{op_ms.get('aten::mm', 0.0):.1f} ms")
        print(f"{phase} profile (a third, profiled batch): {prof}")
    shard_max = max(len(r) for r, _, _ in shards)
    # free the model before the holds: K5's plain version of one shard
    # materialises its float32 scores
    del model, lm, score_fn, counted, ops, g, eng, shards
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    held = hold_recorded(torch, dev, phase, seen,
                         timed=dev.type == "cuda") if hold else {}
    return {"launches": launched[main_kernel], "kernel_launches": launched,
            "calls": calls, "walls": walls, "tokens": tokens,
            "ref_rel": ref_rel, "held": held, "drops": drops,
            "shard_rows": shard_max}



# -- the tenth slice: K5's repaired limits, K6's final state, projected
# gradient, the LM token server ----------------------------------------------

def attention_limits_phase(torch, dev) -> dict:
    """K5 at the two shapes the wrapper refused before (ROADMAP C4): head
    dim 8 (the granite / deepseek smoke configs' d 64 over 8 heads), float32
    and bfloat16, causal and full, at ragged S; and B·H = 65 536 (B·H on the
    grid's x dimension) with a short S.  Each against its plain version with
    phase 5's bars, bitwise on repeat."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    worst = {}
    shapes = [(2, S_, 8, 8) for S_ in (37, 300)] + [ATTN_WIDE]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in ((True, False) if shape[-1] == 8 else (True,)):
                q, k, v = (torch.randn(shape, generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(3))
                out = fa.flash_attention(q, k, v, causal=causal)
                again = fa.flash_attention(q, k, v, causal=causal)
                if dtype == torch.float32:
                    want, bar = ref.flash_attention_plain(
                        q.double(), k.double(), v.double(), causal), REL
                else:
                    want, bar = ref.flash_attention_plain(q, k, v, causal), \
                        BF16_REL
                sync(torch, dev)
                rel, _ = rel_err(out, want)
                what = f"flash_attention {shape} {dtype} causal={causal}"
                check(bool(torch.isfinite(out).all()), f"{what}: non-finite")
                check(rel <= bar, f"{what}: rel err {rel:.3e} > {bar}")
                check(torch.equal(out, again), f"{what}: repeat differs")
                key = (f"D {shape[-1]}, B·H {shape[0] * shape[2]}, "
                       f"{str(dtype).replace('torch.', '')}")
                worst[key] = max(worst.get(key, 0.0), rel)
                del q, k, v, out, again, want
    torch.cuda.empty_cache()
    print("flash_attention limits (ROADMAP C4): " + "; ".join(
        f"{k} rel err {v:.3e}" for k, v in worst.items())
          + f" (bars {REL} / {BF16_REL}); bitwise on repeat")
    return worst


def ssd_final_state_phase(torch, dev, shapes) -> dict:
    """K6 with its final state at the case shapes and at ``shapes`` (the
    lm_score shard's and the lm_serve prefill's): the state against the
    plain version's (float32 against float64 at ≤1e-5, or the plain
    float32 version's own error where larger, as phase 7's y; bfloat16 at
    ≤1e-2 against the plain version in float32 math), bitwise on repeat,
    and y bitwise the y of the call without the state; written into a
    given buffer (``state_out``, filled with NaN first), bitwise the
    same."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk

    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    worst, widened = {}, 0
    # (case, slow decay, read as views of one conv output as the model does)
    cases = [(c, False, False) for c in SSD_CASES] \
        + [(c, True, False) for c in SSD_SLOW_CASES] \
        + [((*s, SSM_CHUNK), False, True) for s in shapes]
    for (b, L, H, P, N, Q), slow, model_like in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_operands(torch, gen, dev, b, L, H, P, N, dtype,
                                model_like=model_like, slow=slow)
            y, st = sk.ssd_scan(*args, Q, final_state=True)
            y2, st2 = sk.ssd_scan(*args, Q, final_state=True)
            y0 = sk.ssd_scan(*args, Q)
            # into a given buffer, as the model's prefill writes its cache
            buf = torch.full((b, H, N, P), float("nan"), device=dev)
            y3, st3 = sk.ssd_scan(*args, Q, state_out=buf)
            what = f"ssd_scan final state (b={b} L={L} H={H} Q={Q}) {dtype}"
            if dtype == torch.float32:
                _, want = ref.ssd_scan_plain(*(a.double() for a in args), Q,
                                             final_state=True)
                _, own = ref.ssd_scan_plain(*args, Q, final_state=True)
                bar = max(REL, rel_err(own, want)[0])
                widened += bar > REL
            else:
                _, want = ref.ssd_scan_plain(*args, Q, final_state=True)
                bar = BF16_REL
            sync(torch, dev)
            rel, _ = rel_err(st, want)
            check(st.shape == (b, H, N, P) and st.dtype == torch.float32,
                  f"{what}: {tuple(st.shape)} {st.dtype}")
            check(bool(torch.isfinite(st).all()), f"{what}: non-finite")
            check(rel <= bar, f"{what}: rel err {rel:.3e} > {bar:.3e}")
            check(torch.equal(st, st2) and torch.equal(y, y2),
                  f"{what}: repeat differs")
            check(torch.equal(y, y0), f"{what}: y differs from the call "
                                      f"without the state")
            check(st3 is buf and torch.equal(st3, st) and torch.equal(y3, y),
                  f"{what}: the state written into state_out differs")
            key = str(dtype).replace("torch.", "")
            worst[key] = max(worst.get(key, 0.0), rel)
            del args, y, st, y2, st2, y0, y3, st3, buf, want
    torch.cuda.empty_cache()
    print(f"ssd_scan final state: {len(cases)} shapes x 2 dtypes, worst rel "
          f"err " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (float32 bar widened to the plain float32 version's own error"
            f" in {widened} case(s)); y bitwise equal with and without the "
            f"state; bitwise on repeat and into state_out")
    return worst


def norm_rel(got, want) -> float:
    """‖got − want‖ / ‖want‖ over all elements, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


# the bf16 route's kernels that run wgmma (csrc/ssd_scan_bwd.cu, namespace
# tc; <1> and <0>: with and without 16-byte loads), and the substrings of
# each pass's kernel names in a profile
SSD_BWD_TC_KERNELS = ("ssd_bwd_tc_states_kernel", "ssd_bwd_tc_chunk_kernel")
SSD_BWD_PASS_KEYS = {"bwd_states": "states_kernel", "bwd_state_passing":
                     "pass_kernel", "bwd_chunk": "chunk_kernel",
                     "bwd_reduce": "reduce_kernel"}
# the emulated candidates' shape: b 1, L 2048 (8 chunks of 256), 8 heads of
# 64, N 128, under fast and slow decay
SSD_BWD_EMULATED = (1, 2048, 8, 64, 128, 256)
# the float32 route timed per pass at Mamba2-1.3B's training shape: its
# state passing is the first version's (a thread an element), beside the
# bf16 route's
SSD_BWD_PASS_PROBE = (4, 2048, 64, 64, 128, 256)


def ssd_bwd_resources(resources: dict) -> str:
    """The resource line of the backward's library (``kernel_resources``
    of ``ssd_scan_bwd``): each kernel's registers, spill bytes and HGMMA
    count; the bf16 route's states and chunk kernels must contain HGMMA
    and spill nothing."""
    for name in SSD_BWD_TC_KERNELS:
        hits = {k: v for k, v in resources.items() if k.startswith(name)}
        check(bool(hits), f"ssd_scan_bwd: no {name} in the library")
        for k, v in hits.items():
            check(v["HGMMA"] > 0, f"ssd_scan_bwd {k}: no HGMMA in its SASS")
            check(v["spill_bytes"] == 0,
                  f"ssd_scan_bwd {k}: {v['spill_bytes']} spill bytes")
    return "; ".join(f"{k} {v['registers']} registers, {v['spill_bytes']} "
                     f"spill bytes, HGMMA {v['HGMMA']}"
                     for k, v in sorted(resources.items()))


def ssd_bwd_candidates(torch, dev, shape=SSD_BWD_EMULATED) -> str:
    """The bf16 route's roundings emulated on the card
    (:func:`ssd_bwd_passes`, each candidate of ``SSD_CANDIDATES`` for its
    six rounded operands) against the plain version in float32 math on the
    same bf16 inputs: the worst norm-wise gradient of each, fast and slow
    decay."""
    from repro_torch.kernels import ref
    b, L, H, P, N, Q = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    out = []
    for slow in (False, True):
        ops = ssd_operands(torch, gen, dev, b, L, H, P, N, torch.bfloat16,
                           slow=slow)
        dy = torch.randn((b, L, H, P), generator=gen, device=dev).bfloat16()
        want = ref.ssd_scan_bwd_plain(*ops, dy, Q)
        worst = {op: max(norm_rel(g, w) for g, w in zip(
            ssd_bwd_passes(torch, *ops, dy, Q, op), want))
                 for op in SSD_CANDIDATES}
        out.append(f"{'slow' if slow else 'fast'} decay " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
    return "; ".join(out)


def ssd_bwd_phase(torch, dev, cases=SSD_BWD_CASES, timed=SSD_BWD_TIMED,
                  resources: dict | None = None,
                  emulated=SSD_BWD_EMULATED,
                  pass_probe=SSD_BWD_PASS_PROBE) -> dict:
    """K6's backward (``ssd_scan_bwd``) against its plain version
    (``ref.ssd_scan_bwd_plain``) on the model's operands (x, B and C views
    of one conv output, Mamba2's decays) and a standard normal dy: float32
    against the float64 plain version within ``REL``, bfloat16 against the
    plain version in float32 math within ``LM_REF_REL``, each of the six
    gradients norm-wise (dA and ddt sum terms that largely cancel); every
    gradient finite, bitwise on repeat, one launch of each pass a call.  A
    planted fault — dy read one row late (rolled by a row) — must fail the
    bar.  At the ``timed`` cases: ms (median of single calls between CUDA
    events), the device time of its kernels alone and of each pass, the
    forward's ms, the plain version's ms and the bound
    (``roofline.ssd_scan_bwd_terms``).  With ``resources`` (the library's
    :func:`kernel_resources`) it prints and checks
    :func:`ssd_bwd_resources`; with ``emulated`` (a shape) it prints
    :func:`ssd_bwd_candidates`; with ``pass_probe`` (a shape) it times the
    float32 route per pass there, beside the first timed case's bf16 passes.
    Returns the kernel line's record for the first case (Mamba2-1.3B's
    training shape)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.perf.roofline import ssd_scan_bwd_terms
    if resources is not None:
        print(f"ssd_scan_bwd kernels: {ssd_bwd_resources(resources)}")
    if emulated is not None:
        print(f"ssd_scan_bwd bf16 route's roundings emulated at "
              f"{emulated}, worst norm-wise gradient: "
              f"{ssd_bwd_candidates(torch, dev, emulated)}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    names = ("dx", "dB", "dC", "ddt", "dA", "dD")
    record = None
    for i, (b, L, H, P, N, Q, dname) in enumerate(cases):
        dtype = getattr(torch, dname)
        ops = ssd_operands(torch, gen, dev, b, L, H, P, N, dtype,
                           model_like=True)
        dy = torch.randn((b, L, H, P), generator=gen, device=dev).to(dtype)
        what = f"ssd_scan_bwd {(b, L, H, P, N, Q)} {dname}"
        before, n0 = dict(sk.route_launches), sk.launches["ssd_scan_bwd"]
        got = sk.ssd_scan_bwd(*ops, dy, Q)
        again = sk.ssd_scan_bwd(*ops, dy, Q)
        sync(torch, dev)
        passes = [sk.route_launches[p] - before[p] for p in sk.BWD_PASSES]
        check(sk.launches["ssd_scan_bwd"] - n0 == 2
              and passes == [2] * len(passes),
              f"{what}: launches {sk.launches['ssd_scan_bwd'] - n0}, "
              f"passes {passes}")
        f32 = dtype == torch.float32
        if f32:
            want = ref.ssd_scan_bwd_plain(*(t.double() for t in ops),
                                          dy.double(), Q)
        else:
            want = ref.ssd_scan_bwd_plain(*ops, dy, Q)
        bar = REL if f32 else LM_REF_REL
        rels = {n: norm_rel(g, w) for n, g, w in zip(names, got, want)}
        worst = max(rels.values())
        bitwise = all(torch.equal(a, g) for a, g in zip(again, got))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        check([g.dtype for g in got] == [dtype] * 3 + [torch.float32] * 3
              and all(g.shape == w.shape for g, w in zip(got, want)),
              f"{what}: dtypes {[g.dtype for g in got]} or shapes differ")
        check(finite, f"{what}: a gradient is not finite")
        check(worst <= bar, f"{what}: norm-wise {rels} over {bar}")
        check(bitwise, f"{what}: not bitwise on repeat")
        planted = max(norm_rel(g, w) for g, w in zip(
            sk.ssd_scan_bwd(*ops, dy.roll(1, 1), Q), want))
        check(planted > bar, f"{what}: the planted fault (dy one row late) "
                             f"passes ({planted:.3e} <= {bar})")
        abs_err = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got, want))
        line = (f"{what} ({sk.route(dtype)}): " + ", ".join(
            f"{n} {v:.2e}" for n, v in rels.items())
                + f" (norm-wise, bar {bar:g}; max abs {abs_err:.3e}); "
                f"bitwise on repeat; planted fault {planted:.3e}")
        if i in timed:
            def call():
                return sk.ssd_scan_bwd(*ops, dy, Q)
            ms = time_ms(call, 10)
            alone = kernel_device_ms(torch, call, 10, "ssd_bwd")
            per_pass = ssd_bwd_pass_ms(torch, call, 10)
            fwd_ms = time_ms(lambda: sk.ssd_scan(*ops, Q), 10)
            plain_ms = time_ms(lambda: ref.ssd_scan_bwd_plain(*ops, dy, Q),
                               3)
            terms = ssd_scan_bwd_terms(b, L, H, P, N, Q, dtype)
            line += (f"; {ms:.4f} ms (the device alone {alone:.4f}: "
                     + ", ".join(f"{p} {v:.4f}" for p, v in per_pass.items())
                     + f"; the forward {fwd_ms:.4f}), plain {plain_ms:.3f} "
                     f"ms, bound {terms.step_time_s * 1e3:.4f} ms by "
                     f"{terms.bound_by} ({terms.flops:.3e} operations, "
                     f"{terms.bytes:.3e} bytes), "
                     f"{terms.step_time_s * 1e3 / ms:.2%} of it")
            if record is None:
                record = {"max_abs_err": abs_err, "ms": ms,
                          "device_ms": alone, "pass_ms": per_pass,
                          "plain_ms": plain_ms,
                          "bound_ms": terms.step_time_s * 1e3,
                          "bound_by": terms.bound_by, "library_ms": None,
                          "rel": worst}
        print(line)
        del ops, dy, got, again, want
    if pass_probe is not None:
        b, L, H, P, N, Q = pass_probe
        ops = ssd_operands(torch, gen, dev, b, L, H, P, N, torch.float32,
                           model_like=True)
        dy = torch.randn((b, L, H, P), generator=gen, device=dev)
        per = ssd_bwd_pass_ms(torch, lambda: sk.ssd_scan_bwd(*ops, dy, Q), 3)
        print(f"ssd_scan_bwd at {pass_probe}, the device ms of each pass: "
              f"float32 route " + ", ".join(
                  f"{p} {v:.4f}" for p, v in per.items())
              + "; bf16 route " + ", ".join(
                  f"{p} {v:.4f}" for p, v in (record or {}).get(
                      "pass_ms", {}).items()))
        del ops, dy
    return {"ssd_scan_bwd": record}


def ssd_bwd_pass_ms(torch, fn, reps: int) -> dict[str, float]:
    """Device ms per call of each of the backward's passes
    (``SSD_BWD_PASS_KEYS`` in its kernels' names), from one profiled run of
    ``reps`` calls after a warm-up; a run that recorded fewer than ``reps``
    launches of a pass is taken again."""
    fn()
    for _ in range(PROFILE_ATTEMPTS):
        _, per_name = device_events(torch,
                                    lambda: [fn() for _ in range(reps)])
        out, full = {}, True
        for p, key in SSD_BWD_PASS_KEYS.items():
            hits = [(t, c) for name, (t, c) in per_name.items()
                    if "ssd_bwd" in name and key in name]
            full = full and sum(c for _, c in hits) >= reps
            out[p] = sum(t for t, _ in hits) / reps
        if full:
            return out
    check(False, f"the profiler recorded fewer than {reps} launches of a "
                 f"backward pass in {PROFILE_ATTEMPTS} runs")


def pg_problems(np, graph, per_region: int):
    """The paper's worked example with its capacity coupling, and phase
    9's DAG on a random_fleet of 8 regions × ``per_region`` with phase 9's
    coupling."""
    from repro_torch.core import (DQCoupling, ExplicitFleet, PlacementProblem,
                                  linear_graph)
    from repro_torch.sim.scenarios import ScenarioConfig, random_fleet
    com = np.array([[0.0, 1.5, 2.0], [1.5, 0.0, 1.0], [2.0, 1.0, 0.0]])
    paper = PlacementProblem(
        linear_graph([1.0, 1.5, 1.0]), ExplicitFleet(com_cost=com), beta=1.0,
        dq=DQCoupling(cap0=np.full(3, 1.2), load=np.full(3, 0.2)))
    fleet = random_fleet(np.random.default_rng(SEED + 9), ScenarioConfig(
        n_regions=(8, 8), devices_per_region=(per_region, per_region)))
    V = fleet.n_devices
    dense = PlacementProblem(graph, fleet, beta=1.0,
                             dq=coupling_for(np, DQCoupling, graph.n_ops, V))
    return paper, dense


def pg_loss_and_grad(torch, prob, temp, z, w, dev):
    """``projected_gradient``'s loss (``projected_gradient_loss``) and its
    gradient at logits ``z`` and dq logit ``w`` on ``dev``."""
    from repro_torch.core.optimizers import projected_gradient_loss
    zt = torch.tensor(z, device=dev, requires_grad=True)
    wt = torch.tensor(w, device=dev, requires_grad=True)
    f = projected_gradient_loss(prob, temp, device=dev)(zt, wt)
    gz, gw = torch.autograd.grad(f, (zt, wt))
    return float(f.detach()), gz.cpu(), float(gw)


def projected_gradient_phase(torch, np, dev, graph, small_per_region: int,
                             per_region: int, steps: int,
                             profile: bool = True) -> dict:
    """``projected_gradient`` (ROADMAP A9) on the card.  (1) The paper
    problem and phase 9's DAG at V 8 × ``small_per_region``: the loss and
    its gradient at seeded points, every temperature, ≤1e-5 to the CPU
    route's; from a shared start, the same dq and the paper problem's F
    within ``PG_PAPER_F`` of the CPU route's.  The small dense problem's
    trajectory is not determined by float32 (ROADMAP Queue C): the two
    routes' results are each held at most at the uniform placement's F,
    and their gap is printed.  (2) Phase 9's problem at
    V 8 × ``per_region``: its loss and gradient at a seeded point per
    temperature ≤1e-5 to the CPU route's, then ``steps`` × 3 temperatures
    timed through ``obs.bench``; the loss falls, the result is on the simplex and
    feasible (its F against the uniform placement's is printed: the
    reference's temperatures do not beat it at this V either,
    tests/test_torch_smooth.py), steps/s, peak memory and a profile of one
    step.  It raises if TF32 matmuls are on."""
    from repro_torch import obs
    from repro_torch.core import SmoothConfig, make_latency_fn, \
        projected_gradient
    from repro_torch.core.optimizers import _dq_grid
    from repro_torch.core.placement import uniform_placement

    phase = "projected_gradient"
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          f"{phase}: TF32 matmuls are on")
    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED + 23)
    paper, small = pg_problems(np, graph, small_per_region)
    worst = {"loss": 0.0, "grad": 0.0}
    for prob in (paper, small):
        n_ops, V = prob.availability().shape
        for temp in (0.1, 0.02, 0.005):
            for _ in range(3):
                z = (rng.standard_normal((n_ops, V)) * 1.5).astype(np.float32)
                w = np.float32(rng.standard_normal())
                got = pg_loss_and_grad(torch, prob, temp, z, w, dev)
                want = pg_loss_and_grad(torch, prob, temp, z, w, cpu)
                worst["loss"] = max(worst["loss"],
                                    abs(got[0] - want[0]) / abs(want[0]))
                g = torch.cat([got[1].flatten(), torch.tensor([got[2]])])
                gw = torch.cat([want[1].flatten(), torch.tensor([want[2]])])
                worst["grad"] = max(worst["grad"], rel_err(g, gw)[0])
    check(worst["loss"] <= REL and worst["grad"] <= REL,
          f"{phase}: card vs CPU route loss {worst['loss']:.3e}, gradient "
          f"{worst['grad']:.3e} > {REL}")
    shared = {}
    for name, prob, n_steps in (("paper", paper, 150), ("small", small, 60)):
        n_ops, V = prob.availability().shape
        z0 = (0.01 * rng.standard_normal((n_ops, V))).astype(np.float32)
        card = projected_gradient(prob, steps=n_steps, device=dev, z0=z0)
        host = projected_gradient(prob, steps=n_steps, device=cpu, z0=z0)
        gap = abs(card.F - host.F) / abs(host.F)
        hist = float(np.abs(np.array(card.history)
                            - np.array(host.history)).max())
        check(card.dq_fraction == host.dq_fraction,
              f"{phase} {name}: dq {card.dq_fraction} vs the CPU route's "
              f"{host.dq_fraction}")
        if name == "paper":
            check(gap <= PG_PAPER_F, f"{phase} paper: F {card.F} vs the CPU "
                                     f"route's {host.F}: {gap:.3e} > "
                                     f"{PG_PAPER_F:.0e}")
        else:
            uni = uniform_placement(n_ops, prob.availability())
            uni_small = min(prob.score(uni, d)
                            for d in _dq_grid(prob, steps=10))
            check(max(card.F, host.F) <= uni_small * (1 + REL),
                  f"{phase} small: F {card.F} / CPU {host.F} above the "
                  f"uniform placement's {uni_small}")
        shared[name] = (gap, hist)
    # the main path at V 4096: steps x 3 temperatures
    _, prob = pg_problems(np, graph, per_region)
    n_ops, V = prob.availability().shape
    uni = uniform_placement(n_ops, prob.availability())
    uni_F = min(prob.score(uni, d) for d in _dq_grid(prob, steps=10))
    # its loss and gradient, card vs CPU route, at one seeded point per
    # temperature (the timed run's 21 V x V products, its DP and autograd)
    big = {"loss": 0.0, "grad": 0.0}
    for temp in (0.1, 0.02, 0.005):
        z = (rng.standard_normal((n_ops, V)) * 1.5).astype(np.float32)
        w = np.float32(rng.standard_normal())
        got = pg_loss_and_grad(torch, prob, temp, z, w, dev)
        want = pg_loss_and_grad(torch, prob, temp, z, w, cpu)
        big["loss"] = max(big["loss"], abs(got[0] - want[0]) / abs(want[0]))
        g = torch.cat([got[1].flatten(), torch.tensor([got[2]])])
        gw = torch.cat([want[1].flatten(), torch.tensor([want[2]])])
        big["grad"] = max(big["grad"], rel_err(g, gw)[0])
    check(big["loss"] <= REL and big["grad"] <= REL,
          f"{phase}: V {V} card vs CPU route loss {big['loss']:.3e}, "
          f"gradient {big['grad']:.3e} > {REL}")
    torch.cuda.reset_peak_memory_stats(dev)
    sync(torch, dev)
    secs, res = obs.time_once(lambda: projected_gradient(
        prob, steps=steps, device=dev, seed=SEED))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n = steps * 3
    check(res.dispatches == n and len(res.history) == n,
          f"{phase}: {res.dispatches} steps, want {n}")
    check(bool(np.isfinite(res.history).all())
          and res.history[-1] < res.history[0] and np.isfinite(res.F),
          f"{phase}: the loss went {res.history[0]} -> {res.history[-1]}, "
          f"F {res.F}")
    check(prob.feasible(res.x, res.dq_fraction)
          and np.allclose(res.x.sum(axis=1), 1.0) and (res.x >= 0).all(),
          f"{phase}: the result is off the simplex or violates the coupling")
    prof = "not measured (no card)"
    if profile:
        lat = make_latency_fn(prob.graph, prob.fleet,
                              SmoothConfig(temp=0.02), device=dev)
        z = torch.zeros((n_ops, V), device=dev, requires_grad=True)

        def one_step():
            val = lat(torch.softmax(z, dim=1))
            torch.autograd.grad(val, z)
            return float(val.detach())

        one_step()
        prof = device_profile(torch, one_step, {
            "GEMV/GEMM": GEMM + ("gemv",),
            "reductions": ("reduce",), "elementwise": ("elementwise",
                                                       "vectorized")})
    print(f"{phase}: card vs CPU route at seeded points (paper, V "
          f"{small.fleet.n_devices}; 3 temperatures): loss {worst['loss']:.3e}"
          f", gradient {worst['grad']:.3e} (bar {REL}); from a shared start, "
          f"card vs CPU route: paper F {shared['paper'][0]:.3e} apart (bar "
          f"{PG_PAPER_F:.0e}), loss history {shared['paper'][1]:.3e}; V "
          f"{small.fleet.n_devices} F {shared['small'][0]:.3e} apart, loss "
          f"history {shared['small'][1]:.3e} (not float32-determined: both "
          f"at most the uniform placement's F, the same dq)")
    print(f"{phase}: random_fleet V = {V}: card vs CPU route at a seeded "
          f"point per temperature: loss {big['loss']:.3e}, gradient "
          f"{big['grad']:.3e} (bar {REL})")
    print(f"{phase}: random_fleet V = {V}, E = {graph.n_edges}, {steps} steps "
          f"x 3 temperatures in {secs:.2f} s ({n / secs:.1f} steps/s), loss "
          f"{res.history[0]:.4g} -> {res.history[-1]:.4g}, F {res.F:.6g} (dq "
          f"{res.dq_fraction}) = {res.F / uni_F:.3f} x the uniform "
          f"placement's {uni_F:.6g} (the reference's absolute temperatures "
          f"dominate at this V; tests/test_torch_smooth.py), peak "
          f"{peak:.2f} GiB")
    print(f"{phase} profile (one loss + gradient at temp 0.02): {prof}")
    return {"seconds": secs, "F": res.F, "uniform_F": uni_F,
            "big_loss": big["loss"], "big_grad": big["grad"]}


def lm_forward_phase(torch, np, dev, cfg, batch: int = FORWARD_BATCH,
                     seq: int = FORWARD_SEQ, timed: bool = True) -> dict:
    """One forward (no cache) of ``cfg``'s model on ``batch`` × ``seq``
    tokens with its extras (seeded image or frame embeddings, a VLM's
    gates opened), on K5's route where ``cfg`` asks for it: K5 and K7
    launched as the config implies (K5 once per causal self-attention:
    never for the Whisper encoder or a cross-attention), finite logits of
    the right shape, and each row's score (its mean next-token
    cross-entropy, what ``model_op`` reports) within ``LM_REF_REL`` of the
    plain route's (the chunked reference attention, K7's plain version);
    then K5 / K7 held on the operands this forward hands them
    (:func:`hold_path_kernels`; timed with ``timed`` on the card).  The
    logits are not held here: at 40 layers, or through an MoE router
    whose top-k flips on a rounding, their gap to the plain route is the
    size of the plain route's own bf16 error against float32 activations
    (an H100 read 2.17e-2 against 2.29e-2 for Llama-Vision, 0.798
    against 0.805 for Grok at 4 layers), so a bar between them would test
    the noise; lm_serve holds the logits over the first layers."""
    from repro_torch.models.layers import token_cross_entropy
    phase = f"lm_forward {cfg.name}"
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = seeded_model(torch, cfg, dev)
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 31)
    inputs = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (batch, seq), dtype=np.int32), device=dev),
        **model_extras(torch, cfg, batch, dev)}
    per = expected_launches(cfg)
    with torch.inference_mode():
        sync(torch, dev)
        reset_lm_launches()
        t0 = time.perf_counter()
        logits, _ = model(inputs)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        launched = {k: lm_launches()[k] for k in per}
        check(launched == per, f"{phase}: launches {launched}, want {per}")
        check(logits.shape == (batch, seq, cfg.vocab_padded)
              and bool(torch.isfinite(logits).all()),
              f"{phase}: logits {tuple(logits.shape)} not finite of shape "
              f"{(batch, seq, cfg.vocab_padded)}")
        toks = inputs["tokens"]
        with plain_route(model):
            want, _ = model(inputs)
        score, want_score = (token_cross_entropy(t[:, :-1], toks[:, 1:])
                             .mean(-1) for t in (logits, want))
        ref_rel = rel_err(score, want_score)[0]
        del logits, want
    check(ref_rel <= LM_REF_REL, f"{phase}: scores vs the plain route "
                                 f"(reference attention, plain K7) rel err "
                                 f"{ref_rel:.3e} > {LM_REF_REL}")

    def run():
        with torch.inference_mode():
            model(inputs)

    held = hold_path_kernels(torch, dev, phase, run,
                             timed=timed and dev.type == "cuda")
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB"
            if dev.type == "cuda" else "not measured")
    extras = ", ".join(f"{k} {tuple(v.shape)}" for k, v in inputs.items()
                       if k != "tokens") or "none"
    print(f"{phase}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd} ({cfg.n_kv_heads} kv), "
          f"{batch} x {seq} tokens, extras {extras}; set-up {setup_s:.1f} s;"
          f" forward {wall * 1e3:.1f} ms, peak {peak}; launches {launched} "
          f"(want {per}); scores vs the plain route rel err {ref_rel:.3e} "
          f"(bar {LM_REF_REL})")
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launched, "ref_rel": ref_rel, "held": held,
            "wall": wall}


def lm_serve_phase(torch, np, dev, cfg, cut: str = "",
                   profile: bool = True) -> dict:
    """``serve_wave`` (ROADMAP A13a) with ``cfg`` at its published widths
    and seeded random weights (a VLM's gates opened), with the extras a
    VLM or an audio model serves with (:func:`model_extras`):
    ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens, ``SERVE_GEN``
    generated.  It checks the K6 / K7 launches against the count the model
    implies (:func:`expected_launches` of a prefill and of each decode
    step) and finite tokens in the vocabulary; with cross-attention, that
    every decode step leaves the cached cross keys and values bitwise as
    the prefill wrote them.  Then a prefill and ``SERVE_FORCED`` teacher-forced
    decode steps: (1) every operand the model handed K7 or K6 there, one
    per shape and dtype (block, qk- and gate norms; the prefill scan with
    its final state), goes through the kernel again against its plain
    version (``REL`` / ``BF16_REL``, float32 K6 widened to the plain
    version's own error as phase 7), bitwise on repeat
    (:func:`hold_path_kernels`); (2) the model cut to its first
    ``SERVE_STRICT_LAYERS`` layers (a hybrid's first shared-attention site
    runs ahead of them) and (3) the whole model: the logits against the
    same depth with K6 / K7's plain versions, within ``LM_REF_REL`` or,
    where larger, the plain route's own bf16 error at that depth (its
    logits against the same model with float32 activations).  Planted
    faults (:func:`wrong_ssm_kernels`) must fail
    both (2) and (3).  It prints prefill s, decode tokens/s, peak memory
    and a profile of one decode step."""
    from repro_torch.launch.serve import ServeStats, serve_wave
    phase = f"lm_serve {cfg.name}"
    B, S_, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = seeded_model(torch, cfg, dev)
    extras = model_extras(torch, cfg, B, dev)
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 24)
    prompts = rng.integers(0, cfg.vocab, (B, S_), dtype=np.int32)
    pre, dec = (expected_launches(cfg, m) for m in ("prefill", "decode"))
    want = {k: pre.get(k, 0) + (G - 1) * dec.get(k, 0)
            for k in ("rmsnorm", "ssd_scan")}
    sync(torch, dev)
    reset_lm_launches()
    stats = ServeStats()
    out, stats = serve_wave(model, cfg, prompts, G, extras, stats=stats)
    launched = {k: lm_launches()[k] for k in LM_FORWARD_KERNELS}
    check(launched["rmsnorm"] == want["rmsnorm"]
          and launched["ssd_scan"] == want["ssd_scan"]
          and launched["flash_attention"] == 0,
          f"{phase}: launches {launched}, want {want} and no K5")
    check(out.shape == (B, G) and ((out >= 0) & (out < cfg.vocab)).all(),
          f"{phase}: tokens out of shape or vocabulary")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # prefill and teacher-forced decode
    forced = rng.integers(0, cfg.vocab, (B, SERVE_FORCED), dtype=np.int32)
    stage = {"now": ""}
    cross_same = []

    def run():
        logits = []
        with torch.inference_mode():
            cache = model.init_cache(B, S_ + SERVE_FORCED)
            stage["now"] = "prefill"
            lg, cache = model.prefill(
                {"tokens": torch.as_tensor(prompts, device=dev), **extras},
                cache)
            logits.append(lg)
            cross = getattr(cache, "cross", None)
            if cross is not None:
                written = cross.k.clone(), cross.v.clone()
            stage["now"] = "decode"
            for i in range(SERVE_FORCED):
                lg, cache = model.decode_step(
                    cache, S_ + i,
                    torch.as_tensor(forced[:, i:i + 1], device=dev))
                logits.append(lg)
            if cross is not None:
                cross_same.append(torch.equal(cross.k, written[0])
                                  and torch.equal(cross.v, written[1]))
                check(cross_same[-1], f"{phase}: a decode step changed the "
                                      f"cached cross keys or values")
                del written
        return torch.cat(logits, dim=1)

    def against_plain(faults: dict):
        """This model's logits through the kernels against the plain
        route's, each planted fault's against the plain route's, and the
        plain route's logits."""
        got = run()
        with plain_ssm_kernels():
            plain = run()
        check(bool(torch.isfinite(got).all()), f"{phase}: non-finite logits")
        planted = {}
        for name, (ssd, rms) in faults.items():
            with swapped_ssm_kernels(ssd, rms):
                planted[name] = rel_err(run(), plain)[0]
        return rel_err(got, plain)[0], planted, plain

    def own_error(plain) -> float:
        """The plain route's own bf16 error: ``plain`` against the plain
        route with float32 activations, at the model's current depth."""
        saved = model.cfg
        with plain_ssm_kernels():
            model.cfg = saved.replace(act_dtype="float32")
            try:
                exact = run()
            finally:
                model.cfg = saved
        return rel_err(plain, exact)[0]

    # (1) K7 / K6 on the operands this path hands them
    held = [f"{h['stage']} {k[0]} {k[1]} {str(k[2])[6:]} {h['rel_err']:.2e}"
            for k, h in hold_path_kernels(torch, dev, phase, run, stage,
                                          timed=False).items()]
    faults = wrong_ssm_kernels(torch, cfg)
    # (2) the first layers, where bf16 drift is smaller than at full depth:
    # within LM_REF_REL or, where larger, the plain route's own bf16 error
    # at that depth
    strict = min(SERVE_STRICT_LAYERS, cfg.n_layers)
    with depth_cut(model, strict):
        rel_cut, planted_cut, plain = against_plain(faults)
        own_cut = own_error(plain)
    bar_cut = max(LM_REF_REL, own_cut)
    check(rel_cut <= bar_cut,
          f"{phase}: first {strict} layers' logits vs the plain K6/K7 route "
          f"rel err {rel_cut:.3e} > {bar_cut:.3e}")
    # (3) full depth, within the plain route's own bf16 error
    rel, planted, plain = against_plain(faults)
    own = own_error(plain)
    bar = max(LM_REF_REL, own)
    del plain
    check(rel <= bar, f"{phase}: logits vs the plain K6/K7 route rel err "
                      f"{rel:.3e} > {bar:.3e}")
    for name in faults:       # NaN logits fail the check too
        check(not (planted_cut[name] <= bar_cut or planted[name] <= bar),
              f"{phase}: the planted fault {name!r} passes the logits check "
              f"(first layers {planted_cut[name]:.3e}, bar {bar_cut:.3e}; "
              f"full depth {planted[name]:.3e}, bar {bar:.3e})")
    prof = "not measured (no card)"
    if profile:
        with torch.inference_mode():
            cache = model.init_cache(B, S_ + 2)
            model.prefill({"tokens": torch.as_tensor(prompts, device=dev),
                           **extras}, cache)
            tok = torch.as_tensor(prompts[:, -1:], device=dev)
            prof = device_profile(
                torch, lambda: model.decode_step(cache, S_, tok), {
                    "K7": ("rmsnorm",), "K6": ("ssd_scan",),
                    "f32 GEMM": F32_GEMM, "bf16 GEMM": GEMM,
                    "casts/copies": ("copy", "memcpy", "cast")})
            del cache
    s = stats.summary()
    if extras:
        print(f"{phase}: extras " + ", ".join(
            f"{k} {tuple(v.shape)}" for k, v in extras.items())
            + (f"; cross keys and values bitwise unchanged by every decode "
               f"step in {len(cross_same)} runs" if cross_same else ""))
    print(f"{phase}{cut}: {B} prompts x {S_} tokens + {G} generated; set-up "
          f"{setup_s:.1f} s; prefill {stats.prefill_s:.4f} s "
          f"({B * S_ / stats.prefill_s:.0f} tokens/s), decode "
          f"{stats.decode_s:.3f} s for {G - 1} steps "
          f"({stats.decode_s / (G - 1) * 1e3:.2f} ms/step, "
          f"{B * (G - 1) / stats.decode_s:.1f} tokens/s); peak {peak:.2f} GiB;"
          f" launches {launched} (want {want})")
    print(f"{phase}: K6/K7 on the operands of prefill + {SERVE_FORCED} decode"
          f" steps vs their plain versions (bars {REL} / {BF16_REL}, bitwise "
          f"on repeat): " + ("; ".join(held) or "no kernel on this path"))
    print(f"{phase}: logits of prefill + {SERVE_FORCED} forced decode steps "
          f"vs the plain K6/K7 route (bars: {LM_REF_REL}, or the plain "
          f"route's own bf16 error against float32 activations at that "
          f"depth, where larger): first {strict} layers {rel_cut:.3e} (bar "
          f"{bar_cut:.3e}, own {own_cut:.3e}), full depth {rel:.3e} (bar "
          f"{bar:.3e}, own {own:.3e}); planted "
          f"faults, first layers / full depth (nan: non-finite logits): "
          + ("; ".join(
              f"{k} {planted_cut[k]:.3e} / {planted[k]:.3e}" for k in faults)
              or "none (no kernel on this path)"))
    print(f"{phase} profile (one decode step, batch {B}): {prof}")
    del model, extras
    torch.cuda.empty_cache()
    return {"summary": s, "launches": launched, "rel": rel, "own": own,
            "rel_cut": rel_cut, "own_cut": own_cut, "planted": planted,
            "planted_cut": planted_cut, "held": held, "peak": peak,
            "cross_unchanged": bool(cross_same) and all(cross_same)}


# -- the thirteenth slice: the single-card trainer ---------------------------

@contextlib.contextmanager
def recorded_rmsnorm_bwd(seen: dict):
    """Inside the block K7's backward still launches, and ``seen`` keeps
    copies of the first (x, w, g, eps) it is handed for every shape and
    dtype, keyed ``("rmsnorm_bwd", shape, dtype)``."""
    from repro_torch.kernels import rmsnorm as rk
    saved = rk.rmsnorm_bwd

    def bwd(x, w, g, eps=1e-6):
        key = ("rmsnorm_bwd", tuple(x.shape), x.dtype)
        if key not in seen:
            seen[key] = (x.clone(), w.clone(), g.clone(), eps)
        return saved(x, w, g, eps)

    rk.rmsnorm_bwd = bwd
    try:
        yield
    finally:
        rk.rmsnorm_bwd = saved


def hold_rmsnorm_bwd(torch, dev, phase: str, seen: dict) -> dict:
    """K7's backward on recorded operands (:func:`recorded_rmsnorm_bwd`)
    against its plain version (autograd through ``ref.rmsnorm_plain``):
    float32 dx against the float64 plain version at ``REL``; bfloat16 dx
    against the plain version on the same operands (float32 math, one
    rounding to bf16) at ``BF16_REL``, one bf16 ulp of the largest, with
    the plain version's own bf16 error against float64 printed beside it;
    dw (float32) against the float64 plain version at ``DW_REL``; bitwise
    on repeat.  Timed: the kernel's, the plain version's and the bound's
    ms, and ``F.rms_norm``'s autograd backward on the same operands
    (timed as a yardstick only; bf16 x with a bf16 weight, the dtype its
    fused kernel takes)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.perf import roofline
    out = {}
    for key, (x, w, g, eps) in seen.items():
        _, shape, dtype = key
        what = f"{phase} rmsnorm_bwd {shape} {str(dtype)[6:]}"
        f32 = dtype == torch.float32
        dx, dw = rk.rmsnorm_bwd(x, w, g, eps)
        dx2, dw2 = rk.rmsnorm_bwd(x, w, g, eps)
        wide = ref.rmsnorm_bwd_plain(x.double(), w.double(), g.double(), eps)
        plain = ref.rmsnorm_bwd_plain(x, w, g, eps)
        sync(torch, dev)
        rel_dx, err_dx = rel_err(dx, wide[0] if f32 else plain[0])
        own = rel_err(plain[0], wide[0])[0]
        rel_dw, err_dw = rel_err(dw, wide[1])
        bar = REL if f32 else BF16_REL
        check(bool(torch.isfinite(dx).all() and torch.isfinite(dw).all()),
              f"{what}: non-finite")
        check(rel_dx <= bar, f"{what}: dx rel err {rel_dx:.3e} > {bar:.0e}")
        check(rel_dw <= DW_REL,
              f"{what}: dw rel err {rel_dw:.3e} > {DW_REL:.0e}")
        check(torch.equal(dx, dx2) and torch.equal(dw, dw2),
              f"{what}: repeat differs (not deterministic)")
        D = shape[-1]
        rows = x.numel() // D
        terms = roofline.rmsnorm_bwd_terms(rows, D, dtype)
        r = {"rel_err": max(rel_dx, rel_dw), "dx_rel": rel_dx,
             "dw_rel": rel_dw, "own_bf16": own, "bar": bar,
             "max_abs_err": max(err_dx, err_dw),
             "bound_ms": terms.step_time_s * 1e3, "bound_by": terms.bound_by,
             "rows": rows, "D": D}
        del dx, dw, dx2, dw2, wide, plain
        r["ms"] = time_ms(lambda: rk.rmsnorm_bwd(x, w, g, eps), 10)
        r["plain_ms"] = time_ms(lambda: ref.rmsnorm_bwd_plain(x, w, g, eps), 3)
        xl = x.detach().requires_grad_()
        wl = w.to(x.dtype).detach().requires_grad_()
        y = F.rms_norm(xl, (D,), weight=wl, eps=eps)
        r["library_ms"] = time_ms(lambda: torch.autograd.grad(
            y, (xl, wl), g, retain_graph=True), 10)
        if dev.type == "cuda":   # the device's time alone, no host
            r["device_ms"] = kernel_device_ms(
                torch, lambda: rk.rmsnorm_bwd(x, w, g, eps), 20,
                "rmsnorm_")       # both kernels: rows and the dw sum
            r["library_device_ms"] = device_ms_per_call(
                torch, lambda: torch.autograd.grad(
                    y, (xl, wl), g, retain_graph=True), 20)
        del xl, wl, y
        out[key] = r
        print(f"{what}: dx rel err {rel_dx:.3e} (bar {bar:.0e}; the plain "
              f"version's own bf16 error {own:.3e}), dw {rel_dw:.3e} (bar "
              f"{DW_REL:.0e}), bitwise on repeat; {r['ms']:.4f} ms (the "
              f"device alone {r.get('device_ms', float('nan')):.4f}), plain "
              f"{r['plain_ms']:.4f} ms, F.rms_norm backward "
              f"{r['library_ms']:.4f} ms (the device alone "
              f"{r.get('library_device_ms', float('nan')):.4f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def grad_summary(torch, grad_fn, batch) -> dict:
    """One gradient of ``grad_fn`` on ``batch``: the loss, the global norm
    and each parameter's gradient norm (the gradients themselves are
    freed)."""
    loss, _, grads = grad_fn(batch)
    norms = {n: float(torch.linalg.vector_norm(g.float()))
             for n, g in grads.items()}
    return {"loss": float(loss), "norms": norms,
            "gnorm": sum(v * v for v in norms.values()) ** 0.5}


def grad_distance(a: dict, b: dict) -> float:
    """The largest relative difference of ``a``'s loss, global gradient
    norm and per-parameter gradient norms from ``b``'s."""
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]),
           abs(a["gnorm"] - b["gnorm"]) / b["gnorm"]]
    rel += [abs(a["norms"][n] - v) / max(v, 1e-30)
            for n, v in b["norms"].items()]
    return max(rel) if all(r == r for r in rel) else float("nan")


def refusal(phase: str, name: str, kind, call) -> str:
    """``call()`` must raise ``kind`` with the refusal of a route without
    a backward: a message that says "no backward" and names the ROADMAP
    item.  Any other outcome fails the phase; returns the message's head."""
    try:
        call()
    except kind as e:
        msg = str(e)
        if "no backward" in msg and "ROADMAP" in msg:
            return f"{name}: {msg[:60]}…"
        raise AssertionError(f"{phase}: {name} under grad raised "
                             f"{type(e).__name__}: {msg[:200]}, not the "
                             f"refusal (no backward, ROADMAP)") from e
    raise AssertionError(f"{phase}: {name} under grad did not raise")


def dw_doubled(x, w, g, eps=1e-6):
    """The planted fault of K7's backward: the plain backward with dw
    scaled by 2."""
    from repro_torch.kernels import ref
    dx, dw = ref.rmsnorm_bwd_plain(x, w, g, eps)
    return dx, 2 * dw


def db_doubled(x, B, C, dt, A, D, dy, chunk):
    """The planted fault of K6's backward: the plain backward with dB
    scaled by 2."""
    from repro_torch.kernels import ref
    dx, dB, *rest = ref.ssd_scan_bwd_plain(x, B, C, dt, A, D, dy, chunk)
    return (dx, 2 * dB, *rest)


def lm_train_phase(torch, np, dev, cfg, batch: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ, n_steps: int = TRAIN_STEPS,
                   resume_cfg=None,
                   ckpt_root=None, profile: bool = True, card: str = "",
                   cut: str = "") -> dict:
    """The single-card trainer (ROADMAP A13c) on ``cfg`` with seeded random
    weights and batches of ``batch`` x ``seq`` tokens from the synthetic
    stream of ``data/pipeline.py`` (a quarter of the rows quality-checked),
    from its first batch whose check masks a row, so that step 1's loss is
    normalised by a ``loss_mask`` that is not all ones (the share masked
    over the run is checked above 0), through ``make_grad_fn`` /
    ``make_train_step``: (1) step 1's gradient: every parameter's finite
    and non-zero (a detached kernel would leave norm weights without one);
    (2) K7's backward held on the operands that step hands it
    (:func:`hold_rmsnorm_bwd`, timed); (3) step 1 over the first
    ``TRAIN_STRICT_LAYERS`` layers and at the cut depth against the plain route
    (K6, K7 and their backward swapped for their plain versions): loss,
    global gradient norm and every parameter's gradient norm within
    ``LM_REF_REL`` or, where larger, the plain route's own bf16 error
    against float32 activations; the planted backward faults
    (:func:`dw_doubled`, and for Mamba2 layers :func:`db_doubled`) must
    fail both; (4) ``n_steps`` steps of AdamW
    (float32 moments, lr ``TRAIN_LR``), each step's launches equal to
    ``expected_launches(cfg, "train")``, the losses finite, tokens/s, the
    model-FLOPs share of the bf16 peak (``analytic_flops(cfg, seq,
    batch, "train")``), peak memory under ``TRAIN_MEM_SHARE`` of the
    card's, the AdamW update's share of a step and the profile of one more
    step; (5) K5 under grad and ``run_training`` on the flash route raise,
    and K6 under grad differentiates through its backward (one launch);
    (6) ``resume_cfg`` (granite's smoke config) dies at step
    ``RESUME_DIE`` and resumes from ``RESUME_EVERY``: its final parameters
    against an uninterrupted run's, bitwise where the path is
    deterministic, else within 1e-5 (the reference test's bar)."""
    import tempfile
    from pathlib import Path as _Path

    from repro_torch.data.pipeline import PipelineConfig, TokenStream
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.launch.train import run_training
    from repro_torch.models import analytic_flops
    from repro_torch.perf.roofline import PEAK_BF16_TC
    from repro_torch.train import steps
    from repro_torch.train.optim import AdamWConfig, adamw_init
    phase = f"lm_train {cfg.name}"
    cuda = dev.type == "cuda"
    resident = 0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = seeded_model(torch, cfg, dev)
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    stream = TokenStream(PipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch, seed=SEED,
                                        dq_fraction=TRAIN_DQ))
    b = stream.next_batch()     # at 1 % corruption few batches mask a row
    for _ in range(TRAIN_MASK_SCAN):
        if not b["loss_mask"].all():
            break
        b = stream.next_batch()
    first_batch = (b["_cursor"] // (batch * (seq + 1))) - 1
    data = []
    for _ in range(n_steps + profile):
        b.pop("_cursor")
        data.append({k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        b = stream.next_batch()
    masked = float(sum((1 - d["loss_mask"]).sum() for d in data)
                   / sum(d["loss_mask"].numel() for d in data))
    check(masked > 0, f"{phase}: no batch of the first {TRAIN_MASK_SCAN} "
                      f"masks a row")
    want = expected_launches(cfg, "train")
    grad_fn = steps.make_grad_fn(model, cfg)

    # (1) + (2): step 1's gradient, K7's backward operands recorded
    seen = {}
    sync(torch, dev)
    reset_lm_launches()
    with recorded_rmsnorm_bwd(seen):
        loss, _, grads = grad_fn(data[0])
    sync(torch, dev)
    launched_grad = {k: lm_launches()[k] for k in want}
    check(launched_grad == want, f"{phase}: step 1's gradient launched "
                                 f"{launched_grad}, want {want}")
    dead = [n for n, g in grads.items()
            if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
    check(not dead, f"{phase}: step 1's gradient is not finite and "
                    f"non-zero for {dead[:8]} ({len(dead)} parameters)")
    n_params = len(grads)
    del grads
    held = hold_rmsnorm_bwd(torch, dev, phase, seen)
    del seen
    if cuda:
        torch.cuda.empty_cache()

    # (3) step 1 against the plain route, over the first layers and at the
    # cut depth; the planted fault must fail both
    def against_plain():
        gf = steps.make_grad_fn(model, model.cfg)   # the current depth's
        got = grad_summary(torch, gf, data[0])
        with plain_route(model):
            plain = grad_summary(torch, gf, data[0])
            saved = model.cfg
            model.cfg = saved.replace(act_dtype="float32")
            try:
                exact = grad_summary(torch, gf, data[0])
            finally:
                model.cfg = saved
        faults = {"dw x 2": dict(rms_bwd=dw_doubled)}
        if ssm:
            faults["dB x 2"] = dict(ssd_bwd=db_doubled)
        planted = {}
        for name, swap in faults.items():
            with plain_route(model, kernels=False), \
                    swapped_ssm_kernels(**swap):
                planted[name] = grad_distance(
                    grad_summary(torch, gf, data[0]), plain)
        own = grad_distance(plain, exact)
        bar = max(LM_REF_REL, own)
        return {"rel": grad_distance(got, plain), "own": own, "bar": bar,
                "planted": min(planted.values()), "faults": planted}

    ssm = cfg.family in ("ssm", "hybrid")
    strict = min(TRAIN_STRICT_LAYERS, cfg.n_layers)
    with depth_cut(model, strict):
        first = against_plain()
    full = against_plain()
    for name, r in ((f"first {strict} layers", first),
                    (f"{cfg.n_layers} layers", full)):
        check(r["rel"] <= r["bar"], f"{phase}: {name}: step 1 vs the plain "
              f"route rel {r['rel']:.3e} > bar {r['bar']:.3e}")
        check(not r["planted"] <= r["bar"], f"{phase}: {name}: the planted "
              f"backward fault passes ({r['planted']:.3e} <= "
              f"{r['bar']:.3e})")
    if cuda:
        torch.cuda.empty_cache()

    # (4) training steps
    opt_cfg = AdamWConfig(lr=TRAIN_LR, bits8=cfg.param_dtype == "bfloat16")
    opt_state = adamw_init(dict(model.named_parameters()), opt_cfg)
    train_step = steps.make_train_step(model, cfg, opt_cfg)
    update = {"s": 0.0}
    adamw = steps.adamw_update

    def timed_update(*args):
        sync(torch, dev)
        t = time.perf_counter()
        out = adamw(*args)
        sync(torch, dev)
        update["s"] += time.perf_counter() - t
        return out

    steps.adamw_update = timed_update
    walls, losses, per_step, updates = [], [], [], []
    try:
        sync(torch, dev)
        reset_lm_launches()     # the main path: n_steps training steps
        for b in data[:n_steps]:
            before = lm_launches()
            update["s"] = 0.0
            t = time.perf_counter()
            opt_state, met = train_step(opt_state, b)
            losses.append(float(met["loss"]))
            sync(torch, dev)
            walls.append(time.perf_counter() - t)
            updates.append(update["s"])
            after = lm_launches()
            per_step.append({k: after[k] - before[k] for k in want})
        launched = dict(lm_launches())
        prof = "not measured (no card)"
        if profile:
            prof = device_profile(
                torch, lambda: train_step(opt_state, data[n_steps]),
                {"K7": ("rmsnorm_kernel", "rmsnorm_rows"),
                 "K7 backward": ("rmsnorm_bwd", "rmsnorm_dw"),
                 "K6 backward chunk pass": ("ssd_bwd_tc_chunk",
                                            "ssd_bwd_chunk"),
                 "K6 backward other passes": ("ssd_bwd",),
                 "K6": ("ssd_scan_states", "ssd_scan_pass",
                        "ssd_scan_output", "ssd_scan_f32"),
                 "f32 GEMM": F32_GEMM, "bf16 GEMM": GEMM,
                 "casts/copies": ("copy", "memcpy", "cast")})
    finally:
        steps.adamw_update = adamw
    check(all(p == want for p in per_step),
          f"{phase}: launches per step {per_step}, want {want}")
    check(all(np.isfinite(losses)), f"{phase}: non-finite losses {losses}")
    peak = total = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
        check(peak <= TRAIN_MEM_SHARE * total,
              f"{phase}: peak {peak / 2 ** 30:.2f} GiB over "
              f"{TRAIN_MEM_SHARE:.0%} of {total / 2 ** 30:.2f} GiB")
    steady = walls[1:] or walls
    step_s = statistics.median(steady)
    upd_s = statistics.median(updates[1:] or updates)
    mflops = analytic_flops(cfg, seq, batch, "train")
    mfu = mflops / (step_s * PEAK_BF16_TC)
    del opt_state, train_step, grad_fn, data, model
    if cuda:
        torch.cuda.empty_cache()

    # (5) the route without a backward refuses under grad; K6 differentiates
    refused = []
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    refused.append(refusal(phase, "K5", RuntimeError,
                           lambda: dispatch.flash_attention(q, q, q)))
    from repro_torch.kernels import ssd_scan as sk
    n0 = sk.launches["ssd_scan_bwd"]
    y6 = dispatch.ssd_scan(q, q[..., 0, :16], q[..., 0, :16],
                           q[..., 0].float(), -torch.ones(2, device=dev),
                           torch.ones(2, device=dev), 64)
    y6.float().sum().backward()
    k6_grad = y6.grad_fn is not None and q.grad is not None \
        and sk.launches["ssd_scan_bwd"] - n0 == 1
    check(k6_grad, f"{phase}: K6 under grad did not differentiate through "
                   f"one launch of its backward")
    del y6, q
    refused.append(refusal(
        phase, "run_training on the flash route", ValueError,
        lambda: run_training(cfg.replace(attention_impl="pallas",
                                         n_layers=1), steps=1,
                             global_batch=1, seq_len=8, device=dev)))

    # (6) die and resume
    resume = None
    if resume_cfg is not None:
        with contextlib.ExitStack() as stack:
            root = _Path(ckpt_root) if ckpt_root is not None else _Path(
                stack.enter_context(tempfile.TemporaryDirectory()))
            kw = dict(steps=RESUME_STEPS, global_batch=RESUME_BATCH,
                      seq_len=RESUME_SEQ, ckpt_every=RESUME_EVERY, lr=1e-3,
                      dq_fraction=TRAIN_DQ, log_every=RESUME_STEPS,
                      device=dev, seed=SEED)
            try:
                run_training(resume_cfg, ckpt_dir=root / "a",
                             die_at_step=RESUME_DIE, **kw)
            except SystemExit as e:
                check(e.code == 13, f"{phase}: died with {e.code}, want 13")
            else:
                check(False, f"{phase}: the run did not die at step "
                             f"{RESUME_DIE}")
            a = run_training(resume_cfg, ckpt_dir=root / "a", resume=True,
                             **kw)["model"].state_dict()
            b = run_training(resume_cfg, ckpt_dir=root / "b",
                             **kw)["model"].state_dict()
            bitwise = all(torch.equal(a[k], b[k]) for k in b)
            worst = max(rel_err(a[k], b[k])[0] for k in b)
            check(bitwise or worst <= 1e-5, f"{phase}: resumed parameters "
                  f"{worst:.3e} from the uninterrupted run's (bar 1e-5)")
            resume = {"bitwise": bitwise, "rel": worst}
            del a, b
    print(f"{phase}{cut} [{card}]: set-up {setup_s:.1f} s; step 1's "
          f"gradient finite and non-zero for all {n_params} parameters; "
          f"launches per step {per_step[0]} (want {want}); batches from "
          f"the stream's batch {first_batch}, the first that masks a row; "
          f"loss-masked share {masked:.4f}")
    for name, r in ((f"first {strict} layers", first),
                    (f"{cfg.n_layers} layers", full)):
        print(f"{phase}: step 1 vs the plain K6/K7 route, {name}: rel "
              f"{r['rel']:.3e} (loss, global and per-parameter gradient "
              f"norms; bar {r['bar']:.3e}, the plain route's own bf16 error "
              f"{r['own']:.3e}); planted faults "
              + ", ".join(f"({k}) {v:.3e}" for k, v in r["faults"].items()))
    print(f"{phase} [{card}]: {n_steps} steps of {batch} x {seq} tokens: "
          f"step {step_s * 1e3:.2f} ms (median of steps 2-{n_steps}), "
          f"{batch * seq / step_s:.1f} tokens/s, model-FLOPs share of the "
          f"bf16 peak {mfu:.2%} ({mflops:.4e} FLOPs a step); AdamW update "
          f"{upd_s * 1e3:.2f} ms ({upd_s / step_s:.2%} of a step); peak "
          + (f"{peak / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} GiB "
             f"({peak / total:.2%}; {resident / 2 ** 30:.2f} GiB resident "
             f"before the phase)" if cuda else "not measured")
          + f"; losses {', '.join(f'{v:.4f}' for v in losses)}; "
          f"walls {', '.join(f'{w:.3f}' for w in walls)} s")
    print(f"{phase} profile (one step) [{card}]: {prof}")
    print(f"{phase}: refusals: " + "; ".join(refused) + "; K6 under grad "
          f"differentiates through one launch of its backward")
    if resume is not None:
        print(f"{phase}: {resume_cfg.name} died at step {RESUME_DIE}, "
              f"resumed from {RESUME_EVERY}: final parameters "
              + ("bitwise those of the uninterrupted run" if resume["bitwise"]
                 else f"{resume['rel']:.3e} from the uninterrupted run's "
                      f"(not bitwise; bar 1e-5)"))
    return {"held": held, "first": first, "full": full,
            "launches_per_step": per_step[0], "launches": launched,
            "step_s": step_s, "tokens_per_s": batch * seq / step_s,
            "mfu": mfu, "peak": peak, "update_s": upd_s, "losses": losses,
            "masked": masked, "refused": refused, "k6_grad": k6_grad,
            "resume_bitwise": bool(resume and resume["bitwise"]),
            "planted_fails": all(not r["planted"] <= r["bar"]
                                 for r in (first, full))}

# -- the fourteenth slice: the mesh planner ---------------------------------

@contextlib.contextmanager
def one_rank_group(backend: str):
    """A world-size-1 ``backend`` process group (FileStore rendezvous in a
    temporary directory) inside the block, destroyed after it."""
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, store=dist.FileStore(
            str(Path(d) / "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def lm_mesh_phase(torch, np, dev, cfg, batch: int = MESH_BATCH,
                  seq: int = MESH_SEQ, n_steps: int = MESH_STEPS,
                  serve: tuple = (SERVE_BATCH, SERVE_PROMPT, SERVE_FORCED),
                  backend: str = "nccl", card: str = "",
                  cut: str = "", parts=("grad", "serve", "score", "train")
                  ) -> dict:
    """The mesh planner's sharded steps (ROADMAP A13d) on ``cfg`` against
    the unsharded ones, on a (1, 1) ("data", "model") mesh over a
    world-size-1 ``backend`` group, for the ``parts`` asked: (grad) step
    1's loss, global gradient norm and every gradient, K7 and its backward
    launched as often on both routes; (serve) prefill ``serve[0]`` ×
    ``serve[1]`` (with the model's image or frame inputs) and ``serve[2]``
    forced decode steps, the logits of each, launches equal; (score) a
    scoring forward on K5's route (``attention_impl="pallas"``), logits,
    launches equal, K5 (or for Mamba2 K6) once a layer; (train)
    ``n_steps`` AdamW steps on each route in turn, each on a model of its
    own built after the others are freed (8-bit moments for bf16
    parameters, as ``run_training`` picks): the losses and the updated
    parameters, ms per step (median of the steps after the first),
    launches per step equal, peak memory.  Every compared value must be
    equal bit for bit (on one device the sharded route runs the same local
    ops); the largest relative gap is printed beside it.  The sharded
    route's launch counts are set to 0 just before each of its runs and
    read just after."""
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.launch.shardings import shard_cache, shard_model
    from repro_torch.models.sharding import distribute, logical_spec, plain
    from repro_torch.train import steps
    from repro_torch.train.optim import AdamWConfig, adamw_init
    phase = f"lm_mesh {cfg.name}"
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(SEED + 26)
    data = [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                                device=dev) for k in ("tokens", "labels")}
            for _ in range(n_steps)]
    B, S_, F_ = serve
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S_)),
                              device=dev)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab, (B, F_)), device=dev)
    extras = model_extras(torch, cfg, B, dev)
    out = {"launches": {}}

    def peak_reset():
        if cuda:
            sync(torch, dev)
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda \
            else float("nan")

    def counted(fn):
        sync(torch, dev)
        reset_lm_launches()
        t = time.perf_counter()
        res = fn()
        sync(torch, dev)
        return res, dict(lm_launches()), time.perf_counter() - t

    def held(what, got, want):
        """(largest relative gap, bit for bit equal) of ``got`` vs
        ``want``; checked to be equal."""
        gap = rel_err(got, want)[0]
        same = bool(torch.equal(got, want))
        check(same, f"{phase}: {what} not bitwise the unsharded route's "
                    f"(gap {gap:.3e})")
        return gap, same

    def serve_run(model, shard=None):
        logits, ws = [], []
        with torch.no_grad():
            cache = model.init_cache(B, S_ + F_)
            if shard is not None:
                cache = shard_cache(cache, model.cache_specs(), shard)
            pre = steps.make_prefill_step(model, model.cfg)
            dec = steps.make_decode_step(model, model.cfg)
            sync(torch, dev)
            t = time.perf_counter()
            lg, cache = pre({"tokens": prompts, **extras}, cache)
            logits.append(plain(lg))
            sync(torch, dev)
            ws.append(time.perf_counter() - t)
            for i in range(F_):
                t = time.perf_counter()
                _, lg, cache = dec(cache, S_ + i, forced[:, i:i + 1])
                logits.append(plain(lg))
                sync(torch, dev)
                ws.append(time.perf_counter() - t)
        return torch.cat(logits, dim=1), ws

    def score_run(model, shard=None):
        saved = model.cfg
        model.cfg = saved.replace(attention_impl="pallas")
        tokens = data[0]["tokens"]
        if shard is not None:       # the rows over the batch axes
            tokens = distribute(tokens, logical_spec("batch", None), shard)
        try:
            with torch.no_grad():
                return plain(model({"tokens": tokens})[0])
        finally:
            model.cfg = saved

    t_phase = time.perf_counter()
    with one_rank_group(backend):
        mesh = make_mesh((1, 1), ("data", "model"), dev)

        def build(route):
            model = seeded_model(torch, cfg, dev)
            if route == "sharded":
                with use_mesh(mesh):
                    build.specs = shard_model(model, mesh)
            return model

        t0 = time.perf_counter()
        flat, sharded = build("unsharded"), build("sharded")
        sync(torch, dev)
        setup_s = time.perf_counter() - t0
        specs = build.specs
        n_split = sum(any(e is not None for e in sp) for sp in specs.values())

        if "grad" in parts:         # step 1's gradients
            peak_reset()
            (l0, _, g0), k_flat, gw0 = counted(
                lambda: steps.make_grad_fn(flat, cfg)(data[0]))
            grad_peak0 = peak_gib()
            peak_reset()
            with use_mesh(mesh):
                (l1, _, g1), k_mesh, gw1 = counted(
                    lambda: steps.make_grad_fn(sharded, cfg)(data[0]))
            grad_peak1 = peak_gib()
            g1 = {n: plain(g) for n, g in g1.items()}
            n0, n1, gap, same = grad_gaps(torch, g1, g0)
            grad = {"loss": abs(float(plain(l1)) - float(l0))
                    / abs(float(l0)),
                    "grad_norm": abs(n1 - n0) / n0, "grads": gap}
            same = same and float(plain(l1)) == float(l0)
            del g0, g1
            check(same, f"{phase}: step 1 not bitwise the unsharded route's "
                        f"({grad})")
            check(k_mesh == k_flat and k_mesh["rmsnorm"] > 0
                  and k_mesh["rmsnorm_bwd"] > 0,
                  f"{phase}: step 1's launches {k_mesh}, unsharded {k_flat}")
            out.update(grad=grad, bitwise=same, grad_ms=gw1 * 1e3,
                       grad_ms_unsharded=gw0 * 1e3, grad_peak=grad_peak1,
                       grad_peak_unsharded=grad_peak0)
            out["launches"]["grad"] = k_mesh
            print(f"{phase}{cut} [{card}]: step 1 vs the unsharded route: "
                  f"loss {grad['loss']:.3e}, gradient norm "
                  f"{grad['grad_norm']:.3e}, gradients {grad['grads']:.3e} "
                  f"(bitwise equal: {same}); launches "
                  f"{k_mesh} (unsharded {k_flat}); forward + backward of "
                  f"{batch} x {seq} tokens {gw1 * 1e3:.2f} ms (unsharded "
                  f"{gw0 * 1e3:.2f}, the first call on each route); peak "
                  f"{grad_peak1:.2f} GiB (unsharded {grad_peak0:.2f})")

        if "serve" in parts:
            peak_reset()
            (want, walls0), s_flat, _ = counted(lambda: serve_run(flat))
            serve_peak0 = peak_gib()
            peak_reset()
            with use_mesh(mesh):
                (got, walls1), s_mesh, _ = counted(
                    lambda: serve_run(sharded, mesh))
            serve_peak1 = peak_gib()
            gap, same = held("prefill + decode logits", got, want)
            check(s_mesh == s_flat and s_mesh["rmsnorm"] > 0,
                  f"{phase}: serving launches {s_mesh}, unsharded {s_flat}")
            del want, got
            out.update(serve_gap=gap, serve_bitwise=same, serve={
                "prefill_ms": walls1[0] * 1e3,
                "prefill_ms_unsharded": walls0[0] * 1e3,
                "decode_ms": statistics.median(walls1[1:]) * 1e3,
                "decode_ms_unsharded": statistics.median(walls0[1:]) * 1e3,
                "peak": serve_peak1, "peak_unsharded": serve_peak0})
            out["launches"]["serve"] = s_mesh
            print(f"{phase}{cut} [{card}]: prefill {B} x {S_} + {F_} decode "
                  f"steps: logits {gap:.3e} from the unsharded route "
                  f"(bitwise equal: {same}); launches {s_mesh} (unsharded "
                  f"{s_flat}); prefill {walls1[0] * 1e3:.2f} ms (unsharded "
                  f"{walls0[0] * 1e3:.2f}), decode "
                  f"{statistics.median(walls1[1:]) * 1e3:.2f} ms/step "
                  f"(unsharded {statistics.median(walls0[1:]) * 1e3:.2f}); "
                  f"peak {serve_peak1:.2f} GiB (unsharded "
                  f"{serve_peak0:.2f})")

        if "score" in parts:        # a scoring forward on K5's route
            want, f_flat, w0 = counted(lambda: score_run(flat))
            with use_mesh(mesh):
                got, f_mesh, w1 = counted(lambda: score_run(sharded, mesh))
            gap, same = held("scoring logits", got, want)
            del want, got
            kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
            check(f_mesh == f_flat and f_mesh[kernel] == cfg.n_layers
                  and f_mesh["rmsnorm"] > 0,
                  f"{phase}: scoring launches {f_mesh}, unsharded {f_flat}")
            out.update(score_gap=gap, score_bitwise=same,
                       score_ms=w1 * 1e3, score_ms_unsharded=w0 * 1e3)
            out["launches"]["score"] = f_mesh
            print(f"{phase}{cut} [{card}]: scoring forward {batch} x {seq} "
                  f"on K5's route: logits {gap:.3e} from the unsharded route"
                  f" (bitwise equal: {same}); launches {f_mesh} (unsharded "
                  f"{f_flat}); {w1 * 1e3:.2f} ms (unsharded "
                  f"{w0 * 1e3:.2f})")

        del flat, sharded
        if "train" in parts:        # each route in turn, one copy at a time
            train, after = {}, {}
            bits8 = cfg.param_dtype == "bfloat16"
            for name in ("unsharded", "sharded"):
                if cuda:
                    torch.cuda.empty_cache()
                model = build(name)
                ctx = use_mesh(mesh) if name == "sharded" else \
                    contextlib.nullcontext()
                with ctx:
                    opt_cfg = AdamWConfig(lr=TRAIN_LR, bits8=bits8)
                    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
                    step = steps.make_train_step(model, cfg, opt_cfg)
                    peak_reset()
                    ws, per_step, losses = [], [], []
                    for b in data:
                        sync(torch, dev)
                        reset_lm_launches()
                        t = time.perf_counter()
                        opt, met = step(opt, b)
                        losses.append(float(met["loss"]))
                        sync(torch, dev)
                        ws.append(time.perf_counter() - t)
                        per_step.append(dict(lm_launches()))
                    train[name] = {"ms": statistics.median(ws[1:] or ws)
                                   * 1e3, "walls": ws,
                                   "launches": per_step, "losses": losses,
                                   "peak": peak_gib()}
                    del opt, step
                # the updated parameters: the unsharded route's to the host,
                # the sharded route's held against them leaf by leaf
                if name == "unsharded":
                    after = {n: p.detach().cpu()
                             for n, p in model.named_parameters()}
                else:
                    differ = [n for n, p in model.named_parameters()
                              if not torch.equal(plain(p.detach()).cpu(),
                                                 after[n])]
                del model
            del after
            check(train["sharded"]["launches"]
                  == train["unsharded"]["launches"],
                  f"{phase}: launches per step "
                  f"{train['sharded']['launches']}, unsharded "
                  f"{train['unsharded']['launches']}")
            check(all(np.isfinite(train["sharded"]["losses"])),
                  f"{phase}: non-finite losses {train['sharded']['losses']}")
            check(train["sharded"]["losses"] == train["unsharded"]["losses"],
                  f"{phase}: losses {train['sharded']['losses']} not "
                  f"bitwise {train['unsharded']['losses']}")
            check(not differ, f"{phase}: after {n_steps} steps the "
                              f"parameters {differ[:4]} are not bitwise the "
                              f"unsharded route's")
            out["train"] = train
            out["launches"]["step"] = train["sharded"]["launches"][0]
            for name, r in train.items():
                print(f"{phase} [{card}]: {name} train step {r['ms']:.2f} ms"
                      f" (median of steps 2-{n_steps} of {batch} x {seq} "
                      f"tokens{', 8-bit moments' if bits8 else ''}); "
                      f"launches per step {r['launches'][0]}; peak "
                      f"{r['peak']:.2f} GiB (this route's copy alone); "
                      f"losses {', '.join(f'{v:.4f}' for v in r['losses'])};"
                      f" walls {', '.join(f'{w:.3f}' for w in r['walls'])} s")
            print(f"{phase} [{card}]: after {n_steps} AdamW steps every "
                  f"parameter and every loss bitwise the unsharded route's")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"{phase}{cut} [{card}]: (1, 1) (data, model) mesh over a "
          f"world-size-1 {backend} group; set-up {setup_s:.1f} s; {n_split} "
          f"of {len(specs)} parameters carry a split spec; phase wall "
          f"{out['wall_s']:.1f} s")
    return out


def grad_gaps(torch, got: dict, want: dict,
              chunk: int = 1 << 26) -> tuple[float, float, float, bool]:
    """(the global norm of ``got``, of ``want``, the largest relative gap
    of a leaf — max |got − want| / max |want| — and whether every leaf is
    equal bit for bit), in float64 over slices of ``chunk`` elements so
    that a leaf of billions of elements (an MoE layer's experts) needs no
    float64 copy of itself."""
    sq_got = sq_want = 0.0
    gap, same = 0.0, True
    for name, w in want.items():
        g = got[name]
        same = same and bool(torch.equal(g, w))
        err = top = 0.0
        for a, b in zip(g.reshape(-1).split(chunk),
                        w.reshape(-1).split(chunk)):
            a, b = a.double(), b.double()
            sq_got += float(torch.sum(a * a))
            sq_want += float(torch.sum(b * b))
            err = max(err, float((a - b).abs().max()))
            top = max(top, float(b.abs().max()))
        if w.numel():
            gap = max(gap, err / max(top, 1e-30))
    return sq_got ** 0.5, sq_want ** 0.5, gap, same


def start_dryrun(cell=DRYRUN_CELL, layers: int = DRYRUN_LAYERS):
    """``python -m repro_torch.launch.dryrun`` of ``cell`` (arch, shape,
    mesh, variant) at ``layers`` started in a child process on the host
    (its own ``fake`` process group, no card): (the process, its start
    time, the cell, the layers)."""
    arch, shape, mesh, variant = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--json", "--layers",
           str(layers), "--variant", variant]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter(), cell, layers


def mesh_dryrun_phase(started, card: str = "") -> dict:
    """The dry run :func:`start_dryrun` ``started`` (so that it runs on the
    host beside the card's phases): prints the record's per-device bytes,
    ``fits``, the roofline terms, the collective summary,
    ``choose_layout``'s pick and the dry run's own wall time, which must
    stay under ``DRYRUN_WALL``."""
    proc, t0, (arch, shape, mesh, variant), layers = started
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"mesh_dryrun: exit {proc.returncode}: "
                                f"{err[-2000:]}")
    rec = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    m, roof, a = rec["memory"], rec["roofline"], rec["autoshard"]
    check(roof["compute_s"] > 0 and roof["memory_s"] > 0
          and rec["collectives"]["total_wire_bytes"] > 0,
          f"mesh_dryrun: empty terms {roof} or no collectives")
    cut = f" (cut to {layers} of {rec['layers_published']} layers)"
    arch = f"{arch} x {shape} x {mesh}" + (f" [{variant}]" if variant else "")
    print(f"mesh_dryrun {arch}{cut}: {rec['chips']} fake "
          f"ranks; per device: parameters {m['param_bytes'] / 1e9:.4f} GB, "
          f"optimizer {m['opt_bytes'] / 1e9:.4f} GB, inputs "
          f"{m['input_bytes'] / 1e9:.6f} GB, step's live peak "
          f"{m['temp_bytes'] / 1e9:.4f} GB, peak {m['peak_bytes'] / 1e9:.4f}"
          f" GB, fits 80 GB: {m['fits_80GB']}")
    print(f"mesh_dryrun roofline (estimates for H100 constants, not "
          f"measured): compute {roof['compute_s']:.6f} s, memory "
          f"{roof['memory_s']:.6f} s, collective {roof['collective_s']:.6f}"
          f" s, dominant {roof['dominant']}, mfu_bound "
          f"{roof['mfu_bound']:.4f}; counted FLOPs/device "
          f"{rec['hlo_flops_per_device']:.4e}, bytes/device "
          f"{rec['hlo_bytes_per_device']:.4e}; effective {rec['effective']}")
    print(f"mesh_dryrun collectives per device: {rec['collectives']}; the "
          f"loss alone (a microbatch): {rec['loss']}")
    print(f"mesh_dryrun choose_layout for {rec['chips']} devices (estimate "
          f"for H100 constants): dp {a['dp']} x tp {a['tp']}, vocab-parallel "
          f"CE {a['vocab_parallel_ce']}, remat {a['remat']}, step "
          f"{a['step_time_s']:.6f} s ({a['dominant']}); dry run wall "
          f"{rec['wall_s']:.1f} s in the child (build {rec['build_s']:.1f} "
          f"s, warm-up {rec['trace_s']:.1f} s, counted run "
          f"{rec['count_s']:.1f} s; {wall:.1f} s from its start to its "
          f"record here) [{card}]")
    check(rec["wall_s"] <= DRYRUN_WALL, f"mesh_dryrun: wall "
          f"{rec['wall_s']:.1f} s over {DRYRUN_WALL} s: cut the depth")
    if variant.startswith("moe_ep="):   # the tokens cross to their experts
        check(rec["collectives"]["counts"].get("all-to-all", 0) > 0,
              f"mesh_dryrun: {arch} moved no tokens by all-to-all")
    return {"record": rec, "wall_s": wall}


# -- the eleventh slice: the perf record, the build hooks --------------------

def hook_overhead_phase(torch, dispatch_fn, samples: int = HOOK_SAMPLES,
                        calls: int = HOOK_CALLS) -> dict:
    """The reference's disabled-telemetry gate (``benchmarks/bench_obs.py``,
    ``MAX_DISABLED_OVERHEAD``) for the port's counting hooks, on a hot loop
    whose cost is the host's (as the reference's ``score_batch`` loop): with
    no counter open and the build hooks disarmed, ``dispatch_fn`` costs at
    most 5 % more than with every hook site stubbed out (``kernel_scope`` a
    bare null context, the wrappers' ``counts`` without a counter list to
    read).  After a warm-up, samples alternate between the two in pairs
    whose order flips, with the garbage collector off; each is ``calls``
    calls and one synchronization; the medians are compared."""
    import types

    from repro_torch.kernels import dispatch
    from repro_torch.kernels import edge_latency as el
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.obs import kernelhooks
    from repro_torch.perf import counts

    check(not counts.ACTIVE, "hook_overhead: a counter is open")
    kernelhooks.disarm()
    null = contextlib.nullcontext()
    stub = types.SimpleNamespace(ACTIVE=(), report_kernel=None)
    mods = (el, fa, rk, sk)

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            dispatch_fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def stubbed() -> float:
        saved = dispatch.kernel_scope, [m.counts for m in mods]
        dispatch.kernel_scope = lambda name: null
        for m in mods:
            m.counts = stub
        try:
            return timed()
        finally:
            dispatch.kernel_scope = saved[0]
            for m, c in zip(mods, saved[1]):
                m.counts = c

    for _ in range(3):
        timed()
    hooked, control = [], []
    pair = ((hooked, timed), (control, stubbed))
    gc.disable()        # a collection inside one sample dwarfs the effect
    try:
        # the order flips every pair, so a drift of the host's speed over
        # the run falls on both alike
        for i in range(samples):
            for out, sample in (pair if i % 2 == 0 else pair[::-1]):
                out.append(sample())
    finally:
        gc.enable()
    # what the gate can see: the disarmed hook sites alone, on the host
    t0 = time.perf_counter()
    for _ in range(calls):
        with dispatch.kernel_scope("rmsnorm"):
            if rk.counts.ACTIVE:
                pass
    sites = (time.perf_counter() - t0) / calls
    ratio = statistics.median(hooked) / statistics.median(control)
    check(ratio <= 1.0 + MAX_DISABLED_OVERHEAD,
          f"hook_overhead: disarmed hooks cost {ratio - 1:.2%} > "
          f"{MAX_DISABLED_OVERHEAD:.0%}")
    print(f"hook_overhead: {samples} alternating samples of {calls} "
          f"calls: disarmed hooks "
          f"{statistics.median(hooked) / calls * 1e6:.3f} us a call, no hooks "
          f"{statistics.median(control) / calls * 1e6:.3f} us; ratio "
          f"{ratio:.4f} (bar {1 + MAX_DISABLED_OVERHEAD}); the disarmed "
          f"hook sites alone {sites * 1e6:.3f} us a call")
    return {"ratio": ratio, "hooked": hooked, "control": control,
            "sites_s": sites}


def print_record(name: str, rec: dict, extra: str = "") -> None:
    """One perf record's line: counted FLOPs and bytes, the roofline row's
    useful fraction and bound, the measured roofline fraction."""
    row = rec["roofline"]
    print(f"perf_record {name}: counted {rec['counted_flops']:.6e} FLOPs, "
          f"{rec['counted_bytes']:.6e} bytes; model {row['model_flops']:.6e}"
          f" FLOPs, useful fraction {row['useful_fraction']:.4f}; bound "
          f"{row['step_time_s'] * 1e3:.4f} ms ({row['dominant']}), "
          f"mfu_bound {row['mfu_bound']:.4f}; measured "
          f"{rec['measured_s'] * 1e3:.4f} ms, roofline fraction "
          f"{rec['roofline_fraction']:.4f}; builds in the timed region "
          f"{rec['n_recompiles']}" + extra)


def perf_dispatch_phase(torch, np, dev, ev, packed, pack, dq, beta) -> dict:
    """The perf record of one serve_dense dispatch (``score_grid`` of the
    served rows against the S-scenario pack: S K1 launches) on the card,
    its K1 FLOPs against the plain version's count at the launch shape on
    the meta device (shapes without data): equal, since both
    count ``2·B·E·V²``."""
    from repro_torch.kernels import edge_latency as el
    from repro_torch.kernels import ref
    from repro_torch.obs import bench, kernelhooks, perfbridge
    from repro_torch.perf import counts

    shapes = []
    kernel = el.edge_latency_dense

    def recorded(x_i, x_j, com, config=None):
        shapes.append((tuple(x_i.shape), tuple(com.shape)))
        return kernel(x_i, x_j, com, config=config)

    def fn():
        return ev.score_grid(packed, pack, dq=dq, beta=beta)

    snap = kernelhooks.snapshot()
    timing = bench.measure(fn, n=5, warmup=1)
    el.edge_latency_dense = recorded
    try:
        rec = perfbridge.perf_record(fn, measured_s=timing.seconds,
                                     compile_snapshot=snap)
    finally:
        el.edge_latency_dense = kernel
    k1 = rec["kernels"].get("edge_latency_dense", {})
    check(k1.get("launches", 0) == len(shapes) > 0,
          f"perf_record serve_dense: {k1} reported for {len(shapes)} K1 "
          f"launches")
    plain = 0.0
    for (B, E, V), (bc, _, _) in shapes:
        meta = [torch.empty(s, device="meta") for s in
                ((B, E, V), (B, E, V), (bc, V, V))]
        plain += counts.analyze_call(ref.edge_latency_dense_plain,
                                     tuple(meta)).flops
    check(k1["flops"] == plain,
          f"perf_record serve_dense: K1 reported {k1['flops']:.6e} FLOPs, "
          f"its plain version counts {plain:.6e} (bar: equal)")
    print_record("serve_dense", rec,
                 f"; K1 {k1['launches']} launches at {shapes[0]}, reported "
                 f"{k1['flops']:.6e} FLOPs == the plain version's count on "
                 f"the meta device")
    return rec


def perf_lm_phase(torch, np, dev, cfg, rows: int, seq: int) -> dict:
    """The perf record of one lm_score shard (the forward of ``rows`` ×
    ``seq`` tokens) of ``cfg`` (K5's route for attention) on the card, and
    its count against the plain (CPU) route's count of the same shard on
    fake CPU tensors (``counts.without_data``: shapes, no data).  Bars,
    each with its reason:

    * everything outside the kernels (the GEMMs, the head) equal: the same
      aten ops at the same shapes;
    * K5: the card reports the causal half, S(S+1)/2 (query, key) pairs
      per head, where the plain version multiplies all S²: card / plain =
      (S+1)/(2S) within 1e-9;
    * K6: the card reports the lower-triangular M·x, Q(Q+1)·H·P a chunk,
      where the plain version multiplies the full Q²: card = plain −
      layers·b·n·(Q²−Q)·H·P, exact where torch runs the plain version's
      three-operand state-update einsum's outer product elementwise (as
      2.13 does); the bar admits that outer product as one more product,
      layers·b·n·2Q·H·max(N, P), should the card's torch pick a path that
      routes it through a bmm;
    * K7: its four operations a row element are elementwise, which
      FlopCounterMode counts as 0: the launches equal the plain calls.

    It prints the counted and analytic FLOPs, bytes, the useful fraction,
    ``mfu_bound``, the measured model-FLOPs share of the bf16 tensor-core
    peak and the roofline fraction."""
    from repro_torch.models import analytic_flops, build_model
    from repro_torch.obs import bench, kernelhooks, perfbridge
    from repro_torch.perf import counts
    from repro_torch.perf.roofline import PEAK_BF16_TC

    name = f"lm_score {cfg.name}" + (f" ({cfg.n_layers} layers)"
                                      if cfg.moe_experts else "")
    model = seeded_model(torch, cfg, dev)
    rng = np.random.default_rng(SEED + 7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (rows, seq),
                                        dtype=np.int32), device=dev)
    model_flops = analytic_flops(cfg, seq, rows, mode="prefill")
    with torch.inference_mode():
        def fn():
            return model({"tokens": toks})
        snap = kernelhooks.snapshot()
        timing = bench.measure(fn, n=3, warmup=1)
        rec = perfbridge.perf_record(fn, measured_s=timing.seconds,
                                     model_flops=model_flops,
                                     compile_snapshot=snap)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with counts.without_data(), torch.inference_mode():
        host = build_model(cfg, device="cpu")
        cpu = counts.analyze_call(host, ({"tokens": torch.zeros(
            (rows, seq), dtype=torch.int32)},))
        del host
    card_k, cpu_k = rec["kernels"], cpu.kernels
    check(set(card_k) == set(cpu_k),
          f"perf_record {name}: kernels {sorted(card_k)} on the card, "
          f"{sorted(cpu_k)} on the plain route")
    for k in card_k:
        check(card_k[k]["launches"] == card_k[k]["calls"] == cpu_k[k]["calls"]
              > 0, f"perf_record {name}: {k} launched "
                   f"{card_k[k]['launches']} times in {card_k[k]['calls']} "
                   f"calls, plain route {cpu_k[k]['calls']} calls")
    rest_card = rec["counted_flops"] - sum(k["flops"] for k in card_k.values())
    rest_cpu = cpu.flops - sum(k["flops"] for k in cpu_k.values())
    check(rest_card == rest_cpu,
          f"perf_record {name}: outside the kernels {rest_card:.6e} FLOPs "
          f"on the card, {rest_cpu:.6e} on the plain route (bar: equal)")
    notes = []
    if "flash_attention" in card_k:
        want = (seq + 1) / (2 * seq)
        got = card_k["flash_attention"]["flops"] \
            / cpu_k["flash_attention"]["flops"]
        check(abs(got / want - 1) <= 1e-9,
              f"perf_record {name}: K5 card / plain FLOPs {got:.9f}, want "
              f"the causal half (S+1)/(2S) = {want:.9f}")
        notes.append(f"K5 card/plain {got:.6f} (causal half {want:.6f})")
    if "ssd_scan" in card_k:
        Q = min(cfg.ssm_chunk, seq)
        n = -(-seq // Q)
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        per = cfg.n_layers * rows * n
        plain = cpu_k["ssd_scan"]["flops"]
        want = plain - per * (Q * Q - Q) * H * P
        got = card_k["ssd_scan"]["flops"]
        bar = per * 2 * Q * H * max(N, P)
        check(abs(got - want) <= bar,
              f"perf_record {name}: K6 reported {got:.6e} FLOPs, want the "
              f"plain count less the upper triangle {want:.6e} (bar "
              f"{bar:.6e})")
        notes.append(f"K6 card {got:.6e} vs plain less the upper triangle "
                     f"{want:.6e} ({abs(got - want) / plain:.3%} of plain)")
    if cfg.moe_experts:
        from repro_torch.models.moe import capacity
        _, n_grp, cap = capacity(cfg, rows * seq)
        slots = cfg.moe_experts * cap * n_grp
        pairs = rows * seq * cfg.moe_top_k
        notes.append(f"MoE: {slots} expert slots a layer for {pairs} "
                     f"(token, choice) pairs ({slots / pairs:.4f}x: capacity"
                     f" factor {cfg.moe_capacity_factor} and the padded "
                     f"last group), each slot multiplied filled or not, "
                     f"where the analytic count charges top-"
                     f"{cfg.moe_top_k} experts a token")
    if "rmsnorm" in card_k:
        check(cpu_k["rmsnorm"]["flops"] == 0,
              f"perf_record {name}: K7's plain version counted "
              f"{cpu_k['rmsnorm']['flops']} matmul FLOPs")
        notes.append(f"K7 {card_k['rmsnorm']['launches']} launches == plain "
                     f"calls")
    share = model_flops / (PEAK_BF16_TC * timing.seconds)
    tokens_s = rows * seq / timing.seconds
    print_record(name, rec,
                 f"; {rows} x {seq} tokens, {tokens_s:.0f} tokens/s; "
                 f"measured model-FLOPs share {share:.4f} of "
                 f"{PEAK_BF16_TC / 1e12:.0f} TFLOP/s; plain-route count "
                 f"{cpu.flops:.6e} FLOPs, outside the kernels equal; "
                 + "; ".join(notes))
    return {"record": rec, "share": share, "tokens_s": tokens_s,
            "cpu_flops": cpu.flops}


def compile_span_phase(torch, dev) -> dict:
    """A span around K7's first use in a fresh build directory (the other
    libraries copied in, so only ``rmsnorm.cu`` builds) records the build
    and the load in ``compile_s`` / ``n_compiles``, ``obs.bench.measure``
    around it reports them as ``n_recompiles``, and a span around a later
    call records none.  The build directory, the loaded library and the
    telemetry switch are restored after it."""
    import shutil

    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.obs import bench, kernelhooks

    x = torch.randn((64, 2048), device=dev).to(torch.bfloat16)
    w = torch.ones(2048, device=dev)
    rk.rmsnorm(x, w)
    fresh = build.BUILD_DIR / f"fresh-{SEED}"
    shutil.rmtree(fresh, ignore_errors=True)
    fresh.mkdir(parents=True)
    for f in build.BUILD_DIR.iterdir():
        if f.is_file() and not f.name.startswith("rmsnorm-"):
            shutil.copy2(f, fresh / f.name)
    saved = build.BUILD_DIR, build._libs.pop("rmsnorm"), rk._bound, \
        obs.enabled()
    build.BUILD_DIR, rk._bound = fresh, None
    obs.enable()
    kernelhooks.install()
    try:
        with obs.span("kernel_first_use") as first:
            timing = bench.measure(lambda: first.sync(rk.rmsnorm(x, w)),
                                   n=1, warmup=0)
        with obs.span("kernel_later_use") as later:
            later.sync(rk.rmsnorm(x, w))
        builds = obs.registry().value("kernels.builds")
    finally:
        build.BUILD_DIR, rk._bound = saved[0], saved[2]
        build._libs["rmsnorm"] = saved[1]
        if not saved[3]:
            obs.disable()
        shutil.rmtree(fresh, ignore_errors=True)
    check(first.compile_s > 0 and first.n_compiles == 2,
          f"compile_span: first use recorded compile_s {first.compile_s}, "
          f"{first.n_compiles} builds/loads (want > 0 and 2)")
    check(timing.n_recompiles == 2 and timing.compile_s > 0,
          f"compile_span: bench.measure reported {timing.n_recompiles} "
          f"builds/loads in {timing.compile_s} s")
    check(later.compile_s == 0.0 and later.n_compiles == 0,
          f"compile_span: a later call recorded compile_s {later.compile_s}")
    check(builds >= 2, f"compile_span: kernels.builds counter {builds}")
    print(f"compile_span: K7's first use in a fresh build directory: span "
          f"wall {first.wall_s:.3f} s, compile_s {first.compile_s:.3f} s "
          f"(nvcc + load, n_compiles {first.n_compiles}), execute_s "
          f"{first.execute_s:.4f} s; bench.measure n_recompiles "
          f"{timing.n_recompiles}; a later call compile_s "
          f"{later.compile_s}; registry kernels.builds {builds:.0f}")
    return {"first": first.compile_s, "later": later.compile_s}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.devices import ExplicitFleet, RegionFleetFamily
    from repro_torch.core.graph import random_dag
    from repro_torch.core.torchmodel import (edge_endpoints, region_factors,
                                             region_mass, region_onehot)
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.perf.roofline import (PEAK_TF32_TC,
                                           edge_latency_dense_terms)
    from repro_torch.search.decision import joint_dq_scores
    from repro_torch.serve import (AdmissionConfig, QueryResult, WhatIfQuery,
                                   WhatIfService)
    from repro_torch.sim import BatchedEvaluator

    dev = torch.device(DEVICE)

    # -- 1. the card and the build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for "
          + ", ".join(f"{r.path.name} (nvcc {r.seconds:.1f} s)"
                      for r in built))
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    resources = {}
    for r in built:
        sass = subprocess.run([str(cuobjdump), "-sass", str(r.path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        resources[r.name] = kernel_resources(r.log, sass)
        for k, use in resources[r.name].items():
            tc = ", ".join(f"{op} {n}" for op, n in use.items()
                           if op != "remarks" and op.isupper() and n)
            print(f"  ptxas[{r.name}] {k}: {use['registers']} registers, "
                  f"{use['spill_bytes']} spill bytes"
                  + (f"; SASS {tc}" if tc else "")
                  + "".join(f"; {m}" for m in use["remarks"]))
    print("kernels: " + "; ".join(
        f"{k} (cuda, {SOURCES[k]}, replaces {REPLACES[k]})"
        for k in SOURCES))
    # phase 16d's dry runs need no card: they run on the host from here on
    dryruns = [start_dryrun(), start_dryrun(DRYRUN_MOE_CELL,
                                            DRYRUN_MOE_LAYERS)]

    # -- the serving instance (shared with the kernel phase's shapes) -------
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    graph = random_dag(N_OPS, EDGE_PROB, rng)
    E = graph.n_edges
    print(f"instance: random_dag({N_OPS}, {EDGE_PROB}) with E = {E} edges; "
          f"dense V = {DENSE_V}, S = {S}, P = {sum(DENSE_ROWS)}; structured "
          f"V = {STRUCT_V}, R = {STRUCT_R}, S = {S}, P = {sum(STRUCT_ROWS)}")
    region_d = rng.integers(0, 8, DENSE_V)
    base = rng.uniform(0.5, 4.0, (8, 8))
    base = (base + base.T) / 2
    np.fill_diagonal(base, 0.1)
    dense_pack = np.empty((S, DENSE_V, DENSE_V), np.float32)
    for s in range(S):      # region costs with per-link lognormal jitter
        c = base[region_d][:, region_d] * rng.lognormal(
            0.0, 0.25, (DENSE_V, DENSE_V))
        np.fill_diagonal(c, 0.0)
        dense_pack[s] = c
    dense_x = placements(torch, gen, sum(DENSE_ROWS), N_OPS, DENSE_V, 0.05)
    inter = rng.uniform(0.5, 4.0, (S, STRUCT_R, STRUCT_R))
    inter = (inter + inter.transpose(0, 2, 1)) / 2
    degrade = np.where(rng.random((S, STRUCT_V)) < 0.05,
                       rng.uniform(1.5, 4.0, (S, STRUCT_V)), 1.0)
    fam = RegionFleetFamily(region=rng.integers(0, STRUCT_R, STRUCT_V),
                            inter=inter, degrade=degrade, self_cost=0.01)
    struct_x = placements(torch, gen, sum(STRUCT_ROWS), N_OPS, STRUCT_V,
                          0.01)
    src = torch.as_tensor([i for i, _ in graph.edges], device=dev)
    dst = torch.as_tensor([j for _, j in graph.edges], device=dev)
    sel = torch.as_tensor([graph.operators[i].selectivity
                           for i, _ in graph.edges], dtype=torch.float32,
                          device=dev)

    # -- 2. kernels against their plain versions ------------------------------
    def hold(name, kernel, plain, args, what):
        out = kernel(*args)
        again = kernel(*args)
        want = plain(*(a.double() for a in args))
        torch.cuda.synchronize()
        rel, err = rel_err(out, want)
        check(out.shape == want.shape, f"{name} {what}: shape {out.shape}")
        check(rel <= REL, f"{name} {what}: rel err {rel:.3e} > {REL}")
        check(torch.equal(out, again), f"{name} {what}: repeat launch differs")
        return rel, err

    cases = 0
    worst = {k: 0.0 for k in kernels.KERNELS}
    for V in (7, 129, 300):
        for E_ in (1, 33, 130, 0):
            for shared in (True, False):
                B, bc = 3, 1 if shared else 3
                xi = torch.randn((B, E_, V), generator=gen, device=dev)
                xj = torch.randn((B, E_, V), generator=gen, device=dev)
                com = torch.randn((bc, V, V), generator=gen, device=dev)
                rel, _ = hold("edge_latency_dense",
                              kernels.edge_latency_dense,
                              ref.edge_latency_dense_plain, (xi, xj, com),
                              f"V={V} E={E_} shared={shared}")
                worst["edge_latency_dense"] = max(
                    worst["edge_latency_dense"], rel)
                cases += 1
                for R in (1, 8):
                    mass = torch.randn((B, E_, R), generator=gen, device=dev)
                    a = torch.randn((bc, R, V), generator=gen, device=dev)
                    corr = torch.randn((bc, 1, V), generator=gen, device=dev)
                    rel, _ = hold("edge_latency_structured",
                                  kernels.edge_latency_structured,
                                  ref.edge_latency_structured_plain,
                                  (xi, xj, mass, a, corr),
                                  f"V={V} E={E_} R={R} shared={shared}")
                    worst["edge_latency_structured"] = max(
                        worst["edge_latency_structured"], rel)
                    cases += 1
    # all-negative operands: a padded or skipped u column must never win
    V = 130
    xi = -torch.rand((2, 4, V), generator=gen, device=dev) - 0.5
    xj = torch.rand((2, 4, V), generator=gen, device=dev) + 0.5
    com = torch.rand((1, V, V), generator=gen, device=dev) + 0.5
    hold("edge_latency_dense", kernels.edge_latency_dense,
         ref.edge_latency_dense_plain, (xi, xj, com), "all-negative")
    check(float(kernels.edge_latency_dense(xi, xj, com).max()) < 0,
          "edge_latency_dense all-negative: a non-negative max")
    mass = torch.rand((2, 4, 8), generator=gen, device=dev)
    a = torch.rand((1, 8, V), generator=gen, device=dev)
    corr = torch.rand((1, 1, V), generator=gen, device=dev)
    hold("edge_latency_structured", kernels.edge_latency_structured,
         ref.edge_latency_structured_plain, (xi, xj, mass, a, corr),
         "all-negative")
    check(float(kernels.edge_latency_structured(xi, xj, mass, a, corr).max())
          < 0, "edge_latency_structured all-negative: a non-negative max")
    cases += 2
    print(f"kernels: {cases} small-shape cases within {REL} of float64 and "
          f"bitwise on repeat; worst rel err dense "
          f"{worst['edge_latency_dense']:.3e}, structured "
          f"{worst['edge_latency_structured']:.3e}")

    report = {}
    # K1 at the serving shape: the 1024-row chunk against one scenario
    x = torch.as_tensor(dense_x, device=dev)
    xi, xj = edge_endpoints(x, src, dst, sel)
    com = torch.as_tensor(dense_pack[:1], device=dev)
    rel, err = hold("edge_latency_dense", kernels.edge_latency_dense,
                    ref.edge_latency_dense_plain, (xi, xj, com),
                    "serving shape")
    B, V = xi.shape[0], xi.shape[2]
    # the route K1 takes (split TF32 on the tensor cores) and the FP32
    # CUDA-core route it replaced, for the same work
    terms = edge_latency_dense_terms(B, E, V, 1)
    fp32_terms = edge_latency_dense_terms(B, E, V, 1, route="fp32")
    report["edge_latency_dense"] = {
        "max_abs_err": err, "rel_err": rel,
        "ms": time_ms(lambda: kernels.edge_latency_dense(xi, xj, com), 5),
        "plain_ms": time_ms(
            lambda: ref.edge_latency_dense_plain(xi, xj, com), 5),
        "library_ms": time_ms(lambda: (xi * torch.einsum(
            "buv,bev->beu", com, xj)).amax(-1), 5),
        "flops": terms.flops, "bytes": terms.bytes,
        "bound_ms": terms.step_time_s * 1e3, "bound_by": terms.bound_by,
        "shape": f"B={B} E={E} V={V} com (1,V,V)"}
    print(f"edge_latency_dense route: split TF32 on the tensor cores, bound "
          f"{terms.step_time_s * 1e3:.3f} ms (3 TF32 products per "
          f"multiply-add at {PEAK_TF32_TC / 1e12:.0f} TFLOP/s); the FP32 "
          f"CUDA-core bound for the same work "
          f"{fp32_terms.step_time_s * 1e3:.3f} ms; rel err to float64 with "
          f"32-deep stage sums {rel:.3e} (bar {REL})")
    del x, xi, xj, com
    # K2 at the serving shape: the 256-row chunk against one scenario
    x = torch.as_tensor(struct_x, device=dev)
    xi, xj = edge_endpoints(x, src, dst, sel)
    region_ix = torch.as_tensor(fam.region, device=dev)
    inter0 = torch.as_tensor(fam.inter[:1], dtype=torch.float32, device=dev)
    deg0 = torch.as_tensor(fam.degrade[:1], dtype=torch.float32, device=dev)
    mass = region_mass(xj, deg0, region_onehot(region_ix, STRUCT_R))
    a, corr = region_factors(inter0, deg0, region_ix, fam.self_cost)
    corr = corr[:, None, :].contiguous()
    args = (xi, xj, mass, a, corr)
    rel, err = hold("edge_latency_structured",
                    kernels.edge_latency_structured,
                    ref.edge_latency_structured_plain, args, "serving shape")
    B, V, R = xi.shape[0], xi.shape[2], STRUCT_R
    flops = B * E * V * (2.0 * R + 3)
    bytes_ = 4.0 * (2 * B * E * V + B * E * R + R * V + V + B * E)
    report["edge_latency_structured"] = {
        "max_abs_err": err, "rel_err": rel,
        "ms": time_ms(lambda: kernels.edge_latency_structured(*args), 20),
        "plain_ms": time_ms(
            lambda: ref.edge_latency_structured_plain(*args), 5),
        "library_ms": None, "flops": flops, "bytes": bytes_,
        "bound_ms": max(flops / PEAK_FP32, bytes_ / HBM_BW) * 1e3,
        "bound_by": "operations" if flops / PEAK_FP32 > bytes_ / HBM_BW
        else "bytes", "shape": f"B={B} E={E} V={V} R={R} shared scenario"}
    del x, xi, xj, mass, a, corr, args
    torch.cuda.empty_cache()
    for k, r in report.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {k} [{r['shape']}]: {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.1%} of it), rel err "
              f"{r['rel_err']:.3e}, max abs err {r['max_abs_err']:.3e}")

    # -- 2b. K4a / K4b against K1 / K2 ----------------------------------------
    tile = single_tile_phase(torch, dev)
    report.update(tile["report"])
    torch.cuda.empty_cache()

    # -- 2c./2d. the block policy and the quality twin -------------------------
    block_policy_phase(torch, dev, card=smi)
    quality_phase(torch, np, dev)
    torch.cuda.empty_cache()

    # -- 3./4. the serving phases ---------------------------------------------
    def serve(phase, pack, xs, rows, kernel, oracle_fleet, same_rows):
        svc = WhatIfService(graph, device=dev,
                            admission=AdmissionConfig(p99_budget_s=1e6))
        fids = {svc.register_fleet(t, pack) for t in ("a", "b", "c")}
        check(len(fids) == 1, f"{phase}: equal packs got different ids")
        (fid,) = fids
        cuts = np.cumsum((0,) + rows)
        sl = [slice(int(cuts[i]), int(cuts[i + 1])) for i in range(3)]
        dqv = np.linspace(0.0, 1.0, 5)
        queries = [
            ("a", WhatIfQuery(kind="score", placements=xs[sl[0]], dq=0.3,
                              beta=0.7)),
            ("b", WhatIfQuery(kind="rank", placements=xs[sl[1]],
                              dq=np.linspace(0.1, 0.8, S), beta=1.3,
                              top_k=5)),
            ("c", WhatIfQuery(kind="joint", placements=xs[sl[2]],
                              dq_values=dqv, beta=0.5)),
        ]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        tickets = [svc.submit(t, fid, q) for t, q in queries]
        completed = svc.drain()
        wall = time.perf_counter() - t0
        launched = dict(kernels.launches)
        buckets = svc.stats.snapshot()["buckets"]
        dispatch_ms = [b["p50"] * 1e3 for b in buckets]   # one each
        n_disp = sum(b["dispatches"] for b in buckets)
        check(completed == 3, f"{phase}: {completed} queries completed")
        check(launched[kernel] > 0, f"{phase}: {kernel} never launched")
        results = {}
        for (t, q), tk in zip(queries, tickets):
            (res,) = [m for m in svc.poll(t) if isinstance(m, QueryResult)
                      and m.query_id == tk.query_id]
            results[t] = res
        ev = BatchedEvaluator.shared(graph, device=dev)
        packed = np.concatenate([q.placements for _, q in queries])

        def direct(i, dq, beta):
            # dense: the tenant's own rows (K1 is row-independent by
            # construction); structured: the rows exactly as dispatched,
            # since cuBLAS may sum the (rows, V) @ (V, R) mass product in
            # another order for another row count
            if same_rows:
                return ev.score_grid(packed, pack, dq=dq,
                                     beta=beta).cpu().numpy()[:, sl[i]]
            return ev.score_grid(queries[i][1].placements, pack, dq=dq,
                                 beta=beta).cpu().numpy()

        for i, (t, q) in enumerate(queries):
            res = results[t]
            if q.kind == "joint":
                want, _ = joint_dq_scores(direct(i, 0.0, 0.0), dqv, q.beta)
            else:
                want = direct(i, q.dq, q.beta)
            check(np.array_equal(res.scores, want),
                  f"{phase}: served {q.kind} scores differ from a direct "
                  f"score_grid")
        # float64 oracle on eight (scenario, placement) pairs of the score
        # query (dq = 0.3, β = 0.7)
        score = results["a"].scores
        worst_oracle = 0.0
        for k in range(8):
            s, p = k % S, int(rng.integers(0, rows[0]))
            lat = costmodel.latency(graph, oracle_fleet(s),
                                    xs[sl[0]][p].astype(np.float64))
            want = costmodel.objective_F(lat, 0.3, 0.7)
            err = abs(float(score[s, p]) - want) / abs(want)
            check(err <= REL, f"{phase}: oracle pair ({s}, {p}) rel err "
                              f"{err:.3e} > {REL}")
            worst_oracle = max(worst_oracle, err)
        # where the time goes: the same three queries once more, profiled
        prof = device_profile(torch, lambda: (
            [svc.submit(t, fid, q) for t, q in queries], svc.drain()))
        cells = S * sum(rows)
        print(f"{phase}: {completed} queries, {sum(rows)} rows x {S} "
              f"scenarios in {n_disp} dispatch(es); {completed / wall:.2f} "
              f"queries/s, {cells / wall:.0f} cells/s, wall {wall * 1e3:.1f} "
              f"ms, ms/dispatch {', '.join(f'{m:.1f}' for m in dispatch_ms)}"
              f"; set-up (kernel build) {svc.stats.setup_s:.3f} s; launches "
              f"{launched}; served == direct bitwise; oracle worst rel err "
              f"{worst_oracle:.3e}")
        print(f"{phase} profile (a second, profiled round): {prof}")
        return svc, ev, packed, launched

    _, dense_ev, dense_packed, dense_launched = serve(
        "serve_dense", dense_pack, dense_x, DENSE_ROWS,
        "edge_latency_dense",
        lambda s: ExplicitFleet(com_cost=dense_pack[s].astype(np.float64)),
        same_rows=False)
    perf_dispatch_phase(torch, np, dev, dense_ev, dense_packed, dense_pack,
                        0.3, 0.7)
    del dense_ev, dense_packed
    # -- 3b. the same instance with all five objectives -----------------------
    speeds = rng.lognormal(0.0, 0.3, (S, DENSE_V)).astype(np.float32)
    serve_multi_phase(
        torch, np, dev, "serve_multi_dense", graph, dense_pack, dense_x,
        MULTI_DENSE_ROWS, speeds, "edge_latency_dense",
        lambda s: ExplicitFleet(com_cost=dense_pack[s].astype(np.float64),
                                speed=speeds[s].astype(np.float64)))
    del dense_pack, dense_x
    torch.cuda.empty_cache()
    _, ev, packed, struct_launched = serve(
        "serve_structured", fam, struct_x, STRUCT_ROWS,
        "edge_latency_structured", fam.fleet, same_rows=True)
    g1 = ev.score_grid(packed, fam, dq=0.2, beta=0.4).cpu()
    g2 = ev.score_grid(packed, fam, dq=0.2, beta=0.4).cpu()
    check(torch.equal(g1, g2), "serve_structured: two score_grid calls "
                               "differ (mass or kernel not deterministic)")
    check(bool(torch.isfinite(g1).all()) and g1.shape == (S, sum(STRUCT_ROWS)),
          "serve_structured: non-finite or mis-shaped grid")
    print("serve_structured: two score_grid calls bitwise equal")
    del ev, packed, g1, g2
    torch.cuda.empty_cache()

    # -- 4b. the same family with all five objectives -------------------------
    multi = serve_multi_phase(
        torch, np, dev, "serve_multi_structured", graph, fam, struct_x,
        MULTI_STRUCT_ROWS, None, "edge_latency_structured", fam.fleet)
    g1 = multi["ev"].score_grid(multi["padded"], fam, dq=0.2, beta=0.4,
                                objectives=multi["obj"]).to_host()
    g2 = multi["ev"].score_grid(multi["padded"], fam, dq=0.2, beta=0.4,
                                objectives=multi["obj"]).to_host()
    check(all(np.array_equal(g1.grids[k], g2.grids[k]) for k in g1.names)
          and np.array_equal(g1.scalarized, g2.scalarized),
          "serve_multi_structured: two score_grid(objectives=) calls differ")
    print("serve_multi_structured: two score_grid(objectives=) calls "
          "bitwise equal")
    del multi, g1, g2, fam, struct_x
    torch.cuda.empty_cache()

    # -- 5./6. K5 and the LM-scoring streaming job ----------------------------
    cfg = get_config(LM_ARCH).replace(attention_impl="pallas")
    shard = -(-LM_ROWS // 12)          # rows of the largest lm_score shard
    report["flash_attention"] = attention_phase(
        torch, dev, (shard, LM_SEQ, cfg.n_heads, cfg.hd))
    torch.cuda.empty_cache()
    attention_limits_phase(torch, dev)
    lm = lm_score_phase(torch, np, dev, cfg, LM_ROWS, LM_SEQ, LM_BATCHES)
    check(lm["shard_rows"] <= shard,
          f"lm_score: a shard of {lm['shard_rows']} rows, K5 timed at {shard}")
    torch.cuda.empty_cache()        # the OLMo model went with the phase

    # -- 7./8. K6, K7 and the LM-scoring job on Mamba2 ------------------------
    ssm_cfg = get_config(SSM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    report.update(ssm_kernels_phase(torch, dev, shard, LM_SEQ, ssm_cfg))
    torch.cuda.empty_cache()
    report.update(ssd_bwd_phase(                     # 7b. K6's backward
        torch, dev, resources=resources["ssd_scan_bwd"]))
    torch.cuda.empty_cache()
    ssm_dims = (ssm_cfg.ssm_heads, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state)
    ssd_final_state_phase(torch, dev, [(shard, LM_SEQ, *ssm_dims),
                                       (SERVE_BATCH, SERVE_PROMPT,
                                        *ssm_dims)])
    ssm = lm_score_phase(torch, np, dev, ssm_cfg, LM_ROWS, LM_SEQ,
                         LM_BATCHES)
    check(ssm["shard_rows"] <= shard,
          f"lm_score_mamba2: a shard of {ssm['shard_rows']} rows, K6/K7 "
          f"timed at {shard}")
    torch.cuda.empty_cache()

    # -- 8b. the LM-scoring job on the Zamba2 hybrid: K5, K6 and K7 --------
    hyb_cfg = get_config(HYBRID_ARCH).replace(attention_impl="pallas")
    hyb = lm_score_phase(torch, np, dev, hyb_cfg, LM_ROWS, LM_SEQ,
                         LM_BATCHES, hold=True)
    check(hyb["shard_rows"] <= shard,
          f"lm_score_zamba2: a shard of {hyb['shard_rows']} rows, K5/K6/K7 "
          f"held at {shard}")
    torch.cuda.empty_cache()

    # -- 8c. the LM-scoring job on the MoE decoder: K5 and K7 -------------
    moe_cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS,
                                           attention_impl="pallas")
    moe_run = lm_score_phase(torch, np, dev, moe_cfg, LM_ROWS, LM_SEQ,
                             LM_BATCHES, hold=True)
    check(moe_run["shard_rows"] <= shard,
          f"lm_score_moe: a shard of {moe_run['shard_rows']} rows, K5/K7 "
          f"held at {shard}")
    torch.cuda.empty_cache()

    # -- 8d. one forward of the VLM, Whisper and Grok on K5's route -------
    for arch, layers in FORWARD_ARCHS:
        fwd_cfg = get_config(arch).replace(attention_impl="pallas")
        if layers is not None:
            fwd_cfg = fwd_cfg.replace(n_layers=layers)
        lm_forward_phase(torch, np, dev, fwd_cfg)
        torch.cuda.empty_cache()

    # -- 9.-12. search, robust search and the engine's re-optimization ------
    search_dense_phase(torch, np, dev, graph, SEARCH_PER_REGION,
                       SEARCH_CANDIDATES, SEARCH_BATCH, ANNEAL_STEPS,
                       ANNEAL_BLOCK)
    torch.cuda.empty_cache()
    search_greedy_phase(torch, np, dev, graph, GREEDY_PER_REGION)
    robust_structured_phase(torch, np, dev, graph, STRUCT_V, S,
                            ROBUST_CANDIDATES)
    torch.cuda.empty_cache()
    streaming_reoptimize_phase(np)

    # -- 13./14. the closed loop and the belief layer -----------------------
    adaptive = adaptive_dense_phase(torch, np, dev, ADAPT_PER_REGION,
                                    ADAPT_TICKS)
    torch.cuda.empty_cache()
    belief_cold_start_phase(torch, np, dev, ADAPT_PER_REGION, BELIEF_TICKS,
                            adaptive)
    torch.cuda.empty_cache()

    # -- 15./16. projected gradient and the LM token server ----------------
    projected_gradient_phase(torch, np, dev, graph, PG_SMALL_PER_REGION,
                             SEARCH_PER_REGION, PG_STEPS)
    torch.cuda.empty_cache()
    from repro_torch.models import count_params
    for arch, layers in SERVE_ARCHS:
        serve_cfg = get_config(arch)
        cut = ""
        if layers is not None:
            gb = count_params(serve_cfg)[0] * serve_cfg.pdtype.itemsize / 1e9
            cut = (f" (cut to {layers} of {serve_cfg.n_layers} layers: one "
                   f"card cannot hold its {gb:.0f} GB of "
                   f"{serve_cfg.param_dtype} parameters)")
            serve_cfg = serve_cfg.replace(n_layers=layers)
        lm_serve_phase(torch, np, dev, serve_cfg, cut)
    torch.cuda.empty_cache()

    # -- 16b. the single-card trainer: K6, K7 and their backward -----------
    from repro_torch.configs import get_smoke_config
    train_cfg = get_config(TRAIN_ARCH)
    whole = count_params(train_cfg)[0] * 16 / 2 ** 30
    train = lm_train_phase(
        torch, np, dev, train_cfg.replace(n_layers=TRAIN_LAYERS),
        resume_cfg=get_smoke_config(TRAIN_ARCH), card=smi,
        cut=(f" (cut to {TRAIN_LAYERS} of {train_cfg.n_layers} layers: "
             f"parameters, gradients and two float32 moments of all "
             f"{train_cfg.n_layers} take {whole:.1f} GiB)"))
    # the kernels line reports K7's backward at the largest operand held
    report["rmsnorm_bwd"] = max(train["held"].values(),
                                key=lambda r: r["rows"] * r["D"])
    torch.cuda.empty_cache()
    # Mamba2-1.3B and Zamba2-1.2B whole: K6 and its backward, K7 and its
    ssm_train = {}
    for arch in TRAIN_SSM_ARCHS:
        ssm_train[arch] = lm_train_phase(torch, np, dev, get_config(arch),
                                         card=smi, cut=" (whole)")
        torch.cuda.empty_cache()

    # -- 16c./16d. the mesh planner and its dry run ------------------------
    lm_mesh_phase(torch, np, dev,
                  get_config(MESH_ARCH).replace(n_layers=MESH_LAYERS),
                  card=smi, cut=(f" (cut to {MESH_LAYERS} of "
                                 f"{get_config(MESH_ARCH).n_layers} layers)"))
    torch.cuda.empty_cache()
    mesh_launches = {}
    for arch, layers, parts in MESH_FAMILIES:
        mesh_cfg, cut = get_config(arch), ""
        if layers is not None:
            gb = count_params(mesh_cfg)[0] * mesh_cfg.pdtype.itemsize / 1e9
            cut = (f" (cut to {layers} of {mesh_cfg.n_layers} layers: "
                   f"{gb:.0f} GB of {mesh_cfg.param_dtype} parameters a "
                   f"copy at full depth)")
            mesh_cfg = mesh_cfg.replace(n_layers=layers)
        moe = mesh_cfg.family == "moe"
        got = lm_mesh_phase(
            torch, np, dev, mesh_cfg,
            batch=MESH_MOE_BATCH if moe else MESH_BATCH,
            seq=MESH_MOE_SEQ if moe else MESH_SEQ,
            n_steps=MESH_MOE_STEPS if moe else MESH_STEPS, card=smi,
            cut=cut, parts=parts)
        mesh_launches[arch] = got["launches"]
        if parts == ("serve",):
            check(got["wall_s"] <= MESH_FAMILY_WALL,
                  f"lm_mesh {arch}: phase wall {got['wall_s']:.1f} s over "
                  f"{MESH_FAMILY_WALL} s: cut the depth")
        torch.cuda.empty_cache()
    print(f"lm_mesh launches on the sharded route, by family and run: "
          f"{json.dumps(mesh_launches)}")
    for started in dryruns:
        mesh_dryrun_phase(started, card=smi)

    # -- 17./18. the perf records and the build hooks ---------------------
    # the counting hooks, disarmed, on K7 dispatches at a decode step's shape
    from repro_torch.kernels import dispatch
    x_dec = torch.randn((SERVE_BATCH, get_config(HYBRID_ARCH).d_model),
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED), device=dev).to(torch.bfloat16)
    w_dec = torch.ones(x_dec.shape[-1], device=dev)
    hook_overhead_phase(torch, lambda: dispatch.rmsnorm(x_dec, w_dec))
    del x_dec, w_dec
    for arch, layers in PERF_ARCHS:
        perf_cfg = get_config(arch)
        if perf_cfg.family != "ssm":
            perf_cfg = perf_cfg.replace(attention_impl="pallas")
        if layers is not None:
            perf_cfg = perf_cfg.replace(n_layers=layers)
        perf_lm_phase(torch, np, dev, perf_cfg, shard, LM_SEQ)
        torch.cuda.empty_cache()
    compile_span_phase(torch, dev)

    launches = {"edge_latency_dense": dense_launched["edge_latency_dense"],
                "edge_latency_structured":
                    struct_launched["edge_latency_structured"],
                "flash_attention": lm["launches"],
                "ssd_scan": ssm["kernel_launches"]["ssd_scan"],
                "rmsnorm": ssm["kernel_launches"]["rmsnorm"],
                "rmsnorm_bwd": train["launches"]["rmsnorm_bwd"],
                "ssd_scan_bwd":
                    ssm_train[SSM_ARCH]["launches"]["ssd_scan_bwd"],
                **tile["launches"]}
    from repro_torch.kernels import autotune
    print(f"block policy: the run's decisions "
          f"{json.dumps(autotune.table_rows())}")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": report[k]["max_abs_err"], "ms": report[k]["ms"],
         "plain_ms": report[k]["plain_ms"],
         "bound_ms": report[k]["bound_ms"],
         "bound_by": report[k]["bound_by"],
         "library_ms": report[k]["library_ms"]}
        for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
