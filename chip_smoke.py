#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0] [--m 100000] [--n 80000]
                          [--m64 20000] [--n64 16000]
                          [--sm 480189] [--sn 17770]

Phases (any failure exits non-zero; there is no CPU fallback):

  1. device and build — the card's name and power limit from nvidia-smi,
     and an nvcc build of every kernel in src/repro_torch/csrc for sm_90a
     (one nvcc per source, all started together);
  2. kernel vs plain version — each of the four fused GK-step kernels, and
     gk_step_fused / gk_rstep_fused at passes 0..3, against the plain-torch
     versions of repro_torch.kernels.ref on ragged small shapes and at the
     main shape, f32 and bf16 storage; matvec_fused / rmatvec_fused with
     f64, f32 and bf16 A on the shapes of tests/test_kernels.py:22-110 and
     at the main shape; sketch_matmat on the shapes of
     tests/test_kernels.py:271-300, on ragged d, zeta, N and b
     (SKETCH_RAGGED: f32, bf16 and f64 X and signs; row-major X, a row
     pitch one past b, transposed views through the range kernel with
     the sketch's kept order and, past a chunk, the element path) and at
     gnystrom's three main-path shapes; sparse_matvec
     on the shapes of tests/test_kernels.py:210-245 (empty rows,
     duplicates, both packs, one vector and 20-column blocks, f32 and
     bf16 values, in COO order and through each pack's window layout at
     b = 1, 2, 3, 8, 20 and 32; long rows of 1,023 to 20,000 slots, f32,
     bf16 and f64 values, in COO order and in the layout's order, one
     vector and blocks of 2 to 32 columns); lowrank_matmul on
     tests/test_kernels.py's SHAPES and RAGGED and at the update's
     30 x 30 core (r = 10, a transposed view);
     qtv, subtract_qc and ops.reorth (passes 1 and 2) on the shapes of
     tests/test_kernels.py:48-60 and :110-116 with an f32 and a bf16
     basis; scatter_add bit for bit against its plain version on the CPU
     (it sums in entry order): the shapes of tests/test_kernels.py:304-363,
     the forced-duplicates dyadic case, the empty stream (no launch), an
     all-at-(0, 0) stream, coordinates outside the panel and a 1e6-entry
     Gaussian stream, spread, in one tile and in one cell (each timed);
     its binning against the plain model, bins of 1 to 128 tiles;
     every kernel twice, bitwise equal; matvec_fused's u bit for bit
     mv_qtv's u and rmatvec_fused's v rmv_qtv's v (f32 and bf16 A); the
     stacked launches of the four GK-step kernels (solve_batched's) on
     ragged shapes, f32 and bf16 A and basis, at B = 1, 3 and 8: one
     launch a call for the stack, every example bit for bit a single
     launch on it, within tolerance of the stacked plain versions; the
     build's ptxas report shows no spills in the A^T q kernels, the
     reorthogonalization pair's staged-tile epilogues, the block and
     window-sum kernels of sparse_matvec, both sketch kernels and the
     kernels of the stacked launches;
  3. main path — A = M N with Gaussian M (m x 100) and N (100 x n) made on
     the card from --seed (the paper's numerical-rank-100 input, §6.1);
     factorize(A, SVDSpec(method="fsvd", rank=20, max_iters=200,
     backend="pallas")), which runs through the plan layer, against
     sigma(A) = sigma(R_M R_N^T) from thin QRs,
     with exact launch counts, a bitwise rerun, a bf16-basis run, and
     estimate_rank(A) == 100 through the host loop; then the rank-k
     update: update_factorization of that r = 20 factorization by a
     seeded rank-10 LowRankOp (s ~ 1e-2 sigma_max, beta 0.9,
     backend="pallas"): zero iterations, one lowrank_matmul launch, held
     against its plain version on the update's own core, and sigma on the
     raw bases within 1e-5 sigma_max of the exact sigma of the factored
     operator (the update thin-QRs the bases first) and of the same update
     in f64 on the same bases; with the bases orthonormalized in f64
     beforehand, within 1e-5 sigma_max of exact sigma too;
  8. the plan (after 3b, before phase 7 edits A): two solves through one
     plan(spec, like=A) after clear_plan_cache: one trace, a miss and a
     hit, phase 3's launch counts each, sigma bit for bit the registered
     solver called directly, wall within 2 % of phase 3's; plan.update of
     3b's drift at beta 0.9 and 0.5 (one trace, one lowrank_matmul launch
     and 0 iterations each, sigma on the raw bases within 1e-5 sigma_max
     of exact); plan.estimate with host_loop=False twice (rank 100, one
     trace); the plan.solve failpoint (FaultInjected, no launch);
     solve_batched of 8 operands of serve_bench's "medium" mix (192 x
     128, low rank plus noise, rank 8, max_iters 24) and of 8 x 8192 x
     4096 f32 operands of rank 100 (rank 20, max_iters 100): a single
     solve's launch counts for the batch, sigma per example within 1e-5
     sigma_max of its own plan.solve from the same q1, host walls beside
     a loop of single solves and the GK loops' device time; the four
     stacked launches on the big batch's own operands with bases of
     101 (Q side) and 100 (P side) columns, and the projection pair on
     the P side's basis too: one launch a call, every example bit for
     bit a single launch on it, within phase 2's tolerance of the
     stacked plain versions, bitwise stable; a profiler trace of each
     stacked stage (the pair on both sides at B = 2, 4 and 8), launch
     by launch; each stacked stage at B = 2, 4 and 8 by device time
     beside B single launches, its bound, the library and the plain
     version (the pair on both sides, also with a cold L2);
  4. the sketch and blocked solvers on the same operand, backend="pallas":
     gnystrom (one sketch_pass, three sketch_matmat launches, bitwise
     rerun), rbk (5 sweeps, bitwise rerun), rsvd and fsvd_blocked, each
     against sigma_true at the reference's stol, with its wall time and a
     peak device memory that shows no copy of A or A^T;
     then every kernel is timed at its main shape beside its bound, its
     plain version and a PyTorch yardstick; mv_qtv, rmv_qtv and the fused
     matvecs, and their yardsticks, by device time too (6 calls in one
     CUDA graph: 32 GB a call); proj_qtv / proj_norm and
     their yardsticks by device time (60 calls in one CUDA graph, over
     basis copies that together exceed the L2) at the Q (m x 201) and P
     (n x 200) bases, f32 and bf16, beside the host loop's figure;
     sketch_matmat at gnystrom's three calls by device time (60 calls in
     one CUDA graph), each beside its sector floor (one 32-byte sector
     per gathered element or group of them) and the range call beside
     A.index_select of the same elements; after A is freed,
     materialize_lowrank of a rank-20
     LowRankOp at the main shape through lowrank_matmul (32 GB written
     once), held against its plain version by row blocks and timed by
     device time (6 calls a graph);
  5. the float64 leg — an f64 operand of numerical rank 100 (--m64 x
     --n64): matvec_fused / rmatvec_fused held against their plain
     versions on it (twice, bitwise), then factorize(method="fsvd",
     rank=20, max_iters=200, backend="pallas"), whose half-steps run
     through them: exact launch counts, sigma within 5e-4, and both
     kernels timed at that shape by device time;
  6. the sparse operand — a matrix of the Netflix Prize's shape (--sm
     users x --sn movies), built on the card from --seed as COO: a row-
     and column-permuted block diagonal of 100 rank-1 blocks, so its
     rank is 100 and its exact sigma is known.  SparseOp(backend=
     "pallas") packs both directions and holds each pack in its window
     layout's order, with no second copy (each layout rebuilt from a
     fresh pack, timed, the same bits; the 20-column block product timed
     by device time through the layout and over the fresh pack with the
     warp-per-row kernel, the previous design; the forward one vector over
     both orders in turns); sparse_matvec is held
     against its plain version on both packs at b = 1, 20 and 32, the
     transposed one vector also without the layout; fsvd (exact launch
     counts, bitwise rerun), "auto" (must pick fsvd_blocked) and
     estimate_rank (must give 100) run on it, with a peak device memory
     far below one dense copy; sparse_matvec is timed by device time both
     ways at b = 1 and b = 20, as the operator calls it, beside cuSPARSE,
     the block products beside this design's floor (the bound's bytes and
     its partials written and read once) and the previous design's L2
     volume and sector time, the forward one vector beside it over both
     orders of the pack in turns again.  Then
     the Lanczos basis of gk_bidiag at k = 200 (480,189 x 201 f32):
     ops.reorth(A p, Q, 2) against its plain version and orthogonal to Q
     (max|Q^T w| < 1e-4 ||v||, tests/test_kernels.py:59-60), and qtv /
     subtract_qc timed on it in f32 and on a bf16 copy by device time
     (60 calls in one CUDA graph), beside the host loop; then (6b) a
     transposed pack of the same shape and nnz whose row lengths follow
     a Zipf profile (at most ZIPF_CAP times the mean), from --seed: one
     vector and a 20-column block through its layout, against the plain
     version on its longest rows, timed by device time beside cuSPARSE;
  7. the sketch-resident state on phase 3's operand (it edits A in place,
     so it runs after every other use of A): sketch_operand with
     SVDSpec(method="gnystrom", rank=20, sketch_dim=128,
     backend="pallas") in one operator sweep; a seeded rank-1 drift on
     1,024 x 1,024 entries (||D||_F = 0.05 ||A||_F), each coordinate sent
     twice (a Gaussian part and the rest), shuffled: apply_entries with
     exactly 2 scatter_add launches, bitwise on a rerun; A += D in place
     and a fresh sketch with the same seeds within 1e-5 (relative
     Frobenius) of the folded panels; reconstruct with 0 iterations and
     the top-20 sigma within 1e-3 sigma_max of the exact sigma of A + D;
     the same after apply_lowrank_delta of phase 3b's rank-10 drift; the
     odometer trips on a fold of budget * base_norm and not before; peak
     memory below phase 3's + 2 GiB; scatter_add timed at both fold
     shapes by device time (the fold and index_add_ in CUDA graphs) and
     stage by stage, and so on two wider panels (480,189 x 128 and
     4,194,304 x 128: bins of 8 and of 64 tiles) with as many spread
     entries as the Y fold;
  9. the Session at full width (after phase 7 and after A is freed, before
     3c): an exact rank-20 operand A = M N (--m x --n f32, Gaussian factors
     from --seed) handed to Session(SVDSpec(method="fsvd", rank=20,
     max_iters=200, backend="pallas")) with learned gates and no other
     reference, then solve -> cold; update((M + 1e-3 E) N) -> refine at
     the learned budget; two rank-2 LowRankOp deltas at 1e-3 ||A||_F ->
     update (0 iterations; the fold by row blocks through lowrank_matmul);
     downdate of 8 rows -> downdate; a rank-1 block of 1,024 x 1,024
     entries, each coordinate twice, shuffled, ||D||_F = 1e-3 ||A||_F ->
     sketch (0 iterations, 2 scatter_add launches, probe <= gate);
     save(keep=2) and Session.restore (the factorization bit for bit, the
     same history); the checkpoint.write failpoint (the previous step
     stays the newest valid), a corrupt-mode save (restore falls back to
     the verified step); one more solve on the restored session ->
     refine.  Each step is checked for its kind, iterations and launches,
     and its sigma against the exact sigma of the operand's factored form
     (fsvd's 5e-4 for solves, 1e-5 for updates, 1e-3 for the sketch); the
     stream runs twice from the seed with the same sigma bits, at a peak
     of at most two operands + 4 GiB; each step's wall, kernel time and
     probe walls are printed, and a {"session": [...]} JSON line;
 10. the paper's RSL application (after phase 9 has freed its operands),
     through the trainer's entry point repro_torch.launch.train_rsl.main
     at the example's defaults (W 10000 x 10000 rank 5, never dense;
     batch 64, lr 3.0, 8,192 pairs, fsvd_iters 20, seed --seed):
     (a) 300 tracking steps: the mean loss of the last 10 steps below half
     the first 5's, train accuracy >= 0.85, 5 positive finite sigma, one
     plan trace over the run, at step 0 and every 50th the step's
     retract_fsvd point within 1e-4 (relative Frobenius, through the
     factors in f64) of retract_qr on the same (W, xi, -lr), and the
     loop's peak device memory within its start + 256 MiB; (b) 20 steps
     twice from the seed, U, s, V and the losses bit for bit; (c) 20
     cold steps (--no-track) under the same retract_qr gate, ms a step
     beside tracking's; (d) --grad-spectrum --session-dir for 100 steps,
     twice: the second run resumes at the first's solve count, every
     session's Ritz sigma at most the exact sigma of the gradient's
     factored form (1 + 1e-5); (e) three tracking steps under
     torch.profiler: CUDA ops and device time a step, beside the wall of
     ten steps without it, and one retraction's GK iterations.  The phase launches none of the
     twelve kernels (checked), and prints a {"rsl": {...}} JSON line;
 11. the solve server on the card (last): (a) the CLI
     repro_torch.launch.solve_serve.main at the reference's defaults
     (backend "xla": 200 requests, 4 clients, fsvd rank 8, Zipf 1.1, 4
     tenants at 0.25, quantum 32, exact mode, max batch 8, a 4 ms window,
     warmup): every request ok, no worker restart, bucket hit rate 1.0;
     (b) SolveServer(SVDSpec(method="fsvd", rank=8, backend="pallas"))
     with run_traffic over DEFAULT_SHAPES x 64 (17-25 M entries an
     operand): 48 requests, 4 clients, 4 tenants at 0.25 with rank-2
     delta drift: every request ok, anonymous sigma within 1e-2 sigma_max
     of the exact sigma (f64), tenants cold then refine or update, an
     update 0 iterations and within 1e-5 sigma_max, the stacked GK-step
     launches on anonymous batches and lowrank_matmul on deltas; each
     anonymous dispatch's wall against its GK loop's device time (a CUDA
     graph), the copies in and out, the peak memory; a batch of 8
     submitted together bit for bit the direct solve_batched on the same
     stack and generators; an entries replay (16 requests, 2 tenants,
     4,096 entries a drift at 6144 x 4096): scatter_add launched, every
     sketch step 0 iterations under its gate; (c) one degraded answer at
     6144 x 4096 (the plan.solve failpoint: gnystrom, probe under
     degraded_tol, sigma within 0.05, three sketch_matmat launches) and
     the chaos battery's replay (benchmarks/chaos_bench.py's settings,
     mixes "faulty" and "storm"): every request terminated, availability
     >= 0.99, quarantined == poisoned, degraded sigma within 0.05.  Each
     replay sets the launch counters to 0 just before it and reads them
     just after; the phase prints a {"serve": {...}} JSON line.

 12. the distributed layer (after phase 11 has freed its memory): two
     ranks, spawned processes that load the kernels phase 1 built, share
     cuda:0 over gloo (NCCL refuses two ranks on one card) through
     repro_torch.launch.mesh.run_world, and drive: (a) the --m x --n f32
     operand A = M N over mesh (2,) ("data",), backend "pallas", each rank
     making its own m/2 rows from the seed (no rank holds A):
     fsvd_sharded (rank 20, max_iters 200) twice (sigma within 5e-4 of
     exact, bit for bit on the rerun and on both ranks, local_mv_qtv /
     local_rmv_qtv launched k / k - 1 times a solve on each rank, one
     collective a half-step: 2k + 1 a solve), the rerun under
     torch.profiler (gk_step kernels' device time, other device work,
     host time in collectives), estimate_rank (100), fsvd_blocked and rbk
     (phase 4's bounds); each rank's stage-1 kernels held against their
     plain versions on its own block, and rank 0 times them at the shard
     shape by device time beside the plain version, torch.addmv +
     torch.mv and the bound; (b) mesh (1, 2) ("data", "model") at --m64 x
     --n64 f32: fsvd_sharded within 5e-4, two collectives a half-step
     (plain local products, as the reference's); (c) the sparse cell
     (--sm x --sn) sharded two ways: fsvd_sharded (k 200) within 5e-4,
     estimate_rank 100, the local packs through sparse_matvec and held
     against its plain version; (d) compress_mean over the two ranks'
     4096 x 14336 gradients (a shared rank-8 part and each worker's own
     noise, k 12): sigma within 5e-4 of the exact mean's SVD, and the
     floats a rank sent and received in the collectives, measured,
     beside the payload k (m + n) + r m and m n.  Each solve sets the
     stage-1 counts and the collective counts to 0 just before it and
     reads them just after; the kernels line gains local_mv_qtv and
     local_rmv_qtv, and a {"distributed": ...} line holds every rank's
     record.

 13. the LM stack (after phase 12 has freed its memory): (a) each of the
     ten registry configs' reduced() (f32) on the card: one
     build_train_step step (AdamW) with a finite loss and grad norm,
     skipped == 0 and the parameters moved, its loss within 1e-5 relative
     of the port's CPU loss on the same parameters and batch, and
     prefill -> decode consistency within 2e-2 of max |logit| (MoE at
     capacity factor 100, tests/test_models_smoke.py:58-87); (b)
     stablelm-1.6b through get_arch at its published width and depth (24
     layers, d_model 2048, vocabulary 100,352, bf16, ~1.64 B parameters
     drawn on the card from --seed): three AdamW steps on lm_batch at 2 x
     4096 (SHAPES["train_4k"]'s global batch 256 cut to 2), each finite
     and not skipped, timed by the host clock and CUDA events; ms a step,
     tokens/s and the model-FLOP share 6 N tokens / (step x 989 TFLOP/s),
     the peak memory; gradient_rank_summary (k 8, four leaves) on the last
     step's gradients, every sigma finite and rank 0-8; one more step
     under torch.profiler (device time by kernel kind); a prefill of 2 x
     4096 and 16 decode steps on the padded cache, the last within 2e-2
     of a prefill of all 4112 tokens, prefill ms and decode ms a token;
     (c) olmoe-1b-7b at its published width (64 experts, top-8, d_ff_expert
     1024, vocabulary 50,304) cut to 2 of 16 layers: two train steps at 2 x
     4096 (phase 14 (b)'s reference), the share of routed slots capacity 1.25 drops, and prefill ->
     decode at capacity 100 (2 x 512).  The phase launches none of the
     twelve kernels (checked with the launch counters) and prints an
     {"lm": {...}} JSON line with its figures and cuts.

 14. training (after phase 13): (a) the fault-tolerant Trainer on
     stablelm-1.6b at its published width cut to 2 layers (bf16, 2 x
     4096): six steps asked, a checkpoint every 3 (f32 on disk, ~6.2 GB),
     a real os.kill(SIGTERM) after step 4 that drains it at step 5 with a
     final checkpoint, then a Trainer built from another seed resumes:
     the step, every parameter and moment leaf and the eval loss of the
     next batch bit for bit; the Trainer's solver Session (a rank-20
     8192 x 4096 f32 operand, fsvd, backend "pallas", solved before the
     run) resumes too, and its update on a 1e-3 drift is a refine that
     launches rows 1-4 (counted from 0); ms a step, the checkpoint's
     bytes, save and restore seconds; (b) two gloo ranks on cuda:0, as
     phase 12 sets them up: olmoe-1b-7b's sharded step (2 layers, 2 x
     4096) on ("data", "model") (1, 2), expert-parallel, and (2, 1), FSDP
     and the batch split, two steps each: the first loss within 1e-2 of
     phase 13 (c)'s single-card step on the same seed and batch; on
     (1, 2) also the first gradient norm and the second loss within 1e-3
     of phase 13 (c)'s; (2, 1) takes capacity and the aux loss by batch
     shard, so it runs again with no slot dropped and no aux loss, and
     then its first loss, first gradient norm and second loss are within
     1e-3 of the same config's two steps on one card; every loss finite
     and the same bits on both ranks, each rank's peak and
     the collectives a step with their host seconds and their calls and
     bytes by kind; the gradient exchange (one all-to-all of each rank's
     own blocks) holds each rank's summed blocks bit for bit to the whole
     gather of every rank's gradient (tests/torch_train_world.py's
     oracle) on the last step of (1, 2) and of (2, 1), its norm within
     1e-6 of the oracle's; and stablelm-1.6b at its published width (2
     layers, bf16, 2 x 4096) tensor parallel on ("data", "model") (1, 2):
     heads, kv heads, the MLP's width and the vocabulary split two ways
     (steps.serving_model for prefill and decode, init_sharded_state for
     training), beside the same 2-layer model on one card drawn from the
     same seed in the parent: a prefill and 4 decode steps fed one card's
     greedy tokens, every step's logits within 2e-2 of max |logit| of one
     card's and the same bits on both ranks; two AdamW steps whose first
     loss, first gradient norm and second loss are within 1e-3 of one
     card's and the same bits on both ranks; ms a step, the collectives a
     step with their host seconds and their calls and bytes by kind, the
     first step's peak and FlopCounterMode's FLOPs (phase 15 (b)'s real
     rank); then the Mamba2, batch-of-one and sequence splits at
     published widths: zamba2-1.2b (6 of 38 layers: one application of
     its shared attention block) on (1, 2), its Mamba2 layers by heads
     over "model", two AdamW steps at 2 x 4096 in bf16 and in f32, the
     same bits on both ranks, whose first loss, first gradient norm and
     second loss are within ZB_RTOL of one card's (bf16: 1e-3, 2e-2,
     1e-3; f32: 1e-5, each f32 first-gradient block within 1e-4 of its
     leaf's max); its batch of one (a 4096-token prompt, replicated) on
     (2, 1), the attention cache's sequence split over "data", a prefill
     and 4 decode steps within 2e-2 of max |logit| of one card's, the
     first decode step's collectives and peak measured (phase 15 (b)'s
     real rank); and deepseek-v2-236b (2 of 60 layers) on (1, 2), its
     MLA latents' sequence split over "model", 2 x 1024 prompts, a
     prefill and 4 decode steps within 2e-2 of max |logit| of one card's,
     a rank's cache half of one card's; (c) on the same
     ranks the compressed step over ("pod",) (stablelm-1.6b, 2 layers, 1
     x 4096 a rank, FsvdConfig defaults): two finite steps, compressed /
     dense bytes, and the top 8 sigma of one 2048 x 5632 MLP gradient's
     compressed mean within 1e-2 sigma_max of the exact mean's
     (svdvals); (d) after (a), so that (a) has the card to itself, the
     CLIs side by side: launch.train --reduced (20 steps, the loss
     lowers), launch.serve --reduced and launch.quickstart exit 0.  It prints a {"train": {...}} JSON line with its cuts.

 15. the dry run (after phase 14): (a) ``python -m
     repro_torch.launch.dryrun --arch A --mesh single|multi`` for every
     arch and both production meshes, one subprocess each, DRYRUN_PROCS
     at a time (each traces on one host core): every (arch x shape x
     mesh) cell traced as rank 0 of a fake 256- or 512-rank world on fake
     cuda tensors; a {"dryrun_counts": ...} line with the ok /
     skipped / failed counts and each failed cell's reason (over the
     device's memory, refused by a port check, an exception); the phase
     fails if a cell fails by an exception; (b) stablelm-1.6b at phase
     13's 2 x 4096, one single-card AdamW step traced under the dry run's
     accounting on fake cuda tensors and run for real under
     FlopCounterMode: the trace's dot FLOPs within 0.1 % of the real
     count, its peak within 10 % of max_memory_allocated over what was
     allocated before the state; and phase 14 (b)'s tensor-parallel
     stablelm step traced as rank 0 of a fake two-rank world on the same
     (1, 2) mesh, against the real rank 0's first step: dot FLOPs within
     0.1 % of FlopCounterMode's, the collectives' calls by kind equal to
     collective_stats()'s and their bytes within 0.1 %, the peak within
     10 % of max_memory_allocated; and phase 14 (b)'s zamba2 batch-of-one
     decode step traced as rank 0 of a fake two-rank world on (2, 1),
     its collectives' calls and bytes by kind equal to the real rank
     0's, its peak within 10 %.  It prints a {"dryrun": {...}} JSON
     line.

The line before the last is the card as nvidia-smi reports it; the last is
{"ok": true, "device": {...}}.  A kernels JSON line precedes them.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEV = "cuda"                  # every tensor of the run lives on the card
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
RANK, R_WANT, MAX_ITERS, RANK_ITERS = 100, 20, 200, 256
FSVD_STOL = 5e-4              # SOLVERS["fsvd"]["stol"], test_solver_parity
BF16_STOL = 5e-2              # BF16_STOL["fsvd"], test_solver_parity
REL_ERR_BOUND = 5e-5          # test_api.py test_factorization_reconstruct
SMALL_SHAPES = [(64, 48, 4), (300, 517, 17), (257, 129, 31), (127, 383, 9),
                (1024, 512, 64), (300, 200, 5)]   # tests/test_kernels.py:136
BF16_A_SHAPE = (8192, 8192, 201)                   # bf16 A kept this small
MATVEC_SHAPES = [(64, 48), (300, 200), (1024, 512), (100, 700), (512, 128),
                 (300, 517), (257, 129), (127, 383)]  # tests/test_kernels.py
SKETCH_SHAPES = [(300, 64, 24), (128, 130, 16), (70, 16, 48), (48, 48, 48),
                 (200, 96, 32)]                 # tests/test_kernels.py:271
# ragged sketches (N, d, zeta, b): chunks of the range kernel that end
# mid-row, one sketch row a chunk, a zeta past a chunk (the element path),
# b of one row-block and of many, N of one sector
SKETCH_RAGGED = [(1025, 37, 24, 5), (70_001, 130, 8, 1000),
                 (3000, 200, 7, 3), (2000, 3, 1100, 37), (48, 48, 1, 17),
                 (5, 300, 5, 100_003)]
SPARSE_SHAPES = [(300, 517, 0.02), (257, 129, 0.1), (64, 48, 0.3),
                 (128, 1000, 0.005)]               # tests/test_kernels.py:214
# long rows: L slots each (odd row starts at 1,023 and 4,802), over an x of
# 98,305 elements (three windows of 49,152, the last of one element)
LONG_ROWS, LONG_SLOTS, LONG_N = 40, (1023, 1024, 4802, 20_000), 98_305
BLOCK_WIDTHS = (2, 3, 8, 20, 32)   # block products through the layout
LOWRANK_SHAPES = [(64, 48, 4), (300, 200, 17), (1024, 512, 64),
                  (100, 700, 5), (512, 128, 128),  # tests/test_kernels.py:10
                  (300, 517, 7), (257, 129, 7), (127, 383, 7),
                  (300, 200, 7),                   # RAGGED, :84 (r = 7)
                  (30, 30, 10)]       # phase 3b's core: (r+k, r+k), r = k
REORTH_SHAPES = [(64, 4), (300, 17), (1024, 64), (100, 5), (512, 128),
                 (517, 5), (129, 31)]   # tests/test_kernels.py:48-60, :110
SCATTER_SHAPES = [(300, 37, 20), (128, 128, 128), (1, 5, 3),
                  (513, 260, 130)]         # tests/test_kernels.py:304-321
SCATTER_GAUSSIAN = (10 ** 6, 1000, 128)    # E, m, d of the long stream
BIN_SHAPES = [(50_000, 300, 37, 7),        # E, m, d, tile_bits: bins of
              (60_000, 700, 150, 5),       # 1, 8 and 128 tiles
              (100_000, 2000, 1000, 5)]
WIDE_FOLDS = [("Netflix-width Y fold", (480_189, 128)),  # bins of 8 tiles
              ("fold into bins of 64 tiles", (4_194_304, 128))]
LANCZOS_K = 200               # phase 6's basis: gk_bidiag(S, 200) -> Q (m, 201)
REORTH_BOUND = 1e-4           # max|Q^T w| / ||v||, tests/test_kernels.py:59
SKETCHRES_FIELDS = dict(method="gnystrom", rank=20, sketch_dim=128,
                        backend="pallas")  # phase 7: k = 128, l = 256
DRIFT_BLOCK = 1024            # phase 7's drift: rows x columns it touches
DRIFT_MASS = 0.05             # ||D||_F / ||A||_F
PANEL_BOUND = 1e-5            # fold vs fresh sketch, tests/test_sketchres.py:70-84
SKETCHRES_STOL = 1e-3         # SOLVERS["gnystrom"]["stol"]
DELTA_RANK = 10               # the update phase's drift
DRIFT_BETA = 0.9              # its decay factor (phase 8 adds a second)
UPDATE_GATE = 1e-5            # GATE, tests/test_update.py:26
SPARSE_STOL = 5e-4            # SOLVERS["fsvd"] / ["fsvd_blocked"] stol
SPARSE_PEAK = 8               # GiB; one dense f32 copy of the cell is 34 GB
ZIPF_CAP = 10                 # phase 6b: the skewed pack's longest row, as
                              # a multiple of the mean (the ELL pack pads
                              # every row to it)
GIB = 2 ** 30
# phase 9, the Session: an exact rank-20 operand (tests/test_update.py's
# _exact at the cell's width) driven through every branch of the policy
SESSION_RANK = 20
SESSION_EPS = 1e-3            # the dense drift (M + eps E) N
SESSION_DELTA = 1e-3          # each rank-2 delta's ||D||_F / ||A||_F
SESSION_DELTA_RANK = 2
SESSION_ROWS = 8              # rows the downdate removes
SESSION_MASS = 1e-3           # ||D||_F / ||A||_F of the entry block
SESSION_SLACK = 4 * GIB       # peak <= two operands + this
# phase 4: (method, spec fields, sigma bound as a fraction of sigma_max)
SKETCH_SOLVES = [
    # sketch_dim >= the rank, so the range is captured; 1e-3 is
    # SOLVERS["gnystrom"]["stol"] of tests/test_solver_parity.py
    ("gnystrom", dict(sketch_dim=128), 1e-3),
    # passes * sketch_dim = 100 Krylov columns reach the rank-100 range
    # (the sketch block's own columns add none of it); SOLVERS stol
    ("rbk", dict(passes=2, sketch_dim=50), 5e-4),
    ("rsvd", dict(oversample=100, power_iters=1), 5e-2),
    ("fsvd_blocked", dict(), 5e-4),
]
REPLACES = {"mv_qtv": "src/repro/kernels/gk_step.py:147",
            "rmv_qtv": "src/repro/kernels/gk_step.py:178",
            "proj_qtv": "src/repro/kernels/gk_step.py:206",
            "proj_norm": "src/repro/kernels/gk_step.py:232",
            "matvec_fused": "src/repro/kernels/gk_matvec.py:71",
            "rmatvec_fused": "src/repro/kernels/gk_matvec.py:92",
            "qtv": "src/repro/kernels/reorth.py:50",
            "subtract_qc": "src/repro/kernels/reorth.py:68",
            "lowrank_matmul": "src/repro/kernels/lowrank_update.py:34",
            "sparse_matvec": "src/repro/kernels/sparse_matvec.py:75",
            "sketch_matmat": "src/repro/kernels/sketch_matvec.py:65",
            "scatter_add": "src/repro/kernels/count_sketch.py:75"}
SOURCES = {"mv_qtv": "gk_step.cu", "rmv_qtv": "gk_step.cu",
           "proj_qtv": "gk_step.cu", "proj_norm": "gk_step.cu",
           "matvec_fused": "gk_step.cu", "rmatvec_fused": "gk_step.cu",
           "qtv": "reorth.cu", "subtract_qc": "reorth.cu",
           "sketch_matmat": "sketch_matvec.cu",
           "lowrank_matmul": "lowrank_update.cu",
           "sparse_matvec": "sparse_matvec.cu",
           "scatter_add": "count_sketch.cu"}
GK_STEP = ("mv_qtv", "rmv_qtv", "proj_qtv", "proj_norm")
# the A^T q pass and the reorthogonalization pair's staged-tile epilogues
# (proj_kernel's modes 2 and 3, as in proj_tiles.cuh; rmv_qtv's P^T v is
# mode 3): the build must show no spills
STREAM_KERNELS = (r"rmv_partial_kernel|rmv_finish_kernel|proj_kernelI\w*Li[23]E"
                  r"|block_kernel|sum_windows_kernel|range_kernel|rows_kernel")
MATVECS = ("matvec_fused", "rmatvec_fused")
# the kernels of the batched launches on the main path's widths (k <= 256:
# the projection modes' register path): the build must show no spills
BATCHED_KERNELS = (r"rows_kernelINS_5MvRow|rmv_partial_kernel|rmv_finish_kernel"
                   r"|proj_(?:stacked_)?kernelI\w*Li[013]ELb1E|finish_kernel"
                   r"|finish_warps_kernel")
# phase 2's stacked cases (m, n, k), each at B = 1, 3 and 8: ragged m, n
# and k, the serving shape and a basis past a tile of rows
BATCH_SHAPES = [(64, 48, 4), (300, 517, 17), (127, 383, 9), (192, 128, 25),
                (1025, 333, 201)]
BATCHES = (1, 3, 8)
# phase 8: serve_bench's "medium" mix (benchmarks/serve_bench.py:46-49,
# twice the stock (96, 64)), low rank plus noise as serve/traffic.py makes
# it, the server's max batch; then a batch where the kernels do real work
SERVE_SHAPE, SERVE_B, SERVE_RANK, SERVE_ITERS = (192, 128), 8, 8, 24
SERVE_NOISE = 1e-3
BIG_BATCH, BIG_ITERS = (8, 8192, 4096), 100     # f32: 1.07 GB
BATCH_SIGMA = 1e-5            # batched vs single sigma, a fraction of sigma_max
PLAN_WALL_SLACK = 0.02        # plan.solve's wall against phase 3's


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def ptxas_report(log: str) -> list:
    """One line per kernel of an nvcc log built with -Xptxas -v: its
    (mangled) name, registers, shared memory and spills."""
    out, kernel, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
            kernel = re.sub(r"^_ZN\d+_GLOBAL__N_\w*?_cu_[0-9a-f]{8}\d+", "",
                            kernel)          # the anonymous namespace
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{kernel[:110]}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --- phase 2: kernels against their plain versions ------------------------

def compare(name, got, want, dtypes):
    """Max |got − want| over the outputs; raises past the tolerance: rtol
    and atol/max|want| of 1e-5 in f32, 3e-2 with bf16 storage (the bounds
    of tests/test_kernels.py:151-187)."""
    import torch
    rtol = 3e-2 if torch.bfloat16 in dtypes else 1e-5
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        ok = torch.allclose(g, w, rtol=rtol, atol=rtol * scale)
        check(ok, f"{name}: kernel differs from plain version by {err:.3e} "
                  f"(scale {scale:.3e}, rtol {rtol})")
        worst = max(worst, err)
    return worst


def bitwise_twice(name, fn):
    import torch
    a, b = fn(), fn()
    for x, y in zip(a, b):
        check(torch.equal(x, y), f"{name}: two launches differ bitwise")
    return a


def stage_inputs(gen, m, n, k, adt, qdt, A=None):
    import torch
    dev = DEV
    if A is None:
        A = torch.randn(m, n, generator=gen, device=dev).to(adt)
    p = torch.randn(n, generator=gen, device=dev)
    q = torch.randn(m, generator=gen, device=dev)
    ym = torch.randn(m, generator=gen, device=dev)
    yn = torch.randn(n, generator=gen, device=dev)
    Q = torch.linalg.qr(torch.randn(m, k, generator=gen, device=dev))[0]
    P = torch.linalg.qr(torch.randn(n, k, generator=gen, device=dev))[0]
    c = torch.randn(k, generator=gen, device=dev)
    return A, p, q, ym, yn, Q.to(qdt).contiguous(), P.to(qdt).contiguous(), c


def check_stages(gen, m, n, k, adt, qdt, A=None, steps=True):
    """All four kernels (and the composed half-steps) on one shape;
    returns {kernel: max abs error}."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    A, p, q, ym, yn, Q, P, c = stage_inputs(gen, m, n, k, adt, qdt, A)
    alpha = torch.tensor([0.37], device=DEV)
    tag = f"({m}x{n}, k={k}, A {adt}, basis {qdt})"
    errs = {}
    cases = {
        "mv_qtv": (lambda: gs.mv_qtv(A, p, ym, alpha, Q),
                   lambda: ref.mv_qtv(A, p, ym, alpha, Q), (adt, qdt)),
        "rmv_qtv": (lambda: gs.rmv_qtv(A, q, yn, 1.7, P),
                    lambda: ref.rmv_qtv(A, q, yn, 1.7, P), (adt, qdt)),
        "proj_qtv": (lambda: gs.proj_qtv(ym, Q, c),
                     lambda: ref.proj_qtv(ym, Q, c), (qdt,)),
        "proj_norm": (lambda: gs.proj_norm(ym, Q, c),
                      lambda: ref.proj_norm(ym, Q, c), (qdt,)),
    }
    for name, (kern, plain, dts) in cases.items():
        got = bitwise_twice(f"{name} {tag}", kern)
        errs[name] = compare(f"{name} {tag}", got, plain(), dts)
    if steps:
        for passes in range(4):
            got = bitwise_twice(
                f"gk_step_fused p={passes} {tag}",
                lambda: kops.gk_step_fused(A, p, ym, alpha, Q, passes))
            compare(f"gk_step_fused p={passes} {tag}", got,
                    ref.gk_step(A, p, ym, alpha, Q, passes), (adt, qdt))
            got = bitwise_twice(
                f"gk_rstep_fused p={passes} {tag}",
                lambda: kops.gk_rstep_fused(A, q, yn, 1.7, P, passes))
            compare(f"gk_rstep_fused p={passes} {tag}", got,
                    ref.gk_rstep(A, q, yn, 1.7, P, passes), (adt, qdt))
    torch.cuda.synchronize()
    return errs


def check_matvecs(gen, m, n, adt, A=None):
    """matvec_fused / rmatvec_fused on one shape against the plain
    versions (both multiply in f32 whatever A's storage: f32 bounds);
    returns {kernel: max abs error}."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    A, p, q, ym, yn, _, _, _ = stage_inputs(gen, m, n, 1, adt,
                                            torch.float32, A)
    alpha = torch.tensor([0.37], device=DEV)
    tag = f"({m}x{n}, A {adt})"
    cases = {
        "matvec_fused": (lambda: (gs.matvec_fused(A, p, ym, alpha),),
                         lambda: (ref.matvec_fused(A, p, ym, alpha),)),
        "rmatvec_fused": (lambda: (gs.rmatvec_fused(A, q, yn, 1.7),),
                          lambda: (ref.rmatvec_fused(A, q, yn, 1.7),)),
    }
    errs = {}
    for name, (kern, plain) in cases.items():
        got = bitwise_twice(f"{name} {tag}", kern)
        errs[name] = compare(f"{name} {tag}", got, plain(), (torch.float32,))
    if adt != torch.float64:   # mv_qtv / rmv_qtv take f32 / bf16 A
        u, _ = gs.mv_qtv(A, p, ym, alpha, torch.zeros(m, 1, device=DEV))
        check(torch.equal(gs.matvec_fused(A, p, ym, alpha), u),
              f"matvec_fused {tag}: u differs bitwise from mv_qtv's u")
        v, _ = gs.rmv_qtv(A, q, yn, 1.7, torch.zeros(n, 1, device=DEV))
        check(torch.equal(gs.rmatvec_fused(A, q, yn, 1.7), v),
              f"rmatvec_fused {tag}: v differs bitwise from rmv_qtv's v")
    torch.cuda.synchronize()
    return errs


def sketch_pack(gen, N, d):
    from repro_torch.core.sketch import make_sketch
    return make_sketch(gen, N, d, backend="pallas", device=DEV)


def check_sketch(tag, sk, X):
    """sketch_matmat(X), with the sketch's own order as the main path
    passes it, against the plain version (bf16 and f64 X are widened as
    the plain version widens them, so f32 bounds hold); returns (max abs
    error, Y)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch_matvec as skm
    name = f"sketch_matmat {tag}"
    got = bitwise_twice(name, lambda: (skm.sketch_matmat(sk.signs, sk.idx,
                                                         X, sk.order),))
    err = compare(name, got, (ref.sketch_matmat(sk.signs, sk.idx, X),),
                  (torch.float32,))
    torch.cuda.synchronize()
    return err, got[0]


def check_sketch_ragged(gen):
    """Both sketch kernels on SKETCH_RAGGED: row-major X (16-byte loads,
    and element loads on a row pitch one off a multiple), transposed views
    (the range kernel, and the element path past a chunk), f32, bf16 and
    f64 X and signs, each twice bitwise and one launch a call; returns the
    number of cases."""
    import torch
    from repro_torch.core.sketch import make_sketch
    from repro_torch.kernels import sketch_matvec as skm
    cases = 0
    for N, d, zeta, b in SKETCH_RAGGED:
        for dt in (torch.float32, torch.bfloat16, torch.float64):
            sk = make_sketch(gen, N, d, zeta=zeta, dtype=dt,
                             backend="pallas", device=DEV)
            X = torch.randn(N, b + 1, generator=gen, device=DEV).to(dt)
            Xt = torch.randn(b, N, generator=gen, device=DEV).to(dt).T
            views = (("row-major", X[:, :b].contiguous()),
                     ("row pitch b+1", X[:, :b]), ("transposed view", Xt))
            for label, V in views:
                before = skm.LAUNCHES["sketch_matmat"]
                check_sketch(f"({N}x{b} {label}, d={d}, zeta={zeta}, {dt})",
                             sk, V)
                check(skm.LAUNCHES["sketch_matmat"] == before + 2,
                      f"sketch_matmat ({N}x{b} {label}): not one launch a "
                      f"call")
                cases += 1
    return cases


def phase_new_kernels(gen, A_main):
    """Phase 2 rows of the gk_matvec pair and sketch_matmat; returns the
    max abs errors at the main path's shapes."""
    import torch
    n_cases = 0
    for m, n in MATVEC_SHAPES:
        for adt in (torch.float64, torch.float32, torch.bfloat16):
            check_matvecs(gen, m, n, adt)
            n_cases += 1
    m, n = A_main.shape
    errs = check_matvecs(gen, m, n, torch.float32, A=A_main)
    for N, d, b in SKETCH_SHAPES:
        for xdt in (torch.float32, torch.bfloat16):
            sk = sketch_pack(gen, N, d)
            X = torch.randn(N, b, generator=gen, device=DEV).to(xdt)
            Xt = torch.randn(b, N, generator=gen, device=DEV).to(xdt).T
            check_sketch(f"({N}x{b} row-major, d={d}, {xdt})", sk, X)
            check_sketch(f"({N}x{b} transposed view, d={d}, {xdt})", sk, Xt)
            n_cases += 2
    n_cases += check_sketch_ragged(gen)
    # gnystrom's three calls: Omega^T A^T (A^T a view), Psi^T A, Psi^T Y
    k = SKETCH_SOLVES[0][1]["sketch_dim"]
    l = 2 * k                                   # gnystrom's co-range width
    e1, Yt = check_sketch(f"range ({n}x{m} view of A, d={k})",
                          sketch_pack(gen, n, k), A_main.T)
    psi = sketch_pack(gen, m, l)
    e2, _ = check_sketch(f"co-range ({m}x{n} A, d={l})", psi, A_main)
    e3, _ = check_sketch(f"core ({m}x{k} view of Y, d={l})", psi, Yt.T)
    errs["sketch_matmat"] = max(e1, e2, e3)
    print(f"phase 2: {n_cases} more shape/type cases of matvec_fused/"
          f"rmatvec_fused (f64/f32/bf16 A) and sketch_matmat (row-major, "
          f"row-pitched and transposed-view X, f32/bf16/f64, ragged d, "
          f"zeta, N and b) match the plain versions, bitwise stable; max "
          f"abs err at the main shapes: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def phase_kernels(gen, A_main):
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    n_cases = 0
    for m, n, k in SMALL_SHAPES:
        for adt in (f32, bf16):
            for qdt in (f32, bf16):
                check_stages(gen, m, n, k, adt, qdt)
                n_cases += 1
    m, n, k = BF16_A_SHAPE
    for qdt in (f32, bf16):
        check_stages(gen, m, n, k, bf16, qdt)
        n_cases += 1
    m, n = A_main.shape
    check_stages(gen, m, n, MAX_ITERS + 1, f32, bf16, A=A_main)
    errs = check_stages(gen, m, n, MAX_ITERS + 1, f32, f32, A=A_main)
    print(f"phase 2: {n_cases + 2} shape/type cases x 4 kernels and "
          f"gk_step_fused/gk_rstep_fused x passes 0..3 match the plain "
          f"versions, bitwise stable; max abs err at the main shape (f32): "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


# --- phase 3: the main path ------------------------------------------------

def operand_factors(seed, m, n, dtype=None):
    """The seeded Gaussian factors M (m x RANK) and N (RANK x n) of A."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    M = torch.randn(m, RANK, generator=gen, device=DEV, dtype=dtype)
    N = torch.randn(RANK, n, generator=gen, device=DEV, dtype=dtype)
    return M, N


def factored_sigma(left, right):
    """sigma(left right^T) = sigma(R_l R_r^T) from the thin QRs left =
    Q_l R_l and right = Q_r R_r, in f64 — no dense SVD of the (m, n)
    matrix."""
    import torch
    R_l = torch.linalg.qr(left.double())[1]
    R_r = torch.linalg.qr(right.double())[1]
    return torch.linalg.svdvals(R_l @ R_r.T)


def make_operand(seed, m, n, dtype=None):
    import torch
    M, N = operand_factors(seed, m, n, dtype)
    A = M @ N
    s_true = factored_sigma(M, N.T)
    torch.cuda.synchronize()
    return A, s_true


def _sync():
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def phase_main(A, s_true, seed):
    import torch
    from repro_torch.api import SVDSpec, estimate_rank, factorize
    from repro_torch.kernels import gk_step as gs
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")
    smax = float(s_true[0])

    def gen():
        return torch.Generator(device=DEV).manual_seed(seed)

    gs.reset_launches()
    fact, wall = timed(lambda: factorize(A, spec, generator=gen()))
    launches = dict(gs.LAUNCHES)
    k, passes = MAX_ITERS, spec.reorth_passes
    want = {"mv_qtv": k, "rmv_qtv": k - 1,
            "proj_qtv": (2 * k - 1) * (passes - 1), "proj_norm": 2 * k - 1,
            "matvec_fused": 0, "rmatvec_fused": 0}
    check(launches == want, f"launch counts {launches} != {want}")
    launches = {name: launches[name] for name in GK_STEP}
    err = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
    print(f"phase 3: fsvd f32 {A.shape[0]}x{A.shape[1]} wall {wall:.3f} s, "
          f"iterations {int(fact.iterations)}, breakdown "
          f"{bool(fact.breakdown)}, max|sigma - sigma_true|/sigma_max "
          f"{err:.3e} (bound {FSVD_STOL}), launches {launches}", flush=True)
    check(err < FSVD_STOL, f"fsvd sigma error {err:.3e} >= {FSVD_STOL}")
    errs, t_err = timed(lambda: fact.errors(A))
    rel = float(errs["relative"])
    print(f"phase 3: errors(A) relative {rel:.3e} (bound {REL_ERR_BOUND}), "
          f"residual {float(errs['residual']):.3e} "
          f"(||A||_F {float(torch.linalg.vector_norm(s_true)):.3e}), "
          f"{t_err:.3f} s", flush=True)
    check(rel < REL_ERR_BOUND, f"relative error {rel:.3e}")

    gs.reset_launches()
    again, wall2 = timed(lambda: factorize(A, spec, generator=gen()))
    check(dict(gs.LAUNCHES) == want, "rerun launch counts differ")
    check(torch.equal(fact.s, again.s), "sigma differs bitwise on a rerun")
    print(f"phase 3: rerun wall {wall2:.3f} s, sigma bitwise equal",
          flush=True)

    gs.reset_launches()
    half, wall3 = timed(lambda: factorize(
        A, spec.replace(precision="bf16"), generator=gen()))
    check(gs.LAUNCHES["mv_qtv"] == k, f"bf16 launches {gs.LAUNCHES}")
    err16 = float((half.s.double() - s_true[:R_WANT]).abs().max()) / smax
    print(f"phase 3: fsvd bf16 bases wall {wall3:.3f} s, iterations "
          f"{int(half.iterations)}, sigma error {err16:.3e} "
          f"(bound {BF16_STOL})", flush=True)
    check(err16 < BF16_STOL, f"bf16 sigma error {err16:.3e}")

    gs.reset_launches()
    est, wall4 = timed(lambda: estimate_rank(
        A, SVDSpec(max_iters=RANK_ITERS, backend="pallas"),
        generator=gen()))
    rank_launches = {name: gs.LAUNCHES[name] for name in GK_STEP}
    print(f"phase 3: estimate_rank wall {wall4:.3f} s, rank {int(est)}, "
          f"GK iterations {int(est.iterations)}, launches {rank_launches}",
          flush=True)
    check(int(est) == RANK, f"estimate_rank returned {int(est)}")
    check(all(v > 0 for v in rank_launches.values()),
          f"estimate_rank skipped a kernel: {rank_launches}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 3: peak device memory {peak / GIB:.2f} GiB", flush=True)
    return launches, peak, fact, (wall, wall2)


def counting_op(inner):
    """``inner`` behind a wrapper that counts each operator touch (a
    fused sketch_pass is one), so a run shows its sweep budget."""
    from repro_torch.core.operators import Operator

    class CountingOp(Operator):
        def __init__(self):
            self.counts = dict.fromkeys(
                ("mv", "rmv", "matmat", "rmatmat", "sketch_pass"), 0)

        shape = property(lambda self: inner.shape)
        dtype = property(lambda self: inner.dtype)
        device = property(lambda self: inner.device)

        def _touch(self, kind, *args):
            self.counts[kind] += 1
            return getattr(inner, kind)(*args)

        def mv(self, p):
            return self._touch("mv", p)

        def rmv(self, q):
            return self._touch("rmv", q)

        def matmat(self, V):
            return self._touch("matmat", V)

        def rmatmat(self, Q):
            return self._touch("rmatmat", Q)

        def sketch_pass(self, omega, psi):
            return self._touch("sketch_pass", omega, psi)

    return CountingOp()


def phase_sketch(A, s_true, seed, peak3):
    """gnystrom, rbk, rsvd and fsvd_blocked on the main operand; returns
    gnystrom's sketch_matmat launch count."""
    import torch
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.core.operators import DenseOp
    from repro_torch.kernels import sketch_matvec as skm
    smax = float(s_true[0])
    dense = DenseOp(A, backend="pallas")
    launches = None
    for method, fields, bound in SKETCH_SOLVES:
        spec = SVDSpec(method=method, rank=R_WANT, backend="pallas",
                       **fields)

        def solve(op):
            gen = torch.Generator(device=DEV).manual_seed(seed + 3)
            return factorize(op, spec, generator=gen)

        guard = counting_op(dense)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        skm.reset_launches()
        fact, wall = timed(lambda: solve(guard))
        sk_launches = skm.LAUNCHES["sketch_matmat"]
        peak = torch.cuda.max_memory_allocated()
        err = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
        touches = {k: v for k, v in guard.counts.items() if v}
        print(f"phase 4: {method} {fields} wall {wall:.3f} s, iterations "
              f"{int(fact.iterations)}, max|sigma - sigma_true|/sigma_max "
              f"{err:.3e} (bound {bound}), operator touches {touches}, "
              f"sketch_matmat launches {sk_launches}, peak device memory "
              f"{peak / GIB:.2f} GiB (phase 3 {peak3 / GIB:.2f} GiB)",
              flush=True)
        check(err < bound, f"{method} sigma error {err:.3e} >= {bound}")
        check(peak < peak3 + 2 * GIB,
              f"{method} peak {peak / GIB:.2f} GiB: a copy of the operand?")
        if method == "gnystrom":
            launches = sk_launches
            check(touches == {"sketch_pass": 1},
                  f"gnystrom touched the operand {touches}")
            check(sk_launches == 3, f"gnystrom launched sketch_matmat "
                                    f"{sk_launches} times, not 3")
        if method == "rbk":
            sweeps = 2 * fields["passes"] + 1
            check(int(fact.iterations) == sweeps,
                  f"rbk reports {int(fact.iterations)} sweeps")
            check(sum(touches.values()) == sweeps,
                  f"rbk touched the operand {touches}")
        if method in ("gnystrom", "rbk"):
            skm.reset_launches()
            again, wall2 = timed(lambda: solve(dense))
            check(torch.equal(fact.s, again.s),
                  f"{method} sigma differs bitwise on a rerun")
            print(f"phase 4: {method} rerun wall {wall2:.3f} s, sigma "
                  f"bitwise equal", flush=True)
    return launches


def event_ms(fn, reps=10):
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(calls, reps=60, replays=5):
    """Device ms per call: ``reps`` calls, cycling through ``calls``,
    captured in one CUDA graph and replayed ``replays`` times between two
    CUDA events, so no host time between launches enters the figure."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up outside the capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()   # the graph's pool: a 32 GB output a call
    return ms


MAIN_GRAPH = (6, 2)       # graph_ms at the main shape: 32 GB a call
PROJ_COPIES = {"f32": 2, "bf16": 3}   # basis copies a timing cycles through:
                                      # together above the 50 MB L2


def proj_times(m, n, seed):
    """proj_qtv / proj_norm and their library yardsticks by device time
    (``graph_ms``) at both main-path shapes, the left basis Q (m, k+1) and
    the right basis P (n, k), f32 and bf16.  Each call finds its basis
    cold, as the main path does after a stage-1 sweep over A: the calls
    cycle through copies of the basis that together exceed the L2.  The
    back-to-back figure of ``event_ms`` is printed beside it as the host
    loop.  Returns the rows of the kernels line: ``ms`` is the f32 Q-side
    device time, ``device`` every shape's."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    out = {"proj_qtv": [], "proj_norm": []}
    for side, L, k in (("Q side", m, MAX_ITERS + 1), ("P side", n, MAX_ITERS)):
        u = torch.randn(L, generator=g, device=DEV)
        c = torch.randn(k, generator=g, device=DEV)
        basis = torch.linalg.qr(torch.randn(L, k, generator=g,
                                            device=DEV))[0].contiguous()
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            copies = [basis.to(dt, copy=True)
                      for _ in range(PROJ_COPIES[tag])]
            eb = copies[0].element_size()
            ub, cb = u.to(dt), c.to(dt)   # the library multiplies in dt
            cases = {
                "proj_qtv": (gs.proj_qtv, ref.proj_qtv,
                             lambda B: (lambda w: (w, torch.mv(B.T, w)))(
                                 torch.addmv(ub, B, cb, alpha=-1.0)),
                             4 * (2 * L + 2 * k), 4 * L * k + L),
                "proj_norm": (gs.proj_norm, ref.proj_norm,
                              lambda B: (lambda v: (v, torch.dot(v, v)))(
                                  torch.addmv(ub, B, cb, alpha=-1.0)),
                              4 * (2 * L + k + 1), 2 * L * k + 3 * L),
            }
            for name, (kern, plain, lib, vec_bytes, flops) in cases.items():
                nbytes = eb * L * k + vec_bytes
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / F32_FLOP_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                row = dict(
                    call=f"{side} {L}x{k} {tag}",
                    ms=graph_ms([lambda B=B: kern(u, B, c) for B in copies]),
                    library_ms=graph_ms([lambda B=B: lib(B)
                                         for B in copies]),
                    plain_ms=graph_ms([lambda B=B: plain(u, B, c)
                                       for B in copies]),
                    host_loop_ms=event_ms(lambda: kern(u, copies[0], c)),
                    host_loop_library_ms=event_ms(lambda: lib(copies[0])),
                    bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
                row["share_of_bound"] = bound / row["ms"]
                print(f"phase 3: {name} at {row['call']}, device time over "
                      f"{len(copies)} cold copies: kernel {row['ms']:.4f} ms "
                      f"({100 * row['share_of_bound']:.0f} % of the bound "
                      f"{bound:.4f} ms, {nbytes / row['ms'] / 1e6:.1f} "
                      f"GB/s), library {row['library_ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms; host loop (back to back, "
                      f"one basis): kernel {row['host_loop_ms']:.4f} ms, "
                      f"library {row['host_loop_library_ms']:.4f} ms",
                      flush=True)
                out[name].append(row)
            del copies
    rows = {}
    for name, calls in out.items():
        main = calls[0]                       # Q side, f32
        rows[name] = {key: main[key] for key in
                      ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                       "host_loop_ms")}
        rows[name]["device"] = calls
    return rows


def phase_times(A, seed):
    """Each stage-1 kernel at the main shape (f32 A, f32 bases of the
    main path's widths), its bound, its plain version and a PyTorch
    yardstick that computes the same function with library calls; then
    the projection pair by device time (``proj_times``)."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    m, n = A.shape
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    kq, kp = MAX_ITERS + 1, MAX_ITERS
    p = torch.randn(n, generator=g, device=DEV)
    q = torch.randn(m, generator=g, device=DEV)
    ym = torch.randn(m, generator=g, device=DEV)
    yn = torch.randn(n, generator=g, device=DEV)
    Q = torch.linalg.qr(torch.randn(m, kq, generator=g, device=DEV))[0]
    P = torch.linalg.qr(torch.randn(n, kp, generator=g, device=DEV))[0]
    Q, P = Q.contiguous(), P.contiguous()
    alpha = torch.tensor([0.37], device=DEV)
    f = 4  # bytes of an f32

    def lib_mv():
        u = torch.addmv(ym, A, p, beta=-0.37)
        return u, torch.mv(Q.T, u)

    def lib_rmv():
        v = torch.addmv(yn, A.T, q, beta=-1.7)
        return v, torch.mv(P.T, v)

    rows = {
        "mv_qtv": (lambda: gs.mv_qtv(A, p, ym, alpha, Q),
                   lambda: ref.mv_qtv(A, p, ym, alpha, Q), lib_mv,
                   f * (m * n + n + m + m * kq + 1 + m + kq),
                   2 * m * n + 2 * m + 2 * m * kq),
        "rmv_qtv": (lambda: gs.rmv_qtv(A, q, yn, 1.7, P),
                    lambda: ref.rmv_qtv(A, q, yn, 1.7, P), lib_rmv,
                    f * (m * n + m + n + n * kp + n + kp),
                    2 * m * n + 2 * n + 2 * n * kp),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops) in rows.items():
        k = kp if name == "rmv_qtv" else kq
        out[name] = time_row(name, kern, plain, lib, nbytes, flops,
                             f"({m}x{n}, k={k}, f32)", graph=MAIN_GRAPH)
    del Q, P
    out.update(proj_times(m, n, seed))
    return out


def csr_transpose(sk):
    """Tᵀ (d, N) of a sparse-sign pack as a CSR tensor (columns sorted
    within each row; colliding slots stay as separate entries, which
    SpMM sums) for the torch.sparse.mm yardstick."""
    import torch
    cols, order = torch.sort(sk.idx.long(), dim=1)
    vals = torch.gather(sk.signs.float(), 1, order)
    d, zeta = sk.idx.shape
    crow = torch.arange(0, d * zeta + 1, zeta, device=DEV)
    with warnings.catch_warnings():       # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols.reshape(-1),
                                       vals.reshape(-1), size=(d, sk.n),
                                       check_invariants=False)


def time_row(name, kern, plain, lib, nbytes, flops, shape, phase=3,
             graph=None):
    """One timing row: the kernel, its plain version and its library
    yardstick, each over 10 back-to-back calls between CUDA events (the
    host loop), beside the bound.  With ``graph=(reps, replays)`` the
    kernel and the library call are also timed by device time
    (``graph_ms``): ``ms`` and ``library_ms`` are then device times, and
    the host loop's figures stay as ``host_loop_ms`` and
    ``host_loop_library_ms``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    ms, plain_ms, lib_ms = event_ms(kern), event_ms(plain), event_ms(lib)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               nbytes=nbytes)
    if graph is None:
        print(f"phase {phase}: {name} at {shape}: kernel {ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{nbytes / ms / 1e6:.1f} GB/s, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms", flush=True)
        return row
    reps, replays = graph
    row.update(host_loop_ms=ms, host_loop_library_ms=lib_ms,
               ms=graph_ms([kern], reps, replays),
               library_ms=graph_ms([lib], reps, replays))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    share = 100 * row["share_of_bound"]
    print(f"phase {phase}: {name} at {shape}, device time ({reps} calls a "
          f"graph): kernel {row['ms']:.4f} ms ({share:.0f} % of the bound "
          f"{row['bound_ms']:.4f} ms, "
          f"{nbytes / row['ms'] / 1e6:.1f} GB/s), library "
          f"{row['library_ms']:.4f} ms; host loop "
          f"(10 back to back): kernel {ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    return row


def phase_times_new(A, seed):
    """matvec_fused / rmatvec_fused at the main shape (f32, library
    torch.addmv) and sketch_matmat at gnystrom's three main-path calls
    (library: a CSR torch.sparse.mm); the sketch_matmat row is the mean
    over the three calls of one solve."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch_matvec as skm
    m, n = A.shape
    g = torch.Generator(device=DEV).manual_seed(seed + 4)
    p = torch.randn(n, generator=g, device=DEV)
    q = torch.randn(m, generator=g, device=DEV)
    ym = torch.randn(m, generator=g, device=DEV)
    yn = torch.randn(n, generator=g, device=DEV)
    alpha = torch.tensor([0.37], device=DEV)
    f = 4
    out = {
        "matvec_fused": time_row(
            "matvec_fused", lambda: gs.matvec_fused(A, p, ym, alpha),
            lambda: ref.matvec_fused(A, p, ym, alpha),
            lambda: torch.addmv(ym, A, p, beta=-0.37),
            f * (m * n + n + m + 1 + m), 2 * m * n + 2 * m,
            f"({m}x{n}, f32)", graph=MAIN_GRAPH),
        "rmatvec_fused": time_row(
            "rmatvec_fused", lambda: gs.rmatvec_fused(A, q, yn, 1.7),
            lambda: ref.rmatvec_fused(A, q, yn, 1.7),
            lambda: torch.addmv(yn, A.T, q, beta=-1.7),
            f * (m * n + m + n + 1 + n), 2 * m * n + 2 * n,
            f"({m}x{n}, f32)", graph=MAIN_GRAPH),
    }
    k = SKETCH_SOLVES[0][1]["sketch_dim"]
    omega, psi = sketch_pack(g, n, k), sketch_pack(g, m, 2 * k)
    Y = skm.sketch_matmat(omega.signs, omega.idx, A.T,
                          omega.order).T                     # (m, k) view
    calls = [("range: Omega^T A^T, A^T a view", omega, A.T),
             ("co-range: Psi^T A, row-major", psi, A),
             ("core: Psi^T Y, Y a view", psi, Y)]
    rows = []
    for label, sk, X in calls:
        d, zeta = sk.idx.shape
        N, b = X.shape
        rows_read = int(torch.unique(sk.idx).numel())  # this draw's rows
        nbytes = d * zeta * 8 + rows_read * b * f + d * b * f
        Tt = csr_transpose(sk)
        row = time_row(
            f"sketch_matmat {label}",
            lambda sk=sk, X=X: skm.sketch_matmat(sk.signs, sk.idx, X,
                                                 sk.order),
            lambda sk=sk, X=X: ref.sketch_matmat(sk.signs, sk.idx, X),
            lambda Tt=Tt, X=X: torch.sparse.mm(Tt, X),
            nbytes, 2 * d * zeta * b, f"(X {N}x{b}, d={d}, f32)",
            graph=(60, 5))
        # the sector floor: one 32-byte sector per gathered element, or
        # per 8-element group of them where this draw's elements share one
        # (a transposed view gathers X[idx, c] along row c of the matrix
        # below; a row-major X streams whole rows)
        if X.stride(0) == 1:
            sectors = b * int(torch.unique(sk.idx // 8).numel())
        else:
            sectors = rows_read * -(-b * f // 32)
        floor_bytes = sectors * 32 + d * zeta * 8 + d * b * f
        row["sector_floor_ms"] = floor_bytes / HBM_BYTES_PER_S * 1e3
        extra = ""
        if X.stride(0) == 1 and X.shape[1] == m:
            # the same elements gathered by one PyTorch call (their
            # columns of A, in order): what this access pattern costs
            cols = torch.unique(sk.idx).long()
            row["gather_yardstick_ms"] = graph_ms(
                [lambda c=cols: A.index_select(1, c)], 60, 5)
            extra = (f"; A.index_select(1, this draw's {cols.numel()} "
                     f"columns), the same elements gathered, "
                     f"{row['gather_yardstick_ms']:.4f} ms")
        print(f"phase 3: sketch_matmat {label}: sector floor "
              f"{row['sector_floor_ms']:.4f} ms ({sectors} sectors), "
              f"kernel {row['ms'] / row['sector_floor_ms']:.2f}x it{extra}",
              flush=True)
        rows.append(row)
    mean = {key: sum(r[key] for r in rows) / len(rows)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "host_loop_ms", "sector_floor_ms")}
    mean["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows) else "operations"
    mean["calls"] = [dict({key: r[key] for key in
                           ("ms", "library_ms", "bound_ms", "sector_floor_ms",
                            "host_loop_ms")}, call=label,
                          **({"gather_yardstick_ms": r["gather_yardstick_ms"]}
                             if "gather_yardstick_ms" in r else {}))
                     for (label, _, _), r in zip(calls, rows)]
    out["sketch_matmat"] = mean
    print(f"phase 3: sketch_matmat per launch over one gnystrom solve "
          f"(mean of the three calls), device time: kernel "
          f"{mean['ms']:.4f} ms, bound {mean['bound_ms']:.4f} ms, library "
          f"{mean['library_ms']:.4f} ms; host loop: kernel "
          f"{mean['host_loop_ms']:.4f} ms, plain {mean['plain_ms']:.4f} ms",
          flush=True)
    return out


def phase_f64(seed, m, n):
    """The float64 leg: matvec_fused / rmatvec_fused against their plain
    versions on an f64 operand of numerical rank 100, then its F-SVD with
    backend="pallas", every half-step through them, and both kernels
    timed there.  Returns (launches, max abs errors, times)."""
    import torch
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    A, s_true = make_operand(seed + 5, m, n, dtype=torch.float64)
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    errs = check_matvecs(gen, m, n, torch.float64, A=A)
    print(f"phase 5: matvec_fused / rmatvec_fused on the f64 {m}x{n} "
          f"operand match the plain versions, bitwise stable; max abs err "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")
    gs.reset_launches()
    fact, wall = timed(lambda: factorize(
        A, spec, generator=torch.Generator(device=DEV).manual_seed(seed)))
    k = MAX_ITERS
    want = dict(dict.fromkeys(gs.LAUNCHES, 0), matvec_fused=k,
                rmatvec_fused=k - 1)
    check(gs.LAUNCHES == want, f"f64 launch counts {gs.LAUNCHES} != {want}")
    launches = {name: gs.LAUNCHES[name] for name in MATVECS}
    err = float((fact.s - s_true[:R_WANT]).abs().max()) / float(s_true[0])
    print(f"phase 5: fsvd f64 {m}x{n} ({A.numel() * 8 / 1e9:.2f} GB) wall "
          f"{wall:.3f} s, iterations {int(fact.iterations)}, breakdown "
          f"{bool(fact.breakdown)}, max|sigma - sigma_true|/sigma_max "
          f"{err:.3e} (bound {FSVD_STOL}), launches {launches}", flush=True)
    check(err < FSVD_STOL, f"f64 fsvd sigma error {err:.3e}")
    g = torch.Generator(device=DEV).manual_seed(seed + 7)
    p = torch.randn(n, generator=g, device=DEV)
    q = torch.randn(m, generator=g, device=DEV)
    ym = torch.randn(m, generator=g, device=DEV)
    yn = torch.randn(n, generator=g, device=DEV)
    pd, qd, ymd, ynd = p.double(), q.double(), ym.double(), yn.double()
    shape = f"({m}x{n}, f64 A; library in f64)"
    times = {
        "matvec_fused": time_row(
            "matvec_fused", lambda: gs.matvec_fused(A, p, ym, 0.37),
            lambda: ref.matvec_fused(A, p, ym, 0.37),
            lambda: torch.addmv(ymd, A, pd, beta=-0.37),
            8 * m * n + 4 * (n + 2 * m + 1), 2 * m * n + 2 * m, shape,
            phase=5, graph=(60, 5)),
        "rmatvec_fused": time_row(
            "rmatvec_fused", lambda: gs.rmatvec_fused(A, q, yn, 1.7),
            lambda: ref.rmatvec_fused(A, q, yn, 1.7),
            lambda: torch.addmv(ynd, A.T, qd, beta=-1.7),
            8 * m * n + 4 * (m + 2 * n + 1), 2 * m * n + 2 * n, shape,
            phase=5, graph=(60, 5)),
    }
    return launches, errs, times


# --- slice 3: sparse_matvec and lowrank_matmul ----------------------------

def sparse_coo(gen, m, n, density):
    """COO triplets of a random (m, n) matrix on the card: Bernoulli
    entries, the first two rows empty, entry 0 duplicated, and a shuffled
    entry order; int32 indices."""
    import torch
    A = torch.randn(m, n, generator=gen, device=DEV)
    A = A * (torch.rand(m, n, generator=gen, device=DEV) < density)
    A[:2] = 0
    idx = torch.nonzero(A)
    idx = torch.cat([idx, idx[:1]])
    idx = idx[torch.randperm(idx.shape[0], generator=gen, device=DEV)]
    return A[idx[:, 0], idx[:, 1]], idx.to(torch.int32)


def check_spmv(tag, vals, cols, X, layout=None):
    """sparse_matvec (through ``layout`` where given) against its plain
    version (bf16 values are widened exactly, so f32 bounds hold); returns
    the max abs error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_matvec as spm
    name = f"sparse_matvec {tag}" + (" windows" if layout else "")
    got = bitwise_twice(name, lambda: (spm.sparse_matvec(vals, cols, X,
                                                         layout),))
    err = compare(name, got, (ref.sparse_matvec(vals, cols, X),),
                  (torch.float32,))
    torch.cuda.synchronize()
    return err


def check_lowrank(tag, U, s, Vt):
    import torch
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import ref
    name = f"lowrank_matmul {tag}"
    got = bitwise_twice(name, lambda: (klu.lowrank_matmul(U, s, Vt),))
    err = compare(name, got, (ref.lowrank_matmul(U, s, Vt),),
                  (torch.float32,))
    torch.cuda.synchronize()
    return err


def phase_slice3_kernels(gen):
    """Phase 2 rows of sparse_matvec and lowrank_matmul on the shapes of
    tests/test_kernels.py (their main-path shapes come in phases 3b/6)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_matvec as spm
    n_cases = 0
    for m, n, density in SPARSE_SHAPES:
        data, idx = sparse_coo(gen, m, n, density)
        for vdt in (torch.float32, torch.bfloat16):
            for shape, ix in (((m, n), idx), ((n, m), idx.flip(1))):
                vals, cols = spm.ell_pack(data.to(vdt), ix, shape)
                for b in (1, 20):
                    X = torch.randn(shape[1], b, generator=gen, device=DEV)
                    X = X[:, 0].contiguous() if b == 1 else X
                    check_spmv(f"({shape[0]}x{shape[1]}, b={b}, {vdt})",
                               vals, cols, X)
                    n_cases += 1
                # the pack in the operator's order, through its layout
                lay = spm.window_layout(vals, cols, shape[1], torch.bincount(
                    ix[:, 0].long(), minlength=shape[0]))
                for b in (1,) + BLOCK_WIDTHS:
                    X = torch.randn(shape[1], b, generator=gen, device=DEV)
                    X = X[:, 0].contiguous() if b == 1 else X
                    check_spmv(f"({shape[0]}x{shape[1]}, b={b}, {vdt}, "
                               f"layout order)", lay.vals, lay.cols, X, lay)
                    n_cases += 1
    # long rows, each path: one vector and a 20-column block, over the
    # pack and over its window layout's pack
    for L in LONG_SLOTS:
        cols = torch.randint(0, LONG_N, (LONG_ROWS, L), generator=gen,
                             device=DEV, dtype=torch.int32)
        vals = torch.randn(LONG_ROWS, L, generator=gen, device=DEV)
        X = torch.randn(LONG_N, max(BLOCK_WIDTHS), generator=gen,
                        device=DEV)
        x = X[:, 0].contiguous()
        for vdt in (torch.float32, torch.bfloat16, torch.float64):
            v = vals.to(vdt)
            tag = f"({LONG_ROWS}x{LONG_N}, L={L}, {vdt})"
            lay = spm.window_layout(v, cols, LONG_N, torch.full(
                (LONG_ROWS,), L, device=DEV))
            check_spmv(tag + " b=1", v, cols, x)
            check_spmv(tag + " b=1", lay.vals, lay.cols, x, lay)
            check_spmv(tag + " b=20", v, cols, X[:, :20].contiguous())
            n_cases += 3
            for b in BLOCK_WIDTHS:
                check_spmv(tag + f" b={b} window order", lay.vals, lay.cols,
                           X[:, :b].contiguous(), lay)
                n_cases += 1
    # tests/test_kernels.py:232-242: empty rows and duplicates, exactly
    data = torch.tensor([1.0, 2.0, 3.0, 4.0], device=DEV)
    idx = torch.tensor([[0, 1], [0, 1], [3, 0], [3, 2]], dtype=torch.int32,
                       device=DEV)
    vals, cols = spm.ell_pack(data, idx, (5, 3))
    y = kops.sparse_matvec(vals, cols, torch.tensor([1.0, 10.0, 100.0],
                                                    device=DEV))
    check(y.tolist() == [30.0, 0.0, 0.0, 403.0, 0.0],
          f"sparse_matvec empty rows / duplicates gave {y.tolist()}")
    for m, n, r in LOWRANK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            U = torch.randn(m, r, generator=gen, device=DEV).to(dt)
            sv = torch.rand(r, generator=gen, device=DEV) + 0.5
            Vt = torch.randn(r, n, generator=gen, device=DEV).to(dt)
            check_lowrank(f"({m}x{n}, r={r}, {dt})", U, sv, Vt)
            check_lowrank(f"({m}x{n}, r={r}, {dt}, Vt a view)", U, sv,
                          Vt.T.contiguous().T)
            n_cases += 2
    print(f"phase 2: {n_cases + 1} shape/type cases of sparse_matvec (both "
          f"packs, b = 1 and 20, f32/bf16 values, empty rows and "
          f"duplicates, in COO order and through the layout at b = 1 and "
          f"{BLOCK_WIDTHS}; long rows of {LONG_SLOTS} slots in "
          f"f32/bf16/f64 in COO and in window order) and lowrank_matmul "
          f"(f32/bf16, row-major and transposed-view Vt) match the plain "
          f"versions, bitwise stable",
          flush=True)


# --- slice 4: the reorth pair and scatter_add ------------------------------

def check_reorth(tag, Q, v, c):
    """qtv, subtract_qc and ops.reorth (passes 1, 2) on one basis against
    their plain versions (rtol 1e-5 in f32, 3e-2 with a bf16 basis),
    each twice bitwise; returns {kernel: max abs error}."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import reorth as kro
    dts = (Q.dtype,)
    errs = {}
    for name, kern, plain in (
            ("qtv", lambda: (kro.qtv(Q, v),), lambda: (ref.qtv(Q, v),)),
            ("subtract_qc", lambda: (kro.subtract_qc(v, Q, c),),
             lambda: (ref.subtract_qc(v, Q, c),))):
        got = bitwise_twice(f"{name} {tag}", kern)
        errs[name] = compare(f"{name} {tag}", got, plain(), dts)
    for passes in (1, 2):
        got = bitwise_twice(f"reorth p={passes} {tag}",
                            lambda: (kops.reorth(v, Q, passes),))
        compare(f"reorth p={passes} {tag}", got,
                (ref.reorth(v, Q, passes),), dts)
    torch.cuda.synchronize()
    return errs


def check_scatter(tag, rows, cols, vals, shape):
    """scatter_add twice (bitwise) against its plain version on the CPU,
    bit for bit: the kernel sums every cell in entry order, as index_add_
    does there.  Returns the panel."""
    import torch
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ref
    name = f"scatter_add {tag}"
    got = bitwise_twice(name, lambda: (kcs.scatter_add(rows, cols, vals,
                                                       shape),))[0]
    want = ref.scatter_add(rows.cpu(), cols.cpu(), vals.cpu(), shape)
    err = float((got.cpu() - want).abs().max()) if want.numel() else 0.0
    check(torch.equal(got.cpu(), want),
          f"{name}: differs from the CPU plain version (max abs {err:.3e})")
    return got


def phase_slice4_kernels(gen):
    """Phase 2 rows of qtv / subtract_qc / ops.reorth and scatter_add on
    the shapes of tests/test_kernels.py (their main-path shapes come in
    phases 6 and 7)."""
    import torch
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    n_cases = 0
    for m, k in REORTH_SHAPES:
        for qdt in (torch.float32, torch.bfloat16):
            Q = torch.linalg.qr(torch.randn(m, k, generator=gen,
                                            device=DEV))[0]
            Q = Q.to(qdt).contiguous()
            v = torch.randn(m, generator=gen, device=DEV)
            c = torch.randn(k, generator=gen, device=DEV)
            check_reorth(f"({m}x{k}, {qdt})", Q, v, c)
            n_cases += 1

    def stream(E, m, d):
        rows = torch.randint(0, m, (E,), generator=gen, device=DEV,
                             dtype=torch.int32)
        cols = torch.randint(0, d, (E,), generator=gen, device=DEV,
                             dtype=torch.int32)
        return rows, cols, torch.randn(E, generator=gen, device=DEV)

    for E, m, d in SCATTER_SHAPES:
        check_scatter(f"({E} entries, {m}x{d})", *stream(E, m, d), (m, d))
        n_cases += 1
    # tests/test_kernels.py:324-340: forced duplicates, dyadic values
    t = lambda x, dt: torch.tensor(x, dtype=dt, device=DEV)  # noqa: E731
    i32, f32 = torch.int32, torch.float32
    got = check_scatter(
        "dyadic duplicates", t([3, 3, 3, 0, 3, 1, 1], i32),
        t([1, 1, 1, 0, 1, 2, 2], i32),
        t([0.25, 0.5, 1.25, -2.0, -0.75, 8.0, -8.0], f32), (5, 4))
    check((got[3, 1].item(), got[1, 2].item(), got[0, 0].item())
          == (1.25, 0.0, -2.0), "scatter_add dyadic duplicates gave "
          f"{got.tolist()}")
    # :343-357: the empty stream (no launch) and an all-at-(0, 0) stream
    empty = torch.zeros(0, dtype=i32, device=DEV)
    kcs.reset_launches()
    z = kops.scatter_add(empty, empty, torch.zeros(0, device=DEV), (4, 6))
    check(kcs.LAUNCHES["scatter_add"] == 0 and not z.any()
          and z.shape == (4, 6), "scatter_add of an empty stream")
    zeros = torch.zeros(200, dtype=i32, device=DEV)
    got = check_scatter("all at (0, 0)", zeros, zeros,
                        torch.ones(200, device=DEV), (3, 3))
    check(got[0, 0].item() == 200.0 and got.abs().sum().item() == 200.0,
          f"scatter_add all at (0, 0) gave {got.tolist()}")
    # coordinates outside the panel (past the end, negative) are dropped
    got = check_scatter(
        "outside the panel", t([0, 2, 5, 1, -1, 3, 1], i32),
        t([0, 3, 0, 4, 1, -2, 1], i32),
        t([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 0.5], f32), (4, 4))
    want = torch.zeros(4, 4)
    want[0, 0], want[2, 3], want[1, 1] = 1.0, 2.0, 0.5
    check(torch.equal(got.cpu(), want),
          f"scatter_add kept a coordinate outside the panel: {got.tolist()}")
    E, m, d = SCATTER_GAUSSIAN
    rows, cols, vals = stream(E, m, d)
    check_scatter(f"Gaussian ({E} entries, {m}x{d})", rows, cols, vals,
                  (m, d))
    n_cases += 5
    # the binning (steps 1-4) against its plain model, bins of many tiles
    widths = set()
    for E2, m2, d2, bits in BIN_SHAPES:
        r2, c2, v2 = (x.to(dt) for x, dt in zip(
            stream(E2, m2 + 2, d2 + 2), (i32, i32, torch.float64)))
        plan = kcs.bin_plan(E2, (m2, d2), bits)
        got = kcs.bin_entries(r2, c2, v2, plan)
        want = ref.bin_entries(r2.cpu(), c2.cpu(), v2.cpu(), (m2, d2),
                               plan.part_bits)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"bin_entries ({E2} entries, {m2}x{d2}, bins of 2^"
              f"{plan.bin_bits} cells in parts of 2^{plan.part_bits}) "
              f"differs from its plain model")
        widths.add(1 << (plan.bin_bits - plan.tile_bits))
        n_cases += 1
    check(widths == {1, 8, 128}, f"the binning cases took bins of {widths} "
                                 f"tiles")
    # skew: the Gaussian stream's values all into one tile, then one cell
    def times(r, c):
        return event_ms(lambda: kcs.scatter_add(r, c, vals, (m, d)), reps=3)

    t_spread = times(rows, cols)
    corner = torch.randint(0, 3, (E,), generator=gen, device=DEV, dtype=i32)
    check_scatter(f"{E} entries in a 3x3 corner", corner, corner.flip(0),
                  vals, (m, d))
    t_corner = times(corner, corner.flip(0))
    zeros = torch.zeros(E, dtype=i32, device=DEV)
    check_scatter(f"{E} entries at (0, 0)", zeros, zeros, vals, (m, d))
    t_cell = times(zeros, zeros)
    n_cases += 2
    print(f"phase 2: {n_cases} shape/type cases of qtv / subtract_qc / "
          f"ops.reorth (f32 and bf16 bases, passes 1 and 2), scatter_add "
          f"(dyadic duplicates, empty, all at (0, 0), outside the panel, a "
          f"{E}-entry Gaussian stream, the same into a 3x3 corner and into "
          f"one cell) and the binning into bins of {sorted(widths)} tiles "
          f"match the "
          f"plain versions, scatter_add bit for bit against the CPU, "
          f"bitwise stable; scatter_add of the {E}-entry stream spread over "
          f"{m}x{d} {t_spread:.4f} ms, in a 3x3 corner (one tile) "
          f"{t_corner:.4f} ms, in one cell {t_cell:.4f} ms", flush=True)


def exact_update_sigma(fact, C, sd, Dt, beta):
    """sigma of beta U S V^T + C diag(sd) Dt, independently in f64: the
    Householder QRs of [U | C] and [V | Dt^T], then svdvals of the small
    core."""
    import torch
    Ra = torch.linalg.qr(torch.cat([fact.U, C], 1).double())[1]
    Rb = torch.linalg.qr(torch.cat([fact.V, Dt.T], 1).double())[1]
    core = torch.cat([beta * fact.s.double(), sd.double()])
    return torch.linalg.svdvals(Ra @ torch.diag(core) @ Rb.T)


def orthonormal_bases(fact):
    """The same operator U S V^T with bases orthonormal to f32 rounding:
    U = Q_U R_U and V = Q_V R_V in f64, then the SVD of R_U S R_V^T (the
    update's precondition; the reference's update assumes it)."""
    import torch
    from repro_torch.api import Factorization
    Qu, Ru = torch.linalg.qr(fact.U.double())
    Qv, Rv = torch.linalg.qr(fact.V.double())
    X, sx, Yt = torch.linalg.svd(Ru @ torch.diag(fact.s.double()) @ Rv.T)
    return Factorization((Qu @ X).float(), sx.float(), (Qv @ Yt.T).float(),
                         fact.iterations, fact.breakdown, method=fact.method)


def defect(Q):
    """||Q^T Q - I||_2 in f64."""
    import torch
    G = Q.double().T @ Q.double()
    return float(torch.linalg.matrix_norm(
        G - torch.eye(G.shape[0], dtype=G.dtype, device=G.device), ord=2))


def update_with_inputs(f, delta, beta):
    """update_factorization(backend="pallas") of f by delta, timed, with
    the launch count and the arguments its one lowrank_matmul launch was
    given (the core's Chat, ones and the transposed view Dhat.T)."""
    from repro_torch.api import update_factorization
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import ops as kops
    seen = []
    real = kops.lowrank_matmul

    def spy(U, s, Vt):
        seen.append((U, s, Vt))
        return real(U, s, Vt)

    kops.lowrank_matmul = spy
    try:
        klu.reset_launches()
        upd, wall = timed(lambda: update_factorization(
            f, delta, beta=beta, backend="pallas"))
        launches = klu.LAUNCHES["lowrank_matmul"]
    finally:
        kops.lowrank_matmul = real
    return upd, wall, launches, seen


def update_in_f64(f, C, sd, Dt, beta):
    """The same update on the same bases, every step in float64 (the
    plain core product): what the f32 pallas run would give without its
    own rounding."""
    import torch
    from repro_torch.api import Factorization, LowRankOp, update_factorization
    f64 = Factorization(f.U.double(), f.s.double(), f.V.double(),
                        f.iterations, f.breakdown, method=f.method)
    return update_factorization(
        f64, LowRankOp(C.double(), sd.double(), Dt.double()), beta=beta,
        backend="xla").s.to(torch.float64)


def phase_update(fact, seed):
    """update_factorization of phase 3's r = 20 factorization by a seeded
    rank-10 drift.  The core product's kernel is held against its plain
    version on the arguments the update gave it.  The f32 fsvd's bases
    are not orthonormal to f32 rounding; the port's update thin-QRs them
    first, so the raw run is gated against the exact sigma of
    beta U S V^T + C diag(s) Dt, and also against the same update in f64
    on those bases (the port's own rounding); the bases orthonormalized in
    f64 beforehand are gated against exact sigma too.  Returns (launches,
    wall seconds, sigma error of the raw run against f64, the drift)."""
    import torch
    from repro_torch.api import LowRankOp
    m, n = fact.shape
    smax = float(fact.s[0])
    g = torch.Generator(device=DEV).manual_seed(seed + 8)
    C = torch.randn(m, DELTA_RANK, generator=g, device=DEV) / m ** 0.5
    Dt = torch.randn(DELTA_RANK, n, generator=g, device=DEV) / n ** 0.5
    sd = 1e-2 * smax * torch.linspace(1.0, 0.5, DELTA_RANK, device=DEV)
    delta, beta = LowRankOp(C, sd, Dt), DRIFT_BETA
    r = fact.rank
    errs = {}
    for name, f in (("raw", fact), ("orthonormal", orthonormal_bases(fact))):
        upd, wall, launches, seen = update_with_inputs(f, delta, beta)
        check(int(upd.iterations) == 0, "the update ran GK iterations")
        check(launches == 1, f"update launched lowrank_matmul {launches} "
                             f"times")
        (Uc, ones, Vc), = seen
        core_err = check_lowrank(
            f"update core ({Uc.shape[0]}x{Vc.shape[1]}, r={Uc.shape[1]}, "
            f"Vt a view {tuple(Vc.stride())})", Uc, ones, Vc)
        s_exact = exact_update_sigma(f, C, sd, Dt, beta)
        s64 = update_in_f64(f, C, sd, Dt, beta)
        errs[name] = {
            "exact": float((upd.s.double() - s_exact[:r]).abs().max()
                           / s_exact[0]),
            "f64": float((upd.s.double() - s64).abs().max() / s_exact[0]),
            "f64_exact": float((s64 - s_exact[:r]).abs().max()
                               / s_exact[0])}
        e = errs[name]
        print(f"phase 3b: update_factorization ({name} bases: "
              f"||U^T U - I|| {defect(f.U):.3e}, ||V^T V - I|| "
              f"{defect(f.V):.3e}; r = {r}, rank-{DELTA_RANK} drift, beta "
              f"{beta}) wall {wall * 1e3:.3f} ms, iterations "
              f"{int(upd.iterations)}, lowrank_matmul launches {launches} "
              f"(core {tuple(Uc.shape)} x {tuple(Vc.shape)} matches its "
              f"plain version, max abs err {core_err:.3e}, bitwise "
              f"stable); max|sigma - .|/sigma_max: vs the f64 update on "
              f"the same bases {e['f64']:.3e}, vs exact {e['exact']:.3e} "
              f"(f64 update vs exact {e['f64_exact']:.3e})", flush=True)
    raw, orth = errs["raw"]["f64"], errs["orthonormal"]["exact"]
    exact = errs["raw"]["exact"]
    print(f"phase 3b: gate {UPDATE_GATE}: raw bases vs exact {exact:.3e}, "
          f"raw bases vs the f64 update {raw:.3e}, orthonormal bases vs "
          f"exact {orth:.3e}", flush=True)
    check(exact < UPDATE_GATE, f"update sigma error (raw bases) vs exact "
                               f"{exact:.3e}")
    check(raw < UPDATE_GATE, f"update sigma error vs f64 {raw:.3e}")
    check(orth < UPDATE_GATE, f"update sigma error vs exact {orth:.3e}")
    return launches, wall, raw, delta


def phase_materialize(seed, m, n):
    """materialize_lowrank of a rank-20 LowRankOp at (m, n) through the
    kernel, held against the plain version by row blocks (no second
    (m, n) buffer), then timed beside its bound, the plain version and
    torch.matmul(U*s, Vt).  Returns (launches, max abs error, times)."""
    import torch
    from repro_torch.api import LowRankOp
    from repro_torch.core.update import materialize_lowrank
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEV).manual_seed(seed + 10)
    r = R_WANT
    U = torch.randn(m, r, generator=g, device=DEV)
    sv = torch.rand(r, generator=g, device=DEV) + 0.5
    Vt = torch.randn(r, n, generator=g, device=DEV)
    delta = LowRankOp(U, sv, Vt)
    klu.reset_launches()
    W, wall = timed(lambda: materialize_lowrank(delta, backend="pallas"))
    launches = klu.LAUNCHES["lowrank_matmul"]
    check(launches == 1, f"materialize launched lowrank_matmul {launches}")
    rows = 1 << 13
    err = 0.0
    for r0 in range(0, m, rows):
        err = max(err, compare(f"materialize_lowrank rows {r0}+",
                               (W[r0:r0 + rows],),
                               (ref.lowrank_matmul(U[r0:r0 + rows], sv, Vt),),
                               (torch.float32,)))
    again = klu.lowrank_matmul(U, sv, Vt)
    check(torch.equal(W, again), "lowrank_matmul differs bitwise on a rerun")
    del W, again
    torch.cuda.empty_cache()
    print(f"phase 3c: materialize_lowrank {m}x{n} r = {r} "
          f"({m * n * 4 / 1e9:.1f} GB) wall {wall * 1e3:.3f} ms, launches "
          f"{launches}, matches the plain version by row blocks (max abs "
          f"err {err:.3e}), bitwise stable", flush=True)
    row = time_row("lowrank_matmul", lambda: klu.lowrank_matmul(U, sv, Vt),
                   lambda: ref.lowrank_matmul(U, sv, Vt),
                   lambda: torch.matmul(U * sv, Vt),
                   4 * (m * r + r + r * n + m * n), 2 * m * n * r,
                   f"({m}x{n}, r={r}, f32)", phase="3c", graph=MAIN_GRAPH)
    torch.cuda.empty_cache()
    return launches, err, row


# --- phase 2 (stacked) and phase 8: the plan --------------------------------

def check_batched(gen, m, n, k, adt, qdt, B, A=None, kp=None):
    """The four GK-step stages on a stack of B examples, and the
    projection pair on the P side's basis too: one launch a call for the
    whole stack, each example bit for bit a single launch on it, the
    stack within phase 2's tolerance of its stacked plain version and
    bitwise stable; returns {kernel: max abs error}.  ``A`` (B, m, n)
    defaults to a random stack; the Q side's basis has k columns, the P
    side's ``kp`` (default k)."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref

    def t(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=DEV).to(dt)

    kp = k if kp is None else kp
    A = t(B, m, n, dt=adt) if A is None else A
    p, q, ym, yn = t(B, n), t(B, m), t(B, m), t(B, n)
    al, c = t(B), t(B, k)
    Q, P = t(B, m, k, dt=qdt), t(B, n, kp, dt=qdt)
    cp = t(B, kp)
    tag = f"(B={B}, {m}x{n}, k={k}/{kp}, A {adt}, basis {qdt})"
    cases = {
        "mv_qtv": (lambda: gs.mv_qtv(A, p, ym, al, Q),
                   lambda b: gs.mv_qtv(A[b], p[b], ym[b], al[b], Q[b]),
                   lambda: ref.mv_qtv(A, p, ym, al, Q), (adt, qdt)),
        "rmv_qtv": (lambda: gs.rmv_qtv(A, q, yn, al, P),
                    lambda b: gs.rmv_qtv(A[b], q[b], yn[b], al[b], P[b]),
                    lambda: ref.rmv_qtv(A, q, yn, al, P), (adt, qdt)),
        "proj_qtv": (lambda: gs.proj_qtv(ym, Q, c),
                     lambda b: gs.proj_qtv(ym[b], Q[b], c[b]),
                     lambda: ref.proj_qtv(ym, Q, c), (qdt,)),
        "proj_norm": (lambda: gs.proj_norm(ym, Q, c),
                      lambda b: gs.proj_norm(ym[b], Q[b], c[b]),
                      lambda: ref.proj_norm(ym, Q, c), (qdt,)),
        # the pair on the P side's basis, as the batched solve runs it
        "proj_qtv P": (lambda: gs.proj_qtv(yn, P, cp),
                       lambda b: gs.proj_qtv(yn[b], P[b], cp[b]),
                       lambda: ref.proj_qtv(yn, P, cp), (qdt,)),
        "proj_norm P": (lambda: gs.proj_norm(yn, P, cp),
                        lambda b: gs.proj_norm(yn[b], P[b], cp[b]),
                        lambda: ref.proj_norm(yn, P, cp), (qdt,)),
    }
    errs = {}
    for case, (stacked, single, plain, dts) in cases.items():
        name = case.split()[0]
        before = gs.LAUNCHES[name]
        got = bitwise_twice(f"stacked {case} {tag}", stacked)
        check(gs.LAUNCHES[name] == before + 2,
              f"stacked {case} {tag}: not one launch a call")
        for b in range(B):
            for x, y in zip(got, single(b)):
                check(torch.equal(x[b], y), f"stacked {case} {tag}: example "
                                            f"{b} differs bitwise from a "
                                            f"single launch on it")
        errs[name] = max(errs.get(name, 0.0),
                         compare(f"stacked {case} {tag}", got, plain(), dts))
    torch.cuda.synchronize()
    return errs


def phase_batched_kernels(gen, logs):
    """Phase 2 rows of the stacked launches: BATCH_SHAPES x (f32, bf16) A
    x (f32, bf16) basis x BATCHES; the ptxas report of their kernels shows
    no spills.  Returns ({kernel: max abs error}, cases)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    spills = [line for log in logs.values() for line in ptxas_report(log)
              if re.search(BATCHED_KERNELS, line)
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    check(not spills, f"the batched launches' kernels spill: {spills}")
    errs, n_cases = {name: 0.0 for name in GK_STEP}, 0
    for m, n, k in BATCH_SHAPES:
        for adt in (f32, bf16):
            for qdt in (f32, bf16):
                for B in BATCHES:
                    for name, e in check_batched(gen, m, n, k, adt, qdt,
                                                 B).items():
                        errs[name] = max(errs[name], e)
                    n_cases += 1
    print(f"phase 2: {n_cases} stacked shape/type cases (B = "
          f"{', '.join(map(str, BATCHES))}; f32 / bf16 A and basis) x 4 "
          f"kernels: one launch a call for the stack, every example bit for "
          f"bit a single launch on it, within tolerance of the stacked "
          f"plain versions, bitwise stable, no spills; max abs err "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return errs, n_cases


def gk_step_want(k, passes):
    """Launch counts of a k-step in-graph GK loop (batched or not)."""
    return {"mv_qtv": k, "rmv_qtv": k - 1,
            "proj_qtv": (2 * k - 1) * (passes - 1), "proj_norm": 2 * k - 1}


def plan_solves(A, seed, walls3):
    """Two solves through one plan (one trace, a miss then a hit, phase
    3's launch counts each), the first bit for bit a direct call of the
    registered solver, its wall within PLAN_WALL_SLACK of phase 3's."""
    import torch
    from repro_torch.api import (SVDSpec, clear_plan_cache, get_solver, plan,
                                 plan_cache_stats, trace_count)
    from repro_torch.core.operators import DenseOp
    from repro_torch.kernels import gk_step as gs
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")
    want = dict(gk_step_want(MAX_ITERS, spec.reorth_passes),
                matvec_fused=0, rmatvec_fused=0)
    clear_plan_cache(reset_stats=True)
    p = plan(spec, like=A)
    facts, walls = [], []
    for s in (seed, seed + 20):
        gs.reset_launches()
        f, w = timed(lambda: p.solve(
            A, generator=torch.Generator(device=DEV).manual_seed(s)))
        check(dict(gs.LAUNCHES) == want,
              f"plan.solve launch counts {dict(gs.LAUNCHES)} != {want}")
        facts.append(f)
        walls.append(w)
    stats = plan_cache_stats()
    check(trace_count() == 1 and stats["misses"] == 1
          and stats["hits"] == 1, f"two plan solves: {stats}")
    direct, wall_d = timed(lambda: get_solver("fsvd")(
        DenseOp(A, backend="pallas"), spec,
        generator=torch.Generator(device=DEV).manual_seed(seed)))
    check(torch.equal(direct.s, facts[0].s),
          "plan.solve's sigma differs bitwise from the direct solver call")
    ratio = min(walls) / min(walls3)
    print(f"phase 8: plan.solve x 2 (fsvd, {A.shape[0]}x{A.shape[1]}): "
          f"walls {walls[0]:.3f} / {walls[1]:.3f} s (phase 3 "
          f"{walls3[0]:.3f} / {walls3[1]:.3f} s, best over best "
          f"{ratio:.4f}; the direct solver call {wall_d:.3f} s), traces 1, "
          f"cache {stats['misses']} miss / {stats['hits']} hit, launches "
          f"{ {k: want[k] for k in GK_STEP} } each, sigma bit for bit the "
          f"direct call's", flush=True)
    check(ratio <= 1 + PLAN_WALL_SLACK,
          f"plan.solve wall {min(walls):.3f} s vs phase 3's "
          f"{min(walls3):.3f} s")
    return p, facts[0], walls


def plan_updates(p, fact, drift):
    """plan.update of phase 3b's drift at two decay factors: one trace, one
    lowrank_matmul launch and 0 iterations each, sigma on the raw bases
    within UPDATE_GATE of the exact sigma of the factored operator."""
    from repro_torch.api import trace_count
    from repro_torch.kernels import lowrank_update as klu
    t0, rows = trace_count(), []
    for beta in (DRIFT_BETA, 0.5):
        klu.reset_launches()
        upd, wall = timed(lambda: p.update(fact, drift, beta=beta))
        check(int(upd.iterations) == 0, "plan.update ran GK iterations")
        check(klu.LAUNCHES["lowrank_matmul"] == 1,
              f"plan.update launched lowrank_matmul "
              f"{klu.LAUNCHES['lowrank_matmul']} times")
        s_ex = exact_update_sigma(fact, drift.U, drift.s, drift.Vt, beta)
        err = float((upd.s.double() - s_ex[:fact.rank]).abs().max()
                    / s_ex[0])
        rows.append((beta, wall, err))
        check(err < UPDATE_GATE, f"plan.update (beta {beta}) sigma vs exact "
                                 f"{err:.3e} >= {UPDATE_GATE}")
    traces = trace_count() - t0
    check(traces == 1, f"two plan updates traced {traces} times")
    print("phase 8: plan.update (raw bases, rank-10 drift): "
          + "; ".join(f"beta {b}: wall {w * 1e3:.3f} ms, max|sigma - exact|"
                      f"/sigma_max {e:.3e}" for b, w, e in rows)
          + f" (gate {UPDATE_GATE}); 1 lowrank_matmul launch and 0 "
          f"iterations each, 1 trace", flush=True)
    return max(e for _, _, e in rows)


def plan_estimates(A, seed):
    """plan.estimate in-graph (host_loop=False) twice: rank 100 both
    times, one trace."""
    import torch
    from repro_torch.api import SVDSpec, plan, trace_count
    p = plan(SVDSpec(max_iters=RANK_ITERS, backend="pallas",
                     host_loop=False), like=A)
    t0, rows = trace_count(), []
    for s in (seed, seed + 21):
        est, wall = timed(lambda: p.estimate(
            generator=torch.Generator(device=DEV).manual_seed(s)))
        check(int(est) == RANK, f"plan.estimate returned {int(est)}")
        rows.append(wall)
    check(trace_count() - t0 == 1, "two in-graph estimates traced "
                                   f"{trace_count() - t0} times")
    print(f"phase 8: plan.estimate (host_loop=False, max_iters "
          f"{RANK_ITERS}) x 2: rank {RANK} both, walls "
          + " / ".join(f"{w:.3f}" for w in rows) + " s, 1 trace", flush=True)
    return rows


def plan_failpoint(p, A, seed):
    """Under an armed plan.solve failpoint, solve raises FaultInjected and
    launches nothing; the failpoint is disarmed after."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.runtime import faults
    gs.reset_launches()
    raised = False
    with faults.inject(faults.PLAN_SOLVE, mode="raise"):
        try:
            p.solve(A, generator=torch.Generator(device=DEV).manual_seed(seed))
        except faults.FaultInjected:
            raised = True
    check(raised, "plan.solve did not raise under its armed failpoint")
    check(not any(gs.LAUNCHES.values()),
          f"a failed plan.solve launched {dict(gs.LAUNCHES)}")
    check(not faults.armed(faults.PLAN_SOLVE), "the failpoint stayed armed")
    print("phase 8: failpoint plan.solve (mode raise): FaultInjected, no "
          "launch, disarmed after", flush=True)


def serve_operands(seed, B, shape, rank):
    """B low-rank-plus-noise operands with a geometric spectrum, as
    serve/traffic.py's lowrank_operand makes them, and B start vectors."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    m, n = shape
    U = torch.randn(B, m, rank, generator=g, device=DEV)
    V = torch.randn(B, n, rank, generator=g, device=DEV)
    s = torch.logspace(0.0, -2.0, rank, device=DEV)
    A = (U * s) @ V.transpose(1, 2) \
        + SERVE_NOISE * torch.randn(B, m, n, generator=g, device=DEV)
    q1s = 2.0 + torch.randn(B, m, generator=g, device=DEV)
    return A.contiguous(), q1s


def batched_vs_singles(label, As, q1s, spec):
    """solve_batched over the stack beside a loop of single plan solves
    from the same start vectors: one batched call a stage (a single
    solve's launch counts), sigma per example within BATCH_SIGMA of its
    single solve (and whether bitwise), host walls of both, and the GK
    loops' device time (each captured in a CUDA graph: every launch but
    the Ritz step's, no host time)."""
    import torch
    from repro_torch.api import plan
    from repro_torch.core import gk as gk_mod
    from repro_torch.core.operators import DenseOp
    from repro_torch.kernels import gk_step as gs
    B = As.shape[0]
    p = plan(spec)
    p.solve_batched(As, q1s=q1s)              # warm: builds the runner
    for b in range(B):
        p.solve(As[b], q1=q1s[b])
    gs.reset_launches()
    fb, wall_b = timed(lambda: p.solve_batched(As, q1s=q1s))
    launches = {name: gs.LAUNCHES[name] for name in GK_STEP}
    want = gk_step_want(spec.max_iters, spec.reorth_passes)
    check(launches == want, f"{label}: solve_batched launches {launches} != "
                            f"a single solve's {want}")
    singles, wall_s = timed(lambda: [p.solve(As[b], q1=q1s[b])
                                     for b in range(B)])
    errs = [float((fb.s[b] - f.s).abs().max()) / float(f.s[0])
            for b, f in enumerate(singles)]
    bitwise = all(torch.equal(fb.s[b], f.s) for b, f in enumerate(singles))
    check(max(errs) < BATCH_SIGMA, f"{label}: batched sigma vs single "
                                   f"{max(errs):.3e} >= {BATCH_SIGMA}")
    op = DenseOp(As, backend="pallas")
    ones = [DenseOp(As[b], backend="pallas") for b in range(B)]
    dev_b = graph_ms([lambda: gk_mod.gk_bidiag_batched(
        op, spec.max_iters, q1s=q1s)], reps=1, replays=5)
    dev_s = graph_ms([lambda: [gk_mod.gk_bidiag(o, spec.max_iters,
                                                q1=q1s[b])
                               for b, o in enumerate(ones)]],
                     reps=1, replays=5)
    row = dict(call=label, B=B, wall_ms=wall_b * 1e3,
               singles_wall_ms=wall_s * 1e3, device_ms=dev_b,
               singles_device_ms=dev_s,
               launch_bound_share=1 - dev_b / (wall_b * 1e3),
               singles_launch_bound_share=1 - dev_s / (wall_s * 1e3),
               max_sigma_err=max(errs), bitwise=bitwise, launches=launches)
    print(f"phase 8: solve_batched {label}: wall {row['wall_ms']:.3f} ms "
          f"(loop of {B} plan.solve {row['singles_wall_ms']:.3f} ms); GK "
          f"loop device time {dev_b:.3f} ms (loop of singles {dev_s:.3f} "
          f"ms), so {100 * row['launch_bound_share']:.1f} % of the batched "
          f"wall ({100 * row['singles_launch_bound_share']:.1f} % of the "
          f"loop's) is host time; launches {launches} (a single solve's); "
          f"max|sigma_b - sigma_single|/sigma_max {max(errs):.3e} (bound "
          f"{BATCH_SIGMA}), bitwise {bitwise}", flush=True)
    return fb, row


STAGE_BATCHES = (2, 4, 8)     # phase 8's stage times: the server's
                              # dispatches run B <= 4, the big batch 8
COLD_BYTES = 100e6            # a cold-L2 timing cycles through stacks of
                              # at least this much (twice the 50 MB L2)


def proj_library(u, X, c, norm):
    """The yardstick of rows 3-4 on a stack: w = u - X c by
    ``torch.baddbmm``, then Xᵀw or wᵀw by ``torch.bmm``."""
    import torch
    w = torch.baddbmm(u[:, :, None], X, c[:, :, None], alpha=-1.0)
    return w, torch.bmm(w.transpose(1, 2), w) if norm \
        else torch.bmm(X.transpose(1, 2), w)


def basis_copies(X):
    """``X`` and copies of it, at least three and ``COLD_BYTES`` in all,
    so a timing that cycles through them reads each from device memory."""
    n = max(3, -(-int(COLD_BYTES) // (X.numel() * X.element_size())))
    return [X] + [X.clone() for _ in range(n - 1)]


def batched_stage_times(As, seed, k, batches=STAGE_BATCHES):
    """Each GK-step stage at the big batch's solve shapes by device time
    (``graph_ms``), for the first B examples of the stack for each B of
    ``batches`` the stack holds: the stacked call, B single launches,
    one single launch and the stacked plain version (``kernels.ref``),
    beside the bound (B x each input byte read and each output byte
    written once at 3.35 TB/s) and the yardstick of rows 1-4 applied to
    the whole stack in batched library calls (``torch.baddbmm`` for the
    matvec or the projection's update, then ``torch.bmm`` for the basis
    product or the norm): two calls where the kernel is one.  The
    projection pair runs on the Q side's basis (k + 1 columns) and, as
    "proj_qtv P" / "proj_norm P", on the P side's (k); its rows add the
    kernel and the library with a cold L2 (``cold_ms``,
    ``library_cold_ms``: one graph cycling through ``basis_copies`` of
    the stack's basis), where the warm figures replay one call on the
    same basis.  Returns {stage: the largest B's row, with every B's row
    under ``by_batch``}."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    m, n = As.shape[1:]
    g = torch.Generator(device=DEV).manual_seed(seed + 30)
    kq, kp = k + 1, k
    f = 4

    def t(*shape):
        return torch.randn(*shape, generator=g, device=DEV)

    batches = [B for B in batches if B <= As.shape[0]] or [As.shape[0]]
    Bmax = max(batches)
    p, q, ym, yn, al = (t(Bmax, n), t(Bmax, m), t(Bmax, m), t(Bmax, n),
                        t(Bmax))
    Q, P = t(Bmax, m, kq) / m ** 0.5, t(Bmax, n, kp) / n ** 0.5
    cq = t(Bmax, kq)
    cp = t(Bmax, kp)
    rows = {}
    for B in batches:
        # the first B examples: every one a contiguous stack
        Ab, pb, qb, ymb, ynb, alb = (As[:B], p[:B], q[:B], ym[:B], yn[:B],
                                     al[:B])
        Qb, Pb, cqb, cpb = Q[:B], P[:B], cq[:B], cp[:B]
        At, Qt, Pt = (Ab.transpose(1, 2), Qb.transpose(1, 2),
                      Pb.transpose(1, 2))

        def lib_mv():
            u = torch.baddbmm(ymb[:, :, None], Ab, pb[:, :, None],
                              beta=-0.37)
            return u, torch.bmm(Qt, u)

        def lib_rmv():
            v = torch.baddbmm(ynb[:, :, None], At, qb[:, :, None],
                              beta=-1.7)
            return v, torch.bmm(Pt, v)

        def pair(name, u, X, c, L, kk, side):
            """The stage row of proj_qtv / proj_norm on basis X (B, L,
            kk): call(b=None, X) runs the stacked call on X (example b's
            single launch), and cold the kernel and the library over
            copies of X."""
            kern = getattr(gs, name)
            plain = getattr(ref, name)
            norm = name == "proj_norm"

            def call(b=None, Xc=X):
                return kern(u, Xc, c) if b is None else kern(u[b], Xc[b],
                                                             c[b])

            nbytes = (f * (L * kk + 2 * L + kk + 1) if norm
                      else f * (L * kk + 2 * L + 2 * kk))
            flops = 2 * L * kk + 3 * L if norm else 4 * L * kk + L
            return (call, lambda: proj_library(u, X, c, norm),
                    lambda: plain(u, X, c), nbytes, flops,
                    f"{side} {L}x{kk}",
                    dict(kernel=lambda Xc: (lambda: call(None, Xc)),
                         library=lambda Xc: (lambda: proj_library(u, Xc, c,
                                                              norm)),
                         basis=X))

        stages = {
            "mv_qtv": (lambda b=None: gs.mv_qtv(Ab, pb, ymb, alb, Qb)
                       if b is None else gs.mv_qtv(Ab[b], pb[b], ymb[b],
                                                   alb[b], Qb[b]), lib_mv,
                       lambda: ref.mv_qtv(Ab, pb, ymb, alb, Qb),
                       f * (m * n + n + m + m * kq + 1 + m + kq),
                       2 * m * n + 2 * m + 2 * m * kq, f"{m}x{n}, k={kq}",
                       None),
            "rmv_qtv": (lambda b=None: gs.rmv_qtv(Ab, qb, ynb, alb, Pb)
                        if b is None else gs.rmv_qtv(Ab[b], qb[b], ynb[b],
                                                     alb[b], Pb[b]),
                        lib_rmv, lambda: ref.rmv_qtv(Ab, qb, ynb, alb, Pb),
                        f * (m * n + m + n + n * kp + n + kp),
                        2 * m * n + 2 * n + 2 * n * kp, f"{m}x{n}, k={kp}",
                        None),
            "proj_qtv": pair("proj_qtv", ymb, Qb, cqb, m, kq, "Q"),
            "proj_norm": pair("proj_norm", ymb, Qb, cqb, m, kq, "Q"),
            "proj_qtv P": pair("proj_qtv", ynb, Pb, cpb, n, kp, "P"),
            "proj_norm P": pair("proj_norm", ynb, Pb, cpb, n, kp, "P"),
        }
        for name, (call, lib, plain, nbytes, flops, shape, cold) in \
                stages.items():
            t_bytes = B * nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = B * flops / F32_FLOP_PER_S * 1e3
            row = dict(call=f"B={B} x {shape} f32",
                       ms=graph_ms([call], 60, 5),
                       singles_ms=graph_ms(
                           [lambda: [call(b) for b in range(B)]], 20, 5),
                       one_ms=graph_ms([lambda: call(0)], 60, 5),
                       library_ms=graph_ms([lib], 60, 5),
                       plain_ms=graph_ms([plain], 20, 5),
                       library="torch.baddbmm + torch.bmm (two calls)",
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            extra = ""
            if cold is not None:
                copies = basis_copies(cold["basis"])
                row["cold_ms"] = graph_ms(
                    [cold["kernel"](X) for X in copies], 60, 5)
                row["library_cold_ms"] = graph_ms(
                    [cold["library"](X) for X in copies], 60, 5)
                row["cold_copies"] = len(copies)
                row["cold_share_of_bound"] = row["bound_ms"] / row["cold_ms"]
                del copies
                extra = (f"; cold L2 ({row['cold_copies']} copies of the "
                         f"basis) {row['cold_ms']:.4f} ms "
                         f"({100 * row['cold_share_of_bound']:.0f} % of the "
                         f"bound), library {row['library_cold_ms']:.4f} ms")
            print(f"phase 8: {name} stacked {row['call']}, device time: "
                  f"{row['ms']:.4f} ms ({100 * row['share_of_bound']:.0f} % "
                  f"of the bound {row['bound_ms']:.4f} ms), {B} single "
                  f"launches {row['singles_ms']:.4f} ms, one single launch "
                  f"{row['one_ms']:.4f} ms, library on the stack "
                  f"({row['library']}) {row['library_ms']:.4f} ms, plain "
                  f"version on the stack {row['plain_ms']:.4f} ms" + extra,
                  flush=True)
            rows.setdefault(name, {})[B] = row
    return {name: dict(by_B[Bmax], by_batch=by_B)
            for name, by_B in rows.items()}


TRACE_CALLS = 3               # stacked calls of each kernel under the profiler


def stacked_trace(As, seed, k, calls=TRACE_CALLS, batches=STAGE_BATCHES):
    """One torch.profiler trace each of ``calls`` stacked ``rmv_qtv`` and
    ``mv_qtv`` calls on ``As`` (the big batch's stack, P side k columns,
    Q side k + 1), of the stacked ``proj_qtv`` / ``proj_norm`` on the Q
    and the P side's basis (named "proj_qtv P", ...) for the first B
    examples, each B of ``batches``, and of their library yardsticks
    (``torch.baddbmm`` + ``torch.bmm``) on the whole stack, after one
    traced call that is dropped: every launch of a call by its kernel's
    name and device µs, and the call's span from its first launch's
    start to its last launch's end, so the gaps between a call's launches
    show too.  Keys: the kernel's name (and " library") for the whole
    stack, with " B=b" for a smaller stack."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels import gk_step as gs
    B, m, n = As.shape
    g = torch.Generator(device=DEV).manual_seed(seed + 31)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=DEV)

    p, q, ym, yn, al = t(B, n), t(B, m), t(B, m), t(B, n), t(B)
    Q, P = t(B, m, k + 1) / m ** 0.5, t(B, n, k) / n ** 0.5
    Qt, Pt = Q.transpose(1, 2), P.transpose(1, 2)
    cq, cp = t(B, k + 1), t(B, k)

    def lib_rmv():
        v = torch.baddbmm(yn[:, :, None], As.transpose(1, 2),
                          q[:, :, None], beta=-1.7)
        return v, torch.bmm(Pt, v)

    def lib_mv():
        u = torch.baddbmm(ym[:, :, None], As, p[:, :, None], beta=-0.37)
        return u, torch.bmm(Qt, u)

    cases = {"rmv_qtv": (lambda: gs.rmv_qtv(As, q, yn, al, P),
                         f"B={B} x {m}x{n} f32"),
             "mv_qtv": (lambda: gs.mv_qtv(As, p, ym, al, Q),
                        f"B={B} x {m}x{n} f32"),
             "rmv_qtv library": (lib_rmv, f"B={B} x {m}x{n} f32"),
             "mv_qtv library": (lib_mv, f"B={B} x {m}x{n} f32")}
    for side, u, X, c, L, kk in (("", ym, Q, cq, m, k + 1),
                                 (" P", yn, P, cp, n, k)):
        for name in ("proj_qtv", "proj_norm"):
            kern = getattr(gs, name)
            for b in sorted(x for x in batches if x <= B):
                key = f"{name}{side}" + ("" if b == B else f" B={b}")
                cases[key] = ((lambda kern=kern, u=u[:b], X=X[:b],
                               c=c[:b]: kern(u, X, c)),
                              f"B={b} x {'P' if side else 'Q'} {L}x{kk} f32")
            cases[f"{name}{side} library"] = (
                (lambda u=u, X=X, c=c, norm=name == "proj_norm":
                 proj_library(u, X, c, norm)),
                f"B={B} x {'P' if side else 'Q'} {L}x{kk} f32")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, (fn, call) in cases.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls + 1):   # the first waits on the profiler
                fn()
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)

        def short(e):
            hit = re.search(r"\w*(?:kernel|gemv|gemm)\w*(<[^(]*>)?",
                            e.name)
            return (hit.group(0) if hit else e.name)[:60]

        # a measurement, not a gate: where the library's calls do not
        # launch alike, its launches are grouped by name, with no span
        per = len(dev) // (calls + 1)
        if dev and per * (calls + 1) == len(dev):
            dev = dev[per:]
            launches = [dict(kernel=short(dev[i]),
                             us=[e.time_range.elapsed_us()
                                 for e in dev[i::per]])
                        for i in range(per)]
            spans = [dev[c * per + per - 1].time_range.end
                     - dev[c * per].time_range.start for c in range(calls)]
        else:
            groups = {}
            for e in dev:
                groups.setdefault(short(e), []).append(
                    e.time_range.elapsed_us())
            launches = [dict(kernel=k, us=v) for k, v in groups.items()]
            spans = []
        out[name] = dict(call=call, launches=launches, span_us=spans)
        print(f"phase 8: trace of stacked {name} {call} ({calls} calls): "
              + "; ".join(f"{r['kernel']} "
                          + "/".join(f"{u:.1f}" for u in r["us"]) + " us"
                          for r in launches)
              + "; span " + ("/".join(f"{s:.1f}" for s in spans)
                             or "not taken (uneven launches)") + " us",
              flush=True)
    return out


def phase_plan(A, seed, walls3, drift):
    """Phase 8, the plan layer on the card: two solves through one plan
    (phase 3's operand and spec), two updates, two in-graph estimates, the
    plan.solve failpoint, and solve_batched at the serving shape and at
    a batch where the kernels do real work.  Returns the rows of the
    kernels line's ``batched`` entries and the walls."""
    import torch
    from repro_torch.api import SVDSpec, plan
    p, fact, walls = plan_solves(A, seed, walls3)
    update_err = plan_updates(p, fact, drift)
    est_walls = plan_estimates(A, seed)
    plan_failpoint(p, A, seed)
    del fact

    As, q1s = serve_operands(seed + 22, SERVE_B, SERVE_SHAPE, SERVE_RANK)
    spec = SVDSpec(method="fsvd", rank=SERVE_RANK, max_iters=SERVE_ITERS,
                   backend="pallas")
    _, serve = batched_vs_singles(
        f"serving shape B={SERVE_B} x {SERVE_SHAPE[0]}x{SERVE_SHAPE[1]}",
        As, q1s, spec)
    del As, q1s

    B, m, n = BIG_BATCH
    g = torch.Generator(device=DEV).manual_seed(seed + 23)
    M = torch.randn(B, m, RANK, generator=g, device=DEV)
    N = torch.randn(B, RANK, n, generator=g, device=DEV)
    As = M @ N
    q1s = 2.0 + torch.randn(B, m, generator=g, device=DEV)
    s_big = [factored_sigma(M[b], N[b].T) for b in range(B)]
    del M, N
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=BIG_ITERS,
                   backend="pallas")
    fb, big = batched_vs_singles(f"B={B} x {m}x{n} f32", As, q1s, spec)
    err = max(float((fb.s[b].double() - s_big[b][:R_WANT]).abs().max())
              / float(s_big[b][0]) for b in range(B))
    print(f"phase 8: solve_batched B={B} x {m}x{n}: max|sigma - "
          f"sigma_true|/sigma_max {err:.3e} (bound {FSVD_STOL})", flush=True)
    check(err < FSVD_STOL, f"batched sigma error {err:.3e} >= {FSVD_STOL}")
    # the stacked launches at this batch's own operands and bases (Q side
    # k + 1 columns, P side k): the multi-tile, multi-chunk plans that
    # phase 2's smaller stacks do not reach
    gen = torch.Generator(device=DEV).manual_seed(seed + 24)
    big_errs = check_batched(gen, m, n, BIG_ITERS + 1, torch.float32,
                             torch.float32, B, A=As, kp=BIG_ITERS)
    print(f"phase 8: stacked launches on the B={B} x {m}x{n} f32 operands "
          f"(Q {m}x{BIG_ITERS + 1}, P {n}x{BIG_ITERS}): one launch a call, "
          f"every example bit for bit a single launch on it, bitwise "
          f"stable; max abs err against the stacked plain versions "
          + ", ".join(f"{k}={v:.3e}" for k, v in big_errs.items()),
          flush=True)
    trace = stacked_trace(As, seed, BIG_ITERS)
    stages = batched_stage_times(As, seed, BIG_ITERS)
    del As, q1s, fb
    torch.cuda.empty_cache()
    return dict(stages=stages, trace=trace, serve=serve, big=big,
                big_errs=big_errs, plan_walls=walls,
                estimate_walls=est_walls, update_err=update_err)


# --- phase 7: the sketch-resident state ------------------------------------

def drift_stream(seed, m, n, norm_a, mass=DRIFT_MASS):
    """The seeded rank-1 drift D = c u v^T on DRIFT_BLOCK rows x
    DRIFT_BLOCK columns (drawn without replacement), ||D||_F = mass
    ||A||_F, as a COO stream: each coordinate twice, a Gaussian part a and
    D_ij - a, shuffled.  Returns (rows, cols, vals, u_full, v_full) with
    D = u_full v_full^T (c folded into u_full)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed + 15)
    b = DRIFT_BLOCK
    R = torch.randperm(m, generator=g, device=DEV)[:b]
    C = torch.randperm(n, generator=g, device=DEV)[:b]
    u = torch.randn(b, generator=g, device=DEV)
    v = torch.randn(b, generator=g, device=DEV)
    c = mass * norm_a / (torch.linalg.vector_norm(u)
                               * torch.linalg.vector_norm(v))
    D = (c * u)[:, None] * v[None, :]
    a = torch.randn(b, b, generator=g, device=DEV) * (
        torch.linalg.vector_norm(D) / b)          # the drift's rms entry
    rows = R[:, None].expand(b, b).reshape(-1)
    cols = C[None, :].expand(b, b).reshape(-1)
    order = torch.randperm(2 * b * b, generator=g, device=DEV)
    rows = torch.cat([rows, rows])[order].to(torch.int32)
    cols = torch.cat([cols, cols])[order].to(torch.int32)
    vals = torch.cat([a.reshape(-1), (D - a).reshape(-1)])[order]
    u_full = torch.zeros(m, device=DEV).index_copy_(0, R, c * u)
    v_full = torch.zeros(n, device=DEV).index_copy_(0, C, v)
    return rows, cols, vals, u_full, v_full


def rel_fro(got, want):
    import torch
    d = torch.linalg.vector_norm(got.float() - want.float())
    return float(d / torch.linalg.vector_norm(want.float()))


def time_scatter(label, r, c, v, shape):
    """scatter_add on one stream: bit for bit against the CPU plain
    version, then timed beside the plain version on the card and
    index_add_, with each stage of its plan timed alone.
    The binned fold and index_add_ are also timed by device time (each in
    a CUDA graph: the fold's scans and allocations capture too).  Returns
    the timing row, with the largest difference from the CPU under
    "err"."""
    import torch
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ref
    got = kcs.scatter_add(r, c, v, shape)
    want = ref.scatter_add(r.cpu(), c.cpu(), v.cpu(), shape)
    err = float((got.cpu() - want).abs().max())
    check(torch.equal(got.cpu(), want), f"scatter_add at the {label} "
                                        f"differs from the CPU plain "
                                        f"version by {err:.3e}")
    del got, want
    flat = r.long() * shape[1] + c.long()
    panel = torch.zeros(shape[0] * shape[1], device=DEV)
    nbytes = 12 * r.shape[0] + 4 * shape[0] * shape[1]

    def binned():
        return kcs.scatter_add(r, c, v, shape)

    row = time_row(
        f"scatter_add {label}", binned,
        lambda: ref.scatter_add(r, c, v, shape),
        lambda: panel.zero_().index_add_(0, flat, v),
        nbytes, r.shape[0], f"({r.shape[0]} entries -> {shape[0]}x"
        f"{shape[1]}, f32)", phase=7, graph=(60, 5))
    row["host_loop_ms"] = (row["host_loop_ms"] + event_ms(binned)) / 2
    del flat, panel
    plan = kcs.bin_plan(r.shape[0], shape)
    counts = kcs.count_bins(r, c, plan)
    incl = kcs.scan_counts(counts)
    pairs = kcs.scatter_bins(r, c, v, plan, counts, incl)
    stages = {
        "count_ms": event_ms(lambda: kcs.count_bins(r, c, plan)),
        "scan_ms": event_ms(lambda: kcs.scan_counts(counts)),
        "bin_ms": event_ms(
            lambda: kcs.scatter_bins(r, c, v, plan, counts, incl))}
    if plan.part_slices:
        # what step 4 buys: the tile sum over step 3's bins read whole
        whole = plan._replace(part_bits=plan.bin_bits, part_slices=0)
        stages["unsplit_sum_ms"] = event_ms(
            lambda: kcs.sum_tiles(pairs, incl, whole))

        def parts():
            pc = kcs.count_parts(pairs, incl, plan)
            pi = kcs.scan_counts(pc)
            return kcs.scatter_parts(pairs, incl, plan, pc, pi), pi

        stages["part_ms"] = event_ms(parts)
        pairs, incl = parts()
    stages["sum_ms"] = event_ms(lambda: kcs.sum_tiles(pairs, incl, plan))
    row["stages"] = stages
    print(f"phase 7: scatter_add {label}: binned, device time "
          f"{row['ms']:.4f} ms, host loop {row['host_loop_ms']:.4f} ms (mean "
          f"of two); stages "
          + ", ".join(f"{k} {t:.4f}" for k, t in stages.items())
          + f"; plan {plan.bins} bins of 2^{plan.bin_bits} cells, "
          f"{plan.slices} slices of {plan.slice_len}, "
          f"{plan.parts} parts a bin in {plan.part_slices} slices",
          flush=True)
    row["call"], row["err"] = label, err
    del counts, incl, pairs
    return row


def phase_sketchres(A, seed, peak3, drift):
    """Phase 7: the sketch-resident state on the main operand (edited in
    place).  Returns (scatter_add launches, max abs error, timing row)."""
    import torch
    from repro_torch import sketchres as sk
    from repro_torch.api import LowRankOp, SVDSpec
    from repro_torch.core.operators import DenseOp
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    m, n = A.shape
    spec = SVDSpec(**SKETCHRES_FIELDS)
    M, N = operand_factors(seed, m, n)
    left, right = [M], [N.T]                # A = left right^T, in pieces

    def sketch(op):
        return sk.sketch_operand(op, spec, generator=torch.Generator(
            device=DEV).manual_seed(seed + 16))

    def exact():
        return factored_sigma(torch.cat(left, 1), torch.cat(right, 1))

    def check_state(label, st, wall):
        """Fresh sketch of the edited A (same seeds) against the folded
        panels, then reconstruct against the exact sigma."""
        fresh = sketch(DenseOp(A, backend="pallas"))
        check(fresh.seeds == st.seeds, "a re-sketch drew other seeds")
        eY, eZ = rel_fro(st.Y, fresh.Y), rel_fro(st.Z, fresh.Z)
        f, t_rec = timed(lambda: sk.reconstruct(st, spec))
        s_exact = exact()
        err = float((f.s.double() - s_exact[:R_WANT]).abs().max()
                    / s_exact[0])
        ratio = float(sk.staleness_ratio(st))
        print(f"phase 7: {label} wall {wall * 1e3:.3f} ms; folded vs fresh "
              f"sketch (same seeds) |dY|/|Y| {eY:.3e}, |dZ|/|Z| {eZ:.3e} "
              f"(bound {PANEL_BOUND}); reconstruct {t_rec * 1e3:.3f} ms, "
              f"iterations {int(f.iterations)}, method {f.method}, "
              f"max|sigma - sigma_exact|/sigma_max {err:.3e} (bound "
              f"{SKETCHRES_STOL}; the exact sigma of a rank <= "
              f"{s_exact.shape[0]} operand); "
              f"staleness {ratio:.4f}", flush=True)
        check(eY <= PANEL_BOUND and eZ <= PANEL_BOUND,
              f"{label}: folded panels {eY:.3e} / {eZ:.3e} from a fresh "
              f"sketch")
        check(int(f.iterations) == 0 and f.method == "sketch",
              f"{label}: reconstruct gave {int(f.iterations)} iterations, "
              f"method {f.method}")
        check(err < SKETCHRES_STOL, f"{label}: sigma error {err:.3e}")
        check(not bool(sk.is_stale(st)), f"{label}: stale at {ratio:.4f}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    guard = counting_op(DenseOp(A, backend="pallas"))
    st, t_sketch = timed(lambda: sketch(guard))
    touches = {k: v for k, v in guard.counts.items() if v}
    k, l = st.panel_dims
    print(f"phase 7: sketch_operand {m}x{n} (k = {k}, l = {l}; Y "
          f"{st.Y.numel() * 4 / 1e6:.1f} MB, Z {st.Z.numel() * 4 / 1e6:.1f} "
          f"MB) wall {t_sketch:.3f} s, operator touches {touches}, "
          f"base_norm {float(st.base_norm):.4e}", flush=True)
    check(touches == {"sketch_pass": 1}, f"sketch_operand touched {touches}")

    rows, cols, vals, u_full, v_full = drift_stream(
        seed, m, n, float(torch.linalg.vector_norm(exact())))
    E = rows.shape[0]
    seen = []
    real = kops.scatter_add

    def spy(r, c, v, shape):
        seen.append((r, c, v, shape))
        return real(r, c, v, shape)

    kops.scatter_add = spy
    try:
        kcs.reset_launches()
        folded, t_fold = timed(lambda: sk.apply_entries(st, rows, cols,
                                                        vals))
        launches = kcs.LAUNCHES["scatter_add"]
    finally:
        kops.scatter_add = real
    check(launches == 2, f"apply_entries launched scatter_add {launches} "
                         f"times, not 2")
    again = sk.apply_entries(st, rows, cols, vals)
    check(torch.equal(folded.Y, again.Y) and torch.equal(folded.Z, again.Z),
          "apply_entries differs bitwise on a rerun")
    del again
    print(f"phase 7: apply_entries of {E} entries (a rank-1 drift on "
          f"{DRIFT_BLOCK}x{DRIFT_BLOCK} coordinates, each sent twice) -> "
          f"{[x[0].shape[0] for x in seen]} expanded entries into panels "
          f"{[x[3] for x in seen]}: scatter_add launches {launches}, panels "
          f"bitwise equal on a rerun", flush=True)
    A.index_put_((rows.long(), cols.long()), vals, accumulate=True)
    left.append(u_full[:, None])
    right.append(v_full[:, None])
    check_state("entry fold", folded, t_fold)

    Cd, sd, Dt = drift.U, drift.s, drift.Vt
    st2, t_lr = timed(lambda: sk.apply_lowrank_delta(
        folded, LowRankOp(Cd, sd, Dt)))
    W = Cd * sd
    for r0 in range(0, m, 1 << 13):
        A[r0:r0 + (1 << 13)].addmm_(W[r0:r0 + (1 << 13)], Dt)
    left.append(W)
    right.append(Dt.T)
    check_state(f"low-rank fold (rank {Dt.shape[0]})", st2, t_lr)

    target = (st2.budget * st2.base_norm).reshape(1)
    zero = torch.zeros(1, dtype=torch.int32, device=DEV)
    st3 = sk.apply_entries(st2, zero, zero, target)
    ratio = float(sk.staleness_ratio(st3))
    print(f"phase 7: odometer: a one-entry fold of budget * base_norm "
          f"({float(target):.4e}) takes staleness to {ratio:.4f}, stale "
          f"{bool(sk.is_stale(st3))}", flush=True)
    check(bool(sk.is_stale(st3)), "the budget fold did not trip is_stale")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 7: peak device memory {peak / GIB:.2f} GiB (phase 3 "
          f"{peak3 / GIB:.2f} GiB + 2 GiB)", flush=True)
    check(peak < peak3 + 2 * GIB,
          f"phase 7 peak {peak / GIB:.2f} GiB: a copy of the operand?")
    del st, folded, st2, st3, M, N, left, right

    errs, rows_t = [], []
    for (r, c, v, shape), label in zip(seen, ("Y fold", "Z fold")):
        row = time_scatter(label, r, c, v, shape)
        errs.append(row.pop("err"))
        rows_t.append(row)
    # wider panels than the phase-7 folds: bins of 8 and of 64 tiles
    g = torch.Generator(device=DEV).manual_seed(seed + 17)
    wide = []
    E = seen[0][0].shape[0]             # as many entries as the Y fold
    for label, shape in WIDE_FOLDS:
        r = torch.randint(0, shape[0], (E,), generator=g, device=DEV,
                          dtype=torch.int32)
        c = torch.randint(0, shape[1], (E,), generator=g, device=DEV,
                          dtype=torch.int32)
        v = torch.randn(E, generator=g, device=DEV)
        row = time_scatter(label, r, c, v, shape)
        errs.append(row.pop("err"))
        wide.append(row)
        del r, c, v
        torch.cuda.empty_cache()
    out = {key: sum(r[key] for r in rows_t) / len(rows_t)
           for key in ("ms", "host_loop_ms", "plain_ms", "library_ms",
                       "bound_ms")}
    out["bound_by"] = "bytes"
    keys = ("call", "ms", "host_loop_ms", "stages", "plain_ms",
            "library_ms", "host_loop_library_ms", "bound_ms")
    out["calls"] = [{k: r[k] for k in keys} for r in rows_t]
    out["wide"] = [{k: r[k] for k in keys} for r in wide]
    del seen
    torch.cuda.empty_cache()
    return launches, max(errs), out


# --- phase 9: the Session at full width -------------------------------------

def session_launches():
    """Launches of the six kernels the Session's stream runs, since the
    last ``reset_session_launches``."""
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import lowrank_update as klu
    out = {name: gs.LAUNCHES[name] for name in GK_STEP}
    out["lowrank_matmul"] = klu.LAUNCHES["lowrank_matmul"]
    out["scatter_add"] = kcs.LAUNCHES["scatter_add"]
    return out


def reset_session_launches():
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import lowrank_update as klu
    gs.reset_launches()
    klu.reset_launches()
    kcs.reset_launches()


def rank2_delta(g, m, n, norm_a):
    """test_update's _delta at the cell's width: Gaussian U (m, k) and Vt
    (k, n), s = SESSION_DELTA ||A||_F / ||U Vt||_F (the Frobenius norm
    from the k x k Gram matrices)."""
    import torch
    from repro_torch.api import LowRankOp
    k = SESSION_DELTA_RANK
    U = torch.randn(m, k, generator=g, device=DEV)
    Vt = torch.randn(k, n, generator=g, device=DEV)
    fro = torch.sqrt(((U.T @ U) * (Vt @ Vt.T)).sum())
    s = torch.full((k,), SESSION_DELTA, device=DEV) * (norm_a / fro)
    return LowRankOp(U, s, Vt)


def session_stream(seed, m, n, directory, spies):
    """One run of phase 9's stream on an exact rank-20 operand A = M N,
    every step checked (kind, iterations, launches, sigma against the
    exact sigma of the factored operand).  Returns (records, the sigma of
    every step on the host, probe walls, peak device memory)."""
    import torch
    from repro_torch.api import SVDSpec
    from repro_torch.api.session import Session
    from repro_torch.checkpoint import valid_steps
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import faults
    from repro_torch.serve import resilience
    r = SESSION_RANK
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")
    g = torch.Generator(device=DEV).manual_seed(seed + 40)
    M = torch.randn(m, r, generator=g, device=DEV)
    N = torch.randn(r, n, generator=g, device=DEV)
    left, right = [M], [N.T]                 # A = [left] [right]^T
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def gen(k):
        return torch.Generator(device=DEV).manual_seed(seed + k)

    cur = {"sess": Session(M @ N, spec, generator=gen(41))}
    records, bits, probe_walls, peaks = [], [], [], []
    real = {"probe": resilience.residual_probe,
            "lowrank_matmul": kops.lowrank_matmul,
            "scatter_add": kops.scatter_add}
    calls = {"lowrank_matmul": [], "scatter_add": []}

    def probe(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["probe"](*a, **kw)
        probe_walls.append(time.perf_counter() - t0)
        return out

    def spy(name):
        def call(*a):
            if spies:
                calls[name].append(a)
            return real[name](*a)
        return call

    def exact():
        return factored_sigma(torch.cat(left, 1), torch.cat(right, 1))

    def step(label, kind, bound, fn, zero_iters=False):
        reset_session_launches()
        for v in calls.values():
            v.clear()
        n_probes = len(probe_walls)
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        fact, wall = timed(fn)
        step_peak = torch.cuda.max_memory_allocated()
        launches = session_launches()
        rec = dict(cur["sess"].history[-1])
        s_exact = exact()
        err = float((fact.s.double() - s_exact[:R_WANT]).abs().max()
                    / s_exact[0])
        out = dict(step=label, kind=rec["kind"],
                   iterations=int(rec["iterations"]), wall_s=wall,
                   launches=launches, sigma_err=err, bound=bound,
                   peak_gib=step_peak / GIB, probe_s=probe_walls[n_probes:],
                   shapes={k: sorted({tuple(tuple(x.shape) for x in a[:3])
                                      for a in v})
                           for k, v in calls.items() if v})
        for key in ("budget", "drift", "probe", "gate", "residual_update",
                    "residual", "staleness"):
            if key in rec:
                out[key] = rec[key]
        if spies:
            out["calls"] = {k: list(v) for k, v in calls.items()}
        records.append(out)
        bits.append(fact.s.cpu())
        shown = {k: v for k, v in out.items() if k not in ("calls",)}
        print(f"phase 9: {json.dumps(shown, default=str)}", flush=True)
        check(rec["kind"] == kind, f"{label}: took {rec['kind']}, not {kind}")
        check(err < bound, f"{label}: sigma error {err:.3e} >= {bound}")
        if zero_iters:
            check(out["iterations"] == 0, f"{label}: ran GK iterations")
            check(not any(launches[k] for k in GK_STEP),
                  f"{label}: launched GK stages {launches}")
        return out

    resilience.residual_probe = probe
    kops.lowrank_matmul = spy("lowrank_matmul")
    kops.scatter_add = spy("scatter_add")
    try:
        cold = step("solve", "cold", FSVD_STOL, lambda: cur["sess"].solve())
        want = gk_step_want(MAX_ITERS, spec.reorth_passes)
        check({k: cold["launches"][k] for k in GK_STEP} == want,
              f"cold launches {cold['launches']} != {want}")

        E = torch.randn(m, r, generator=g, device=DEV)
        left[0] = M + SESSION_EPS * E
        held = [left[0] @ N]           # the session's update takes it over
        del E
        ref = step("update (dense drift)", "refine", FSVD_STOL,
                   lambda: cur["sess"].update(held.pop()))
        check(ref["iterations"] <= cold["iterations"]
              and ref["budget"] < MAX_ITERS,
              f"refine ran {ref['iterations']} iterations (budget "
              f"{ref.get('budget')}) against cold {cold['iterations']}")
        check(ref["launches"]["mv_qtv"] == ref["budget"],
              f"refine launches {ref['launches']}")

        for i in range(2):
            norm_a = float(torch.linalg.vector_norm(exact()))
            d = rank2_delta(g, m, n, norm_a)
            left.append(d.U * d.s)
            right.append(d.Vt.T)
            rec = step(f"delta {i + 1}", "update", UPDATE_GATE,
                       lambda: cur["sess"].delta(d), zero_iters=True)
            check(rec["launches"]["lowrank_matmul"] >= 2,
                  f"delta: lowrank_matmul launches {rec['launches']}")
            del d

        rows = torch.randperm(m, generator=g, device=DEV)[:SESSION_ROWS]
        left = [L.index_fill(0, rows, 0) for L in left]
        rec = step("downdate", "downdate", UPDATE_GATE,
                   lambda: cur["sess"].downdate(rows=rows), zero_iters=True)
        check(rec["launches"]["lowrank_matmul"] == 1,
              f"downdate: lowrank_matmul launches {rec['launches']}")

        norm_a = float(torch.linalg.vector_norm(exact()))
        er, ec, ev, u_full, v_full = drift_stream(seed + 27, m, n, norm_a,
                                                  mass=SESSION_MASS)
        left.append(u_full[:, None])
        right.append(v_full[:, None])
        rec = step("entries", "sketch", SKETCHRES_STOL,
                   lambda: cur["sess"].entries(er, ec, ev), zero_iters=True)
        check(rec["launches"]["scatter_add"] == 2,
              f"entries: scatter_add launches {rec['launches']}")
        check(rec["probe"] <= rec["gate"],
              f"entries: probe {rec['probe']:.3e} > gate {rec['gate']:.3e}")
        del er, ec, ev, u_full, v_full
        if spies:
            # the probe pads its Omega to 8 columns: both forms of A Omega
            A = cur["sess"].op.A
            om8 = torch.randn(n, 8, generator=g, device=DEV)
            om4 = om8[:, :4].contiguous()
            t4 = event_ms(lambda: A @ om4, reps=3)
            t8 = event_ms(lambda: A @ om8, reps=3)
            del A
            records.append(dict(step="probe product", ms_4_columns=t4,
                                ms_8_columns=t8))
            print(f"phase 9: the probe's A Omega ({m}x{n} f32, cuBLAS, "
                  f"host loop of 3): 4 columns {t4:.2f} ms, padded to 8 "
                  f"{t8:.2f} ms", flush=True)

        sess = cur["sess"]
        saved = sess._step
        _, t_save = timed(lambda: sess.save(directory, keep=2))
        back, t_restore = timed(lambda: Session.restore(
            directory, sess.op.A, generator=gen(43)))
        for f in ("U", "s", "V", "iterations", "breakdown"):
            check(torch.equal(getattr(back.fact, f), getattr(sess.fact, f)),
                  f"restore: {f} differs bitwise")
        check(back.history == sess.history and back.solves == saved
              and back.counts() == sess.counts(),
              "restore: history or counts differ")
        cur["sess"] = back
        del sess
        raised = False
        with faults.inject(faults.CHECKPOINT_WRITE, mode="raise"):
            try:
                back.save(directory, saved + 1)
            except faults.FaultInjected:
                raised = True
        check(raised and valid_steps(directory) == [saved]
              and not os.path.exists(os.path.join(directory,
                                                  f"step_{saved + 1}")),
              f"failpoint: raised {raised}, valid {valid_steps(directory)}")
        with faults.inject(faults.CHECKPOINT_WRITE, mode="corrupt"):
            back.save(directory, saved + 2)
        again = Session.restore(directory, back.op.A, generator=gen(43))
        check(os.path.exists(os.path.join(directory, f"step_{saved + 2}"))
              and valid_steps(directory) == [saved] and again.solves == saved
              and torch.equal(again.fact.s, back.fact.s),
              f"corrupt save: valid {valid_steps(directory)}, restored "
              f"step {again.solves}")
        print(f"phase 9: save(keep=2) of step {saved} {t_save * 1e3:.1f} ms, "
              f"restore {t_restore * 1e3:.1f} ms (fact bit for bit, the same "
              f"history); the checkpoint.write failpoint left step {saved} "
              f"the newest valid; a corrupt-mode save of step {saved + 2} "
              f"was written, rejected, and restore fell back to step "
              f"{again.solves}", flush=True)
        cur["sess"] = again
        del back
        rec = step("solve (restored)", "refine", FSVD_STOL,
                   lambda: cur["sess"].solve())
        check(rec["launches"]["mv_qtv"] == rec["budget"],
              f"restored refine launches {rec['launches']}")
        records.append(dict(step="checkpoint", save_s=t_save,
                            restore_s=t_restore))
    finally:
        resilience.residual_probe = real["probe"]
        kops.lowrank_matmul = real["lowrank_matmul"]
        kops.scatter_add = real["scatter_add"]
    peaks.append(torch.cuda.max_memory_allocated())
    del cur, M, N, left, right, held
    return records, bits, probe_walls, max(peaks)


def kernel_ms(rec, times):
    """Device time of a step's launches: the GK stages at phase 3's
    device time per launch (the same operand shape; the projection pair
    at the cold basis width), the blocked fold's and the entry fold's
    launches each timed on the inputs the step gave them."""
    import torch
    total = sum(rec["launches"][k] * times[k]["ms"] for k in GK_STEP)
    from repro_torch.kernels import ops as kops
    for name in ("lowrank_matmul", "scatter_add"):
        for args in rec.get("calls", {}).get(name, []):
            fn = getattr(kops, name)
            total += graph_ms([lambda a=args: fn(*a)], 6, 2)
    torch.cuda.empty_cache()
    return total


def phase_session(seed, m, n, times):
    """Phase 9: the stream twice from the same seed (sigma bits equal),
    peak device memory within two operands + SESSION_SLACK, then each
    step's kernel time.  Returns the records of the first run."""
    import shutil
    import tempfile
    import torch
    limit = 2 * m * n * 4 + SESSION_SLACK
    runs = []
    for run in range(2):
        directory = tempfile.mkdtemp(prefix="chip_smoke_session.")
        try:
            out = session_stream(seed, m, n, directory, spies=run == 0)
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        records, bits, probes, peak = out
        print(f"phase 9: run {run + 1}: peak device memory "
              f"{peak / GIB:.2f} GiB (limit {limit / GIB:.2f}: two "
              f"operands + {SESSION_SLACK / GIB:.0f} GiB); probe walls "
              + ", ".join(f"{1e3 * t:.2f} ms" for t in probes), flush=True)
        check(peak <= limit, f"phase 9 peak {peak / GIB:.2f} GiB")
        runs.append((records, bits))
        gc.collect()
        torch.cuda.empty_cache()
    (records, bits), (_, bits2) = runs
    same = len(bits) == len(bits2) and all(
        torch.equal(a, b) for a, b in zip(bits, bits2))
    print(f"phase 9: a rerun of the stream from the same seed: sigma of "
          f"all {len(bits)} steps bit for bit {same}", flush=True)
    check(same, "phase 9: sigma differs bitwise on a rerun of the stream")
    for rec in records:
        if "launches" not in rec:
            continue
        rec["kernel_ms"] = kernel_ms(rec, times)
        rec.pop("calls", None)
        print(f"phase 9: {rec['step']}: wall {rec['wall_s'] * 1e3:.1f} ms, "
              f"kernel time {rec['kernel_ms']:.1f} ms (launches "
              f"{rec['launches']}), the rest "
              f"{rec['wall_s'] * 1e3 - rec['kernel_ms']:.1f} ms", flush=True)
    torch.cuda.empty_cache()
    return records


def netflix_operand(seed, m, n):
    """COO triplets (on the card, int32 indices) of a row- and column-
    permuted block diagonal: block k of RANK joins ~m/RANK users and
    ~n/RANK movies as the rank-1 c_k m_k n_k^T (Gaussian m, n; c_k in
    [0.5, 1]).
    Returns (data, indices, exact sigma descending in f64)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed + 9)
    rp = torch.randperm(m, generator=g, device=DEV)
    cp = torch.randperm(n, generator=g, device=DEV)
    rb = torch.arange(m, device=DEV) * RANK // m     # block of row position
    cb = torch.arange(n, device=DEV) * RANK // n
    col_cnt = torch.bincount(cb, minlength=RANK)
    col_start = torch.cumsum(col_cnt, 0) - col_cnt
    per_row = col_cnt[rb]
    j = torch.repeat_interleave(torch.arange(m, device=DEV), per_row)
    first = torch.cumsum(per_row, 0) - per_row
    cpos = col_start[rb[j]] + (torch.arange(j.shape[0], device=DEV)
                               - first[j])
    mv = torch.randn(m, generator=g, device=DEV)
    nv = torch.randn(n, generator=g, device=DEV)
    c = 0.5 + 0.5 * torch.rand(RANK, generator=g, device=DEV)
    data = c[rb[j]] * mv[j] * nv[cpos]
    idx = torch.stack([rp[j], cp[cpos]], 1).to(torch.int32)
    del j, cpos, first
    nm = torch.zeros(RANK, dtype=torch.float64, device=DEV).index_add_(
        0, rb, mv.double() ** 2)
    nn = torch.zeros(RANK, dtype=torch.float64, device=DEV).index_add_(
        0, cb, nv.double() ** 2)
    s_true = torch.sort(c.double() * nm.sqrt() * nn.sqrt(),
                        descending=True).values
    return data, idx, s_true


def sectors_spanned(gathered, b):
    """32-byte sectors the gathers X[j, 0:b] of a row-major (n, b) f32 X
    span, summed over the gathered rows j (one a stored entry)."""
    start = (gathered.long() * (4 * b)) % 32
    return int(((start + 4 * b + 31) // 32).sum())


def csr_of_pack(vals, cols):
    """The (rows, L) ELL pack as a CSR tensor (columns sorted in each row;
    the padding slots stay as explicit zeros) for the library yardstick."""
    import torch
    rows, L = cols.shape
    c, order = torch.sort(cols.long(), dim=1)
    v = torch.gather(vals.float(), 1, order)
    crow = torch.arange(0, rows * L + 1, L, device=DEV)
    with warnings.catch_warnings():       # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, c.reshape(-1), v.reshape(-1),
                                       size=(rows, int(cols.max()) + 1),
                                       check_invariants=False)


def phase_reorth(S, seed):
    """Phase 6, the reorthogonalization pair on the sparse operand's
    Lanczos basis Q (gk_bidiag at k = LANCZOS_K).  Returns ({kernel:
    launches}, {kernel: max abs error}, {kernel: timing row})."""
    import torch
    from repro_torch.core.gk import gk_bidiag
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import reorth as kro
    m, n = S.shape
    res, wall = timed(lambda: gk_bidiag(
        S, LANCZOS_K, generator=torch.Generator(device=DEV).manual_seed(
            seed + 13)))
    Q = res.Q
    g = torch.Generator(device=DEV).manual_seed(seed + 14)
    v = S.mv(torch.randn(n, generator=g, device=DEV))          # A p
    kro.reset_launches()
    w = kops.reorth(v, Q, 2)
    launches = dict(kro.LAUNCHES)
    check(launches == {"qtv": 2, "subtract_qc": 2},
          f"ops.reorth(passes=2) launched {launches}")
    check(torch.equal(w, kops.reorth(v, Q, 2)),
          "ops.reorth differs bitwise on a rerun")
    # A p lies in the range that the basis spans (rank 100, breakdown near
    # 105), so w is the roundoff remainder of v: the kernel and the plain
    # version are held to 1e-5 max|v| there, not to 1e-5 max|w|
    vmax, vn = float(v.abs().max()), float(torch.linalg.vector_norm(v))
    err_ap = float((w - ref.reorth(v, Q, 2)).abs().max())
    check(err_ap <= 1e-5 * vmax, f"ops.reorth(A p) differs from its plain "
                                 f"version by {err_ap:.3e} (max|v| {vmax:.3e})")
    ortho = float(torch.mv(Q.T, w).abs().max())
    check(ortho < REORTH_BOUND * vn, f"max|Q^T w| {ortho:.3e} >= "
                                     f"{REORTH_BOUND} ||v|| ({vn:.3e})")
    # a Gaussian vector has a remainder of its own size: the usual bounds
    x = torch.randn(m, generator=g, device=DEV)
    Qh = Q.to(torch.bfloat16)
    k = Q.shape[1]
    errs = check_reorth(f"Lanczos basis ({m}x{k}, f32)", Q, x,
                        kro.qtv(Q, x))
    check_reorth(f"Lanczos basis ({m}x{k}, bf16)", Qh, x, kro.qtv(Qh, x))
    errs = {name: max(e, err_ap) for name, e in errs.items()}
    print(f"phase 6: Lanczos basis {m}x{k} f32 ({Q.numel() * 4 / 1e6:.1f} "
          f"MB) from gk_bidiag in {wall:.3f} s (iterations "
          f"{int(res.kprime)}); ops.reorth(A p, Q, 2) launches {launches}, "
          f"vs plain {err_ap:.3e} (max|v| {vmax:.3e}), max|Q^T w| "
          f"{ortho:.3e} < {REORTH_BOUND} ||v|| = {REORTH_BOUND * vn:.3e}; "
          f"qtv / subtract_qc / reorth on a Gaussian vector match the "
          f"plain versions (f32 and bf16 basis), bitwise stable", flush=True)
    rows = {"qtv": [], "subtract_qc": []}
    for label, B in (("f32", Q), ("bf16", Qh)):
        eb, mk = B.element_size(), B.numel()
        c = ref.qtv(B, v)
        # the library calls take one dtype: in bf16 they multiply in bf16
        vb, cb = v.to(B.dtype), c.to(B.dtype)
        shape = f"(Q {m}x{k} {label}, f32 vectors)"
        row = time_row(f"qtv {label}", lambda B=B: kro.qtv(B, v),
                       lambda B=B: ref.qtv(B, v),
                       lambda B=B, vb=vb: torch.mv(B.T, vb),
                       eb * mk + 4 * (m + k), 2 * mk, shape, phase=6,
                       graph=(60, 5))
        rows["qtv"].append(dict(row, call=label))
        row = time_row(f"subtract_qc {label}",
                       lambda B=B, c=c: kro.subtract_qc(v, B, c),
                       lambda B=B, c=c: ref.subtract_qc(v, B, c),
                       lambda B=B, vb=vb, cb=cb: torch.addmv(vb, B, cb,
                                                             alpha=-1),
                       eb * mk + 4 * (2 * m + k), 2 * mk, shape, phase=6,
                       graph=(60, 5))
        rows["subtract_qc"].append(dict(row, call=label))
    times = {}
    for name, calls in rows.items():
        times[name] = {key: calls[0][key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "host_loop_ms")}
        times[name]["calls"] = [{key: r[key] for key in
                                 ("call", "ms", "plain_ms", "library_ms",
                                  "host_loop_ms", "host_loop_library_ms",
                                  "bound_ms", "share_of_bound")}
                                for r in calls]
    return launches, errs, times


def phase_sparse(seed, m, n):
    """Phase 6: the sparse operand.  Returns (launches, max abs error,
    timing row) of sparse_matvec and phase_reorth's results."""
    import torch
    from repro_torch.api import SVDSpec, estimate_rank, factorize
    from repro_torch.core.operators import SparseOp
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_matvec as spm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (data, idx, s_true), t_coo = timed(
        lambda: netflix_operand(seed, m, n))
    nnz = data.shape[0]
    S, t_pack = timed(lambda: SparseOp.from_coo(data, idx, (m, n),
                                                backend="pallas"))
    peak_build = torch.cuda.max_memory_allocated()
    packs = {"forward": (S.ell[0], S.ell[1], n, S.windows[0]),
             "transposed": (S.ell[2], S.ell[3], m, S.windows[1])}
    # each pack is held once, in its layout's order
    check(all(w is not None for w in S.windows),
          f"window layouts {[w is not None for w in S.windows]}")
    check(all(S.ell[2 * k] is S.windows[k].vals
              and S.ell[2 * k + 1] is S.windows[k].cols for k in (0, 1)),
          "the operator holds a second pack beside a layout")
    desc = ", ".join(f"{k} {v.shape[0]} rows x L {v.shape[1]} (fill "
                     f"{nnz / v.numel():.4f})" for k, (v, *_)
                     in packs.items())
    # rebuild each layout from a fresh pack in COO order (the same bits),
    # and time the 20-column block product over the fresh pack without a
    # layout (the warp-per-row kernel: the previous design) beside the
    # operator's call
    rebuild, off_mb, b20, b1 = {}, 0.0, {}, {}
    gen_x = torch.Generator(device=DEV).manual_seed(seed + 10)
    for side, (name, (vals, cols, nx, lay)) in enumerate(packs.items()):
        ix = idx if side == 0 else idx.flip(1)
        fv, fc = spm.ell_pack(data, ix, (vals.shape[0], nx))
        counts = torch.bincount(ix[:, 0].long(), minlength=vals.shape[0])
        fresh, rebuild[name] = timed(
            lambda: spm.pack_layout(fv, fc, nx, counts))
        check(lay.offsets is not None
              and all(torch.equal(a, b) for a, b in zip(fresh, lay)),
              f"the {name} window layout differs on a rebuild")
        # the main path's 20-column blocks take the block kernel here
        check(spm.block_scratch_fits(vals.shape[1], nx, 20, vals.dtype),
              f"the {name} pack's 20-column blocks skip the block kernel")
        off_mb += (lay.offsets.numel() + lay.window_offsets.numel()) * 4e-6
        del fresh
        Xb = torch.randn(nx, 20, generator=gen_x, device=DEV)
        b20[name] = (graph_ms([lambda: spm.sparse_matvec(fv, fc, Xb)], 60, 5),
                     graph_ms([lambda: spm.sparse_matvec(vals, cols, Xb,
                                                         lay)], 60, 5))
        if vals.shape[1] < spm.LONG_ROW:
            # one vector through short rows takes the warp-per-row kernel
            # over either order of the pack: the two orders in turns
            xb = Xb[:, 0].contiguous()
            coo = lambda: spm.sparse_matvec(fv, fc, xb)          # noqa: E731
            own = lambda: spm.sparse_matvec(vals, cols, xb,      # noqa: E731
                                            lay)
            b1[name] = [graph_ms([f], 60, 5) for f in (coo, own, own, coo)]
            del xb
        del fv, fc, Xb, counts
    print(f"phase 6: sparse operand {m}x{n}, {RANK} rank-1 blocks, nnz "
          f"{nnz} (density {nnz / (m * n):.3e}), COO on the card in "
          f"{t_coo:.3f} s, both ELL packs and their window layouts in "
          f"{t_pack:.3f} s: {desc}; the layouts (sub-windows of {spm.SUB} "
          f"rows, windows of {spm.WINDOW}, each pack held once in its "
          f"layout's order, the offsets add {off_mb:.1f} MB) rebuilt from "
          f"fresh packs in "
          + ", ".join(f"{k} {v:.3f} s" for k, v in rebuild.items())
          + ", the same bits; b=20 by device time, warp-per-row kernel over "
          f"the COO-order pack (the previous design) -> block kernel over "
          f"the layout: "
          + ", ".join(f"{k} {a:.4f} -> {b:.4f} ms" for k, (a, b)
                      in b20.items())
          + "; b=1 in turns, the COO-order pack vs the layout's: "
          + ", ".join(f"{k} {t[0]:.4f} / {t[3]:.4f} vs {t[1]:.4f} / "
                      f"{t[2]:.4f} ms" for k, t in b1.items())
          + f"; peak {peak_build / GIB:.2f} GiB while building (one dense "
          f"f32 copy: {m * n * 4 / GIB:.1f} GiB)", flush=True)
    err = 0.0
    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    for name, (vals, cols, nx, lay) in packs.items():
        for vdt in (torch.float32, torch.bfloat16):
            v = vals if vdt == torch.float32 else vals.to(vdt)
            # the same slot order in bf16: the layout's offsets still hold
            vlay = lay if vdt == torch.float32 or lay is None else \
                lay._replace(vals=v)
            for b in (1, 20, 32):
                X = torch.randn(nx, b, generator=gen, device=DEV)
                X = X[:, 0].contiguous() if b == 1 else X
                e = check_spmv(f"cell {name} b={b} {vdt}", v, cols, X, vlay)
                if b == 1 and cols.shape[1] >= spm.LONG_ROW:
                    e = max(e, check_spmv(f"cell {name} b={b} {vdt}", v,
                                          cols, X))
                if vdt == torch.float32:
                    err = max(err, e)
            del vlay
    print(f"phase 6: sparse_matvec matches its plain version on both packs "
          f"(b = 1, 20 and 32, f32 and bf16 values, through the layouts; "
          f"the transposed b = 1 also without), bitwise stable; max abs "
          f"err (f32) {err:.3e}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    smax = float(s_true[0])
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")

    def gen_f():
        return torch.Generator(device=DEV).manual_seed(seed + 12)

    guard = counting_op(S)
    spm.reset_launches()
    fact, wall = timed(lambda: factorize(guard, spec, generator=gen_f()))
    launches = spm.LAUNCHES["sparse_matvec"]
    k = MAX_ITERS
    touches = {kk: v for kk, v in guard.counts.items() if v}
    ferr = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
    print(f"phase 6: fsvd wall {wall:.3f} s, iterations "
          f"{int(fact.iterations)}, breakdown {bool(fact.breakdown)}, "
          f"max|sigma - sigma_true|/sigma_max {ferr:.3e} (bound "
          f"{SPARSE_STOL}), sparse_matvec launches {launches} (touches "
          f"{touches})", flush=True)
    check(touches == {"mv": k, "rmv": k, "matmat": 1},
          f"fsvd touched the sparse operand {touches}")
    check(launches == 2 * k + 1, f"fsvd launched sparse_matvec {launches} "
                                 f"times, not {2 * k + 1}")
    check(ferr < SPARSE_STOL, f"sparse fsvd sigma error {ferr:.3e}")
    again, wall2 = timed(lambda: factorize(S, spec, generator=gen_f()))
    check(torch.equal(fact.s, again.s), "sparse fsvd sigma differs bitwise "
                                        "on a rerun")
    print(f"phase 6: fsvd rerun wall {wall2:.3f} s, sigma bitwise equal",
          flush=True)

    auto_spec = SVDSpec(method="auto", rank=R_WANT, backend="pallas")
    spm.reset_launches()
    auto, wall3 = timed(lambda: factorize(S, auto_spec, generator=gen_f()))
    auto_launches = spm.LAUNCHES["sparse_matvec"]
    aerr = float((auto.s.double() - s_true[:R_WANT]).abs().max()) / smax
    # the same solve behind a counting wrapper (which "auto" would not
    # see as sparse): each block product must be one launch
    guard = counting_op(S)
    spm.reset_launches()
    counted = factorize(guard, auto_spec.replace(method=auto.method),
                        generator=gen_f())
    touches = sum(guard.counts.values())
    print(f"phase 6: auto -> {auto.method} wall {wall3:.3f} s, block passes "
          f"{int(auto.iterations)}, sigma error {aerr:.3e} (bound "
          f"{SPARSE_STOL}), sparse_matvec launches {auto_launches} for "
          f"{touches} operator products", flush=True)
    check(auto.method == "fsvd_blocked", f"auto picked {auto.method}")
    check(auto_launches == spm.LAUNCHES["sparse_matvec"] == touches,
          "a block product was not one sparse_matvec launch")
    check(torch.equal(auto.s, counted.s), "fsvd_blocked sigma differs "
                                          "bitwise on a rerun")
    check(aerr < SPARSE_STOL, f"sparse fsvd_blocked sigma error {aerr:.3e}")

    est, wall4 = timed(lambda: estimate_rank(
        S, SVDSpec(max_iters=RANK_ITERS, backend="pallas"),
        generator=gen_f()))
    print(f"phase 6: estimate_rank wall {wall4:.3f} s, rank {int(est)}, GK "
          f"iterations {int(est.iterations)}", flush=True)
    check(int(est) == RANK, f"estimate_rank returned {int(est)}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 6: peak device memory over the solves {peak / GIB:.2f} "
          f"GiB (bound {SPARSE_PEAK} GiB)", flush=True)
    check(peak < SPARSE_PEAK * GIB, f"sparse peak {peak / GIB:.2f} GiB")

    rows = []
    vb = S.ell[0].element_size()
    for name, (vals, cols, nx, lay) in packs.items():
        csr = csr_of_pack(vals, cols)
        ny = vals.shape[0]
        for b in (1, 20):
            X = torch.randn(nx, b, generator=gen, device=DEV)
            if b == 1:
                x = X[:, 0].contiguous()
                lib = (lambda csr=csr, x=x: csr @ x)
            else:
                x = X
                lib = (lambda csr=csr, x=x: torch.sparse.mm(csr, x))
            nbytes = nnz * (vb + 4) + 4 * b * (nx + ny)
            # the main path's call, as the operator makes it
            row = time_row(
                f"sparse_matvec {name} b={b}",
                lambda v=vals, c=cols, x=x, w=lay:
                    spm.sparse_matvec(v, c, x, w),
                lambda v=vals, c=cols, x=x: ref.sparse_matvec(v, c, x),
                lib, nbytes, 2 * nnz * b, f"({ny} rows x L "
                f"{vals.shape[1]}, x {nx}x{b}, f32)", phase=6,
                graph=(60, 5))
            row["call"] = f"{name} b={b}"
            if b > 1:
                # what bounds this design: the pack, X and the output once,
                # and its partials (windows x rows x b f32) written and
                # read once, from device memory
                windows = spm.block_windows(nx, b)
                part = 2 * windows * ny * b * 4
                row["design_floor_ms"] = ((nbytes + part) / HBM_BYTES_PER_S
                                          * 1e3)
                # the previous design gathered each slot's X row (b f32)
                # from L2 as the 32-byte sectors it spans: its L2 volume
                # (with the pack), and the time those sectors would take
                # from device memory (a gather's sector floor; this design
                # gathers from shared memory instead)
                spans = sectors_spanned(idx[:, 1 if name == "forward"
                                            else 0], b)
                gathered = spans * 32
                row["previous_design_l2_gb"] = (nnz * (vb + 4) + gathered) / 1e9
                row["previous_design_sector_ms"] = (
                    (nnz * (vb + 4) + gathered + 4 * b * ny)
                    / HBM_BYTES_PER_S * 1e3)
                row["previous_design_ms"] = b20[name][0]
                print(f"phase 6: sparse_matvec {name} b={b}: this design's "
                      f"floor {row['design_floor_ms']:.4f} ms (the bound's "
                      f"bytes and {windows} windows of partials, "
                      f"{part / 1e9:.3f} GB written and read; kernel "
                      f"{100 * row['design_floor_ms'] / row['ms']:.0f} % of "
                      f"it); the previous design's gather from L2: "
                      f"{row['previous_design_l2_gb']:.2f} GB ({spans} "
                      f"sectors), {row['previous_design_sector_ms']:.4f} ms "
                      f"as sectors of device memory", flush=True)
            elif vals.shape[1] < spm.LONG_ROW:
                # one vector through short rows: the warp-per-row kernel
                # over the layout's order (the main path) and over a fresh
                # pack in COO order (the previous design's), in turns, here
                # beside the row
                fv, fc = spm.ell_pack(data, idx if name == "forward"
                                      else idx.flip(1), (ny, nx))
                coo = lambda: spm.sparse_matvec(fv, fc, x)       # noqa: E731
                own = lambda: spm.sparse_matvec(vals, cols, x,   # noqa: E731
                                                lay)
                turns = [graph_ms([f], 60, 5)
                         for f in (own, coo, coo, own, own, coo)]
                row["turns_layout_ms"] = turns[0::3] + turns[4:5]
                row["turns_coo_ms"] = turns[1:3] + turns[5:6]
                del fv, fc
                print(f"phase 6: sparse_matvec {name} b=1 in turns beside "
                      f"the row, device time: the layout's order "
                      + " / ".join(f"{t:.4f}" for t in row["turns_layout_ms"])
                      + " ms, COO order (the previous design's) "
                      + " / ".join(f"{t:.4f}" for t in row["turns_coo_ms"])
                      + " ms", flush=True)
            rows.append(row)
        del csr
    # the row of the kernels line: the GK half-steps (b = 1, both packs),
    # 400 of the fsvd solve's 401 launches, as the mean per launch
    half = [r for r in rows if r["call"].endswith("b=1")]
    out = {key: sum(r[key] for r in half) / len(half)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = "bytes"
    out["host_loop_ms"] = sum(r["host_loop_ms"] for r in half) / len(half)
    out["calls"] = [{k: r[k] for k in ("call", "ms", "plain_ms",
                                       "library_ms", "host_loop_ms",
                                       "host_loop_library_ms",
                                       "bound_ms", "share_of_bound",
                                       "design_floor_ms",
                                       "previous_design_l2_gb",
                                       "previous_design_sector_ms",
                                       "previous_design_ms",
                                       "turns_layout_ms", "turns_coo_ms")
                     if k in r}
                    for r in rows]
    out["nnz"] = nnz
    return launches, err, out, phase_reorth(S, seed)


def zipf_counts(total, rows, cap):
    """Row lengths of a Zipf profile (the k-th longest ~ C / k) summing to
    ``total``, none above ``cap``: C found by bisection, the remainder of
    the rounding given one each to the longest rows below the cap."""
    import numpy as np
    k = np.arange(1, rows + 1, dtype=np.float64)
    lo, hi = 0.0, float(total) * rows
    for _ in range(200):
        c = (lo + hi) / 2
        if np.minimum(cap, c / k).sum() < total:
            lo = c
        else:
            hi = c
    counts = np.minimum(cap, np.floor(lo / k)).astype(np.int64)
    short = total - int(counts.sum())
    free = np.nonzero(counts < cap)[0][:short]
    counts[free] += 1
    return counts


def phase_skew(seed, m, n, nnz):
    """Phase 6b: a transposed pack of the phase-6 shape whose row lengths
    follow a Zipf profile (ROADMAP Queue 3): n rows (movies) of the sparse
    cell's nnz entries in total, the k-th longest ~1/k of a constant, at
    most ZIPF_CAP times the mean, in a random order; columns (users)
    uniform over m, Gaussian values, all from the seed.  One vector and a
    20-column block through its window layout, by device time, beside
    cuSPARSE on the entries' CSR (without the pack's padding), and held
    against the plain version on the longest rows and a run of others.
    Returns the timing rows."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_matvec as spm
    g = torch.Generator(device=DEV).manual_seed(seed + 15)
    cap = ZIPF_CAP * nnz // n
    counts = torch.from_numpy(zipf_counts(nnz, n, cap)).to(DEV)
    counts = counts[torch.randperm(n, generator=g, device=DEV)]
    rows = torch.repeat_interleave(torch.arange(n, device=DEV), counts)
    cols = torch.randint(0, m, (nnz,), generator=g, device=DEV)
    data = torch.randn(nnz, generator=g, device=DEV)
    idx = torch.stack([rows, cols], 1).to(torch.int32)
    del rows, cols
    (vals, pcols), t_pack = timed(lambda: spm.ell_pack(data, idx, (n, m)))
    lay, t_lay = timed(lambda: spm.pack_layout(vals, pcols, m, counts))
    check(lay is not None and lay.offsets is not None,
          "the skewed pack's layout lacks its sub-window table")
    del vals, pcols
    L = lay.vals.shape[1]
    order = torch.argsort(idx[:, 0].long(), stable=True)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=DEV)
    torch.cumsum(counts, 0, out=crow[1:])
    with warnings.catch_warnings():       # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(crow, idx[order, 1].long(),
                                      data[order], size=(n, m),
                                      check_invariants=False)
    del order, data, idx
    longest = torch.topk(counts, 8).indices
    others = torch.arange(n // 2, min(n, n // 2 + 512), device=DEV)
    print(f"phase 6b: skewed transposed pack {n} rows x L {L} over x of "
          f"{m} (Zipf row lengths, longest {int(counts.max())} = "
          f"{ZIPF_CAP}x the mean {nnz // n}, shortest {int(counts.min())}; "
          f"fill {nnz / (n * L):.4f}), pack in {t_pack:.3f} s, layout in "
          f"{t_lay:.3f} s", flush=True)
    out = []
    for b in (1, 20):
        X = torch.randn(m, b, generator=g, device=DEV)
        X = X[:, 0].contiguous() if b == 1 else X
        got = bitwise_twice(f"skewed b={b}", lambda: (spm.sparse_matvec(
            lay.vals, lay.cols, X, lay),))[0]
        for r in (longest, others):
            compare(f"sparse_matvec skewed b={b}", (got[r],),
                    (ref.sparse_matvec(lay.vals[r], lay.cols[r], X),),
                    (torch.float32,))
        lib = (lambda x=X: csr @ x) if b == 1 else \
            (lambda x=X: torch.sparse.mm(csr, x))
        row = dict(call=f"skewed transposed b={b}",
                   ms=graph_ms([lambda x=X: spm.sparse_matvec(
                       lay.vals, lay.cols, x, lay)], 60, 5),
                   library_ms=graph_ms([lib], 60, 5),
                   bound_ms=(nnz * 8 + 4 * b * (m + n)) / HBM_BYTES_PER_S
                   * 1e3)
        print(f"phase 6b: sparse_matvec skewed transposed b={b}, device "
              f"time: kernel {row['ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['ms']:.0f} % of the bound "
              f"{row['bound_ms']:.4f} ms), cuSPARSE (CSR of the entries) "
              f"{row['library_ms']:.4f} ms; matches the plain version on "
              f"the 8 longest rows and 512 others, bitwise stable",
              flush=True)
        out.append(row)
    return out


# --- phase 10: the paper's RSL application at full width -------------------

RSL_EVERY = 50                # the trainer's log steps: gated retractions
RSL_RETRACT_TOL = 1e-4        # retract_fsvd vs retract_qr, relative Frobenius
RSL_LOOP_SLACK = 256 * 2 ** 20   # the loop's peak <= its start + this
RSL_ACC = 0.85                # train accuracy over the 8,192 pairs
RSL_LOSS_RATIO = 0.5          # tests/test_rsgd.py: last 10 vs first 5
RSL_RERUN_STEPS, RSL_COLD_STEPS, RSL_RESUME_STEPS = 20, 20, 100
RSL_PROFILE_STEPS = 3          # steps under the profiler
RSL_WALL_STEPS = 10            # steps timed without it
RSL_RITZ_SLACK = 1e-5         # Ritz sigma <= exact sigma (1 + this)


def kernel_launches():
    """Every launch counter of the twelve kernels, as one dict."""
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import reorth as kre
    from repro_torch.kernels import sketch_matvec as ksm
    from repro_torch.kernels import sparse_matvec as kspm
    out = {}
    for mod in (gs, kre, klu, ksm, kspm, kcs):
        out.update(mod.LAUNCHES)
    return out


def point_distance(Wa, Wb):
    """||Wa - Wb||_F / ||Wb||_F of two factored points, in f64 and through
    their factors: thin QRs of [Ua sa, -Ub sb] and [Va, Vb], then the norm
    of R_l R_r^T (a difference of Gram traces would lose 1e-4 to f32
    cancellation)."""
    import torch

    def fro(left, right):
        return torch.linalg.vector_norm(
            torch.linalg.qr(left).R @ torch.linalg.qr(right).R.T)

    Ua, sa, Va = (t.double() for t in Wa)
    Ub, sb, Vb = (t.double() for t in Wb)
    num = fro(torch.cat([Ua * sa, -(Ub * sb)], 1), torch.cat([Va, Vb], 1))
    return float(num / fro(Ub * sb, Vb))


def retraction_errors(events, opts):
    """For each kept step, the trainer's retract_fsvd point against
    retract_qr on the same (W, xi, -lr)."""
    from repro_torch.core import manifold as mf
    from repro_torch.core import rsgd
    errs = []
    for e in events:
        W0, b = e["W_prev"], e["batch"]
        g = rsgd.batch_euclidean_grad(W0, b["x"], b["v"], b["y"], opts.loss,
                                      opts.weight_decay)
        Wq = mf.retract_qr(W0, mf.project_tangent(W0, g.op), -opts.lr)
        errs.append((e["step"], point_distance(e["W"], Wq)))
    return errs


def gradient_sigma(g):
    """Exact sigma of the batch gradient Xb^T diag(c) Vb from its factors:
    thin QRs of Xb^T and Vb^T, then the SVD of the b x b core, in f64."""
    import torch
    R1 = torch.linalg.qr(g.U.double()).R
    R2 = torch.linalg.qr(g.Vt.T.double()).R
    return torch.linalg.svdvals(R1 * g.s.double()[None, :] @ R2.T)


def rsl_run(argv, keep):
    """One train_rsl.main run on the card; ``keep(event)`` chooses the
    step events to hold."""
    from repro_torch.launch import train_rsl
    events = []
    out = train_rsl.main(["--device", DEV] + argv,
                         observe=lambda e: keep(e) and events.append(e))
    return out, events


def rsl_profile(seed, opts):
    """RSL_PROFILE_STEPS tracking steps at full width under torch.profiler:
    CUDA ops (kernels, copies, sets) and summed device time a step,
    beside the step's wall over RSL_WALL_STEPS steps without the
    profiler, and the GK iterations of one retraction."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.core import manifold as mf
    from repro_torch.core import rsgd
    from repro_torch.data.synthetic import rsl_batch
    from repro_torch.launch import train_rsl
    n_train, d1, d2, rank, batch = 8192, 10_000, 10_000, 5, 64
    ds, W = train_rsl.build(seed, n_train, d1, d2, rank, DEV)
    step = rsgd.make_step(opts)
    warm = 3
    batches = [rsl_batch(ds, seed, t, batch) for t in
               range(warm + RSL_WALL_STEPS + RSL_PROFILE_STEPS)]
    for b in batches[:warm]:
        W, _ = step(W, b["x"], b["v"], b["y"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[warm:warm + RSL_WALL_STEPS]:
        W, _ = step(W, b["x"], b["v"], b["y"])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / RSL_WALL_STEPS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches[warm + RSL_WALL_STEPS:]:
            W, _ = step(W, b["x"], b["v"], b["y"])
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    launches = len(device) / RSL_PROFILE_STEPS if device else None
    device_ms = (sum(e.time_range.elapsed_us() for e in device) / 1e3
                 / RSL_PROFILE_STEPS) if device else None
    # one retraction's GK iterations: the operand has rank <= 3r
    b = batches[-1]
    g = rsgd.batch_euclidean_grad(W, b["x"], b["v"], b["y"])
    xi = mf.project_tangent(W, g.op)
    op = mf.as_linop(W, xi, -opts.lr)
    k = min(max(opts.fsvd_iters, rank + 2), min(op.shape))
    fact = factorize(op, SVDSpec(method="fsvd", rank=rank, max_iters=k),
                     q1=W.U @ W.s)
    return dict(steps=RSL_PROFILE_STEPS, wall_steps=RSL_WALL_STEPS,
                wall_ms=wall_ms,
                cuda_ops_per_step=launches, device_ms_per_step=device_ms,
                host_share=(None if device_ms is None
                            else 1.0 - device_ms / wall_ms),
                gk_iterations_run=k, gk_kprime=int(fact.iterations))


def phase_rsl(seed):
    """Phase 10: the paper's RSL application (train_rsl at the example's
    defaults: W 10000 x 10000 rank 5, batch 64, lr 3.0, 8,192 pairs)
    through the trainer's entry point; see the module docstring."""
    import shutil
    import tempfile
    import torch
    from repro_torch.api import trace_count
    from repro_torch.core import rsgd
    gc.collect()
    torch.cuda.empty_cache()
    before = kernel_launches()
    seed_args = ["--seed", str(seed)]
    track = rsgd.RSGDOptions(lr=3.0, fsvd_iters=20)
    rec = {}

    # (a) tracking, 300 steps
    traces = trace_count()
    t0 = time.perf_counter()
    out, events = rsl_run(seed_args, lambda e: e["step"] % RSL_EVERY == 0)
    wall = time.perf_counter() - t0
    traces = trace_count() - traces
    losses = out["losses"]
    ratio = sum(losses[-10:]) / 10 / (sum(losses[:5]) / 5)
    errs = retraction_errors(events, track)
    spec = out["spectrum"]
    print(f"phase 10 (a): {out['steps']} tracking steps, "
          f"{out['ms_per_step']:.3f} ms a step ({wall:.1f} s with the "
          f"dataset); loss {sum(losses[:5]) / 5:.4f} -> "
          f"{sum(losses[-10:]) / 10:.4f} (ratio {ratio:.3f}), train acc "
          f"{out['train_acc']:.4f}; sigma {['%.3f' % x for x in spec]}, "
          f"planted {['%.3f' % x for x in out['planted']]}; traces "
          f"{traces}; retract_fsvd vs retract_qr "
          + ", ".join(f"step {t}: {e:.2e}" for t, e in errs), flush=True)
    check(ratio < RSL_LOSS_RATIO, f"phase 10: loss ratio {ratio:.3f}")
    check(out["train_acc"] >= RSL_ACC,
          f"phase 10: train accuracy {out['train_acc']:.4f}")
    check(len(spec) == 5 and all(math.isfinite(x) and x > 0 for x in spec),
          f"phase 10: learned sigma {spec}")
    check(traces == 1, f"phase 10: {traces} traces over the run")
    check(len(errs) == (out["steps"] - 1) // RSL_EVERY + 1
          and all(e <= RSL_RETRACT_TOL for _, e in errs),
          f"phase 10: retract_fsvd vs retract_qr {errs}")
    mem = out["memory"]
    if mem is not None:
        print(f"phase 10 (a): device memory at the loop's start "
              f"{mem['start_bytes'] / 2 ** 20:.1f} MiB, peak "
              f"{mem['peak_bytes'] / 2 ** 20:.1f} MiB (limit start + "
              f"{RSL_LOOP_SLACK / 2 ** 20:.0f} MiB)", flush=True)
        check(mem["peak_bytes"] <= mem["start_bytes"] + RSL_LOOP_SLACK,
              f"phase 10: loop peak {mem}")
    rec["tracking"] = dict(
        steps=out["steps"], ms_per_step=out["ms_per_step"],
        loss_first5=sum(losses[:5]) / 5, loss_last10=sum(losses[-10:]) / 10,
        train_acc=out["train_acc"], sigma=spec, planted=out["planted"],
        traces=traces, retract_rel_err=errs, memory=mem)
    del events

    # (b) the first steps twice from the seed: the same bits
    runs = [rsl_run(seed_args + ["--steps", str(RSL_RERUN_STEPS)],
                    lambda e: False)[0] for _ in range(2)]
    same = runs[0]["losses"] == runs[1]["losses"] and all(
        torch.equal(a, b) for a, b in zip(runs[0]["W"], runs[1]["W"]))
    print(f"phase 10 (b): {RSL_RERUN_STEPS} steps twice from the seed: U, "
          f"s, V and losses bit for bit {same}", flush=True)
    check(same, "phase 10: a rerun from the seed differs")
    rec["rerun_bitwise"] = same
    del runs

    # (c) cold retractions
    cold_every = RSL_COLD_STEPS - 1
    out_c, events = rsl_run(
        seed_args + ["--steps", str(RSL_COLD_STEPS), "--no-track"],
        lambda e: e["step"] % cold_every == 0)
    errs_c = retraction_errors(
        events, rsgd.RSGDOptions(lr=3.0, fsvd_iters=20, track=False))
    print(f"phase 10 (c): {RSL_COLD_STEPS} cold steps, "
          f"{out_c['ms_per_step']:.3f} ms a step (tracking "
          f"{out['ms_per_step']:.3f}); retract_fsvd vs retract_qr "
          + ", ".join(f"step {t}: {e:.2e}" for t, e in errs_c), flush=True)
    check(all(e <= RSL_RETRACT_TOL for _, e in errs_c),
          f"phase 10: cold retract_fsvd vs retract_qr {errs_c}")
    rec["cold"] = dict(steps=RSL_COLD_STEPS,
                       ms_per_step=out_c["ms_per_step"],
                       retract_rel_err=errs_c)
    del events

    # (d) the gradient-spectrum Session, saved and resumed
    directory = tempfile.mkdtemp(prefix="chip_smoke_rsl.")
    try:
        resume = []
        for run in range(2):
            out_d, events = rsl_run(
                seed_args + ["--steps", str(RSL_RESUME_STEPS),
                             "--grad-spectrum", "--session-dir", directory],
                lambda e: "grad" in e)
            ritz = []
            for e in events:
                exact = gradient_sigma(e["grad"])[:5]
                got = e["grad_fact"].s.double()
                ritz.append(dict(
                    step=e["step"],
                    rel_err=float(torch.max(torch.abs(got - exact))
                                  / exact[0]),
                    bound_ok=bool(torch.all(
                        got <= exact * (1 + RSL_RITZ_SLACK)))))
            sess = out_d["session"]
            print(f"phase 10 (d): run {run + 1}: resumed at "
                  f"{sess['resumed_at']}, {sess['solves']} solves, kinds "
                  f"{sess['kinds']}; Ritz sigma vs exact (max |err| / "
                  f"sigma_1) " + ", ".join(
                      f"step {r['step']}: {r['rel_err']:.2e}"
                      f"{'' if r['bound_ok'] else ' ABOVE'}" for r in ritz),
                  flush=True)
            check(bool(ritz) and all(r["bound_ok"] for r in ritz),
                  f"phase 10: Ritz sigma above the exact sigma: {ritz}")
            resume.append(dict(sess, ms_per_step=out_d["ms_per_step"],
                               ritz=ritz))
            del events
        check(resume[0]["resumed_at"] is None
              and resume[1]["resumed_at"] == resume[0]["solves"],
              f"phase 10: resume {resume}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    rec["session"] = resume

    # (e) the step under the profiler
    prof = rsl_profile(seed, track)
    print(f"phase 10 (e): a tracking step: wall {prof['wall_ms']:.3f} ms, "
          f"CUDA ops {prof['cuda_ops_per_step']}, device time "
          f"{prof['device_ms_per_step']} ms, host share "
          f"{prof['host_share']}; a retraction runs "
          f"{prof['gk_iterations_run']} GK iterations, kprime "
          f"{prof['gk_kprime']}", flush=True)
    rec["profile"] = prof

    after = kernel_launches()
    print(f"phase 10: launches of the twelve kernels in this phase: "
          f"{ {k: after[k] - before[k] for k in after} }", flush=True)
    check(after == before, "phase 10 launched a hand-written kernel")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# --- phase 11: the solve server on the card --------------------------------

WIDE = 64                     # DEFAULT_SHAPES x 64: 17-25 M entries each
WIDE_REQUESTS = 48
ENTRY_REQUESTS, ENTRY_TENANTS, ENTRY_NNZ = 16, 2, 4096
ENTRY_SHAPE = (6144, 4096)
EXACT_BATCH = 8               # the batch held bit for bit to a direct call
SERVED_BOUND = 1e-2           # tests/test_serve.py:289-293
UPDATE_BOUND = 1e-5           # GATE, tests/test_update.py:26
DEGRADED_BOUND = 0.05         # tests/test_resilience.py, chaos SIGMA_GATE
# benchmarks/chaos_bench.py:45-64 and :100-127
CHAOS_REQUESTS, CHAOS_SEED, CHAOS_POISONED = 160, 7, 2
CHAOS_DEADLINE_MS, CHAOS_AVAILABILITY = 15000.0, 0.99
CHAOS_MIXES = [("faulty", dict(crash=0.03, hang=0.01, transient=0.05)),
               ("storm", dict(crash=0.10, hang=0.03, transient=0.15))]
SERVE_KERNELS = GK_STEP + ("lowrank_matmul", "sketch_matmat", "scatter_add")


def reset_kernel_launches():
    """Every launch counter of the twelve kernels to 0."""
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import reorth as kre
    from repro_torch.kernels import sketch_matvec as ksm
    from repro_torch.kernels import sparse_matvec as kspm
    for mod in (gs, kre, klu, ksm, kspm, kcs):
        mod.reset_launches()


def exact_top_sigma(A, r):
    """The top-r sigma of a host operand in f64: the square roots of the
    top eigenvalues of its f64 Gram matrix (cuBLAS and cuSOLVER on the
    card, no kernel of the port).  Exact to ~1e-10 sigma_max at these
    shapes, as a host SVD would be, at a fraction of its time."""
    import torch
    X = torch.from_numpy(A).to(DEV, torch.float64)
    G = X.T @ X if X.shape[0] >= X.shape[1] else X @ X.T
    ev = torch.linalg.eigvalsh(G).flip(0)[:r].clamp(min=0.0)
    return ev.sqrt().cpu()


def sigma_error(s, A):
    """max |s - sigma(A)| / sigma_max(A) over the top len(s)."""
    import torch
    s = torch.as_tensor(s).double().cpu()
    exact = exact_top_sigma(A, s.shape[-1])
    return float((s - exact).abs().max() / exact[0])


class DispatchLog:
    """Instruments one server for a replay: each dispatch's group, size,
    host wall (ending in a synchronize), kernel launches, and the time of
    its copies in (``serve.server.stack``: the host stack and one host ->
    device copy) and out (``serve.server._to_host``: one device -> host
    copy a field, after a synchronize).  Dispatches run one at a time on
    the worker thread, so the deltas belong to the dispatch."""

    def __init__(self, server):
        import torch
        from repro_torch.serve import server as srv_mod
        self.rows, self._cur, self._mod = [], None, srv_mod
        self._real = (srv_mod.stack, srv_mod._to_host)
        real_stack, real_host = self._real
        inner = server.batcher._dispatch

        def stack(arrays, device=None):
            t0 = time.perf_counter()
            out = real_stack(arrays, device)
            torch.cuda.synchronize()
            self._add("copy_in_ms", t0)
            return out

        def to_host(obj):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_host(obj)
            self._add("copy_out_ms", t0)
            return out

        def dispatch(group, tickets):
            rec = dict(kind=group[0], group=str(group[1]), n=len(tickets),
                       copy_in_ms=0.0, copy_out_ms=0.0)
            before = kernel_launches()
            self._cur = rec
            t0 = time.perf_counter()
            try:
                inner(group, tickets)
            finally:
                torch.cuda.synchronize()
                rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
                after = kernel_launches()
                rec["launches"] = {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}
                if group[0] == "tenant":
                    rec["steps"] = [t.result(0).meta["kind"]
                                    for t in tickets if t.done
                                    and t._error is None]
                self._cur = None
                self.rows.append(rec)

        server.batcher._dispatch = dispatch
        srv_mod.stack, srv_mod._to_host = stack, to_host

    def _add(self, key, t0):
        if self._cur is not None:
            self._cur[key] += (time.perf_counter() - t0) * 1e3

    def close(self):
        self._mod.stack, self._mod._to_host = self._real

    def launches(self, kind):
        out = {}
        for rec in self.rows:
            if rec["kind"] == kind:
                for k, v in rec["launches"].items():
                    out[k] = out.get(k, 0) + v
        return out


def gk_device_ms(B, shape, k):
    """Device time of one in-graph batched GK loop of k steps over a
    (B, m, n) stack (backend "pallas"), in one CUDA graph as phase 8
    times it: what a dispatch of B padded requests at ``shape`` needs the
    card for, before the Ritz step."""
    import torch
    from repro_torch.core import gk as gk_mod
    from repro_torch.core.operators import DenseOp
    g = torch.Generator(device=DEV).manual_seed(B * 7 + shape[0])
    As = torch.randn(B, *shape, generator=g, device=DEV)
    q1s = 2.0 + torch.randn(B, shape[0], generator=g, device=DEV)
    op = DenseOp(As, backend="pallas")
    ms = graph_ms([lambda: gk_mod.gk_bidiag_batched(op, k, q1s=q1s)],
                  reps=1, replays=3)
    del As, op
    torch.cuda.empty_cache()
    return ms


def quantiles(xs):
    xs = sorted(xs)
    if not xs:
        return None
    pick = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return dict(min=xs[0], p50=pick(0.5), max=xs[-1], n=len(xs))


def replay_summary(label, counts, stats, log, wall_s, peak):
    """One replay's line: requests/s, p50 / p99, batches, copies, peak."""
    lat = stats["latency_ms"]
    rec = dict(requests=sum(counts[k] for k in ("ok", "rejected", "failed",
                                                 "timeouts")),
               ok=counts["ok"], failed=counts["failed"],
               errors=counts["errors"], wall_s=wall_s,
               requests_per_s=counts["ok"] / wall_s,
               p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
               batch_histogram=stats["batch_histogram"],
               bucket_hit_rate=stats["bucket_hit_rate"],
               worker_restarts=stats["worker_restarts"],
               peak_gib=peak / GIB)
    if log is not None:
        anon = [r for r in log.rows if r["kind"] == "solve"]
        rec["copy_in_ms"] = quantiles([r["copy_in_ms"] for r in anon])
        rec["copy_out_ms"] = quantiles([r["copy_out_ms"] for r in anon])
    print(f"phase 11 {label}: {rec['ok']}/{rec['requests']} ok in "
          f"{wall_s:.2f} s = {rec['requests_per_s']:.1f} requests/s; p50 "
          f"{rec['p50_ms']:.1f} ms, p99 {rec['p99_ms']:.1f} ms; batches "
          f"{rec['batch_histogram']}, bucket hit rate "
          f"{rec['bucket_hit_rate']:.3f}, worker restarts "
          f"{rec['worker_restarts']}; peak device memory "
          f"{rec['peak_gib']:.2f} GiB"
          + (f"; copy in (ms) {rec['copy_in_ms']}, copy out (ms) "
             f"{rec['copy_out_ms']}" if log is not None else ""),
          flush=True)
    return rec


def serve_cli(seed):
    """(a) the CLI at the reference's defaults (backend "xla"): 200
    requests, 4 clients, fsvd rank 8, Zipf 1.1, 4 tenants at 0.25,
    quantum 32, exact mode, max batch 8, a 4 ms window, with warmup."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import solve_serve
    reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    sink = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sink):
        out = solve_serve.main(["--device", DEV, "--seed", str(seed)])
    wall = time.perf_counter() - t0
    drv, st = out["traffic"], out["server"]
    rec = replay_summary("(a) the CLI at its defaults, backend xla", drv, st,
                         None, drv["wall_s"],
                         torch.cuda.max_memory_allocated())
    rec.update(cli_wall_s=wall, tenants=st["tenants"],
               launches=kernel_launches())
    check(drv["ok"] == 200 and rec["requests"] == 200,
          f"phase 11 (a): {drv}")
    check(st["worker_restarts"] == 0,
          f"phase 11 (a): {st['worker_restarts']} worker restarts")
    check(st["bucket_hit_rate"] == 1.0,
          f"phase 11 (a): bucket hit rate {st['bucket_hit_rate']}")
    return rec


def wide_replay(seed):
    """(b) DEFAULT_SHAPES x 64 through SolveServer(fsvd rank 8, backend
    "pallas") on the card: 48 requests, 4 clients, 4 tenants at 0.25,
    structured (rank-2 delta) tenant drift; then one batch of 8 against
    the direct call, and the entries replay."""
    import numpy as np
    import torch
    from repro_torch.api import SVDSpec
    from repro_torch.launch.solve_serve import run_traffic
    from repro_torch.serve import SolveServer
    from repro_torch.serve.bucket import stack
    from repro_torch.serve.traffic import (DEFAULT_SHAPES, lowrank_operand,
                                           synthetic_stream)
    shapes = [(m * WIDE, n * WIDE) for m, n in DEFAULT_SHAPES]
    spec = SVDSpec(method="fsvd", rank=8, backend="pallas")
    t0 = time.perf_counter()
    reqs = list(synthetic_stream(WIDE_REQUESTS, shapes=shapes, rank=8,
                                 tenants=4, tenant_fraction=0.25,
                                 structured_drift=True, seed=seed))
    gen_s = time.perf_counter() - t0
    print(f"phase 11 (b): {WIDE_REQUESTS} requests at DEFAULT_SHAPES x "
          f"{WIDE} made on the host in {gen_s:.1f} s "
          f"({sum(r.A.nbytes for r in reqs) / GIB:.2f} GiB)", flush=True)
    served = {}
    srv = SolveServer(spec, generator=torch.Generator().manual_seed(seed),
                      device=DEV)
    log = DispatchLog(srv)
    try:
        t0 = time.perf_counter()
        srv.warmup(shapes)
        warm_s = time.perf_counter() - t0
        reset_kernel_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = run_traffic(srv, reqs, clients=4, on_result=lambda r, o, d:
                             served.__setitem__(id(r), (o, d)))
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        log.close()
        srv.close()
    stats = srv.stats()
    rec = replay_summary("(b) the wide replay, backend pallas", counts,
                         stats, log, counts["wall_s"], peak)
    rec.update(generate_s=gen_s, warmup_s=warm_s, tenants=stats["tenants"],
               launches=launches, launches_anonymous=log.launches("solve"),
               launches_tenant=log.launches("tenant"))
    check(counts["ok"] == WIDE_REQUESTS, f"phase 11 (b): {counts}")
    anon_err, update_err, kinds = 0.0, 0.0, {}
    for r in reqs:
        _, res = served[id(r)]
        err = sigma_error(res.value.s, r.A)
        if r.tenant is None:
            anon_err = max(anon_err, err)
            continue
        kinds.setdefault(r.tenant, []).append(
            (res.meta["kind"], res.meta["iterations"]))
        if res.meta["kind"] == "update":
            update_err = max(update_err, err)
            check(res.meta["iterations"] == 0,
                  f"phase 11 (b): an update ran {res.meta['iterations']} "
                  f"GK iterations")
        else:
            check(err < SERVED_BOUND, f"phase 11 (b): tenant sigma {err}")
    print(f"phase 11 (b): anonymous sigma vs exact (f64) max "
          f"{anon_err:.3e} (bound {SERVED_BOUND}); updates {update_err:.3e} "
          f"(bound {UPDATE_BOUND}); tenant steps {kinds}; launches on "
          f"anonymous batches {rec['launches_anonymous']}, on tenant "
          f"requests {rec['launches_tenant']}", flush=True)
    check(anon_err < SERVED_BOUND, f"phase 11 (b): sigma error {anon_err}")
    check(update_err < UPDATE_BOUND, f"phase 11 (b): update {update_err}")
    for steps in kinds.values():
        check(steps[0][0] == "cold"
              and all(k in ("refine", "update") for k, _ in steps[1:]),
              f"phase 11 (b): tenant steps {kinds}")
    check(any(k == "update" for s in kinds.values() for k, _ in s),
          f"phase 11 (b): no update among {kinds}")
    check(all(rec["launches_anonymous"].get(k, 0) > 0 for k in GK_STEP),
          f"phase 11 (b): stacked GK launches {rec['launches_anonymous']}")
    check(rec["launches_tenant"].get("lowrank_matmul", 0) > 0,
          f"phase 11 (b): no lowrank_matmul on deltas "
          f"{rec['launches_tenant']}")
    rec.update(anonymous_sigma_err=anon_err, update_sigma_err=update_err,
               tenant_steps=kinds)

    # each anonymous dispatch's wall against its GK loop's device time
    k = min(4 * spec.rank, min(shapes[0]))
    dev = {}
    shares = []
    for row in log.rows:
        if row["kind"] != "solve":
            continue
        B = 1 << (row["n"] - 1).bit_length()
        key = (B, row["group"])
        if key not in dev:
            shape = next(s for s in shapes if str(s) == row["group"])
            dev[key] = gk_device_ms(B, shape, min(k, min(shape)))
        row["gk_device_ms"] = dev[key]
        row["host_share"] = 1.0 - dev[key] / row["wall_ms"]
        shares.append(row["host_share"])
    rec["host_share"] = quantiles(shares)
    rec["dispatch_wall_ms"] = {
        kind: quantiles([r["wall_ms"] for r in log.rows
                         if r["kind"] == kind]) for kind in ("solve",
                                                             "tenant")}
    print(f"phase 11 (b): anonymous dispatches' host share (1 - GK device "
          f"time / wall) {rec['host_share']}; "
          + "; ".join(f"{r['kind']} {r['group']} n={r['n']}: wall "
                      f"{r['wall_ms']:.1f} ms"
                      + (f", GK device {r['gk_device_ms']:.2f} ms, copy in "
                         f"{r['copy_in_ms']:.1f}, out {r['copy_out_ms']:.2f}"
                         if r["kind"] == "solve" else f" {r.get('steps')}")
                      for r in log.rows), flush=True)

    # one batch of 8 submitted together, against the direct call
    ops = [r.A for r in reqs if r.tenant is None
           and r.shape == shapes[0]][:EXACT_BATCH]
    rng = np.random.default_rng(seed + 11)
    while len(ops) < EXACT_BATCH:
        ops.append(lowrank_operand(rng, shapes[0], 8))
    srv = SolveServer(spec, generator=torch.Generator().manual_seed(seed),
                      device=DEV, max_batch=EXACT_BATCH,
                      window_ms=60_000.0)
    try:
        tickets = [srv.submit(A) for A in ops]
        got = [t.result(timeout=120.0) for t in tickets]
        direct = srv.plan.solve_batched(
            stack(ops, DEV), generators=[srv.request_generator(
                t.payload["seq"]) for t in tickets])
    finally:
        srv.close()
    same = all(res.batch == EXACT_BATCH and all(
        torch.equal(getattr(res.value, f), getattr(direct, f)[i].cpu())
        for f in ("U", "s", "V")) for i, res in enumerate(got))
    print(f"phase 11 (b): a batch of {EXACT_BATCH} at {ops[0].shape} "
          f"submitted together: served U, s, V bit for bit the direct "
          f"solve_batched on the same stack and generators: {same}",
          flush=True)
    check(same, "phase 11 (b): a served batch differs from the direct call")
    rec["batch_bitwise"] = same
    del ops, got, direct, reqs, served
    rec["entries"] = entries_replay(seed, spec)
    return rec


def entries_replay(seed, spec):
    """The entries replay: 16 requests, 2 tenants, 4,096 COO entries a
    drift, at (6144, 4096); scatter_add folds them into the tenants'
    resident sketches."""
    import torch
    from repro_torch.launch.solve_serve import run_traffic
    from repro_torch.serve import SolveServer
    from repro_torch.serve.traffic import synthetic_stream
    reqs = list(synthetic_stream(ENTRY_REQUESTS, shapes=[ENTRY_SHAPE],
                                 rank=8, tenants=ENTRY_TENANTS,
                                 tenant_fraction=1.0,
                                 entry_drift_nnz=ENTRY_NNZ, seed=seed))
    served = {}
    srv = SolveServer(spec, generator=torch.Generator().manual_seed(seed),
                      device=DEV)
    log = DispatchLog(srv)
    try:
        srv.warmup([ENTRY_SHAPE])
        reset_kernel_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = run_traffic(srv, reqs, clients=4, on_result=lambda r, o, d:
                             served.__setitem__(id(r), (o, d)))
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        log.close()
        srv.close()
    stats = srv.stats()
    rec = replay_summary("(b) the entries replay, backend pallas", counts,
                         stats, log, counts["wall_s"], peak)
    check(counts["ok"] == ENTRY_REQUESTS, f"phase 11 entries: {counts}")
    steps, worst = [], 0.0
    for r in reqs:
        res = served[id(r)][1]
        m = res.meta
        steps.append((m["kind"], m["iterations"]))
        worst = max(worst, sigma_error(res.value.s, r.A))
        if m["kind"] == "sketch":
            check(m["iterations"] == 0 and m["probe"] <= m["gate"],
                  f"phase 11 entries: sketch step {m}")
    sketched = sum(k == "sketch" for k, _ in steps)
    print(f"phase 11 (b) entries: steps {steps}; {sketched} sketch steps "
          f"of {ENTRY_REQUESTS - ENTRY_TENANTS} entries requests; sigma vs "
          f"exact max {worst:.3e}; launches {launches}", flush=True)
    check(launches["scatter_add"] > 0, "phase 11: no scatter_add launch")
    check(sketched > 0, f"phase 11 entries: no sketch step in {steps}")
    check(worst < SERVED_BOUND, f"phase 11 entries: sigma error {worst}")
    rec.update(steps=steps, sketch_steps=sketched, sigma_err=worst,
               launches=launches, tenants=stats["tenants"])
    return rec


def degraded_and_chaos(seed):
    """(c) one deterministic degraded answer at (6144, 4096), then the
    chaos battery's replay at its own settings, mixes "faulty" and
    "storm"."""
    import numpy as np
    import torch
    from repro_torch.api import SVDSpec
    from repro_torch.launch.solve_serve import run_traffic
    from repro_torch.runtime import faults
    from repro_torch.serve import SolveServer
    from repro_torch.serve.traffic import (DEFAULT_SHAPES, lowrank_operand,
                                           synthetic_stream)
    spec = SVDSpec(method="fsvd", rank=8, backend="pallas")
    A = lowrank_operand(np.random.default_rng(seed + 12), ENTRY_SHAPE, 8)
    srv = SolveServer(spec, generator=torch.Generator().manual_seed(seed),
                      device=DEV)
    try:
        srv.warmup([ENTRY_SHAPE])
        reset_kernel_launches()
        faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, max_fires=1)
        try:
            t0 = time.perf_counter()
            res = srv.solve(A, timeout=120.0)
            wall = time.perf_counter() - t0
        finally:
            faults.disarm_all()
        launches = kernel_launches()
        tol = srv.degraded_tol
    finally:
        srv.close()
    err = sigma_error(res.value.s, A)
    meta = res.meta
    print(f"phase 11 (c): degraded answer at {ENTRY_SHAPE}: {meta}; sigma "
          f"vs exact {err:.3e} (bound {DEGRADED_BOUND}); wall "
          f"{wall * 1e3:.1f} ms; sketch_matmat launches "
          f"{launches['sketch_matmat']}", flush=True)
    check(meta.get("degraded") is True and meta["method"] == "gnystrom"
          and meta["probe"] <= tol, f"phase 11 (c): {meta}")
    check(err < DEGRADED_BOUND, f"phase 11 (c): degraded sigma {err}")
    check(launches["sketch_matmat"] == 3,
          f"phase 11 (c): sketch_matmat launched "
          f"{launches['sketch_matmat']} times")
    rec = dict(degraded=dict(meta, sigma_err=err, wall_ms=wall * 1e3,
                             launches={k: v for k, v in launches.items()
                                       if v}))

    chaos = []
    for label, mix in CHAOS_MIXES:
        reqs = list(synthetic_stream(
            CHAOS_REQUESTS, shapes=DEFAULT_SHAPES, zipf_a=1.1, rank=8,
            tenants=4, tenant_fraction=0.25, seed=CHAOS_SEED))
        poisoned = 0
        for r in reqs:
            if poisoned < CHAOS_POISONED and r.tenant is None \
                    and r.kind == "factorize":
                r.A = np.array(r.A, copy=True)
                r.A[0, 0] = np.nan
                poisoned += 1
        srv = SolveServer(spec, device=DEV, max_batch=8, window_ms=2.0,
                          max_queue=4 * CHAOS_REQUESTS + 16,
                          generator=torch.Generator().manual_seed(4321),
                          hang_timeout_s=1.0, breaker_threshold=5,
                          breaker_reset_s=1.0, max_retries=2,
                          retry_backoff_ms=5.0)
        degraded = []

        def collect(req, outcome, detail):
            if outcome == "ok" and req.tenant is None \
                    and detail.meta.get("degraded"):
                s_true = np.linalg.svd(req.A.astype(np.float64),
                                       compute_uv=False)
                s = detail.value.s.double().numpy()
                degraded.append(float(np.max(np.abs(
                    s - s_true[:s.shape[0]])) / s_true[0]))

        try:
            srv.warmup(DEFAULT_SHAPES)
            with faults.chaos(seed, dispatch_crash_p=mix["crash"],
                              dispatch_hang_p=mix["hang"], hang_s=2.5,
                              solve_transient_p=mix["transient"]):
                counts = run_traffic(srv, reqs, clients=4,
                                     timeout=CHAOS_DEADLINE_MS / 1e3,
                                     deadline_ms=CHAOS_DEADLINE_MS,
                                     on_result=collect)
            faults.disarm_all()
            stats = srv.stats()
        finally:
            faults.disarm_all()
            srv.close()
        outcomes = (counts["ok"] + counts["rejected"] + counts["failed"]
                    + counts["timeouts"])
        quarantined = counts["errors"].get("PoisonedOperand", 0)
        eligible = max(CHAOS_REQUESTS - quarantined - counts["rejected"], 1)
        row = dict(mix=label, **mix, ok=counts["ok"],
                   degraded=counts["degraded"], failed=counts["failed"],
                   errors=counts["errors"], timeouts=counts["timeouts"],
                   rejected=counts["rejected"], quarantined=quarantined,
                   availability=counts["ok"] / eligible,
                   all_terminated=outcomes == CHAOS_REQUESTS,
                   degraded_err_max=max(degraded, default=0.0),
                   wall_s=counts["wall_s"],
                   p50_ms=stats["latency_ms"]["p50_ms"],
                   p99_ms=stats["latency_ms"]["p99_ms"],
                   worker_restarts=stats["worker_restarts"],
                   worker_crashes=stats["worker_crashes"],
                   retries=stats["retries"],
                   deadline_drops=stats["deadline_drops"],
                   breaker_open_shed=stats["breaker_open_shed"])
        print(f"phase 11 (c): chaos {label}: {row}", flush=True)
        check(row["all_terminated"], f"phase 11 (c) {label}: not drained")
        check(row["availability"] >= CHAOS_AVAILABILITY,
              f"phase 11 (c) {label}: availability {row['availability']}")
        check(quarantined == poisoned,
              f"phase 11 (c) {label}: quarantined {quarantined} of "
              f"{poisoned}")
        check(row["degraded_err_max"] <= DEGRADED_BOUND,
              f"phase 11 (c) {label}: degraded sigma "
              f"{row['degraded_err_max']}")
        chaos.append(row)
    rec["chaos"] = chaos
    return rec


def phase_serve(seed):
    """Phase 11: the solve server on the card; see the module docstring.
    Returns the {"serve": ...} record; each replay resets the launch
    counters just before it and reads them just after."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = {"cli": serve_cli(seed)}
    rec["wide"] = wide_replay(seed)
    rec.update(degraded_and_chaos(seed))
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = {k: rec["wide"]["launches"][k]
                       + rec["wide"]["entries"]["launches"][k]
                       + rec["degraded"]["launches"].get(k, 0)
                       for k in SERVE_KERNELS}
    print(f"phase 11: {rec['wall_s']:.1f} s; launches of this slice's "
          f"kernels over replays (b), its entries replay and (c)'s "
          f"degraded answer {rec['launches']}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# --- phase 12: the distributed layer, two ranks on one card ---------------

DIST_WORLD = 2                # ranks; one card, so both share cuda:0
DIST_TIMEOUT_S = 900.0        # a collective waits at most this for a rank
COMPRESS_SHAPE = (4096, 14336)     # one MLP block's gradient
COMPRESS_RANK, COMPRESS_K = 8, 12
COMPRESS_NOISE = 1e-3         # each worker's own part of its gradient
LOCAL_KERNELS = ("local_mv_qtv", "local_rmv_qtv")
LOCAL_REPLACES = {"local_mv_qtv": "src/repro/kernels/ops.py:131",
                  "local_rmv_qtv": "src/repro/kernels/ops.py:154"}
# kernels of gk_step.cu in a profile (stage 1's rows / A^T q kernels and
# the projection kernel rmv_qtv's P^T v runs)
GK_KERNEL_NAMES = r"rows_kernel|rmv_partial_kernel|rmv_finish_kernel|proj_"


def sigma_list(s):
    return [float(x) for x in s.float().cpu()]


def dist_solve(fn, profile=False):
    """Run ``fn`` once with the collective stats and the stage-1 counts set
    to 0 just before it and read just after: (result, record).  With
    ``profile`` the device time under torch.profiler is split into the
    gk_step kernels' and the rest."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import sparse_matvec as spm
    dist.barrier()
    gs.reset_launches()
    spm.reset_launches()
    reset_collectives()
    if profile and DEV == "cuda":
        from torch.autograd import DeviceType
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            out, wall = timed(fn)
        dev = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
        gk = sum(e.time_range.elapsed_us() for e in dev
                 if re.search(GK_KERNEL_NAMES, e.name)) / 1e3
        total = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        prof_rec = dict(kernel_device_ms=gk,
                        other_device_ms=total - gk)
    else:
        out, wall = timed(fn)
        prof_rec = {}
    stats = collective_stats()
    # a rank's process runs only the sharded seam's stage-1 launches
    rec = dict(wall_s=wall,
               launches={name: gs.LAUNCHES[name[len("local_"):]]
                         for name in LOCAL_KERNELS},
               sparse_matvec=spm.LAUNCHES["sparse_matvec"],
               collectives=stats["calls"],
               collective_s=stats["seconds"],
               floats_sent=stats["floats_sent"],
               floats_received=stats["floats_received"], **prof_rec)
    return out, rec


def local_kernel_checks(block, seed, rank):
    """Each stage-1 kernel on this rank's block against its plain version
    (bases of the main path's widths, f32): max |kernel - plain|."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    m, n = block.shape
    g = torch.Generator(device=DEV).manual_seed(seed + 40 + rank)
    p = torch.randn(n, generator=g, device=DEV)
    q = torch.randn(m, generator=g, device=DEV)
    ym = torch.randn(m, generator=g, device=DEV)
    yn = torch.randn(n, generator=g, device=DEV)
    Q = torch.linalg.qr(torch.randn(m, MAX_ITERS + 1, generator=g,
                                    device=DEV))[0].contiguous()
    P = torch.linalg.qr(torch.randn(n, MAX_ITERS, generator=g,
                                    device=DEV))[0].contiguous()
    alpha = torch.tensor([0.37], device=DEV)
    beta = torch.tensor([1.7], device=DEV)
    errs = {}
    for name, kern, plain in [
            ("local_mv_qtv", lambda: kops.local_mv_qtv(block, p, ym, alpha, Q),
             lambda: ref.mv_qtv(block, p, ym, alpha, Q)),
            ("local_rmv_qtv",
             lambda: kops.local_rmv_qtv(block, q, yn, beta, P),
             lambda: ref.rmv_qtv(block, q, yn, beta, P))]:
        errs[name] = compare(name, kern(), plain(), (torch.float32,
                                                      torch.float32))
        a, b = kern(), kern()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{name} differs bitwise from call to call")
    return errs, (p, q, ym, yn, Q, P, alpha, beta)


def local_kernel_times(block, inputs):
    """Rank 0 times both stage-1 kernels at its shard shape by device time
    (graph_ms), beside the plain version and torch.addmv + torch.mv(Q^T u),
    and the bound: bytes read once at 3.35 TB/s or f32 operations."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    p, q, ym, yn, Q, P, alpha, beta = inputs
    m, n = block.shape
    kq, kp = Q.shape[1], P.shape[1]
    f = 4

    def lib_mv():
        u = torch.addmv(ym, block, p, beta=-0.37)
        return u, torch.mv(Q.T, u)

    def lib_rmv():
        v = torch.addmv(yn, block.T, q, beta=-1.7)
        return v, torch.mv(P.T, v)

    rows = {
        "local_mv_qtv": (lambda: kops.local_mv_qtv(block, p, ym, alpha, Q),
                         lambda: ref.mv_qtv(block, p, ym, alpha, Q), lib_mv,
                         f * (m * n + n + m + m * kq + 1 + m + kq),
                         2 * m * n + 2 * m + 2 * m * kq, kq),
        "local_rmv_qtv": (lambda: kops.local_rmv_qtv(block, q, yn, beta, P),
                          lambda: ref.rmv_qtv(block, q, yn, beta, P),
                          lib_rmv, f * (m * n + m + n + n * kp + n + kp),
                          2 * m * n + 2 * n + 2 * n * kp, kp),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops, k) in rows.items():
        out[name] = time_row(name, kern, plain, lib, nbytes, flops,
                             f"({m}x{n} shard, k={k}, f32)", phase=12,
                             graph=MAIN_GRAPH)
    return out


def dist_dense(rank, world, seed, m, n):
    """(a) the 1e5 x 8e4 f32 operand A = M N over mesh (world,) ("data",),
    backend "pallas": each rank makes its own m/world rows from the
    shared seed and no rank holds the whole operand."""
    import torch
    from repro_torch.api import SVDSpec, estimate_rank, factorize
    from repro_torch.distributed.matvec import ShardedOp
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), device_type=DEV)
    check(m % world == 0, f"{m} rows do not split over {world} ranks")
    rows = m // world
    M, N = operand_factors(seed, m, n)
    s_true = factored_sigma(M, N.T)
    block = (M[rank * rows:(rank + 1) * rows] @ N).contiguous()
    del M, N
    _sync()
    smax = float(s_true[0])
    op = ShardedOp(block, mesh, lshape=(m, n), backend="pallas")
    spec = SVDSpec(method="fsvd_sharded", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")

    def gen():
        return torch.Generator(device=DEV).manual_seed(seed)

    rec = {}
    k = MAX_ITERS
    f1, rec["fsvd"] = dist_solve(lambda: factorize(
        op, spec, generator=gen()))
    f2, rec["fsvd_rerun"] = dist_solve(lambda: factorize(
        op, spec, generator=gen()), profile=True)
    err = float((f1.s.double() - s_true[:R_WANT]).abs().max()) / smax
    rec["fsvd"].update(sigma=sigma_list(f1.s), sigma_err=err,
                       iterations=int(f1.iterations))
    check(err < FSVD_STOL, f"phase 12 (a) fsvd_sharded sigma error {err}")
    check(torch.equal(f1.s, f2.s), "phase 12 (a): sigma differs bitwise on "
                                   "a rerun")
    # the kernels launch on CUDA tensors only (a CPU rehearsal counts 0)
    want = {"local_mv_qtv": k, "local_rmv_qtv": k - 1} if DEV == "cuda" \
        else {"local_mv_qtv": 0, "local_rmv_qtv": 0}
    for key in ("fsvd", "fsvd_rerun"):
        check(rec[key]["launches"] == want,
              f"phase 12 (a) {key} launches {rec[key]['launches']} != {want}")
        # 2k - 1 half-steps, one collective each, + A^T q1 and A V
        check(rec[key]["collectives"] == 2 * k + 1,
              f"phase 12 (a) {key}: {rec[key]['collectives']} collectives, "
              f"not {2 * k + 1}")
    est, rec["estimate_rank"] = dist_solve(lambda:
                                           estimate_rank(
        op, SVDSpec(max_iters=RANK_ITERS, backend="pallas"),
        generator=gen()))
    rec["estimate_rank"]["rank"] = int(est.rank)
    check(int(est.rank) == RANK, f"phase 12 (a) rank {int(est.rank)}")
    for method, fields, bound in SKETCH_SOLVES:
        if method not in ("fsvd_blocked", "rbk"):
            continue
        fact, r = dist_solve(lambda: factorize(
            op, SVDSpec(method=method, rank=R_WANT, backend="pallas",
                        **fields), generator=gen()))
        e = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
        r.update(sigma=sigma_list(fact.s), sigma_err=e, bound=bound)
        check(e < bound, f"phase 12 (a) {method} sigma error {e}")
        rec[method] = r
    errs, inputs = local_kernel_checks(block, seed, rank)
    rec["kernel_errs"] = errs
    rec["shard"] = list(block.shape)
    if rank == 0 and DEV == "cuda":
        rec["times"] = local_kernel_times(block, inputs)
    del inputs, op, block
    import torch.distributed as dist
    dist.barrier()                 # the other rank waits out the timing
    return rec


def dist_model(rank, world, seed, m, n):
    """(b) mesh (1, world) ("data", "model") at phase 5's width in f32:
    each rank holds n/world columns; two collectives a half-step."""
    import torch
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.distributed.matvec import ShardedOp
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, world), ("data", "model"), device_type=DEV)
    check(n % world == 0, f"{n} columns do not split over {world} ranks")
    cols = n // world
    M, N = operand_factors(seed + 12, m, n)
    s_true = factored_sigma(M, N.T)
    block = (M @ N[:, rank * cols:(rank + 1) * cols]).contiguous()
    del M, N
    op = ShardedOp(block, mesh, lshape=(m, n), backend="pallas")
    spec = SVDSpec(method="fsvd_sharded", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")
    fact, rec = dist_solve(lambda: factorize(
        op, spec, generator=torch.Generator(device=DEV).manual_seed(seed)))
    k = MAX_ITERS
    err = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / float(
        s_true[0])
    rec.update(sigma=sigma_list(fact.s), sigma_err=err, shard=[m, cols])
    check(err < FSVD_STOL, f"phase 12 (b) sigma error {err}")
    # two per half-step, + A^T q1, the gather of V over "model" and A V
    check(rec["collectives"] == 2 * (2 * k - 1) + 3,
          f"phase 12 (b): {rec['collectives']} collectives, not "
          f"{2 * (2 * k - 1) + 3}")
    check(not any(rec["launches"].values()),
          f"phase 12 (b): a 'model' axis took the stage-1 kernels "
          f"{rec['launches']}")
    return rec


def dist_sparse(rank, world, seed, m, n):
    """(c) the sparse cell over mesh (world,) ("data",): each rank packs
    its rows from the shared COO triplets; the local packs go through
    sparse_matvec."""
    import torch
    from repro_torch.api import SVDSpec, estimate_rank, factorize
    from repro_torch.core.operators import SparseOp
    from repro_torch.distributed.matvec import sharded_operator
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), device_type=DEV)
    data, idx, s_true = netflix_operand(seed, m, n)
    nnz = int(data.shape[0])
    op, t_pack = timed(lambda: sharded_operator(
        SparseOp.from_coo(data, idx, (m, n)), mesh, backend="pallas"))
    del data, idx
    smax = float(s_true[0])

    def gen():
        return torch.Generator(device=DEV).manual_seed(seed)

    rec = dict(nnz=nnz, pack_s=t_pack,
               packs=[list(op.A.mv_vals.shape), list(op.A.rmv_vals.shape)])
    fact, rec["fsvd"] = dist_solve(lambda: factorize(
        op, SVDSpec(method="fsvd_sharded", rank=R_WANT, max_iters=MAX_ITERS),
        generator=gen()))
    err = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
    rec["fsvd"].update(sigma=sigma_list(fact.s), sigma_err=err)
    check(err < SPARSE_STOL, f"phase 12 (c) sparse sigma error {err}")
    est, rec["estimate_rank"] = dist_solve(lambda:
                                           estimate_rank(
        op, SVDSpec(max_iters=RANK_ITERS), generator=gen()))
    rec["estimate_rank"]["rank"] = int(est.rank)
    check(int(est.rank) == RANK, f"phase 12 (c) rank {int(est.rank)}")
    if DEV == "cuda":
        check(rec["fsvd"]["sparse_matvec"] > 0,
              "phase 12 (c): the local packs took no sparse_matvec launch")
    # the local packs through the kernel against its plain version
    g = torch.Generator(device=DEV).manual_seed(seed + 41 + rank)
    a = op.A
    errs = []
    for vals, cols, nx in [(a.mv_vals, a.mv_cols, n),
                           (a.rmv_vals, a.rmv_rows, a.mv_vals.shape[0])]:
        x = torch.randn(nx, generator=g, device=DEV)
        got, want = kops.sparse_matvec(vals, cols, x), ref.sparse_matvec(
            vals, cols, x)
        errs.append(float((got - want).abs().max()
                          / want.abs().max().clamp_min(1e-30)))
    rec["pack_rel_err"] = errs
    check(max(errs) < 1e-5, f"phase 12 (c): local packs {errs}")
    return rec


def dist_compress(rank, world, seed, shape):
    """(d) compress_mean over the ranks' (m, n) gradients: a shared
    rank-COMPRESS_RANK part plus each worker's own noise, k = COMPRESS_K
    Lanczos iterations; sigma against the exact mean's SVD."""
    import torch
    from repro_torch.core.gk import start_vector
    from repro_torch.distributed.compression import compress_mean
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), device_type=DEV)
    m, n = shape
    g = torch.Generator(device=DEV).manual_seed(seed + 30)
    low = torch.randn(m, COMPRESS_RANK, generator=g, device=DEV) @ \
        torch.randn(COMPRESS_RANK, n, generator=g, device=DEV)

    def noise(r):
        gr = torch.Generator(device=DEV).manual_seed(seed + 31 + r)
        return COMPRESS_NOISE * torch.randn(m, n, generator=gr, device=DEV)

    G = low + noise(rank)
    mean = low.double() + sum(noise(r).double() for r in range(world)) / world
    s_exact = torch.linalg.svdvals(mean)[:COMPRESS_RANK]
    del mean, low
    q1 = start_vector(torch.Generator(device=DEV).manual_seed(seed + 32), m,
                      device=DEV)
    (U, s, V), rec = dist_solve(lambda: compress_mean(
        G, "data", COMPRESS_RANK, COMPRESS_K, mesh=mesh, q1=q1))
    err = float((s.double() - s_exact).abs().max() / s_exact[0])
    r, k = COMPRESS_RANK, COMPRESS_K
    rec.update(sigma=sigma_list(s), sigma_err=err, shape=[m, n],
               floats_dense=m * n, floats_compressed=k * (m + n) + r * m,
               ratio=(k * (m + n) + r * m) / (m * n))
    check(err < FSVD_STOL, f"phase 12 (d) compressed sigma error {err}")
    return rec


def dist_rank(rank, world, dev, seed, dims, out_dir):
    """One rank of phase 12: (a) to (d) in turn; writes rank<r>.json."""
    import torch
    global DEV
    DEV = dev
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import sparse_matvec as spm
        kops.load_dense_libraries()     # built by the parent: loads only
        spm._lib()
    m, n, m64, n64, sm, sn, cshape = dims
    t0 = time.perf_counter()
    rec = dict(rank=rank, dense=dist_dense(rank, world, seed, m, n))
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    rec["model"] = dist_model(rank, world, seed, m64, n64)
    rec["sparse"] = dist_sparse(rank, world, seed, sm, sn)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    rec["compress"] = dist_compress(rank, world, seed, cshape)
    rec["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def phase_distributed(seed, dims, walls3):
    """Phase 12: the distributed layer on the card; see the module
    docstring.  Returns the kernels line's rows of the two local stage-1
    launches and the {"distributed": ...} record."""
    import shutil

    import torch
    from repro_torch.launch.mesh import run_world
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, "build", "phase12")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    run_world(dist_rank, DIST_WORLD, os.path.join(out_dir, "rendezvous"),
              (DEV, seed, dims, out_dir), timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(DIST_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
    # every rank holds the same global answer, bit for bit
    for part, key in [("dense", "fsvd"), ("dense", "fsvd_blocked"),
                      ("dense", "rbk"), ("model", None), ("sparse", "fsvd"),
                      ("compress", None)]:
        sig = [(rec[part][key] if key else rec[part])["sigma"]
               for rec in recs]
        check(all(s == sig[0] for s in sig),
              f"phase 12 {part} {key}: sigma differs between ranks")
    dense = [rec["dense"] for rec in recs]
    for r, d in enumerate(dense):
        f, p = d["fsvd"], d["fsvd_rerun"]
        print(f"phase 12 (a) rank {r}: fsvd_sharded on its {d['shard']} "
              f"shard: wall {f['wall_s']:.3f} s (phase 3 single card "
              f"{walls3[0]:.3f} / {walls3[1]:.3f} s), collectives "
              f"{f['collectives']} ({f['collective_s']:.3f} s host), "
              f"launches {f['launches']}, sigma error {f['sigma_err']:.3e}; "
              f"rerun under the profiler: wall {p['wall_s']:.3f} s, gk_step "
              f"kernels {p.get('kernel_device_ms', 0.0):.1f} ms device, "
              f"other device work {p.get('other_device_ms', 0.0):.1f} ms, "
              f"collectives {p['collective_s']:.3f} s; estimate_rank "
              f"{d['estimate_rank']['rank']} in "
              f"{d['estimate_rank']['wall_s']:.3f} s; fsvd_blocked "
              f"{d['fsvd_blocked']['sigma_err']:.3e} in "
              f"{d['fsvd_blocked']['wall_s']:.3f} s, collectives "
              f"{d['fsvd_blocked']['collectives']} "
              f"({d['fsvd_blocked']['collective_s']:.3f} s, floats sent "
              f"{d['fsvd_blocked']['floats_sent']}, received "
              f"{d['fsvd_blocked']['floats_received']}); rbk "
              f"{d['rbk']['sigma_err']:.3e} in {d['rbk']['wall_s']:.3f} s; "
              f"kernel vs plain {d['kernel_errs']}", flush=True)
    for r, rec in enumerate(recs):
        b, c, q = rec["model"], rec["sparse"], rec["compress"]
        print(f"phase 12 (b) rank {r}: ('data', 'model') 1 x "
              f"{DIST_WORLD}, shard {b['shard']}: wall {b['wall_s']:.3f} s, "
              f"collectives {b['collectives']} ({b['collective_s']:.3f} s), "
              f"sigma error {b['sigma_err']:.3e}", flush=True)
        print(f"phase 12 (c) rank {r}: sparse nnz {c['nnz']}, packs "
              f"{c['packs']} built in {c['pack_s']:.3f} s; fsvd_sharded wall "
              f"{c['fsvd']['wall_s']:.3f} s, sigma error "
              f"{c['fsvd']['sigma_err']:.3e}, sparse_matvec launches "
              f"{c['fsvd']['sparse_matvec']}, collectives "
              f"{c['fsvd']['collectives']}; estimate_rank "
              f"{c['estimate_rank']['rank']} in "
              f"{c['estimate_rank']['wall_s']:.3f} s; packs vs plain "
              f"{c['pack_rel_err']}", flush=True)
        print(f"phase 12 (d) rank {r}: compress_mean {q['shape']} rank "
              f"{COMPRESS_RANK} k {COMPRESS_K}: sigma error "
              f"{q['sigma_err']:.3e}, payload k(m+n)+rm "
              f"{q['floats_compressed']} vs mn {q['floats_dense']} "
              f"({100 * q['ratio']:.2f} %); measured floats sent "
              f"{q['floats_sent']}, received {q['floats_received']} "
              f"({DIST_WORLD} x sent); wall {q['wall_s']:.3f} s, "
              f"collectives {q['collectives']}",
              flush=True)
    print(f"phase 12: {DIST_WORLD} ranks on one card in {wall:.1f} s",
          flush=True)
    rows = {}
    times = dense[0].get("times", {})
    for name in LOCAL_KERNELS:
        per_rank = []
        for rec in recs:
            n_part = sum(rec["dense"][key]["launches"][name] for key in
                         ("fsvd", "fsvd_rerun", "estimate_rank",
                          "fsvd_blocked", "rbk"))
            n_part += rec["model"]["launches"][name]
            n_part += sum(rec["sparse"][key]["launches"][name]
                          for key in ("fsvd", "estimate_rank"))
            n_part += rec["compress"]["launches"][name]
            per_rank.append(n_part)
        t = times.get(name, {})
        rows[name] = dict(
            name=name, route="cuda", source="src/repro_torch/csrc/gk_step.cu",
            replaces=LOCAL_REPLACES[name], launches=sum(per_rank),
            max_abs_err=max(d["kernel_errs"][name] for d in dense),
            ms=t.get("ms"), plain_ms=t.get("plain_ms"),
            bound_ms=t.get("bound_ms"), bound_by=t.get("bound_by"),
            library_ms=t.get("library_ms"),
            host_loop_ms=t.get("host_loop_ms"),
            shape=f"{dense[0]['shard'][0]}x{dense[0]['shard'][1]} shard f32",
            launches_per_rank=per_rank,
            launches_per_solve=dense[0]["fsvd"]["launches"][name])
    return rows, dict(wall_s=wall, ranks=recs)


# --- phase 13: the LM stack ----------------------------------------------

LM_ARCH = "stablelm-1.6b"
LM_BATCH = 2                  # SHAPES["train_4k"]'s global batch 256, cut
LM_STEPS = 3                  # AdamW steps at the full width and depth
LM_DECODE = 16                # decode steps on the padded cache
LM_CONSISTENCY = 2e-2         # tests/test_models_smoke.py:87
LM_LOSS_RTOL = 1e-5           # card vs CPU loss, same parameters and batch
LM_SUMMARY_K = 8              # tests/test_telemetry.py:50-63
LM_SUMMARY_LEAVES = 4
MOE_ARCH = "olmoe-1b-7b"
MOE_LAYERS = 2                # of 16
MOE_CHECK_SEQ = 512           # capacity 100 holds (E, 100 T k / E, D) slots
BF16_PEAK = 989e12            # H100 SXM dense bf16 tensor-core FLOP/s
SMALL_B, SMALL_S = 2, 32      # tests/test_models_smoke.py's batch


def lm_spec(cfg, B, S):
    from repro_torch.data.synthetic import LMBatchSpec
    img = cfg.vlm.num_image_tokens if cfg.vlm is not None else 0
    frames = S if cfg.encdec is not None else 0
    return LMBatchSpec(B, S, cfg.vocab_size, img, frames, cfg.d_model)


def lm_consistency(model, cfg, seed, tag, B, S, n_decode=1):
    """Prefill S tokens, decode the next ``n_decode`` on the padded cache,
    and hold the last decode's logits against a prefill of all S +
    n_decode tokens: max |difference| / max |logit|.  MoE configs run at
    capacity factor 100, as tests/test_models_smoke.py:58-87 does.
    Returns the error and the prefill's and a decode step's ms, by CUDA
    events and by the host clock."""
    import dataclasses
    import torch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import (build_decode_step,
                                           build_prefill_step)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=100.0))
    full = lm_batch(lm_spec(cfg, B, S + n_decode), seed, 10_000, device=DEV)
    full.pop("labels")
    part = dict(full, tokens=full["tokens"][:, :S])
    img = cfg.vlm.num_image_tokens if cfg.vlm is not None else 0
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    _, cache = prefill(model, part)
    mid.record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = M.pad_cache_to(cache, cfg, S + n_decode + img)
    for j in range(n_decode):
        pos = torch.full((B, 1), S + j + img, dtype=torch.int32, device=DEV)
        logits, cache = decode(model, cache, {
            "tokens": full["tokens"][:, S + j:S + j + 1], "positions": pos})
    end.record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del cache
    want, _ = prefill(model, full)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), f"phase 13 {tag}: decode "
          "logits not finite")
    err = float((logits - want).abs().max() / want.abs().max())
    check(err < LM_CONSISTENCY, f"phase 13 {tag}: prefill -> decode "
          f"{err:.3e} >= {LM_CONSISTENCY}")
    return dict(consistency=err, prefill_ms=start.elapsed_time(mid),
                prefill_wall_ms=(t1 - t0) * 1e3,
                decode_ms=mid.elapsed_time(end) / n_decode,
                decode_wall_ms=(t2 - t1) * 1e3 / n_decode)


def lm_train(model, cfg, opt_cfg, batches, keep=None):
    """``build_train_step`` over ``batches``: each step's wall and
    CUDA-event ms, loss, grad norm and skip flag; the gradients of step
    ``keep`` (an index into ``batches``), or None."""
    import torch
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.steps import TrainState, build_train_step
    init, _ = make_optimizer(opt_cfg)
    state = TrainState(model, init(dict(model.named_parameters())))
    step = build_train_step(cfg, opt_cfg)
    kept = build_train_step(cfg, opt_cfg, keep_grads=True)
    steps, grads = [], None
    for i, batch in enumerate(batches):
        fn = kept if i == keep else step
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        state, met = fn(state, batch)
        ev1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        steps.append(dict(wall_ms=wall, event_ms=ev0.elapsed_time(ev1),
                          loss=float(met["loss"]),
                          grad_norm=float(met["grad_norm"]),
                          skipped=int(met["skipped"])))
        if i == keep:
            grads = met["grads"]
    for i, s in enumerate(steps):
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              and s["skipped"] == 0, f"phase 13 {cfg.name} step {i}: {s}")
    return steps, grads


LM_KERNEL_KINDS = (("matrix products", r"gemm|nvjet|cutlass|xmma"),
                   ("softmax", r"softmax"),
                   ("copies and fills", r"^Memcpy|^Memset|copy|fill"))


def lm_profile(model, cfg, batch):
    """One AdamW step (fresh moments) under torch.profiler: the device
    time of its kernels by kind and the ten costliest kernels, beside the
    step's wall."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.configs import OptimConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.steps import TrainState, build_train_step
    opt = OptimConfig()
    state = TrainState(model, make_optimizer(opt)[0](
        dict(model.named_parameters())))
    step = build_train_step(cfg, opt)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del state
    kinds, names = {}, {}
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kind = next((k for k, pat in LM_KERNEL_KINDS
                     if re.search(pat, e.name, re.I)),
                    "elementwise and reductions")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + ms
    device_ms = sum(kinds.values())
    check(device_ms > 0, "phase 13 (b): the profiler saw no device time")
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                host_share=1 - device_ms / wall_ms, by_kind=kinds,
                kernels=sum(1 for e in prof.events() if getattr(
                    e, "device_type", None) == DeviceType.CUDA),
                top=top)


def lm_reduced(seed):
    """(a) every architecture's reduced config on the card."""
    import copy
    import torch
    from repro_torch.configs import ARCHS, OptimConfig, get_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import model as M
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=0)
    out = {}
    for i, arch in enumerate(sorted(ARCHS)):
        cfg = get_arch(arch).reduced()
        model, _ = M.init_model(
            cfg, torch.Generator(device=DEV).manual_seed(seed + 100 + i))
        batch = lm_batch(lm_spec(cfg, SMALL_B, SMALL_S), seed, i, device=DEV)
        cpu = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            cpu_loss = float(M.loss_fn(
                cpu, {k: v.cpu() for k, v in batch.items()}, cfg)[0])
        del cpu
        before = [p.detach().clone() for p in model.parameters()]
        steps, _ = lm_train(model, cfg, opt_cfg, [batch])
        moved = max(float((p.detach() - b).abs().max())
                    for p, b in zip(model.parameters(), before))
        rel = abs(steps[0]["loss"] - cpu_loss) / abs(cpu_loss)
        check(rel < LM_LOSS_RTOL, f"phase 13 (a) {arch}: card loss "
              f"{steps[0]['loss']} vs CPU {cpu_loss} ({rel:.2e})")
        check(moved > 0, f"phase 13 (a) {arch}: the step moved no parameter")
        err = lm_consistency(model, cfg, seed, f"(a) {arch}", SMALL_B,
                             SMALL_S)["consistency"]
        out[arch] = dict(loss=steps[0]["loss"], cpu_loss=cpu_loss,
                         loss_rel=rel, grad_norm=steps[0]["grad_norm"],
                         max_param_move=moved, consistency=err,
                         step_ms=steps[0]["wall_ms"])
        print(f"phase 13 (a) {arch}: loss {steps[0]['loss']:.6f} (CPU "
              f"{cpu_loss:.6f}, rel {rel:.1e}), grad norm "
              f"{steps[0]['grad_norm']:.4f}, prefill -> decode {err:.2e}",
              flush=True)
        del model, before
    return out


def lm_full(seed):
    """(b) stablelm-1.6b at its published width and depth."""
    import torch
    from repro_torch.configs import OptimConfig, get_arch, get_shape
    from repro_torch.data.synthetic import lm_batch, spec_for
    from repro_torch.models import model as M
    from repro_torch.runtime.telemetry import gradient_rank_summary
    cfg = get_arch(LM_ARCH)
    shape = get_shape("train_4k")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = M.init_model(cfg, torch.Generator(device=DEV).manual_seed(
        seed + 13))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    spec = spec_for(cfg, shape, batch_override=LM_BATCH)
    batches = [lm_batch(spec, seed, s, device=DEV) for s in range(LM_STEPS)]
    steps, grads = lm_train(model, cfg, OptimConfig(), batches,
                            keep=len(batches) - 1)
    train_peak = torch.cuda.max_memory_allocated()
    del batches
    summary = gradient_rank_summary(grads, k=LM_SUMMARY_K,
                                    max_leaves=LM_SUMMARY_LEAVES)
    check(len(summary) == LM_SUMMARY_LEAVES, f"phase 13 (b): "
          f"{len(summary)} summary leaves")
    spectra = {}
    for name, s in summary.items():
        sig = s["sigma"].float().cpu()
        rank = int(s["rank"])
        check(bool(torch.isfinite(sig).all()) and 0 <= rank <= LM_SUMMARY_K,
              f"phase 13 (b): gradient summary {name}: {sig} rank {rank}")
        spectra[name] = dict(sigma=sig.tolist(), rank=rank,
                             energy_r=float(s["energy_r"]))
    del grads, summary
    gc.collect()
    torch.cuda.empty_cache()
    profile = lm_profile(model, cfg, lm_batch(spec, seed, LM_STEPS,
                                              device=DEV))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve = lm_consistency(model, cfg, seed, "(b)", LM_BATCH, spec.seq_len,
                           LM_DECODE)
    serve_peak = torch.cuda.max_memory_allocated()
    tokens = LM_BATCH * spec.seq_len
    timed_steps = steps[1:]
    step_ms = sum(s["wall_ms"] for s in timed_steps) / len(timed_steps)
    event_ms = sum(s["event_ms"] for s in timed_steps) / len(timed_steps)
    flops = 6 * n_params * tokens
    rec = dict(
        arch=LM_ARCH, params=n_params, dtype=cfg.dtype, layers=cfg.num_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, batch=LM_BATCH,
        seq=spec.seq_len, init_s=init_s, steps=steps,
        step_ms=step_ms, step_event_ms=event_ms,
        tokens_per_s=tokens / (step_ms / 1e3),
        model_flop_share=flops / (step_ms / 1e3) / BF16_PEAK,
        flop_formula="6 * params * tokens / step_s / 989e12 (H100 SXM "
                     "dense bf16)",
        train_peak_gib=train_peak / GIB, decode_tokens=LM_DECODE,
        serve_peak_gib=serve_peak / GIB, **serve, gradient_summary=spectra,
        profile=profile)
    print(f"phase 13 (b) {LM_ARCH}: {n_params:,} params ({cfg.dtype}), "
          f"init {init_s:.2f} s; steps wall "
          f"{[round(s['wall_ms'], 1) for s in steps]} ms, events "
          f"{[round(s['event_ms'], 1) for s in steps]} ms, losses "
          f"{[round(s['loss'], 4) for s in steps]}; {step_ms:.1f} ms a step "
          f"(steps 2-{LM_STEPS}), {rec['tokens_per_s']:.0f} tokens/s, "
          f"model-FLOP share {100 * rec['model_flop_share']:.2f} % of "
          f"989 TFLOP/s; train peak {rec['train_peak_gib']:.2f} GiB; prefill "
          f"{LM_BATCH} x {spec.seq_len} {serve['prefill_ms']:.1f} ms (wall "
          f"{serve['prefill_wall_ms']:.1f}), decode {serve['decode_ms']:.2f} "
          f"ms a token (wall {serve['decode_wall_ms']:.2f}), peak "
          f"{rec['serve_peak_gib']:.2f} GiB, prefill -> decode "
          f"{serve['consistency']:.2e}; "
          f"gradient ranks {[v['rank'] for v in spectra.values()]}",
          flush=True)
    print(f"phase 13 (b) profiled step: wall {profile['wall_ms']:.1f} ms, "
          f"device {profile['device_ms']:.1f} ms in {profile['kernels']} "
          f"kernels (host share {100 * profile['host_share']:.1f} %): "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(profile["by_kind"].items(),
                             key=lambda kv: -kv[1]))
          + "; top: " + "; ".join(f"{n} {v:.1f}" for n, v in
                                   profile["top"][:6]), flush=True)
    return rec


def moe_dispatch_spy(moe_mod, calls):
    """Wrap ``moe.dispatch`` to keep each call's kept-slot count."""
    real = moe_mod.dispatch

    def spy(gates, eidx, num_experts, C):
        tok, gate = real(gates, eidx, num_experts, C)
        calls.append(((tok < eidx.shape[0]).sum(), eidx.numel()))
        return tok, gate
    return real, spy


def lm_moe(seed):
    """(c) olmoe-1b-7b at its published width, depth cut."""
    import dataclasses
    import torch
    from repro_torch.configs import OptimConfig, get_arch, get_shape
    from repro_torch.data.synthetic import lm_batch, spec_for
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model, _ = M.init_model(cfg, torch.Generator(device=DEV).manual_seed(
        seed + 14))
    spec = spec_for(cfg, get_shape("train_4k"), batch_override=LM_BATCH)
    calls = []
    real, spy = moe_dispatch_spy(moe_mod, calls)
    moe_mod.dispatch = spy
    try:
        steps, _ = lm_train(model, cfg, OptimConfig(),
                            [lm_batch(spec, seed, t, device=DEV)
                             for t in range(SHARD_STEPS)])
    finally:
        moe_mod.dispatch = real
    # the forward pass's calls (the backward pass recomputes each layer)
    kept = sum(int(k) for k, _ in calls[:MOE_LAYERS])
    routed = sum(n for _, n in calls[:MOE_LAYERS])
    peak = torch.cuda.max_memory_allocated()
    serve = lm_consistency(model, cfg, seed, "(c)", LM_BATCH, MOE_CHECK_SEQ)
    rec = dict(arch=MOE_ARCH, layers=MOE_LAYERS,
               experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
               d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
               params=sum(p.numel() for p in model.parameters()),
               batch=LM_BATCH, seq=spec.seq_len, step=steps[0],
               next_step=steps[1],
               capacity=moe_mod.capacity(cfg.moe, LM_BATCH * spec.seq_len),
               dropped_share=1 - kept / routed, peak_gib=peak / GIB,
               consistency_seq=MOE_CHECK_SEQ, **serve)
    print(f"phase 13 (c) {MOE_ARCH} ({MOE_LAYERS} of 16 layers, "
          f"{rec['params']:,} params): step {steps[0]['wall_ms']:.1f} ms "
          f"(events {steps[0]['event_ms']:.1f}), loss "
          f"{steps[0]['loss']:.4f}; capacity {rec['capacity']} a expert "
          f"drops {100 * rec['dropped_share']:.2f} % of {routed} routed "
          f"slots; peak {rec['peak_gib']:.2f} GiB; prefill -> decode "
          f"(capacity 100, {LM_BATCH} x {MOE_CHECK_SEQ}) "
          f"{serve['consistency']:.2e}",
          flush=True)
    return rec


def phase_lm(seed):
    """Phase 13: the LM stack on one card; see the module docstring.
    Returns the {"lm": ...} record."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    before = kernel_launches()
    t0 = time.perf_counter()
    rec = dict(reduced=lm_reduced(seed))
    rec["stablelm"] = lm_full(seed)
    gc.collect()
    torch.cuda.empty_cache()
    rec["olmoe"] = lm_moe(seed)
    launched = {k: v - before.get(k, 0) for k, v in kernel_launches().items()
                if v != before.get(k, 0)}
    check(not launched, f"phase 13 launched kernels: {launched}")
    rec["cuts"] = [
        f"{LM_ARCH}: global batch {256} -> {LM_BATCH} (SHAPES['train_4k'], "
        "seq 4096): full attention's f32 logits beside the weights",
        f"{MOE_ARCH}: num_layers 16 -> {MOE_LAYERS}; global batch 256 -> "
        f"{LM_BATCH}; its capacity-100 check at seq {MOE_CHECK_SEQ}",
        "random weights drawn on the card from --seed"]
    rec["wall_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13: {rec['wall_s']:.1f} s; none of the twelve kernels "
          "launched", flush=True)
    return rec


# --- phase 14: the Trainer, the sharded and compressed steps, the CLIs ------

TRAIN_LAYERS = 2              # of stablelm's 24 (and of olmoe's 16)
TRAIN_BATCH = 2               # x 4096 tokens, SHAPES["train_4k"] cut
TRAIN_STEPS = 6               # asked of the Trainer; SIGTERM drains it at 5
TRAIN_EVERY = 3               # checkpoint period
TRAIN_TERM_AFTER = 4          # os.kill(SIGTERM) once this step is done
TRAIN_KEEP = 2                # checkpoints kept (each ~6 GB at this width)
TSESSION_SHAPE = (8192, 4096)  # the Trainer's solver Session operand
TSESSION_RANK = 20
TSESSION_ITERS = 64
TSESSION_DRIFT = 1e-3
# (tag, ("data", "model") shape, without drops or aux loss): (2, 1) takes
# capacity and the aux loss by batch shard, so its gradients differ from
# the global batch's (12 % in the norm at this width); without drops or
# aux they are the sum of the shards' (see _no_drops)
SHARD_RUNS = (("1x2", (1, 2), False), ("2x1", (2, 1), False),
              ("2x1 no drops", (2, 1), True))
SHARD_STEPS = 2               # (phase 13 (c) takes as many on one card)
# the runs whose last step is held bit for bit to the whole-gather
# exchange (tests/torch_train_world.py's oracle): one a mesh; their peak
# is taken before it (the oracle keeps a copy of the gradients)
ORACLE_RUNS = ("1x2", "2x1")
SHARD_LOSS_RTOL = 1e-2        # the first loss vs phase 13 (c), every run
# the first loss, the first gradient norm and the second loss against the
# same config's single-card steps, where the sums are the same: bf16 adds
# in another order
SHARD_RTOL = {"1x2": 1e-3, "2x1 no drops": 1e-3}
COMP_STEPS = 2
COMP_SIGMA_TOL = 1e-2         # compressed mean's top r sigma, x sigma_max
COMP_LEAF = (2048, 5632)      # one MLP gradient (w_gate / w_up)
CLI_TIMEOUT_S = 300


def _no_drops(cfg):
    """``cfg`` with a capacity that drops no routed slot on any batch
    shard (C = T) and no aux loss."""
    import dataclasses
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k,
        aux_loss_weight=0.0))


def shard_reference(seed):
    """The single-card steps of (b)'s run without drops: olmoe-1b-7b cut
    as phase 13 (c), :func:`_no_drops`, the same seed and batches."""
    import dataclasses
    import torch
    from repro_torch.configs import OptimConfig, get_arch, get_shape
    from repro_torch.data.synthetic import lm_batch, spec_for
    from repro_torch.models import model as M
    cfg = _no_drops(dataclasses.replace(get_arch(MOE_ARCH),
                                        num_layers=MOE_LAYERS))
    model, _ = M.init_model(cfg, torch.Generator(device=DEV).manual_seed(
        seed + 14))
    spec = spec_for(cfg, get_shape("train_4k"), batch_override=LM_BATCH)
    steps, _ = lm_train(model, cfg, OptimConfig(),
                        [lm_batch(spec, seed, t, device=DEV)
                         for t in range(SHARD_STEPS)])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step=steps[0], next_step=steps[1])


def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def train_trainer(seed, out_dir):
    """(a) the Trainer on stablelm-1.6b at its published width, 2 layers:
    checkpoints, a real SIGTERM drain, a resume that restores every leaf
    and the solver Session bit for bit."""
    import dataclasses
    import signal

    import torch
    from repro_torch.api import SVDSpec, session
    from repro_torch.checkpoint import latest_step
    from repro_torch.checkpoint.store import _named_leaves
    from repro_torch.configs import (CheckpointConfig, OptimConfig,
                                     RunConfig, RuntimeConfig, ShapeConfig,
                                     get_arch, get_shape)
    from repro_torch.data.synthetic import lm_batch, spec_for
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.steps import (build_eval_step, build_train_step,
                                           init_state)
    from repro_torch.runtime.trainer import saved_state
    cfg = dataclasses.replace(get_arch(LM_ARCH), num_layers=TRAIN_LAYERS)
    opt = OptimConfig()
    spec = spec_for(cfg, get_shape("train_4k"), batch_override=TRAIN_BATCH)
    ckpt = os.path.join(out_dir, "ckpt")
    run = RunConfig(
        model=cfg, shape=ShapeConfig("phase14", "train", spec.seq_len,
                                     TRAIN_BATCH), optim=opt,
        checkpoint=CheckpointConfig(directory=ckpt, every_steps=TRAIN_EVERY,
                                    keep=TRAIN_KEEP, async_write=False),
        runtime=RuntimeConfig(log_every=0))

    def batch_fn(s):
        return lm_batch(spec, seed, s, device=DEV)

    def gen(k):
        return torch.Generator(device=DEV).manual_seed(seed + k)
    g = gen(60)
    m, n = TSESSION_SHAPE
    A = (torch.randn((m, TSESSION_RANK), generator=g, device=DEV)
         @ torch.randn((TSESSION_RANK, n), generator=g, device=DEV))
    sspec = SVDSpec(method="fsvd", rank=TSESSION_RANK,
                    max_iters=TSESSION_ITERS, backend="pallas")
    reset_kernel_launches()
    sess = session(A, sspec, generator=gen(61))
    sess.solve()
    solve_launches = {k: kernel_launches()[k] for k in GK_STEP}
    check(all(solve_launches[k] > 0 for k in GK_STEP),
          f"phase 14 (a): the Session's solve launched {solve_launches}")

    torch.cuda.reset_peak_memory_stats()
    step = build_train_step(cfg, opt)
    prev = signal.getsignal(signal.SIGTERM)
    step_s, save_s = [], []
    try:
        tr = Trainer(run, step, batch_fn, init_state(cfg, opt, gen(62)),
                     log_fn=lambda s: None, session=sess)
        real_save, real_step = tr._save, tr.train_step

        def timed_save():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_save()
            save_s.append(time.perf_counter() - t0)

        def step_then_term(st, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_step(st, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if tr.step == TRAIN_TERM_AFTER:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        tr._save, tr.train_step = timed_save, step_then_term
        hist = tr.run(TRAIN_STEPS)
    finally:
        signal.signal(signal.SIGTERM, prev)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses) and not any(
        h.get("skipped", 0) for h in hist), f"phase 14 (a): losses {losses}")
    check(tr._drain and tr.step == TRAIN_TERM_AFTER + 1,
          f"phase 14 (a): drained {tr._drain} at step {tr.step}")
    check(latest_step(ckpt) == tr.step, f"phase 14 (a): latest checkpoint "
          f"{latest_step(ckpt)}, trainer at {tr.step}")
    ckpt_bytes = _tree_bytes(os.path.join(ckpt, f"step_{tr.step}"))
    eval_step = build_eval_step(cfg)
    next_batch = batch_fn(tr.step)
    loss_a = eval_step(tr.state.model, next_batch)["loss"]

    sess2 = session(A, sspec, generator=gen(63))
    tr2 = Trainer(run, step, batch_fn, init_state(cfg, opt, gen(64)),
                  log_fn=lambda s: None, install_sigterm=False,
                  session=sess2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = tr2.maybe_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(resumed and tr2.step == tr.step, f"phase 14 (a): resumed "
          f"{resumed} at step {tr2.step}, saved {tr.step}")
    a = dict(_named_leaves(saved_state(tr.state)))
    b = dict(_named_leaves(saved_state(tr2.state)))
    check(sorted(a) == sorted(b), "phase 14 (a): restored leaf names differ")
    unequal = [k for k in a if a[k].dtype != b[k].dtype
               or b[k].device.type != DEV or not torch.equal(a[k], b[k])]
    check(not unequal, f"phase 14 (a): restored leaves differ: {unequal[:5]}")
    loss_b = eval_step(tr2.state.model, next_batch)["loss"]
    check(torch.equal(loss_a, loss_b), f"phase 14 (a): eval loss "
          f"{float(loss_a)!r} vs restored {float(loss_b)!r}")
    check(sess2.fact is not None and sess2.solves == sess.solves
          and torch.equal(sess2.fact.s, sess.fact.s),
          "phase 14 (a): the Session did not resume its factorization")
    drift = A + TSESSION_DRIFT * torch.randn(A.shape, generator=gen(65),
                                             device=DEV)
    reset_kernel_launches()
    sess2.update(drift)
    torch.cuda.synchronize()
    update_launches = {k: kernel_launches()[k] for k in GK_STEP}
    kind = sess2.history[-1]["kind"]
    check(kind == "refine", f"phase 14 (a): the resumed update was {kind}")
    check(all(update_launches[k] > 0 for k in GK_STEP),
          f"phase 14 (a): the refine launched {update_launches}")
    n_params = sum(p.numel() for p in tr.state.model.parameters())
    timed = step_s[1:]
    rec = dict(arch=LM_ARCH, layers=TRAIN_LAYERS, params=n_params,
               dtype=cfg.dtype, batch=TRAIN_BATCH, seq=spec.seq_len,
               losses=losses, step_ms=1e3 * sum(timed) / len(timed),
               step_ms_all=[1e3 * s for s in step_s], drained_at=tr.step,
               checkpoints=len(save_s), save_s=save_s, restore_s=restore_s,
               checkpoint_bytes=ckpt_bytes, eval_loss=float(loss_a),
               peak_gib=peak / GIB, session=dict(
                   shape=[m, n], rank=TSESSION_RANK, solves=sess.solves,
                   solve_launches=solve_launches,
                   update_launches=update_launches, update_kind=kind))
    print(f"phase 14 (a) Trainer {LM_ARCH} ({TRAIN_LAYERS} of 24 layers, "
          f"{n_params:,} params, {cfg.dtype}, {TRAIN_BATCH} x "
          f"{spec.seq_len}): losses {[round(x, 4) for x in losses]}, "
          f"{rec['step_ms']:.1f} ms a step (steps 2-{len(step_s)}); SIGTERM "
          f"after step {TRAIN_TERM_AFTER} drained at {tr.step}; "
          f"{len(save_s)} checkpoints of {ckpt_bytes / 1e9:.2f} GB in "
          f"{[round(s, 2) for s in save_s]} s, restore {restore_s:.2f} s, "
          f"every leaf and the eval loss bit for bit; peak "
          f"{rec['peak_gib']:.2f} GiB; Session {m} x {n} rank "
          f"{TSESSION_RANK}: solve launches {solve_launches}, resumed "
          f"update {kind} launches {update_launches}", flush=True)
    del tr, tr2, sess, sess2, A, drift
    return rec


def _mlp_leaf(named):
    """The name of layer 0's first (2048, 5632) MLP weight."""
    return next(k for k, p in named.items() if k.startswith("layers.0.")
                and tuple(p.shape) == COMP_LEAF)


def train_rank(rank, world, dev, seed, out_dir):
    """(b) and (c) on one rank of a two-rank gloo world on cuda:0; writes
    rank<r>.json."""
    import dataclasses

    import torch
    from repro_torch.configs import (FsvdConfig, OptimConfig, get_arch,
                                     get_shape)
    from repro_torch.core.gk import start_vector
    from repro_torch.data.synthetic import lm_batch, spec_for
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.matvec import (collective_stats, psum,
                                                reset_collectives)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    global DEV
    DEV = dev
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        reset_collectives()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0, collective_stats()

    rec = dict(rank=rank, sharded={})
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_train_world import whole_gather_oracle
    published = dataclasses.replace(get_arch(MOE_ARCH),
                                    num_layers=MOE_LAYERS)
    spec = spec_for(published, get_shape("train_4k"),
                    batch_override=LM_BATCH)
    opt = OptimConfig()
    for tag, shape, no_drops in SHARD_RUNS:
        cfg = _no_drops(published) if no_drops else published
        mesh = make_mesh(shape, ("data", "model"), device_type=dev)
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        state = S.init_sharded_state(cfg, opt, torch.Generator(
            device=dev).manual_seed(seed + 14), mesh)
        step = S.build_train_step(cfg, opt, mesh)
        steps, oracle, peak = [], None, None
        for t in range(SHARD_STEPS):
            batch = lm_batch(spec, seed, t, device=dev)
            if t == SHARD_STEPS - 1 and tag in ORACLE_RUNS:
                # the peak before the oracle's copy of the gradients
                peak = torch.cuda.max_memory_allocated() if dev == "cuda" \
                    else 0
                # this step's gradients, kept for the whole-gather oracle
                seen, exchange = {}, S._exchange

                def spy(grads, *args):
                    seen.update({k: v.clone() for k, v in grads.items()})
                    return exchange(grads, *args)
                keep = S.build_train_step(cfg, opt, mesh, keep_grads=True)
                S._exchange = spy
                try:
                    (state, met), wall, coll = timed(
                        lambda: keep(state, batch))
                finally:
                    S._exchange = exchange
                want, norm = whole_gather_oracle(seen, state.layout, mesh)
                oracle = dict(
                    leaves=len(want),
                    differ=sum(not torch.equal(met["grads"][k], want[k])
                               for k in want),
                    norm_rel=abs(float(met["grad_norm"]) - float(norm))
                    / float(norm))
                del seen, want, met["grads"]
            else:
                (state, met), wall, coll = timed(lambda: step(state, batch))
            steps.append(dict(loss=float(met["loss"]),
                              grad_norm=float(met["grad_norm"]),
                              skipped=int(met["skipped"]), wall_s=wall,
                              collectives=coll["calls"],
                              collective_s=coll["seconds"],
                              floats_sent=coll["floats_sent"],
                              by_kind=coll["by_kind"]))
        blocks = {k: v.device.type for k, v in state.params.items()}
        rec["sharded"][tag] = dict(
            steps=steps, devices=sorted(set(blocks.values())), oracle=oracle,
            peak_gib=(peak if peak is not None else
                      torch.cuda.max_memory_allocated()
                      if dev == "cuda" else 0.0) / GIB,
            param_bytes=sum(v.numel() * v.element_size()
                            for v in state.params.values()))
        del state, step, met
        gc.collect()

    # (b) stablelm-1.6b tensor parallel over "model"
    rec["tp"] = tp_rank(rank, dev, seed, out_dir, timed)
    # (b) zamba2's Mamba2 heads, a batch of one,
    # deepseek-v2's latents by sequence
    rec["q3"] = q3_rank(rank, dev, seed, out_dir, timed)

    # (c) the compressed step over ("pod",)
    cfg = dataclasses.replace(get_arch(LM_ARCH), num_layers=TRAIN_LAYERS)
    spec = spec_for(cfg, get_shape("train_4k"), batch_override=world)
    mesh = make_mesh((world,), ("pod",), device_type=dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fcfg = FsvdConfig()
    state = S.init_state(cfg, opt, torch.Generator(device=dev).manual_seed(
        seed + 13))
    # one MLP gradient of this rank's shard, before any step
    named = dict(state.model.named_parameters())
    leaf = _mlp_leaf(named)
    local = S.shard_batch(lm_batch(spec, seed, 0, device=dev), mesh)
    loss, _ = M.loss_fn(state.model, local, cfg)
    g = torch.autograd.grad(loss, [named[leaf]])[0].float()
    r = fcfg.compression_rank
    k = min(max(2 * r, r + 2), fcfg.max_iters)
    q1 = start_vector(torch.Generator(device=dev).manual_seed(seed + 66),
                      g.shape[0], torch.float32, g.device)
    (U, s, V), comp_wall, comp_coll = timed(
        lambda: C.compress_mean(g, "pod", r, k, mesh=mesh, q1=q1))
    exact = torch.linalg.svdvals(psum(g, mesh, "pod") / world)
    sigma_err = float((s - exact[:r]).abs().max() / exact[0])
    del U, V, g, loss
    step = S.build_compressed_train_step(cfg, opt, mesh, fcfg)
    steps = []
    for t in range(COMP_STEPS):
        batch = lm_batch(spec, seed, t, device=dev)
        (state, met), wall, coll = timed(lambda: step(state, batch))
        steps.append(dict(loss=float(met["loss"]),
                          skipped=int(met["skipped"]),
                          dense_bytes=float(met["comm_dense_bytes"]),
                          compressed_bytes=float(
                              met["comm_compressed_bytes"]),
                          wall_s=wall, collectives=coll["calls"],
                          collective_s=coll["seconds"]))
    rec["compressed"] = dict(
        steps=steps, leaf=leaf, shape=list(COMP_LEAF), r=r, k=k,
        sigma=s.tolist(), sigma_exact=exact[:r].tolist(),
        sigma_err=sigma_err, compress_wall_s=comp_wall,
        compress_collectives=comp_coll["calls"],
        device=str(next(state.model.parameters()).device),
        peak_gib=(torch.cuda.max_memory_allocated() / GIB
                  if dev == "cuda" else 0.0))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


# (b) stablelm-1.6b tensor parallel over "model": its published width cut
# to TRAIN_LAYERS layers, bf16, LM_BATCH x 4096, on ("data", "model")
# (1, 2): heads, kv heads, the MLP's width and the vocabulary split two ways
TP_SHAPE = (1, 2)
TP_STEPS = 2
TP_DECODE = 4
TP_RTOL = 1e-3          # first loss, first grad norm, second loss vs one card
# each leaf's first gradient block vs one card's, x that leaf's max |g|:
# 2.0e-3 to 8.5e-3 on the card (bf16), so a leaf whose gradient misses a
# rank's part (O(1)) fails
TP_GRAD_TOL = 2e-2
# the embedding's: each row of the batch's repeated 8-grams gathers ~500
# bf16 atomic adds, whose order changes from run to run (0.058-0.118 on
# the card in two runs)
TP_EMBED_GRAD_TOL = 0.3
TP_LOGIT_TOL = 2e-2     # x max |logit|: prefill and decode vs one card
TP_SEED = 31            # the model's draws: seed + TP_SEED


def tp_config():
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(LM_ARCH), num_layers=TRAIN_LAYERS)


def tp_spec(cfg):
    from repro_torch.configs import get_shape
    from repro_torch.data.synthetic import spec_for
    return spec_for(cfg, get_shape("train_4k"), batch_override=LM_BATCH)


def tp_serve(model, cfg, mesh, prompt, tokens=None, batch=None,
             measure=False):
    """A prefill of ``prompt`` and TP_DECODE decode steps on the padded
    cache, step t fed ``tokens[t]`` (one card's greedy picks) or, without
    them, the greedy pick.  On a mesh the cache is the rank's block: its
    sequence split over ``input_specs.decode_seq_axes`` of the global
    ``batch`` (default: the prompt's rows).  ``measure`` takes the first
    decode step alone: its collectives by kind and the card's peak
    allocation during it (the rest are timed).  Returns (the logits of
    each step on the host, the tokens fed, prefill ms, decode ms a token,
    the cache's bytes, the sequence axes, the first step's record or
    None)."""
    import torch
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    from repro_torch.launch import input_specs as I
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    prefill = S.build_prefill_step(cfg, mesh)
    sync = torch.cuda.synchronize if DEV == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": prompt})
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    S0 = prompt.shape[1]
    cache = M.pad_cache_to(cache, cfg, S0 + TP_DECODE)
    seq = ()
    if mesh is not None:
        seq = I.decode_seq_axes(cfg, mesh, batch or prompt.shape[0],
                                S0 + TP_DECODE)
        cache = I.sequence_block(cache, mesh, seq)
    decode = S.build_decode_step(cfg, mesh, seq)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _tree_leaves(cache))
    out, fed, first = [logits.float()], [], None
    t0 = time.perf_counter()
    for t in range(TP_DECODE):
        tok = tokens[t] if tokens is not None else \
            logits.argmax(-1)[:, None].int()
        fed.append(tok)
        batch_t = {"tokens": tok, "positions": torch.full_like(tok, S0 + t)}
        if measure and t == 0:
            del logits
            sync()
            reset_collectives()
            if DEV == "cuda":
                torch.cuda.reset_peak_memory_stats()
            logits, cache = decode(model, cache, batch_t)
            sync()
            first = dict(by_kind=collective_stats()["by_kind"],
                         peak_alloc=torch.cuda.max_memory_allocated()
                         if DEV == "cuda" else 0)
            t0 = time.perf_counter()
        else:
            logits, cache = decode(model, cache, batch_t)
        out.append(logits.float())
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (
        TP_DECODE - (first is not None))
    return ([o.cpu() for o in out], fed, prefill_ms, decode_ms, cache_bytes,
            list(seq), first)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def tp_reference(seed, out_dir):
    """(b)'s single-card run: the same 2-layer model drawn from the same
    seed, a prefill and TP_DECODE greedy decode steps (the tokens kept in
    ``out_dir`` for the ranks), then TP_STEPS AdamW steps on the same
    batches, the first step's gradients kept in ``out_dir``."""
    import torch
    from repro_torch.configs import OptimConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import model as M
    cfg = tp_config()
    spec = tp_spec(cfg)
    model, _ = M.init_model(cfg, torch.Generator(device=DEV).manual_seed(
        seed + TP_SEED))
    prompt = lm_batch(spec, seed, 0, device=DEV)["tokens"]
    with torch.no_grad():
        logits, fed, prefill_ms, decode_ms, _, _, _ = tp_serve(
            model, cfg, None, prompt)
    torch.save([t.cpu() for t in fed], os.path.join(out_dir,
                                                    "tp_tokens.pt"))
    steps, grads = lm_train(model, cfg, OptimConfig(),
                            [lm_batch(spec, seed, t, device=DEV)
                             for t in range(TP_STEPS)], keep=0)
    torch.save({k: g.cpu() for k, g in grads.items()},
               os.path.join(out_dir, "tp_grads.pt"))
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, logits=logits, prefill_ms=prefill_ms,
                decode_ms=decode_ms)


def tp_rank(rank, dev, seed, out_dir, timed):
    """(b)'s tensor-parallel run on one rank: the serving blocks
    (``steps.serving_model``) prefill and decode the one card's tokens
    (the logits saved to ``out_dir``), then TP_STEPS sharded AdamW steps,
    the first under FlopCounterMode with the peak over what was allocated
    before the state (phase 15 (b)'s real rank).  Its gradient blocks
    are held to one card's (:func:`tp_grad_errs`)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import OptimConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    cuda = dev == "cuda"
    cfg, opt = tp_config(), OptimConfig()
    spec = tp_spec(cfg)
    mesh = make_mesh(TP_SHAPE, ("data", "model"), device_type=dev)
    model, _ = M.init_model(cfg, torch.Generator(device=dev).manual_seed(
        seed + TP_SEED))
    served = S.serving_model(model, cfg, mesh)
    del model
    tokens = [t.to(dev) for t in torch.load(os.path.join(out_dir,
                                                         "tp_tokens.pt"))]
    prompt = S.shard_batch({"tokens": lm_batch(spec, seed, 0, device=dev)[
        "tokens"]}, mesh)["tokens"]
    reset_collectives()
    with torch.no_grad():
        logits, _, prefill_ms, decode_ms, _, _, _ = tp_serve(
            served, cfg, mesh, prompt, tokens)
    serve_coll = collective_stats()
    torch.save(logits, os.path.join(out_dir, f"tp_logits{rank}.pt"))
    del served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() if cuda else 0
    state = S.init_sharded_state(cfg, opt, torch.Generator(
        device=dev).manual_seed(seed + TP_SEED), mesh)
    step = S.build_train_step(cfg, opt, mesh)
    first = S.build_train_step(cfg, opt, mesh, keep_grads=True)
    steps, flops, peak = [], None, 0
    for t in range(TP_STEPS):
        batch = lm_batch(spec, seed, t, device=dev)
        if t == 0:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as fc:
                (state, met), wall, coll = timed(lambda: first(state, batch))
            flops = fc.get_total_flops()
            peak = torch.cuda.max_memory_allocated() - base if cuda else 0
            grad_errs = tp_grad_errs(met.pop("grads"), state.layout, mesh,
                                     out_dir)
        else:
            (state, met), wall, coll = timed(lambda: step(state, batch))
        steps.append(dict(loss=float(met["loss"]),
                          grad_norm=float(met["grad_norm"]),
                          skipped=int(met["skipped"]), wall_s=wall,
                          collectives=coll["calls"],
                          collective_s=coll["seconds"],
                          by_kind=coll["by_kind"]))
    rec = dict(steps=steps, flops=flops, peak_bytes=peak,
               grad_errs=grad_errs,
               param_bytes=sum(v.numel() * v.element_size()
                               for v in state.params.values()),
               prefill_ms=prefill_ms, decode_ms=decode_ms,
               serve_collectives=serve_coll["calls"],
               serve_collective_s=serve_coll["seconds"])
    del state, step, met
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def tp_grad_errs(blocks, layout, mesh, out_dir, name="tp_grads.pt"):
    """{leaf: max |this rank's block - one card's same block| / max |one
    card's leaf|} of the first step's gradients; one card's are read from
    ``out_dir``/``name`` (:func:`tp_reference`)."""
    import torch
    from repro_torch.distributed import partition as P
    want = torch.load(os.path.join(out_dir, name), mmap=True)
    out = {}
    for k, lf in layout.items():
        w = want[k].to(blocks[k].device)
        sl = P.block_slices(lf.spec, lf.shape, mesh)
        out[k] = float((blocks[k].float() - w[sl].float()).abs().max()
                       / w.float().abs().max())
        del w
    return out


def tp_check(single, recs, out_dir):
    """(b)'s checks: the same bits on both ranks, the steps and the
    logits against one card's; prints a line a rank."""
    import torch
    per = [x["tp"] for x in recs]
    for key in ("loss", "grad_norm"):
        vals = [[s[key] for s in p["steps"]] for p in per]
        check(all(v == vals[0] for v in vals), f"phase 14 (b) "
              f"tensor parallel: {key} differs between ranks {vals}")
    check(not any(s["skipped"] for p in per for s in p["steps"]) and all(
        math.isfinite(s["loss"]) for s in per[0]["steps"]),
        f"phase 14 (b) tensor parallel: {per[0]['steps']}")
    got = dict(loss=per[0]["steps"][0]["loss"],
               grad_norm=per[0]["steps"][0]["grad_norm"],
               loss2=per[0]["steps"][1]["loss"])
    want = dict(loss=single["steps"][0]["loss"],
                grad_norm=single["steps"][0]["grad_norm"],
                loss2=single["steps"][1]["loss"])
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    check(max(rel.values()) < TP_RTOL, f"phase 14 (b) tensor parallel: "
          f"{got} vs one card {want} (relative {rel}, bound {TP_RTOL})")
    logits = [torch.load(os.path.join(out_dir, f"tp_logits{r}.pt"))
              for r in range(len(recs))]
    check(all(all(torch.equal(a, b) for a, b in zip(lg, logits[0]))
              for lg in logits), "phase 14 (b) tensor parallel: the ranks' "
          "logits differ")
    scale = max(float(w.abs().max()) for w in single["logits"])
    errs = [float((g - w).abs().max()) / scale
            for g, w in zip(logits[0], single["logits"])]
    check(max(errs) < TP_LOGIT_TOL, f"phase 14 (b) tensor parallel: "
          f"logits {errs} of max |logit| from one card's (bound "
          f"{TP_LOGIT_TOL})")
    def bound(leaf):
        return TP_EMBED_GRAD_TOL if leaf == "embed" else TP_GRAD_TOL
    worst = [max(p["grad_errs"], key=lambda k: p["grad_errs"][k] / bound(k))
             for p in per]
    others = [max(e for k, e in p["grad_errs"].items() if k != "embed")
              for p in per]
    out = dict(rel_vs_single=rel, logit_errs=errs, single=dict(
        steps=single["steps"], prefill_ms=single["prefill_ms"],
        decode_ms=single["decode_ms"]), ranks=per)
    for r, p in enumerate(per):
        s = p["steps"][-1]
        print(f"phase 14 (b) {LM_ARCH} ({TRAIN_LAYERS} layers, {LM_BATCH} x "
              f"{tp_spec(tp_config()).seq_len}, bf16) tensor parallel on "
              f"('data', 'model') "
              f"{TP_SHAPE}, rank {r}: losses "
              f"{[round(q['loss'], 5) for q in p['steps']]}, first grad "
              f"norm {p['steps'][0]['grad_norm']:.5f} (one card "
              f"{want['loss']:.5f}, {want['grad_norm']:.5f}, "
              f"{want['loss2']:.5f}; relative "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f", bound {TP_RTOL}); step walls "
              f"{[round(q['wall_s'], 3) for q in p['steps']]} s (the first "
              f"under FlopCounterMode; one card "
              f"{[round(q['wall_ms'], 1) for q in single['steps']]} ms), "
              f"collectives a step {s['collectives']} "
              f"({s['collective_s']:.3f} s; received by kind "
              + ", ".join(f"{k} {v['calls']} x {v['bytes'] / 1e9:.3f} GB"
                          for k, v in s["by_kind"].items() if v["calls"])
              + f"); blocks {p['param_bytes'] / 1e9:.3f} GB; first step's "
              f"peak {p['peak_bytes'] / GIB:.3f} GiB; prefill "
              f"{p['prefill_ms']:.1f} ms, decode {p['decode_ms']:.1f} ms a "
              f"token ({p['serve_collectives']} collectives, "
              f"{p['serve_collective_s']:.3f} s; one card "
              f"{single['prefill_ms']:.1f} / {single['decode_ms']:.1f} ms); "
              f"logits vs one card "
              + ", ".join(f"{e:.2e}" for e in errs)
              + f" of max |logit| (bound {TP_LOGIT_TOL}); first gradients "
              f"vs one card's, of a leaf's max |g|: the embedding "
              f"{p['grad_errs']['embed']:.2e} (bound {TP_EMBED_GRAD_TOL}), "
              f"the other {len(p['grad_errs']) - 1} leaves "
              f"{min(p['grad_errs'].values()):.2e} to {others[r]:.2e} "
              f"(bound {TP_GRAD_TOL})", flush=True)
    out["grad_errs"] = [p["grad_errs"] for p in per]
    check(all(e < bound(k) for p in per for k, e in p["grad_errs"].items()),
          f"phase 14 (b) tensor parallel: first gradients "
          f"{[(w, p['grad_errs'][w]) for w, p in zip(worst, per)]} of a "
          f"leaf's max |g| from one card's (bounds {TP_GRAD_TOL}, the "
          f"embedding {TP_EMBED_GRAD_TOL})")
    return out


# (b) the Mamba2, batch-of-one and sequence splits at published widths.
# zamba2-1.2b (d_model 2048, 64 SSD heads of 64, d_state 64) cut to
# ZB_LAYERS of its 38 layers,
# so that its shared attention block runs once (attn_every 6): on
# ZB_TRAIN_SHAPE its Mamba2 layers split by heads over "model" (32 a rank)
# and its shared block by heads and MLP columns, ZB_STEPS AdamW steps at
# LM_BATCH x 4096 against one card's; on ZB_SERVE_SHAPE a prefill of a
# batch of one (ZB_PROMPT tokens, replicated) and TP_DECODE decode steps,
# its attention cache split by sequence over "data".  Every kv-head count
# of the registry divides 2, so on two ranks the cache's sequence split
# over "model" is shown by deepseek-v2-236b's MLA latents (no head axis):
# its published width, DV_LAYERS layers (the dense first layer and one of
# 160 experts), LM_BATCH x DV_PROMPT, on DV_SHAPE
ZB_ARCH = "zamba2-1.2b"
ZB_LAYERS = 6
ZB_TRAIN_SHAPE = (1, 2)
ZB_SERVE_SHAPE = (2, 1)
ZB_STEPS = 2
ZB_PROMPT = 4096
# the train steps run in the published bf16 and in f32.  Bounds of the first
# loss, the first grad norm and the second loss against one card's: in f32
# the split's sums are the only difference (2e-7 / 1.9e-6 on the card); in
# bf16 each rank's partial sums round once more, and the random 6-layer
# model (tied embeddings, losses ~517) turns that into ~0.9 % of the grad
# norm on both steps, where one card's own bf16 norm sits ~0.6 % from its
# f32 norm (printed beside it; PERF.md): a rank missing a block's part
# would be off by O(1)
ZB_DTYPES = ("bfloat16", "float32")
ZB_RTOL = {"bfloat16": dict(loss=1e-3, grad_norm=2e-2, loss2=1e-3),
           "float32": dict(loss=1e-5, grad_norm=1e-5, loss2=1e-5)}
ZB_F32_GRAD_TOL = 1e-4  # each f32 first-gradient block, x its leaf's max |g|
ZB_SEED = 41            # the model's draws: seed + ZB_SEED
DV_ARCH = "deepseek-v2-236b"
DV_LAYERS = 2
DV_SHAPE = (1, 2)
DV_PROMPT = 1024
DV_SEED = 43


def q3_config(arch, layers, dtype=None):
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    return cfg


def q3_prompts(seed):
    """The prompts of (b)'s two serving runs: zamba2's batch of one and
    deepseek-v2's LM_BATCH rows."""
    from repro_torch.data.synthetic import LMBatchSpec, lm_batch
    zb = q3_config(ZB_ARCH, ZB_LAYERS)
    dv = q3_config(DV_ARCH, DV_LAYERS)
    return (lm_batch(LMBatchSpec(1, ZB_PROMPT, zb.vocab_size), seed, 7,
                     device=DEV)["tokens"],
            lm_batch(LMBatchSpec(LM_BATCH, DV_PROMPT, dv.vocab_size), seed, 8,
                     device=DEV)["tokens"])


def q3_reference(seed, out_dir):
    """(b)'s single-card runs of zamba2 and deepseek-v2: prefill and
    TP_DECODE greedy decode steps of each prompt (the tokens kept in
    ``out_dir`` for the ranks), then zamba2's ZB_STEPS AdamW steps."""
    import torch
    from repro_torch.configs import OptimConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import model as M
    zb_prompt, dv_prompt = q3_prompts(seed)
    out = {}
    for tag, arch, layers, off, prompt in (
            ("zb", ZB_ARCH, ZB_LAYERS, ZB_SEED, zb_prompt),
            ("dv", DV_ARCH, DV_LAYERS, DV_SEED, dv_prompt)):
        cfg = q3_config(arch, layers)
        model, _ = M.init_model(cfg, torch.Generator(device=DEV).manual_seed(
            seed + off))
        with torch.no_grad():
            logits, fed, prefill_ms, decode_ms, cache_bytes, _, _ = tp_serve(
                model, cfg, None, prompt)
        torch.save([t.cpu() for t in fed], os.path.join(
            out_dir, f"{tag}_tokens.pt"))
        out[tag] = dict(logits=logits, prefill_ms=prefill_ms,
                        decode_ms=decode_ms, cache_bytes=cache_bytes)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for dtype in ZB_DTYPES:
        cfg = q3_config(ZB_ARCH, ZB_LAYERS, dtype)
        model, _ = M.init_model(cfg, torch.Generator(device=DEV).manual_seed(
            seed + ZB_SEED))
        spec = tp_spec(cfg)
        out[f"zb_{dtype}"], grads = lm_train(
            model, cfg, OptimConfig(), [lm_batch(spec, seed, t, device=DEV)
                                        for t in range(ZB_STEPS)], keep=0)
        torch.save({k: g.cpu() for k, g in grads.items()},
                   os.path.join(out_dir, f"zb_grads_{dtype}.pt"))
        del model, grads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def q3_serve_rank(rank, dev, tag, cfg, off, shape, prompt, batch, seed,
                  out_dir, measure=False):
    """One rank's serving run of (b): its serving blocks
    (``steps.serving_model``) prefill its rows of ``prompt`` (all of them
    where the batch does not split) and decode one card's tokens, its
    block of the cache; the logits saved to ``out_dir``."""
    import torch
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    cuda = dev == "cuda"
    mesh = make_mesh(shape, ("data", "model"), device_type=dev)
    if cuda:
        torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() if cuda else 0
    model, _ = M.init_model(cfg, torch.Generator(device=dev).manual_seed(
        seed + off))
    served = S.serving_model(model, cfg, mesh)
    del model
    gc.collect()
    tokens = [t.to(dev) for t in torch.load(os.path.join(
        out_dir, f"{tag}_tokens.pt"))]
    if batch > 1:
        tokens = [S.shard_batch({"t": t}, mesh)["t"] for t in tokens]
    local = S.shard_batch({"tokens": prompt}, mesh)["tokens"]
    reset_collectives()
    with torch.no_grad():
        logits, _, prefill_ms, decode_ms, cache_bytes, seq, first = tp_serve(
            served, cfg, mesh, local, tokens, batch=batch, measure=measure)
    coll = collective_stats()
    torch.save(logits, os.path.join(out_dir, f"{tag}_logits{rank}.pt"))
    rec = dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
               cache_bytes=cache_bytes, seq_axes=seq,
               collectives=coll["calls"], collective_s=coll["seconds"],
               param_bytes=sum(p.numel() * p.element_size()
                               for p in served.parameters()))
    if first is not None:
        rec["first_decode"] = dict(by_kind=first["by_kind"],
                                   peak_bytes=first["peak_alloc"] - base)
    del served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def q3_rank(rank, dev, seed, out_dir, timed):
    """(b)'s split runs on one rank: zamba2's ZB_STEPS
    sharded AdamW steps on ZB_TRAIN_SHAPE, its batch of one served on
    ZB_SERVE_SHAPE (the first decode step measured for phase 15 (b)),
    deepseek-v2's rows served on DV_SHAPE."""
    import torch
    from repro_torch.configs import OptimConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import steps as S
    cuda = dev == "cuda"
    opt = OptimConfig()
    mesh = make_mesh(ZB_TRAIN_SHAPE, ("data", "model"), device_type=dev)
    train = {}
    for dtype in ZB_DTYPES:
        cfg = q3_config(ZB_ARCH, ZB_LAYERS, dtype)
        spec = tp_spec(cfg)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        state = S.init_sharded_state(cfg, opt, torch.Generator(
            device=dev).manual_seed(seed + ZB_SEED), mesh)
        step = S.build_train_step(cfg, opt, mesh)
        first = S.build_train_step(cfg, opt, mesh, keep_grads=True)
        steps = []
        for t in range(ZB_STEPS):
            batch = lm_batch(spec, seed, t, device=dev)
            (state, met), wall, coll = timed(
                lambda: (first if t == 0 else step)(state, batch))
            if t == 0:
                grad_errs = tp_grad_errs(met.pop("grads"), state.layout,
                                         mesh, out_dir,
                                         f"zb_grads_{dtype}.pt")
            steps.append(dict(loss=float(met["loss"]),
                              grad_norm=float(met["grad_norm"]),
                              skipped=int(met["skipped"]), wall_s=wall,
                              collectives=coll["calls"],
                              collective_s=coll["seconds"],
                              by_kind=coll["by_kind"]))
        train[dtype] = dict(
            steps=steps, grad_errs=grad_errs,
            blocked=sum(lf.model_block for lf in state.layout.values()),
            param_bytes=sum(v.numel() * v.element_size()
                            for v in state.params.values()),
            peak_bytes=(torch.cuda.max_memory_allocated() - base)
            if cuda else 0)
        del state, step, first, met
        gc.collect()
    cfg = q3_config(ZB_ARCH, ZB_LAYERS)
    zb_prompt, dv_prompt = q3_prompts(seed)
    serve = q3_serve_rank(rank, dev, "zb", cfg, ZB_SEED, ZB_SERVE_SHAPE,
                          zb_prompt, 1, seed, out_dir, measure=True)
    dv = q3_serve_rank(rank, dev, "dv", q3_config(DV_ARCH, DV_LAYERS),
                       DV_SEED, DV_SHAPE, dv_prompt, LM_BATCH, seed,
                       out_dir)
    return dict(train=train, serve=serve, dv=dv)


def q3_check_train(single, per, dtype):
    """(b)'s zamba2 steps in ``dtype``: the same bits on both ranks, the
    first loss, first grad norm and second loss within ZB_RTOL[dtype] of
    one card's, in f32 each first-gradient block within ZB_F32_GRAD_TOL of
    its leaf's max |g|; prints a line."""
    for key in ("loss", "grad_norm"):
        vals = [[s[key] for s in p["train"][dtype]["steps"]] for p in per]
        check(all(v == vals[0] for v in vals), f"phase 14 (b) {ZB_ARCH} "
              f"{dtype}: {key} differs between ranks {vals}")
    run = per[0]["train"][dtype]
    tr = run["steps"]
    one = single[f"zb_{dtype}"]
    check(not any(s["skipped"] for p in per
                  for s in p["train"][dtype]["steps"])
          and all(math.isfinite(s["loss"]) for s in tr),
          f"phase 14 (b) {ZB_ARCH} {dtype}: {tr}")
    want = dict(loss=one[0]["loss"], grad_norm=one[0]["grad_norm"],
                loss2=one[1]["loss"])
    got = dict(loss=tr[0]["loss"], grad_norm=tr[0]["grad_norm"],
               loss2=tr[1]["loss"])
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    bound = ZB_RTOL[dtype]
    errs = run["grad_errs"]
    worst = sorted(errs, key=lambda k: -errs[k])[:3]
    s = tr[-1]
    print(f"phase 14 (b) {ZB_ARCH} ({ZB_LAYERS} layers, {LM_BATCH} x "
          f"{tp_spec(q3_config(ZB_ARCH, ZB_LAYERS)).seq_len}, {dtype}) on "
          f"('data', 'model') {ZB_TRAIN_SHAPE}, the Mamba2 heads split: "
          f"losses {[round(q['loss'], 5) for q in tr]}, first grad norm "
          f"{tr[0]['grad_norm']:.5f} (one card {want['loss']:.5f}, "
          f"{want['grad_norm']:.5f}, {want['loss2']:.5f}; relative "
          + ", ".join(f"{k} {v:.2e} (bound {bound[k]})"
                      for k, v in rel.items())
          + f"); {run['blocked']} leaves by 'model' block; step walls "
          f"{[round(q['wall_s'], 3) for q in tr]} s (one card "
          f"{[round(q['wall_ms'], 1) for q in one]} ms), collectives a "
          f"step {s['collectives']} ({s['collective_s']:.3f} s; received "
          f"by kind "
          + ", ".join(f"{k} {v['calls']} x {v['bytes'] / 1e9:.3f} GB"
                      for k, v in s["by_kind"].items() if v["calls"])
          + f"); blocks {run['param_bytes'] / 1e9:.3f} GB; peak "
          f"{run['peak_bytes'] / GIB:.3f} GiB; first gradients vs one "
          f"card's, of a leaf's max |g|: "
          + ", ".join(f"{k} {errs[k]:.2e}" for k in worst)
          + f" (the largest of {len(errs)})", flush=True)
    check(all(rel[k] < bound[k] for k in rel), f"phase 14 (b) {ZB_ARCH} "
          f"{dtype} on {ZB_TRAIN_SHAPE}: {got} vs one card {want} "
          f"(relative {rel}, bounds {bound})")
    if dtype == "float32":
        check(all(e < ZB_F32_GRAD_TOL for p in per
                  for e in p["train"][dtype]["grad_errs"].values()),
              f"phase 14 (b) {ZB_ARCH} f32: first gradients "
              f"{[(k, errs[k]) for k in worst]} of a leaf's max |g| from "
              f"one card's (bound {ZB_F32_GRAD_TOL})")
    return dict(rel_vs_single=rel, single=one,
                grad_errs=[p["train"][dtype]["grad_errs"] for p in per])


def q3_check(single, recs, out_dir):
    """(b)'s checks of the split runs: zamba2's steps
    (:func:`q3_check_train`); each serving run's
    logits the same bits on both ranks and within TP_LOGIT_TOL of max
    |logit| of one card's, deepseek-v2's cache a rank half of one
    card's; prints a line a run."""
    import torch
    per = [x["q3"] for x in recs]
    out = dict(train={})
    for dtype in ZB_DTYPES:
        out["train"][dtype] = q3_check_train(single, per, dtype)
    gaps = [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
            for a, b in zip(single["zb_bfloat16"], single["zb_float32"])]
    out["train"]["one_card_bf16_vs_f32"] = gaps
    print(f"phase 14 (b) {ZB_ARCH}: one card's bf16 grad norms are "
          + ", ".join(f"{g:.2e}" for g in gaps)
          + " from its f32 ones (the same draws in f32)", flush=True)
    for tag, arch, shape in (("zb", ZB_ARCH, ZB_SERVE_SHAPE),
                             ("dv", DV_ARCH, DV_SHAPE)):
        key = "serve" if tag == "zb" else "dv"
        runs = [p[key] for p in per]
        logits = [torch.load(os.path.join(out_dir, f"{tag}_logits{r}.pt"))
                  for r in range(len(recs))]
        check(all(all(torch.equal(a, b) for a, b in zip(lg, logits[0]))
                  for lg in logits), f"phase 14 (b) {arch} serving on "
              f"{shape}: the ranks' logits differ")
        ref = single[tag]["logits"]
        scale = max(float(w.abs().max()) for w in ref)
        # rank 0 holds the first rows where the batch splits (LM_BATCH on
        # a "data" axis of 1 does not)
        errs = [float((g - w).abs().max()) / scale
                for g, w in zip(logits[0], ref)]
        check(max(errs) < TP_LOGIT_TOL, f"phase 14 (b) {arch} serving on "
              f"{shape}: logits {errs} of max |logit| from one card's "
              f"(bound {TP_LOGIT_TOL})")
        if tag == "dv":
            check(all(2 * r["cache_bytes"] == single[tag]["cache_bytes"]
                      for r in runs), f"phase 14 (b) {arch}: a rank's "
                  f"cache {runs[0]['cache_bytes']} B, one card's "
                  f"{single[tag]['cache_bytes']} B")
        want_axes = ["data"] if tag == "zb" else ["model"]
        check(all(r["seq_axes"] == want_axes for r in runs),
              f"phase 14 (b) {arch}: the cache's sequence split over "
              f"{runs[0]['seq_axes']}, not {want_axes}")
        r0 = runs[0]
        print(f"phase 14 (b) {arch} serving on ('data', 'model') {shape}, "
              f"the cache's sequence over {r0['seq_axes']}: prefill "
              f"{r0['prefill_ms']:.1f} ms, decode {r0['decode_ms']:.1f} ms "
              f"a token ({r0['collectives']} collectives, "
              f"{r0['collective_s']:.3f} s; one card "
              f"{single[tag]['prefill_ms']:.1f} / "
              f"{single[tag]['decode_ms']:.1f} ms); a rank's cache "
              f"{r0['cache_bytes'] / 1e6:.2f} MB (one card "
              f"{single[tag]['cache_bytes'] / 1e6:.2f}), its blocks "
              f"{r0['param_bytes'] / 1e9:.3f} GB; logits vs one card "
              + ", ".join(f"{e:.2e}" for e in errs)
              + f" of max |logit| (bound {TP_LOGIT_TOL}), the same bits "
              f"on both ranks", flush=True)
        out[tag] = dict(logit_errs=errs, single=dict(
            prefill_ms=single[tag]["prefill_ms"],
            decode_ms=single[tag]["decode_ms"],
            cache_bytes=single[tag]["cache_bytes"]), ranks=runs)
    return out


def start_clis(out_dir):
    """(d) the three CLIs on the card, started side by side; returns the
    processes and their start time for :func:`finish_clis`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmds = {
        "train": ["-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                  "--reduced", "--steps", "20", "--ckpt-dir",
                  os.path.join(out_dir, "cli_ckpt")],
        "serve": ["-m", "repro_torch.launch.serve", "--arch", LM_ARCH,
                  "--reduced"],
        "quickstart": ["-m", "repro_torch.launch.quickstart"]}
    if DEV != "cuda":
        for argv in cmds.values():
            argv += ["--device", DEV]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable] + argv, cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, argv in cmds.items()}
    return procs, t0


def finish_clis(procs, t0):
    """Wait for the CLIs of :func:`start_clis` and check them: each exits
    0, and the trainer lowers its loss."""
    out = {}
    for name, p in procs.items():
        try:
            so, se = p.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise SmokeFailure(f"phase 14 (d): {name} timed out")
        check(p.returncode == 0, f"phase 14 (d): {name} exited "
              f"{p.returncode}: {se[-2000:]}")
        out[name] = dict(rc=p.returncode, last=so.strip().splitlines()[-1:])
    line = (out["train"]["last"] or [""])[0]
    got = re.search(r"loss ([0-9.]+) -> ([0-9.]+)", line)
    check(got is not None and float(got.group(2)) < float(got.group(1)),
          f"phase 14 (d): train did not lower its loss: {line}")
    out["train"]["loss"] = [float(got.group(1)), float(got.group(2))]
    out["collected_after_s"] = time.perf_counter() - t0
    return out


def phase_train(seed, single):
    """Phase 14: the Trainer, the sharded and compressed steps and the
    CLIs; see the module docstring.  ``single`` is phase 13 (c)'s record
    (its two steps on one card).  Returns the {"train": ...} record."""
    import shutil

    import torch
    from repro_torch.launch.mesh import run_world
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, "build", "phase14")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    clis = None
    try:
        rec = dict(trainer=train_trainer(seed, out_dir))
        # (d) after (a), whose times are the card's alone
        clis = start_clis(out_dir)
        rec["cli"] = finish_clis(*clis)
        clis = None
        print(f"phase 14 (d) CLIs after (a): train loss "
              f"{rec['cli']['train']['loss']}, serve and quickstart exit 0, "
              f"all done {rec['cli']['collected_after_s']:.1f} s after their "
              f"start", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        refs = {"1x2": single, "2x1": single,
                "2x1 no drops": shard_reference(seed)}
        tp_single = tp_reference(seed, out_dir)
        q3_single = q3_reference(seed, out_dir)
        t1 = time.perf_counter()
        run_world(train_rank, DIST_WORLD, os.path.join(out_dir, "rendezvous"),
                  (DEV, seed, out_dir), timeout_s=DIST_TIMEOUT_S)
        world_s = time.perf_counter() - t1
        recs = []
        for r in range(DIST_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                recs.append(json.load(fh))
        for tag in recs[0]["sharded"]:
            per = [x["sharded"][tag] for x in recs]
            losses = [[s["loss"] for s in p["steps"]] for p in per]
            check(all(ls == losses[0] for ls in losses),
                  f"phase 14 (b) {tag}: losses differ between ranks {losses}")
            check(all(math.isfinite(x) for x in losses[0]) and not any(
                s["skipped"] for p in per for s in p["steps"]),
                f"phase 14 (b) {tag}: {per[0]['steps']}")
            check(all(p["devices"] == [DEV] for p in per),
                  f"phase 14 (b) {tag}: blocks on {per[0]['devices']}")
            norms = [[s["grad_norm"] for s in p["steps"]] for p in per]
            check(all(ns == norms[0] for ns in norms),
                  f"phase 14 (b) {tag}: grad norms differ between ranks "
                  f"{norms}")
            got = dict(loss=losses[0][0], grad_norm=norms[0][0],
                       loss2=losses[0][1])
            want = dict(loss=refs[tag]["step"]["loss"],
                        grad_norm=refs[tag]["step"]["grad_norm"],
                        loss2=refs[tag]["next_step"]["loss"])
            rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
            first = abs(losses[0][0] - single["step"]["loss"]) / abs(
                single["step"]["loss"])
            check(first < SHARD_LOSS_RTOL, f"phase 14 (b) {tag}: first loss "
                  f"{losses[0][0]} vs phase 13 (c) {single['step']['loss']} "
                  f"({first:.2e})")
            if tag in SHARD_RTOL:
                check(max(rel.values()) < SHARD_RTOL[tag],
                      f"phase 14 (b) {tag}: {got} vs one card {want} "
                      f"(relative {rel}, bound {SHARD_RTOL[tag]})")
            for r, p in enumerate(per):
                o = p["oracle"]
                if tag in ORACLE_RUNS:
                    check(o is not None and o["differ"] == 0
                          and o["norm_rel"] < 1e-6,
                          f"phase 14 (b) {tag}, rank {r}: the exchange's "
                          f"blocks against the whole gather: {o}")
                p["rel_vs_single"] = rel
                p["first_loss_rel_vs_phase13"] = first
                s = p["steps"][-1]
                print(f"phase 14 (b) {MOE_ARCH} ({MOE_LAYERS} layers) on "
                      f"('data', 'model') {tag}, rank {r}: losses "
                      f"{[round(x, 5) for x in losses[r]]}, first grad "
                      f"norm {norms[r][0]:.5f} (one card "
                      f"{want['loss']:.5f}, {want['grad_norm']:.5f}, "
                      f"{want['loss2']:.5f}; relative "
                      + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
                      + (f", bound {SHARD_RTOL[tag]}" if tag in SHARD_RTOL
                         else ", not bounded: capacity and aux by shard")
                      + f"); step walls "
                      f"{[round(q['wall_s'], 3) for q in p['steps']]} s, "
                      f"collectives a step {s['collectives']} "
                      f"({s['collective_s']:.3f} s, {s['floats_sent']} "
                      f"words sent; received by kind "
                      + ", ".join(f"{k} {v['calls']} x {v['bytes'] / 1e9:.3f}"
                                  f" GB" for k, v in s["by_kind"].items()
                                  if v["calls"])
                      + f"); blocks {p['param_bytes'] / 1e9:.2f} GB; "
                      f"peak {p['peak_gib']:.2f} GiB"
                      + (f"; the exchange's {o['leaves']} blocks bit for bit "
                         f"the whole gather's ({o['differ']} differ), norm "
                         f"{o['norm_rel']:.1e} from it" if o else ""),
                      flush=True)
        rec["tp"] = tp_check(tp_single, recs, out_dir)
        rec["q3"] = q3_check(q3_single, recs, out_dir)
        for x in recs:
            del x["tp"], x["q3"]
        comp = [x["compressed"] for x in recs]
        closs = [[s["loss"] for s in c["steps"]] for c in comp]
        check(all(ls == closs[0] for ls in closs) and all(
            math.isfinite(x) for x in closs[0]) and not any(
            s["skipped"] for c in comp for s in c["steps"]),
            f"phase 14 (c): losses {closs}")
        check(all(c["device"].startswith(DEV) for c in comp),
              f"phase 14 (c): state on {comp[0]['device']}")
        for r, c in enumerate(comp):
            check(c["sigma_err"] < COMP_SIGMA_TOL, f"phase 14 (c) rank {r}: "
                  f"compressed sigma error {c['sigma_err']:.3e}")
            s = c["steps"][-1]
            c["ratio"] = s["compressed_bytes"] / s["dense_bytes"]
            print(f"phase 14 (c) compressed step {LM_ARCH} "
                  f"({TRAIN_LAYERS} layers, 1 x 4096 a rank) on ('pod',) "
                  f"{DIST_WORLD}, rank {r}: losses "
                  f"{[round(x, 5) for x in closs[r]]}, step walls "
                  f"{[round(q['wall_s'], 3) for q in c['steps']]} s, "
                  f"collectives a step {s['collectives']} "
                  f"({s['collective_s']:.3f} s); bytes "
                  f"{s['compressed_bytes']:.4g} / {s['dense_bytes']:.4g} = "
                  f"{100 * c['ratio']:.3f} %; {c['leaf']} rank {c['r']} k "
                  f"{c['k']}: sigma error {c['sigma_err']:.3e} of sigma_max "
                  f"({c['compress_collectives']} collectives, "
                  f"{c['compress_wall_s']:.3f} s); peak "
                  f"{c['peak_gib']:.2f} GiB", flush=True)
        rec.update(world_s=world_s, ranks=recs)
    finally:
        if clis is not None:
            for p in clis[0].values():
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    rec["cuts"] = [
        f"{LM_ARCH}: num_layers 24 -> {TRAIN_LAYERS}; global batch 256 -> "
        f"{TRAIN_BATCH} (SHAPES['train_4k'], seq 4096); (c) 1 x 4096 a rank",
        f"{MOE_ARCH}: num_layers 16 -> {MOE_LAYERS}; global batch 256 -> "
        f"{LM_BATCH}, as phase 13 (c); its run '2x1 no drops' also "
        "capacity_factor 1.25 -> 8 and aux_loss_weight 0.01 -> 0",
        f"(b) tensor parallel: {LM_ARCH} num_layers 24 -> {TRAIN_LAYERS}, "
        f"global batch 256 -> {LM_BATCH}, the 'model' axis 16 -> 2",
        f"(b) {ZB_ARCH}: num_layers 38 -> {ZB_LAYERS} (one application of "
        f"the shared attention block); train global batch 256 -> "
        f"{LM_BATCH} x 4096, the 'model' axis 16 -> 2; the batch of one's "
        f"context 524288 (long_500k) -> {ZB_PROMPT} + {TP_DECODE}, the "
        f"'data' axis 16 -> 2",
        f"(b) {DV_ARCH}: num_layers 60 -> {DV_LAYERS} (the dense first "
        f"layer and one MoE layer); decode_32k's batch 128 x 32768 -> "
        f"{LM_BATCH} x ({DV_PROMPT} + {TP_DECODE}), the 'model' axis 16 -> "
        f"2",
        f"two gloo ranks share one card (the mesh has {DIST_WORLD} ranks, "
        "not 256)", "random weights drawn on the card from --seed"]
    rec["wall_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14: {rec['wall_s']:.1f} s (the world {world_s:.1f} s)",
          flush=True)
    return rec


# --- phase 15: the dry run ------------------------------------------------

# the sweep runs one dry-run process an (arch, mesh), at most DRYRUN_PROCS
# at a time: each traces on one host core
DRYRUN_PROCS = 8
# the arch whose cells trace longest (deepseek-v2-236b's two-pod train cell
# alone 138-169 s, its four cells a mesh 164-219 s on the card)
# runs one subprocess a cell
DRYRUN_SPLIT = ("deepseek-v2-236b",)
# a job's trace seconds grow with the layers it traces (on the card: 1.5
# to 2.6 s a layer for an (arch, mesh) of the other archs, more on two
# pods; deepseek-v2-236b's train cell ~2-3 s a layer, its prefill and
# decode ~0.5-0.8): the sweep starts the longest first, so that its wall
# stays near its traces' sum over DRYRUN_PROCS
DRYRUN_SHAPE_COST = {"train_4k": 3.0, "prefill_32k": 0.8, "decode_32k": 0.5,
                     "long_500k": 0.0}
DRYRUN_TIMEOUT_S = 900
DRY_FLOP_RTOL = 1e-3          # trace vs FlopCounterMode on the real step
DRY_PEAK_RTOL = 0.10          # trace vs max_memory_allocated


def dryrun_sweep(out_dir):
    """(a) ``python -m repro_torch.launch.dryrun`` over every (arch x shape
    x mesh) cell on fake cuda tensors, an (arch, mesh) a subprocess, or
    an (arch, mesh, shape) for DRYRUN_SPLIT, the longest first: the
    counts, each failed cell's reason, the wall.  Fails if a cell fails
    by an exception."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ARCHS, SHAPES, get_arch
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    check(sorted(DRYRUN_SHAPE_COST) == sorted(SHAPES),
          f"phase 15 (a): the shapes' costs {DRYRUN_SHAPE_COST}")

    def cost(job):
        arch, mesh, shape = job
        per = DRYRUN_SHAPE_COST[shape] if shape else 1.6
        return get_arch(arch).num_layers * per * (1.3 if mesh == "multi"
                                                   else 1.0)
    jobs = sorted([(arch, mesh, shape) for arch in sorted(ARCHS)
                   for mesh in ("multi", "single")
                   for shape in (sorted(SHAPES) if arch in DRYRUN_SPLIT
                                 else [None])], key=cost, reverse=True)

    def run(job):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               job[0], "--mesh", job[1], "--out", out_dir, "--device", DEV]
        if job[2] is not None:
            cmd += ["--shape", job[2]]
        try:
            return job, subprocess.run(cmd, cwd=ROOT, env=env,
                                       capture_output=True, text=True,
                                       timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            return job, None
    t0 = time.perf_counter()
    with ThreadPoolExecutor(DRYRUN_PROCS) as pool:
        done = list(pool.map(run, jobs))
    wall = time.perf_counter() - t0
    for job, p in done:
        check(p is not None, f"phase 15 (a): {job} ran past "
              f"{DRYRUN_TIMEOUT_S} s")
        check(p.returncode in (0, 1), f"phase 15 (a): the dry run of {job} "
              f"exited {p.returncode}: {p.stderr[-2000:]}")
    cells = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as fh:
            cells[name[:-len(".json")]] = json.load(fh)
    counts = {st: sum(c["status"] == st for c in cells.values())
              for st in ("ok", "skipped", "failed")}
    failed = {tag: c["failure"] for tag, c in cells.items()
              if c["status"] == "failed"}
    by_reason = {r: sum(v == r for v in failed.values())
                 for r in ("memory", "check", "exception")}
    check(len(cells) == 2 * len(ARCHS) * len(SHAPES),
          f"phase 15 (a): {len(cells)} cells from {len(jobs)} runs")
    keep = ("kind", "status", "failure", "error", "trace_s",
            "flops_per_device", "bytes_per_device", "memory",
            "model_flops_global")
    rec = dict(wall_s=wall, processes=DRYRUN_PROCS,
               counts=counts, failed_by_reason=by_reason, failed=failed,
               cells={tag: {k: c[k] for k in keep if k in c}
                      | ({"collective_bytes":
                          c["collectives"]["total_bytes"]}
                         if "collectives" in c else {})
                      for tag, c in cells.items()})
    print(json.dumps({"dryrun_counts": dict(
        counts=counts, failed_by_reason=by_reason, failed=failed)}),
          flush=True)
    traced = sum(c.get("trace_s", 0) for c in cells.values())
    print(f"phase 15 (a) the dry run's sweep over both production meshes: "
          f"{len(cells)} cells in {wall:.1f} s, {len(jobs)} processes "
          f"{DRYRUN_PROCS} at a time ({traced:.1f} s of traces)",
          flush=True)
    exc = [t for t, r in failed.items() if r == "exception"]
    check(not exc, "phase 15 (a): cells failed by an exception: "
          + "; ".join(f"{t}: {cells[t]['error'][:300]}" for t in exc))
    return rec


def dryrun_vs_real(seed):
    """(b) one single-card AdamW step of stablelm-1.6b at phase 13's 2 x
    4096, traced on fake cuda tensors under the dry run's accounting and
    run for real under FlopCounterMode: dot FLOPs within 0.1 %, the peak
    within 10 % of max_memory_allocated over what was allocated before
    the state."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import OptimConfig, get_arch, get_shape
    from repro_torch.data.synthetic import lm_batch, spec_for
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import steps as S
    cfg, opt = get_arch(LM_ARCH), OptimConfig()
    spec = spec_for(cfg, get_shape("train_4k"), batch_override=LM_BATCH)
    step = S.build_train_step(cfg, opt)
    shapes = {k: (tuple(p.shape), p.dtype) for k, p in
              M.init_abstract(cfg)[0].named_parameters()}
    like = lm_batch(spec, seed, 0, device=DEV)

    def fake_args():
        model = M.ParamTree(S._nest({k: torch.empty(sh, dtype=dt, device=DEV)
                                     for k, (sh, dt) in shapes.items()}))
        state = S.TrainState(model, make_optimizer(opt)[0](
            dict(model.named_parameters())))
        return state, {k: torch.empty_like(v) for k, v in like.items()}
    mode, arg_bytes, trace_s = dryrun.trace(step, fake_args)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model, _ = M.init_model(cfg, torch.Generator(device=DEV).manual_seed(
        seed + 15))
    state = S.TrainState(model, make_optimizer(opt)[0](
        dict(model.named_parameters())))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        state, met = step(state, like)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    real_peak = torch.cuda.max_memory_allocated() - base
    flops = fc.get_total_flops()
    check(math.isfinite(float(met["loss"])), "phase 15 (b): the real step's "
          f"loss is {float(met['loss'])}")
    del state, met, model, like
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(arch=LM_ARCH, batch=LM_BATCH, seq=spec.seq_len,
               trace_s=trace_s, real_step_s=real_s,
               dot_flops=mode.dot_flops, flop_counter_flops=flops,
               flop_rel=abs(mode.dot_flops - flops) / flops,
               peak_bytes=mode.peak_bytes, argument_bytes=arg_bytes,
               real_peak_bytes=real_peak,
               peak_ratio=mode.peak_bytes / real_peak,
               hbm_bytes=mode.hbm_bytes)
    print(f"phase 15 (b) {LM_ARCH} one step at {LM_BATCH} x {spec.seq_len}: "
          f"the trace's dot FLOPs {mode.dot_flops:.6e}, FlopCounterMode's "
          f"{flops:.6e} (relative {rec['flop_rel']:.2e}); the trace's peak "
          f"{mode.peak_bytes / GIB:.3f} GiB (arguments {arg_bytes / GIB:.3f})"
          f", the card's {real_peak / GIB:.3f} GiB (ratio "
          f"{rec['peak_ratio']:.4f}); traced in {trace_s:.1f} s, the real "
          f"step {real_s:.2f} s", flush=True)
    check(rec["flop_rel"] < DRY_FLOP_RTOL, f"phase 15 (b): dot FLOPs "
          f"{mode.dot_flops} vs {flops}")
    check(abs(rec["peak_ratio"] - 1) < DRY_PEAK_RTOL, f"phase 15 (b): peak "
          f"{mode.peak_bytes} vs {real_peak}")
    return rec


def dryrun_vs_real_tp(real):
    """(b) phase 14 (b)'s tensor-parallel stablelm step traced as rank 0
    of a fake two-rank world on the same (1, 2) mesh, against the real
    rank 0's first step (``real``): dot FLOPs within 0.1 % of
    FlopCounterMode's, the collectives' calls by kind equal and their
    bytes within 0.1 %, the peak within 10 % of max_memory_allocated over
    what was allocated before the state."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = tp_config()
    with dryrun.fake_world(2):
        mesh = make_mesh(TP_SHAPE, ("data", "model"), device_type=DEV)
        got = dryrun.trace_cell(cfg, ShapeConfig(
            "tp", "train", tp_spec(cfg).seq_len, LM_BATCH), mesh,
                                {"mesh": "x".join(map(str, TP_SHAPE))},
                                device=DEV)
    check(got["status"] == "ok", f"phase 15 (b) tensor parallel: the trace "
          f"failed: {got.get('error')}")
    first = real["steps"][0]
    coll = {k: v for k, v in got["collectives"].items()
            if k != "total_bytes"}
    rec = dict(mesh=list(TP_SHAPE), trace_s=got["trace_s"],
               dot_flops=got["flops_per_device"],
               flop_counter_flops=real["flops"],
               flop_rel=abs(got["flops_per_device"] - real["flops"])
               / real["flops"],
               collectives=coll, real_collectives=first["by_kind"],
               peak_bytes=got["memory"]["peak_bytes"],
               argument_bytes=got["memory"]["argument_bytes"],
               real_peak_bytes=real["peak_bytes"],
               peak_ratio=got["memory"]["peak_bytes"]
               / max(real["peak_bytes"], 1))
    bytes_rel = {k: abs(coll[k]["bytes"] - v["bytes"]) / v["bytes"]
                 for k, v in first["by_kind"].items() if v["bytes"]}
    rec["bytes_rel"] = bytes_rel
    print(f"phase 15 (b) {LM_ARCH} ({TRAIN_LAYERS} layers) tensor parallel "
          f"on {TP_SHAPE}, rank 0: the trace's dot FLOPs "
          f"{rec['dot_flops']:.6e}, FlopCounterMode's "
          f"{rec['flop_counter_flops']:.6e} (relative {rec['flop_rel']:.2e});"
          f" collectives traced / real by kind "
          + ", ".join(f"{k} {coll[k]['count']} / {v['calls']} calls, "
                      f"{coll[k]['bytes']:.6g} / {v['bytes']:.6g} B"
                      for k, v in first["by_kind"].items() if v["calls"]
                      or coll[k]["count"])
          + f"; the trace's peak {rec['peak_bytes'] / GIB:.3f} GiB, the "
          f"rank's {rec['real_peak_bytes'] / GIB:.3f} GiB (ratio "
          f"{rec['peak_ratio']:.4f}); traced in {rec['trace_s']:.1f} s",
          flush=True)
    check(rec["flop_rel"] < DRY_FLOP_RTOL, f"phase 15 (b) tensor parallel: "
          f"dot FLOPs {rec['dot_flops']} vs {rec['flop_counter_flops']}")
    check(all(coll[k]["count"] == v["calls"]
              for k, v in first["by_kind"].items()),
          f"phase 15 (b) tensor parallel: collective calls {coll} vs "
          f"{first['by_kind']}")
    check(all(r < DRY_FLOP_RTOL for r in bytes_rel.values()),
          f"phase 15 (b) tensor parallel: collective bytes {bytes_rel}")
    check(abs(rec["peak_ratio"] - 1) < DRY_PEAK_RTOL, f"phase 15 (b) tensor "
          f"parallel: peak {rec['peak_bytes']} vs {rec['real_peak_bytes']}")
    return rec


def dryrun_vs_real_q3(real):
    """(b) phase 14 (b)'s zamba2 batch-of-one decode rank traced as rank 0
    of a fake two-rank world on the same (2, 1) mesh, against the real
    rank 0's first decode step (``real``): the collectives' calls and
    bytes by kind equal, the peak within 10 % of max_memory_allocated
    during the step over what was allocated before the serving model."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = q3_config(ZB_ARCH, ZB_LAYERS)
    with dryrun.fake_world(2):
        mesh = make_mesh(ZB_SERVE_SHAPE, ("data", "model"), device_type=DEV)
        got = dryrun.trace_cell(cfg, ShapeConfig(
            "zb", "decode", ZB_PROMPT + TP_DECODE, 1), mesh,
                                {"mesh": "x".join(map(str, ZB_SERVE_SHAPE))},
                                device=DEV)
    check(got["status"] == "ok", f"phase 15 (b) batch of one: the trace "
          f"failed: {got.get('error')}")
    first = real["first_decode"]
    coll = {k: v for k, v in got["collectives"].items()
            if k != "total_bytes"}
    rec = dict(mesh=list(ZB_SERVE_SHAPE), trace_s=got["trace_s"],
               collectives=coll, real_collectives=first["by_kind"],
               peak_bytes=got["memory"]["peak_bytes"],
               argument_bytes=got["memory"]["argument_bytes"],
               real_peak_bytes=first["peak_bytes"],
               peak_ratio=got["memory"]["peak_bytes"]
               / max(first["peak_bytes"], 1))
    print(f"phase 15 (b) {ZB_ARCH} ({ZB_LAYERS} layers) a batch of one's "
          f"decode step on {ZB_SERVE_SHAPE}, rank 0: collectives traced / "
          f"real by kind "
          + ", ".join(f"{k} {coll[k]['count']} / {v['calls']} calls, "
                      f"{coll[k]['bytes']:.6g} / {v['bytes']:.6g} B"
                      for k, v in first["by_kind"].items() if v["calls"]
                      or coll[k]["count"])
          + f"; the trace's peak {rec['peak_bytes'] / GIB:.4f} GiB "
          f"(arguments {rec['argument_bytes'] / GIB:.4f}), the rank's "
          f"{rec['real_peak_bytes'] / GIB:.4f} GiB (ratio "
          f"{rec['peak_ratio']:.4f}); traced in {rec['trace_s']:.1f} s",
          flush=True)
    check(all(coll[k]["count"] == v["calls"] and coll[k]["bytes"]
              == v["bytes"] for k, v in first["by_kind"].items()),
          f"phase 15 (b) batch of one: collectives {coll} vs "
          f"{first['by_kind']}")
    check(abs(rec["peak_ratio"] - 1) < DRY_PEAK_RTOL, f"phase 15 (b) batch "
          f"of one: peak {rec['peak_bytes']} vs {rec['real_peak_bytes']}")
    return rec


def phase_dryrun(seed, tp_real, q3_real):
    """Phase 15: the dry run on the card; see the module docstring.
    ``tp_real`` is phase 14 (b)'s tensor-parallel rank 0, ``q3_real`` its
    zamba2 batch-of-one serving rank 0.  Returns the {"dryrun": ...}
    record."""
    import shutil

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, "build", "phase15")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    try:
        rec = dict(sweep=dryrun_sweep(out_dir), step=dryrun_vs_real(seed),
                   tp_step=dryrun_vs_real_tp(tp_real),
                   batch_of_one=dryrun_vs_real_q3(q3_real))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rec["wall_s"] = time.perf_counter() - t0
    print(f"phase 15: {rec['wall_s']:.1f} s", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=80_000)
    ap.add_argument("--m64", type=int, default=20_000)
    ap.add_argument("--n64", type=int, default=16_000)
    # the Netflix Prize rating matrix: 480,189 users x 17,770 movies
    ap.add_argument("--sm", type=int, default=480_189)
    ap.add_argument("--sn", type=int, default=17_770)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    try:
        from repro_torch.kernels import _build
        card = smi_line()
        print(f"phase 1: card {card}", flush=True)
        t0 = time.perf_counter()
        logs = _build.build()
        print(f"phase 1: built {sorted(logs)} for sm_90a in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, log in logs.items():
            for line in ptxas_report(log):
                print(f"  {name}: {line}")
        spills = [line for log in logs.values() for line in ptxas_report(log)
                  if re.search(STREAM_KERNELS, line)
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        check(not spills, f"kernels spill registers: {spills}")

        A, s_true = make_operand(args.seed, args.m, args.n)
        gen = torch.Generator(device=DEV).manual_seed(args.seed + 2)
        errs = phase_kernels(gen, A)
        errs.update(phase_new_kernels(gen, A))
        phase_slice3_kernels(gen)
        phase_slice4_kernels(gen)
        batched_errs, batched_cases = phase_batched_kernels(gen, logs)
        launches, peak3, fact, walls3 = phase_main(A, s_true, args.seed)
        update_launches, _, _, drift = phase_update(fact, args.seed)
        del fact
        # phase 8 before phase 7, which edits A in place
        planned = phase_plan(A, args.seed, walls3, drift)
        launches["sketch_matmat"] = phase_sketch(A, s_true, args.seed, peak3)
        times = phase_times(A, args.seed)
        times.update(phase_times_new(A, args.seed))
        # phase 7 edits A in place: it comes after every other use of A
        (launches["scatter_add"], errs["scatter_add"],
         times["scatter_add"]) = phase_sketchres(A, args.seed, peak3, drift)
        del drift
        # the counting wrappers of phase 4 are classes made in a function,
        # so reference cycles keep their operand (A) until a collection
        del A, s_true
        gc.collect()
        torch.cuda.empty_cache()
        # phase 9: no earlier operand is alive; its stream holds two copies
        session_records = phase_session(args.seed, args.m, args.n, times)
        print(json.dumps({"session": session_records}, default=str))
        # phase 10: phase 9 has freed its operands
        print(json.dumps({"rsl": phase_rsl(args.seed)}))
        (launches["lowrank_matmul"], errs["lowrank_matmul"],
         times["lowrank_matmul"]) = phase_materialize(args.seed, args.m,
                                                      args.n)
        # the matvecs' main path is the f64 leg: its run gives their
        # launches, errors and times; the f32 1e5 x 8e4 figures stay
        # beside them for the comparison with mv_qtv / rmv_qtv
        f32_main = {name: dict(shape=f"{args.m}x{args.n} f32",
                               max_abs_err=errs[name],
                               **{k: v for k, v in times[name].items()
                                  if k != "nbytes"})
                    for name in MATVECS}
        f64_launches, f64_errs, f64_times = phase_f64(args.seed, args.m64,
                                                      args.n64)
        launches.update(f64_launches)
        errs.update(f64_errs)
        times.update(f64_times)
        torch.cuda.empty_cache()
        (launches["sparse_matvec"], errs["sparse_matvec"],
         times["sparse_matvec"], (reorth_launches, reorth_errs,
                                  reorth_times)) = phase_sparse(
            args.seed, args.sm, args.sn)
        launches.update(reorth_launches)
        errs.update(reorth_errs)
        times.update(reorth_times)
        gc.collect()
        torch.cuda.empty_cache()
        skewed = phase_skew(args.seed, args.sm, args.sn,
                            times["sparse_matvec"]["nnz"])
        # phase 11: the server, after every other phase has freed its
        # operands
        served = phase_serve(args.seed)
        print(json.dumps({"serve": served}, default=str))
        # phase 12: the distributed layer, after phase 11 has freed its
        # memory; a failure in a rank raises here
        local_rows, distributed = phase_distributed(
            args.seed, (args.m, args.n, args.m64, args.n64, args.sm,
                        args.sn, COMPRESS_SHAPE), walls3)
        print(json.dumps({"distributed": distributed}, default=str))
        # phase 13: the LM stack, after phase 12 has freed its memory
        lm = phase_lm(args.seed)
        print(json.dumps({"lm": lm}, default=str))
        # phase 14: the Trainer, the sharded steps and the CLIs
        trained = phase_train(args.seed, lm["olmoe"])
        print(json.dumps({"train": trained}, default=str))
        # phase 15: the dry run, after phase 14 has freed its memory
        print(json.dumps({"dryrun": phase_dryrun(
            args.seed, trained["tp"]["ranks"][0],
            trained["q3"]["zb"]["ranks"][0])}, default=str))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name in REPLACES:
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/csrc/{SOURCES[name]}",
                   replaces=REPLACES[name], launches=launches[name],
                   max_abs_err=errs[name], ms=times[name]["ms"],
                   plain_ms=times[name]["plain_ms"],
                   bound_ms=times[name]["bound_ms"],
                   bound_by=times[name]["bound_by"],
                   library_ms=times[name]["library_ms"])
        if "host_loop_ms" in times[name]:
            row["host_loop_ms"] = times[name]["host_loop_ms"]
        if name in MATVECS:
            row["shape"] = f"{args.m64}x{args.n64} f64"
            row["f32_main"] = f32_main[name]
        if name == "lowrank_matmul":
            row["shape"] = f"{args.m}x{args.n} r={R_WANT}"
            row["launches_update"] = update_launches
        if name == "sparse_matvec":
            row["shape"] = f"{args.sm}x{args.sn}, {RANK} blocks"
            row["calls"] = times[name]["calls"]
            row["skewed"] = skewed
        if name == "sketch_matmat":
            row["sector_floor_ms"] = times[name]["sector_floor_ms"]
            row["calls"] = times[name]["calls"]
        if name in ("qtv", "subtract_qc"):
            row["shape"] = f"Lanczos basis {args.sm}x{LANCZOS_K + 1} f32"
            row["calls"] = times[name]["calls"]
        if name in ("proj_qtv", "proj_norm"):
            row["shape"] = (f"Q side {args.m}x{MAX_ITERS + 1} f32, "
                            f"device time")
            row["device"] = times[name]["device"]
        if name in GK_STEP:
            # the stacked launches of solve_batched (phases 2 and 8)
            row["batched"] = dict(
                planned["stages"][name], B=list(BATCHES),
                trace=planned["trace"].get(name),
                trace_library=planned["trace"].get(f"{name} library"),
                cases=batched_cases, max_abs_err=batched_errs[name],
                max_abs_err_big=planned["big_errs"][name],
                bitwise_vs_single=True,
                launches_serve=planned["serve"]["launches"][name],
                launches_big=planned["big"]["launches"][name])
            if name in ("proj_qtv", "proj_norm"):
                # the pair on the P side's basis, and the traces of the
                # smaller stacks
                row["batched"]["p_side"] = dict(
                    planned["stages"][f"{name} P"],
                    trace=planned["trace"].get(f"{name} P"),
                    trace_library=planned["trace"].get(f"{name} P library"))
                row["batched"]["traces_by_batch"] = {
                    key: tr for key, tr in planned["trace"].items()
                    if key.startswith(name) and " B=" in key}
        if name in SERVE_KERNELS:
            row["launches_serve"] = served["launches"][name]
        if name == "scatter_add":
            row["shape"] = "phase 7 folds, mean of Y and Z"
            row["calls"] = times[name]["calls"]
            row["wide"] = times[name]["wide"]
        kernels.append(row)
    kernels.extend(local_rows[name] for name in LOCAL_KERNELS)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
