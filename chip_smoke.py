#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero, printing no
result) when it fails:

1. build: compiles every CUDA source of ``src/repro_torch/csrc`` with nvcc for
   sm_90a (in parallel) into ``build/repro_torch/`` and prints the seconds;
2. kernels against their plain PyTorch versions on the card, at the shapes
   the main path and the benchmarks give them (C also at the three shapes
   the main path's ``method="pallas"`` drive gives it, ``CAUCHY_MAIN_SHAPES``;
   D at 58+4 and 16+6 steps, ``SECULAR_STEPS``), each with its tolerance (see
   ``TOL``, ``CAUCHY_TOL``, ``SPARSE_TOL``, ``SECULAR_TOL``, ``NEAR_TOL``),
   two launches equal to the bit where the kernel promises it, and each
   check shown to reject planted faults; bf16 storage against the
   reference's ``BF16_ERROR_BUDGET``;
3. the main path: ``api.update_many`` / ``api.update`` with the default policy
   (auto -> fused kernels A and B) and with ``method="pallas"`` (kernel C),
   checked by reconstruction (f64) and against the same route on the CPU;
   then the structured-update path, four drives of ``api.apply`` /
   ``api.apply_many`` (``Sparse`` through kernel F, rank-1 steps through A and
   B, a ``Window`` downdate on the phase chain), each checked against the
   dense truth or the same route on the CPU; then the FMM route, five drives
   of ``api.update`` / ``api.update_many`` (``auto`` above the fused gate,
   and the README quickstart's ``method="fmm"``) whose near field is kernel
   E, each held to the same route on the CPU, to the card's ``direct`` and,
   for full states, to the dense truth, with the members whose FMM plan
   overflowed named.  Before each drive the launch counters are zeroed, after
   it they are read and held to the counts the planner gives
   (``DRIVE_LAUNCHES``);
3d. the streaming service, ``serve.SvdService`` (``service_inputs``): (s1)
   16 streams at the reference's serving shape m512 n768 r16, 8 rounds, f64
   and f32, under ``method="fused"`` (kernel B), ``"pallas"`` (C) and
   ``"direct"``, each with ``max_in_flight`` 0 and 2: async equal to sync to
   the bit, each route held to itself on the CPU; (s2) the same streams fed
   RankK, Sparse (F), AppendRows and Window events, saved halfway with events
   pending and restored from disk: the resumed service equal to the
   uninterrupted one to the bit, its first flush adding no engine-cache miss
   and building no library; (s3) 64 streams at m1024 n4096 r32 f32 flushed at
   B64, then ``merge_streams`` over all of them (6 levels), held to the
   stacked matrix's top-32 SVD (the same deployment in f64 at the
   reference's merge tolerance);
3e. the fleet tier, the batch mesh and the collectives (``fleet_inputs``):
   (f1) ``fleet.SvdFleet`` with 64 streams at m512 n768 r16 on 4 shards of the
   card (``devices="auto"``), continuous batching at ``max_depth`` 8, 32
   pairs and one Sparse (F) a stream under ``method="fused"`` (B), f64 and
   f32: every token visible after ``drain``, settle on 1 and on 4 shards equal
   to the bit, ``query`` over 8 streams equal to a single service's settle to
   the bit, f64 held to the route on the CPU, drain on 1 vs 4 shards reported;
   events/s, ms a round, the device share, host waits a round and B's and
   F's launches; a ``direct`` row at 16 streams; (f2) ``api.update_many`` at
   B = 13 on full f64 (32, 48) states (A) and m512 n768 r16 states (B), and
   the service, under a mesh of one and of four entries of the card: equal
   to the local call to the bit; (f3) ``dist.distributed_merge`` of four
   rank-32 shards at m1024 n4096 f64, one process a rank on the card: NCCL at
   world 1, gloo (CUDA tensors) at 2 and 4, every rank equal to the port's
   ``merge_tree`` to the bit, ``psum_factor`` / ``pmean_factor`` against the
   sums, ms of the merge and of the factor all-gather; (f4) the fleet saved
   with 8 pairs a stream pending and restored onto 2 shards: equal to the
   uninterrupted fleet to the bit, its first flush missing no cache;
4. times: median of CUDA-event timings after warm-up, for each kernel, its
   plain version and a PyTorch call that computes the same function (one
   batched ``torch.linalg.svd`` of the updated matrices for A and B,
   ``torch.sparse.mm`` on a CSR matrix for F, built outside the timing and,
   like for like with F's own bucketing, inside it; yardsticks the port never
   calls; none computes D's or E's function, and E is shown beside the
   einsum on a prebuilt ``near_inv`` as a reference point), beside a bound
   from bytes and operations; for E and F also the device time from
   ``torch.profiler`` (CUDA activity), for F the host time to enqueue a call
   and the walk on the plain bucketing (a PyTorch stable sort and
   ``searchsorted``, the bucketing kernel F used to take); for A and B the
   profiler's device time, the host time, the blocks an update (the cluster
   size); for C and D the device and host time, C's plan (targets a panel,
   blocks a panel) at each shape, and for D beside the bound a second one
   at the pipes it can use (``SECULAR_SASS``); each drive end to end; and
   the FMM route
   against ``method="pallas"`` (kernel C) and ``direct`` at (1024, 1024); and
   the service: ms a flush round by route and dtype at (s1) (CUDA events),
   the device's busy share of it (profiler); wherever the profiler hands back
   no device time three times running, the device time comes from CUDA events
   and says so; the host's waits for the device
   in a round (``torch.cuda.set_sync_debug_mode``), host µs an enqueue; save,
   restore and warm seconds at (s2); the (s3) round and merge;
(t) the training path, ``train.loop.train`` (no kernel of its own; ``TRAIN_*``;
   run right after the build, while the card's memory is empty):
   (t1) granite-34b at its published widths, 2 of its 88 layers, batch 1 x
   seq 4096, bf16 compute, remat "full": 6 AdamW steps, then 6 spectral-Adam
   steps (rank 32, a refresh every 4), each from its own init; finite
   losses, the first within 1 of ln(vocab); ms a step split into forward and
   backward, the trackers' update, the refresh and the rest of the optimizer
   (the program's own spans, timed on the card), peak memory against ``moment_memory_ratio``,
   the device's busy share of a step (profiler) and its host waits (none in
   an AdamW step that neither logs nor saves: a check); (t2) the card
   against the port on the CPU at the smoke config, AdamW and spectral-Adam,
   with planted faults (bias correction dropped, weight decay dropped, a
   tracker update skipped); (t3) a run resumed at step 3 of 6 equal to the
   uninterrupted one to the bit under deterministic algorithms, and a
   spectral-Adam resume raising the reference's ``ValueError``; (t4)
   ``examples/train_lm.py``'s repro-tiny run, 60 steps: the loss falls;
   (t2) also holds rwkv6-1.6b's smoke config (AdamW) card vs CPU; (t5)
   rwkv6-1.6b at full width and depth through ``train`` (4 AdamW steps, b 1
   x seq 4096) and whisper-base's ``train_loss`` + backward + AdamW at seq
   1500, b 8 (frames (8, 1500, 512)): ms a step, forward and backward, the
   device share, host waits (0: a check), peak memory; ``train`` on whisper
   raising the reference's ``KeyError: 'frames'``.
(g) token serving, ``serve.engine.generate`` over ``ModelApi.prefill`` /
   ``decode_step`` (no kernel of its own; ``SERVE*``; run after (t)): (g1)
   deepseek-v2-lite-16b (MLA + MoE) at full width, 8 of its 27 layers; (g2)
   zamba2-7b (the Mamba2 hybrid) at full width and depth; (g3) qwen1.5-32b
   (dense MHA, QKV bias), 2 of 64 layers; each greedy on b 8 prompts of 1024
   tokens, 32 new: two runs equal to the bit under deterministic algorithms,
   tokens in the vocabulary, 0 host waits a decode step (a check); prefill
   ms, ms a decode token, tokens/s, the device's busy share of a step
   (profiler) and its kernels by kind, peak memory, the cache's GiB, the
   time of one cast of the matrix parameters to bf16; the prefill's last
   logits and three teacher-forced decode steps against the forward over
   1152 tokens in f32 compute (the MoE router dropless), with planted faults
   rejected (the cache written at pos - 1, the decode mask < pos, MLA's
   k_rope cached before RoPE; the hybrid's conv buffer not shifted, its
   decay dropped); decode_32k rows (seq 32768, b 8) on zero caches from the
   decode specs (bf16; (g3) also int8); (g3) int8 ``generate`` raising the
   reference's TypeError and 64 tokens decoded from zero int8 and bf16
   caches agreeing at the 65th; (g5) rwkv6-1.6b and (g6) whisper-base at
   full width and depth through ``prefill`` + ``decode_step`` (``generate``
   raises the reference's TypeError for both: a check): (g5) b 8 prompts of
   1024 tokens and 32 greedy tokens, (g6) b 8 x 1500 frames, a 4-token
   decoder prompt, ``max_dec_len`` 448 and 64 greedy tokens; the same checks
   and figures as (g1)-(g3) plus the launches a step, the state's or the
   caches' MiB, and A-F's launches on the path (0); consistency in f32 with
   planted faults ((g5) the token shift not carried, the decay or the u
   bonus dropped; (g6) the self cache written at pos - 1, every layer
   reading layer 0's cross K/V, the sinusoid taken at pos - 1); (g5) the
   chunked WKV against the recurrence at full width over the prompt, and
   the decode_32k (b 128) and long_500k (b 1) rows from zero states; (g4)
   the card against the port on the CPU at seven smoke configs (tokens
   greedy and sampled through ``generate``, or greedy through ``prefill`` +
   ``decode_step`` for RWKV and whisper; logits; a planted fault) and the
   threefry bits equal.
(m) the model side of sharding and the launch tier (no kernel of its own;
   ``SHARD*``; run after (g)): (m1) (t1)'s model (granite-34b at its
   published widths, 2 layers, bf16 compute, remat "full", AdamW) under a
   (4, 2) ``make_host_mesh`` of the card: ``train_step`` at b 4 x seq 1024
   against the mesh-less step on one batch (the loss and the parameter
   update beside their limits), the check shown to reject the slices summed
   rather than averaged and one slice dropped; then ``train(mesh=)`` at b 4 x
   seq 4096: ms a step, the forward-and-backward share, peak memory, host
   waits (0: a check), and whether the mesh-less step fits there; (m2)
   ``reshard`` of (m1)'s host tree onto ``plan_mesh()``: equal to the bit,
   its seconds; (m3) the dry-run of perf_iter's three LM cells on the 16 x
   16 meta mesh (three terms, useful FLOPs), and the compute term of (t1)'s
   own configuration on one card held under (t1)'s measured step; (m4)
   ``perf_iter --svd``'s cells on the card (FLOPs, bytes, useful ratio,
   seconds); A-F's launches over the phase (0: a check); the split
   kernel's launches over (m1)'s ``train(mesh=)`` (its bf16 backward).
(s) the split kernel S (``kernels.split_bf16x3``: ``split_bf16x3`` and
   ``repeat_bf16x3``, no TPU kernel; run after (m)) at the shapes the bf16
   backward gives it at (t1)'s widths (``SPLIT_SHAPES``): granite's score
   cotangent (1, 48 x 4096, 4096) and its MLP input matrix's cotangent
   (4096, 24576), each split in 512-term chunks along either axis, and the
   bf16 operands laid out beside them; each against its plain version bit
   for bit (NaN where the plain version has NaN; special values planted),
   its ms, the plain version's and its bytes bound (10 B an element split,
   8 B repeated, at 3.35 TB/s).  The ``kernels`` line's S row.
(x) the port's four examples (``examples/*_torch.py``), each through its
   ``main`` at the reference's defaults, last: the quickstart (E), the
   streaming SVD's five parts (B), compressed DP in a gloo world of 8 ranks
   on the card (B, counted in the ranks) and train_lm at repro-tiny, then
   its repro-100m configuration (through the example's ``run_config`` and
   ``train``) for 20 steps resumed to 30 and held to the bit against an
   unbroken run; each example's self-checks raise, its seconds, figures and
   A-F's launches are printed and held to its route (``X_ROUTES``).  The
   ``kernels`` line's launches include phase (x)'s.  Each phase prints its
   seconds.


The last lines are the ``kernels`` JSON line, the card (nvidia-smi), and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks from NVIDIA's data sheet: HBM3 bandwidth; f32 outside the
# tensor cores (TF32 would not hold the f32 results), and f64 on the DMMA
# tensor cores, which compute at full f64 precision (kernel E contracts on
# them in f64; the other kernels use the CUDA cores), so the bound is the least
# time the card could take.
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 67e12}
N_BISECT, N_NEWTON = 16, 6
DEVICE = "cuda"
# the key of a device time taken with CUDA events when torch.profiler saw none
EVENTS_KEY = "(CUDA events: the profiler saw no device time)"

# Kernel against its plain version on the same inputs, on data with no
# dominant singular value (see ``spectrum``), by two scale-free measures
# taken per update and maximised over the batch:
#   recon  ||U S V^T - U' S' V'^T||_F / ||U' S' V'^T||_F
#   sigma  max_i |s_i - s'_i| / s'_i
# Each limit sits above the readings of the sound kernel on the H100
# (PERF.md) and below what a planted fault gives: each check is also run on
# the kernel's output with the right factor left unrotated, and with the
# sign of U's column of the largest and of the smallest singular value
# flipped, and must reject them.  The one exception is kernel A in float32 at
# (256, 320): there the route itself (the reference's as much as the port's)
# does not determine its smallest triplets -- one float32 rounding of the
# inputs rotates them or flips their signs, moving ``recon`` by up to 1e-2
# (printed beside the check as the route's own sensitivity) -- so its limit
# is that sensitivity's size and the smallest triplet's sign is not required.
TOL = {("A", "float64"): {"recon": 1e-10, "sigma": 1e-10},
       ("B", "float64"): {"recon": 1e-10, "sigma": 1e-10},
       ("A", "float32"): {"recon": 5e-2, "sigma": 2e-3, "smallest_sign": False},
       ("B", "float32"): {"recon": 1e-3, "sigma": 1e-4},
       ("A", "bfloat16"): {"recon": 3e-3, "sigma": 1e-2}}
# the main path on the card against the same route on the CPU (plain
# versions), same inputs and measures; f64 is also held to the reference's
# own limit against A + a b^T: max |U S V^T - (A + a b^T)| / sigma_max
MAIN_TOL = {"float64": {"recon": 1e-10, "sigma": 1e-10},
            "float32": {"recon": 5e-3, "sigma": 1e-4}}
F64_RECON_LIMIT = 1e-10
# the Cauchy product against its plain version, relative to max |out|: N
# products summed in another order
CAUCHY_TOL = {"float64": 1e-12, "float32": 1e-5}
# (B, k) of the products method="pallas" gives kernel C on the main path
# (R = N = M = k; counted on the CPU through a spy on
# kernels.ops.cauchy_matmul_stable): the full update at (128, 192) B4 makes
# four at k = 128 and four at k = 192, the truncated one at r 16 B16 eight at
# k = 17
CAUCHY_MAIN_SHAPES = ((4, 128), (4, 192), (16, 17))
# the sparse projection against its plain version, relative to max |out|: each
# row's terms are summed in the same (entry) order on the kernel's side, so
# only the rounding of the fused multiply-add differs (the plain version's
# index_add_ on the card adds in an order of its own, ~10 terms per row)
SPARSE_TOL = {"float64": 1e-13, "float32": 1e-5}
# the structured-update drives on the card against the same route on the CPU,
# by the measures of TOL.  Drives 1 and 3 (an exact sketch, a downdate) and
# drive 2x (drive 2's states and steps with a Sparse in the sketch's exact
# regime) hold 1e-10 in f64.  Drive 2 sketches a 1 % random COO delta (rank
# ~1000) at rank 8, outside the exact regime, where the reference's
# single-pass core solve amplifies rounding (sigma_max 28779 where the
# truth's is 99): the port and the reference differ there by 1.3e-7 in f64,
# and in f32 by 1.9e-3 after the Sparse step and 9e-2 after the RankK
# (tools/port_vs_reference.py, ROADMAP queue C).  Limits sit above the
# H100's card-vs-CPU readings (PERF.md) and the route's own sensitivity to
# one rounding of its inputs (tools/port_vs_reference.py), below faults: besides
# those of TOL, the stage's last rank-1 component dropped and one member's
# largest triplet turned by 0.5 rad.  Where the route's own f32 noise exceeds
# a dropped RankK pair, that fault is not required, nor is the smallest
# triplet's sign in f32: in drive 2 the pair moves recon by 2.7e-2 and one
# rounding of the inputs by up to 0.13; in drive 2x the Sparse step leaves a
# cluster of close singular values, among which the f32 route turns vectors
# by rounding (f32 vs f64 up to 0.24, port vs reference 6.4e-2;
# tools/port_vs_reference.py), as large as the pair's 6.4e-2.
DRIVE_TOL = {"exact": {"recon": 1e-10, "sigma": 1e-10},
             ("sparse", "float64", "sparse"): {"recon": 5e-6, "sigma": 5e-6},
             ("sparse", "float64", "rank_k"): {"recon": 5e-6, "sigma": 5e-6},
             ("sparse", "float32", "sparse"): {"recon": 2e-2, "sigma": 2e-3, "smallest_sign": False},
             ("sparse", "float32", "rank_k"): {"recon": 0.25, "sigma": 1e-2, "smallest_sign": False,
                                               "dropped": False},
             ("sparse_exact", "float64", "sparse"): {"recon": 1e-10, "sigma": 1e-10},
             ("sparse_exact", "float64", "rank_k"): {"recon": 1e-10, "sigma": 1e-10},
             ("sparse_exact", "float32", "sparse"): {"recon": 2e-3, "sigma": 3e-4, "smallest_sign": False},
             ("sparse_exact", "float32", "rank_k"): {"recon": 0.15, "sigma": 5e-3, "smallest_sign": False,
                                                     "dropped": False}}
# drive 1 against the dense truth, |U S V[:, :m]^T - T| and |s - s_T| over
# sigma_max.  The sketch is exact there (1.9e-14 from S); the rank-1 steps
# fed S's exact top-8 SVD read 9.8e-9 (fused; direct 1.5e-8; the reference's
# fused 9.8e-9).  The error enters at the sixth step on 2 of the 128 members:
# the deflation rule |rho| z_i^2 <= 64 eps scale (reference
# core/secular.py:107), second order in z, drops a z component of 5.2e-6 from
# the second left eigen-update, which turns a well-separated left vector by
# 1.7e-6 rad; with the tolerance at 1e-20 the step reads 3.6e-15
# (tools/port_vs_reference.py --part drives, ROADMAP queue C).  One rounding
# of the inputs moves the drive's result by 8.6e-14 (recon) and 7.9e-13
# (sigma), so the reading is the route's, not noise: the limit sits 10x above
# it and below the planted faults; the card is held to the CPU route at 1e-10
# besides.
DRIVE1_TRUTH_LIMIT = 1e-7
# launches each drive must make, reckoned from the planner's schedules:
# (1) one batched Sparse of rank 8 on a stacked full state: 2 batched
#     projections, 8 rank-1 steps on kernel A;
# (2), (2x) per dtype, apply_many of Compose(Decay, Sparse rank 8) on 16
#     members (each member sketches its own op: 2 projections each) and then
#     of RankK(k=32) (one rank-k step: 32 batched launches of B): 64 F and 80
#     B over both dtypes;
# (3) Window on truncated states: remove steps pin the phase chain, no kernel.
# (3c) the FMM drives: every call runs 4 applies of each side's two eigen-plans
#      (q1, q2, the materialised Q of the first plan, G), each side has n >= 96
#      poles, and sign_fix is on: 8 batched launches of kernel E per call,
#      none of any other kernel (the secular solve of the route is the plain
#      core solver, as in the reference; kernel D is reached only through
#      kernels.ops.secular_solve).
_NONE = {"sparse_project": 0, "fused_update": 0, "fused_update_truncated": 0,
         "cauchy_matmul": 0, "secular_solve": 0, "nearfield": 0}
# the ports of the TPU kernels; split_bf16x3 and repeat_bf16x3 (no TPU kernel)
# run in every bf16 backward on the card and are held to no route here
A_TO_F = tuple(_NONE)
SPLIT_KERNELS = ("split_bf16x3", "repeat_bf16x3")
_FMM_CALL = {**_NONE, "nearfield": 8}
DRIVE_LAUNCHES = {
    "1 full exact": {**_NONE, "sparse_project": 2, "fused_update": 8},
    "2 truncated": {**_NONE, "sparse_project": 64, "fused_update_truncated": 80},
    "2x truncated exact": {**_NONE, "sparse_project": 64, "fused_update_truncated": 80},
    "3 window": _NONE,
    "i fmm single": _FMM_CALL,
    "ii fmm batched": _FMM_CALL,
    "iii quickstart": _FMM_CALL,
    "iv truncated r127": _FMM_CALL,
    "v fmm spread squares": _FMM_CALL,
    # (3d) the service drives, counted on the CPU through spies on the
    # wrappers (kernels.ops, updates.sketch.sparse_project) at the same inputs:
    # s1 fused: 8 rounds x 2 dtypes x 2 in-flight depths, one B launch a round;
    # s1 pallas: 8 Cauchy products (C) a truncated update; s1 direct: none;
    # s2: the uninterrupted service, the saved one's first half and the
    # resumed one's second half (B for rounds and for the ops' rank-1 steps;
    # F 2 a Sparse expansion, 8 + 8, and 2 for the restore's warming of the
    # sparse sketch); s3: 4 rounds at B64, then 6 merge levels of 32 rank-1
    # steps each, in float32 and again in float64
    "s1 fused": {**_NONE, "fused_update_truncated": 32},
    "s1 pallas": {**_NONE, "cauchy_matmul": 256},
    "s1 direct": _NONE,
    "s2 failover": {**_NONE, "fused_update_truncated": 152, "sparse_project": 18},
    "s3 B64 and merge": {**_NONE, "fused_update_truncated": 392},
}
# kernel D against its plain version: max |tau - tau'| over the widest
# bracket (each root's terms summed in another order; the reference's own
# test holds 1e-14 and 1e-5 absolute on brackets no wider than 0.5).  The
# planted faults: every member's heaviest pole dropped, and one Newton step
# too few, read on the roots that hug their poles at 4 bisection steps, where
# the Newton steps carry the solve (after 58 the bisection alone converges).
SECULAR_TOL = {"float64": 1e-13, "float32": 1e-5}
# kernel D's step counts: the default (kernels/secular_newton.py) and the
# fused route's (N_BISECT, N_NEWTON)
SECULAR_STEPS = ((58, 4), (16, 6))
# kernel D's instructions a pole term on its arithmetic pipe, read from
# cuobjdump -sass of its build (tools/cauchy_secular_probe.py --sass): a
# bisection term DADD (the difference) + 3 DFMA (the reciprocal's correction)
# + DFMA (the sum), a Newton term DADD + 3 DFMA + DMUL + DADD + DFMA; in f32
# the same on FADD / FFMA / FMUL with one correction of 2 FFMA; one MUFU
# (RCP64H, RCP) a term; "lanes" the pipe's lanes a clock an SM
SECULAR_SASS = {"float64": {"bisect": 5, "newton": 7, "lanes": 64},
                "float32": {"bisect": 4, "newton": 6, "lanes": 128}}
# kernel E against its plain version, relative to max |out|: 3cap products
# summed in another order.  Planted faults: the invalid source slots left
# unmasked, and the sign of tau flipped.
NEAR_TOL = {"float64": 1e-12, "float32": 1e-5}
# the FMM drives on the card against the same route on the CPU and against
# the card's own method="direct", by the measures of TOL (v[:, :m]).  Drive
# (v) is the exception.  Its route (reference and port alike) decides some
# steps by thresholds its data sits close to: the port and the reference on
# the CPU differ there by 1.19e-10 (recon) and 2.25e-8 (sigma), the card and
# the CPU by 1.10e-10 and 2.03e-8 (H100 run), while one rounding of the
# inputs moves recon by only 9.5e-13 and sigma by 7.1e-10, and a deflation
# tolerance twice the default moves two of the eight members by up to 1.7e-6
# (tools/port_vs_reference.py --part fmm; the CPU).  Its limits sit above the
# two implementations' distance and below the planted faults; its FMM
# against its own direct route reads ~3e-14 (CPU), and the truth check below
# holds it besides.
FMM_TOL = {"recon": 1e-10, "sigma": 1e-10}
FMM_TOL_V = {"recon": 1e-9, "sigma": 1e-7}
# (i), (ii), (iii), (v) against the dense truth: max(|U S V[:, :m]^T - T|,
# |s - s_T|) over sigma_max(T), the largest over the members:
# (reference reading, limit).  The readings are the reference's on the CPU on
# the same inputs (tools/port_vs_reference.py --part fmm; the port's CPU
# route reads the same to 3 digits); the limits sit just above them.  (i) and
# (ii) are the squared route's own error on uniform(1, 9) data (every FMM
# plan there overflows, so it is the dense product's; direct reads the same),
# (iii) is exact, (v) (where the FMM runs) reads 5.4e-9.
# the service drives (phase 3d): the reference's serving shape
# (benchmarks/bench_serve.py:56-58: 16 streams, m512 n768 r16) and a larger
# deployment (64 streams at m1024 n4096 r32, about 42 MB of float32 factors)
SERVE_S1 = {"streams": 16, "m": 512, "n": 768, "r": 16, "rounds": 8}
SERVE_S3 = {"streams": 64, "m": 1024, "n": 4096, "r": 32, "rounds": 4}
SERVE_METHODS = ("fused", "pallas", "direct")
# (s1), (s3): the card's service against the same route on the CPU after all
# its rounds: float64 max |U S V^T - U' S' V'^T| and |s - s'| over sigma_max;
# float32 by TOL's scale-free measures.  (s2) per group of streams: 1e-10 by
# TOL's measures, the Sparse streams at drive 2's limit (the sketch is
# outside its exact regime there: a 1 % random COO delta at rank 8).  The
# merge of (s3) against the stacked matrix's top-32 SVD: ten times the
# merge's noise floor sqrt(eps) sigma_max, the rule behind the reference's own
# tolerance (1e-6 against a ~1e-7 floor in float64, tests/test_dist_merge.py);
# the same deployment in float64 at the reference's 1e-6.  Both relative, on
# the singular values, both subspaces and the reconstruction against the
# stacked matrix's rank-32 truncation.
SERVE_F64_LIMIT = 1e-10
SERVE_F32_TOL = {"recon": 1e-2, "sigma": 2e-3}
SERVE_S2_TOL = {"RankK": {"recon": 1e-10, "sigma": 1e-10},
                "Sparse": {"recon": 5e-6, "sigma": 5e-6},
                "AppendRows": {"recon": 1e-10, "sigma": 1e-10},
                "Window": {"recon": 1e-10, "sigma": 1e-10}}
SERVE_MERGE_LIMIT = 10 * 2.0 ** -11.5
SERVE_MERGE_F64_LIMIT = 1e-6
FMM_TRUTH = {"i": (3.33e-7, 5e-7), "ii": (2.16e-7, 3e-7), "iii": (4.59e-14, 1e-13),
             "v": (5.38e-9, 1e-8)}
# the fleet and mesh phase: (f1) 64 streams at the reference's serving shape
# (bench_serve.py:56-58, m512 n768 r16) across 4 shards of the one card,
# continuous batching at max_depth 8, 32 pairs a stream and one Sparse (256
# entries in 8 rows, rank 8: the sketch's exact regime) after the 16th, a pump
# every 64 admissions; a direct row at 16 streams, 8 pairs each (a direct
# round costs ~120 ms, PERF.md); (f2) the mesh rows at B = 13 (padding on a
# four-entry axis); (f3) distributed_merge of four rank-32 shards at m1024
# n4096, f64, row blocks of one rank-32 matrix; (f4) the fleet saved with 8
# pairs a stream pending, restored onto 2 shards
FLEET = {"streams": 64, "m": 512, "n": 768, "r": 16, "pairs": 32, "sparse_after": 16,
         "sparse_nnz": 256, "shards": 4, "max_depth": 8, "pump_every": 64,
         "direct_streams": 16, "direct_pairs": 8, "pending_from": 16, "pending_to": 24}
MESH_B = 13
MERGE_F3 = {"shards": 4, "m": 1024, "n": 4096, "r": 32}
# phase (t), the training path: (t1) granite-34b at its published widths
# (src/repro_torch/configs/granite_34b.py: d_model 6144, 48 heads with one KV
# head, head_dim 128, d_ff 24576 swiglu, vocab 49152, bf16 compute, f32
# params, remat "full"), its 88 layers cut to 2 by one card's memory, batch 1
# x seq 4096 (SHAPES["train_4k"]'s sequence; its batch of 256 cut to 1);
# spectral-Adam at rank 32 with a refresh every 4 steps
TRAIN_ARCH = "granite-34b"
TRAIN_LAYERS = 2
TRAIN_SEQ = 4096
TRAIN_STEPS = 6
TRAIN_RANK = 32
TRAIN_REFRESH = 4
# the first loss of a random init: within 1 of ln(vocab), as the reference's
# tests/test_models.py bounds a smoke model's
TRAIN_FIRST_LOSS_SLACK = 1.0
# (t2) the card against the port on the CPU at granite-34b's smoke config (3
# layers, d 64, f32; TF32 off): 4 steps each of AdamW and spectral-Adam (rank
# 8, no refresh), from one init, lr 1e-2 from the first step.  Relative max
# differences: the losses, and each parameter leaf over its largest entry.
# Two f32 implementations sum in other orders, and Adam's update is nearly
# the sign of each gradient entry, so an entry rounded to the other sign
# moves its parameter by 2 lr: the port and the reference on the CPU read
# 1.1e-6 (losses) and 2.8e-3 (parameters) here, against which the limits sit
# 9x and 3.6x above; the planted faults read 3.7e-4 and up (losses) and 5e-2
# and up (parameters) in a CPU rehearsal, 37x and 5x above the limits.  The
# trackers are not compared: a zero singular value leaves its pair free
# (ROADMAP queue C)
TRAIN_T2 = {"steps": 4, "rank": 8, "lr": 1e-2, "loss": 1e-5, "params": 1e-2}
# (t2) again in bf16 compute, (t1)'s dtype: the first step's loss and
# gradients from one init, and the losses of 4 AdamW steps.  A bf16 rounding
# that one side takes to the other neighbour moves what follows by a bf16
# ulp: the port and the reference on the CPU read 1.4e-5 (loss) and 7.4e-3
# (gradients, of each leaf's largest entry; one bf16 ulp is 2**-8 to 2**-7)
# for one step, and 5.4e-5 on the losses of 4 steps, against which the limits
# sit 7x, 2.1x and 18x above.  The parameters are not compared: after 4 Adam
# steps those two part by 0.34 of a leaf's largest entry (a gradient entry
# near 0 takes the other sign, and Adam moves it by lr either way)
TRAIN_T2_BF16 = {"loss": 1e-4, "grads": 2.0 ** -6, "losses": 1e-3}
# (t4) examples/train_lm.py's default run (repro-tiny, batch 8, seq 128,
# lr 1e-3, warmup 20), 60 steps of AdamW: the loss must fall
TRAIN_T4 = {"steps": 60, "batch": 8, "seq": 128}
# (t5) rwkv6-1.6b at full width and depth (1.58 B parameters) through
# train.loop.train, AdamW, 4 steps at batch 1 x seq 4096 (train_4k's
# sequence, its batch of 256 cut to 1 by one card, as (t1)); whisper-base's
# train_loss + backward + AdamW on the registry's train specs at seq 1500,
# b 8 (frames (8, 1500, 512) bf16, decoder tokens (8, 375))
TRAIN_T5 = {"rwkv": "rwkv6-1.6b", "steps": 4, "seq": 4096, "batch": 1,
            "encdec": "whisper-base", "enc_seq": 1500, "enc_batch": 8}

# phase (g), token serving (serve.engine.generate over ModelApi.prefill /
# decode_step; no kernel of A-F on the path), each model built at its
# published widths (src/repro_torch/configs/*), f32 parameters, bf16 compute:
# (g1) deepseek-v2-lite-16b (MLA r512 rope64 nope128 v128, MoE 64 routed + 2
# shared top-6, d_ff_expert 1408, vocab 102400), its 27 layers cut to 8 by
# the phase's memory and time (~5.1 B parameters); (g2) zamba2-7b (81 Mamba2
# layers, d 3584, d_state 64, 112 SSM heads, the shared block every 6) at
# full depth (~6.75 B); (g3) qwen1.5-32b (dense MHA with QKV bias, d 5120, 40
# heads, d_ff 27392, vocab 152064), 64 layers cut to 2 (~2.6 B).  generate
# greedy on b 8 prompts of 1024 tokens, 32 new tokens (max_len 1056); the
# decode_32k rows at SHAPES["decode_32k"]'s sequence, its batch 128 cut to 8
SERVE = {"g1": ("deepseek-v2-lite-16b", 8), "g2": ("zamba2-7b", None),
         "g3": ("qwen1.5-32b", 2), "batch": 8, "prompt": 1024, "new": 32, "extra": 128,
         "long": 32768, "timed_steps": 8, "int8_steps": 64}
# consistency: the prefill's last logits and three teacher-forced decode
# steps (positions prompt .. prompt + 2) against the full forward over the
# prompt + 128 tokens on the card, max |delta logits| / max |logits| at each
# position, the worst.  Run in float32 compute (TF32 off): in bf16 one
# rounding that the two paths take to other neighbours moves the logits by
# ~1e-2, above what one cache entry or one masked key moves them at 1024
# keys (attention near uniform at a random init).  The MoE router dropless,
# as the reference's own test makes it (capacity_factor = n_routed / top_k).
# Limit above the readings, below each planted fault (PERF.md):
SERVE_CONSIST = 1e-4
# (g3) int8 against bf16 caches after 64 tokens decoded from zero caches:
# the reference's own limit (tests/test_models.py:221-224) and equal argmax
SERVE_INT8 = 0.05
# (g4) the card against the port on the CPU at the smoke configs, f32
# compute, TF32 off: the prefill's and 3 decode steps' logits, relative to
# the largest logit (two devices summing in other orders), and the tokens
# equal; a planted fault (the cache written at pos - 1) must exceed it
SERVE_G4_ARCHS = ("granite-34b", "qwen2-72b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
                  "zamba2-7b")
SERVE_G4_TOL = 1e-5
# a decode step's kernels by kind, from the profiler's kernel names (the
# first kind whose words a name holds): cuBLAS's Hopper products are "nvjet"
# kernels
SERVE_KERNEL_KINDS = (("products", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")),
                      ("copies and casts", ("copy", "convert")),
                      ("softmax and reductions", ("softmax", "reduce")))

# (g5) rwkv6-1.6b (src/repro_torch/configs/rwkv6_1_6b.py: 24 layers, d 2048,
# d_ff 7168, vocab 65536, head 64, decay LoRA 64, chunk 64) and (g6)
# whisper-base (whisper_base.py: 6 encoder and 6 decoder layers, d 512, 8
# heads, d_ff 2048, vocab 51865 padded to 51968), each at full width and
# depth (1.58 B and 97 M parameters fit one card whole), f32 parameters,
# bf16 compute, through prefill + decode_step (generate raises for both, as
# in the reference).  (g5): b 8 prompts of 1024 tokens and 32 greedy tokens;
# the decode rows from zero states of the decode specs at
# SHAPES["decode_32k"] (its full batch of 128: the state is O(1)) and
# SHAPES["long_500k"] (b 1).  (g6): b 8 x 1500 frames (Whisper's 30-second
# encoder context) in bf16, a 4-token decoder prompt (the
# start-of-transcript sequence), max_dec_len 448 (Whisper's text context),
# 64 greedy tokens.  Consistency as (g1)-(g3), over prompt + 128 tokens.
SERVE_FAMILIES = {
    "g5": {"arch": "rwkv6-1.6b", "batch": 8, "prompt": 1024, "new": 32, "extra": 128,
           "timed_steps": 8, "rows": (("decode_32k", 32768, 128), ("long_500k", 524288, 1))},
    "g6": {"arch": "whisper-base", "batch": 8, "frames": 1500, "prompt": 4, "max_dec_len": 448,
           "new": 64, "extra": 128, "timed_steps": 8, "rows": ()},
}
# (g5) the chunked WKV against the recurrence on the same full-width inputs
# (layer 0 over the 1024-token prompt, f32), max |delta| over the largest
# value, of y and of the final state: the CPU reads 3.3e-7 and 5.7e-7 at b 1
# on a random init (the recurrence against float64 1.5e-7), the decay
# dropped from the recurrence 8.0 and 11.2
RWKV_CHUNK_TOL = 1e-5
# (g4) the families that serve through prefill + decode_step, and their
# planted fault
SERVE_G4_FAMILIES = {"rwkv6-1.6b": "the decay dropped from the recurrence",
                     "whisper-base": "the self cache written at pos - 1"}

# one world at a time, in this order: NCCL can take one rank a card, gloo
# stages CUDA tensors through the host
MERGE_WORLDS = (("nccl", 1), ("gloo", 2), ("gloo", 4))

# phase (m), the model side of sharding and the launch tier (no kernel of A-F
# on the path).  (m1) (t1)'s model (granite-34b at its published widths, 2
# of 88 layers, bf16 compute, remat "full", AdamW) under a (4, 2)
# make_host_mesh of the card: one step of train_step at global batch 4 x seq
# 1024 (the mesh-less step fits there too) against the mesh-less step on the
# same batch from one init, lr 1e-4 from the first step; then train(mesh=) at
# batch 4 x seq 4096 (SHAPES["train_4k"]'s sequence; its batch of 256 cut to
# 4, one sequence a data entry), 3 steps.  The check's measures: the loss
# |delta| / |loss|, and the parameter update's ||p_mesh - p|| / ||p - p0||
# over all leaves (Adam's update is nearly the sign of each gradient entry,
# so a gradient entry the two steps round to other signs moves by 2 lr: a
# max |delta| does not tell a fault from rounding, the update's norm does).
# The limits sit between the readings on the H100 (PERF.md): the sound
# step read loss 0 and update 2.7e-2 (each slice rounds its weight gradients
# to bf16 on its own, and Adam turns an entry whose slices nearly cancel to
# either sign); the slices summed read loss 3.0 (update 2.7e-2: Adam does not
# see a scale), one slice dropped loss 0.25 and update 0.75
SHARD = {"mesh": (4, 2), "batch": 4, "seq_check": 1024, "seq": 4096, "steps": 3, "lr": 1e-4}
SHARD_TOL = {"loss": 1e-3, "update": 0.1}
# (m3) perf_iter's three LM cells on the 16 x 16 production mesh of the meta
# device, and (t1)'s own configuration (2 layers, b 1 x seq 4096) on one card
SHARD_CELLS = (("qwen2-72b", "train_4k"), ("deepseek-v2-lite-16b", "prefill_32k"),
               ("qwen1.5-32b", "decode_32k"))
# (m4) perf_iter's fleet cells up to this depth: the B8 m64 n96 r8 k32 cell
# (3.2-7.2 s a flush on the phase chain, counted and then timed, no kernel of
# A-F) is left out to make room for phase (x); its k8 twin keeps the geometry
M4_MAX_DEPTH = 8


def log(*args):
    print(*args, flush=True)


def drive_inputs(seed: int = 1) -> dict:
    """The numpy inputs of the structured-update drives, from one seed
    (``tools/port_vs_reference.py`` runs the same inputs through the
    reference on the CPU).

    1. 128 full states at (32, 48): random orthogonal factors, singular values
       100 .. 1 geometric; one batched COO delta per member whose 96 entries
       lie in 8 rows (rank <= 8), with a duplicate coordinate and 8 padding
       entries (0, 0, 0.0); sketched at rank 8.
    2. 16 rank-16 states at (1024, 1024) of the same kind; per member a 1 %
       random COO delta (10485 entries) at rank 8 after a decay of 0.99, then
       a RankK of k = 32 with N(0, 0.01) entries.  ``sparse_exact``: per
       member 2048 entries in 8 rows (rank <= 8: the sketch's exact regime),
       for the same two steps on the same states.
    3. 4 rank-8 states at (1024, 768) of the same kind; a Window keeping the
       last 960 rows, lam 0.97.
    """
    import numpy as np

    rng = np.random.default_rng(seed)

    def orth(*shape):
        return np.linalg.qr(rng.normal(size=shape))[0]

    b1, m1, n1, nnz1 = 128, 32, 48, 96
    rows1 = np.stack([rng.choice(m1, 8, replace=False)[rng.integers(0, 8, nnz1)]
                      for _ in range(b1)]).astype(np.int32)
    cols1 = rng.integers(0, n1, (b1, nnz1)).astype(np.int32)
    rows1[:, 1], cols1[:, 1] = rows1[:, 0], cols1[:, 0]
    rows1[:, -8:], cols1[:, -8:] = 0, 0
    vals1 = rng.normal(size=(b1, nnz1))
    vals1[:, -8:] = 0.0
    one = dict(u=orth(b1, m1, m1), s=np.tile(np.geomspace(100.0, 1.0, m1), (b1, 1)),
               v=orth(b1, n1, n1), rows=rows1, cols=cols1, vals=vals1, rank=8)
    b2, m2, r2, nnz2, k2 = 16, 1024, 16, 10485, 32
    two = dict(factors=[(orth(m2, r2), np.geomspace(100.0, 1.0, r2), orth(m2, r2))
                        for _ in range(b2)],
               sparse=[(rng.integers(0, m2, nnz2).astype(np.int32),
                        rng.integers(0, m2, nnz2).astype(np.int32), rng.normal(size=nnz2))
                       for _ in range(b2)],
               decay=0.99, rank=8,
               rank_k=[(0.1 * rng.normal(size=(m2, k2)), 0.1 * rng.normal(size=(m2, k2)))
                       for _ in range(b2)])
    b3, m3, n3, r3 = 4, 1024, 768, 8
    three = dict(factors=[(orth(m3, r3), np.geomspace(100.0, 1.0, r3), orth(n3, r3))
                          for _ in range(b3)], keep=m3 - 64, lam=0.97)
    nnz2e = 2048
    two["sparse_exact"] = [(rng.choice(m2, 8, replace=False)[rng.integers(0, 8, nnz2e)].astype(np.int32),
                            rng.integers(0, m2, nnz2e).astype(np.int32), rng.normal(size=nnz2e))
                           for _ in range(b2)]
    return {"1": one, "2": two, "3": three}


def fmm_inputs(seed: int = 3) -> dict:
    """The numpy inputs of the FMM drives (phase 3c), from one seed
    (``tools/port_vs_reference.py --part fmm`` runs (i), (ii), (iii) and (v)
    through the reference on the CPU).

    i, ii. uniform(1, 9) matrices at (1024, 1024), the largest n of the
       paper's Fig. 1/2 sweep (``benchmarks/fig1_2_runtime.py``), and
       standard-normal pairs: one for (i), eight for (ii);
    iii. the README quickstart's own data: ``default_rng(0)``, A standard
       normal (200, 300), then a and b standard normal;
    iv. four rank-127 states at (4096, 4096): QR-made orthonormal bases,
       singular values 100 .. 1 geometric, standard-normal pairs;
    v. eight full (1024, 1024) states from QR-made bases whose squared
       singular values are evenly spaced from 1e4 down to 1, standard-normal
       pairs: squares that fill the FMM's value grid evenly, so that no plan
       overflows its box capacity (the squared spectra of (i) and (ii) crowd
       the lowest boxes and overflow it).
    """
    import numpy as np

    rng = np.random.default_rng(seed)

    def orth(*shape):
        return np.linalg.qr(rng.normal(size=shape))[0]

    n = 1024
    full = [(rng.uniform(1, 9, (n, n)), rng.normal(size=n), rng.normal(size=n)) for _ in range(9)]
    quick = np.random.default_rng(0)
    a_q = quick.normal(size=(200, 300))
    iii = (a_q, quick.normal(size=200), quick.normal(size=300))
    iv = [(orth(4096, 127), np.geomspace(100.0, 1.0, 127), orth(4096, 127),
           rng.normal(size=4096), rng.normal(size=4096)) for _ in range(4)]
    v = [(orth(n, n), np.sqrt(np.linspace(1e4, 1.0, n)), orth(n, n), rng.normal(size=n),
          rng.normal(size=n)) for _ in range(8)]
    return {"i": full[0], "ii": full[1:], "iii": iii, "iv": iv, "v": v}


def service_inputs(seed: int = 5) -> dict:
    """The numpy inputs of the service drives (phase 3d), from one seed.

    s1. 16 rank-16 streams at m512 n768 (the reference's serving shape,
        ``benchmarks/bench_serve.py:56-58``): QR-made orthonormal factors,
        singular values 100 .. 1 geometric; ``SERVE_S1["rounds"]`` rounds of
        one standard-normal pair a stream, scaled to |a| |b| = the median
        singular value.
    s2. the same streams: one round of pairs; then RankK (k = 4, N(0, 0.01))
        on streams 0-3, a 1 % random COO Sparse (3932 entries, rank 8) on 4-7,
        AppendRows (8 rows) on 8-11, Window(504, lam 0.97) on 12-15; then
        one more round of pairs at each stream's new geometry.
    s3. 64 rank-32 streams at m1024 n4096, row blocks of one matrix of rank
        32: each stream's right factor is a common orthonormal V0 (4096 x 32)
        turned by its own 32 x 32 rotation, singular values 100 .. 1; each
        pair's b lies in V0's span, so every stream stays in it and the
        stacked matrix keeps rank 32: the merge of the 64 streams is then
        exact up to rounding, and its truth is the stacked matrix itself
        (the reference's merge tests use globally low-rank data for this).
        The stacked matrix's 32 singular values cluster (gaps down to 0.05 %).
        ``SERVE_S3["rounds"]`` rounds.
    """
    import numpy as np

    rng = np.random.default_rng(seed)

    def orth(*shape):
        return np.linalg.qr(rng.normal(size=shape))[0]

    def pairs(shapes, scale):
        out = []
        for m, n in shapes:
            a, b = rng.normal(size=m), rng.normal(size=n)
            out.append((a, b * scale / (np.linalg.norm(a) * np.linalg.norm(b))))
        return out

    def streams(count, m, n, r, rounds):
        s = np.geomspace(100.0, 1.0, r)
        return {"factors": [(orth(m, r), s, orth(n, r)) for _ in range(count)],
                "rounds": [pairs([(m, n)] * count, np.median(s)) for _ in range(rounds)]}

    s1 = streams(SERVE_S1["streams"], SERVE_S1["m"], SERVE_S1["n"], SERVE_S1["r"],
                 SERVE_S1["rounds"])
    m, n, scale = SERVE_S1["m"], SERVE_S1["n"], float(np.median(s1["factors"][0][1]))
    nnz = int(0.01 * m * n)
    s2 = {"pairs1": pairs([(m, n)] * 16, scale),
          "rank_k": [(0.1 * rng.normal(size=(m, 4)), 0.1 * rng.normal(size=(n, 4)))
                     for _ in range(4)],
          "sparse": [(rng.integers(0, m, nnz).astype(np.int32),
                      rng.integers(0, n, nnz).astype(np.int32), rng.normal(size=nnz))
                     for _ in range(4)],
          "append": [rng.normal(size=(8, n)) for _ in range(4)],
          "window": (m - 8, 0.97),
          "pairs2": pairs([(m, n)] * 8 + [(m + 8, n)] * 4 + [(m - 8, n)] * 4, scale)}
    m3, n3, r3 = SERVE_S3["m"], SERVE_S3["n"], SERVE_S3["r"]
    v0, s = orth(n3, r3), np.geomspace(100.0, 1.0, r3)
    s3 = {"factors": [(orth(m3, r3), s, v0 @ orth(r3, r3)) for _ in range(SERVE_S3["streams"])],
          "rounds": [[(a, v0 @ c * (np.median(s) / (np.linalg.norm(a) * np.linalg.norm(c))))
                      for a, c in ((rng.normal(size=m3), rng.normal(size=r3))
                                   for _ in range(SERVE_S3["streams"]))]
                     for _ in range(SERVE_S3["rounds"])]}
    return {"s1": s1, "s2": s2, "s3": s3}


def fleet_inputs(seed: int = 6) -> dict:
    """The numpy inputs of the fleet and mesh phase, from one seed.

    f1. ``FLEET["streams"]`` rank-16 streams at m512 n768: QR-made orthonormal
        factors, singular values 100 .. 1 geometric; ``FLEET["pairs"]`` rounds
        of one pair a stream (|a| |b| the median singular value); a Sparse a
        stream of 256 N(0, 1) entries in 8 of its rows.
    f2. 13 full (32, 48) states and 13 rank-16 states at m512 n768, of the
        same kind, and a pair each.
    f3. four rank-32 shards at m1024 n4096: row blocks of one matrix of rank
        32 (a common right factor turned by each shard's own rotation), so
        their merge is exact up to rounding.
    """
    import numpy as np

    rng = np.random.default_rng(seed)

    def orth(*shape):
        return np.linalg.qr(rng.normal(size=shape))[0]

    def pair(m, n, scale):
        a, b = rng.normal(size=m), rng.normal(size=n)
        return a, b * scale / (np.linalg.norm(a) * np.linalg.norm(b))

    m, n, r, k = FLEET["m"], FLEET["n"], FLEET["r"], FLEET["streams"]
    s = np.geomspace(100.0, 1.0, r)
    scale = float(np.median(s))
    f1 = {"factors": [(orth(m, r), s, orth(n, r)) for _ in range(k)],
          "rounds": [[pair(m, n, scale) for _ in range(k)] for _ in range(FLEET["pairs"])],
          "sparse": [(rng.choice(m, 8, replace=False)[rng.integers(0, 8, FLEET["sparse_nnz"])]
                      .astype(np.int32), rng.integers(0, n, FLEET["sparse_nnz"]).astype(np.int32),
                      rng.normal(size=FLEET["sparse_nnz"])) for _ in range(k)]}
    full = [(orth(32, 32), np.geomspace(100.0, 1.0, 32), orth(48, 48)) for _ in range(MESH_B)]
    trunc = [(orth(m, r), s, orth(n, r)) for _ in range(MESH_B)]
    f2 = {"full": full, "full_pairs": [pair(32, 48, 10.0) for _ in range(MESH_B)],
          "trunc": trunc, "trunc_pairs": [pair(m, n, scale) for _ in range(MESH_B)]}
    m3, n3, r3 = MERGE_F3["m"], MERGE_F3["n"], MERGE_F3["r"]
    v0 = orth(n3, r3)
    f3 = [(orth(m3, r3), np.geomspace(100.0, 1.0, r3), v0 @ orth(r3, r3))
          for _ in range(MERGE_F3["shards"])]
    return {"f1": f1, "f2": f2, "f3": f3}


def merge_worker(rank: int, world: int, backend: str, init: str, paths: dict) -> None:
    """One rank of a (f3) world, in its own process on card 0: warm
    ``distributed_merge`` once, wait for the previous world to finish, time
    one merge and one ``all_gather_tsvd`` (on CUDA tensors: gloo stages them
    through the host), run ``psum_factor`` and ``pmean_factor`` against their
    sums, and write the results to ``paths["out"] % rank``.  gloo may refuse
    an op on CUDA tensors: the refusal is recorded, not raised (NCCL's is
    raised)."""
    import os

    import numpy as np
    import torch
    import torch.distributed as tdist

    sys.path.insert(0, str(SRC))
    from repro_torch import api
    from repro_torch.core.svd_update import TruncatedSvd
    from repro_torch.dist import all_gather_tsvd, distributed_merge, pmean_factor, psum_factor
    from repro_torch.kernels import _build

    torch.cuda.set_device(0)
    tdist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    try:
        group = tdist.group.WORLD
        with np.load(paths["shards"]) as z:
            shards = [tuple(torch.as_tensor(z[f"{f}{i}"], device="cuda") for f in "usv")
                      for i in range(world)]
        local = TruncatedSvd(*shards[rank])
        pol = api.UpdatePolicy(method="fused")
        distributed_merge(local, group, policy=pol)
        torch.cuda.synchronize()
        if rank == 0 and paths["prev"]:
            while not os.path.exists(paths["prev"]):
                time.sleep(0.05)
        tdist.barrier()
        _build.reset_launches()
        t = time.perf_counter()
        merged = distributed_merge(local, group, policy=pol)
        torch.cuda.synchronize()
        merge_ms = (time.perf_counter() - t) * 1e3
        launches = {k: _build.LAUNCHES[k] for k in A_TO_F}
        t = time.perf_counter()
        all_gather_tsvd(local, group)
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t) * 1e3
        ops = {}
        want = {"psum": sum(sh[0] for sh in shards)}
        want["pmean"] = want["psum"] / world
        for name, fn in (("psum", psum_factor), ("pmean", pmean_factor)):
            try:
                got = fn(local.u, group)
            except RuntimeError as e:
                if backend != "gloo":
                    raise
                ops[name] = f"refused by gloo on CUDA tensors: {str(e).splitlines()[0][:160]}"
                continue
            ops[name] = float((got - want[name]).abs().max() / want[name].abs().max())
        tdist.barrier()
        if rank == 0:
            Path(paths["done"]).touch()
        np.savez(paths["out"] % rank, u=merged.u.cpu().numpy(), s=merged.s.cpu().numpy(),
                 v=merged.v.cpu().numpy(), merge_ms=merge_ms, gather_ms=gather_ms,
                 launches=json.dumps(launches), ops=json.dumps(ops))
    finally:
        tdist.destroy_process_group()


def serve_streams(api, serve, d, *, method, dtype, mif, device, max_batch=None, mesh=None):
    """A service with the streams of ``d`` registered (not yet fed)."""
    svc = serve.SvdService(max_batch=max_batch or len(d["factors"]), max_in_flight=mif,
                           policy=api.UpdatePolicy(method=method, mesh=mesh))
    for i, f in enumerate(d["factors"]):
        svc.register(f"s{i}", api.SvdState.from_factors(*f, device=device, dtype=dtype))
    return svc


def serve_rounds(svc, rounds) -> None:
    """Feed rounds of one pair a stream (each round's last enqueue flushes it)."""
    for rnd in rounds:
        for i, (a, b) in enumerate(rnd):
            svc.enqueue(f"s{i}", a, b)


def serve_s2_first(api, serve, updates, inputs, device):
    """Drive (s2) up to its snapshot: a round of pairs, then the structured
    events (their enqueue flushes one round, leaving RankK and Sparse pairs
    pending)."""
    d = inputs["s2"]
    svc = serve_streams(api, serve, inputs["s1"], method="fused", dtype=None, mif=2,
                        device=device)
    for i, (a, b) in enumerate(d["pairs1"]):
        svc.enqueue(f"s{i}", a, b)
    for i in range(16):
        j = i % 4
        op = (updates.RankK(*d["rank_k"][j]) if i < 4
              else updates.Sparse(*d["sparse"][j], rank=8) if i < 8
              else updates.AppendRows(d["append"][j]) if i < 12
              else updates.Window(d["window"][0], lam=d["window"][1]))
        svc.enqueue_op(f"s{i}", op)
    return svc


def serve_s2_second(svc, inputs) -> None:
    """Drive (s2) after its snapshot: one flush round of the pending pairs
    (the first after a restore: its geometry is in the warmed set), then the
    last round of pairs, drained."""
    svc.flush_round()
    for i, (a, b) in enumerate(inputs["s2"]["pairs2"]):
        svc.enqueue(f"s{i}", a, b)
    svc.drain()


def require(ok, what: str) -> None:
    """Fail the run (an explicit raise: asserts vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def count_syncs(fn):
    """Host waits for the device while ``fn`` runs, as
    ``torch.cuda.set_sync_debug_mode`` reports them: (count, {file:line: count})."""
    import collections

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter("/".join(Path(w.filename).parts[-2:]) + f":{w.lineno}"
                                for w in caught
                                if "called a synchronizing CUDA operation" in str(w.message))
    return sum(where.values()), dict(where)


def _tree_to(tree, device):
    """A training state or parameter tree with every tensor on ``device``,
    step counters (0-dim int32) left on the CPU where the port keeps them."""
    import torch

    from repro_torch._tree import tree_leaves, tree_unflatten

    moved = [x if not isinstance(x, torch.Tensor) or (x.dim() == 0 and x.dtype == torch.int32)
             else x.to(device) for x in tree_leaves(tree)]
    return tree_unflatten(tree, moved)


def _rel_max(got, want) -> float:
    """Largest |got - want| over the largest |want|, leaf by leaf, the worst leaf."""
    import torch

    from repro_torch._tree import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if not isinstance(a, torch.Tensor) or not a.is_floating_point():
            continue
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        worst = max(worst, float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)))
    return worst


class _StepMemory:
    """Bytes held and peak bytes over the pieces of one training step, by
    patching the module attributes ``train_step`` calls: the forward and
    backward (``loop.loss_and_grads``) and the optimizer
    (``loop.adamw_update`` / ``loop.spectral_adam_update``).  Each piece
    starts and ends with a host wait, so use it on a step that is not timed."""

    NAMES = ("loss_and_grads", "adamw_update", "spectral_adam_update")

    def __init__(self):
        import torch

        from repro_torch.train import loop

        self.torch, self.loop, self.marks = torch, loop, {}
        self.saved = {n: getattr(loop, n) for n in self.NAMES}

    def _wrap(self, name, fn):
        cuda = self.torch.cuda

        def measured(*args, **kwargs):
            cuda.synchronize()
            cuda.reset_peak_memory_stats()
            before = cuda.memory_allocated()
            out = fn(*args, **kwargs)
            cuda.synchronize()
            self.marks[name] = {"held_before": before, "peak": cuda.max_memory_allocated(),
                                "held_after": cuda.memory_allocated()}
            return out

        return measured

    def __enter__(self):
        for n, fn in self.saved.items():
            setattr(self.loop, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.loop, n, fn)


def _card_bytes(tree) -> int:
    import torch

    from repro_torch._tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda)


class _SpanClock:
    """The pieces of each training step from the program's own spans
    (``obs.start_tracing(device=True)``: the card's time from a span's enter
    to its exit): the step (``train_step``), the forward and backward
    (``fwd_bwd``), the optimizer (``optimizer``) and, inside spectral-Adam,
    the trackers' update (``trackers``, the phase chain) and the refresh
    (``refresh``).  ``split()`` gives each step's ms by piece."""

    PIECES = ("fwd_bwd", "optimizer", "trackers", "refresh")

    def __enter__(self):
        from repro_torch import obs

        self.obs = obs
        obs.clear_trace()
        obs.start_tracing(device=True)
        return self

    def __exit__(self, *exc):
        self.obs.stop_tracing()

    def split(self) -> list[dict]:
        """Per step: ``step_ms``, each piece's ms (0 where the step had none),
        the rest of the optimizer, and ``pieces``, the spans the step had."""
        steps = []
        for t in self.obs.device_times():
            if t["name"] == "train_step":
                steps.append({"step_ms": t["ms"], "pieces": set(),
                              **{f"{p}_ms": 0.0 for p in self.PIECES}})
            elif steps and t["name"] in self.PIECES:
                steps[-1][f"{t['name']}_ms"] += t["ms"]
                steps[-1]["pieces"].add(t["name"])
        self.obs.clear_trace()
        for st in steps:
            st["rest_of_optimizer_ms"] = st["optimizer_ms"] - st["trackers_ms"] - st["refresh_ms"]
            st["pieces"] = sorted(st["pieces"])
        return steps


def train_phase(dev, card: str) -> dict:
    """Phase (t): the training path on the card (``train.loop.train``).
    (t1) granite-34b at full width, 2 layers, AdamW then spectral-Adam; (t2)
    the card against the port on the CPU at the smoke config, with planted
    faults; (t3) resume equal to the bit, and the spectral resume refusal;
    (t4) examples/train_lm.py's repro-tiny run.  Raises on any failed check."""
    import dataclasses as dc
    import gc
    import math
    import shutil

    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ModelConfig, OptimizerConfig, RunConfig
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as AW
    from repro_torch.optim import spectral_adam as SA
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import loop

    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    out = {"card": card}
    t_phase = time.perf_counter()

    # -- (t1) granite-34b at full width ----------------------------------------
    cfg = configs.get(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    api = build_model(cfg)
    n_params = None
    t1 = {}
    for name, rank in (("adamw", 0), ("spectral_adam", TRAIN_RANK)):
        opt = OptimizerConfig(warmup_steps=2, total_steps=100, spectral_rank=rank,
                              basis_refresh_every=TRAIN_REFRESH if rank else 0)
        run = RunConfig(model=cfg, optimizer=opt, steps=TRAIN_STEPS, log_every=1,
                        checkpoint_every=0, checkpoint_dir=str(work / name), seed=0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with _SpanClock() as clock:
            res = loop.train(run, batch_size=1, seq_len=TRAIN_SEQ, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_mem
        split = clock.split()
        losses = [v for _, v in res.losses]
        require(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
                f"(t1) {name}: losses not finite: {losses}")
        require(abs(losses[0] - math.log(cfg.vocab_size)) < TRAIN_FIRST_LOSS_SLACK,
                f"(t1) {name}: first loss {losses[0]} not within {TRAIN_FIRST_LOSS_SLACK} of "
                f"ln({cfg.vocab_size}) = {math.log(cfg.vocab_size):.3f}")

        # one step outside the loop, from a fresh init: host waits (no log, no
        # save) and the device's busy share (profiler)
        params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        if rank:
            ratio = SA.moment_memory_ratio(params, rank)
        state = (SA.spectral_adam_init(torch.Generator(device=dev).manual_seed(1), params,
                                       rank=rank, device=dev) if rank else AW.adamw_init(params))
        holder = {"p": params, "s": state}
        del params, state

        def one_step(step, holder=holder, opt=opt, rank=rank):
            batch = batch_for_step(0, step, batch=1, seq=TRAIN_SEQ, vocab=cfg.vocab_size,
                                   device=dev)
            holder["p"], holder["s"], _, _ = loop.train_step(api, opt, holder["p"], holder["s"],
                                                             batch, step, spectral=bool(rank))

        one_step(0)
        waits, where = count_syncs(lambda: one_step(1))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_step(2)
            torch.cuda.synchronize()
            step_wall = (time.perf_counter() - t0) * 1e3
        by_kernel = sorted(((ev.device_time_total / 1e3, ev.key[:60]) for ev in prof.key_averages()
                            if ev.device_time_total > 0), reverse=True)
        busy = sum(ms for ms, _ in by_kernel)
        # and one more, to see where its bytes go: parameters and optimizer
        # state held, the forward and backward's peak over them, the gradients
        # it leaves, the optimizer's peak over all of those
        param_b, state_b = _card_bytes(holder["p"]), _card_bytes(holder["s"])
        gc.collect()
        with _StepMemory() as mem:
            one_step(3)
        fb = mem.marks["loss_and_grads"]
        op = mem.marks["spectral_adam_update" if rank else "adamw_update"]
        memory = {"params": param_b, "optimizer_state": state_b,
                  "held_before_step": fb["held_before"],
                  "fwd_bwd_peak_over_held": fb["peak"] - fb["held_before"],
                  "grads_held": fb["held_after"] - fb["held_before"],
                  "optimizer_peak_over_held": op["peak"] - op["held_before"],
                  "optimizer_leaves": op["held_after"] - op["held_before"],
                  "step_peak": max(fb["peak"], op["peak"])}
        del holder, one_step       # its default argument holds the step's state too
        gc.collect()
        torch.cuda.empty_cache()
        steady = split[1:]
        mean = {k: statistics.mean(st[k] for st in steady)
                for k in ("step_ms", "fwd_bwd_ms", "optimizer_ms", "trackers_ms", "refresh_ms",
                          "rest_of_optimizer_ms")}
        t1[name] = {"losses": losses, "wall_s": wall, "peak_bytes": peak, "steps": split,
                    "mean_after_first": mean, "host_waits_a_step": waits, "waits_at": where,
                    "profiled_step_ms": step_wall, "device_busy_ms": busy,
                    "top_kernels_ms": by_kernel[:8],
                    "device_share": busy / step_wall if step_wall > 0 else None,
                    "memory_bytes": memory}
        log(f"  (t1) {name}: losses {[round(v, 4) for v in losses]} | {wall:.1f} s for "
            f"{TRAIN_STEPS} steps with init | peak {peak / 2**30:.2f} GiB | card: {card}")
        for i, st in enumerate(split):
            log(f"    step {i}: {st['step_ms']:.1f} ms = fwd+bwd {st['fwd_bwd_ms']:.1f} + "
                f"optimizer {st['optimizer_ms']:.1f} (trackers {st['trackers_ms']:.1f}, refresh "
                f"{st['refresh_ms']:.1f}, rest {st['rest_of_optimizer_ms']:.1f})")
        log(f"    a step outside the loop: {waits} host waits {where or ''}; profiled step "
            f"{step_wall:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / step_wall:.1f} %)")
        log("    its kernels by device ms: " + "; ".join(f"{k} {ms:.1f}" for ms, k in by_kernel[:8]))
        gib = {k: v / 2**30 for k, v in memory.items()}
        log(f"    memory of a step (GiB): params {gib['params']:.2f} + optimizer state "
            f"{gib['optimizer_state']:.2f} held ({gib['held_before_step']:.2f} allocated); "
            f"fwd+bwd peaks {gib['fwd_bwd_peak_over_held']:.2f} above that and leaves "
            f"gradients of {gib['grads_held']:.2f}; the optimizer peaks "
            f"{gib['optimizer_peak_over_held']:.2f} above its start and leaves "
            f"{gib['optimizer_leaves']:.2f} more (the old and new state live at once until the "
            f"step returns); step peak {gib['step_peak']:.2f}")
        if not rank:
            require(waits == 0, f"(t1) an AdamW step that neither logs nor saves waited for the "
                                f"card {waits} times: {where}")
    out["t1"] = t1
    out["t1_params"] = n_params
    out["t1_peak_diff_bytes"] = t1["adamw"]["peak_bytes"] - t1["spectral_adam"]["peak_bytes"]
    # the optimizer state's bytes the ratio predicts: dense moments 2 floats a
    # parameter, spectral-Adam's the dense ones over the ratio
    dense_bytes = 8 * n_params
    out["t1_moment_memory_ratio"] = ratio
    out["t1_predicted_diff_bytes"] = dense_bytes - dense_bytes / ratio
    log(f"  (t1) {n_params / 1e9:.4f} B parameters; moment_memory_ratio {ratio:.3f}: moments "
        f"{dense_bytes / 2**30:.2f} GiB -> {dense_bytes / ratio / 2**30:.2f} GiB, predicted "
        f"difference {out['t1_predicted_diff_bytes'] / 2**30:.2f} GiB; measured peak AdamW - "
        f"spectral-Adam {out['t1_peak_diff_bytes'] / 2**30:.2f} GiB")

    # -- (t2) the card against the CPU at the smoke config, planted faults -------
    scfg = configs.get_smoke(TRAIN_ARCH)
    sapi = build_model(scfg)
    p0 = sapi.init(torch.Generator().manual_seed(1), device="cpu")
    base_opt = OptimizerConfig(lr=TRAIN_T2["lr"], warmup_steps=0, total_steps=100,
                               spectral_rank=TRAIN_T2["rank"])
    s0 = {"adamw": AW.adamw_init(p0),
          "spectral_adam": SA.spectral_adam_init(torch.Generator().manual_seed(2), p0,
                                                 rank=TRAIN_T2["rank"], device="cpu")}

    def t2_run(device, name, fault=None, api_=sapi, inits=(p0, s0)):
        params, state = _tree_to(inits[0], device), _tree_to(inits[1][name], device)
        opt = dc.replace(base_opt, weight_decay=0.0) if fault == "weight decay dropped" \
            else base_opt
        losses = []
        for step in range(TRAIN_T2["steps"]):
            batch = batch_for_step(0, step, batch=2, seq=32, vocab=api_.cfg.vocab_size,
                                   device=device)
            if fault in (None, "weight decay dropped"):
                params, state, loss, _ = loop.train_step(api_, opt, params, state, batch, step,
                                                         spectral=name == "spectral_adam")
            else:
                loss, grads = loop.loss_and_grads(api_, params, batch)
                lr = warmup_cosine(step, base_lr=opt.lr, warmup_steps=opt.warmup_steps,
                                   total_steps=opt.total_steps)
                with torch.no_grad():
                    if fault == "bias correction dropped":   # 1 - beta ** 1e6 == 1
                        state = state._replace(step=torch.tensor(10**6, dtype=torch.int32))
                        params, state, _ = AW.adamw_update(grads, state, params, lr=lr,
                                                           grad_clip=opt.grad_clip)
                    else:                                    # one tracker update skipped
                        every = 10**9 if step == 2 else 1
                        params, state = SA.spectral_adam_update(grads, state, params, lr=lr,
                                                                update_basis_every=every)
            losses.append(float(loss))
        return torch.tensor(losses, dtype=torch.float64), params

    t2 = {}
    # rwkv6-1.6b's smoke config under the same limits (AdamW)
    rapi = build_model(configs.get_smoke(TRAIN_T5["rwkv"]))
    rp0 = rapi.init(torch.Generator().manual_seed(1), device="cpu")
    rwkv_run = {"api_": rapi, "inits": (rp0, {"adamw": AW.adamw_init(rp0)})}
    for name, faults, kw in (
            ("adamw", ("bias correction dropped", "weight decay dropped"), {}),
            ("spectral_adam", ("one tracker update skipped", "weight decay dropped"), {}),
            ("adamw", ("bias correction dropped", "weight decay dropped"), rwkv_run)):
        label = name if not kw else f"{name} {TRAIN_T5['rwkv']} smoke"
        cpu_l, cpu_p = t2_run("cpu", name, **kw)
        card_l, card_p = t2_run(dev, name, **kw)
        loss_err = float(((card_l - cpu_l).abs() / cpu_l.abs()).max())
        param_err = _rel_max(card_p, cpu_p)
        row = {"loss_rel": loss_err, "params_rel": param_err, "faults": {}}
        log(f"  (t2) {label}: card vs CPU losses {loss_err:.2e} (limit {TRAIN_T2['loss']:g}), "
            f"params {param_err:.2e} (limit {TRAIN_T2['params']:g}) | {card}")
        require(loss_err <= TRAIN_T2["loss"] and param_err <= TRAIN_T2["params"],
                f"(t2) {label}: the card differs from the CPU beyond the limits")
        for fault in faults:
            f_l, f_p = t2_run(dev, name, fault, **kw)
            fl = float(((f_l - cpu_l).abs() / cpu_l.abs()).max())
            fp = _rel_max(f_p, cpu_p)
            row["faults"][fault] = {"loss_rel": fl, "params_rel": fp}
            log(f"    planted fault, {fault}: losses {fl:.2e}, params {fp:.2e}")
            require(fl > TRAIN_T2["loss"] or fp > TRAIN_T2["params"],
                    f"(t2) {label}: the check passes a planted fault ({fault})")
        t2[label] = row
    # the same in bf16 compute: the card's bmm.dtype / mm.dtype path
    bapi = build_model(scfg.replace(compute_dtype="bfloat16"))
    batch0 = batch_for_step(0, 0, batch=2, seq=32, vocab=scfg.vocab_size, device="cpu")
    cpu_loss, cpu_grads = loop.loss_and_grads(bapi, p0, batch0)
    card_loss, card_grads = loop.loss_and_grads(bapi, _tree_to(p0, dev), _tree_to(batch0, dev))
    first_err = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_err = _rel_max(card_grads, cpu_grads)
    cpu_l, _ = t2_run("cpu", "adamw", api_=bapi)
    card_l, _ = t2_run(dev, "adamw", api_=bapi)
    losses_err = float(((card_l - cpu_l).abs() / cpu_l.abs()).max())
    t2["adamw_bf16"] = {"first_loss_rel": first_err, "grads_rel": grad_err,
                        "losses_rel": losses_err}
    lim = TRAIN_T2_BF16
    log(f"  (t2) bf16 compute: card vs CPU first loss {first_err:.2e} (limit {lim['loss']:g}), "
        f"gradients {grad_err:.2e} (limit {lim['grads']:g}), AdamW losses over "
        f"{TRAIN_T2['steps']} steps {losses_err:.2e} (limit {lim['losses']:g}) | {card}")
    require(first_err <= lim["loss"] and grad_err <= lim["grads"] and losses_err <= lim["losses"],
            "(t2) bf16 compute: the card differs from the CPU beyond the limits")
    out["t2"] = t2

    # -- (t3) resume on the card, to the bit ------------------------------------
    torch.use_deterministic_algorithms(True)
    try:
        def smoke_run(d, steps, rank=0, every=3):
            return RunConfig(model=scfg, optimizer=dc.replace(base_opt, spectral_rank=rank),
                             steps=steps, log_every=1, checkpoint_every=every,
                             checkpoint_dir=str(work / d), seed=0)

        whole = loop.train(smoke_run("t3_whole", 6), batch_size=2, seq_len=32, device=dev)
        loop.train(smoke_run("t3_resumed", 3), batch_size=2, seq_len=32, device=dev)
        resumed = loop.train(smoke_run("t3_resumed", 6), batch_size=2, seq_len=32, device=dev)
        require(resumed.resumed_from == 3, f"(t3) resumed from {resumed.resumed_from}, not 3")
        same_losses = [v for _, v in whole.losses][3:] == [v for _, v in resumed.losses]
        (sa, la), (sb, lb) = CK.restore(work / "t3_whole", None), CK.restore(work / "t3_resumed", None)
        same_state = sa == sb == 6 and len(la) == len(lb) and all(
            a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            for a, b in zip(la, lb))
        log(f"  (t3) resume at step 3 of 6 (AdamW, deterministic algorithms): losses "
            f"{'equal' if same_losses else 'NOT equal'}, the {len(la)} leaves of the step-6 "
            f"checkpoint {'equal to the bit' if same_state else 'NOT equal'} | {card}")
        require(same_losses and same_state, "(t3) the resumed run is not the uninterrupted one")
        loop.train(smoke_run("t3_spectral", 2, rank=TRAIN_T2["rank"], every=100),
                   batch_size=2, seq_len=32, device=dev)
        try:
            loop.train(smoke_run("t3_spectral", 4, rank=TRAIN_T2["rank"], every=100),
                       batch_size=2, seq_len=32, device=dev)
        except ValueError as e:
            refusal = str(e)
        else:
            refusal = None
        log(f"  (t3) resuming spectral-Adam raises as the reference does: {refusal!r}")
        require(refusal is not None and "leaves; target structure has" in refusal,
                "(t3) resuming a spectral-Adam run did not raise the reference's ValueError")
        out["t3"] = {"losses_equal": same_losses, "state_equal": same_state, "leaves": len(la),
                     "spectral_refusal": refusal}
    finally:
        torch.use_deterministic_algorithms(False)

    # -- (t4) examples/train_lm.py's repro-tiny run --------------------------------
    tiny = ModelConfig(name="repro-tiny", family="dense", n_layers=4, d_model=256, n_heads=8,
                       n_kv_heads=4, d_ff=704, vocab_size=2_048, vocab_pad_to=64,
                       mlp_type="swiglu", norm_type="rmsnorm", compute_dtype="float32",
                       remat=False)
    run = RunConfig(model=tiny, optimizer=OptimizerConfig(lr=1e-3, warmup_steps=20,
                                                          total_steps=100),
                    steps=TRAIN_T4["steps"], log_every=10, checkpoint_every=25,
                    checkpoint_dir=str(work / "t4"), seed=0)
    t0 = time.perf_counter()
    res = loop.train(run, batch_size=TRAIN_T4["batch"], seq_len=TRAIN_T4["seq"], device=dev)
    t4_s = time.perf_counter() - t0
    first, last = res.losses[0][1], res.losses[-1][1]
    log(f"  (t4) repro-tiny: loss {first:.3f} -> {last:.3f} over {res.final_step} steps "
        f"({t4_s:.1f} s) | {card}")
    require(last < first, f"(t4) the loss did not fall: {first} -> {last}")
    out["t4"] = {"losses": res.losses, "seconds": t4_s}
    out["t5"] = _train_t5(dev, card, work)
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase (t): {out['seconds']:.1f} s | {card}")
    return out


def _train_t5_steps(dev, card, label, one_step, n_params, vocab, clock_steps, extra):
    """The step figures of a (t5) row: ms a step by piece over ``clock_steps``
    (the program's spans on the card, after the first), the host waits of one
    more step (0: a check), the device's busy share of one more (profiler),
    the first loss against ln(vocab)."""
    import math

    import torch

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses = []
    with _SpanClock() as clock:
        for step in range(clock_steps):
            losses.append(one_step(step))
    split = clock.split()
    losses = [float(v) for v in losses]
    waits, where = count_syncs(lambda: one_step(clock_steps))
    sync = torch.cuda.synchronize
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step(clock_steps + 1)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(((ev.device_time_total / 1e3, ev.key[:60]) for ev in prof.key_averages()
                        if ev.device_time_total > 0), reverse=True)
    busy = sum(ms for ms, _ in by_kernel)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    steady = split[1:] or split
    row = {"params": n_params, "losses": losses,
           "step_ms": [st["step_ms"] for st in split],
           "mean_step_ms": statistics.mean(st["step_ms"] for st in steady),
           "mean_fwd_bwd_ms": statistics.mean(st["fwd_bwd_ms"] for st in steady),
           "host_waits_a_step": waits, "waits_at": where, "profiled_step_ms": wall,
           "device_busy_ms": busy, "device_share": busy / wall if wall > 0 else None,
           "top_kernels_ms": by_kernel[:8], "peak_over_start_gib": peak, **extra}
    log(f"  (t5) {label}, {n_params / 1e9:.4f} B params: {row['mean_step_ms']:.1f} ms a step "
        f"(fwd+bwd {row['mean_fwd_bwd_ms']:.1f}; steps {[round(v, 1) for v in row['step_ms']]}) "
        f"| losses {[round(v, 4) for v in losses]} | device share {100 * busy / wall:.1f} % "
        f"({busy:.1f} of {wall:.1f} ms) | host waits a step {waits} {where or ''}| peak "
        f"{peak:.2f} GiB over {base / 2**30:.2f} held | card: {card}")
    log("    its kernels by device ms: " + "; ".join(f"{k} {ms:.1f}" for ms, k in by_kernel[:6]))
    require(all(math.isfinite(v) for v in losses), f"(t5) {label}: losses not finite: {losses}")
    require(abs(losses[0] - math.log(vocab)) < TRAIN_FIRST_LOSS_SLACK,
            f"(t5) {label}: first loss {losses[0]} not within {TRAIN_FIRST_LOSS_SLACK} of "
            f"ln({vocab})")
    require(waits == 0, f"(t5) {label}: a training step waited for the card {waits} times: {where}")
    return row


def _train_t5(dev, card, work) -> dict:
    """(t5): rwkv6-1.6b through ``train`` at full width and depth, and
    whisper-base's train_loss + backward + AdamW on its train specs; train on
    whisper raises the reference's KeyError: 'frames'."""
    import gc
    import math

    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as AW
    from repro_torch.train import loop

    out = {}
    t_cell = time.perf_counter()
    opt = OptimizerConfig(warmup_steps=2, total_steps=100)

    def fresh():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # rwkv6-1.6b through train(): 4 AdamW steps, then steps outside the loop
    cfg = configs.get(TRAIN_T5["rwkv"])
    fresh()
    base = torch.cuda.memory_allocated()
    run = RunConfig(model=cfg, optimizer=opt, steps=TRAIN_T5["steps"], log_every=1,
                    checkpoint_every=0, checkpoint_dir=str(work / "t5_rwkv"), seed=0)
    t0 = time.perf_counter()
    with _SpanClock() as clock:
        res = loop.train(run, batch_size=TRAIN_T5["batch"], seq_len=TRAIN_T5["seq"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    split = clock.split()
    losses = [v for _, v in res.losses]
    require(len(losses) == TRAIN_T5["steps"] and all(math.isfinite(v) for v in losses),
            f"(t5) rwkv train: losses not finite: {losses}")
    require(abs(losses[0] - math.log(cfg.vocab_size)) < TRAIN_FIRST_LOSS_SLACK,
            f"(t5) rwkv train: first loss {losses[0]} not within {TRAIN_FIRST_LOSS_SLACK} of "
            f"ln({cfg.vocab_size})")
    log(f"  (t5) {cfg.name} train(): {TRAIN_T5['steps']} AdamW steps at b{TRAIN_T5['batch']} x "
        f"{TRAIN_T5['seq']} in {wall:.1f} s with init | losses {[round(v, 4) for v in losses]} | "
        f"steps {[round(st['step_ms'], 1) for st in split]} ms (fwd+bwd "
        f"{[round(st['fwd_bwd_ms'], 1) for st in split]}) | peak {train_peak:.2f} GiB | {card}")
    del res
    fresh()
    api = build_model(cfg)
    holder = {"p": api.init(torch.Generator(device=dev).manual_seed(0), device=dev)}
    holder["s"] = AW.adamw_init(holder["p"])
    n_params = sum(x.numel() for x in tree_leaves(holder["p"]))

    def rwkv_step(step):
        batch = batch_for_step(0, step, batch=TRAIN_T5["batch"], seq=TRAIN_T5["seq"],
                               vocab=cfg.vocab_size, device=dev)
        holder["p"], holder["s"], loss, _ = loop.train_step(api, opt, holder["p"], holder["s"],
                                                            batch, step, spectral=False)
        return loss

    out["rwkv"] = _train_t5_steps(
        dev, card, f"{cfg.name} {cfg.n_layers} layers, AdamW, b{TRAIN_T5['batch']} x "
                   f"{TRAIN_T5['seq']}", rwkv_step, n_params, cfg.vocab_size, 3,
        {"train_losses": losses, "train_wall_s": wall, "train_peak_gib": train_peak,
         "train_steps": split})
    del holder
    fresh()

    # whisper-base: train_loss + backward + AdamW on its train specs
    ecfg = configs.get(TRAIN_T5["encdec"])
    eapi = build_model(ecfg)
    specs = eapi.input_specs(ShapeConfig("train", TRAIN_T5["enc_seq"], TRAIN_T5["enc_batch"],
                                         "train"))["batch"]
    g = torch.Generator(device=dev).manual_seed(5)
    frames = (torch.randn(specs["frames"].shape, generator=g, device=dev) * 0.02).to(
        specs["frames"].dtype)
    holder = {"p": eapi.init(torch.Generator(device=dev).manual_seed(0), device=dev)}
    holder["s"] = AW.adamw_init(holder["p"])
    n_params = sum(x.numel() for x in tree_leaves(holder["p"]))
    s_dec = specs["tokens"].shape[1]

    def whisper_step(step):
        batch = batch_for_step(0, step, batch=TRAIN_T5["enc_batch"], seq=s_dec,
                               vocab=ecfg.vocab_size, device=dev)
        batch["frames"] = frames
        holder["p"], holder["s"], loss, _ = loop.train_step(eapi, opt, holder["p"], holder["s"],
                                                            batch, step, spectral=False)
        return loss

    out["whisper"] = _train_t5_steps(
        dev, card, f"{ecfg.name} train_loss + backward + AdamW, frames "
                   f"{tuple(specs['frames'].shape)} {str(specs['frames'].dtype)[6:]}, tokens "
                   f"{tuple(specs['tokens'].shape)}", whisper_step, n_params, ecfg.vocab_size, 4,
        {"frames": list(specs["frames"].shape), "tokens": list(specs["tokens"].shape)})
    del holder, frames
    fresh()
    run = RunConfig(model=ecfg, optimizer=opt, steps=1, log_every=1, checkpoint_every=0,
                    checkpoint_dir=str(work / "t5_whisper"), seed=0)
    try:
        loop.train(run, batch_size=1, seq_len=64, device=dev)
    except KeyError as e:
        refusal = repr(e)
    else:
        refusal = None
    log(f"  (t5) train() on {ecfg.name} raises as the reference does: {refusal}")
    require(refusal == "KeyError('frames')",
            f"(t5) train on {ecfg.name} did not raise the reference's KeyError: {refusal}")
    out["whisper_train_refusal"] = refusal
    out["seconds"] = time.perf_counter() - t_cell
    log(f"  (t5): {out['seconds']:.1f} s | {card}")
    return out


def _serve_prompts(cfg, b, s, seed, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev, dtype=torch.int32)


def _logit_rel(got, want) -> float:
    """max |got - want| / max |want| over the real vocabulary."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


class _Plant:
    """A planted fault: ``setattr`` patches on the port's modules for a
    ``with`` block."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, fn in self.patches:
            setattr(m, n, fn(getattr(m, n)))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def _serve_faults(kind):
    """The planted faults of a consistency drive, by name: each a list of
    (module, attribute, wrapper of the original)."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import mla as M
    from repro_torch.models import ssm as S

    def write_at_pos_minus_1(orig):
        return lambda buf, new, pos: orig(buf, new, pos - 1)

    def mask_lt_pos(orig):
        return lambda sk, pos, device: torch.arange(sk, device=device) < pos

    def k_rope_before_rope(orig):
        def project(x, p, cfg, positions):
            q_nope, q_rope, c_kv, _ = orig(x, p, cfg, positions)
            raw = L.dot(x, p["w_dkv"], cfg.compute_dtype).to(x.dtype)[..., cfg.mla.kv_lora_rank:]
            return q_nope, q_rope, c_kv, raw
        return project

    def conv_not_shifted(orig):
        def decode(x, p, cfg, state):
            old = state["conv"].clone()
            out = orig(x, p, cfg, state)
            state["conv"].copy_(old)
            return out
        return decode

    def decay_dropped(orig):
        def decode(x, p, cfg, state):
            return orig(x, dict(p, a_log=torch.full_like(p["a_log"], -torch.inf)), cfg, state)
        return decode

    faults = {"the cache written at pos - 1": [(A, "_write", write_at_pos_minus_1)],
              "the decode mask < pos": [(A, "_decode_valid", mask_lt_pos)]}
    if kind == "mla":
        faults["k_rope cached before RoPE"] = [(M, "_project", k_rope_before_rope)]
    if kind == "hybrid":
        faults = {"the conv buffer not shifted": [(S, "ssm_decode", conv_not_shifted)],
                  "the SSM state's decay dropped": [(S, "ssm_decode", decay_dropped)]}
    return faults


def _tree_bytes(tree) -> int:
    from repro_torch._tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _greedy(api, params, box, pos):
    """One greedy decode step as ``generate`` takes it: the cache written in
    place, the argmax kept on the device."""
    from repro_torch.serve.engine import _sample

    logits, box["cache"] = api.decode_step(params, box["cache"], box["token"], pos)
    box["token"] = _sample(logits[:, -1, :], 0.0, None)[:, None]
    box["out"].append(box["token"])


def _decode_profile(api, params, box, pos0, steps, sync):
    """ms a decode step (CUDA events over ``steps`` steps), the device's busy
    share of one step (profiler) and its kernels by category, host waits a
    step (``set_sync_debug_mode``)."""
    import torch

    waits, where = count_syncs(lambda: _greedy(api, params, box, pos0))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(steps):
        _greedy(api, params, box, pos0 + 1 + i)
    e1.record()
    sync()
    ms = e0.elapsed_time(e1) / steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _greedy(api, params, box, pos0 + 1 + steps)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    cats, kernels = {}, []
    for ev in prof.key_averages():
        if ev.device_time_total <= 0:
            continue
        k = ev.key.lower()
        cat = next((c for c, words in SERVE_KERNEL_KINDS if any(w in k for w in words)),
                   "other elementwise")
        cats[cat] = cats.get(cat, 0.0) + ev.device_time_total / 1e3
        kernels.append((ev.device_time_total / 1e3, ev.count, ev.key[:90]))
    busy = sum(cats.values())
    return {"ms_a_token": ms, "profiled_step_ms": wall, "device_busy_ms": busy,
            "device_share": busy / wall if wall > 0 else None,
            "launches_a_step": sum(c for _, c, _ in kernels),
            "device_ms_by_kind": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top_kernels": sorted(kernels, reverse=True)[:8],
            "host_waits_a_step": waits, "waits_at": where}


def _param_cast_ms(params, cd, sync):
    """ms of casting every matrix parameter but the embedding table (which a
    step gathers from, uncast) to the compute dtype once, as a decode step's
    products do (CUDA events, median of 3)."""
    import torch

    from repro_torch._tree import tree_leaves

    leaves = [x for x in tree_leaves({k: v for k, v in params.items() if k != "embed"})
              if x.dim() >= 2]
    times = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for x in leaves:
            x.to(cd)
        e1.record()
        sync()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), sum(x.numel() for x in leaves)


def _consistency(api_f32, params, prompts, extra_toks, fwd, faults, prompt_len, inputs=None,
                 prefill_key="max_len"):
    """The prefill's last logits and 3 teacher-forced decode steps against the
    full forward (float32 compute); then each planted fault's reading.
    ``inputs``: more entries of both batches (the encoder's frames);
    ``prefill_key``: the keyword that sizes the prefill's cache (None for
    RWKV, whose state has no length)."""
    import torch

    seq = torch.cat([prompts, extra_toks], dim=1)
    inputs = inputs or {}
    kw = {prefill_key: seq.shape[1]} if prefill_key else {}
    with torch.inference_mode():
        full = fwd(params, {"tokens": seq, **inputs}, api_f32.cfg)
        want = [full[:, prompt_len - 1 + i] for i in range(4)]
        del full

        def drive():
            logits, cache = api_f32.prefill(params, {"tokens": prompts, **inputs}, **kw)
            got = [logits[:, -1]]
            for i in range(3):
                logits, cache = api_f32.decode_step(
                    params, cache, seq[:, prompt_len + i:prompt_len + i + 1], prompt_len + i)
                got.append(logits[:, 0])
            vocab = api_f32.cfg.vocab_size
            return max(_logit_rel(g[:, :vocab], w[:, :vocab]) for g, w in zip(got, want))

        sound = drive()
        planted = {}
        for name, patches in faults.items():
            with _Plant(patches):
                planted[name] = drive()
    return sound, planted


def serve_phase(dev, card: str, sizes=None) -> dict:
    """Phase (g): token serving on the card (``serve.engine.generate``).
    (g1) deepseek-v2-lite-16b, (g2) zamba2-7b, (g3) qwen1.5-32b at their
    published widths: generate greedy, determinism, host waits, consistency
    with planted faults, times; (g3) the int8 cache; the decode_32k rows;
    (g4) the card against the CPU at the smoke configs.  Raises on any failed
    check."""
    import dataclasses as dc
    import gc

    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_leaves
    from repro_torch.models import hybrid as HY
    from repro_torch.models import transformer as TR
    from repro_torch.models.registry import build_model
    from repro_torch.serve import engine as ENG

    sz = dict(SERVE, **(sizes or {}))
    b, plen, new, extra = sz["batch"], sz["prompt"], sz["new"], sz["extra"]
    sync = torch.cuda.synchronize
    out = {"card": card}
    t_phase = time.perf_counter()

    def fresh():
        gc.collect()
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for label in ("g1", "g2", "g3"):
        arch, layers = sz[label]
        cfg = configs.get(arch) if "cfg_" + label not in sz else sz["cfg_" + label]
        if layers:
            cfg = cfg.replace(n_layers=layers)
        row = {"arch": arch, "n_layers": cfg.n_layers, "compute": cfg.compute_dtype}
        fresh()
        t0 = time.perf_counter()
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        sync()
        row["params"] = sum(x.numel() for x in tree_leaves(params))
        row["init_s"] = time.perf_counter() - t0
        prompts = _serve_prompts(cfg, b, plen, 1, dev)
        sc = ENG.ServeConfig(max_new_tokens=new)

        # generate, twice, under deterministic algorithms: equal to the bit
        torch.use_deterministic_algorithms(True)
        try:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            toks1 = ENG.generate(api, params, prompts, sc)
            sync()
            row["generate_s"] = time.perf_counter() - t0
            row["generate_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            toks2 = ENG.generate(api, params, prompts, sc)
        finally:
            torch.use_deterministic_algorithms(False)
        require(torch.equal(toks1, toks2), f"({label}) two greedy generate runs differ")
        require(tuple(toks1.shape) == (b, new) and int(toks1.max()) < cfg.vocab_size
                and int(toks1.min()) >= 0, f"({label}) tokens out of the vocabulary")
        row["first_tokens"] = toks1[0, :8].tolist()

        # prefill ms, decode ms a token, host waits, device share
        with torch.inference_mode():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            logits, cache = api.prefill(params, {"tokens": prompts}, max_len=plen + new)
            e1.record()
            sync()
            row["prefill_ms"] = e0.elapsed_time(e1)
            row["cache_gib"] = _tree_bytes(cache) / 2**30
            token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            box = {"cache": cache, "token": token, "out": [token]}
            prof = _decode_profile(api, params, box, plen, min(sz["timed_steps"], new - 3), sync)
            del box, cache, logits
        row.update(prof)
        row["tokens_per_s"] = b * 1e3 / prof["ms_a_token"]
        row["param_cast_ms"], row["cast_params"] = _param_cast_ms(params, torch.bfloat16, sync)
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"  ({label}) {arch} {cfg.n_layers} layers, {row['params'] / 1e9:.3f} B params: "
            f"generate b{b} x {plen} + {new} in {row['generate_s']:.2f} s (deterministic, equal "
            f"twice) | prefill {row['prefill_ms']:.1f} ms | decode {prof['ms_a_token']:.2f} ms a "
            f"token = {row['tokens_per_s']:.0f} tokens/s | device share "
            f"{100 * (prof['device_share'] or 0):.1f} % | host waits a step "
            f"{prof['host_waits_a_step']} {prof['waits_at'] or ''}| cache {row['cache_gib']:.2f} "
            f"GiB | peak {row['peak_gib']:.2f} GiB | card: {card}")
        log("    its top kernels (device ms, launches): " + "; ".join(
            f"{n} {ms:.2f} x{c}" for ms, c, n in prof["top_kernels"]))
        log(f"    device ms of a step by kind: "
            + "; ".join(f"{k} {v:.2f}" for k, v in prof["device_ms_by_kind"].items())
            + f" | casting the {row['cast_params'] / 1e9:.3f} B matrix parameters to bf16 once: "
            f"{row['param_cast_ms']:.2f} ms")
        require(prof["host_waits_a_step"] == 0,
                f"({label}) a greedy decode step waited for the host: {prof['waits_at']}")

        # consistency in float32 compute (dropless MoE), with planted faults
        fcfg = cfg.replace(compute_dtype="float32", remat=False)
        if fcfg.moe is not None:
            fcfg = fcfg.replace(moe=dc.replace(fcfg.moe,
                                               capacity_factor=fcfg.moe.n_routed / fcfg.moe.top_k))
        fapi = build_model(fcfg)
        fwd = HY.hybrid_forward if fcfg.ssm is not None else TR.decoder_forward
        kind = "hybrid" if fcfg.ssm is not None else "mla" if fcfg.mla is not None else "attn"
        extra_toks = _serve_prompts(cfg, b, extra, 2, dev)
        sound, planted = _consistency(fapi, params, prompts, extra_toks, fwd, _serve_faults(kind),
                                      plen)
        row["consistency"] = {"sound": sound, "planted": planted, "limit": SERVE_CONSIST}
        log(f"    consistency (f32, {'dropless ' if fcfg.moe else ''}prefill + 3 decode steps vs "
            f"forward over {plen + extra}): {sound:.2e} (limit {SERVE_CONSIST:g}); planted: "
            + "; ".join(f"{k} {v:.2e}" for k, v in planted.items()))
        require(sound <= SERVE_CONSIST, f"({label}) prefill/decode differ from the forward: {sound}")
        for name, v in planted.items():
            require(v > SERVE_CONSIST, f"({label}) the consistency check passes a planted fault "
                                       f"({name}: {v})")

        # the decode_32k rows (bf16 caches from the decode specs; g3 also int8)
        if label in ("g1", "g3"):
            row["decode_32k"] = _decode_32k(cfg, api, params, b, sz["long"], dev, sync, label, card)
        if label == "g3":
            row["int8"] = _int8_check(cfg, params, b, sz["int8_steps"], dev, label, card)
        del params, api, fapi
        out[label] = row
    for label in ("g5", "g6"):
        fresh()
        out[label] = _serve_family(label, dev, card, dict(SERVE_FAMILIES[label],
                                                          **sz.get(label, {})))
    fresh()
    out["g4"] = _serve_g4(dev, card)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase (g): {out['seconds']:.1f} s | {card}")
    return out


def _family_faults(kind):
    """The planted faults of the RWKV and encoder-decoder consistency drives,
    by name (each a list of (module, attribute, wrapper of the original))."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import encdec as ED
    from repro_torch.models import rwkv as RW

    if kind == "rwkv":
        def shift_not_carried(orig):
            def step(x, p, cfg, state):
                return orig(x, p, cfg, dict(state, tm_x=torch.zeros_like(state["tm_x"])))
            return step

        def decay_dropped(orig):
            return lambda r, k, v, logw, u, st: orig(r, k, v, torch.zeros_like(logw), u, st)

        def bonus_dropped(orig):
            return lambda r, k, v, logw, u, st: orig(r, k, v, logw, torch.zeros_like(u), st)

        return {"the token shift not carried (tm_x left at zero)":
                [(RW, "rwkv_decode_step", shift_not_carried)],
                "the decay dropped from the recurrence": [(RW, "wkv_recurrent", decay_dropped)],
                "the u bonus dropped": [(RW, "wkv_recurrent", bonus_dropped)]}

    def layer0_cross(orig):
        def step(params, cache, token, pos, cfg):
            cross = {k: v[:1].expand_as(v) for k, v in cache["cross"].items()}
            return orig(params, dict(cache, cross=cross), token, pos, cfg)
        return step

    def sinusoid_at_pos_minus_1(orig):
        return lambda pos, device: orig(pos - 1, device)

    return {"the self cache written at pos - 1":
            [(A, "_write", lambda orig: lambda buf, new, pos: orig(buf, new, pos - 1))],
            "every layer reading layer 0's cross K/V": [(ED, "encdec_decode_step", layer0_cross)],
            "the sinusoid taken at pos - 1": [(ED, "_decode_position", sinusoid_at_pos_minus_1)]}


def _family_inputs(cfg, b, frames, seed, dev, dtype=None):
    """The encoder's frames (b, frames, d) from a seed (N(0, 0.02)), in the
    compute dtype unless ``dtype``; {} for a decoder-only family."""
    import torch

    from repro_torch.models.layers import as_dtype

    if not cfg.encdec:
        return {}
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, frames, cfg.d_model), generator=g, device=dev) * 0.02
    return {"frames": x.to(dtype or as_dtype(cfg.compute_dtype))}


def _family_greedy(api, params, batch, new, prefill_kw):
    """``generate``'s loop over ``prefill`` + ``decode_step`` (these families
    have no ``generate``): ``new`` greedy tokens, (b, new) int32."""
    import torch

    from repro_torch.serve.engine import _sample

    with torch.inference_mode():
        logits, cache = api.prefill(params, batch, **prefill_kw)
        token = _sample(logits[:, -1, :], 0.0, None)[:, None]
        box = {"cache": cache, "token": token, "out": [token]}
        pos = batch["tokens"].shape[1]
        for i in range(new - 1):
            _greedy(api, params, box, pos + i)
    return torch.cat(box["out"], dim=1)


def _wkv_chunk_check(cfg, params, prompts, card):
    """(g5) the chunked WKV against the recurrence on layer 0's inputs over
    the prompt at full width (f32), y and the final state; the decay dropped
    from the recurrence must read above the limit."""
    import torch

    from repro_torch.models import rwkv as RW
    from repro_torch.models.layers import embed_lookup, norm_apply

    b, l = prompts.shape
    h, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    with torch.inference_mode():
        lp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
              for k, v in params["layers"].items()}
        x = norm_apply(embed_lookup(prompts, params["embed"]), lp["ln1"], cfg.norm_type)
        xs = RW._shift(x, torch.zeros_like(x[:, 0]))
        r, k, v, _, logw = RW._projections(x, xs, lp["mix"], cfg)
        ins = [a.reshape(b, l, h, hd) for a in (r, k, v, logw)]
        st0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=prompts.device)
        y_c, s_c = RW._wkv_chunked(*ins, lp["mix"]["u_bonus"], st0, cfg.rwkv.chunk)
        y_r, s_r = RW.wkv_recurrent(*ins, lp["mix"]["u_bonus"], st0)
        y_f, s_f = RW.wkv_recurrent(*ins[:3], torch.zeros_like(ins[3]), lp["mix"]["u_bonus"], st0)
    sound = (_logit_rel(y_c, y_r), _logit_rel(s_c, s_r))
    fault = (_logit_rel(y_c, y_f), _logit_rel(s_c, s_f))
    log(f"    chunked WKV vs the recurrence, layer 0 over the {l}-token prompt (b {b}, f32): y "
        f"{sound[0]:.2e}, final state {sound[1]:.2e} (limit {RWKV_CHUNK_TOL:g}); planted, the "
        f"decay dropped from the recurrence: {fault[0]:.2e}, {fault[1]:.2e} | card: {card}")
    require(max(sound) <= RWKV_CHUNK_TOL, f"(g5) the chunked WKV differs from the recurrence: "
                                          f"{sound}")
    require(min(fault) > RWKV_CHUNK_TOL, f"(g5) the WKV check passes a planted fault: {fault}")
    return {"y_rel": sound[0], "state_rel": sound[1], "planted": fault}


def _family_rows(cfg, params, rows, dev, sync, label, card):
    """decode_step from zero states of the decode specs at each (name, seq,
    batch): ms a token (CUDA events over 4 steps after one), state MiB, peak."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import build_model, zeros_like_specs

    api = build_model(cfg)
    out = {}
    for name, seq, b in rows:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = zeros_like_specs(api.input_specs(ShapeConfig(name, seq, b, "decode"))["cache"],
                                 device=dev)
        mib = _tree_bytes(cache) / 2**20
        box = {"cache": cache, "token": torch.zeros((b, 1), dtype=torch.int32, device=dev),
               "out": []}
        del cache
        with torch.inference_mode():
            _greedy(api, params, box, seq - 5)
            sync()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for i in range(4):
                _greedy(api, params, box, seq - 4 + i)
            e1.record()
            sync()
        ms = e0.elapsed_time(e1) / 4
        out[name] = {"seq": seq, "batch": b, "ms_a_token": ms, "tokens_per_s": b * 1e3 / ms,
                     "state_mib": mib, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"    ({label}) {name} (seq {seq}, b {b}) from a zero state: {ms:.2f} ms a token "
            f"({b * 1e3 / ms:.0f} tokens/s) | state {mib:.1f} MiB | peak "
            f"{out[name]['peak_gib']:.2f} GiB | card: {card}")
        del box
    return out


def _serve_family(label, dev, card, sz) -> dict:
    """(g5) / (g6): an RWKV or encoder-decoder config at full width through
    prefill + decode_step; raises on any failed check."""
    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.models import encdec as ED
    from repro_torch.models import rwkv_model as RM
    from repro_torch.models.registry import build_model
    from repro_torch.serve import engine as ENG

    sync = torch.cuda.synchronize
    t_cell = time.perf_counter()
    cfg = sz.get("cfg") or configs.get(sz["arch"])
    b, plen, new, extra = sz["batch"], sz["prompt"], sz["new"], sz["extra"]
    row = {"arch": sz["arch"], "n_layers": cfg.n_layers, "compute": cfg.compute_dtype}
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    sync()
    row["params"] = sum(x.numel() for x in tree_leaves(params))
    prompts = _serve_prompts(cfg, b, plen, 1, dev)
    inputs = _family_inputs(cfg, b, sz.get("frames", 0), 7, dev)
    batch = {"tokens": prompts, **inputs}
    prefill_kw = {"max_dec_len": sz["max_dec_len"]} if cfg.encdec else {}

    # prefill + greedy decode, twice, under deterministic algorithms: equal to
    # the bit; the launch counters of A-F zeroed before, read after
    _build.reset_launches()
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        toks1 = _family_greedy(api, params, batch, new, prefill_kw)
        sync()
        row["generate_s"] = time.perf_counter() - t0
        row["generate_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        toks2 = _family_greedy(api, params, batch, new, prefill_kw)
    finally:
        torch.use_deterministic_algorithms(False)
    row["kernel_launches"] = {k: _build.LAUNCHES[k] for k in A_TO_F}
    require(torch.equal(toks1, toks2), f"({label}) two greedy runs differ")
    require(tuple(toks1.shape) == (b, new) and int(toks1.max()) < cfg.vocab_size
            and int(toks1.min()) >= 0, f"({label}) tokens out of the vocabulary")
    require(not any(row["kernel_launches"].values()),
            f"({label}) a kernel of A-F launched on this path: {row['kernel_launches']}")
    row["first_tokens"] = toks1[0, :8].tolist()
    try:
        ENG.generate(api, params, prompts[:, :8], ENG.ServeConfig(max_new_tokens=3))
    except TypeError as e:
        refusal = str(e)
    else:
        refusal = None
    require(refusal is not None and "unexpected keyword argument 'max_len'" in refusal,
            f"({label}) generate did not raise the reference's TypeError: {refusal!r}")
    row["generate_refusal"] = refusal

    # prefill ms, decode ms a token, launches, host waits, device share
    with torch.inference_mode():
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        logits, cache = api.prefill(params, batch, **prefill_kw)
        e1.record()
        sync()
        row["prefill_ms"] = e0.elapsed_time(e1)
        if cfg.encdec:
            row["self_cache_mib"] = _tree_bytes(cache["self"]) / 2**20
            row["cross_cache_mib"] = _tree_bytes(cache["cross"]) / 2**20
        else:
            row["state_mib"] = _tree_bytes(cache) / 2**20
        token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        box = {"cache": cache, "token": token, "out": [token]}
        prof = _decode_profile(api, params, box, plen, min(sz["timed_steps"], new - 3), sync)
        del box, cache, logits
    row.update(prof)
    row["tokens_per_s"] = b * 1e3 / prof["ms_a_token"]
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    sizes = (f"self cache {row['self_cache_mib']:.1f} MiB, cross cache "
             f"{row['cross_cache_mib']:.1f} MiB" if cfg.encdec else
             f"state {row['state_mib']:.1f} MiB")
    what = (f"b{b} x {sz['frames']} frames, prompt {plen}, max_dec_len {sz['max_dec_len']}"
            if cfg.encdec else f"b{b} x {plen}")
    log(f"  ({label}) {sz['arch']} {cfg.n_layers} layers, {row['params'] / 1e9:.4f} B params: "
        f"{what} + {new} greedy tokens in {row['generate_s']:.2f} s (deterministic, equal "
        f"twice; A-F launches {sum(row['kernel_launches'].values())}) | prefill "
        f"{row['prefill_ms']:.1f} ms | decode {prof['ms_a_token']:.2f} ms a token = "
        f"{row['tokens_per_s']:.0f} tokens/s | {prof['launches_a_step']} launches a step | device "
        f"share {100 * (prof['device_share'] or 0):.1f} % | host waits a step "
        f"{prof['host_waits_a_step']} {prof['waits_at'] or ''}| {sizes} | peak "
        f"{row['peak_gib']:.2f} GiB | card: {card}")
    log("    its top kernels (device ms, launches): " + "; ".join(
        f"{n} {ms:.2f} x{c}" for ms, c, n in prof["top_kernels"]))
    log("    device ms of a step by kind: "
        + "; ".join(f"{k} {v:.2f}" for k, v in prof["device_ms_by_kind"].items())
        + f" | generate raises {refusal!r}")
    require(prof["host_waits_a_step"] == 0,
            f"({label}) a greedy decode step waited for the host: {prof['waits_at']}")

    # consistency in float32 compute, with planted faults
    fcfg = cfg.replace(compute_dtype="float32", remat=False)
    fapi = build_model(fcfg)
    extra_toks = _serve_prompts(cfg, b, extra, 2, dev)
    f_inputs = {k: v.float() for k, v in inputs.items()}
    fwd = ED.encdec_forward if cfg.encdec else RM.rwkv_forward
    kind = "encdec" if cfg.encdec else "rwkv"
    sound, planted = _consistency(fapi, params, prompts, extra_toks, fwd, _family_faults(kind),
                                  plen, inputs=f_inputs,
                                  prefill_key="max_dec_len" if cfg.encdec else None)
    row["consistency"] = {"sound": sound, "planted": planted, "limit": SERVE_CONSIST}
    log(f"    consistency (f32, prefill + 3 decode steps vs the forward over {plen + extra} "
        f"tokens): {sound:.2e} (limit {SERVE_CONSIST:g}); planted: "
        + "; ".join(f"{k} {v:.2e}" for k, v in planted.items()))
    require(sound <= SERVE_CONSIST, f"({label}) prefill/decode differ from the forward: {sound}")
    for name, v in planted.items():
        require(v > SERVE_CONSIST, f"({label}) the consistency check passes a planted fault "
                                   f"({name}: {v})")
    del fapi
    if not cfg.encdec:
        row["wkv_chunked_vs_recurrent"] = _wkv_chunk_check(cfg, params, prompts, card)
    if sz["rows"]:
        row["rows"] = _family_rows(cfg, params, sz["rows"], dev, sync, label, card)
    row["seconds"] = time.perf_counter() - t_cell
    log(f"    ({label}): {row['seconds']:.1f} s | {card}")
    return row


def _decode_32k(cfg, api, params, b, seq, dev, sync, label, card):
    """decode_step on a zero cache of ``seq`` entries (the decode specs, bf16;
    for a dense config also int8): ms a token, cache GiB, peak GiB."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import build_model, zeros_like_specs

    rows = {}
    kinds = [("bf16", cfg)]
    if cfg.mla is None and cfg.ssm is None:
        kinds.append(("int8", cfg.replace(kv_cache_dtype="int8")))
    for name, c in kinds:
        gc.collect()
        torch.cuda.empty_cache()
        a = build_model(c)
        specs = a.input_specs(ShapeConfig("decode_32k_b8", seq, b, "decode"))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cache = zeros_like_specs(specs["cache"], device=dev)
        token = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        box = {"cache": cache, "token": token, "out": []}
        with torch.inference_mode():
            _greedy(a, params, box, seq - 16)
            sync()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for i in range(4):
                _greedy(a, params, box, seq - 15 + i)
            e1.record()
            sync()
        ms = e0.elapsed_time(e1) / 4
        rows[name] = {"ms_a_token": ms, "tokens_per_s": b * 1e3 / ms,
                      "cache_gib": _tree_bytes(cache) / 2**30,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "peak_over_params_and_cache_gib":
                          (torch.cuda.max_memory_allocated() - base - _tree_bytes(cache)) / 2**30}
        log(f"    ({label}) decode_32k (seq {seq}, b {b}), {name} cache: {ms:.2f} ms a token "
            f"({rows[name]['tokens_per_s']:.0f} tokens/s) | cache {rows[name]['cache_gib']:.2f} "
            f"GiB | peak {rows[name]['peak_gib']:.2f} GiB | card: {card}")
        del box, cache
    return rows


def _int8_check(cfg, params, b, steps, dev, label, card):
    """``generate`` under the int8 cache raises the reference's TypeError; 64
    tokens decoded from a zero int8 cache and from a zero bf16 cache give
    logits at the 65th within SERVE_INT8 relative and the same argmax."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import build_model, zeros_like_specs
    from repro_torch.serve import engine as ENG

    qcfg = cfg.replace(kv_cache_dtype="int8")
    prompts = _serve_prompts(cfg, b, steps + 1, 3, dev)
    try:
        ENG.generate(build_model(qcfg), params, prompts[:, :8], ENG.ServeConfig(max_new_tokens=3))
    except TypeError as e:
        refusal = str(e)
    else:
        refusal = None
    require(refusal is not None and "same dtypes, got float32, int8" in refusal,
            f"({label}) int8 generate did not raise the reference's TypeError: {refusal!r}")
    last = {}
    with torch.inference_mode():
        for name, c in (("int8", qcfg), ("bf16", cfg)):
            a = build_model(c)
            cache = zeros_like_specs(a.input_specs(ShapeConfig("d", steps + 1, b, "decode"))["cache"],
                                     device=dev)
            for i in range(steps + 1):
                logits, cache = a.decode_step(params, cache, prompts[:, i:i + 1], i)
            last[name] = logits[:, 0, :cfg.vocab_size].float()
            del cache
    rel = _logit_rel(last["int8"], last["bf16"])
    same = bool(torch.equal(last["int8"].argmax(-1), last["bf16"].argmax(-1)))
    log(f"    ({label}) int8 generate raises {refusal!r}; after {steps} tokens from zero caches "
        f"the int8 logits at token {steps + 1} read {rel:.2e} of the bf16 cache's (limit "
        f"{SERVE_INT8:g}), argmax {'equal' if same else 'NOT equal'} | card: {card}")
    require(rel < SERVE_INT8 and same, f"({label}) int8 decode strays from the bf16 cache")
    return {"refusal": refusal, "rel": rel, "argmax_equal": same}


def _serve_g4(dev, card):
    """(g4) the card against the port on the CPU at the smoke configs."""
    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve import engine as ENG

    rows = {}
    for arch in SERVE_G4_ARCHS:
        cfg = configs.get_smoke(arch)
        api = build_model(cfg)
        p_cpu = api.init(torch.Generator().manual_seed(0), device="cpu")
        p_card = tree_map(lambda x: x.to(dev), p_cpu)
        prompts = _serve_prompts(cfg, 2, 16, 4, "cpu")
        toks = {}
        for name, sc in (("greedy", ENG.ServeConfig(8)), ("t0.7", ENG.ServeConfig(8, 0.7, 5))):
            cpu = ENG.generate(api, p_cpu, prompts, sc)
            card1 = ENG.generate(api, p_card, prompts.to(dev), sc)
            card2 = ENG.generate(api, p_card, prompts.to(dev), sc)
            toks[name] = bool(torch.equal(card1.cpu(), cpu) and torch.equal(card1, card2))

        def logits_of(params, d):
            with torch.inference_mode():
                lg, cache = api.prefill(params, {"tokens": prompts.to(d)}, max_len=20)
                outs = [lg[:, -1]]
                for i in range(3):
                    lg, cache = api.decode_step(params, cache, prompts[:, i:i + 1].to(d), 16 + i)
                    outs.append(lg[:, 0])
            return [o[:, :cfg.vocab_size].cpu() for o in outs]

        want = logits_of(p_cpu, "cpu")
        rel = max(_logit_rel(g, w) for g, w in zip(logits_of(p_card, dev), want))
        with _Plant(_serve_faults("attn" if cfg.ssm is None else "hybrid")
                    ["the cache written at pos - 1" if cfg.ssm is None
                     else "the SSM state's decay dropped"]):
            fault = max(_logit_rel(g, w) for g, w in zip(logits_of(p_card, dev), want))
        rows[arch] = {"tokens_equal": toks, "logits_rel": rel, "planted": fault}
        log(f"  (g4) {arch} smoke: card vs CPU tokens greedy {toks['greedy']}, sampled "
            f"{toks['t0.7']} (equal twice on the card), logits {rel:.2e} (limit "
            f"{SERVE_G4_TOL:g}), planted fault {fault:.2e} | {card}")
        require(all(toks.values()), f"(g4) {arch}: the card's tokens differ from the CPU's")
        require(rel <= SERVE_G4_TOL < fault, f"(g4) {arch}: logits {rel}, fault {fault}")
    for arch, fault_name in SERVE_G4_FAMILIES.items():
        rows[arch] = _serve_g4_family(arch, fault_name, dev, card)
    key = ENG.split(ENG.prng_key(2**32 + 9))[1]
    bits_equal = bool(torch.equal(ENG.random_bits(key, (8, 102400), dev).cpu(),
                                  ENG.random_bits(key, (8, 102400), "cpu")))
    log(f"  (g4) threefry bits (8, 102400) card vs CPU: {'equal' if bits_equal else 'NOT equal'}")
    require(bits_equal, "(g4) the threefry bits differ between the card and the CPU")
    rows["threefry_bits_equal"] = bits_equal
    return rows


def _serve_g4_family(arch, fault_name, dev, card):
    """(g4) for a family that serves through prefill + decode_step: greedy
    tokens equal on the card (twice) and the CPU, the prefill's and 3 decode
    steps' logits within SERVE_G4_TOL, a planted fault above it."""
    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.models.registry import build_model

    cfg = configs.get_smoke(arch)
    api = build_model(cfg)
    p_cpu = api.init(torch.Generator().manual_seed(0), device="cpu")
    p_card = tree_map(lambda x: x.to(dev), p_cpu)
    prompts = _serve_prompts(cfg, 2, 16, 4, "cpu")
    inputs = _family_inputs(cfg, 2, 24, 6, "cpu")
    kw = {"max_dec_len": 24} if cfg.encdec else {}

    def batch_on(d):
        return {"tokens": prompts.to(d), **{k: v.to(d) for k, v in inputs.items()}}

    cpu = _family_greedy(api, p_cpu, batch_on("cpu"), 8, kw)
    card1 = _family_greedy(api, p_card, batch_on(dev), 8, kw)
    card2 = _family_greedy(api, p_card, batch_on(dev), 8, kw)
    toks = bool(torch.equal(card1.cpu(), cpu) and torch.equal(card1, card2))

    def logits_of(params, d):
        with torch.inference_mode():
            lg, cache = api.prefill(params, batch_on(d), **kw)
            outs = [lg[:, -1]]
            for i in range(3):
                lg, cache = api.decode_step(params, cache, prompts[:, i:i + 1].to(d), 16 + i)
                outs.append(lg[:, 0])
        return [o[:, :cfg.vocab_size].cpu() for o in outs]

    want = logits_of(p_cpu, "cpu")
    rel = max(_logit_rel(g, w) for g, w in zip(logits_of(p_card, dev), want))
    with _Plant(_family_faults("encdec" if cfg.encdec else "rwkv")[fault_name]):
        fault = max(_logit_rel(g, w) for g, w in zip(logits_of(p_card, dev), want))
    log(f"  (g4) {arch} smoke (prefill + decode_step): card vs CPU greedy tokens {toks} (equal "
        f"twice on the card), logits {rel:.2e} (limit {SERVE_G4_TOL:g}), planted fault "
        f"({fault_name}) {fault:.2e} | {card}")
    require(toks, f"(g4) {arch}: the card's tokens differ from the CPU's")
    require(rel <= SERVE_G4_TOL < fault, f"(g4) {arch}: logits {rel}, fault {fault}")
    return {"tokens_equal": {"greedy": toks}, "logits_rel": rel, "planted": fault}


def _update_rel(got, want, start) -> float:
    """||got - want|| / ||want - start|| over all floating leaves: how far a
    step's parameter update parts from another's, over the update's size."""
    import torch

    from repro_torch._tree import tree_leaves

    num = den = 0.0
    for g, w, s0 in zip(tree_leaves(got), tree_leaves(want), tree_leaves(start)):
        if isinstance(w, torch.Tensor) and w.is_floating_point():
            num += float(torch.sum(torch.square((g - w).double())))
            den += float(torch.sum(torch.square((w - s0).double())))
    return (num / den) ** 0.5 if den else float("inf")


def shard_phase(dev, card: str, t1_step_ms: float, sizes=None) -> dict:
    """Phase (m): the model side of sharding and the launch tier on the card.
    (m1) the mesh step against the mesh-less one with planted faults, then
    ``train(mesh=)`` at (t1)'s widths; (m2) ``reshard`` onto ``plan_mesh()``;
    (m3) the dry-run of perf_iter's LM cells on the meta device and the
    compute term of (t1)'s configuration held under (t1)'s measured step;
    (m4) ``perf_iter --svd`` on the card.  A-F launch 0 times.  Raises on any
    failed check."""
    import gc
    import shutil

    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.dist import Mesh, make_host_mesh
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, perf_iter
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import loop
    from repro_torch.train.elastic import plan_mesh, reshard

    sz = dict(SHARD, **(sizes or {}))
    work = ROOT / "build" / "chip_smoke_shard"
    shutil.rmtree(work, ignore_errors=True)
    out = {"card": card}
    t_phase = time.perf_counter()
    launches0 = dict(_build.LAUNCHES)
    sync = torch.cuda.synchronize

    def fresh():
        gc.collect()
        sync()
        torch.cuda.empty_cache()

    # -- (m1) the mesh step against the mesh-less step, then train(mesh=) --------
    cfg = sz.get("cfg") or configs.get(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    api = build_model(cfg)
    mesh = make_host_mesh(*sz["mesh"], device=dev)
    opt = OptimizerConfig(lr=sz["lr"], warmup_steps=0, total_steps=100)
    params0 = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    state0 = adamw_init(params0)
    batch = batch_for_step(0, 0, batch=sz["batch"], seq=sz["seq_check"], vocab=cfg.vocab_size,
                           device=dev)

    def one(step_mesh):
        p, _, loss, _ = loop.train_step(api, opt, params0, state0, batch, 0, spectral=False,
                                        mesh=step_mesh)
        sync()
        return p, float(loss)

    p_ref, l_ref = one(None)
    faults = {"sound": None,
              "slices summed, not averaged": ("_average", lambda orig: lambda acc, n: acc),
              "one slice dropped": ("_accumulate", None)}
    check = {}
    for label, fault in faults.items():
        saved = None
        if fault is not None:
            name, make = fault
            saved = getattr(loop, name)
            if make is None:                 # the last slice's sum left out
                calls = {"n": 0}

                def dropped(acc, x, home, orig=saved, calls=calls, n=sz["mesh"][0]):
                    calls["n"] += 1      # a slice adds its loss, then its gradients
                    return acc if calls["n"] > 2 * (n - 1) else orig(acc, x, home)

                setattr(loop, name, dropped)
            else:
                setattr(loop, name, make(saved))
        try:
            p_mesh, l_mesh = one(mesh)
        finally:
            if saved is not None:
                setattr(loop, name, saved)
        row = {"loss": l_mesh, "loss_rel": abs(l_mesh - l_ref) / abs(l_ref),
               "update_rel": _update_rel(p_mesh, p_ref, params0),
               "params_max_abs": max(float((a - b).abs().max())
                                     for a, b in zip(tree_leaves(p_mesh), tree_leaves(p_ref)))}
        del p_mesh
        check[label] = row
        within = row["loss_rel"] <= SHARD_TOL["loss"] and row["update_rel"] <= SHARD_TOL["update"]
        log(f"  (m1) {label}: mesh {sz['mesh']} step vs mesh-less at b{sz['batch']} x "
            f"s{sz['seq_check']}: loss {l_mesh:.6f} vs {l_ref:.6f}, rel {row['loss_rel']:.2e} "
            f"(limit {SHARD_TOL['loss']:g}); update rel {row['update_rel']:.2e} (limit "
            f"{SHARD_TOL['update']:g}); params max |delta| {row['params_max_abs']:.2e} | {card}")
        if fault is None:
            require(within, "(m1) the mesh step differs from the mesh-less step beyond the limits")
        else:
            require(not within, f"(m1) the check passes a planted fault ({label})")
    out["m1_check"] = check
    host_params = tree_map(lambda x: x.cpu(), params0)
    del p_ref, params0, state0, batch
    fresh()

    # train(mesh=) at batch 4 x seq 4096: ms a step, fwd+bwd share, peak, waits
    run = RunConfig(model=cfg, optimizer=OptimizerConfig(warmup_steps=2, total_steps=100),
                    steps=sz["steps"], log_every=1, checkpoint_every=0,
                    checkpoint_dir=str(work / "m1"), seed=0)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for k in SPLIT_KERNELS:              # the split kernel's launches over this bf16 training
        _build.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with _SpanClock() as clock:
        res = loop.train(run, batch_size=sz["batch"], seq_len=sz["seq"], device=dev, mesh=mesh)
    sync()
    split_launches = {k: _build.LAUNCHES[k] for k in SPLIT_KERNELS}
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    split = clock.split()
    for st in split:
        require(st["pieces"] == ["fwd_bwd", "optimizer"],
                f"(m1) unexpected pieces of a mesh step: {st['pieces']}")
    losses = [v for _, v in res.losses]
    require(len(losses) == sz["steps"] and all(v == v and abs(v) < 1e30 for v in losses),
            f"(m1) train(mesh=) losses not finite: {losses}")
    steady = split[1:] or split
    step_ms = statistics.mean(st["step_ms"] for st in steady)
    fb_ms = statistics.mean(st["fwd_bwd_ms"] for st in steady)
    fresh()
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    holder = {"p": reshard(params, mesh), "s": adamw_init(params)}
    del params

    def mesh_step(step, holder=holder):
        b = batch_for_step(0, step, batch=sz["batch"], seq=sz["seq"], vocab=cfg.vocab_size,
                           device=dev)
        holder["p"], holder["s"], _, _ = loop.train_step(api, run.optimizer, holder["p"],
                                                         holder["s"], b, step, spectral=False,
                                                         mesh=mesh)

    mesh_step(0)
    waits, where = count_syncs(lambda: mesh_step(1))
    del holder, mesh_step
    fresh()
    # the mesh-less step at the same batch, to see whether it fits
    try:
        params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        b = batch_for_step(0, 0, batch=sz["batch"], seq=sz["seq"], vocab=cfg.vocab_size,
                           device=dev)
        torch.cuda.reset_peak_memory_stats()
        loop.train_step(api, run.optimizer, params, adamw_init(params), b, 0, spectral=False)
        sync()
        meshless = f"fits, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    except torch.cuda.OutOfMemoryError as e:
        meshless = f"does not fit: {str(e).splitlines()[0][:160]}"
    params = b = None
    fresh()
    out["m1_train"] = {"losses": losses, "steps": split, "step_ms": step_ms,
                       "fwd_bwd_ms": fb_ms, "fwd_bwd_share": fb_ms / step_ms, "wall_s": wall,
                       "peak_bytes": peak, "host_waits_a_step": waits, "waits_at": where,
                       "meshless_same_batch": meshless, "split_launches": split_launches}
    log(f"  (m1) train(mesh={sz['mesh']}) b{sz['batch']} x s{sz['seq']}: losses "
        f"{[round(v, 4) for v in losses]} | {step_ms:.1f} ms a step after the first (fwd+bwd "
        f"{fb_ms:.1f} ms, {100 * fb_ms / step_ms:.1f} %) | peak {peak / 2**30:.2f} GiB | "
        f"{waits} host waits a step {where or ''} | {card}")
    for i, st in enumerate(split):
        log(f"    step {i}: {st['step_ms']:.1f} ms = fwd+bwd of the slices {st['fwd_bwd_ms']:.1f} "
            f"+ AdamW {st['optimizer_ms']:.1f}")
    log(f"    the mesh-less step at b{sz['batch']} x s{sz['seq']}: {meshless}")
    log(f"    the split kernel's launches over train(mesh=): {split_launches}")
    require(split_launches["split_bf16x3"] > 0
            and split_launches["split_bf16x3"] == split_launches["repeat_bf16x3"],
            f"(m1) the bf16 backward did not split each product once: {split_launches}")
    require(waits == 0, f"(m1) a mesh step that neither logs nor saves waited for the card "
                        f"{waits} times: {where}")

    # -- (m2) reshard a host tree onto plan_mesh() ---------------------------------
    pmesh = plan_mesh(device=dev)
    sync()
    t0 = time.perf_counter()
    placed = reshard(host_params, pmesh)
    sync()
    m2_s = time.perf_counter() - t0
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    equal = all(a.dtype == b.dtype and a.device.type == dev.type and torch.equal(
                a.cpu().view(ints[a.element_size()]), b.view(ints[b.element_size()]))
                for a, b in zip(tree_leaves(placed), tree_leaves(host_params)))
    n_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(host_params))
    out["m2"] = {"mesh": pmesh.shape, "seconds": m2_s, "bytes": n_bytes, "equal": equal}
    log(f"  (m2) reshard of (m1)'s {n_bytes / 2**30:.2f} GiB host tree onto plan_mesh() "
        f"{pmesh.shape}: {m2_s:.3f} s, {'equal to the bit' if equal else 'NOT equal'} | {card}")
    require(equal, "(m2) reshard changed the parameters")
    del placed, host_params
    fresh()

    # -- (m3) the dry-run on the meta device -----------------------------------------
    m3 = {}
    for arch, shape in sz.get("lm_cells", SHARD_CELLS):
        r = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=work / "dryrun")
        rt = r["roofline"]
        m3[f"{arch}/{shape}"] = {k: rt[k] for k in ("t_compute_s", "t_memory_s",
                                                    "t_collective_s")}
        m3[f"{arch}/{shape}"].update(useful=r["useful_flops_ratio"], counted_s=r["compile_s"])
        log(f"  (m3) {arch} {shape} on 16x16 (counts against data-sheet peaks): compute "
            f"{rt['t_compute_s'] * 1e3:.1f} ms, memory {rt['t_memory_s'] * 1e3:.1f} ms, "
            f"collective {rt['t_collective_s'] * 1e3:.1f} ms, useful FLOPs "
            f"{r['useful_flops_ratio']:.3f} (counted in {r['compile_s']} s)")
    import numpy as np

    one_card = Mesh(np.full((1, 1), torch.device("meta"), dtype=object), ("data", "model"))
    t1_cfg = sz.get("t1_cfg") or configs.get(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    t1_shape = ShapeConfig("t1", sz.get("t1_seq", TRAIN_SEQ), 1, "train")
    c = dryrun.lower_cell(t1_cfg, t1_shape, one_card, multi_pod=False, shape_name="t1")
    compute_ms, memory_ms = c.flops / PEAK_FLOPS * 1e3, c.bytes / HBM_BW * 1e3
    m3["t1"] = {"flops": c.flops, "bytes": c.bytes, "compute_ms": compute_ms,
                "memory_ms": memory_ms, "t1_step_ms": t1_step_ms,
                "compute_share": compute_ms / t1_step_ms}
    log(f"  (m3) (t1)'s configuration on one card: {c.flops:.4e} FLOPs (products) -> compute "
        f"term {compute_ms:.2f} ms at 989 TFLOP/s; {c.bytes:.4e} bytes (unfused) -> "
        f"{memory_ms:.2f} ms at 3.35 TB/s; (t1)'s measured AdamW step {t1_step_ms:.1f} ms: the "
        f"count is {100 * compute_ms / t1_step_ms:.1f} % of it | {card}")
    require(compute_ms <= t1_step_ms, f"(m3) the compute term of (t1), {compute_ms:.2f} ms, "
                                      f"exceeds its measured step, {t1_step_ms:.2f} ms")
    out["m3"] = m3

    # -- (m4) perf_iter --svd on the card ------------------------------------------------
    m4 = []
    cells = sz.get("svd_cells") or (
        [(m, n, r, b, None) for m, n, r, b in perf_iter.SVD_CELLS]
        + [c for c in perf_iter.FLEET_CELLS if c[4] <= M4_MAX_DEPTH])
    for rec in perf_iter.run_svd_cells(work / "dryrun", device=dev, cells=cells):
        rt = rec["roofline"]
        m4.append({"cell": f"{rec['arch']}/{rec['shape']}", "flops": rt["flops_per_device"],
                   "bytes": rt["bytes_per_device"], "useful": rec["useful_flops_ratio"],
                   "seconds": rec["seconds"]})
        log(f"  (m4) {rec['arch']} {rec['shape']}: {rt['flops_per_device']:.4e} FLOPs "
            f"(products), {rt['bytes_per_device']:.4e} bytes (unfused), useful "
            f"{rec['useful_flops_ratio']:.3f}, {rec['seconds'] * 1e3:.2f} ms a flush | {card}")
    out["m4"] = m4

    launched = {k: _build.LAUNCHES[k] - launches0[k] for k in A_TO_F}
    out["launches_a_f"] = launched
    log(f"  (m) launches of A-F over the phase: {launched}")
    require(not any(launched.values()), f"(m) a kernel of A-F launched on the path: {launched}")
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase (m): {out['seconds']:.1f} s | {card}")
    return out


def split_phase(dev, card: str) -> dict:
    """Phase (s): the split kernel S at ``SPLIT_SHAPES`` against its plain
    version, bit for bit, and timed.  Returns the ``kernels`` line's S row
    (the first shape) with every shape's figures under ``cases``.  Raises on
    any failed check."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import split_bf16x3 as SB
    from repro_torch.models.layers import _chunks

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def same_bits(got, want):
        """Per chunk: NaN where ``want`` has NaN, the same bits elsewhere."""
        for x, y in zip(got, want):
            nan = y.isnan()
            if not (torch.equal(x.isnan(), nan) and torch.equal(
                    x.masked_fill(nan, 0).view(torch.int16), y.masked_fill(nan, 0).view(torch.int16))):
                return False
        return True

    cases = []
    for label, kernel, shape, dim in SPLIT_SHAPES:
        length = _chunks(shape[dim])[1]
        # a cotangent's spread of magnitudes (a normal times e^(10 x normal)),
        # the special values planted at random places
        x = torch.randn(shape, generator=gen, device=dev) * torch.exp(
            torch.randn(shape, generator=gen, device=dev) * 10)
        at = torch.randint(0, x.numel(), (64 * len(SPLIT_SPECIALS),), generator=gen, device=dev)
        x.view(-1)[at] = torch.tensor(SPLIT_SPECIALS, device=dev).repeat(64)
        if kernel == "repeat_bf16x3":
            x = x.bfloat16()
        fn = getattr(SB, f"{kernel}_cuda")
        plain = getattr(SB, f"{kernel}_plain")
        before = _build.LAUNCHES[kernel]
        got = fn(x, dim, length)
        torch.cuda.synchronize()
        require(_build.LAUNCHES[kernel] == before + 1, f"(s) {kernel} did not count its launch")
        want = plain(x, dim, length)
        equal = same_bits(got, want)
        del got, want
        torch.cuda.empty_cache()
        nbytes = x.numel() * (10 if kernel == "split_bf16x3" else 8)
        row = {"case": label, "kernel": kernel, "shape": list(shape), "dim": dim, "length": length,
               "equal": equal, "ms": time_ms(lambda: fn(x, dim, length)),
               "plain_ms": time_ms(lambda: plain(x, dim, length), reps=3),
               "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3, "bytes": nbytes}
        cases.append(row)
        log(f"  (s) {kernel} {label} {tuple(shape)} along {dim} by {length}: "
            f"{'equal to its plain version' if equal else 'NOT equal to its plain version'} | "
            f"kernel {row['ms']:.3f} ms ({100 * row['bound_ms'] / row['ms']:.1f} % of its bytes "
            f"bound {row['bound_ms']:.3f} ms) | plain {row['plain_ms']:.3f} ms | {card}")
        require(equal, f"(s) {kernel} differs from its plain version at {label} {shape}")
        del x
        torch.cuda.empty_cache()
    head = cases[0]
    seconds = time.perf_counter() - t_phase
    log(f"  phase (s): {seconds:.1f} s | {card}")
    return {"ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": f"float32 {tuple(head['shape'])} along {head['dim']} by {head['length']}",
            "cases": cases, "seconds": seconds}


# phase (x): the port's four examples on the card at the reference's defaults,
# through their main(argv).  The kernels each example's route reaches (PERF.md
# section 6): quickstart E (method="fmm", n = 300 >= FMM_MIN_N; 8 launches a
# full update); streaming B (auto: fused at
# (600, 400, r 12) and on the structured demo's rank-1 steps; the service
# parts run direct); compressed_dp B (the trackers, auto at (64, 128, r 8),
# in the ranks' processes); train_lm none.  Beside its default run through
# main, train_lm's repro-100m configuration (the reference's "assignment
# driver" width) runs through the example's run_config and train.train for
# X_TRAIN["steps"] steps, resumed to X_TRAIN["resume_to"] and held to the bit
# against an unbroken run under deterministic algorithms; its first loss within
# TRAIN_FIRST_LOSS_SLACK of ln(vocab), every loss finite.  Not through main:
# main's own check (the last logged loss below the first) needs a longer run
# at that width than a smoke test gives it (on the H100, 100 steps at this
# schedule left the loss at 10.45-10.73 from 10.51 at step 0).
X_TRAIN = {"steps": 20, "resume_to": 30}
# phase (s): (name, kernel, shape, dim) at (t1)'s widths (granite-34b: 48
# heads, MQA, d_model 6144, d_ff 24576, seq 4096): the score cotangent dS of
# q k^T (dim 2 for dS k, dim 1 for q^T dS), the MLP input matrix's cotangent
# (dim 2 for its dx, dim 1 for its dW), and the bf16 operands beside them:
# q for q^T dS, the MLP input matrix for dx.  The row of the ``kernels`` line
# is the first.
SPLIT_SHAPES = (("scores dS k", "split_bf16x3", (1, 48 * 4096, 4096), 2),
                ("scores q^T dS", "split_bf16x3", (1, 48 * 4096, 4096), 1),
                ("mlp dx", "split_bf16x3", (1, 4096, 24576), 2),
                ("mlp dW", "split_bf16x3", (1, 4096, 24576), 1),
                ("q for q^T dS", "repeat_bf16x3", (1, 48 * 4096, 128), 1),
                ("w_in for dx", "repeat_bf16x3", (1, 6144, 24576), 2))
SPLIT_SPECIALS = (0.0, -0.0, 1e-40, -1e-45, 7.7e-34, -3.3e38, float("inf"), -float("inf"),
                  float("nan"))
X_ROUTES = {"quickstart": ("nearfield",), "streaming": ("fused_update_truncated",),
            "compressed_dp": ("fused_update_truncated",), "train_lm": ()}


def examples_phase(dev, card: str) -> dict:
    """Phase (x): each example's ``main`` on the card; its self-checks raise
    on failure (nothing is caught).  Launch counts of A-F are zeroed before
    each example and read after it (compressed_dp's from its ranks), and
    held to ``X_ROUTES``: each listed kernel launched, every other one not.
    E launches on the quickstart whether or not its FMM plans overflowed (an
    overflowed member's product is replaced after the FMM's, as the
    reference's ``lax.cond`` picks); the count of overflowed plans is
    printed."""
    import math
    import tempfile

    import torch

    from repro_torch.kernels import _build
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import loop

    sys.path.insert(0, str(ROOT / "examples"))
    import compressed_dp_torch
    import quickstart_torch
    import streaming_svd_torch
    import train_lm_torch

    t_phase = time.perf_counter()
    out, launches_all = {}, {k: 0 for k in _build.LAUNCHES}

    def run(label, fn):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        fig = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: _build.LAUNCHES[k] for k in A_TO_F}
        if label == "compressed_dp":
            require(not any(launched.values()), f"(x) the parent of compressed_dp launched {launched}")
            launched = fig["launches"]
        for k, v in launched.items():
            launches_all[k] += v
        return fig, seconds, launched

    def held(label, launched, figures):
        want = X_ROUTES[label]
        for k, v in launched.items():
            if k in want:
                require(v > 0, f"(x) {label}: kernel {k} did not launch ({launched})")
            elif k not in want:
                require(v == 0, f"(x) {label}: kernel {k} launched {v} times off its route")
        out[label] = {**figures, "launches": launched}
        log(f"  (x) {label}: {figures['seconds']:.1f} s | " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in figures.items() if k != "seconds")
            + f" | launches {launched} | {card}")

    fig, sec, launched = run("quickstart", lambda: quickstart_torch.main([]))
    held("quickstart", launched,
         {"seconds": sec, "eq32_error": fig["eq32_error"], "orthogonality": fig["orthogonality"],
          "sigma_max": fig["sigma_max"], "fmm_plans_overflowed": fig["fmm_plans_overflowed"]})

    fig, sec, launched = run("streaming", lambda: streaming_svd_torch.main([]))
    held("streaming", launched,
         {"seconds": sec, "stream_s": fig["stream"]["seconds"],
          "dominant_rel_dev": fig["stream"]["dominant_rel_dev"],
          "max_rel_dev": fig["stream"]["max_rel_dev"], "service_rounds": fig["service"]["rounds"],
          "structured_parity": fig["structured"]["parity"],
          "deletion_parity": fig["deletion"]["parity"], "obs_spans": fig["obs"]["spans"],
          "ortho_drift": fig["obs"]["ortho_drift"]})

    fig, sec, launched = run("compressed_dp", lambda: compressed_dp_torch.main([]))
    held("compressed_dp", launched,
         {"seconds": sec, "loop_s": fig["loop_seconds"], "world": fig["world"],
          "backend": fig["backend"], "dense_loss": fig["dense_loss"],
          "compressed_loss": fig["compressed_loss"],
          "wire_bytes": f"{fig['wire_bytes']['dense']} -> {fig['wire_bytes']['compressed']}"})

    with tempfile.TemporaryDirectory() as tmp:
        def train_lm():
            tiny = train_lm_torch.main(["--ckpt-dir", f"{tmp}/tiny"])

            def big(steps, where):
                args = train_lm_torch.parse(["--scale", "100m", "--steps", str(steps),
                                             "--ckpt-dir", f"{tmp}/{where}"])
                return loop.train(train_lm_torch.run_config(args), batch_size=args.batch,
                                  seq_len=args.seq, device=dev)

            torch.use_deterministic_algorithms(True)
            try:
                first = big(X_TRAIN["steps"], "a")
                resumed = big(X_TRAIN["resume_to"], "a")
                whole = big(X_TRAIN["resume_to"], "b")
            finally:
                torch.use_deterministic_algorithms(False)
            vocab = train_lm_torch.model_for_scale("100m").vocab_size
            losses = [v for res in (first, resumed, whole) for _, v in res.losses]
            require(all(math.isfinite(v) for v in losses), "(x) train_lm 100m: a loss is not finite")
            require(abs(first.losses[0][1] - math.log(vocab)) <= TRAIN_FIRST_LOSS_SLACK,
                    f"(x) train_lm 100m: first loss {first.losses[0][1]} not within "
                    f"{TRAIN_FIRST_LOSS_SLACK} of ln({vocab})")
            (sa, la), (sb, lb) = CK.restore(f"{tmp}/a", None), CK.restore(f"{tmp}/b", None)
            same = sa == sb == X_TRAIN["resume_to"] and len(la) == len(lb) and all(
                a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
                for a, b in zip(la, lb))
            require(resumed.resumed_from == X_TRAIN["steps"],
                    f"(x) train_lm resumed from {resumed.resumed_from}")
            require(same and resumed.losses == [x for x in whole.losses
                                                if x[0] >= X_TRAIN["steps"]],
                    "(x) train_lm: the resumed 100m run is not the unbroken one to the bit")
            return {"tiny": tiny, "first": first, "resumed": resumed, "leaves": len(la)}

        fig, sec, launched = run("train_lm", train_lm)
    held("train_lm", launched,
         {"seconds": sec, "tiny_loss": f"{fig['tiny']['first_loss']:.4f} -> "
                                       f"{fig['tiny']['last_loss']:.4f}",
          "100m_loss": f"{fig['first'].losses[0][1]:.4f} -> {fig['first'].losses[-1][1]:.4f}",
          "100m_resumed_loss": f"{fig['resumed'].losses[0][1]:.4f} -> "
                               f"{fig['resumed'].losses[-1][1]:.4f}",
          "resume": f"from step {X_TRAIN['steps']} to {X_TRAIN['resume_to']}, equal to the bit "
                    f"({fig['leaves']} leaves)"})
    out["launches"] = launches_all
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase (x): {out['seconds']:.1f} s | {card}")
    return out


def main() -> int:
    # phase (t3) runs with deterministic algorithms, and cuBLAS reads this
    # before the card's first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import api, convert, updates
    from repro_torch.core import fmm as FMM
    from repro_torch.core import secular as SEC
    from repro_torch.core.eigh_update import make_plan
    from repro_torch.kernels import _build, cauchy_matmul as CM, fused_update as FU
    from repro_torch.kernels import nearfield as NF, secular_newton as SN
    from repro_torch.kernels import sparse_proj as SP
    from repro_torch.updates import sketch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # -- phase 1: build ---------------------------------------------------------
    t_run = t0 = time.perf_counter()
    out_dir = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s into {out_dir.relative_to(ROOT)}")
    for f in sorted(out_dir.glob("*.log")):
        regs = [ln.strip() for ln in f.read_text().splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {f.stem}: " + " | ".join(regs[-2:]))

    # -- phase (t), the training path: first, while the card's memory is
    # empty (granite-34b's 2 layers peak at ~50 GiB; the later phases' states
    # would not leave room for it) ---------------------------------------------
    log("phase (t): training")
    train_out = train_phase(dev, card)
    log("train " + json.dumps(train_out))

    # -- phase (g), token serving: after (t), while the card's memory is still
    # free of the later phases' states (g2's zamba2-7b holds 27 GB of params)
    log("phase (g): token serving")
    log("serve " + json.dumps(serve_phase(dev, card)))

    # -- phase (m), sharding and the launch tier: after (g), while the card's
    # memory is still free (the mesh step at (t1)'s widths peaks near (t1))
    log("phase (m): sharding and the launch tier")
    t1_step_ms = train_out["t1"]["adamw"]["mean_after_first"]["step_ms"]
    shard_out = shard_phase(dev, card, t1_step_ms)
    log("shard " + json.dumps(shard_out))

    # -- phase (s), the split kernel at the bf16 backward's shapes: after (m),
    # while the card's memory is still free (the plain version's temporaries
    # at the score cotangent take ~40 GB)
    log("phase (s): the split kernel")
    split_out = split_phase(dev, card)
    log("split " + json.dumps(split_out))

    rng = np.random.default_rng(0)

    def tt(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype).contiguous()

    def orthonormal(bsz, rows, cols):
        q, _ = np.linalg.qr(rng.normal(size=(bsz, rows, cols)))
        return q

    def pair(m, n, scale):
        """A rank-1 pair with |a| |b| = scale, per update."""
        a = rng.normal(size=(len(scale), m))
        b = rng.normal(size=(len(scale), n))
        b *= (np.asarray(scale) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)))[:, None]
        return a, b

    def spectrum(bsz, k):
        """Singular values 100 .. 1, geometric: no dominant one, and gaps
        wide enough (1.8 % at m=256) that float32 rounding moves the route's
        vectors little, so two summation orders can be compared closely."""
        return np.tile(np.geomspace(100.0, 1.0, k), (bsz, 1))

    def full_inputs(bsz, m, n, dtype, dist="geometric"):
        """B full states and a pair each.  ``geometric``: random orthogonal
        factors, ``spectrum``, and |a| |b| the median singular value;
        ``uniform``: the reference's own test problem, the SVD of a
        uniform(1, 9) matrix (one dominant singular value) and a
        standard-normal pair."""
        if dist == "uniform":
            u, s, vt = np.linalg.svd(rng.uniform(1, 9, (bsz, m, n)))
            v = vt.transpose(0, 2, 1)
            a, b = rng.normal(size=(bsz, m)), rng.normal(size=(bsz, n))
        else:
            u, s, v = orthonormal(bsz, m, m), spectrum(bsz, m), orthonormal(bsz, n, n)
            a, b = pair(m, n, np.median(s, axis=1))
        return [tt(x, dtype) for x in (u, s, v, a, b)]

    def trunc_inputs(bsz, m, n, r, dtype):
        """B rank-r states (orthonormal factors, ``spectrum``) and a pair each
        with |a| |b| the median kept singular value."""
        s = spectrum(bsz, r)
        a, b = pair(m, n, np.median(s, axis=1))
        return [tt(x, dtype) for x in (orthonormal(bsz, m, r), s, orthonormal(bsz, n, r), a, b)]

    def cauchy_inputs(bsz, r, n, m, dtype):
        src = np.sort(rng.normal(size=(bsz, n)), axis=1)
        av = np.take_along_axis(src, rng.integers(0, n, size=(bsz, m)), axis=1)
        tau = rng.normal(size=(bsz, m)) * 1e-3
        tau[:, 0] = 0.0
        return [tt(rng.normal(size=(bsz, r, n)), dtype), tt(src, dtype), tt(av, dtype),
                tt(tau, dtype), tt(rng.random((bsz, m)) > 0.2, dtype)]

    def recon(u, s, v):
        k = s.shape[-1]
        return (u[..., :, :k].double() * s[..., None, :].double()) @ v[..., :, :k].double().mT

    def measures(got, want):
        """recon and sigma (see TOL) of ``got`` against ``want``, each the
        largest over the batch (singular values below 1e-3 sigma_max, the
        numerical zeros of rank-deficient states, are measured against
        1e-3 sigma_max), and ``abs``: the largest absolute difference of
        U S V^T and of s."""
        rw, rg = recon(*want[:3]), recon(*got[:3])
        recon_e = (rg - rw).flatten(-2).norm(dim=-1) / rw.flatten(-2).norm(dim=-1)
        sw, sg = want[1].double(), got[1].double()
        floor = 1e-3 * sw.abs().amax(-1, keepdim=True)
        sigma_e = ((sg - sw).abs() / torch.maximum(sw.abs(), floor)).amax(-1)
        return {"recon": float(recon_e.max()), "sigma": float(sigma_e.max()),
                "abs": max(float((rg - rw).abs().max()), float((sg - sw).abs().max()))}

    def name_of(dtype):
        return str(dtype).replace("torch.", "")

    def check(label, err, tol):
        log(f"  {label}: max err {err:.3e} (tol {tol:.3g})")
        require(np.isfinite(err) and err <= tol, f"{label}: error {err} above {tol}")
        return err

    def check_pair(label, got, want, tol):
        """Both measures within ``tol``; returns the largest absolute error."""
        e = measures(got, want)
        log(f"  {label}: recon {e['recon']:.3e} (tol {tol['recon']:.3g}), "
            f"sigma {e['sigma']:.3e} (tol {tol['sigma']:.3g}), max abs {e['abs']:.3e}")
        for k in ("recon", "sigma"):
            require(np.isfinite(e[k]) and e[k] <= tol[k], f"{label}: {k} error {e[k]} above {tol[k]}")
        return e["abs"]

    def planted_faults(label, got, want, v_in, tol):
        """The check must reject the kernel's output with V left unrotated and
        with the sign of U's column of the largest and of the smallest
        singular value flipped (in the first update of the batch)."""
        faults = [("V unrotated", (got[0], got[1], v_in), True)]
        for which, j in (("largest", int(got[1][0].float().abs().argmax())),
                         ("smallest", int(got[1][0].float().abs().argmin()))):
            flip = got[0].clone()
            flip[0, :, j] = -flip[0, :, j]
            faults.append((f"sign of the {which} triplet flipped", (flip, got[1], got[2]),
                           which == "largest" or tol.get("smallest_sign", True)))
        for what, fault, required in faults:
            e = measures(fault, want)
            log(f"    planted fault, {what}: recon {e['recon']:.3e} (tol {tol['recon']:.3g})"
                + ("" if required else ", not required"))
            if required:
                require(e["recon"] > tol["recon"], f"{label}: the check passes a planted fault ({what})")

    def sensitivity(body, args):
        """The route's own float32 sensitivity: the plain body on inputs
        perturbed by one float32 rounding against the plain body, the
        largest over four perturbations."""
        want = body(*args)
        worst = {"recon": 0.0, "sigma": 0.0}
        for seed in range(1, 5):
            g = torch.Generator(dev).manual_seed(seed)
            pert = [x * (1 + 2.0 ** -23 * torch.randn(x.shape, generator=g, device=dev, dtype=x.dtype))
                    for x in args]
            e = measures(body(*pert), want)
            worst = {k: max(worst[k], e[k]) for k in worst}
        log(f"    the route's own sensitivity (plain, inputs perturbed by one rounding, worst of 4): "
            f"recon {worst['recon']:.3e}, sigma {worst['sigma']:.3e}")

    def plan_of(kernel, args):
        """Kernel A's or B's launch for these inputs: blocks an update (the
        cluster size), where the operators live, shared memory a block."""
        store = args[0].dtype
        sfx = FU._SUFFIX[(store, FU._compute_dtype_for(store))]
        if kernel == "A":
            return FU.launch_plan(sfx, args[0].shape[0], args[0].shape[1], args[2].shape[1])
        return FU.launch_plan(sfx, args[0].shape[0], args[0].shape[1], args[2].shape[1],
                              args[0].shape[2])

    def time_ms(fn, budget_ms=1500.0):
        # one untimed call warms up and sizes the count: at least 3 timed calls
        # where a call takes under half a second; the second-long routes and
        # drives get one (they had two until the fleet phase needed the time)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t) * 1e3
        reps = int(min(30, max(3 if once < 500 else 1, budget_ms / max(once, 1e-3))))
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def device_ms(fn, n=20, warm=True):
        """Device time per call from torch.profiler (CUDA activity): the sum
        over the kernels the call launches, and each kernel's share.  CUPTI
        now and then hands back no activity, for a whole run of profiles: after
        three empty ones the time comes from CUDA events around the n calls,
        under the key ``EVENTS_KEY`` (an upper bound, since it also counts the
        device's idle gaps between launches)."""
        if warm:
            fn()
        torch.cuda.synchronize()
        for _ in range(3):
            split = {}
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                if ev.device_time_total > 0:
                    name = ev.key.replace("(anonymous namespace)::", "").removeprefix("void ")
                    name = name.split("(")[0].split("<")[0].strip()[:40]
                    split[name] = split.get(name, 0.0) + ev.device_time_total / n / 1e3
            if split:
                return sum(split.values()), split
        log("  torch.profiler saw no device time in three profiles: CUDA events instead")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / n
        require(ms > 0, "neither torch.profiler nor CUDA events saw device time")
        return ms, {EVENTS_KEY: ms}

    def host_ms(fn, n=50):
        """Host time to enqueue one call (no synchronisation inside the loop)."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        out = (time.perf_counter() - t) / n * 1e3
        torch.cuda.synchronize()
        return out

    drive_launches = {}
    drive_timing = []

    def drive(name, fn):
        """Run one drive with the counters zeroed just before and read just
        after; they must equal the planner's counts."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        drive_launches[name] = got
        log(f"  drive {name}: launches {got}")
        for kname, want_n in DRIVE_LAUNCHES[name].items():
            require(got[kname] == want_n,
                    f"drive {name}: {kname} launched {got[kname]} times, expected {want_n}")
        return out

    # -- phase 3d, run after 3c: the streaming service (serve.SvdService) ------

    def stream_stack(svc, sids):
        sts = [svc.state(s) for s in sids]
        return [torch.stack([getattr(x, f) for x in sts]).cpu() for f in ("u", "s", "v")]

    def require_bitwise(label, x, y):
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(x, y))
        log(f"  {label}: {'equal to the bit' if same else 'NOT equal'}")
        require(same, f"{label}: not equal to the bit")

    def over_sigma_max(got, want):
        """max |U S V^T - U' S' V'^T| and max |s - s'|, over sigma_max of
        ``want``, the largest over the streams."""
        rw, rg = recon(*want[:3]), recon(*got[:3])
        smax = want[1].double().abs().amax(-1)
        return max(float(((rg - rw).abs().amax((-2, -1)) / smax).max()),
                   float(((got[1].double() - want[1].double()).abs().amax(-1) / smax).max()))

    def sigma_max_faults(label, got, want, v_in, limit):
        """The sigma_max check must reject V left unrotated and the sign of the
        first stream's largest triplet flipped."""
        flip = got[0].clone()
        flip[0, :, 0] = -flip[0, :, 0]
        for what, fault in (("V unrotated", (got[0], got[1], v_in)),
                            ("sign of the largest triplet flipped", (flip, got[1], got[2]))):
            e = over_sigma_max(fault, want)
            log(f"    planted fault, {what}: {e:.3e} (limit {limit:.3g})")
            require(e > limit, f"{label}: the check passes a planted fault ({what})")

    def service_phase():
        """Drives (s1)-(s3) through ``serve.SvdService`` on the card, each with
        the launch counters zeroed before it and held to ``DRIVE_LAUNCHES``
        after it; returns what phase 4 times."""
        import shutil

        from repro_torch import obs, serve
        from repro_torch.core import engine as ENG
        from repro_torch.dist import merge_tree

        log("the streaming service (serve.SvdService):")
        inp = service_inputs()
        f64, f32 = torch.float64, torch.float32
        d1 = inp["s1"]
        ids = [f"s{i}" for i in range(SERVE_S1["streams"])]

        def run1(method, dtype, mif, device):
            svc = serve_streams(api, serve, d1, method=method, dtype=dtype, mif=mif, device=device)
            serve_rounds(svc, d1["rounds"])
            svc.drain()
            return svc

        # (s1) rank-1 streams at the reference's serving shape, per route
        for method in SERVE_METHODS:
            runs = drive(f"s1 {method}", lambda m_=method: {
                (name_of(dt), mif): run1(m_, dt, mif, dev) for dt in (f64, f32) for mif in (0, 2)})
            for dt in (f64, f32):
                dn = name_of(dt)
                label = (f"(s1) {method} {dn} {SERVE_S1['streams']} streams m{SERVE_S1['m']} "
                         f"n{SERVE_S1['n']} r{SERVE_S1['r']}, {SERVE_S1['rounds']} rounds")
                got = stream_stack(runs[(dn, 2)], ids)
                require(all(bool(torch.isfinite(x).all()) for x in got), f"{label}: non-finite")
                require_bitwise(f"{label}: max_in_flight 2 against 0", got,
                                stream_stack(runs[(dn, 0)], ids))
                want = stream_stack(run1(method, dt, 2, "cpu"), ids)
                v_in = torch.stack([torch.as_tensor(f[2]) for f in d1["factors"]]).to(dt)
                if dn == "float64":
                    check(f"{label}: card vs CPU, over sigma_max", over_sigma_max(got, want),
                          SERVE_F64_LIMIT)
                    sigma_max_faults(label, got, want, v_in, SERVE_F64_LIMIT)
                else:
                    check_pair(f"{label}: card vs CPU", got, want, SERVE_F32_TOL)
                    planted_faults(label, got, want, v_in, SERVE_F32_TOL)

        # (s2) structured events and failover: the uninterrupted service, and
        # one saved halfway and restored from disk, must end equal to the bit
        ckpt_dir = ROOT / "build" / "chip_smoke_service_ckpt"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        s2 = {}

        def run2():
            whole = serve_s2_first(api, serve, updates, inp, dev)
            serve_s2_second(whole, inp)
            part = serve_s2_first(api, serve, updates, inp, dev)
            s2["pending"] = part.pending()
            part.save(ckpt_dir, step=1)
            for eng in ENG._default_engines.values():
                eng.cache_clear()      # so the restore's warming is what the flush finds
            _, resumed = serve.SvdService.restore(ckpt_dir, device=dev)
            s2["misses"] = sum(e.cache_info().misses for e in ENG._default_engines.values())
            builds = []
            real_build = _build.build_all
            _build.build_all = lambda *a: builds.append(1) or real_build(*a)
            try:
                resumed.flush_round()          # the first flush after the restore
                torch.cuda.synchronize()
            finally:
                _build.build_all = real_build
            s2["first_misses"] = sum(e.cache_info().misses
                                     for e in ENG._default_engines.values()) - s2["misses"]
            s2["first_builds"] = len(builds)
            for i, (a, b) in enumerate(inp["s2"]["pairs2"]):
                resumed.enqueue(f"s{i}", a, b)
            resumed.drain()
            return whole, resumed

        whole, resumed = drive("s2 failover", run2)
        label2 = ("(s2) fused float64 16 streams m512 n768 r16: RankK, Sparse, AppendRows, "
                  f"Window; saved with {s2['pending']} events pending, restored")
        require(s2["pending"] > 0, f"{label2}: nothing pending at the snapshot")
        log(f"  {label2}: first flush after the restore: {s2['first_misses']} engine-cache "
            f"misses, {s2['first_builds']} library builds (warmed set: "
            f"{len(resumed._warmed)} entries)")
        require(s2["first_misses"] == 0 and s2["first_builds"] == 0,
                f"{label2}: the first flush after the restore missed the warmed caches")
        require(all(tuple(whole.state(s).u.shape) == tuple(resumed.state(s).u.shape) for s in ids),
                f"{label2}: shapes differ")
        for s in ids:
            require(all(torch.equal(getattr(whole.state(s), f), getattr(resumed.state(s), f))
                        for f in ("u", "s", "v")), f"{label2}: stream {s} differs from the bit")
        log(f"  {label2}: resumed vs uninterrupted: every stream equal to the bit")
        cpu_whole = serve_s2_first(api, serve, updates, inp, "cpu")
        serve_s2_second(cpu_whole, inp)
        for group, sids in (("RankK", ids[0:4]), ("Sparse", ids[4:8]), ("AppendRows", ids[8:12]),
                            ("Window", ids[12:16])):
            got, want = stream_stack(whole, sids), stream_stack(cpu_whole, sids)
            require(all(bool(torch.isfinite(x).all()) for x in got), f"{label2}: non-finite")
            check_pair(f"(s2) {group} streams: card vs CPU", got, want, SERVE_S2_TOL[group])

        # (s3) a larger deployment, then the merge of its 64 streams
        d3 = inp["s3"]
        ids3 = [f"s{i}" for i in range(SERVE_S3["streams"])]
        s3 = {}

        def run3():
            svc = serve_streams(api, serve, d3, method="fused", dtype=f32, mif=2, device=dev,
                                max_batch=SERVE_S3["streams"])
            serve_rounds(svc, d3["rounds"])
            svc.drain()
            obs.start_tracing()
            obs.clear_trace()
            try:
                s3["merged"] = svc.merge_streams(ids3)
                torch.cuda.synchronize()
            finally:
                obs.stop_tracing()
            # the same deployment in float64, rounds and merge, for the
            # reference's merge tolerance
            svc64 = serve_streams(api, serve, d3, method="fused", dtype=f64, mif=2, device=dev,
                                  max_batch=SERVE_S3["streams"])
            serve_rounds(svc64, d3["rounds"])
            s3["merged64"] = svc64.merge_streams(ids3)
            s3["svc64"] = svc64
            s3["levels"] = sum(1 for e in obs.trace_events() if e["name"] == "merge_level")
            obs.clear_trace()
            return svc

        svc3 = drive("s3 B64 and merge", run3)
        label3 = (f"(s3) fused float32 {SERVE_S3['streams']} streams m{SERVE_S3['m']} "
                  f"n{SERVE_S3['n']} r{SERVE_S3['r']}, {SERVE_S3['rounds']} rounds")
        got3 = stream_stack(svc3, ids3)
        require(all(bool(torch.isfinite(x).all()) for x in got3), f"{label3}: non-finite")
        cpu3 = serve_streams(api, serve, d3, method="fused", dtype=f32, mif=2, device="cpu",
                             max_batch=SERVE_S3["streams"])
        serve_rounds(cpu3, d3["rounds"])
        cpu3.drain()
        want3 = stream_stack(cpu3, ids3)
        check_pair(f"{label3}: card vs CPU", got3, want3, SERVE_F32_TOL)
        merged, merged64 = s3["merged"], s3["merged64"]
        r3 = SERVE_S3["r"]
        require(tuple(merged.u.shape) == (SERVE_S3["streams"] * SERVE_S3["m"], r3)
                and s3["levels"] == 6, f"{label3}: merge gave u {tuple(merged.u.shape)} in "
                f"{s3['levels']} levels")
        # the truth: the stacked matrix (rank 32 by construction) and its
        # top-32 SVD, from the eigenpairs of its Gram matrix in float64
        def truth(svc):
            stacked = torch.cat([(svc.state(s).u.double() * svc.state(s).s.double())
                                 @ svc.state(s).v.double().mT for s in ids3])
            evals, evecs = torch.linalg.eigh(stacked.mT @ stacked)
            sig_ = evals.flip(0).clamp(min=0).sqrt()
            v_ = evecs.flip(1)[:, :r3]
            return stacked, sig_, (stacked @ v_) / sig_[:r3], v_

        def merge_err_for(svc):
            """The distance of a merge to the top-32 SVD of ``svc``'s stacked
            streams, M_32: max(|s - s_M| / s_M, the RMS sine of the angles to
            U_M's and to V_M's span, ||U S V^T - M_32||_F / ||M_32||_F)."""
            stacked, sig, u_t, v_t = truth(svc)
            del stacked
            m32 = (u_t * sig[:r3]) @ v_t.mT

            def span_err(want, got):
                q = torch.linalg.qr(got.double()).Q
                return float((q - want @ (want.mT @ q)).norm()) / r3 ** 0.5

            def err(u, s, v):
                rec = float(((u.double() * s.double()) @ v.double().mT - m32).norm() / m32.norm())
                sig_e = float(((s.double() - sig[:r3]).abs() / sig[:r3]).max())
                return max(rec, sig_e, span_err(u_t, u), span_err(v_t, v))

            return err, sig

        def rows_cut(u):
            """U with the last stream's rows zeroed (a planted fault)."""
            return torch.cat([u[:-SERVE_S3["m"]], torch.zeros_like(u[-SERVE_S3["m"]:])])

        merge_what = ("vs the stacked matrix's top-32 SVD, max(|s - s_M| / s_M, RMS sine to "
                      "U_M's and V_M's spans, ||U S V^T - M_32||_F / ||M_32||_F)")
        err64, sig = merge_err_for(s3["svc64"])
        log(f"  {label3}: the float64 deployment's stacked matrix has sigma_33 / sigma_1 = "
            f"{float(sig[r3] / sig[0]):.2e}, its closest singular values "
            f"{float(((sig[:r3 - 1] - sig[1:r3]) / sig[:r3 - 1]).min()):.2e} apart (relative)")
        # float64 at the reference's merge tolerance (relative)
        check(f"(s3) the same deployment in float64: merge_streams {merge_what}",
              err64(merged64.u, merged64.s, merged64.v), SERVE_MERGE_F64_LIMIT)
        flip_u = merged64.u.clone()
        flip_u[:, 0] = -flip_u[:, 0]
        faults = [("float64: sign of the largest triplet flipped",
                   err64(flip_u, merged64.s, merged64.v), SERVE_MERGE_F64_LIMIT),
                  ("float64: the last stream's rows left out",
                   err64(rows_cut(merged64.u), merged64.s, merged64.v), SERVE_MERGE_F64_LIMIT)]
        del err64
        err32, _ = merge_err_for(svc3)
        # float32, the drive's own merge, by the same measures
        check(f"{label3}: merge_streams of the {SERVE_S3['streams']} streams ({s3['levels']} "
              f"levels) {merge_what}", err32(merged.u, merged.s, merged.v), SERVE_MERGE_LIMIT)
        turned_v = merged.v.clone()
        turned_v[:, 0] = merged.v[:, 0] + 0.01 * torch.randn_like(merged.v[:, 0])
        faults += [("float32: V's largest vector moved by 1 %",
                    err32(merged.u, merged.s, turned_v), SERVE_MERGE_LIMIT),
                   ("float32: the largest singular value 1 % off",
                    err32(merged.u, merged.s * torch.cat([merged.s.new_tensor([1.01]),
                                                         merged.s.new_ones(r3 - 1)]),
                          merged.v), SERVE_MERGE_LIMIT),
                   ("float32: the last stream's rows left out",
                    err32(rows_cut(merged.u), merged.s, merged.v), SERVE_MERGE_LIMIT)]
        for what, e, limit in faults:
            log(f"    planted fault, {what}: {e:.3e} (limit {limit:.3g})")
            require(e > limit, f"{label3}: the merge check passes a planted fault ({what})")
        del err32
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        return {"inputs": inp, "ids": ids, "ids3": ids3, "svc3": svc3}

    def service_times(ctx):
        """Phase 4's service rows: per route and dtype at (s1) the ms of a flush
        round by CUDA events over a run of rounds (enqueues included), the
        device's busy time in it by the profiler, the host's waits for the
        device in one round, and the host time of an enqueue; then save,
        restore and warm at (s2), and (s3)'s round and merge."""
        import shutil

        from repro_torch import serve
        from repro_torch.core import engine as ENG

        inp, ids = ctx["inputs"], ctx["ids"]
        d1 = inp["s1"]
        rows = []

        for method in SERVE_METHODS:
            # the phase chain's rounds take a fifth of a second: time 2 of them
            timed = d1["rounds"] if method == "fused" else d1["rounds"][:2]
            nround = len(timed)
            for dt in (torch.float64, torch.float32):
                dn = name_of(dt)
                svc = serve_streams(api, serve, d1, method=method, dtype=dt, mif=2, device=dev)
                serve_rounds(svc, d1["rounds"][:1])        # warm: every geometry seen
                svc.drain()

                def rounds(svc_=svc, timed_=timed):
                    serve_rounds(svc_, timed_)
                    svc_.drain()

                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                e0.record()
                rounds()
                e1.record()
                torch.cuda.synchronize()
                round_ms = e0.elapsed_time(e1) / nround
                busy_ms, busy_split = device_ms(rounds, n=1, warm=False)
                source = "CUDA events" if EVENTS_KEY in busy_split else "profiler"
                share = busy_ms / (round_ms * nround)
                syncs, where = count_syncs(lambda s_=svc: serve_rounds(s_, d1["rounds"][:1]))
                svc.drain()
                enq = []
                for a, b in d1["rounds"][0][:-1]:          # 15 enqueues that flush nothing
                    t = time.perf_counter()
                    svc.enqueue(ids[len(enq)], a, b)
                    enq.append((time.perf_counter() - t) * 1e6)
                svc.drain()
                row = {"route": method, "dtype": dn, "shape": "16 streams m512 n768 r16",
                       "round_ms": round_ms, "device_busy_ms_per_round": busy_ms / nround,
                       "device_share": share, "device_source": source,
                       "syncs_per_round": syncs,
                       "sync_sites": where,
                       "enqueue_us": statistics.median(enq)}
                rows.append(row)
                log(f"  service (s1) {method} {dn}: {round_ms:.3f} ms a flush round (events, "
                    f"16 pairs enqueued and flushed), device busy {busy_ms / nround:.3f} ms of it "
                    f"({100 * share:.1f} %, {source}), {syncs} host waits a "
                    f"round {where or ''}, "
                    f"enqueue {row['enqueue_us']:.1f} us")

        # (s2): save, restore (load + warm) and warm alone, host clock
        ckpt_dir = ROOT / "build" / "chip_smoke_service_ckpt"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        part = serve_s2_first(api, serve, updates, inp, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        part.save(ckpt_dir, step=1)
        save_s = time.perf_counter() - t
        for eng in ENG._default_engines.values():
            eng.cache_clear()
        t = time.perf_counter()
        _, resumed = serve.SvdService.restore(ckpt_dir, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        for eng in ENG._default_engines.values():
            eng.cache_clear()
        t = time.perf_counter()
        resumed.warm(device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        rows.append({"route": "fused", "dtype": "float64", "shape": "(s2) 16 streams, "
                     f"{part.pending()} events pending", "save_s": save_s,
                     "restore_s": restore_s, "warm_s": warm_s,
                     "warmed_entries": len(resumed._warmed)})
        log(f"  service (s2): save {save_s:.3f} s, restore {restore_s:.3f} s (load and warm "
            f"{len(resumed._warmed)} entries), warm alone {warm_s:.3f} s (libraries loaded)")

        # (s3): a flush round at B64 and the merge of the 64 streams
        d3, ids3, svc3 = inp["s3"], ctx["ids3"], ctx["svc3"]

        def round3(svc_=svc3):
            serve_rounds(svc_, d3["rounds"][:1])
            svc_.drain()

        b_ms = time_ms(round3)
        merge_ms = time_ms(lambda: svc3.merge_streams(ids3))
        merge_dev, merge_split = device_ms(lambda: svc3.merge_streams(ids3), n=2)
        rows.append({"route": "fused", "dtype": "float32", "shape": "(s3) 64 streams m1024 n4096 r32",
                     "round_ms": b_ms, "merge_ms": merge_ms, "merge_device_ms": merge_dev})
        log(f"  service (s3) fused float32 B64: {b_ms:.3f} ms a flush round; merge_streams of 64 "
            f"streams {merge_ms:.2f} ms (device busy {merge_dev:.2f} ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(merge_split.items(),
                                                           key=lambda kv: -kv[1])[:4]) + ")")
        return rows

    # -- phase 2: kernels against their plain versions --------------------------
    log(f"kernels vs plain (phase 2, from {time.perf_counter() - t_run:.0f} s into the run):")
    errs = {}
    cases = {}
    # kernel C at the headline B16 R=N=M=192 and at the three shapes the main
    # path's method="pallas" drive gives it (CAUCHY_MAIN_SHAPES); planted
    # faults: tau's sign flipped, each member's w taken from the next
    for bsz, k in ((16, 192),) + CAUCHY_MAIN_SHAPES:
        for dtype in (torch.float64, torch.float32):
            args = cauchy_inputs(bsz, k, k, k, dtype)
            got = CM.cauchy_matmul_cuda(*args)
            want = CM.cauchy_matmul_plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            label = f"C cauchy_matmul B{bsz} R=N=M={k} {name_of(dtype)}, relative to max |out|"
            log(f"  C B{bsz} R=N=M={k} {name_of(dtype)} launch: "
                f"{CM.cauchy_plan(bsz, k, k, k, dtype)}")
            check(label, err / scale, CAUCHY_TOL[name_of(dtype)])
            require(torch.equal(got, CM.cauchy_matmul_cuda(*args)), f"{label}: two launches differ")
            for what, fault in (("tau's sign flipped", args[:3] + [-args[3], args[4]]),
                                ("members shifted by one", [args[0].roll(1, 0).contiguous()]
                                 + args[1:])):
                e = float((CM.cauchy_matmul_cuda(*fault) - want).abs().max()) / scale
                log(f"    planted fault, {what}: {e:.3e} (tol {CAUCHY_TOL[name_of(dtype)]:.0e})")
                require(e > CAUCHY_TOL[name_of(dtype)],
                        f"{label}: the check passes a planted fault ({what})")
            errs[("C", name_of(dtype), bsz, k)] = err
            cases[("C", name_of(dtype), bsz, k)] = (f"B{bsz} R=N=M={k}", args)

    for bsz, m, n, dtype in ((128, 32, 48, torch.float64), (32, 256, 320, torch.float32),
                             (128, 32, 48, torch.bfloat16)):
        args = full_inputs(bsz, m, n, dtype)
        got = FU.fused_update_cuda(*args)
        want = FU._fused_body(*args)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(x.float()).all()) for x in got),
                f"A {name_of(dtype)}: non-finite output")
        label = f"A fused_update B{bsz} ({m},{n}) {name_of(dtype)}"
        log(f"  A B{bsz} ({m},{n}) {name_of(dtype)} launch: {plan_of('A', args)}")
        tol = TOL[("A", name_of(dtype))]
        errs[("A", name_of(dtype), m)] = check_pair(label, got, want, tol)
        if dtype == torch.float32:
            sensitivity(FU._fused_body, args)
        planted_faults(label, got, want, args[2], tol)
        cases[("A", name_of(dtype), m)] = (f"B{bsz} ({m},{n})", args)

    # bf16 storage against the reference's budget, on the reference's own test
    # problems, against an f64 SVD of A + a b^T: singular values by the
    # budget's measure (max_i |s_i - s_ref_i| / s_ref_0); the reconstruction
    # budget (||U S V^T - T||_F / ||T||_F) is reported, because the
    # reference's own fused body misses it on part of these problems
    # (tools/port_vs_reference.py)
    args = full_inputs(128, 32, 48, torch.bfloat16, dist="uniform")
    got, want = FU.fused_update_cuda(*args), FU._fused_body(*args)
    a64 = [x.double() for x in args]
    dense = recon(*a64[:3]) + a64[3][:, :, None] * a64[4][:, None, :]
    s_ref = torch.linalg.svdvals(dense)
    sigma_rel = float(((got[1].double() - s_ref).abs().amax(1) / s_ref[:, 0]).max())
    check("A bf16 B128 (32,48) uniform: sigma_rel vs f64 SVD", sigma_rel,
          FU.BF16_ERROR_BUDGET["sigma_rel"])

    def recon_fro(out):
        return ((recon(*out[:3]) - dense).flatten(-2).norm(dim=-1)
                / dense.flatten(-2).norm(dim=-1))

    budget = FU.BF16_ERROR_BUDGET["recon_rel"]
    for side, out in (("kernel", got), ("plain", want)):
        rf = recon_fro(out)
        log(f"  A bf16 uniform {side}: recon_fro vs f64 median {float(rf.median()):.3e} max "
            f"{float(rf.max()):.3e}, over the {budget:.0e} budget on {int((rf > budget).sum())} of 128")

    for bsz, m, n, r in ((16, 512, 768, 16), (8, 1024, 4096, 32)):
        for dtype in (torch.float32, torch.float64):
            args = trunc_inputs(bsz, m, n, r, dtype)
            got = FU.fused_update_truncated_cuda(*args)
            want = FU._fused_truncated_body(*args)
            torch.cuda.synchronize()
            label = f"B fused_update_truncated B{bsz} m{m} n{n} r{r} {name_of(dtype)}"
            log(f"  B B{bsz} m{m} n{n} r{r} {name_of(dtype)} launch: {plan_of('B', args)}")
            tol = TOL[("B", name_of(dtype))]
            errs[("B", name_of(dtype), m)] = check_pair(label, got, want, tol)
            if dtype == torch.float32:
                sensitivity(FU._fused_truncated_body, args)
            planted_faults(label, got, want, args[2], tol)
            cases[("B", name_of(dtype), m)] = (f"B{bsz} m{m} n{n} r{r}", args)

    # kernel F: COO entries over the upper 7/8 of the rows (the rest stay
    # empty), eight entries at one coordinate (duplicates accumulate) and 64
    # padding entries (0, 0, 0.0) at the end; at the sketch's shape (1024 x
    # 1024, 1 % dense, l = 16) and at an embedding table's (32768 x 1024)
    def coo(m, n, nnz, bsz, shared, n_pad=64):
        coord_lead = () if bsz is None or shared else (bsz,)
        rows = rng.integers(0, m - m // 8, coord_lead + (nnz,)).astype(np.int32)
        cols = rng.integers(0, n, coord_lead + (nnz,)).astype(np.int32)
        rows[..., 1:8], cols[..., 1:8] = rows[..., :1], cols[..., :1]
        rows[..., -n_pad:], cols[..., -n_pad:] = 0, 0
        vals = rng.normal(size=(() if bsz is None else (bsz,)) + (nnz,))
        vals[..., -n_pad:] = 0.0
        return rows, cols, vals

    def sparse_err(got, want):
        return float((got - want).abs().max()) / float(want.abs().max())

    # drive 1's two projections as the sketch launches them: per-member
    # coordinates and values (B128, nnz 96, entries in 8 rows) against one
    # shared test matrix (read at batch stride 0), Omega (48, 16) and Psi (32, 16)
    inputs = drive_inputs()
    d1 = inputs["1"]
    m_d1, n_d1 = d1["u"].shape[1], d1["v"].shape[1]

    def f_case(label, dtype):
        """(rows, cols, vals, mat, out_rows, first empty row or None)."""
        if label.startswith("drive 1"):
            if "Omega" in label:
                return (d1["rows"], d1["cols"], d1["vals"],
                        sketch._test_matrix(n_d1, 16, dtype, dev, seed=sketch._SEED), m_d1, None)
            return (d1["cols"], d1["rows"], d1["vals"],
                    sketch._test_matrix(m_d1, 16, dtype, dev, seed=sketch._SEED_CORANGE), n_d1, None)
        m_ = 32768 if "32768" in label else 1024
        nnz = 335544 if m_ == 32768 else 10485
        bsz = 16 if label.startswith("B16") else None
        rows, cols, vals = coo(m_, 1024, nnz, bsz, bsz is None or "shared" in label)
        lead = () if bsz is None else (bsz,)
        if "transposed" in label:  # S^T @ mat
            return cols, rows, vals, tt(rng.normal(size=lead + (m_, 16)), dtype), 1024, None
        return rows, cols, vals, tt(rng.normal(size=lead + (1024, 16)), dtype), m_, m_ - m_ // 8

    sparse_cases = {}
    for dtype in (torch.float64, torch.float32):
        dn = name_of(dtype)
        for label in ("1024x1024 nnz10485 l16", "1024x1024 nnz10485 l16 transposed",
                      "B16 1024x1024 nnz10485 l16 shared coords", "B16 1024x1024 nnz10485 l16",
                      "32768x1024 nnz335544 l16", "B16 32768x1024 nnz335544 l16",
                      "drive 1 S Omega B128 32x48 nnz96 l16 shared mat",
                      "drive 1 S^T Psi B128 32x48 nnz96 l16 shared mat"):
            rows, cols, vals, mat, out_rows, empty_from = f_case(label, dtype)
            args = (torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev),
                    tt(vals, dtype), mat)
            SP.check_coords(args[0], args[1], out_rows, mat.shape[-2])
            got = SP.sparse_project_cuda(*args, out_rows)
            want = SP.sparse_project_plain(*args, out_rows)
            torch.cuda.synchronize()
            full_label = f"F sparse_project {label} {dn}, relative to max |out|"
            err = check(full_label, sparse_err(got, want), SPARSE_TOL[dn])
            require(torch.equal(got, SP.sparse_project_cuda(*args, out_rows)),
                    f"{full_label}: two launches differ")
            coords = args[0] if args[0].dim() == 2 else args[0][None]
            require(all(torch.equal(d_, p_) for d_, p_ in zip(
                SP.sparse_bucket_cuda(coords, out_rows), SP.sparse_project_prep(coords, out_rows))),
                f"{full_label}: the device bucketing differs from sparse_project_prep")
            if empty_from is not None:
                require(float(got[..., empty_from:, :].abs().max()) == 0.0,
                        f"{full_label}: an empty row is not zero")
            # planted faults: the largest entry of the first member dropped;
            # rows and cols swapped (square shapes); per-member entries moved
            # to the next member (batched coordinates)
            drop = vals.copy()
            first = drop if drop.ndim == 1 else drop[0]
            first[int(np.abs(first).argmax())] = 0.0
            faults = [("one entry dropped",
                       sparse_err(got, SP.sparse_project_plain(args[0], args[1], tt(drop, dtype),
                                                               args[3], out_rows)))]
            if out_rows == mat.shape[-2]:
                faults.append(("rows and cols swapped",
                               sparse_err(SP.sparse_project_cuda(args[1], args[0], *args[2:],
                                                                 out_rows), want)))
            if args[0].dim() == 2:
                faults.append(("members shifted by one",
                               sparse_err(SP.sparse_project_cuda(*(x.roll(1, 0) for x in args[:3]),
                                                                 args[3], out_rows), want)))
            for what, e in faults:
                log(f"    planted fault, {what}: {e:.3e} (tol {SPARSE_TOL[dn]:.0e})")
                require(e > SPARSE_TOL[dn], f"{full_label}: the check passes a planted fault ({what})")
            sparse_cases[(label, dn)] = (args, out_rows, err * float(want.abs().max()))

    # kernel D, the secular solve, at B=8 and N = M = 1024, f64 and f32: on
    # brackets built as core.secular builds them from a real (d, z, rho)
    # (d the squares of uniform(1, 9) values, every ninth z shrunk by 1e-5 so
    # that its root hugs its pole), and on tests/test_kernels.py's random
    # brackets
    def secular_inputs(brackets, dtype):
        g = np.random.default_rng(21 if brackets == "real" else 22)
        bsz, nn = 8, 1024
        if brackets == "random":
            return [tt(x, dtype) for x in (
                np.sort(g.uniform(0, 5, (bsz, nn)), axis=1), g.uniform(0.01, 1, (bsz, nn)),
                np.full(bsz, 0.7), np.sort(g.uniform(0, 5, (bsz, nn)), axis=1),
                np.zeros((bsz, nn)), g.uniform(0.01, 0.5, (bsz, nn)))]
        d = np.sort(g.uniform(1, 9, (bsz, nn)) ** 2, axis=1)
        z = g.normal(size=(bsz, nn))
        z[:, ::9] *= 1e-5
        rho = g.uniform(0.5, 2.0, bsz)
        br = SEC.secular_brackets(tt(d, dtype), tt(z, dtype), tt(rho, dtype),
                                  torch.full((bsz,), nn, device=dev))
        return [tt(d, dtype), br.zc2, tt(rho, dtype), br.anchor_vals, br.lo, br.hi]

    def secular_err(got, want, args, roots=slice(None)):
        """max |tau - tau'| over the widest bracket, on the roots ``roots``."""
        return (float((got - want)[:, roots].abs().max())
                / float((args[5] - args[4])[:, roots].abs().max()))

    secular_cases = {}
    for dtype in (torch.float64, torch.float32):
        dn = name_of(dtype)
        for brackets in ("real", "random"):
            args = secular_inputs(brackets, dtype)
            if brackets == "real" and dn == "float64":
                log(f"  D B8 N=M=1024 launch: {SN.secular_plan(args[0].shape[1])}")
            for nb, nn_ in SECULAR_STEPS:
                got = SN.secular_solve_cuda(*args, n_bisect=nb, n_newton=nn_)
                want = SN.secular_solve_plain(*args, n_bisect=nb, n_newton=nn_)
                torch.cuda.synchronize()
                label = (f"D secular_solve B8 N=M=1024 {brackets} brackets {nb}+{nn_} steps {dn}, "
                         "over the widest bracket")
                err = check(label, secular_err(got, want, args), SECULAR_TOL[dn])
                require(torch.equal(got, SN.secular_solve_cuda(*args, n_bisect=nb, n_newton=nn_)),
                        f"{label}: two launches differ")
                secular_cases[(brackets, dn, nb, nn_)] = (args, float((got - want).abs().max()))
            if brackets != "real":
                continue
            want = SN.secular_solve_plain(*args)
            hug = slice(0, None, 9)
            want4 = SN.secular_solve_plain(*args, n_bisect=4, n_newton=4)
            check(f"  D at 4 bisection + 4 Newton steps {dn}, pole-hugging roots",
                  secular_err(SN.secular_solve_cuda(*args, n_bisect=4, n_newton=4), want4, args,
                              hug), SECULAR_TOL[dn])
            dropped = args[1].clone()
            dropped.scatter_(1, dropped.argmax(1, keepdim=True), 0.0)
            for what, e in (
                    ("every member's heaviest pole dropped",
                     secular_err(SN.secular_solve_cuda(args[0], dropped, *args[2:]), want, args)),
                    ("one Newton step too few (4 + 3 against 4 + 4), pole-hugging roots",
                     secular_err(SN.secular_solve_cuda(*args, n_bisect=4, n_newton=3), want4,
                                 args, hug))):
                log(f"    planted fault, {what}: {e:.3e} (tol {SECULAR_TOL[dn]:.0e})")
                require(e > SECULAR_TOL[dn], f"{label}: the check passes a planted fault ({what})")

    # kernel E, the FMM near field, at the shapes the FMM drives give it: the
    # eigen-plan of a full (1024, 1024) update (d the squared singular values
    # of drive (ii)'s matrices, R 1024, nb 32, 3cap 408, capt 136) at B=1 and
    # B=8, and of a truncated rank-127 update's (128, 128) core (d the squares
    # of drive (iv)'s singular values and a zero, R 128, nb 4, B=4); z normal,
    # rho 1, the weights normal
    fmm_in = fmm_inputs()
    sv_ii = torch.linalg.svdvals(torch.as_tensor(np.stack([x[0] for x in fmm_in["ii"]]),
                                                 device=dev))
    s_iv = np.append(fmm_in["iv"][0][1], 0.0)

    def near_inputs(which, bsz):
        g = np.random.default_rng(31)
        if which == "full":
            d = torch.flip(sv_ii[:bsz] ** 2, dims=(1,))
        else:
            d = tt(np.tile(np.sort(s_iv ** 2), (bsz, 1)), torch.float64)
        nn = d.shape[1]
        plan = make_plan(d, tt(g.normal(size=(bsz, nn)), torch.float64),
                         torch.ones(bsz, dtype=torch.float64, device=dev), rho_positive=True,
                         build_fmm=True).fmm
        return plan, tt(g.normal(size=(bsz, nn, nn)), torch.float64)

    def near_err(got, want):
        return float((got - want).abs().max()) / float(want.abs().max())

    near_cases = {}
    for which, bsz in (("full", 1), ("full", 8), ("truncated", 4)):
        plan, w = near_inputs(which, bsz)
        unmasked = FMM.near_operands(dataclasses.replace(
            plan, near_src_mask=torch.ones_like(plan.near_src_mask)), w)[0]
        operands = FMM.near_operands(plan, w)
        for dtype in (torch.float64, torch.float32):
            dn = name_of(dtype)
            args = [x.to(dtype) if x.is_floating_point() else x for x in operands]
            got = NF.nearfield_cuda(*args)
            want = NF.nearfield_plain(*args)
            torch.cuda.synchronize()
            shape = (f"B{bsz} R{w.shape[1]} nb{plan.nb} 3cap{3 * plan.cap} capt{plan.capt}")
            label = f"E nearfield {which} {shape} {dn}, relative to max |out|"
            err = check(label, near_err(got, want), NEAR_TOL[dn])
            require(torch.equal(got, NF.nearfield_cuda(*args)), f"{label}: two launches differ")
            for what, fault in (("invalid source slots unmasked", [unmasked.to(dtype)] + args[1:]),
                                ("tau's sign flipped", args[:3] + [-args[3], args[4]])):
                e = near_err(NF.nearfield_cuda(*fault), want)
                log(f"    planted fault, {what}: {e:.3e} (tol {NEAR_TOL[dn]:.0e})")
                require(e > NEAR_TOL[dn], f"{label}: the check passes a planted fault ({what})")
            near_cases[(which, bsz, dn)] = (shape, args, err * float(want.abs().max()))
        del plan, w, unmasked, operands

    # -- phase 3: the main path ---------------------------------------------------
    log(f"main path (api.update_many / api.update; phase 3, from {time.perf_counter() - t_run:.0f} "
        f"s into the run):")
    m, n, bsz = 128, 192, 4
    fp = full_inputs(bsz, m, n, torch.float64)
    full_probs = [(recon(*(x[i] for x in fp[:3])).cpu().numpy(), fp[3][i].cpu().numpy(),
                   fp[4][i].cpu().numpy()) for i in range(bsz)]
    r, true_rank = 16, 12
    tm, tn = 512, 768
    trunc_probs = []
    for _ in range(16):  # the service bench's flush size
        a_mat = rng.normal(size=(tm, true_rank)) @ rng.normal(size=(true_rank, tn))
        trunc_probs.append((a_mat, rng.normal(size=tm), rng.normal(size=tn)))

    def run_main_path():
        results = []
        for method in ("auto", "pallas"):
            pol = api.UpdatePolicy(method=method)
            for dtype in (torch.float64, torch.float32):
                states = [api.SvdState.from_dense(p[0], device=dev, dtype=dtype) for p in full_probs]
                outs = api.update_many(states, [p[1] for p in full_probs],
                                       [p[2] for p in full_probs], pol)
                results.append((f"full {method} {name_of(dtype)} B{bsz} ({m},{n})", outs,
                                full_probs, name_of(dtype), states, pol))
            states = [api.SvdState.from_dense(p[0], r, device=dev) for p in trunc_probs]
            outs = api.update_many(states, [p[1] for p in trunc_probs],
                                   [p[2] for p in trunc_probs], pol)
            results.append((f"truncated {method} float64 B{len(trunc_probs)} m{tm} n{tn} r{r} "
                            f"(rank {true_rank})", outs, trunc_probs, "float64", states, pol))
        state = api.SvdState.from_dense(full_probs[0][0], device=dev)
        single = api.update(state, full_probs[0][1], full_probs[0][2])
        results.append((f"single full auto float64 ({m},{n})", [single], full_probs[:1], "float64",
                        [state], api.UpdatePolicy()))
        return results

    _build.reset_launches()
    results = run_main_path()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    for label, outs, probs, dt, states, pol in results:
        worst = 0.0
        for out, (a_mat, a, b) in zip(outs, probs):
            arrs = convert.state_to_arrays(out)
            require(all(np.isfinite(x).all() for x in arrs.values()), f"{label}: non-finite output")
            want = a_mat + np.outer(a, b)
            k = arrs["s"].shape[0]
            got = (arrs["u"] * arrs["s"]) @ arrs["v"][:, :k].T
            require(got.shape == want.shape, f"{label}: shape {got.shape} != {want.shape}")
            worst = max(worst, np.abs(got - want).max() / np.linalg.norm(want, 2))
        if dt == "float64":
            check(f"{label}: |U S V^T - (A + ab^T)| / sigma_max", worst, F64_RECON_LIMIT)
        else:
            log(f"  {label}: |U S V^T - (A + ab^T)| / sigma_max {worst:.3e} (the f32 route's own "
                f"error; held to the CPU below)")
        # the same states and pairs through the same route on the CPU
        cpu_states = [convert.state_from_arrays(**convert.state_to_arrays(st), device="cpu")
                      for st in states]
        want = api.update_many(cpu_states, [p[1] for p in probs], [p[2] for p in probs], pol)
        stack = lambda sts: [torch.stack([getattr(x, f).cpu() for x in sts])  # noqa: E731
                             for f in ("u", "s", "v")]
        check_pair(f"{label}: card vs CPU", stack(outs), stack(want), MAIN_TOL[dt])
    for kname in ("fused_update", "fused_update_truncated", "cauchy_matmul"):
        require(launches[kname] > 0, f"the main path never launched {kname}")

    # -- phase 3b: the structured-update path (api.apply / api.apply_many) -----
    log(f"structured updates (api.apply / api.apply_many), default policy (phase 3b, from "
        f"{time.perf_counter() - t_run:.0f} s into the run):")
    def stacked(sts, device="cpu"):
        return [torch.stack([getattr(x, f) for x in sts]).to(device) for f in ("u", "s", "v")]

    def truth_faults(label, arrs, v_in, err_fn, limit):
        """The truth check must reject the output with V left unrotated and
        with the sign of the first member's smallest triplet flipped."""
        flip = arrs["u"].copy()
        j = int(np.abs(arrs["s"][0]).argmin())
        flip[0, :, j] = -flip[0, :, j]
        for what, fault in (("V unrotated", (arrs["u"], arrs["s"], v_in)),
                            ("sign of the smallest triplet flipped", (flip, arrs["s"], arrs["v"]))):
            e = err_fn(*fault)
            log(f"    planted fault, {what}: {e:.3e} (limit {limit:.3g})")
            require(e > limit, f"{label}: the check passes a planted fault ({what})")

    # (1) full, exact regime: one batched Sparse of rank <= 8 on 128 stacked
    # full f64 states at the reference's engine-bench geometry, held to the
    # dense truth and to the same route on the CPU
    u1, s1, v1 = d1["u"], d1["s"], d1["v"]
    b1, m1, n1 = u1.shape[0], u1.shape[1], v1.shape[1]
    op1 = updates.Sparse(d1["rows"], d1["cols"], d1["vals"], rank=d1["rank"])
    st1 = api.SvdState.from_factors(u1, s1, v1, device=dev)
    out1 = drive("1 full exact", lambda: api.apply(st1, op1))
    truth1 = op1.apply_dense((u1 * s1[:, None, :]) @ v1[:, :, :m1].transpose(0, 2, 1)).numpy()
    s_true1 = np.linalg.svd(truth1, compute_uv=False)

    def truth1_err(u, s, v):
        """max over members of |U S V[:, :m]^T - T| / sigma_max and |s - s_T| / sigma_max."""
        rec = (u * s[:, None, :]) @ v[:, :, :m1].transpose(0, 2, 1)
        return max(float((np.abs(rec - truth1).max(axis=(1, 2)) / s_true1[:, 0]).max()),
                   float((np.abs(s - s_true1).max(axis=1) / s_true1[:, 0]).max()))

    a1 = convert.state_to_arrays(out1)
    require(all(np.isfinite(x).all() for x in a1.values()), "drive 1: non-finite output")
    label1 = f"drive 1: api.apply B{b1} ({m1},{n1}) float64 Sparse rank 8"
    check(f"{label1} vs dense truth, over sigma_max", truth1_err(a1["u"], a1["s"], a1["v"]),
          DRIVE1_TRUTH_LIMIT)
    truth_faults(label1, a1, v1, truth1_err, DRIVE1_TRUTH_LIMIT)
    cpu1 = api.apply(api.SvdState.from_factors(u1, s1, v1, device="cpu"), op1)
    check_pair(f"{label1}: card vs CPU", [x.cpu() for x in (out1.u, out1.s, out1.v)],
               [cpu1.u, cpu1.s, cpu1.v], DRIVE_TOL["exact"])
    drive_timing.append((f"1 api.apply B{b1} ({m1},{n1}) float64 Sparse(nnz "
                         f"{d1['vals'].shape[-1]}, rank 8)", lambda: api.apply(st1, op1)))

    # (2) truncated, the reference's sparse bench geometry: apply_many of
    # Compose(Decay, Sparse rank 8), then of RankK(k=32) (k >= 17: one
    # update_rank_k step), in f64 and f32, held to the same route on the CPU;
    # "2 truncated" with a 1 % random COO delta (outside the sketch's exact
    # regime), "2x truncated exact" with 2048 entries in 8 rows (inside it)
    d2 = inputs["2"]
    b2, m2, r2 = len(d2["factors"]), d2["factors"][0][0].shape[0], d2["factors"][0][1].shape[0]
    k2 = d2["rank_k"][0][0].shape[1]
    rank_ops2 = [updates.RankK(*uv) for uv in d2["rank_k"]]
    short_ops2 = [updates.RankK(uv[0][:, :-1], uv[1][:, :-1]) for uv in d2["rank_k"]]

    def sparse_ops2(key, rank):
        return [updates.Compose((updates.Decay(d2["decay"]), updates.Sparse(*coo_, rank=rank)))
                for coo_ in d2[key]]

    ops2 = {key: sparse_ops2(key, d2["rank"]) for key in ("sparse", "sparse_exact")}

    def run2(key, dtype, device):
        sts = [api.SvdState.from_factors(*f, device=device, dtype=dtype) for f in d2["factors"]]
        mid = api.apply_many(sts, ops2[key])
        return sts, mid, api.apply_many(mid, rank_ops2)

    def turned(out, angle=0.5):
        """``out`` with the first member's largest triplet's left vector
        turned by ``angle`` towards the next one."""
        u = out[0].clone()
        u[0, :, 0] = np.cos(angle) * out[0][0, :, 0] + np.sin(angle) * out[0][0, :, 1]
        return [u, out[1], out[2]]

    for name2, key in (("2 truncated", "sparse"), ("2x truncated exact", "sparse_exact")):
        out2 = drive(name2, lambda k_=key: {name_of(dt): run2(k_, dt, dev)
                                            for dt in (torch.float64, torch.float32)})
        nnz2 = d2[key][0][2].shape[0]
        for dn, (sts, mid, fin) in out2.items():
            cpu_sts, cpu_mid, cpu_fin = run2(key, getattr(torch, dn), "cpu")
            # moderate planted faults: the stage's last rank-1 component
            # dropped (the CPU route run with it left out), and one member's
            # largest triplet turned by 0.5 rad
            short = {"sparse": api.apply_many(cpu_sts, sparse_ops2(key, d2["rank"] - 1)),
                     "rank_k": api.apply_many(cpu_mid, short_ops2)}
            for stage, got2, want2 in (("sparse", mid, cpu_mid), ("rank_k", fin, cpu_fin)):
                label2 = (f"drive {name2.split()[0]} B{b2} m{m2} n{m2} r{r2} {dn} "
                          + ("Compose(Decay, Sparse)" if stage == "sparse" else "then RankK(32)"))
                tol2 = DRIVE_TOL[(key, dn, stage)]
                got_s, want_s = stacked(got2), stacked(want2)
                check_pair(f"{label2}: card vs CPU", got_s, want_s, tol2)
                planted_faults(label2, got_s, want_s, stacked(sts)[2], tol2)
                for what, e, required in (
                        ("last rank-1 component dropped", measures(got_s, stacked(short[stage]))["recon"],
                         tol2.get("dropped", True)),
                        ("largest triplet turned by 0.5 rad", measures(turned(got_s), want_s)["recon"],
                         True)):
                    log(f"    planted fault, {what}: recon {e:.3e} (tol {tol2['recon']:.3g})"
                        + ("" if required else ", not required"))
                    if required:
                        require(e > tol2["recon"], f"{label2}: the check passes a planted fault ({what})")
            drive_timing.append((f"{name2.split()[0]} apply_many B{b2} m{m2} r{r2} {dn} "
                                 f"Compose(Decay, Sparse(nnz {nnz2}, rank 8))",
                                 lambda s_=sts, o_=ops2[key]: api.apply_many(s_, o_)))
            drive_timing.append((f"{name2.split()[0]} apply_many B{b2} m{m2} r{r2} {dn} RankK(k={k2})",
                                 lambda s_=mid: api.apply_many(s_, rank_ops2)))

    # (3) downdate, the reference's Window bench shape: the planner pins the
    # phase chain for remove steps, so no kernel runs; held to the CPU route
    # (the distance to the dense truth is reported: it is the route's own)
    d3 = inputs["3"]
    facs3 = d3["factors"]
    b3, m3, n3, r3 = len(facs3), facs3[0][0].shape[0], facs3[0][2].shape[0], facs3[0][1].shape[0]
    cut = m3 - d3["keep"]
    op3 = updates.Window(d3["keep"], lam=d3["lam"])
    sts3 = [api.SvdState.from_factors(*f, device=dev) for f in facs3]
    out3 = drive("3 window", lambda: api.apply_many(sts3, [op3] * b3))
    cpu3 = api.apply_many([api.SvdState.from_factors(*f, device="cpu") for f in facs3],
                          [op3] * b3)
    label3 = f"drive 3 apply_many B{b3} ({m3},{n3}) r{r3} Window(cut {cut}) float64"
    check_pair(f"{label3}: card vs CPU", stacked(out3), stacked(cpu3), DRIVE_TOL["exact"])
    planted_faults(label3, stacked(out3), stacked(cpu3), stacked(sts3)[2], DRIVE_TOL["exact"])
    truth3 = np.stack([d3["lam"] * ((u * s) @ v.T)[cut:] for u, s, v in facs3])
    rec3 = recon(*stacked(out3)).numpy()
    log(f"  {label3}: |U S V^T - T| / sigma_max vs dense truth "
        f"{max(float(np.abs(rec3[i] - truth3[i]).max() / np.linalg.norm(truth3[i], 2)) for i in range(b3)):.3e}"
        f" (the route's own; reported)")
    drive_timing.append((f"3 apply_many B{b3} ({m3},{n3}) r{r3} float64 Window(cut {cut})",
                         lambda: api.apply_many(sts3, [op3] * b3)))

    # -- phase 3c: the FMM route (api.update / api.update_many) --------------------
    log(f"FMM route (auto above the fused gate, and method='fmm'; phase 3c, from "
        f"{time.perf_counter() - t_run:.0f} s into the run):")
    fmm_overflows = {}
    fmm_rows = []

    def cpu_copy(sts):
        return [convert.state_from_arrays(**convert.state_to_arrays(st), device="cpu") for st in sts]

    def truth_err(outs, mats, pairs):
        """max over the members of max(|U S V[:, :m]^T - T|, |s - s_T|) / sigma_max(T)."""
        worst = 0.0
        for out, a_mat, (a, b) in zip(outs, mats, pairs):
            t_mat = torch.as_tensor(a_mat + np.outer(a, b), device=dev)
            s_t = torch.linalg.svdvals(t_mat)
            k = out.s.shape[0]
            rec = (out.u * out.s) @ out.v[:, :k].T
            worst = max(worst, float(torch.maximum((rec - t_mat).abs().max(),
                                                   (out.s - s_t).abs().max()) / s_t[0]))
        return worst

    fmm_drives = {
        "i fmm single": ("(i) api.update (1024,1024) f64 uniform(1, 9), auto", [fmm_in["i"]], None),
        "ii fmm batched": ("(ii) api.update_many B8 (1024,1024) f64 uniform(1, 9), auto",
                           fmm_in["ii"], None),
        "iii quickstart": ("(iii) README quickstart (200,300) f64, method='fmm'", [fmm_in["iii"]],
                           api.UpdatePolicy(method="fmm")),
        "iv truncated r127": ("(iv) api.update_many B4 (4096,4096) rank 127 f64, auto",
                              fmm_in["iv"], None),
        "v fmm spread squares": ("(v) api.update_many B8 (1024,1024) f64 spread squares, auto",
                                 fmm_in["v"], None),
    }
    for name, (label, members, pol) in fmm_drives.items():
        if len(members[0]) == 3:
            mats = [x[0] for x in members]
            sts = [api.SvdState.from_dense(a_mat, device=dev) for a_mat in mats]
        else:
            mats = [(u * sv) @ v.T for u, sv, v, _, _ in members]
            sts = [api.SvdState.from_factors(u, sv, v, device=dev) for u, sv, v, _, _ in members]
        pairs = [x[-2:] for x in members]
        resolved = (pol or api.UpdatePolicy()).resolve_method(
            sts[0].n if sts[0].is_full else sts[0].rank + 1, m=sts[0].m, n=sts[0].n,
            rank=None if sts[0].is_full else sts[0].rank)
        require(resolved == "fmm", f"drive {label}: the policy resolves to {resolved}, not fmm")

        def call(sts_=sts, pol_=pol, pairs_=pairs):
            if len(sts_) == 1:
                return [api.update(sts_[0], *pairs_[0], pol_)]
            return list(api.update_many(sts_, [p[0] for p in pairs_], [p[1] for p in pairs_], pol_))

        FMM.OVERFLOWED.clear()
        outs = drive(name, call)
        fmm_overflows[name] = list(FMM.OVERFLOWED)
        log(f"  {label}: members whose FMM plan overflowed its box capacity (those take the "
            f"dense product), one entry per plan: {fmm_overflows[name] or 'none'}")
        require(all(bool(torch.isfinite(x).all()) for o in outs for x in (o.u, o.s, o.v)),
                f"{label}: non-finite output")
        got = stacked(outs)
        cpu_out = call(cpu_copy(sts))
        tol = FMM_TOL_V if name.startswith("v ") else FMM_TOL
        check_pair(f"{label}: card vs CPU", got, stacked(cpu_out), tol)
        planted_faults(label, got, stacked(cpu_out), stacked(sts)[2], tol)
        direct = call(sts, (pol or api.UpdatePolicy()).replace(method="direct"))
        check_pair(f"{label}: card vs the card's method='direct'", got, stacked(direct), tol)
        key = name.split()[0]
        if key in ("iii", "iv"):    # (i), (ii) and (v) are timed with the routes below
            drive_timing.append((label, call))
        if not sts[0].is_full:      # a rank-127 state of a rank-128 sum: no exact truth
            continue
        e = truth_err(outs, mats, pairs)
        reading, limit = FMM_TRUTH[key]
        log(f"  {label}: vs dense truth {e:.3e} (limit {limit:.3g}; the reference on the CPU "
            f"reads {reading:.3e})")
        require(np.isfinite(e) and e <= limit, f"{label}: {e} from the truth, above {limit}")

    # -- phase 3d: the streaming service --------------------------------------------
    log(f"phase 3d from {time.perf_counter() - t_run:.0f} s into the run")
    service_ctx = service_phase()

    # -- phase 3e: the fleet tier, the batch mesh and the collectives ----------------
    log(f"phase 3e from {time.perf_counter() - t_run:.0f} s into the run")
    def launches_of(name, fn):
        """Run ``fn`` with the counters zeroed before it and read after it
        (kept in ``drive_launches`` for the kernels line); the counts of the
        fleet's rounds depend on when the card finishes a round, so they are
        reported, not held to a number."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        drive_launches[name] = dict(_build.LAUNCHES)
        log(f"  {name}: launches {drive_launches[name]}")
        return out

    def fleet_phase(ctx):
        """(f1)-(f4); returns the phase's timing rows."""
        import multiprocessing as mp_
        import shutil
        import tempfile

        from repro_torch import dist as D
        from repro_torch import fleet as FL
        from repro_torch import serve
        from repro_torch.core import engine as ENG
        from repro_torch.core.svd_update import TruncatedSvd
        from repro_torch.dist import merge_tree

        log("the fleet tier, the batch mesh and the collectives:")
        t_phase = time.perf_counter()
        inp = fleet_inputs()
        d1 = inp["f1"]
        ids = [f"f{i}" for i in range(FLEET["streams"])]
        rows = []

        def fleet(n_shards, method, dtype, device, streams=FLEET["streams"], continuous=True):
            """A fleet with the first ``streams`` streams registered; its
            shards on the card (``devices="auto"``) or the CPU.  The fixed
            mode never autoflushes: it is the settle path."""
            on_card = torch.device(device).type == "cuda"
            fl = FL.SvdFleet(n_shards, policy=api.UpdatePolicy(method=method),
                             max_batch=64 if continuous else 1 << 30, continuous=continuous,
                             max_depth=FLEET["max_depth"],
                             devices="auto" if on_card else [torch.device("cpu")])
            for sid, f in zip(ids[:streams], d1["factors"]):
                fl.register(sid, api.SvdState.from_factors(*f, device=device, dtype=dtype))
            return fl

        def feed(fl, first=0, last=FLEET["pairs"], streams=FLEET["streams"], pump=True,
                 sparse=True):
            """Rounds ``first`` .. ``last`` - 1 of one pair a stream, each
            stream's Sparse after round ``sparse_after`` - 1, a pump every
            ``pump_every`` admissions; returns the tokens."""
            toks, n = [], 0
            for e in range(first, last):
                for i in range(streams):
                    toks.append(fl.enqueue(ids[i], *d1["rounds"][e][i]))
                    if sparse and e == FLEET["sparse_after"] - 1:
                        toks.append(fl.enqueue_op(ids[i], updates.Sparse(*d1["sparse"][i],
                                                                         rank=8)))
                    n += 1
                    if pump and n % FLEET["pump_every"] == 0:
                        fl.pump()
            return toks

        def states(fl, sids):
            return [torch.stack([getattr(fl.state(x), f) for x in sids]).cpu()
                    for f in ("u", "s", "v")]

        # (f1) the fleet at the serving shape, per dtype
        n_events = FLEET["streams"] * (FLEET["pairs"] + 1)
        for dt in (torch.float64, torch.float32):
            dn = name_of(dt)
            label = (f"(f1) fused {dn} {FLEET['streams']} streams m{FLEET['m']} n{FLEET['n']} "
                     f"r{FLEET['r']} on {FLEET['shards']} shards")
            fl4 = fleet(FLEET["shards"], "fused", dt, dev)

            def run_timed(fl_=fl4):
                t = time.perf_counter()
                toks = feed(fl_)
                fl_.drain()
                torch.cuda.synchronize()
                return toks, time.perf_counter() - t

            toks, wall = launches_of(f"f1 fused {dn}", run_timed)
            seen = set(fl4.poll())
            require(seen == set(toks) and fl4.pending() == 0,
                    f"{label}: {len(set(toks) - seen)} tokens not visible after drain")
            st = fl4.stats()
            got = states(fl4, ids)
            require(all(bool(torch.isfinite(x).all()) for x in got), f"{label}: non-finite")
            lc = drive_launches[f"f1 fused {dn}"]
            require(lc["fused_update_truncated"] > 0, f"{label}: kernel B never launched")
            require(lc["sparse_project"] == 2 * FLEET["streams"],
                    f"{label}: kernel F launched {lc['sparse_project']} times, expected "
                    f"{2 * FLEET['streams']}")
            # the device's busy time and the host's waits, on two more runs
            flp = fleet(FLEET["shards"], "fused", dt, dev)
            busy_ms, busy_split = device_ms(lambda f_=flp: (feed(f_), f_.drain()), n=1, warm=False)
            source = "CUDA events" if EVENTS_KEY in busy_split else "profiler"
            fls = fleet(FLEET["shards"], "fused", dt, dev)
            syncs, where = count_syncs(lambda f_=fls: (feed(f_), f_.drain()))
            rounds = st.flushes
            row = {"drive": "f1", "route": "fused", "dtype": dn, "streams": FLEET["streams"],
                   "shards": FLEET["shards"], "events": n_events, "wall_ms": wall * 1e3,
                   "events_per_s": n_events / wall, "rounds": rounds,
                   "ms_per_round": wall * 1e3 / rounds, "scan_rounds": st.scan_rounds,
                   "device_busy_ms": busy_ms, "device_share": busy_ms / (wall * 1e3),
                   "device_source": source, "host_waits": syncs,
                   "host_waits_per_round": syncs / max(fls.stats().flushes, 1),
                   "sync_sites": where, "launches_B": lc["fused_update_truncated"],
                   "launches_F": lc["sparse_project"]}
            rows.append(row)
            log(f"  {label}: {n_events} events in {wall * 1e3:.1f} ms: {row['events_per_s']:.0f} "
                f"events/s, {rounds} rounds ({st.scan_rounds} deep), {row['ms_per_round']:.3f} ms "
                f"a round, device busy {busy_ms:.1f} ms ({100 * row['device_share']:.1f} %, "
                f"{source}), {syncs} host waits ({row['host_waits_per_round']:.2f} a round) "
                f"{where or ''}, B {lc['fused_update_truncated']} launches, F {lc['sparse_project']}")
            # drain across 1 and 4 shards (reported: the reference promises ulps)
            fl1 = fleet(1, "fused", dt, dev)
            feed(fl1)
            fl1.drain()
            same = all(torch.equal(x, y) for x, y in zip(states(fl1, ids), got))
            row["drain_1_vs_4_bitwise"] = same
            log(f"  {label}: drain on 1 shard vs 4: {'equal to the bit' if same else 'NOT equal'}")
            # settle across 1 and 4 shards, and query over 8 streams against a
            # single service's settle, to the bit
            g4 = fleet(FLEET["shards"], "fused", dt, dev, continuous=False)
            g1 = fleet(1, "fused", dt, dev, continuous=False)
            for g in (g4, g1):
                feed(g, pump=False)
            require_bitwise(f"{label}: settle on 1 shard vs 4", [torch.stack(x) for x in zip(
                *[(st_.u, st_.s, st_.v) for st_ in g4.settle(ids)])], [torch.stack(x) for x in zip(
                    *[(st_.u, st_.s, st_.v) for st_ in g1.settle(ids)])])
            single = serve.SvdService(max_batch=1 << 30, policy=api.UpdatePolicy(method="fused"))
            for sid, f in zip(ids[:8], d1["factors"]):
                single.register(sid, api.SvdState.from_factors(*f, device=dev, dtype=dt))
            for e in range(FLEET["pairs"]):
                for i in range(8):
                    single.enqueue(ids[i], *d1["rounds"][e][i])
                    if e == FLEET["sparse_after"] - 1:
                        single.enqueue_op(ids[i], updates.Sparse(*d1["sparse"][i], rank=8))
            q, want_q = g4.query(ids[:8]), single.merge_streams(ids[:8])
            require_bitwise(f"{label}: query over 8 streams vs a single service's settle",
                            [q.u, q.s, q.v], [want_q.u, want_q.s, want_q.v])
            if dt == torch.float64:
                cpu_fl = fleet(1, "fused", dt, "cpu")
                feed(cpu_fl)
                cpu_fl.drain()
                check(f"{label}: card (4 shards) vs the route on the CPU (1 shard), over "
                      f"sigma_max", over_sigma_max(got, states(cpu_fl, ids)), SERVE_F64_LIMIT)
                del cpu_fl
            del fl4, flp, fls, fl1, g4, g1, single

        # (f1) one direct row: the phase chain's rounds
        fld = fleet(FLEET["shards"], "direct", torch.float64, dev, streams=FLEET["direct_streams"])

        def run_direct(fl_=fld):
            t = time.perf_counter()
            feed(fl_, last=FLEET["direct_pairs"], streams=FLEET["direct_streams"], sparse=False)
            fl_.drain()
            torch.cuda.synchronize()
            return time.perf_counter() - t

        wall = launches_of("f1 direct float64", run_direct)
        n_dir = FLEET["direct_streams"] * FLEET["direct_pairs"]
        st = fld.stats()
        require(all(bool(torch.isfinite(x).all())
                    for x in states(fld, ids[:FLEET["direct_streams"]])), "(f1) direct: non-finite")
        rows.append({"drive": "f1", "route": "direct", "dtype": "float64",
                     "streams": FLEET["direct_streams"], "shards": FLEET["shards"],
                     "events": n_dir, "wall_ms": wall * 1e3, "events_per_s": n_dir / wall,
                     "rounds": st.flushes, "ms_per_round": wall * 1e3 / st.flushes})
        log(f"  (f1) direct float64 {FLEET['direct_streams']} streams on {FLEET['shards']} shards: "
            f"{n_dir} events in {wall * 1e3:.0f} ms: {n_dir / wall:.0f} events/s, {st.flushes} "
            f"rounds, {wall * 1e3 / st.flushes:.1f} ms a round")
        del fld

        # (f2) the mesh rows on the one card: a one-entry and a four-entry mesh
        d2 = inp["f2"]
        meshes = {"1 entry": D.make_host_mesh(1), "4 entries": D.make_host_mesh(4)}

        def run_mesh():
            out = {}
            for kind, key in (("full", "full_pairs"), ("trunc", "trunc_pairs")):
                sts = [api.SvdState.from_factors(*f, device=dev) for f in d2[kind]]
                A, Bv = [p[0] for p in d2[key]], [p[1] for p in d2[key]]
                pol = api.UpdatePolicy(method="fused")
                out[(kind, None)] = api.update_many(sts, A, Bv, pol)
                for mname, mesh in meshes.items():
                    out[(kind, mname)] = api.update_many(sts, A, Bv, pol.replace(mesh=mesh))
            return out

        outs = launches_of("f2 mesh", run_mesh)
        for kind, what in (("full", f"full f64 (32, 48) B{MESH_B}, kernel A"),
                           ("trunc", f"truncated f64 m{FLEET['m']} n{FLEET['n']} r{FLEET['r']} "
                                     f"B{MESH_B}, kernel B")):
            want = [torch.stack([getattr(o, f) for o in outs[(kind, None)]]) for f in "usv"]
            for mname in meshes:
                require_bitwise(f"(f2) api.update_many {what}, mesh of {mname} vs local",
                                [torch.stack([getattr(o, f) for o in outs[(kind, mname)]])
                                 for f in "usv"], want)
        require(drive_launches["f2 mesh"]["fused_update"] > 0
                and drive_launches["f2 mesh"]["fused_update_truncated"] > 0,
                "(f2) the mesh rows never launched kernel A or B")
        d_s1 = ctx["inputs"]["s1"]
        sids = [f"s{i}" for i in range(SERVE_S1["streams"])]

        def run_service_mesh():
            out = {}
            for mname, mesh in (("none", None), *meshes.items()):
                svc = serve_streams(api, serve, d_s1, method="fused", dtype=torch.float64, mif=2,
                                    device=dev, mesh=mesh)
                serve_rounds(svc, d_s1["rounds"][:3])
                svc.drain()
                out[mname] = stream_stack(svc, sids)
            return out

        svc_outs = launches_of("f2 service mesh", run_service_mesh)
        for mname in meshes:
            require_bitwise(f"(f2) service fused f64 16 streams m512 n768 r16, 3 rounds, mesh of "
                            f"{mname} vs none", svc_outs[mname], svc_outs["none"])

        # (f3) distributed_merge across processes on the one card
        d3 = inp["f3"]
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_f3_", dir=ROOT / "build"))
        np.savez(work / "shards.npz", **{f"{f}{i}": x for i, sh in enumerate(d3)
                                          for f, x in zip("usv", sh)})
        mp_ctx = torch.multiprocessing.get_context("spawn")
        worlds = []
        prev = None
        for backend, world in MERGE_WORLDS:
            paths = {"shards": str(work / "shards.npz"), "prev": prev,
                     "done": str(work / f"done_{backend}{world}"),
                     "out": str(work / f"{backend}{world}_rank%d.npz")}
            init = f"file://{work / f'store_{backend}{world}'}"
            procs = [mp_ctx.Process(target=merge_worker, args=(r, world, backend, init, paths))
                     for r in range(world)]
            worlds.append((backend, world, paths, procs))
            prev = paths["done"]
        t_f3 = time.perf_counter()
        for *_, procs in worlds:
            for p in procs:
                p.start()
        try:
            for backend, world, _, procs in worlds:
                for p in procs:
                    p.join(timeout=600)
                alive = [p for p in procs if p.is_alive()]
                require(not alive, f"(f3) {backend} world {world}: {len(alive)} ranks still "
                        f"running after 600 s")
                require(all(p.exitcode == 0 for p in procs),
                        f"(f3) {backend} world {world}: exit codes {[p.exitcode for p in procs]}")
        finally:
            for *_, procs in worlds:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                        p.join(timeout=30)
        log(f"  (f3) {len(worlds)} worlds ({sum(w for _, w, _, _ in worlds)} processes) in "
            f"{time.perf_counter() - t_f3:.1f} s")
        shards_dev = [TruncatedSvd(*(torch.as_tensor(x, device=dev) for x in sh)) for sh in d3]
        pol = api.UpdatePolicy(method="fused")
        f3_launches = dict(_NONE)
        for backend, world, paths, _ in worlds:
            want = launches_of(f"f3 merge_tree of {world}",
                               lambda w_=world: merge_tree(shards_dev[:w_], policy=pol))
            want = [x.cpu() for x in (want.u, want.s, want.v)]
            res = []
            for r in range(world):
                with np.load(paths["out"] % r) as z:
                    res.append({k: z[k] for k in z.files})
            label = (f"(f3) distributed_merge, {backend} world {world}: {world} rank-"
                     f"{MERGE_F3['r']} shards m{MERGE_F3['m']} n{MERGE_F3['n']} f64 on CUDA tensors")
            for r, x in enumerate(res):
                require_bitwise(f"{label}: rank {r} vs the port's merge_tree",
                                [torch.as_tensor(x[f]) for f in "usv"], want)
                for k_, v_ in json.loads(str(x["launches"])).items():
                    f3_launches[k_] += v_
            ops = [json.loads(str(x["ops"])) for x in res]
            for name in ("psum", "pmean"):
                vals = [o[name] for o in ops]
                if any(isinstance(v, str) for v in vals):
                    log(f"  {label}: {name}_factor {vals[0]}")
                    require(backend == "gloo", f"{label}: {name} refused under {backend}")
                else:
                    check(f"{label}: {name}_factor vs the sum of the shards' u, relative",
                          max(vals), 1e-14)
            merge_ms = [float(x["merge_ms"]) for x in res]
            gather_ms = [float(x["gather_ms"]) for x in res]
            rows.append({"drive": "f3", "backend": backend, "world": world,
                         "merge_ms": max(merge_ms), "gather_ms": max(gather_ms), "ops": ops[0]})
            log(f"  {label}: merge {max(merge_ms):.2f} ms (slowest rank), of which the factor "
                f"all-gather alone {max(gather_ms):.2f} ms"
                + (" (gloo: CUDA tensors staged through the host)" if backend == "gloo" else ""))
        drive_launches["f3 distributed_merge, every rank"] = f3_launches
        log(f"  f3 distributed_merge, every rank: launches {f3_launches}")
        log("  (f3) NCCL across several cards is not run: this machine has one card, and NCCL "
            "takes one rank a card")
        shutil.rmtree(work, ignore_errors=True)

        # (f4) a fleet snapshot: saved with 8 pairs a stream pending, restored
        # onto 2 shards, against the fleet that was not interrupted
        ckpt_dir = ROOT / "build" / "chip_smoke_fleet_ckpt"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        f4 = {}

        def run_f4():
            whole, part = (fleet(FLEET["shards"], "fused", torch.float64, dev) for _ in range(2))
            for fl_ in (whole, part):
                feed(fl_, last=FLEET["pending_from"])     # the Sparse events included
                fl_.drain()
                feed(fl_, first=FLEET["pending_from"], last=FLEET["pending_to"], pump=False)
            f4["pending"] = part.pending()
            part.save(ckpt_dir, step=1)
            for eng in ENG._default_engines.values():
                eng.cache_clear()
            t = time.perf_counter()
            _, resumed = FL.SvdFleet.restore(ckpt_dir, num_shards=2, devices="auto", device=dev)
            torch.cuda.synchronize()
            f4["restore_s"] = time.perf_counter() - t
            f4["misses"] = sum(e.cache_info().misses for e in ENG._default_engines.values())
            builds = []
            real_build = _build.build_all
            _build.build_all = lambda *a: builds.append(1) or real_build(*a)
            try:
                f4["first_events"] = resumed.pump()      # the first flush after the restore
                torch.cuda.synchronize()
            finally:
                _build.build_all = real_build
            f4["first_misses"] = sum(e.cache_info().misses
                                     for e in ENG._default_engines.values()) - f4["misses"]
            f4["first_builds"] = len(builds)
            for fl_ in (whole, resumed):
                feed(fl_, first=FLEET["pending_to"])
                fl_.drain()
            return whole, resumed

        whole, resumed = launches_of("f4 fleet snapshot", run_f4)
        label4 = (f"(f4) fused float64 {FLEET['streams']} streams on {FLEET['shards']} shards, saved "
                  f"with {f4['pending']} events pending, restored onto {resumed.num_shards}")
        require(f4["pending"] > 0 and resumed.num_shards == 2, f"{label4}: nothing pending")
        log(f"  {label4}: restore (load, regroup, warm) {f4['restore_s']:.3f} s; the first flush "
            f"({f4['first_events']} events): {f4['first_misses']} engine-cache misses, "
            f"{f4['first_builds']} library builds")
        require(f4["first_events"] > 0 and f4["first_misses"] == 0 and f4["first_builds"] == 0,
                f"{label4}: the first flush after the restore missed the warmed caches")
        require_bitwise(f"{label4}: resumed vs uninterrupted, every stream", states(resumed, ids),
                        states(whole, ids))
        rows.append({"drive": "f4", "restore_s": f4["restore_s"], "pending": f4["pending"],
                     "first_flush_misses": f4["first_misses"]})
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        log(f"  fleet phase: {time.perf_counter() - t_phase:.1f} s")
        return rows

    fleet_rows = fleet_phase(service_ctx)

    # -- phase 4: times -------------------------------------------------------------
    log(f"times (median of CUDA events after warm-up), from {time.perf_counter() - t_run:.0f} s "
        f"into the run:")

    def phase_ops(k):
        # secular: k roots x k poles per sweep, 5 operations per pair in a
        # bisection sweep (2 subtractions, a division, a multiply-add) and 7 in
        # a Newton sweep; about 35 k^2 for merge, brackets, Loewner, norms,
        # rank and qt; 2 k^3 for hh @ qt
        return k * k * (N_BISECT * 5 + N_NEWTON * 7) + 35 * k * k + 2 * k ** 3

    def full_ops(m, n):
        kr = m + 2 if n - m > 2 else n
        k0 = n - m
        chain = lambda k: 2 * phase_ops(k) + 2 * k * k + 2 * k ** 3  # noqa: E731
        proj = 2 * (2 * n * n + 3 * m * m + n * m) + 2 * n * n
        comp = 2 * k0 ** 3 + 8 * k0 * k0 + 4 * n * k0 if kr != n else 0
        rot_v = 2 * n * kr * kr + 2 * n * (n - kr) * k0 if kr != n else 2 * n ** 3
        return proj + chain(m) + chain(kr) + comp + 6 * m * m + 2 * m ** 3 + rot_v

    def trunc_ops(m, n, r):
        k = r + 1
        return 4 * (m + n) * r + full_ops(k, k) + 2 * (m + n) * k * r

    def bound(nbytes, ops, dtype_name):
        peak = PEAK_OPS["float64" if dtype_name == "float64" else "float32"]
        t_b, t_o = nbytes / MEM_BYTES_PER_S, ops / peak
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    rows = []
    for key, (shape, args) in cases.items():
        kernel, dt = key[0], key[1]
        isz = args[0].element_size()
        if kernel == "C":
            bsz, rr, nn = args[0].shape
            mm = args[2].shape[1]
            nbytes = isz * (bsz * rr * nn + bsz * nn + 3 * bsz * mm + bsz * rr * mm)
            ops = bsz * (2 * rr * nn * mm + 3 * nn * mm)
            fn = lambda a=args: CM.cauchy_matmul_cuda(*a)  # noqa: E731
            plain = lambda a=args: CM.cauchy_matmul_plain(*a)  # noqa: E731
            lib = None
            cplan = CM.cauchy_plan(bsz, rr, nn, mm, args[0].dtype)
        elif kernel == "A":
            bsz, mm, _ = args[0].shape
            nn = args[2].shape[1]
            nbytes = isz * bsz * (2 * mm * mm + 2 * nn * nn + 4 * mm + 2 * nn)
            ops = bsz * full_ops(mm, nn)
            fn = lambda a=args: FU.fused_update_cuda(*a)  # noqa: E731
            plain = lambda a=args: FU._fused_body(*a)  # noqa: E731
            sdt = torch.float32 if args[0].dtype == torch.bfloat16 else args[0].dtype
            dense = (recon(*args[:3]) + args[3].double()[:, :, None] * args[4].double()[:, None, :]).to(sdt)
            lib = lambda d=dense: torch.linalg.svd(d, full_matrices=True)  # noqa: E731
        else:
            bsz, mm, rr = args[0].shape
            nn = args[2].shape[1]
            nbytes = isz * bsz * (2 * (mm + nn) * rr + 2 * rr + mm + nn)
            ops = bsz * trunc_ops(mm, nn, rr)
            fn = lambda a=args: FU.fused_update_truncated_cuda(*a)  # noqa: E731
            plain = lambda a=args: FU._fused_truncated_body(*a)  # noqa: E731
            dense = (recon(*args[:3]) + args[3].double()[:, :, None] * args[4].double()[:, None, :]).to(args[0].dtype)
            lib = lambda d=dense: torch.linalg.svd(d, full_matrices=False)  # noqa: E731
        b_ms, b_by = bound(nbytes, ops, dt)
        row = {"kernel": kernel, "dtype": dt, "shape": shape, "ms": time_ms(fn),
               "plain_ms": time_ms(plain), "library_ms": time_ms(lib) if lib else None,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
               "max_abs_err": errs[key]}
        rows.append(row)
        lib_txt = f"{row['library_ms']:.3f}" if lib else "none"
        extra = ""
        if kernel == "C":
            row["targets"], row["cluster"] = cplan["targets"], cplan["cluster"]
            row["device_ms"], _ = device_ms(fn)
            row["host_ms"] = host_ms(fn)
            extra = (f" (device {row['device_ms']:.4f}, host {row['host_ms']:.4f}; "
                     f"{cplan['targets']} targets a panel, {cplan['cluster']} blocks a panel)")
        if kernel in ("A", "B"):
            plan = plan_of(kernel, args)
            row["cluster"], row["operators"] = plan["cluster"], plan["operators"]
            row["device_ms"], _ = device_ms(fn, n=5)
            row["host_ms"] = host_ms(fn, n=20)
            extra = (f" (device {row['device_ms']:.4f}, host {row['host_ms']:.4f}; "
                     f"{plan['cluster']} blocks an update, operators in {plan['operators']} memory)")
        log(f"  {kernel} {dt} {shape}: kernel {row['ms']:.4f} ms{extra} | plain {row['plain_ms']:.3f} ms "
            f"| torch.linalg.svd {lib_txt} ms | bound {b_ms:.5f} ms ({b_by})")
    f_rows = []
    for (label, dn), (args, out_rows, err) in sparse_cases.items():
        op = SP.cuda_operands(*args)
        bsz, nnz = op.batch, op.vals.shape[-1]
        src, kk = op.mat.shape[-2:]
        isz = op.mat.element_size()
        # bytes: coordinates and values read once, the rows of mat the entries
        # touch (per member), out written once; 2 operations per gathered element
        touched = sum(int(torch.unique(c).numel()) for c in op.cols)
        touched *= bsz if op.cols.shape[0] == 1 else 1
        nbytes = 8 * op.rows.numel() + isz * (bsz * nnz + touched * kk + bsz * out_rows * kk)
        ops = 2 * bsz * nnz * kk
        # the yardstick: one torch.sparse.mm of a block-diagonal CSR matrix with
        # the stacked blocks, the CSR matrix built outside the timed region
        # ("library_ms") and inside it, from the COO entries as F takes them
        # ("library_with_csr_build_ms": coalesce and conversion, like for like
        # with F's own bucketing)
        shift = torch.arange(bsz, device=dev)[:, None]
        idx = torch.stack([(op.rows.expand(bsz, nnz).long() + shift * out_rows).reshape(-1),
                           (op.cols.expand(bsz, nnz).long() + shift * src).reshape(-1)])
        coo_vals = op.vals.expand(bsz, nnz).reshape(-1)

        def csr_of(i_=idx, v_=coo_vals, shape_=(bsz * out_rows, bsz * src)):
            with warnings.catch_warnings():  # sparse CSR support is marked beta
                warnings.simplefilter("ignore", UserWarning)
                return torch.sparse_coo_tensor(i_, v_, shape_).coalesce().to_sparse_csr()

        csr = csr_of()
        dense_mat = op.mat.expand(bsz, src, kk).reshape(bsz * src, kk).contiguous()
        lib_err = sparse_err(torch.sparse.mm(csr, dense_mat).reshape(bsz, out_rows, kk),
                             SP.sparse_project_plain(*args, out_rows).reshape(bsz, out_rows, kk))
        require(lib_err <= SPARSE_TOL[dn], f"torch.sparse.mm computes another function ({lib_err})")
        b_ms, b_by = bound(nbytes, ops, dn)

        def prep_walk(op_=op, out_rows_=out_rows):
            """The bucketing F used to take, in PyTorch (a stable sort and
            searchsorted), then the walk."""
            perm, rowptr = SP.sparse_project_prep(op_.rows, out_rows_)
            return SP.sparse_project_launch(perm, rowptr, op_, out_rows_)

        f_call = lambda a=args, o=out_rows: SP.sparse_project_cuda(*a, o)  # noqa: E731
        dev_ms, dev_split = device_ms(f_call)
        row = {"kernel": "F", "dtype": dn, "shape": label, "ms": time_ms(f_call),
               "device_ms": dev_ms, "device_split_ms": dev_split, "host_ms": host_ms(f_call),
               "prep_walk_ms": time_ms(prep_walk),
               "plain_ms": time_ms(lambda: SP.sparse_project_plain(*args, out_rows)),
               "library_ms": time_ms(lambda: torch.sparse.mm(csr, dense_mat)),
               "library_with_csr_build_ms": time_ms(lambda: torch.sparse.mm(csr_of(), dense_mat)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
               "max_abs_err": err}
        f_rows.append(row)
        log(f"  F {dn} {label}: kernel with bucketing {row['ms']:.4f} ms (device {dev_ms:.4f}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in dev_split.items())
            + f"; host {row['host_ms']:.4f}) | PyTorch sort + searchsorted, then the walk "
            f"{row['prep_walk_ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | torch.sparse.mm "
            f"{row['library_ms']:.4f} ms, with the CSR build {row['library_with_csr_build_ms']:.4f} ms "
            f"| bound {b_ms:.5f} ms ({b_by})")
    # kernel D: every step of every root reads all N poles; 5 operations a
    # pole term in a bisection step (2 subtractions, a division, a
    # multiply-add) and 7 in a Newton step; poles, weights, rho and three
    # numbers a root read once, tau written once.  Beside that bound, one at
    # the pipes D can use (no tensor cores: the terms are reciprocals): its
    # own instructions a term, read from cuobjdump -sass of the build
    # (tools/cauchy_secular_probe.py --sass; SECULAR_SASS), over 132 SMs x
    # 64 f64 lanes (f64) or 128 f32 lanes (f32) and 16 MUFU lanes a clock at
    # the card's largest SM clock
    d_rows = []
    sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"], capture_output=True, text=True,
                                  check=True).stdout.split()[0])
    for (brackets, dn, nb, nn_), (args, err) in secular_cases.items():
        bsz, nn = args[0].shape
        mm = args[3].shape[1]
        isz = args[0].element_size()
        nbytes = isz * (2 * bsz * nn + bsz + 4 * bsz * mm)
        ops = bsz * mm * nn * (nb * 5 + nn_ * 7)
        b_ms, b_by = bound(nbytes, ops, dn)
        sass = SECULAR_SASS[dn]
        terms_b, terms_n = bsz * mm * nn * nb, bsz * mm * nn * nn_
        clk = torch.cuda.get_device_properties(0).multi_processor_count * sm_mhz * 1e6
        pipe_ms = max((terms_b * sass["bisect"] + terms_n * sass["newton"]) / (clk * sass["lanes"]),
                      (terms_b + terms_n) / (clk * 16)) * 1e3
        fn = lambda a=args, b_=nb, n_=nn_: SN.secular_solve_cuda(*a, n_bisect=b_, n_newton=n_)  # noqa: E731
        row = {"kernel": "D", "dtype": dn, "shape": f"B{bsz} N=M={nn} {brackets} brackets",
               "steps": f"{nb}+{nn_}", "ms": time_ms(fn), "device_ms": device_ms(fn)[0],
               "host_ms": host_ms(fn),
               "plain_ms": time_ms(lambda a=args, b_=nb, n_=nn_: SN.secular_solve_plain(
                   *a, n_bisect=b_, n_newton=n_)), "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "pipe_bound_ms": pipe_ms, "bytes": nbytes,
               "ops": ops, "max_abs_err": err}
        d_rows.append(row)
        log(f"  D {dn} {row['shape']} {row['steps']}: kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}, host {row['host_ms']:.4f}) | plain {row['plain_ms']:.3f} ms "
            f"| bound {b_ms:.5f} ms ({b_by}) | pipe bound {pipe_ms:.5f} ms at {sm_mhz:.0f} MHz")
    # kernel E: 2 operations a multiply-add over R x nb x 3cap x capt, and 4 to
    # build each block entry (a subtraction, an addition, a division, the
    # mask); w_near and the coordinates read once, out written once.  The
    # yardstick is no single call of the same function: it is the einsum of
    # the reference's plan against a prebuilt near_inv (the plain version's
    # blocks, built outside the timing), a reference point only
    e_rows = []
    for (which, bsz, dn), (shape, args, err) in near_cases.items():
        w_near, x_near, av_b, tau_b, tm = args
        _, rr, nbx, c3 = w_near.shape
        capt = av_b.shape[-1]
        isz = w_near.element_size()
        nbytes = isz * (bsz * rr * nbx * c3 + bsz * nbx * c3 + 3 * bsz * nbx * capt
                        + bsz * rr * nbx * capt)
        ops = 2 * bsz * rr * nbx * c3 * capt + 4 * bsz * nbx * c3 * capt
        denom = (av_b[:, :, None, :] - x_near[:, :, :, None]) + tau_b[:, :, None, :]
        near_inv = torch.where(denom != 0.0, 1.0 / torch.where(denom == 0.0, 1.0, denom),
                               0.0) * tm.to(w_near.dtype)[:, :, None, :]
        b_ms, b_by = bound(nbytes, ops, dn)
        e_dev, _ = device_ms(lambda a=args: NF.nearfield_cuda(*a), n=5)
        row = {"kernel": "E", "dtype": dn, "shape": f"{which} {shape}",
               "ms": time_ms(lambda a=args: NF.nearfield_cuda(*a)), "device_ms": e_dev,
               "plain_ms": time_ms(lambda a=args: NF.nearfield_plain(*a)), "library_ms": None,
               "einsum_near_inv_ms": time_ms(
                   lambda w_=w_near, c_=near_inv: torch.einsum("zrbc,zbct->zrbt", w_, c_)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops, "max_abs_err": err}
        e_rows.append(row)
        del near_inv, denom
        log(f"  E {dn} {row['shape']}: kernel {row['ms']:.4f} ms (device {e_dev:.4f}, "
            f"{ops / row['ms'] / 1e9:.1f} TFLOP/s) | plain {row['plain_ms']:.3f} ms "
            f"| einsum on a prebuilt near_inv (reference point) {row['einsum_near_inv_ms']:.4f} ms "
            f"| bound {b_ms:.5f} ms ({b_by})")
    # the FMM route against kernel C (method="pallas") and the phase chain
    # (direct) on the same states at (1024, 1024) f64: drive (i) (B=1), (ii)
    # (B=8) and (v) (B=8); the fmm rows are those drives end to end
    route_rows = []
    for label, members in (("uniform(1, 9)", [fmm_in["i"]]), ("uniform(1, 9)", fmm_in["ii"]),
                           ("spread squares", fmm_in["v"])):
        if len(members[0]) == 3:
            sts = [api.SvdState.from_dense(x[0], device=dev) for x in members]
        else:
            sts = [api.SvdState.from_factors(*x[:3], device=dev) for x in members]
        pairs = [x[-2:] for x in members]
        for method in ("fmm", "pallas", "direct"):
            pol = api.UpdatePolicy(method=method)
            if len(sts) == 1:
                fn = lambda s_=sts, p_=pol, q_=pairs: api.update(s_[0], *q_[0], p_)  # noqa: E731
            else:
                fn = lambda s_=sts, p_=pol, q_=pairs: api.update_many(  # noqa: E731
                    s_, [p[0] for p in q_], [p[1] for p in q_], p_)
            route_rows.append({"route": method, "states": f"B{len(sts)} (1024,1024) f64 {label}",
                               "ms": time_ms(fn)})
            log(f"  route {method} B{len(sts)} (1024,1024) f64 {label}: {route_rows[-1]['ms']:.2f} ms "
                f"end to end")
    drive_rows = []
    for label, fn in drive_timing:
        drive_rows.append({"drive": label, "ms": time_ms(fn)})
        log(f"  drive {label}: {drive_rows[-1]['ms']:.3f} ms end to end")
    service_rows = service_times(service_ctx)
    log("timings " + json.dumps({"timings": rows + f_rows + d_rows + e_rows, "drives": drive_rows,
                                 "service": service_rows, "fleet": fleet_rows,
                                 "routes": route_rows, "drive_launches": drive_launches,
                                 "fmm_overflowed": fmm_overflows, "card": card}))

    # -- phase (x), the examples: last, after every kernel has been checked -------
    log("phase (x): the examples")
    x_out = examples_phase(dev, card)
    log("examples " + json.dumps(x_out, default=str))
    x_launches = x_out["launches"]

    headline = {"C": ("float64", 16, 192), "A": ("float64", 32), "B": ("float32", 512)}
    meta = {
        "C": ("cauchy_matmul", "src/repro_torch/csrc/cauchy_matmul.cu",
              "src/repro/kernels/cauchy_matmul.py:139", "cauchy_matmul"),
        "A": ("fused_update", "src/repro_torch/csrc/fused_update.cuh",
              "src/repro/kernels/fused_update.py:566", "fused_update"),
        "B": ("fused_update_truncated", "src/repro_torch/csrc/fused_update.cuh",
              "src/repro/kernels/fused_update.py:601", "fused_update_truncated"),
    }
    kernels = []
    for k, (name, source, replaces, counter) in meta.items():
        row = next(rw for key, rw in zip(cases, rows) if key == (k,) + headline[k])
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[counter] + x_launches[counter]
                        + sum(d[counter] for d in drive_launches.values()),
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        **({k_: row[k_] for k_ in ("cluster", "targets", "device_ms", "host_ms")
                            if k_ in row}),
                        "shape": f"{row['dtype']} {row['shape']}"})
    # kernel F (with its bucketing) at the sketch's shape, as drive 2 gives it;
    # launches over the drives
    row = next(rw for rw in f_rows if (rw["dtype"], rw["shape"]) == ("float64", "1024x1024 nnz10485 l16"))
    kernels.append({"name": "sparse_project", "route": "cuda",
                    "source": "src/repro_torch/csrc/sparse_proj.cu",
                    "replaces": "src/repro/kernels/sparse_proj.py:179",
                    "launches": x_launches["sparse_project"]
                    + sum(d["sparse_project"] for d in drive_launches.values()),
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "device_ms": row["device_ms"], "prep_walk_ms": row["prep_walk_ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "library_with_csr_build_ms": row["library_with_csr_build_ms"],
                    "shape": f"float64 {row['shape']}"})
    # kernels D and E at their headline shapes (f64: B8 real brackets; the
    # full plan at B8); launches over the main path and every drive
    for name, source, replaces, counter, row in (
            ("secular_solve", "src/repro_torch/csrc/secular_newton.cu",
             "src/repro/kernels/secular_newton.py:47", "secular_solve",
             next(rw for rw in d_rows if rw["dtype"] == "float64" and "real" in rw["shape"]
                  and rw["steps"] == "58+4")),
            ("nearfield", "src/repro_torch/csrc/nearfield.cu", "src/repro/kernels/nearfield.py:39",
             "nearfield", next(rw for rw in e_rows if rw["dtype"] == "float64"
                               and rw["shape"].startswith("full B8")))):
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[counter] + x_launches[counter]
                        + sum(d[counter] for d in drive_launches.values()),
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None,
                        **({k_: row[k_] for k_ in ("einsum_near_inv_ms", "device_ms", "host_ms",
                                                   "pipe_bound_ms", "steps") if k_ in row}),
                        "shape": f"float64 {row['shape']}"})
    # kernel S at the score cotangent (phase (s)); launches over (m1)'s bf16
    # training, which counts both of its entry points
    m1_split = shard_out["m1_train"]["split_launches"]
    kernels.append({"name": "split_bf16x3", "route": "cuda",
                    "source": "src/repro_torch/csrc/split_bf16x3.cu", "replaces": None,
                    "launches": sum(m1_split.values()), "launches_by_entry": m1_split,
                    "launches_over": f"phase (m1)'s train(mesh=), {SHARD['steps']} bf16 steps",
                    "max_abs_err": 0.0, **split_out})
    log(f"run: {time.perf_counter() - t_run:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
