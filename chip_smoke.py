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
   restore and warm seconds at (s2); the (s3) round and merge.


The last lines are the ``kernels`` JSON line, the card (nvidia-smi), and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
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


def serve_streams(api, serve, d, *, method, dtype, mif, device, max_batch=None):
    """A service with the streams of ``d`` registered (not yet fed)."""
    svc = serve.SvdService(max_batch=max_batch or len(d["factors"]), max_in_flight=mif,
                           policy=api.UpdatePolicy(method=method))
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


def main() -> int:
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
        # where a call takes under half a second, 2 for the second-long routes
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t) * 1e3
        reps = int(min(30, max(3 if once < 500 else 2, budget_ms / max(once, 1e-3))))
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
            _build.build_all = lambda: builds.append(1) or real_build()
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

    def count_syncs(fn):
        """Host waits for the device while ``fn`` runs, as
        ``torch.cuda.set_sync_debug_mode`` reports them: (count, {file:line: count})."""
        import collections

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
    log("kernels vs plain:")
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
    log("main path (api.update_many / api.update):")
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
    log("structured updates (api.apply / api.apply_many), default policy:")
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
    log("FMM route (auto above the fused gate, and method='fmm'):")
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
    service_ctx = service_phase()

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
                                 "service": service_rows,
                                 "routes": route_rows, "drive_launches": drive_launches,
                                 "fmm_overflowed": fmm_overflows, "card": card}))

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
                        "launches": launches[counter] + sum(d[counter]
                                                            for d in drive_launches.values()),
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
                    "launches": sum(d["sparse_project"] for d in drive_launches.values()),
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
                        "launches": launches[counter] + sum(d[counter]
                                                            for d in drive_launches.values()),
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None,
                        **({k_: row[k_] for k_ in ("einsum_near_inv_ms", "device_ms", "host_ms",
                                                   "pipe_bound_ms", "steps") if k_ in row}),
                        "shape": f"float64 {row['shape']}"})
    log(f"run: {time.perf_counter() - t_run:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
