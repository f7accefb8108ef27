// The fused rank-1 SVD update core, for a team of thread blocks per update.
//
// Shared by kernel A (full update) and kernel B (Brand-truncated update) in
// fused_update.cuh.  It computes what repro/kernels/fused_update.py's
// _fused_body computes, step by step:
//   projections V^T b, U^T a, A b, A^T a;  the analytic 2x2 splits;
//   on each side a chain of two diagonal-plus-rank-1 phases (phase2():
//   grouped Householder merge of near-coincident poles, tiny-z deflation,
//   brackets and anchors, secular_iterate(), Loewner zhat in log space,
//   scaled-Cauchy columns, stable reorder);  the structural-zero compression
//   of the right problem to m + 2 coordinates when n - m > 2;  the rotations
//   and the sign fix.
//
// The team.  An update runs on a Team: the blocks of one thread-block
// cluster (kernel A), or one block alone (kernel B's core, which every block
// of B's cluster computes for itself: the same code on the same inputs gives
// the same bits).  Each block keeps every vector of the update in its own
// shared memory; where they do not fit (kmax past about 300 in f64 or 590 in
// f32), they live in a device scratch and the team is one block.  Work on
// roots, poles and entries is cut into the team's slices (Team::lo / hi); a
// slice's results reach the other blocks through distributed shared memory
// (gather()).
//
// The chains.  The left and right chains are independent, so they run
// together: every step of a phase (phase2()) takes both sides' problems,
// and their roots share the lane groups where a model of the sweep says
// that is cheaper (the sweeps and barriers are bound by latency, so one pass
// serves both).
//
// The operators.  The (k, k) operators that outlive a phase (both chains'
// phi1 and phib, then each side's G) are stored by rows: row r lives with
// team block r / Ops::rows, in that block's shared memory when the team's
// slots fit beside its vectors (one block: shared memory; a cluster:
// distributed shared memory), else in a device scratch the wrapper
// allocates (the live set only: 5 slots).  Every read goes through a
// generic pointer, so the same code serves the three places.  qt and the
// Householder hh of a phase are never stored: phi = hh @ qt is formed entry
// by entry, each entry walking only its row's group (hh is block diagonal;
// an entry sums the same terms in the same order as the dense product).  The dense products (each
// side's G = phi1 @ flip2(phib), U @ G_u, V @ G_v, B's factor rotations) go
// through gemm(): 64 x 64 output tiles shared out over the team, operands
// staged through shared memory in 16-deep slices; f64 on the DMMA tensor
// cores (mma.sync m16n8k8, fragment layouts verified by tools/dmma_probe.cu),
// f32 with register-tiled FFMA (4 x 4 outputs a thread, summed in k order).
//
// The secular loop and the other per-root sums run on lane groups: a group
// of g lanes (a power of two, chosen by a model of the sweep for the whole
// problem: lanes_for) takes one root (or pole), its lanes take every g-th
// term (held in registers when they are few), with several accumulators
// each, and a butterfly shuffle adds the lanes.
//
// All reductions run in a fixed order (warp butterflies, warps in order,
// kernel B's Brand sums over fixed chunks of rows and a pairwise tree); no
// atomic decides a sum, and no sum's order depends on the team's size or on
// where a value is stored.  So a launch gives the same bits every time, and
// an update the same bits at every batch size.
#pragma once

#include <cfloat>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// Phase markers for tools/fused_phases.cu; empty in the package's build.
#ifndef FUSED_MARK
#define FUSED_MARK(id)
#define FUSED_MARK_START()
#endif

namespace fused {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int RED = 64;       // reduction buffer, in elements of T
constexpr int MAXC = 8;       // the largest cluster: the portable limit
constexpr int NCHUNK = MAXC;  // kernel B's Brand sums: fixed chunks of the rows
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on Hopper (227 KB)

// gemm(): 64 x 64 output tiles, operands staged 16 deep, rows padded by 4
constexpr int TM = 64, TN = 64, TK = 16, LDS = TM + 4;
constexpr int STAGE_ELEMS = 2 * TK * LDS;

// -- numeric limits and math, per compute type -------------------------------

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float max() { return FLT_MAX; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double max() { return DBL_MAX; }
};

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

// -- storage <-> compute conversions -----------------------------------------

template <typename T, typename S>
__device__ __forceinline__ T ld(const S* p, long i) { return static_cast<T>(p[i]); }
template <>
__device__ __forceinline__ float ld<float, __nv_bfloat16>(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
template <>
__device__ __forceinline__ float ld<float, __half>(const __half* p, long i) {
  return __half2float(p[i]);
}

template <typename S, typename T>
__device__ __forceinline__ void st(S* p, long i, T x) { p[i] = static_cast<S>(x); }
template <>
__device__ __forceinline__ void st<__nv_bfloat16, float>(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}
template <>
__device__ __forceinline__ void st<__half, float>(__half* p, long i, float x) {
  p[i] = __float2half(x);
}

// -- workspace layout ----------------------------------------------------------

enum VecSlot {
  // phase2() and chains(): one bank per chain, bank b's slot at slot + b N_BANK
  P_Z2RAW, P_ISREP, P_GZ2, P_ZREP, P_RVEC, P_WV, P_GN2, P_ZM, P_Z2K, P_ANCHOR, P_TAU,
  P_MU, P_ZHAT, P_COLNORM, C_MU1, C_Z2, C_DNEG, C_ZNEG, C_MUB, N_BANK,
  // full_core(): the left chain's inputs (F_D0, F_Z1, F_Z2W) and the right's (..R)
  F_S = 2 * N_BANK, F_A, F_B, F_VTB, F_BT, F_UTA, F_AT, F_A1, F_B1, F_A2, F_B2, F_VA2, F_VB2,
  F_DASC, F_DASCR, F_DL, F_DR, F_D0, F_Z1, F_Z2W, F_D0R, F_Z1R, F_Z2WR, F_BV, F_CORE, F_AU,
  F_FLIP, F_BTVA, F_VN0, F_VN1,
  // compression
  X_Q1, X_Q2, X_C2P, X_F1, X_F2, X_W1, X_W2, X_Q2H, X_MQ0, X_MQ1,
  // truncated kernel
  T_PVEC, T_QVEC, T_SAUG, T_AK, T_BK,
  N_VEC_SLOTS
};
enum IntSlot { I_LEAD0, I_LEAD1, I_KEEP, I_RANK, I_NEXT, I_PERM, N_IBANK,
               N_INT_SLOTS = 2 * N_IBANK };
// the operators that outlive a phase: the left G, each chain's two phase
// rotations; the right G takes the left chain's phi1 once G_L is formed
enum OpSlot { O_GL, O_PHI1_0, O_PHIB_0, O_PHI1_1, O_PHIB_1, N_OPS, O_GR = O_PHI1_0 };

__host__ __device__ inline int kmax_of(int m, int n) { return n > m + 2 ? n : m + 2; }
// the largest chain of a full update: m on the left, m + 2 or n on the right
__host__ __device__ inline int chain_k(int m, int n) {
  const int kr = n - m > 2 ? m + 2 : n;
  return kr > m ? kr : m;
}
__host__ __device__ inline int rows_per(int kc, int csz) { return (kc + csz - 1) / csz; }
__host__ __device__ inline long ops_elems(int kc, int csz) {
  return (long)N_OPS * rows_per(kc, csz) * kc;
}
// The vectors of one context in device scratch, in elements of T: the int
// slots follow the T slots (an int per element: no narrower than T).
__host__ __device__ inline long vec_elems(int kmax) {
  return (long)(N_VEC_SLOTS + N_INT_SLOTS) * kmax;
}

struct Layout {
  size_t ptrs, red, xchg, vecs, ints, stage, ops, total;
};

// Byte offsets in a block's dynamic shared memory: the team's operator base
// pointers, the reduction buffer, ``xchg`` elements read by the other blocks
// of a cluster (kernel B's Brand sums), the vectors (kmax elements a slot)
// when they fit (``vecs_in_smem``; else they live in device scratch), the
// gemm staging and, when they fit, this block's rows of the operators (kc
// columns, Ops::rows rows a slot).
template <typename T>
__host__ __device__ inline Layout layout(int kmax, int kc, int csz, bool ops_in_smem,
                                         bool vecs_in_smem = true, size_t xchg = 0) {
  Layout L;
  size_t o = 0;
  L.ptrs = o;
  o += MAXC * sizeof(void*);
  L.red = o;
  o += RED * sizeof(T);
  L.xchg = o;
  o += xchg * sizeof(T);
  L.vecs = o;
  if (vecs_in_smem) o += (size_t)N_VEC_SLOTS * kmax * sizeof(T);
  L.ints = o;
  if (vecs_in_smem) o += (size_t)N_INT_SLOTS * kmax * sizeof(int);
  o = (o + 15) & ~(size_t)15;
  L.stage = o;
  o += (size_t)STAGE_ELEMS * sizeof(T);
  L.ops = o;
  if (ops_in_smem) o += (size_t)ops_elems(kc, csz) * sizeof(T);
  L.total = o;
  return L;
}

// -- the team --------------------------------------------------------------------

struct Team {
  int rank, size;
  __device__ void sync() const {
    if (size > 1) cg::this_cluster().sync();
    else __syncthreads();
  }
  template <typename P>
  __device__ P* map(P* p, int r) const {
    return size > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
  }
  __device__ int lo(int k) const { return (int)((long)k * rank / size); }
  __device__ int hi(int k) const { return (int)((long)k * (rank + 1) / size); }
};

// Operator storage: row r of slot s is computed by team block r / rows.  In
// distributed shared memory it also lives there (block b's rows at base[b]);
// in one block's shared memory or in the scratch the slots are flat (kc, kc)
// arrays at base[0], so an entry's address needs no division.
template <typename T>
struct Ops {
  T* base0;        // flat: the slots
  T* const* base;  // distributed: MAXC generic pointers, in shared memory
  int rows, ld;
  long slot;
  bool flat;
  __device__ T* at(int s, int r, int c) const {
    if (flat) return base0 + s * slot + (long)r * ld + c;
    const int b = r / rows;
    return base[b] + s * slot + (long)(r - b * rows) * ld + c;
  }
};

template <typename T>
struct Ctx {
  T* red;      // RED elements
  T* xchg;     // read by the other blocks of a cluster
  T* vecs;     // N_VEC_SLOTS * kmax, in shared memory or in device scratch
  int* ints;   // N_INT_SLOTS * kmax, beside them
  T* stage;    // STAGE_ELEMS
  Ops<T> ops;
  Team team;
  int kmax;
  T rtol;
  int n_bisect, n_newton;
  __device__ T* v(int slot) const { return vecs + (long)slot * kmax; }
  __device__ int* iv(int slot) const { return ints + (long)slot * kmax; }
};

// A context on this block's shared memory.  ``ops_scratch``: the update's
// operators in device scratch (N_OPS flat (kc, kc) slots), or null when they
// live in shared memory (one block: flat; a cluster: each block its rows).
// ``vec_scratch``: the vectors in device scratch (vec_elems(kmax); a team of
// one block only, since gather() reads the other blocks' shared memory), or
// null when they live in shared memory.
template <typename T>
__device__ Ctx<T> make_ctx(unsigned char* smem, const Layout& L, const Team& team, int kmax,
                           int kc, T* ops_scratch, T* vec_scratch, double rtol, int nb, int nn) {
  Ctx<T> c;
  T** ptrs = reinterpret_cast<T**>(smem + L.ptrs);
  c.red = reinterpret_cast<T*>(smem + L.red);
  c.xchg = reinterpret_cast<T*>(smem + L.xchg);
  c.vecs = vec_scratch ? vec_scratch : reinterpret_cast<T*>(smem + L.vecs);
  c.ints = vec_scratch ? reinterpret_cast<int*>(vec_scratch + (long)N_VEC_SLOTS * kmax)
                       : reinterpret_cast<int*>(smem + L.ints);
  c.stage = reinterpret_cast<T*>(smem + L.stage);
  c.ops.flat = team.size == 1 || ops_scratch != nullptr;
  c.ops.base0 = ops_scratch ? ops_scratch : reinterpret_cast<T*>(smem + L.ops);
  if (!c.ops.flat && threadIdx.x < team.size)
    ptrs[threadIdx.x] = team.map(reinterpret_cast<T*>(smem + L.ops), threadIdx.x);
  c.ops.base = ptrs;
  c.ops.rows = rows_per(kc, team.size);
  c.ops.ld = kc;
  c.ops.slot = c.ops.flat ? (long)kc * kc : (long)c.ops.rows * kc;
  c.team = team;
  c.kmax = kmax;
  c.rtol = static_cast<T>(rtol);
  c.n_bisect = nb;
  c.n_newton = nn;
  __syncthreads();
  return c;
}

// -- block-wide and lane-group helpers ---------------------------------------

struct SumOp { template <typename T> __device__ T operator()(T a, T b) const { return a + b; } };
struct MaxOp { template <typename T> __device__ T operator()(T a, T b) const { return a > b ? a : b; } };

// Fixed-order reduction of one value per thread; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(FULL, v, o));
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = red[0];
    for (int w = 1; w < NWARPS; ++w) acc = op(acc, red[w]);
    red[RED - 1] = acc;
  }
  __syncthreads();
  return red[RED - 1];
}

// sum_i x[i] * y[i] over i < k (y == nullptr: sum of x[i]^2)
template <typename T>
__device__ T block_dot(int k, const T* x, const T* y, T* red) {
  T acc = T(0);
  for (int i = threadIdx.x; i < k; i += THREADS) acc += x[i] * (y ? y[i] : x[i]);
  return block_reduce(acc, red, SumOp());
}

// Butterfly over a lane group of g lanes (a power of two): every lane of the
// group gets the same bits.  All 32 lanes of the warp must call it.
template <typename T>
__device__ __forceinline__ T gsum(T v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
template <typename T>
__device__ __forceinline__ T gmin(T v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(FULL, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// Lane groups: g lanes an item (a root or a pole), ng groups in the block, g
// a power of two.  sweep_cost() is a model of a secular sweep over ``items``
// roots of k terms, in cycles, fitted to a micro-benchmark of the sweep on
// the H100: a round (every group one root) costs about 400 + 100 a lane's
// term held in registers (200 read from shared memory) + 50 a butterfly
// level, and at least a cycle for each term it computes (the division's
// throughput).  lanes_for() takes the cheapest g.  A lane's terms are held in
// registers when they are at most RMAX.  From KBIG terms on the model favours
// wide groups, whose butterflies and rounds cost more than it counts: there g
// is GBIG, the fastest or within 13 % of the fastest in every case timed on
// the card (tools/fused_lanes.py: kernel A at (100, 150) to (256, 320), one
// to eight blocks an update, f32 and f64).
constexpr int RMAX = 10;
constexpr int KBIG = 48, GBIG = 8;
struct Lanes {
  int g, ng, gid, gl;
};
__device__ inline float sweep_cost(int items, int k, int g) {
  const int ng = THREADS / g, rounds = (items + ng - 1) / ng, per = (k + g - 1) / g;
  int lg = 0;
  while ((1 << lg) < g) ++lg;
  const float lat = 400.f + per * (per <= RMAX ? 100.f : 200.f) + 50.f * lg;
  const float thr = (float)(items < ng ? items : ng) * k;
  return rounds * (lat > thr ? lat : thr);
}
__device__ inline float best_cost(int items, int k, int* best_g = nullptr) {
  if (k >= KBIG) {
    if (best_g) *best_g = GBIG;
    return items > 0 ? sweep_cost(items, k, GBIG) : 0.f;
  }
  float bc = 3.4e38f;
  for (int g = 1; g <= 32; g <<= 1) {
    const float c = sweep_cost(items, k, g);
    if (c < bc) {
      bc = c;
      if (best_g) *best_g = g;
    }
  }
  return items > 0 ? bc : 0.f;
}
__device__ inline Lanes lanes_for(int items, int k) {
  int g = 1;
  best_cost(items, k, &g);
  Lanes L;
  L.g = g;
  L.ng = THREADS / g;
  L.gid = threadIdx.x / g;
  L.gl = threadIdx.x % g;
  return L;
}

// sum over the terms j = gl, gl + g, ... < k of f(j), four accumulators
// a lane (four divisions in flight), added in a fixed order, then over the
// group.  The last one to three terms are computed together too (a term past
// k at k - 1, not added).
template <typename T, typename F>
__device__ __forceinline__ T lane_sum(int k, const Lanes L, F f) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  const int g = L.g;
  int j = L.gl;
  for (; j + 3 * g < k; j += 4 * g) {
    s0 += f(j);
    s1 += f(j + g);
    s2 += f(j + 2 * g);
    s3 += f(j + 3 * g);
  }
  if (j < k) {
    const int j1 = j + g, j2 = j + 2 * g;
    const T t0 = f(j), t1 = f(j1 < k ? j1 : k - 1), t2 = f(j2 < k ? j2 : k - 1);
    s0 += t0;
    s1 += j1 < k ? t1 : T(0);
    s2 += j2 < k ? t2 : T(0);
  }
  return gsum((s0 + s1) + (s2 + s3), g);
}

// Every block writes its slice [lo(k), hi(k)) of the vectors; afterwards
// every block of the team holds all of them.
template <typename V>
__device__ void copy_slice(const Team& t, int r, V* p, int k) {
  if (!p) return;
  const V* src = t.map(p, r);
  const int lo = (int)((long)k * r / t.size), hi = (int)((long)k * (r + 1) / t.size);
  for (int i = lo + threadIdx.x; i < hi; i += THREADS) p[i] = src[i];
}
template <typename T>
__device__ void gather(const Team& t, T* a, int ka, T* b = nullptr, int kb = 0, T* c = nullptr,
                       int kc = 0, T* d = nullptr, int kd = 0, int* ia = nullptr, int ki = 0) {
  t.sync();
  if (t.size == 1) return;
  for (int r = 0; r < t.size; ++r) {
    if (r == t.rank) continue;
    copy_slice(t, r, a, ka);
    copy_slice(t, r, b, kb);
    copy_slice(t, r, c, kc);
    copy_slice(t, r, d, kd);
    copy_slice(t, r, ia, ki);
  }
  t.sync();
}

// gather() of up to three vectors of each bank (k0 and k1 elements) and an
// int vector of each bank.
template <typename T>
__device__ void gather_banks(const Team& t, int k0, T* a0, T* b0, T* c0, int* i0, int k1, T* a1,
                             T* b1, T* c1, int* i1) {
  t.sync();
  if (t.size == 1) return;
  for (int r = 0; r < t.size; ++r) {
    if (r == t.rank) continue;
    copy_slice(t, r, a0, k0);
    copy_slice(t, r, b0, k0);
    copy_slice(t, r, c0, k0);
    copy_slice(t, r, i0, k0);
    copy_slice(t, r, a1, k1);
    copy_slice(t, r, b1, k1);
    copy_slice(t, r, c1, k1);
    copy_slice(t, r, i1, k1);
  }
  t.sync();
}

// y[i] = sum_{l < L} term(l, i) for i in [lo, hi), in a fixed order: for 32
// consecutive i at a time, warp w sums its eighth of l in order, and the
// eight partials are added in warp order.  ``wp``: NWARPS * 32 elements.
template <typename T, typename F>
__device__ void colsum(int lo, int hi, int L, F term, T* y, T* wp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int l0 = (int)((long)L * w / NWARPS), l1 = (int)((long)L * (w + 1) / NWARPS);
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane < hi ? i0 + lane : lo;
    T acc = T(0);
#pragma unroll 4
    for (int l = l0; l < l1; ++l) acc += term(l, i);
    wp[w * 32 + lane] = acc;
    __syncthreads();
    if (threadIdx.x < 32 && i0 + lane < hi) {
      T s = wp[lane];
      for (int q = 1; q < NWARPS; ++q) s += wp[q * 32 + lane];
      y[i0 + lane] = s;
    }
    __syncthreads();
  }
}

// Pairwise tree over p[0, n), n a power of two <= N: ((p0 + p1) + (p2 + p3))
// + ...; the result in p[0].  A tree over aligned runs of leaves, completed by
// a tree over the runs' sums, is the same tree.
template <int N, typename T>
__device__ __forceinline__ T tree_sum(T (&p)[N], int n) {
#pragma unroll
  for (int s = 1; s < N; s <<= 1)
#pragma unroll
    for (int q = 0; q + s < N; q += 2 * s)
      if (s < n) p[q] = p[q] + p[q + s];
  return p[0];
}

// Sums over L rows that do not depend on how many blocks share them (kernel
// B's Brand projections and residual norms): the rows are cut into NCHUNK
// chunks (chunk t: rows [L t / NCHUNK, L (t + 1) / NCHUNK)), a chunk's sum
// formed as colsum() forms it (warp w its eighth of the chunk's rows in
// order, the warps added in order), and the chunks added by tree_sum().  This
// block takes the aligned chunks [t0, t0 + nch) (nch a power of two) and
// y[i] = its subtree of sum_l term(l, i), i < N (l the row's index in
// [0, L)); the cluster completes the tree over its blocks' y in rank order.
// ``wp``: nch * NWARPS * 32 elements.
template <typename T, typename F>
__device__ void chunk_sum(int L, int t0, int nch, int N, F term, T* y, T* wp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i0 = 0; i0 < N; i0 += 32) {
    const int i = i0 + lane < N ? i0 + lane : 0;
    for (int q = 0; q < nch; ++q) {
      const int c0 = (int)((long)L * (t0 + q) / NCHUNK);
      const int len = (int)((long)L * (t0 + q + 1) / NCHUNK) - c0;
      const int l0 = c0 + (int)((long)len * w / NWARPS), l1 = c0 + (int)((long)len * (w + 1) / NWARPS);
      T acc = T(0);
#pragma unroll 4
      for (int l = l0; l < l1; ++l) acc += term(l, i);
      wp[(q * NWARPS + w) * 32 + lane] = acc;
    }
    __syncthreads();
    if (threadIdx.x < 32 && i0 + lane < N) {
      T p[NCHUNK];
#pragma unroll
      for (int q = 0; q < NCHUNK; ++q) {
        T s = T(0);
        if (q < nch) {
          s = wp[q * NWARPS * 32 + lane];
          for (int v = 1; v < NWARPS; ++v) s += wp[(q * NWARPS + v) * 32 + lane];
        }
        p[q] = s;
      }
      y[i0 + lane] = tree_sum(p, nch);
    }
    __syncthreads();
  }
}

// y[i] = sum_{l < L} term(i, l) for i in [lo, hi): a warp an entry (four
// entries at a time, their loads in flight together), lanes over l, a
// butterfly.
template <typename T, typename F, typename Y>
__device__ void rowsum(int lo, int hi, int L, F term, Y y) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i0 = lo; i0 < hi; i0 += 4 * NWARPS) {   // uniform over the warps
    int ii[4];
    T acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + w + q * NWARPS;
      ii[q] = i < hi ? i : lo;
      acc[q] = T(0);
    }
    for (int l = lane; l < L; l += 32)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += term(ii[q], l);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T x = gsum(acc[q], 32);
      const int i = i0 + w + q * NWARPS;
      if (lane == 0 && i < hi) y(i, x);
    }
  }
}

// -- the dense products --------------------------------------------------------

__device__ __forceinline__ void mma_16x8x8(double (&d)[4], double a0, double a1, double a2,
                                           double a3, double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// C (M, N) = A (M, K) @ B (K, N): fa(i, l) and fb(l, j) give the operands'
// entries, fc(i, j, x) takes the result.  Output tiles t = part, part +
// nparts, ... of the (M / 64) x (N / 64) grid are this block's.  Slices of 16
// k are staged in shared memory (zeros past the edges), each slice's entries
// read into registers while the slice before it computes; then f64 runs
// mma.sync m16n8k8 (warp w: rows 16 (w % 4), columns 32 (w / 4), four n8
// tiles) and f32 FFMA (thread (ty, tx): the 4 x 4 outputs at rows 4 ty,
// columns 4 tx, each summed in k order).
template <typename T, typename FA, typename FB, typename FC>
__device__ void gemm(int part, int nparts, int M, int N, int K, FA fa, FB fb, FC fc, T* stage) {
  constexpr int NA = TK * TM / THREADS, NB = TK * TN / THREADS;
  T* As = stage;
  T* Bs = stage + TK * LDS;
  const int tid = threadIdx.x;
  const int ntm = (M + TM - 1) / TM, ntn = (N + TN - 1) / TN;
  for (int t = part; t < ntm * ntn; t += nparts) {
    const int i0 = (t / ntn) * TM, j0 = (t % ntn) * TN;
    T ra[NA], rb[NB];
    auto load = [&](int k0) {
#pragma unroll
      for (int q = 0; q < NA; ++q) {
        const int e = tid + q * THREADS, ii = e / TK, kk = e % TK;
        ra[q] = (i0 + ii < M && k0 + kk < K) ? fa(i0 + ii, k0 + kk) : T(0);
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int e = tid + q * THREADS, kk = e / TN, jj = e % TN;
        rb[q] = (j0 + jj < N && k0 + kk < K) ? fb(k0 + kk, j0 + jj) : T(0);
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int q = 0; q < NA; ++q) {
        const int e = tid + q * THREADS;
        As[(e % TK) * LDS + e / TK] = ra[q];
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int e = tid + q * THREADS;
        Bs[(e / TN) * LDS + e % TN] = rb[q];
      }
    };
    load(0);
    if constexpr (std::is_same<T, double>::value) {
      const int lane = tid & 31, w = tid >> 5, g = lane >> 2, tq = lane & 3;
      const int mr = (w & 3) * 16, nc = (w >> 2) * 32;
      double acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0;
      for (int k0 = 0; k0 < K; k0 += TK) {
        __syncthreads();
        store();
        __syncthreads();
        if (k0 + TK < K) load(k0 + TK);
#pragma unroll
        for (int s = 0; s < TK; s += 8) {
          const double* ar = As + (s + tq) * LDS + mr + g;
          const double a0 = ar[0], a1 = ar[8], a2 = ar[4 * LDS], a3 = ar[4 * LDS + 8];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const double* br = Bs + (s + tq) * LDS + nc + nt * 8 + g;
            mma_16x8x8(acc[nt], a0, a1, a2, a3, br[0], br[4 * LDS]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + mr + g + 8 * (q >> 1), j = j0 + nc + nt * 8 + 2 * tq + (q & 1);
          if (i < M && j < N) fc(i, j, acc[nt][q]);
        }
    } else {
      const int ty = tid >> 4, tx = tid & 15;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += TK) {
        __syncthreads();
        store();
        __syncthreads();
        if (k0 + TK < K) load(k0 + TK);
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          const float4 av = *reinterpret_cast<const float4*>(As + kk * LDS + 4 * ty);
          const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * LDS + 4 * tx);
          const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + 4 * ty + a, j = j0 + 4 * tx + b;
          if (i < M && j < N) fc(i, j, acc[a][b]);
        }
    }
  }
  __syncthreads();
}

// -- the secular loop ----------------------------------------------------------

// Counterpart of repro/kernels/secular_body.py: secular_iterate, for one root
// anchored at ``anchor``, on a lane group (every lane of the group returns the
// same bits).  ``kpath``, the largest k of the roots the block solves at
// once, picks the register path for every group alike.  The differences (d_j - anchor) - tau are recomputed on the
// fly.  16 bisection + 6 safeguarded Newton steps on f(tau) = tau * w(tau),
// with the CLOSED-bracket acceptance of the reference.
template <typename T>
__device__ T secular_iterate(int k, const T* d, const T* z2k, T rho, T anchor, T lo, T hi,
                             int n_bisect, int n_newton, const Lanes L, int kpath) {
  if ((kpath + L.g - 1) / L.g <= RMAX) {   // kpath >= k, the same for the whole block
    // a lane's terms in registers: d_j - anchor and z_j^2 read once
    T dr[RMAX], zr[RMAX];
    const int nq = L.gl < k ? (k - L.gl + L.g - 1) / L.g : 0;
#pragma unroll
    for (int q = 0; q < RMAX; ++q) {
      const int j = L.gl + q * L.g;
      dr[q] = q < nq ? d[j] - anchor : T(0);
      zr[q] = q < nq ? z2k[j] : T(0);
    }
    for (int it = 0; it < n_bisect; ++it) {
      const T mid = T(0.5) * (lo + hi);
      T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int q = 0; q < RMAX; ++q)
        if (q < nq) {
          const T delta = dr[q] - mid;
          s[q & 3] += zr[q] * (delta == T(0) ? T(0) : T(1) / delta);
        }
      const T w = T(1) + rho * gsum((s[0] + s[1]) + (s[2] + s[3]), L.g);
      if (w < T(0)) lo = mid; else hi = mid;
    }
    T tau = T(0.5) * (lo + hi);
    for (int it = 0; it < n_newton; ++it) {
      T s[2] = {T(0), T(0)}, p[2] = {T(0), T(0)};
#pragma unroll
      for (int q = 0; q < RMAX; ++q)
        if (q < nq) {
          const T delta = dr[q] - tau;
          const T inv = delta == T(0) ? T(0) : T(1) / delta;
          const T rq = zr[q] * inv;
          s[q & 1] += rq;
          p[q & 1] += rq * inv;
        }
      const T w = T(1) + rho * gsum(s[0] + s[1], L.g);
      const T wp = rho * gsum(p[0] + p[1], L.g);
      if (w < T(0)) lo = tau; else hi = tau;
      const T fp = w + tau * wp;
      const T safe_fp = fp == T(0) ? Lim<T>::tiny() : fp;
      const T cand = tau - tau * w / safe_fp;
      tau = (cand >= lo && cand <= hi) ? cand : T(0.5) * (lo + hi);
    }
    return tau;
  }
  for (int it = 0; it < n_bisect; ++it) {
    const T mid = T(0.5) * (lo + hi);
    const T s = lane_sum<T>(k, L, [=](int j) {
      const T delta = (d[j] - anchor) - mid;
      return z2k[j] * (delta == T(0) ? T(0) : T(1) / delta);
    });
    const T w = T(1) + rho * s;
    if (w < T(0)) lo = mid; else hi = mid;
  }
  T tau = T(0.5) * (lo + hi);
  for (int it = 0; it < n_newton; ++it) {
    T s0 = T(0), s1 = T(0), p0 = T(0), p1 = T(0);
    int j = L.gl;
    for (; j + L.g < k; j += 2 * L.g) {
      const T d0 = (d[j] - anchor) - tau, d1 = (d[j + L.g] - anchor) - tau;
      const T i0 = d0 == T(0) ? T(0) : T(1) / d0, i1 = d1 == T(0) ? T(0) : T(1) / d1;
      const T r0 = z2k[j] * i0, r1 = z2k[j + L.g] * i1;
      s0 += r0;
      s1 += r1;
      p0 += r0 * i0;
      p1 += r1 * i1;
    }
    if (j < k) {
      const T d0 = (d[j] - anchor) - tau;
      const T i0 = d0 == T(0) ? T(0) : T(1) / d0;
      const T r0 = z2k[j] * i0;
      s0 += r0;
      p0 += r0 * i0;
    }
    const T sw = gsum(s0 + s1, L.g), sp = gsum(p0 + p1, L.g);
    const T w = T(1) + rho * sw;
    const T wp = rho * sp;
    if (w < T(0)) lo = tau; else hi = tau;
    const T fp = w + tau * wp;
    const T safe_fp = fp == T(0) ? Lim<T>::tiny() : fp;
    const T cand = tau - tau * w / safe_fp;
    tau = (cand >= lo && cand <= hi) ? cand : T(0.5) * (lo + hi);
  }
  return tau;
}

// -- one diagonal-plus-rank-1 phase, for both chains at once ------------------

// eig(diag(d) + rho z z^T), d ascending, rho > 0: the problem of one chain.
template <typename T>
struct Prob {
  int k;
  const T* d;
  const T* z;
  T rho;
  T* mu_sorted;   // out: the ascending eigenvalues (every block)
  int phi_slot;   // out: the (k, k) rotation (each block its rows)
};

// The phase of both chains (problem b in vector bank b).  The chains are
// independent, so every step takes the two problems' roots and poles
// together: a latency-bound sweep or barrier serves both.  Syncs the team at
// the end.
template <typename T>
__device__ void phase2(const Prob<T> (&pr)[2], const Ctx<T>& c) {
  const int tid = threadIdx.x;
  const Team tm = c.team;
  const Ops<T> ops = c.ops;
  T* const vecs = c.vecs;
  int* const ints = c.ints;
  T* const red = c.red;
  const int kmax = c.kmax;
  const T tiny = Lim<T>::tiny();
  auto V = [=](int slot, int b) { return vecs + (long)(slot + b * N_BANK) * kmax; };
  auto I = [=](int slot, int b) { return ints + (long)(slot + b * N_IBANK) * kmax; };
  const int kk[2] = {pr[0].k, pr[1].k};
  const int kx = kk[0] > kk[1] ? kk[0] : kk[1];
  T tol[2], zn2[2];

  // scale and deflation tolerance (every block: the same bits)
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = kk[b];
    const T* d = pr[b].d;
    const T* z = pr[b].z;
    T* z2raw = V(P_Z2RAW, b);
    T amax = T(0), zsum = T(0);
    for (int i = tid; i < k; i += THREADS) {
      z2raw[i] = z[i] * z[i];
      amax = MaxOp()(amax, m_abs(d[i]));
      zsum += z2raw[i];
    }
    amax = block_reduce(amax, red, MaxOp());
    zsum = block_reduce(zsum, red, SumOp());
    const T scale = (amax > pr[b].rho * zsum ? amax : pr[b].rho * zsum) + tiny;
    tol[b] = c.rtol * scale;
  }

  // group leaders: the first pole within tol below, chains closed by pointer
  // jumping; then each pole's next group member (k: none).  Item t of both
  // problems' poles: problem b = t >= k0, pole t - b k0.
  const int nall = kk[0] + kk[1];
  const Lanes L = lanes_for(nall, kx);
  for (int base = 0; base < nall; base += L.ng) {
    const int t = base + L.gid < nall ? base + L.gid : 0;
    const int b = t >= kk[0], i = t - b * kk[0];
    const T* d = b ? pr[1].d : pr[0].d;
    const T tb = b ? tol[1] : tol[0];
    int first = i;
    for (int j = L.gl; j <= i; j += L.g)
      if (d[i] - d[j] <= tb) { first = j; break; }
    first = gmin(first, L.g);
    if (base + L.gid < nall && L.gl == 0) I(I_LEAD0, b)[i] = first;
  }
  __syncthreads();
  int rounds = 1;
  while ((1 << rounds) < kx) ++rounds;
  for (int r = 0; r < rounds; ++r) {   // extra rounds leave a converged chain as it is
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int* src = I(r & 1 ? I_LEAD1 : I_LEAD0, b);
      int* dst = I(r & 1 ? I_LEAD0 : I_LEAD1, b);
      for (int i = tid; i < kk[b]; i += THREADS) dst[i] = src[src[i]];
    }
    __syncthreads();
  }
  const int lead_slot = rounds & 1 ? I_LEAD1 : I_LEAD0;
  for (int base = 0; base < nall; base += L.ng) {
    const int t = base + L.gid < nall ? base + L.gid : 0;
    const int b = t >= kk[0], i = t - b * kk[0], k = kk[b];
    const int* lead = I(lead_slot, b);
    int nx = k;
    for (int j = i + 1 + L.gl; j < k; j += L.g)
      if (lead[j] == lead[i]) { nx = j; break; }
    nx = gmin(nx, L.g);
    if (base + L.gid < nall && L.gl == 0) I(I_NEXT, b)[i] = nx;
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int* lead = I(lead_slot, b);
    T* isrep = V(P_ISREP, b);
    for (int i = tid; i < kk[b]; i += THREADS) isrep[i] = lead[i] == i ? T(1) : T(0);
  }
  __syncthreads();

  // grouped Householder merge: each group's sums walk its members in order
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = kk[b];
    const T* z = pr[b].z;
    const int* lead = I(lead_slot, b);
    const int* nextm = I(I_NEXT, b);
    const T* z2raw = V(P_Z2RAW, b);
    const T* isrep = V(P_ISREP, b);
    T* rvec = V(P_RVEC, b);
    T* wv = V(P_WV, b);
    for (int i = tid; i < k; i += THREADS) {
      T g = T(0), zr = T(0);
      for (int j = lead[i]; j < k; j = nextm[j]) {
        g += z2raw[j];
        zr += z[j] * isrep[j];
      }
      V(P_GZ2, b)[i] = g;
      V(P_ZREP, b)[i] = zr;
      const T sg = zr < T(0) ? T(1) : T(-1);
      rvec[i] = sg * m_sqrt(g);
      wv[i] = z[i] - rvec[i] * isrep[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = kk[b];
    const int* lead = I(lead_slot, b);
    const int* nextm = I(I_NEXT, b);
    const T* wv = V(P_WV, b);
    for (int i = tid; i < k; i += THREADS) {
      T g = T(0);
      for (int j = lead[i]; j < k; j = nextm[j]) g += wv[j] * wv[j];
      V(P_GN2, b)[i] = g;
    }
  }

  // tiny-z deflation on the merged weights
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const T rho = pr[b].rho;
    const T* rvec = V(P_RVEC, b);
    const T* isrep = V(P_ISREP, b);
    T* zm = V(P_ZM, b);
    T* z2k = V(P_Z2K, b);
    int* keep = I(I_KEEP, b);
    T acc = T(0);
    for (int i = tid; i < kk[b]; i += THREADS) {
      zm[i] = rvec[i] * isrep[i];
      const T z2 = zm[i] * zm[i];
      keep[i] = rho * z2 > tol[b];
      z2k[i] = keep[i] ? z2 : T(0);
      acc += z2k[i];
    }
    zn2[b] = block_reduce(acc, red, SumOp());  // also publishes keep / z2k / gn2
  }
  FUSED_MARK(1);

  // brackets, anchors and the secular solve: this block's roots of both
  // problems, a lane group each.  Item t: problem b = t >= n0.  The two
  // problems' roots share the lane groups when the sweep model says that is
  // cheaper than one problem after the other (segments [0, n0) and [n0, nt)).
  // The groups' size and the register path are chosen for the whole
  // problems, not for this block's slice, so that a root's sums are the same
  // whatever the team's size: an update gives the same bits at every batch
  // size.
  const int lo0 = tm.lo(kk[0]), lo1 = tm.lo(kk[1]);
  const int n0 = tm.hi(kk[0]) - lo0, nt = n0 + tm.hi(kk[1]) - lo1;
  const bool together = best_cost(nall, kx) <= best_cost(kk[0], kk[0]) + best_cost(kk[1], kk[1]);
  const int nseg = together ? 1 : 2;
  const int seg_lo[2] = {0, together ? nt : n0}, seg_hi[2] = {together ? nt : n0, nt};
  const Lanes seg_l[2] = {together ? lanes_for(nall, kx) : lanes_for(kk[0], kk[0]),
                          lanes_for(kk[1], kk[1])};
  const int seg_k[2] = {together ? kx : kk[0], kk[1]};
  const T big = Lim<T>::max() * T(0.25);
  for (int sg = 0; sg < nseg; ++sg) {
    const Lanes L = seg_l[sg];
    for (int base = seg_lo[sg]; base < seg_hi[sg]; base += L.ng) {
      const bool act = base + L.gid < seg_hi[sg];
      const int t = act ? base + L.gid : seg_lo[sg];
      const int b = t >= n0, i = b ? lo1 + t - n0 : lo0 + t, k = kk[b];
      const T* d = b ? pr[1].d : pr[0].d;
      const T rho = b ? pr[1].rho : pr[0].rho;
      const T* z2k = V(P_Z2K, b);
      const int* keep = I(I_KEEP, b);
      T nxt = big;
      for (int j = i + 1 + L.gl; j < k; j += L.g)
        if (keep[j] && d[j] < nxt) nxt = d[j];
      nxt = gmin(nxt, L.g);
      const bool kept = keep[i] != 0;
      const bool is_last = kept && nxt >= T(0.5) * big;
      const T right = is_last ? d[i] + rho * (b ? zn2[1] : zn2[0]) : nxt;
      const T width = kept ? right - d[i] : T(0);
      const T half = T(0.5) * width;
      const T acc = lane_sum<T>(k, L, [&](int j) {
        const T dm = (d[j] - d[i]) - half;
        return z2k[j] * (dm != T(0) ? T(1) / dm : T(0));
      });
      const T w_mid = T(1) + rho * acc;
      const bool use_left = w_mid > T(0) || is_last;
      const T anc = use_left ? d[i] : right;
      const T lo = use_left ? T(0) : -half;
      const T hi = is_last ? width : (use_left ? half : T(0));
      T tau = secular_iterate(k, d, z2k, rho, anc, lo, hi, c.n_bisect, c.n_newton, L, seg_k[sg]);
      tau = kept ? tau : T(0);
      if (act && L.gl == 0) {
        V(P_ANCHOR, b)[i] = anc;
        V(P_TAU, b)[i] = tau;
        V(P_MU, b)[i] = kept ? anc + tau : d[i];
      }
    }
  }
  gather_banks(tm, kk[0], V(P_ANCHOR, 0), V(P_TAU, 0), V(P_MU, 0), (int*)nullptr, kk[1],
               V(P_ANCHOR, 1), V(P_TAU, 1), V(P_MU, 1), (int*)nullptr);
  FUSED_MARK(2);

  // Loewner zhat (Gu-Eisenstat), log-magnitude space, anchored differences:
  // this block's poles of both problems, on the same segments
  for (int sg = 0; sg < nseg; ++sg) {
    const Lanes L = seg_l[sg];
    for (int base = seg_lo[sg]; base < seg_hi[sg]; base += L.ng) {
      const bool act = base + L.gid < seg_hi[sg];
      const int t = act ? base + L.gid : seg_lo[sg];
      const int b = t >= n0, j = b ? lo1 + t - n0 : lo0 + t, k = kk[b];
      const T* d = b ? pr[1].d : pr[0].d;
      const int* keep = I(I_KEEP, b);
      const T* anchor = V(P_ANCHOR, b);
      const T* tau = V(P_TAU, b);
      T ln0 = T(0), ln1 = T(0), ld0 = T(0), ld1 = T(0);
      int i = L.gl;
      for (; i + L.g < k; i += 2 * L.g) {
        const int i1 = i + L.g;
        const T n0_ = keep[i] ? (anchor[i] - d[j]) + tau[i] : T(1);
        const T n1_ = keep[i1] ? (anchor[i1] - d[j]) + tau[i1] : T(1);
        const T e0 = (i != j && keep[i]) ? d[i] - d[j] : T(1);
        const T e1 = (i1 != j && keep[i1]) ? d[i1] - d[j] : T(1);
        ln0 += m_log(m_abs(n0_) + tiny);
        ln1 += m_log(m_abs(n1_) + tiny);
        ld0 += m_log(m_abs(e0) + tiny);
        ld1 += m_log(m_abs(e1) + tiny);
      }
      for (; i < k; i += L.g) {
        const T n0_ = keep[i] ? (anchor[i] - d[j]) + tau[i] : T(1);
        const T e0 = (i != j && keep[i]) ? d[i] - d[j] : T(1);
        ln0 += m_log(m_abs(n0_) + tiny);
        ld0 += m_log(m_abs(e0) + tiny);
      }
      const T ln = gsum(ln0 + ln1, L.g), ld_ = gsum(ld0 + ld1, L.g);
      if (act && L.gl == 0) {
        const T zmj = V(P_ZM, b)[j];
        const T sgn = zmj > T(0) ? T(1) : (zmj < T(0) ? T(-1) : T(0));
        const T log_rho = m_log(b ? pr[1].rho : pr[0].rho);
        V(P_ZHAT, b)[j] = keep[j] ? sgn * m_exp(T(0.5) * (ln - ld_ - log_rho)) : T(0);
      }
    }
  }
  gather_banks(tm, kk[0], V(P_ZHAT, 0), (T*)nullptr, (T*)nullptr, (int*)nullptr, kk[1],
               V(P_ZHAT, 1), (T*)nullptr, (T*)nullptr, (int*)nullptr);

  // column norms of the scaled Cauchy columns, and the stable rank of mu:
  // this block's roots of both problems
  for (int sg = 0; sg < nseg; ++sg) {
    const Lanes L = seg_l[sg];
    for (int base = seg_lo[sg]; base < seg_hi[sg]; base += L.ng) {
      const bool act = base + L.gid < seg_hi[sg];
      const int t = act ? base + L.gid : seg_lo[sg];
      const int b = t >= n0, i = b ? lo1 + t - n0 : lo0 + t, k = kk[b];
      const T* d = b ? pr[1].d : pr[0].d;
      const T* zhat = V(P_ZHAT, b);
      const T* mu = V(P_MU, b);
      const T an = V(P_ANCHOR, b)[i], ta = V(P_TAU, b)[i], mi = mu[i];
      const T acc = lane_sum<T>(k, L, [&](int j) {
        const T cd = (d[j] - an) - ta;
        const T inv = cd != T(0) ? T(1) / cd : T(0);
        return zhat[j] * zhat[j] * inv * inv;
      });
      int r = 0;
      for (int j = L.gl; j < k; j += L.g) r += (mu[j] < mi) || (mu[j] == mi && j < i);
      r = gsum(r, L.g);
      if (act && L.gl == 0) {
        V(P_COLNORM, b)[i] = I(I_KEEP, b)[i] ? m_sqrt(acc) : T(1);
        I(I_RANK, b)[i] = r;
      }
    }
  }
  gather_banks(tm, kk[0], V(P_COLNORM, 0), (T*)nullptr, (T*)nullptr, I(I_RANK, 0), kk[1],
               V(P_COLNORM, 1), (T*)nullptr, (T*)nullptr, I(I_RANK, 1));
  FUSED_MARK(3);

  // phi[r, rank_i] = (hh @ qt)[r, i] for the rows this block stores: hh is
  // block diagonal over the groups, so the sum walks row r's group (the
  // terms of the dense product that are not zero, in the same order); qt's
  // entries are formed on the fly (deflated columns pass through).  Threads
  // take consecutive columns j = rank_i of a row (i = perm[j]), so the stores
  // are contiguous.
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int* rank = I(I_RANK, b);
    int* perm = I(I_PERM, b);
    for (int i = tid; i < kk[b]; i += THREADS) perm[rank[i]] = i;
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = kk[b];
    const T* d = pr[b].d;
    const int* keep = I(I_KEEP, b);
    const int* lead = I(lead_slot, b);
    const int* nextm = I(I_NEXT, b);
    const int* perm = I(I_PERM, b);
    const T* anchor = V(P_ANCHOR, b);
    const T* tau = V(P_TAU, b);
    const T* colnorm = V(P_COLNORM, b);
    const T* zhat = V(P_ZHAT, b);
    const T* gn2 = V(P_GN2, b);
    const T* wv = V(P_WV, b);
    const int r0 = tm.rank * ops.rows;
    const int r1 = r0 + ops.rows < k ? r0 + ops.rows : k;
    auto entry = [&](int r, int i) {
      const bool kept = keep[i] != 0;
      const T an = anchor[i], ta = tau[i], cn = colnorm[i];
      auto qt = [&](int l) {
        if (!kept) return i == l ? T(1) : T(0);
        const T cd = (d[l] - an) - ta;
        const T inv = cd != T(0) ? T(1) / cd : T(0);
        return zhat[l] * inv / cn;
      };
      const T g = gn2[r];
      if (lead[r] == r && nextm[r] == k) {   // a group of one: a diagonal hh
        const T x = g > T(0) ? T(2) * wv[r] * wv[r] / g : T(0);
        return (T(1) - x) * qt(r);
      }
      T acc = T(0);
      for (int l = lead[r]; l < k; l = nextm[l]) {
        const T x = g > T(0) ? T(2) * wv[r] * wv[l] / g : T(0);
        acc += ((r == l ? T(1) : T(0)) - x) * qt(l);
      }
      return acc;
    };
    const int total = (r1 > r0 ? r1 - r0 : 0) * k;   // < 2^31: k is at most a few hundred
    for (int e0 = tid; e0 < total; e0 += 4 * THREADS) {
      T val[4];
      int rr[4], jj[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = e0 + q * THREADS < total ? e0 + q * THREADS : e0;
        rr[q] = e / k;
        jj[q] = e - rr[q] * k;
        val[q] = entry(r0 + rr[q], perm[jj[q]]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e0 + q * THREADS < total) *ops.at(pr[b].phi_slot, r0 + rr[q], jj[q]) = val[q];
    }
    const int* rank = I(I_RANK, b);
    const T* mu = V(P_MU, b);
    for (int i = tid; i < k; i += THREADS) pr[b].mu_sorted[rank[i]] = mu[i];
  }
  FUSED_MARK(4);
  tm.sync();
  FUSED_MARK(10);
}

// One side's chain: two phases in ascending coordinates (rho_pos > 0 >
// rho_neg); the negative phase solves the negated problem, a double flip.
template <typename T>
struct ChainIn {
  int k;
  const T* d0;
  const T* z1;
  const T* z2w;
  T rho_pos, rho_neg;
  T* mu2;   // out: the final eigenvalues, ascending
};

// The left (0) and the right (1) chains together: operator slots O_GL and
// O_GR get G (k, k) with Q_final = Q0_asc @ G.
template <typename T>
__device__ void chains(const ChainIn<T> (&ch)[2], const Ctx<T>& c) {
  const int tid = threadIdx.x;
  const Team tm = c.team;
  const Ops<T> ops = c.ops;
  T* const stage = c.stage;
  T* const vecs = c.vecs;
  const int kmax = c.kmax;
  auto V = [=](int slot, int b) { return vecs + (long)(slot + b * N_BANK) * kmax; };
  constexpr int PHI1[2] = {O_PHI1_0, O_PHI1_1}, PHIB[2] = {O_PHIB_0, O_PHIB_1};

  const Prob<T> first[2] = {{ch[0].k, ch[0].d0, ch[0].z1, ch[0].rho_pos, V(C_MU1, 0), PHI1[0]},
                            {ch[1].k, ch[1].d0, ch[1].z1, ch[1].rho_pos, V(C_MU1, 1), PHI1[1]}};
  phase2(first, c);
  // z2 = phi1^T z2w: this block's entries
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = ch[b].k;
    const T* z2w = ch[b].z2w;
    colsum<T>(tm.lo(k), tm.hi(k), k,
              [&](int r, int i) { return *ops.at(PHI1[b], r, i) * z2w[r]; }, V(C_Z2, b), stage);
  }
  gather_banks(tm, ch[0].k, V(C_Z2, 0), (T*)nullptr, (T*)nullptr, (int*)nullptr, ch[1].k,
               V(C_Z2, 1), (T*)nullptr, (T*)nullptr, (int*)nullptr);
  FUSED_MARK(4);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = ch[b].k;
    const T* mu1 = V(C_MU1, b);
    const T* z2 = V(C_Z2, b);
    for (int i = tid; i < k; i += THREADS) {
      V(C_DNEG, b)[i] = -mu1[k - 1 - i];
      V(C_ZNEG, b)[i] = z2[k - 1 - i];
    }
  }
  __syncthreads();
  FUSED_MARK(8);
  const Prob<T> second[2] = {
      {ch[0].k, V(C_DNEG, 0), V(C_ZNEG, 0), -ch[0].rho_neg, V(C_MUB, 0), PHIB[0]},
      {ch[1].k, V(C_DNEG, 1), V(C_ZNEG, 1), -ch[1].rho_neg, V(C_MUB, 1), PHIB[1]}};
  phase2(second, c);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = ch[b].k;
    const T* mub = V(C_MUB, b);
    for (int i = tid; i < k; i += THREADS) ch[b].mu2[i] = -mub[k - 1 - i];
  }
  // G = phi1 @ flip2(phib): the left's into O_GL, then the right's into O_GR
  // (the left's phi1, free once G_L is formed)
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int k = ch[b].k;
    const int gs = b ? O_GR : O_GL;
    gemm<T>(tm.rank, tm.size, k, k, k, [&](int i, int l) { return *ops.at(PHI1[b], i, l); },
            [&](int l, int j) { return *ops.at(PHIB[b], k - 1 - l, k - 1 - j); },
            [&](int i, int j, T x) { *ops.at(gs, i, j) = x; }, stage);
    tm.sync();
  }
  FUSED_MARK(9);
}

template <typename T>
__device__ void split(T cval, T& rho_p, T& rho_n, T& qp0, T& qp1, T& qn0, T& qn1) {
  const T h = T(0.5) * cval;
  const T r = m_sqrt(h * h + T(1));
  rho_p = h + r;
  rho_n = h - r;
  const T np = m_sqrt(T(1) + rho_p * rho_p);
  const T nn = m_sqrt(T(1) + rho_n * rho_n);
  qp0 = rho_p / np;
  qp1 = T(1) / np;
  qn0 = rho_n / nn;
  qn1 = T(1) / nn;
}

// -- the full update -----------------------------------------------------------

// One full rank-1 update of u (m, m), s (m), v (n, n) by a (m), b (n), m <= n,
// all row-major, on the team of ``c``.  Inputs of storage type SI, outputs of
// type SO, computed in T.  dl_out / dr_out may be null.
//
// IDENT: u and v are the (m, m) identity, never read or formed (kernel B's
// core on the augmented basis, m = n = r + 1): every product with them is
// the operand itself, which is what the dense product with the identity
// gives, bit for bit.  Then nothing is written out: the caller reads the
// singular values from F_DL, the rotations from operator slots O_GL (G_u,
// flipped) and O_GR (G_v, flipped) and the signs from F_FLIP.
template <typename T, typename SI, typename SO, bool IDENT>
__device__ void full_core(int m, int n, const SI* u, const SI* s_in, const SI* v, const SI* a_in,
                          const SI* b_in, SO* u_out, SO* s_out, SO* v_out, SO* dl_out,
                          SO* dr_out, bool sign_fix, const Ctx<T>& c) {
  const int tid = threadIdx.x;
  const Team tm = c.team;
  const Ops<T> ops = c.ops;
  T* const stage = c.stage;
  T* s = c.v(F_S);
  T* a = c.v(F_A);
  T* b = c.v(F_B);
  T* vtb = c.v(F_VTB);
  T* bt = c.v(F_BT);
  T* uta = c.v(F_UTA);
  T* at = c.v(F_AT);
  T* a1 = c.v(F_A1);
  T* b1 = c.v(F_B1);
  T* a2 = c.v(F_A2);
  T* b2 = c.v(F_B2);
  T* va2 = c.v(F_VA2);
  T* vb2 = c.v(F_VB2);
  T* dasc = c.v(F_DASC);
  T* dl = c.v(F_DL);
  T* dr = c.v(F_DR);
  T* d0 = c.v(F_D0);
  T* z1 = c.v(F_Z1);
  T* z2w = c.v(F_Z2W);
  T* bv = c.v(F_BV);
  T* core = c.v(F_CORE);
  T* au = c.v(F_AU);
  T* flip = c.v(F_FLIP);

  for (int i = tid; i < m; i += THREADS) {
    s[i] = ld<T>(s_in, i);
    a[i] = ld<T>(a_in, i);
  }
  for (int j = tid; j < n; j += THREADS) b[j] = ld<T>(b_in, j);
  __syncthreads();

  // STEP 1: structured products
  if (IDENT) {
    for (int i = tid; i < m; i += THREADS) {
      vtb[i] = b[i];
      uta[i] = a[i];
      bt[i] = s[i] * b[i];
      at[i] = s[i] * a[i];
    }
  } else {
    colsum<T>(tm.lo(n), tm.hi(n), n, [&](int l, int i) { return ld<T>(v, (long)l * n + i) * b[l]; },
              vtb, stage);
    colsum<T>(tm.lo(m), tm.hi(m), m, [&](int l, int i) { return ld<T>(u, (long)l * m + i) * a[l]; },
              uta, stage);
    gather(tm, vtb, n, uta, m);
    rowsum<T>(tm.lo(m), tm.hi(m), m,
              [&](int i, int l) { return ld<T>(u, (long)i * m + l) * (s[l] * vtb[l]); },
              [&](int i, T x) { bt[i] = x; });
    rowsum<T>(tm.lo(n), tm.hi(n), m,
              [&](int i, int l) { return ld<T>(v, (long)i * n + l) * (s[l] * uta[l]); },
              [&](int i, T x) { at[i] = x; });
    gather(tm, bt, m, at, n);
  }
  const T beta = block_dot(n, b, (const T*)nullptr, c.red);
  const T alpha = block_dot(m, a, (const T*)nullptr, c.red);

  // STEPS 2-3: analytic 2x2 splits
  T rho1, rho2, qp0, qp1, qn0, qn1, rho3, rho4, qpv0, qpv1, qnv0, qnv1;
  split(beta, rho1, rho2, qp0, qp1, qn0, qn1);
  split(alpha, rho3, rho4, qpv0, qpv1, qnv0, qnv1);
  for (int i = tid; i < m; i += THREADS) {
    a1[i] = qp0 * a[i] + qp1 * bt[i];
    b1[i] = qn0 * a[i] + qn1 * bt[i];
  }
  for (int j = tid; j < n; j += THREADS) {
    a2[j] = qpv0 * b[j] + qpv1 * at[j];
    b2[j] = qnv0 * b[j] + qnv1 * at[j];
  }
  __syncthreads();

  // STEPS 4-5 (left): ascending order is a static flip of s^2
  for (int i = tid; i < m; i += THREADS) d0[i] = s[m - 1 - i] * s[m - 1 - i];
  if (IDENT) {
    for (int i = tid; i < m; i += THREADS) {
      z1[i] = a1[m - 1 - i];
      z2w[i] = b1[m - 1 - i];
      va2[i] = a2[i];
      vb2[i] = b2[i];
    }
  } else {
    colsum<T>(tm.lo(m), tm.hi(m), m,
              [&](int l, int i) { return ld<T>(u, (long)l * m + (m - 1 - i)) * a1[l]; }, z1, stage);
    colsum<T>(tm.lo(m), tm.hi(m), m,
              [&](int l, int i) { return ld<T>(u, (long)l * m + (m - 1 - i)) * b1[l]; }, z2w, stage);
    colsum<T>(tm.lo(n), tm.hi(n), n, [&](int l, int i) { return ld<T>(v, (long)l * n + i) * a2[l]; },
              va2, stage);
    colsum<T>(tm.lo(n), tm.hi(n), n, [&](int l, int i) { return ld<T>(v, (long)l * n + i) * b2[l]; },
              vb2, stage);
  }
  gather(tm, z1, m, z2w, m, va2, n, vb2, n);
  FUSED_MARK(0);

  // STEPS 6-7 (right): its chain's inputs (the chains run together below)
  T* d0r = c.v(F_D0R);
  T* z1r = c.v(F_Z1R);
  T* z2wr = c.v(F_Z2WR);
  T* dascr = c.v(F_DASCR);
  const bool compress = n - m > 2;
  const int kr = compress ? m + 2 : n;
  const int k0 = n - m;
  T* vn0 = c.v(F_VN0);
  T* vn1 = c.v(F_VN1);
  T* btva = c.v(F_BTVA);
  T* w1 = c.v(X_W1);
  T* w2 = c.v(X_W2);
  T* mq0 = c.v(X_MQ0);
  T* mq1 = c.v(X_MQ1);
  T cw1 = T(0), cw2 = T(0), w12 = T(0);
  if (compress) {
    T* q1 = c.v(X_Q1);
    T* q2 = c.v(X_Q2);
    T* c2p = c.v(X_C2P);
    T* f1 = c.v(X_F1);
    T* f2 = c.v(X_F2);
    T* q2h = c.v(X_Q2H);
    const T* c1 = va2 + m;
    const T* c2 = vb2 + m;
    const T eps = Lim<T>::eps();
    const T na2 = m_sqrt(block_dot(n, va2, (const T*)nullptr, c.red));
    const T r11 = m_sqrt(block_dot(k0, c1, (const T*)nullptr, c.red));
    const T nb2 = m_sqrt(block_dot(n, vb2, (const T*)nullptr, c.red));
    for (int i = tid; i < k0; i += THREADS) q1[i] = r11 > eps * na2 ? c1[i] : (i == 0 ? T(1) : T(0));
    const T nq1 = m_sqrt(block_dot(k0, q1, (const T*)nullptr, c.red));
    for (int i = tid; i < k0; i += THREADS) q1[i] = q1[i] / nq1;
    const T dq = block_dot(k0, q1, c2, c.red);
    for (int i = tid; i < k0; i += THREADS) c2p[i] = c2[i] - dq * q1[i];
    const T r22 = m_sqrt(block_dot(k0, c2p, (const T*)nullptr, c.red));
    const T q10 = q1[0], q11 = q1[1];
    for (int i = tid; i < k0; i += THREADS) {
      f1[i] = (i == 0 ? T(1) : T(0)) - q1[i] * q10;
      f2[i] = (i == 1 ? T(1) : T(0)) - q1[i] * q11;
    }
    const T nf1 = block_dot(k0, f1, (const T*)nullptr, c.red);
    const T nf2 = block_dot(k0, f2, (const T*)nullptr, c.red);
    const T* fb = nf1 >= nf2 ? f1 : f2;
    for (int i = tid; i < k0; i += THREADS) q2[i] = r22 > eps * (na2 + nb2) ? c2p[i] : fb[i];
    const T d12 = block_dot(k0, q1, q2, c.red);
    for (int i = tid; i < k0; i += THREADS) q2[i] = q2[i] - d12 * q1[i];
    const T nq2 = m_sqrt(block_dot(k0, q2, (const T*)nullptr, c.red));
    for (int i = tid; i < k0; i += THREADS) q2[i] = q2[i] / nq2;

    // M = H1 @ H2, exactly orthogonal, M[:, 0] = +-q1, with
    // H = I - cw w w^T: applied and formed in closed form, never stored
    const T sgn1 = q1[0] >= T(0) ? T(1) : T(-1);
    for (int i = tid; i < k0; i += THREADS) w1[i] = q1[i] + (i == 0 ? sgn1 : T(0));
    cw1 = T(2) / block_dot(k0, w1, (const T*)nullptr, c.red);
    const T w1q2 = block_dot(k0, w1, q2, c.red);
    for (int i = tid; i < k0; i += THREADS)
      q2h[i] = i == 0 ? T(0) : q2[i] - cw1 * w1[i] * w1q2;
    const T nq2h2 = block_dot(k0, q2h, (const T*)nullptr, c.red);
    const T nq2h = m_sqrt(nq2h2 > Lim<T>::tiny() ? nq2h2 : Lim<T>::tiny());
    for (int i = tid; i < k0; i += THREADS) q2h[i] = q2h[i] / nq2h;
    __syncthreads();
    const T sgn2 = q2h[1] >= T(0) ? T(1) : T(-1);
    for (int i = tid; i < k0; i += THREADS) w2[i] = q2h[i] + (i == 1 ? sgn2 : T(0));
    cw2 = T(2) / block_dot(k0, w2, (const T*)nullptr, c.red);
    w12 = block_dot(k0, w1, w2, c.red);
    for (int p = tid; p < k0; p += THREADS) {
      mq0[p] = (p == 0 ? T(1) : T(0)) - cw1 * w1[p] * w1[0] - cw2 * w2[p] * w2[0] +
               cw1 * cw2 * w12 * w1[p] * w2[0];
      mq1[p] = (p == 1 ? T(1) : T(0)) - cw1 * w1[p] * w1[1] - cw2 * w2[p] * w2[1] +
               cw1 * cw2 * w12 * w1[p] * w2[1];
    }
    __syncthreads();

    // chain on the m + 2 active coordinates: two compressed zero poles lead
    for (int i = tid; i < kr; i += THREADS) {
      if (i < 2) {
        const T* mqi = i == 0 ? mq0 : mq1;
        d0r[i] = T(0);
        T s1 = T(0), s2 = T(0);
        for (int p = 0; p < k0; ++p) {
          s1 += mqi[p] * c1[p];
          s2 += mqi[p] * c2[p];
        }
        z1r[i] = s1;
        z2wr[i] = s2;
      } else {
        const int o = m - 1 - (i - 2);
        d0r[i] = s[o] * s[o];
        z1r[i] = va2[o];
        z2wr[i] = vb2[o];
      }
    }
  } else {
    for (int i = tid; i < n; i += THREADS) {
      const int o = n - 1 - i;
      d0r[i] = o < m ? s[o] * s[o] : T(0);
      z1r[i] = va2[o];
      z2wr[i] = vb2[o];
    }
  }
  __syncthreads();
  FUSED_MARK(5);

  // STEPS 5 and 7: the left chain (k = m) and the right one (k = kr) together
  const ChainIn<T> both[2] = {{m, d0, z1, z2w, rho1, rho2, dasc},
                              {kr, d0r, z1r, z2wr, rho3, rho4, dascr}};
  chains(both, c);
  for (int i = tid; i < m; i += THREADS) dl[i] = dasc[m - 1 - i];
  for (int j = tid; j < n; j += THREADS) dr[j] = j < kr ? dascr[kr - 1 - j] : T(0);
  if (compress) {
    // v_null @ m2 (n x 2), and btva = [m2^T vtb[m:], flip(vtb[:m])]
    rowsum<T>(tm.lo(n), tm.hi(n), k0,
              [&](int i, int p) { return ld<T>(v, (long)i * n + m + p) * mq0[p]; },
              [&](int i, T x) { vn0[i] = x; });
    rowsum<T>(tm.lo(n), tm.hi(n), k0,
              [&](int i, int p) { return ld<T>(v, (long)i * n + m + p) * mq1[p]; },
              [&](int i, T x) { vn1[i] = x; });
    for (int i = tid; i < kr; i += THREADS) {
      if (i < 2) {
        const T* mqi = i == 0 ? mq0 : mq1;
        T acc = T(0);
        for (int p = 0; p < k0; ++p) acc += vtb[m + p] * mqi[p];
        btva[i] = acc;
      } else {
        btva[i] = vtb[m - 1 - (i - 2)];
      }
    }
    gather(tm, vn0, n, vn1, n);
  } else {
    __syncthreads();
  }
  FUSED_MARK(8);

  // g_u(q, j) = G_L[m-1-q, m-1-j]; the right rotation's leading (m, m) block
  // g_vm(q, j): G_R[2+m-1-q, kr-1-j] (compressed) or G_R[n-1-q, n-1-j]
  auto gu = [&](int q, int j) { return *ops.at(O_GL, m - 1 - q, m - 1 - j); };
  auto gvm = [&](int q, int j) {
    return compress ? *ops.at(O_GR, 2 + m - 1 - q, kr - 1 - j) : *ops.at(O_GR, n - 1 - q, n - 1 - j);
  };
  // bv = flip(g_act^T btva)[:m] or g_v[:, :m]^T vtb, and the sign fix
  // diag_i = u_i^T (A + a b^T) v_i from the structured factors: this block's
  // columns
  const int jlo = tm.lo(m), jhi = tm.hi(m);
  if (compress)
    colsum<T>(jlo, jhi, kr, [&](int l, int j) { return btva[l] * *ops.at(O_GR, l, kr - 1 - j); },
              bv, stage);
  else
    colsum<T>(jlo, jhi, n, [&](int l, int j) { return *ops.at(O_GR, n - 1 - l, n - 1 - j) * vtb[l]; },
              bv, stage);
  if (sign_fix) {
    colsum<T>(jlo, jhi, m, [&](int q, int j) { return (s[q] * gu(q, j)) * gvm(q, j); }, core,
              stage);
    colsum<T>(jlo, jhi, m, [&](int q, int j) { return uta[q] * gu(q, j); }, au, stage);
  }
  for (int j = jlo + tid; j < jhi; j += THREADS)
    flip[j] = sign_fix ? (core[j] + au[j] * bv[j] < T(0) ? T(-1) : T(1)) : T(1);
  gather(tm, flip, m);
  FUSED_MARK(6);
  if (IDENT) return;

  // outputs
  gemm<T>(tm.rank, tm.size, m, m, m, [&](int i, int l) { return ld<T>(u, (long)i * m + l); }, gu,
          [&](int i, int j, T x) { st(u_out, (long)i * m + j, x); }, stage);
  if (tm.rank == 0) {
    for (int i = tid; i < m; i += THREADS) {
      const T x = dl[i] > T(0) ? dl[i] : T(0);
      st(s_out, i, m_sqrt(x));
      if (dl_out) st(dl_out, i, dl[i]);
    }
    if (dr_out)
      for (int j = tid; j < n; j += THREADS) st(dr_out, j, dr[j]);
  }
  if (compress) {
    // flip(v_act @ g_act) for the first kr columns, v_null @ mq[:, 2:] after
    gemm<T>(tm.rank, tm.size, n, kr, kr,
            [&](int i, int l) {
              return l == 0 ? vn0[i] : (l == 1 ? vn1[i] : ld<T>(v, (long)i * n + (m + 1 - l)));
            },
            [&](int l, int jj) { return *ops.at(O_GR, l, jj); },
            [&](int i, int jj, T x) {
              const int j = kr - 1 - jj;
              st(v_out, (long)i * n + j, j < m ? x * flip[j] : x);
            },
            stage);
    gemm<T>(tm.rank, tm.size, n, k0 - 2, k0,
            [&](int i, int p) { return ld<T>(v, (long)i * n + m + p); },
            [&](int p, int jj) {
              const int q = jj + 2;
              return (p == q ? T(1) : T(0)) - cw1 * w1[p] * w1[q] - cw2 * w2[p] * w2[q] +
                     cw1 * cw2 * w12 * w1[p] * w2[q];
            },
            [&](int i, int jj, T x) { st(v_out, (long)i * n + kr + jj, x); }, stage);
  } else {
    gemm<T>(tm.rank, tm.size, n, n, n, [&](int i, int l) { return ld<T>(v, (long)i * n + l); },
            [&](int l, int j) { return *ops.at(O_GR, n - 1 - l, n - 1 - j); },
            [&](int i, int j, T x) { st(v_out, (long)i * n + j, j < m ? x * flip[j] : x); },
            stage);
  }
  tm.sync();  // no block leaves while another still reads its shared memory
  FUSED_MARK(7);
}

}  // namespace fused
