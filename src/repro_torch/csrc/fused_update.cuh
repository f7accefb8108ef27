// Kernels A and B: the fused rank-1 SVD update, a thread-block cluster per
// update.
//
// Kernel A replaces repro/kernels/fused_update.py: fused_update_pallas_batched
// (:566; and fused_update_pallas, which is this kernel at B = 1).  Kernel B
// replaces fused_update_truncated_pallas_batched (:601; and
// fused_update_truncated_pallas).  The per-update computation is
// fused::full_core in fused_core.cuh.
//
// What bounds them on an H100.  A full update at (m, n) moves about
// 2 (m^2 + n^2) elements but does hundreds of operations per element: four
// secular phases of 22 sweeps over k roots x k poles (a division each), and
// the dense products (each side's G, U @ G_u, V @ G_v), so the card's f32 /
// f64 rate is the bound (0.0026 ms for a B128 (32, 48) f64 batch).  Kernel
// B's bytes (the (m + n) x r factors, read and written once) bound it.  What
// holds both far above those bounds is latency (tools/fused_phases.cu on the
// card, PERF.md): 22 dependent sweeps a root, each an IEEE division (a few
// hundred cycles on this card) and a butterfly; barriers between the steps
// of a phase; and, at (256, 320) f32, the scratch tier's stores drained at
// every team barrier.  The one-block kernels this replaces held one thread a
// root (52 % of B's time at m512 n768 r16), scalar products from a
// device-memory scratch (62 % of A's at (256, 320) f32) and one SM an update
// (B's rotations at m1024 n4096 r32 ran on 8 of 132 SMs).
//
// Design.  A launch runs c blocks per update as one thread-block cluster,
// launched with cudaLaunchKernelEx: c is the largest power of two with
// c <= 8 (the portable limit: a cluster of 16 needs the non-portable
// attribute and would have at most the 16-18 SMs of one GPC to itself),
// B c <= the card's SMs, and all B clusters on the card at once
// (cudaOccupancyMaxActiveClusters; a cluster's blocks share one GPC, so at
// B = 16 sixteen clusters of 8 do not fit together and a second wave would
// double the time).  Kernel A runs the whole update on the cluster as a
// team: roots, poles and columns shared out, the operators stored by rows in
// distributed shared memory where the five live slots fit (one block: its
// own shared memory), else in a scratch of the live set (1.3 MB an update at
// (256, 320) f32, so a B32 batch stays in L2), the left and right chains
// solved together, products tiled through shared memory, f64 on the DMMA
// tensor cores.  Where even a block's vectors do not fit in shared memory
// (kmax past about 300 in f64), they go to the scratch as well and the update
// runs on one block: every shape the fused gate passes runs.  Kernel B splits
// the Brand projections and residuals (over eight fixed chunks of rows, added
// by a pairwise tree whose top levels run over the cluster's blocks through
// distributed shared memory, so the sums do not depend on the cluster's size)
// and the factor rotations ([U p] @ G_u, by row slices), reading its rows of
// U and V once into shared memory where they fit and keeping their residuals
// there; every block computes the (r + 1) core itself on the implicit
// identity basis (no eye @ G product), so no block waits on another for it
// and all hold the same bits.  The secular roots run a lane group each, its
// size chosen for the whole problem.  An update gives the same bits at every
// batch size.  No TF32, no library GEMM.
//
// Storage types: float and double compute in their own type; bf16 and f16
// storage is read, upcast to float on load (as the TPU kernel upcasts after
// its load), computed in float and rounded back on store.
//
// Each storage type is instantiated in its own source (fused_update_<type>.cu)
// so that nvcc compiles the four in parallel.
#pragma once

#include "fused_core.cuh"

namespace {

using fused::Ctx;
using fused::Team;
using fused::THREADS;

// The kernels' flags: the operators in shared memory, the vectors in device
// scratch (a block of its own an update), and kernel B's residuals in device
// scratch and its rows of U and V cached in shared memory.
constexpr int OPS_SMEM = 1, VECS_SCRATCH = 2, B_PERP_SCRATCH = 4, B_CACHE_ROWS = 8;

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS, 1)
fused_update_kernel(const S* u, const S* s, const S* v, const S* a, const S* b, S* uo, S* so,
                    S* vo, S* dlo, S* dro, T* scratch, int m, int n, double rtol, int nb,
                    int nn, int sign_fix, int csz, int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long i = blockIdx.x / csz;
  const Team tm{(int)(blockIdx.x % csz), csz};
  const int kmax = fused::kmax_of(m, n), kc = fused::chain_k(m, n);
  const bool ops_in_smem = flags & OPS_SMEM, vecs_in_smem = !(flags & VECS_SCRATCH);
  const fused::Layout L = fused::layout<T>(kmax, kc, csz, ops_in_smem, vecs_in_smem);
  // an update's scratch: its operators (N_OPS (kc, kc) slots), then its vectors
  T* mine = scratch + i * ((ops_in_smem ? 0 : fused::N_OPS * (long)kc * kc) +
                           (vecs_in_smem ? 0 : fused::vec_elems(kmax)));
  T* ops_mem = ops_in_smem ? nullptr : mine;
  T* vec_mem = vecs_in_smem ? nullptr : mine + (ops_in_smem ? 0 : fused::N_OPS * (long)kc * kc);
  Ctx<T> c = fused::make_ctx<T>(smem, L, tm, kmax, kc, ops_mem, vec_mem, rtol, nb, nn);
  FUSED_MARK_START();
  const long mm = (long)m * m, nn2 = (long)n * n;
  fused::full_core<T, S, S, false>(m, n, u + i * mm, s + i * m, v + i * nn2, a + i * m,
                                   b + i * n, uo + i * mm, so + i * m, vo + i * nn2, dlo + i * m,
                                   dro + i * n, sign_fix != 0, c);
}

// Kernel B's exchange: a block's subtree of the Brand sums (U^T a, V^T b and
// the two residual norms), read by the other blocks of its cluster.
__host__ __device__ inline size_t trunc_xchg(int r) { return 2 * (size_t)r + 2; }
// Where kernel B's residuals and cached rows start.
__host__ __device__ inline size_t trunc_extra_offset(const fused::Layout& L) {
  return (L.total + 15) & ~(size_t)15;
}

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS, 1)
fused_update_truncated_kernel(const S* u, const S* s, const S* v, const S* a, const S* b,
                              S* uo, S* so, S* vo, T* scratch, int m, int n, int r,
                              double rtol, int nb, int nn, int csz, int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long bi = blockIdx.x / csz;
  const Team cl{(int)(blockIdx.x % csz), csz};  // Brand projections and rotations
  const Team one{0, 1};                          // the core: every block computes it
  const int k = r + 1;
  const int tid = threadIdx.x;
  const bool ops_in_smem = flags & OPS_SMEM, cache_rows = flags & B_CACHE_ROWS;
  const bool vecs_in_smem = !(flags & VECS_SCRATCH);
  const fused::Layout L = fused::layout<T>(k, k, 1, ops_in_smem, vecs_in_smem, trunc_xchg(r));
  const int ulo = cl.lo(m), uhi = cl.hi(m), vlo = cl.lo(n), vhi = cl.hi(n);
  // after the core's layout: the residuals of this block's rows (a_perp,
  // b_perp), then (cache_rows) its rows of U and V; in the scratch: the
  // residuals of every update (B_PERP_SCRATCH), then each block's operators
  // and vectors
  T* sp = reinterpret_cast<T*>(smem + trunc_extra_offset(L));
  T* perp_a = flags & B_PERP_SCRATCH ? scratch + bi * (m + n) : sp - ulo;
  T* perp_b = flags & B_PERP_SCRATCH ? scratch + bi * (m + n) + m : sp + (uhi - ulo) - vlo;
  const long per_block = (ops_in_smem ? 0 : fused::ops_elems(k, 1)) +
                         (vecs_in_smem ? 0 : fused::vec_elems(k));
  T* mine = scratch + (flags & B_PERP_SCRATCH ? (long)gridDim.x / csz * (m + n) : 0) +
            (long)blockIdx.x * per_block;
  T* ops_mem = ops_in_smem ? nullptr : mine;
  T* vec_mem = vecs_in_smem ? nullptr : mine + (ops_in_smem ? 0 : fused::ops_elems(k, 1));
  Ctx<T> c = fused::make_ctx<T>(smem, L, one, k, k, ops_mem, vec_mem, rtol, nb, nn);
  FUSED_MARK_START();
  u += bi * m * (long)r;
  v += bi * n * (long)r;
  s += bi * r;
  a += bi * m;
  b += bi * n;
  uo += bi * m * (long)r;
  vo += bi * n * (long)r;
  so += bi * r;
  T* pvec = c.v(fused::T_PVEC);
  T* qvec = c.v(fused::T_QVEC);
  T* saug = c.v(fused::T_SAUG);
  T* ak = c.v(fused::T_AK);
  T* bk = c.v(fused::T_BK);
  // this block's subtree of the Brand sums: [0, r) U^T a, [r, 2r) V^T b, then
  // |a_perp|^2 and |b_perp|^2 (fused::chunk_sum: the same bits at every
  // cluster size)
  T* part = c.xchg;
  const int cpb = fused::NCHUNK / csz, t0 = cl.rank * cpb;

  // this block's rows of U and V: read once into shared memory when they fit
  // beside the core (every later pass reads them there), else read in place
  T* su = sp + (uhi - ulo) + (vhi - vlo);
  T* sv = su + (long)(uhi - ulo) * r;
  if (cache_rows) {
#pragma unroll 4
    for (long e = tid; e < (long)(uhi - ulo) * r; e += THREADS) su[e] = fused::ld<T>(u + (long)ulo * r, e);
#pragma unroll 4
    for (long e = tid; e < (long)(vhi - vlo) * r; e += THREADS) sv[e] = fused::ld<T>(v + (long)vlo * r, e);
    __syncthreads();
  }
  auto uat = [&](int i, int l) {   // U[i, l], i a row of this block
    return cache_rows ? su[(long)(i - ulo) * r + l] : fused::ld<T>(u, (long)i * r + l);
  };
  auto vat = [&](int i, int l) {
    return cache_rows ? sv[(long)(i - vlo) * r + l] : fused::ld<T>(v, (long)i * r + l);
  };
  // the cluster's tree over its blocks' subtrees, in rank order
  auto cluster_sum = [&](int l) {
    T p[fused::MAXC];
#pragma unroll
    for (int q = 0; q < fused::MAXC; ++q) p[q] = q < csz ? cl.map(part, q)[l] : T(0);
    return fused::tree_sum(p, csz);
  };

  // Brand: project a and b off the bases, over this block's chunks of rows
  fused::chunk_sum<T>(m, t0, cpb, r, [&](int l, int j) { return uat(l, j) * fused::ld<T>(a, l); },
                      part, c.stage);
  fused::chunk_sum<T>(n, t0, cpb, r, [&](int l, int j) { return vat(l, j) * fused::ld<T>(b, l); },
                      part + r, c.stage);
  cl.sync();
  for (int l = tid; l < 2 * r; l += THREADS) {
    const T x = cluster_sum(l);
    if (l < r) pvec[l] = x; else qvec[l - r] = x;
  }
  __syncthreads();
  // residuals of this block's rows, and their squared norms
  fused::rowsum<T>(ulo, uhi, r, [&](int i, int l) { return uat(i, l) * pvec[l]; },
                   [&](int i, T x) { perp_a[i] = fused::ld<T>(a, i) - x; });
  fused::rowsum<T>(vlo, vhi, r, [&](int i, int l) { return vat(i, l) * qvec[l]; },
                   [&](int i, T x) { perp_b[i] = fused::ld<T>(b, i) - x; });
  __syncthreads();
  fused::chunk_sum<T>(m, t0, cpb, 1, [&](int l, int) { return perp_a[l] * perp_a[l]; },
                      part + 2 * r, c.stage);
  fused::chunk_sum<T>(n, t0, cpb, 1, [&](int l, int) { return perp_b[l] * perp_b[l]; },
                      part + 2 * r + 1, c.stage);
  cl.sync();
  const T ra2 = cluster_sum(2 * r), rb2 = cluster_sum(2 * r + 1);
  cl.sync();  // every block has read the others' partial sums
  T ra = fused::m_sqrt(ra2), rb = fused::m_sqrt(rb2);
  const bool ok_a = ra > T(1e-12), ok_b = rb > T(1e-12);
  ra = ok_a ? ra : T(0);
  rb = ok_b ? rb : T(0);
  FUSED_MARK(0);

  // the full core on the implicit (r+1) identity basis
  for (int i = tid; i < k; i += THREADS) {
    saug[i] = i < r ? fused::ld<T>(s, i) : T(0);
    ak[i] = i < r ? pvec[i] : ra;
    bk[i] = i < r ? qvec[i] : rb;
  }
  __syncthreads();
  fused::full_core<T, T, T, true>(k, k, (const T*)nullptr, saug, (const T*)nullptr, ak, bk,
                                  (T*)nullptr, (T*)nullptr, (T*)nullptr, (T*)nullptr,
                                  (T*)nullptr, true, c);
  const fused::Ops<T> ops = c.ops;
  const T* dl = c.v(fused::F_DL);
  const T* flip = c.v(fused::F_FLIP);

  // rotate this block's rows of the augmented factors, keep the top r:
  // u_new = [U a_perp / ra] @ G_u[:, :r], v_new = [V b_perp / rb] @ (G_v F)[:, :r]
  fused::gemm<T>(0, 1, uhi - ulo, r, k,
                 [&](int i, int l) {
                   return l < r ? uat(ulo + i, l) : (ok_a ? perp_a[ulo + i] / ra : T(0));
                 },
                 [&](int l, int j) { return *ops.at(fused::O_GL, k - 1 - l, k - 1 - j); },
                 [&](int i, int j, T x) { fused::st(uo, (long)(ulo + i) * r + j, x); }, c.stage);
  fused::gemm<T>(0, 1, vhi - vlo, r, k,
                 [&](int i, int l) {
                   return l < r ? vat(vlo + i, l) : (ok_b ? perp_b[vlo + i] / rb : T(0));
                 },
                 [&](int l, int j) { return *ops.at(fused::O_GR, k - 1 - l, k - 1 - j) * flip[j]; },
                 [&](int i, int j, T x) { fused::st(vo, (long)(vlo + i) * r + j, x); }, c.stage);
  if (cl.rank == 0)
    for (int j = tid; j < r; j += THREADS) fused::st(so, j, fused::m_sqrt(dl[j] > T(0) ? dl[j] : T(0)));
  FUSED_MARK(7);
}

// The card's SM count, read once.
inline int card_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// How a launch runs: blocks per update, where the operators live (0: shared
// memory, 1: distributed shared memory, 2: device scratch), the dynamic
// shared memory of a block, the scratch elements of the launch and the
// kernel's flags.
struct Plan {
  int csz, tier;
  size_t smem;
  long long scratch;
  int flags;   // OPS_SMEM | VECS_SCRATCH | B_PERP_SCRATCH | B_CACHE_ROWS
};

constexpr int ERR_TOO_LARGE = 1001;  // a shape the kernels cannot take

inline cudaLaunchConfig_t cluster_config(int grid, int csz, size_t smem, void* stream,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csz;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises the kernel's dynamic shared memory limit to ``smem`` (once a size).
template <typename Kern>
int allow_smem(Kern kern, size_t smem) {
  static size_t set = 48 * 1024;
  if (smem <= set) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)fused::SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  set = fused::SMEM_MAX;
  return 0;
}

// How many clusters of ``csz`` blocks of ``smem`` bytes the card runs at once
// (cudaOccupancyMaxActiveClusters: a cluster's blocks share one GPC), cached.
template <typename Kern>
int active_clusters(Kern kern, int csz, size_t smem) {
  static size_t key[4] = {0, 0, 0, 0};
  static int val[4] = {0, 0, 0, 0};
  const int slot = csz == 8 ? 3 : csz == 4 ? 2 : csz == 2 ? 1 : 0;
  if (key[slot] == smem + 1) return val[slot];
  if (allow_smem(kern, smem)) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(csz, csz, smem, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  key[slot] = smem + 1;
  val[slot] = n;
  return n;
}

// Blocks per update: the largest power of two c <= MAXC with B c <= SMs and
// all B clusters on the card at once; where the operators live and the
// shared memory for that c (``place``), and false when even one block's
// vectors exceed its shared memory.
template <typename Kern, typename Place>
bool choose(Kern kern, int B, Plan& p, Place place) {
  const int sms = card_sms();
  for (int c = fused::MAXC; c >= 1; c >>= 1) {
    if (!place(c, p)) continue;
    if (c == 1 || ((long)B * c <= sms && active_clusters(kern, c, p.smem) >= B)) return true;
  }
  return place(1, p);
}

// Kernel A: the operators in shared memory where they fit beside the
// vectors (one block: its own; a cluster: distributed), else in device
// scratch; where even the vectors do not fit, they go to the scratch too and
// the update runs on one block (gather() reads the team's shared memory).
template <typename T, typename S>
bool full_plan(int B, int m, int n, Plan& p) {
  const int kmax = fused::kmax_of(m, n), kc = fused::chain_k(m, n);
  return choose(fused_update_kernel<T, S>, B, p, [&](int c, Plan& q) {
    const size_t cap = fused::SMEM_MAX;
    q.csz = c;
    q.smem = fused::layout<T>(kmax, kc, c, true).total;
    if (q.smem <= cap) {
      q.tier = c > 1 ? 1 : 0;
      q.scratch = 0;
      q.flags = OPS_SMEM;
      return true;
    }
    q.tier = 2;
    q.scratch = (long long)B * fused::N_OPS * kc * kc;
    q.flags = 0;
    q.smem = fused::layout<T>(kmax, kc, c, false).total;
    if (q.smem <= cap) return true;
    if (c > 1) return false;
    q.flags = VECS_SCRATCH;
    q.scratch += (long long)B * fused::vec_elems(kmax);
    q.smem = fused::layout<T>(kmax, kc, 1, false, false).total;
    return q.smem <= cap;
  });
}

// Kernel B: the core's operators and vectors in shared memory where they fit
// (each block computes the core alone), else in device scratch (each block's
// own); then the residuals of the block's rows and, where they fit too, its
// rows of U and V.
template <typename T, typename S>
bool trunc_plan(int B, int m, int n, int r, Plan& p) {
  const int k = r + 1;
  return choose(fused_update_truncated_kernel<T, S>, B, p, [&](int c, Plan& q) {
    const size_t cap = fused::SMEM_MAX, xc = trunc_xchg(r);
    q.csz = c;
    q.tier = 0;
    q.flags = OPS_SMEM;
    q.scratch = 0;
    if (fused::layout<T>(k, k, 1, true, true, xc).total > cap) {
      q.tier = 2;
      q.flags = 0;
      q.scratch = (long long)B * c * fused::ops_elems(k, 1);
      if (fused::layout<T>(k, k, 1, false, true, xc).total > cap) {
        q.flags = VECS_SCRATCH;
        q.scratch += (long long)B * c * fused::vec_elems(k);
      }
    }
    const size_t base = trunc_extra_offset(
        fused::layout<T>(k, k, 1, q.flags & OPS_SMEM, !(q.flags & VECS_SCRATCH), xc));
    const size_t rows = (size_t)((m + c - 1) / c + (n + c - 1) / c);
    q.smem = base + rows * sizeof(T);
    if (q.smem > cap) {
      q.flags |= B_PERP_SCRATCH;
      q.scratch += (long long)B * (m + n);
      q.smem = base;
    } else if (q.smem + rows * r * sizeof(T) <= cap) {
      q.flags |= B_CACHE_ROWS;
      q.smem += rows * r * sizeof(T);
    }
    return q.smem <= cap;
  });
}

template <typename Kern, typename... Args>
int launch_cluster(Kern kern, int grid, const Plan& p, void* stream, Args... args) {
  const int err = allow_smem(kern, p.smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(grid, p.csz, p.smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, typename S>
int launch_full(const void* u, const void* s, const void* v, const void* a, const void* b,
                void* uo, void* so, void* vo, void* dlo, void* dro, void* scratch, int B, int m,
                int n, double rtol, int nb, int nn, int sign_fix, void* stream) {
  Plan p;
  if (!full_plan<T, S>(B, m, n, p)) return ERR_TOO_LARGE;
  if (B == 0) return 0;
  return launch_cluster(fused_update_kernel<T, S>, B * p.csz, p, stream, (const S*)u,
                        (const S*)s, (const S*)v, (const S*)a, (const S*)b, (S*)uo, (S*)so,
                        (S*)vo, (S*)dlo, (S*)dro, (T*)scratch, m, n, rtol, nb, nn, sign_fix,
                        p.csz, p.flags);
}

template <typename T, typename S>
int launch_trunc(const void* u, const void* s, const void* v, const void* a, const void* b,
                 void* uo, void* so, void* vo, void* scratch, int B, int m, int n, int r,
                 double rtol, int nb, int nn, void* stream) {
  Plan p;
  if (!trunc_plan<T, S>(B, m, n, r, p)) return ERR_TOO_LARGE;
  if (B == 0) return 0;
  return launch_cluster(fused_update_truncated_kernel<T, S>, B * p.csz, p, stream,
                        (const S*)u, (const S*)s, (const S*)v, (const S*)a, (const S*)b, (S*)uo,
                        (S*)so, (S*)vo, (T*)scratch, m, n, r, rtol, nb, nn, p.csz, p.flags);
}

template <typename T, typename S>
int plan_entry(int kind, int B, int m, int n, int r, long long* out) {
  Plan p;
  const bool ok = kind == 0 ? full_plan<T, S>(B, m, n, p) : trunc_plan<T, S>(B, m, n, r, p);
  out[0] = p.csz;
  out[1] = p.tier;
  out[2] = (long long)p.smem;
  out[3] = p.scratch;
  out[4] = (p.flags & VECS_SCRATCH) != 0;
  return ok ? 0 : ERR_TOO_LARGE;
}

}  // namespace

#define FULL_ENTRY(NAME, T, S)                                                                 \
  int NAME(const void* u, const void* s, const void* v, const void* a, const void* b,         \
           void* uo, void* so, void* vo, void* dlo, void* dro, void* scratch, int B, int m,    \
           int n, double rtol, int nb, int nn, int sign_fix, void* stream) {                   \
    return launch_full<T, S>(u, s, v, a, b, uo, so, vo, dlo, dro, scratch, B, m, n, rtol, nb,  \
                             nn, sign_fix, stream);                                            \
  }
#define TRUNC_ENTRY(NAME, T, S)                                                                \
  int NAME(const void* u, const void* s, const void* v, const void* a, const void* b,         \
           void* uo, void* so, void* vo, void* scratch, int B, int m, int n, int r,            \
           double rtol, int nb, int nn, void* stream) {                                        \
    return launch_trunc<T, S>(u, s, v, a, b, uo, so, vo, scratch, B, m, n, r, rtol, nb, nn,    \
                              stream);                                                         \
  }

// The launch plan for compute type T (kind 0: full, 1: truncated): out[0]
// blocks an update, out[1] the operators' tier (0 shared memory, 1
// distributed shared memory, 2 device scratch), out[2] a block's dynamic
// shared memory, out[3] the scratch elements of the launch, out[4] 1 when the
// vectors live in the scratch too; returns 1001 when the kernels cannot take
// the shape.  The scratch entries are out[3].
#define PLAN_ENTRIES(T, S)                                                                     \
  int fused_plan(int kind, int B, int m, int n, int r, long long* out) {                       \
    return plan_entry<T, S>(kind, B, m, n, r, out);                                            \
  }                                                                                            \
  long long fused_full_scratch_elems(int B, int m, int n) {                                    \
    long long out[5];                                                                          \
    plan_entry<T, S>(0, B, m, n, 0, out);                                                      \
    return out[3];                                                                             \
  }                                                                                            \
  long long fused_trunc_scratch_elems(int B, int m, int n, int r) {                            \
    long long out[5];                                                                          \
    plan_entry<T, S>(1, B, m, n, r, out);                                                      \
    return out[3];                                                                             \
  }
