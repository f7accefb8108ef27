// Kernels A and B: the fused rank-1 SVD update, one thread block per update.
//
// Kernel A replaces repro/kernels/fused_update.py: fused_update_pallas_batched
// (and fused_update_pallas, which is this kernel at B = 1).  Kernel B replaces
// fused_update_truncated_pallas_batched (and fused_update_truncated_pallas).
// The per-update computation is fused::full_core in fused_core.cuh.
//
// What bounds them on an H100: not memory.  A full update at (m, n) moves
// about 2 (m^2 + n^2) elements, but runs four secular phases of
// 22 sweeps over k roots x k poles (one division each), dense (k, k)
// products for every phase operator (about 3 k^3 multiply-adds per phase
// pair), and the rotations u @ G_u, v @ G_v.  That is hundreds of operations
// per byte, so the bound is the card's f32 / f64 rate.  Kernel B's secular
// core is only (r+1)-sized; its bytes (the (m + n) x r factors, read and
// written once) and its factor rotations ((m + n) (r+1) r multiply-adds)
// leave it bound by memory at the large shapes.
//
// What the design does about it, in this first version: little on purpose.
// One block of 256 threads per update keeps the whole update in one launch
// and every vector in shared memory, with the (k, k) operators in a
// device-memory scratch that stays in L2 at these sizes.  Secular roots and
// matrix entries are spread over the block's threads.  With B updates only B
// of the 132 SMs work, which is the first thing a later version changes (a
// cluster or several blocks per update, tensor-core products).
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
using fused::THREADS;

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
fused_update_kernel(const S* u, const S* s, const S* v, const S* a, const S* b, S* uo, S* so,
                    S* vo, S* dlo, S* dro, T* scratch, int m, int n, double rtol, int nb,
                    int nn, int sign_fix) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long i = blockIdx.x;
  const int kmax = fused::kmax_of(m, n);
  const long per = (long)fused::N_FULL_MATS * kmax * kmax;
  Ctx<T> c = fused::make_ctx<T>(smem, scratch + i * per, kmax, rtol, nb, nn);
  const long mm = (long)m * m, nn2 = (long)n * n;
  fused::full_core<T, S, S>(m, n, u + i * mm, s + i * m, v + i * nn2, a + i * m, b + i * n,
                            uo + i * mm, so + i * m, vo + i * nn2, dlo + i * m, dro + i * n,
                            sign_fix != 0, c);
}

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
fused_update_truncated_kernel(const S* u, const S* s, const S* v, const S* a, const S* b,
                              S* uo, S* so, S* vo, T* scratch, int m, int n, int r,
                              double rtol, int nb, int nn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long bi = blockIdx.x;
  const int k = r + 1;
  const int kmax = fused::kmax_of(k, k);
  const long per = (long)fused::N_TRUNC_MATS * kmax * kmax + m + n;
  T* mats = scratch + bi * per;
  Ctx<T> c = fused::make_ctx<T>(smem, mats, kmax, rtol, nb, nn);
  const int tid = threadIdx.x, nt = blockDim.x;
  u += bi * m * (long)r;
  v += bi * n * (long)r;
  s += bi * r;
  a += bi * m;
  b += bi * n;
  uo += bi * m * (long)r;
  vo += bi * n * (long)r;
  so += bi * r;
  T* p_unit = mats + (long)fused::N_TRUNC_MATS * kmax * kmax;  // (m): a_perp, then unit
  T* q_unit = p_unit + m;                                      // (n)
  T* pvec = c.v(fused::T_PVEC);
  T* qvec = c.v(fused::T_QVEC);
  T* saug = c.v(fused::T_SAUG);
  T* ak = c.v(fused::T_AK);
  T* bk = c.v(fused::T_BK);
  T* ss = c.v(fused::T_SS);
  T* eye = c.mat(fused::M_EYE);
  T* uu = c.mat(fused::M_UU);
  T* vv = c.mat(fused::M_VV);

  // Brand: project a and b off the bases; residual norms and unit vectors
  fused::matmul<T>(r, 1, m, u, 1, r, a, 1, 0, pvec, 1, 0);  // U^T a
  fused::matmul<T>(r, 1, n, v, 1, r, b, 1, 0, qvec, 1, 0);  // V^T b
  __syncthreads();
  for (int i = tid; i < m; i += nt) {
    T acc = T(0);
    for (int l = 0; l < r; ++l) acc += fused::ld<T>(u, (long)i * r + l) * pvec[l];
    p_unit[i] = fused::ld<T>(a, i) - acc;
  }
  for (int i = tid; i < n; i += nt) {
    T acc = T(0);
    for (int l = 0; l < r; ++l) acc += fused::ld<T>(v, (long)i * r + l) * qvec[l];
    q_unit[i] = fused::ld<T>(b, i) - acc;
  }
  T ra = fused::m_sqrt(fused::block_dot(m, p_unit, (const T*)nullptr, c.red));
  T rb = fused::m_sqrt(fused::block_dot(n, q_unit, (const T*)nullptr, c.red));
  const bool ok_a = ra > T(1e-12), ok_b = rb > T(1e-12);
  for (int i = tid; i < m; i += nt) p_unit[i] = ok_a ? p_unit[i] / ra : T(0);
  for (int i = tid; i < n; i += nt) q_unit[i] = ok_b ? q_unit[i] / rb : T(0);
  ra = ok_a ? ra : T(0);
  rb = ok_b ? rb : T(0);

  // the full core on the (r+1) identity basis
  for (int i = tid; i < k; i += nt) {
    saug[i] = i < r ? fused::ld<T>(s, i) : T(0);
    ak[i] = i < r ? pvec[i] : ra;
    bk[i] = i < r ? qvec[i] : rb;
  }
  for (long e = tid; e < (long)k * k; e += nt) eye[e] = (e / k == e % k) ? T(1) : T(0);
  __syncthreads();
  fused::full_core<T, T, T>(k, k, eye, saug, eye, ak, bk, uu, ss, vv, (T*)nullptr,
                            (T*)nullptr, true, c);

  // rotate the augmented factors, keep the top r: streamed over the rows
  for (long e = tid; e < (long)m * r; e += nt) {
    const long i = e / r;
    const int j = e % r;
    T acc = T(0);
    for (int l = 0; l < r; ++l) acc += fused::ld<T>(u, i * r + l) * uu[(long)l * k + j];
    acc += p_unit[i] * uu[(long)r * k + j];
    fused::st(uo, e, acc);
  }
  for (long e = tid; e < (long)n * r; e += nt) {
    const long i = e / r;
    const int j = e % r;
    T acc = T(0);
    for (int l = 0; l < r; ++l) acc += fused::ld<T>(v, i * r + l) * vv[(long)l * k + j];
    acc += q_unit[i] * vv[(long)r * k + j];
    fused::st(vo, e, acc);
  }
  for (int j = tid; j < r; j += nt) fused::st(so, j, ss[j]);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T, typename S>
int launch_full(const void* u, const void* s, const void* v, const void* a, const void* b,
                void* uo, void* so, void* vo, void* dlo, void* dro, void* scratch, int B, int m,
                int n, double rtol, int nb, int nn, int sign_fix, void* stream) {
  const size_t bytes = fused::smem_bytes<T>(fused::kmax_of(m, n));
  auto kern = fused_update_kernel<T, S>;
  int err = set_smem(kern, bytes);
  if (err) return err;
  kern<<<B, THREADS, bytes, (cudaStream_t)stream>>>(
      (const S*)u, (const S*)s, (const S*)v, (const S*)a, (const S*)b, (S*)uo, (S*)so, (S*)vo,
      (S*)dlo, (S*)dro, (T*)scratch, m, n, rtol, nb, nn, sign_fix);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch_trunc(const void* u, const void* s, const void* v, const void* a, const void* b,
                 void* uo, void* so, void* vo, void* scratch, int B, int m, int n, int r,
                 double rtol, int nb, int nn, void* stream) {
  const size_t bytes = fused::smem_bytes<T>(fused::kmax_of(r + 1, r + 1));
  auto kern = fused_update_truncated_kernel<T, S>;
  int err = set_smem(kern, bytes);
  if (err) return err;
  kern<<<B, THREADS, bytes, (cudaStream_t)stream>>>(
      (const S*)u, (const S*)s, (const S*)v, (const S*)a, (const S*)b, (S*)uo, (S*)so, (S*)vo,
      (T*)scratch, m, n, r, rtol, nb, nn);
  return (int)cudaGetLastError();
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


// elements of compute type per update in the scratch the wrapper allocates
#define SCRATCH_ENTRIES                                                                        \
  long long fused_full_scratch_elems(int m, int n) {                                           \
    const long long k = fused::kmax_of(m, n);                                                  \
    return (long long)fused::N_FULL_MATS * k * k;                                              \
  }                                                                                            \
  long long fused_trunc_scratch_elems(int m, int n, int r) {                                   \
    const long long k = fused::kmax_of(r + 1, r + 1);                                          \
    return (long long)fused::N_TRUNC_MATS * k * k + m + n;                                     \
  }
