// The fused rank-1 SVD update core, one thread block per update.
//
// Shared by kernel A (full update) and kernel B (Brand-truncated update) in
// fused_update.cuh.  It computes what repro/kernels/fused_update.py's
// _fused_body computes, step by step:
//   projections V^T b, U^T a, A b, A^T a;  the analytic 2x2 splits;
//   on each side a chain of two diagonal-plus-rank-1 phases (phase():
//   grouped Householder merge of near-coincident poles, tiny-z deflation,
//   brackets and anchors, secular_iterate(), Loewner zhat in log space,
//   scaled-Cauchy columns, stable reorder);  the structural-zero compression
//   of the right problem to m + 2 coordinates when n - m > 2;  the rotations
//   and the sign fix.
//
// Memory: vectors of the update live in dynamic shared memory, in fixed slots
// of KMAX = max(n, m + 2) elements (slot enums below).  The dense (k, k)
// operators (hh, qt, phi, G, the Householders h1/h2 and their product mq) do
// not fit a block's 227 KB beyond k of about 50 in f64, so they live in a
// device-memory scratch the wrapper allocates (B x fused_full_scratch_elems),
// in slots of KMAX^2 elements.  The kernel allocates nothing.
//
// All reductions run in a fixed order inside the block (a warp shuffle tree,
// then warp 0 in order), so a result does not change from run to run.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace fused {

constexpr int THREADS = 256;
constexpr int RED = 64;  // reduction buffer, in elements of T

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
  // phase()
  P_Z2RAW, P_ISREP, P_GZ2, P_ZREP, P_RVEC, P_WV, P_GN2, P_ZM, P_Z2K, P_ANCHOR, P_TAU,
  P_MU, P_ZHAT, P_COLNORM,
  // chain()
  C_MU1, C_Z2, C_DNEG, C_ZNEG, C_MUB,
  // full_core()
  F_S, F_A, F_B, F_VTB, F_BT, F_UTA, F_AT, F_A1, F_B1, F_A2, F_B2, F_VA2, F_VB2, F_DASC,
  F_DL, F_DR, F_D0, F_Z1, F_Z2W, F_BV, F_FLIP, F_BTVA, F_VN0, F_VN1,
  // compression
  X_Q1, X_Q2, X_C2P, X_F1, X_F2, X_W1, X_W2, X_Q2H,
  // truncated kernel
  T_PVEC, T_QVEC, T_SAUG, T_AK, T_BK, T_SS,
  N_VEC_SLOTS
};
enum IntSlot { I_LEAD0, I_LEAD1, I_KEEP, I_RANK, N_INT_SLOTS };
enum MatSlot { M_HH, M_QT, M_PHI1, M_PHIB, M_GASC, M_GU, M_GV, M_H1, M_H2, M_MQ,
               N_FULL_MATS, M_EYE = N_FULL_MATS, M_UU, M_VV, N_TRUNC_MATS };

__host__ __device__ inline int kmax_of(int m, int n) { return n > m + 2 ? n : m + 2; }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int kmax) {
  return (size_t)(RED + N_VEC_SLOTS * kmax) * sizeof(T) + (size_t)N_INT_SLOTS * kmax * sizeof(int);
}

template <typename T>
struct Ctx {
  T* red;      // RED elements, shared
  T* vecs;     // N_VEC_SLOTS * kmax, shared
  int* ints;   // N_INT_SLOTS * kmax, shared
  T* mats;     // per-update device scratch, slots of kmax^2
  int kmax;
  T rtol;
  int n_bisect, n_newton;
  __device__ T* v(int slot) const { return vecs + (long)slot * kmax; }
  __device__ int* iv(int slot) const { return ints + (long)slot * kmax; }
  __device__ T* mat(int slot) const { return mats + (long)slot * kmax * kmax; }
};

template <typename T>
__device__ Ctx<T> make_ctx(void* smem, T* mats, int kmax, double rtol, int nb, int nn) {
  Ctx<T> c;
  c.red = reinterpret_cast<T*>(smem);
  c.vecs = c.red + RED;
  c.ints = reinterpret_cast<int*>(c.vecs + (long)N_VEC_SLOTS * kmax);
  c.mats = mats;
  c.kmax = kmax;
  c.rtol = static_cast<T>(rtol);
  c.n_bisect = nb;
  c.n_newton = nn;
  return c;
}

// -- block-wide helpers --------------------------------------------------------

struct SumOp { template <typename T> __device__ T operator()(T a, T b) const { return a + b; } };
struct MaxOp { template <typename T> __device__ T operator()(T a, T b) const { return a > b ? a : b; } };

// Fixed-order reduction of one value per thread; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = red[0];
    for (int w = 1; w < nw; ++w) acc = op(acc, red[w]);
    red[RED - 1] = acc;
  }
  __syncthreads();
  return red[RED - 1];
}

// sum_i x[i] * y[i] over i < k (y == nullptr: sum of x[i]^2)
template <typename T>
__device__ T block_dot(int k, const T* x, const T* y, T* red) {
  T acc = T(0);
  for (int i = threadIdx.x; i < k; i += blockDim.x) acc += x[i] * (y ? y[i] : x[i]);
  return block_reduce(acc, red, SumOp());
}

// C(i, j) = sum_l A(i, l) B(l, j) with arbitrary (possibly negative) strides,
// so transposes and flips are index arithmetic.  Elements are spread over the
// block; consecutive threads take consecutive j.
template <typename T, typename TA, typename TB, typename TC>
__device__ void matmul(int M, int N, int K, const TA* A, long ar, long ac, const TB* B, long br,
                       long bc, TC* C, long cr, long cc) {
  for (long e = threadIdx.x; e < (long)M * N; e += blockDim.x) {
    const long i = e / N, j = e % N;
    T acc = T(0);
    for (int l = 0; l < K; ++l) acc += ld<T>(A, i * ar + l * ac) * ld<T>(B, l * br + j * bc);
    st(C, i * cr + j * cc, acc);
  }
}

// -- the secular loop ----------------------------------------------------------

// Counterpart of repro/kernels/secular_body.py: secular_iterate, for one root
// anchored at `anchor`.  The differences (d_j - anchor) - tau are recomputed on
// the fly, so the (k, k) difference tensor is never stored.  16 bisection +
// 6 safeguarded Newton steps on f(tau) = tau * w(tau), with the CLOSED-bracket
// acceptance of the reference.
template <typename T>
__device__ T secular_iterate(int k, const T* d, const T* z2k, T rho, T anchor, T lo, T hi,
                             int n_bisect, int n_newton) {
  for (int it = 0; it < n_bisect; ++it) {
    const T mid = T(0.5) * (lo + hi);
    T s = T(0);
    for (int j = 0; j < k; ++j) {
      const T delta = (d[j] - anchor) - mid;
      s += z2k[j] * (delta == T(0) ? T(0) : T(1) / delta);
    }
    const T w = T(1) + rho * s;
    if (w < T(0)) lo = mid; else hi = mid;
  }
  T tau = T(0.5) * (lo + hi);
  for (int it = 0; it < n_newton; ++it) {
    T s = T(0), sp = T(0);
    for (int j = 0; j < k; ++j) {
      const T delta = (d[j] - anchor) - tau;
      const T inv = delta == T(0) ? T(0) : T(1) / delta;
      const T r = z2k[j] * inv;
      s += r;
      sp += r * inv;
    }
    const T w = T(1) + rho * s;
    const T wp = rho * sp;
    if (w < T(0)) lo = tau; else hi = tau;
    const T fp = w + tau * wp;
    const T safe_fp = fp == T(0) ? Lim<T>::tiny() : fp;
    const T cand = tau - tau * w / safe_fp;
    tau = (cand >= lo && cand <= hi) ? cand : T(0.5) * (lo + hi);
  }
  return tau;
}

// -- one diagonal-plus-rank-1 phase ------------------------------------------

// eig(diag(d) + rho z z^T), d ascending, rho > 0.  Writes the ascending
// eigenvalues to mu_sorted and the (k, k) rotation to phi (row-major, leading
// dimension k).  d, z, mu_sorted are shared; phi is device scratch.
template <typename T>
__device__ void phase(int k, const T* d, const T* z, T rho, T* mu_sorted, T* phi,
                      const Ctx<T>& c) {
  const int tid = threadIdx.x, nt = blockDim.x;
  T* z2raw = c.v(P_Z2RAW);
  T* isrep = c.v(P_ISREP);
  T* gz2 = c.v(P_GZ2);
  T* zrep = c.v(P_ZREP);
  T* rvec = c.v(P_RVEC);
  T* wv = c.v(P_WV);
  T* gn2 = c.v(P_GN2);
  T* zm = c.v(P_ZM);
  T* z2k = c.v(P_Z2K);
  T* anchor = c.v(P_ANCHOR);
  T* tau = c.v(P_TAU);
  T* mu = c.v(P_MU);
  T* zhat = c.v(P_ZHAT);
  T* colnorm = c.v(P_COLNORM);
  int* lead = c.iv(I_LEAD0);
  int* lead2 = c.iv(I_LEAD1);
  int* keep = c.iv(I_KEEP);
  int* rank = c.iv(I_RANK);
  T* hh = c.mat(M_HH);
  T* qt = c.mat(M_QT);
  const T tiny = Lim<T>::tiny();

  // scale and deflation tolerance
  T amax = T(0), zsum = T(0);
  for (int i = tid; i < k; i += nt) {
    z2raw[i] = z[i] * z[i];
    amax = MaxOp()(amax, m_abs(d[i]));
    zsum += z2raw[i];
  }
  amax = block_reduce(amax, c.red, MaxOp());
  zsum = block_reduce(zsum, c.red, SumOp());
  const T scale = (amax > rho * zsum ? amax : rho * zsum) + tiny;
  const T tol = c.rtol * scale;

  // group leaders: first pole within tol below, chains closed by pointer jumping
  for (int i = tid; i < k; i += nt) {
    int L = i;
    for (int j = 0; j <= i; ++j)
      if (d[i] - d[j] <= tol) { L = j; break; }
    lead[i] = L;
  }
  __syncthreads();
  int rounds = 1;
  while ((1 << rounds) < k) ++rounds;
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i < k; i += nt) lead2[i] = lead[lead[i]];
    __syncthreads();
    int* t = lead; lead = lead2; lead2 = t;
  }
  for (int i = tid; i < k; i += nt) isrep[i] = lead[i] == i ? T(1) : T(0);
  __syncthreads();

  // grouped Householder merge
  for (int i = tid; i < k; i += nt) {
    T g = T(0), zr = T(0);
    for (int j = 0; j < k; ++j)
      if (lead[j] == lead[i]) { g += z2raw[j]; zr += z[j] * isrep[j]; }
    gz2[i] = g;
    zrep[i] = zr;
    const T sg = zr < T(0) ? T(1) : T(-1);
    rvec[i] = sg * m_sqrt(g);
    wv[i] = z[i] - rvec[i] * isrep[i];
  }
  __syncthreads();
  for (int i = tid; i < k; i += nt) {
    T g = T(0);
    for (int j = 0; j < k; ++j)
      if (lead[j] == lead[i]) g += wv[j] * wv[j];
    gn2[i] = g;
  }
  __syncthreads();
  for (long e = tid; e < (long)k * k; e += nt) {
    const int i = e / k, j = e % k;
    const T x = (lead[i] == lead[j] && gn2[i] > T(0)) ? T(2) * wv[i] * wv[j] / gn2[i] : T(0);
    hh[e] = (i == j ? T(1) : T(0)) - x;
  }

  // tiny-z deflation on the merged weights
  T zn2 = T(0);
  for (int i = tid; i < k; i += nt) {
    zm[i] = rvec[i] * isrep[i];
    const T z2 = zm[i] * zm[i];
    keep[i] = rho * z2 > tol;
    z2k[i] = keep[i] ? z2 : T(0);
    zn2 += z2k[i];
  }
  zn2 = block_reduce(zn2, c.red, SumOp());  // also publishes keep / z2k

  // brackets, anchors and the secular solve, one root per thread
  const T big = Lim<T>::max() * T(0.25);
  for (int i = tid; i < k; i += nt) {
    T nxt = big;
    for (int j = i + 1; j < k; ++j)
      if (keep[j] && d[j] < nxt) nxt = d[j];
    const bool is_last = keep[i] && nxt >= T(0.5) * big;
    const T right = is_last ? d[i] + rho * zn2 : nxt;
    const T width = keep[i] ? right - d[i] : T(0);
    const T half = T(0.5) * width;
    T acc = T(0);
    for (int j = 0; j < k; ++j) {
      const T dm = (d[j] - d[i]) - half;
      acc += z2k[j] * (dm != T(0) ? T(1) / dm : T(0));
    }
    const T w_mid = T(1) + rho * acc;
    const bool use_left = w_mid > T(0) || is_last;
    const T anc = use_left ? d[i] : right;
    const T lo = use_left ? T(0) : -half;
    const T hi = is_last ? width : (use_left ? half : T(0));
    T t = secular_iterate(k, d, z2k, rho, anc, lo, hi, c.n_bisect, c.n_newton);
    t = keep[i] ? t : T(0);
    anchor[i] = anc;
    tau[i] = t;
    mu[i] = keep[i] ? anc + t : d[i];
  }
  __syncthreads();

  // Loewner zhat (Gu-Eisenstat), log-magnitude space, anchored differences
  const T log_rho = m_log(rho);
  for (int j = tid; j < k; j += nt) {
    T ln = T(0), ld_ = T(0);
    for (int i = 0; i < k; ++i) {
      const T num = keep[i] ? (anchor[i] - d[j]) + tau[i] : T(1);
      ln += m_log(m_abs(num) + tiny);
      const T den = (i != j && keep[i]) ? d[i] - d[j] : T(1);
      ld_ += m_log(m_abs(den) + tiny);
    }
    const T sg = zm[j] > T(0) ? T(1) : (zm[j] < T(0) ? T(-1) : T(0));
    zhat[j] = keep[j] ? sg * m_exp(T(0.5) * (ln - ld_ - log_rho)) : T(0);
  }
  __syncthreads();

  // column norms of the scaled Cauchy columns, and the stable rank of mu
  for (int i = tid; i < k; i += nt) {
    T acc = T(0);
    for (int j = 0; j < k; ++j) {
      const T cd = (d[j] - anchor[i]) - tau[i];
      const T inv = cd != T(0) ? T(1) / cd : T(0);
      acc += zhat[j] * zhat[j] * inv * inv;
    }
    colnorm[i] = keep[i] ? m_sqrt(acc) : T(1);
    int r = 0;
    for (int j = 0; j < k; ++j) r += (mu[j] < mu[i]) || (mu[j] == mu[i] && j < i);
    rank[i] = r;
  }
  __syncthreads();

  // qt[j, i]: eigenvector columns; deflated columns pass through
  for (long e = tid; e < (long)k * k; e += nt) {
    const int j = e / k, i = e % k;
    T q;
    if (keep[i]) {
      const T cd = (d[j] - anchor[i]) - tau[i];
      const T inv = cd != T(0) ? T(1) / cd : T(0);
      q = zhat[j] * inv / colnorm[i];
    } else {
      q = i == j ? T(1) : T(0);
    }
    qt[e] = q;
  }
  __syncthreads();

  // phi[:, rank_i] = (hh @ qt)[:, i];  mu_sorted[rank_i] = mu_i
  for (long e = tid; e < (long)k * k; e += nt) {
    const int r = e / k, i = e % k;
    T acc = T(0);
    for (int l = 0; l < k; ++l) acc += hh[(long)r * k + l] * qt[(long)l * k + i];
    phi[(long)r * k + rank[i]] = acc;
  }
  for (int i = tid; i < k; i += nt) mu_sorted[rank[i]] = mu[i];
  __syncthreads();
}

// Two chained phases in ascending coordinates (rho_pos > 0 > rho_neg); the
// negative phase solves the negated problem, a double flip.  mu2: final
// eigenvalues ascending; G (k, k) with Q_final = Q0_asc @ G.
template <typename T>
__device__ void chain(int k, const T* d0, const T* z1, const T* z2w, T rho_pos, T rho_neg,
                      T* mu2, T* G, const Ctx<T>& c) {
  const int tid = threadIdx.x, nt = blockDim.x;
  T* mu1 = c.v(C_MU1);
  T* z2 = c.v(C_Z2);
  T* dneg = c.v(C_DNEG);
  T* zneg = c.v(C_ZNEG);
  T* mub = c.v(C_MUB);
  T* phi1 = c.mat(M_PHI1);
  T* phib = c.mat(M_PHIB);

  phase(k, d0, z1, rho_pos, mu1, phi1, c);
  matmul<T>(k, 1, k, phi1, 1, k, z2w, 1, 0, z2, 1, 0);  // z2 = phi1^T z2w
  __syncthreads();
  for (int i = tid; i < k; i += nt) {
    dneg[i] = -mu1[k - 1 - i];
    zneg[i] = z2[k - 1 - i];
  }
  __syncthreads();
  phase(k, dneg, zneg, -rho_neg, mub, phib, c);
  for (int i = tid; i < k; i += nt) mu2[i] = -mub[k - 1 - i];
  // G = phi1 @ flip2(phib)
  matmul<T>(k, k, k, phi1, k, 1, phib + (long)(k - 1) * k + (k - 1), -k, -1, G, k, 1);
  __syncthreads();
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
// all row-major.  Inputs of storage type SI, outputs of type SO, computed in T.
// dl_out / dr_out may be null.
template <typename T, typename SI, typename SO>
__device__ void full_core(int m, int n, const SI* u, const SI* s_in, const SI* v, const SI* a_in,
                          const SI* b_in, SO* u_out, SO* s_out, SO* v_out, SO* dl_out,
                          SO* dr_out, bool sign_fix, const Ctx<T>& c) {
  const int tid = threadIdx.x, nt = blockDim.x;
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
  T* flip = c.v(F_FLIP);
  T* gasc = c.mat(M_GASC);
  T* gu = c.mat(M_GU);
  T* gv = c.mat(M_GV);

  for (int i = tid; i < m; i += nt) {
    s[i] = ld<T>(s_in, i);
    a[i] = ld<T>(a_in, i);
  }
  for (int j = tid; j < n; j += nt) b[j] = ld<T>(b_in, j);
  __syncthreads();

  // STEP 1: structured products
  matmul<T>(n, 1, n, v, 1, n, b, 1, 0, vtb, 1, 0);  // V^T b
  matmul<T>(m, 1, m, u, 1, m, a, 1, 0, uta, 1, 0);  // U^T a
  const T beta = block_dot(n, b, (const T*)nullptr, c.red);
  const T alpha = block_dot(m, a, (const T*)nullptr, c.red);
  for (int i = tid; i < m; i += nt) {
    T acc = T(0);
    for (int l = 0; l < m; ++l) acc += ld<T>(u, (long)i * m + l) * (s[l] * vtb[l]);
    bt[i] = acc;
  }
  for (int i = tid; i < n; i += nt) {
    T acc = T(0);
    for (int l = 0; l < m; ++l) acc += ld<T>(v, (long)i * n + l) * (s[l] * uta[l]);
    at[i] = acc;
  }
  __syncthreads();

  // STEPS 2-3: analytic 2x2 splits
  T rho1, rho2, qp0, qp1, qn0, qn1, rho3, rho4, qpv0, qpv1, qnv0, qnv1;
  split(beta, rho1, rho2, qp0, qp1, qn0, qn1);
  split(alpha, rho3, rho4, qpv0, qpv1, qnv0, qnv1);
  for (int i = tid; i < m; i += nt) {
    a1[i] = qp0 * a[i] + qp1 * bt[i];
    b1[i] = qn0 * a[i] + qn1 * bt[i];
  }
  for (int j = tid; j < n; j += nt) {
    a2[j] = qpv0 * b[j] + qpv1 * at[j];
    b2[j] = qnv0 * b[j] + qnv1 * at[j];
  }
  __syncthreads();

  // STEPS 4-5 (left): ascending order is a static flip of s^2
  for (int i = tid; i < m; i += nt) d0[i] = s[m - 1 - i] * s[m - 1 - i];
  matmul<T>(m, 1, m, u + (m - 1), -1, m, a1, 1, 0, z1, 1, 0);   // flip(U^T a1)
  matmul<T>(m, 1, m, u + (m - 1), -1, m, b1, 1, 0, z2w, 1, 0);  // flip(U^T b1)
  matmul<T>(n, 1, n, v, 1, n, a2, 1, 0, va2, 1, 0);
  matmul<T>(n, 1, n, v, 1, n, b2, 1, 0, vb2, 1, 0);
  __syncthreads();
  chain(m, d0, z1, z2w, rho1, rho2, dasc, gasc, c);
  for (long e = tid; e < (long)m * m; e += nt) {  // g_u = flip2(G_asc)
    const long i = e / m, j = e % m;
    gu[e] = gasc[(m - 1 - i) * m + (m - 1 - j)];
  }
  for (int i = tid; i < m; i += nt) dl[i] = dasc[m - 1 - i];
  __syncthreads();

  // STEPS 6-7 (right)
  const bool compress = n - m > 2;
  const int kr = compress ? m + 2 : n;
  const int k0 = n - m;
  T* vn0 = c.v(F_VN0);
  T* vn1 = c.v(F_VN1);
  T* mq = c.mat(M_MQ);
  if (compress) {
    T* q1 = c.v(X_Q1);
    T* q2 = c.v(X_Q2);
    T* c2p = c.v(X_C2P);
    T* f1 = c.v(X_F1);
    T* f2 = c.v(X_F2);
    T* w1 = c.v(X_W1);
    T* w2 = c.v(X_W2);
    T* q2h = c.v(X_Q2H);
    T* h1 = c.mat(M_H1);
    T* h2 = c.mat(M_H2);
    const T* c1 = va2 + m;
    const T* c2 = vb2 + m;
    const T eps = Lim<T>::eps();
    const T na2 = m_sqrt(block_dot(n, va2, (const T*)nullptr, c.red));
    const T r11 = m_sqrt(block_dot(k0, c1, (const T*)nullptr, c.red));
    const T nb2 = m_sqrt(block_dot(n, vb2, (const T*)nullptr, c.red));
    for (int i = tid; i < k0; i += nt) q1[i] = r11 > eps * na2 ? c1[i] : (i == 0 ? T(1) : T(0));
    const T nq1 = m_sqrt(block_dot(k0, q1, (const T*)nullptr, c.red));
    for (int i = tid; i < k0; i += nt) q1[i] = q1[i] / nq1;
    const T dq = block_dot(k0, q1, c2, c.red);
    for (int i = tid; i < k0; i += nt) c2p[i] = c2[i] - dq * q1[i];
    const T r22 = m_sqrt(block_dot(k0, c2p, (const T*)nullptr, c.red));
    const T q10 = q1[0], q11 = q1[1];
    for (int i = tid; i < k0; i += nt) {
      f1[i] = (i == 0 ? T(1) : T(0)) - q1[i] * q10;
      f2[i] = (i == 1 ? T(1) : T(0)) - q1[i] * q11;
    }
    const T nf1 = block_dot(k0, f1, (const T*)nullptr, c.red);
    const T nf2 = block_dot(k0, f2, (const T*)nullptr, c.red);
    const T* fb = nf1 >= nf2 ? f1 : f2;
    for (int i = tid; i < k0; i += nt) q2[i] = r22 > eps * (na2 + nb2) ? c2p[i] : fb[i];
    const T d12 = block_dot(k0, q1, q2, c.red);
    for (int i = tid; i < k0; i += nt) q2[i] = q2[i] - d12 * q1[i];
    const T nq2 = m_sqrt(block_dot(k0, q2, (const T*)nullptr, c.red));
    for (int i = tid; i < k0; i += nt) q2[i] = q2[i] / nq2;

    // M = H1 @ H2, exactly orthogonal, M[:, 0] = +-q1
    const T sgn1 = q1[0] >= T(0) ? T(1) : T(-1);
    for (int i = tid; i < k0; i += nt) w1[i] = q1[i] + (i == 0 ? sgn1 : T(0));
    const T cw1 = T(2) / block_dot(k0, w1, (const T*)nullptr, c.red);
    for (long e = tid; e < (long)k0 * k0; e += nt) {
      const int i = e / k0, j = e % k0;
      h1[e] = (i == j ? T(1) : T(0)) - cw1 * (w1[i] * w1[j]);
    }
    __syncthreads();
    matmul<T>(k0, 1, k0, h1, k0, 1, q2, 1, 0, q2h, 1, 0);
    __syncthreads();
    for (int i = tid; i < k0; i += nt) q2h[i] = q2h[i] * (i == 0 ? T(0) : T(1));
    const T nq2h2 = block_dot(k0, q2h, (const T*)nullptr, c.red);
    const T nq2h = m_sqrt(nq2h2 > Lim<T>::tiny() ? nq2h2 : Lim<T>::tiny());
    for (int i = tid; i < k0; i += nt) q2h[i] = q2h[i] / nq2h;
    __syncthreads();
    const T sgn2 = q2h[1] >= T(0) ? T(1) : T(-1);
    for (int i = tid; i < k0; i += nt) w2[i] = q2h[i] + (i == 1 ? sgn2 : T(0));
    const T cw2 = T(2) / block_dot(k0, w2, (const T*)nullptr, c.red);
    for (long e = tid; e < (long)k0 * k0; e += nt) {
      const int i = e / k0, j = e % k0;
      h2[e] = (i == j ? T(1) : T(0)) - cw2 * (w2[i] * w2[j]);
    }
    __syncthreads();
    matmul<T>(k0, k0, k0, h1, k0, 1, h2, k0, 1, mq, k0, 1);
    __syncthreads();

    // chain on the m + 2 active coordinates: two compressed zero poles lead
    for (int i = tid; i < kr; i += nt) {
      if (i < 2) {
        d0[i] = T(0);
        T s1 = T(0), s2 = T(0);
        for (int p = 0; p < k0; ++p) {
          s1 += mq[(long)p * k0 + i] * c1[p];
          s2 += mq[(long)p * k0 + i] * c2[p];
        }
        z1[i] = s1;
        z2w[i] = s2;
      } else {
        const int o = m - 1 - (i - 2);
        d0[i] = s[o] * s[o];
        z1[i] = va2[o];
        z2w[i] = vb2[o];
      }
    }
    __syncthreads();
    chain(kr, d0, z1, z2w, rho3, rho4, dasc, gv, c);
    for (int j = tid; j < n; j += nt) dr[j] = j < kr ? dasc[kr - 1 - j] : T(0);
    // v_null @ m2 (n x 2), and btva = [m2^T vtb[m:], flip(vtb[:m])]
    T* btva = c.v(F_BTVA);
    for (int i = tid; i < n; i += nt) {
      T s0 = T(0), s1 = T(0);
      for (int p = 0; p < k0; ++p) {
        const T x = ld<T>(v, (long)i * n + m + p);
        s0 += x * mq[(long)p * k0];
        s1 += x * mq[(long)p * k0 + 1];
      }
      vn0[i] = s0;
      vn1[i] = s1;
    }
    for (int i = tid; i < kr; i += nt) {
      if (i < 2) {
        T acc = T(0);
        for (int p = 0; p < k0; ++p) acc += vtb[m + p] * mq[(long)p * k0 + i];
        btva[i] = acc;
      } else {
        btva[i] = vtb[m - 1 - (i - 2)];
      }
    }
    __syncthreads();
    for (int j = tid; j < m; j += nt) {  // bv = flip(g_act^T btva)[:m]
      T acc = T(0);
      for (int l = 0; l < kr; ++l) acc += btva[l] * gv[(long)l * kr + (kr - 1 - j)];
      bv[j] = acc;
    }
  } else {
    for (int i = tid; i < n; i += nt) {
      const int o = n - 1 - i;
      d0[i] = o < m ? s[o] * s[o] : T(0);
      z1[i] = va2[o];
      z2w[i] = vb2[o];
    }
    __syncthreads();
    chain(n, d0, z1, z2w, rho3, rho4, dasc, gasc, c);
    for (long e = tid; e < (long)n * n; e += nt) {  // g_v = flip2(G_asc)
      const long i = e / n, j = e % n;
      gv[e] = gasc[(n - 1 - i) * n + (n - 1 - j)];
    }
    for (int j = tid; j < n; j += nt) dr[j] = dasc[n - 1 - j];
    __syncthreads();
    matmul<T>(m, 1, n, gv, 1, n, vtb, 1, 0, bv, 1, 0);  // g_v[:, :m]^T vtb
  }
  __syncthreads();

  // sign fix: diag_i = u_i^T (A + a b^T) v_i from the structured factors
  for (int j = tid; j < m; j += nt) {
    T f = T(1);
    if (sign_fix) {
      T core = T(0), au = T(0);
      for (int q = 0; q < m; ++q) {
        const T g = gu[(long)q * m + j];
        const T gvm = compress ? gv[(long)(2 + m - 1 - q) * kr + (kr - 1 - j)]
                               : gv[(long)q * n + j];
        core += (s[q] * g) * gvm;
        au += uta[q] * g;
      }
      f = core + au * bv[j] < T(0) ? T(-1) : T(1);
    }
    flip[j] = f;
  }
  __syncthreads();

  // outputs
  matmul<T>(m, m, m, u, m, 1, gu, m, 1, u_out, m, 1);  // u @ g_u
  for (int i = tid; i < m; i += nt) {
    const T x = dl[i] > T(0) ? dl[i] : T(0);
    st(s_out, i, m_sqrt(x));
    if (dl_out) st(dl_out, i, dl[i]);
  }
  if (dr_out)
    for (int j = tid; j < n; j += nt) st(dr_out, j, dr[j]);
  if (compress) {
    for (long e = tid; e < (long)n * n; e += nt) {
      const long i = e / n;
      const int j = e % n;
      T acc = T(0);
      if (j < kr) {  // flip(v_act @ g_act): column kr-1-j of the rotation
        const int cidx = kr - 1 - j;
        acc += vn0[i] * gv[cidx] + vn1[i] * gv[(long)kr + cidx];
        for (int l = 2; l < kr; ++l)
          acc += ld<T>(v, i * n + (m - 1 - (l - 2))) * gv[(long)l * kr + cidx];
        if (j < m) acc = acc * flip[j];
      } else {  // v_null @ mq[:, 2:]
        for (int p = 0; p < k0; ++p) acc += ld<T>(v, i * n + m + p) * mq[(long)p * k0 + (j - m)];
      }
      st(v_out, e, acc);
    }
  } else {
    for (long e = tid; e < (long)n * n; e += nt) {
      const long i = e / n;
      const int j = e % n;
      T acc = T(0);
      for (int l = 0; l < n; ++l) acc += ld<T>(v, i * n + l) * gv[(long)l * n + j];
      st(v_out, e, j < m ? acc * flip[j] : acc);
    }
  }
  __syncthreads();
}

}  // namespace fused
