// Kernel E: the FMM near field, with the Cauchy blocks built on chip.
//
//   out[b, r, box, t] = sum_c w[b, r, box, c] * k(box, c, t),
//   k(box, c, t) = tm[b, box, t] / ((av[b, box, t] - x[b, box, c]) + tau[b, box, t])
//                  (0 where the denominator is exactly 0)
//
// over the C3 = 3 cap sources of boxes box-1, box, box+1 (w is zero at invalid
// slots).  Note the sign: the denominator is y - x, the opposite of kernel C's
// (src - av) - tau.
//
// Replaces repro/kernels/nearfield.py: nearfield_pallas.
//
// What bounds it on an H100: operations.  Per box, 2 R C3 CT operations
// against R (C3 + CT) elements of w and out: 204 operations per element at the
// FMM's leaf sizes (C3 = 408, CT = 136), 25 per byte in f64, above the card's
// line of 20 (67 TFLOP/s, f64 on the DMMA tensor cores or f32 on the CUDA
// cores, over 3.35 TB/s).  At B = 8, R = 1024, nb = 32: 29.1 GFLOP, 0.435 ms;
// 855 MB of w and 285 MB of out, 0.34 ms.  The reference precomputes the
// masked (C3, CT) inverse block of every box in device memory; this kernel
// never stores it.
//
// Design.  A block owns one (member, box, panel of TN = 48 targets) and all R
// rows, so each Cauchy entry -- a division -- is built once per launch (a
// 32 x 32 tile rebuilt for every 32 rows cost as much as the products).  The
// block builds the (C3, TN) panel in dynamic shared memory (163 KB in f64 at
// C3 = 408; a larger C3 runs in chunks, each chunk's sum added to out in a
// fixed order) and then streams the rows of w through it: each warp owns rows,
// and each lane reads its rows' w straight from global memory into registers
// a step or two ahead of the products, so nothing but the panel passes through
// shared memory.  The panels of one box are neighbours in blockIdx, so the
// three blocks that read the same w run side by side and share it in L2.
// f64 contracts on the DMMA tensor cores with mma.sync m16n8k8 as
// out^T = K^T w^T: M = 16 targets, N = 8 rows, K = 8 sources; a warp holds 16
// rows against the panel's 48 targets, 6 products a step.  The 8 sources of a
// step are placed so that a lane's B fragment is one 16-byte load of a row of
// w and its A fragment two 16-byte reads of the panel, which stores the
// targets g and g + 8 of each source side by side (the sum does not care which
// source sits at which position, as long as A and B agree).  (The m8n8k4
// shape runs at half the DMMA rate on this card: tools/dmma_probe.cu.)  f32
// uses FFMA, each lane 4 rows x 12 targets, a panel value read from shared
// memory feeding 4 multiply-adds, two blocks an SM.  What remains between the
// kernel and its bound is mostly the reading of w: three panel blocks read
// each box's w from L2 (2.6 GB at B = 8), a step's products wait on it, and
// sharing it across the panels needs shared memory that the f64 panel holds.
// Ragged R, C3 and CT are masked, not padded in memory; no atomics, so two
// launches give the same bits.  Each output is summed over the sources in a
// fixed order: in f32 in source order, as the plain version's product sums
// it; in f64 in the tensor core's steps of 8.
#include <cuda_runtime.h>

namespace {

constexpr int TN = 48;  // targets per block
constexpr int SMEM_OPTIN = 232448;
// f64: the panel holds, per source, the 48 targets as three 16-target tiles,
// each as 8 pairs (g, g + 8), padded to 50 doubles (25 16-byte units, odd, so
// that a quarter-warp's 16-byte reads of sources 2 apart fall in distinct
// banks); 560 sources a chunk: 219 KB.  f32: 48 x 1024 floats, 192 KB.
constexpr int ROW64 = 50;
constexpr int KCH64 = 560;
constexpr int KCH32 = 1024;

template <typename T>
__device__ __forceinline__ T cauchy(const T* __restrict__ x, const T* __restrict__ av,
                                    const T* __restrict__ tau, const T* __restrict__ tm, int c,
                                    int t) {
  const T den = (av[t] - x[c]) + tau[t];
  return (den != T(0) ? T(1) / den : T(0)) * tm[t];
}

__device__ __forceinline__ void mma_16x8x8(double (&d)[4], double2 a01, double2 a23, double2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a01.x), "d"(a01.y), "d"(a23.x), "d"(a23.y), "d"(b.x), "d"(b.y));
}

// The block's (member, box, panel): w[b, 0, box, 0] and out[b, 0, box, 0],
// the strides between rows of one box, the panel's first target, and the
// offsets of x[b, box, :] and av / tau / tm[b, box, :].
template <typename T>
struct Tile {
  const T* w;
  T* out;
  long long wrow, orow, xo, to;
  int t0;
  __device__ Tile(const T* w_, T* out_, int R, int NB, int C3, int CT, int npanel) {
    const int bb = blockIdx.x / npanel;  // b * NB + box
    t0 = (blockIdx.x - bb * npanel) * TN;
    const int b = bb / NB, box = bb - b * NB;
    w = w_ + ((long long)b * R * NB + box) * C3;
    out = out_ + ((long long)b * R * NB + box) * CT;
    wrow = (long long)NB * C3;
    orow = (long long)NB * CT;
    xo = (long long)bb * C3;
    to = (long long)bb * CT;
  }
};

// Steps 0 .. nsteps-1 of a contraction, the operands of step s + PF loaded
// while step s computes: ``load(buf, s)`` and ``compute(buf, s)``.
template <int PF, typename Buf, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int nsteps, Buf (&buf)[PF + 1], Load load,
                                         Compute compute) {
#pragma unroll
  for (int j = 0; j < PF; ++j)
    if (j < nsteps) load(buf[j], j);
  for (int s0 = 0; s0 < nsteps; s0 += PF + 1) {
#pragma unroll
    for (int j = 0; j <= PF; ++j) {
      const int s = s0 + j;
      if (s < nsteps) {
        if (s + PF < nsteps) load(buf[(j + PF) % (PF + 1)], s + PF);
        compute(buf[j], s);
      }
    }
  }
}

template <int NR>
struct Frag64 {
  double2 v[NR];
};

// f64: out^T = K^T w^T on mma.sync m16n8k8, M = 16 targets of the panel, N =
// 8 rows of w, K = 8 sources; each warp NR n-tiles (8 NR rows) against the
// three target tiles.  Lane (g, tq) = (lane / 4, lane % 4) holds positions tq
// and tq + 4 of a step as the sources k0 + 2 tq and k0 + 2 tq + 1 (the sum does
// not care which source sits at which position, as long as A and B agree), so
// its B fragment is one 16-byte load of row g of w, and its A fragment two
// 16-byte reads of the panel (targets g and g + 8 at each source).  PAIRS: the
// rows of w start 16-byte aligned (C3 even), so the pair is one load.
template <int NR, int NTHR, int PF, bool PAIRS>
__global__ void __launch_bounds__(NTHR, 1)
nearfield_f64_kernel(const double* __restrict__ w, const double* __restrict__ x,
                     const double* __restrict__ av, const double* __restrict__ tau,
                     const double* __restrict__ tm, double* __restrict__ out, int R, int NB,
                     int C3, int CT, int npanel) {
  extern __shared__ __align__(16) double panel64[];
  const Tile<double> tl(w, out, R, NB, C3, CT, npanel);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  for (int c0 = 0; c0 < C3; c0 += KCH64) {
    const int kc = min(KCH64, C3 - c0);
    const int kpad = (kc + 7) & ~7;
    __syncthreads();
#pragma unroll 4
    for (int e = threadIdx.x; e < TN * kpad; e += NTHR) {
      const int k = e / TN, n = e - k * TN;
      const int t = tl.t0 + n;
      panel64[k * ROW64 + (n >> 4) * 16 + (n & 7) * 2 + ((n >> 3) & 1)] =
          (t < CT && k < kc) ? cauchy(x + tl.xo, av + tl.to, tau + tl.to, tm + tl.to, c0 + k, t)
                             : 0.0;
    }
    __syncthreads();
    for (int r0 = warp * 8 * NR; r0 < R; r0 += (NTHR / 32) * 8 * NR) {
      const double* wr[NR];
      bool rok[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = r0 + 8 * j + g;
        rok[j] = r < R;
        wr[j] = tl.w + (rok[j] ? r : 0) * tl.wrow + c0;
      }
      // acc[mt][j] = {(target g, row 2 tq), (g, 2 tq + 1), (g + 8, 2 tq), (g + 8, 2 tq + 1)}
      double acc[3][NR][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int j = 0; j < NR; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = tl.t0 + 16 * mt + g + 8 * (i >> 1);
            const int r = r0 + 8 * j + 2 * tq + (i & 1);
            acc[mt][j][i] = (c0 > 0 && r < R && t < CT) ? tl.out[r * tl.orow + t] : 0.0;
          }
      auto load = [&](Frag64<NR>& b, int s) {
        const int k = 8 * s + 2 * tq;
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          b.v[j] = make_double2(0.0, 0.0);
          if (PAIRS) {
            if (rok[j] && k < kc) b.v[j] = __ldg(reinterpret_cast<const double2*>(wr[j] + k));
          } else {
            if (rok[j] && k < kc) b.v[j].x = __ldg(wr[j] + k);
            if (rok[j] && k + 1 < kc) b.v[j].y = __ldg(wr[j] + k + 1);
          }
        }
      };
      auto compute = [&](const Frag64<NR>& b, int s) {
        const double2* pk = reinterpret_cast<const double2*>(
            panel64 + (8 * s + 2 * tq) * ROW64 + 2 * g);
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          const double2 a01 = pk[8 * mt];
          const double2 a23 = pk[8 * mt + ROW64 / 2];
#pragma unroll
          for (int j = 0; j < NR; ++j) mma_16x8x8(acc[mt][j], a01, a23, b.v[j]);
        }
      };
      Frag64<NR> buf[PF + 1];
      pipeline<PF>(kpad / 8, buf, load, compute);
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int j = 0; j < NR; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = tl.t0 + 16 * mt + g + 8 * (i >> 1);
            const int r = r0 + 8 * j + 2 * tq + (i & 1);
            if (r < R && t < CT) tl.out[r * tl.orow + t] = acc[mt][j][i];
          }
    }
  }
}

template <int RM>
struct Frag32 {
  float v[RM][4];
};

// f32: panel[k][n] (row stride TN).  A warp's lanes form 32 / CH row groups
// of CH lanes; lane (rg, ch) owns RM rows (r0 + rg + (32 / CH) h) against the
// TN / CH targets from ch TN / CH, so each panel value a lane reads from
// shared memory (a broadcast to the CH-th of the warp that shares it) feeds
// RM multiply-adds.  QUADS: the rows of w start 16-byte aligned (C3 a
// multiple of 4), so four sources are one load.
template <int RM, int CH, int NTHR, int MINB, int PF, bool QUADS>
__global__ void __launch_bounds__(NTHR, MINB)
nearfield_f32_kernel(const float* __restrict__ w, const float* __restrict__ x,
                     const float* __restrict__ av, const float* __restrict__ tau,
                     const float* __restrict__ tm, float* __restrict__ out, int R, int NB, int C3,
                     int CT, int npanel) {
  constexpr int RG = 32 / CH, CW = TN / CH;
  extern __shared__ __align__(16) float panel32[];
  const Tile<float> tl(w, out, R, NB, C3, CT, npanel);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane / CH, n0 = (lane % CH) * CW;

  for (int c0 = 0; c0 < C3; c0 += KCH32) {
    const int kc = min(KCH32, C3 - c0);
    const int kpad = (kc + 3) & ~3;
    __syncthreads();
#pragma unroll 4
    for (int e = threadIdx.x; e < TN * kpad; e += NTHR) {
      const int k = e / TN, n = e - k * TN;
      const int t = tl.t0 + n;
      panel32[e] = (t < CT && k < kc)
          ? cauchy(x + tl.xo, av + tl.to, tau + tl.to, tm + tl.to, c0 + k, t) : 0.0f;
    }
    __syncthreads();
    for (int r0 = warp * RG * RM; r0 < R; r0 += (NTHR / 32) * RG * RM) {
      const float* wr[RM];
      bool rok[RM];
      float acc[RM][CW];
#pragma unroll
      for (int h = 0; h < RM; ++h) {
        const int r = r0 + rg + RG * h;
        rok[h] = r < R;
        wr[h] = tl.w + (rok[h] ? r : 0) * tl.wrow + c0;
#pragma unroll
        for (int n = 0; n < CW; ++n) {
          const int t = tl.t0 + n0 + n;
          acc[h][n] = (c0 > 0 && rok[h] && t < CT) ? tl.out[r * tl.orow + t] : 0.0f;
        }
      }
      auto load = [&](Frag32<RM>& a, int s) {
        const int k = 4 * s;
#pragma unroll
        for (int h = 0; h < RM; ++h) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (QUADS) {
            if (rok[h] && k < kc) v = __ldg(reinterpret_cast<const float4*>(wr[h] + k));
          } else {
            if (rok[h] && k < kc) v.x = __ldg(wr[h] + k);
            if (rok[h] && k + 1 < kc) v.y = __ldg(wr[h] + k + 1);
            if (rok[h] && k + 2 < kc) v.z = __ldg(wr[h] + k + 2);
            if (rok[h] && k + 3 < kc) v.w = __ldg(wr[h] + k + 3);
          }
          a.v[h][0] = v.x;
          a.v[h][1] = v.y;
          a.v[h][2] = v.z;
          a.v[h][3] = v.w;
        }
      };
      auto compute = [&](const Frag32<RM>& a, int s) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4* pk = reinterpret_cast<const float4*>(panel32 + (4 * s + kk) * TN + n0);
#pragma unroll
          for (int n4 = 0; n4 < CW / 4; ++n4) {
            const float4 bv = pk[n4];
#pragma unroll
            for (int h = 0; h < RM; ++h) {
              acc[h][4 * n4 + 0] = fmaf(a.v[h][kk], bv.x, acc[h][4 * n4 + 0]);
              acc[h][4 * n4 + 1] = fmaf(a.v[h][kk], bv.y, acc[h][4 * n4 + 1]);
              acc[h][4 * n4 + 2] = fmaf(a.v[h][kk], bv.z, acc[h][4 * n4 + 2]);
              acc[h][4 * n4 + 3] = fmaf(a.v[h][kk], bv.w, acc[h][4 * n4 + 3]);
            }
          }
        }
      };
      Frag32<RM> buf[PF + 1];
      pipeline<PF>(kpad / 4, buf, load, compute);
#pragma unroll
      for (int h = 0; h < RM; ++h) {
        if (!rok[h]) continue;
        float* o = tl.out + (r0 + rg + RG * h) * tl.orow + tl.t0 + n0;
#pragma unroll
        for (int n = 0; n < CW; ++n)
          if (tl.t0 + n0 + n < CT) o[n] = acc[h][n];
      }
    }
  }
}

// The launch configuration: f64 NR 8-row tiles a warp, f32 RM rows and CH
// lanes a row group, the threads of a block, the operands' prefetch distance
// in steps.
constexpr int F64_NR = 2, F64_THREADS = 512, F64_PF = 2;
constexpr int F32_RM = 4, F32_CH = 4, F32_THREADS = 256, F32_MINB = 2, F32_PF = 1;

// Lift the kernel's dynamic shared memory limit to the card's opt-in maximum,
// once per device.
int set_smem_once(const void* kernel, bool (&done)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && done[dev]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return (int)err;
}

template <typename T, typename Kernel>
int launch(Kernel kernel, bool (&done)[64], size_t smem, const void* w, const void* x,
           const void* av, const void* tau, const void* tm, void* out, int B, int R, int NB,
           int C3, int CT, int nthr, cudaStream_t stream) {
  const int err = set_smem_once((const void*)kernel, done);
  if (err != 0) return err;
  const int npanel = (CT + TN - 1) / TN;
  kernel<<<B * NB * npanel, nthr, smem, stream>>>(
      (const T*)w, (const T*)x, (const T*)av, (const T*)tau, (const T*)tm, (T*)out, R, NB, C3, CT,
      npanel);
  return (int)cudaGetLastError();
}

template <int RM, int CH, int NTHR, int MINB, int PF>
int launch_f32(const void* w, const void* x, const void* av, const void* tau, const void* tm,
               void* out, int B, int R, int NB, int C3, int CT, cudaStream_t stream) {
  static bool done[2][64] = {};
  const size_t smem = (size_t)TN * ((min(C3, KCH32) + 3) & ~3) * sizeof(float);
  if (C3 % 4 == 0 && reinterpret_cast<unsigned long long>(w) % 16 == 0)
    return launch<float>(nearfield_f32_kernel<RM, CH, NTHR, MINB, PF, true>, done[1], smem, w, x, av,
                         tau, tm, out, B, R, NB, C3, CT, NTHR, stream);
  return launch<float>(nearfield_f32_kernel<RM, CH, NTHR, MINB, PF, false>, done[0], smem, w, x, av,
                       tau, tm, out, B, R, NB, C3, CT, NTHR, stream);
}

template <int NR, int NTHR, int PF>
int launch_f64(const void* w, const void* x, const void* av, const void* tau, const void* tm,
               void* out, int B, int R, int NB, int C3, int CT, cudaStream_t stream) {
  static bool done[2][64] = {};
  const size_t smem = (size_t)((min(C3, KCH64) + 7) & ~7) * ROW64 * sizeof(double);
  if (C3 % 2 == 0 && reinterpret_cast<unsigned long long>(w) % 16 == 0)
    return launch<double>(nearfield_f64_kernel<NR, NTHR, PF, true>, done[1], smem, w, x, av, tau,
                          tm, out, B, R, NB, C3, CT, NTHR, stream);
  return launch<double>(nearfield_f64_kernel<NR, NTHR, PF, false>, done[0], smem, w, x, av, tau,
                        tm, out, B, R, NB, C3, CT, NTHR, stream);
}

}  // namespace

extern "C" {

int nearfield_f32(const void* w, const void* x, const void* av, const void* tau, const void* tm,
                  void* out, int B, int R, int NB, int C3, int CT, void* stream) {
  return launch_f32<F32_RM, F32_CH, F32_THREADS, F32_MINB, F32_PF>(w, x, av, tau, tm, out, B, R, NB, C3, CT,
                                                         (cudaStream_t)stream);
}

int nearfield_f64(const void* w, const void* x, const void* av, const void* tau, const void* tm,
                  void* out, int B, int R, int NB, int C3, int CT, void* stream) {
  return launch_f64<F64_NR, F64_THREADS, F64_PF>(w, x, av, tau, tm, out, B, R, NB, C3, CT,
                                                 (cudaStream_t)stream);
}

}  // extern "C"
