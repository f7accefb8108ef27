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
// What bounds it on an H100: per box, 2 R C3 CT operations against R (C3 + CT)
// elements of w and out, so 2 C3 CT / (C3 + CT) = 204 operations per element
// at the FMM's leaf sizes (C3 = 408, CT = 136), 25 per byte in f64: just above
// the card's line of 20 (67 TFLOP/s over 3.35 TB/s), so bound by operations,
// and more so in f32.
// The reference precomputes the masked (C3, CT) inverse block of every box in
// device memory (nb C3 CT elements, read again by every apply); this kernel
// never stores it.
//
// Design: grid (B * nb, ceil(CT/32), ceil(R/32)); each block owns a 32 x 32
// tile of (rows, targets) of one box and loops over C3 in chunks of 32.  Per
// chunk it loads the w tile and builds the (32, 32) block tile in shared memory
// from x, av, tau and tm, as kernel C does; the loop replaces the TPU's
// whole-block VMEM product, which would not fit a block's shared memory here
// (408 x 136 doubles are 444 KB).  Ragged edges are masked, not padded.  The
// tile costs 1024 divisions per 32K multiply-adds.  No tensor cores and no
// asynchronous copies yet; that is later work.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE * TILE / THREADS;  // 4

template <typename T>
__global__ void __launch_bounds__(THREADS)
nearfield_kernel(const T* __restrict__ w, const T* __restrict__ x, const T* __restrict__ av,
                 const T* __restrict__ tau, const T* __restrict__ tm, T* __restrict__ out,
                 int R, int NB, int C3, int CT) {
  __shared__ T ws[TILE][TILE + 1];  // [row][source]
  __shared__ T ks[TILE][TILE + 1];  // [source][target]
  const int bb = blockIdx.x;        // b * NB + box
  const int b = bb / NB;
  const int box = bb - b * NB;
  const int t0 = blockIdx.y * TILE;
  const int r0 = blockIdx.z * TILE;
  const int tx = threadIdx.x % TILE;
  const int ty = threadIdx.x / TILE;
  const long xo = (long)bb * C3;  // x[b, box, :]
  const long to = (long)bb * CT;  // av, tau, tm[b, box, :]

  T acc[ROWS_PER_THREAD];
#pragma unroll
  for (int q = 0; q < ROWS_PER_THREAD; ++q) acc[q] = T(0);

  for (int c0 = 0; c0 < C3; c0 += TILE) {
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int rr = e / TILE, cc = e % TILE;
      const int r = r0 + rr, c = c0 + cc;
      ws[rr][cc] = (r < R && c < C3) ? w[(((long)b * R + r) * NB + box) * C3 + c] : T(0);
    }
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int cc = e / TILE, tt = e % TILE;
      const int c = c0 + cc, t = t0 + tt;
      T k = T(0);
      if (c < C3 && t < CT) {
        const T den = (av[to + t] - x[xo + c]) + tau[to + t];
        k = (den != T(0) ? T(1) / den : T(0)) * tm[to + t];
      }
      ks[cc][tt] = k;
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < TILE; ++cc) {
      const T k = ks[cc][tx];
#pragma unroll
      for (int q = 0; q < ROWS_PER_THREAD; ++q) acc[q] += ws[ty + q * (THREADS / TILE)][cc] * k;
    }
    __syncthreads();
  }
  const int t = t0 + tx;
  if (t >= CT) return;
#pragma unroll
  for (int q = 0; q < ROWS_PER_THREAD; ++q) {
    const int r = r0 + ty + q * (THREADS / TILE);
    if (r < R) out[(((long)b * R + r) * NB + box) * CT + t] = acc[q];
  }
}

template <typename T>
int launch(const void* w, const void* x, const void* av, const void* tau, const void* tm,
           void* out, int B, int R, int NB, int C3, int CT, void* stream) {
  dim3 grid(B * NB, (CT + TILE - 1) / TILE, (R + TILE - 1) / TILE);
  nearfield_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)w, (const T*)x, (const T*)av, (const T*)tau, (const T*)tm, (T*)out,
      R, NB, C3, CT);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nearfield_f32(const void* w, const void* x, const void* av, const void* tau, const void* tm,
                  void* out, int B, int R, int NB, int C3, int CT, void* stream) {
  return launch<float>(w, x, av, tau, tm, out, B, R, NB, C3, CT, stream);
}

int nearfield_f64(const void* w, const void* x, const void* av, const void* tau, const void* tm,
                  void* out, int B, int R, int NB, int C3, int CT, void* stream) {
  return launch<double>(w, x, av, tau, tm, out, B, R, NB, C3, CT, stream);
}

}  // extern "C"
