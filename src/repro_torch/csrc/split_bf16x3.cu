// The exact split of a float32 tensor into three bf16 planes, chunked along a
// contraction axis.
//
//   hi = trunc16(g),  r = g - hi,  mid = trunc16(r),  lo = r - mid
//
// where trunc16 keeps a float32's top 16 bits (sign, exponent and the first 7
// stored significand bits), which is a bf16 value.  Each piece is truncated
// toward zero, so every nonzero piece has g's sign, and a zero piece takes it
// too (a -0 splits into three -0).  (hi + mid) + lo == g bit for bit for every
// finite g whose lowest significand bit is not below bf16's smallest
// subnormal (2^-133), i.e. for |g| >= 2^-110 (about 7.7e-34): r and lo are
// exact float32 differences, and lo has at most 8 significant bits.  No finite
// g splits into an infinite plane; a non-finite g gives non-finite planes.
//
// Replaces no TPU kernel.  The reference multiplies the float32 cotangent of
// each compute-dtype product by the saved compute-dtype operand in float32
// (repro/models/layers.py, the transpose rule of ``dot``); on an H100 a
// float32 product runs on the CUDA cores at 67 TFLOP/s.  A bf16 x bf16
// product is exact in float32, so sum_p plane_p . b, accumulated in float32,
// is the same product in another order of sums, on the bf16 tensor cores
// (models/layers.py, _split_products).  This kernel makes the planes.
//
// Layout.  g is (outer, n) and a row's n elements fall into ``chunks`` runs of
// ``seg`` (the last one zero-padded to seg):
//
//   out[j, o, p, s] = plane_p(g[o, j seg + s])  (0 where j seg + s >= n),
//   p = 0 (lo), 1 (mid), 2 (hi)
//
// With g (B, K, N) split along K into chunks of L (outer B, n = K N, seg =
// L N), out (c, B, 3, L, N) holds for each chunk and member a (3L, N) matrix;
// along N (outer B K, n = N, seg = L), out (c, B K, 3, L) holds (K, 3L)
// matrices of row stride 3L.  Either way a batched product over the c B
// matrices runs each chunk's contraction over its three planes stacked, the
// smallest first, so a chunk adds its small parts before its large ones.
// ``repeat_bf16x3`` writes a bf16 operand in the same layout, its value in
// all three planes: the other side of that product, each chunk three times.
//
// What bounds it on an H100: bytes, 4 (repeat: 2) read and 6 written an
// element, at 3.35 TB/s.  Design: each thread takes 8 consecutive elements of
// a run (two 16-byte loads; repeat: one) and writes 8 bf16 of each plane
// (three 16-byte stores).  A run or row length that is not a multiple of 8, or
// a pointer that is not 16-byte aligned, takes one element a thread.
// Elementwise: two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ void split(float g, uint16_t& lo, uint16_t& mid, uint16_t& hi) {
  const uint32_t gb = __float_as_uint(g), sign = gb & 0x80000000u;
  const uint32_t rb = __float_as_uint(g - __uint_as_float(gb & 0xFFFF0000u)) | sign;
  const uint32_t lb = __float_as_uint(__uint_as_float(rb) - __uint_as_float(rb & 0xFFFF0000u)) | sign;
  hi = (uint16_t)(gb >> 16);
  mid = (uint16_t)(rb >> 16);
  lo = (uint16_t)(lb >> 16);  // exact: lo has at most 8 significant bits
}

__device__ __forceinline__ uint4 pack8(const uint16_t* h) {
  return make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                    h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
}

// 8 consecutive elements from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *(const float4*)p, b = *(const float4*)(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const uint16_t* p, uint16_t* x) {
  const uint4 a = *(const uint4*)p;
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = (uint16_t)(w[e] & 0xFFFFu);
    x[2 * e + 1] = (uint16_t)(w[e] >> 16);
  }
}

// The planes of a float32 (the split) or of a bf16 (the same value three
// times: the other operand of a product over stacked planes).
struct Split {
  using In = float;
  static __device__ __forceinline__ void pieces(float g, uint16_t& lo, uint16_t& mid, uint16_t& hi) {
    split(g, lo, mid, hi);
  }
};

struct Repeat {
  using In = uint16_t;
  static __device__ __forceinline__ void pieces(uint16_t x, uint16_t& lo, uint16_t& mid, uint16_t& hi) {
    lo = mid = hi = x;
  }
};

// Units of V elements: a thread handles one unit (o, j, s) of the output.
template <int V, class Op>
__global__ void __launch_bounds__(THREADS) planes_kernel(const typename Op::In* __restrict__ g,
                                                        uint16_t* __restrict__ out,
                                                        long long outer, long long n,
                                                        long long seg, long long chunks) {
  using In = typename Op::In;
  const long long segv = seg / V, units = chunks * outer * segv;
  for (long long u = blockIdx.x * (long long)THREADS + threadIdx.x; u < units;
       u += (long long)gridDim.x * THREADS) {
    const long long run = u / segv, s = (u - run * segv) * V;  // run = j * outer + o
    const long long j = run / outer, o = run - j * outer, k = j * seg + s;
    uint16_t* dst = out + run * 3 * seg + s;
    if (V == 8) {
      In x[8];
      if (k < n) {  // n and seg are multiples of 8: a unit is all in or all out
        load8(g + o * n + k, x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = In(0);
      }
      uint16_t lo[8], mid[8], hi[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) Op::pieces(x[e], lo[e], mid[e], hi[e]);
      *(uint4*)dst = pack8(lo);
      *(uint4*)(dst + seg) = pack8(mid);
      *(uint4*)(dst + 2 * seg) = pack8(hi);
    } else {
      uint16_t lo, mid, hi;
      Op::pieces(k < n ? g[o * n + k] : In(0), lo, mid, hi);
      dst[0] = lo;
      dst[seg] = mid;
      dst[2 * seg] = hi;
    }
  }
}

unsigned blocks_for(long long units) {
  const long long b = (units + THREADS - 1) / THREADS;
  return (unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <class Op>
int launch(const void* g, void* out, long long outer, long long n, long long seg,
           long long chunks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (outer * seg * chunks == 0) return 0;
  const bool vec = n % 8 == 0 && seg % 8 == 0 && ((uintptr_t)g % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  using In = typename Op::In;
  if (vec) {
    planes_kernel<8, Op><<<blocks_for(chunks * outer * (seg / 8)), THREADS, 0, s>>>(
        (const In*)g, (uint16_t*)out, outer, n, seg, chunks);
  } else {
    planes_kernel<1, Op><<<blocks_for(chunks * outer * seg), THREADS, 0, s>>>(
        (const In*)g, (uint16_t*)out, outer, n, seg, chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g: (outer, n) float32, contiguous; out: (chunks, outer, 3, seg) bf16 (as
// uint16), chunks * seg >= n: the planes (lo, mid, hi).
int split_bf16x3(const void* g, void* out, long long outer, long long n, long long seg,
                 long long chunks, void* stream) {
  return launch<Split>(g, out, outer, n, seg, chunks, stream);
}

// x: (outer, n) bf16, contiguous; out as above: x's chunk three times.
int repeat_bf16x3(const void* x, void* out, long long outer, long long n, long long seg,
                  long long chunks, void* stream) {
  return launch<Repeat>(x, out, outer, n, seg, chunks, stream);
}

}  // extern "C"
