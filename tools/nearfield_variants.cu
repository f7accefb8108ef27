// Kernel E's launch configurations, timed at the FMM's full plan on the card.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/nearfield_variants tools/nearfield_variants.cu
//   build/nearfield_variants
//
// Includes src/repro_torch/csrc/nearfield.cu and launches its templates
// directly on B = 8, R = 1024, nb = 32, 3cap = 408, capt = 136 (drive (ii)'s
// plan shape): w uniform in [-1, 1], x, av uniform in [0, 1], tau in
// [-1e-4, 1e-4], every target valid.  Each configuration is run once, checked
// against the first of its dtype (max |difference| over max |out|; all
// configurations sum the sources in the same order, so 0 is expected), then
// timed 20 times back to back with CUDA events; prints the best and mean ms
// and TFLOP/s (2 R nb 3cap capt B operations).  f64: NR 8-row tiles a warp,
// threads a block, prefetch distance; f32: RM rows and CH lanes a row group,
// threads a block, blocks an SM, prefetch distance.
#include <cstdio>

#include "../src/repro_torch/csrc/nearfield.cu"

__global__ void fill(double* a, long long n, unsigned seed, double lo, double hi) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    unsigned long long h = (i + 1) * 6364136223846793005ULL + seed * 1442695040888963407ULL;
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    a[i] = lo + (hi - lo) * ((h >> 11) * (1.0 / 9007199254740992.0));
  }
}

__global__ void to_f32(const double* a, float* b, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    b[i] = (float)a[i];
}

template <typename T>
__global__ void maxdiff(const T* a, const T* b, long long n, double* out) {
  double m = 0, s = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    m = fmax(m, fabs((double)a[i] - (double)b[i]));
    s = fmax(s, fabs((double)b[i]));
  }
  atomicMax((unsigned long long*)out, __double_as_longlong(m));  // non-negative doubles
  atomicMax((unsigned long long*)(out + 1), __double_as_longlong(s));
}

typedef int (*Launch)(const void*, const void*, const void*, const void*, const void*, void*, int,
                      int, int, int, int, cudaStream_t);

constexpr int B = 8, R = 1024, NB = 32, C3 = 408, CT = 136;

template <typename T>
void run(const char* name, Launch fn, const T* const* in, T* out, const T* ref, long long nout) {
  const int err = fn(in[0], in[1], in[2], in[3], in[4], out, B, R, NB, C3, CT, 0);
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e30f, total = 0.f;
  for (int i = 0; i < 20; ++i) {
    cudaEventRecord(e0);
    fn(in[0], in[1], in[2], in[3], in[4], out, B, R, NB, C3, CT, 0);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    best = ms < best ? ms : best;
    total += ms;
  }
  double* d;
  cudaMalloc(&d, 16);
  cudaMemset(d, 0, 16);
  maxdiff<T><<<264, 256>>>(out, ref, nout, d);
  double h[2];
  cudaMemcpy(h, d, 16, cudaMemcpyDeviceToHost);
  cudaFree(d);
  const double flops = 2.0 * B * R * NB * C3 * CT;
  printf("%s: launch %d (%s), best %.4f ms, mean %.4f ms, %.1f TFLOP/s, vs first %.2e\n", name,
         err, cudaGetErrorString(cudaGetLastError()), best, total / 20, flops / best / 1e9,
         h[0] / h[1]);
}

int main() {
  const long long nw = (long long)B * R * NB * C3, nx = (long long)B * NB * C3,
                  nt = (long long)B * NB * CT, nout = (long long)B * R * NB * CT;
  const long long sizes[5] = {nw, nx, nt, nt, nt};
  const double bounds[5][2] = {{-1, 1}, {0, 1}, {0, 1}, {-1e-4, 1e-4}, {1, 1}};
  double* in64[5];
  float* in32[5];
  for (int i = 0; i < 5; ++i) {
    cudaMalloc(&in64[i], sizes[i] * 8);
    fill<<<1024, 256>>>(in64[i], sizes[i], i + 1, bounds[i][0], bounds[i][1]);
  }
  double *out64, *ref64;
  cudaMalloc(&out64, nout * 8);
  cudaMalloc(&ref64, nout * 8);
  const Launch f64[] = {launch_f64<2, 512, 2>, launch_f64<2, 512, 1>, launch_f64<2, 384, 2>,
                        launch_f64<2, 384, 1>, launch_f64<4, 256, 1>, launch_f64<1, 512, 2>};
  const char* f64_names[] = {"f64 NR2 T512 PF2", "f64 NR2 T512 PF1", "f64 NR2 T384 PF2",
                             "f64 NR2 T384 PF1", "f64 NR4 T256 PF1", "f64 NR1 T512 PF2"};
  f64[0](in64[0], in64[1], in64[2], in64[3], in64[4], ref64, B, R, NB, C3, CT, 0);
  for (int i = 0; i < 6; ++i) run<double>(f64_names[i], f64[i], in64, out64, ref64, nout);
  for (int i = 0; i < 5; ++i) {
    cudaMalloc(&in32[i], sizes[i] * 4);
    to_f32<<<1024, 256>>>(in64[i], in32[i], sizes[i]);
  }
  cudaDeviceSynchronize();
  for (int i = 0; i < 5; ++i) cudaFree(in64[i]);
  cudaFree(out64);
  cudaFree(ref64);
  float *out32, *ref32;
  cudaMalloc(&out32, nout * 4);
  cudaMalloc(&ref32, nout * 4);
  const Launch f32[] = {launch_f32<4, 4, 256, 2, 1>, launch_f32<4, 4, 512, 1, 1>,
                        launch_f32<2, 1, 256, 1, 1>, launch_f32<2, 2, 256, 2, 1>};
  const char* f32_names[] = {"f32 RM4 CH4 T256 2/SM PF1", "f32 RM4 CH4 T512 1/SM PF1",
                             "f32 RM2 CH1 T256 1/SM PF1", "f32 RM2 CH2 T256 2/SM PF1"};
  f32[0](in32[0], in32[1], in32[2], in32[3], in32[4], ref32, B, R, NB, C3, CT, 0);
  for (int i = 0; i < 4; ++i) run<float>(f32_names[i], f32[i], in32, out32, ref32, nout);
  return 0;
}
