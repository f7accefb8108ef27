// The f64 mma.sync shapes of sm_90a: the fragment layouts kernel E relies on,
// and each shape's throughput.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/dmma_probe tools/dmma_probe.cu
//   build/dmma_probe
//
// For m8n8k4, m16n8k4, m16n8k8 and m16n8k16 (f64 in, f64 accumulate) it
// fills A and B in the layout assumed below, runs one product on one warp and
// counts the entries of D that differ from the product on the host; then it
// times 264 blocks issuing eight independent products a warp, 4096 times,
// at 128, 256 and 512 threads a block, and prints TFLOP/s.
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cuda_runtime.h>

// assumed layouts (g = lane>>2, t = lane&3)
// m8n8k4 : a0(g,t)            b0(t,g)          c0(g,2t) c1(g,2t+1)
// m16n8k4: a0(g,t) a1(g+8,t)  b0(t,g)          c0(g,2t) c1(g,2t+1) c2(g+8,2t) c3(g+8,2t+1)
// m16n8k8: a0(g,t) a1(g+8,t) a2(g,t+4) a3(g+8,t+4)   b0(t,g) b1(t+4,g)
// m16n8k16: a_{2j}(g,t+4j) a_{2j+1}(g+8,t+4j)        b_j(t+4j,g)

template <int SHAPE> struct Mma;
template <> struct Mma<0> {  // m8n8k4
  static constexpr int M = 8, K = 4, NA = 1, NB = 1, NC = 2;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                 : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
  }
};
template <> struct Mma<1> {  // m16n8k4
  static constexpr int M = 16, K = 4, NA = 2, NB = 1, NC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};
template <> struct Mma<2> {  // m16n8k8
  static constexpr int M = 16, K = 8, NA = 4, NB = 2, NC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};
template <> struct Mma<3> {  // m16n8k16
  static constexpr int M = 16, K = 16, NA = 8, NB = 4, NC = 4;
  __device__ static void run(double* d, const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                   "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

template <int S>
__device__ void a_coord(int lane, int i, int& r, int& c) {
  int g = lane >> 2, t = lane & 3;
  if (S == 0) { r = g; c = t; return; }
  r = g + 8 * (i & 1); c = t + 4 * (i >> 1);
}
template <int S>
__device__ void b_coord(int lane, int i, int& r, int& c) {
  int g = lane >> 2, t = lane & 3;
  r = t + 4 * i; c = g;
}
template <int S>
__device__ void c_coord(int lane, int i, int& r, int& c) {
  int g = lane >> 2, t = lane & 3;
  r = g + 8 * (i >> 1); c = 2 * t + (i & 1);
}

template <int S>
__global__ void layout_kernel(const double* A, const double* B, double* D) {
  using T = Mma<S>;
  int lane = threadIdx.x;
  double a[8], b[4], d[4] = {0, 0, 0, 0};
  for (int i = 0; i < T::NA; ++i) { int r, c; a_coord<S>(lane, i, r, c); a[i] = A[r * T::K + c]; }
  for (int i = 0; i < T::NB; ++i) { int r, c; b_coord<S>(lane, i, r, c); b[i] = B[r * 8 + c]; }
  T::run(d, a, b);
  for (int i = 0; i < T::NC; ++i) { int r, c; c_coord<S>(lane, i, r, c); D[r * 8 + c] = d[i]; }
}

template <int S>
__global__ void tput_kernel(double* out, int iters) {
  using T = Mma<S>;
  double a[8], b[4], d[8][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) d[j][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) T::run(d[j], a, b);
  }
  double s = 0;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) s += d[j][i];
  if (s == 12345.678) out[0] = s;
}

template <int S>
bool check_layout(const char* name) {
  using T = Mma<S>;
  const int M = T::M, K = T::K;
  double hA[16 * 16], hB[16 * 8], hD[16 * 8], ref[16 * 8];
  for (int i = 0; i < M * K; ++i) hA[i] = (double)((i * 37) % 101) - 50.0;
  for (int i = 0; i < K * 8; ++i) hB[i] = (double)((i * 53) % 97) - 48.0;
  for (int r = 0; r < M; ++r)
    for (int c = 0; c < 8; ++c) {
      double s = 0;
      for (int k = 0; k < K; ++k) s += hA[r * K + k] * hB[k * 8 + c];
      ref[r * 8 + c] = s;
    }
  double *dA, *dB, *dD;
  cudaMalloc(&dA, sizeof hA); cudaMalloc(&dB, sizeof hB); cudaMalloc(&dD, sizeof hD);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  cudaMemset(dD, 0, sizeof hD);
  layout_kernel<S><<<1, 32>>>(dA, dB, dD);
  cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(hD, dD, sizeof hD, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < M * 8; ++i) bad += hD[i] != ref[i];
  printf("layout %s: err=%s mismatches %d of %d\n", name, cudaGetErrorString(e), bad, M * 8);
  if (bad) {
    printf("  got  :"); for (int i = 0; i < M * 8; ++i) printf(" %g", hD[i]); printf("\n");
    printf("  want :"); for (int i = 0; i < M * 8; ++i) printf(" %g", ref[i]); printf("\n");
  }
  cudaFree(dA); cudaFree(dB); cudaFree(dD);
  return bad == 0;
}

template <int S>
void tput(const char* name, int blocks, int threads) {
  using T = Mma<S>;
  double* out; cudaMalloc(&out, 8);
  int iters = 4096;
  tput_kernel<S><<<blocks, threads>>>(out, 16);
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  tput_kernel<S><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double flops = 2.0 * T::M * 8 * T::K * 8.0 * iters * (blocks * threads / 32);
  printf("tput %s blocks %d threads %d: %.3f ms, %.2f TFLOP/s (%s)\n", name, blocks, threads, ms,
         flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  check_layout<0>("m8n8k4");
  check_layout<1>("m16n8k4");
  check_layout<2>("m16n8k8");
  check_layout<3>("m16n8k16");
  for (int th : {128, 256, 512}) {
    tput<0>("m8n8k4", 132 * 2, th);
    tput<1>("m16n8k4", 132 * 2, th);
    tput<2>("m16n8k8", 132 * 2, th);
    tput<3>("m16n8k16", 132 * 2, th);
  }
  return 0;
}
