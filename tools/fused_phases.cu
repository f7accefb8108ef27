// Where the time of kernels A and B goes: a clock64() probe of their phases.
//
//   python3 tools/fused_phases.py            (on a machine with an H100 and nvcc)
//
// tools/fused_phases.py builds this file twice into shared libraries: once
// against the kernels' sources in src/repro_torch/csrc, and once against the
// sources of commit e9a9ea2 (the one-block-per-update kernels), into which it
// inserts the same markers at the same phase boundaries.  Built with
// -DFUSED_PHASES, the kernels' FUSED_MARK(id) markers (empty in the package's
// own build) call fp_mark below: thread 0 of blocks 0 and 1 adds the clock64()
// cycles since the previous marker to phase id, after a barrier of the block,
// so a phase's count is the time the block spent in it, barriers included
// (block 1 is update 0's second block when an update runs on a cluster).  The
// script makes the inputs (chip_smoke.py's kind), runs each kernel at the
// headline shapes, and prints cycles and microseconds per phase beside the
// launch's CUDA-event time.
//
// Phases: 0 projections (A: the structured products and splits; B: the Brand
// projections and residuals), 1 the secular set-up (groups, Householder merge,
// deflation), 2 brackets and the secular iteration, 3 Loewner zhat, column
// norms and the stable rank, 4 a phase's rotation phi = hh @ qt and the
// chain's phi1^T z2w, 5 the right side's compression, 6 bv and the sign fix,
// 7 the rotations and outputs, 8 everything else (flips and copies between
// phases), 9 each chain's G = phi1 @ flip2(phib), 10 the team's wait for its
// other blocks at the end of a phase.
#include <cuda_runtime.h>

// [0, 16): block 0, [16, 32): block 1 (the second block of update 0's
// cluster when the update runs on more than one block)
__device__ unsigned long long fp_acc[32];
__device__ unsigned int fp_cnt[32];
__device__ long long fp_last[2];

__device__ __forceinline__ void fp_start() {
  __syncthreads();
  if (blockIdx.x < 2 && threadIdx.x == 0) fp_last[blockIdx.x] = clock64();
}

__device__ __forceinline__ void fp_mark(int id) {
  __syncthreads();
  if (blockIdx.x < 2 && threadIdx.x == 0) {
    const long long t = clock64();
    fp_acc[16 * blockIdx.x + id] += (unsigned long long)(t - fp_last[blockIdx.x]);
    fp_cnt[16 * blockIdx.x + id] += 1;
    fp_last[blockIdx.x] = t;
  }
}

#define FUSED_MARK_START() fp_start()
#define FUSED_MARK(id) fp_mark(id)

#include "fused_update.cuh"

extern "C" {

FULL_ENTRY(fused_update_f32, float, float)
FULL_ENTRY(fused_update_f64, double, double)
TRUNC_ENTRY(fused_update_truncated_f32, float, float)
TRUNC_ENTRY(fused_update_truncated_f64, double, double)

// The scratch elements of a launch (kind 0: full, 1: truncated) and its
// blocks per update, for either build.
#ifdef PLAN_ENTRIES
long long probe_scratch(int kind, int dbl, int B, int m, int n, int r, long long* csz) {
  long long out[5];
  if (dbl) plan_entry<double, double>(kind, B, m, n, r, out);
  else plan_entry<float, float>(kind, B, m, n, r, out);
  *csz = out[0];
  return out[3];
}
#else
SCRATCH_ENTRIES
long long probe_scratch(int kind, int dbl, int B, int m, int n, int r, long long* csz) {
  *csz = 1;
  return B * (kind == 0 ? fused_full_scratch_elems(m, n) : fused_trunc_scratch_elems(m, n, r));
}
#endif

// Copies the per-phase cycles and marker counts out and zeroes them.
int fused_phases_read(unsigned long long* acc, unsigned int* cnt) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(acc, fp_acc, sizeof(unsigned long long) * 32);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cnt, fp_cnt, sizeof(unsigned int) * 32);
  unsigned long long z[32] = {0};
  unsigned int zc[32] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fp_acc, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fp_cnt, zc, sizeof(zc));
  return (int)e;
}

// The SM clock the cycles are converted with, in kHz (the card's maximum).
int fused_phases_clock_khz() {
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  return khz;
}

}  // extern "C"
