// Kernel F: COO sparse projection.
//
//   out[b, r, :] = sum over entries e with rows[b, e] == r of vals[b, e] * mat[b, cols[b, e], :]
//
// i.e. out = S @ mat for a static-nnz COO matrix S (swap rows and cols for
// S^T @ mat).  Duplicate coordinates accumulate; padding entries (0, 0, 0.0)
// add zero.  Replaces repro/kernels/sparse_proj.py: sparse_project_pallas_batched
// (and sparse_project_pallas, which is this kernel at B = 1).
//
// What bounds it on an H100: bytes.  Each entry's (row, col, val) is read once,
// the rows of mat it gathers (from L2 after first touch) and out once, at 2
// operations per gathered element; at the sketch's shape (1024 x 1024, nnz
// 10485, k 16, f64) that is about 0.4 MB, or 0.13 us at 3.35 TB/s, so a launch
// (a few us) costs more than the work.
//
// Design.  The TPU kernel walks nnz in an in-order grid and accumulates into
// one output block that stays in VMEM across grid steps; Hopper runs blocks in
// no order, so that carry does not exist here.  Instead the wrapper sorts the
// entries stably by destination row (a permutation and row pointers: index
// bookkeeping in PyTorch, outside this kernel), and the kernel gives each
// destination row a group of lanes (8, 16 or 32, the smallest that covers k,
// chosen by the wrapper).  The lanes stride the k columns, walk that row's
// entries in their original order, accumulate in registers and write the row
// once; an empty row writes zeros.  No atomics: the result is the same from
// run to run, and within a row the terms are summed in entry order, as the
// plain version sums them (up to the rounding of the fused multiply-add).
// The batch is the grid's y axis; shared coordinates, values or mat are read
// with a batch stride of 0.  The kernel allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
sparse_proj_kernel(const int* __restrict__ perm, const int* __restrict__ rowptr,
                   const int* __restrict__ cols, const T* __restrict__ vals,
                   const T* __restrict__ mat, T* __restrict__ out, int R, int K, int group,
                   long long coord_stride, long long rowptr_stride, long long vals_stride,
                   long long mat_stride) {
  const int lane = threadIdx.x % group;
  const int r = blockIdx.x * (THREADS / group) + threadIdx.x / group;
  if (r >= R) return;
  const long long b = blockIdx.y;
  const int* pm = perm + b * coord_stride;
  const int* cl = cols + b * coord_stride;
  const int* rp = rowptr + b * rowptr_stride;
  const T* vl = vals + b * vals_stride;
  const T* mt = mat + b * mat_stride;
  T* o = out + (b * R + r) * (long long)K;
  const int start = rp[r];
  const int end = rp[r + 1];
  for (int c = lane; c < K; c += group) {
    T acc = T(0);
    for (int p = start; p < end; ++p) {
      const int e = pm[p];
      acc += vl[e] * mt[(long long)cl[e] * K + c];
    }
    o[c] = acc;
  }
}

template <typename T>
int launch(const void* perm, const void* rowptr, const void* cols, const void* vals,
           const void* mat, void* out, int B, int R, int K, int group, long long coord_stride,
           long long rowptr_stride, long long vals_stride, long long mat_stride, void* stream) {
  const int rows_per_block = THREADS / group;
  dim3 grid((R + rows_per_block - 1) / rows_per_block, B);
  sparse_proj_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)perm, (const int*)rowptr, (const int*)cols, (const T*)vals, (const T*)mat,
      (T*)out, R, K, group, coord_stride, rowptr_stride, vals_stride, mat_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sparse_project_f32(const void* perm, const void* rowptr, const void* cols, const void* vals,
                       const void* mat, void* out, int B, int R, int K, int group,
                       long long coord_stride, long long rowptr_stride, long long vals_stride,
                       long long mat_stride, void* stream) {
  return launch<float>(perm, rowptr, cols, vals, mat, out, B, R, K, group, coord_stride,
                       rowptr_stride, vals_stride, mat_stride, stream);
}

int sparse_project_f64(const void* perm, const void* rowptr, const void* cols, const void* vals,
                       const void* mat, void* out, int B, int R, int K, int group,
                       long long coord_stride, long long rowptr_stride, long long vals_stride,
                       long long mat_stride, void* stream) {
  return launch<double>(perm, rowptr, cols, vals, mat, out, B, R, K, group, coord_stride,
                        rowptr_stride, vals_stride, mat_stride, stream);
}

}  // extern "C"
