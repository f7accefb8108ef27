// Kernel F: COO sparse projection, with the bucketing by destination row on
// the card.
//
//   out[b, r, :] = sum over entries e with rows[b, e] == r of vals[b, e] * mat[b, cols[b, e], :]
//
// i.e. out = S @ mat for a static-nnz COO matrix S (swap rows and cols for
// S^T @ mat).  Duplicate coordinates accumulate; padding entries (0, 0, 0.0)
// add zero; an entry whose row or column lies out of range is dropped.
// Replaces repro/kernels/sparse_proj.py: sparse_project_pallas_batched (and
// sparse_project_pallas, which is this kernel at B = 1).
//
// What bounds it on an H100: bytes, and at the shapes the sketch gives it,
// launches and the host.  Each entry's (row, col, val) is read once, the rows
// of mat it gathers (from L2 after first touch) and out once, at 2 operations
// per gathered element; at the sketch's shape (1024 x 1024, nnz 10485, k 16,
// f64) that is about 0.4 MB, or 0.13 us at 3.35 TB/s, far below the cost of
// one launch (a few us), so the number of launches, the device's latencies
// and the host's work per call decide the time.
//
// Design.  The TPU kernel walks nnz in an in-order grid and accumulates into
// one output block that stays in VMEM across grid steps; Hopper runs blocks in
// no order, so that carry does not exist here.  Instead the entries are
// bucketed by destination row, and each destination row gets a group of lanes
// (8, 16 or 32, the smallest that covers k) that walks its bucket in entry
// order, accumulates in registers and writes the row once (an empty row writes
// zeros).  The bucketing is a counting sort on the card: count the entries of
// each row, scan the counts into row pointers, place each entry in its row's
// bucket with an atomic cursor (the bucket's contents are fixed, their order is
// not), then rank: an entry's place in its bucket is the number of the
// bucket's entries with a smaller index, so the final order is entry order
// whatever order the atomics took (the work is the sum of the buckets' squared
// lengths: ~10 per entry at the sketch's shape, 256 when 2048 entries share 8
// rows).  Two paths, one launch each:
//   - up to SMALL_NNZ entries (every sketch of a 1 % delta up to 1.5M cells):
//     a block owns a run of destination rows of one member, reads the member's
//     rows, keeps the entries that fall in its run and buckets them in shared
//     memory, then walks its rows.  Blocks share nothing: no scratch, no
//     barrier, the row scan is as short as the block's run;
//   - above it (32768 rows, 335544 entries), a cooperative launch: the four
//     steps over the whole grid, parted by grid-wide barriers (a counter in the
//     scratch, zeroed with the counters by cudaMemsetAsync; the cooperative
//     launch guarantees that every block is resident), the scan one chunk per
//     block, then the walk grid-stride.  Data another block wrote is read past
//     L1 (__ldcg), which is not coherent across SMs.
// The caller allocates the scratch and the kernels allocate nothing.  No
// atomics touch a value, so two launches give the same bits, and within a row
// the terms are summed in entry order, as the plain version sums them (up to
// the rounding of the fused multiply-add).  Shared coordinates, values or mat
// are read at batch stride 0.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_GRID = 2048;      // room for the chunk sums in the scratch
constexpr int BAR_INTS = 4;         // the barrier counter, padded
constexpr int SMALL_NNZ = 24576;    // the largest nnz of the row-block path
constexpr int SMEM_OPTIN = 232448;  // shared memory a block may opt in to on sm_90

// Batch flags of the C entry points: which operands carry a member per batch
// member (else the batch shares one, read at stride 0), and whether to walk.
constexpr int ROWS_BATCHED = 1, COLS_BATCHED = 2, VALS_BATCHED = 4, MAT_BATCHED = 8, WALK = 16;

int lane_group(int K) { return K <= 8 ? 8 : K <= 16 ? 16 : 32; }

// The cooperative path's scratch, in ints: rowptr M (R + 1) | perm M nnz |
// barrier | counters M (R + 1) | chunk sums MAX_GRID | unsorted buckets M nnz.
// Positions and entry indices are global over the members (entry m nnz + e).
// The row-block path writes the same rowptr and perm when asked for the
// bucketing alone.
struct Scratch {
  int* rowptr;
  int* perm;
  unsigned int* bar;
  int* cnt;
  int* part;
  int* tmp;
  __host__ __device__ Scratch(int* s, long long members, int nnz, int R)
      : rowptr(s),
        perm(rowptr + members * (R + 1)),
        bar(reinterpret_cast<unsigned int*>(perm + members * nnz)),
        cnt(perm + members * nnz + BAR_INTS),
        part(cnt + members * (R + 1)),
        tmp(part + MAX_GRID) {}
};

__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(bar) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Sum over the block; every thread gets it.
__device__ int block_sum(int v) {
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  return total;
}

// Exclusive prefix of v over the threads of the block.
__device__ int block_exclusive(int v) {
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + incl - v;
}

// Prefetch this block's share (by blockIdx.x) of [p, p + bytes) into L2.
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  const char* c = static_cast<const char*>(p);
  for (long long o = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * 128; o < bytes;
       o += static_cast<long long>(gridDim.x) * THREADS * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
}

template <bool CG>
__device__ __forceinline__ int load_index(const int* p) {
  return CG ? __ldcg(p) : *p;
}

// One destination row: lanes stride the k columns and walk the bucket
// pm[start, end) in order; entry indices are offset by e_base.  The group's
// lanes load the (column, value) of up to ``group`` entries at once and pass
// them round by shuffles, eight at a time, so eight gathers are in flight
// together; the sum still runs in entry order.  CG: pm was written by other
// blocks of this launch.
template <typename T, bool CG>
__device__ __forceinline__ void walk_row(const int* pm, int start, int end, int e_base,
                                         const int* __restrict__ cl, const T* __restrict__ vl,
                                         const T* __restrict__ mt, T* o, int S, int K, int lane,
                                         int group) {
  const unsigned int mask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1) << ((threadIdx.x & 31) & ~(group - 1));
  for (int c0 = 0; c0 < K; c0 += group) {
    const int c = c0 + lane;
    T acc = T(0);
    for (int p0 = start; p0 < end; p0 += group) {
      const int n = min(group, end - p0);
      int src = -1;
      T v = T(0);
      if (lane < n) {
        const int e = load_index<CG>(pm + p0 + lane) - e_base;
        src = cl[e];
        v = vl[e];
      }
      // eight entries at a time: their gathers all issued before the sum
      for (int j0 = 0; j0 < n; j0 += 8) {
        int sj[8];
        T vj[8], mj[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sj[j] = __shfl_sync(mask, src, j0 + j, group);
          vj[j] = __shfl_sync(mask, v, j0 + j, group);
        }
        bool use[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          use[j] = j0 + j < n && c < K && (unsigned)sj[j] < (unsigned)S;
          mj[j] = use[j] ? mt[(long long)sj[j] * K + c] : T(0);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (use[j]) acc += vj[j] * mj[j];
      }
    }
    if (c < K) o[c] = acc;
  }
}

// The row-block path: block (x, y) owns destination rows [r0, r0 + THREADS /
// group) of batch member y.  Shared memory: starts and cursors (rows + 1 each),
// the block's entries as found and then in entry order, and as bucketed in any
// order (nnz each).  bucket_out, when given, receives the bucketing in the
// scratch layout (positions from the number of the member's entries in lower
// rows) and the walk is skipped.
template <typename T>
__global__ void __launch_bounds__(THREADS)
row_block_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const T* __restrict__ vals, const T* __restrict__ mat, T* __restrict__ out,
                 int* __restrict__ bucket_out, int M, int nnz, int R, int S, int K, int group,
                 long long rows_stride, long long cols_stride, long long vals_stride,
                 long long mat_stride) {
  extern __shared__ int sm[];
  __shared__ int n_mine;
  const int rpb = THREADS / group;
  const int r0 = blockIdx.x * rpb;
  const int nr = min(rpb, R - r0);
  const long long b = blockIdx.y;
  const int* rw = rows + b * rows_stride;
  int* start = sm;               // nr + 1
  int* cur = start + rpb + 1;    // nr + 1
  int* found = cur + rpb + 1;    // nnz
  int* tmp = found + nnz;        // nnz

  for (int r = threadIdx.x; r <= rpb; r += THREADS) start[r] = 0;
  if (threadIdx.x == 0) n_mine = 0;
  __syncthreads();
  // the walk's operands of this member, a share per block, into L2 while the
  // block scans the rows
  if (bucket_out == nullptr) {
    prefetch_l2(cols + b * cols_stride, (long long)nnz * sizeof(int));
    prefetch_l2(vals + b * vals_stride, (long long)nnz * sizeof(T));
    prefetch_l2(mat + b * mat_stride, (long long)S * K * sizeof(T));
  }
  // the member's rows, four neighbouring entries at a time (one 16-byte load
  // where they are aligned), all of a thread's loads (up to eight) issued
  // before any is used: every block reads them all, so this pass sets the
  // block's pace.  Each block starts at its own place in them, so that the
  // blocks do not ask L2 for the same lines at once.
  int below = 0;
  const bool quads = reinterpret_cast<unsigned long long>(rw) % 16 == 0;
  const int nq = (nnz + 3) / 4;
  const int rot = (int)(((long long)blockIdx.x * nq) / gridDim.x);
  for (int qb = threadIdx.x; qb < nq; qb += 8 * THREADS) {
    int rr[8][4], e0[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = qb + i * THREADS;
      e0[i] = 4 * (q + rot < nq ? q + rot : q + rot - nq);
      rr[i][0] = rr[i][1] = rr[i][2] = rr[i][3] = -1;
      if (q >= nq) continue;
      if (quads && e0[i] + 3 < nnz) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(rw + e0[i]));
        rr[i][0] = v.x, rr[i][1] = v.y, rr[i][2] = v.z, rr[i][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) rr[i][j] = e0[i] + j < nnz ? rw[e0[i] + j] : -1;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rr[i][j] - r0;
        if ((unsigned)r < (unsigned)nr) {
          atomicAdd(&start[r], 1);
          found[atomicAdd(&n_mine, 1)] = e0[i] + j;
        } else if (r < 0 && rr[i][j] >= 0) {
          ++below;
        }
      }
  }
  __syncthreads();
  const int mine = n_mine;
  const int count = threadIdx.x <= nr ? start[threadIdx.x] : 0;  // start[nr] is 0
  const int first = block_exclusive(count);
  if (threadIdx.x <= nr) {
    start[threadIdx.x] = first;
    cur[threadIdx.x] = first;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < mine; i += THREADS) {
    const int e = found[i];
    tmp[atomicAdd(&cur[rw[e] - r0], 1)] = e;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < mine; p += THREADS) {
    const int e = tmp[p];
    const int r = rw[e] - r0;
    const int lo = start[r], hi = start[r + 1];
    int rank = 0;
#pragma unroll 4
    for (int q = lo; q < hi; ++q) rank += tmp[q] < e;
    found[lo + rank] = e;
  }
  __syncthreads();

  if (bucket_out != nullptr) {
    const int base = (int)(b * nnz) + block_sum(below);
    int* rowptr = bucket_out + b * (R + 1);
    int* perm = bucket_out + (long long)M * (R + 1);
    for (int r = threadIdx.x; r <= nr; r += THREADS)
      if (r < nr || r0 + nr == R) rowptr[r0 + r] = base + start[r];
    for (int p = threadIdx.x; p < mine; p += THREADS) perm[base + p] = (int)(b * nnz) + found[p];
    return;
  }
  const int g = threadIdx.x / group;
  if (g >= nr) return;
  walk_row<T, false>(found, start[g], start[g + 1], 0, cols + b * cols_stride,
                     vals + b * vals_stride, mat + b * mat_stride,
                     out + (b * R + r0 + g) * (long long)K, S, K, threadIdx.x % group, group);
}

// The cooperative path: the bucketing of all M members over the grid, then
// the walk of all B members.
template <typename T>
__global__ void __launch_bounds__(THREADS)
project_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
               const T* __restrict__ vals, const T* __restrict__ mat, T* __restrict__ out,
               int* scratch, int B, int M, int nnz, int R, int S, int K, int group,
               long long rows_stride, long long cols_stride, long long vals_stride,
               long long mat_stride, int walk) {
  const Scratch sc(scratch, M, nnz, R);
  const unsigned int G = gridDim.x;
  const long long n_entries = (long long)M * nnz;
  const long long n_slots = (long long)M * (R + 1);
  const long long stride = (long long)G * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;

  // 1. counts
  for (long long i = tid; i < n_entries; i += stride) {
    const int m = (int)(i / nnz);
    const int r = rows[m * rows_stride + (i - (long long)m * nnz)];
    if ((unsigned)r < (unsigned)R) atomicAdd(&sc.cnt[(long long)m * (R + 1) + r], 1);
  }
  grid_sync(sc.bar, G);

  // 2. exclusive scan of the counts (the slot R of each member is 0, so its
  // pointer is the member's end)
  const long long chunk = (n_slots + G - 1) / G;
  const long long lo = min((long long)blockIdx.x * chunk, n_slots);
  const long long hi = min(lo + chunk, n_slots);
  const int span = (int)((chunk + THREADS - 1) / THREADS);
  const long long my_lo = min(lo + (long long)threadIdx.x * span, hi);
  const long long my_hi = min(my_lo + span, hi);
  int mine = 0;
  for (long long j = my_lo; j < my_hi; ++j) mine += __ldcg(sc.cnt + j);
  const int block_total = block_sum(mine);
  if (threadIdx.x == 0) sc.part[blockIdx.x] = block_total;
  grid_sync(sc.bar, 2 * G);
  int before = 0;
  for (unsigned int j = threadIdx.x; j < blockIdx.x; j += THREADS) before += __ldcg(sc.part + j);
  int run = block_sum(before) + block_exclusive(mine);
  for (long long j = my_lo; j < my_hi; ++j) {
    const int c = __ldcg(sc.cnt + j);
    sc.rowptr[j] = run;
    sc.cnt[j] = run;
    run += c;
  }
  grid_sync(sc.bar, 3 * G);

  // 3. placement
  for (long long i = tid; i < n_entries; i += stride) {
    const int m = (int)(i / nnz);
    const int r = rows[m * rows_stride + (i - (long long)m * nnz)];
    if ((unsigned)r < (unsigned)R) sc.tmp[atomicAdd(&sc.cnt[(long long)m * (R + 1) + r], 1)] = (int)i;
  }
  grid_sync(sc.bar, 4 * G);

  // 4. rank within each bucket
  const int placed = __ldcg(sc.rowptr + n_slots - 1);
  for (long long p = tid; p < placed; p += stride) {
    const int ei = __ldcg(sc.tmp + p);
    const int m = ei / nnz;
    const int r = rows[m * rows_stride + (ei - m * nnz)];
    const int* rp = sc.rowptr + (long long)m * (R + 1) + r;
    const int start = __ldcg(rp), end = __ldcg(rp + 1);
    int rank = 0;
#pragma unroll 4
    for (int q = start; q < end; ++q) rank += __ldcg(sc.tmp + q) < ei;
    sc.perm[start + rank] = ei;
  }
  if (!walk) return;
  grid_sync(sc.bar, 5 * G);

  // 5. the walk
  const int rows_per_block = THREADS / group;
  const int lane = threadIdx.x % group;
  const long long n_rows = (long long)B * R;
  for (long long slot = (long long)blockIdx.x * rows_per_block + threadIdx.x / group;
       slot < n_rows; slot += (long long)G * rows_per_block) {
    const int b = (int)(slot / R), r = (int)(slot - (long long)b * R);
    const int m = M > 1 ? b : 0;
    const int* rp = sc.rowptr + (long long)m * (R + 1) + r;
    walk_row<T, true>(sc.perm, __ldcg(rp), __ldcg(rp + 1), m * nnz, cols + b * cols_stride,
                      vals + b * vals_stride, mat + b * mat_stride, out + slot * K, S, K, lane,
                      group);
  }
}

// The walk alone on a bucketing laid out as sparse_project_prep gives it:
// perm (nnz) and rowptr (R + 1) per member, entry indices local to it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
walk_kernel(const int* __restrict__ perm, const int* __restrict__ rowptr,
            const int* __restrict__ cols, const T* __restrict__ vals, const T* __restrict__ mat,
            T* __restrict__ out, int nnz, int R, int S, int K, int group, int members_batched,
            long long cols_stride, long long vals_stride, long long mat_stride) {
  const int r = blockIdx.x * (THREADS / group) + threadIdx.x / group;
  if (r >= R) return;
  const long long b = blockIdx.y;
  const long long m = members_batched ? b : 0;
  const int* rp = rowptr + m * (R + 1) + r;
  walk_row<T, false>(perm + m * nnz, rp[0], rp[1], 0, cols + b * cols_stride,
                     vals + b * vals_stride, mat + b * mat_stride,
                     out + (b * R + r) * (long long)K, S, K, threadIdx.x % group, group);
}

template <typename T>
int launch_project(const void* rows, const void* cols, const void* vals, const void* mat,
                   void* out, void* scratch, int B, int nnz, int R, int S, int K, int flags,
                   cudaStream_t stream) {
  int M = flags & ROWS_BATCHED ? B : 1;
  int walk = (flags & WALK) != 0;
  int group = lane_group(K);
  long long rows_stride = flags & ROWS_BATCHED ? nnz : 0;
  long long cols_stride = flags & COLS_BATCHED ? nnz : 0;
  long long vals_stride = flags & VALS_BATCHED ? nnz : 0;
  long long mat_stride = flags & MAT_BATCHED ? (long long)S * K : 0;
  int dev = 0;
  cudaGetDevice(&dev);

  if (nnz <= SMALL_NNZ) {
    const int rpb = THREADS / group;
    const size_t smem = (2 * (rpb + 1) + 2 * (size_t)nnz) * sizeof(int);
    static bool attr_set[64] = {};
    if (dev >= 64 || !attr_set[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          row_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN - 1024);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) attr_set[dev] = true;
    }
    dim3 grid((R + rpb - 1) / rpb, walk ? B : M);
    row_block_kernel<T><<<grid, THREADS, smem, stream>>>(
        (const int*)rows, (const int*)cols, (const T*)vals, (const T*)mat, (T*)out,
        walk ? nullptr : (int*)scratch, M, nnz, R, S, K, group, rows_stride, cols_stride,
        vals_stride, mat_stride);
    return (int)cudaGetLastError();
  }

  static int max_blocks[64] = {};
  int cap = dev < 64 ? max_blocks[dev] : 0;
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, project_kernel<T>,
                                                                    THREADS, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cap = per_sm * sms < MAX_GRID ? per_sm * sms : MAX_GRID;
    if (dev < 64) max_blocks[dev] = cap;
  }
  const long long work_entries = ((long long)M * nnz + THREADS - 1) / THREADS;
  const long long work_rows = walk ? ((long long)B * R * group + THREADS - 1) / THREADS : 0;
  long long grid = work_entries > work_rows ? work_entries : work_rows;
  grid = grid < 1 ? 1 : grid > cap ? cap : grid;

  const Scratch sc((int*)scratch, M, nnz, R);
  cudaError_t err =
      cudaMemsetAsync(sc.bar, 0, (BAR_INTS + (size_t)M * (R + 1)) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&rows, &cols, &vals, &mat, &out, &scratch, &B, &M, &nnz, &R, &S, &K, &group,
                  &rows_stride, &cols_stride, &vals_stride, &mat_stride, &walk};
  err = cudaLaunchCooperativeKernel((const void*)project_kernel<T>, dim3((unsigned)grid),
                                    dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_walk(const void* perm, const void* rowptr, const void* cols, const void* vals,
                const void* mat, void* out, int B, int nnz, int R, int S, int K, int flags,
                cudaStream_t stream) {
  const int group = lane_group(K);
  const int rows_per_block = THREADS / group;
  dim3 grid((R + rows_per_block - 1) / rows_per_block, B);
  walk_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const int*)perm, (const int*)rowptr, (const int*)cols, (const T*)vals, (const T*)mat,
      (T*)out, nnz, R, S, K, group, (flags & ROWS_BATCHED) != 0,
      flags & COLS_BATCHED ? nnz : 0, flags & VALS_BATCHED ? nnz : 0,
      flags & MAT_BATCHED ? (long long)S * K : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The bucketing and the walk.  flags: ROWS_BATCHED (rows carry a member per
// batch member, else one shared), COLS_, VALS_, MAT_BATCHED likewise, WALK (else
// only the bucketing, rowptr and perm at the head of the scratch).  The
// row-block path's walk (nnz <= SMALL_NNZ) takes no scratch.
int sparse_project_f32(const void* rows, const void* cols, const void* vals, const void* mat,
                       void* out, void* scratch, int B, int nnz, int R, int S, int K, int flags,
                       void* stream) {
  return launch_project<float>(rows, cols, vals, mat, out, scratch, B, nnz, R, S, K, flags,
                               (cudaStream_t)stream);
}

int sparse_project_f64(const void* rows, const void* cols, const void* vals, const void* mat,
                       void* out, void* scratch, int B, int nnz, int R, int S, int K, int flags,
                       void* stream) {
  return launch_project<double>(rows, cols, vals, mat, out, scratch, B, nnz, R, S, K, flags,
                                (cudaStream_t)stream);
}

// The walk alone, on a bucketing laid out as sparse_project_prep gives it
// (a member of its own per batch member when ROWS_BATCHED).
int sparse_walk_f32(const void* perm, const void* rowptr, const void* cols, const void* vals,
                    const void* mat, void* out, int B, int nnz, int R, int S, int K, int flags,
                    void* stream) {
  return launch_walk<float>(perm, rowptr, cols, vals, mat, out, B, nnz, R, S, K, flags,
                            (cudaStream_t)stream);
}

int sparse_walk_f64(const void* perm, const void* rowptr, const void* cols, const void* vals,
                    const void* mat, void* out, int B, int nnz, int R, int S, int K, int flags,
                    void* stream) {
  return launch_walk<double>(perm, rowptr, cols, vals, mat, out, B, nnz, R, S, K, flags,
                             (cudaStream_t)stream);
}

// Scratch ints a call needs for M coordinate members: none on the row-block
// path's walk, else the layout of Scratch.
long long sparse_scratch_ints(int M, int nnz, int R, int walk) {
  if (walk && nnz <= SMALL_NNZ) return 0;
  return BAR_INTS + MAX_GRID + 2LL * M * (R + 1) + 2LL * M * nnz;
}

}  // extern "C"
