// Sorted-table membership probe for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/member_probe.py
// (member_probe_pallas): out[i] = (q_hi[i], q_lo[i]) is a row of the table
// (t_hi, t_lo), with (-1, -1) as the pad on both sides.
//
// Precondition: the table is sorted lexicographically by (hi, lo) with its
// (-1, -1) pads at the tail. Every caller in the engine passes such a table
// (the partition edge list, the dedup_rows drop tables, the delete table).
// The TPU kernel compares every query with every table row, O(N*M); at the
// engine's shapes that is ~1e12 compares per call, so this kernel does one
// lexicographic binary search per query instead, O(N log M), with the same
// predicate as the plain version (pads remapped to INT_MAX, position clipped
// to the last row).
//
// Bound: bytes. Each query reads 8 bytes and writes 1; the table is read
// log2(M) times per query but stays in shared memory (M <= kSmemRows, the
// whole per-partition edge table at e_cap = 8192) or in L2 (the candidate
// drop tables, ~1 MB). One thread per query, grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemRows = 8192;  // 8192 pairs = 64 KiB of shared memory
constexpr int kBig = 0x7fffffff;

__device__ __forceinline__ void load_row(const int* __restrict__ th,
                                         const int* __restrict__ tl, int j,
                                         int& h, int& l) {
  h = th[j];
  l = tl[j];
  if (h == -1 && l == -1) {  // pads sort last
    h = kBig;
    l = kBig;
  }
}

template <bool kStaged>
__global__ void member_probe_kernel(const int* __restrict__ q_hi,
                                    const int* __restrict__ q_lo,
                                    const int* __restrict__ t_hi,
                                    const int* __restrict__ t_lo, long long n,
                                    int m, bool* __restrict__ out) {
  extern __shared__ int smem[];
  const int* th = t_hi;
  const int* tl = t_lo;
  if (kStaged) {
    int* sh = smem;
    int* sl = smem + m;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      sh[j] = t_hi[j];
      sl[j] = t_lo[j];
    }
    __syncthreads();
    th = sh;
    tl = sl;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int qh = q_hi[i];
    const int ql = q_lo[i];
    int lo = 0, hi = m;
    while (lo < hi) {  // lower bound of (qh, ql)
      const int mid = (lo + hi) >> 1;
      int h, l;
      load_row(th, tl, mid, h, l);
      if (h < qh || (h == qh && l < ql)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int h, l;
    load_row(th, tl, lo < m ? lo : m - 1, h, l);
    out[i] = (h == qh) && (l == ql) && !(qh == -1 && ql == -1);
  }
}

}  // namespace

// q_hi, q_lo: [n] int32; t_hi, t_lo: [m] int32; out: [n] bool. n, m > 0.
// n is 64-bit: the store's set values alone exceed 7e8 queries per call.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int member_probe_launch(const int* q_hi, const int* q_lo,
                                   const int* t_hi, const int* t_lo,
                                   long long n, int m, bool* out,
                                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long need = (n + kThreads - 1) / kThreads;
  if (m <= kSmemRows) {
    const size_t bytes = 2 * sizeof(int) * static_cast<size_t>(m);
    cudaFuncSetAttribute(member_probe_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(2 * sizeof(int) * kSmemRows));
    // Each block stages the whole table once: keep the grid to a few
    // resident waves and let the blocks stride over the queries.
    const int blocks = static_cast<int>(need < 3 * sms ? need : 3 * sms);
    member_probe_kernel<true><<<blocks, kThreads, bytes, stream>>>(
        q_hi, q_lo, t_hi, t_lo, n, m, out);
  } else {
    const int blocks = static_cast<int>(need < 16 * sms ? need : 16 * sms);
    member_probe_kernel<false><<<blocks, kThreads, 0, stream>>>(
        q_hi, q_lo, t_hi, t_lo, n, m, out);
  }
  return static_cast<int>(cudaGetLastError());
}
