// Segment sum for Hopper (sm_90a): the GNN message-passing reduction.
//
// Replaces the TPU kernel repro/kernels/segment_sum.py
// (segment_sum_pallas): acc[s, :] += sum of data[i, :] over the rows i
// with seg[i] = s, for 0 <= s < n; rows whose id is negative or >= n are
// dropped. data: [rows, d] float32 or bfloat16, seg: [rows] int32,
// acc: [n, d] float64, summed into in place.
//
// The TPU kernel turns the scatter into a one-hot matmul per (segment
// tile x edge tile) and skips pairs by each edge tile's [min, max] id; it
// is right for unsorted ids only because that skip test is conservative.
// Here every thread owns (row, column group) pairs of the flat [rows, d]
// array in a 64-bit grid-stride loop and adds its values into acc with
// float64 atomics, so the ids need no order and the rows need no sort.
// float64, not float32: the float64 sum of m float32 (bf16) values is
// exact while their exponents span fewer than 29 - log2(m) (45 - log2(m))
// binades, so the sum, and its rounding to the output type, almost never
// depends on the order in which the atomics land. The kernel then agrees
// with the plain version (index_add_ in float64) and with itself from run
// to run; with float32 atomics the 16-layer bf16 gatedgcn forward grew
// last-bit differences into large ones (PERF.md).
// Neighbouring threads read neighbouring addresses of data and add into
// neighbouring addresses of one accumulator row. A column group is two
// values (float2 / bf16x2 loads) where d is even and the rows are aligned
// for it, else one, so d = 70, d = 1 and d = 1433 take the same code.
// data is read with streaming loads (__ldcs) to leave L2 to acc. The
// (row, column) pair advances by the stride's quotient and remainder, so
// the loop has no division.
//
// Bound: bytes, at best data + seg read once and acc written once. acc is
// n * d * 8 bytes (1.37 GB at 2,449,029 nodes x 70), far above the 50 MB
// L2, so with random ids nearly every add touches an accumulator line that
// is not in L2; the atomics' read-modify-write traffic, not the data, sets
// the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int kVec>
struct Rows;

template <>
struct Rows<float, 1> {
  static __device__ __forceinline__ void load(const float* p, double* v) {
    v[0] = __ldcs(p);
  }
};

template <>
struct Rows<float, 2> {
  static __device__ __forceinline__ void load(const float* p, double* v) {
    const float2 f = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
};

template <>
struct Rows<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, double* v) {
    v[0] = __bfloat162float(__ldcs(p));
  }
};

template <>
struct Rows<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, double* v) {
    const float2 f =
        __bfloat1622float2(__ldcs(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = f.x;
    v[1] = f.y;
  }
};

template <typename T, int kVec>
__global__ void segment_sum_kernel(const T* __restrict__ data,
                                   const int* __restrict__ seg,
                                   long long rows, long long d, long long n,
                                   double* __restrict__ acc) {
  const long long groups = d / kVec;  // column groups per row
  const long long total = rows * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= total) return;
  // Invariant: k = i * groups + c with 0 <= c < groups, so k < total
  // implies i < rows.
  long long i = k / groups;
  long long c = k - i * groups;
  const long long di = stride / groups;
  const long long dc = stride - di * groups;
  for (; k < total; k += stride) {
    const long long s = seg[i];
    if (s >= 0 && s < n) {
      double v[kVec];
      Rows<T, kVec>::load(data + i * d + c * kVec, v);
      double* out = acc + s * d + c * kVec;
#pragma unroll
      for (int j = 0; j < kVec; ++j) atomicAdd(out + j, v[j]);
    }
    i += di;
    c += dc;
    if (c >= groups) {
      c -= groups;
      ++i;
    }
  }
}

template <typename T>
int launch(const T* data, const int* seg, long long rows, long long d,
           long long n, double* acc, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const bool vec2 = d % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(data) % (2 * sizeof(T)) == 0;
  const long long total = rows * (vec2 ? d / 2 : d);
  const long long need = (total + kThreads - 1) / kThreads;
  const long long cap = 32LL * sms;  // a few resident waves; the rest strides
  const int blocks = static_cast<int>(need < cap ? need : cap);
  if (vec2) {
    segment_sum_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(data, seg, rows,
                                                              d, n, acc);
  } else {
    segment_sum_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(data, seg, rows,
                                                              d, n, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: [rows, d] float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// seg: [rows] int32; acc: [n, d] float64, added into. rows, d, n > 0.
// All sizes are 64-bit: one GNN edge slice is 2**24 x 70 values and the
// whole edge set 8.7e9. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int segment_sum_launch(const void* data, int is_bf16,
                                  const int* seg, long long rows, long long d,
                                  long long n, double* acc,
                                  cudaStream_t stream) {
  if (is_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(data), seg, rows, d, n,
                  acc, stream);
  }
  return launch(static_cast<const float*>(data), seg, rows, d, n, acc, stream);
}
