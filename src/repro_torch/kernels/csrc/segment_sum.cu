// Segment sum for Hopper (sm_90a): the GNN message-passing reduction.
//
// Replaces the TPU kernel repro/kernels/segment_sum.py
// (segment_sum_pallas): acc[s, :] += sum of data[i, :] over the rows i
// with seg[i] = s, for 0 <= s < n; rows whose id is negative or >= n are
// dropped. data: [rows, d] float32 or bfloat16, acc: [n, d] float64,
// summed into in place.
//
// The TPU kernel takes sorted ids and turns the scatter into a one-hot
// matmul per (segment tile x edge tile), skipping the pairs whose
// [min, max] ids cannot meet. Here the ids arrive as a segment plan
// (segment_sum.py SegmentPlan), built once per set of ids: `order`, a
// stable argsort of the ids (null when they are already ascending), and
// `offsets`, where segment s owns the sorted rows [offsets[s],
// offsets[s + 1]). The kernel covers the segments [lo, hi) that have rows:
//
//   acc[s, :] += sum_{j in [offsets[s], offsets[s+1])} data[order[j], :]
//
// with order[j] = j when order is null. Ids outside [0, n) sort before
// offsets[0] or after offsets[n], so no thread reads them.
//
// One thread owns one (segment, column group) and sums its rows, in
// sorted order, in float64 registers; it adds into acc once. There are no
// atomics: the result is the same from run to run, and acc rows outside
// [lo, hi), or of segments without rows, are not touched. Column groups
// are the fastest axis across a warp's lanes, so a warp reads whole rows:
// with order null the rows of a segment are contiguous and every read is
// coalesced. A column group is two values (float2 / bf16x2 loads) where d
// is even and data is aligned for it, which keeps every row aligned after
// an order gather; else one (d = 3, 5, 1,433). The row loop keeps kUnroll
// loads in flight before it adds them.
//
// Long segments (a hub, or half the rows in one id) would serialise on
// their owner, so the plan lists each segment of more than `chunk` rows
// (CHUNK_ROWS, 256) as `heavy` with its number of parts (`parts`, a
// prefix sum, at most MAX_PARTS, 4,096, a segment; segment_sum.py). A
// part is cut into `split` pieces (more where rows are narrow, so that a
// hub of d = 1 or 3 still has enough threads), each summed like a segment
// into a float64 partial row; a second kernel adds each heavy segment's
// partials in a fixed tree, a block per (segment, 32 columns), and adds
// the total into acc once. Every add has a fixed place, so heavy segments
// repeat bit for bit too.
//
// float64, not float32: the float64 sum of m float32 (bf16) values is
// exact while their exponents span fewer than 29 - log2(m) (45 - log2(m))
// binades, so the result agrees with the plain version (index_add_ in
// float64, in another order) after its rounding to the output type.
//
// Bound: bytes. With sorted ids, data read once and contiguous, the
// offsets, and the acc rows of the touched segments read and written once
// (2.35 + 0.37 GB at a gatedgcn edge slice of 2**24 x 70 bf16 rows over
// about 332 K segments: 0.81 ms at 3.35 TB/s). With unsorted ids the rows
// are gathered through order, 140 random bytes each, and every segment's
// acc row is read and written (about 5.5 GB, 1.65 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxDevices = 64;
constexpr int kCombineCols = 32;
constexpr int kCombineThreads = 1024;

template <typename T, int kVec>
struct Rows;

template <>
struct Rows<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
};

template <>
struct Rows<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
};

template <>
struct Rows<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(__ldg(p));
  }
};

template <>
struct Rows<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const float2 f = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = f.x;
    v[1] = f.y;
  }
};

// v[0:kVec] += data[row(j), col:col + kVec] for j in [j0, j1), in order of
// j; row(j) = order[j], or j where order is null.
template <typename T, int kVec>
__device__ __forceinline__ void sum_rows(const T* __restrict__ data,
                                         const int* __restrict__ order,
                                         long long d, long long col, long long j0,
                                         long long j1, double* v) {
  const T* base = data + col;
  long long j = j0;
  for (; j + kUnroll <= j1; j += kUnroll) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = order ? static_cast<long long>(__ldg(order + j + u)) : j + u;
      Rows<T, kVec>::load(base + r * d, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] += static_cast<double>(x[u][k]);
    }
  }
  for (; j < j1; ++j) {
    const long long r = order ? static_cast<long long>(__ldg(order + j)) : j;
    float x[kVec];
    Rows<T, kVec>::load(base + r * d, x);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] += static_cast<double>(x[k]);
  }
}

struct Plan {
  const int* order;          // [rows] or null (identity)
  const long long* offsets;  // [n + 1]
  long long lo, hi;          // segments with rows
  long long chunk;           // rows a light segment may have
  const int* heavy;          // [n_heavy] segments of more than chunk rows
  const long long* parts;    // [n_heavy + 1] prefix of their part counts
  long long n_heavy, n_parts;
  long long split;           // threads per (part, column group)
};

// Items, in one grid-stride loop: first (segment, column group) for every
// segment of [lo, hi), then (part, piece, column group) for every heavy
// part cut into `split` pieces, so that narrow rows (d = 1, 3) still give
// a hub enough threads. A light segment's owner adds into acc; a piece
// writes its partial row, part * split + piece.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ data, long long d, Plan p,
                   double* __restrict__ acc, double* __restrict__ partial) {
  const long long groups = d / kVec;
  const long long light = (p.hi - p.lo) * groups;
  const long long total = light + p.n_parts * p.split * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < total; k += stride) {
    double v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) v[u] = 0.0;
    if (k < light) {
      const long long i = k / groups;
      const long long col = (k - i * groups) * kVec;
      const long long s = p.lo + i;
      const long long j0 = p.offsets[s], j1 = p.offsets[s + 1];
      if (j1 == j0 || j1 - j0 > p.chunk) continue;  // empty, or heavy: in parts
      sum_rows<T, kVec>(data, p.order, d, col, j0, j1, v);
      double* out = acc + s * d + col;
#pragma unroll
      for (int u = 0; u < kVec; ++u) out[u] += v[u];
    } else {
      const long long q = k - light;
      const long long row = q / groups;  // partial row: part * split + piece
      const long long col = (q - row * groups) * kVec;
      const long long part = row / p.split, piece = row - part * p.split;
      // the heavy segment h with parts[h] <= part < parts[h + 1]
      long long a = 0, b = p.n_heavy;
      while (b - a > 1) {
        const long long m = (a + b) >> 1;
        if (p.parts[m] <= part) a = m; else b = m;
      }
      const long long s = p.heavy[a];
      const long long j0 = p.offsets[s], j1 = p.offsets[s + 1];
      const long long np = (p.parts[a + 1] - p.parts[a]) * p.split;
      const long long per = (j1 - j0 + np - 1) / np;
      const long long r0 = j0 + ((part - p.parts[a]) * p.split + piece) * per;
      const long long r1 = r0 + per < j1 ? r0 + per : j1;
      sum_rows<T, kVec>(data, p.order, d, col, r0, r1, v);
      double* out = partial + row * d + col;
#pragma unroll
      for (int u = 0; u < kVec; ++u) out[u] = v[u];
    }
  }
}

// acc[heavy[h], c] += sum of the partial rows [parts[h] * split,
// parts[h + 1] * split), column c. A block per (h, kCombineCols columns):
// its kCombineThreads threads are lanes x columns, the lanes a power of
// two; each lane sums every lanes-th row, then a tree over the lanes adds
// them. Every add has a fixed place, so the result repeats bit for bit.
__global__ void __launch_bounds__(kCombineThreads)
segment_sum_combine(const double* __restrict__ partial, long long d, long long split,
                    const int* __restrict__ heavy, const long long* __restrict__ parts,
                    double* __restrict__ acc) {
  __shared__ double lane_sum[kCombineThreads];
  const int width = d < kCombineCols ? static_cast<int>(d) : kCombineCols;
  int lanes = 1;
  while (lanes * 2 * width <= kCombineThreads) lanes *= 2;
  const int cl = threadIdx.x % width, r = threadIdx.x / width;
  const long long h = blockIdx.x;
  const long long c = static_cast<long long>(blockIdx.y) * kCombineCols + cl;
  double v = 0.0;
  if (r < lanes && c < d) {
    const long long q1 = parts[h + 1] * split;
    for (long long q = parts[h] * split + r; q < q1; q += lanes) v += partial[q * d + c];
  }
  if (r < lanes) lane_sum[r * width + cl] = v;
  __syncthreads();
  for (int half = lanes / 2; half > 0; half /= 2) {
    if (r < half) lane_sum[r * width + cl] += lane_sum[(r + half) * width + cl];
    __syncthreads();
  }
  if (r == 0 && c < d) acc[static_cast<long long>(heavy[h]) * d + c] += lane_sum[cl];
}

int sm_count(int device) {
  static int cache[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (cache[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cache[device] = sms > 0 ? sms : 132;
  }
  return cache[device];
}

template <typename T>
int launch(const T* data, long long d, const Plan& p, double* acc, double* partial,
           int device, cudaStream_t stream) {
  const bool vec2 = d % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(data) % (2 * sizeof(T)) == 0;
  const long long groups = vec2 ? d / 2 : d;
  const long long total = (p.hi - p.lo + p.n_parts * p.split) * groups;
  const long long need = (total + kThreads - 1) / kThreads;
  const long long cap = 32LL * sm_count(device);  // a few resident waves; the rest strides
  const int blocks = static_cast<int>(need < cap ? need : cap);
  if (blocks > 0) {
    if (vec2) {
      segment_sum_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(data, d, p, acc, partial);
    } else {
      segment_sum_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(data, d, p, acc, partial);
    }
  }
  if (p.n_heavy > 0) {
    const dim3 grid(static_cast<unsigned>(p.n_heavy),
                    static_cast<unsigned>((d + kCombineCols - 1) / kCombineCols));
    segment_sum_combine<<<grid, kCombineThreads, 0, stream>>>(partial, d, p.split, p.heavy,
                                                              p.parts, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: [rows, d] float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1), rows
// indexed by order ([rows] int32, or null for the identity); offsets:
// [n + 1] int64; the segments [lo, hi) are summed, those of more than
// chunk rows through their n_parts parts, each cut into `split` pieces
// (heavy: [n_heavy] int32 segment ids, parts: [n_heavy + 1] int64 prefix,
// partial: [n_parts * split, d] float64 scratch; none is read when
// n_heavy = 0). acc: [n, d] float64, added into. Launches on `stream` of
// `device`; returns the cudaError_t of the launches (0 on success).
extern "C" int segment_sum_launch(const void* data, int is_bf16, long long d,
                                  const int* order, const long long* offsets,
                                  long long lo, long long hi, long long chunk,
                                  const int* heavy, const long long* parts,
                                  long long n_heavy, long long n_parts, long long split,
                                  double* partial, double* acc, int device,
                                  cudaStream_t stream) {
  const Plan p{order, offsets, lo, hi, chunk, heavy, parts, n_heavy, n_parts, split};
  if (is_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(data), d, p, acc, partial, device, stream);
  }
  return launch(static_cast<const float*>(data), d, p, acc, partial, device, stream);
}
