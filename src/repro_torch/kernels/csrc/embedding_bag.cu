// Embedding bag (sum mode) for Hopper (sm_90a): the DLRM lookup.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py:41
// (embedding_bag_pallas): out[b, :] = sum of table[idx[i], :] over the
// rows i with bag[i] = b, for 0 <= b < num_bags. table: [rows, d] float32
// or bfloat16; idx, bag: [n] int32, sorted by bag (the ops wrapper sorts);
// out: [num_bags, d] in the table's type, every bag written.
//
// The TPU kernel runs one grid step per input row in order and keeps the
// running bag's sum in its output block between steps. Blocks here run in
// no order, so nothing is carried between them: each warp owns a run of
// consecutive bags [b0, b1) and walks their rows itself.
//  - It finds the first row of bag b0 by a 32-way search of the sorted
//    bag ids (each lane probes one point; a ballot narrows the range 32-fold
//    a step, 5 steps for 6.8 M rows), then walks forward: the lanes read 32
//    bag ids at a time and a ballot finds where bag b ends. No offsets
//    array, no second pass, no atomics: the result repeats run to run.
//  - Bag ids below 0 sort before b0 = 0 and ids >= num_bags after the last
//    bag, so neither is ever walked: they are dropped, as in
//    jax.ops.segment_sum. A bag with no rows is written as zeros.
//  - Lanes take neighbouring column groups of a row: 16 bytes a lane
//    (float4, or 8 bfloat16) where d and the pointers allow, else one value;
//    d = 64 float32 is 16 lanes of float4, one 256-byte row read at once.
//    Rows wider than 32 groups take several passes. The row offset is
//    64-bit (26,000,000 rows x 64 overflow 32 bits).
//  - The lanes load 32 row indices at a time and pass them round by
//    shuffle. A row index outside [0, rows) is never read: its bag's row
//    becomes NaN (jnp.take_along_axis fills such a gather with NaN).
//  - Sums are float32 in input order for both table types, rounded once to
//    the output type; a one-row bag is its row, bit for bit.
//
// Bound: bytes. Each row is read once and each bag written once (at the
// DLRM serve_bulk shape 6,815,744 one-row bags of 256 bytes: 3.54 GB with
// the ids, 1.06 ms at 3.35 TB/s); the adds are nothing beside them. The
// rows are random, so each is a DRAM access; the grid is one wave of as
// many warps as fit (each with a few hundred bags), so that enough row
// loads are in flight to cover the memory's latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr unsigned kFull = 0xffffffffu;

// kVec values of T from p, added into acc (float32).
template <typename T, int kVec>
struct Row;

template <>
struct Row<float, 1> {
  static __device__ __forceinline__ void add(const float* p, float* acc) {
    acc[0] += __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Row<float, 4> {
  static __device__ __forceinline__ void add(const float* p, float* acc) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] += f.x;
    acc[1] += f.y;
    acc[2] += f.z;
    acc[3] += f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Row<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void add(const __nv_bfloat16* p, float* acc) {
    acc[0] += __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

template <>
struct Row<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void add(const __nv_bfloat16* p, float* acc) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[2 * j] += f.x;
      acc[2 * j + 1] += f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// First i in [0, n) with bag[i] >= x, or n. The whole warp calls it and
// gets the same answer. Invariant: bag[i] < x for i < lo, bag[i] >= x for
// i >= hi. Lane l probes lo + l * step; the probes below x are a prefix
// (bag is sorted), so their count c places the answer in
// (probe c - 1, probe c], a range of under step entries.
__device__ long long warp_lower_bound(const int* __restrict__ bag, long long n,
                                      long long x, int lane) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool less = p < hi && bag[p] < x;
    const int c = __popc(__ballot_sync(kFull, less));
    if (c == 0) {
      hi = lo;
    } else {
      const long long next = lo + c * step;
      lo = lo + (c - 1) * step + 1;
      if (c < 32 && next < hi) hi = next;
    }
  }
  return lo;
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    embedding_bag_kernel(const T* __restrict__ table, long long rows, long long d,
                         const int* __restrict__ idx, const int* __restrict__ bag,
                         long long n, long long num_bags, long long per_warp,
                         T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long b0 = warp * per_warp;
  if (b0 >= num_bags) return;  // warp-uniform
  const long long b1 = b0 + per_warp < num_bags ? b0 + per_warp : num_bags;
  const long long groups = d / kVec;
  long long i = warp_lower_bound(bag, n, b0, lane);
  for (long long b = b0; b < b1; ++b) {
    // the rows of bag b are [i, end): bag[i] >= b holds here
    long long end = i;
    for (;;) {
      const long long p = end + lane;
      const unsigned stop = __ballot_sync(kFull, p >= n || bag[p] != b);
      if (stop) {
        end += __ffs(stop) - 1;
        break;
      }
      end += 32;
    }
    for (long long g0 = 0; g0 < groups; g0 += 32) {
      const long long g = g0 + lane;
      const bool active = g < groups;
      float acc[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
      bool bad = false;
      for (long long k0 = i; k0 < end; k0 += 32) {
        const int cnt = end - k0 < 32 ? static_cast<int>(end - k0) : 32;
        const int mine = lane < cnt ? idx[k0 + lane] : 0;
        bad |= __any_sync(kFull, mine < 0 || mine >= rows) != 0;
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const long long r = __shfl_sync(kFull, mine, j);
          if (active && r >= 0 && r < rows) {
            Row<T, kVec>::add(table + r * d + g * kVec, acc);
          }
        }
      }
      if (active) {
        if (bad) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[j] = __int_as_float(0x7fc00000);
        }
        Row<T, kVec>::store(out + b * d + g * kVec, acc);
      }
    }
    i = end;
  }
}

template <typename T, int kVec>
int launch_vec(const T* table, long long rows, long long d, const int* idx,
               const int* bag, long long n, long long num_bags, T* out,
               cudaStream_t stream) {
  auto kernel = embedding_bag_kernel<T, kVec>;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, 0);
  if (per_sm < 1) per_sm = 1;
  // one wave: as many warps as fit, each with an equal run of bags
  const long long warps = static_cast<long long>(per_sm) * sms * kWarps;
  const long long per_warp = (num_bags + warps - 1) / warps;
  const long long need = (num_bags + per_warp - 1) / per_warp;
  const int blocks = static_cast<int>((need + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, 0, stream>>>(table, rows, d, idx, bag, n,
                                            num_bags, per_warp, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* table, long long rows, long long d, const int* idx,
           const int* bag, long long n, long long num_bags, T* out,
           cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);  // values in 16 bytes
  const bool wide = d % kWide == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (wide) {
    return launch_vec<T, kWide>(table, rows, d, idx, bag, n, num_bags, out,
                                stream);
  }
  return launch_vec<T, 1>(table, rows, d, idx, bag, n, num_bags, out, stream);
}

}  // namespace

// table: [rows, d] float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// idx, bag: [n] int32 sorted by bag; out: [num_bags, d] of the table's
// type, every row written. rows, d, n, num_bags > 0. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int embedding_bag_launch(const void* table, int is_bf16,
                                    long long rows, long long d,
                                    const int* idx, const int* bag, long long n,
                                    long long num_bags, void* out,
                                    cudaStream_t stream) {
  if (is_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(table), rows, d, idx, bag,
                  n, num_bags, static_cast<__nv_bfloat16*>(out), stream);
  }
  return launch(static_cast<const float*>(table), rows, d, idx, bag, n,
                num_bags, static_cast<float*>(out), stream);
}
