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
//    a step, 5 steps for 6.8 M rows), which starts with the 32 ids around
//    where b0 would start were the rows spread evenly: at the serving
//    shapes (one row a bag) that first probe finds it. No offsets array,
//    no second pass, no atomics: the result repeats run to run.
//  - It walks the rows in windows of 32 (bag, idx) pairs, one coalesced
//    load of each a window, and finds where bags end inside the window by
//    one ballot of bag[k] != bag[k + 1]. Rows of bags >= b1 end the walk.
//  - A row is `width` lanes, 16 bytes a lane (float4, or 8 bfloat16) where
//    d and the pointers allow, else one value: d = 64 float32 is 16 lanes,
//    so a warp has two workers of 16 lanes (bfloat16 d = 64: four of 8).
//    The bags of a window go to the workers in turn; each worker loads
//    kAhead of its rows before it adds any, so a warp keeps 16 random
//    256-byte rows in flight at d = 64 float32 where one bag at a time
//    kept one. A one-row bag is then a straight copy.
//  - A bag that runs past the window stays with its worker: the next
//    window gives its first bag to that worker, whose registers hold the
//    running sum. Each bag is summed by one worker in input order, so the
//    adds keep their order however far the loads run ahead.
//  - Bag ids below 0 sort before b0 = 0 and ids >= num_bags after the last
//    bag, so neither is ever walked: they are dropped, as in
//    jax.ops.segment_sum. A bag with no rows is written as zeros by the
//    worker of the next bag (or after the warp's last row).
//  - Rows wider than 32 lane groups take several passes over the windows.
//    The row offset is 64-bit (26,000,000 rows x 64 overflow 32 bits).
//  - A row index outside [0, rows) is never read: its bag's row becomes
//    NaN (jnp.take_along_axis fills such a gather with NaN).
//  - Sums are float32 in input order for both table types, rounded once to
//    the output type; a one-row bag is its row, bit for bit.
//
// Bound: bytes. Each row is read once and each bag written once (at the
// DLRM serve_bulk shape 6,815,744 one-row bags of 256 bytes: 3.54 GB with
// the ids, 1.06 ms at 3.35 TB/s); the adds are nothing beside them. The
// rows are random, so each is a DRAM access and the kernel is bound by the
// loads in flight; the grid is one wave of as many warps as fit (each with
// a few hundred bags). The SM count and each instantiation's occupancy are
// read once per device and cached.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <mutex>

namespace {

constexpr int kWarps = 8;        // warps a block
constexpr int kAhead = 8;        // rows a worker loads before it adds
constexpr int kMaxWorkers = 8;   // workers a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// kVec values of T: Raw holds them as loaded, add() sums them into acc
// (float32).
template <typename T, int kVec>
struct Row;

template <>
struct Row<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw zero() { return 0.0f; }
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) { acc[0] += r; }
  static __device__ __forceinline__ void store(float* p, const float* v) { p[0] = v[0]; }
};

template <>
struct Row<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(const Raw& f, float* acc) {
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
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw zero() { return 0; }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void add(const Raw& r, float* acc) {
    acc[0] += __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

template <>
struct Row<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void add(const Raw& u, float* acc) {
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
// gets the same answer. A first probe reads the 32 ids around `guess`
// (where x would start were the rows spread evenly over the bags: x itself
// when every bag has one row) and ends the search there when the answer
// lies among them. Then the invariant bag[i] < x for i < lo, bag[i] >= x
// for i >= hi holds, and each step narrows [lo, hi) 32-fold: lane l
// probes lo + l * step; the probes below x are a prefix (bag is sorted),
// so their count c places the answer in (probe c - 1, probe c], a range of
// under step entries.
__device__ long long warp_lower_bound(const int* __restrict__ bag, long long n,
                                      long long x, long long guess, int lane) {
  long long lo = 0, hi = n;
  {
    long long base = guess - 16 < n - 32 ? guess - 16 : n - 32;
    if (base < 0) base = 0;
    const long long p = base + lane;
    const int c = __popc(__ballot_sync(kFull, p < n && bag[p] < x));
    const long long cnt = n - base < 32 ? n - base : 32;
    if (c == cnt) {
      lo = base + c;
    } else if (c == 0) {
      hi = base;
    } else {
      return base + c;
    }
  }
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
__device__ __forceinline__ void store_zeros(T* p) {
  float z[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) z[j] = 0.0f;
  Row<T, kVec>::store(p, z);
}

// Warp w sums the bags [w * per_warp, (w + 1) * per_warp). A worker is
// `width` lanes (a power of two); the warp has `workers` of them.
template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    embedding_bag_kernel(const T* __restrict__ table, long long rows, long long d,
                         const int* __restrict__ idx, const int* __restrict__ bag,
                         long long n, long long num_bags, long long per_warp, int width,
                         int workers, T* __restrict__ out) {
  using R = Row<T, kVec>;
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long b0 = warp * per_warp;
  if (b0 >= num_bags) return;  // warp-uniform
  const long long b1 = b0 + per_warp < num_bags ? b0 + per_warp : num_bags;
  const long long groups = d / kVec;
  const int me = lane / width;  // this lane's worker, if < workers
  const long long first = warp_lower_bound(bag, n, b0, b0 * n / num_bags, lane);
  for (long long g0 = 0; g0 < groups; g0 += width) {
    const long long g = g0 + lane % width;
    const bool active = me < workers && g < groups;
    const long long col = g * kVec;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    bool bad = false;
    long long last = b0 - 1;  // bag of the last row walked (warp-uniform)
    int rot = 0;              // worker of the window's first bag
    for (long long k0 = first; k0 < n; k0 += 32) {
      const long long p = k0 + lane;
      const int pb = p < n ? bag[p] : INT_MAX;
      const bool valid = pb < b1;  // bags >= b1 are the next warp's
      const int pi = valid ? idx[p] : 0;
      int nb = __shfl_down_sync(kFull, pb, 1);
      if (lane == 31) nb = p + 1 < n ? bag[p + 1] : INT_MAX;
      const unsigned vmask = __ballot_sync(kFull, valid);  // a prefix
      if (vmask == 0) break;
      const unsigned ends = __ballot_sync(kFull, valid && nb != pb);
      // bag j of the window (counted from its first row) goes to worker
      // (rot + j) % workers
      const int owner = (rot + __popc(ends & ((1u << lane) - 1))) % workers;
      unsigned mine = 0;
      int most = 0;
      for (int w = 0; w < workers; ++w) {
        const unsigned mw = __ballot_sync(kFull, valid && owner == w);
        if (w == me) mine = mw;
        most = max(most, __popc(mw));
      }
      for (int t = 0; t < most; t += kAhead) {
        typename R::Raw v[kAhead];
        int pos[kAhead];
        bool oob[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {  // the loads, all before any add
          pos[u] = mine ? __ffs(mine) - 1 : -1;
          mine &= mine - 1;
          const long long r = __shfl_sync(kFull, pi, pos[u] < 0 ? 0 : pos[u]);
          oob[u] = r < 0 || r >= rows;
          v[u] = R::zero();
          if (pos[u] >= 0 && active && !oob[u]) v[u] = R::load(table + r * d + col);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {  // the adds, in input order
          const int q = pos[u] < 0 ? 0 : pos[u];
          const int qb = __shfl_sync(kFull, pb, q);
          const int prev = __shfl_sync(kFull, pb, q > 0 ? q - 1 : 0);
          if (pos[u] >= 0) {
            const long long before = q > 0 ? prev : last;
            if (active) {
              for (long long b = before + 1; b < qb; ++b) store_zeros<T, kVec>(out + b * d + col);
            }
            R::add(v[u], acc);
            bad |= oob[u];
            if ((ends >> q) & 1u) {  // the bag's last row
              if (bad) {
#pragma unroll
                for (int j = 0; j < kVec; ++j) acc[j] = __int_as_float(0x7fc00000);
              }
              if (active) R::store(out + qb * d + col, acc);
#pragma unroll
              for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
              bad = false;
            }
          }
        }
      }
      rot = (rot + __popc(ends)) % workers;
      last = __shfl_sync(kFull, pb, __popc(vmask) - 1);
      if (vmask != kFull) break;
    }
    // bags after the warp's last row have none
    if (active) {
      for (long long b = last + 1 + me; b < b1; b += workers) {
        store_zeros<T, kVec>(out + b * d + col);
      }
    }
  }
}

// Launch state of one device, read on its first launch: the SM count and
// the resident blocks an SM of each instantiation.
struct DeviceState {
  std::atomic<bool> ready{false};
  int sms = 0;
  int blocks[4] = {0};  // float/1, float/4, bf16/1, bf16/8
};

DeviceState g_state[kMaxDevices];
std::mutex g_init;

template <typename T, int kVec>
constexpr int slot() {
  return (sizeof(T) == 2 ? 2 : 0) + (kVec == 1 ? 0 : 1);
}

template <typename T, int kVec>
cudaError_t occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, embedding_bag_kernel<T, kVec>, kWarps * 32, 0);
}

cudaError_t device_state(int device, const DeviceState** out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[device];
  if (!st.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_init);
    if (!st.ready.load(std::memory_order_relaxed)) {
      cudaError_t err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess) err = occupancy<float, 1>(&st.blocks[slot<float, 1>()]);
      if (err == cudaSuccess) err = occupancy<float, 4>(&st.blocks[slot<float, 4>()]);
      if (err == cudaSuccess) {
        err = occupancy<__nv_bfloat16, 1>(&st.blocks[slot<__nv_bfloat16, 1>()]);
      }
      if (err == cudaSuccess) {
        err = occupancy<__nv_bfloat16, 8>(&st.blocks[slot<__nv_bfloat16, 8>()]);
      }
      for (int b : st.blocks) {
        if (err == cudaSuccess && b < 1) err = cudaErrorInvalidConfiguration;
      }
      if (err != cudaSuccess) return err;
      st.ready.store(true, std::memory_order_release);
    }
  }
  *out = &st;
  return cudaSuccess;
}

template <typename T, int kVec>
int launch_vec(const T* table, long long rows, long long d, const int* idx,
               const int* bag, long long n, long long num_bags, T* out,
               const DeviceState& st, cudaStream_t stream) {
  const long long groups = d / kVec;
  int width = 1;
  while (width < 32 && width < groups) width *= 2;
  const int workers = 32 / width < kMaxWorkers ? 32 / width : kMaxWorkers;
  // one wave: as many warps as fit, each with an equal run of bags
  const long long warps =
      static_cast<long long>(st.blocks[slot<T, kVec>()]) * st.sms * kWarps;
  const long long per_warp = (num_bags + warps - 1) / warps;
  const long long need = (num_bags + per_warp - 1) / per_warp;
  const int blocks = static_cast<int>((need + kWarps - 1) / kWarps);
  embedding_bag_kernel<T, kVec><<<blocks, kWarps * 32, 0, stream>>>(
      table, rows, d, idx, bag, n, num_bags, per_warp, width, workers, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* table, long long rows, long long d, const int* idx,
           const int* bag, long long n, long long num_bags, T* out,
           const DeviceState& st, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);  // values in 16 bytes
  const bool wide = d % kWide == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (wide) {
    return launch_vec<T, kWide>(table, rows, d, idx, bag, n, num_bags, out, st, stream);
  }
  return launch_vec<T, 1>(table, rows, d, idx, bag, n, num_bags, out, st, stream);
}

}  // namespace

// table: [rows, d] float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// idx, bag: [n] int32 sorted by bag; out: [num_bags, d] of the table's
// type, every row written. rows, d, n, num_bags > 0, num_bags < 2**31.
// Launches on `stream` of `device`; returns the cudaError_t of the launch
// (0 on success).
extern "C" int embedding_bag_launch(const void* table, int is_bf16,
                                    long long rows, long long d,
                                    const int* idx, const int* bag, long long n,
                                    long long num_bags, void* out, int device,
                                    cudaStream_t stream) {
  const DeviceState* st = nullptr;
  const cudaError_t err = device_state(device, &st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(table), rows, d, idx, bag, n, num_bags,
                  static_cast<__nv_bfloat16*>(out), *st, stream);
  }
  return launch(static_cast<const float*>(table), rows, d, idx, bag, n, num_bags,
                static_cast<float*>(out), *st, stream);
}
