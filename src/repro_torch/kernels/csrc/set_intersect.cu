// Padded-set intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/set_intersect.py:34
// (set_intersect_pallas): mask[g, i] = a[g, i] != pad and a[g, i] is one of
// the non-pad values of b[g, :]. a: [G, CA], b: [G, CB] int32, mask bool;
// any pad, any widths, any order of the values.
//
// The TPU kernel evaluates the [TG, CA, CB] broadcast compare in VMEM,
// CA * CB compares a row. Both callers in the engine pass rows in the
// CompTensors layout (ascending values, then a pad tail), so this kernel
// searches instead: O(CA log CB + CB) a row on such rows.
//
// Bound: bytes, 4 * G * (CA + CB) read and G * CA written (604 MB for the
// CC-join's 131,072 x 512 x 512). What the design does about it:
//  - Rows per block. On the warp path (CB <= kWarpInts) a warp owns a row
//    and kWarps rows share a block, so a block's loads are several rows
//    wide. A lane takes 4 consecutive values: one 16-byte load where the
//    row pitch and base allow (width % 4 == 0, 16-byte aligned), else
//    scalar loads; kBatch such loads a lane are in flight before it uses
//    them (a 512-wide row is one batch), and a lane writes its 4 results as
//    one 32-bit store.
//  - a first. The warp reads a batch by batch to its first non-pad value; a
//    row whose a is all pad is written as zeros and b is never read.
//  - b staged once, checked on the way in. The row is in layout when its
//    non-pad values form a non-decreasing prefix and the rest is pad. Pads
//    are compared by equality only: pad is an argument and need not be the
//    smallest value. The check reads the loaded registers: the pairs inside
//    a lane, across lanes (a shuffle) and across chunks (a carry). The
//    prefix length nb comes from a ballot of the lanes that hold a pad.
//  - In layout: a fixed-trip lower bound (the last value <= x) over
//    b[0:nb) in shared memory, ceil(log2 nb) steps for every value: 9 for
//    CB = 512. Chunks of a whose values are all pad are not searched.
//  - Out of layout: the row's non-pad values are compacted in place in
//    shared memory and scanned, exact for any row at the old kernel's cost
//    on such rows only.
//  - Wide rows (CB > kWarpInts) take one row per block: b staged in dynamic
//    shared memory while it fits the block's opt-in limit, else searched in
//    place in global memory after the same check (pairs read in chunks of
//    the block's threads) and, out of layout, scanned in place. The launch
//    state (the opt-in limit, the wide kernel's shared-memory attribute) is
//    read once per device and cached.
// Row offsets are 64-bit (G * CA may pass 2^31); positions in a row are
// 64-bit where a width near 2^31 could overflow them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kWarps = 4;          // warp path: rows (one a warp) a block
constexpr int kWarpInts = 2048;    // warp path: the widest b a warp stages (8 KiB)
constexpr int kBatch = 4;          // loads of 4 values a lane has in flight
constexpr int kChunk = 128;        // values a warp holds per load: 4 a lane
constexpr int kSpan = kBatch * kChunk;
constexpr int kWideThreads = 256;  // wide path: one row a block
constexpr int kMaxBlocks = 1 << 30;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// Values p .. p + 3 of a row of n values, those at n or past it set to
// `fill`. `vec`: n % 4 == 0 and the row is 16-byte aligned, so p < n means
// all four are in the row.
__device__ __forceinline__ void load4(const int* __restrict__ row, long long p, long long n,
                                      bool vec, int fill, int (&v)[4]) {
  if (vec) {
    if (p < n) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(row + p));
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = fill;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = p + k < n ? __ldg(row + p + k) : fill;
  }
}

// Results p .. p + 3 of a row of n; `vec` as for load4 (and the output row
// 4-byte aligned): one packed 32-bit store.
__device__ __forceinline__ void store4(uint8_t* __restrict__ row, long long p, long long n,
                                       bool vec, const bool (&h)[4]) {
  if (vec) {
    if (p < n) {
      *reinterpret_cast<unsigned*>(row + p) =
          static_cast<unsigned>(h[0]) | static_cast<unsigned>(h[1]) << 8 |
          static_cast<unsigned>(h[2]) << 16 | static_cast<unsigned>(h[3]) << 24;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (p + k < n) row[p + k] = h[k];
    }
  }
}

__device__ __forceinline__ bool any_value(const int (&x)[4], int pad) {
  return x[0] != pad || x[1] != pad || x[2] != pad || x[3] != pad;
}

// x[v] in s[0:n), s non-decreasing, n > 0: the last i with s[i] <= x[v]
// (0 where none) by a fixed-trip search, the four interleaved, then one
// compare. A pad x is false.
__device__ __forceinline__ void search4(const int* s, int n, int pad, const int (&x)[4],
                                        bool (&h)[4]) {
  int base[4] = {0, 0, 0, 0};
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int v = 0; v < 4; ++v) base[v] = s[base[v] + half] <= x[v] ? base[v] + half : base[v];
    len -= half;
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) h[v] = x[v] != pad && s[base[v]] == x[v];
}

// x[v] in s[0:n) by a scan, in any order. A pad x is false, so a pad of s
// never matches.
__device__ __forceinline__ void scan4(const int* s, long long n, int pad, const int (&x)[4],
                                      bool (&h)[4]) {
  bool f[4] = {false, false, false, false};
#pragma unroll 4
  for (long long j = 0; j < n; ++j) {
    const int y = s[j];
#pragma unroll
    for (int v = 0; v < 4; ++v) f[v] |= y == x[v];
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) h[v] = f[v] && x[v] != pad;
}

// Warp path: a warp a row, b (CB <= kWarpInts) staged in the warp's slice
// of shared memory.
__global__ void __launch_bounds__(kWarps * 32)
    set_intersect_warp(const int* __restrict__ a, const int* __restrict__ b, long long g,
                       int ca, int cb, int pad, bool va, bool vb, uint8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* s = reinterpret_cast<int*>(smem4) + warp * ((cb + 3) & ~3);
  const bool zero[4] = {false, false, false, false};
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < g;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    const int* arow = a + row * ca;
    const int* brow = b + row * cb;
    uint8_t* orow = out + row * ca;

    // 1. a to its first batch with a non-pad value; all-pad batches are zeros
    int av[kBatch][4];
    long long a0 = 0;
    for (; a0 < ca; a0 += kSpan) {
      bool any = false;
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        load4(arow, a0 + c * kChunk + 4 * lane, ca, va, pad, av[c]);
        any |= any_value(av[c], pad);
      }
      if (__any_sync(kFull, any)) break;
#pragma unroll
      for (int c = 0; c < kBatch; ++c) store4(orow, a0 + c * kChunk + 4 * lane, ca, va, zero);
    }
    if (a0 >= ca) continue;  // a is all pad: b is not read

    // 2. b into shared memory, checked on the way in. Values past cb load
    //    as pad: they count as neither a value nor a descent.
    int nb = -1;       // the first pad's position (warp-uniform)
    int nonpad = 0;    // this lane's non-pad values
    bool desc = false; // this lane saw two adjacent non-pad values descend
    int carry = pad;   // the previous chunk's last value
    for (int b0 = 0; b0 < cb; b0 += kSpan) {
      int bv[kBatch][4];
#pragma unroll
      for (int c = 0; c < kBatch; ++c) load4(brow, b0 + c * kChunk + 4 * lane, cb, vb, pad, bv[c]);
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        const int base = b0 + c * kChunk;
        const int(&x)[4] = bv[c];
        const int p = base + 4 * lane;
        if (p < cb) *reinterpret_cast<int4*>(s + p) = make_int4(x[0], x[1], x[2], x[3]);
        int first = 4;
#pragma unroll
        for (int k = 3; k >= 0; --k) {
          if (x[k] == pad) first = k;
          nonpad += x[k] != pad;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) desc |= x[k] != pad && x[k + 1] != pad && x[k] > x[k + 1];
        const int next = __shfl_down_sync(kFull, x[0], 1);
        if (lane < 31) desc |= x[3] != pad && next != pad && x[3] > next;
        if (lane == 0) desc |= carry != pad && x[0] != pad && carry > x[0];
        carry = __shfl_sync(kFull, x[3], 31);
        const unsigned holds = __ballot_sync(kFull, first < 4);
        if (nb < 0 && holds != 0) {
          const int l = __ffs(holds) - 1;
          nb = base + 4 * l + __shfl_sync(kFull, first, l);
        }
      }
    }
    if (nb < 0 || nb > cb) nb = cb;
    nonpad = __reduce_add_sync(kFull, nonpad);
    const bool layout = !__any_sync(kFull, desc) && nonpad == nb;
    __syncwarp();

    // 3. out of layout: the non-pad values compacted in place, in order
    if (!layout) {
      int k = 0;
      for (int p0 = 0; p0 < cb; p0 += 32) {
        const int p = p0 + lane;
        const int x = p < cb ? s[p] : pad;
        const unsigned keep = __ballot_sync(kFull, x != pad);
        __syncwarp();
        if (x != pad) s[k + __popc(keep & ((1u << lane) - 1))] = x;
        k += __popc(keep);
        __syncwarp();
      }
    }
    const int n = layout ? nb : nonpad;

    // 4. a's values against b[0:n), from the batch found in step 1 on
    for (;;) {
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        bool h[4] = {false, false, false, false};
        const bool go = __any_sync(kFull, any_value(av[c], pad));
        if (go && n > 0) {
          if (layout) {
            search4(s, n, pad, av[c], h);
          } else {
            scan4(s, n, pad, av[c], h);
          }
        }
        store4(orow, a0 + c * kChunk + 4 * lane, ca, va, h);
      }
      a0 += kSpan;
      if (a0 >= ca) break;
#pragma unroll
      for (int c = 0; c < kBatch; ++c) load4(arow, a0 + c * kChunk + 4 * lane, ca, va, pad, av[c]);
    }
    __syncwarp();  // the next row's b overwrites s
  }
}

// Wide path: a block a row. kStaged: b in dynamic shared memory; else b is
// searched in place in global memory.
template <bool kStaged>
__global__ void __launch_bounds__(kWideThreads)
    set_intersect_wide(const int* __restrict__ a, const int* __restrict__ b, long long g,
                       int ca, int cb, int pad, bool va, bool vb, uint8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  __shared__ int first_pad, count, warp_count[kWideThreads / 32];
  int* s = reinterpret_cast<int*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kStep = 4 * kWideThreads;
  const bool zero[4] = {false, false, false, false};
  for (long long row = blockIdx.x; row < g; row += gridDim.x) {
    const int* arow = a + row * ca;
    const int* brow = b + row * cb;
    uint8_t* orow = out + row * ca;

    // 1. a to its first step with a non-pad value
    int av[4];
    long long a0 = 0;
    for (; a0 < ca; a0 += kStep) {
      load4(arow, a0 + 4 * tid, ca, va, pad, av);
      if (__syncthreads_or(any_value(av, pad))) break;
      store4(orow, a0 + 4 * tid, ca, va, zero);
    }
    if (a0 >= ca) continue;

    // 2. b staged (or not), then checked pair by pair in chunks of the
    //    block's threads
    if (tid == 0) {
      first_pad = cb;
      count = 0;
    }
    if (kStaged) {
      for (long long p = 4 * tid; p < cb; p += kStep) {
        int v[4];
        load4(brow, p, cb, vb, pad, v);
        *reinterpret_cast<int4*>(s + p) = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    const int* src = kStaged ? s : brow;
    int first = cb, nonpad = 0;
    bool desc = false;
    for (long long p = tid; p < cb; p += kWideThreads) {
      const int x = src[p];
      if (x == pad) {
        first = min(first, static_cast<int>(p));
      } else {
        ++nonpad;
        if (p + 1 < cb) {
          const int y = src[p + 1];
          desc |= y != pad && x > y;
        }
      }
    }
    first = __reduce_min_sync(kFull, first);
    nonpad = __reduce_add_sync(kFull, nonpad);
    if (lane == 0) {
      atomicMin(&first_pad, first);
      atomicAdd(&count, nonpad);
    }
    const bool layout = !__syncthreads_or(desc) && count == first_pad;
    const int nb = first_pad;
    const int total = count;

    // 3. out of layout and staged: the non-pad values compacted in place
    if (kStaged && !layout) {
      int k = 0;
      for (long long p0 = 0; p0 < cb; p0 += kWideThreads) {
        const long long p = p0 + tid;
        const int x = p < cb ? s[p] : pad;
        const unsigned keep = __ballot_sync(kFull, x != pad);
        if (lane == 0) warp_count[warp] = __popc(keep);
        __syncthreads();
        int off = k, all = 0;
#pragma unroll
        for (int w = 0; w < kWideThreads / 32; ++w) {
          off += w < warp ? warp_count[w] : 0;
          all += warp_count[w];
        }
        if (x != pad) s[off + __popc(keep & ((1u << lane) - 1))] = x;
        k += all;
        __syncthreads();
      }
    }
    // in layout: b[0:nb); out of layout: the compacted values, or all of b
    // in place (a pad x is false, so b's pads never match)
    const long long n = layout ? nb : (kStaged ? total : cb);

    // 4. a's values, from the step found in step 1 on
    for (;;) {
      bool h[4] = {false, false, false, false};
      if (n > 0 && any_value(av, pad)) {
        if (layout) {
          search4(src, static_cast<int>(n), pad, av, h);
        } else {
          scan4(src, n, pad, av, h);
        }
      }
      store4(orow, a0 + 4 * tid, ca, va, h);
      a0 += kStep;
      if (a0 >= ca) break;
      load4(arow, a0 + 4 * tid, ca, va, pad, av);
    }
    __syncthreads();  // the next row's b overwrites s and the counts
  }
}

// Launch state of one device, read on its first launch.
struct DeviceState {
  std::atomic<bool> ready{false};
  int staged_ints = 0;  // the widest b the wide path stages in shared memory
};

DeviceState g_state[kMaxDevices];
std::mutex g_init;

cudaError_t device_state(int device, const DeviceState** out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[device];
  if (!st.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_init);
    if (!st.ready.load(std::memory_order_relaxed)) {
      int optin = 0;
      cudaError_t err =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      cudaFuncAttributes attr = {};
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, set_intersect_wide<true>);
      const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
      if (err == cudaSuccess && dynamic < 16) err = cudaErrorInvalidConfiguration;
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(set_intersect_wide<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
      }
      if (err != cudaSuccess) return err;
      st.staged_ints = dynamic / 16 * 4;
      st.ready.store(true, std::memory_order_release);
    }
  }
  *out = &st;
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// out[0] = kWarpInts (the widest b of the warp path), out[1] = the widest b
// the wide path stages in shared memory on `device` (wider rows are searched
// in global memory). Returns the cudaError_t (0 on success).
extern "C" int set_intersect_limits(int device, int* out) {
  const DeviceState* st = nullptr;
  const cudaError_t err = device_state(device, &st);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kWarpInts;
  out[1] = st->staged_ints;
  return 0;
}

// a: [g, ca] int32, b: [g, cb] int32, out: [g, ca] bool, every element
// written. g, ca, cb > 0. Launches on `stream` of `device`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int set_intersect_launch(const int* a, const int* b, long long g, int ca, int cb,
                                    int pad, bool* out, int device, cudaStream_t stream) {
  if (g <= 0 || ca <= 0 || cb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceState* st = nullptr;
  const cudaError_t err = device_state(device, &st);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* o = reinterpret_cast<uint8_t*>(out);
  const bool va = ca % 4 == 0 && aligned(a, 16) && aligned(out, 4);
  const bool vb = cb % 4 == 0 && aligned(b, 16);
  const size_t padded = static_cast<size_t>((static_cast<long long>(cb) + 3) & ~3LL);
  if (cb <= kWarpInts) {
    const long long need = (g + kWarps - 1) / kWarps;
    const int blocks = static_cast<int>(need < kMaxBlocks ? need : kMaxBlocks);
    set_intersect_warp<<<blocks, kWarps * 32, sizeof(int) * kWarps * padded, stream>>>(
        a, b, g, ca, cb, pad, va, vb, o);
  } else {
    const int blocks = static_cast<int>(g < kMaxBlocks ? g : kMaxBlocks);
    if (cb <= st->staged_ints) {
      set_intersect_wide<true><<<blocks, kWideThreads, sizeof(int) * padded, stream>>>(
          a, b, g, ca, cb, pad, va, vb, o);
    } else {
      set_intersect_wide<false><<<blocks, kWideThreads, 0, stream>>>(a, b, g, ca, cb, pad, va,
                                                                     vb, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
