// Sorted-table membership probe for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/member_probe.py:52
// (member_probe_pallas): out[i] = (q_hi[i], q_lo[i]) is a row of the table
// (t_hi, t_lo), with (-1, -1) as the pad on both sides.
//
// Precondition: the table is sorted lexicographically by signed (hi, lo)
// with its (-1, -1) pads at the tail. Every caller in the engine passes such
// a table (the partition edge list, the dedup_rows drop tables, the delete
// table). The TPU kernel compares every query with every table row, O(N*M);
// at the engine's shapes that is ~1e12 compares per call, so this kernel
// searches the sorted table instead, O(N log M), with the predicate of the
// plain version (ref.member_probe_ref: pads sort last, a (-1, -1) query is
// false).
//
// Keys. A row is one 64-bit key, hi * 2^32 + (lo ^ 0x80000000) as unsigned:
// int64 order on keys is signed lexicographic order on (hi, lo). A pad row
// is INT64_MAX, so it sorts last and needs no test in the search. A search
// step is one 8-byte load and one compare.
//
// Search. last_le is a branchless lower bound with a fixed trip count of
// ceil(log2 m): every thread of a warp takes the same steps.
//
// Bound: bytes. Each query reads 8 bytes and writes 1. Two table sizes:
//  - Small tables (m <= kSmemKeys, the per-partition edge list and the
//    64-row delete table): every block stages the m keys in shared memory
//    once and probes there. At the delete filter (7e8 queries x 64 rows)
//    the queries stream from HBM, so each thread takes kVec consecutive
//    queries a trip (one 16-byte load of each lane) and writes their kVec
//    results as one 32-bit store; the grid is every block the SMs hold at
//    once, striding over the queries, so that enough loads are in flight
//    to cover HBM's latency.
//  - Large tables probed by fewer queries than they have rows (the stored
//    edge list against the drop table): one search over the keys made from
//    the table's lanes in global memory, as a pass over the whole table
//    would cost more than the queries.
//  - Large tables probed by more queries than they have rows (the
//    candidate rows against the 116,669-row drop table): a two-level search. A
//    pre-pass kernel writes the packed keys once per call into a scratch
//    buffer, padded to whole windows of s rows, and every s-th key beside
//    them as fences (at most kMaxFences, s a power of two, chosen by the
//    wrapper). Each block stages the fences in shared memory; a query
//    searches them there, then compares itself with the s keys of its one
//    window in L2 (s = 16: one 128-byte line read as 8 independent 16-byte
//    loads), where a search of the table in global memory would take
//    ceil(log2 m) dependent L2 round trips. The pre-pass is a kernel and not
//    each block's own work: the fences are then one contiguous 8 * nf-byte
//    copy a block instead of nf scattered sector reads of two int32 lanes,
//    and the windows are aligned 16-byte loads whatever the table's offset.
//    The window tail past m holds key_of(-1, -1), which only a (-1, -1)
//    query could equal, and that query is answered false beforehand.
//
// A thread takes kVec queries only when there are more queries than
// resident threads; queries whose lanes are not both 16-byte aligned
// (offset views), and the n % kVec tail, take one query per thread. Launch state (SM count,
// occupancy by shared-memory size, the kernels' shared-memory attribute) is
// read once per device and cached; a failed query is returned as the error.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;            // queries a thread takes a trip
constexpr int kSmemKeys = 8192;    // small tables: 8192 keys = 64 KiB of shared memory
constexpr int kMaxFences = 8192;   // large tables: at most 64 KiB of fences
constexpr long long kPad = LLONG_MAX;  // a (-1, -1) table row
constexpr int kMaxDevices = 64;
constexpr int kBuckets = 7;        // occupancy at 1, 2, 4, ..., 64 KiB of shared memory

__host__ __device__ __forceinline__ long long key_of(int h, int l) {
  return static_cast<long long>(h) * 0x100000000LL +
         static_cast<long long>(static_cast<unsigned>(l) ^ 0x80000000u);
}

__device__ __forceinline__ long long table_key(int h, int l) {
  return (h == -1 && l == -1) ? kPad : key_of(h, l);
}

// For each v: the last i in [0, m) with key(i) <= q[v], or 0 where there
// is none. Invariant: the answer lies in [base, base + len). ceil(log2 m)
// steps whatever the queries; the V searches interleave.
template <int V, class Key>
__device__ __forceinline__ void last_le(const Key& key, int m, const long long (&q)[V],
                                        int (&base)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) base[v] = 0;
  for (int len = m; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int v = 0; v < V; ++v) base[v] = key(base[v] + half) <= q[v] ? base[v] + half : base[v];
    len -= half;
  }
}

// Keys staged in shared memory (the small table, or the fences).
struct SharedKeys {
  const long long* keys;
  __device__ __forceinline__ long long operator()(int i) const { return keys[i]; }
};

// Keys made from the table's lanes in global memory, a step at a time.
struct LaneKeys {
  const int* t_hi;
  const int* t_lo;
  __device__ __forceinline__ long long operator()(int i) const {
    return table_key(__ldg(t_hi + i), __ldg(t_lo + i));
  }
};

// One search over all m keys.
template <class Key>
struct WholeTable {
  Key key;
  int m;
  template <int V>
  __device__ __forceinline__ void find(const long long (&q)[V], bool (&hit)[V]) const {
    int base[V];
    last_le<V>(key, m, q, base);
#pragma unroll
    for (int v = 0; v < V; ++v) hit[v] = key(base[v]) == q[v];
  }
};

// Fences in shared memory, then windows of s keys in global memory.
struct TwoLevel {
  SharedKeys fences;        // nf of them
  const long long* keys;    // global, nf * s
  int nf, s;
  template <int V>
  __device__ __forceinline__ void find(const long long (&q)[V], bool (&hit)[V]) const {
    int base[V];
    last_le<V>(fences, nf, q, base);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const longlong2* w =
          reinterpret_cast<const longlong2*>(keys + static_cast<long long>(base[v]) * s);
      bool h = false;
#pragma unroll 8
      for (int j = 0; j < s / 2; ++j) {
        const longlong2 x = __ldg(w + j);
        h |= (x.x == q[v]) | (x.y == q[v]);
      }
      hit[v] = h;
    }
  }
};

// Every query of [0, n): kVec a trip with one 16-byte load of each lane and
// one 32-bit store where the lanes are aligned, then the tail one at a time.
template <class Table>
__device__ __forceinline__ void probe(const int* __restrict__ q_hi,
                                      const int* __restrict__ q_lo, long long n,
                                      bool vec, const Table& table,
                                      uint8_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long quads = n / kVec;
    const int4* qh = reinterpret_cast<const int4*>(q_hi);
    const int4* ql = reinterpret_cast<const int4*>(q_lo);
    for (long long i = t; i < quads; i += stride) {
      const int4 h4 = __ldg(qh + i);
      const int4 l4 = __ldg(ql + i);
      const int h[kVec] = {h4.x, h4.y, h4.z, h4.w};
      const int l[kVec] = {l4.x, l4.y, l4.z, l4.w};
      long long q[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) q[v] = key_of(h[v], l[v]);
      bool hit[kVec];
      table.template find<kVec>(q, hit);
      unsigned word = 0;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        word |= static_cast<unsigned>(hit[v] && !(h[v] == -1 && l[v] == -1)) << (8 * v);
      }
      reinterpret_cast<unsigned*>(out)[i] = word;
    }
    done = quads * kVec;
  }
  for (long long i = done + t; i < n; i += stride) {
    const int h = q_hi[i], l = q_lo[i];
    const long long q[1] = {key_of(h, l)};
    bool hit[1];
    table.template find<1>(q, hit);
    out[i] = hit[0] && !(h == -1 && l == -1);
  }
}

__global__ void __launch_bounds__(kThreads)
    member_probe_small(const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                       const int* __restrict__ t_hi, const int* __restrict__ t_lo,
                       long long n, int m, bool vec, uint8_t* __restrict__ out) {
  extern __shared__ long long smem[];
  for (int j = threadIdx.x; j < m; j += blockDim.x) smem[j] = table_key(t_hi[j], t_lo[j]);
  __syncthreads();
  probe(q_hi, q_lo, n, vec, WholeTable<SharedKeys>{SharedKeys{smem}, m}, out);
}

__global__ void __launch_bounds__(kThreads)
    member_probe_global(const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                        const int* __restrict__ t_hi, const int* __restrict__ t_lo,
                        long long n, int m, bool vec, uint8_t* __restrict__ out) {
  probe(q_hi, q_lo, n, vec, WholeTable<LaneKeys>{LaneKeys{t_hi, t_lo}, m}, out);
}

__global__ void __launch_bounds__(kThreads)
    member_probe_two_level(const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                           const long long* __restrict__ keys,
                           const long long* __restrict__ fences, long long n, int nf, int s,
                           bool vec, uint8_t* __restrict__ out) {
  extern __shared__ long long smem[];
#pragma unroll 4
  for (int j = threadIdx.x; j < nf; j += blockDim.x) smem[j] = __ldg(fences + j);
  __syncthreads();
  probe(q_hi, q_lo, n, vec, TwoLevel{SharedKeys{smem}, keys, nf, s}, out);
}

// keys[i] = the key of row i for i < m, key_of(-1, -1) up to nf * s;
// fences[k] = keys[k * s].
__global__ void member_probe_pack(const int* __restrict__ t_hi, const int* __restrict__ t_lo,
                                  int m, int s, long long total, long long* __restrict__ keys,
                                  long long* __restrict__ fences) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long k = i < m ? table_key(t_hi[i], t_lo[i]) : key_of(-1, -1);
    keys[i] = k;
    if (i % s == 0) fences[i / s] = k;
  }
}

// Launch state of one device, read on its first launch.
struct DeviceState {
  std::atomic<bool> ready{false};
  int sms = 0;
  int small_blocks[kBuckets] = {0};  // resident blocks an SM by shared-memory bucket
  int large_blocks[kBuckets] = {0};
  int global_blocks = 0;
};

DeviceState g_state[kMaxDevices];
std::mutex g_init;

int bucket(size_t bytes) {
  int b = 0;
  while (b + 1 < kBuckets && (static_cast<size_t>(1024) << b) < bytes) ++b;
  return b;
}

cudaError_t device_state(int device, const DeviceState** out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[device];
  if (!st.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_init);
    if (!st.ready.load(std::memory_order_relaxed)) {
      cudaError_t err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, device);
      const cudaFuncAttribute most = cudaFuncAttributeMaxDynamicSharedMemorySize;
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(member_probe_small, most,
                                   static_cast<int>(sizeof(long long)) * kSmemKeys);
      }
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(member_probe_two_level, most,
                                   static_cast<int>(sizeof(long long)) * kMaxFences);
      }
      for (int b = 0; b < kBuckets && err == cudaSuccess; ++b) {
        const size_t bytes = static_cast<size_t>(1024) << b;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &st.small_blocks[b], member_probe_small, kThreads, bytes);
        if (err == cudaSuccess) {
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &st.large_blocks[b], member_probe_two_level, kThreads, bytes);
        }
        if (err == cudaSuccess && (st.small_blocks[b] < 1 || st.large_blocks[b] < 1)) {
          err = cudaErrorInvalidConfiguration;
        }
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&st.global_blocks,
                                                            member_probe_global, kThreads, 0);
      }
      if (err == cudaSuccess && st.global_blocks < 1) err = cudaErrorInvalidConfiguration;
      if (err != cudaSuccess) return err;
      st.ready.store(true, std::memory_order_release);
    }
  }
  *out = &st;
  return cudaSuccess;
}

// Blocks for n queries: one thread a query while there are no more
// queries than resident threads, else kVec a thread (where `aligned`), and
// no more blocks than are resident at once.
int grid(long long n, bool aligned, int per_sm, int sms, bool* vec) {
  const long long resident = static_cast<long long>(per_sm) * sms;
  *vec = aligned && n > resident * kThreads;
  const long long work = *vec ? (n + kVec - 1) / kVec : n;
  const long long need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < resident ? need : resident);
}

}  // namespace

// q_hi, q_lo: [n] int32; t_hi, t_lo: [m] int32; out: [n] bool, every
// element written. n, m > 0. s = 1: one search over all m keys, in shared
// memory where m <= 8192, else in global memory (scratch unused, may be
// null). s > 1 (a power of two with ceil(m / s) <= 8192): the two-level
// search, with scratch: [nf * s + nf] int64, nf = ceil(m / s). n is
// 64-bit: the store's set values alone exceed 7e8 queries a call.
// Launches on `stream` of `device`; returns the cudaError_t of the
// launches (0 on success).
extern "C" int member_probe_launch(const int* q_hi, const int* q_lo, const int* t_hi,
                                   const int* t_lo, long long n, int m, int s,
                                   long long* scratch, bool* out, int device,
                                   cudaStream_t stream) {
  const DeviceState* st = nullptr;
  const cudaError_t err = device_state(device, &st);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* o = reinterpret_cast<uint8_t*>(out);
  const bool aligned = reinterpret_cast<uintptr_t>(q_hi) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q_lo) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 4 == 0;
  bool vec = false;
  if (s <= 1 && m <= kSmemKeys) {
    const size_t bytes = sizeof(long long) * static_cast<size_t>(m);
    const int blocks = grid(n, aligned, st->small_blocks[bucket(bytes)], st->sms, &vec);
    member_probe_small<<<blocks, kThreads, bytes, stream>>>(q_hi, q_lo, t_hi, t_lo, n, m,
                                                            vec, o);
  } else if (s <= 1) {
    const int blocks = grid(n, aligned, st->global_blocks, st->sms, &vec);
    member_probe_global<<<blocks, kThreads, 0, stream>>>(q_hi, q_lo, t_hi, t_lo, n, m, vec,
                                                         o);
  } else {
    const int nf = static_cast<int>((static_cast<long long>(m) + s - 1) / s);
    if (nf > kMaxFences || (s & (s - 1)) != 0 || scratch == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long total = static_cast<long long>(nf) * s;
    long long* keys = scratch;
    long long* fences = scratch + total;
    const long long pack_blocks = (total + kThreads - 1) / kThreads;
    member_probe_pack<<<static_cast<int>(pack_blocks), kThreads, 0, stream>>>(
        t_hi, t_lo, m, s, total, keys, fences);
    const size_t bytes = sizeof(long long) * static_cast<size_t>(nf);
    const int blocks = grid(n, aligned, st->large_blocks[bucket(bytes)], st->sms, &vec);
    member_probe_two_level<<<blocks, kThreads, bytes, stream>>>(q_hi, q_lo, keys, fences, n,
                                                                nf, s, vec, o);
  }
  return static_cast<int>(cudaGetLastError());
}
