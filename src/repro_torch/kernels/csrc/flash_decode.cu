// Flash decode for Hopper (sm_90a): attention of a few query rows (Lq <=
// 16: decode, and short chunks) over a long KV cache, split over the keys.
//
// Replaces, for those calls, the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas): out[b, h, i] = softmax_j(q[b, h, i] .
// k[b, h / group, j] / sqrt(dh)) v[b, h / group, j] over the keys j < lk
// and, when causal, j <= i + q_offset; float32 scores, softmax and sums, the
// output in q's type (float32 or bfloat16). A row that sees no key is 0.
//
// Bound: bytes. A decode call reads the admitted cache once (phi4-mini at
// position 8,192: 4 x 8 KV heads x 8,193 keys x 128 x 2 values x 2 bytes =
// 134 MB, 0.040 ms at 3.35 TB/s) for 4 FLOP per (row, key, column).
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.061 ms a call
// over 20 calls in a row, 2.2 TB/s, 1.5x that bound (PERF.md).
//
// Design. The grid is (b * hkv * row chunks, splits). A block holds every
// query row of its KV head (group * lq rows, up to 8 a block: the 3 rows of
// phi4-mini's decode, the 8 of command-r's grouping) and streams the keys
// of its split once, so each K/V byte crosses HBM once per call; only
// group * lq > 8 (short chunks) adds row chunks, each reading the split
// again. The wrapper sizes the splits to one wave of the blocks the card
// holds at once. Within a block, LPK lanes share a key row: each copies
// 16 bytes of K and of V (coalesced) with cp.async into a ring of its own
// in shared memory, a batch of kU key steps ahead of the batch in use, and
// holds its slice of every query row (scaled by 1/sqrt(dh) * log2 e) in
// registers. Each K row is dotted with every query row, the dots reduced
// over the LPK lanes, and each V row added into every row's float32
// accumulator with an online softmax; the loops over the rows are unrolled
// and free of branches, so the rows' reductions interleave. The causal end
// of the keys is taken per row. The lanes of a warp, then the 8 warps,
// merge their (m, l, acc) states; the block writes its split's (m, l,
// acc[dh]) per row to a float32 workspace. A split that admits no key of a
// row writes m = -inf, l = 0 and merges with weight 0. The last block of
// each (b * hkv, row chunk) to finish, found by an int32 ticket (atomicAdd
// after __threadfence, reset by that block so the next call needs no
// memset), merges the splits with exact float32 online-softmax algebra and
// writes the output: one launch per call. The wrapper keeps the tickets
// and the workspace per (device, stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;       // key steps a ring stage holds
constexpr int kStages = 2;  // ring stages: one in flight while one is used
constexpr int kMaxSplits = 64;  // splits a call takes at most (flash_decode_max_splits)
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The float32 values of one 16-byte chunk: 4 float32 or 8 bfloat16.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: the copy ring (16-byte slots [kStages][kU][K, V][cpl]
// [kThreads], each thread's own), then floats: query rows [R][dh], warp
// accumulators [kWarps][R][dh], warp maxima and sums [kWarps][R] each, the
// splits' maxima and sums [kMaxSplits][R] each.
size_t ring_bytes(int cpl) { return static_cast<size_t>(kStages) * kU * 2 * cpl * kThreads * 16; }
size_t smem_bytes(int cpl, int r, int dh) {
  return ring_bytes(cpl) +
         (static_cast<size_t>(r) * dh * (1 + kWarps) + 2 * (kWarps + kMaxSplits) * r) *
             sizeof(float);
}

// LPK lanes per key row, CPL 16-byte chunks a lane, R rows a block.
// Two blocks an SM for up to 4 rows (at most 128 registers a thread).
template <typename T, int LPK, int CPL, int R>
__global__ void __launch_bounds__(kThreads, R <= 4 ? 2 : 1)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ tickets, int hq, int hkv, int lq, int lk, int dh,
                        int causal, int q_offset, float scale_log2, int rows, int nchunk,
                        int kps) {
  constexpr int V = 16 / sizeof(T);    // elements of a chunk
  constexpr int KPW = 32 / LPK;        // key rows a warp scores at once
  constexpr int E = CPL * V;           // elements a lane holds of a row
  constexpr int kStep = kWarps * KPW;  // key rows the block scores at once
  extern __shared__ uint4 smem16[];
  uint4* ring = smem16;
  float* sq = reinterpret_cast<float*>(smem16 + kStages * kU * 2 * CPL * kThreads);
  float* wacc = sq + R * dh;
  float* wm = wacc + kWarps * R * dh;
  float* wl = wm + kWarps * R;
  float* sm = wl + kWarps * R;  // [kMaxSplits][R]
  float* sl = sm + kMaxSplits * R;
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gi = lane / LPK, li = lane % LPK;
  const int bx = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int bkv = bx / nchunk, chunk = bx - bkv * nchunk;  // bkv = b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv - b * hkv, group = hq / hkv;
  // the block's rows are slots slot0 .. slot0 + nrows - 1 of the group's
  // group * lq (head, query row) pairs, head-major
  const int slot0 = chunk * rows;
  const int nrows = min(rows, group * lq - slot0);
  const int nch = dh / V;
  const int kmax = causal ? min(lk, q_offset + lq) : lk;
  const int k_lo = split * kps, k_hi = min(k_lo + kps, kmax);

  // The keys of this warp: batches of kU steps of KPW rows; batch i, step u
  // is key row base + i * kU * kStep + u * kStep + gi. The count of batches
  // is uniform over the warp, so every lane runs every shuffle.
  const int base = k_lo + w * KPW;
  const int nb = base < k_hi ? (k_hi - base + kU * kStep - 1) / (kU * kStep) : 0;
  const T* kp = k + static_cast<size_t>(bkv) * lk * dh;
  const T* vp = v + static_cast<size_t>(bkv) * lk * dh;
  // slot of (stage, step u, K or V, chunk cc) that this thread fills and reads
  auto slot = [&](int stage, int u, int kv, int cc) {
    return ring + (((stage * kU + u) * 2 + kv) * CPL + cc) * kThreads + tid;
  };
  auto copy_batch = [&](int i) {
    const int stage = i % kStages;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int key = base + (i * kU + u) * kStep + gi;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = li + cc * LPK;
        const bool ok = key < k_hi && c < nch;
        const size_t off = ok ? static_cast<size_t>(key) * dh + c * V : 0;
        cp_async16(slot(stage, u, 0, cc), kp + off, ok);
        cp_async16(slot(stage, u, 1, cc), vp + off, ok);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nb) copy_batch(i);
    cp_async_commit();
  }

  // the query rows, scaled into the log2 domain; rows past nrows are 0
  for (int e = tid; e < R * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh, slot_ = slot0 + r;
    const size_t bh = static_cast<size_t>(b) * hq + kvh * group + slot_ / lq;
    sq[e] = r < nrows ? to_f32(q[(bh * lq + slot_ % lq) * dh + d]) * scale_log2 : 0.f;
  }
  __syncthreads();

  // Every loop over the rows is unrolled and free of branches, so the
  // rows' dot products and shuffle reductions interleave; a row past nrows
  // sees no key (kend 0) and stays at m = -inf, l = 0.
  int kend[R];
  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    kend[r] = r >= nrows ? 0 : min(k_hi, causal ? q_offset + (slot0 + r) % lq + 1 : lk);
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  // this lane's elements of the query rows; a lane past the row's chunks
  // takes chunk nch - 1 of the query and reads zeros of K and V
  float qv[R][E];
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc) {
    const int off = min(li + cc * LPK, nch - 1) * V;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) qv[r][cc * V + j] = sq[r * dh + off + j];
  }

  for (int i = 0; i < nb; ++i) {
    if (i + kStages - 1 < nb) copy_batch(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of batch i landed
    const int stage = i % kStages;
    float sc[kU][R];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[E];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) unpack(*slot(stage, u, 0, cc), kf + cc * V, T());
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[r][e], kf[e], dot);
        sc[u][r] = dot;
      }
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) sc[u][r] += __shfl_xor_sync(kAll, sc[u][r], o);
    float mu[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int key = base + (i * kU + u) * kStep + gi;
        sc[u][r] = key < kend[r] ? sc[u][r] : -INFINITY;
        mx = fmaxf(mx, sc[u][r]);
      }
      const float m_new = fmaxf(m[r], mx);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - mu[r]);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[E];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) unpack(*slot(stage, u, 1, cc), vf + cc * V, T());
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = exp2f(sc[u][r] - mu[r]);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the KPW key slots of the warp (lanes li, li + LPK, ...)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mw = m[r];
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(kAll, mw, o));
    const float f = exp2f(m[r] - (mw == -INFINITY ? 0.f : mw));
    float lw = l[r] * f;
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) lw += __shfl_xor_sync(kAll, lw, o);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float a = acc[r][e] * f;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) a += __shfl_xor_sync(kAll, a, o);
      acc[r][e] = a;
    }
    m[r] = mw;
    l[r] = lw;
  }
  if (gi == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nrows) break;
      if (li == 0) {
        wm[w * R + r] = m[r];
        wl[w * R + r] = l[r];
      }
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = li + cc * LPK;
        if (c < nch)
#pragma unroll
          for (int j = 0; j < V; ++j) wacc[(w * R + r) * dh + c * V + j] = acc[r][cc * V + j];
      }
    }
  }
  __syncthreads();

  // this split's (m, l, acc[dh]) per row: m at [r], l at [R + r], acc at
  // [2 R + r dh + d]
  const int stride = R * (dh + 2);
  float* part = ws + (static_cast<size_t>(bx) * splits + split) * stride;
  for (int e = tid; e < nrows * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) mx = fmaxf(mx, wm[j * R + r]);
    const float mz = mx == -INFINITY ? 0.f : mx;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) a += wacc[(j * R + r) * dh + d] * exp2f(wm[j * R + r] - mz);
    part[2 * R + e] = a;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) mx = fmaxf(mx, wm[j * R + r]);
    const float mz = mx == -INFINITY ? 0.f : mx;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) ls += wl[j * R + r] * exp2f(wm[j * R + r] - mz);
    part[r] = mx;
    part[R + r] = ls;
  }

  // the last split of this (b * hkv, row chunk) to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(tickets + bx, 1) == splits - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const float* parts = ws + static_cast<size_t>(bx) * splits * stride;
  for (int e = tid; e < splits * nrows; e += kThreads) {
    const int s = e / nrows, r = e - s * nrows;
    sm[s * R + r] = __ldcg(parts + static_cast<size_t>(s) * stride + r);
    sl[s * R + r] = __ldcg(parts + static_cast<size_t>(s) * stride + R + r);
  }
  __syncthreads();
  // each row's weights 2^(m_s - max m) over sm, its sum over sl[0]
  for (int r = tid; r < nrows; r += kThreads) {
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, sm[s * R + r]);
    const float mz = mx == -INFINITY ? 0.f : mx;
    float ls = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float f = exp2f(sm[s * R + r] - mz);
      sm[s * R + r] = f;
      ls += sl[s * R + r] * f;
    }
    sl[r] = ls;
  }
  __syncthreads();
  for (int e = tid; e < nrows * dh; e += kThreads) {
    const int r = e / dh, slot_ = slot0 + r;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      a += sm[s * R + r] * __ldcg(parts + static_cast<size_t>(s) * stride + 2 * R + e);
    const float ls = sl[r];
    const size_t bh = static_cast<size_t>(b) * hq + kvh * group + slot_ / lq;
    store(out + (bh * lq + slot_ % lq) * dh + (e - r * dh), ls > 0.f ? a / ls : 0.f);
  }
  if (tid == 0) tickets[bx] = 0;
}

template <typename T, int LPK, int CPL, int R>
int launch_v(const void* q, const void* k, const void* v, void* out, float* ws, int* tickets,
             int b, int hq, int hkv, int lq, int lk, int dh, int causal, int q_offset,
             float scale, int rows, int splits, int kps, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, LPK, CPL, R>;
  const size_t smem = smem_bytes(CPL, R, dh);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunk = ((hq / hkv) * lq + rows - 1) / rows;
  const dim3 grid(b * hkv * nchunk, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), ws, tickets, hq, hkv, lq, lk, dh, causal, q_offset, scale * kLog2e,
      rows, nchunk, kps);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel resident on one SM, into *n.
template <typename T, int LPK, int CPL, int R>
int occupancy_v(int dh, int* n) {
  auto kernel = flash_decode_kernel<T, LPK, CPL, R>;
  const size_t smem = smem_bytes(CPL, R, dh);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, kThreads, smem);
  return static_cast<int>(err);
}

// Registers, static shared, local (spill) and dynamic shared bytes.
template <typename T, int LPK, int CPL, int R>
int attributes_v(int dh, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_decode_kernel<T, LPK, CPL, R>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(smem_bytes(CPL, R, dh));
  return 0;
}

// The variant that serves a row of dh values of T: LPK lanes a key row,
// CPL 16-byte chunks a lane.
#define FD_DISPATCH(T, R, FN, ...)                                 \
  do {                                                             \
    const int nch_ = dh * static_cast<int>(sizeof(T)) / 16;        \
    if (nch_ <= 16) return FN<T, 16, 1, R>(__VA_ARGS__);           \
    if (nch_ <= 32) return FN<T, 32, 1, R>(__VA_ARGS__);           \
    return FN<T, 32, 2, R>(__VA_ARGS__);                           \
  } while (0)

template <typename T, int R>
int launch_r(const void* q, const void* k, const void* v, void* out, float* ws, int* tickets,
             int b, int hq, int hkv, int lq, int lk, int dh, int causal, int q_offset,
             float scale, int rows, int splits, int kps, cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits || rows < 1 || rows > 8 || kps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FD_DISPATCH(T, R, launch_v, q, k, v, out, ws, tickets, b, hq, hkv, lq, lk, dh, causal,
              q_offset, scale, rows, splits, kps, stream);
}
template <typename T, int R>
int occupancy_r(int dh, int* n) {
  FD_DISPATCH(T, R, occupancy_v, dh, n);
}
template <typename T, int R>
int attributes_r(int dh, int* out) {
  FD_DISPATCH(T, R, attributes_v, dh, out);
}

// FN<T, R>(args...) for the rows a block: R = rows up to 4, else 8.
#define FD_R(T, FN, ...)                                                     \
  (rows <= 1   ? FN<T, 1>(__VA_ARGS__)                                       \
   : rows == 2 ? FN<T, 2>(__VA_ARGS__)                                       \
   : rows == 3 ? FN<T, 3>(__VA_ARGS__)                                       \
   : rows == 4 ? FN<T, 4>(__VA_ARGS__)                                       \
               : FN<T, 8>(__VA_ARGS__))
#define FD_ROWS(FN, ...) \
  (is_bf16 ? FD_R(__nv_bfloat16, FN, __VA_ARGS__) : FD_R(float, FN, __VA_ARGS__))

}  // namespace

// q: [b, hq, lq, dh], k, v: [b, hkv, lk, dh], out: [b, hq, lq, dh], all
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1). rows: query
// rows a block (1..8; the kernel is built for 1, 2, 3, 4 or 8), splits: key
// splits (1..64), kps: keys a split (splits * kps >= the admitted keys).
// ws: float32 workspace of b * hkv * ceil(hq / hkv * lq / rows) * splits *
// R * (dh + 2) floats, R = rows up to 4, else 8; tickets: one int32 zero per
// (b * hkv, row chunk), left zero. The caller guarantees b, hq, hkv, lq, lk
// >= 1, hq % hkv == 0, 1 <= dh <= 256 a whole number of 16-byte chunks, k
// and v 16-byte aligned, a grid within CUDA's limits, and, when causal,
// q_offset + lq <= lk. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, void* out,
                                   void* ws, void* tickets, int is_bf16, int b, int hq, int hkv,
                                   int lq, int lk, int dh, int causal, int q_offset, float scale,
                                   int rows, int splits, int kps, cudaStream_t stream) {
  return FD_ROWS(launch_r, q, k, v, out, static_cast<float*>(ws), static_cast<int*>(tickets), b,
                 hq, hkv, lq, lk, dh, causal, q_offset, scale, rows, splits, kps, stream);
}

// Blocks of the kernel a call with these arguments takes that one SM
// holds at once, into *n.
extern "C" int flash_decode_occupancy(int is_bf16, int dh, int rows, int* n) {
  return FD_ROWS(occupancy_r, dh, n);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// dynamic shared bytes of the kernel a call with these arguments takes,
// into out[0..3].
extern "C" int flash_decode_attributes(int is_bf16, int dh, int rows, int* out) {
  return FD_ROWS(attributes_r, dh, out);
}

// The most splits a call may take: the merge's shared memory is sized for
// them. The wrapper's split planner reads its cap here.
extern "C" int flash_decode_max_splits() { return kMaxSplits; }
