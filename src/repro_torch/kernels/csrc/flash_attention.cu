// Flash attention on the CUDA cores (sm_90a): causal or non-causal
// grouped-query attention with a query offset, for the calls the
// tensor-core kernel (flash_attention_tc.cu) does not take: float32, and
// bfloat16 with dh other than 64 or 128, at lq > 16 (prefill and chunked
// prefill; lq <= 16 goes to flash_decode.cu).
//
// Replaces, for those calls, the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas): out[b, h, i] = softmax_j(q[b, h, i] .
// k[b, h / group, j] / sqrt(dh)) v[b, h / group, j] over the keys
// j < lk, and, when causal, j <= i + q_offset. q: [b, hq, lq, dh],
// k, v: [b, hkv, lk, dh], all float32 or all bfloat16, contiguous;
// out: [b, hq, lq, dh] in q's type. The softmax and both sums are float32;
// a row that sees no key is written as 0.
//
// The TPU kernel runs a (b * hq, query tile, key tile) grid whose last axis
// is sequential, carrying the online-softmax state (m, l, acc) in scratch
// memory from one key tile to the next. Here blocks run in parallel and in
// no order, so one block owns one (b * hq, 64-row query tile) and walks the
// keys in a loop, keeping (m, l, acc) in registers. Keys past the causal
// diagonal of the tile's last query row are never loaded; keys at >= lk
// are masked by bounds, not by padded copies. Dh must be a whole number of
// 16-byte chunks and K and V 16-byte aligned: every key/value load is a
// 16-byte chunk.
//
// 256 threads as 16 x 16 (ty, tx); thread (ty, tx) computes the scores of
// rows ty * 4 + i and keys tx * 4 + jj of a 64-key tile with float32 FMAs
// from a transposed query tile and a transposed key tile in shared memory
// (float4 reads, no bank conflicts); a row's max and sum are reduced over
// its 16 tx lanes with warp shuffles. The probabilities go to shared
// memory (over the key tile, which is dead by then), and the thread adds
// P V into columns c * 16 + tx of its rows. A key/value tile is loaded in
// 16-byte chunks, all in flight at once, and converted to float32 as it is
// stored.
//
// Bound: operations. The float32 gate's prefill (b 2, hq 24, lq 2,048,
// dh 128, causal) does 4 * dh FLOP per admitted (query, key) pair on the
// float32 CUDA cores, whose peak is 67 TFLOP/s: 0.77 ms. Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: 2.56 ms, 20 TFLOP/s, 3.3x
// that bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per tile of flash_attention_kernel
constexpr int kQS = kBQ + 4;   // row stride of the transposed query tile
constexpr int kBK = 64;        // keys per tile
constexpr int kKS = kBK + 4;   // row stride of the transposed key tile
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// One key/value tile: each thread loads up to C 16-byte chunks of K and of
// V into registers (all in flight at once), then stores them as float32.
// Chunk e of the tile is key e % kBK, columns (e / kBK) * V ... + V - 1, so
// a warp's 32 threads hold 32 neighbouring keys: their stores to the
// transposed key tile hit 32 banks, and the value tile's row stride of
// 16 * NC + 4 floats keeps its float4 stores apart.
template <typename T, int NC>
__device__ __forceinline__ void load_tile(const T* kp, const T* vp, int k0, int kend, int dh,
                                          float* kT, float* vs) {
  constexpr int V = 16 / sizeof(T);  // elements per chunk
  constexpr int C = (kBK * 16 * NC / V + kThreads - 1) / kThreads;
  constexpr int VS = 16 * NC + 4;
  const int chunks = kBK * (dh / V);
  uint4 kr[C], vr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = threadIdx.x + c * kThreads;
    const int j = e % kBK;
    kr[c] = vr[c] = make_uint4(0, 0, 0, 0);
    if (e < chunks && k0 + j < kend) {
      const size_t g = static_cast<size_t>(k0 + j) * dh + (e / kBK) * V;
      kr[c] = __ldg(reinterpret_cast<const uint4*>(kp + g));
      vr[c] = __ldg(reinterpret_cast<const uint4*>(vp + g));
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = threadIdx.x + c * kThreads;
    if (e < chunks) {
      const int j = e % kBK, d0 = (e / kBK) * V;
      float f[V];
      unpack(kr[c], f, T());
#pragma unroll
      for (int t = 0; t < V; ++t) kT[(d0 + t) * kKS + j] = f[t];
      unpack(vr[c], f, T());
#pragma unroll
      for (int t = 0; t < V; t += 4)
        *reinterpret_cast<float4*>(vs + j * VS + d0 + t) =
            make_float4(f[t], f[t + 1], f[t + 2], f[t + 3]);
    }
  }
}

// Floats of shared memory of the 64-row kernel: the transposed query tile
// [dh][kQS], the transposed key tile [dh][kKS] (reused for the transposed
// probabilities [kBK][kQS]) and the value tile [kBK][16 * NC + 4].
size_t smem_floats(int nc, int dh) {
  const size_t kt = static_cast<size_t>(dh) * kKS;
  const size_t pt = static_cast<size_t>(kBK) * kQS;
  return static_cast<size_t>(dh) * kQS + (kt > pt ? kt : pt) +
         static_cast<size_t>(kBK) * (16 * nc + 4);
}

// Two blocks per SM where the registers allow it (bf16, Dh <= 128).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && NC <= 8 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int hq, int group, int lq, int lk, int dh,
                           int causal, int q_offset, float scale) {
  constexpr int VS = 16 * NC + 4;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + dh * kQS;
  float* pT = kT;  // the key tile is dead once the scores are taken
  float* vs = kT + (dh * kKS > kBK * kQS ? dh * kKS : kBK * kQS);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;  // b * hq + h
  // The last query tiles see the most keys: start them first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / hq, h = bh - b * hq;
  const size_t kvh = static_cast<size_t>(b) * (hq / group) + h / group;
  const T* qp = q + static_cast<size_t>(bh) * lq * dh;
  const T* kp = k + kvh * lk * dh;
  const T* vp = v + kvh * lk * dh;

  for (int e = tid; e < kBQ * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    qT[d * kQS + r] = q0 + r < lq ? to_f32(qp[static_cast<size_t>(q0 + r) * dh + d]) : 0.f;
  }

  // Keys this tile of queries can see.
  const int last_row = min(q0 + kBQ, lq) - 1;
  const int kend = causal ? min(lk, q_offset + last_row + 1) : lk;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    load_tile<T, NC>(kp, vp, k0, kend, dh, kT, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float4 kb = *reinterpret_cast<const float4*>(kT + d * kKS + tx * 4);
      const float4 q4 = *reinterpret_cast<const float4*>(qT + d * kQS + ty * 4);
      const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qa[i], kb.x, s[i][0]);
        s[i][1] = fmaf(qa[i], kb.y, s[i][1]);
        s[i][2] = fmaf(qa[i], kb.z, s[i][2]);
        s[i][3] = fmaf(qa[i], kb.w, s[i][3]);
      }
    }
    __syncthreads();  // every thread is done with kT: pT may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx * 4 + jj;
        const bool ok = kpos < kend && (!causal || kpos <= qpos);
        s[i][jj] = ok ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_use);
        pT[(tx * 4 + jj) * kQS + ty * 4 + i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kAll, sum, o);
      const float corr = expf(m[i] - m_use);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + j * kQS + ty * 4);
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vb = vs[j * VS + c * 16 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
    __syncthreads();  // kT, pT and vs are refilled by the next tile
  }

  T* op = out + static_cast<size_t>(bh) * lq * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 16 + tx;
      if (col < dh)
        store(op + static_cast<size_t>(row) * dh + col, l[i] > 0.f ? acc[i][c] / l[i] : 0.f);
    }
  }
}

template <typename T, int NC>
int launch_tile(const T* q, const T* k, const T* v, T* out, int b, int hq, int hkv, int lq,
                int lk, int dh, int causal, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(NC, dh) * sizeof(float);
  auto kernel = flash_attention_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, hq, hq / hkv, lq, lk, dh, causal,
                                           q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int lq, int lk, int dh, int causal, int q_offset, float scale, cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
#define FA_ARGS qq, kk, vv, oo, b, hq, hkv, lq, lk, dh, causal, q_offset, scale, stream
  if (dh <= 16) return launch_tile<T, 1>(FA_ARGS);
  if (dh <= 32) return launch_tile<T, 2>(FA_ARGS);
  if (dh <= 64) return launch_tile<T, 4>(FA_ARGS);
  if (dh <= 128) return launch_tile<T, 8>(FA_ARGS);
  return launch_tile<T, 16>(FA_ARGS);
#undef FA_ARGS
}

}  // namespace

// q: [b, hq, lq, dh], k, v: [b, hkv, lk, dh], out: [b, hq, lq, dh], all
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1). The caller
// guarantees b, hq, hkv, lq, lk >= 1, hq % hkv == 0, 1 <= dh <= 256, dh a
// whole number of 16-byte chunks, k and v 16-byte aligned, b * hq < 2**31,
// ceil(lq / 64) <= 65,535, and, when causal, q_offset + lq <= lk. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int is_bf16, int b, int hq, int hkv, int lq, int lk,
                                      int dh, int causal, int q_offset, float scale,
                                      cudaStream_t stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, lq, lk, dh, causal, q_offset, scale,
                                 stream);
  return launch<float>(q, k, v, out, b, hq, hkv, lq, lk, dh, causal, q_offset, scale, stream);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// dynamic shared bytes of the kernel a call with these arguments takes,
// into out[0..3].
extern "C" int flash_attention_attributes(int is_bf16, int dh, int* out) {
  cudaFuncAttributes a;
  const int nc = dh <= 16 ? 1 : dh <= 32 ? 2 : dh <= 64 ? 4 : dh <= 128 ? 8 : 16;
  cudaError_t err;
  if (is_bf16)
    err = nc == 1    ? cudaFuncGetAttributes(&a, flash_attention_kernel<__nv_bfloat16, 1>)
          : nc == 2  ? cudaFuncGetAttributes(&a, flash_attention_kernel<__nv_bfloat16, 2>)
          : nc == 4  ? cudaFuncGetAttributes(&a, flash_attention_kernel<__nv_bfloat16, 4>)
          : nc == 8  ? cudaFuncGetAttributes(&a, flash_attention_kernel<__nv_bfloat16, 8>)
                     : cudaFuncGetAttributes(&a, flash_attention_kernel<__nv_bfloat16, 16>);
  else
    err = nc == 1    ? cudaFuncGetAttributes(&a, flash_attention_kernel<float, 1>)
          : nc == 2  ? cudaFuncGetAttributes(&a, flash_attention_kernel<float, 2>)
          : nc == 4  ? cudaFuncGetAttributes(&a, flash_attention_kernel<float, 4>)
          : nc == 8  ? cudaFuncGetAttributes(&a, flash_attention_kernel<float, 8>)
                     : cudaFuncGetAttributes(&a, flash_attention_kernel<float, 16>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(smem_floats(nc, dh) * sizeof(float));
  return 0;
}

// Query rows a block owns (kBQ): the grid has ceil(lq / kBQ) rows of blocks.
extern "C" int flash_attention_block_rows() { return kBQ; }
