// The backward of causal grouped-query attention on the CUDA cores (sm_90a),
// float32: the "simt" route of kernels/flash_attention.py bwd_route (bf16
// takes the tensor cores, flash_attention_bwd_tc.cu).
//
// Differentiates the function of the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas) as the LM training step calls it: causal, query
// offset 0, as many queries as keys. The JAX package has no backward kernel:
// it trains through its plain _attention (repro/models/transformer.py), a
// query-chunked float32 softmax recomputed a chunk at a time in the
// backward. This kernel computes the same gradient, dQ, dK and dV of
//   out[b, h, i] = sum_j P[i, j] v[b, h / group, j],
//   P[i, j] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale), j <= i,
// given dO = d loss / d out and the forward's output O: with
// D[i] = sum_d dO[i, d] O[i, d] and dS = P * (dO V^T - D),
//   dV = P^T dO,  dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the query heads of each KV head. q, o, dout, dq:
// [b, hq, l, dh]; k, v, dk, dv: [b, hkv, l, dh]; all float32, contiguous,
// dh 64 or 128. Every product, the softmax and every sum are float32.
//
// Two launches, deterministic, no atomics:
// (a) flash_attention_bwd_dq_kernel, one block per (b * hq, 64-query tile):
//     a first pass over the tile's keys takes each row's max and sum of
//     exp (its log-sum-exp, LSE), D from O and dO; a second pass
//     recomputes the scores, P = exp(S - LSE), dP = dO V^T and dS, and
//     adds dS K into dQ held in registers. It writes LSE and D to a
//     float32 scratch for (b).
// (b) flash_attention_bwd_dkdv_kernel, one block per (b * hkv, 64-key
//     tile): for each query head of the group and each query tile on or
//     past the diagonal, recompute P^T and dP^T from the tile's keys and
//     values and the queries, LSE and D, and add P^T dO into dV and dS^T Q
//     into dK, held in registers; the group's heads are summed inside the
//     block. Query tiles wholly before the key tile are skipped (causal).
// Tiles are in shared memory, transposed ([dh][64 + 4]) for the
// score products; thread (ty, tx) of 16 x 16 takes a 4 x 4 block of
// scores and 4 rows x dh / 16 columns of its accumulators, as the forward
// CUDA-core kernel (flash_attention.cu) does.
//
// Bound: operations. The step needs five causal products of
// 2 * b * hq * l^2 * dh / 2 FLOP (S, dP, dV, dQ, dK); this kernel does
// eight (S in both passes of (a) and in (b), dP in both kernels), all on
// the float32 CUDA cores (67 TFLOP/s peak), the bound of float32 inputs.
// Its time on an H100 is in PERF.md (chip_smoke.py, kernel_check
// "flash_attention_bwd", the float32 cases).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // query rows or keys per tile
constexpr int kS = kTile + 4;  // row stride of a transposed tile and of a P / dS tile
constexpr unsigned kAll = 0xffffffffu;

// dst[d * kS + j] = src[(row0 + j) * DH + d] for the kTile rows from
// row0, zero for rows at or past end. Each thread loads its 16-byte chunks
// first (all in flight), then stores them; neighbouring threads take
// neighbouring rows, so the transposed stores hit distinct banks.
template <int DH>
__device__ __forceinline__ void load_transposed(const float* __restrict__ src, int row0,
                                                int end, float* dst) {
  constexpr int V = 4;
  constexpr int CH = kTile * DH / V;
  constexpr int C = (CH + kThreads - 1) / kThreads;
  float4 r[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = threadIdx.x + c * kThreads;
    const int j = e % kTile;
    r[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < CH && row0 + j < end)
      r[c] = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + j) * DH + (e / kTile) * V));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = threadIdx.x + c * kThreads;
    if (e < CH) {
      const int j = e % kTile, d0 = (e / kTile) * V;
      dst[d0 * kS + j] = r[c].x;
      dst[(d0 + 1) * kS + j] = r[c].y;
      dst[(d0 + 2) * kS + j] = r[c].z;
      dst[(d0 + 3) * kS + j] = r[c].w;
    }
  }
}

// acc[i][jj] += sum_d a[d][ra + i] * b[d][rb + jj] over transposed tiles
// (4 x 4 of the 64 x 64 product), for two products at once.
template <int DH>
__device__ __forceinline__ void two_products(const float* a1, const float* b1, const float* a2,
                                             const float* b2, int ra, int rb, float (&s1)[4][4],
                                             float (&s2)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s1[i][jj] = s2[i][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + d * kS + ra);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + d * kS + rb);
    const float4 x2 = *reinterpret_cast<const float4*>(a2 + d * kS + ra);
    const float4 y2 = *reinterpret_cast<const float4*>(b2 + d * kS + rb);
    const float xa[4] = {x1.x, x1.y, x1.z, x1.w};
    const float ya[4] = {y1.x, y1.y, y1.z, y1.w};
    const float xb[4] = {x2.x, x2.y, x2.z, x2.w};
    const float yb[4] = {y2.x, y2.y, y2.z, y2.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s1[i][jj] = fmaf(xa[i], ya[jj], s1[i][jj]);
        s2[i][jj] = fmaf(xb[i], yb[jj], s2[i][jj]);
      }
  }
}

// Floats of dynamic shared memory: (a) qT, doT, kT, vT and a dS tile;
// (b) kT, vT, qT, doT and a P and a dS tile.
constexpr size_t dq_smem_floats(int dh) { return 4 * static_cast<size_t>(dh) * kS + kTile * kS; }
constexpr size_t dkdv_smem_floats(int dh) {
  return 4 * static_cast<size_t>(dh) * kS + 2 * kTile * kS;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ o,
                                  const float* __restrict__ dout, float* __restrict__ dq,
                                  float* __restrict__ lse_out, float* __restrict__ delta_out,
                                  int hq, int group, int l, float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* doT = qT + DH * kS;
  float* kT = doT + DH * kS;
  float* vT = kT + DH * kS;
  float* ds = vT + DH * kS;  // dS[i][j] at ds[i * kS + j]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  // the last query tiles see the most keys: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int b = bh / hq, h = bh - b * hq;
  const size_t kvh = static_cast<size_t>(b) * (hq / group) + h / group;
  const size_t qoff = static_cast<size_t>(bh) * l * DH;
  const float* kp = k + kvh * l * DH;
  const float* vp = v + kvh * l * DH;

  load_transposed<DH>(q + qoff, q0, l, qT);
  load_transposed<DH>(dout + qoff, q0, l, doT);
  __syncthreads();

  // D[i] = sum_d dO[i, d] O[i, d], over the row's 16 tx lanes
  float dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    dsum[i] = 0.f;
    if (row < l) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 16 + tx;
        dsum[i] = fmaf(o[qoff + static_cast<size_t>(row) * DH + col],
                       doT[col * kS + ty * 4 + i], dsum[i]);
      }
    }
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) dsum[i] += __shfl_xor_sync(kAll, dsum[i], s);
  }

  const int kend = min(q0 + kTile, l);  // causal: keys up to the tile's last row

  // pass 1: each row's max and sum of exp over its keys
  float m[4], lsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
  }
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_transposed<DH>(kp, k0, kend, kT);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 x = *reinterpret_cast<const float4*>(qT + d * kS + ty * 4);
      const float4 y = *reinterpret_cast<const float4*>(kT + d * kS + tx * 4);
      const float xa[4] = {x.x, x.y, x.z, x.w};
      const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(xa[i], ya[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx * 4 + jj;
        s[i][jj] = kpos < kend && kpos <= qpos ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sum += expf(s[i][jj] - m_use);
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) sum += __shfl_xor_sync(kAll, sum, o2);
      lsum[i] = lsum[i] * expf(m[i] - m_use) + sum;
      m[i] = m_new;
    }
    __syncthreads();  // kT is refilled by the next tile
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse[i] = lsum[i] > 0.f ? m[i] + logf(lsum[i]) : 0.f;
    if (row < l && tx == 0) {
      lse_out[static_cast<size_t>(bh) * l + row] = lse[i];
      delta_out[static_cast<size_t>(bh) * l + row] = dsum[i];
    }
  }

  // pass 2: dQ = scale * dS K
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_transposed<DH>(kp, k0, kend, kT);
    load_transposed<DH>(vp, k0, kend, vT);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<DH>(qT, kT, doT, vT, ty * 4, tx * 4, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float dsv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx * 4 + jj;
        const float p = kpos < kend && kpos <= qpos ? expf(s[i][jj] * scale - lse[i]) : 0.f;
        dsv[jj] = p * (dp[i][jj] - dsum[i]);
      }
      *reinterpret_cast<float4*>(ds + (ty * 4 + i) * kS + tx * 4) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dsj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsj[i] = ds[(ty * 4 + i) * kS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kb = kT[(c * 16 + tx) * kS + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsj[i], kb, acc[i][c]);
      }
    }
    __syncthreads();  // kT, vT and ds are refilled by the next tile
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= l) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[qoff + static_cast<size_t>(row) * DH + c * 16 + tx] = acc[i][c] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ dout,
                                    const float* __restrict__ lse_in,
                                    const float* __restrict__ delta_in, float* __restrict__ dk,
                                    float* __restrict__ dv, int hq, int group, int l, float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);
  float* vT = kT + DH * kS;
  float* qT = vT + DH * kS;
  float* doT = qT + DH * kS;
  float* ps = doT + DH * kS;  // P[i][j] at ps[i * kS + j] (i a query, j a key)
  float* dss = ps + kTile * kS;
  __shared__ float s_lse[kTile], s_delta[kTile];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.x;  // b * hkv + kv head
  const int hkv = hq / group;
  const int b = bkv / hkv, hk = bkv - b * hkv;
  // the first key tiles are seen by the most queries: start them first
  const int k0 = blockIdx.y * kTile;
  const size_t koff = static_cast<size_t>(bkv) * l * DH;

  load_transposed<DH>(k + koff, k0, l, kT);
  load_transposed<DH>(v + koff, k0, l, vT);

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[jj][c] = adv[jj][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const size_t bh = static_cast<size_t>(b) * hq + hk * group + g;
    const float* qp = q + bh * l * DH;
    const float* dop = dout + bh * l * DH;
    for (int q0 = k0; q0 < l; q0 += kTile) {  // causal: queries before k0 see none
      load_transposed<DH>(qp, q0, l, qT);
      load_transposed<DH>(dop, q0, l, doT);
      if (tid < kTile) {
        const int row = q0 + tid;
        s_lse[tid] = row < l ? lse_in[bh * l + row] : 0.f;
        s_delta[tid] = row < l ? delta_in[bh * l + row] : 0.f;
      }
      __syncthreads();
      // scores transposed: s[jj][ii] for key ty * 4 + jj, query tx * 4 + ii
      float s[4][4], dp[4][4];
      two_products<DH>(kT, qT, vT, doT, ty * 4, tx * 4, s, dp);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int qi = tx * 4 + ii, qpos = q0 + qi;
        float pv[4], dsv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kpos = k0 + ty * 4 + jj;
          const float p = qpos < l && kpos <= qpos ? expf(s[jj][ii] * scale - s_lse[qi]) : 0.f;
          pv[jj] = p;
          dsv[jj] = p * (dp[jj][ii] - s_delta[qi]);
        }
        *reinterpret_cast<float4*>(ps + qi * kS + ty * 4) = make_float4(pv[0], pv[1], pv[2],
                                                                        pv[3]);
        *reinterpret_cast<float4*>(dss + qi * kS + ty * 4) =
            make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
      }
      __syncthreads();
      const int rows = min(kTile, l - q0);
      for (int i = 0; i < rows; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kS + ty * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(dss + i * kS + ty * 4);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = doT[(c * 16 + tx) * kS + i];
          const float qv = qT[(c * 16 + tx) * kS + i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            adv[jj][c] = fmaf(pa[jj], ov, adv[jj][c]);
            adk[jj][c] = fmaf(da[jj], qv, adk[jj][c]);
          }
        }
      }
      __syncthreads();  // qT, doT, ps, dss and the row statistics are refilled
    }
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int key = k0 + ty * 4 + jj;
    if (key >= l) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t at = koff + static_cast<size_t>(key) * DH + c * 16 + tx;
      dk[at] = adk[jj][c] * scale;
      dv[at] = adv[jj][c];
    }
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           float* dq, float* dk, float* dv, float* lse, float* delta, int b, int hq, int hkv,
           int l, float scale, cudaStream_t stream) {
  const size_t smem_a = dq_smem_floats(DH) * sizeof(float);
  const size_t smem_b = dkdv_smem_floats(DH) * sizeof(float);
  auto ka = flash_attention_bwd_dq_kernel<DH>;
  auto kb = flash_attention_bwd_dkdv_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (l + kTile - 1) / kTile;
  ka<<<dim3(b * hq, tiles), kThreads, smem_a, stream>>>(q, k, v, o, dout, dq, lse, delta, hq,
                                                         hq / hkv, l, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<dim3(b * hkv, tiles), kThreads, smem_b, stream>>>(q, k, v, dout, lse, delta, dk, dv, hq,
                                                          hq / hkv, l, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int attributes(int which, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, flash_attention_bwd_dq_kernel<DH>)
                 : cudaFuncGetAttributes(&a, flash_attention_bwd_dkdv_kernel<DH>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>((which == 0 ? dq_smem_floats(DH) : dkdv_smem_floats(DH)) *
                            sizeof(float));
  return 0;
}

}  // namespace

// q, o, dout, dq: [b, hq, l, dh]; k, v, dk, dv: [b, hkv, l, dh], all
// contiguous, 16-byte aligned float32; lse, delta: float32 scratch of
// b * hq * l. Causal with query offset 0. The caller guarantees b, hq,
// hkv, l >= 1, hq % hkv == 0, dh 64 or 128, b * hq < 2**31 and ceil(l / 64)
// <= 65,535. Launches (a) then (b) on the stream; returns the first
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(const float* q, const float* k, const float* v,
                                          const float* o, const float* dout, float* dq,
                                          float* dk, float* dv, float* lse, float* delta, int b,
                                          int hq, int hkv, int l, int dh, float scale,
                                          cudaStream_t stream) {
#define FAB_ARGS q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, l, scale, stream
  if (dh == 64) return launch<64>(FAB_ARGS);
  if (dh == 128) return launch<128>(FAB_ARGS);
#undef FAB_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// dynamic shared bytes of kernel (a) (which = 0) or (b) (which = 1) for
// dh, into out[0..3].
extern "C" int flash_attention_bwd_attributes(int dh, int which, int* out) {
  if (dh == 64) return attributes<64>(which, out);
  if (dh == 128) return attributes<128>(which, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
