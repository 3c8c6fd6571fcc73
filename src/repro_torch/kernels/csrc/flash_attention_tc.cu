// Flash attention on Hopper's tensor cores (sm_90a): bf16 prefill and
// chunked prefill at the (Dqk, Dv) widths (64, 64), (128, 128) and MLA's
// (96, 64) (minicpm3-4b) and (192, 128) (deepseek-v2-lite-16b).
//
// Replaces, for those calls, the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas; at Dv != Dqk the JAX model's reference,
// repro/models/transformer.py _attention): out[b, h, i] = softmax_j(q[b, h,
// i] . k[b, h / group, j] / sqrt(dqk)) v[b, h / group, j] over the keys j <
// lk and, when causal, j <= i + q_offset; float32 softmax and sums, the
// output rounded once to bf16. q: [b, hq, lq, dqk], k: [b, hkv, lk, dqk],
// v: [b, hkv, lk, dv], out: [b, hq, lq, dv], bf16, contiguous; a row that
// sees no key is written as 0. V is read at its own width: no zero columns
// are built, loaded or multiplied.
//
// Design. A block owns one (b * hq, 192-row query tile). Tiles that start
// latest in the sequence go first. The block walks the key tiles (64
// keys) up to the causal diagonal of its last row; keys past it are never
// loaded.
// - Copies: one thread of a producer warpgroup loads the Q tile, then each
//   K/V tile into a ring of stages (four; three at (192, 128), where four
//   would take 238,664 bytes of the 232,448 a block may have), by TMA
//   (cp.async.bulk.tensor over 3-D tensor maps [b * heads, rows, width],
//   V's over its own dv columns, so a box past the last row is zero-filled
//   and not read from the next head), reported to a "full" mbarrier per
//   stage; it refills a stage once every consumer has arrived on its
//   "empty" mbarrier. The producer warpgroup gives its registers to the
//   consumers (setmaxnreg: 32 a thread against 160).
// - Layout: TMA's 128-byte swizzle stores each tile as 64-column blocks of
//   128-byte rows (16-byte chunk c of row r at chunk c ^ (r % 8)), the
//   layout the wgmma descriptors below name: Q and K K-major, V ([keys,
//   dv], dv contiguous) MN-major, the B operand of P V with the transpose
//   bit. Q and K take ceil(dqk / 64) blocks: at dqk 96 the second block's
//   box starts at column 64 and lies half past the tensor map's 96
//   columns; TMA fills columns 96-127 with zeros without reading memory,
//   and the full box's bytes count toward the stage's transaction bytes
//   (as for a box past the last row). The zero half takes shared memory
//   only (148,552 bytes a block at (96, 64)) and is never multiplied.
//   A 64-byte swizzle over 32-column boxes would fit 96 columns exactly,
//   but needs a second descriptor layout and tensor-map form beside the one
//   every other width uses; shared memory, not global traffic, is the
//   whole price, and four stages still fit.
// - Three consumer warpgroups of 64 query rows run on their own, with no
//   block barrier, so one's softmax overlaps the others' products.
// - S = Q K^T: dqk / 16 steps of wgmma m64n64k16 (six at 96), A (Q) and B
//   (K) from shared memory, float32 accumulators in registers; the first
//   step only writes them, so they hold nothing live between tiles. The
//   online softmax runs on them in float32: scores scaled by 1/sqrt(dqk) *
//   log2 e in the FMA that subtracts the maximum, 2^x on the
//   special-function unit; l sums the float32 p; O is rescaled only when a
//   row's maximum moved.
// - O += P V: wgmma m64n{dv}k16 with A from registers. One bf16 rounding of
//   P errs by up to 2^-9 of each p, and the checks hold every output to
//   the float32 reference within 1e-5 of sum_j p_j |v_j| before its one
//   bf16 rounding, and P once in bf16 misses that limit
//   (tests/test_torch_flash_split.py shows it on a small case).
//   So p is split: hi = bf16(p), lo = bf16(p - hi), and two products hi V
//   + lo V go into the same float32 accumulator: hi + lo = p within 2^-16
//   of p. That is 2 * dqk + 4 * dv FLOP per admitted (query, key) pair on
//   the tensor cores, where the function needs 2 * dqk + 2 * dv: the price
//   of the reference's precision.
// - Only a tile that crosses a warpgroup's causal diagonal or lk is
//   masked; a warpgroup skips the tiles wholly past its last row (and
//   releases them once loaded).
// - On request (training; at any width, the backward built for (64, 64),
//   (128, 128) and (96, 64)) each row's log-sum-exp m + log2 l, in the log2
//   domain of the scaled scores, is
//   written to a float32 [b, hq, lq] vector after the output (rows lse_ld
//   apart, a multiple of 64: the backward's TMA loads it in boxes of 64
//   that must start 16-byte aligned); the backward
//   (flash_attention_bwd_tc.cu) takes P from it. Serving passes none and
//   its output is the same.
// Within a warpgroup the softmax waits for S and the next S for the
// softmax: issuing S_t before P_{t-1} V_{t-1} (the softmax running under
// that product) and 128-key tiles cost time in the two-warpgroup form of
// this kernel.
//
// Bound: operations, (2 * dqk + 2 * dv) FLOP per admitted pair and head at
// the card's 989 TFLOP/s bf16 peak. phi4-mini's prefill (b 4, hq 24, lq
// 8,192, dh 128, causal): 3.22e9 admitted pairs, 1.65 TFLOP, 1.67 ms (2.48
// TFLOP, 2.5 ms, with the split); measured by chip_smoke.py on an H100
// 80GB HBM3 at 700 W: 4.76 ms, 2.9x that bound (PERF.md). minicpm3-4b's
// MLA prefill (b 4, hq 40, lq 4,096, (96, 64)): 1.34e9 pairs, 4.30e11 FLOP,
// 0.434 ms (6.01e11 issued); deepseek-v2-lite-16b's (hq 16, (192, 128)):
// 5.37e8 pairs, 3.44e11 FLOP, 0.348 ms (4.81e11 issued).

#include "hopper.cuh"

namespace {

constexpr int kConsumerWGs = 3;             // warpgroups of 64 query rows
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kBQ = 64 * kConsumerWGs;      // query rows per block
constexpr int kBK = 64;                    // keys per tile
constexpr int kMaxSmem = 232448;           // dynamic shared bytes a block may have
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the (DQK, DV) instantiation: the Q tile, then a ring of
// K/V stages, then the mbarriers (full and empty per stage, and the Q
// tile's), + 1024 to align the base to the swizzle's 1024-byte period.
// Q and K rows take whole 64-column (128-byte) blocks, V rows DV / 64.
template <int DQK, int DV>
struct Smem {
  static_assert(DV % 64 == 0 && DV <= DQK && DQK % 16 == 0, "unsupported widths");
  static constexpr int kQKBlocks = (DQK + 63) / 64;  // 64-column blocks of a Q or K row
  static constexpr int kVBlocks = DV / 64;
  static constexpr int kQ = kBQ * kQKBlocks * 128;   // bytes of the Q tile
  static constexpr int kK = kBK * kQKBlocks * 128;   // bytes of one K tile
  static constexpr int kV = kBK * kVBlocks * 128;    // bytes of one V tile
  static constexpr int kStage = kK + kV;
  static constexpr int kFixed = kQ + 8 + 1024;     // the Q tile, its mbarrier, the alignment
  static constexpr int kPerStage = kStage + 16;    // a K/V stage and its two mbarriers
  // K/V tiles in flight: four where they fit, else three
  static constexpr int kStages = kFixed + 4 * kPerStage <= kMaxSmem ? 4 : 3;
  static constexpr int kBytes = kFixed + kStages * kPerStage;
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// The register fragments of one warpgroup (64 query rows). Thread (warp w,
// lane = 4 g + t) holds rows 16 w + g and 16 w + g + 8; accumulator
// element 4 j + 2 h + c is row 16 w + g + 8 h, column 8 j + 2 t + c.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                              int lse_ld, int hq, int group, int lq, int lk, int causal,
                              int q_offset, float scale_log2) {
  using S = Smem<DQK, DV>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, skv = base + S::kQ;
  const uint32_t bars = skv + kStages * S::kStage;  // full[kStages], empty[kStages], q
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t qbar = bars + 16 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;  // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * (hq / group) + h / group;

  // Keys the block's rows can see.
  const int last = min(q0 + kBQ, lq) - 1;
  const int kend = causal ? min(lk, q_offset + last + 1) : lk;
  const int ntiles = (kend + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // The producer warpgroup gives up registers for the consumers; one
    // thread loads the Q tile, then each K/V tile into the stage its
    // consumers released. Rows past lk (or lq) come in as zeros; keys in
    // [kend, tile end) are real and masked.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect(qbar, S::kQ);
      for (int w = 0; w < kConsumerWGs; ++w)
        for (int blk = 0; blk < S::kQKBlocks; ++blk)
          tma_load(sq + blk * kBQ * 128 + w * 64 * 128, tq, blk * 64, q0 + w * 64, bh, qbar);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
        const uint32_t ks = skv + s * S::kStage, vs = ks + S::kK;
        mbar_expect(full(s), S::kStage);
        for (int blk = 0; blk < S::kQKBlocks; ++blk)
          tma_load(ks + blk * kBK * 128, tk, blk * 64, t * kBK, kvh, full(s));
        for (int blk = 0; blk < S::kVBlocks; ++blk)
          tma_load(vs + blk * kBK * 128, tv, blk * 64, t * kBK, kvh, full(s));
      }
    }
  } else {
  // The consumers: warpgroups that run on their own, so that one's
  // softmax overlaps the others' products.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int wwarp = warp & 3;
  const int r0 = q0 + wg * 64;
  const int last_w = min(r0 + 64, lq) - 1;
  const int kend_w = last_w < r0 ? 0 : (causal ? min(lk, q_offset + last_w + 1) : lk);

  float o[DV / 2], s[kBK / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  // query positions of this thread's two rows
  const int qpos0 = q_offset + r0 + wwarp * 16 + g;
  mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(full(stage), (it / kStages) & 1);
    const int k0 = it * kBK;
    if (k0 < kend_w) {  // warpgroup-uniform: some key of the tile is visible
      const uint32_t ks = skv + stage * S::kStage, vs = ks + S::kK;

      // S = Q K^T over dqk in steps of 16 (32 bytes inside a 128-byte
      // row); the first step only writes s, so s holds nothing live between
      // tiles
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        const uint64_t da = desc(sq + (kk >> 2) * kBQ * 128 + wg * 64 * 128 + col, 16, 1024);
        const uint64_t db = desc(ks + (kk >> 2) * kBK * 128 + col, 16, 1024);
        if (kk == 0)
          wgmma_ss_n64_first(s, da, db);
        else
          wgmma_ss_n64(s, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // online softmax, float32: the max on the raw scores (the scale is
      // positive), then p = 2^(s * scale log2 e - m) in one FMA; only a
      // tile crossing the diagonal or lk is masked
      const bool masked = k0 + kBK > lk || (causal && k0 + kBK - 1 > q_offset + r0);
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qpos = qpos0 + 8 * hh;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[4 * j + 2 * hh + c];
            if (masked) {
              const int key = k0 + 8 * j + 2 * t4 + c;
              if (key >= lk || (causal && key > qpos)) x = -INFINITY;
            }
            s[4 * j + 2 * hh + c] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx * scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        corr[hh] = ex2(m[hh] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(fmaf(s[4 * j + 2 * hh + c], scale_log2, -m_use));
            s[4 * j + 2 * hh + c] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hh] = l[hh] * corr[hh] + sum;
        m[hh] = m_new;
      }
      // O to the new maxima; a factor of 1 (most tiles, once the maxima
      // settle) is skipped by the whole warp
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }

      // P as A fragments, split into bf16 hi + lo. Fragment register r of
      // key step kk holds row g + 8 (r & 1), keys 16 kk + 8 (r >> 1) + 2 t
      // and + 1: accumulator elements 4 (2 kk + (r >> 1)) + 2 (r & 1) + {0, 1}.
      uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
          const float a = s[e], c = s[e + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][r] = pack_bf16(a - __low2float(hi), c - __high2float(hi));
        }

      // O += P V: V is [keys, dv] (MN-major): 8-key groups 1024 bytes
      // apart, 64-column blocks kBK * 128 bytes apart
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc(vs + kk * 16 * 128, kBK * 128, 1024);
        if constexpr (DV == 128) {
          wgmma_rs_n128(o, ph[kk], dv);
          wgmma_rs_n128(o, pl[kk], dv);
        } else {
          wgmma_rs_n64(o, ph[kk], dv);
          wgmma_rs_n64(o, pl[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    mbar_arrive(empty(stage));  // this thread is done with the stage
  }

  __nv_bfloat16* op = out + static_cast<size_t>(bh) * lq * DV;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wwarp * 16 + g + 8 * hh;
    if (row >= lq) continue;
    const float lsum = l[hh];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const float a = lsum > 0.f ? o[4 * j + 2 * hh] / lsum : 0.f;
      const float c = lsum > 0.f ? o[4 * j + 2 * hh + 1] / lsum : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(row) * DV + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(a, c);
    }
    // the row's log-sum-exp in the log2 domain, log2 sum_j 2^(s_j * scale
    // log2 e) = m + log2 l, for the backward (+inf for a row with no key)
    if (lse != nullptr && t4 == 0)
      lse[static_cast<size_t>(bh) * lse_ld + row] = lsum > 0.f ? m[hh] + log2f(lsum) : INFINITY;
  }
  }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int lse_ld,
           int b, int hq, int hkv, int lq, int lk, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  // a runtime call first: it makes the device's context current on this
  // thread (the training recompute runs on autograd's), which the driver's
  // tensor-map encoding below needs
  auto kernel = flash_attention_tc_kernel<DQK, DV>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Smem<DQK, DV>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, DQK, lq, b * hq);
  if (err == 0) err = tensor_map(&tk, k, DQK, lk, b * hkv);
  if (err == 0) err = tensor_map(&tv, v, DV, lk, b * hkv);
  if (err != 0) return err;
  const dim3 grid(b * hq, (lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, Smem<DQK, DV>::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, lse_ld, hq, hq / hkv, lq, lk, causal,
      q_offset, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's attributes (as flash_attention_tc_attributes reports them).
template <int DQK, int DV>
int attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_attention_tc_kernel<DQK, DV>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = Smem<DQK, DV>::kBytes;
  return 0;
}

}  // namespace

// q: [b, hq, lq, dqk], k: [b, hkv, lk, dqk], v: [b, hkv, lk, dv], out:
// [b, hq, lq, dv], all contiguous bfloat16, 16-byte aligned, (dqk, dv) one
// of (64, 64), (128, 128), (96, 64), (192, 128); scale 1/sqrt(dqk); lse:
// null, or float32 [b * hq] rows of lse_ld >= lq
// elements that receive each query row's log-sum-exp of its scaled scores
// in the log2 domain (the output is the same either way). The caller
// guarantees b, hq, hkv, lq, lk >= 1, hq % hkv == 0, b * hq < 2**31,
// ceil(lq / kBQ) <= 65,535 (kBQ = 192 at every width,
// flash_attention_tc_block_rows) and, when causal, q_offset + lq <= lk.
// Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for another pair).
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int lse_ld, int b, int hq, int hkv,
                                         int lq, int lk, int dqk, int dv, int causal,
                                         int q_offset, float scale, cudaStream_t stream) {
  if (dqk == 128 && dv == 128)
    return launch<128, 128>(q, k, v, out, lse, lse_ld, b, hq, hkv, lq, lk, causal, q_offset,
                            scale, stream);
  if (dqk == 64 && dv == 64)
    return launch<64, 64>(q, k, v, out, lse, lse_ld, b, hq, hkv, lq, lk, causal, q_offset,
                          scale, stream);
  if (dqk == 96 && dv == 64)
    return launch<96, 64>(q, k, v, out, lse, lse_ld, b, hq, hkv, lq, lk, causal, q_offset,
                          scale, stream);
  if (dqk == 192 && dv == 128)
    return launch<192, 128>(q, k, v, out, lse, lse_ld, b, hq, hkv, lq, lk, causal, q_offset,
                            scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// dynamic shared bytes of the kernel for (dqk, dv), into out[0..3].
extern "C" int flash_attention_tc_attributes(int dqk, int dv, int* out) {
  if (dqk == 128 && dv == 128) return attributes<128, 128>(out);
  if (dqk == 64 && dv == 64) return attributes<64, 64>(out);
  if (dqk == 96 && dv == 64) return attributes<96, 64>(out);
  if (dqk == 192 && dv == 128) return attributes<192, 128>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Query rows a block owns (kBQ, the same at every width): the grid has
// ceil(lq / kBQ) rows of blocks.
extern "C" int flash_attention_tc_block_rows() { return kBQ; }
