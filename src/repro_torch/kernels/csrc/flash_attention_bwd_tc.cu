// The backward of causal grouped-query attention on Hopper's tensor cores
// (sm_90a): bf16, (Dqk, Dv) (64, 64), (128, 128) or MLA's (96, 64)
// (minicpm3-4b) and (192, 128) (deepseek-v2-lite-16b), V at its own width,
// query offset 0, as many queries as keys.
//
// Differentiates the function of the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas) as the LM training step calls it; the JAX
// package has no backward kernel (it differentiates its plain _attention).
// With P[i, j] = softmax_j(q_i . k_j * scale), j <= i, taken from the
// forward's log-sum-exp (flash_attention_tc.cu writes it, log2 domain:
// P = 2^(s * scale log2 e - lse)), D[i] = sum_d dO[i, d] O[i, d] from the
// forward's bf16 output and dS = P * (dO V^T - D), scale = 1/sqrt(dqk):
//   dV = P^T dO,  dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the query heads of each KV head. S = Q K^T runs over
// dqk, dP = dO V^T and D over dv; dV is dv wide, dQ and dK dqk wide. Every
// product and sum is float32; each gradient is rounded once to bf16. q, dq:
// [b, hq, l, dqk]; o, dout: [b, hq, l, dv]; k, dk: [b, hkv, l, dqk]; v,
// dv: [b, hkv, l, dv]; lse: float32 [b, hq, l] (its rows padded to a
// multiple of 64 floats).
//
// Numerics. S and dP come from the bf16 operands in float32. dV takes P
// split into bf16 hi + lo (two products, as the forward's P V): one bf16
// rounding of P errs by up to 2^-9 of each p and breaks dV's limit
// (ref.flash_attention_bwd_limits) by 36-58x on random inputs. dS is
// rounded once to bf16 for dQ and dK, which keeps them well inside theirs
// (tests/test_torch_flash_bwd_split.py holds the mirror,
// ref.flash_attention_bwd_tc_ref, to the limits).
//
// Two launches, deterministic, no atomics. Each block is two consumer
// warpgroups of 64 rows and one producer warpgroup: one thread of it
// streams tiles by TMA (the forward's 3-D tensor maps [b * heads, rows,
// width], 64 x 64 boxes, 128-byte swizzle; a box past l is zero-filled) into
// a ring of four stages (three at (192, 128), where four would take
// 248,904 / 246,856 bytes of shared memory in (b) / (a) against a block's
// 232,448) with full and empty mbarriers, and the warpgroup gives its
// registers to the consumers (setmaxnreg 24 against 240). A row
// of Q or K takes ceil(dqk / 64) boxes, of dO or V dv / 64: at dqk 96 the
// second box starts at column 64 and lies half past the tensor map's 96
// columns, TMA zero-fills columns 96-127 without reading memory, and the
// whole box's bytes count toward the stage's transaction bytes (as the
// forward, flash_attention_tc.cu). S and dP then run dqk / 16 and dv / 16
// k-steps, and the zero half is never multiplied. At dqk 192 a row is three
// whole boxes: S runs 12 k-steps, dP 8.
// (a) flash_attention_bwd_tc_dq_kernel, one block per (b * hq, 128 query
//     rows), the latest rows first. Q and dO of its rows are resident; K
//     and V tiles of 64 keys stream up to the diagonal. Each consumer
//     warpgroup takes D of its rows from O and dO (and writes it for (b))
//     and the forward's LSE, then per tile: S = Q K^T and dP = dO V^T
//     (wgmma m64n64k16, both operands in shared memory, K-major), P and
//     dS in float32 registers, and dQ += dS K (A from registers, K as an
//     MN-major B with the transpose bit, as V in the forward's P V; at dqk
//     96 one m64n96k16 a k-step, whose B descriptor reads the first 64
//     columns and half of the second block).
// (b) flash_attention_bwd_tc_dkdv_kernel, one block per (b * hkv, 128
//     keys), the first keys (the most work) first. K and V of its keys are
//     resident; the Q and dO tiles of 64 query rows of each query head of
//     the group stream from the diagonal on, with their LSE and D (1-D
//     tensor maps over rows padded to 64 floats, so a box starts 16-byte
//     aligned), twice: a first pass takes S^T = K Q^T, whose accumulator
//     layout is the A operand from registers, and adds (P^T_hi + P^T_lo) dO
//     into dV (n = dv); a second takes S^T and dP^T = V dO^T and adds dS^T
//     Q into dK (n = dqk; dO and Q as MN-major B). One float32 accumulator
//     a pass: both at once, with S^T, dP^T and the fragments, left ptxas
//     spilling at Dh 128 (and a kernel that spilled under setmaxnreg
//     faulted). The group's heads are summed in the block in a fixed order.
// At (192, 128) dQ and dK are computed in two column chunks, 128 then 64,
// each a pass over the streamed tiles that recomputes S and dP (two more
// products a tile in each kernel: (a) runs S, dP twice and dQ once, (b) S
// three times, dP twice, dV twice and dK once, 2.5x the function's work).
// Whole, a thread's dQ or dK accumulator is 96 floats beside S, dP (32
// each) and 16 fragment registers: ptxas holds the consumers to the
// launch's 168 registers (65,536 / 384), not setmaxnreg's 240, and
// spilled (kernel_attributes("tc", 192, 128) on the H100: 168 / 176 local
// bytes a thread in (a) / (b), and it serialized the wgmmas). A chunk of
// 128 holds the registers of the (128, 128) instantiation, which spills
// nothing. Chunks of 96 would not do: the second would start 64 bytes into
// a 128-byte swizzle row of the MN-major B, not on a whole block. With the
// chunks (and product_ss's descriptors remade a call) kernel_attributes
// reads (a) 168 registers, 0 local bytes, 205,880 dynamic shared bytes;
// (b) 168, 0, 207,416.
// Only a tile that crosses the diagonal or l is masked; a warpgroup skips
// the tiles it sees nothing of (and releases them once loaded).
//
// Register fragments of a warpgroup (64 rows): thread (warp w, lane 4 g +
// t) holds rows 16 w + g and 16 w + g + 8; accumulator element 4 j + 2 h +
// c is row 16 w + g + 8 h, column 8 j + 2 t + c. A fragment register r of
// k-step kk holds row g + 8 (r & 1), columns 16 kk + 8 (r >> 1) + 2 t and
// + 1: accumulator elements 4 (2 kk + (r >> 1)) + 2 (r & 1) + {0, 1}.
//
// Bound: operations. The function needs five causal products of 2 * b *
// hq * l (l + 1) / 2 FLOP a column: S, dQ and dK over dqk, dP and dV over
// dv (3 * dqk + 2 * dv columns); this design runs nine (S in (a) and both
// passes of (b), dP in both kernels, dV twice for the split): 3 dqk + 2 dv
// columns more, 1.8x the work at dqk = dv, 2.0x at (96, 64); at (192, 128)
// the chunks run S and dP once more in each kernel, 2,112 columns against
// the function's 832, 2.5x.
// phi4-mini's training shape (b 2, hq 24, l 4,096, dh 128) needs 0.52 TFLOP,
// 0.52 ms at the card's 989 TFLOP/s bf16 peak; minicpm3-4b's (b 1, hq 40,
// l 4,096, (96, 64)) 832 FLOP a pair and head, 0.28 TFLOP, 0.283 ms;
// deepseek-v2-lite-16b's (b 1, hq 16, l 4,096, (192, 128)) 1,664 FLOP a
// pair and head, 0.223 TFLOP, 0.226 ms. Their times are in PERF.md
// (chip_smoke.py, kernel_check "flash_attention_bwd").

#include "hopper.cuh"

namespace {

constexpr int kWGs = 2;                   // consumer warpgroups of 64 rows
constexpr int kConsumers = 128 * kWGs;
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kRows = 64 * kWGs;          // query rows (a) or keys (b) a block owns
constexpr int kTile = 64;                 // keys (a) or query rows (b) a streamed tile
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kMaxSmem = 232448;          // dynamic shared bytes a block may have
constexpr float kLog2e = 1.4426950408889634f;

// Shared bytes: two resident bf16 tiles, [kRows, DQK] (Q, or K) then
// [kRows, DV] (dO, or V), kStages stages of two streamed tiles, [kTile,
// DQK] (K, or Q) then [kTile, DV] (V, or dO), each row in whole 64-column
// (128-byte) blocks, all multiples of the swizzle's 1024-byte period; in
// (b) then each stage's kTile LSE and kTile D floats of its Q rows; the
// mbarriers (full and empty per stage and the resident tiles'); + 1024 to
// align the base. Four stages where they fit, else three ((192, 128)).
template <int DQK, int DV, bool kWithStats>
struct Smem {
  static_assert(DV % 64 == 0 && DV <= DQK && DQK % 16 == 0 && DQK <= 192, "unsupported widths");
  static constexpr int kQKBlocks = (DQK + 63) / 64;  // 64-column blocks of a Q or K row
  static constexpr int kVBlocks = DV / 64;           // of a dO or V row
  static constexpr int kRes1 = kRows * kQKBlocks * 128;
  static constexpr int kRes2 = kRows * kVBlocks * 128;
  static constexpr int kT1 = kTile * kQKBlocks * 128;
  static constexpr int kT2 = kTile * kVBlocks * 128;
  static constexpr int kStage = kT1 + kT2;
  static constexpr int kStatBytes = kWithStats ? 2 * kTile * 4 : 0;  // a stage's LSE and D
  static constexpr int kFixed = kRes1 + kRes2 + 8 + 1024;  // resident tiles, their mbarrier, alignment
  static constexpr int kPerStage = kStage + kStatBytes + 16;  // and two mbarriers a stage
  static constexpr int kStages = kFixed + 4 * kPerStage <= kMaxSmem ? 4 : 3;
  static constexpr int kStats = kRes1 + kRes2 + kStages * kStage;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// dQ and dK in column chunks of whole 64-column blocks, at most 128 wide
// (a chunk's float32 accumulator within the consumers' registers): one at
// every width but 192, where 128 then 64. Chunk c is a pass over the
// streamed tiles.
template <int DQK>
struct Chunks {
  static constexpr int kCount = DQK > 128 ? 2 : 1;
  static constexpr int kFirst = DQK > 128 ? 128 : DQK;  // the first chunk's columns
};
template <int N>
struct Width {
  static constexpr int value = N;
};

// Each k-step of a [64 rows, K] x [kTile rows, K]^T product over K columns:
// A rows from the resident tile at `a` (kRows rows a 64-column block,
// warpgroup wg's 64 from row 64 wg), B from the streamed tile at `b`.
template <int K>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a, uint32_t b, int wg) {
  // Over 128 columns the compiler would hold the resident tile's k-step
  // descriptors (loop invariants) live across every pass: 40 registers at
  // (192, 128), which spilled in (b). Hidden from it, they are remade a call.
  if constexpr (K > 128) asm volatile("" : "+r"(a));
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    const uint64_t da = desc(a + (kk >> 2) * kRows * 128 + wg * 64 * 128 + col, 16, 1024);
    const uint64_t db = desc(b + (kk >> 2) * kTile * 128 + col, 16, 1024);
    if (kk == 0)
      wgmma_ss_n64_first(d, da, db);
    else
      wgmma_ss_n64(d, da, db, 1);
  }
}

// acc[64, N] += A[64, 16] B[16, N] with A from registers and B the k-step's
// 16 rows of a streamed [kTile, N] tile (MN-major, the transpose bit; its
// 64-column blocks kTile * 128 bytes apart).
template <int N>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2], const uint32_t (&a)[4],
                                           uint32_t b, int kk) {
  const uint64_t db = desc(b + kk * 16 * 128, kTile * 128, 1024);
  if constexpr (N == 128)
    wgmma_rs_n128(acc, a, db);
  else if constexpr (N == 96)
    wgmma_rs_n96(acc, a, db);
  else
    wgmma_rs_n64(acc, a, db);
}

// The 32 accumulator elements of a 64 x 64 tile as the A fragments of its
// four 16-column k-steps, each value rounded once to bf16.
__device__ __forceinline__ void to_fragments(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      f[kk][r] = pack_bf16(x[e], x[e + 1]);
    }
}

// Writes scale * acc of this thread's two rows, row0 and row0 + 8, into N
// columns at p of a bf16 matrix of rows ld elements apart, rows at or past
// n left out.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* p, int ld, const float (&acc)[N / 2],
                                           int row0, int n, float scale, int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + static_cast<size_t>(row) * ld + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(scale * acc[4 * j + 2 * hh], scale * acc[4 * j + 2 * hh + 1]);
  }
}

// One thread loads a resident tile of kRows rows in BLOCKS 64-column
// blocks: 64 x 64 boxes at rows row0 + 64 w, column block blk, of plane
// `plane`.
template <int BLOCKS>
__device__ __forceinline__ void load_resident(uint32_t dst, const CUtensorMap& map, int row0,
                                              int plane, uint32_t bar) {
  for (int w = 0; w < kWGs; ++w)
    for (int blk = 0; blk < BLOCKS; ++blk)
      tma_load(dst + blk * kRows * 128 + w * 64 * 128, map, blk * 64, row0 + w * 64, plane, bar);
}

// One thread loads a streamed tile of kTile rows in BLOCKS 64-column
// blocks at row0 of plane `plane`.
template <int BLOCKS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, int row0,
                                          int plane, uint32_t bar) {
  for (int blk = 0; blk < BLOCKS; ++blk)
    tma_load(dst + blk * kTile * 128, map, blk * 64, row0, plane, bar);
}

// (a) dQ, and D for (b).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const __nv_bfloat16* __restrict__ o,
                                     const __nv_bfloat16* __restrict__ dout,
                                     const float* __restrict__ lse, float* __restrict__ delta,
                                     int ld, __nv_bfloat16* __restrict__ dq, int hq, int group,
                                     int l, float scale_log2, float scale) {
  using S = Smem<DQK, DV, false>;
  using C = Chunks<DQK>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = base + S::kRes1, skv = base + S::kRes1 + S::kRes2;
  const uint32_t bars = base + S::kBars;  // full[kStages], empty[kStages], resident
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t rbar = bars + 16 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;  // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * (hq / group) + h / group;
  // causal at offset 0: the block's rows see keys 0 .. its last row
  const int ntiles = (min(q0 + kRows, l) - 1) / kTile + 1;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect(rbar, S::kRes1 + S::kRes2);
      load_resident<S::kQKBlocks>(sq, tq, q0, bh, rbar);
      load_resident<S::kVBlocks>(sdo, tdo, q0, bh, rbar);
      for (int it = 0; it < C::kCount * ntiles; ++it) {  // the tiles once a chunk
        const int s = it % kStages, t = it % ntiles;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        const uint32_t ks = skv + s * S::kStage;
        mbar_expect(full(s), S::kStage);
        load_tile<S::kQKBlocks>(ks, tk, t * kTile, kvh, full(s));
        load_tile<S::kVBlocks>(ks + S::kT1, tv, t * kTile, kvh, full(s));
      }
    }
  } else {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3, wwarp = warp & 3;
  const int r0 = q0 + wg * 64;
  const int last_w = min(r0 + 64, l) - 1;
  const int ntiles_w = last_w < r0 ? 0 : last_w / kTile + 1;
  const int row0 = r0 + wwarp * 16 + g;  // this thread's rows: row0 and row0 + 8

  // D of the two rows from the forward's output (DV wide), each of the
  // row's four threads summing every fourth 16-byte chunk, then across the four (0 for
  // the rows in [l, ld), so (b) never reads an unwritten D); the rows' LSE
  // (+inf past l: P = 0 there)
  float dd[2], ls[2];
  const size_t off = static_cast<size_t>(bh) * l, soff = static_cast<size_t>(bh) * ld;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    float acc = 0.f;
    if (row < l) {
      const uint4* op = reinterpret_cast<const uint4*>(o + (off + row) * DV);
      const uint4* dop = reinterpret_cast<const uint4*>(dout + (off + row) * DV);
#pragma unroll
      for (int i = 0; i < DV / 32; ++i) {
        const uint4 x = __ldg(op + t4 + 4 * i), y = __ldg(dop + t4 + 4 * i);
        const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 a = __bfloat1622float2(xh[c]), d = __bfloat1622float2(yh[c]);
          acc = fmaf(a.x, d.x, acc);
          acc = fmaf(a.y, d.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dd[hh] = acc;
    ls[hh] = row < l ? lse[soff + row] : INFINITY;
    if (row < ld && t4 == 0) delta[soff + row] = acc;
  }

  mbar_wait(rbar, 0);

  // dQ's columns [c0, c0 + N): pass `pass` over the K / V tiles
  auto dq_chunk = [&](auto width, int c0, int pass) {
    constexpr int N = decltype(width)::value;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const int it = pass * ntiles + t, stage = it % kStages;
      mbar_wait(full(stage), (it / kStages) & 1);
      if (t < ntiles_w) {  // warpgroup-uniform: some key of the tile is visible
        const int k0 = t * kTile;
        const uint32_t ks = skv + stage * S::kStage, vs = ks + S::kT1;
        float s[32], dp[32];
        wgmma_fence();
        product_ss<DQK>(s, sq, ks, wg);
        product_ss<DV>(dp, sdo, vs, wg);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        fence_regs(dp);

        // dS = P (dP - D), P = 2^(S scale log2 e - LSE); a tile crossing the
        // diagonal of the warpgroup's first row is masked (keys past a row)
        const bool masked = k0 + kTile - 1 > r0;
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * hh + c;
              float p = ex2(fmaf(s[e], scale_log2, -ls[hh]));
              if (masked && k0 + 8 * j + 2 * t4 + c > row0 + 8 * hh) p = 0.f;
              s[e] = p * (dp[e] - dd[hh]);
            }
        uint32_t f[kTile / 16][4];
        to_fragments(s, f);

        // dQ += dS K, the chunk's columns of K as the MN-major B
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          product_rs<N>(acc, f[kk], ks + (c0 / 64) * kTile * 128, kk);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
      mbar_arrive(empty(stage));  // this thread is done with the stage
    }
    store_rows<N>(dq + off * DQK + c0, DQK, acc, row0, l, scale, t4);
  };
  dq_chunk(Width<C::kFirst>{}, 0, 0);
  if constexpr (C::kCount == 2) dq_chunk(Width<DQK - C::kFirst>{}, C::kFirst, 1);
  }
}

// P^T of the accumulator elements e, e + 1 of an S^T tile (query columns
// col, col + 1 of the streamed tile at q0, keys `key` of this thread):
// 2^(s scale log2 e - lse), 0 where masked (a query before its key or at or
// past l).
__device__ __forceinline__ float2 p_pair(float s0, float s1, float2 lse, bool masked, int qpos,
                                         int key, int l, float scale_log2) {
  float2 p = make_float2(ex2(fmaf(s0, scale_log2, -lse.x)), ex2(fmaf(s1, scale_log2, -lse.y)));
  if (masked) {
    if (qpos < key || qpos >= l) p.x = 0.f;
    if (qpos + 1 < key || qpos + 1 >= l) p.y = 0.f;
  }
  return p;
}

// (b) dV, then dK: two passes over the streamed tiles (three at Dqk 192, dK
// in two chunks), each holding one float32 accumulator (dV and dK at once
// spill at Dh 128).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                                       const __grid_constant__ CUtensorMap tk,
                                       const __grid_constant__ CUtensorMap tv,
                                       const __grid_constant__ CUtensorMap tdo,
                                       const __grid_constant__ CUtensorMap tlse,
                                       const __grid_constant__ CUtensorMap tdelta,
                                       __nv_bfloat16* __restrict__ dk,
                                       __nv_bfloat16* __restrict__ dv, int hq, int group, int l,
                                       int ld, float scale_log2, float scale) {
  using S = Smem<DQK, DV, true>;
  using C = Chunks<DQK>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));  // base, generic
  const uint32_t sk = base, sv = base + S::kRes1, sst = base + S::kRes1 + S::kRes2;
  const uint32_t bars = base + S::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t rbar = bars + 16 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bkv = blockIdx.x;  // b * hkv + kv head
  const int hkv = hq / group;
  const int b = bkv / hkv, hk = bkv - b * hkv;
  const int kb0 = blockIdx.y * kRows;                // the block's first key
  const int nq = (l - kb0 + kTile - 1) / kTile;      // query tiles a head, from kb0 on
  const int ntiles = group * nq;                     // streamed tiles a pass
  const int bh0 = b * hq + hk * group;               // the group's first query head

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect(rbar, S::kRes1 + S::kRes2);
      load_resident<S::kQKBlocks>(sk, tk, kb0, bkv, rbar);
      load_resident<S::kVBlocks>(sv, tv, kb0, bkv, rbar);
      for (int it = 0; it < (1 + C::kCount) * ntiles; ++it) {  // dV's pass, dK's chunks
        const int s = it % kStages, t = it % ntiles;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        const int hg = t / nq, q0 = kb0 + (t - hg * nq) * kTile;
        const uint32_t qs = sst + s * S::kStage, st = base + S::kStats + s * S::kStatBytes;
        mbar_expect(full(s), S::kStage + S::kStatBytes);
        load_tile<S::kQKBlocks>(qs, tq, q0, bh0 + hg, full(s));
        load_tile<S::kVBlocks>(qs + S::kT1, tdo, q0, bh0 + hg, full(s));
        const int at = (bh0 + hg) * ld + q0;  // past the head's last row: masked
        tma_load_1d(st, tlse, at, full(s));
        tma_load_1d(st + kTile * 4, tdelta, at, full(s));
      }
    }
  } else {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3, wwarp = warp & 3;
  const int kw = kb0 + wg * 64;          // the warpgroup's first key
  const int key0 = kw + wwarp * 16 + g;  // this thread's keys: key0 and key0 + 8
  const size_t off = static_cast<size_t>(bkv) * l;  // the KV head's first row
  mbar_wait(rbar, 0);

  // pass 1: dV += (P^T_hi + P^T_lo) dO, with S^T = K Q^T
  {
    float adv[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) adv[i] = 0.f;
    for (int it = 0; it < ntiles; ++it) {
      const int stage = it % kStages;
      mbar_wait(full(stage), (it / kStages) & 1);
      const int hg = it / nq, q0 = kb0 + (it - hg * nq) * kTile;
      // warpgroup-uniform: some query of the tile sees some key of the warpgroup
      if (kw < l && q0 + kTile - 1 >= kw) {
        const uint32_t qs = sst + stage * S::kStage, dos = qs + S::kT1;
        const float* lse_s =
            reinterpret_cast<const float*>(gbase + S::kStats + stage * S::kStatBytes);
        const bool masked = q0 < kw + 63 || q0 + kTile > l;
        float s[32];
        wgmma_fence();
        product_ss<DQK>(s, sk, qs, wg);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        // P^T split into bf16 hi + lo A fragments: register r = 2 half + hh
        // of k-step kk holds columns 16 kk + 8 half + 2 t4 + {0, 1}
        uint32_t ph[kTile / 16][4], pl[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 2 * kk + half, col = 8 * j + 2 * t4;
            const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int e = 4 * j + 2 * hh;
              const float2 p = p_pair(s[e], s[e + 1], lse2, masked, q0 + col, key0 + 8 * hh, l,
                                      scale_log2);
              const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
              ph[kk][2 * half + hh] = *reinterpret_cast<const uint32_t*>(&h);
              pl[kk][2 * half + hh] = pack_bf16(p.x - __low2float(h), p.y - __high2float(h));
            }
          }
        fence_regs(adv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          product_rs<DV>(adv, ph[kk], dos, kk);
          product_rs<DV>(adv, pl[kk], dos, kk);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(adv);
      }
      mbar_arrive(empty(stage));
    }
    store_rows<DV>(dv + off * DV, DV, adv, key0, l, 1.f, t4);
  }

  // pass 2 (and 3): dK += dS^T Q, dS^T = P^T (dP^T - D), dP^T = V dO^T, dK's
  // columns [c0, c0 + N) in pass `pass`
  auto dk_chunk = [&](auto width, int c0, int pass) {
    constexpr int N = decltype(width)::value;
    float adk[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) adk[i] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const int it = pass * ntiles + t, stage = it % kStages;
      mbar_wait(full(stage), (it / kStages) & 1);
      const int hg = t / nq, q0 = kb0 + (t - hg * nq) * kTile;
      if (kw < l && q0 + kTile - 1 >= kw) {
        const uint32_t qs = sst + stage * S::kStage, dos = qs + S::kT1;
        const float* lse_s =
            reinterpret_cast<const float*>(gbase + S::kStats + stage * S::kStatBytes);
        const float* d_s = lse_s + kTile;
        const bool masked = q0 < kw + 63 || q0 + kTile > l;
        float s[32], dp[32];
        wgmma_fence();
        product_ss<DQK>(s, sk, qs, wg);
        product_ss<DV>(dp, sv, dos, wg);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        fence_regs(dp);
        uint32_t f[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 2 * kk + half, col = 8 * j + 2 * t4;
            const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 d2 = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int e = 4 * j + 2 * hh;
              const float2 p = p_pair(s[e], s[e + 1], lse2, masked, q0 + col, key0 + 8 * hh, l,
                                      scale_log2);
              f[kk][2 * half + hh] = pack_bf16(p.x * (dp[e] - d2.x), p.y * (dp[e + 1] - d2.y));
            }
          }
        fence_regs(adk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          product_rs<N>(adk, f[kk], qs + (c0 / 64) * kTile * 128, kk);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(adk);
      }
      mbar_arrive(empty(stage));
    }
    store_rows<N>(dk + off * DQK + c0, DQK, adk, key0, l, scale, t4);
  };
  dk_chunk(Width<C::kFirst>{}, 0, 1);
  if constexpr (C::kCount == 2) dk_chunk(Width<DQK - C::kFirst>{}, C::kFirst, 2);
  }
}

// Registers the compiler gave a kernel; setmaxnreg needs 168 (the most at
// kThreads) so the producer's release covers the consumers' request, and a
// launch with fewer would wait on registers that never come.
template <typename K>
int check_registers(K kernel) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return a.numRegs * kThreads < kConsumers * kConsumerRegs + 128 * kProducerRegs
             ? static_cast<int>(cudaErrorInvalidConfiguration)
             : 0;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, int ld, void* dq, void* dk, void* dv, float* delta, int b, int hq,
           int hkv, int l, float scale, cudaStream_t stream) {
  // runtime calls first: they make the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which the
  // driver's tensor-map encoding below needs
  auto ka = flash_attention_bwd_tc_dq_kernel<DQK, DV>;
  auto kb = flash_attention_bwd_tc_dkdv_kernel<DQK, DV>;
  int err = check_registers(ka);
  if (err == 0) err = check_registers(kb);
  if (err != 0) return err;
  const int sa = Smem<DQK, DV, false>::kBytes, sb = Smem<DQK, DV, true>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, sa);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, sb);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  err = tensor_map(&tq, q, DQK, l, b * hq);
  if (err == 0) err = tensor_map(&tdo, dout, DV, l, b * hq);
  if (err == 0) err = tensor_map(&tk, k, DQK, l, b * hkv);
  if (err == 0) err = tensor_map(&tv, v, DV, l, b * hkv);
  if (err == 0) err = tensor_map_1d(&tlse, lse, static_cast<long long>(b) * hq * ld);
  if (err == 0) err = tensor_map_1d(&tdelta, delta, static_cast<long long>(b) * hq * ld);
  if (err != 0) return err;
  const int tiles = (l + kRows - 1) / kRows;
  const float scale_log2 = scale * kLog2e;
  ka<<<dim3(b * hq, tiles), kThreads, sa, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, ld, static_cast<__nv_bfloat16*>(dq),
      hq, hq / hkv, l, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kb<<<dim3(b * hkv, tiles), kThreads, sb, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), hq, hq / hkv, l, ld, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int attributes(int which, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&a, flash_attention_bwd_tc_dq_kernel<DQK, DV>)
                 : cudaFuncGetAttributes(&a, flash_attention_bwd_tc_dkdv_kernel<DQK, DV>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = which == 0 ? Smem<DQK, DV, false>::kBytes : Smem<DQK, DV, true>::kBytes;
  return 0;
}

}  // namespace

// q, dq: [b, hq, l, dqk]; o, dout: [b, hq, l, dv]; k, dk: [b, hkv, l, dqk];
// v, dv: [b, hkv, l, dv], all contiguous bfloat16, 16-byte aligned; (dqk,
// dv) one of (64, 64), (128, 128), (96, 64), (192, 128); lse: the forward's float32 LSE
// (flash_attention_tc_launch's), b * hq rows of ld floats; delta: float32
// scratch of the same layout; both 16-byte aligned, ld >= l a multiple of
// 64 (whole TMA boxes, each starting 16-byte aligned). Causal with query
// offset 0; scale 1/sqrt(dqk). The caller guarantees b, hq, hkv, l >= 1,
// hq % hkv == 0, b * hq * ld < 2**31 and ceil(l / 128) <= 65,535. Launches
// (a) then (b) on the stream; returns the first cudaError_t (0 on success;
// cudaErrorInvalidValue for another pair).
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const float* lse,
                                             int ld, void* dq, void* dk, void* dv, float* delta,
                                             int b, int hq, int hkv, int l, int dqk, int dv_cols,
                                             float scale, cudaStream_t stream) {
#define FAB_ARGS q, k, v, o, dout, lse, ld, dq, dk, dv, delta, b, hq, hkv, l, scale, stream
  if (dqk == 64 && dv_cols == 64) return launch<64, 64>(FAB_ARGS);
  if (dqk == 128 && dv_cols == 128) return launch<128, 128>(FAB_ARGS);
  if (dqk == 96 && dv_cols == 64) return launch<96, 64>(FAB_ARGS);
  if (dqk == 192 && dv_cols == 128) return launch<192, 128>(FAB_ARGS);
#undef FAB_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, static shared bytes, local (spill) bytes a thread and
// dynamic shared bytes of kernel (a) (which = 0) or (b) (which = 1) for
// (dqk, dv), into out[0..3].
extern "C" int flash_attention_bwd_tc_attributes(int dqk, int dv, int which, int* out) {
  if (dqk == 64 && dv == 64) return attributes<64, 64>(which, out);
  if (dqk == 128 && dv == 128) return attributes<128, 128>(which, out);
  if (dqk == 96 && dv == 64) return attributes<96, 64>(which, out);
  if (dqk == 192 && dv == 128) return attributes<192, 128>(which, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
