// Padded-set intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/set_intersect.py
// (set_intersect_pallas): mask[g, i] = a[g, i] != pad and a[g, i] is one of
// the non-pad values of b[g, :]. a: [G, CA], b: [G, CB] int32, mask bool.
//
// The TPU kernel evaluates the [TG, CA, CB] broadcast compare in VMEM. Here
// one block owns one row g: it stages b[g, :] in shared memory (in tiles of
// kTileB values) and each thread scans it for its own a[g, i], stopping at
// the first hit. The scan needs no order of the rows, so the result equals
// the plain version for any input, sorted or not (the engine's rows are
// ascending with a pad tail, the CompTensors invariant).
//
// Bound: bytes at the engine's shapes (G = group_cap rows of 512 + 512
// int32 in, 512 bool out); the compares are shared-memory broadcasts, at
// most CA * CB per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileB = 4096;  // 16 KiB of shared memory per block

__global__ void set_intersect_kernel(const int* __restrict__ a,
                                     const int* __restrict__ b, int ca, int cb,
                                     int pad, bool* __restrict__ out) {
  __shared__ int sb[kTileB];
  const size_t row = blockIdx.x;
  const int* arow = a + row * ca;
  const int* brow = b + row * cb;
  bool* orow = out + row * ca;
  for (int a0 = 0; a0 < ca; a0 += blockDim.x) {
    const int i = a0 + threadIdx.x;
    const int av = i < ca ? arow[i] : pad;
    bool hit = false;
    for (int b0 = 0; b0 < cb; b0 += kTileB) {
      const int nb = cb - b0 < kTileB ? cb - b0 : kTileB;
      __syncthreads();
      for (int j = threadIdx.x; j < nb; j += blockDim.x) sb[j] = brow[b0 + j];
      __syncthreads();
      if (!hit && av != pad) {
        // av != pad, so a match is never a pad of b.
        for (int j = 0; j < nb; ++j) {
          if (sb[j] == av) {
            hit = true;
            break;
          }
        }
      }
    }
    if (i < ca) orow[i] = hit;
  }
}

}  // namespace

// a: [g, ca] int32, b: [g, cb] int32, out: [g, ca] bool. g, ca, cb > 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int set_intersect_launch(const int* a, const int* b, int g, int ca,
                                    int cb, int pad, bool* out,
                                    cudaStream_t stream) {
  int threads = ((ca + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  set_intersect_kernel<<<g, threads, 0, stream>>>(a, b, ca, cb, pad, out);
  return static_cast<int>(cudaGetLastError());
}
