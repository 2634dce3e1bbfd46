// Staging transpose (K5) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_stage_transpose_kernel` (driven by
// `_stage_to_feat`) of sph_tpu/pallas_step.py: the feature-minor staging
// array of `scatter_slots(staged=True)` is turned into the kernels' layout,
//
//   stag [c_rows, lanes, 8]  (one particle's 8 features contiguous)
//     -> feat [c_rows, 8, lanes]  (one feature's lanes contiguous)
//
// for every compacted row, the dummy row 0 and the rows past n_occ
// included, because the output is the whole array, as in the reference.
// Words are copied as 32-bit patterns with no arithmetic, so the result is
// bitwise the input's transpose (float32 or int32 alike).
//
// Design: one 256-thread block per (128-lane tile, row).  The tile's input
// is 128 x 8 words = 4 KB contiguous in memory; each thread loads one
// 16-byte vector of it (coalesced), scatters its 4 words into a shared
// tile padded to 9 words a lane (the stride 9 is coprime with the 32 banks,
// so the column reads below hit 32 distinct banks), and after a barrier
// the block writes the 8 feature rows of 128 lanes, four 128-word runs per
// pass, coalesced along the lanes.  `lanes` is a multiple of 128 in both
// layouts (slot: whole 128-lane groups; packed: row_lanes rounded to 128).
//
// What bounds it on this card: bytes.  The function reads c_rows*lanes*8
// words and writes as many; there is no arithmetic, so the bound is
// 2 * c_rows * lanes * 32 B over the 3.35 TB/s of HBM3 (PERF.md holds the
// measured time beside it and beside PyTorch's own transpose copy).

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 8;
constexpr int kTile = 128;          // lanes per block
constexpr int kThreads = 256;       // one 16-byte load each: 128 * 8 * 4 B
constexpr int kPad = kFeat + 1;     // shared words per lane

__global__ void __launch_bounds__(kThreads)
stage_transpose_kernel(const unsigned* __restrict__ stag,
                       unsigned* __restrict__ feat, int lanes) {
  __shared__ unsigned tile[kTile * kPad];
  const int row = blockIdx.y;
  const int l0 = blockIdx.x * kTile;
  const int t = threadIdx.x;

  // load: word e = 4t .. 4t+3 of the tile is lane e / 8, features e % 8
  const uint4* src = reinterpret_cast<const uint4*>(
      stag + ((size_t)row * lanes + l0) * kFeat);
  const uint4 w = __ldg(src + t);
  const int lane = t >> 1;
  const int c0 = (t & 1) * 4;
  unsigned* s = tile + lane * kPad + c0;
  s[0] = w.x;
  s[1] = w.y;
  s[2] = w.z;
  s[3] = w.w;
  __syncthreads();

  // store: feature c, lane l of the tile; 256 consecutive (c, l) a pass
  unsigned* dst = feat + (size_t)row * kFeat * lanes + l0;
#pragma unroll
  for (int k = t; k < kTile * kFeat; k += kThreads) {
    const int c = k / kTile;
    const int l = k % kTile;
    dst[(size_t)c * lanes + l] = tile[l * kPad + c];
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError() after
// the launch; the caller raises on a nonzero code.  The launch goes to the
// caller's stream and does not synchronize.

extern "C" int stage_transpose(const void* stag, void* feat, int c_rows,
                               int lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(lanes / kTile, c_rows);
  stage_transpose_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)stag, (unsigned*)feat, lanes);
  return (int)cudaGetLastError();
}
