// Packed-row SPH density (K3) and force (K4) kernels for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels `_density_kernel_packed` and
// `_force_kernel_packed` of sph_tpu/pallas_step.py.  Same function, not the
// same blocking: the TPU kernels pair every 128-lane i-block against the
// concatenated first blocks of all neighbor rows (the empty dummy row
// included) plus one block per extra occupied block, a shape chosen for
// Mosaic's vector unit.  An empty lane sits at 1e18 and contributes exactly
// 0 to both sums (q = max(h^2 - r^2, 0) = 0; t = 0, so s = 0 and the
// viscosity coefficient is 0; r^2 ~ 3e36 stays finite in fp32), so these
// kernels visit only the occupied lanes of the occupied blocks.
//
// Layout (see sph_tpu_torch/pallas_step.py, SlotGrid.packed):
//   feat    f32 [c_rows, 8, lanes]   x(3) | v(3) | . | .; a row's particles
//                                    fill lanes 0..count-1, empty lanes sit
//                                    at 1e18, row 0 is the all-empty dummy
//   rp      f32 [c_rows, 2, lanes]   (rho, EOS p), K3's output, K4's input
//   f       f32 [c_rows, 4, lanes]   force density, components >= dim zero
//   nbr_pos i32 [R, c_rows]          compacted position of each of the
//                                    3^(dim-1) neighbor (z, y) rows (0 =
//                                    the dummy row)
//   jb      i32 [c_rows]             occupied 128-lane blocks per row
//                                    (jb[0] = 0)
//   gcounts i32 [c_rows, 1, n_groups] particles per block; lanes fill
//                                    contiguously, so block jg of a row
//                                    holds its particles in its first
//                                    gcounts[row, jg] lanes
//   n_occ   i32 [1]                  number of real compacted rows; read on
//                                    the device, so a step needs no host sync
//
// Design: all 128 i-lanes of a block share the same candidates (every
// particle of the R neighbor rows), unlike the slot kernels where each cell
// has its own window.  So: one 128-thread block per (i-block, row), one
// thread per i-lane.  For each neighbor row and each of its occupied
// blocks, the threads stage that block's x (K3) or x, v, 1/rho, p (K4) in
// shared memory once, and every thread loops over the staged lanes, which
// all threads read at the same address (a broadcast, no bank conflicts).
// The order is fixed (neighbor row, block, lane) and there are no atomics,
// so results are bitwise reproducible run to run.  There is no x halo: all
// n_groups blocks are i-blocks.  A block writes zeros and exits for row 0,
// rows past n_occ and blocks with no particle, and an empty i-lane writes
// zeros, so the kernels write every output element and the wrapper
// allocates without a fill.
//
// What bounds it on this card: the work is small and irregular.  At the
// settled emitter scene a row holds ~29 particles, so most of a block's 128
// threads idle, a run is a few thousand short blocks, and its time is near
// a launch's own latency, far above the bytes the function must move.
// Packing several sparse rows into one block, or one warp per row, is left
// for a later change; PERF.md holds the measured times beside the bound.
//
// K4 takes 1/r as 1.0f / sqrtf(r2) (IEEE-rounded sqrt and division; the
// build passes no --use_fast_math), not the approximate rsqrtf.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 8;
constexpr int kFout = 4;
constexpr int kLane = 128;
constexpr float kEmpty = 1e17f;  // empty lanes hold 1e18

struct Eos {
  int tait;          // 0: p = k (rho - rho0); 1: p = b ((rho/rho0)^gamma - 1)
  int floor_p;       // clamp p >= 0
  float stiffness;
  float rest;
  float b;
  float gamma;
};

__device__ __forceinline__ float eos_pressure(float rho, const Eos& e) {
  float p = e.tait ? e.b * (powf(rho / e.rest, e.gamma) - 1.0f)
                   : e.stiffness * (rho - e.rest);
  return e.floor_p ? fmaxf(p, 0.0f) : p;
}

// False for the blocks with nothing to compute: row 0, rows past n_occ, and
// blocks with no particle.  The same for every thread of a block.
__device__ __forceinline__ bool live_block(const int* __restrict__ n_occ,
                                           const int* __restrict__ gcounts,
                                           int row, int g, int n_groups) {
  if (row == 0 || row > __ldg(n_occ)) return false;
  return __ldg(gcounts + row * n_groups + g) != 0;
}

template <int DIM>
__global__ void __launch_bounds__(kLane)
packed_density_kernel(const float* __restrict__ feat,
                      const int* __restrict__ nbr_pos,
                      const int* __restrict__ jb,
                      const int* __restrict__ gcounts,
                      const int* __restrict__ n_occ, float* __restrict__ rp,
                      int c_rows, int lanes, int n_groups, int n_r, float h2,
                      float mc, Eos eos) {
  __shared__ float xs[DIM][kLane];
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kLane + tid;
  float* out = rp + (size_t)row * 2 * lanes + lane;
  if (!live_block(n_occ, gcounts, row, blockIdx.x, n_groups)) {
    out[0] = 0.0f;
    out[lanes] = 0.0f;
    return;
  }
  const size_t strip = (size_t)kFeat * lanes;
  const float* fi = feat + row * strip + lane;
  float xi[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) xi[c] = fi[(size_t)c * lanes];

  float acc = 0.0f;
  for (int s = 0; s < n_r; ++s) {
    const int nr = __ldg(nbr_pos + s * c_rows + row);
    const int nb = __ldg(jb + nr);           // 0 for the dummy row
    const float* fj = feat + nr * strip;
    for (int jg = 0; jg < nb; ++jg) {
      const int cnt = __ldg(gcounts + nr * n_groups + jg);
      __syncthreads();                       // the last tile is consumed
      if (tid < cnt) {
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          xs[c][tid] = fj[(size_t)c * lanes + jg * kLane + tid];
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        float d = xi[0] - xs[0][j];
        float r2 = d * d;
#pragma unroll
        for (int c = 1; c < DIM; ++c) {
          d = xi[c] - xs[c][j];
          r2 += d * d;
        }
        const float q = fmaxf(h2 - r2, 0.0f);
        acc += q * q * q;
      }
    }
  }
  const bool real = xi[0] < kEmpty;
  const float rho = mc * acc;
  out[0] = real ? rho : 0.0f;
  out[lanes] = real ? eos_pressure(rho, eos) : 0.0f;
}

template <int DIM>
__global__ void __launch_bounds__(kLane)
packed_force_kernel(const float* __restrict__ feat,
                    const float* __restrict__ rp,
                    const int* __restrict__ nbr_pos,
                    const int* __restrict__ jb,
                    const int* __restrict__ gcounts,
                    const int* __restrict__ n_occ, float* __restrict__ f,
                    int c_rows, int lanes, int n_groups, int n_r, float h,
                    float c_s, float m_half, float mu_m, float c_v) {
  __shared__ float xs[DIM][kLane];
  __shared__ float vs[DIM][kLane];
  __shared__ float inv_rho_s[kLane];
  __shared__ float p_s[kLane];
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kLane + tid;
  float* out = f + (size_t)row * kFout * lanes + lane;
  if (!live_block(n_occ, gcounts, row, blockIdx.x, n_groups)) {
#pragma unroll
    for (int c = 0; c < kFout; ++c) out[(size_t)c * lanes] = 0.0f;
    return;
  }
  const size_t strip = (size_t)kFeat * lanes;
  const size_t rp_strip = (size_t)2 * lanes;
  const float* fi = feat + row * strip + lane;
  float xi[DIM], vi[DIM], fa[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    xi[c] = fi[(size_t)c * lanes];
    vi[c] = fi[(size_t)(3 + c) * lanes];
    fa[c] = 0.0f;
  }
  const float p_i = rp[row * rp_strip + lanes + lane];

  for (int s = 0; s < n_r; ++s) {
    const int nr = __ldg(nbr_pos + s * c_rows + row);
    const int nb = __ldg(jb + nr);           // 0 for the dummy row
    const float* fj = feat + nr * strip;
    const float* rpj = rp + nr * rp_strip;
    for (int jg = 0; jg < nb; ++jg) {
      const int cnt = __ldg(gcounts + nr * n_groups + jg);
      __syncthreads();                       // the last tile is consumed
      if (tid < cnt) {
        const int lj = jg * kLane + tid;
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          xs[c][tid] = fj[(size_t)c * lanes + lj];
          vs[c][tid] = fj[(size_t)(3 + c) * lanes + lj];
        }
        inv_rho_s[tid] = 1.0f / fmaxf(rpj[lj], 1e-12f);
        p_s[tid] = rpj[lanes + lj];
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        float dx[DIM];
        float r2 = 0.0f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          dx[c] = xi[c] - xs[c][j];
          r2 = c == 0 ? dx[0] * dx[0] : r2 + dx[c] * dx[c];
        }
        const float inv_r = 1.0f / sqrtf(fmaxf(r2, 1e-24f));
        const float t = fmaxf(h - r2 * inv_r, 0.0f);
        const float s_r = r2 > 1e-24f ? c_s * t * t * inv_r : 0.0f;
        const float inv_rho_j = inv_rho_s[j];
        const float coef_p = m_half * (p_i + p_s[j]) * inv_rho_j * s_r;
        const float coef_v = mu_m * inv_rho_j * (c_v * t);
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          fa[c] += coef_p * dx[c] + coef_v * (vs[c][j] - vi[c]);
      }
    }
  }
  const bool real = xi[0] < kEmpty;
#pragma unroll
  for (int c = 0; c < DIM; ++c) out[(size_t)c * lanes] = real ? fa[c] : 0.0f;
#pragma unroll
  for (int c = DIM; c < kFout; ++c) out[(size_t)c * lanes] = 0.0f;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after its launch; the caller raises on a nonzero code.  Launches go to
// the caller's stream and do not synchronize.

extern "C" int packed_density(const void* feat, const void* nbr_pos,
                              const void* jb, const void* gcounts,
                              const void* n_occ, void* rp, int c_rows,
                              int lanes, int n_groups, int n_r, int dim,
                              float h2, float mc, int tait, int floor_p,
                              float stiffness, float rest, float b,
                              float gamma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Eos eos{tait, floor_p, stiffness, rest, b, gamma};
  const dim3 grid(n_groups, c_rows);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* fe = (const float*)feat;
  const int* nb = (const int*)nbr_pos;
  const int* bl = (const int*)jb;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  if (dim == 3) {
    packed_density_kernel<3><<<grid, kLane, 0, st>>>(
        fe, nb, bl, gc, no, (float*)rp, c_rows, lanes, n_groups, n_r, h2, mc,
        eos);
  } else {
    packed_density_kernel<2><<<grid, kLane, 0, st>>>(
        fe, nb, bl, gc, no, (float*)rp, c_rows, lanes, n_groups, n_r, h2, mc,
        eos);
  }
  return (int)cudaGetLastError();
}

extern "C" int packed_force(const void* feat, const void* rp,
                            const void* nbr_pos, const void* jb,
                            const void* gcounts, const void* n_occ, void* f,
                            int c_rows, int lanes, int n_groups, int n_r,
                            int dim, float h, float c_s, float m_half,
                            float mu_m, float c_v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_groups, c_rows);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* fe = (const float*)feat;
  const float* r = (const float*)rp;
  const int* nb = (const int*)nbr_pos;
  const int* bl = (const int*)jb;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  if (dim == 3) {
    packed_force_kernel<3><<<grid, kLane, 0, st>>>(
        fe, r, nb, bl, gc, no, (float*)f, c_rows, lanes, n_groups, n_r, h,
        c_s, m_half, mu_m, c_v);
  } else {
    packed_force_kernel<2><<<grid, kLane, 0, st>>>(
        fe, r, nb, bl, gc, no, (float*)f, c_rows, lanes, n_groups, n_r, h,
        c_s, m_half, mu_m, c_v);
  }
  return (int)cudaGetLastError();
}
