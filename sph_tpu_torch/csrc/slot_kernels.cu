// Slot-layout SPH density (K1) and force (K2) kernels for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels `_density_kernel` and `_force_kernel` of
// sph_tpu/pallas_step.py.  Same function, not the same blocking: the TPU's
// xb-cell union windows and 128-aligned lane slices exist for Mosaic and
// are not copied; their extra candidates contribute exactly 0 by compact
// support, so each i-slot here visits only its own +-1 x-cells.
//
// Layout (see sph_tpu_torch/pallas_step.py):
//   feat    f32 [c_rows, 8, lanes]   x(3) | v(3) | . | .; empty slots sit at
//                                    1e18, row 0 is the all-empty dummy row
//   rp      f32 [c_rows, 2, lanes]   (rho, EOS p), K1's output and K2's input
//   f       f32 [c_rows, 4, lanes]   force density, components >= dim zero
//   nbr_pos i32 [R, c_rows]          compacted position of each of the
//                                    3^(dim-1) neighbor (z, y) rows
//   gcounts i32 [c_rows, 1, n_groups] real particles per 128-lane group
//   n_occ   i32 [1]                  number of real compacted rows; read on
//                                    the device, so a step needs no host sync
//
// Design: one thread per i-slot, one 128-thread block per (group, row).  A
// block writes zeros and exits for row 0, rows past n_occ, the halo groups
// 0 and n_groups-1, and groups with no real particle; a thread whose slot
// is empty (x >= 1e17) writes zeros too.  So the kernel writes every output
// element, as the TPU kernel zeroes every output block, and the wrapper
// allocates the output without a fill of its own.  Each thread
// loops over the R neighbor rows x the x-cells hx-1..hx+1 x cap slots in a
// fixed order, with no atomics, so results are bitwise reproducible run to
// run.
//
// What bounds it on this card: each pair costs ~13 (K1) / ~38 (K2) fp32
// operations, and each i-slot examines R*3*cap = 432 (3D, cap 16) candidate
// slots, most of them empty, so a run is far above the bytes the function
// must move (x, or x|v|rho|p, of the occupied rows read once, and rho|p, or
// f, of those rows written once; the zeros past n_occ are extra writes the
// gathers never read).  Candidate loads
// are shared: the 16 threads of one cell read the same addresses and the
// next cell's threads the neighboring 16, so they are served from L1/L2.
// Staging the rows in shared memory and skipping empty candidate slots is
// left for a later change; PERF.md holds the measured times beside the
// bound.
//
// K2 takes 1/r as 1.0f / sqrtf(r2) (IEEE-rounded sqrt and division; the
// build passes no --use_fast_math), not the approximate rsqrtf.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 8;
constexpr int kFout = 4;
constexpr int kLane = 128;
constexpr float kEmpty = 1e17f;  // empty slots hold 1e18

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

// False for the blocks with nothing to compute: row 0, rows past n_occ, the
// halo groups 0 and n_groups-1, and groups with no real particle.
__device__ __forceinline__ bool live_group(const int* __restrict__ n_occ,
                                           const int* __restrict__ gcounts,
                                           int row, int g, int n_groups) {
  if (row == 0 || row > __ldg(n_occ) || g == 0 || g == n_groups - 1)
    return false;
  return __ldg(gcounts + row * n_groups + g) != 0;
}

template <int C>
__device__ __forceinline__ void write_zeros(float* out, int lanes) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[(size_t)c * lanes] = 0.0f;
}

template <int DIM>
__global__ void __launch_bounds__(kLane)
density_kernel(const float* __restrict__ feat, const int* __restrict__ nbr_pos,
               const int* __restrict__ gcounts, const int* __restrict__ n_occ,
               float* __restrict__ rp, int c_rows, int lanes, int n_groups,
               int cap, int n_r, float h2, float mc, Eos eos) {
  const int row = blockIdx.y;
  const int lane = blockIdx.x * kLane + threadIdx.x;
  float* out = rp + (size_t)row * 2 * lanes + lane;
  if (!live_group(n_occ, gcounts, row, blockIdx.x, n_groups)) {
    write_zeros<2>(out, lanes);
    return;
  }
  const size_t strip = (size_t)kFeat * lanes;
  const float* fi = feat + row * strip + lane;
  float xi[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) xi[c] = fi[(size_t)c * lanes];
  if (xi[0] >= kEmpty) {
    write_zeros<2>(out, lanes);
    return;
  }

  const int j0 = (lane / cap - 1) * cap;   // cells hx-1 .. hx+1
  const int j1 = j0 + 3 * cap;
  float acc = 0.0f;
  for (int s = 0; s < n_r; ++s) {
    const float* fj = feat + __ldg(nbr_pos + s * c_rows + row) * strip;
    for (int j = j0; j < j1; ++j) {
      float d = xi[0] - __ldg(fj + j);
      float r2 = d * d;
#pragma unroll
      for (int c = 1; c < DIM; ++c) {
        d = xi[c] - __ldg(fj + (size_t)c * lanes + j);
        r2 += d * d;
      }
      const float q = fmaxf(h2 - r2, 0.0f);
      acc += q * q * q;
    }
  }
  const float rho = mc * acc;
  out[0] = rho;
  out[lanes] = eos_pressure(rho, eos);
}

template <int DIM>
__global__ void __launch_bounds__(kLane)
force_kernel(const float* __restrict__ feat, const float* __restrict__ rp,
             const int* __restrict__ nbr_pos, const int* __restrict__ gcounts,
             const int* __restrict__ n_occ, float* __restrict__ f,
             int c_rows, int lanes, int n_groups, int cap, int n_r, float h,
             float c_s, float m_half, float mu_m, float c_v) {
  const int row = blockIdx.y;
  const int lane = blockIdx.x * kLane + threadIdx.x;
  float* out = f + (size_t)row * kFout * lanes + lane;
  if (!live_group(n_occ, gcounts, row, blockIdx.x, n_groups)) {
    write_zeros<kFout>(out, lanes);
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
  if (xi[0] >= kEmpty) {
    write_zeros<kFout>(out, lanes);
    return;
  }
  const float p_i = rp[row * rp_strip + lanes + lane];

  const int j0 = (lane / cap - 1) * cap;   // cells hx-1 .. hx+1
  const int j1 = j0 + 3 * cap;
  for (int s = 0; s < n_r; ++s) {
    const int nr = __ldg(nbr_pos + s * c_rows + row);
    const float* fj = feat + nr * strip;
    const float* rpj = rp + nr * rp_strip;
    for (int j = j0; j < j1; ++j) {
      float dx[DIM];
      float r2 = 0.0f;
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        dx[c] = xi[c] - __ldg(fj + (size_t)c * lanes + j);
        r2 = c == 0 ? dx[0] * dx[0] : r2 + dx[c] * dx[c];
      }
      const float inv_r = 1.0f / sqrtf(fmaxf(r2, 1e-24f));
      const float t = fmaxf(h - r2 * inv_r, 0.0f);
      const float s_r = r2 > 1e-24f ? c_s * t * t * inv_r : 0.0f;
      const float inv_rho_j = 1.0f / fmaxf(__ldg(rpj + j), 1e-12f);
      const float coef_p = m_half * (p_i + __ldg(rpj + lanes + j)) * inv_rho_j * s_r;
      const float coef_v = mu_m * inv_rho_j * (c_v * t);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        const float vj = __ldg(fj + (size_t)(3 + c) * lanes + j);
        fa[c] += coef_p * dx[c] + coef_v * (vj - vi[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c) out[(size_t)c * lanes] = fa[c];
#pragma unroll
  for (int c = DIM; c < kFout; ++c) out[(size_t)c * lanes] = 0.0f;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after its launch; the caller raises on a nonzero code.  Launches go to
// the caller's stream and do not synchronize.

extern "C" int slot_density(const void* feat, const void* nbr_pos,
                            const void* gcounts, const void* n_occ, void* rp,
                            int c_rows, int lanes, int n_groups, int cap,
                            int n_r, int dim, float h2, float mc, int tait,
                            int floor_p, float stiffness, float rest, float b,
                            float gamma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Eos eos{tait, floor_p, stiffness, rest, b, gamma};
  const dim3 grid(n_groups, c_rows);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* fe = (const float*)feat;
  const int* nb = (const int*)nbr_pos;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  if (dim == 3) {
    density_kernel<3><<<grid, kLane, 0, st>>>(fe, nb, gc, no, (float*)rp,
                                              c_rows, lanes, n_groups, cap,
                                              n_r, h2, mc, eos);
  } else {
    density_kernel<2><<<grid, kLane, 0, st>>>(fe, nb, gc, no, (float*)rp,
                                              c_rows, lanes, n_groups, cap,
                                              n_r, h2, mc, eos);
  }
  return (int)cudaGetLastError();
}

extern "C" int slot_force(const void* feat, const void* rp,
                          const void* nbr_pos, const void* gcounts,
                          const void* n_occ, void* f, int c_rows, int lanes,
                          int n_groups, int cap, int n_r, int dim, float h,
                          float c_s, float m_half, float mu_m, float c_v,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_groups, c_rows);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* fe = (const float*)feat;
  const float* r = (const float*)rp;
  const int* nb = (const int*)nbr_pos;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  if (dim == 3) {
    force_kernel<3><<<grid, kLane, 0, st>>>(fe, r, nb, gc, no, (float*)f,
                                            c_rows, lanes, n_groups, cap, n_r,
                                            h, c_s, m_half, mu_m, c_v);
  } else {
    force_kernel<2><<<grid, kLane, 0, st>>>(fe, r, nb, gc, no, (float*)f,
                                            c_rows, lanes, n_groups, cap, n_r,
                                            h, c_s, m_half, mu_m, c_v);
  }
  return (int)cudaGetLastError();
}
