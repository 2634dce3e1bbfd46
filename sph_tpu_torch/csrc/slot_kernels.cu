// Slot-layout SPH density (K1) and force (K2) kernels for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels `_density_kernel` and `_force_kernel` of
// sph_tpu/pallas_step.py, every branch: fp32 or bf16 cell-relative
// features, and an x margin of `xm` slot-cells (the reference's xsub).
// Same function, not the same blocking: the TPU's xb-cell union windows and
// 128-aligned lane slices exist for Mosaic and are not copied; their extra
// candidates contribute exactly 0 by compact support, so each i-slot here
// visits only its own slot-cells hx-xm..hx+xm (xm slot-cells span one full
// cell, so beyond them no candidate is within h).  The reference's row_pair
// maps two rows to one Pallas program; one thread per slot has no use for
// it, so these kernels take no such option.
//
// Layout (see sph_tpu_torch/pallas_step.py):
//   feat    f32 or bf16 [c_rows, 8, lanes]  x(3) | v(3) | . | .; empty slots
//                                    sit at 1e18, row 0 is the all-empty
//                                    dummy row
//   rp      f32 [c_rows, 2, lanes]   (rho, EOS p), K1's output and K2's input
//   f       f32 [c_rows, 4, lanes]   force density, components >= dim zero
//   nbr_pos i32 [R, c_rows]          compacted position of each of the
//                                    3^(dim-1) neighbor (z, y) rows
//   gcounts i32 [c_rows, 1, n_groups] real particles per 128-lane group
//   n_occ   i32 [1]                  number of real compacted rows; read on
//                                    the device, so a step needs no host sync
//
// bf16 features hold positions relative to the particle's build-time cell
// center (velocities absolute), so the kernels rebuild pair distances from
// the static lattice offsets, with the reference's origin and rounding
// (`_bf16_offsets`, sph_tpu/pallas_step.py:316): in x the origin is the
// first slot-cell of the i-slot's 128-lane group, so i adds
// (lane_in_group / cap) * cfx and j adds (its slot-cell - the group's first)
// * cfx, each product rounded once (cfx = fp32(cell / xsub)); in y and z, j
// adds (dy, dz) * cf of its neighbor row.  Each value is upcast to fp32 and
// its offset added with one rounding, so (rel_i + off_i) - (rel_j + off_j)
// has the reference's bits.  __fmul_rn / __fadd_rn keep nvcc from fusing an
// offset product into an FMA, which would round once instead of twice.
//
// Design: one thread per i-slot, one 128-thread block per (group, row).  A
// block writes zeros and exits for row 0, rows past n_occ, the halo groups
// 0 and n_groups-1, and groups with no real particle; a thread whose slot
// is empty (x >= 1e17) writes zeros too.  So the kernel writes every output
// element, as the TPU kernel zeroes every output block, and the wrapper
// allocates the output without a fill of its own.  Each thread
// loops over the R neighbor rows x the slot-cells hx-xm..hx+xm x cap slots
// in a fixed order, with no atomics, so results are bitwise reproducible
// run to run.
//
// What bounds it on this card: each pair costs ~13 (K1) / ~38 (K2) fp32
// operations (bf16: 2 more a coordinate for the upcast and the offset), and
// each i-slot examines R*3*cap = 432 (3D, cap 16) candidate slots, most of
// them empty, so a run is far above the bytes the function must move (x, or
// x|v|rho|p, of the occupied rows read once, and rho|p, or f, of those rows
// written once; the zeros past n_occ are extra writes the gathers never
// read).  Candidate loads
// are shared: the 16 threads of one cell read the same addresses and the
// next cell's threads the neighboring 16, so they are served from L1/L2.
// Halving the feature bytes (bf16) does not touch that bound.  Staging the
// rows in shared memory and skipping empty candidate slots is left for a
// later change; PERF.md holds the measured times beside the bound.
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

// Lattice offsets of the bf16 cell-relative frame (see the header).
struct Frame {
  float cf;          // fp32(cell): y and z rows
  float cfx;         // fp32(cell / xsub): x slot-cells
};

__device__ __forceinline__ float eos_pressure(float rho, const Eos& e) {
  float p = e.tait ? e.b * (powf(rho / e.rest, e.gamma) - 1.0f)
                   : e.stiffness * (rho - e.rest);
  return e.floor_p ? fmaxf(p, 0.0f) : p;
}

// One feature value as fp32: a plain load, or a bf16 load widened exactly
// (a bf16 is the top 16 bits of the fp32 of the same value).
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const unsigned short* p) {
  return __uint_as_float((unsigned)__ldg(p) << 16);
}

// value + (k * step), the product and the sum each rounded once.
__device__ __forceinline__ float add_offset(float value, int k, float step) {
  return __fadd_rn(value, __fmul_rn((float)k, step));
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

// The i-slot's position in the frame of its group (fp32: as stored).
template <int DIM, typename T>
__device__ __forceinline__ void self_position(const T* fi, int lanes, int lane,
                                              int cap, const Frame& fr,
                                              float (&xi)[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) xi[c] = load(fi + (size_t)c * lanes);
  if constexpr (sizeof(T) == 2)
    xi[DIM - 1] = add_offset(xi[DIM - 1], (lane % kLane) / cap, fr.cfx);
}

// Static y/z offsets of neighbor strip s, in cells (row_offsets order).
template <int DIM>
__device__ __forceinline__ void strip_offset(int s, int& dz, int& dy) {
  dz = DIM == 3 ? s / 3 - 1 : 0;
  dy = DIM == 3 ? s % 3 - 1 : s - 1;
}

// Candidate j's position in the i-slot's frame: slot-cell `cell_k` of the
// group (x) and strip offsets dz, dy (fp32: as stored).
template <int DIM, typename T>
__device__ __forceinline__ void cand_position(const T* fj, int lanes, int j,
                                              int cell_k, int dz, int dy,
                                              const Frame& fr,
                                              float (&xj)[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) xj[c] = load(fj + (size_t)c * lanes + j);
  if constexpr (sizeof(T) == 2) {
    xj[DIM - 1] = add_offset(xj[DIM - 1], cell_k, fr.cfx);
    xj[DIM - 2] = add_offset(xj[DIM - 2], dy, fr.cf);
    if constexpr (DIM == 3) xj[0] = add_offset(xj[0], dz, fr.cf);
  }
}

template <int DIM, typename T>
__global__ void __launch_bounds__(kLane)
density_kernel(const T* __restrict__ feat, const int* __restrict__ nbr_pos,
               const int* __restrict__ gcounts, const int* __restrict__ n_occ,
               float* __restrict__ rp, int c_rows, int lanes, int n_groups,
               int cap, int xm, int n_r, float h2, float mc, Eos eos,
               Frame fr) {
  const int row = blockIdx.y;
  const int lane = blockIdx.x * kLane + threadIdx.x;
  float* out = rp + (size_t)row * 2 * lanes + lane;
  if (!live_group(n_occ, gcounts, row, blockIdx.x, n_groups)) {
    write_zeros<2>(out, lanes);
    return;
  }
  const size_t strip = (size_t)kFeat * lanes;
  float xi[DIM];
  self_position<DIM>(feat + row * strip + lane, lanes, lane, cap, fr, xi);
  if (xi[0] >= kEmpty) {
    write_zeros<2>(out, lanes);
    return;
  }

  const int hx = lane / cap;                   // slot-cells hx-xm .. hx+xm
  const int cell0 = blockIdx.x * (kLane / cap);  // the group's first
  float acc = 0.0f;
  for (int s = 0; s < n_r; ++s) {
    const T* fj = feat + __ldg(nbr_pos + s * c_rows + row) * strip;
    int dz, dy;
    strip_offset<DIM>(s, dz, dy);
    for (int cx = hx - xm; cx <= hx + xm; ++cx) {
      for (int j = cx * cap; j < (cx + 1) * cap; ++j) {
        float xj[DIM];
        cand_position<DIM>(fj, lanes, j, cx - cell0, dz, dy, fr, xj);
        float d = xi[0] - xj[0];
        float r2 = d * d;
#pragma unroll
        for (int c = 1; c < DIM; ++c) {
          d = xi[c] - xj[c];
          r2 += d * d;
        }
        const float q = fmaxf(h2 - r2, 0.0f);
        acc += q * q * q;
      }
    }
  }
  const float rho = mc * acc;
  out[0] = rho;
  out[lanes] = eos_pressure(rho, eos);
}

template <int DIM, typename T>
__global__ void __launch_bounds__(kLane)
force_kernel(const T* __restrict__ feat, const float* __restrict__ rp,
             const int* __restrict__ nbr_pos, const int* __restrict__ gcounts,
             const int* __restrict__ n_occ, float* __restrict__ f,
             int c_rows, int lanes, int n_groups, int cap, int xm, int n_r,
             float h, float c_s, float m_half, float mu_m, float c_v,
             Frame fr) {
  const int row = blockIdx.y;
  const int lane = blockIdx.x * kLane + threadIdx.x;
  float* out = f + (size_t)row * kFout * lanes + lane;
  if (!live_group(n_occ, gcounts, row, blockIdx.x, n_groups)) {
    write_zeros<kFout>(out, lanes);
    return;
  }
  const size_t strip = (size_t)kFeat * lanes;
  const size_t rp_strip = (size_t)2 * lanes;
  const T* fi = feat + row * strip + lane;
  float xi[DIM], vi[DIM], fa[DIM];
  self_position<DIM>(fi, lanes, lane, cap, fr, xi);
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    vi[c] = load(fi + (size_t)(3 + c) * lanes);
    fa[c] = 0.0f;
  }
  if (xi[0] >= kEmpty) {
    write_zeros<kFout>(out, lanes);
    return;
  }
  const float p_i = rp[row * rp_strip + lanes + lane];

  const int hx = lane / cap;                   // slot-cells hx-xm .. hx+xm
  const int cell0 = blockIdx.x * (kLane / cap);  // the group's first
  for (int s = 0; s < n_r; ++s) {
    const int nr = __ldg(nbr_pos + s * c_rows + row);
    const T* fj = feat + nr * strip;
    const float* rpj = rp + nr * rp_strip;
    int dz, dy;
    strip_offset<DIM>(s, dz, dy);
    for (int cx = hx - xm; cx <= hx + xm; ++cx) {
      for (int j = cx * cap; j < (cx + 1) * cap; ++j) {
        float xj[DIM], dx[DIM];
        cand_position<DIM>(fj, lanes, j, cx - cell0, dz, dy, fr, xj);
        float r2 = 0.0f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          dx[c] = xi[c] - xj[c];
          r2 = c == 0 ? dx[0] * dx[0] : r2 + dx[c] * dx[c];
        }
        const float inv_r = 1.0f / sqrtf(fmaxf(r2, 1e-24f));
        const float t = fmaxf(h - r2 * inv_r, 0.0f);
        const float s_r = r2 > 1e-24f ? c_s * t * t * inv_r : 0.0f;
        const float inv_rho_j = 1.0f / fmaxf(__ldg(rpj + j), 1e-12f);
        const float coef_p =
            m_half * (p_i + __ldg(rpj + lanes + j)) * inv_rho_j * s_r;
        const float coef_v = mu_m * inv_rho_j * (c_v * t);
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          const float vj = load(fj + (size_t)(3 + c) * lanes + j);
          fa[c] += coef_p * dx[c] + coef_v * (vj - vi[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c) out[(size_t)c * lanes] = fa[c];
#pragma unroll
  for (int c = DIM; c < kFout; ++c) out[(size_t)c * lanes] = 0.0f;
}

template <int DIM, typename T>
void launch_density(const void* feat, const int* nb, const int* gc,
                    const int* no, float* rp, int c_rows, int lanes,
                    int n_groups, int cap, int xm, int n_r, float h2, float mc,
                    const Eos& eos, const Frame& fr, cudaStream_t st) {
  density_kernel<DIM, T><<<dim3(n_groups, c_rows), kLane, 0, st>>>(
      (const T*)feat, nb, gc, no, rp, c_rows, lanes, n_groups, cap, xm, n_r,
      h2, mc, eos, fr);
}

template <int DIM, typename T>
void launch_force(const void* feat, const float* rp, const int* nb,
                  const int* gc, const int* no, float* f, int c_rows,
                  int lanes, int n_groups, int cap, int xm, int n_r, float h,
                  float c_s, float m_half, float mu_m, float c_v,
                  const Frame& fr, cudaStream_t st) {
  force_kernel<DIM, T><<<dim3(n_groups, c_rows), kLane, 0, st>>>(
      (const T*)feat, rp, nb, gc, no, f, c_rows, lanes, n_groups, cap, xm,
      n_r, h, c_s, m_half, mu_m, c_v, fr);
}

}  // namespace

// Plain C interface (loaded with ctypes).  `bf16` selects the bf16
// cell-relative features (then `cf`, `cfx` are the frame's offsets), `xm`
// the x margin in slot-cells.  Each returns cudaGetLastError() after its
// launch; the caller raises on a nonzero code.  Launches go to the caller's
// stream and do not synchronize.

extern "C" int slot_density(const void* feat, const void* nbr_pos,
                            const void* gcounts, const void* n_occ, void* rp,
                            int c_rows, int lanes, int n_groups, int cap,
                            int xm, int n_r, int dim, int bf16, float h2,
                            float mc, int tait, int floor_p, float stiffness,
                            float rest, float b, float gamma, float cf,
                            float cfx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Eos eos{tait, floor_p, stiffness, rest, b, gamma};
  const Frame fr{cf, cfx};
  const cudaStream_t st = (cudaStream_t)stream;
  const int* nb = (const int*)nbr_pos;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  float* out = (float*)rp;
  if (dim == 3 && bf16) {
    launch_density<3, unsigned short>(feat, nb, gc, no, out, c_rows, lanes,
                                      n_groups, cap, xm, n_r, h2, mc, eos,
                                      fr, st);
  } else if (dim == 3) {
    launch_density<3, float>(feat, nb, gc, no, out, c_rows, lanes, n_groups,
                             cap, xm, n_r, h2, mc, eos, fr, st);
  } else if (bf16) {
    launch_density<2, unsigned short>(feat, nb, gc, no, out, c_rows, lanes,
                                      n_groups, cap, xm, n_r, h2, mc, eos,
                                      fr, st);
  } else {
    launch_density<2, float>(feat, nb, gc, no, out, c_rows, lanes, n_groups,
                             cap, xm, n_r, h2, mc, eos, fr, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int slot_force(const void* feat, const void* rp,
                          const void* nbr_pos, const void* gcounts,
                          const void* n_occ, void* f, int c_rows, int lanes,
                          int n_groups, int cap, int xm, int n_r, int dim,
                          int bf16, float h, float c_s, float m_half,
                          float mu_m, float c_v, float cf, float cfx,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Frame fr{cf, cfx};
  const cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rp;
  const int* nb = (const int*)nbr_pos;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  float* out = (float*)f;
  if (dim == 3 && bf16) {
    launch_force<3, unsigned short>(feat, r, nb, gc, no, out, c_rows, lanes,
                                    n_groups, cap, xm, n_r, h, c_s, m_half,
                                    mu_m, c_v, fr, st);
  } else if (dim == 3) {
    launch_force<3, float>(feat, r, nb, gc, no, out, c_rows, lanes, n_groups,
                           cap, xm, n_r, h, c_s, m_half, mu_m, c_v, fr, st);
  } else if (bf16) {
    launch_force<2, unsigned short>(feat, r, nb, gc, no, out, c_rows, lanes,
                                    n_groups, cap, xm, n_r, h, c_s, m_half,
                                    mu_m, c_v, fr, st);
  } else {
    launch_force<2, float>(feat, r, nb, gc, no, out, c_rows, lanes, n_groups,
                           cap, xm, n_r, h, c_s, m_half, mu_m, c_v, fr, st);
  }
  return (int)cudaGetLastError();
}
