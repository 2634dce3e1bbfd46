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
// maps two rows to one Pallas program; these kernels have no use for it.
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
// What bounds them on this card.  The function needs, per real candidate
// pair, r^2 and a compare (9 fp32 operations in 3D), and only for a pair
// within h (about 15% of them in a 3x3x3-cell window) the rest of the pair
// arithmetic (~13 in all for K1, ~39 for K2); at the presets' densities
// that takes less time than the bytes the function must move (x, or
// x|v|rho|p, of the occupied rows read once, rho|p or f written once), so
// the bound is bytes (chip_smoke.py `bound`).  The first design (kept as the `_simple`
// kernels, the yardstick the staged ones are held to bitwise) was
// issue-bound on wasted work: one thread per slot of a 128-lane group, two
// thirds of its lanes without a particle, each looping over all R * (2 xm
// + 1) * cap candidate slots (432 in 3D at cap 16), two thirds of those
// empty, every candidate loaded from L1/L2 once per i-slot and, for bf16,
// widened and offset once per pair.
//
// The staged design (staged_kernel), one block of kThreads per (128-lane
// group, row); a group with nothing to compute writes its zeros and exits:
//   1. Threads only for live i-slots.  A ballot over the group's lanes
//      lists its real particles in shared memory (the empty lanes get their
//      zeros there and then), and thread t takes live slots t, t +
//      kThreads, ..., so the warps that compute are full.  An i-slot's
//      position, velocity and sums stay in shared memory between rows.
//   2. Each neighbor row's window, lanes [g*128 - xm*cap, (g+1)*128 +
//      xm*cap), is staged once per block: a coalesced pass over x reads
//      which slots are real, and the real ones are compacted, in lane order,
//      into float4 records of x (and 1/max(rho_j, 1e-12)) and v (and p_j),
//      bf16 widened and frame-offset at this point, once per slot instead of
//      once per pair.  The same operations on the same values: the same bits.
//   3. Empty candidates are skipped.  The compacted list keeps lane order,
//      so a slot-cell's real slots are consecutive and an i-slot's window
//      (slot-cells hx-xm..hx+xm) is one range [start[c], start[c+2xm+1]) of
//      it, with no assumption that a cell's particles fill its first slots
//      (the resident path's repair leaves holes).  A skipped candidate
//      (x >= 1e17) would add exactly +-0: for it r^2 ~ 1e36 is finite, so
//      K1's max(h^2 - r^2, 0) and K2's t = max(h - r, 0) are 0, and with
//      the finite rho_j, p_j that K1 writes there every product is +-0; an
//      accumulator that starts at +0 never becomes -0, so adding +-0 leaves
//      its bits unchanged (tests/test_torch_skip.py holds this on the host).
//      K2 also leaves out the real candidates beyond h (r^2 >= force_cut2,
//      where t = 0 too): a thread first lists, kNear at a time, the
//      candidates of its range within the cut, then runs the costly pair
//      arithmetic (IEEE sqrt and division) on those only; in a 3x3x3-cell
//      window about 15% of the real candidates lie within h.
//   4. Per i-slot the order stays row s, then slot-cell, then slot
//      ascending, with no atomics and no cross-thread sum, and the pair
//      arithmetic is one function (density_pair, force_pair) that both
//      designs call, so the staged kernels give the simple ones' bits.
// The block size (64) and the choice against staging the next row with
// cp.async, a persistent grid and a register prefetch of the next row rest
// on a sweep on the card whose numbers were not kept: unrecorded, and open
// to a measured sweep (ROADMAP Queue 2).
// K2 takes 1/r as 1.0f / sqrtf(r2) (IEEE-rounded sqrt and division; the
// build passes no --use_fast_math), not the approximate rsqrtf.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kFeat = 8;
constexpr int kFout = 4;
constexpr int kLane = 128;
constexpr float kEmpty = 1e17f;  // empty slots hold 1e18
// threads of a staged block: sized from the live i-slots per live group
// (chip_smoke.py prints their histogram, median 30-64; see the header)
constexpr int kThreads = 64;
static_assert(kThreads % 32 == 0 && kLane % kThreads == 0,
              "whole warps that divide the 128-lane group");

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

struct ForceConst {
  float h, c_s, m_half, mu_m, c_v;
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

// An i- or j-slot holds a particle unless its first coordinate is at the
// empty sentinel (written so that a NaN counts as a particle, as the
// simple kernels treat it).
__device__ __forceinline__ bool real_slot(float x0) { return !(x0 >= kEmpty); }

__device__ __forceinline__ float inv_rho(float rho) {
  return 1.0f / fmaxf(rho, 1e-12f);
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
__device__ __forceinline__ void frame_offset(int cell_k, int dz, int dy,
                                             const Frame& fr,
                                             float (&xj)[DIM]) {
  if constexpr (sizeof(T) == 2) {
    xj[DIM - 1] = add_offset(xj[DIM - 1], cell_k, fr.cfx);
    xj[DIM - 2] = add_offset(xj[DIM - 2], dy, fr.cf);
    if constexpr (DIM == 3) xj[0] = add_offset(xj[0], dz, fr.cf);
  }
}

template <int DIM, typename T>
__device__ __forceinline__ void cand_position(const T* fj, int lanes, int j,
                                              int cell_k, int dz, int dy,
                                              const Frame& fr,
                                              float (&xj)[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) xj[c] = load(fj + (size_t)c * lanes + j);
  frame_offset<DIM, T>(cell_k, dz, dy, fr, xj);
}

// One candidate's term of K1's sum, added to acc.  Both designs call it, so
// nvcc contracts and rounds it alike in each.
template <int DIM>
__device__ __forceinline__ void density_pair(const float (&xi)[DIM],
                                             const float (&xj)[DIM], float h2,
                                             float& acc) {
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

// One candidate's term of K2's sum, added to fa (inv_rho_j = inv_rho(rho_j)).
template <int DIM>
__device__ __forceinline__ void force_pair(const float (&xi)[DIM],
                                           const float (&vi)[DIM], float p_i,
                                           const float (&xj)[DIM],
                                           const float (&vj)[DIM],
                                           float inv_rho_j, float p_j,
                                           const ForceConst& k,
                                           float (&fa)[DIM]) {
  float dx[DIM];
  float r2 = 0.0f;
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    dx[c] = xi[c] - xj[c];
    r2 = c == 0 ? dx[0] * dx[0] : r2 + dx[c] * dx[c];
  }
  const float inv_r = 1.0f / sqrtf(fmaxf(r2, 1e-24f));
  const float t = fmaxf(k.h - r2 * inv_r, 0.0f);
  const float s_r = r2 > 1e-24f ? k.c_s * t * t * inv_r : 0.0f;
  const float coef_p = k.m_half * (p_i + p_j) * inv_rho_j * s_r;
  const float coef_v = k.mu_m * inv_rho_j * (k.c_v * t);
#pragma unroll
  for (int c = 0; c < DIM; ++c)
    fa[c] += coef_p * dx[c] + coef_v * (vj[c] - vi[c]);
}

template <int DIM>
__device__ __forceinline__ float4 pack(const float (&x)[DIM], float w) {
  return make_float4(x[0], x[1], DIM == 3 ? x[DIM - 1] : 0.0f, w);
}

template <int DIM>
__device__ __forceinline__ void unpack(const float4& a, float (&x)[DIM]) {
  x[0] = a.x;
  x[1] = a.y;
  if constexpr (DIM == 3) x[2] = a.z;
}

// ---------------------------------------------------------------------------
// The simple design (the first version of these kernels): one thread per
// slot, global loads of every candidate.  The yardstick of the staged
// kernels; no path runs it.
// ---------------------------------------------------------------------------

template <int DIM, typename T>
__global__ void __launch_bounds__(kLane)
density_kernel_simple(const T* __restrict__ feat,
                      const int* __restrict__ nbr_pos,
                      const int* __restrict__ gcounts,
                      const int* __restrict__ n_occ, float* __restrict__ rp,
                      int c_rows, int lanes, int n_groups, int cap, int xm,
                      int n_r, float h2, float mc, Eos eos, Frame fr) {
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
        density_pair<DIM>(xi, xj, h2, acc);
      }
    }
  }
  const float rho = mc * acc;
  out[0] = rho;
  out[lanes] = eos_pressure(rho, eos);
}

template <int DIM, typename T>
__global__ void __launch_bounds__(kLane)
force_kernel_simple(const T* __restrict__ feat, const float* __restrict__ rp,
                    const int* __restrict__ nbr_pos,
                    const int* __restrict__ gcounts,
                    const int* __restrict__ n_occ, float* __restrict__ f,
                    int c_rows, int lanes, int n_groups, int cap, int xm,
                    int n_r, ForceConst k, Frame fr) {
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
        float xj[DIM], vj[DIM];
        cand_position<DIM>(fj, lanes, j, cx - cell0, dz, dy, fr, xj);
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          vj[c] = load(fj + (size_t)(3 + c) * lanes + j);
        force_pair<DIM>(xi, vi, p_i, xj, vj, inv_rho(__ldg(rpj + j)),
                        __ldg(rpj + lanes + j), k, fa);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c) out[(size_t)c * lanes] = fa[c];
#pragma unroll
  for (int c = DIM; c < kFout; ++c) out[(size_t)c * lanes] = 0.0f;
}

// ---------------------------------------------------------------------------
// The staged design
// ---------------------------------------------------------------------------

constexpr int kNear = 16;        // K2: candidates within h listed at a time

// A staged block's shared memory, carved from its dynamic allocation
// (stage_bytes): W = 128 + 2 xm cap window slots.
struct Stage {
  float4* xa;      // [W] compacted real candidates: x, and 1/rho_j (K2)
  float4* vb;      // [W] K2: v, and p_j
  float4* si;      // [128] live i-slots: x, and p_i (K2) or the rho sum (K1)
  float4* sv;      // [128] K2: v_i
  float4* acc;     // [128] K2: the f sum
  int* live;       // [128] lane in the group of each live i-slot
  int* start;      // [W + 1] compacted index of each window slot-cell's
                   // first slot, then the count
  unsigned* mask;  // [W / 32 + 1] ballots: which window slots are real
  unsigned short* near;  // [kNear][kThreads] K2: candidates within h
};

__host__ __device__ inline int window(int cap, int xm) {
  return kLane + 2 * xm * cap;
}

__host__ __device__ inline size_t stage_bytes(bool force, int cap, int xm) {
  const int w = window(cap, xm);
  return sizeof(float4) * (force ? 2 * (size_t)w + 3 * kLane : w + kLane)
         + sizeof(int) * (kLane + w + 1) + sizeof(unsigned) * (w / 32 + 1)
         + (force ? sizeof(unsigned short) * kNear * kThreads : 0);
}

__device__ __forceinline__ Stage carve(float4* base, bool force, int w) {
  Stage s;
  s.xa = base;
  s.vb = s.xa + w;
  s.si = s.vb + (force ? w : 0);
  s.sv = s.si + kLane;
  s.acc = s.sv + (force ? kLane : 0);
  s.live = reinterpret_cast<int*>(s.acc + (force ? kLane : 0));
  s.start = s.live + kLane;
  s.mask = reinterpret_cast<unsigned*>(s.start + w + 1);
  s.near = reinterpret_cast<unsigned short*>(s.mask + w / 32 + 1);
  return s;
}

// Number of set ballot bits before bit `w` of the mask words.
__device__ __forceinline__ int rank_in(const unsigned* mask, int w) {
  int k = __popc(mask[w >> 5] & ((1u << (w & 31)) - 1u));
  for (int m = 0; m < (w >> 5); ++m) k += __popc(mask[m]);
  return k;
}

// Lists the group's live i-slots (lanes 0..127 of `fi`, ascending) in
// sh.live, writes zeros to the C output components of its empty lanes, and
// returns how many are live.  Ends with the list visible to the block.
template <int C, typename T>
__device__ int list_live(const T* fi, float* out, int lanes, const Stage& sh) {
  for (int w = threadIdx.x; w < kLane; w += kThreads) {
    const bool live = real_slot(load(fi + w));
    const unsigned b = __ballot_sync(0xffffffffu, live);
    if ((w & 31) == 0) sh.mask[w >> 5] = b;
    if (!live) write_zeros<C>(out + w, lanes);
  }
  __syncthreads();
  for (int w = threadIdx.x; w < kLane; w += kThreads)
    if ((sh.mask[w >> 5] >> (w & 31)) & 1u) sh.live[rank_in(sh.mask, w)] = w;
  int n = 0;
#pragma unroll
  for (int m = 0; m < kLane / 32; ++m) n += __popc(sh.mask[m]);
  __syncthreads();
  return n;
}

// Stages the real slots of neighbor strip `fj` (rp strip `rpj` for K2)
// over the window of group g into sh.xa (and sh.vb), compacted in lane
// order, with sh.start per window slot-cell.  Returns false, with nothing
// staged, when the window holds no particle.  Starts with a barrier (the
// previous strip's readers are done) and ends with one (the stage is
// visible); the return value is the same for every thread.
template <int DIM, bool FORCE, typename T>
__device__ bool stage_strip(const T* fj, const float* rpj, int lanes, int g,
                            int cap, int cs, int xm, int dz, int dy,
                            const Frame& fr, const Stage& sh) {
  const int w_slots = window(cap, xm);
  const int words = (w_slots + 31) >> 5;
  const int lane0 = g * kLane - xm * cap;      // first lane of the window
  const int cell0 = g * (kLane / cap);         // the group's first slot-cell
  __syncthreads();
  for (int w = threadIdx.x; w < words * 32; w += kThreads) {
    const bool real = w < w_slots && real_slot(load(fj + lane0 + w));
    const unsigned b = __ballot_sync(0xffffffffu, real);
    if ((w & 31) == 0) sh.mask[w >> 5] = b;
  }
  __syncthreads();
  int total = 0;
  for (int m = 0; m < words; ++m) total += __popc(sh.mask[m]);
  if (total == 0) return false;
  for (int w = threadIdx.x; w < w_slots; w += kThreads) {
    const int k = rank_in(sh.mask, w);
    if ((w & (cap - 1)) == 0) sh.start[w >> cs] = k;
    if (!((sh.mask[w >> 5] >> (w & 31)) & 1u)) continue;
    const int j = lane0 + w;
    float xj[DIM];
    cand_position<DIM>(fj, lanes, j, (j >> cs) - cell0, dz, dy, fr, xj);
    if constexpr (FORCE) {
      float vj[DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) vj[c] = load(fj + (size_t)(3 + c) * lanes + j);
      sh.xa[k] = pack<DIM>(xj, inv_rho(__ldg(rpj + j)));
      sh.vb[k] = pack<DIM>(vj, __ldg(rpj + lanes + j));
    } else {
      sh.xa[k] = pack<DIM>(xj, 0.0f);
    }
  }
  if (threadIdx.x == 0) sh.start[w_slots >> cs] = total;
  __syncthreads();
  return true;
}

// Squared distance as force_pair computes it, below the cut beyond which
// K2's term is exactly +-0 (see force_cut2).
template <int DIM>
__device__ __forceinline__ bool within_cut(const float (&xi)[DIM],
                                           const float (&xj)[DIM],
                                           float cut2) {
  float r2 = 0.0f;
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    const float d = xi[c] - xj[c];
    r2 = c == 0 ? d * d : r2 + d * d;
  }
  return !(r2 >= cut2);
}

// One live (128-lane group g, row) of K1 (FORCE false: rp = out) or K2
// (FORCE true: rp in, f = out); `o` is the group's first output lane.
template <int DIM, typename T, bool FORCE>
__device__ void staged_group(const T* __restrict__ feat,
                             const float* __restrict__ rp,
                             const int* __restrict__ nbr_pos, float* o,
                             int c_rows, int lanes, int row, int g, int cap,
                             int xm, int n_r, float h2, float mc,
                             const Eos& eos, const ForceConst& k, float cut2,
                             const Frame& fr, const Stage& sh) {
  constexpr int C = FORCE ? kFout : 2;
  const int cs = __ffs(cap) - 1;               // cap is a power of two
  const size_t strip = (size_t)kFeat * lanes;
  const size_t rp_strip = (size_t)2 * lanes;
  const T* fi = feat + row * strip + g * kLane;
  const int n_live = list_live<C>(fi, o, lanes, sh);
  for (int t = threadIdx.x; t < n_live; t += kThreads) {
    const int l = sh.live[t];
    float xi[DIM];
    self_position<DIM>(fi + l, lanes, g * kLane + l, cap, fr, xi);
    if constexpr (FORCE) {
      float vi[DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) vi[c] = load(fi + (size_t)(3 + c) * lanes + l);
      sh.si[t] = pack<DIM>(xi, rp[row * rp_strip + lanes + g * kLane + l]);
      sh.sv[t] = pack<DIM>(vi, 0.0f);
      sh.acc[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      sh.si[t] = pack<DIM>(xi, 0.0f);
    }
  }
  for (int s = 0; s < n_r; ++s) {
    const int nr = __ldg(nbr_pos + s * c_rows + row);
    int dz, dy;
    strip_offset<DIM>(s, dz, dy);
    if (!stage_strip<DIM, FORCE>(feat + nr * strip, rp + nr * rp_strip, lanes,
                                 g, cap, cs, xm, dz, dy, fr, sh))
      continue;
    for (int t = threadIdx.x; t < n_live; t += kThreads) {
      const int c = sh.live[t] >> cs;         // window slot-cells c..c+2xm
      const int hi = sh.start[c + 2 * xm + 1];
      const float4 a = sh.si[t];
      float xi[DIM];
      unpack<DIM>(a, xi);
      if constexpr (FORCE) {
        float vi[DIM], fa[DIM];
        unpack<DIM>(sh.sv[t], vi);
        unpack<DIM>(sh.acc[t], fa);
        for (int q = sh.start[c]; q < hi;) {
          int n = 0;                 // list the next candidates within h
          for (; q < hi && n < kNear; ++q) {
            float xj[DIM];
            unpack<DIM>(sh.xa[q], xj);
            if (within_cut<DIM>(xi, xj, cut2))
              sh.near[n++ * kThreads + threadIdx.x] = (unsigned short)q;
          }
          for (int m = 0; m < n; ++m) {
            const int qn = sh.near[m * kThreads + threadIdx.x];
            const float4 xr = sh.xa[qn], vr = sh.vb[qn];
            float xj[DIM], vj[DIM];
            unpack<DIM>(xr, xj);
            unpack<DIM>(vr, vj);
            force_pair<DIM>(xi, vi, a.w, xj, vj, xr.w, vr.w, k, fa);
          }
        }
        sh.acc[t] = pack<DIM>(fa, 0.0f);
      } else {
        float acc = a.w;
        for (int q = sh.start[c]; q < hi; ++q) {
          float xj[DIM];
          unpack<DIM>(sh.xa[q], xj);
          density_pair<DIM>(xi, xj, h2, acc);
        }
        sh.si[t].w = acc;
      }
    }
  }
  for (int t = threadIdx.x; t < n_live; t += kThreads) {
    float* ol = o + sh.live[t];
    if constexpr (FORCE) {
      float fa[DIM];
      unpack<DIM>(sh.acc[t], fa);
#pragma unroll
      for (int c = 0; c < DIM; ++c) ol[(size_t)c * lanes] = fa[c];
#pragma unroll
      for (int c = DIM; c < kFout; ++c) ol[(size_t)c * lanes] = 0.0f;
    } else {
      const float rho = mc * sh.si[t].w;
      ol[0] = rho;
      ol[lanes] = eos_pressure(rho, eos);
    }
  }
}

// K1 or K2, one block per (128-lane group, row); a group with nothing to
// compute (see live_group) gets its zeros and nothing else.
template <int DIM, typename T, bool FORCE>
__global__ void __launch_bounds__(kThreads)
staged_kernel(const T* __restrict__ feat, const float* __restrict__ rp,
              const int* __restrict__ nbr_pos,
              const int* __restrict__ gcounts, const int* __restrict__ n_occ,
              float* __restrict__ out, int c_rows, int lanes, int n_groups,
              int cap, int xm, int n_r, float h2, float mc, Eos eos,
              ForceConst k, float cut2, Frame fr) {
  constexpr int C = FORCE ? kFout : 2;
  extern __shared__ float4 smem[];
  const int row = blockIdx.y, g = blockIdx.x;
  float* o = out + (size_t)row * C * lanes + g * kLane;
  if (!live_group(n_occ, gcounts, row, g, n_groups)) {
    for (int w = threadIdx.x; w < kLane; w += kThreads)
      write_zeros<C>(o + w, lanes);
    return;
  }
  staged_group<DIM, T, FORCE>(feat, rp, nbr_pos, o, c_rows, lanes, row, g,
                              cap, xm, n_r, h2, mc, eos, k, cut2, fr,
                              carve(smem, FORCE, window(cap, xm)));
}

// The squared distance beyond which K2's term is exactly +-0, for the fp32
// smoothing length h: any r2 >= cut2 has sqrt(r2) >= h (1 + 2^-16), so
// r2 * inv_r (inv_r = 1/sqrt(r2), each IEEE-rounded) exceeds h and t =
// max(h - r2 inv_r, 0) = 0, fused or not; then s = 0, coef_p and coef_v
// are +-0 times finite values, and so is the term.  Rounded up, in double.
inline float force_cut2(float h) {
  const double r = (double)h * (1.0 + 1.0 / 65536.0);
  return nextafterf((float)(r * r), 3.4e38f);
}

template <int DIM, typename T, bool SIMPLE>
void launch_density(const void* feat, const int* nb, const int* gc,
                    const int* no, float* rp, int c_rows, int lanes,
                    int n_groups, int cap, int xm, int n_r, float h2, float mc,
                    const Eos& eos, const Frame& fr, cudaStream_t st) {
  const dim3 grid(n_groups, c_rows);
  if constexpr (SIMPLE) {
    density_kernel_simple<DIM, T><<<grid, kLane, 0, st>>>(
        (const T*)feat, nb, gc, no, rp, c_rows, lanes, n_groups, cap, xm, n_r,
        h2, mc, eos, fr);
  } else {
    staged_kernel<DIM, T, false>
        <<<grid, kThreads, stage_bytes(false, cap, xm),
           st>>>(
            (const T*)feat, nullptr, nb, gc, no, rp, c_rows, lanes, n_groups,
            cap, xm, n_r, h2, mc, eos, ForceConst{}, 0.0f, fr);
  }
}

template <int DIM, typename T, bool SIMPLE>
void launch_force(const void* feat, const float* rp, const int* nb,
                  const int* gc, const int* no, float* f, int c_rows,
                  int lanes, int n_groups, int cap, int xm, int n_r,
                  const ForceConst& k, const Frame& fr, cudaStream_t st) {
  const dim3 grid(n_groups, c_rows);
  if constexpr (SIMPLE) {
    force_kernel_simple<DIM, T><<<grid, kLane, 0, st>>>(
        (const T*)feat, rp, nb, gc, no, f, c_rows, lanes, n_groups, cap, xm,
        n_r, k, fr);
  } else {
    staged_kernel<DIM, T, true>
        <<<grid, kThreads, stage_bytes(true, cap, xm),
           st>>>(
            (const T*)feat, rp, nb, gc, no, f, c_rows, lanes, n_groups, cap,
            xm, n_r, 0.0f, 0.0f, Eos{}, k, force_cut2(k.h), fr);
  }
}

template <bool SIMPLE>
int density_entry(const void* feat, const void* nbr_pos, const void* gcounts,
                  const void* n_occ, void* rp, int c_rows, int lanes,
                  int n_groups, int cap, int xm, int n_r, int dim, int bf16,
                  float h2, float mc, const Eos& eos, const Frame& fr,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* nb = (const int*)nbr_pos;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  float* out = (float*)rp;
  if (dim == 3 && bf16) {
    launch_density<3, unsigned short, SIMPLE>(feat, nb, gc, no, out, c_rows,
                                              lanes, n_groups, cap, xm, n_r,
                                              h2, mc, eos, fr, st);
  } else if (dim == 3) {
    launch_density<3, float, SIMPLE>(feat, nb, gc, no, out, c_rows, lanes,
                                     n_groups, cap, xm, n_r, h2, mc, eos, fr,
                                     st);
  } else if (bf16) {
    launch_density<2, unsigned short, SIMPLE>(feat, nb, gc, no, out, c_rows,
                                              lanes, n_groups, cap, xm, n_r,
                                              h2, mc, eos, fr, st);
  } else {
    launch_density<2, float, SIMPLE>(feat, nb, gc, no, out, c_rows, lanes,
                                     n_groups, cap, xm, n_r, h2, mc, eos, fr,
                                     st);
  }
  return (int)cudaGetLastError();
}

template <bool SIMPLE>
int force_entry(const void* feat, const void* rp, const void* nbr_pos,
                const void* gcounts, const void* n_occ, void* f, int c_rows,
                int lanes, int n_groups, int cap, int xm, int n_r, int dim,
                int bf16, const ForceConst& k, const Frame& fr, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rp;
  const int* nb = (const int*)nbr_pos;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  float* out = (float*)f;
  if (dim == 3 && bf16) {
    launch_force<3, unsigned short, SIMPLE>(feat, r, nb, gc, no, out, c_rows,
                                            lanes, n_groups, cap, xm, n_r, k,
                                            fr, st);
  } else if (dim == 3) {
    launch_force<3, float, SIMPLE>(feat, r, nb, gc, no, out, c_rows, lanes,
                                   n_groups, cap, xm, n_r, k, fr, st);
  } else if (bf16) {
    launch_force<2, unsigned short, SIMPLE>(feat, r, nb, gc, no, out, c_rows,
                                            lanes, n_groups, cap, xm, n_r, k,
                                            fr, st);
  } else {
    launch_force<2, float, SIMPLE>(feat, r, nb, gc, no, out, c_rows, lanes,
                                   n_groups, cap, xm, n_r, k, fr, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  `bf16` selects the bf16
// cell-relative features (then `cf`, `cfx` are the frame's offsets), `xm`
// the x margin in slot-cells.  Each returns cudaGetLastError() after its
// launch; the caller raises on a nonzero code.  Launches go to the caller's
// stream and do not synchronize.  slot_density / slot_force launch the
// staged kernels, the `_simple` entry points the simple ones (same
// arguments, same results bit for bit).

extern "C" int slot_density(const void* feat, const void* nbr_pos,
                            const void* gcounts, const void* n_occ, void* rp,
                            int c_rows, int lanes, int n_groups, int cap,
                            int xm, int n_r, int dim, int bf16, float h2,
                            float mc, int tait, int floor_p, float stiffness,
                            float rest, float b, float gamma, float cf,
                            float cfx, int device, void* stream) {
  return density_entry<false>(feat, nbr_pos, gcounts, n_occ, rp, c_rows,
                              lanes, n_groups, cap, xm, n_r, dim, bf16, h2,
                              mc, Eos{tait, floor_p, stiffness, rest, b, gamma},
                              Frame{cf, cfx}, device, stream);
}

extern "C" int slot_density_simple(const void* feat, const void* nbr_pos,
                                   const void* gcounts, const void* n_occ,
                                   void* rp, int c_rows, int lanes,
                                   int n_groups, int cap, int xm, int n_r,
                                   int dim, int bf16, float h2, float mc,
                                   int tait, int floor_p, float stiffness,
                                   float rest, float b, float gamma, float cf,
                                   float cfx, int device, void* stream) {
  return density_entry<true>(feat, nbr_pos, gcounts, n_occ, rp, c_rows, lanes,
                             n_groups, cap, xm, n_r, dim, bf16, h2, mc,
                             Eos{tait, floor_p, stiffness, rest, b, gamma},
                             Frame{cf, cfx}, device, stream);
}

extern "C" int slot_force(const void* feat, const void* rp,
                          const void* nbr_pos, const void* gcounts,
                          const void* n_occ, void* f, int c_rows, int lanes,
                          int n_groups, int cap, int xm, int n_r, int dim,
                          int bf16, float h, float c_s, float m_half,
                          float mu_m, float c_v, float cf, float cfx,
                          int device, void* stream) {
  return force_entry<false>(feat, rp, nbr_pos, gcounts, n_occ, f, c_rows,
                            lanes, n_groups, cap, xm, n_r, dim, bf16,
                            ForceConst{h, c_s, m_half, mu_m, c_v},
                            Frame{cf, cfx}, device, stream);
}

extern "C" int slot_force_simple(const void* feat, const void* rp,
                                 const void* nbr_pos, const void* gcounts,
                                 const void* n_occ, void* f, int c_rows,
                                 int lanes, int n_groups, int cap, int xm,
                                 int n_r, int dim, int bf16, float h,
                                 float c_s, float m_half, float mu_m,
                                 float c_v, float cf, float cfx, int device,
                                 void* stream) {
  return force_entry<true>(feat, rp, nbr_pos, gcounts, n_occ, f, c_rows,
                           lanes, n_groups, cap, xm, n_r, dim, bf16,
                           ForceConst{h, c_s, m_half, mu_m, c_v},
                           Frame{cf, cfx}, device, stream);
}

// Threads and dynamic shared memory of one staged block (K1: force = 0,
// K2: force = 1) at slot-cell capacity `cap` and x margin `xm`.
extern "C" int slot_stage_bytes(int force, int cap, int xm) {
  return (int)stage_bytes(force != 0, cap, xm);
}
