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
// All i-lanes of a row share the same candidates: every particle of the R
// neighbor rows, in the order neighbor row s, occupied block jg, lane.
// What bounds these kernels on this card is not bytes (x, or x|v|rho|p, of
// the occupied blocks read once, rho|p or f written once: ~1-3 us) nor the
// card's arithmetic rate, but the ordered sum of the heaviest rows: each
// i-lane adds its candidates' terms one after another, and at the settled
// emitter scene a particle has ~341 candidates on average (~24 of them in
// its +-1 cells, ~6.5 within h) but up to 1,099 (1,355 on the skinned
// lattice) in the densest rows.  The warp that holds such a row runs
// longest, alone for the last part of the launch (trace_packed.py measures
// it); ordering a row's lanes in x, so that a lane reads only its +-1-cell
// range, would cut that walk, but changes the order of the sums.
//
// The first design (kept as `simple_density_kernel` / `simple_force_kernel`,
// the yardstick the warp kernels are held to bitwise; no path runs it) gave
// one 128-thread block to each (128-lane block, row), ~4x the threads of the
// live lanes, ran K4's IEEE sqrt and division on all ~341 candidates, and
// put two block barriers around each neighbor block's ~29-candidate loop.
//
// The warp design (warp_density_kernel, warp_force_kernel):
//   1. One warp per unit, a (row, 32-lane chunk), several units a block, no
//      block barrier.  Units are numbered chunk-major (u = chunk * c_rows +
//      row), so the blocks of upper chunks, nearly all empty, finish at
//      once.  A row's live lanes are a prefix (packed rows take no repair),
//      so a unit is live when its chunk starts below its block's count and
//      its row is in 1..n_occ; a dead unit writes its zeros and exits.
//      Every unit writes its 32 lanes' outputs once, coalesced.
//   2. A live warp lists its candidates as one list: a warp-wide scan of
//      the neighbor blocks' counts gives each (s, jg) segment's start.  It
//      walks the list `tile` candidates at a time, whatever rows they come
//      from, staging each tile in its own slice of shared memory (K3: x;
//      K4: x | 1/max(rho_j, 1e-12) and v | p_j as float4 records, 1/rho
//      once per staged lane as the first design does; and the last
//      coordinate again), between two __syncwarp; with `prefetch` the next
//      tile's loads are issued before the current one is consumed.
//   3. The costly arithmetic runs only near i.  With `band`, each lane
//      first tests the last coordinate (the row's own axis) of 32 staged
//      candidates at once against hx, a little above h (band_cut), and
//      keeps the ones within as a bitmask; K3 adds the terms of those only.
//      K4 then computes r^2 (the operations of packed_force_pair) for the
//      kept ones, or without `band` for all, keeps those with r^2 <
//      force_cut2(h), and runs the IEEE sqrt/division arithmetic on those
//      only, in order.  Kept candidates are computed kBatch at a time, so
//      that their latencies overlap; the terms still add in order.
//   4. Bits.  Per i-lane the order stays s, jg, lane; no atomics, no
//      cross-lane sum; the pair arithmetic is one function
//      (packed_density_pair, packed_force_pair) that both designs call, so
//      nvcc contracts it alike.  A dropped term is exactly +-0: outside the
//      band r^2 >= cut2 > h^2; q = 0 for r^2 >= h^2 and t = 0 for r^2 >=
//      force_cut2, fused or not.  Padding records (past a tile's end, and
//      in a batch past the last kept candidate) sit at x = -1e18, where the
//      term is exactly +-0 too.  The sums start at +0, and adding +-0 to
//      them leaves their bits unchanged (tests/test_torch_skip.py holds
//      this on the host).  So the warp kernels give the yardstick's bits.
// The warps a block, the tile, `prefetch` and `band` are launch choices
// (the *_variant entry points); the defaults (kDensityDefault,
// kForceDefault) are the fastest of chip_smoke.py's sweep (PERF.md holds
// its numbers).
//
// Each kernel takes 1/r as 1.0f / sqrtf(r2) (IEEE-rounded sqrt and
// division; the build passes no --use_fast_math), not the approximate
// rsqrtf.

#include <cuda_runtime.h>

#include <cmath>

// Per-warp timeline of the warp kernels for sph_tpu_torch/trace_packed.py,
// compiled only into the library that tool builds with -DSPH_PACKED_TRACE:
// for unit u, trace[4u..4u+3] = start and end (%globaltimer, ns), SM, and
// the unit's candidates (-1 for a dead unit).  With only_row >= 0 every
// other row's units are dead, so one row's warps run alone.
#ifdef SPH_PACKED_TRACE
__device__ long long* g_trace;
__device__ int g_only_row = -1;

extern "C" int packed_trace(void* trace, int only_row) {
  cudaError_t err = cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_only_row, &only_row, sizeof(only_row));
  return (int)err;
}

__device__ __forceinline__ long long trace_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void trace_end(int u, long long t0, int n,
                                          int lane) {
  if (g_trace == nullptr || lane != 0) return;
  unsigned sm;
  asm("mov.u32 %0, %%smid;" : "=r"(sm));
  long long* t = g_trace + 4 * (size_t)u;
  t[0] = t0;
  t[1] = trace_clock();
  t[2] = sm;
  t[3] = n;
}
#define PACKED_TRACE_BEGIN const long long trace_t0 = trace_clock();
#define PACKED_TRACE_END(u, n) trace_end(u, trace_t0, n, lane);
#else
#define PACKED_TRACE_BEGIN
#define PACKED_TRACE_END(u, n)
#endif

namespace {

constexpr int kFeat = 8;
constexpr int kFout = 4;
constexpr int kLane = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;         // launch bound of the warp kernels
constexpr float kEmpty = 1e17f;      // empty lanes hold 1e18
// Stage padding: a record at x = -1e18 (1/rho, p, v 0) whose term is exactly
// +-0 for any i-lane, real (r^2 ~ 3e36) or empty (r^2 ~ 1.2e37): q = 0 and
// t = 0, as for an empty lane.
constexpr float kPad = -1e18f;
constexpr int kGroup = 8;            // candidates a warp kernel reads at once
// kept candidates a warp kernel computes at once, so that their latencies
// overlap (their terms still add in order)
constexpr int kBatch = 2;

struct Eos {
  int tait;          // 0: p = k (rho - rho0); 1: p = b ((rho/rho0)^gamma - 1)
  int floor_p;       // clamp p >= 0
  float stiffness;
  float rest;
  float b;
  float gamma;
};

struct ForceConst {
  float h, c_s, m_half, mu_m, c_v;
};

__device__ __forceinline__ float eos_pressure(float rho, const Eos& e) {
  float p = e.tait ? e.b * (powf(rho / e.rest, e.gamma) - 1.0f)
                   : e.stiffness * (rho - e.rest);
  return e.floor_p ? fmaxf(p, 0.0f) : p;
}

__device__ __forceinline__ float inv_rho(float rho) {
  return 1.0f / fmaxf(rho, 1e-12f);
}

// One candidate's term of K3's sum, added to acc.  Both designs call it, so
// nvcc contracts and rounds it alike in each.
template <int DIM>
__device__ __forceinline__ void packed_density_pair(const float (&xi)[DIM],
                                                    const float (&xj)[DIM],
                                                    float h2, float& acc) {
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

// One candidate's term of K4's sum: its factors, then their sum into fa.
template <int DIM>
struct ForceTerm {
  float dx[DIM], dv[DIM], coef_p, coef_v;
};

template <int DIM>
__device__ __forceinline__ ForceTerm<DIM> force_term(
    const float (&xi)[DIM], const float (&vi)[DIM], float p_i,
    const float (&xj)[DIM], const float (&vj)[DIM], float inv_rho_j,
    float p_j, const ForceConst& k) {
  ForceTerm<DIM> e;
  float r2 = 0.0f;
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    e.dx[c] = xi[c] - xj[c];
    r2 = c == 0 ? e.dx[0] * e.dx[0] : r2 + e.dx[c] * e.dx[c];
    e.dv[c] = vj[c] - vi[c];
  }
  const float inv_r = 1.0f / sqrtf(fmaxf(r2, 1e-24f));
  const float t = fmaxf(k.h - r2 * inv_r, 0.0f);
  const float s_r = r2 > 1e-24f ? k.c_s * t * t * inv_r : 0.0f;
  e.coef_p = k.m_half * (p_i + p_j) * inv_rho_j * s_r;
  e.coef_v = k.mu_m * inv_rho_j * (k.c_v * t);
  return e;
}

template <int DIM>
__device__ __forceinline__ void add_term(const ForceTerm<DIM>& e,
                                         float (&fa)[DIM]) {
#pragma unroll
  for (int c = 0; c < DIM; ++c)
    fa[c] += e.coef_p * e.dx[c] + e.coef_v * e.dv[c];
}

// One candidate's term of K4's sum, added to fa (inv_rho_j = inv_rho(rho_j)).
// Both designs build it from force_term and add_term, so nvcc contracts
// and rounds it alike in each.
template <int DIM>
__device__ __forceinline__ void packed_force_pair(
    const float (&xi)[DIM], const float (&vi)[DIM], float p_i,
    const float (&xj)[DIM], const float (&vj)[DIM], float inv_rho_j,
    float p_j, const ForceConst& k, float (&fa)[DIM]) {
  add_term(force_term<DIM>(xi, vi, p_i, xj, vj, inv_rho_j, p_j, k), fa);
}

// Below the cut, with r^2 as packed_force_pair computes it.  Written so
// that a NaN distance is kept, as the first design adds every term.
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

template <int C>
__device__ __forceinline__ void write_zeros(float* out, int lanes) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[(size_t)c * lanes] = 0.0f;
}

// ---------------------------------------------------------------------------
// The simple design (the first version of these kernels): one 128-thread
// block per (128-lane block, row), block-wide staging.  The yardstick of
// the warp kernels; no path runs it.
// ---------------------------------------------------------------------------

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
simple_density_kernel(const float* __restrict__ feat,
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
    write_zeros<2>(out, lanes);
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
        float xj[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c) xj[c] = xs[c][j];
        packed_density_pair<DIM>(xi, xj, h2, acc);
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
simple_force_kernel(const float* __restrict__ feat,
                    const float* __restrict__ rp,
                    const int* __restrict__ nbr_pos,
                    const int* __restrict__ jb,
                    const int* __restrict__ gcounts,
                    const int* __restrict__ n_occ, float* __restrict__ f,
                    int c_rows, int lanes, int n_groups, int n_r,
                    ForceConst k) {
  __shared__ float xs[DIM][kLane];
  __shared__ float vs[DIM][kLane];
  __shared__ float inv_rho_s[kLane];
  __shared__ float p_s[kLane];
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kLane + tid;
  float* out = f + (size_t)row * kFout * lanes + lane;
  if (!live_block(n_occ, gcounts, row, blockIdx.x, n_groups)) {
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
        inv_rho_s[tid] = inv_rho(rpj[lj]);
        p_s[tid] = rpj[lanes + lj];
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        float xj[DIM], vj[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          xj[c] = xs[c][j];
          vj[c] = vs[c][j];
        }
        packed_force_pair<DIM>(xi, vi, p_i, xj, vj, inv_rho_s[j], p_s[j], k,
                               fa);
      }
    }
  }
  const bool real = xi[0] < kEmpty;
#pragma unroll
  for (int c = 0; c < DIM; ++c) out[(size_t)c * lanes] = real ? fa[c] : 0.0f;
#pragma unroll
  for (int c = DIM; c < kFout; ++c) out[(size_t)c * lanes] = 0.0f;
}

// ---------------------------------------------------------------------------
// The warp design
// ---------------------------------------------------------------------------

// One warp's unit: row, 32-lane chunk, and whether it has lanes to compute.
struct Unit {
  int row, chunk;
  bool live;
};

// Unit u, chunk-major: u = chunk * c_rows + row.  Warp-uniform.
__device__ __forceinline__ Unit unit_of(int u, int c_rows, int n_groups,
                                        const int* __restrict__ n_occ,
                                        const int* __restrict__ gcounts) {
  Unit w;
  w.chunk = u / c_rows;
  w.row = u - w.chunk * c_rows;
  const int per_block = kLane / kWarp;
  w.live = w.row != 0 && w.row <= __ldg(n_occ)
           && __ldg(gcounts + w.row * n_groups + w.chunk / per_block)
                  > (w.chunk % per_block) * kWarp;
#ifdef SPH_PACKED_TRACE
  w.live = w.live && (g_only_row < 0 || w.row == g_only_row);
#endif
  return w;
}

// n rounded up to whole groups.
__device__ __forceinline__ int padded(int n) {
  return (n + kGroup - 1) / kGroup * kGroup;
}

// A unit's candidates are the particles of its neighbor rows' occupied
// blocks, concatenated in the order neighbor row s, block jg, lane: the
// segment k = (s, jg) = (k / n_groups, k % n_groups) holds the cnt_k
// particles of block jg of neighbor row s (0 past the row's occupied
// blocks), from index start[k] of the list.  The warp lists its segments
// in its slice of shared memory: start[k] (and start[n_seg] = the total),
// the compacted row nrow[k], and off[k] = jg * 128 - start[k], so that list
// index g of segment k is lane off[k] + g of row nrow[k].
struct Segments {
  int* start;   // [n_seg + 1]
  int* nrow;    // [n_seg]
  int* off;     // [n_seg]
  int n_seg;
};

__host__ __device__ inline int n_segments(int n_r, int n_groups) {
  return n_r * n_groups;
}

// A warp's slice of shared memory: the stage, TILE records and one padding
// record (slot TILE) of x | 1/rho (K3: x) and, for K4, of v | p; the last
// coordinate of each staged candidate again, for the band test; then the
// segment lists.
struct Stage {
  float4* xs;   // [TILE + 1]
  float4* vs;   // [TILE + 1] K4 only
  float* xl;    // [TILE]
  Segments sg;
};

__host__ __device__ inline size_t stage_floats(bool force, int tile) {
  return 4 * (size_t)(force ? 2 : 1) * (tile + 1) + tile;
}

// Bytes of one warp's slice, rounded to 16.
__host__ __device__ inline size_t warp_bytes(bool force, int tile, int n_seg) {
  const size_t b = sizeof(float) * stage_floats(force, tile) +
                   sizeof(int) * (3 * (size_t)n_seg + 1);
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ Stage carve(char* slice, bool force, int tile,
                                       int n_seg) {
  Stage st;
  st.xs = reinterpret_cast<float4*>(slice);
  st.vs = force ? st.xs + tile + 1 : nullptr;
  st.xl = reinterpret_cast<float*>(st.xs + (force ? 2 : 1) * (tile + 1));
  st.sg.start = reinterpret_cast<int*>(st.xl + tile);
  st.sg.nrow = st.sg.start + n_seg + 1;
  st.sg.off = st.sg.nrow + n_seg;
  st.sg.n_seg = n_seg;
  return st;
}

// A padding record at stage slot q.
__device__ __forceinline__ void pad_record(const Stage& st, int q) {
  st.xs[q] = make_float4(kPad, kPad, kPad, 0.0f);
  if (st.vs) st.vs[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Lists the unit's segments (a warp-wide scan of their counts) and returns
// the number of candidates.  Ends with the lists visible to the warp.
__device__ __forceinline__ int list_segments(const int* __restrict__ nbr_pos,
                                             const int* __restrict__ jb,
                                             const int* __restrict__ gcounts,
                                             int row, int c_rows,
                                             int n_groups, int lane,
                                             const Segments& sg) {
  int carry = 0;
  for (int k0 = 0; k0 < sg.n_seg; k0 += kWarp) {
    const int k = k0 + lane;
    int cnt = 0, nr = 0, jg = 0;
    if (k < sg.n_seg) {
      jg = k % n_groups;
      nr = __ldg(nbr_pos + (k / n_groups) * c_rows + row);
      if (jg < __ldg(jb + nr)) cnt = __ldg(gcounts + nr * n_groups + jg);
    }
    int incl = cnt;                          // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < kWarp; d *= 2) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (k < sg.n_seg) {
      const int first = carry + incl - cnt;
      sg.start[k] = first;
      sg.nrow[k] = nr;
      sg.off[k] = jg * kLane - first;
    }
    carry += __shfl_sync(kFull, incl, kWarp - 1);
  }
  if (lane == 0) sg.start[sg.n_seg] = carry;
  __syncwarp();
  return carry;
}

// A lane's share of one tile, list indices g0 + lane + 32 m for m < TILE /
// 32, in registers (K3: x; K4: x | rho and v | p).
template <int DIM, int TILE, bool FORCE>
struct Fetch {
  float x[TILE / kWarp][DIM];
  float v[FORCE ? TILE / kWarp : 1][DIM];
  float rho[FORCE ? TILE / kWarp : 1];
  float p[FORCE ? TILE / kWarp : 1];

  // Loads list indices [g0, g0 + n).  seg[m] is the segment of slot m's
  // last index: the indices only grow, so each moves forward from there.
  __device__ __forceinline__ void load(const float* __restrict__ feat,
                                       const float* __restrict__ rp,
                                       const Segments& sg,
                                       int (&seg)[TILE / kWarp],
                                       int g0, int n, int lanes, int lane) {
#pragma unroll
    for (int m = 0; m < TILE / kWarp; ++m) {
      const int g = g0 + lane + m * kWarp;
      if (g >= g0 + n) break;
      while (sg.start[seg[m] + 1] <= g) ++seg[m];
      const int nr = sg.nrow[seg[m]], lj = sg.off[seg[m]] + g;
      const float* fj = feat + (size_t)nr * kFeat * lanes;
#pragma unroll
      for (int c = 0; c < DIM; ++c)
        x[m][c] = __ldg(fj + (size_t)c * lanes + lj);
      if constexpr (FORCE) {
        const float* rpj = rp + (size_t)nr * 2 * lanes;
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          v[m][c] = __ldg(fj + (size_t)(3 + c) * lanes + lj);
        rho[m] = __ldg(rpj + lj);
        p[m] = __ldg(rpj + lanes + lj);
      }
    }
  }

  // Into the warp's stage: K3 xs[q] = x; K4 xs[q] = x | 1/max(rho, 1e-12),
  // vs[q] = v | p; xl[q] = the last coordinate; padding records from n up
  // to a whole group.
  __device__ __forceinline__ void store(const Stage& st, int n,
                                        int lane) const {
    const int n_pad = padded(n);
#pragma unroll
    for (int m = 0; m < TILE / kWarp; ++m) {
      const int q = lane + m * kWarp;
      if (q >= n_pad) break;
      if (q >= n) {
        pad_record(st, q);
        st.xl[q] = kPad;
        continue;
      }
      if constexpr (FORCE) {
        st.xs[q] = pack<DIM>(x[m], inv_rho(rho[m]));
        st.vs[q] = pack<DIM>(v[m], p[m]);
      } else {
        st.xs[q] = pack<DIM>(x[m], 0.0f);
      }
      st.xl[q] = x[m][DIM - 1];
    }
  }
};

// Calls f(j, xs[j]) for j in [j0, j0 + len), in order (len a multiple of
// kGroup), reading each group of records while the one before is used.
template <typename F>
__device__ __forceinline__ void for_each_record(const float4* xs, int j0,
                                                int len, F&& f) {
  float4 cur[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) cur[q] = xs[j0 + q];
  for (int j = j0; j < j0 + len; j += kGroup) {
    float4 nxt[kGroup];
    const int jn = j + kGroup < j0 + len ? j + kGroup : j0;  // read in range
#pragma unroll
    for (int q = 0; q < kGroup; ++q) nxt[q] = xs[jn + q];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) f(j + q, cur[q]);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) cur[q] = nxt[q];
  }
}

// Walks a unit's candidate list `total` long, TILE at a time, in order:
// stages each tile into the warp's stage, padded to whole groups, and
// calls consume(n) on it with n the padded size.  With PREFETCH the next
// tile's loads are issued before the current one is consumed.
template <int DIM, int TILE, bool FORCE, bool PREFETCH, typename Consume>
__device__ __forceinline__ void for_each_tile(
    const float* __restrict__ feat, const float* __restrict__ rp,
    const Stage& st, int total, int lanes, int lane, Consume&& consume) {
  Fetch<DIM, TILE, FORCE> r;
  int seg[TILE / kWarp] = {};                // each slot's segment
  if (PREFETCH && total > 0)
    r.load(feat, rp, st.sg, seg, 0, min(TILE, total), lanes, lane);
  for (int g0 = 0; g0 < total; g0 += TILE) {
    const int n = min(TILE, total - g0);
    if (!PREFETCH) r.load(feat, rp, st.sg, seg, g0, n, lanes, lane);
    __syncwarp();                            // the last tile is consumed
    r.store(st, n, lane);
    __syncwarp();
    if (PREFETCH && g0 + TILE < total)
      r.load(feat, rp, st.sg, seg, g0 + TILE, min(TILE, total - g0 - TILE),
             lanes, lane);
    consume(padded(n));
  }
}

// The candidates j of a 32-record run (xl: their last coordinate, 16-byte
// aligned; the first `len` are real or padding) whose last coordinate lies
// within hx of x, as bits: a candidate outside (|x - x_j| >= hx, hx above h
// by a margin, see band_cut) has r^2 >= cut2 > h^2, so its term is exactly
// +-0 in K3 and K4.  Written so that a NaN distance is kept.
__device__ __forceinline__ unsigned band_mask(const float* xl, float x,
                                              float hx, int len) {
  unsigned kept = 0;
#pragma unroll
  for (int q = 0; q < kWarp; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(xl + q);
    if (!(fabsf(x - v.x) >= hx)) kept |= 1u << q;
    if (!(fabsf(x - v.y) >= hx)) kept |= 2u << q;
    if (!(fabsf(x - v.z) >= hx)) kept |= 4u << q;
    if (!(fabsf(x - v.w) >= hx)) kept |= 8u << q;
  }
  return len >= kWarp ? kept : kept & ((1u << len) - 1u);
}

// Pops the lowest kBatch set bits of `bits` as record slots of the run at
// j0, in order (the padding record, slot `pad`, for those past the last).
__device__ __forceinline__ void pop_batch(unsigned& bits, int j0, int pad,
                                          int (&q)[kBatch]) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    q[i] = bits ? j0 + __ffs(bits) - 1 : pad;
    bits &= bits - 1;
  }
}

template <int DIM, int TILE, bool BAND, bool PREFETCH>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
warp_density_kernel(const float* __restrict__ feat,
                    const int* __restrict__ nbr_pos,
                    const int* __restrict__ jb,
                    const int* __restrict__ gcounts,
                    const int* __restrict__ n_occ, float* __restrict__ rp,
                    int c_rows, int lanes, int n_groups, int n_r, float h2,
                    float hx, float mc, Eos eos) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int u = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (u >= c_rows * (lanes / kWarp)) return;
  PACKED_TRACE_BEGIN
  const Unit w = unit_of(u, c_rows, n_groups, n_occ, gcounts);
  const int l = w.chunk * kWarp + lane;
  float* out = rp + (size_t)w.row * 2 * lanes + l;
  if (!w.live) {
    write_zeros<2>(out, lanes);
    PACKED_TRACE_END(u, -1)
    return;
  }
  const float* fi = feat + (size_t)w.row * kFeat * lanes + l;
  float xi[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) xi[c] = fi[(size_t)c * lanes];
  const int n_seg = n_segments(n_r, n_groups);
  const Stage st = carve(reinterpret_cast<char*>(smem) +
                             warp * warp_bytes(false, TILE, n_seg),
                         false, TILE, n_seg);
  if (lane == 0) pad_record(st, TILE);
  const int total = list_segments(nbr_pos, jb, gcounts, w.row, c_rows,
                                  n_groups, lane, st.sg);
  float acc = 0.0f;
  for_each_tile<DIM, TILE, false, PREFETCH>(
      feat, nullptr, st, total, lanes, lane, [&](int n) {
        if constexpr (BAND) {
          // the candidates within the band, two at a time, in order
#pragma unroll
          for (int m = 0; m < TILE / kWarp; ++m) {
            const int len = min(n - m * kWarp, kWarp);
            if (len <= 0) break;
            unsigned kept = band_mask(st.xl + m * kWarp, xi[DIM - 1], hx, len);
            while (kept) {
              int q[kBatch];
              pop_batch(kept, m * kWarp, TILE, q);
              float xj[kBatch][DIM];
#pragma unroll
              for (int i = 0; i < kBatch; ++i) unpack<DIM>(st.xs[q[i]], xj[i]);
#pragma unroll
              for (int i = 0; i < kBatch; ++i)
                packed_density_pair<DIM>(xi, xj[i], h2, acc);
            }
          }
        } else {
          for_each_record(st.xs, 0, n, [&](int, const float4& rec) {
            float xj[DIM];
            unpack<DIM>(rec, xj);
            packed_density_pair<DIM>(xi, xj, h2, acc);
          });
        }
      });
  const bool real = xi[0] < kEmpty;
  const float rho = mc * acc;
  out[0] = real ? rho : 0.0f;
  out[lanes] = real ? eos_pressure(rho, eos) : 0.0f;
  PACKED_TRACE_END(u, total)
}

template <int DIM, int TILE, bool BAND, bool PREFETCH>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
warp_force_kernel(const float* __restrict__ feat, const float* __restrict__ rp,
                  const int* __restrict__ nbr_pos, const int* __restrict__ jb,
                  const int* __restrict__ gcounts,
                  const int* __restrict__ n_occ, float* __restrict__ f,
                  int c_rows, int lanes, int n_groups, int n_r, ForceConst k,
                  float cut2, float hx) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int u = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (u >= c_rows * (lanes / kWarp)) return;
  PACKED_TRACE_BEGIN
  const Unit w = unit_of(u, c_rows, n_groups, n_occ, gcounts);
  const int l = w.chunk * kWarp + lane;
  float* out = f + (size_t)w.row * kFout * lanes + l;
  if (!w.live) {
    write_zeros<kFout>(out, lanes);
    PACKED_TRACE_END(u, -1)
    return;
  }
  const float* fi = feat + (size_t)w.row * kFeat * lanes + l;
  float xi[DIM], vi[DIM], fa[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    xi[c] = fi[(size_t)c * lanes];
    vi[c] = fi[(size_t)(3 + c) * lanes];
    fa[c] = 0.0f;
  }
  const float p_i = rp[(size_t)w.row * 2 * lanes + lanes + l];
  const int n_seg = n_segments(n_r, n_groups);
  const Stage st = carve(reinterpret_cast<char*>(smem) +
                             warp * warp_bytes(true, TILE, n_seg),
                         true, TILE, n_seg);
  if (lane == 0) pad_record(st, TILE);
  const int total = list_segments(nbr_pos, jb, gcounts, w.row, c_rows,
                                  n_groups, lane, st.sg);
  for_each_tile<DIM, TILE, true, PREFETCH>(
      feat, rp, st, total, lanes, lane, [&](int n) {
#pragma unroll
        for (int m = 0; m < TILE / kWarp; ++m) {
          const int j0 = m * kWarp;
          const int len = min(n - j0, kWarp);
          if (len <= 0) break;
          unsigned near = 0;                 // this lane's kept candidates
          auto keep = [&](int j, const float4& rec) {
            float xj[DIM];
            unpack<DIM>(rec, xj);
            if (within_cut<DIM>(xi, xj, cut2)) near |= 1u << (j - j0);
          };
          if constexpr (BAND) {
            for (unsigned b = band_mask(st.xl + j0, xi[DIM - 1], hx, len); b;
                 b &= b - 1) {
              const int j = j0 + __ffs(b) - 1;
              keep(j, st.xs[j]);
            }
          } else {
            for_each_record(st.xs, j0, len, keep);
          }
          // kBatch at a time, in the tile's order, so that their sqrt and
          // division overlap; past the last, the padding record, whose term
          // is exactly +-0.
          while (near) {
            int q[kBatch];
            pop_batch(near, j0, TILE, q);
            ForceTerm<DIM> e[kBatch];
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
              const float4 xr = st.xs[q[i]], vr = st.vs[q[i]];
              float xj[DIM], vj[DIM];
              unpack<DIM>(xr, xj);
              unpack<DIM>(vr, vj);
              e[i] = force_term<DIM>(xi, vi, p_i, xj, vj, xr.w, vr.w, k);
            }
#pragma unroll
            for (int i = 0; i < kBatch; ++i) add_term(e[i], fa);
          }
        }
      });
  const bool real = xi[0] < kEmpty;
#pragma unroll
  for (int c = 0; c < DIM; ++c) out[(size_t)c * lanes] = real ? fa[c] : 0.0f;
#pragma unroll
  for (int c = DIM; c < kFout; ++c) out[(size_t)c * lanes] = 0.0f;
  PACKED_TRACE_END(u, total)
}

// The squared distance beyond which K4's term is exactly +-0, for the fp32
// smoothing length h (a copy of force_cut2 in csrc/slot_kernels.cu, so this
// file builds alone): any r2 >= cut2 has sqrt(r2) >= h (1 + 2^-16), so r2 *
// inv_r (inv_r = 1/sqrt(r2), each IEEE-rounded) exceeds h and t = max(h -
// r2 inv_r, 0) = 0, fused or not; then s = 0, coef_p and coef_v are +-0
// times finite values, and so is the term.  Rounded up, in double.
inline float force_cut2(float h) {
  const double r = (double)h * (1.0 + 1.0 / 65536.0);
  return nextafterf((float)(r * r), 3.4e38f);
}

// The band half-width for a cut at distance `len` (K3: sqrt(h2), K4: h):
// any |d| >= hx has d^2 >= len^2 (1 + 2^-12), so fl(d^2), and with it the
// r^2 that adds the other coordinates' squares to it, is at least h2 (K3)
// or cut2 (K4).  Rounded up, in double.
inline float band_cut(double len) {
  return nextafterf((float)(len * (1.0 + 1.0 / 8192.0)), 3.4e38f);
}

// A warp kernel's launch choices.
struct Config {
  int warps, tile, prefetch, band;
};

// The launch choices packed_density and packed_force use: the fastest of
// chip_smoke.py's sweep at emitters3d@settled (PERF.md holds its numbers).
constexpr Config kDensityDefault{4, 128, 1, 1};
constexpr Config kForceDefault{4, 64, 0, 1};

constexpr size_t kMaxShared = 48 * 1024;  // without an opt-in attribute

bool valid(const Config& c, bool force, int n_r, int n_groups) {
  return c.warps >= 1 && c.warps <= kMaxWarps &&
         (c.tile == 32 || c.tile == 64 || c.tile == 128) &&
         c.warps * warp_bytes(force, c.tile, n_segments(n_r, n_groups))
             <= kMaxShared;
}

dim3 warp_grid(int c_rows, int lanes, int warps) {
  const int units = c_rows * (lanes / kWarp);
  return dim3((units + warps - 1) / warps);
}

size_t warp_shared(bool force, int tile, int warps, int n_r, int n_groups) {
  return warps * warp_bytes(force, tile, n_segments(n_r, n_groups));
}

template <int DIM, int TILE, bool BAND, bool PREFETCH>
void launch_warp_density(const float* fe, const int* nb, const int* bl,
                         const int* gc, const int* no, float* rp, int c_rows,
                         int lanes, int n_groups, int n_r, float h2, float mc,
                         const Eos& eos, int warps, cudaStream_t st) {
  warp_density_kernel<DIM, TILE, BAND, PREFETCH>
      <<<warp_grid(c_rows, lanes, warps), warps * kWarp,
         warp_shared(false, TILE, warps, n_r, n_groups), st>>>(
          fe, nb, bl, gc, no, rp, c_rows, lanes, n_groups, n_r, h2,
          band_cut(std::sqrt((double)h2)), mc, eos);
}

template <int DIM, int TILE, bool BAND, bool PREFETCH>
void launch_warp_force(const float* fe, const float* r, const int* nb,
                       const int* bl, const int* gc, const int* no, float* f,
                       int c_rows, int lanes, int n_groups, int n_r,
                       const ForceConst& k, int warps, cudaStream_t st) {
  warp_force_kernel<DIM, TILE, BAND, PREFETCH>
      <<<warp_grid(c_rows, lanes, warps), warps * kWarp,
         warp_shared(true, TILE, warps, n_r, n_groups), st>>>(
          fe, r, nb, bl, gc, no, f, c_rows, lanes, n_groups, n_r, k,
          force_cut2(k.h), band_cut(k.h));
}

// The launch choices each build holds: tile 32, 64 or 128, band, prefetch.
#define SPH_WARP_CHOICES(X) \
  X(32, false, false) X(32, false, true) X(32, true, false) X(32, true, true) \
  X(64, false, false) X(64, false, true) X(64, true, false) X(64, true, true) \
  X(128, false, false) X(128, false, true) X(128, true, false)               \
  X(128, true, true)

template <int DIM>
void density_dim(const Config& cf, bool simple, const float* fe,
                 const int* nb, const int* bl, const int* gc, const int* no,
                 float* rp, int c_rows, int lanes, int n_groups, int n_r,
                 float h2, float mc, const Eos& eos, cudaStream_t st) {
  if (simple) {
    simple_density_kernel<DIM><<<dim3(n_groups, c_rows), kLane, 0, st>>>(
        fe, nb, bl, gc, no, rp, c_rows, lanes, n_groups, n_r, h2, mc, eos);
    return;
  }
#define SPH_WARP_DENSITY(T, B, P)                                          \
  if (cf.tile == T && (cf.band != 0) == B && (cf.prefetch != 0) == P) {    \
    launch_warp_density<DIM, T, B, P>(fe, nb, bl, gc, no, rp, c_rows,      \
                                      lanes, n_groups, n_r, h2, mc, eos,   \
                                      cf.warps, st);                       \
    return;                                                                \
  }
  SPH_WARP_CHOICES(SPH_WARP_DENSITY)
#undef SPH_WARP_DENSITY
}

template <int DIM>
void force_dim(const Config& cf, bool simple, const float* fe, const float* r,
               const int* nb, const int* bl, const int* gc, const int* no,
               float* f, int c_rows, int lanes, int n_groups, int n_r,
               const ForceConst& k, cudaStream_t st) {
  if (simple) {
    simple_force_kernel<DIM><<<dim3(n_groups, c_rows), kLane, 0, st>>>(
        fe, r, nb, bl, gc, no, f, c_rows, lanes, n_groups, n_r, k);
    return;
  }
#define SPH_WARP_FORCE(T, B, P)                                            \
  if (cf.tile == T && (cf.band != 0) == B && (cf.prefetch != 0) == P) {    \
    launch_warp_force<DIM, T, B, P>(fe, r, nb, bl, gc, no, f, c_rows,      \
                                    lanes, n_groups, n_r, k, cf.warps,     \
                                    st);                                   \
    return;                                                                \
  }
  SPH_WARP_CHOICES(SPH_WARP_FORCE)
#undef SPH_WARP_FORCE
}

int density_entry(const Config& cf, bool simple, const void* feat,
                  const void* nbr_pos, const void* jb, const void* gcounts,
                  const void* n_occ, void* rp, int c_rows, int lanes,
                  int n_groups, int n_r, int dim, float h2, float mc,
                  const Eos& eos, int device, void* stream) {
  if (!simple && !valid(cf, false, n_r, n_groups))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* fe = (const float*)feat;
  const int* nb = (const int*)nbr_pos;
  const int* bl = (const int*)jb;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  if (dim == 3) {
    density_dim<3>(cf, simple, fe, nb, bl, gc, no, (float*)rp, c_rows, lanes,
                   n_groups, n_r, h2, mc, eos, st);
  } else {
    density_dim<2>(cf, simple, fe, nb, bl, gc, no, (float*)rp, c_rows, lanes,
                   n_groups, n_r, h2, mc, eos, st);
  }
  return (int)cudaGetLastError();
}

int force_entry(const Config& cf, bool simple, const void* feat,
                const void* rp, const void* nbr_pos, const void* jb,
                const void* gcounts, const void* n_occ, void* f, int c_rows,
                int lanes, int n_groups, int n_r, int dim,
                const ForceConst& k, int device, void* stream) {
  if (!simple && !valid(cf, true, n_r, n_groups))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* fe = (const float*)feat;
  const float* r = (const float*)rp;
  const int* nb = (const int*)nbr_pos;
  const int* bl = (const int*)jb;
  const int* gc = (const int*)gcounts;
  const int* no = (const int*)n_occ;
  if (dim == 3) {
    force_dim<3>(cf, simple, fe, r, nb, bl, gc, no, (float*)f, c_rows, lanes,
                 n_groups, n_r, k, st);
  } else {
    force_dim<2>(cf, simple, fe, r, nb, bl, gc, no, (float*)f, c_rows, lanes,
                 n_groups, n_r, k, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for launch choices it does not
// take, or whose shared memory passes 48 KB); the caller raises on a
// nonzero code.  Launches go to the
// caller's stream and do not synchronize.  packed_density / packed_force
// launch the warp kernels with the default choices, the `_variant` entry
// points with the given ones (warps a block 1-8, tile 32, 64 or 128,
// prefetch, band), the `_simple` ones the first design; every one gives
// the same results bit for bit.

extern "C" int packed_density(const void* feat, const void* nbr_pos,
                              const void* jb, const void* gcounts,
                              const void* n_occ, void* rp, int c_rows,
                              int lanes, int n_groups, int n_r, int dim,
                              float h2, float mc, int tait, int floor_p,
                              float stiffness, float rest, float b,
                              float gamma, int device, void* stream) {
  return density_entry(kDensityDefault, false, feat, nbr_pos, jb, gcounts,
                       n_occ, rp, c_rows, lanes, n_groups, n_r, dim, h2, mc,
                       Eos{tait, floor_p, stiffness, rest, b, gamma}, device,
                       stream);
}

extern "C" int packed_density_simple(const void* feat, const void* nbr_pos,
                                     const void* jb, const void* gcounts,
                                     const void* n_occ, void* rp, int c_rows,
                                     int lanes, int n_groups, int n_r,
                                     int dim, float h2, float mc, int tait,
                                     int floor_p, float stiffness, float rest,
                                     float b, float gamma, int device,
                                     void* stream) {
  return density_entry(Config{}, true, feat, nbr_pos, jb, gcounts,
                       n_occ, rp, c_rows, lanes, n_groups, n_r, dim, h2, mc,
                       Eos{tait, floor_p, stiffness, rest, b, gamma}, device,
                       stream);
}

extern "C" int packed_density_variant(
    const void* feat, const void* nbr_pos, const void* jb,
    const void* gcounts, const void* n_occ, void* rp, int c_rows, int lanes,
    int n_groups, int n_r, int dim, float h2, float mc, int tait, int floor_p,
    float stiffness, float rest, float b, float gamma, int warps, int tile,
    int prefetch, int band, int device, void* stream) {
  return density_entry(Config{warps, tile, prefetch, band}, false, feat,
                       nbr_pos, jb, gcounts, n_occ, rp, c_rows, lanes,
                       n_groups, n_r, dim, h2, mc,
                       Eos{tait, floor_p, stiffness, rest, b, gamma}, device,
                       stream);
}

extern "C" int packed_force(const void* feat, const void* rp,
                            const void* nbr_pos, const void* jb,
                            const void* gcounts, const void* n_occ, void* f,
                            int c_rows, int lanes, int n_groups, int n_r,
                            int dim, float h, float c_s, float m_half,
                            float mu_m, float c_v, int device, void* stream) {
  return force_entry(kForceDefault, false, feat, rp, nbr_pos, jb, gcounts,
                     n_occ, f, c_rows, lanes, n_groups, n_r, dim,
                     ForceConst{h, c_s, m_half, mu_m, c_v}, device, stream);
}

extern "C" int packed_force_simple(const void* feat, const void* rp,
                                   const void* nbr_pos, const void* jb,
                                   const void* gcounts, const void* n_occ,
                                   void* f, int c_rows, int lanes,
                                   int n_groups, int n_r, int dim, float h,
                                   float c_s, float m_half, float mu_m,
                                   float c_v, int device, void* stream) {
  return force_entry(Config{}, true, feat, rp, nbr_pos, jb, gcounts,
                     n_occ, f, c_rows, lanes, n_groups, n_r, dim,
                     ForceConst{h, c_s, m_half, mu_m, c_v}, device, stream);
}

extern "C" int packed_force_variant(
    const void* feat, const void* rp, const void* nbr_pos, const void* jb,
    const void* gcounts, const void* n_occ, void* f, int c_rows, int lanes,
    int n_groups, int n_r, int dim, float h, float c_s, float m_half,
    float mu_m, float c_v, int warps, int tile, int prefetch, int band,
    int device, void* stream) {
  return force_entry(Config{warps, tile, prefetch, band}, false, feat, rp,
                     nbr_pos, jb, gcounts, n_occ, f, c_rows, lanes, n_groups,
                     n_r, dim, ForceConst{h, c_s, m_half, mu_m, c_v}, device,
                     stream);
}

// The default launch choices, K3's then K4's: warps a block, tile,
// prefetch, band.
extern "C" int packed_defaults(int* out) {
  int i = 0;
  for (const Config& c : {kDensityDefault, kForceDefault}) {
    out[i++] = c.warps;
    out[i++] = c.tile;
    out[i++] = c.prefetch;
    out[i++] = c.band;
  }
  return 0;
}
