// The minority slot repair of the resident auto-rebuild advance for Hopper
// (sm_90a): its plan and its re-homing.
//
// They replace no Pallas kernel.  The reference plans and applies the
// repair inside its resident scan (sph_tpu/step.py, `make_repair_tools`),
// where XLA fuses the arithmetic; the port ran the same sequence as some 200
// separate PyTorch operations an attempt, a few over all 1.08M particles or
// all 7.87M slots, each launched by the host while the card waited between
// two blocks.  sph_tpu_torch/repair.py keeps that sequence as the plain
// versions (`make_repair_tools_plain`); these kernels compute the same keys
// and write the same arrays, bit for bit, in five launches:
//
//   repair_particles   over the particles: gather x and v from their slots,
//                      speed, projected move, drift from the anchor, the
//                      anchor's build cell and the margin to its faces, the
//                      risky predicate; each block's risky count and its
//                      risky particles in ascending order
//   repair_movers      over the K = repair_k movers: the first K risky
//                      particles in ascending order (the padded
//                      nonzero(size=K, fill_value=N) of the reference), then
//                      each mover's x, old slot, target cell and row
//   repair_lanes       a warp a mover: its rank among the earlier movers into
//                      the same cell, the cell's free lanes once the movers
//                      left their old slots, its new lane; `can`
//   repair_copy        the new addressing's pos, row_pos and gcounts and the
//                      new anchors, copied from the old ones
//   repair_patch       one block: every array's old slots of the movers get
//                      the empty values, then (after a barrier) their new
//                      slots the movers' values; the new addressing and the
//                      anchors are patched at the movers' particles and
//                      gcounts counted with integer atomics
//
// Bits.  The plan's predicate must give PyTorch's own bits on the card,
// since it decides which particles move.  As in slot_pass_kernels.cu each
// product and sum is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// which nvcc never contracts), in PyTorch's order: lo + ci * cell, and
// x - lo_c and (lo_c + cell) - x.  The binning divides truly (__fdiv_rn),
// as `neighbors.cell_index` divides by a device scalar.  The plain version
// sums the squares of a particle's [N, D] row, contiguous along D, with
// torch.sum(dim=1); PyTorch's reduction splits a row of three over two
// threads (Reduce.cuh: the block width is the largest power of two not
// above the row), the first adding elements 0 and 2, the second element 1,
// so the sum is (a + c) + b.  The empty-slot test is x < fp32(1e17).
//
// Slabs.  The slab fast path (decomp.py) repairs on its slab-local lattice:
// the bins are shifted by the lattice's integer index offset before they
// are clipped (`cell_index`'s ci_offset), the anchor's build cell is its
// global bin, and the distance to the slab's nearer interior face joins the
// margin.  A risky particle whose anchor lies in a band, where a neighbor
// holds a ghost copy the local repair cannot patch, vetoes the repair: the
// particle pass counts it per block, and repair_movers folds the vetoes into
// the flag that `can` reads.  On the single-device lattice the offset is 0
// and there are no faces.
//
// Where they work, and what bounds them.  The particle pass reads a
// particle's slot position (row, lane, valid), its movable flag, its anchor
// and its x and v in the slots: 46 B a particle in 3D (54 MB at 1.08M
// particles, ~16 us at 3.35 TB/s); its slot reads follow the particles'
// order, which the slot rows mostly follow too.  Everything after it works
// on the K movers (2048 in production) and the cells they go to, far below
// a microsecond of bytes; their launches and the serial latency of a few
// dependent loads bound them.  The copy moves the addressing's three
// arrays and the anchors (~22 MB read and written at 1.08M particles).
// The compaction does not scan all particles again: the particle pass
// leaves each block's count and its risky particles, and each block of
// repair_movers walks the counts (4,219 at 1.08M) for its own movers.  The
// free-lane search reads only the movers' target cells, and a vacated slot
// is found among the movers' old slots, not in an occupancy of every slot.
//
// The row of a target cell is found by a binary search in the addressing's row codes
// 1..n_occ, which `pallas_step.build_addr` lists in ascending order and a
// repair keeps: the same row as the plain version's inverse table.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kPartThreads = 256;    // repair_particles: a particle a thread
constexpr int kMoverThreads = 256;   // repair_movers: a mover a thread
constexpr int kLaneThreads = 256;    // repair_lanes: 8 warps, a mover each
constexpr int kPatchThreads = 1024;  // repair_patch: one block
constexpr int kCopyThreads = 256;
constexpr int kLane = 128;           // lanes of a gcounts group
constexpr unsigned kFull = 0xffffffffu;

// The lattice as the plan reads it (repair._RepairConsts mirrors this
// layout field by field).
struct RepairConsts {
  int cap;           // slot cap of a cell
  int xc;            // cells per 128-lane group (the x halo)
  int h1;            // y rows incl. halo
  int h2;            // x slot-cells of a row incl. halos
  int n_codes;       // (z, y) row codes incl. halo
  int lanes;         // lanes of a slot row (h2 * cap)
  int c_rows;        // compacted rows incl. the dummy row 0
  int n_groups;      // 128-lane groups of a row
  int shape[3];      // cells per axis
  int off[3];        // the lattice's index offset (a slab's; else 0)
  int face_axis;     // the slab axis, or -1: no faces
  int face_lo_on;    // the lower face is interior (not a domain wall)
  int face_hi_on;    // the upper face is interior
  float lo[3];       // the grid's origin
  float cell;        // cell edge
  float move_k;      // fp32(1.2 dt sort_every)
  float budget;      // the predicate's drift budget
  float face_lo;     // the slab's faces along face_axis
  float face_hi;
  float band_lo;     // an anchor below band_lo (at or above band_hi) is in
  float band_hi;     // the lower (upper) band
};

// torch.minimum / torch.amin on the card: a NaN operand propagates.
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// torch.sum(t * t, dim=1) of a contiguous [N, DIM] row (see Bits).
template <int DIM>
__device__ __forceinline__ float row_sum_sq(const float* t) {
  if (DIM == 2) return __fadd_rn(__fmul_rn(t[0], t[0]), __fmul_rn(t[1], t[1]));
  return __fadd_rn(__fadd_rn(__fmul_rn(t[0], t[0]), __fmul_rn(t[2], t[2])),
                   __fmul_rn(t[1], t[1]));
}

// `neighbors.cell_index` along axis `a`: floor((x - lo) / cell) less the
// index offset (wrapping as int32 does), clipped to the lattice.
__device__ __forceinline__ int bin(float x, int a, const RepairConsts& k) {
  const float q = floorf(__fdiv_rn(__fsub_rn(x, k.lo[a]), k.cell));
  const int ci = (int)((unsigned)(int)q - (unsigned)k.off[a]);
  return min(max(ci, 0), k.shape[a] - 1);
}

// The compacted row of (z, y) row code `code`: r in 1..n_occ with
// row_code[r] == code, else 0 (the dummy row).
__device__ __forceinline__ int row_of(const int* __restrict__ row_code,
                                      int n_occ, int code) {
  int lo = 1, hi = n_occ;
  while (lo <= hi) {
    const int mid = (lo + hi) >> 1;
    const int c = __ldg(row_code + mid);
    if (c == code) return mid;
    if (c < code) lo = mid + 1;
    else hi = mid - 1;
  }
  return 0;
}

// Inclusive sum of `v` over the block; `s_warp` holds a sum per warp.
template <int kThreads>
__device__ __forceinline__ int block_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int add = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; w++)
    if (w < warp) add += s_warp[w];
  __syncthreads();
  return v + add;
}

template <int DIM>
__global__ void __launch_bounds__(kPartThreads)
repair_particles_kernel(const float* __restrict__ xs, int xs_rs,
                        const float* __restrict__ vs, int vs_rs,
                        const unsigned char* __restrict__ valid,
                        const int* __restrict__ row_pos,
                        const int* __restrict__ pos,
                        const float* __restrict__ x0,
                        const unsigned char* __restrict__ movable, int cap_n,
                        int* __restrict__ counts, int* __restrict__ vetoes,
                        int* __restrict__ lists, const RepairConsts k) {
  __shared__ int s_warp[kPartThreads / 32];
  const int i = blockIdx.x * kPartThreads + threadIdx.x;
  bool risky = false, banded = false;
  if (i < cap_n && movable[i] && valid[i]) {
    const int row = row_pos[i];
    if (row > 0) {
      const int p = pos[i];
      float x[DIM], v[DIM], dd[DIM];
#pragma unroll
      for (int c = 0; c < DIM; c++) {
        x[c] = xs[(size_t)row * xs_rs + c * k.lanes + p];
        v[c] = vs[(size_t)row * vs_rs + c * k.lanes + p];
      }
      const float move = __fmul_rn(k.move_k, __fsqrt_rn(row_sum_sq<DIM>(v)));
      float m = 0.0f;
#pragma unroll
      for (int a = 0; a < DIM; a++) {
        const float a0 = x0[(size_t)i * DIM + a];
        dd[a] = __fsub_rn(x[a], a0);
        // the anchor's build cell (its global bin) and the distance to
        // its nearer face
        const float lo_c = __fadd_rn(
            k.lo[a], __fmul_rn((float)(bin(a0, a, k) + k.off[a]), k.cell));
        const float ma = minimum(__fsub_rn(x[a], lo_c),
                                 __fsub_rn(__fadd_rn(lo_c, k.cell), x[a]));
        m = a ? minimum(m, ma) : ma;
      }
      if (k.face_axis >= 0) {
        // `_Slab.face_margin` of x and `_Slab.bands` of the anchor (x
        // picked by an unrolled loop, so that it stays in registers)
        float xa = x[0];
#pragma unroll
        for (int a = 1; a < DIM; a++)
          if (a == k.face_axis) xa = x[a];
        const float a0 = x0[(size_t)i * DIM + k.face_axis];
        const float f_lo = k.face_lo_on ? __fsub_rn(xa, k.face_lo) : INFINITY;
        const float f_hi = k.face_hi_on ? __fsub_rn(k.face_hi, xa) : INFINITY;
        m = minimum(m, minimum(f_lo, f_hi));
        banded = (k.face_lo_on && a0 < k.band_lo) ||
                 (k.face_hi_on && a0 >= k.band_hi);
      }
      const float drift = __fsqrt_rn(row_sum_sq<DIM>(dd));
      risky = m < move && __fadd_rn(drift, move) > k.budget;
    }
  }
  // a risky particle in a band vetoes the repair
  const int veto = __syncthreads_or(risky && banded);
  // the block's risky particles, in ascending order, and their count
  const unsigned ballot = __ballot_sync(kFull, risky);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kPartThreads / 32; w++) {
    const int c = s_warp[w];
    if (w < warp) before += c;
    total += c;
  }
  if (risky)
    lists[(size_t)blockIdx.x * kPartThreads + before +
          __popc(ballot & ((1u << lane) - 1u))] = i;
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = total;
    vetoes[blockIdx.x] = veto;
  }
}

template <int DIM>
__global__ void __launch_bounds__(kMoverThreads)
repair_movers_kernel(const int* __restrict__ counts,
                     const int* __restrict__ vetoes, int n_blocks,
                     const int* __restrict__ lists, int cap_n, int repair_k,
                     const float* __restrict__ xs, int xs_rs,
                     const unsigned char* __restrict__ valid,
                     const int* __restrict__ row_pos,
                     const int* __restrict__ pos,
                     const int* __restrict__ row_code,
                     const int* __restrict__ n_occ,
                     long long* __restrict__ pids,
                     unsigned char* __restrict__ vm_out,
                     float* __restrict__ x_m, int* __restrict__ old_row,
                     int* __restrict__ old_pos, int* __restrict__ new_row,
                     int* __restrict__ n_risky, int* __restrict__ cellkey,
                     int* __restrict__ hx_out, int* __restrict__ oslot,
                     int* __restrict__ flags, const RepairConsts k) {
  __shared__ int s_warp[kMoverThreads / 32];
  __shared__ int s_pid[kMoverThreads];
  __shared__ int s_carry;
  const int k0 = blockIdx.x * kMoverThreads;
  const int k_end = min(k0 + kMoverThreads, repair_k);
  s_pid[threadIdx.x] = cap_n;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  // an exclusive scan of the particle blocks' counts, a chunk at a time:
  // risky particle number q is in the block whose range holds q.  Block 0
  // also gathers the vetoes
  int veto = 0;
  for (int base = 0; base < n_blocks; base += kMoverThreads) {
    const int b = base + threadIdx.x;
    const int cnt = b < n_blocks ? counts[b] : 0;
    if (blockIdx.x == 0) veto |= __syncthreads_or(b < n_blocks && vetoes[b]);
    const int incl = block_scan<kMoverThreads>(cnt, s_warp);
    const int carry = s_carry;
    const int start = carry + incl - cnt;
    for (int q = max(start, k0); q < min(start + cnt, k_end); q++)
      s_pid[q - k0] = lists[(size_t)b * kPartThreads + (q - start)];
    __syncthreads();
    if (threadIdx.x == kMoverThreads - 1) s_carry = carry + incl;
    __syncthreads();
  }
  const int kk = k0 + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *n_risky = s_carry;
    flags[0] = veto;  // a veto, or (repair_lanes) a mover not placed
    flags[1] = 0;    // repair_lanes: blocks done
  }
  if (kk >= repair_k) return;
  const int pid = s_pid[threadIdx.x];
  const bool vm = pid < cap_n;
  const int ps = min(pid, cap_n - 1);
  const int orow = row_pos[ps], opos = pos[ps];
  // `_SlotPhysics.gather`: a particle without a slot reads row 0, lane 0
  const bool ok = valid[ps] && orow > 0;
  const int r = ok ? orow : 0, p = ok ? opos : 0;
  float x[DIM];
#pragma unroll
  for (int c = 0; c < DIM; c++) {
    x[c] = xs[(size_t)r * xs_rs + c * k.lanes + p];
    x_m[(size_t)kk * DIM + c] = x[c];
  }
  // the target cell: the bin of the current position
  int ci[DIM];
#pragma unroll
  for (int a = 0; a < DIM; a++) ci[a] = bin(x[a], a, k);
  const int code = DIM == 3 ? (ci[0] + 1) * k.h1 + (ci[1] + 1) : ci[0] + 1;
  const int hx = ci[DIM - 1] + k.xc;
  const int nrow = row_of(row_code, __ldg(n_occ), min(max(code, 0),
                                                       k.n_codes));
  pids[kk] = pid;
  vm_out[kk] = vm;
  old_row[kk] = orow;
  old_pos[kk] = opos;
  new_row[kk] = nrow;
  cellkey[kk] = nrow * k.h2 + hx;
  hx_out[kk] = hx;
  oslot[kk] = vm ? orow * k.lanes + opos : -1;
}

// The n-th (from 0) set bit of `m`.
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int j = 0; j < n; j++) m &= m - 1u;
  return __ffs(m) - 1;
}

__global__ void __launch_bounds__(kLaneThreads)
repair_lanes_kernel(const float* __restrict__ xs, int xs_rs,
                    const unsigned char* __restrict__ vm,
                    const int* __restrict__ new_row,
                    const int* __restrict__ n_risky,
                    const int* __restrict__ cellkey,
                    const int* __restrict__ hx_in,
                    const int* __restrict__ oslot, int repair_k,
                    int* __restrict__ new_pos,
                    unsigned char* __restrict__ can, int* flags,
                    const RepairConsts k) {
  const int lane = threadIdx.x & 31;
  const int kk = blockIdx.x * (kLaneThreads / 32) + (threadIdx.x >> 5);
  const int nr = __ldg(n_risky);
  const int n_vm = min(nr, repair_k);    // the movers are movers 0..n_vm-1
  bool bad = false;
  if (kk < repair_k) {
    const bool mv = vm[kk];
    const int key = cellkey[kk];
    const int rowsel = min(max(key, 0), k.c_rows * k.h2 - 1);
    const int first = rowsel * k.cap;    // the cell's first slot, row-major
    // the stable argsort's rank among equal keys: the earlier movers into
    // the same cell (a non-mover's key, 2**30, sorts after every mover's)
    int rank = 0;
    if (mv) {
      for (int j = lane; j < kk; j += 32) rank += cellkey[j] == key;
      rank = __reduce_add_sync(kFull, rank);
    } else {
      rank = kk - n_vm;
    }
    // the rank-th free lane of the cell, 32 lanes at a time: free when its
    // x is empty or a mover leaves it
    const float* xr = xs + (size_t)(rowsel / k.h2) * xs_rs +
                      (rowsel % k.h2) * k.cap;
    int lane_in = -1, seen = 0;
    for (int c0 = 0; c0 < k.cap; c0 += 32) {
      unsigned left = 0;
      for (int j = lane; j < n_vm; j += 32) {
        const unsigned off = (unsigned)(oslot[j] - first - c0);
        if (off < 32u) left |= 1u << off;
      }
      left = __reduce_or_sync(kFull, left);
      const bool free_lane =
          c0 + lane < k.cap &&
          (!(xr[c0 + lane] < 1e17f) || ((left >> lane) & 1u));
      const unsigned fm = __ballot_sync(kFull, free_lane);
      if (lane_in < 0 && seen + __popc(fm) > rank)
        lane_in = c0 + nth_bit(fm, rank - seen);
      seen += __popc(fm);
    }
    const bool placeable = lane_in >= 0;
    if (lane == 0) new_pos[kk] = hx_in[kk] * k.cap + (placeable ? lane_in : 0);
    bad = mv && (new_row[kk] == 0 || !placeable);
  }
  // can = 0 < n_risky <= K and every mover placed: the last block decides
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flags, 1);
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(flags + 1, 1) == (int)gridDim.x - 1)
      *can = nr <= repair_k && nr > 0 && atomicOr(flags, 0) == 0;
  }
}

struct Copies {
  const unsigned* src[4];
  unsigned* dst[4];
  long long n[4];       // 32-bit words; 0 for an absent array
};

__global__ void __launch_bounds__(kCopyThreads)
repair_copy_kernel(const Copies c) {
  const long long step = (long long)gridDim.x * kCopyThreads;
#pragma unroll
  for (int a = 0; a < 4; a++)
    for (long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
         i < c.n[a]; i += step)
      c.dst[a][i] = c.src[a][i];
}

// The slot arrays a repair re-homes: the carry's and the other filled
// storages' x, v and acc (set 0 the carry's), and the carry's x0s, rp and
// movb.  Row strides in elements; the components are `lanes` apart.
constexpr int kMaxSets = 3;
struct SlotArrays {
  float* x[kMaxSets];
  float* v[kMaxSets];
  float* a[kMaxSets];
  int x_rs[kMaxSets], v_rs[kMaxSets], a_rs[kMaxSets];
  int n_sets;
  float* x0s;
  int x0_rs;
  float* rp;
  int rp_rs;
  unsigned char* movb;
  int movb_rs;
};

template <int DIM>
__global__ void __launch_bounds__(kPatchThreads)
repair_patch_kernel(const SlotArrays s, const unsigned char* __restrict__ vm,
                    const float* __restrict__ x_m,
                    const int* __restrict__ old_row,
                    const int* __restrict__ old_pos,
                    const int* __restrict__ new_row,
                    const int* __restrict__ new_pos,
                    const long long* __restrict__ pids,
                    float* __restrict__ stash, int* __restrict__ pos_out,
                    int* __restrict__ row_pos_out,
                    int* __restrict__ gcounts_out,
                    float* __restrict__ anchors_out, int repair_k, int lanes,
                    int n_groups) {
  constexpr int kStash = 2 * DIM + 2;    // v | acc | rho, p of a mover
  // the movers' values in their old slots, then the empty values there;
  // the movers' old slots are distinct, so no other thread touches them
  for (int kk = threadIdx.x; kk < repair_k; kk += kPatchThreads) {
    if (!vm[kk]) continue;
    const size_t r = old_row[kk];
    const int p = old_pos[kk];
    float* st = stash + (size_t)kk * kStash;
#pragma unroll
    for (int c = 0; c < DIM; c++) {
      st[c] = s.v[0][r * s.v_rs[0] + c * lanes + p];
      st[DIM + c] = s.a[0][r * s.a_rs[0] + c * lanes + p];
    }
    st[2 * DIM] = s.rp[r * s.rp_rs + p];
    st[2 * DIM + 1] = s.rp[r * s.rp_rs + lanes + p];
    for (int i = 0; i < s.n_sets; i++) {
#pragma unroll
      for (int c = 0; c < DIM; c++) {
        s.x[i][r * s.x_rs[i] + c * lanes + p] = 1e18f;
        s.v[i][r * s.v_rs[i] + c * lanes + p] = 0.0f;
        s.a[i][r * s.a_rs[i] + c * lanes + p] = 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < DIM; c++) s.x0s[r * s.x0_rs + c * lanes + p] = 1e18f;
    s.rp[r * s.rp_rs + p] = 0.0f;
    s.rp[r * s.rp_rs + lanes + p] = 0.0f;
    s.movb[r * s.movb_rs + p] = 0;
  }
  // every old slot is empty before any new slot is written: a mover may
  // land in a slot another mover left, or in its own
  __syncthreads();
  for (int kk = threadIdx.x; kk < repair_k; kk += kPatchThreads) {
    if (!vm[kk]) continue;
    const int nrow = new_row[kk], np = new_pos[kk];
    const size_t r = nrow;
    const float* st = stash + (size_t)kk * kStash;
    float x[DIM];
#pragma unroll
    for (int c = 0; c < DIM; c++) x[c] = x_m[(size_t)kk * DIM + c];
    for (int i = 0; i < s.n_sets; i++) {
#pragma unroll
      for (int c = 0; c < DIM; c++) {
        s.x[i][r * s.x_rs[i] + c * lanes + np] = x[c];
        s.v[i][r * s.v_rs[i] + c * lanes + np] = st[c];
        s.a[i][r * s.a_rs[i] + c * lanes + np] = st[DIM + c];
      }
    }
#pragma unroll
    for (int c = 0; c < DIM; c++) s.x0s[r * s.x0_rs + c * lanes + np] = x[c];
    s.rp[r * s.rp_rs + np] = st[2 * DIM];
    s.rp[r * s.rp_rs + lanes + np] = st[2 * DIM + 1];
    s.movb[r * s.movb_rs + np] = 1;
    const long long pid = pids[kk];
    pos_out[pid] = np;
    row_pos_out[pid] = nrow;
    if (anchors_out != nullptr) {
#pragma unroll
      for (int c = 0; c < DIM; c++) anchors_out[pid * DIM + c] = x[c];
    }
    atomicAdd(gcounts_out + (size_t)old_row[kk] * n_groups +
                  old_pos[kk] / kLane, -1);
    atomicAdd(gcounts_out + r * n_groups + np / kLane, 1);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after its launches; the caller raises on a nonzero code.  Launches go to
// the caller's stream and do not synchronize.  Row strides (`*_rs`) are in
// elements; the component stride of every slot array is `lanes`.

// The plan: repair_particles, repair_movers, repair_lanes.  `scratch` holds
// ceil(cap_n / 256) counts and as many vetoes, then ceil(cap_n / 256) * 256
// list entries, then 3 * repair_k per-mover ints and 2 flags
// (repair_scratch_ints).
extern "C" int repair_plan(const void* xs, int xs_rs, const void* vs, int vs_rs,
                           const void* valid, const void* row_pos,
                           const void* pos, const void* row_code,
                           const void* n_occ, const void* x0,
                           const void* movable, int cap_n, int repair_k,
                           void* pids, void* vm, void* x_m, void* old_row,
                           void* old_pos, void* new_row, void* new_pos,
                           void* n_risky, void* can, void* scratch,
                           const void* consts, int dim, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RepairConsts k = *(const RepairConsts*)consts;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = (cap_n + kPartThreads - 1) / kPartThreads;
  int* counts = (int*)scratch;
  int* vetoes = counts + n_blocks;
  int* lists = vetoes + n_blocks;
  int* cellkey = lists + (size_t)n_blocks * kPartThreads;
  int* hx = cellkey + repair_k;
  int* oslot = hx + repair_k;
  int* flags = oslot + repair_k;
  const int m_blocks = (repair_k + kMoverThreads - 1) / kMoverThreads;
  const int l_blocks =
      (repair_k + kLaneThreads / 32 - 1) / (kLaneThreads / 32);
  if (dim == 3) {
    repair_particles_kernel<3><<<n_blocks, kPartThreads, 0, st>>>(
        (const float*)xs, xs_rs, (const float*)vs, vs_rs,
        (const unsigned char*)valid, (const int*)row_pos, (const int*)pos,
        (const float*)x0, (const unsigned char*)movable, cap_n, counts,
        vetoes, lists, k);
    repair_movers_kernel<3><<<m_blocks, kMoverThreads, 0, st>>>(
        counts, vetoes, n_blocks, lists, cap_n, repair_k, (const float*)xs,
        xs_rs,
        (const unsigned char*)valid, (const int*)row_pos, (const int*)pos,
        (const int*)row_code, (const int*)n_occ, (long long*)pids,
        (unsigned char*)vm, (float*)x_m, (int*)old_row, (int*)old_pos,
        (int*)new_row, (int*)n_risky, cellkey, hx, oslot, flags, k);
  } else {
    repair_particles_kernel<2><<<n_blocks, kPartThreads, 0, st>>>(
        (const float*)xs, xs_rs, (const float*)vs, vs_rs,
        (const unsigned char*)valid, (const int*)row_pos, (const int*)pos,
        (const float*)x0, (const unsigned char*)movable, cap_n, counts,
        vetoes, lists, k);
    repair_movers_kernel<2><<<m_blocks, kMoverThreads, 0, st>>>(
        counts, vetoes, n_blocks, lists, cap_n, repair_k, (const float*)xs,
        xs_rs,
        (const unsigned char*)valid, (const int*)row_pos, (const int*)pos,
        (const int*)row_code, (const int*)n_occ, (long long*)pids,
        (unsigned char*)vm, (float*)x_m, (int*)old_row, (int*)old_pos,
        (int*)new_row, (int*)n_risky, cellkey, hx, oslot, flags, k);
  }
  repair_lanes_kernel<<<l_blocks, kLaneThreads, 0, st>>>(
      (const float*)xs, xs_rs, (const unsigned char*)vm, (const int*)new_row,
      (const int*)n_risky, cellkey, hx, oslot, repair_k, (int*)new_pos,
      (unsigned char*)can, flags, k);
  return (int)cudaGetLastError();
}

// The ints of repair_plan's scratch.
extern "C" int repair_scratch_ints(int cap_n, int repair_k) {
  const int n_blocks = (cap_n + kPartThreads - 1) / kPartThreads;
  return n_blocks * (kPartThreads + 2) + 3 * repair_k + 2;
}

// The apply: repair_copy, then repair_patch.  `x`, `v`, `a` and their row
// strides hold `n_sets` slot arrays each (the carry's first); `stash`
// (2 dim + 2) * repair_k floats; `anchors`/`anchors_out` ([n_anchors, dim])
// may be null.
extern "C" int repair_apply(const void* const* x, const void* const* v,
                            const void* const* a, const int* x_rs,
                            const int* v_rs, const int* a_rs, int n_sets,
                            void* x0s, int x0_rs, void* rp, int rp_rs,
                            void* movb, int movb_rs, const void* vm,
                            const void* x_m, const void* old_row,
                            const void* old_pos, const void* new_row,
                            const void* new_pos, const void* pids,
                            void* stash, const void* pos, void* pos_out,
                            const void* row_pos, void* row_pos_out, int n,
                            const void* gcounts, void* gcounts_out, int n_g,
                            const void* anchors, void* anchors_out,
                            int n_anchors, int repair_k, int lanes,
                            int n_groups, int dim, int copy_blocks,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_sets < 1 || n_sets > kMaxSets) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Copies c{};
  c.src[0] = (const unsigned*)pos;
  c.dst[0] = (unsigned*)pos_out;
  c.n[0] = n;
  c.src[1] = (const unsigned*)row_pos;
  c.dst[1] = (unsigned*)row_pos_out;
  c.n[1] = n;
  c.src[2] = (const unsigned*)gcounts;
  c.dst[2] = (unsigned*)gcounts_out;
  c.n[2] = n_g;
  c.src[3] = (const unsigned*)anchors;
  c.dst[3] = (unsigned*)anchors_out;
  c.n[3] = anchors_out != nullptr ? (long long)n_anchors * dim : 0;
  repair_copy_kernel<<<copy_blocks, kCopyThreads, 0, st>>>(c);
  SlotArrays s{};
  for (int i = 0; i < n_sets; i++) {
    s.x[i] = (float*)x[i];
    s.v[i] = (float*)v[i];
    s.a[i] = (float*)a[i];
    s.x_rs[i] = x_rs[i];
    s.v_rs[i] = v_rs[i];
    s.a_rs[i] = a_rs[i];
  }
  s.n_sets = n_sets;
  s.x0s = (float*)x0s;
  s.x0_rs = x0_rs;
  s.rp = (float*)rp;
  s.rp_rs = rp_rs;
  s.movb = (unsigned char*)movb;
  s.movb_rs = movb_rs;
  if (dim == 3) {
    repair_patch_kernel<3><<<1, kPatchThreads, 0, st>>>(
        s, (const unsigned char*)vm, (const float*)x_m, (const int*)old_row,
        (const int*)old_pos, (const int*)new_row, (const int*)new_pos,
        (const long long*)pids, (float*)stash, (int*)pos_out,
        (int*)row_pos_out, (int*)gcounts_out, (float*)anchors_out, repair_k,
        lanes, n_groups);
  } else {
    repair_patch_kernel<2><<<1, kPatchThreads, 0, st>>>(
        s, (const unsigned char*)vm, (const float*)x_m, (const int*)old_row,
        (const int*)old_pos, (const int*)new_row, (const int*)new_pos,
        (const long long*)pids, (float*)stash, (int*)pos_out,
        (int*)row_pos_out, (int*)gcounts_out, (float*)anchors_out, repair_k,
        lanes, n_groups);
  }
  return (int)cudaGetLastError();
}

// sizeof(RepairConsts): the wrapper checks its mirror of the layout.
extern "C" int repair_consts_bytes() { return (int)sizeof(RepairConsts); }
