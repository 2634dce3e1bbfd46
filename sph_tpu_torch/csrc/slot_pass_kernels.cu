// The resident block's slot-space passes for Hopper (sm_90a): slot_pre
// before K1 and slot_post after K2.
//
// They have no Pallas counterpart.  On the TPU, XLA fuses the body of the
// resident scan (`run_block`, sph_tpu/step.py:1032-1093: the kick and the
// drift, `mk_feat_builder` :628-651, `_SlotPhysics.body_forces` :557,
// `clamp_slot` :579, the drift audit and `_membership_bad` :325) around the
// two Pallas calls.  The port ran that body as ~90 separate PyTorch kernels
// a step over every slot; these two kernels are its counterpart, one on
// each side of K1/K2 (sph_tpu_torch/slot_pass.py holds the PyTorch
// sequence as their plain versions, and `step._slot_steps` drives them).
//
//   slot_pre   the leapfrog kick v += fp32(dt/2) a mov and drift
//              x += fp32(dt) v mov, written into the block's feature array
//              feat [c_rows, 8, lanes] = x(3) | 0 | v(3) | 0 | mov | 0,
//              which K1/K2 read and which also stores the block's x and v
//              (their views feat[:, 0:d], feat[:, 3:3+d]); with bf16
//              features also feat16 = bf16(x - center) | 0 | bf16(v) | 0.
//   slot_post  the body forces (gravity, penalty walls, force fields in
//              their live window), a = where(mov, f / max(rho, 1e-12), 0),
//              the second half-kick (or Euler's v and x), the clamp walls,
//              and the drift audit |x - x0|^2 > (skin/2)^2 relaxed by build
//              cell membership (and kept strict past a slab's faces),
//              counted into one device int32.
//
// Bits.  Every step must give PyTorch's own bits on the card, since the
// audit's compares decide the heals, rebuilds and repairs.  PyTorch runs
// each operation as its own kernel, so each product and sum is rounded on
// its own: they are written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn, which nvcc never contracts into an FMA, in
// PyTorch's order.  A Python scalar reaches a PyTorch kernel rounded to
// fp32 (the wrapper rounds it the same way), and a division by one runs on
// the card as a product with fp32(1 / b): `r / radius` is r * inv_radius
// here.  torch.sum over the D components of a [c_rows, D, lanes] array sums
// (x0 + x1) + x2 in one thread (Reduce.cuh: below 16 values a thread, each
// output is one thread's; its four accumulators combine in order).  clamp,
// maximum and minimum are fmaxf / fminf behind PyTorch's NaN guards, with
// PyTorch's argument order, so the sign of a zero comes out the same.
//
// Where they work.  128 threads, one a lane, on each occupied (row,
// 128-lane group) tile: rows 1..n_occ whose group holds a particle
// (gcounts > 0).  The tiles are listed once per addressing
// (`slot_pass.occupied_tiles`, the count on the device), and a grid of a
// few blocks an SM walks the list, so that no block is launched for an
// empty group: a launch over every (row, group), most of whose blocks exit
// at once, cost 0.038 ms on an H100 at splash3d_1m with nothing to do
// (61,455 blocks, 19,520 occupied; chip_smoke.py's slot_pass phase).  The
// walk changes no bit: each slot's arithmetic is its own, and the counts
// are integers.  The plain sequence
// leaves an empty slot (x 1e18, v +0, acc +0, mov 0) bit for bit as it
// is, so skipping those groups gives the plain whole arrays.  A pass over
// every slot (slot_pre's `full`) launches one block a (row, group).
//
// A block's first slot_pre (`first`) reads the block's top, the carry, and
// writes the block's own storage, because the top must stay as it is (a
// heal re-runs from it, a repair plans on it); it zeroes the violation and
// rebuild-predicate counts.  The storage outlives the block
// (`slot_pass.SlotStore`): the array that held the last accepted block's
// top is the next block's, and under the same addressing its slots outside
// the occupied groups already hold what a pass over every slot would write
// there, since no pass writes them.  So the first pass, too, visits the
// occupied groups only, writes x and v there and leaves acc, which
// slot_post writes before anything reads it.  Only a storage not yet filled
// under the block's addressing gets the pass over every slot (`full`): all
// eight feature channels and a zeroed acc, and, where the build's own
// scatter array is to become a storage, a copy of the top's x into `x0`,
// the drift audit's reference, which the array held until then.
//
// What bounds them on this card: bytes.  slot_post reads x, v, rho, f, x0
// and mov of a slot and writes v and acc (77 B in 3D; x too with Euler or
// clamp walls); slot_pre reads x, v, acc and mov and writes x and v (61 B),
// in place or, as a block's first, from the top; its full pass writes
// every slot's eight channels and acc.  A few dozen fp32 operations a slot
// are far below the bytes' time.  The byte bounds are in chip_smoke.py's
// slot_pass phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kFeat = 8;
constexpr int kFout = 4;
constexpr int kLane = 128;
constexpr int kFieldF = 5;  // a force field: pos(3), fp32(radius), strength
constexpr int kFieldI = 2;   // per force field: start_step, stop_step

// slot_post's constants, filled once a block by the wrapper
// (slot_pass._PostConsts mirrors this layout field by field).
struct PostConsts {
  int leap;          // 1: leapfrog's second half-kick; 0: Euler's v and x
  int penalty;       // penalty walls in the body forces
  int clamp;         // clamp walls after the update
  int use_mem;       // relax the audit by build-cell membership
  int packed;        // packed rows: x is exempt from membership
  int faces;         // a slab: keep the strict audit past its faces
  int face_axis;
  int face_lo_on;    // the slab's low face is interior
  int face_hi_on;
  int cap, xc, h1;   // slot cap, cells per 128-lane group, y rows + halo
  int shape[3];      // the lattice's cells per axis
  int ci_off[3];     // a slab-local lattice's index shift
  float dt, c_half, half2, k_w, c_w, damping, cell;
  float face_lo, face_hi;
  float g[3], lo_w[3], hi_w[3], lo[3];
  int need;          // the block's last slot_post counts the rebuild
                     // predicate's slots (`membership_risky`)
  float move_k;      // fp32(1.2 dt sort_every)
  float budget;      // the predicate's drift budget
};

// The (row, lane) of each of a thread's tiles: every (row, group) of the
// grid's own for a launch over every slot (`tiles` null), else the tiles of
// the list `tiles[0..*n_tiles)`, row * n_groups + group, walked by the grid.
template <typename F>
__device__ __forceinline__ void for_tiles(const int* __restrict__ tiles,
                                          const int* __restrict__ n_tiles,
                                          int n_groups, F&& body) {
  if (tiles == nullptr) {
    body((int)blockIdx.y, (int)(blockIdx.x * kLane + threadIdx.x));
    return;
  }
  const int n = __ldg(n_tiles);
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    const int tile = __ldg(tiles + t);
    body(tile / n_groups, (tile % n_groups) * kLane + (int)threadIdx.x);
  }
}

// torch.clamp(v, min=lo) on the card: NaN passes, else ::max(v, lo).
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.maximum / torch.minimum: a NaN operand propagates.
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// torch.sum(t * t, dim=1) over D components, in PyTorch's order.
template <int DIM>
__device__ __forceinline__ float sum_sq(const float* t) {
  float s = __fmul_rn(t[0], t[0]);
#pragma unroll
  for (int c = 1; c < DIM; c++) s = __fadd_rn(s, __fmul_rn(t[c], t[c]));
  return s;
}

__device__ __forceinline__ unsigned short to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The slot's build-cell index along `ax` (`slot_pass.slot_bin_refs`).
template <int DIM>
__device__ __forceinline__ int build_ref(int ax, int code, int lane,
                                         const PostConsts& k) {
  if (ax == DIM - 1) return lane / k.cap - k.xc;
  if (DIM == 3 && ax == 0) return code / k.h1 - 1;
  return (DIM == 3 ? code % k.h1 : code) - 1;
}

// `membership_risky` for a movable slot at the end of a block: its
// 1.2x-projected move over the next block can take it out of its build
// cell (or past an interior slab face) and past the drift budget.
template <int DIM>
__device__ __forceinline__ bool rebuild_risky(const float* x, const float* v,
                                              float d2, const int* row_code,
                                              int row, int lane,
                                              const PostConsts& k) {
  const float move = __fmul_rn(k.move_k, __fsqrt_rn(sum_sq<DIM>(v)));
  const int code = __ldg(row_code + row);
  float m = 0.0f;
  bool any = false;
#pragma unroll
  for (int ax = 0; ax < DIM; ax++) {
    if (ax == DIM - 1 && k.packed) continue;
    const int ref = build_ref<DIM>(ax, code, lane, k) + k.ci_off[ax];
    const float lo_c = __fadd_rn(__fmul_rn((float)ref, k.cell), k.lo[ax]);
    const float ma = minimum(__fsub_rn(x[ax], lo_c),
                             __fsub_rn(__fadd_rn(lo_c, k.cell), x[ax]));
    m = any ? minimum(m, ma) : ma;
    any = true;
  }
  if (k.faces) {
    const float xa = x[k.face_axis];
    const float fm =
        minimum(k.face_lo_on ? __fsub_rn(xa, k.face_lo) : INFINITY,
                k.face_hi_on ? __fsub_rn(k.face_hi, xa) : INFINITY);
    m = minimum(m, fm);
  }
  return m < move && __fadd_rn(__fsqrt_rn(d2), move) > k.budget;
}

template <int DIM>
__global__ void __launch_bounds__(kLane)
slot_pre_kernel(const float* x_in, int x_rs, const float* v_in, int v_rs,
                const float* acc, int a_rs,
                const unsigned char* __restrict__ movb, float* feat,
                unsigned short* __restrict__ feat16,
                const float* __restrict__ centers,
                float* __restrict__ acc_zero, float* __restrict__ x0,
                int* __restrict__ count, int* __restrict__ risky,
                const int* __restrict__ tiles,
                const int* __restrict__ n_tiles, int lanes, int n_groups,
                int first, int full, int kick, int drift, float c_half,
                float dt) {
  if (first && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    *count = 0;
    *risky = 0;
  }
  for_tiles(tiles, n_tiles, n_groups, [&](int row, int lane) {
    const float mov = movb[(size_t)row * lanes + lane] ? 1.0f : 0.0f;
    float x[DIM], v[DIM];
#pragma unroll
    for (int c = 0; c < DIM; c++) {
      x[c] = x_in[(size_t)row * x_rs + c * lanes + lane];
      v[c] = v_in[(size_t)row * v_rs + c * lanes + lane];
    }
    if (x0 != nullptr) {
#pragma unroll
      for (int c = 0; c < DIM; c++)
        x0[((size_t)row * DIM + c) * lanes + lane] = x[c];
    }
    if (kick) {
#pragma unroll
      for (int c = 0; c < DIM; c++) {
        const float a = acc[(size_t)row * a_rs + c * lanes + lane];
        v[c] = __fadd_rn(v[c], __fmul_rn(__fmul_rn(c_half, a), mov));
      }
    }
    if (drift) {
#pragma unroll
      for (int c = 0; c < DIM; c++)
        x[c] = __fadd_rn(x[c], __fmul_rn(__fmul_rn(dt, v[c]), mov));
    }
    float* fr = feat + (size_t)row * kFeat * lanes + lane;
#pragma unroll
    for (int c = 0; c < DIM; c++) {
      if (first || drift) fr[c * lanes] = x[c];
      if (first || kick) fr[(3 + c) * lanes] = v[c];
    }
    if (full) {
#pragma unroll
      for (int c = DIM; c < 3; c++) {
        fr[c * lanes] = 0.0f;
        fr[(3 + c) * lanes] = 0.0f;
      }
      fr[6 * lanes] = mov;
      fr[7 * lanes] = 0.0f;
#pragma unroll
      for (int c = 0; c < DIM; c++)
        acc_zero[((size_t)row * DIM + c) * lanes + lane] = 0.0f;
    }
    if (feat16 != nullptr) {
      unsigned short* hr = feat16 + (size_t)row * kFeat * lanes + lane;
      const float* cr = centers + (size_t)row * DIM * lanes + lane;
#pragma unroll
      for (int c = 0; c < DIM; c++) {
        hr[c * lanes] = to_bf16(__fsub_rn(x[c], cr[c * lanes]));
        hr[(3 + c) * lanes] = to_bf16(v[c]);
      }
#pragma unroll
      for (int c = DIM; c < 3; c++) {
        hr[c * lanes] = 0;
        hr[(3 + c) * lanes] = 0;
      }
      hr[6 * lanes] = 0;
      hr[7 * lanes] = 0;
    }
  });
}

template <int DIM>
__global__ void __launch_bounds__(kLane)
slot_post_kernel(float* feat, float* __restrict__ acc,
                 const float* __restrict__ rp, const float* __restrict__ f,
                 const float* __restrict__ x0, int x0_rs,
                 const unsigned char* __restrict__ movb,
                 const int* __restrict__ row_code,
                 const int* __restrict__ tiles,
                 const int* __restrict__ n_tiles,
                 const int* __restrict__ step0, int step_off,
                 const float* __restrict__ ff_f, const int* __restrict__ ff_i,
                 int n_fields, int* __restrict__ count,
                 int* __restrict__ risky, int need_now, const PostConsts k,
                 int lanes, int n_groups) {
  // a block's threads walk the same tiles, so the counts' barriers match
  for_tiles(tiles, n_tiles, n_groups, [&](int row, int lane) {
    const bool mv = movb[(size_t)row * lanes + lane] != 0;
    const float mov = mv ? 1.0f : 0.0f;
    float* fr = feat + (size_t)row * kFeat * lanes + lane;
    float x[DIM], v[DIM], a[DIM];
#pragma unroll
    for (int c = 0; c < DIM; c++) {
      x[c] = fr[c * lanes];
      v[c] = fr[(3 + c) * lanes];
      a[c] = 0.0f;   // where(movb, ..., 0.0)
    }
    if (mv) {
      const float rho = rp[(size_t)row * 2 * lanes + lane];
      float fo[DIM];
#pragma unroll
      for (int c = 0; c < DIM; c++)
        fo[c] = __fadd_rn(f[((size_t)row * kFout + c) * lanes + lane],
                          __fmul_rn(rho, k.g[c]));
      if (k.penalty) {
#pragma unroll
        for (int c = 0; c < DIM; c++) {
          const float d_lo = clamp_min(__fsub_rn(k.lo_w[c], x[c]), 0.0f);
          const float d_hi = clamp_min(__fsub_rn(x[c], k.hi_w[c]), 0.0f);
          const float p_lo = __fsub_rn(__fmul_rn(k.k_w, d_lo),
                                       __fmul_rn(k.c_w, v[c]));
          const float p_hi = __fsub_rn(__fmul_rn(k.k_w, d_hi),
                                       __fmul_rn(k.c_w, -v[c]));
          fo[c] = __fsub_rn(
              __fadd_rn(fo[c], __fmul_rn(p_lo, d_lo > 0.0f ? 1.0f : 0.0f)),
              __fmul_rn(p_hi, d_hi > 0.0f ? 1.0f : 0.0f));
        }
      }
      if (n_fields > 0) {
        const int step_i = __ldg(step0) + step_off;
        for (int j = 0; j < n_fields; j++) {
          const float* ff = ff_f + j * kFieldF;
          float dx[DIM];
#pragma unroll
          for (int c = 0; c < DIM; c++) dx[c] = __fsub_rn(__ldg(ff + c), x[c]);
          const float r = __fsqrt_rn(sum_sq<DIM>(dx));
          const float fall =
              clamp_min(__fsub_rn(1.0f, __fdiv_rn(r, __ldg(ff + 3))), 0.0f);
          const float live = (step_i >= __ldg(ff_i + j * kFieldI) &&
                              step_i < __ldg(ff_i + j * kFieldI + 1))
                                 ? 1.0f : 0.0f;
          const float sf = __fmul_rn(__fmul_rn(live, __ldg(ff + 4)), fall);
          const float rr = clamp_min(r, 1e-6f);
#pragma unroll
          for (int c = 0; c < DIM; c++)
            fo[c] = __fadd_rn(fo[c], __fmul_rn(sf, __fdiv_rn(dx[c], rr)));
        }
      }
      const float rc = clamp_min(rho, 1e-12f);
#pragma unroll
      for (int c = 0; c < DIM; c++) a[c] = __fdiv_rn(fo[c], rc);
    }
    if (k.leap) {
#pragma unroll
      for (int c = 0; c < DIM; c++)
        v[c] = __fadd_rn(v[c], __fmul_rn(k.c_half, a[c]));
    } else {
#pragma unroll
      for (int c = 0; c < DIM; c++)
        v[c] = __fadd_rn(v[c], __fmul_rn(__fmul_rn(k.dt, a[c]), mov));
#pragma unroll
      for (int c = 0; c < DIM; c++)
        x[c] = __fadd_rn(x[c], __fmul_rn(__fmul_rn(k.dt, v[c]), mov));
    }
    if (k.clamp && mv) {
#pragma unroll
      for (int c = 0; c < DIM; c++) {
        if (x[c] < k.lo_w[c] || x[c] > k.hi_w[c])
          v[c] = __fmul_rn(v[c], k.damping);
        x[c] = minimum(maximum(x[c], k.lo_w[c]), k.hi_w[c]);
      }
    }
    bool bad = false, risk = false;
    if (mv) {
      float dd[DIM];
#pragma unroll
      for (int c = 0; c < DIM; c++)
        dd[c] = __fsub_rn(x[c], x0[(size_t)row * x0_rs + c * lanes + lane]);
      const float d2 = sum_sq<DIM>(dd);
      bad = d2 > k.half2;
      if (need_now) risk = rebuild_risky<DIM>(x, v, d2, row_code, row, lane, k);
      if (bad && k.use_mem) {
        // still inside the build cell: `neighbors.cell_index`'s floor and
        // clip against the refs of `slot_pass.slot_bin_refs`
        const int code = __ldg(row_code + row);
        bool inside = true;
#pragma unroll
        for (int ax = 0; ax < DIM; ax++) {
          if (ax == DIM - 1 && k.packed) continue;
          const int ref = build_ref<DIM>(ax, code, lane, k);
          const float q = floorf(__fdiv_rn(__fsub_rn(x[ax], k.lo[ax]), k.cell));
          int ci = (int)q - k.ci_off[ax];
          ci = min(max(ci, 0), k.shape[ax] - 1);
          inside = inside && ci == ref;
        }
        bool keep = !inside;
        if (k.faces) {
          const float xa = x[k.face_axis];
          keep = keep || (k.face_lo_on && xa < k.face_lo) ||
                 (k.face_hi_on && xa >= k.face_hi);
        }
        bad = keep;
      }
    }
    // the order-free sums of the pass: integer counts
    const int n_bad = __syncthreads_count(bad);
    if (threadIdx.x == 0 && n_bad > 0) atomicAdd(count, n_bad);
    if (need_now) {
      const int n_risk = __syncthreads_count(risk);
      if (threadIdx.x == 0 && n_risk > 0) atomicAdd(risky, n_risk);
    }
#pragma unroll
    for (int c = 0; c < DIM; c++) {
      if (!k.leap || k.clamp) fr[c * lanes] = x[c];
      fr[(3 + c) * lanes] = v[c];
      acc[((size_t)row * DIM + c) * lanes + lane] = a[c];
    }
  });
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after its launch; the caller raises on a nonzero code.  Launches go to the
// caller's stream and do not synchronize.  A row stride (`*_rs`) is in
// floats; the component stride of every slot array is `lanes`.

// `tiles`, `n_tiles`: the occupied tiles (`slot_pass.occupied_tiles`),
// walked by `tile_blocks` blocks; a full slot_pre takes neither and
// launches one block a (row, group).
extern "C" int slot_pre(const void* x_in, int x_rs, const void* v_in,
                        int v_rs, const void* acc, int a_rs, const void* movb,
                        void* feat, void* feat16, const void* centers,
                        void* acc_zero, void* x0, void* count, void* risky,
                        const void* tiles, const void* n_tiles,
                        int tile_blocks, int c_rows, int lanes, int n_groups,
                        int dim, int first, int full, int kick, int drift,
                        float c_half, float dt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = full ? dim3(n_groups, c_rows) : dim3(tile_blocks);
  if (full) tiles = nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3) {
    slot_pre_kernel<3><<<grid, kLane, 0, st>>>(
        (const float*)x_in, x_rs, (const float*)v_in, v_rs,
        (const float*)acc, a_rs, (const unsigned char*)movb, (float*)feat,
        (unsigned short*)feat16, (const float*)centers, (float*)acc_zero,
        (float*)x0, (int*)count, (int*)risky, (const int*)tiles,
        (const int*)n_tiles, lanes, n_groups, first, full, kick, drift,
        c_half, dt);
  } else {
    slot_pre_kernel<2><<<grid, kLane, 0, st>>>(
        (const float*)x_in, x_rs, (const float*)v_in, v_rs,
        (const float*)acc, a_rs, (const unsigned char*)movb, (float*)feat,
        (unsigned short*)feat16, (const float*)centers, (float*)acc_zero,
        (float*)x0, (int*)count, (int*)risky, (const int*)tiles,
        (const int*)n_tiles, lanes, n_groups, first, full, kick, drift,
        c_half, dt);
  }
  return (int)cudaGetLastError();
}

extern "C" int slot_post(void* feat, void* acc, const void* rp, const void* f,
                         const void* x0, int x0_rs, const void* movb,
                         const void* row_code, const void* tiles,
                         const void* n_tiles, int tile_blocks,
                         const void* step0, int step_off,
                         const void* ff_f, const void* ff_i, int n_fields,
                         void* count, void* risky, int need_now,
                         const void* consts, int lanes, int n_groups, int dim,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const PostConsts k = *(const PostConsts*)consts;
  const dim3 grid(tile_blocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3) {
    slot_post_kernel<3><<<grid, kLane, 0, st>>>(
        (float*)feat, (float*)acc, (const float*)rp, (const float*)f,
        (const float*)x0, x0_rs, (const unsigned char*)movb,
        (const int*)row_code, (const int*)tiles, (const int*)n_tiles,
        (const int*)step0, step_off, (const float*)ff_f, (const int*)ff_i,
        n_fields, (int*)count, (int*)risky, need_now, k, lanes, n_groups);
  } else {
    slot_post_kernel<2><<<grid, kLane, 0, st>>>(
        (float*)feat, (float*)acc, (const float*)rp, (const float*)f,
        (const float*)x0, x0_rs, (const unsigned char*)movb,
        (const int*)row_code, (const int*)tiles, (const int*)n_tiles,
        (const int*)step0, step_off, (const float*)ff_f, (const int*)ff_i,
        n_fields, (int*)count, (int*)risky, need_now, k, lanes, n_groups);
  }
  return (int)cudaGetLastError();
}

// sizeof(PostConsts), so the wrapper can check its mirror of the layout.
extern "C" int slot_post_consts_bytes() { return (int)sizeof(PostConsts); }
