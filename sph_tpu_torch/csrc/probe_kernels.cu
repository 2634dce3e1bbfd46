// P1, the vector-throughput probe: does the card run the SPH pair op mix
// (sub, mul, add, max) in bf16 at twice the fp32 rate?  Replaces the TPU
// Pallas kernel of bench/probe_vpu_bf16.py (`make_kernel`), which asks the
// same of the TPU's vector unit.
//
// Each kernel runs 64 dependent rounds of
//     d = acc - y;  acc = max(d * d + y, acc * 0.5)
// over [512, 1024] arrays, unrolled and loop-carried so nothing is hoisted.
//   probe_f32   one element a thread, with __fsub_rn / __fmul_rn / __fadd_rn
//               and fmaxf: the _rn intrinsics are never fused, so d * d + y
//               stays a multiply and an add (nvcc's default -fmad=true would
//               make it one FMA), and every op rounds as the TPU kernel and
//               the plain PyTorch chain do.
//   probe_bf16  two elements a thread as one packed bf16 pair (32 bits),
//               with the sm_90 pair instructions sub / mul / add.rn.bf16x2
//               and max.bf16x2, what __hsub2_rn / __hmul2_rn / __hadd2_rn /
//               __hmax2 issue, written as PTX so that no header version
//               decides: the .rn forms, unlike the plain __hmul2's, may not
//               be contracted into an FMA, and no __hfma2 is used, for the
//               same reason.  Packed pairs are the point: the question is
//               whether the card issues bf16 as paired lanes.
// What bounds them on this card: arithmetic issue, 4 ops a round for
// 64 rounds an element against 12 (fp32) or 6 (bf16) bytes moved; PERF.md
// holds the times beside the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kChain = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
  const float yy = y[i];
#pragma unroll
  for (int r = 0; r < kChain; ++r) {
    const float d = __fsub_rn(acc, yy);
    acc = fmaxf(__fadd_rn(__fmul_rn(d, d), yy), __fmul_rn(acc, 0.5f));
  }
  out[i] = acc;
}

// One packed bf16 pair instruction: d = a OP b on both lanes.
#define BF16X2_OP(name, op)                                          \
  __device__ __forceinline__ unsigned name(unsigned a, unsigned b) { \
    unsigned d;                                                      \
    asm(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));               \
    return d;                                                        \
  }
BF16X2_OP(sub2, "sub.rn.bf16x2")
BF16X2_OP(mul2, "mul.rn.bf16x2")
BF16X2_OP(add2, "add.rn.bf16x2")
BF16X2_OP(max2, "max.bf16x2")
#undef BF16X2_OP

constexpr unsigned kHalfPair = 0x3F003F00u;  // (0.5, 0.5) in bf16

__global__ void __launch_bounds__(kThreads)
probe_bf16_kernel(const unsigned* __restrict__ x,
                  const unsigned* __restrict__ y, unsigned* __restrict__ out,
                  int n2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n2) return;
  unsigned acc = x[i];
  const unsigned yy = y[i];
#pragma unroll
  for (int r = 0; r < kChain; ++r) {
    const unsigned d = sub2(acc, yy);
    acc = max2(add2(mul2(d, d), yy), mul2(acc, kHalfPair));
  }
  out[i] = acc;
}

}  // namespace

// Plain C interface (loaded with ctypes): `n` elements (even for bf16).
// Each returns cudaGetLastError() after its launch; the launch goes to the
// caller's stream and does not synchronize.

extern "C" int probe_f32(const void* x, const void* y, void* out, int n,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  probe_f32_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>((const float*)x, (const float*)y,
                                             (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int probe_bf16(const void* x, const void* y, void* out, int n,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n2 = n / 2;
  probe_bf16_kernel<<<(n2 + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const unsigned*)x, (const unsigned*)y, (unsigned*)out, n2);
  return (int)cudaGetLastError();
}
