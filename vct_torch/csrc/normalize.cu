// K6: uint8 frames -> f32, scaled by 1/255, then per channel
// (x - mean[c]) * inv_std[c].
//
// Replaces the TPU kernel of vct/ops/preprocess_pallas.py::normalize_frames_pallas
// (_norm_kernel).
//
// Bound on the H100: bytes. Each element costs one byte read and four
// written against three f32 operations, so one pass at 3.35 TB/s is the
// least time.
//
// Design, kept simple:
//   * a grid-stride loop over groups of 4 elements: one 4-byte load of the
//     uint8 input and one 16-byte store of the f32 output per thread, so a
//     warp reads 128 contiguous bytes and writes 512 (a first design gave
//     each thread 16 elements and four 16-byte stores 64 bytes apart, which
//     left every store instruction of a warp half-coalesced); the channel
//     of element i is i % C;
//   * the elements after the last whole group, and every element when the
//     input's base is not 4-byte aligned (offset views), take a scalar
//     grid-stride loop;
//   * the arithmetic is __fmul_rn / __fsub_rn (never contracted into an FMA)
//     in the plain version's order, with the scale f32(1/255) passed in by
//     the caller, so the result is bit-identical to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

__device__ __forceinline__ float norm_one(unsigned int v, float scale, float mean,
                                          float inv_std) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__uint2float_rn(v), scale), mean), inv_std);
}

__global__ void __launch_bounds__(kThreads)
normalize_frames_vec_kernel(const unsigned int* __restrict__ x, float4* __restrict__ out,
                            long long n_vec, int C, const float* __restrict__ mean,
                            const float* __restrict__ inv_std, float scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < n_vec; v += stride) {
    const unsigned int w = __ldg(x + v);
    int c = static_cast<int>((v * 4) % C);
    float r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // little-endian: byte q is element 4v + q
      r[q] = norm_one((w >> (8 * q)) & 0xffu, scale, __ldg(mean + c), __ldg(inv_std + c));
      c = (c + 1 == C) ? 0 : c + 1;
    }
    out[v] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
normalize_frames_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                        long long start, long long n, int C,
                        const float* __restrict__ mean, const float* __restrict__ inv_std,
                        float scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = start + (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int c = static_cast<int>(i % C);
    out[i] = norm_one(x[i], scale, __ldg(mean + c), __ldg(inv_std + c));
  }
}

unsigned int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// x: n uint8 elements, contiguous, channel-last with C channels; out: n f32.
// mean, inv_std: C f32 each, on the same device. Requires n >= 1, C >= 1.
// Returns cudaGetLastError() after the launches.
extern "C" int vct_normalize_frames(const void* x, void* out, long long n, int C,
                                    const void* mean, const void* inv_std, float scale,
                                    void* stream) {
  const auto* xp = static_cast<const uint8_t*>(x);
  auto* op = static_cast<float*>(out);
  const auto* mp = static_cast<const float*>(mean);
  const auto* sp = static_cast<const float*>(inv_std);
  auto s = static_cast<cudaStream_t>(stream);
  long long done = 0;
  const bool aligned = reinterpret_cast<uintptr_t>(xp) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(op) % 16 == 0;
  if (aligned && n >= 4) {
    const long long n_vec = n / 4;
    normalize_frames_vec_kernel<<<blocks_for(n_vec), kThreads, 0, s>>>(
        reinterpret_cast<const unsigned int*>(xp), reinterpret_cast<float4*>(op), n_vec, C, mp,
        sp, scale);
    done = n_vec * 4;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (done < n) {
    normalize_frames_kernel<<<blocks_for(n - done), kThreads, 0, s>>>(xp, op, done, n, C, mp, sp,
                                                                      scale);
  }
  return static_cast<int>(cudaGetLastError());
}
