// K1: per-transition SAD / flow-proxy scores of consecutive uint8 frames.
//
// Replaces the TPU kernels of vct/ops/pair_scores_pallas.py::pair_scores
// (_clip_kernel, _blocked_kernel, math in _chunk_scores).
//
// out[b, t] = sum over the frame of |x[b,t+1] - x[b,t]|      (sad)
//           = sum over the frame of (x[b,t+1] - x[b,t])^2    (flow)
//
// Bound on the H100: bytes. The work is a handful of integer operations per
// byte read, so the least time is one read of every frame at 3.35 TB/s.
// Design for that:
//   * one block owns one clip's chunk of kChunk transitions and walks its
//     kChunk + 1 frames in time order, so each frame is read from device
//     memory once (plus one shared boundary frame per chunk);
//   * each thread owns a fixed set of 16-byte words of the frame and keeps
//     the previous frame's word in registers, so nothing is staged in shared
//     memory and every load is a coalesced 16-byte vector load;
//   * per-byte |b-a| comes from __vsadu4 (sad) or __vabsdiffu4 + __dp4a
//     (flow), summed exactly in 64-bit integers and converted to f32 once,
//     so sad is bit-exact and flow is the correctly rounded exact sum;
//   * frames whose size is not a multiple of 16 bytes, or whose base is not
//     16-byte aligned (C=1, odd H*W*C, offset views), take a byte-wise path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // transitions per block

template <bool kSquare>
__device__ __forceinline__ unsigned int word_score(unsigned int a, unsigned int b) {
  if (kSquare) {
    const unsigned int d = __vabsdiffu4(a, b);
    return __dp4a(d, d, 0u);  // <= 4 * 255^2
  }
  return __vsadu4(a, b);  // <= 4 * 255
}

template <bool kSquare>
__device__ __forceinline__ unsigned int vec_score(const uint4& a, const uint4& b) {
  return word_score<kSquare>(a.x, b.x) + word_score<kSquare>(a.y, b.y) +
         word_score<kSquare>(a.z, b.z) + word_score<kSquare>(a.w, b.w);
}

template <bool kSquare, bool kVec>
__global__ void __launch_bounds__(kThreads)
pair_scores_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                   int L, long long frame_bytes) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kChunk;
  const int nt = min(kChunk, L - 1 - t0);
  const uint8_t* first = x + ((long long)b * L + t0) * frame_bytes;

  unsigned long long acc[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) acc[k] = 0ull;

  if (kVec) {
    const long long nvec = frame_bytes / 16;
    const uint4* base = reinterpret_cast<const uint4*>(first);
    for (long long v = threadIdx.x; v < nvec; v += kThreads) {
      uint4 prev = __ldg(base + v);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < nt) {
          const uint4 cur = __ldg(base + (long long)(k + 1) * nvec + v);
          acc[k] += vec_score<kSquare>(prev, cur);
          prev = cur;
        }
      }
    }
  } else {
    for (long long i = threadIdx.x; i < frame_bytes; i += kThreads) {
      int prev = first[i];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < nt) {
          const int cur = first[(long long)(k + 1) * frame_bytes + i];
          const int d = cur - prev;
          acc[k] += kSquare ? (unsigned long long)(d * d) : (unsigned long long)abs(d);
          prev = cur;
        }
      }
    }
  }

  __shared__ unsigned long long partial[kChunk][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    unsigned long long s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) partial[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < nt) {
    unsigned long long s = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[threadIdx.x][w];
    out[(long long)b * (L - 1) + t0 + threadIdx.x] = static_cast<float>(s);
  }
}

template <bool kSquare>
void launch(const uint8_t* x, float* out, int B, int L, long long frame_bytes,
            cudaStream_t stream) {
  const dim3 grid((L - 1 + kChunk - 1) / kChunk, B);
  const bool vec = frame_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec) {
    pair_scores_kernel<kSquare, true><<<grid, kThreads, 0, stream>>>(x, out, L, frame_bytes);
  } else {
    pair_scores_kernel<kSquare, false><<<grid, kThreads, 0, stream>>>(x, out, L, frame_bytes);
  }
}

}  // namespace

// x: (B, L, frame_bytes) uint8, contiguous; out: (B, L-1) f32.
// Requires B >= 1, L >= 2, frame_bytes >= 1, B <= 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int vct_pair_scores(const void* x, void* out, int B, int L,
                               long long frame_bytes, int square, void* stream) {
  const auto* xp = static_cast<const uint8_t*>(x);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (square) {
    launch<true>(xp, op, B, L, frame_bytes, s);
  } else {
    launch<false>(xp, op, B, L, frame_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
