// K3: the Mamba selective scan, forward.
//
// Replaces the TPU kernel of vct/ops/selective_scan_pallas.py
// (_scan_kernel inside _forward, entry selective_scan_pallas).
//
// For each batch element b and channel d, from h = 0:
//   h[n]  = exp(delta[t,d] * A[d,n]) * h[n] + (delta[t,d] * u[t,d]) * B[t,n]
//   y[t,d] = sum_n h[n] * C[t,n]
// With reverse, u and delta are read at L-1-t and y is written at L-1-t,
// while B and C keep forward time order (the reference's quirk).
//
// Bound on the H100: neither bytes nor operations at the serving shape
// (B=32, L=60, D=16, N=32: under 1 MB and ~6 MFLOP), but the L-step
// dependency chain of each channel and the launch latency. Design for
// that, kept simple:
//   * one thread per (b, d) channel; its N states and its row of A stay in
//     registers (N is a template parameter, 16 or 32), and the L loop runs
//     inside the thread, so the recurrence never touches memory;
//   * B_t and C_t (N floats each, shared by every d of one b) are staged in
//     shared memory kSteps time steps at a time and read as broadcasts;
//   * u, delta and y are read and written once, coalesced along d.
// expf (not __expf) keeps parity with the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 64;       // time steps of B and C staged per chunk
constexpr int kMaxThreads = 128;

template <int N>
__global__ void __launch_bounds__(kMaxThreads)
selective_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, float* __restrict__ y,
                          int L, int D, int reverse) {
  __shared__ float sB[kSteps][N];
  __shared__ float sC[kSteps][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = d < D;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float* Bb = Bm + (long long)b * L * N;
  const float* Cb = Cm + (long long)b * L * N;

  for (int t0 = 0; t0 < L; t0 += kSteps) {
    const int steps = min(kSteps, L - t0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < steps * N; i += blockDim.x) {
      sB[i / N][i % N] = Bb[(long long)t0 * N + i];
      sC[i / N][i % N] = Cb[(long long)t0 * N + i];
    }
    __syncthreads();
    if (active) {
      for (int s = 0; s < steps; ++s) {
        const int t = t0 + s;
        const int tu = reverse ? L - 1 - t : t;
        const long long off = ((long long)b * L + tu) * D + d;
        const float dt = delta[off];
        const float du = dt * u[off];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dt * a[n]) * h[n] + du * sB[s][n];
          acc += h[n] * sC[s][n];
        }
        y[off] = acc;
      }
    }
  }
}

template <int N>
void launch(const float* u, const float* delta, const float* A, const float* Bm,
            const float* Cm, float* y, int batch, int L, int D, int reverse,
            cudaStream_t stream) {
  const int threads = min(kMaxThreads, (D + 31) / 32 * 32);
  const dim3 grid((D + threads - 1) / threads, batch);
  selective_scan_fwd_kernel<N><<<grid, threads, 0, stream>>>(u, delta, A, Bm, Cm, y, L, D, reverse);
}

}  // namespace

// u, delta, y: (batch, L, D); Bm, Cm: (batch, L, N); A: (D, N); all f32,
// contiguous. N must be 16 or 32; batch <= 65535.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an N without an instance).
extern "C" int vct_selective_scan_fwd(const void* u, const void* delta, const void* A,
                                      const void* Bm, const void* Cm, void* y,
                                      int batch, int L, int D, int N, int reverse,
                                      void* stream) {
  const auto* up = static_cast<const float*>(u);
  const auto* dp = static_cast<const float*>(delta);
  const auto* ap = static_cast<const float*>(A);
  const auto* bp = static_cast<const float*>(Bm);
  const auto* cp = static_cast<const float*>(Cm);
  auto* yp = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: launch<16>(up, dp, ap, bp, cp, yp, batch, L, D, reverse, s); break;
    case 32: launch<32>(up, dp, ap, bp, cp, yp, batch, L, D, reverse, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
