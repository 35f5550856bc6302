// K3 backward: the Mamba selective scan in reverse time.
//
// vct computes this gradient with no Pallas kernel: its custom_vjp
// (vct/ops/selective_scan_pallas.py _scan_op, _scan_bwd) differentiates the
// plain-JAX associative scan. Here it is a kernel so that training on the
// card runs no plain version.
//
// The forward (selective_scan.cu), for batch b, channel d, state n, from
// h = 0: a_t = exp(dt_t A_n), h_t = a_t h_{t-1} + (dt_t u_t) B_t,n,
// y_t = sum_n h_t C_t,n. Given gy, with dh_t the gradient reaching h_t:
//   dh_t   = gy_t C_t,n + a_{t+1} dh_{t+1}
//   du_t   = dt_t sum_n dh_t B_t,n
//   ddt_t  = u_t sum_n dh_t B_t,n + sum_n dh_t h_{t-1} a_t A_n
//   dA_n   = sum_{b,t} dh_t h_{t-1} a_t dt_t
//   dB_t,n = sum_d dh_t dt_t u_t,     dC_t,n = sum_d gy_t h_t.
// With reverse, u, dt, gy, du and ddt are read and written at L-1-t while B,
// C, dB and dC keep forward time order (the reference's quirk, as in the
// forward).
//
// The design, simple and deterministic:
// * A thread per (channel, state) in blocks of 128 threads: P lanes a
//   channel (a power of two up to 32, so a channel's lanes share a warp),
//   128/P channels a block, a block per (channel group g, batch b); N beyond
//   32 is walked in state tiles of P, one after the other.
// * h_{t-1} is recomputed, not stored by the forward: pass 1 runs the
//   forward recurrence (rounded as the forward rounds it) and keeps h at the
//   start of every 32-step chunk in a scratch of (B, D, N, chunks) floats;
//   pass 2 walks the chunks backwards, recomputes a chunk's h into shared
//   memory from its checkpoint, then walks its steps backwards carrying
//   a_{t+1} dh_{t+1} in a register.
// * Sums over a channel's states (du, ddt) are xor-shuffles among its P
//   lanes each step; a later state tile adds to what the earlier wrote (the
//   same thread, in order). Sums over channels and batch cross blocks, so no
//   float atomics: a block sums its channels' dB, dC terms of a chunk in
//   shared memory in a fixed order into per-group partials (G, B, L, N), dA
//   into per-batch partials (B, D, N), and a second kernel adds the partials
//   in index order. Two runs, and a graph replay, are bit-equal.
//
// What bounds it on the H100: at the deployed shape (B=32, L=60, D=16,
// N=32) the bytes (its inputs once, its outputs once) take under a
// microsecond; the chain of L dependent steps in each pass, each an expf, a
// few loads and shuffles, takes several microseconds, and the launches of
// the three kernels a few more. expf (not __expf) keeps parity with the
// plain version.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kChunk = 32;  // steps a chunk keeps in shared memory

__host__ __device__ inline int lanes_for(int N) {
  int p = 1;
  while (p < N && p < 32) p *= 2;
  return p;
}

template <int P>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ gy,
                float* __restrict__ du, float* __restrict__ ddelta, float* __restrict__ dA_part,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                float* __restrict__ ckpt, int batch, int L, int D, int N, int reverse) {
  __shared__ float s_h[kChunk * kThreads];   // h_t of the chunk, a column a thread
  __shared__ float s_db[kChunk * kThreads];  // dh dt u of the chunk's steps
  __shared__ float s_dc[kChunk * kThreads];  // gy h
  constexpr int kChans = kThreads / P;
  const int tid = threadIdx.x, c = tid / P, j = tid % P;
  const int g = blockIdx.x, b = blockIdx.y, d = g * kChans + c;
  const bool dvalid = d < D;
  const int tiles = (N + P - 1) / P, chunks = (L + kChunk - 1) / kChunk;
  const long long rows = static_cast<long long>(b) * L;  // row (b, 0) of (B, L, *)
  auto tu = [&](int t) { return reverse ? L - 1 - t : t; };

  for (int tile = 0; tile < tiles; ++tile) {
    const int n = tile * P + j;
    const bool valid = dvalid && n < N;
    const float a = valid ? A[static_cast<long long>(d) * N + n] : 0.f;
    float* ck = ckpt + ((static_cast<long long>(b) * D + (dvalid ? d : 0)) * N +
                        (valid ? n : 0)) * chunks;
    // Pass 1: the forward recurrence, h at the start of each chunk.
    float h = 0.f;
    for (int t = 0; t < L; ++t) {
      if (valid && t % kChunk == 0) ck[t / kChunk] = h;
      const long long r = rows + tu(t);
      const float dt = dvalid ? delta[r * D + d] : 0.f;
      const float uu = dvalid ? u[r * D + d] : 0.f;
      const float bv = valid ? Bm[(rows + t) * N + n] : 0.f;
      h = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, a)), h), __fmul_rn(__fmul_rn(dt, uu), bv));
    }
    // Pass 2: the chunks backwards.
    float carry = 0.f, dA_acc = 0.f;
    for (int k = chunks - 1; k >= 0; --k) {
      const int t0 = k * kChunk, steps = min(kChunk, L - t0);
      const float h0 = valid ? ck[k] : 0.f;
      h = h0;
      for (int i = 0; i < steps; ++i) {
        const long long r = rows + tu(t0 + i);
        const float dt = dvalid ? delta[r * D + d] : 0.f;
        const float uu = dvalid ? u[r * D + d] : 0.f;
        const float bv = valid ? Bm[(rows + t0 + i) * N + n] : 0.f;
        h = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, a)), h), __fmul_rn(__fmul_rn(dt, uu), bv));
        s_h[i * kThreads + tid] = h;
      }
      for (int i = steps - 1; i >= 0; --i) {
        const int t = t0 + i;
        const long long r = rows + tu(t);
        const float dt = dvalid ? delta[r * D + d] : 0.f;
        const float uu = dvalid ? u[r * D + d] : 0.f;
        const float gv = dvalid ? gy[r * D + d] : 0.f;
        const float bv = valid ? Bm[(rows + t) * N + n] : 0.f;
        const float cv = valid ? Cm[(rows + t) * N + n] : 0.f;
        const float ea = expf(__fmul_rn(dt, a));
        const float hp = i ? s_h[(i - 1) * kThreads + tid] : h0;
        const float ht = s_h[i * kThreads + tid];
        const float dh = gv * cv + carry;
        const float dha = dh * hp * ea;
        s_db[i * kThreads + tid] = dh * (dt * uu);
        s_dc[i * kThreads + tid] = gv * ht;
        dA_acc += dha * dt;
        carry = ea * dh;
        const float sb = lane_sum<P>(dh * bv);
        const float sa = lane_sum<P>(dha * a);
        if (j == 0 && dvalid) {
          const float vu = sb * dt, vd = sb * uu + sa;
          du[r * D + d] = tile ? du[r * D + d] + vu : vu;
          ddelta[r * D + d] = tile ? ddelta[r * D + d] + vd : vd;
        }
      }
      __syncthreads();  // the chunk's s_db, s_dc complete
      for (int q = tid; q < steps * P; q += kThreads) {
        const int i = q / P, jj = q - i * P, nn = tile * P + jj;
        float vb = 0.f, vc = 0.f;
        for (int cc = 0; cc < kChans; ++cc) {
          vb += s_db[i * kThreads + cc * P + jj];
          vc += s_dc[i * kThreads + cc * P + jj];
        }
        if (nn < N) {
          const long long o = ((static_cast<long long>(g) * batch + b) * L + t0 + i) * N + nn;
          dB_part[o] = vb;
          dC_part[o] = vc;
        }
      }
      __syncthreads();  // s_h, s_db, s_dc free for the next chunk
    }
    if (valid) dA_part[(static_cast<long long>(b) * D + d) * N + n] = dA_acc;
  }
}

// out[i] = sum over p < parts, in order, of part[p * n + i].
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 long long n, int parts) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[p * n + i];
    out[i] = s;
  }
}

int sum_parts(const float* part, float* out, long long n, int parts, cudaStream_t s) {
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  sum_parts_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(part, out, n,
                                                                                   parts);
  return static_cast<int>(cudaGetLastError());
}

struct Layout {
  int P, groups, chunks;
  long long ckpt, dA, dBC;  // floats of each scratch part
};

Layout layout(int batch, int L, int D, int N) {
  Layout l;
  l.P = lanes_for(N);
  l.groups = (D + kThreads / l.P - 1) / (kThreads / l.P);
  l.chunks = (L + kChunk - 1) / kChunk;
  l.ckpt = static_cast<long long>(batch) * D * N * l.chunks;
  l.dA = static_cast<long long>(batch) * D * N;
  l.dBC = static_cast<long long>(l.groups) * batch * L * N;
  return l;
}

template <int P>
int launch(const float* u, const float* delta, const float* A, const float* Bm, const float* Cm,
           const float* gy, float* du, float* ddelta, float* dA_part, float* dB_part,
           float* dC_part, float* ckpt, int batch, int L, int D, int N, int reverse,
           const Layout& l, cudaStream_t s) {
  scan_bwd_kernel<P><<<dim3(l.groups, batch), kThreads, 0, s>>>(
      u, delta, A, Bm, Cm, gy, du, ddelta, dA_part, dB_part, dC_part, ckpt, batch, L, D, N,
      reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the scratch vct_selective_scan_bwd needs.
extern "C" long long vct_selective_scan_bwd_scratch(int batch, int L, int D, int N) {
  const Layout l = layout(batch, L, D, N);
  return l.ckpt + l.dA + 2 * l.dBC;
}

// u, delta, gy, du, ddelta: (batch, L, D); A, dA: (D, N); Bm, Cm, dB, dC:
// (batch, L, N); scratch: vct_selective_scan_bwd_scratch floats. All f32,
// contiguous; batch <= 65535, L, D, N >= 1. Three launches: the reverse
// scan, then the sums of the dB, dC and dA partials. Returns
// cudaGetLastError() after the last launch, or the first error.
extern "C" int vct_selective_scan_bwd(const void* u, const void* delta, const void* A,
                                      const void* Bm, const void* Cm, const void* gy, void* du,
                                      void* ddelta, void* dA, void* dB, void* dC, void* scratch,
                                      int batch, int L, int D, int N, int reverse, void* stream) {
  const Layout l = layout(batch, L, D, N);
  auto* ckpt = static_cast<float*>(scratch);
  float* dA_part = ckpt + l.ckpt;
  float* dB_part = dA_part + l.dA;
  float* dC_part = dB_part + l.dBC;
  const auto* up = static_cast<const float*>(u);
  const auto* dp = static_cast<const float*>(delta);
  const auto* ap = static_cast<const float*>(A);
  const auto* bp = static_cast<const float*>(Bm);
  const auto* cp = static_cast<const float*>(Cm);
  const auto* gp = static_cast<const float*>(gy);
  auto* dup = static_cast<float*>(du);
  auto* ddp = static_cast<float*>(ddelta);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  switch (l.P) {
#define VCT_BWD_CASE(P)                                                                          \
  case P:                                                                                        \
    err = launch<P>(up, dp, ap, bp, cp, gp, dup, ddp, dA_part, dB_part, dC_part, ckpt, batch, L, \
                    D, N, reverse, l, s);                                                        \
    break;
    VCT_BWD_CASE(1) VCT_BWD_CASE(2) VCT_BWD_CASE(4) VCT_BWD_CASE(8) VCT_BWD_CASE(16)
    VCT_BWD_CASE(32)
#undef VCT_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  const long long nbc = static_cast<long long>(batch) * L * N;
  if ((err = sum_parts(dB_part, static_cast<float*>(dB), nbc, l.groups, s))) return err;
  if ((err = sum_parts(dC_part, static_cast<float*>(dC), nbc, l.groups, s))) return err;
  return sum_parts(dA_part, static_cast<float*>(dA), static_cast<long long>(D) * N, batch, s);
}
