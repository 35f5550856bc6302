// K3: the Mamba selective scan, forward.
//
// Replaces the TPU kernel of vct/ops/selective_scan_pallas.py
// (_scan_kernel inside _forward, entry selective_scan_pallas).
//
// For each batch element b and channel d, from h = 0:
//   h[n]  = exp(delta[t,d] * A[d,n]) * h[n] + (delta[t,d] * u[t,d]) * B[t,n]
//   y[t,d] = sum_n h[n] * C[t,n]
// With reverse, u and delta are read at L-1-t and y is written at L-1-t,
// while B and C keep forward time order (the reference's quirk). Any N >= 1.
//
// What bounds it on the H100. The bytes, each input read once and y written
// once, are 4 (3 B L D + 2 B L N + D N): 0.26 us at the deployed shape (B=32,
// L=60, D=16, N=32) and 3.8 us at the VideoMamba shape (B=2, L=256, D=2048,
// N=16) at 3.35 TB/s. Each state and step needs one expf, which issues one
// MUFU.EX2 on the special-function units, 16 a clock per SM: B L D N of them
// take 4.0 us at the VideoMamba shape (132 SMs at 1.98 GHz), more than its
// bytes. Beside each go about 13 other instructions (expf's range reduction,
// the update of h, y's product and sum) at one warp instruction a clock per
// scheduler: ~6.5 us there, the nearest floor. At the deployed shape none of
// these counts: a channel's recurrence is a chain of L dependent steps, and
// the launch and the first copy into shared memory take a few us.
//
// The design:
// * A channel's N states are spread over `lanes` lanes, S states a lane
//   (S = 1 or 2); the states' row of A and h stay in registers. Up to 32
//   lanes a channel sit in one warp (P = lanes, a power of two, several
//   channels a warp); above, a channel spans W = lanes/32 warps. Lanes past N
//   hold a = 0, h = 0 and read B = C = 0, so they add nothing. Two states a
//   lane share a lane's loads of u, delta and its share of the reduction of
//   y, but leave half the warps to hide each other's latency. The plan
//   (vct_scan_plan) takes S = 2 where B*D*lanes still give each SM scheduler
//   about two warps, else S = 1: one state a lane at the deployed shape
//   (P = 32, one warp a scheduler), two at the VideoMamba shape (P = 8);
//   timed against the other S at both (chip_smoke's selective_scan_plans).
//   N beyond 256 states a channel is walked in state tiles of lanes*S, one
//   after the other, y summed over the tiles in order.
// * Before the time loop a block (128 threads) copies its channels' u and
//   delta (at the reversed rows with reverse) and its batch element's B and
//   C into shared memory by cp.async, 16 bytes a copy where the rows allow,
//   zeros past the valid rows and columns, so the loop reads only shared
//   memory it wrote. The whole L at once up to 64 steps, else chunks of 64
//   (or fewer, to fit 96 KB), the next chunk's copy behind this chunk's
//   steps (double buffer), so that several blocks fit an SM at VideoMamba's
//   L = 256. The block size and the chunk are fields of the plan, so that
//   selective_scan_plans times 256-thread blocks and 32-step chunks beside
//   them.
// * The chain of a step is a multiply and an add per state (unfused, rounded
//   as the plain version rounds, so h is bit-equal to it): expf(dt*a),
//   dt*u*B and h*C of later steps do not depend on h. The loop over a group
//   of P steps is unrolled, so they issue while the chain runs. y's sum over
//   the P lanes of a warp is off the chain too: each lane keeps its partial
//   sum for P steps, then a butterfly transpose-reduce (P-1 shuffles for P
//   steps, against 5 a step for a shuffle sum per step, which timed 1.5-2.4x
//   slower) leaves step i's sum in lane i. The warps of a wide channel add
//   their sums in shared memory in a fixed order when y is written,
//   coalesced along d.
// expf (not __expf) keeps parity with the plain version.
#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 128;   // a block's threads, unless a channel takes more lanes
constexpr int kMaxTileStates = 256;  // lanes * S of one state tile
constexpr int kFillLanes = 32768;    // B*D*lanes that give each SM scheduler ~two warps
constexpr int kStepAlign = 32;       // chunks are multiples of this many steps (>= P)
constexpr int kMaxChunk = 64;        // steps a chunk when L takes several
constexpr size_t kSmemBudget = 96 * 1024;
constexpr int kMaxDevices = 64;

// A plan packs S (bits 0-3), the lanes a channel (bits 4-15), the block's
// threads / 64 (bits 16-19) and the most steps a chunk / 32 (bits 20-23).
struct Plan {
  int S, lanes, threads, chunk;
};

int encode(Plan p) {
  return p.S | (p.lanes << 4) | (p.threads / 64 << 16) | (p.chunk / kStepAlign << 20);
}
Plan decode(int code) {
  return {code & 15, (code >> 4) & 4095, (code >> 16 & 15) * 64, (code >> 20 & 15) * kStepAlign};
}

bool valid(Plan p) {
  const bool s_ok = p.S == 1 || p.S == 2;
  const bool lanes_ok = p.lanes >= 1 && (p.lanes <= 32 ? (p.lanes & (p.lanes - 1)) == 0
                                                       : p.lanes % 32 == 0);
  const bool block_ok = p.threads == 64 || p.threads == 128 || p.threads == 256;
  const bool chunk_ok = p.chunk % kStepAlign == 0 && p.chunk >= kStepAlign &&
                        p.chunk <= 8 * kStepAlign;
  return s_ok && lanes_ok && p.lanes * p.S <= kMaxTileStates && block_ok && chunk_ok;
}

// Lanes for m states of a channel: a power of two up to a warp, whole warps above.
int lanes_for(int m) {
  if (m > 32) return (m + 31) / 32 * 32;
  int p = 1;
  while (p < m) p *= 2;
  return p;
}

// S states a lane (0: the plan's choice), lanes as S gives them.
Plan choose(int batch, int D, int N, int S) {
  const auto lanes = [N](int s) {
    return lanes_for(min((max(N, 1) + s - 1) / s, kMaxTileStates / s));
  };
  if (S == 0) S = static_cast<long long>(batch) * D * lanes(2) >= kFillLanes ? 2 : 1;
  return {S, S == 1 || S == 2 ? lanes(S) : 0, kBlockThreads, kMaxChunk};
}

// The launch geometry of a plan at one shape; every count in floats.
struct Geometry {
  int lanes, warps, chans, threads;  // lanes and warps a channel, channels a block
  int CP, NP, NPp;                   // row pitch of u/delta/y, states a tile and its pitch
  int tiles, Lc, chunks, buffers;    // state tiles, steps a chunk, chunks, copy buffers
  size_t smem;                       // bytes
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

Geometry geometry(Plan p, int L, int N) {
  Geometry g;
  g.lanes = p.lanes;
  g.warps = p.lanes > 32 ? p.lanes / 32 : 1;
  g.chans = p.lanes >= p.threads ? 1 : p.threads / p.lanes;
  g.threads = g.chans * p.lanes;
  g.CP = round_up(g.chans, 4);
  g.NP = p.lanes * p.S;
  g.NPp = round_up(g.NP, 4);
  g.tiles = max(1, (N + g.NP - 1) / g.NP);
  const size_t row = 2 * g.CP + 2 * g.NPp, yrow = static_cast<size_t>(g.warps) * g.CP;
  const int whole = round_up(max(L, 1), kStepAlign);
  if (whole <= p.chunk && whole * (row + yrow) * 4 <= kSmemBudget) {
    g.Lc = whole, g.buffers = 1;
  } else {
    g.Lc = static_cast<int>(kSmemBudget / ((2 * row + yrow) * 4)) / kStepAlign * kStepAlign;
    g.Lc = min(g.Lc, p.chunk), g.buffers = 2;
    if (g.Lc < kStepAlign) g.Lc = kStepAlign, g.buffers = 1;
  }
  g.chunks = (max(L, 1) + g.Lc - 1) / g.Lc;
  g.smem = (g.buffers * g.Lc * row + g.Lc * yrow) * 4;
  return g;
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// dst[r][q] (pitch dp) = src[r*sp + q] for r < vrows, q < vcols, and 0 for
// the other r < rows, q < cols. vec: cols, vcols, dp and sp multiples of 4
// and src 16-byte aligned, so each thread copies 16 bytes at a time.
__device__ __forceinline__ void stage(float* dst, int dp, const float* src, long long sp, int rows,
                                      int vrows, int cols, int vcols, bool vec) {
  const int w = vec ? 4 : 1, cw = cols / w;
  for (int i = threadIdx.x; i < rows * cw; i += blockDim.x) {
    const int r = i / cw, q = (i - r * cw) * w;
    float* d = dst + r * dp + q;
    if (r < vrows && q < vcols) {
      if (vec) copy16(d, src + r * sp + q);
      else copy4(d, src + r * sp + q);
    } else if (vec) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      *d = 0.f;
    }
  }
}

// One step of a lane's S states; returns the lane's part of y.
template <int S>
__device__ __forceinline__ float step(float (&h)[S], const float (&a)[S], float dt, float uu,
                                      const float* sb, const float* sc) {
  float bv[S], cv[S];
  if constexpr (S == 2) {
    const float2 b2 = *reinterpret_cast<const float2*>(sb);
    const float2 c2 = *reinterpret_cast<const float2*>(sc);
    bv[0] = b2.x, bv[1] = b2.y, cv[0] = c2.x, cv[1] = c2.y;
  } else {
    bv[0] = *sb, cv[0] = *sc;
  }
  const float du = __fmul_rn(dt, uu);
  float part = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {  // rounded as the plain version rounds: h is bit-equal
    h[s] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, a[s])), h[s]), __fmul_rn(du, bv[s]));
    part = __fadd_rn(part, __fmul_rn(h[s], cv[s]));
  }
  return part;
}

// v[i]: this lane's part of step i's sum, i < P. Afterwards v[0] holds the
// sum over the P lanes (an aligned group of the warp) of step jj's parts.
// Level M halves the steps a lane holds: it keeps those whose bit M matches
// its own and receives its partner's parts of them. A recursion over M, so
// every index is a constant and v stays in registers.
template <int P, int M = P / 2>
__device__ __forceinline__ void transpose_reduce(float (&v)[P], int jj) {
  if constexpr (M >= 1) {
    const bool upper = (jj & M) != 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float send = upper ? v[i] : v[i + M];
      const float keep = upper ? v[i + M] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, M);
    }
    transpose_reduce<P, M / 2>(v, jj);
  }
}

template <int S, int P>
__global__ void __launch_bounds__(kMaxTileStates)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ delta,
            const float* __restrict__ A, const float* __restrict__ Bm,
            const float* __restrict__ Cm, float* __restrict__ y, int L, int D, int N,
            int reverse, Geometry g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int c = tid / g.lanes, j = tid - c * g.lanes;  // channel in the block, lane in the channel
  const int w = j >> 5, jj = j & (P - 1);             // warp in the channel, lane in the group
  const int b = blockIdx.y, d0 = blockIdx.x * g.chans, d = d0 + c;
  const int vc = min(g.chans, D - d0);  // channels of this block inside D
  const size_t buf = static_cast<size_t>(g.Lc) * (2 * g.CP + 2 * g.NPp);
  float* sY = smem + g.buffers * buf;
  const long long ud_pitch = reverse ? -static_cast<long long>(D) : D;
  const bool vec_ud = D % 4 == 0 && d0 % 4 == 0 && vc % 4 == 0 &&
                      ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(delta)) & 15) == 0;

  for (int tile = 0; tile < g.tiles; ++tile) {
    const int n0 = tile * g.NP, vn = max(0, min(g.NP, N - n0));
    const bool vec_bc = N % 4 == 0 && n0 % 4 == 0 && vn % 4 == 0 &&
                        ((reinterpret_cast<size_t>(Bm) | reinterpret_cast<size_t>(Cm)) & 15) == 0;
    float a[S], h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = j * S + s;
      a[s] = (d < D && n < vn) ? A[static_cast<long long>(d) * N + n0 + n] : 0.f;
      h[s] = 0.f;
    }
    auto issue = [&](int k) {
      float* base = smem + (k % g.buffers) * buf;
      const int t0 = k * g.Lc, steps = min(g.Lc, L - t0), rows = round_up(steps, P);
      const long long tu0 = static_cast<long long>(b) * L + (reverse ? L - 1 - t0 : t0);
      const long long tb0 = (static_cast<long long>(b) * L + t0) * N + n0;
      stage(base, g.CP, u + tu0 * D + d0, ud_pitch, rows, steps, g.CP, vc, vec_ud);
      stage(base + g.Lc * g.CP, g.CP, delta + tu0 * D + d0, ud_pitch, rows, steps, g.CP, vc,
            vec_ud);
      stage(base + 2 * g.Lc * g.CP, g.NPp, Bm + tb0, N, rows, steps, g.NPp, vn, vec_bc);
      stage(base + 2 * g.Lc * g.CP + g.Lc * g.NPp, g.NPp, Cm + tb0, N, rows, steps, g.NPp, vn,
            vec_bc);
      copy_commit();
    };
    issue(0);
    for (int k = 0; k < g.chunks; ++k) {
      const int t0 = k * g.Lc, steps = min(g.Lc, L - t0);
      const bool ahead = g.buffers == 2 && k + 1 < g.chunks;
      if (ahead) issue(k + 1);  // into the buffer chunk k-1 used
      if (g.buffers == 1 && k > 0) issue(k);
      if (ahead) copy_wait<1>();
      else copy_wait<0>();
      __syncthreads();  // chunk k is in shared memory; chunk k-1's y is out
      const float* base = smem + (k % g.buffers) * buf;
      const float* sU = base;
      const float* sD = base + g.Lc * g.CP;
      const float* sB = base + 2 * g.Lc * g.CP + j * S;
      const float* sC = sB + g.Lc * g.NPp;
      float* yw = sY + w * g.Lc * g.CP + c;
      for (int tb = 0; tb < steps; tb += P) {  // rows past steps are zeros: h stays
        float v[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int t = tb + i;
          v[i] = step<S>(h, a, sD[t * g.CP + c], sU[t * g.CP + c], sB + t * g.NPp,
                         sC + t * g.NPp);
        }
        transpose_reduce<P>(v, jj);
        yw[(tb + jj) * g.CP] = v[0];
      }
      __syncthreads();  // every warp's sums of chunk k are in sY; its buffer is free
      for (int i = tid; i < steps * vc; i += blockDim.x) {
        const int t = i / vc, cc = i - t * vc;
        float s = sY[t * g.CP + cc];
        for (int ww = 1; ww < g.warps; ++ww) s += sY[(ww * g.Lc + t) * g.CP + cc];
        const int tu = reverse ? L - 1 - (t0 + t) : t0 + t;
        float* dst = y + (static_cast<long long>(b) * L + tu) * D + d0 + cc;
        *dst = tile ? *dst + s : s;  // the same thread wrote it in the tile before
      }
    }
  }
}

template <int S, int P>
int launch(const float* u, const float* delta, const float* A, const float* Bm, const float* Cm,
           float* y, int batch, int L, int D, int N, int reverse, const Geometry& g,
           cudaStream_t stream) {
  auto* kernel = selective_scan_kernel<S, P>;
  // Once an instance and device: every geometry fits kSmemBudget.
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBudget));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((D + g.chans - 1) / g.chans, batch);
  kernel<<<grid, g.threads, g.smem, stream>>>(u, delta, A, Bm, Cm, y, L, D, N, reverse, g);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_p(const float* u, const float* delta, const float* A, const float* Bm,
             const float* Cm, float* y, int batch, int L, int D, int N, int reverse,
             const Geometry& g, cudaStream_t s) {
  switch (min(g.lanes, 32)) {
    case 1: return launch<S, 1>(u, delta, A, Bm, Cm, y, batch, L, D, N, reverse, g, s);
    case 2: return launch<S, 2>(u, delta, A, Bm, Cm, y, batch, L, D, N, reverse, g, s);
    case 4: return launch<S, 4>(u, delta, A, Bm, Cm, y, batch, L, D, N, reverse, g, s);
    case 8: return launch<S, 8>(u, delta, A, Bm, Cm, y, batch, L, D, N, reverse, g, s);
    case 16: return launch<S, 16>(u, delta, A, Bm, Cm, y, batch, L, D, N, reverse, g, s);
    default: return launch<S, 32>(u, delta, A, Bm, Cm, y, batch, L, D, N, reverse, g, s);
  }
}

}  // namespace

// The packed plan (see Plan) vct_selective_scan_fwd takes for a batch of D
// channels of N states, decided by these shapes alone. S, threads and chunk
// at 0 take the plan's choice; else S states a lane (1 or 2, lanes as S
// gives them), blocks of `threads` and chunks of at most `chunk` steps. -1
// for a plan that vct_selective_scan_fwd would refuse.
extern "C" int vct_scan_plan(int batch, int D, int N, int S, int threads, int chunk) {
  Plan p = choose(batch, D, N, S);
  if (threads) p.threads = threads;
  if (chunk) p.chunk = chunk;
  return valid(p) ? encode(p) : -1;
}

// u, delta, y: (batch, L, D); Bm, Cm: (batch, L, N); A: (D, N); all f32,
// contiguous; batch <= 65535. plan: a vct_scan_plan value.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// invalid plan).
extern "C" int vct_selective_scan_fwd(const void* u, const void* delta, const void* A,
                                      const void* Bm, const void* Cm, void* y, int batch, int L,
                                      int D, int N, int reverse, int plan, void* stream) {
  const Plan p = decode(plan);
  if (plan < 0 || !valid(p) || plan >> 24) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(p, L, N);
  const auto* up = static_cast<const float*>(u);
  const auto* dp = static_cast<const float*>(delta);
  const auto* ap = static_cast<const float*>(A);
  const auto* bp = static_cast<const float*>(Bm);
  const auto* cp = static_cast<const float*>(Cm);
  auto* yp = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (p.S) {
    case 1: return launch_p<1>(up, dp, ap, bp, cp, yp, batch, L, D, N, reverse, g, s);
    default: return launch_p<2>(up, dp, ap, bp, cp, yp, batch, L, D, N, reverse, g, s);
  }
}
