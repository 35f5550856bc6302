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
// What bounds it on the H100. Its bytes (five (B, L, D) and four (B, L, N)
// arrays, A and dA) take 0.5 us at the deployed shape (B=32, L=60, D=16,
// N=32) and its expf 0.24 us. What it cannot avoid is two dependent chains
// of L steps a channel, h forward and dh backward, and then sums across
// blocks. The first design (three passes over every step through L1, a
// shuffle sum a step, and three more launches to add partials) took
// 0.048 ms there. This one takes about 0.013 ms; clock stamps of its phases
// put a fifth of that in the first copy and the kernel's start, two fifths
// in the two walks, and the rest in the sums over channels and the last
// blocks' sums. At VideoMamba's shape (B=2, L=256, D=2048, N=16) it is
// issue-bound at two warps a scheduler: every shared-memory access needs
// its address computed (the pitches are per shape), and the last blocks'
// tree of dB/dC partials adds some 15 us.
//
// The design, one launch a call:
// * The forward's layout: a channel's N states over `lanes` lanes, S = 1 or
//   2 states a lane, A's row, h, the carry a_{t+1} dh_{t+1} and dA's sums in
//   registers; up to 32 lanes a channel share a warp, above that a channel
//   spans warps; lanes past N hold a = 0 and read B = C = 0. N beyond 256
//   states is walked in state tiles, in order. The plan (vct_scan_bwd_plan)
//   takes S as the forward does (S = 2 where B*D*lanes give each SM
//   scheduler about two warps), 128-thread blocks and chunks of 64 steps
//   (fewer where shared memory asks). Timed against S = 1 and 2 with 64-,
//   128- and 256-thread blocks, it was the fastest at the deployed and
//   VideoMamba shapes; 256 threads were 15% faster at N = 64 (B=4, D=16),
//   which no configuration runs yet.
// * Before a chunk's steps the block copies its channels' u, delta and gy
//   (the reversed rows with reverse) and its batch element's B and C into
//   shared memory by cp.async (16 bytes a copy where rows and pointers
//   allow), zeros past the valid rows and columns. Chunks walked backwards
//   are double-buffered: the earlier chunk's copy runs behind this one's
//   steps. Two blocks of VideoMamba's shape fit an SM.
// * Where L fits one chunk (the deployed L = 60) there are two chains: the
//   chunk's h_t is recomputed from h = 0 into shared memory, then walked
//   backwards. For longer L a first pass walks chunks 0..K-2 forward and
//   keeps h at the start of chunks 1..K-2 in the scratch (the last chunk's
//   in registers), then each chunk, latest first, recomputes its h from
//   there. h is rounded as the forward and the plain version round it
//   (expf, not __expf; unfused).
// * The reverse chain is dh = gy C + carry, carry = a dh; the expf, the
//   products with B, h_{t-1}, A and dt u hang off it. Steps go in groups of
//   8 whose shared-memory loads all issue before the group's chain and its
//   stores (the compiler cannot tell they do not alias). dh dt u overwrites
//   h_t in shared memory once step t no longer needs it.
// * du and ddt sum over a channel's states: each lane keeps its parts for a
//   group, a butterfly transpose-reduce (the forward's: 7 shuffles for 8
//   steps, then one a step more for each doubling of lanes past 8) leaves
//   step i's sum in lane i, the warps of a wide channel add theirs in
//   shared memory in a fixed order, and both are written once, coalesced
//   along d (a later state tile adds to what the same thread wrote).
// * dC and dB sum over d: after each chunk's recompute (dC) and walk (dB)
//   the block adds its channels in shared memory in a fixed order, each
//   thread 2 rows of 4 states at a time with every load in flight (a
//   branch per row had left one load in flight). Where a block holds every
//   channel of its batch element that is the result; else it is the
//   block's partial, and the channel groups of a batch element add their
//   partials in a fixed tree of fan-in 4: of a node's children the last to
//   finish (an integer counter, atomicAdd after __threadfence, set back to
//   zero by that block) adds them in order and goes on up. A flat sum by
//   the last group would read all G partials of L*N floats through one SM
//   (4 MB at VideoMamba's 128 groups); the tree reads 4*log4(G) on its
//   longest path. Fan-in 8 and 16 were no faster.
// * dA sums over b and t: a lane keeps its states' sums over t, a block
//   writes them as a partial, and the last of a channel group's batch
//   elements adds the partials in order of b; a block's first arrival at
//   the tree and at dA's counter share one fence. No float atomics: two
//   runs and a graph replay are bit-equal.
#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 128;   // a block's threads, unless a channel takes more lanes
constexpr int kMaxTileStates = 256;  // lanes * S of one state tile
constexpr int kFillLanes = 32768;    // B*D*lanes that give each SM scheduler ~two warps
constexpr int kGroup = 8;            // steps whose shared-memory loads issue together
constexpr int kMaxChunk = 64;        // steps a chunk, a multiple of kGroup
// Shared memory a block: two blocks of VideoMamba's shape (two 64-step
// buffers, its h) fit an SM's 228 KB with their 1 KB reserve each.
constexpr size_t kSmemBudget = 112 * 1024;
constexpr int kFan = 4;  // channel groups a node of the dB/dC tree adds
constexpr int kMaxDevices = 64;

// A plan packs S (bits 0-3), the lanes a channel (bits 4-15), the block's
// threads / 64 (bits 16-19) and the steps a chunk / 8 (bits 20-23).
struct Plan {
  int S, lanes, threads, chunk;
};

int encode(Plan p) {
  return p.S | (p.lanes << 4) | (p.threads / 64 << 16) | (p.chunk / kGroup << 20);
}

// Lanes for m states of a channel: a power of two up to a warp, whole warps above.
int lanes_for(int m) {
  if (m > 32) return (m + 31) / 32 * 32;
  int p = 1;
  while (p < m) p *= 2;
  return p;
}

Plan choose(int batch, int D, int N) {
  const auto lanes = [N](int s) { return lanes_for(min((N + s - 1) / s, kMaxTileStates / s)); };
  const int S = static_cast<long long>(batch) * D * lanes(2) >= kFillLanes ? 2 : 1;
  return {S, lanes(S), kBlockThreads, kMaxChunk};
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The launch geometry of a plan at one shape; every count in floats.
struct Geometry {
  int S, lanes, warps, chans, threads;  // lanes and warps a channel, channels a block
  int CP, NP, NPp, HP;                  // u/delta/gy row pitch, states a tile, its pitch, h row
  int tiles, Lc, chunks, buffers, groups;
  size_t smem;  // bytes
};

Geometry geometry(Plan p, int L, int D, int N) {
  Geometry g;
  g.S = p.S, g.lanes = p.lanes;
  g.warps = p.lanes > 32 ? p.lanes / 32 : 1;
  g.chans = p.lanes >= p.threads ? 1 : p.threads / p.lanes;
  g.threads = g.chans * p.lanes;
  g.CP = round_up(g.chans, 4);
  g.NP = p.lanes * p.S;
  g.NPp = round_up(g.NP, 4);
  g.HP = g.chans * g.NP;
  g.tiles = (N + g.NP - 1) / g.NP;
  g.groups = (D + g.chans - 1) / g.chans;
  // A staged row (u, delta, gy, B, C), and the rest a step takes: h (then
  // dh dt u) of every state of the block, and the per-warp state sums.
  const size_t row = 3 * g.CP + 2 * g.NPp, rest = g.HP + 2 * g.warps * g.CP;
  const int whole = round_up(L, kGroup);
  if (whole <= p.chunk && whole * (row + rest) * 4 <= kSmemBudget) {
    g.Lc = whole, g.buffers = 1;
  } else {
    g.Lc = static_cast<int>(kSmemBudget / ((2 * row + rest) * 4)) / kGroup * kGroup;
    g.Lc = min(g.Lc, p.chunk), g.buffers = 2;
    if (g.Lc < kGroup) g.Lc = kGroup, g.buffers = 1;
  }
  g.chunks = (L + g.Lc - 1) / g.Lc;
  if (g.chunks == 1) g.buffers = 1;
  g.smem = (g.buffers * g.Lc * row + g.Lc * rest) * 4;
  return g;
}

// Floats of each scratch part (each a multiple of 4, so every part stays
// 16-byte aligned) and the counters: h at the start of chunks 1..K-2, the
// dA partials (one a batch element), the dB/dC partials (one a channel
// group); a counter a (batch element, tree node) and one a channel group.
struct Scratch {
  long long ckpt, dA, dBC, counters;
};

Scratch scratch_of(const Geometry& g, int batch, int L, int D, int N) {
  const long long bdn = static_cast<long long>(batch) * D * N;
  const auto up4 = [](long long x) { return (x + 3) / 4 * 4; };
  Scratch s;
  s.ckpt = g.chunks > 2 ? up4((g.chunks - 2) * bdn) : 0;
  s.dA = batch > 1 ? up4(bdn) : 0;
  s.dBC = g.groups > 1 ? up4(2LL * batch * g.groups * L * N) : 0;
  s.counters = (g.groups > 1 ? static_cast<long long>(batch) * g.groups : 0) +
               (batch > 1 ? g.groups : 0);
  return s;
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
// and src 16-byte aligned, so each thread copies 16 bytes at a time. (The
// forward's, with each thread's (row, column) stepped, not divided out.)
__device__ __forceinline__ void stage(float* dst, int dp, const float* src, long long sp, int rows,
                                      int vrows, int cols, int vcols, bool vec) {
  const int w = vec ? 4 : 1, cw = cols / w;
  const int dr = blockDim.x / cw, dq = (blockDim.x - dr * cw) * w;
  int r = threadIdx.x / cw, q = (threadIdx.x - r * cw) * w;
  for (; r < rows; r += dr, q += dq) {
    if (q >= cols) q -= cols, ++r;
    if (r >= rows) break;
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

template <int S>
__device__ __forceinline__ void load_s(float (&v)[S], const float* p) {
  if constexpr (S == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int S>
__device__ __forceinline__ void store_s(float* p, const float (&v)[S]) {
  if constexpr (S == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}

// v[i]: this lane's part of step i's sum, i < P. Afterwards v[0] holds the
// sum over the P lanes (an aligned group of the warp) of step jj's parts
// (the forward's transpose-reduce).
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

// The sums over a channel's P lanes of kGroup steps' parts, v[i] this
// lane's part of step tb + i. Afterwards step tb + i's sum is in v[0] of
// lane i (P >= kGroup: the transpose within groups of kGroup lanes, then
// the groups added), or, for P < kGroup, in v[k P] of lane i - k P.
template <int P>
__device__ __forceinline__ void group_reduce(float (&v)[kGroup], int jj) {
  if constexpr (P >= kGroup) {
    transpose_reduce<kGroup>(v, jj);
#pragma unroll
    for (int o = kGroup; o < P; o <<= 1) v[0] += __shfl_xor_sync(kFull, v[0], o);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup / P; ++k)
      transpose_reduce<P>(*reinterpret_cast<float(*)[P]>(v + k * P), jj);
  }
}

// h through rows [0, rows) of a staged chunk (rows a multiple of kGroup),
// rounded as the forward rounds it, each step's h into hcol's row when
// kStore. A group's loads issue before its chain.
template <int S, bool kStore>
__device__ __forceinline__ void walk_forward(float (&h)[S], const float (&a)[S], const float* sD,
                                             const float* sU, const float* sB, float* hcol, int c,
                                             int CP, int NPp, int HP, int rows) {
#pragma unroll 1
  for (int tb = 0; tb < rows; tb += kGroup) {
    float dt[kGroup], uu[kGroup], bv[kGroup][S];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int t = tb + i;
      dt[i] = sD[t * CP + c], uu[i] = sU[t * CP + c];
      load_s<S>(bv[i], sB + t * NPp);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float du = __fmul_rn(dt[i], uu[i]);
#pragma unroll
      for (int s = 0; s < S; ++s)
        h[s] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt[i], a[s])), h[s]), __fmul_rn(du, bv[i][s]));
      if constexpr (kStore) store_s<S>(hcol + (tb + i) * HP, h);
    }
  }
}

// out[t * N + n] for rows t < steps and states n < vn of a chunk: the sum
// over the block's channels cc < vc, in order, of w[t * CP + cc] *
// x[t * HP + cc * NP + n] (kWeighted), or of x alone. A thread takes V
// states (V = 4: NP a multiple of 4) of R rows at once, every load of a
// channel in flight.
template <int V, int R, bool kWeighted>
__device__ __forceinline__ void channel_sums(const float* x, const float* w, float* out, int steps,
                                             int vc, int vn, int NP, int HP, int CP, int N) {
  const int NC = NP / V, across = min(NC, static_cast<int>(blockDim.x));
  const int rs = blockDim.x / across, col = threadIdx.x % across, row = threadIdx.x / across;
  if (row >= rs) return;
  for (int q = col; q < NC; q += across) {
    const int n = q * V;
    for (int r0 = row; r0 < steps; r0 += R * rs) {
      float acc[R][V];
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
      for (int cc = 0; cc < vc; ++cc) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          // rows past steps read the last row (no branch: all loads in
          // flight) and are not stored
          const int t = min(r0 + k * rs, steps - 1);
          const float* xp = x + t * HP + cc * NP + n;
          float xv[V];
          if constexpr (V == 4) {
            const float4 f = *reinterpret_cast<const float4*>(xp);
            xv[0] = f.x, xv[1] = f.y, xv[2] = f.z, xv[3] = f.w;
          } else {
            xv[0] = *xp;
          }
          const float wv = kWeighted ? w[t * CP + cc] : 1.f;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[k][e] = kWeighted ? fmaf(wv, xv[e], acc[k][e])
                                                            : acc[k][e] + xv[e];
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int t = r0 + k * rs;
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (t < steps && n + e < vn) out[static_cast<long long>(t) * N + n + e] = acc[k][e];
      }
    }
  }
}

// channel_sums with float4 where NP allows.
template <bool kWeighted>
__device__ __forceinline__ void sum_channels(const float* x, const float* w, float* out, int steps,
                                             int vc, int vn, int NP, int HP, int CP, int N) {
  if (NP % 4) channel_sums<1, 8, kWeighted>(x, w, out, steps, vc, vn, NP, HP, CP, N);
  else channel_sums<4, 2, kWeighted>(x, w, out, steps, vc, vn, NP, HP, CP, N);
}

// Every thread of the block calls it after writing what other blocks will
// read, at one or two counters (c1 may be null) with one fence. Bit 0 of
// the answer: this block's arrival at c0 is the n0-th (the last); bit 1:
// at c1, the n1-th. The last arrival sets a counter back to zero. flag: an
// int of shared memory.
__device__ __forceinline__ int arrive_last(int* c0, int n0, int* c1, int n1, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int f = 0;
    if (atomicAdd(c0, 1) == n0 - 1) *c0 = 0, f |= 1;  // ready for the next launch
    if (c1 && atomicAdd(c1, 1) == n1 - 1) *c1 = 0, f |= 2;
    *flag = f;
  }
  __syncthreads();
  const int f = *flag;
  if (f) __threadfence();
  return f;
}

__device__ __forceinline__ float4 operator+(float4 p, float4 q) {
  return make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w);
}

// x[e] = the sum over kids k < kids, in order, of x[k * stride + e] (slots
// other blocks wrote), for e < n; at the root into rb for e < LN and rc
// above. T: float4 where n, LN, stride and the pointers are multiples of 4
// floats, else float. kUnroll elements a thread at a time, every load in
// flight.
template <typename T, int kUnroll = 4>
__device__ __forceinline__ void sum_slots(float* x, long long stride, int kids, long long n,
                                          float* rb, float* rc, long long LN, bool root) {
  constexpr int w = sizeof(T) / sizeof(float);
  const long long step = static_cast<long long>(blockDim.x) * w;
  for (long long e0 = threadIdx.x * w; e0 < n; e0 += step * kUnroll) {
    T acc[kUnroll], v[kFan - 1][kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long e = e0 + i * step;
      if (e >= n) continue;
      acc[i] = __ldcg(reinterpret_cast<const T*>(x + e));
#pragma unroll
      for (int k = 1; k < kFan; ++k)
        if (k < kids) v[k - 1][i] = __ldcg(reinterpret_cast<const T*>(x + k * stride + e));
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long e = e0 + i * step;
      if (e >= n) continue;
#pragma unroll
      for (int k = 1; k < kFan; ++k)
        if (k < kids) acc[i] = acc[i] + v[k - 1][i];
      *reinterpret_cast<T*>(!root ? x + e : e < LN ? rb + e : rc + (e - LN)) = acc[i];
    }
  }
}

template <int S, int P>
__global__ void __launch_bounds__(kMaxTileStates, 1)
scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ gy,
                float* __restrict__ du, float* __restrict__ ddelta, float* __restrict__ dA,
                float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ ckpt,
                float* __restrict__ partA, float* __restrict__ partBC, int* __restrict__ counters,
                int batch, int L, int D, int N, int reverse, Geometry g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int c = tid / g.lanes, j = tid - c * g.lanes;  // channel in the block, lane in the channel
  const int w = j >> 5, jj = j & (P - 1);             // warp in the channel, lane in the group
  const int gi = blockIdx.x, b = blockIdx.y, d0 = gi * g.chans, d = d0 + c;
  const int vc = min(g.chans, D - d0);  // channels of this block inside D
  const int CP = g.CP, NP = g.NP, NPp = g.NPp, HP = g.HP, Lc = g.Lc;
  const int K = g.chunks, visits = 2 * K - 1;  // chunks 0..K-2 forward, then K-1..0 backward
  const size_t buf = static_cast<size_t>(Lc) * (3 * CP + 2 * NPp);
  float* sH = smem + g.buffers * buf;  // h_t, then dh_t dt_t u_t: Lc rows of HP
  float* sSB = sH + static_cast<size_t>(Lc) * HP;              // per warp: sum_n dh B
  float* sSA = sSB + static_cast<size_t>(g.warps) * Lc * CP;   // per warp: sum_n dh h_{t-1} a A
  const long long LN = static_cast<long long>(L) * N, DN = static_cast<long long>(D) * N;
  const long long ud_pitch = reverse ? -static_cast<long long>(D) : D;
  const bool vec_ud =
      D % 4 == 0 && d0 % 4 == 0 && vc % 4 == 0 &&
      ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(delta) |
        reinterpret_cast<size_t>(gy)) & 15) == 0;
  // dB and dC rows of this block: its partial slot, or the results
  float* outB = g.groups > 1 ? partBC + (static_cast<long long>(b) * g.groups + gi) * 2 * LN
                             : dB + b * LN;
  float* outC = g.groups > 1 ? outB + LN : dC + b * LN;
  float* hcol = sH + c * NP + j * S;  // this lane's states in a row of sH

  for (int tile = 0; tile < g.tiles; ++tile) {
    const int n0 = tile * NP, vn = min(NP, N - n0);
    const bool vec_bc = N % 4 == 0 && n0 % 4 == 0 && vn % 4 == 0 &&
                        ((reinterpret_cast<size_t>(Bm) | reinterpret_cast<size_t>(Cm)) & 15) == 0;
    float a[S], h[S], carry[S], dA_acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = j * S + s;
      a[s] = (d < D && n < vn) ? A[static_cast<long long>(d) * N + n0 + n] : 0.f;
      h[s] = carry[s] = dA_acc[s] = 0.f;
    }
    const auto chunk_of = [K](int q) { return q < K ? q : 2 * K - 2 - q; };
    const auto issue = [&](int q) {
      const int k = chunk_of(q);
      float* base = smem + (q % g.buffers) * buf;
      const int t0 = k * Lc, steps = min(Lc, L - t0), rows = round_up(steps, kGroup);
      const long long tu0 = static_cast<long long>(b) * L + (reverse ? L - 1 - t0 : t0);
      const long long tb0 = (static_cast<long long>(b) * L + t0) * N + n0;
      stage(base, CP, u + tu0 * D + d0, ud_pitch, rows, steps, CP, vc, vec_ud);
      stage(base + Lc * CP, CP, delta + tu0 * D + d0, ud_pitch, rows, steps, CP, vc, vec_ud);
      stage(base + 3 * Lc * CP, NPp, Bm + tb0, N, rows, steps, NPp, vn, vec_bc);
      if (q >= K - 1) {  // the backward walk reads gy and C too
        stage(base + 2 * Lc * CP, CP, gy + tu0 * D + d0, ud_pitch, rows, steps, CP, vc, vec_ud);
        stage(base + 3 * Lc * CP + Lc * NPp, NPp, Cm + tb0, N, rows, steps, NPp, vn, vec_bc);
      }
      copy_commit();
    };

    issue(0);
    for (int q = 0; q < visits; ++q) {
      if (g.buffers == 1 && q > 0) {
        __syncthreads();  // every thread is done with the buffer
        issue(q);
      }
      copy_wait<0>();
      __syncthreads();  // visit q is in shared memory; visit q-1's buffer is free
      if (g.buffers == 2 && q + 1 < visits) issue(q + 1);
      const int k = chunk_of(q);
      const int t0 = k * Lc, steps = min(Lc, L - t0), rows = round_up(steps, kGroup);
      const long long o0 = static_cast<long long>(t0) * N + n0;  // row t0, state n0 of dB, dC
      const float* base = smem + (q % g.buffers) * buf;
      const float* sU = base;
      const float* sD = base + Lc * CP;
      const float* sG = base + 2 * Lc * CP;
      const float* sB = base + 3 * Lc * CP + j * S;
      const float* sC = sB + Lc * NPp;

      if (q < K - 1) {  // first pass: h through chunk k, kept at chunk k+1's start
        walk_forward<S, false>(h, a, sD, sU, sB, hcol, c, CP, NPp, HP, rows);
        if (k + 1 < K - 1 && d < D) {  // chunk K-1 starts from h in registers
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int n = j * S + s;
            if (n < vn)
              ckpt[(static_cast<long long>(k) * batch + b) * DN + static_cast<long long>(d) * N +
                   n0 + n] = h[s];
          }
        }
        continue;
      }

      // Chunk k backwards. Its h_t, from its start h0, into sH (rows past
      // steps are zeros: h stays).
      float h0[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int n = j * S + s;
        if (k == K - 1) h0[s] = h[s];
        else if (k == 0 || d >= D || n >= vn) h0[s] = 0.f;
        else h0[s] = ckpt[(static_cast<long long>(k - 1) * batch + b) * DN +
                          static_cast<long long>(d) * N + n0 + n];
        h[s] = h0[s];
      }
      walk_forward<S, true>(h, a, sD, sU, sB, hcol, c, CP, NPp, HP, rows);
      __syncthreads();  // the chunk's h in sH
      // dC_t,n = sum_d gy h_t: the block's channels in order
      sum_channels<true>(sH, sG, outC + o0, steps, vc, vn, NP, HP, CP, N);
      __syncthreads();  // sH read: the walk overwrites it
#pragma unroll 1
      for (int tb = rows - kGroup; tb >= 0; tb -= kGroup) {
        float dt[kGroup], uu[kGroup], gv[kGroup], bv[kGroup][S], cv[kGroup][S], hp[kGroup][S];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {  // the group's loads, before its stores
          const int t = tb + i;
          dt[i] = sD[t * CP + c], uu[i] = sU[t * CP + c], gv[i] = sG[t * CP + c];
          load_s<S>(bv[i], sB + t * NPp);
          load_s<S>(cv[i], sC + t * NPp);
          if (t > 0) {
            load_s<S>(hp[i], hcol + (t - 1) * HP);
          } else {
#pragma unroll
            for (int s = 0; s < S; ++s) hp[i][s] = h0[s];
          }
        }
        float vb[kGroup], va[kGroup];
#pragma unroll
        for (int i = kGroup - 1; i >= 0; --i) {
          const float dtu = dt[i] * uu[i];
          float sb = 0.f, sa = 0.f, out[S];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float ea = expf(__fmul_rn(dt[i], a[s]));
            const float dh = fmaf(gv[i], cv[i][s], carry[s]);
            carry[s] = ea * dh;
            sb = fmaf(dh, bv[i][s], sb);
            const float e = dh * (hp[i][s] * ea);
            sa = fmaf(e, a[s], sa);
            dA_acc[s] = fmaf(e, dt[i], dA_acc[s]);
            out[s] = dh * dtu;
          }
          store_s<S>(hcol + (tb + i) * HP, out);  // h_t is no longer needed
          vb[i] = sb, va[i] = sa;
        }
        group_reduce<P>(vb, jj);
        group_reduce<P>(va, jj);
        if constexpr (P >= kGroup) {
          if (jj < kGroup) {
            sSB[(w * Lc + tb + jj) * CP + c] = vb[0];
            sSA[(w * Lc + tb + jj) * CP + c] = va[0];
          }
        } else {
#pragma unroll
          for (int k2 = 0; k2 < kGroup / P; ++k2) {
            sSB[(w * Lc + tb + k2 * P + jj) * CP + c] = vb[k2 * P];
            sSA[(w * Lc + tb + k2 * P + jj) * CP + c] = va[k2 * P];
          }
        }
      }
      __syncthreads();  // dh dt u in sH, the state sums in sSB, sSA
      // dB_t,n = sum_d dh dt u: the block's channels in order
      sum_channels<false>(sH, sG, outB + o0, steps, vc, vn, NP, HP, CP, N);
      // du, ddt: the warps' sums in order, coalesced along d
      for (int i = tid; i < steps * vc; i += blockDim.x) {
        const int t = i / vc, cc = i - t * vc;
        float sb = sSB[t * CP + cc], sa = sSA[t * CP + cc];
        for (int ww = 1; ww < g.warps; ++ww) {
          sb += sSB[(ww * Lc + t) * CP + cc];
          sa += sSA[(ww * Lc + t) * CP + cc];
        }
        const float vu = sD[t * CP + cc] * sb, vd = fmaf(sU[t * CP + cc], sb, sa);
        const int tu = reverse ? L - 1 - (t0 + t) : t0 + t;
        const long long o = (static_cast<long long>(b) * L + tu) * D + d0 + cc;
        du[o] = tile ? du[o] + vu : vu;  // the same thread wrote it in the tile before
        ddelta[o] = tile ? ddelta[o] + vd : vd;
      }
    }
    if (d < D) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int n = j * S + s;
        if (n < vn)
          (batch > 1 ? partA + static_cast<long long>(b) * DN : dA)[static_cast<long long>(d) * N +
                                                                     n0 + n] = dA_acc[s];
      }
    }
    __syncthreads();  // the next tile restages the buffers
  }

  // dA: the last of a channel group's batch elements adds their partials in
  // order of b. dB, dC: the channel groups' partials in a fixed tree of
  // fan-in kFan. The first arrivals of both share one fence.
  __shared__ int flag;  // arrive_last's answer
  const long long trees = g.groups > 1 ? static_cast<long long>(batch) * g.groups : 0;
  int* cntA = batch > 1 ? counters + trees + gi : nullptr;
  const auto add_dA = [&]() {
    constexpr int kLoads = 32;  // in flight a thread
    for (int e = tid; e < vc * N; e += blockDim.x) {
      const long long o = static_cast<long long>(d0) * N + e;
      float s = 0.f;
      for (int b0 = 0; b0 < batch; b0 += kLoads) {
        float v[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k)
          if (b0 + k < batch) v[k] = __ldcg(partA + (b0 + k) * DN + o);
#pragma unroll
        for (int k = 0; k < kLoads; ++k)
          if (b0 + k < batch) s += v[k];
      }
      dA[o] = s;
    }
  };
  const bool vec = LN % 4 == 0 &&
                   ((reinterpret_cast<size_t>(dB) | reinterpret_cast<size_t>(dC)) & 15) == 0;
  float* slots = partBC + static_cast<long long>(b) * g.groups * 2 * LN;
  int node = gi;
  for (int span = 1; span < g.groups; span *= kFan) {  // span: groups a child covers
    node /= kFan;
    const int first = node * span * kFan, kids = min(kFan, (g.groups - first + span - 1) / span);
    if (kids == 1) continue;  // an only child's sum goes up as it is
    // the node's counter: at its second child's first group, which no other node has
    const int f = arrive_last(counters + static_cast<long long>(b) * g.groups + first + span, kids,
                              cntA, batch, &flag);
    if (f & 2) add_dA();
    cntA = nullptr;
    if (!(f & 1)) return;
    const bool root = span * kFan >= g.groups;
    float *x = slots + first * 2 * LN, *rb = dB + b * LN, *rc = dC + b * LN;
    if (vec) sum_slots<float4>(x, span * 2 * LN, kids, 2 * LN, rb, rc, LN, root);
    else sum_slots<float>(x, span * 2 * LN, kids, 2 * LN, rb, rc, LN, root);
  }
  if (cntA && arrive_last(cntA, batch, nullptr, 0, &flag)) add_dA();
}

template <int S, int P>
int launch(const float* u, const float* delta, const float* A, const float* Bm, const float* Cm,
           const float* gy, float* du, float* ddelta, float* dA, float* dB, float* dC,
           float* scratch, int* counters, int batch, int L, int D, int N, int reverse,
           const Geometry& g, const Scratch& sc, cudaStream_t stream) {
  auto* kernel = scan_bwd_kernel<S, P>;
  // Once an instance and device: every geometry fits kSmemBudget, and the
  // carveout that leaves room for two such blocks an SM.
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !attr_set[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBudget));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev].store(true, std::memory_order_relaxed);
  }
  float* ckpt = scratch;
  float* partA = ckpt + sc.ckpt;
  float* partBC = partA + sc.dA;
  const dim3 grid(g.groups, batch);
  kernel<<<grid, g.threads, g.smem, stream>>>(u, delta, A, Bm, Cm, gy, du, ddelta, dA, dB, dC,
                                              ckpt, partA, partBC, counters, batch, L, D, N,
                                              reverse, g);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int batch, int L, int D, int N) {
  return batch >= 1 && batch <= 65535 && L >= 1 && D >= 1 && N >= 1;
}

}  // namespace

// The packed plan (see Plan) vct_selective_scan_bwd takes for these shapes,
// decided by them alone; its chunk is the steps a chunk at this L. -1 for a
// shape the kernel does not take.
extern "C" int vct_scan_bwd_plan(int batch, int L, int D, int N) {
  if (!valid_shape(batch, L, D, N)) return -1;
  Plan p = choose(batch, D, N);
  p.chunk = geometry(p, L, D, N).Lc;
  return encode(p);
}

// Floats of the scratch vct_selective_scan_bwd needs (0: none).
extern "C" long long vct_selective_scan_bwd_scratch(int batch, int L, int D, int N) {
  if (!valid_shape(batch, L, D, N)) return -1;
  const Plan p = choose(batch, D, N);
  const Scratch s = scratch_of(geometry(p, L, D, N), batch, L, D, N);
  return s.ckpt + s.dA + s.dBC;
}

// int32 counters vct_selective_scan_bwd needs (0: none). They must be zero
// before a launch, and each launch leaves them zero.
extern "C" long long vct_selective_scan_bwd_counters(int batch, int L, int D, int N) {
  if (!valid_shape(batch, L, D, N)) return -1;
  const Plan p = choose(batch, D, N);
  return scratch_of(geometry(p, L, D, N), batch, L, D, N).counters;
}

// u, delta, gy, du, ddelta: (batch, L, D); A, dA: (D, N); Bm, Cm, dB, dC:
// (batch, L, N); all f32, contiguous. scratch: vct_selective_scan_bwd_scratch
// floats, counters: vct_selective_scan_bwd_counters int32s, zero (either may
// be null where it needs none). batch <= 65535; L, D, N >= 1. One launch.
// Returns cudaGetLastError() after it, or cudaErrorInvalidValue for a shape
// it does not take or a missing scratch.
extern "C" int vct_selective_scan_bwd(const void* u, const void* delta, const void* A,
                                      const void* Bm, const void* Cm, const void* gy, void* du,
                                      void* ddelta, void* dA, void* dB, void* dC, void* scratch,
                                      void* counters, int batch, int L, int D, int N, int reverse,
                                      void* stream) {
  if (!valid_shape(batch, L, D, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = choose(batch, D, N);
  const Geometry g = geometry(p, L, D, N);
  const Scratch sc = scratch_of(g, batch, L, D, N);
  if ((sc.ckpt + sc.dA + sc.dBC > 0 && scratch == nullptr) ||
      (sc.counters > 0 && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* up = static_cast<const float*>(u);
  const auto* dp = static_cast<const float*>(delta);
  const auto* ap = static_cast<const float*>(A);
  const auto* bp = static_cast<const float*>(Bm);
  const auto* cp = static_cast<const float*>(Cm);
  const auto* gp = static_cast<const float*>(gy);
  auto* dup = static_cast<float*>(du);
  auto* ddp = static_cast<float*>(ddelta);
  auto* dap = static_cast<float*>(dA);
  auto* dbp = static_cast<float*>(dB);
  auto* dcp = static_cast<float*>(dC);
  auto* sp = static_cast<float*>(scratch);
  auto* cn = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
#define VCT_BWD_ARGS up, dp, ap, bp, cp, gp, dup, ddp, dap, dbp, dcp, sp, cn, batch, L, D, N, \
                     reverse, g, sc, s
#define VCT_BWD_CASES(S)                                  \
  switch (min(g.lanes, 32)) {                             \
    case 1: return launch<S, 1>(VCT_BWD_ARGS);            \
    case 2: return launch<S, 2>(VCT_BWD_ARGS);            \
    case 4: return launch<S, 4>(VCT_BWD_ARGS);            \
    case 8: return launch<S, 8>(VCT_BWD_ARGS);            \
    case 16: return launch<S, 16>(VCT_BWD_ARGS);          \
    default: return launch<S, 32>(VCT_BWD_ARGS);          \
  }
  if (g.S == 1) VCT_BWD_CASES(1)
  VCT_BWD_CASES(2)
#undef VCT_BWD_CASES
#undef VCT_BWD_ARGS
}
