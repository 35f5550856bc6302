// K1: per-transition SAD / flow-proxy scores of consecutive uint8 frames.
//
// Replaces the TPU kernels of vct/ops/pair_scores_pallas.py::pair_scores
// (_clip_kernel, _blocked_kernel, math in _chunk_scores).
//
// out[b, t] = sum over the frame of |x[b,t+1] - x[b,t]|      (sad)
//           = sum over the frame of (x[b,t+1] - x[b,t])^2    (flow)
//
// Bound on the H100: bytes. The work is a handful of integer operations per
// 16 bytes read, so the least time is one read of every frame at 3.35 TB/s.
// What stands between a launch and that bound depends on the batch. The
// served path scores one video at a time (B=1): there the launch is short,
// and what counts is to give every SM a share of one clip and to keep each
// thread's chain of dependent loads short. A batch of many clips (the bench
// step, B=32) has blocks enough to fill the card several times, and the
// loads in flight on each SM set its pace. The plan
// (vct_torch/ops/pair_scores.py::plan, from the shape alone) picks one of
// two designs and its tiles by a cost model fitted to H100 timings.
//
// "bands" (few clips):
//   * a tile is (clip b, chunk of K consecutive transitions, band of the
//     frame's 16-byte words). A block reads the K+1 frames of its chunk,
//     band by band; a chunk's boundary frame is read twice, (K+1)/K of the
//     bytes, the second time mostly from L2;
//   * the bands of one (clip, chunk) form a thread-block cluster of up to
//     eight blocks (the portable size), one band each; where a shape has
//     more bands than that, a block takes bands rank, rank + cluster, ...
//     in turn. Each block sums its bands of each transition exactly, in
//     uint64, in its own shared memory; then the cluster synchronises and
//     rank 0 adds the blocks' sums through distributed shared memory
//     (map_shared_rank), rounds once to f32 and stores. No global scratch,
//     no counter and no atomics, so CUDA-graph replays and launches on two
//     streams need nothing beside the output. The plan keeps a launch to
//     one block an SM where it can (one video: 120 or 128 blocks);
//   * a thread owns W (1 or 2) 16-byte words of its band and walks them
//     down the chunk's frames kGroup frames at a time: the W * kGroup loads
//     of a group are issued together, at the end of the previous group's
//     step, so they are in flight at once; the previous frame's words stay
//     in registers, so every byte is loaded once per chunk;
//   * the group's per-thread 32-bit sums (W <= 2 words: 32 * 2 * 16 * 255^2
//     < 2^32) become kGroup warp sums (REDUX) issued back to back, and lane
//     u adds sum u into the warp's uint64 slot of transition k0 + u: one
//     shared-memory update a group. Slots are added in warp order, then
//     across the cluster.
// "chunks" (many clips): a block takes kChunk = 8 transitions of one clip
//   and whole frames; each of its 256 threads walks its words one at a
//   time, nine loads a word, its eight uint64 sums in registers, and the
//   block reduces once at the end. This is the first design of this port:
//   at the bench batch it reads 9/8 of the bytes, the boundary frames from
//   L2, and it was the fastest of every tiling timed there, the bands
//   design's included.
// Both designs score a word with __vsadu4 (sad) or __vabsdiffu4 + __dp4a
// (flow), sum exactly and convert to f32 once, so both methods are the
// correctly rounded exact sum, bit-equal to the plain version. Frames whose
// size is not a multiple of 16 bytes, or whose base is not 16-byte aligned
// (C=1, odd H*W*C, offset views), take each design's byte path: every
// thread reads bytes straight from device memory. The path is chosen here
// from the pointer and the shape.
//
// Tried and removed: streaming each block's (band, frame) pieces through a
// ring of shared-memory stages with the TMA (1-D cp.async.bulk, an mbarrier
// a stage, one producer thread). On the H100 a block's pieces arrived one
// after another rather than together, and it was slower than these loads at
// every shape timed, by several times at the bench batch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChunkPairs = 1024;  // K: a block's sums and slots live in shared memory
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kMaxThreads = 256;
constexpr int kGroup = 8;             // frames a thread loads at once

constexpr int kMaxDevices = 64;
// Dynamic shared memory a block may take: K sums and a warp's K slots.
constexpr int kSmemBudget = (1 + kMaxThreads / 32) * kMaxChunkPairs * 8;

struct Geometry {
  int L, K, n_chunks, n_bands, cluster;
  long long frame_bytes, band_bytes;  // band_bytes: a band's 16-byte words * 16
};

template <bool kSquare>
__device__ __forceinline__ unsigned word_score(unsigned a, unsigned b) {
  if (kSquare) {
    const unsigned d = __vabsdiffu4(a, b);
    return __dp4a(d, d, 0u);  // <= 4 * 255^2
  }
  return __vsadu4(a, b);  // <= 4 * 255
}

template <bool kSquare>
__device__ __forceinline__ unsigned vec_score(const uint4& a, const uint4& b) {
  return word_score<kSquare>(a.x, b.x) + word_score<kSquare>(a.y, b.y) +
         word_score<kSquare>(a.z, b.z) + word_score<kSquare>(a.w, b.w);
}

struct Tile {
  const uint8_t* clip;  // the chunk's first frame
  float* out;           // the chunk's first score
  int rank, nt;
};

__device__ __forceinline__ Tile tile_of(const uint8_t* x, float* out, const Geometry& g,
                                        const cg::cluster_group& cluster) {
  const long long tile = blockIdx.x / g.cluster;
  const long long b = tile / g.n_chunks;
  const int t0 = static_cast<int>(tile % g.n_chunks) * g.K;
  Tile t;
  t.clip = x + (b * g.L + t0) * g.frame_bytes;
  t.out = out + b * (g.L - 1) + t0;
  t.rank = static_cast<int>(cluster.block_rank());
  t.nt = min(g.K, g.L - 1 - t0);
  return t;
}

// Rank 0 adds the cluster's sums of each transition and stores them; the
// second sync keeps every block's shared memory alive until it has.
__device__ __forceinline__ void cluster_store(const Tile& t, unsigned long long* sums,
                                              const Geometry& g, cg::cluster_group& cluster) {
  cluster.sync();
  if (t.rank == 0) {
    for (int k = threadIdx.x; k < t.nt; k += blockDim.x) {
      unsigned long long s = 0ull;
      for (int r = 0; r < g.cluster; ++r) s += *cluster.map_shared_rank(sums + k, r);
      t.out[k] = static_cast<float>(s);
    }
  }
  cluster.sync();
}

// Adds the U transitions' per-thread sums of a group into the warp's slots:
// U warp sums (REDUX) issued back to back, then lane u adds sum u to its
// slot, so a group costs one shared-memory update, not U dependent ones.
template <int U>
__device__ __forceinline__ void add_group(unsigned long long* slots, const unsigned (&acc)[U],
                                          int n) {
  unsigned mine = 0u;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned s = __reduce_add_sync(0xffffffffu, acc[u]);
    mine = (threadIdx.x & 31) == u ? s : mine;
  }
  if ((threadIdx.x & 31) < n) slots[threadIdx.x & 31] += mine;
}

// The block's per-transition sums: each warp's slots added in warp order.
__device__ __forceinline__ void block_sums(const unsigned long long* slots,
                                           unsigned long long* sums, int warps, int K, int nt) {
  __syncthreads();
  for (int k = threadIdx.x; k < nt; k += blockDim.x) {
    unsigned long long s = 0ull;
    for (int w = 0; w < warps; ++w) s += slots[w * K + k];
    sums[k] = s;
  }
}

template <bool kSquare, int W>
__global__ void __launch_bounds__(kMaxThreads)
pair_scores_words(const uint8_t* __restrict__ x, float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned long long smem[];  // sums[K], then slots[warps][K]
  cg::cluster_group cluster = cg::this_cluster();
  const Tile t = tile_of(x, out, g, cluster);
  const int warps = blockDim.x >> 5;
  unsigned long long* sums = smem;
  unsigned long long* slots = smem + g.K;
  for (int k = threadIdx.x; k < warps * g.K; k += blockDim.x) slots[k] = 0ull;
  __syncthreads();
  unsigned long long* mine = slots + (threadIdx.x >> 5) * g.K;
  const long long fw = g.frame_bytes >> 4;
  const uint4* base = reinterpret_cast<const uint4*>(t.clip);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int j = t.rank; j < g.n_bands; j += g.cluster) {
    const long long w1 = min((j + 1) * (g.band_bytes >> 4), fw);
    long long w[W];
    bool on[W];
    uint4 prev[W], cur[W][kGroup];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      w[i] = j * (g.band_bytes >> 4) + threadIdx.x + i * static_cast<long long>(blockDim.x);
      on[i] = w[i] < w1;
      prev[i] = on[i] ? __ldg(base + w[i]) : zero;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
#pragma unroll
      for (int i = 0; i < W; ++i)
        cur[i][u] = (on[i] && u < t.nt) ? __ldg(base + (u + 1) * fw + w[i]) : zero;
    for (int k0 = 0; k0 < t.nt; k0 += kGroup) {
      unsigned acc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        acc[u] = 0u;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          acc[u] += vec_score<kSquare>(prev[i], cur[i][u]);
          prev[i] = cur[i][u];
        }
      }
      add_group<kGroup>(mine + k0, acc, min(kGroup, t.nt - k0));
      // The next group's loads, issued here so that they are in flight
      // together, not one before each use.
      const int k1 = k0 + kGroup;
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
#pragma unroll
        for (int i = 0; i < W; ++i)
          cur[i][u] = (on[i] && k1 + u < t.nt) ? __ldg(base + (k1 + u + 1) * fw + w[i]) : zero;
    }
  }
  block_sums(slots, sums, warps, g.K, t.nt);
  cluster_store(t, sums, g, cluster);
}

template <bool kSquare>
__global__ void __launch_bounds__(kMaxThreads)
pair_scores_bytes(const uint8_t* __restrict__ x, float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned long long smem[];  // sums[K], then slots[warps][K]
  cg::cluster_group cluster = cg::this_cluster();
  const Tile t = tile_of(x, out, g, cluster);
  const int warps = blockDim.x >> 5;
  unsigned long long* sums = smem;
  unsigned long long* slots = smem + g.K;
  unsigned long long* mine = slots + (threadIdx.x >> 5) * g.K;
  for (int k = threadIdx.x; k < warps * g.K; k += blockDim.x) slots[k] = 0ull;
  __syncthreads();
  for (int k = 0; k < t.nt; ++k) {
    const uint8_t* a = t.clip + k * g.frame_bytes;
    const uint8_t* c = a + g.frame_bytes;
    unsigned long long acc = 0ull;
    for (int j = t.rank; j < g.n_bands; j += g.cluster) {
      const long long end = min((j + 1) * g.band_bytes, g.frame_bytes);
      for (long long i = j * g.band_bytes + threadIdx.x; i < end; i += blockDim.x) {
        const int d = static_cast<int>(c[i]) - static_cast<int>(a[i]);
        acc += kSquare ? static_cast<unsigned long long>(d * d)
                       : static_cast<unsigned long long>(abs(d));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) mine[k] += acc;
  }
  block_sums(slots, sums, warps, g.K, t.nt);
  cluster_store(t, sums, g, cluster);
}

// The "chunks" design: a block takes one clip's chunk of kChunk transitions
// and whole frames; each thread walks its 16-byte words (or bytes) one at a
// time down the chunk's frames, its sums in registers, and the block reduces
// once. No cluster.
constexpr int kChunk = 8;
constexpr int kChunkThreads = 256;
constexpr int kChunkWarps = kChunkThreads / 32;

template <bool kSquare, bool kVec>
__global__ void __launch_bounds__(kChunkThreads)
pair_scores_chunks(const uint8_t* __restrict__ x, float* __restrict__ out, int L,
                   long long frame_bytes) {
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
    for (long long v = threadIdx.x; v < nvec; v += kChunkThreads) {
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
    for (long long i = threadIdx.x; i < frame_bytes; i += kChunkThreads) {
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

  __shared__ unsigned long long partial[kChunk][kChunkWarps];
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
    for (int w = 0; w < kChunkWarps; ++w) s += partial[threadIdx.x][w];
    out[(long long)b * (L - 1) + t0 + threadIdx.x] = static_cast<float>(s);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const uint8_t* x, float* out, const Geometry& g, int threads,
                   long long blocks, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (1 + threads / 32) * g.K * 8;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, x, out, g);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
}

// The kernels' shared-memory limit, raised once per device.
cudaError_t set_attributes(int dev) {
  static std::atomic<bool> done[kMaxDevices];
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  for (cudaError_t e :
       {allow_smem(pair_scores_words<false, 1>), allow_smem(pair_scores_words<false, 2>),
        allow_smem(pair_scores_words<true, 1>), allow_smem(pair_scores_words<true, 2>),
        allow_smem(pair_scores_bytes<false>), allow_smem(pair_scores_bytes<true>)})
    if (err == cudaSuccess) err = e;
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <bool kSquare>
cudaError_t launch_words(int W, const uint8_t* x, float* out, const Geometry& g, int threads,
                         long long blocks, cudaStream_t s) {
  if (W == 1) return launch(pair_scores_words<kSquare, 1>, x, out, g, threads, blocks, s);
  return launch(pair_scores_words<kSquare, 2>, x, out, g, threads, blocks, s);
}

}  // namespace

// x: (B, L, frame_bytes) uint8, contiguous; out: (B, L-1) f32. The plan
// (vct_torch/ops/pair_scores.py::plan): K transitions a chunk, `bands`
// bands of ceil(ceil(frame_bytes / 16) / bands) 16-byte words, none empty,
// `cluster` blocks a (clip, chunk), `threads` threads a block (a multiple of
// 32), `words_per_thread` (1 or 2) words of a band a thread, enough for
// the band. Requires B >= 1, L >= 2, frame_bytes >= 1. Returns
// cudaErrorInvalidValue for a plan the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int vct_pair_scores(const void* x, void* out, int B, int L, long long frame_bytes,
                               int square, int chunks_design, int K, int bands, int cluster,
                               int threads, int words_per_thread, void* stream) {
  const auto* xs = static_cast<const uint8_t*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = frame_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (chunks_design) {
    if (B < 1 || B > 65535 || L < 2 || frame_bytes < 1 || K != kChunk)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((L - 1 + kChunk - 1) / kChunk, B);
    if (vec) {
      if (square) pair_scores_chunks<true, true><<<grid, kChunkThreads, 0, s>>>(xs, o, L, frame_bytes);
      else pair_scores_chunks<false, true><<<grid, kChunkThreads, 0, s>>>(xs, o, L, frame_bytes);
    } else {
      if (square) pair_scores_chunks<true, false><<<grid, kChunkThreads, 0, s>>>(xs, o, L, frame_bytes);
      else pair_scores_chunks<false, false><<<grid, kChunkThreads, 0, s>>>(xs, o, L, frame_bytes);
    }
    return static_cast<int>(cudaGetLastError());
  }
  Geometry g;
  g.L = L;
  g.K = K;
  g.n_chunks = (L - 2 + K) / max(K, 1);
  g.n_bands = bands;
  g.cluster = cluster;
  g.frame_bytes = frame_bytes;
  const long long words = (frame_bytes + 15) / 16;
  const long long band_words = (words + bands - 1) / max(bands, 1);
  g.band_bytes = band_words * 16;
  const long long blocks = static_cast<long long>(B) * g.n_chunks * cluster;
  const int W = words_per_thread;
  if (B < 1 || L < 2 || frame_bytes < 1 || K < 1 || K > kMaxChunkPairs || K > L - 1 ||
      bands < 1 || (bands - 1) * band_words >= words || cluster < 1 ||
      cluster > kMaxCluster || cluster > bands || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks > 0x7fffffffll || (W != 1 && W != 2) ||
      band_words > static_cast<long long>(W) * threads)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = set_attributes(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) {
    err = square ? launch_words<true>(W, xs, o, g, threads, blocks, s)
                 : launch_words<false>(W, xs, o, g, threads, blocks, s);
  } else {
    err = square ? launch(pair_scores_bytes<true>, xs, o, g, threads, blocks, s)
                 : launch(pair_scores_bytes<false>, xs, o, g, threads, blocks, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
