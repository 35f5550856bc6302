// The "clusters" design of K2/K5, forward (lstm.cu) and backward
// (lstm_bwd.cu): what both kernels share. A thread-block cluster of n CTAs
// serves R batch rows; CTA c owns the units [c*H/n, (c+1)*H/n), a warp a
// unit (so at most kClusterUnits units a CTA). Every step each unit's warp
// stores what it produced (h_t forward, the gate gradients backward) into
// every CTA's shared memory with st.async (lane p into CTA p, one vector
// store a unit), each store counted in bytes on the receiving CTA's
// mbarrier of that step's parity; a CTA waits on its own mbarrier for the
// whole cluster's bytes of the step before it reads them. On an NVIDIA H100
// 80GB HBM3 (700 W) such a step took 0.17-0.73 us at 2-16 CTAs of 288-512
// threads (0.18-0.46 with 16-byte stores), against 0.68-0.75 us for
// barrier.cluster's arrive.release and wait.acquire alone, most of it the
// release (0.10-0.11 us relaxed): python3 -m vct_torch.tools.cluster_exchange.
// Two mbarriers (by the step's parity) are enough: a CTA stores step q+2's
// values only after it has all of step q+1's, which every unit's warp sends
// after it has read step q's.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kClusterMaxH = 256;    // the widest H the design takes
constexpr int kClusterUnits = 16;    // units a CTA at most: 16 warps
constexpr int kClusterThreads = 32 * kClusterUnits;

// The design takes 64 < H <= kClusterMaxH (H <= 64 is "registers").
inline bool cluster_takes(int H, int n_gates) {
  return H > 64 && H <= kClusterMaxH && (n_gates == 3 || n_gates == 4);
}

// CTAs an SM the kernels are built for (__launch_bounds__), by NQ = HP/32:
// two at H <= 96 (at most 12 warps a CTA), so that the card holds twice
// the clusters; one above.
__host__ __device__ constexpr int cluster_ctas_per_sm(int NQ) { return NQ <= 3 ? 2 : 1; }

// The plan (n CTAs a cluster, R batch rows a cluster), by the shapes alone.
// n: the fewest CTAs whose units fit 16 warps each, 8 up to H = 128, 16
// above. R: the fewest rows of 1, 2 and 4 whose clusters the H100 holds at
// once (cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3: 15
// clusters of 8 and 7 of 16 at a CTA an SM, 30 of 8 at two), so that no
// cluster waits for another to finish; where none does, 2. Each the
// fastest plan, forward and backward, or within 4% of it, in the timing
// of every plan at B = 2 and 32, H = 65, 128 and 256 (chip_smoke.py
// --rnn-timing, _cluster_plans), except H = 65 at B = 32, where 16 CTAs of
// 2 rows ran up to 6% faster than the plan's 8.
inline int cluster_plan_n(int H) { return H <= 8 * kClusterUnits ? 8 : 16; }
inline int cluster_plan_rows(int batch, int n, int H) {
  const int resident = n <= 8 ? (H <= 96 ? 30 : 15) : 7;
  for (int R = 1; R <= 4; R *= 2)
    if ((batch + R - 1) / R <= resident) return R;
  return 2;
}

// Whether (n, R) is a plan the kernels take for H: n in {8, 16} with each
// CTA's units fitting its warps, R in {1, 2, 4}.
inline bool cluster_plan_ok(int H, int n, int R) {
  return (n == 8 || n == 16) && (H + n - 1) / n <= kClusterUnits &&
         (R == 1 || R == 2 || R == 4);
}

// KU sums over groups of S lanes (S a power of two, KU | S) by recursive
// halving: at offset o = S/2, S/4, .., S/KU a lane keeps half of its
// remaining values (the upper half where bit o of s is set) and takes its
// partner's partials of them, then xor-shuffles over the S/KU lanes left
// add up value s / (S/KU), whose sum every one of them ends with. A fixed
// order: runs are bit-equal.
template <int KU, int S>
__device__ __forceinline__ float tile_sum(float (&v)[KU], int s) {
#pragma unroll
  for (int n = KU, o = S / 2; n > 1; n >>= 1, o >>= 1) {
    const bool up = s & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[n / 2 + i];
      const float keep = up ? v[n / 2 + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float r = v[0];
#pragma unroll
  for (int o = S / KU / 2; o >= 1; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of `p` (this CTA's shared memory) in CTA `rank`.
__device__ __forceinline__ unsigned cluster_map(const void* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier of `count` arrivals a phase, visible to the cluster's
// asynchronous stores once the CTAs synchronise.
__device__ __forceinline__ void mbar_init(unsigned long long* m, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(m)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This phase's one arrival, expecting `bytes` of asynchronous stores (which
// may have come in already: the phase completes at both).
__device__ __forceinline__ void mbar_arm(unsigned long long* m, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(m)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `parity` has completed: its bytes are visible.
__device__ __forceinline__ void mbar_wait(unsigned long long* m, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(m)), "r"(parity)
        : "memory");
}

// K floats (1, 2 or 4; 4K-byte aligned) to the shared::cluster address
// `addr`, their bytes counted on the mbarrier at shared::cluster `mbar`.
template <int K>
__device__ __forceinline__ void st_async(unsigned addr, const float* v, unsigned mbar) {
  if constexpr (K == 1) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                 ::"r"(addr), "r"(__float_as_uint(v[0])), "r"(mbar) : "memory");
  } else if constexpr (K == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
        ::"r"(addr), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(mbar)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4},"
        " [%5];" ::"r"(addr), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
        "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(mbar)
        : "memory");
  }
}

// Every thread of every CTA, its earlier memory operations released to the
// cluster and the peers' acquired: a chunk's and a launch's edges.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Launch `kernel` as `clusters` clusters of n CTAs of `threads` threads, or,
// with `fit` set, only write there how many such clusters the card holds at
// once (cudaOccupancyMaxActiveClusters) and launch nothing. A plan the card
// cannot host (no cluster fits) returns cudaErrorInvalidClusterSize, and
// nothing runs. A fit once found is kept per kernel instance, so the query
// runs once a shape.
template <typename... Params, typename... Args>
int cluster_launch(void (*kernel)(Params...), int n, int clusters, int threads, size_t smem,
                   cudaStream_t stream, int* fit, Args... args) {
  static std::atomic<long long> hosted{-1};
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && n > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * clusters));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long key =
      (static_cast<long long>(n) << 40) | (static_cast<long long>(threads) << 24) | (long long)smem;
  if (fit != nullptr || hosted.load(std::memory_order_relaxed) != key) {
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit != nullptr) {
      *fit = count;
      return 0;
    }
    if (count < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
    hosted.store(key, std::memory_order_relaxed);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
