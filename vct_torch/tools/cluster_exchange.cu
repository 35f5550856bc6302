// The per-step cost of exchanging values between the CTAs of a thread-block
// cluster, the choice behind the "clusters" design of K2/K5 (rnn_cluster.cuh).
// One cluster of n CTAs loops `iters` steps; in each, every warp that owns a
// unit (all of them here) hands one value to every CTA, as a recurrence step
// hands h_t or its gate gradients, and the CTAs then wait for each other:
//   barrier  barrier.cluster arrive.release + wait.acquire, nothing stored
//   relaxed  barrier.cluster arrive.relaxed + wait, nothing stored (no
//            ordering: it cannot publish stores; the barrier's own cost)
//   store    st.shared::cluster, lane p into CTA p, then the barrier
//   async    st.async, lane p into CTA p, its bytes counted on CTA p's
//            mbarrier of the step's parity; each CTA waits on its own
//   async4   the same with one 16-byte st.async a lane (four values)
// Built and run by vct_torch/tools/cluster_exchange.py.
#include <cuda_runtime.h>

#include <cstdio>
#include <cstring>

namespace {

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned map(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void sync_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;" ::: "memory");
}
__device__ __forceinline__ void arm(unsigned long long* m, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(m)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void wait(unsigned long long* m, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem(m)), "r"(parity)
        : "memory");
}

enum Mode { kBarrier, kRelaxed, kStore, kAsync, kAsync4, kModes };
const char* kNames[kModes] = {"barrier", "relaxed", "store", "async", "async4"};

__global__ void exchange(int mode, int iters, float* out) {
  __shared__ float4 buf[2][512];
  __shared__ unsigned long long bar[2];
  const int n = static_cast<int>(nctarank()), lane = threadIdx.x % 32;
  const int unit = static_cast<int>(ctarank()) * (blockDim.x / 32) + threadIdx.x / 32;
  const unsigned units = n * blockDim.x / 32, bytes = units * (mode == kAsync4 ? 16 : 4);
  const unsigned peer = lane < n ? map(buf, lane) : 0u, peer_bar = lane < n ? map(bar, lane) : 0u;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&bar[b])) : "memory");
      arm(&bar[b], bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  sync_release();
  float acc = 0.f;
  for (int t = 0; t < iters; ++t) {
    const int b = t & 1;
    const float* row = reinterpret_cast<const float*>(buf[b]);
    if (mode == kBarrier) {
      sync_release();
    } else if (mode == kRelaxed) {
      sync_relaxed();
    } else if (mode == kStore) {
      if (lane < n)
        asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(peer + 4u * (b * 2048 + unit)),
                     "f"(acc) : "memory");
      sync_release();
      acc += row[lane];
    } else {
      if (lane < n) {
        const unsigned m = peer_bar + 8u * b;
        if (mode == kAsync)
          asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                       ::"r"(peer + 4u * (b * 2048 + unit)), "r"(__float_as_uint(acc)), "r"(m)
                       : "memory");
        else
          asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0],"
                       " {%1, %1, %1, %1}, [%2];" ::"r"(peer + 16u * (b * 512 + unit)),
                       "r"(__float_as_uint(acc)), "r"(m)
                       : "memory");
      }
      wait(&bar[b], (t >> 1) & 1);
      if (threadIdx.x == 0) arm(&bar[b], bytes);
      acc += row[lane];
    }
  }
  sync_release();
  if (acc == 12345.f) out[0] = acc;  // keeps the loads
}

}  // namespace

// Prints one line a (CTAs, threads, mode): the microseconds a step.
int main() {
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float));
  cudaFuncSetAttribute(exchange, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const int iters = 20000;
  for (int n : {2, 8, 16})
    for (int threads : {288, 512})
      for (int mode = 0; mode < kModes; ++mode) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(n);
        cfg.blockDim = dim3(threads);
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = n;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        cudaEvent_t a, b;
        cudaEventCreate(&a);
        cudaEventCreate(&b);
        cudaLaunchKernelEx(&cfg, exchange, mode, 100, out);  // warm-up
        cudaEventRecord(a);
        cudaLaunchKernelEx(&cfg, exchange, mode, iters, out);
        cudaEventRecord(b);
        const cudaError_t err = cudaEventSynchronize(b);
        float ms = 0.f;
        cudaEventElapsedTime(&ms, a, b);
        if (err != cudaSuccess) {
          std::printf("error %s\n", cudaGetErrorString(err));
          return 1;
        }
        std::printf("%d %d %s %.4f\n", n, threads, kNames[mode], ms * 1e3f / iters);
      }
  return 0;
}
