// Shared C entry points of the port's kernel library.
#include <cuda_runtime.h>

namespace {

__global__ void fill_shared_kernel(float value, int n) {
  extern __shared__ float smem[];
  volatile float* s = smem;  // stores nothing reads: keep them
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = value;
}

}  // namespace

extern "C" const char* vct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fills the shared memory of every SM with `value`: blocks of the most
// dynamic shared memory a block may take, four for each SM. CUDA does not
// clear shared memory between kernels, so a kernel launched next on the
// stream that reads shared memory it did not write reads `value` (the tests
// pass a NaN). Returns cudaGetLastError() after the launch.
extern "C" int vct_fill_shared(float value, void* stream) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fill_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_shared_kernel<<<4 * sms, 1024, optin, static_cast<cudaStream_t>(stream)>>>(
      value, optin / static_cast<int>(sizeof(float)));
  return static_cast<int>(cudaGetLastError());
}
