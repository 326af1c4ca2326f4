// Launch plumbing shared by the masked kernels (masked1d.cu, masked2d.cu).
#pragma once

#include <cuda_runtime.h>

namespace sgtlaunch {

// Shared memory a block may use on the H100 (dynamic, past 48 KB only after
// cudaFuncSetAttribute).
constexpr size_t kSmemMax = 232448;

// Launches kernel(args) with `threads` threads and `smem` bytes of dynamic
// shared memory a block on `blocks` blocks or, with persistent set, on no
// more blocks than the card holds at once (such a kernel walks its tiles
// with a stride of the grid, so what a block stages once serves every tile
// it takes). Returns the launch's error.
template <typename Args>
cudaError_t launch(void (*kernel)(const Args), long long blocks, int threads,
                   size_t smem, bool persistent, cudaStream_t stream,
                   const Args& args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    const long long resident = static_cast<long long>(sms) * per_sm;
    if (resident > 0 && resident < blocks) blocks = resident;
  }
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  kernel<<<dim3(static_cast<unsigned>(blocks)), threads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace sgtlaunch
