// Bulk copies (cp.async.bulk, the tensor memory accelerator) from device
// memory into shared memory, completing on an mbarrier: the staging of the
// exact 1D tile (sg1d_exact.cuh, K1-K3) and of K7's sweep (corr2d_sep.cu,
// which also copies 2D boxes of a tensor map).
// A stage's barrier counts one arrival a use, which also announces the
// bytes that the stage's copies bring (expect_tx); every copy completes its
// bytes on the barrier, and the phase ends when all have landed.
#pragma once

#include <cstdint>

namespace sgb {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A stage's mbarrier: one arrival a use.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// The use's arrival, announcing the bytes its copies bring.
__device__ __forceinline__ void bar_arrive(uint64_t* bar, unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state) : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of bar with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 "
                 "p, [%1], %2; selp.u32 %0, 1, 0, p; }\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}

// Orders this thread's earlier generic reads and writes of shared memory
// (and, after a block barrier, those of the block) before its later bulk
// copies into it.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy of `bytes`, a multiple of 16 between 16-byte aligned ends,
// completing its bytes on bar; someone's arrival announces them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

// One 2D box of the tensor map at map (a kernel parameter): its columns from
// x and rows from y, coordinates outside the tensor reading as zeros, into
// dst (128-byte aligned) row after row, completing its bytes on bar;
// someone's arrival announces them.
__device__ __forceinline__ void box_load(void* dst, const void* map, int x,
                                         int y, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
               "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
                  "r"(x), "r"(y), "r"(smem_addr(bar)) : "memory");
}

// A stage filled by one bulk copy: the proxy fence, the arrival announcing
// its bytes, the copy.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  proxy_fence();
  bar_arrive(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

}  // namespace sgb
