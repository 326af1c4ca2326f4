// K13: ring halo exchange between the ranks of a process group, one launch
// a rank, with one-sided stores into the neighbours' mapped memory.
//
// Replaces savgol_tpu/parallel/ici_halo.py::_halo_kernel (:39, called from
// _halo_call :92, pl.pallas_call :95): the TPU kernel posts two async remote
// DMAs over the ICI ring after a neighbour barrier and waits for both. Here
// each rank of a ring of P >= 2 processes shares one device buffer with its
// two neighbours once (CUDA IPC handles, ops/cuda_halo.py), and the kernel
// stores straight into the neighbours' buffers: over NVLink on a host with
// one card a rank, into the same HBM when the ranks share one card.
//
// For rank r with tail (its last n samples of every row, or its last ny rows,
// flattened to `nbytes` bytes) and head (its first ones), one exchange:
//   1. stores tail into the right neighbour's LEFT slot and head into the
//      left neighbour's RIGHT slot of parity epoch & 1, 16 bytes at a time
//      where aligned;
//   2. fences at system scope, then adds 1 with release semantics to the
//      neighbours' arrival words (one a block and side);
//   3. waits, with system-scope acquire loads, until its own two arrival
//      words reach epoch * blocks (every block of both neighbours stored);
//   4. copies its own two slots of that parity into the fresh outputs
//      (left = the left neighbour's tail, right = the right neighbour's head).
//
// Why two slots are enough (the TPU kernel's barrier semaphore, :66-73, keeps
// a remote write from landing before the receiver owns its buffer; here the
// parity slots and the ring order do that job). Exchanges of one ring run in
// order on each rank's stream, so exchange e + 1 starts only after the same
// rank's exchange e has finished its copy-out. A neighbour writes slot
// parity p = e & 1 again only in exchange e + 2, and it starts that only
// after its own exchange e + 1 saw this rank's stores of e + 1, which this
// rank issued after its exchange e had copied slot p out. So a slot is never
// overwritten before it is read. The arrival words only grow: a neighbour
// already in exchange e + 1 adds to them while this rank waits for e, which
// still reads as ">= epoch * blocks" and never lets a wait pass early,
// because every store of e precedes the neighbour's increments of e.
//
// Every wait is bounded: past `timeout_ns` of %globaltimer the block prints
// which words it saw and traps, so a broken ring fails the next synchronise
// instead of hanging. Ranks that share one card run in separate contexts,
// which the card time-slices without MPS: a rank's wait then lasts until its
// neighbours' contexts get a slice. That is correct and slow; its time is
// recorded as P processes time-sliced on one card, not as NVLink.
//
// Bound: the bytes are tiny (1D headline split 4 ways: 2 x 128 x 12 x 4 B =
// 12 KB a rank; 2D headline split 4 ways: 2 x 16 x 5 x 2048 x 4 B ~ 1.3 MB a
// rank), microseconds or less at 3.35 TB/s, so its floor is the launch and
// the flag round trip. The design keeps the grid small (at most kMaxBlocks,
// all resident at once, so no block spins while another of its rank waits to
// be scheduled) and does the copy-out in the same launch.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 32;
// Byte offsets inside a rank's buffer: the two arrival words (left, right),
// then four slots of `stride` bytes: parity 0 left, parity 0 right, parity 1
// left, parity 1 right. Kept in step with ops/cuda_halo.py (_FLAG_BYTES).
constexpr long long kFlagBytes = 256;

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release_sys(unsigned long long* p) {
  asm volatile("red.release.sys.global.add.u64 [%0], 1;"
               :: "l"(p) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// dst[lo, hi) = src[lo, hi) by the block: 16-byte words where both sides
// are aligned, 4-byte words where they are not (every halo is whole f32 or
// f64 samples), bytes otherwise. Loads bypass L1 (.cg): a slot is written
// by another process and must not be read from a stale line.
__device__ __forceinline__ void copy_range(char* __restrict__ dst,
                                           const char* __restrict__ src,
                                           long long lo, long long hi) {
  if (hi <= lo) return;
  char* d = dst + lo;
  const char* s = src + lo;
  const long long len = hi - lo;
  const uintptr_t align = reinterpret_cast<uintptr_t>(d) |
                          reinterpret_cast<uintptr_t>(s);
  long long done = 0;
  if ((align & 15) == 0) {
    const long long n16 = len / 16;
    for (long long i = threadIdx.x; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(d)[i] =
          __ldcg(reinterpret_cast<const uint4*>(s) + i);
    done = n16 * 16;
  } else if ((align & 3) == 0) {
    const long long n4 = len / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<unsigned*>(d)[i] =
          __ldcg(reinterpret_cast<const unsigned*>(s) + i);
    done = n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads)
    d[i] = __ldcg(s + i);
}

__global__ void __launch_bounds__(kThreads)
halo_ring_kernel(const char* __restrict__ tail, const char* __restrict__ head,
                 char* right_buf, char* left_buf, char* my_buf,
                 char* __restrict__ out_left, char* __restrict__ out_right,
                 long long nbytes, long long stride, long long chunk,
                 unsigned long long epoch, long long timeout_ns) {
  const long long parity = static_cast<long long>(epoch & 1ULL);
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < nbytes ? lo + chunk : nbytes;
  const long long left_off = kFlagBytes + (2 * parity + 0) * stride;
  const long long right_off = kFlagBytes + (2 * parity + 1) * stride;

  // 1. my tail -> the right neighbour's left slot; my head -> the left
  //    neighbour's right slot
  copy_range(right_buf + left_off, tail, lo, hi);
  copy_range(left_buf + right_off, head, lo, hi);
  // 2. every thread's stores are visible system-wide before the arrival
  //    words move (the release add is cumulative over the barrier)
  __threadfence_system();
  __syncthreads();
  unsigned long long* my_words = reinterpret_cast<unsigned long long*>(my_buf);
  if (threadIdx.x == 0) {
    add_release_sys(reinterpret_cast<unsigned long long*>(right_buf) + 0);
    add_release_sys(reinterpret_cast<unsigned long long*>(left_buf) + 1);
    // 3. wait for both neighbours' blocks of this epoch
    const unsigned long long want = epoch * gridDim.x;
    const unsigned long long t0 = global_ns();
    for (;;) {
      const unsigned long long l = load_acquire_sys(my_words + 0);
      const unsigned long long r = load_acquire_sys(my_words + 1);
      if (l >= want && r >= want) break;
      if (global_ns() - t0 > static_cast<unsigned long long>(timeout_ns)) {
        printf("halo_ring: block %d timed out at epoch %llu: arrivals left "
               "%llu right %llu, want %llu\n", blockIdx.x, epoch, l, r, want);
        __trap();
      }
      __nanosleep(200);
    }
  }
  __syncthreads();
  // 4. my slots of this parity -> the outputs
  copy_range(out_left, my_buf + left_off, lo, hi);
  copy_range(out_right, my_buf + right_off, lo, hi);
}

}  // namespace

// Grid size for an exchange of `nbytes` a side: blocks of kThreads moving
// at least 16 KB each, at most kMaxBlocks. Every rank of a ring computes the
// same number from the same nbytes, and the arrival target counts it.
extern "C" int halo_ring_blocks(long long nbytes) {
  const long long per = 16LL * 1024;
  long long b = (nbytes + per - 1) / per;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

extern "C" int halo_ring(const void* tail, const void* head, void* right_buf,
                         void* left_buf, void* my_buf, void* out_left,
                         void* out_right, long long nbytes, long long stride,
                         int blocks, unsigned long long epoch,
                         long long timeout_ns, void* stream) {
  if (nbytes < 1 || stride < nbytes || stride % 256 != 0 || blocks < 1 ||
      blocks > kMaxBlocks || epoch == 0 || timeout_ns < 1)
    return cudaErrorInvalidValue;
  // 16-byte aligned chunks, so a block's range starts aligned in every slot
  long long chunk = (nbytes + blocks - 1) / blocks;
  chunk = (chunk + 15) / 16 * 16;
  halo_ring_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(tail), static_cast<const char*>(head),
      static_cast<char*>(right_buf), static_cast<char*>(left_buf),
      static_cast<char*>(my_buf), static_cast<char*>(out_left),
      static_cast<char*>(out_right), nbytes, stride, chunk, epoch,
      timeout_ns);
  return cudaGetLastError();
}
