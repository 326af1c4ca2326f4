// K13: ring halo exchange between the ranks of a process group, by one-sided
// stores into the neighbours' mapped memory, on one of two routes a rank:
// the SM route, one launch that also waits for the neighbours, and the
// stream route, where the wait leaves the SMs for the stream's front end
// between two launches.
//
// Replaces savgol_tpu/parallel/ici_halo.py::_halo_kernel (:39, called from
// _halo_call :92, pl.pallas_call :95): the TPU kernel posts two async remote
// DMAs over the ICI ring after a neighbour barrier and waits for both. Here
// each rank of a ring of P >= 2 processes shares one device buffer with its
// two neighbours once (CUDA IPC handles, ops/cuda_halo.py), and the kernels
// store straight into the neighbours' buffers: over NVLink on a host with
// one card a rank, into the same HBM when the ranks share one card.
//
// For rank r with tail (its last n samples of every row, or its last ny rows,
// flattened to `nbytes` bytes) and head (its first ones), exchange `epoch`
// (1, 2, ... on each ring) runs in r's stream on B blocks, with parity p =
// epoch % kParities and target = epoch * B:
//   1. halo_send_kernel stores tail into the right neighbour's LEFT slot and
//      head into the left neighbour's RIGHT slot of parity p, 16 bytes at a
//      time where aligned, each block its chunk;
//   2. each block fences at system scope, then adds 1 with release semantics
//      to the right neighbour's LEFT arrival word and the left neighbour's
//      RIGHT word;
//   3. r waits until both of its own words pass the target by kWaitRule
//      (every block of both neighbours stored);
//   4. r's two slots of parity p are copied into the fresh outputs (left =
//      the left neighbour's tail, right = the right neighbour's head) with
//      L1-bypassing loads.
// SM route (a rank with its card to itself): halo_send_kernel's blocks wait
// in step 3 with system-scope acquire loads and copy their chunks; one
// launch an exchange. Stream route (a rank that shares its card with another
// rank of the ring, ops/cuda_halo.py decides): halo_send_kernel looks once
// and copies only where both words have passed; the stream then waits for
// them in its front end (cuStreamBatchMemOp, CU_STREAM_MEM_OP_WAIT_VALUE_64
// with kWaitRule), holding no SM, and halo_recv_kernel copies the chunks not
// marked done. Ranks that share a card run in P contexts, which the card
// time-slices (no MPS): a kernel that waits on the SMs holds its context's
// slice while the neighbours it waits for cannot run, so it passed the card
// on only when the slice ran out, and an exchange cost one to three slices
// (~1.04 ms each). A stream blocked in a wait leaves its context no work,
// and the card passes to the next context at once. With a card a rank no
// slicer runs, and the stream's wait would only add its own latency: a wait
// operation and a second launch, some microseconds an exchange
// (probes/halo_ab.py times both routes).
//
// Why kParities = 2 slots a side are enough, and why a wait never passes
// early. Each word has one set of writers: r's LEFT word takes adds only
// from r's left neighbour's blocks (its step 2 for its right side), r's
// RIGHT word only from r's right neighbour's; in a ring of two the one
// neighbour adds to both words, each from one side. A word only grows, by B
// an exchange, and reaches e * B only once every block of the neighbour's
// exchange e has added, each after its stores and fence. A neighbour stores
// into r's slot of parity p again only in exchange e + 2. It starts that
// exchange only after its wait of e + 1 has passed, which needs r's adds of
// e + 1; r makes them after its exchange e has ended, copy-out included,
// because r's exchanges run in order on r's stream (the wrapper keeps them
// in order across streams). So a slot is never overwritten before it is
// read. The same chain bounds the words: while r waits for e, each of its
// words lies in [(e - 1) B, (e + 1) B] (r's wait of e - 1 passed; the
// neighbour cannot add for e + 2 before r adds for e + 1), so the cyclic
// comparison of kWaitRule, (int64)(word - target) >= 0, is the plain one,
// and once it passes every block of the neighbour's exchange e has stored
// into slot p (its exchange e + 1 fills the other parity): r's slot p holds
// the neighbour's bytes of exchange e. The two routes share steps 1, 2 and
// the words, so ranks on different routes can share a ring.
// tests/test_torch_halo_protocol.py checks this by an exhaustive search of
// the interleavings (one block a rank), with kParities, kWords and kWaitRule
// read from this file.
//
// Every wait is bounded. On the SM route past `timeout_ns` of %globaltimer
// the block prints which words it saw and traps. A stream wait has no
// timeout, so halo_recv records an event before its waits and one after its
// kernel and hands both to a watchdog thread of this library. When the first
// has completed and the second has not within `timeout_ns`
// (ops/cuda_halo.TIMEOUT_S), the thread reads r's two words and writes
// kPoison | target into each one still short of it, from a stream of its own
// made at the device's first exchange. That releases the wait;
// halo_recv_kernel sees the poison, prints which side never arrived at which
// epoch and traps. Either way a broken ring fails the next synchronise
// instead of hanging. The thread is C++, so a Python thread that blocks in a
// synchronise cannot stall it.
//
// Bound: the bytes are tiny (1D headline split 4 ways: 2 x 128 x 12 x 4 B =
// 12 KB a rank; 2D headline split 4 ways: 2 x 16 x 5 x 2048 x 4 B ~ 1.3 MB a
// rank), microseconds or less at 3.35 TB/s, so the floor is the launches and
// the flags' round trip between the ranks.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kThreads = 256;
// Blocks of at least kBytesPerBlock a side, at most kMaxBlocks.
constexpr long long kBytesPerBlock = 16LL * 1024;
constexpr int kMaxBlocks = 32;
// How long halo_send_kernel waits on the SMs for the neighbours on the
// stream route before it leaves the copy-out to the stream's wait and
// halo_recv_kernel: one look. A neighbour that shares this rank's card cannot
// run while this kernel holds it.
constexpr long long kStreamRouteSpinNs = 0;
// Receive slots a side; exchange e fills the one of parity e % kParities.
constexpr int kParities = 2;
// Arrival words a rank: [0] LEFT, written by the left neighbour, [1] RIGHT.
constexpr int kWords = 2;
// Byte offsets inside a rank's buffer: the arrival words at 0, one copy-out
// mark a block at kMarkOffset, then 2 * kParities slots of `stride` bytes:
// parity 0 left, parity 0 right, parity 1 left, parity 1 right. Kept in
// step with ops/cuda_halo.py (_FLAG_BYTES, _PARITIES).
constexpr long long kMarkOffset = 64;
constexpr long long kFlagBytes = 512;
static_assert(kMarkOffset + 8 * kMaxBlocks <= kFlagBytes, "marks overflow");
// A wait passes once (int64)(word - target) >= 0, in the stream and on the
// SMs alike (passes()).
constexpr unsigned kWaitRule = CU_STREAM_WAIT_VALUE_GEQ;
// Bit 62 marks a word the watchdog wrote: kPoison | target passes the wait
// (its cyclic difference is 2^62 > 0), and no target reaches it.
constexpr unsigned long long kPoison = 1ULL << 62;

__host__ __device__ __forceinline__ bool passes(unsigned long long word,
                                                unsigned long long target) {
  return static_cast<long long>(word - target) >= 0;
}

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

// Steps 1-3, and step 4 where the neighbours come within spin_ns: my tail ->
// the right neighbour's left slot and my head -> the left neighbour's right
// slot; a release add to the right neighbour's LEFT word and the left
// neighbour's RIGHT word from every block; then a wait on my own words for
// at most spin_ns, and the copy-out with a mark of `target` where both
// passed. Past spin_ns the block traps where `alone` (no halo_recv_kernel
// follows: the SM route) and returns otherwise.
__global__ void __launch_bounds__(kThreads)
halo_send_kernel(const char* __restrict__ tail, const char* __restrict__ head,
                 char* right_buf, char* left_buf, char* my_buf,
                 char* __restrict__ out_left, char* __restrict__ out_right,
                 long long nbytes, long long left_off, long long right_off,
                 long long chunk, unsigned long long epoch,
                 unsigned long long target, long long spin_ns, int alone) {
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < nbytes ? lo + chunk : nbytes;
  copy_range(right_buf + left_off, tail, lo, hi);
  copy_range(left_buf + right_off, head, lo, hi);
  // every thread's stores are visible system-wide before the words move
  // (the release add is cumulative over the barrier)
  __threadfence_system();
  __syncthreads();
  __shared__ int arrived;
  if (threadIdx.x == 0) {
    add_release_sys(reinterpret_cast<unsigned long long*>(right_buf) + 0);
    add_release_sys(reinterpret_cast<unsigned long long*>(left_buf) + 1);
    const unsigned long long* words =
        reinterpret_cast<const unsigned long long*>(my_buf);
    const unsigned long long t0 = global_ns();
    unsigned long long l, r;
    for (;;) {
      l = load_acquire_sys(words + 0);
      r = load_acquire_sys(words + 1);
      if (passes(l, target) && passes(r, target)) break;
      if (global_ns() - t0 > static_cast<unsigned long long>(spin_ns)) break;
      __nanosleep(100);
    }
    arrived = passes(l, target) && passes(r, target);
    if (!arrived && alone) {
      printf("halo_send: block %d timed out at exchange %llu: arrival words "
             "left %llu right %llu, want %llu\n", blockIdx.x, epoch, l, r,
             target);
      __trap();
    }
  }
  __syncthreads();
  if (!arrived) return;
  copy_range(out_left, my_buf + left_off, lo, hi);
  copy_range(out_right, my_buf + right_off, lo, hi);
  if (threadIdx.x == 0)
    reinterpret_cast<unsigned long long*>(my_buf + kMarkOffset)[blockIdx.x] =
        target;
}

// Step 4 for the blocks of halo_send_kernel that gave up waiting: my slots
// of this parity -> the outputs, unless the watchdog released the wait.
__global__ void __launch_bounds__(kThreads)
halo_recv_kernel(const char* my_buf, char* __restrict__ out_left,
                 char* __restrict__ out_right, long long nbytes,
                 long long left_off, long long right_off, long long chunk,
                 unsigned long long epoch, unsigned long long target) {
  if (__ldcg(reinterpret_cast<const unsigned long long*>(
          my_buf + kMarkOffset) + blockIdx.x) == target)
    return;   // the block's copy-out is done (the same word for every thread)
  if (threadIdx.x == 0) {
    const unsigned long long* words =
        reinterpret_cast<const unsigned long long*>(my_buf);
    const unsigned long long l = __ldcg(words + 0);
    const unsigned long long r = __ldcg(words + 1);
    if ((l | r) & kPoison) {
      if (blockIdx.x == 0)
        printf("halo_recv: exchange %llu: the %s neighbour never arrived "
               "(arrival words left %llx right %llx); the watchdog released "
               "the wait after its timeout\n", epoch,
               (l & kPoison) ? ((r & kPoison) ? "left and the right" : "left")
                             : "right", l, r);
      __trap();
    }
  }
  __syncthreads();
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < nbytes ? lo + chunk : nbytes;
  copy_range(out_left, my_buf + left_off, lo, hi);
  copy_range(out_right, my_buf + right_off, lo, hi);
}

// -- CUDA driver API entry points, through the runtime (nothing new linked)

struct CuApi {
  PFN_cuStreamBatchMemOp_v11070 batch = nullptr;
  PFN_cuDeviceGet_v2000 get = nullptr;
  PFN_cuDeviceGetAttribute_v2000 attr = nullptr;
  bool ok = false;
};

template <typename F>
bool entry(const char* name, F* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t e =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &status);
#endif
  if (e != cudaSuccess || status != cudaDriverEntryPointSuccess || !p)
    return false;
  *fn = reinterpret_cast<F>(p);
  return true;
}

const CuApi& cu() {
  static const CuApi d = [] {
    CuApi v;
    v.ok = entry("cuStreamBatchMemOp", &v.batch) &&
           entry("cuDeviceGet", &v.get) &&
           entry("cuDeviceGetAttribute", &v.attr);
    return v;
  }();
  return d;
}

CUstreamBatchMemOpParams write_op(void* word, unsigned long long value) {
  CUstreamBatchMemOpParams op;
  memset(&op, 0, sizeof(op));
  op.writeValue.operation = CU_STREAM_MEM_OP_WRITE_VALUE_64;
  op.writeValue.address = reinterpret_cast<CUdeviceptr>(word);
  op.writeValue.value64 = value;
  op.writeValue.flags = CU_STREAM_WRITE_VALUE_DEFAULT;
  return op;
}

CUstreamBatchMemOpParams wait_op(void* word, unsigned long long value) {
  CUstreamBatchMemOpParams op;
  memset(&op, 0, sizeof(op));
  op.waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_64;
  op.waitValue.address = reinterpret_cast<CUdeviceptr>(word);
  op.waitValue.value64 = value;
  op.waitValue.flags = kWaitRule;
  return op;
}

int batch(CUstream s, CUstreamBatchMemOpParams* ops, unsigned n) {
  const CUresult r = cu().batch(s, n, ops, 0);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(r);
}

// -- the watchdog -------------------------------------------------------------

using Clock = std::chrono::steady_clock;
constexpr auto kFirstPause = std::chrono::microseconds(200);

struct Pending {
  int device;
  cudaEvent_t waiting;   // recorded before the waits (the signal is out)
  cudaEvent_t done;      // recorded after halo_recv_kernel
  unsigned long long* words;
  unsigned long long epoch;
  unsigned long long target;   // epoch x blocks: what each word must reach
  long long timeout_ns;
  bool seen = false;     // `waiting` observed complete, at `since`
  bool released = false;
  Clock::time_point since;
};

int greatest_priority();

class Watchdog {
 public:
  static Watchdog& get() {
    // never destroyed: the thread may outlive static destruction at exit
    static Watchdog* w = new Watchdog();
    return *w;
  }

  // An event of `device` without timing, from the spares or new.
  cudaError_t event(int device, cudaEvent_t* ev) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (size_t i = 0; i < spare_.size(); ++i)
        if (spare_[i].first == device) {
          *ev = spare_[i].second;
          spare_[i] = spare_.back();
          spare_.pop_back();
          return cudaSuccess;
        }
    }
    return cudaEventCreateWithFlags(ev, cudaEventDisableTiming);
  }

  // This thread's own stream of `device`, made at the device's first
  // exchange, while the process has few streams: a stream that shares a
  // hardware queue with a blocked wait could not release it.
  cudaError_t own_stream(int device) {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& ds : streams_)
      if (ds.first == device) return cudaSuccess;
    cudaStream_t s = nullptr;
    const cudaError_t err = cudaStreamCreateWithPriority(
        &s, cudaStreamNonBlocking, greatest_priority());
    if (err == cudaSuccess) streams_.emplace_back(device, s);
    return err;
  }

  void watch(const Pending& p) {
    std::lock_guard<std::mutex> lk(mu_);
    queue_.push_back(p);
    cv_.notify_one();
  }

 private:
  Watchdog() { std::thread([this] { loop(); }).detach(); }

  void loop() {
    // polls the oldest exchange every 0.2 ms at first, backing off to 5 ms
    int current = -1;
    auto pause = kFirstPause;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [this] { return !queue_.empty(); });
      Pending p = queue_.front();
      lk.unlock();
      if (p.device != current) {
        cudaSetDevice(p.device);
        current = p.device;
      }
      const cudaError_t done = cudaEventQuery(p.done);
      if (done != cudaErrorNotReady) {
        // finished, or the context failed (a trap): drop it either way
        lk.lock();
        queue_.pop_front();
        if (done == cudaSuccess) {
          spare_.emplace_back(p.device, p.waiting);
          spare_.emplace_back(p.device, p.done);
        }
        pause = kFirstPause;
        continue;
      }
      if (!p.seen) {
        if (cudaEventQuery(p.waiting) == cudaSuccess) {
          p.seen = true;
          p.since = Clock::now();
        }
      } else if (!p.released &&
                 Clock::now() - p.since >
                     std::chrono::nanoseconds(p.timeout_ns)) {
        release(p);
        p.released = true;
      }
      std::this_thread::sleep_for(pause);
      if (pause < std::chrono::milliseconds(5)) pause *= 2;
      lk.lock();
      queue_.front().seen = p.seen;
      queue_.front().since = p.since;
      queue_.front().released = p.released;
    }
  }

  // Write kPoison | epoch into each of p's words still below its epoch,
  // from this thread's own stream of that device.
  void release(const Pending& p) {
    cudaStream_t s = nullptr;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (auto& ds : streams_)
        if (ds.first == p.device) s = ds.second;
    }
    if (s == nullptr) return;
    unsigned long long w[kWords] = {0, 0};
    cudaMemcpyAsync(w, p.words, sizeof(w), cudaMemcpyDeviceToHost, s);
    cudaStreamSynchronize(s);
    CUstreamBatchMemOpParams ops[kWords];
    unsigned n = 0;
    for (int i = 0; i < kWords; ++i)
      if (!passes(w[i], p.target))
        ops[n++] = write_op(p.words + i, kPoison | p.target);
    fprintf(stderr,
            "halo_ring watchdog: exchange %llu waited %lld ns for its "
            "neighbours; arrival words left %llu right %llu, want %llu; "
            "releasing %u wait(s) with poison\n",
            p.epoch, p.timeout_ns, w[0], w[1], p.target, n);
    if (n) batch(reinterpret_cast<CUstream>(s), ops, n);
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Pending> queue_;
  std::vector<std::pair<int, cudaEvent_t>> spare_;
  std::vector<std::pair<int, cudaStream_t>> streams_;  // this thread's own
};

int greatest_priority() {
  int least = 0, greatest = 0;
  cudaDeviceGetStreamPriorityRange(&least, &greatest);
  return greatest;
}

bool bad_args(long long nbytes, long long stride, int blocks,
              unsigned long long epoch) {
  return nbytes < 1 || stride < nbytes || stride % 256 != 0 || blocks < 1 ||
         blocks > kMaxBlocks || epoch == 0 || epoch >= kPoison / kMaxBlocks;
}

// 16-byte aligned chunks, so a block's range starts aligned in every slot
long long chunk_of(long long nbytes, int blocks) {
  const long long chunk = (nbytes + blocks - 1) / blocks;
  return (chunk + 15) / 16 * 16;
}

long long slot(unsigned long long epoch, int side, long long stride) {
  return kFlagBytes + (2 * static_cast<long long>(epoch % kParities) + side) *
                          stride;
}

}  // namespace

// Grid size for an exchange of `nbytes` a side. Every rank of a ring computes
// the same number from the same nbytes.
extern "C" int halo_ring_blocks(long long nbytes) {
  long long b = (nbytes + kBytesPerBlock - 1) / kBytesPerBlock;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// 0 where `device` takes the exchange: the CUDA driver API's
// memory-operation entry points were found (1 if not) and the device
// supports 64-bit stream memory operations (2 if not; 3 if the query
// failed).
extern "C" int halo_ring_check(int device) {
  const CuApi& d = cu();
  if (!d.ok) return 1;
  CUdevice dev;
  int can = 0;
  if (d.get(&dev, device) != CUDA_SUCCESS ||
      d.attr(&can, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev) !=
          CUDA_SUCCESS)
    return 3;
  return can ? 0 : 2;
}

// Exchange `epoch` on `stream`. SM route (`timeout_ns` > 0): all of it, the
// wait on the SMs bounded by timeout_ns. Stream route (`timeout_ns` == 0):
// steps 1 and 2, and step 4 where the neighbours have come at the first
// look; halo_recv follows.
extern "C" int halo_send(const void* tail, const void* head, void* right_buf,
                         void* left_buf, void* my_buf, void* out_left,
                         void* out_right, long long nbytes, long long stride,
                         int blocks, unsigned long long epoch,
                         long long timeout_ns, void* stream) {
  if (bad_args(nbytes, stride, blocks, epoch) || timeout_ns < 0)
    return cudaErrorInvalidValue;
  const int alone = timeout_ns > 0;
  halo_send_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(tail), static_cast<const char*>(head),
      static_cast<char*>(right_buf), static_cast<char*>(left_buf),
      static_cast<char*>(my_buf), static_cast<char*>(out_left),
      static_cast<char*>(out_right), nbytes, slot(epoch, 0, stride),
      slot(epoch, 1, stride), chunk_of(nbytes, blocks), epoch, epoch * blocks,
      alone ? timeout_ns : kStreamRouteSpinNs, alone);
  return cudaGetLastError();
}

// The stream route's steps 3 and 4 of exchange `epoch` on `stream`, for what
// halo_send left, watched for `timeout_ns`.
extern "C" int halo_recv(const void* my_buf, void* out_left, void* out_right,
                         long long nbytes, long long stride, int blocks,
                         unsigned long long epoch, long long timeout_ns,
                         void* stream) {
  if (bad_args(nbytes, stride, blocks, epoch) || timeout_ns < 1)
    return cudaErrorInvalidValue;
  if (!cu().ok) return cudaErrorNotSupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words =
      static_cast<unsigned long long*>(const_cast<void*>(my_buf));
  const unsigned long long target = epoch * blocks;
  Pending p;
  cudaError_t err = cudaGetDevice(&p.device);
  Watchdog& dog = Watchdog::get();
  if (err == cudaSuccess) err = dog.own_stream(p.device);
  if (err == cudaSuccess) err = dog.event(p.device, &p.waiting);
  if (err == cudaSuccess) err = dog.event(p.device, &p.done);
  if (err == cudaSuccess) err = cudaEventRecord(p.waiting, s);
  if (err != cudaSuccess) return err;
  CUstreamBatchMemOpParams ops[kWords] = {wait_op(words + 0, target),
                                          wait_op(words + 1, target)};
  const int r = batch(reinterpret_cast<CUstream>(s), ops, kWords);
  if (r != 0) return r;
  halo_recv_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const char*>(my_buf), static_cast<char*>(out_left),
      static_cast<char*>(out_right), nbytes, slot(epoch, 0, stride),
      slot(epoch, 1, stride), chunk_of(nbytes, blocks), epoch, target);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(p.done, s);
  if (err != cudaSuccess) return err;
  p.words = words;
  p.epoch = epoch;
  p.target = target;
  p.timeout_ns = timeout_ns;
  dog.watch(p);
  return 0;
}
