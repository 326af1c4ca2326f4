// The exact (f32 / f64) 1D tile of K1 and K2 (sg1d_poly.cu's sg1d_poly /
// sg1d_pad) and K3 (corr1d_valid.cu's corr1d_valid): a block walks over
// tiles of rows with the next tiles' samples in flight (a bulk copy) while
// it computes this one, each thread owning Q consecutive outputs in
// registers.
//
// Each kernel computes, for the outputs 0 <= j < n_out of each row,
//
//     acc[j] = sum_{k < ws} w[k] * xv[j + off + k]
//
// with off = -n for the same-length apply (K1, K2) and 0 for the VALID
// correlation (K3); xv is the row extended past [0, N) by the pad mode
// (stencil_tile.cuh map_index: zeros for K1 and K3). Each output is one fma
// chain over k = 0 .. ws - 1 in that order, starting from zero, and the
// last ws mod 4 taps run one at a time, so that no padding tap meets a
// sample outside the window: the outputs are bit for bit those of the
// stencil_tile.cuh row_taps4 loop (P1, probe_dma1d.cu), NaN and inf
// included.
//
// Bound. At 25 taps device-memory bytes (8 B a sample in f32, 0.321 ms at
// the 1D headline's 128 x 2^20 on the data sheet's 3.35 TB/s); at 101 taps
// the FMAs (2 ws flops a sample, 0.405 ms at 67 TFLOP/s). Both derived.
//
// Schedule (its Python statement: tests/_exact_plan.py).
// - A row has tiles = ceil((n_out + V - 1) / tile) tiles of tile = 256 Q
//   outputs, V = 16 / sizeof(T) samples a 16-byte copy. Tile t of a row
//   starts at output o0 = t tile - s, where the row's shift s in [0, V)
//   puts the first staged sample, in0 = o0 + off, on a 16-byte boundary of
//   the row, so that every tile stages by 16-byte copies whatever N and the
//   row's offset (P1's rule). Outputs outside [0, n_out) are computed
//   and not stored; a row's last tile may store nothing.
// - The (row, tile) pairs are numbered row by row, and block i walks ids
//   i, i + G, i + 2 G, ... on G = min(tiles in all, blocks the card holds
//   at once) blocks (launch below), so a short launch still starts one
//   block a tile.
// - A ring of S stages (3 in f32, 2 in f64) in dynamic shared memory
//   holds a tile's span of tile + (ws & ~3) + 4 samples each; the copies of
//   the next S - 1 tiles of the block are in flight while it computes one.
//   One block barrier a tile: after it a stage's last readers are done,
//   and the block starts the copies of the tile S - 1 ahead into it.
// - An interior tile stages by one bulk copy (cp.async.bulk, the tensor
//   memory accelerator) issued by thread 0, which completes on the stage's
//   mbarrier; every thread waits on it. At the 1D headline on an H100 this
//   ran 1-3.5% faster than 16-byte cp.async from every thread
//   (probes/variants.py exact: cp_async). Only a tile whose span leaves
//   [0, N) takes the per-chunk path: 16-byte cp.async of the chunks inside
//   the row, a chunk that straddles a row end copied sample by sample, a
//   sample past it mapped (map_index) or zero.
//
// Tap loop. Thread t owns outputs o0 + Q t + [0, Q) and slides a register
// window r of Q + 4 samples over the staged span: each group of 4 taps
// costs one 16-byte load of 4 new samples (f64: two) and one broadcast
// load of the 4 taps for 4 Q FMAs. Q sizeof(T) is an odd multiple of 16
// bytes (48 in f32, 80 in f64), so the 8 threads of a 16-byte shared load
// phase hit 8 different bank groups: a phase is one wavefront. At Q = 4
// (the row_taps4 tile) a group's 5 wavefronts take as long as its 16 FMAs
// (derived), so the FMA pipe waited on shared memory at wide windows.
// Windows of 101 taps run an unrolled instance; every other width runs
// the runtime-width loop, 8 groups unrolled a step.
//
// Stores. A thread's Q outputs span 48 bytes (f32), so 16-byte stores
// straight from its registers write every 32-byte sector in two pieces
// from two instructions; at the 1D headline's 25 taps on an H100 that took
// 1.4-1.5 times as long (probes/variants.py exact: registers). So each
// warp writes its 32 Q outputs into a shared slot of its own, shifted by
// the row's misalignment at the tile, and its lanes store the slot's
// 16-byte units as the row's (512 bytes a warp instruction), ordered by
// warp barriers alone; a misaligned row's first and last outputs of the
// warp go one at a time. Tiles that reach a row's ends (or K1's edge
// outputs, which this tile does not compute) store output by output from
// registers.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "bulk_copy.cuh"
#include "stencil_tile.cuh"

namespace sgx {

// a stage's mbarrier: one arrival a use, by thread 0, which also counts the
// bytes of the stage's bulk copy
using sgb::bar_arrive;
using sgb::bar_init;
using sgb::bar_wait;
using sgb::bulk_copy;
using sgb::smem_addr;
using sgt::madd;

constexpr int kThreads = 256;
// Outputs a thread: Q sizeof(T) an odd multiple of 16 bytes (above).
constexpr int kQF32 = 12;
constexpr int kQF64 = 10;
template <typename T> constexpr int kQ = sizeof(T) == 4 ? kQF32 : kQF64;
// Stages of the ring: f64 two, so that three blocks share an SM (their
// registers allow three; three stages of f64 spans leave room for two).
constexpr int kStagesF32 = 3;
constexpr int kStagesF64 = 2;
template <typename T> constexpr int kStages =
    sizeof(T) == 4 ? kStagesF32 : kStagesF64;
// Blocks an SM that __launch_bounds__ asks for (a register cap: f32 64
// registers a thread, f64 80).
template <typename T> constexpr int kBlocks = sizeof(T) == 4 ? 4 : 3;
// Groups of 4 taps a step of the runtime-width loop.
constexpr int kChunk = 8;
// Taps slots in shared memory, before the ring (16-byte aligned stages).
constexpr int kTapSlots = sgt::ws_pad(sgt::kMaxWs);

template <typename T> __host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}
template <typename T> __host__ __device__ constexpr int tile() {
  return kThreads * kQ<T>;
}
// Samples a stage holds: the last thread reads up to tile + (ws & ~3) + 3.
template <typename T> __host__ __device__ constexpr int span(int ws) {
  return tile<T>() + (ws & ~3) + 4;
}
// A warp's slot of the output buffers: its 32 threads' outputs, and room to
// shift them by up to V - 1 samples.
template <typename T> __host__ __device__ constexpr int slot_size() {
  return 32 * kQ<T> + vec<T>();
}

// Shared memory a block: the taps, the ring, and the warps' output buffers.
template <typename T> __host__ __device__ constexpr long long smem_bytes(
    int ws) {
  return static_cast<long long>(sizeof(T)) *
         (kTapSlots + static_cast<long long>(kStages<T>) * span<T>(ws) +
          kThreads / 32 * slot_size<T>());
}
// Tiles of a row of n_out outputs (the row's shift is below vec()).
template <typename T> __host__ __device__ constexpr long long tiles(
    long long n_out) {
  return (n_out + vec<T>() - 1 + tile<T>() - 1) / tile<T>();
}

// What a launch computes: output j of row b reads xv[j + off + k] of row b
// (N samples) and goes to out[b n_out + j]. K1 (edge > 0): its outputs j <
// edge and j >= N - edge are fitted from ew (sg1d_poly.cu), the others
// here; mode: the pad mode of K2, kZero for K1 and K3.
template <typename T> struct Args {
  const T* x;
  const T* w;
  const T* ew;
  T* out;
  long long N, n_out, tiles, total;
  int ws, off, edge, mode;
  T lead_sign;
};

// -- copies ------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_one(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_one(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most P committed groups of this thread are in flight.
template <int P> __device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(P) : "memory");
}

// Starts the copies of xv[in0, in0 + n) of a row of N samples into st
// (xrow + in0 16-byte aligned, n a multiple of vec<T>()): an interior tile
// by one bulk copy from thread 0, on bar; a tile that leaves [0, N) by
// 16-byte cp.async of its chunks inside the row (thread 0 arriving on bar
// with no bytes). No commit.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ xrow, long long N,
                                      long long in0, int n, int mode,
                                      T* __restrict__ st, uint64_t* bar) {
  constexpr int V = vec<T>();
  const int chunks = n / V;
  if (in0 >= 0 && in0 + n <= N) {   // interior: one bulk copy
    if (threadIdx.x == 0)
      bulk_copy(st, xrow + in0, static_cast<unsigned>(n * sizeof(T)), bar);
    return;
  }
  if (threadIdx.x == 0) bar_arrive(bar, 0);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const long long g = in0 + static_cast<long long>(V) * c;
    T* dst = st + V * c;
    if (g >= 0 && g + V <= N) {
      copy16(dst, xrow + g);
      continue;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {   // past an end: mapped, or zero
      const long long i = sgt::map_index<true>(g + e, N, mode);
      if (i >= 0)
        copy_one(dst + e, xrow + i);
      else
        dst[e] = T(0);
    }
  }
}

// -- the tap loop ------------------------------------------------------------

// p[0, M) into r[0, M) by 16-byte shared loads (p 16-byte aligned).
template <typename T, int M>
__device__ __forceinline__ void load(const T* __restrict__ p, T* r) {
#pragma unroll
  for (int i = 0; i < M; i += vec<T>()) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
    } else {
      const double2 v = *reinterpret_cast<const double2*>(p + i);
      r[i] = v.x; r[i + 1] = v.y;
    }
  }
}

// G groups of 4 taps, w[0, 4 G), on the window r = row[0, Q + 4); leaves r
// = row[4 G, 4 G + Q + 4).
template <typename T, int Q, int G>
__device__ __forceinline__ void groups(const T* __restrict__ row,
                                       const T* __restrict__ w, T (&r)[Q + 4],
                                       T (&acc)[Q]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    T wv[4];
    load<T, 4>(w + 4 * g, wv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[j] = madd(wv[kk], r[j + kk], acc[j]);
#pragma unroll
    for (int i = 0; i < Q; ++i) r[i] = r[i + 4];
    load<T, 4>(row + 4 * g + Q + 4, r + Q);
  }
}

// The last rem < 4 taps w[0, rem), one at a time, on r = the window at them.
template <typename T, int Q>
__device__ __forceinline__ void tail(const T* __restrict__ w, int rem,
                                     const T (&r)[Q + 4], T (&acc)[Q]) {
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    if (kk < rem) {
      const T wk = w[kk];
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[j] = madd(wk, r[j + kk], acc[j]);
    }
  }
}

// acc[j] = sum_{k < ws} w[k] row[j + k], j < Q: WS > 0 a compile-time
// window, WS = 0 any ws in [1, kMaxWs].
template <typename T, int Q, int WS>
__device__ __forceinline__ void taps(const T* __restrict__ row,
                                     const T* __restrict__ w, int ws,
                                     T (&acc)[Q]) {
  T r[Q + 4];
  load<T, Q + 4>(row, r);
  if constexpr (WS > 0) {
    groups<T, Q, WS / 4>(row, w, r, acc);
    tail<T, Q>(w + (WS & ~3), WS & 3, r, acc);
  } else {
    const int full = ws & ~3;
    int g = 0;
    for (; g + 4 * kChunk <= full; g += 4 * kChunk)
      groups<T, Q, kChunk>(row + g, w + g, r, acc);
    switch ((full - g) / 4) {
      case 1: groups<T, Q, 1>(row + g, w + g, r, acc); break;
      case 2: groups<T, Q, 2>(row + g, w + g, r, acc); break;
      case 3: groups<T, Q, 3>(row + g, w + g, r, acc); break;
      case 4: groups<T, Q, 4>(row + g, w + g, r, acc); break;
      case 5: groups<T, Q, 5>(row + g, w + g, r, acc); break;
      case 6: groups<T, Q, 6>(row + g, w + g, r, acc); break;
      case 7: groups<T, Q, 7>(row + g, w + g, r, acc); break;
      default: break;
    }
    tail<T, Q>(w + full, ws - full, r, acc);
  }
}

// -- stores ------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store16(T* p, const T* v) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// -- the kernel body ---------------------------------------------------------

// A row's tile: its first output o0 and the row pointers.
template <typename T> struct Tile {
  const T* xrow;
  T* orow;
  long long o0;
};

template <typename T>
__device__ __forceinline__ Tile<T> tile_at(const Args<T>& a, long long id) {
  // 32-bit: a launch has fewer than 2^31 tiles (launch)
  const unsigned b32 = static_cast<unsigned>(id) /
                       static_cast<unsigned>(a.tiles);
  const long long b = b32;
  const T* xrow = a.x + b * a.N;   // 64-bit: B * N passes 2^31
  constexpr int V = vec<T>();
  const int e = static_cast<int>(
      (reinterpret_cast<uintptr_t>(xrow) / sizeof(T)) & (V - 1));
  const int s = (((e + a.off) % V) + V) % V;
  return {xrow, a.out + b * a.n_out,
          static_cast<long long>(static_cast<unsigned>(id) -
                                 b32 * static_cast<unsigned>(a.tiles)) *
                  tile<T>() -
              s};
}

// K1's edge outputs in [o0, o0 + tile): each a ws-tap fit of the row's end
// window with its row of ew, read from device memory (sg1d_poly.cu).
template <typename T>
__device__ void edge_outputs(const Args<T>& a, const Tile<T>& t) {
  const int n = a.edge, ws = a.ws;
  for (int i = threadIdx.x; i < tile<T>(); i += kThreads) {
    const long long j = t.o0 + i;
    if (j < 0) continue;
    if (j >= a.N) break;
    if (j < n) {
      const T* __restrict__ e = a.ew + j * ws;
      T acc = T(0);
      for (int k = 0; k < ws; ++k) acc = madd(e[k], t.xrow[ws - 1 - k], acc);
      t.orow[j] = a.lead_sign * acc;
    } else if (j >= a.N - n) {
      const T* __restrict__ e = a.ew + (a.N - 1 - j) * ws;
      const T* __restrict__ xt = t.xrow + (a.N - ws);
      T acc = T(0);
      for (int k = 0; k < ws; ++k) acc = madd(e[k], xt[k], acc);
      t.orow[j] = acc;
    }
  }
}

// Stores a tile clear of the row's ends, p = its first output (m samples
// past a 16-byte boundary), through ob: each warp writes its 32 Q outputs
// into its slot shifted by m, so that the row's 16-byte units lie on
// 16-byte units of the slot, then its lanes store those units (the warp's
// first V - m and last m outputs one at a time). A warp reads and writes
// only its own slot, so warp barriers order it.
template <typename T, int Q>
__device__ __forceinline__ void store_warps(T* __restrict__ p,
                                            T* __restrict__ ob,
                                            const T (&acc)[Q]) {
  constexpr int V = vec<T>(), kRun = 32 * Q, kUnits = kRun / V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* const slot = ob + warp * slot_size<T>();
  T* const q = p + warp * kRun;
  const int m = static_cast<int>(
      (reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (V - 1));
  const int h = (V - m) & (V - 1);   // outputs before the first unit
  T* const dst = slot + Q * lane + m;
  if (m == 0) {
#pragma unroll
    for (int c = 0; c < Q; c += V) store16(dst + c, acc + c);
    __syncwarp();
#pragma unroll
    for (int c = lane; c < kUnits; c += 32) {
      T v[V];
      load<T, V>(slot + V * c, v);
      store16(q + V * c, v);
    }
  } else {
    if (sizeof(T) == 4 && m == 2) {
#pragma unroll
      for (int c = 0; c < Q; c += 2)
        *reinterpret_cast<float2*>(dst + c) = make_float2(acc[c], acc[c + 1]);
    } else {
#pragma unroll
      for (int c = 0; c < Q; ++c) dst[c] = acc[c];
    }
    __syncwarp();
    for (int c = lane; c < kUnits - 1; c += 32) {   // from the unit at q + h
      T v[V];
      load<T, V>(slot + V + V * c, v);
      store16(q + h + V * c, v);
    }
    if (lane < h)
      q[lane] = slot[m + lane];
    else if (lane < V)
      q[kRun - V + lane] = slot[m + kRun - V + lane];
  }
  __syncwarp();   // the slot is read before the next tile writes it
}

// Computes and stores one tile from its stage st.
template <typename T, int WS>
__device__ __forceinline__ void tile_out(const Args<T>& a, const Tile<T>& t,
                                         const T* __restrict__ st,
                                         const T* __restrict__ w,
                                         T* __restrict__ ob) {
  constexpr int Q = kQ<T>;
  if (t.o0 >= a.n_out) return;   // a row's last tile, past its end
  T acc[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) acc[j] = T(0);
  taps<T, Q, WS>(st + Q * threadIdx.x, w, WS > 0 ? WS : a.ws, acc);

  const long long lo = a.edge, hi = a.n_out - a.edge;   // outputs stored here
  if (t.o0 >= lo && t.o0 + tile<T>() <= hi) {   // uniform over the block
    store_warps<T, Q>(t.orow + t.o0, ob, acc);
    return;
  }
  const long long j0 = t.o0 + Q * threadIdx.x;
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (j0 + q >= lo && j0 + q < hi) t.orow[j0 + q] = acc[q];
  if (a.edge > 0) edge_outputs(a, t);
}

// The kernel: the block's tiles through the ring (see the top of the file).
template <typename T, int WS>
__device__ __forceinline__ void run(const Args<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const w = reinterpret_cast<T*>(smem_raw);
  T* const ring = w + kTapSlots;
  const int ws = WS > 0 ? WS : a.ws;
  const int n = span<T>(ws);
  T* const ob = ring + kStages<T> * n;   // the warps' output buffers
  __shared__ uint64_t bars[kStages<T>];   // a stage's barrier
  for (int k = threadIdx.x; k < ws; k += kThreads) w[k] = a.w[k];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages<T>; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages<T> - 1; ++s) {
    const long long id = blockIdx.x + s * step;
    if (id < a.total) {
      const Tile<T> t = tile_at(a, id);
      stage(t.xrow, a.N, t.o0 + a.off, n, a.mode, ring + s * n, bars + s);
    }
    commit();
  }
  int slot = 0;
  unsigned phase = 0;   // bit s: the parity of stage s's next phase
  for (long long id = blockIdx.x; id < a.total; id += step) {
    wait_prior<kStages<T> - 2>();   // this thread's copies of tile id landed
    bar_wait(bars + slot, (phase >> slot) & 1);   // ... and its bulk copy
    phase ^= 1u << slot;
    __syncthreads();   // every thread's too, and the last tile's readers
                       // are done with its stage
    const long long ahead = id + (kStages<T> - 1) * step;
    if (ahead < a.total) {
      const Tile<T> t = tile_at(a, ahead);
      const int to = slot == 0 ? kStages<T> - 1 : slot - 1;
      stage(t.xrow, a.N, t.o0 + a.off, n, a.mode, ring + to * n, bars + to);
    }
    commit();
    tile_out<T, WS>(a, tile_at(a, id), ring + slot * n, w, ob);
    slot = slot + 1 == kStages<T> ? 0 : slot + 1;
  }
}

// Blocks of `kernel` that the current device holds at once with `smem`
// bytes of dynamic shared memory a block. The runtime is asked once for
// each device, kernel and smem, and the kernel's limit is raised then to
// `max_smem`, the most any window takes: the queries cost host time on
// every call, and streaming launches K3 on each short chunk.
inline cudaError_t resident(const void* kernel, int smem, int max_smem,
                            long long* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, long long> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, kernel, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = known[key] = static_cast<long long>(sms) * per_sm;
  return cudaSuccess;
}

// Launches kernel, an instance of run<T, WS>, over the tiles of B rows
// on as many blocks as the card holds at once (fills a.tiles, a.total).
template <typename T>
cudaError_t launch(void (*kernel)(const Args<T>), Args<T> a, long long B,
                   cudaStream_t stream) {
  a.tiles = tiles<T>(a.n_out);
  a.total = a.tiles * B;
  if (B <= 0 || a.total <= 0 || a.total >= (1LL << 31))
    return cudaErrorInvalidConfiguration;
  const int smem = static_cast<int>(smem_bytes<T>(a.ws));
  long long blocks = 0;
  const cudaError_t err =
      resident(reinterpret_cast<const void*>(kernel), smem,
               static_cast<int>(smem_bytes<T>(sgt::kMaxWs)), &blocks);
  if (err != cudaSuccess) return err;
  if (blocks <= 0 || blocks > a.total) blocks = a.total;
  kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace sgx
