// P1: VALID 1D correlation on a double-buffered cp.async pipeline,
//
//     out[b, j] = sum_{k < ws} w[k] * x[b, j + k],   0 <= j < n_out,
//
// with n_out <= N - ws + 1 (the headline geometry computes 2^20 outputs of
// rows of 2^20 + 128 samples).
//
// Replaces the TPU probe benchmarks/probe_dma1d.py::corr1d_dma_call
// [:159, pl.pallas_call :185] (body _corr1d_dma_kernel :46): one instance a
// row group walks every column block of its rows with the next block's DMA in
// flight while the current one is multiplied. The question it asks is the
// same here: whether overlapping the next tile's loads with the current
// tile's taps moves a VALID correlation toward its byte bound. K3
// (corr1d_valid.cu) stages a tile, computes, stores, and keeps nothing in
// flight across tiles inside a block.
//
// Bound: device-memory bytes, as K3's: 4 B read and 4 B written an output
// (the data sheet's 3.35 TB/s; 2 ws FLOPs an output are far under the f32
// peak).
//
// Mapping of the JAX call's parameters. One TPU instance a group of `rows`
// rows would leave the card nearly empty (B / rows = 1 to 16 blocks on 132
// SMs), so the instance is cut up:
//   * a block computes ONE row; the `rows` rows of a group are consecutive
//     blocks (block index = (group, span, row in group) with the row fastest),
//     so the blocks of a group walk the same columns together, as the TPU
//     instance streams a (rows, cols) slab;
//   * each row's tiles of `cols` outputs are split into column spans, enough
//     for about kWaves waves of resident blocks on the card, and a block walks
//     the tiles of its span in order;
//   * a tile is `cols` outputs: the block's 256 threads take 4 consecutive
//     outputs each, cols / 1024 times (sgt::row_taps4, K3's tap loop in K3's
//     tap order, so P1's outputs are bit-equal to K3's on the same input).
// A two-stage ring in shared memory holds a tile's cols + ws - 1 samples
// (rounded up as row_taps4 reads them) and the next tile's, which are in
// flight by cp.async (commit_group / wait_group 1 and a barrier on each side
// of the taps) while the taps run on the current stage.
//
// Alignment. A 16-byte cp.async needs a 16-byte-aligned source, and a row
// starts aligned only when its offset is a multiple of 4 samples. So each
// row's tiles are shifted left by the row's misalignment `shift` (0..3
// samples): tile t stages x[t cols - shift, ...), which is aligned, and
// computes outputs t cols - shift + [0, cols); outputs outside [0, n_out) are
// not stored. Any N runs on 16-byte copies; only the chunks that straddle the
// row's start or end take 4-byte copies (and zeros outside the row), the
// counterpart of the TPU probe's unmasked overlapped tail. A store of 4
// outputs is one 16-byte store where the output row allows it, else 4 scalar
// stores.
#include <cstdint>

#include "stencil_tile.cuh"

namespace {

using sgt::kQ;
using sgt::kThreads;

constexpr int kPass = kThreads * kQ;   // outputs of one pass over a stage
constexpr int kLanes = 128;            // cols granularity (the TPU's lanes)
constexpr int kMaxCols = 8192;
constexpr int kMinBlocks = 4;          // resident blocks __launch_bounds__ asks
constexpr int kWaves = 4;              // waves of resident blocks per launch

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issues the copies of x[in0, in0 + span) of a row of N samples into st
// (span a multiple of 4, xrow + in0 16-byte aligned); samples outside [0, N)
// are zero. No wait and no barrier.
__device__ __forceinline__ void issue_stage(const float* __restrict__ xrow,
                                            long long N, long long in0,
                                            int span, float* __restrict__ st) {
  for (int c = threadIdx.x; c < span / 4; c += kThreads) {
    const long long g = in0 + 4LL * c;
    float* dst = st + 4 * c;
    if (g >= 0 && g + 4 <= N) {
      cp_async16(dst, xrow + g);
    } else if (g >= N || g + 4 <= 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {                      // straddles the row's start or end
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (g + e >= 0 && g + e < N)
          cp_async4(dst + e, xrow + g + e);
        else
          dst[e] = 0.f;
      }
    }
  }
}

// Stores acc to out row positions j .. j + 3 that lie in [0, n_out).
__device__ __forceinline__ void store4(float* __restrict__ orow, long long j,
                                       long long n_out, const float acc[kQ]) {
  if (j >= 0 && j + kQ <= n_out &&
      (reinterpret_cast<uintptr_t>(orow + j) & 15) == 0) {
    *reinterpret_cast<float4*>(orow + j) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (j + q >= 0 && j + q < n_out) orow[j + q] = acc[q];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
corr1d_dma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, long long N, long long n_out,
                  int ws, int rows, int cols, int spans, int tiles_per_span) {
  extern __shared__ __align__(16) float smem[];
  const int wpad = sgt::ws_pad(ws);
  // the samples a tile stages: row_taps4 at the last thread's outputs reads
  // up to index cols + (ws & ~3) + 3
  const int span = cols + (ws & ~(kQ - 1)) + kQ;
  float* const wsm = smem;
  float* const ring = smem + wpad;          // stage s at ring + s * span

  const long long per_group = static_cast<long long>(rows) * spans;
  const long long group = blockIdx.x / per_group;
  const int in_group = static_cast<int>(blockIdx.x % per_group);
  const long long b = group * rows + in_group % rows;
  const long long s = in_group / rows;
  const float* __restrict__ xrow = x + b * N;     // 64-bit: B * N > 2^31
  float* __restrict__ orow = out + b * n_out;

  const int shift = static_cast<int>(
      (reinterpret_cast<uintptr_t>(xrow) / sizeof(float)) & 3);
  const long long tiles = (n_out + shift + cols - 1) / cols;
  const long long t_begin = s * tiles_per_span;
  const long long t_end = min(t_begin + tiles_per_span, tiles);
  if (t_begin >= t_end) return;

  for (int k = threadIdx.x; k < wpad; k += kThreads)
    wsm[k] = k < ws ? w[k] : 0.f;
  issue_stage(xrow, N, t_begin * cols - shift, span, ring);
  cp_async_commit();

  for (long long t = t_begin; t < t_end; ++t) {
    const int cur = static_cast<int>((t - t_begin) & 1);
    if (t + 1 < t_end)
      issue_stage(xrow, N, (t + 1) * cols - shift, span,
                  ring + (cur ^ 1) * span);
    cp_async_commit();       // an empty group on the last tile keeps the count
    cp_async_wait_one();     // this thread's copies of tile t have landed
    __syncthreads();         // ... and every thread's (and the taps)

    const float* st = ring + cur * span;
    const long long j0 = t * cols - shift;
    for (int base = threadIdx.x * kQ; base < cols; base += kPass) {
      float acc[kQ] = {0.f, 0.f, 0.f, 0.f};
      sgt::row_taps4(st + base, wsm, ws, acc);
      store4(orow, j0 + base, n_out, acc);
    }
    __syncthreads();         // stage cur is read before tile t + 2 lands in it
  }
}

}  // namespace

// x (B, N), w (ws,), out (B, n_out), all float32 on the current device; B a
// positive multiple of rows, 1 <= n_out <= N - ws + 1, 1 <= ws <= 129, cols a
// multiple of 128 in [128, 8192]. Returns the launch's cudaError_t.
extern "C" int corr1d_dma_f32(const float* x, const float* w, float* out,
                              long long B, long long N, int ws,
                              long long n_out, int rows, int cols,
                              void* stream) {
  if (ws < 1 || ws > sgt::kMaxWs || N < ws || n_out < 1 ||
      n_out > N - ws + 1 || rows < 1 || B < rows || B % rows != 0 ||
      cols < kLanes || cols > kMaxCols || cols % kLanes != 0)
    return cudaErrorInvalidValue;
  const int span = cols + (ws & ~(kQ - 1)) + kQ;
  const size_t smem = (sgt::ws_pad(ws) + 2 * static_cast<size_t>(span)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      corr1d_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, corr1d_dma_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the most tiles a row takes (its shift is at most 3 samples), cut into
  // spans so that B * spans blocks fill about kWaves waves
  const long long tiles = (n_out + 3 + cols - 1) / cols;
  long long spans = (static_cast<long long>(kWaves) * sms * per_sm + B - 1) / B;
  spans = spans < 1 ? 1 : (spans > tiles ? tiles : spans);
  const long long per_span = (tiles + spans - 1) / spans;
  spans = (tiles + per_span - 1) / per_span;
  const long long blocks = B * spans;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  corr1d_dma_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, w, out, N, n_out, ws, rows, cols, static_cast<int>(spans),
      static_cast<int>(per_span));
  return cudaGetLastError();
}
