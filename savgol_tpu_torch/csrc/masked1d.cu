// K9: the fused masked 1D Savitzky-Golay fit (normal equations),
//
//   out[b, j] = extract . c   where   G c = r  over the window x[b, j .. j+2n]
//   G[a, a'] = sum_t w_t phi_a(t) phi_a'(t),   r[a] = sum_t w_t x_t phi_a(t),
//
// or fill where fewer than kmin samples of the window have a positive
// weight. x and w are the (B, Np) boundary-padded values and weights
// (Np = N + 2n; truncate = zero weight outside the data), out is (B, Np - 2n):
// the VALID fit of the staged plain version (ops/masked.py). A sample takes
// part when its weight is > 0; its value is multiplied by its weight, and
// NaN values of missing samples never enter a product.
//
// Replaces the TPU kernel savgol_tpu/ops/pallas_masked.py::_masked1d_call
// (body _masked1d_kernel). The TPU kernel correlates the weights with
// S = 2m + 1 moment stencils on its MXU and rebuilds the Kp = (m+1)(m+2)/2
// Gram entries from them; that reconstruction costs it the 2e-5 gates of
// tests/test_fused_masked.py (test_weighted, test_odd_length_partial_block).
// Here each Gram entry is its own pair stencil phi_a * phi_a' (host f64,
// rows in packed lower order), correlated directly: Kp * ws multiply-adds a
// sample (375 at n = 12, m = 4) instead of the moment form's S * ws (225),
// cheap on this card. The correlations round as the plain version does (a
// rounded product, then a rounded sum, taps in order; no fma): a hole-starved
// or weighted window's cond(G) amplifies any difference in the stored Gram,
// and an fma accumulation measured 8.7e-5 against test_weighted's 2e-5 gate
// where this form matches the plain version bit for bit (the refined solve
// converges to the solution of the stored system). The solve and the
// extraction round as the plain version does too (plane_chol.cuh).
//
// Design: a block of 128 threads stages x*w and w for 128 outputs and their
// 2n halo in shared memory (zero past the row), then each thread owns one
// output: the count, the Kp Gram and k rhs correlations, the solve of
// plane_chol.cuh, the extraction and the fill. Bound: arithmetic, (Kp + k)
// * ws products and as many sums a sample (500 each at n = 12, m = 4), the
// count and ~k^3 for the solve, against 8 B of device memory.
//
// Two instances, chosen by the configuration alone:
//   masked1d_fixed<T, K, WS>, for k = K <= 8 where the stencils fit in shared
//     memory beside the tile: the block stages the pair and basis stencils
//     and the extraction row once (2 KB at n = 12, m = 4, f32) and then
//     walks its tiles. The solve's size is a compile-time constant, so its
//     whole workspace (60 values at k = 5) is registers. WS = 25 (n = 12,
//     the path's and the JAX benchmarks' window) also fixes the window: each
//     thread copies its 25 weights and 25 weighted values into registers and
//     every tap loop unrolls, so a tap costs a rounded product and a rounded
//     sum with its stencil tap read from shared memory by the whole warp at
//     once (a broadcast). WS = 0 keeps a runtime tap loop.
//   masked1d_kernel<T, KMAX>, the runtime form for the rest: k > 8, or
//     stencils past shared memory (n in the hundreds). Its workspace is a
//     local array of KMAX elements' worth, or an interleaved slice of device
//     scratch past k = 32; stencil rows are read through the read-only cache.
//     The tables have no size limit (any m <= 2n), and shared memory holds
//     2 * (128 + 2n) samples (n up to ~7000 in f64).
#include "launch.cuh"
#include "plane_chol.cuh"

namespace {

using namespace sgtsolve;
using sgtlaunch::kSmemMax;
constexpr int kTile = 128;                   // outputs and threads per block
constexpr int kFixedKmax = 8;                // largest compile-time k

template <typename T>
struct Args {
  const T* x;
  const T* w;
  T* out;
  long long Np, n_out, tiles, total_tiles;
  int n, k;
  const T* pairs;                // (Kp, ws), packed lower order
  const T* qt;                   // (k, ws)
  const T* extract;              // (k,)
  int kmin;
  T fill;
  T* scratch;
};

// Stages tile `tile`'s weights and weighted values (zero where the weight is
// not > 0 or past the row) into sw and sxw; returns (row, first output).
template <typename T>
__device__ __forceinline__ void stage_tile(const Args<T>& a, long long tile,
                                           int span, T* sxw, T* sw,
                                           long long& b, long long& t0) {
  b = tile / a.tiles;
  t0 = (tile % a.tiles) * kTile;
  const T* __restrict__ xr = a.x + b * a.Np;
  const T* __restrict__ wr = a.w + b * a.Np;
  for (int i = threadIdx.x; i < span; i += kTile) {
    const long long g = t0 + i;
    const T wv = g < a.Np ? wr[g] : T(0);
    const bool valid = wv > T(0);
    sw[i] = valid ? wv : T(0);
    sxw[i] = valid ? xr[g] * wv : T(0);
  }
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(kTile) masked1d_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, k = a.k;
  const int ws = 2 * n + 1, span = kTile + 2 * n, kp = packed(k);
  T* sxw = reinterpret_cast<T*>(smem);
  T* sw = sxw + span;
  T local[KMAX > 0 ? work_size(KMAX) : 1];
  const Work<T> wk =
      carve(thread_span(local, KMAX > 0 ? nullptr : a.scratch), k);
  const T quorum_at = static_cast<T>(a.kmin - 0.5);

  for (long long tile = blockIdx.x; tile < a.total_tiles; tile += gridDim.x) {
    long long b, t0;
    stage_tile(a, tile, span, sxw, sw, b, t0);
    __syncthreads();
    const long long j = t0 + threadIdx.x;
    if (j < a.n_out) {
      const T* __restrict__ wt = sw + threadIdx.x;
      const T* __restrict__ xt = sxw + threadIdx.x;
      T count = T(0);
      for (int t = 0; t < ws; ++t) count += wt[t] > T(0) ? T(1) : T(0);
      // each product rounded, then each sum, taps in order: the plain
      // version's arithmetic, so both solve the same stored (G, r)
      for (int p = 0; p < kp; ++p) {
        const T* __restrict__ row = a.pairs + static_cast<long long>(p) * ws;
        T acc = T(0);
        for (int t = 0; t < ws; ++t) acc = add_rn(acc, mul_rn(__ldg(row + t), wt[t]));
        wk.G[p] = acc;
      }
      for (int c = 0; c < k; ++c) {
        const T* __restrict__ row = a.qt + static_cast<long long>(c) * ws;
        T acc = T(0);
        for (int t = 0; t < ws; ++t) acc = add_rn(acc, mul_rn(__ldg(row + t), xt[t]));
        wk.r[c] = acc;
      }
      const bool ok = chol_solve<0>(k, count >= quorum_at, false, T(0), wk);
      T y = T(0);
      for (int c = 0; c < k; ++c)
        y = add_rn(y, mul_rn(__ldg(a.extract + c), wk.c[c]));
      a.out[b * a.n_out + j] = ok ? y : a.fill;
    }
    __syncthreads();
  }
}

// The count, the Kp Gram and K rhs correlations of one output over its ws
// weights wt and weighted values xt (a register array or shared memory) and
// the staged stencils tab (pair rows, then basis rows): each product
// rounded, then each sum, taps in order, as the plain version sums.
template <int K, typename T, typename V>
__device__ __forceinline__ T correlate(const V& wt, const V& xt,
                                       const T* tab, int ws,
                                       FixedWork<T, K>& wk) {
  constexpr int kp = packed(K);
  T count = T(0);
#pragma unroll
  for (int t = 0; t < ws; ++t) count += wt[t] > T(0) ? T(1) : T(0);
#pragma unroll
  for (int p = 0; p < kp; ++p) {
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < ws; ++t) acc = add_rn(acc, mul_rn(tab[p * ws + t], wt[t]));
    wk.G[p] = acc;
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < ws; ++t)
      acc = add_rn(acc, mul_rn(tab[(kp + c) * ws + t], xt[t]));
    wk.r[c] = acc;
  }
  return count;
}

template <typename T, int K, int WS>
__global__ void __launch_bounds__(kTile) masked1d_fixed(const Args<T> a) {
  constexpr int kp = packed(K);
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = WS > 0 ? WS : 2 * a.n + 1, span = kTile + ws - 1;
  T* tab = reinterpret_cast<T*>(smem);         // (kp + K) x ws stencils
  T* ext = tab + (kp + K) * ws;                // K
  T* sxw = ext + K;
  T* sw = sxw + span;
  for (int e = threadIdx.x; e < kp * ws; e += kTile) tab[e] = a.pairs[e];
  for (int e = threadIdx.x; e < K * ws; e += kTile) tab[kp * ws + e] = a.qt[e];
  if (threadIdx.x < K) ext[threadIdx.x] = a.extract[threadIdx.x];
  const T quorum_at = static_cast<T>(a.kmin - 0.5);

  for (long long tile = blockIdx.x; tile < a.total_tiles; tile += gridDim.x) {
    long long b, t0;
    stage_tile(a, tile, span, sxw, sw, b, t0);
    __syncthreads();
    const long long j = t0 + threadIdx.x;
    if (j < a.n_out) {
      FixedWork<T, K> wk;
      T count;
      if constexpr (WS > 0) {
        T wv[WS], xv[WS];
#pragma unroll
        for (int t = 0; t < WS; ++t) {
          wv[t] = sw[threadIdx.x + t];
          xv[t] = sxw[threadIdx.x + t];
        }
        count = correlate<K>(wv, xv, tab, WS, wk);
      } else {
        const T* wt = sw + threadIdx.x;
        const T* xt = sxw + threadIdx.x;
        count = correlate<K>(wt, xt, tab, ws, wk);
      }
      const bool ok = chol_solve<K>(K, count >= quorum_at, false, T(0), wk);
      T y = T(0);
#pragma unroll
      for (int c = 0; c < K; ++c) y = add_rn(y, mul_rn(ext[c], wk.c[c]));
      a.out[b * a.n_out + j] = ok ? y : a.fill;
    }
    __syncthreads();
  }
}

template <typename T, int K>
cudaError_t run_fixed(size_t smem, cudaStream_t s, const Args<T>& a) {
  return sgtlaunch::launch(a.n == 12 ? masked1d_fixed<T, K, 25>
                                     : masked1d_fixed<T, K, 0>,
                           a.total_tiles, kTile, smem, true, s, a);
}

template <typename T>
int launch(const T* x, const T* w, T* out, long long B, long long Np, int n,
           int k, const T* pairs, const T* qt, const T* extract, int kmin,
           T fill, T* scratch, long long scratch_threads, void* stream) {
  const long long n_out = Np - 2LL * n;
  if (n < 1 || k < 1 || B < 1 || n_out < 1) return cudaErrorInvalidValue;
  const bool local = k <= kLocalKmax;
  if (!local && (scratch == nullptr || scratch_threads < kTile ||
                 scratch_threads % kTile != 0))
    return cudaErrorInvalidValue;
  const long long tiles = (n_out + kTile - 1) / kTile;
  const Args<T> a{x, w, out, Np, n_out, tiles, B * tiles, n, k, pairs, qt,
                  extract, kmin, fill, local ? nullptr : scratch};
  const size_t ws = 2 * static_cast<size_t>(n) + 1;
  const size_t smem = sizeof(T) * 2 * (kTile + 2 * static_cast<size_t>(n));
  const size_t fixed_smem =
      smem + sizeof(T) * ((packed(k) + k) * ws + k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= kFixedKmax && fixed_smem <= kSmemMax) {
    switch (k) {
      case 1: return run_fixed<T, 1>(fixed_smem, s, a);
      case 2: return run_fixed<T, 2>(fixed_smem, s, a);
      case 3: return run_fixed<T, 3>(fixed_smem, s, a);
      case 4: return run_fixed<T, 4>(fixed_smem, s, a);
      case 5: return run_fixed<T, 5>(fixed_smem, s, a);
      case 6: return run_fixed<T, 6>(fixed_smem, s, a);
      case 7: return run_fixed<T, 7>(fixed_smem, s, a);
      default: return run_fixed<T, 8>(fixed_smem, s, a);
    }
  }
  void (*kernel)(const Args<T>) =
      k <= 8 ? masked1d_kernel<T, 8>
             : k <= 16 ? masked1d_kernel<T, 16>
                       : local ? masked1d_kernel<T, kLocalKmax>
                               : masked1d_kernel<T, 0>;
  return sgtlaunch::launch(kernel, local ? a.total_tiles
                                         : scratch_threads / kTile,
                           kTile, smem, false, s, a);
}

}  // namespace

extern "C" int masked1d_f32(const float* x, const float* w, float* out,
                            long long B, long long Np, int n, int k,
                            const float* pairs, const float* qt,
                            const float* extract, int kmin, float fill,
                            float* scratch, long long scratch_threads,
                            void* stream) {
  return launch<float>(x, w, out, B, Np, n, k, pairs, qt, extract, kmin,
                       fill, scratch, scratch_threads, stream);
}

extern "C" int masked1d_f64(const double* x, const double* w, double* out,
                            long long B, long long Np, int n, int k,
                            const double* pairs, const double* qt,
                            const double* extract, int kmin, double fill,
                            double* scratch, long long scratch_threads,
                            void* stream) {
  return launch<double>(x, w, out, B, Np, n, k, pairs, qt, extract, kmin,
                        fill, scratch, scratch_threads, stream);
}
