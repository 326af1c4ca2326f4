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
// converges to the solution of the stored system).
//
// Design: a block of 128 threads stages x*w and w for 128 outputs and their
// 2n halo in shared memory (zero past the row), then each thread owns one
// output: the count, the Kp Gram and k rhs correlations (stencil rows read
// through the read-only cache: every thread of a warp reads the same tap),
// the solve of plane_chol.cuh, the extraction and the fill. Bound:
// arithmetic, ~(Kp + k + 1) * ws + ~k^3 operations a sample against 8 B of
// device memory; the tables have no size limit (any m <= 2n), and shared
// memory holds 2 * (128 + 2n) samples (n up to ~7000 in f64).
#include "plane_chol.cuh"

namespace {

using namespace sgtsolve;
constexpr int kTile = 128;                   // outputs and threads per block

template <typename T, int KMAX>
__global__ void __launch_bounds__(kTile)
masked1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, long long Np, long long n_out,
                long long tiles, long long total_tiles, int n, int k,
                const T* __restrict__ pairs, const T* __restrict__ qt,
                const T* __restrict__ extract, int kmin, T fill, T* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = 2 * n + 1, span = kTile + 2 * n, kp = packed(k);
  T* sxw = reinterpret_cast<T*>(smem);
  T* sw = sxw + span;
  T local[KMAX > 0 ? work_size(KMAX) : 1];
  const Work<T> wk =
      carve(thread_span(local, KMAX > 0 ? nullptr : scratch), k);
  const T quorum_at = static_cast<T>(kmin - 0.5);

  for (long long tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const long long b = tile / tiles;
    const long long t0 = (tile % tiles) * kTile;
    const T* __restrict__ xr = x + b * Np;
    const T* __restrict__ wr = w + b * Np;
    for (int i = threadIdx.x; i < span; i += kTile) {
      const long long g = t0 + i;
      const T wv = g < Np ? wr[g] : T(0);
      const bool valid = wv > T(0);
      sw[i] = valid ? wv : T(0);
      sxw[i] = valid ? xr[g] * wv : T(0);
    }
    __syncthreads();
    const long long j = t0 + threadIdx.x;
    if (j < n_out) {
      const T* __restrict__ wt = sw + threadIdx.x;
      const T* __restrict__ xt = sxw + threadIdx.x;
      T count = T(0);
      for (int t = 0; t < ws; ++t) count += wt[t] > T(0) ? T(1) : T(0);
      // each product rounded, then each sum, taps in order: the plain
      // version's arithmetic, so both solve the same stored (G, r)
      for (int p = 0; p < kp; ++p) {
        const T* __restrict__ row = pairs + static_cast<long long>(p) * ws;
        T acc = T(0);
        for (int t = 0; t < ws; ++t) acc = add_rn(acc, mul_rn(__ldg(row + t), wt[t]));
        wk.G[p] = acc;
      }
      for (int a = 0; a < k; ++a) {
        const T* __restrict__ row = qt + static_cast<long long>(a) * ws;
        T acc = T(0);
        for (int t = 0; t < ws; ++t) acc = add_rn(acc, mul_rn(__ldg(row + t), xt[t]));
        wk.r[a] = acc;
      }
      const bool ok = chol_solve(k, count >= quorum_at, false, T(0), wk);
      T y = T(0);
      for (int a = 0; a < k; ++a) y = fma(__ldg(extract + a), wk.c[a], y);
      out[b * n_out + j] = ok ? y : fill;
    }
    __syncthreads();
  }
}

template <typename T, int KMAX>
cudaError_t run(dim3 grid, size_t smem, cudaStream_t s, const T* x,
                const T* w, T* out, long long Np, long long n_out,
                long long tiles, long long total, int n, int k,
                const T* pairs, const T* qt, const T* extract, int kmin,
                T fill, T* scratch) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked1d_kernel<T, KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  masked1d_kernel<T, KMAX><<<grid, kTile, smem, s>>>(
      x, w, out, Np, n_out, tiles, total, n, k, pairs, qt, extract, kmin,
      fill, scratch);
  return cudaGetLastError();
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
  const long long total = B * tiles;
  long long blocks = local ? total : scratch_threads / kTile;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  const dim3 grid(static_cast<unsigned>(blocks));
  const size_t smem = sizeof(T) * 2 * (kTile + 2 * static_cast<size_t>(n));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8)
    return run<T, 8>(grid, smem, s, x, w, out, Np, n_out, tiles, total, n,
                     k, pairs, qt, extract, kmin, fill, nullptr);
  if (k <= 16)
    return run<T, 16>(grid, smem, s, x, w, out, Np, n_out, tiles, total, n,
                      k, pairs, qt, extract, kmin, fill, nullptr);
  if (local)
    return run<T, kLocalKmax>(grid, smem, s, x, w, out, Np, n_out, tiles,
                              total, n, k, pairs, qt, extract, kmin, fill,
                              nullptr);
  return run<T, 0>(grid, smem, s, x, w, out, Np, n_out, tiles, total, n, k,
                   pairs, qt, extract, kmin, fill, scratch);
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
