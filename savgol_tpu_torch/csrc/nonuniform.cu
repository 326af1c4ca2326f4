// K11: the fused nonuniform Savitzky-Golay fit, and its planes mode K11p.
//
// Per output position p of a row, over p's 2n+1 index-neighbours (edges
// truncate: weight 0 outside the row):
//
//   u_j = t[p+j] - t[p]  in t's own dtype, 0 where w_j = 0 (sanitized, so a
//                        NaN or epoch-scale offset never meets a zero weight)
//   s   = max |u_j| over valid taps (1 when all coincide), quorum = count >= kmin
//   S_q = sum_j w_j (u_j/s)^q, q <= 2m;  r_q = sum_j w_j x_j (u_j/s)^q, q <= m
//   G c = r with G[i, j] = S[i+j], solved with the rcond rule
//   out = c_d d! / s^d, or fill where not ok          (K11)
//   out[0..m] = c, out[m+1] = s, out[m+2] = ok as 0/1  (K11p, emit_planes)
//
// Replaces the TPU kernel savgol_tpu/ops/pallas_nonuniform.py::_nonuni_call
// (body _nonuni_kernel, both modes). The design matrix is the plain
// version's bit for bit (ops/cuda_nonuniform.py::_fit_coeffs): u cast to the
// working dtype after the subtraction, s and 1/s, u/s and w*x each rounded
// once in the working dtype. The moments, the rhs and the solve
// (plane_chol.cuh::dd_chol_solve, K8b's) run in double-word arithmetic on
// FP64 pairs for both working dtypes: float32 values enter FP64 exactly and
// a TwoProd is one fma, so the float32 contract (double-word float32, eps
// ~2^-48) is met with room to spare and the float64 one (eps ~2^-106) is the
// plain version's own.
//
// Design: a block of 128 threads stages t, x and w for 128 outputs of one
// row and their 2n halo in shared memory, then each thread owns one output:
// the normalizer pass, the moment pass, the Hankel expansion into the
// solve's workspace, the solve and the output. For k = m + 1 <= 8 the moment
// loop is unrolled to its compile-time bound (5 or 8) with a uniform guard,
// so the moments stay in registers (ptxas: 128 and 168 registers) and the
// solve's workspace is a local array (0.8 and 1.7 KB of stack). Past k = 8
// the moments and the workspace take the thread's interleaved slice of a
// device scratch buffer (96 registers, no stack): a local-array variant for
// k <= 32 spilled 2 KB and held 20 KB of stack, and doubled the build time.
// Any n that shared memory holds is taken. Bound: FP64 arithmetic, ~(5m+2)
// double-word products and (3m+2) double-word sums a tap (~330 FP64
// operations at m = 4, ~8.3 k a sample at n = 12) plus the k x k
// double-word solve, against 16-20 B of device memory a sample.
#include "plane_chol.cuh"

namespace {

using namespace sgtsolve;
constexpr int kTile = 128;                   // outputs and threads per block
constexpr int kNonuniLocalKmax = 8;          // larger k takes device scratch

// Doubles of one thread's scratch: moments and rhs (hi, lo), then the
// double-word solve workspace.
__host__ __device__ constexpr long long mom_size(int k) {
  return 2LL * (2 * k - 1) + 2LL * k;
}
__host__ __device__ constexpr long long nonuni_work(int k) {
  return mom_size(k) + dd_work_size(k);
}

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Shared memory of one block: t, x and w of the tile and its 2n halo, each
// array 16-byte aligned, in the kernel's order.
constexpr size_t smem_bytes(int n, size_t x_size, size_t t_size) {
  return align16(t_size * (kTile + 2 * static_cast<size_t>(n))) +
         2 * align16(x_size * (kTile + 2 * static_cast<size_t>(n)));
}

// dd * double, the plain version's _dd_mul(x, (y, 0)) with its cross term
// in one fma
__device__ __forceinline__ dd dd_mul_d(dd x, double y) {
  const dd p = two_prod(x.hi, y);
  return quick_two_sum(p.hi, fma(x.lo, y, p.lo));
}

template <typename T, typename TT, int KMAX>
__global__ void __launch_bounds__(kTile)
nonuniform_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const TT* __restrict__ t, T* __restrict__ out, long long N,
                  long long t_stride, long long tiles, long long total_tiles,
                  long long plane_stride, int n, int m, int d, int kmin,
                  T fill, double sqrt_rcond, int emit_planes,
                  double* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = 2 * n + 1, span = kTile + 2 * n, k = m + 1;
  const int n_mom = 2 * m + 1;
  TT* st = reinterpret_cast<TT*>(smem);
  T* sx = reinterpret_cast<T*>(smem + align16(sizeof(TT) * span));
  T* sw = reinterpret_cast<T*>(smem + align16(sizeof(TT) * span) +
                               align16(sizeof(T) * span));

  // moments: compile-time layout for KMAX > 0 (registers after unrolling),
  // the scratch slice's head for KMAX == 0
  constexpr int PM = KMAX > 0 ? 2 * KMAX - 1 : 1;
  double mloc[KMAX > 0 ? mom_size(KMAX) : 1];
  double wloc[KMAX > 0 ? dd_work_size(KMAX) : 1];
  const Span<double> base = thread_span(wloc, KMAX > 0 ? nullptr : scratch);
  const Span<double> mom = KMAX > 0 ? Span<double>{mloc, 1} : base;
  const int nm_x = KMAX > 0 ? PM : 2 * k - 1;      // slots of each moment word
  const int k_x = KMAX > 0 ? KMAX : k;
  const Span<double> Sh = mom, Sl = mom.at(nm_x), Rh = mom.at(2 * nm_x),
                     Rl = mom.at(2 * nm_x + k_x);
  const DdWork wk = dd_carve(KMAX > 0 ? base : base.at(mom_size(k)), k);
  const int pmax = KMAX > 0 ? PM : n_mom;

  double fact_d = 1.0;
  for (int i = 2; i <= d; ++i) fact_d *= i;

  for (long long tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const long long b = tile / tiles;
    const long long p0 = (tile % tiles) * kTile;
    const T* __restrict__ xr = x + b * N;
    const T* __restrict__ wr = w + b * N;
    const TT* __restrict__ tr = t + b * t_stride;
    for (int i = threadIdx.x; i < span; i += kTile) {
      const long long g = p0 - n + i;
      const bool inside = g >= 0 && g < N;
      st[i] = inside ? tr[g] : TT(0);
      sx[i] = inside ? xr[g] : T(0);
      sw[i] = inside ? wr[g] : T(0);
    }
    __syncthreads();
    const long long p = p0 + threadIdx.x;
    if (p < N) {
      const TT* __restrict__ tt = st + threadIdx.x;
      const T* __restrict__ xt = sx + threadIdx.x;
      const T* __restrict__ wt = sw + threadIdx.x;
      const TT tc = tt[n];
      // pass 1: the normalizer (NaN propagates, as jnp/torch maximum) and
      // the quorum count
      TT smax = TT(0);
      int count = 0;
      for (int j = 0; j < ws; ++j) {
        const bool valid = wt[j] > T(0);
        const TT au = valid ? fabs(tt[j] - tc) : TT(0);
        if (au > smax || isnan(au)) smax = au;
        count += valid;
      }
      const T s = static_cast<T>(smax > TT(0) ? smax : TT(1));
      const T sinv = T(1) / s;

      // pass 2: double-word Hankel moments and rhs
#pragma unroll
      for (int q = 0; q < pmax; ++q) {
        if (q < n_mom) {
          Sh[q] = 0.0;
          Sl[q] = 0.0;
        }
        if (q < k) {
          Rh[q] = 0.0;
          Rl[q] = 0.0;
        }
      }
      for (int j = 0; j < ws; ++j) {
        const T wj = wt[j];
        const bool valid = wj > T(0);
        const double wd = wj;
        const double wxd = mul_rn(wj, xt[j]);
        const TT u = valid ? tt[j] - tc : TT(0);
        const double und = mul_rn(static_cast<T>(u), sinv);
        dd pw = {1.0, 0.0};
#pragma unroll
        for (int q = 0; q < pmax; ++q) {
          if (q < n_mom) {
            const dd a = dd_add({Sh[q], Sl[q]}, dd_mul_d(pw, wd));
            Sh[q] = a.hi;
            Sl[q] = a.lo;
            if (q < k) {
              const dd c = dd_add({Rh[q], Rl[q]}, dd_mul_d(pw, wxd));
              Rh[q] = c.hi;
              Rl[q] = c.lo;
            }
            if (q + 1 < n_mom) pw = dd_mul_d(pw, und);
          }
        }
      }
      // the Hankel G[i, j] = S[i + j] into the solve's workspace, moment by
      // moment (a static index keeps the moments in registers)
#pragma unroll
      for (int q = 0; q < pmax; ++q) {
        if (q < n_mom) {
          for (int i = (q + 1) / 2; i <= q && i < k; ++i) {
            wk.gh[tri(i, q - i)] = Sh[q];
            wk.gl[tri(i, q - i)] = Sl[q];
          }
          if (q < k) {
            wk.rh[q] = Rh[q];
            wk.rl[q] = Rl[q];
          }
        }
      }
      const bool ok = dd_chol_solve(k, count >= kmin, true, sqrt_rcond, wk);
      const long long o = b * N + p;
      if (emit_planes) {
        for (int i = 0; i < k; ++i)
          out[i * plane_stride + o] = static_cast<T>(wk.ch[i] + wk.cl[i]);
        out[(m + 1) * plane_stride + o] = s;
        out[(m + 2) * plane_stride + o] = ok ? T(1) : T(0);
      } else {
        T sd = T(1);
        for (int i = 0; i < d; ++i) sd = sd * s;
        const T cd = static_cast<T>(wk.ch[d] + wk.cl[d]);
        out[o] = ok ? cd * (static_cast<T>(fact_d) / sd) : fill;
      }
    }
    __syncthreads();
  }
}

template <typename T, typename TT, int KMAX>
cudaError_t run(dim3 grid, size_t smem, cudaStream_t s, const T* x,
                const T* w, const TT* t, T* out, long long N,
                long long t_stride, long long tiles, long long total,
                long long plane_stride, int n, int m, int d, int kmin,
                T fill, double sqrt_rcond, int emit_planes, double* scratch) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nonuniform_kernel<T, TT, KMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nonuniform_kernel<T, TT, KMAX><<<grid, kTile, smem, s>>>(
      x, w, t, out, N, t_stride, tiles, total, plane_stride, n, m, d, kmin,
      fill, sqrt_rcond, emit_planes, scratch);
  return cudaGetLastError();
}

template <typename T, typename TT>
int launch(const T* x, const T* w, const TT* t, T* out, long long B,
           long long N, long long t_stride, int n, int m, int d, int kmin,
           double fill, double sqrt_rcond, int emit_planes, double* scratch,
           long long scratch_threads, void* stream) {
  if (n < 1 || m < 0 || m > 2 * n || d < 0 || d > m || B < 1 || N < 1)
    return cudaErrorInvalidValue;
  const int k = m + 1;
  const bool local = k <= kNonuniLocalKmax;
  if (!local && (scratch == nullptr || scratch_threads < kTile ||
                 scratch_threads % kTile != 0))
    return cudaErrorInvalidValue;
  const long long tiles = (N + kTile - 1) / kTile;
  const long long total = B * tiles;
  long long blocks = local ? total : scratch_threads / kTile;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  const dim3 grid(static_cast<unsigned>(blocks));
  const size_t smem = smem_bytes(n, sizeof(T), sizeof(TT));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T f = static_cast<T>(fill);
  const long long ps = B * N;
  if (k <= 5)
    return run<T, TT, 5>(grid, smem, s, x, w, t, out, N, t_stride, tiles,
                         total, ps, n, m, d, kmin, f, sqrt_rcond, emit_planes,
                         nullptr);
  if (k <= 8)
    return run<T, TT, 8>(grid, smem, s, x, w, t, out, N, t_stride, tiles,
                         total, ps, n, m, d, kmin, f, sqrt_rcond, emit_planes,
                         nullptr);
  return run<T, TT, 0>(grid, smem, s, x, w, t, out, N, t_stride, tiles, total,
                       ps, n, m, d, kmin, f, sqrt_rcond, emit_planes, scratch);
}

}  // namespace

// The launch's layout for the wrapper, so that it lives here alone: out[0]
// the shared memory of a block in bytes, out[1] the doubles of device
// scratch a thread (0 when k = m + 1 fits the unrolled local arrays), out[2]
// the outputs (and threads) of a block.
extern "C" int nonuniform_layout(int n, int m, int x_size, int t_size,
                                 long long* out) {
  if (n < 0 || m < 0 || x_size < 1 || t_size < 1) return cudaErrorInvalidValue;
  out[0] = static_cast<long long>(smem_bytes(n, x_size, t_size));
  out[1] = m + 1 <= kNonuniLocalKmax ? 0 : nonuni_work(m + 1);
  out[2] = kTile;
  return cudaSuccess;
}

#define SGT_NONUNIFORM(NAME, T, TT)                                          \
  extern "C" int NAME(const T* x, const T* w, const TT* t, T* out,           \
                      long long B, long long N, long long t_stride, int n,   \
                      int m, int d, int kmin, double fill, double sqrt_rcond, \
                      int emit_planes, double* scratch,                      \
                      long long scratch_threads, void* stream) {             \
    return launch<T, TT>(x, w, t, out, B, N, t_stride, n, m, d, kmin, fill,  \
                         sqrt_rcond, emit_planes, scratch, scratch_threads,  \
                         stream);                                            \
  }

SGT_NONUNIFORM(nonuniform_f32_t32, float, float)
SGT_NONUNIFORM(nonuniform_f32_t64, float, double)
SGT_NONUNIFORM(nonuniform_f64_t32, double, float)
SGT_NONUNIFORM(nonuniform_f64_t64, double, double)
