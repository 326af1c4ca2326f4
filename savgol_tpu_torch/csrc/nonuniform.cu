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
// the normalizer pass, the moment pass, the solve and the output. For
// k = m + 1 <= 8 each k has its own instance (nonuniform_kernel<T, TT, K>):
// the moment pass unrolls over the 2K - 1 moments, which stay in registers
// and are the solve's Hankel G (plane_chol.cuh's DdFixedWork, G(i, j) =
// S[i + j]), and the solve is dd_chol_solve<K>, with L in registers up to
// K = kNonuniRegsK and past it in shared memory by thread: at K = 6 L in
// registers spilled 16 B at 168 registers, at 7 and 8 it measured 2-8%
// slower, and at K = 5 (the path's m = 4) shared memory measured 2% faster
// in f32 and 1% slower in f64 (probes/variants.py). No instance keeps a
// local array. Past k = 8, and where the tile and L would pass a block's
// shared memory (n past ~4,000-8,000 at k = 5..8), the moments and the
// runtime solve's workspace take the thread's interleaved slice of a device
// scratch buffer (K = 0), so every n whose tile fits is taken.
//
// The moment pass is most of the work. A tap's 2m + 1 moment and m + 1 rhs
// terms come from two chains, w u^q and w x u^q, each step one exact
// product and one fma for the low word, left unrenormalized; each term's
// high word joins its sum by TwoSum while the low words gather apart, and
// every pair is renormalized once, after the window. That keeps the
// moments at double-word accuracy (~2^-100 relative, against ~2^-104 fully
// renormalized: far inside the float32 contract and the float64 gate) for
// 11 FP64 instructions a term and step where a renormalized product, sum
// and power step took 23. Any n that shared memory holds is taken. Bound:
// FP64 issue, (3m + 2) TwoSums and 3m chain steps a tap plus the k x k
// double-word solve, against 16-20 B of device memory a sample.
#include <type_traits>

#include "plane_chol.cuh"

namespace {

using namespace sgtsolve;
constexpr int kTile = 128;                   // outputs and threads per block
constexpr int kNonuniFixedKmax = 8;          // larger k takes device scratch
constexpr int kNonuniRegsK = 4;              // larger K keeps L in shared memory
constexpr size_t kSmemLimit = 232448;        // shared memory a block may use

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

// whether the instance for k keeps L in shared memory
__host__ __device__ constexpr bool shared_l(int k) {
  return k > kNonuniRegsK && k <= kNonuniFixedKmax;
}

// Shared memory of one block: t, x and w of the tile and its 2n halo, each
// array 16-byte aligned, in the kernel's order; then, for an instance that
// keeps L in shared memory, L's hi and lo words by thread.
__host__ __device__ constexpr size_t tile_bytes(int n, size_t x_size,
                                               size_t t_size) {
  return align16(t_size * (kTile + 2 * static_cast<size_t>(n))) +
         2 * align16(x_size * (kTile + 2 * static_cast<size_t>(n)));
}
__host__ __device__ constexpr size_t l_bytes(int k) {
  return shared_l(k) ? sizeof(double) * 2 * packed(k) * kTile : 0;
}
// whether k's compile-time instance runs at this n: k <= 8, with its L in
// the block's shared memory beside the tile (else K = 0, on device scratch)
__host__ __device__ constexpr bool fixed_at(int n, size_t x_size,
                                           size_t t_size, int k) {
  return k <= kNonuniFixedKmax &&
         tile_bytes(n, x_size, t_size) + l_bytes(k) <= kSmemLimit;
}
__host__ __device__ constexpr size_t smem_bytes(int n, size_t x_size,
                                               size_t t_size, int k) {
  return tile_bytes(n, x_size, t_size) +
         (fixed_at(n, x_size, t_size, k) ? l_bytes(k) : 0);
}

// (h, l) += (xh, xl): the high words summed exactly (TwoSum), its error and
// xl gathered in l, which stays unrenormalized; xh alone where xl is 0
__device__ __forceinline__ void gather(double& h, double& l, double xh,
                                       double xl) {
  const dd s = two_sum(h, xh);
  h = s.hi;
  l = add_rn(l, add_rn(s.lo, xl));
}
__device__ __forceinline__ void gather(double& h, double& l, double xh) {
  const dd s = two_sum(h, xh);
  h = s.hi;
  l = add_rn(l, s.lo);
}
// (h, l) *= u: h's product exact (its error by an fma), l's share by one
// more fma; l is 0 before the first step
__device__ __forceinline__ void scale(double& h, double& l, double u,
                                      bool first) {
  const double p = mul_rn(h, u);
  const double e = fma(h, u, -p);
  l = first ? e : fma(l, u, e);
  h = p;
}
__device__ __forceinline__ void renorm(double& h, double& l) {
  const dd v = two_sum(h, l);
  h = v.hi;
  l = v.lo;
}

// The window's double-word moments S_q = sum_j w_j (u_j/s)^q, q < 2k - 1,
// and rhs r_q = sum_j w_j x_j (u_j/s)^q, q < k, into Sh/Sl and Rh/Rl
// (registers for KC > 0, the scratch slice for KC = 0). Each chain starts
// at the exact (w, 0) or (w x, 0).
template <int KC, typename T, typename TT, typename S, typename R>
__device__ __forceinline__ void window_moments(int kk, int ws, const TT* tt,
                                               const T* xt, const T* wt,
                                               TT tc, T sinv, S& Sh, S& Sl,
                                               R& Rh, R& Rl) {
  const int k = KC > 0 ? KC : kk, n_mom = 2 * k - 1;
#pragma unroll
  for (int q = 0; q < n_mom; ++q) {
    Sh[q] = 0.0;
    Sl[q] = 0.0;
    if (q < k) {
      Rh[q] = 0.0;
      Rl[q] = 0.0;
    }
  }
  for (int j = 0; j < ws; ++j) {
    const T wj = wt[j];
    const TT u = wj > T(0) ? tt[j] - tc : TT(0);
    const double und = mul_rn(static_cast<T>(u), sinv);
    double ah = wj, al = 0.0, bh = mul_rn(wj, xt[j]), bl = 0.0;
#pragma unroll
    for (int q = 0; q < n_mom; ++q) {
      if (q == 0) {
        gather(Sh[0], Sl[0], ah);
        gather(Rh[0], Rl[0], bh);
      } else {
        gather(Sh[q], Sl[q], ah, al);
        if (q < k) gather(Rh[q], Rl[q], bh, bl);
      }
      if (q + 1 < n_mom) scale(ah, al, und, q == 0);
      if (q + 1 < k) scale(bh, bl, und, q == 0);
    }
  }
#pragma unroll
  for (int q = 0; q < n_mom; ++q) {
    renorm(Sh[q], Sl[q]);
    if (q < k) renorm(Rh[q], Rl[q]);
  }
}

// One position's output from the solution w.c(i) of its solve: the plane
// stack (emit_planes) or the d-th derivative, fill where not ok. KC > 0
// unrolls over the coefficients, so that a register workspace is read at
// constant indices only. c_d is picked by selects over words read
// unconditionally: a read made only at i == d (a conditional read, a store
// at i == d, or a lambda over the workspace) became one read at the
// dynamic index d and put the whole workspace in local memory, 320-544 B a
// thread at K = 5 (probes/variants.py census).
template <int KC, typename T, typename W>
__device__ __forceinline__ void emit(W& w, int kk, bool ok, T s, int m,
                                     int d, double fact_d, T fill,
                                     int emit_planes, T* __restrict__ out,
                                     long long o, long long ps) {
  const int k = KC > 0 ? KC : kk;
  if (emit_planes) {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const dd ci = w.c(i);
      out[i * ps + o] = static_cast<T>(ci.hi + ci.lo);
    }
    out[(m + 1) * ps + o] = s;
    out[(m + 2) * ps + o] = ok ? T(1) : T(0);
  } else {
    T sd = T(1);
    for (int i = 0; i < d; ++i) sd = sd * s;
    dd cd = {0.0, 0.0};
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const dd ci = w.c(i);    // read unconditionally, then selected
      cd = i == d ? ci : cd;
    }
    out[o] = ok ? static_cast<T>(cd.hi + cd.lo) * (static_cast<T>(fact_d) / sd)
                : fill;
  }
}

template <typename T, typename TT, int K>
__global__ void __launch_bounds__(kTile)
nonuniform_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const TT* __restrict__ t, T* __restrict__ out, long long N,
                  long long t_stride, long long tiles, long long total_tiles,
                  long long plane_stride, int n, int m, int d, int kmin,
                  T fill, double sqrt_rcond, int emit_planes,
                  double* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = 2 * n + 1, span = kTile + 2 * n, k = K > 0 ? K : m + 1;
  TT* st = reinterpret_cast<TT*>(smem);
  T* sx = reinterpret_cast<T*>(smem + align16(sizeof(TT) * span));
  T* sw = reinterpret_cast<T*>(smem + align16(sizeof(TT) * span) +
                               align16(sizeof(T) * span));

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
      const bool quorum = count >= kmin;
      const long long o = b * N + p;

      if constexpr (K > 0) {
        using LS = std::conditional_t<shared_l(K), Strided<double, kTile>,
                                      Regs<double, packed(K)>>;
        DdFixedWork<K, LS, true> wk;
        if constexpr (shared_l(K)) {        // L by thread past the tile
          double* sl = reinterpret_cast<double*>(
              smem + tile_bytes(n, sizeof(T), sizeof(TT))) + threadIdx.x;
          wk.lh.p = sl;
          wk.ll.p = sl + packed(K) * kTile;
        }
        window_moments<K>(K, ws, tt, xt, wt, tc, sinv, wk.sh, wk.sl, wk.vh,
                          wk.vl);
        const bool ok = dd_chol_solve<K>(K, quorum, true, sqrt_rcond, wk);
        emit<K>(wk, K, ok, s, m, d, fact_d, fill, emit_planes, out, o,
                plane_stride);
      } else {
        const Span<double> base =
            thread_span(static_cast<double*>(nullptr), scratch);
        const int n_mom = 2 * k - 1;
        const Span<double> Sh = base, Sl = base.at(n_mom),
                           Rh = base.at(2 * n_mom),
                           Rl = base.at(2 * n_mom + k);
        const DdWork wk = dd_carve(base.at(mom_size(k)), k);
        window_moments<0>(k, ws, tt, xt, wt, tc, sinv, Sh, Sl, Rh, Rl);
        // the Hankel G[i, j] = S[i + j] and the rhs into the workspace
        for (int i = 0; i < k; ++i) {
          for (int j = 0; j <= i; ++j) {
            wk.gh[tri(i, j)] = Sh[i + j];
            wk.gl[tri(i, j)] = Sl[i + j];
          }
          wk.rh[i] = Rh[i];
          wk.rl[i] = Rl[i];
        }
        const bool ok = dd_chol_solve<0>(k, quorum, true, sqrt_rcond, wk);
        emit<0>(wk, k, ok, s, m, d, fact_d, fill, emit_planes, out, o,
                plane_stride);
      }
    }
    __syncthreads();
  }
}

template <typename T, typename TT, int K>
cudaError_t run(dim3 grid, size_t smem, cudaStream_t s, const T* x,
                const T* w, const TT* t, T* out, long long N,
                long long t_stride, long long tiles, long long total,
                long long plane_stride, int n, int m, int d, int kmin,
                T fill, double sqrt_rcond, int emit_planes, double* scratch) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nonuniform_kernel<T, TT, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nonuniform_kernel<T, TT, K><<<grid, kTile, smem, s>>>(
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
  const bool fixed = fixed_at(n, sizeof(T), sizeof(TT), k);
  if (!fixed && (scratch == nullptr || scratch_threads < kTile ||
                 scratch_threads % kTile != 0))
    return cudaErrorInvalidValue;
  const long long tiles = (N + kTile - 1) / kTile;
  const long long total = B * tiles;
  long long blocks = fixed ? total : scratch_threads / kTile;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  const dim3 grid(static_cast<unsigned>(blocks));
  const size_t smem = smem_bytes(n, sizeof(T), sizeof(TT), k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T f = static_cast<T>(fill);
  const long long ps = B * N;
#define SGT_NONUNI_RUN(K, SCRATCH)                                           \
  run<T, TT, K>(grid, smem, s, x, w, t, out, N, t_stride, tiles, total, ps, \
                n, m, d, kmin, f, sqrt_rcond, emit_planes, SCRATCH)
  switch (fixed ? k : 0) {
    case 1: return SGT_NONUNI_RUN(1, nullptr);
    case 2: return SGT_NONUNI_RUN(2, nullptr);
    case 3: return SGT_NONUNI_RUN(3, nullptr);
    case 4: return SGT_NONUNI_RUN(4, nullptr);
    case 5: return SGT_NONUNI_RUN(5, nullptr);
    case 6: return SGT_NONUNI_RUN(6, nullptr);
    case 7: return SGT_NONUNI_RUN(7, nullptr);
    case 8: return SGT_NONUNI_RUN(8, nullptr);
    default: return SGT_NONUNI_RUN(0, scratch);
  }
#undef SGT_NONUNI_RUN
}

}  // namespace

// The launch's layout for the wrapper, so that it lives here alone: out[0]
// the shared memory of a block in bytes, out[1] the doubles of device
// scratch a thread (0 when the compile-time instance for k = m + 1 runs at
// this n), out[2] the outputs (and threads) of a block.
extern "C" int nonuniform_layout(int n, int m, int x_size, int t_size,
                                 long long* out) {
  if (n < 0 || m < 0 || x_size < 1 || t_size < 1) return cudaErrorInvalidValue;
  out[0] = static_cast<long long>(smem_bytes(n, x_size, t_size, m + 1));
  out[1] = fixed_at(n, x_size, t_size, m + 1) ? 0 : nonuni_work(m + 1);
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
