// K10: the fused masked 2D Savitzky-Golay fit (normal equations) in the
// tensor-moment form of savgol_tpu/ops/pallas_masked2d.py.
//
// x and w are the (B, R + 2ny, C + 2nx) boundary-padded values (already
// multiplied by the weights for a weighted fit) and weights; out is
// (B, R, C). In the tensor-product basis B_p(x, y) = phi_i(x) psi_j(y)
// (i + j <= m, 1D orthonormal bases per axis) every Gram entry is a fixed
// combination of tensor moments
//
//     T[s, t] = sum_window w * phi_s(x) * psi_t(y),
//
// each a vertical profile  V_t = sum_y psi_t(y) w[r + y, :]  followed by a
// horizontal correlation with phi_s. So a pixel needs Sy + m + 2 vertical
// profiles (shared by the whole tile row), M moments, P right-hand sides
// r_p = sum_x phi_i(x) (sum_y psi_j(y) x[r + y, c + x]), its positive-weight
// count, the Gram assembly G = comb . T, the solve with the rcond rule
// (plane_chol.cuh), the extraction and the fill.
//
// Replaces the TPU kernel savgol_tpu/ops/pallas_masked2d.py::
// _masked2d_const_call (body kernel, pl.pallas_call at :309). The TPU kernel
// bakes PhiY, comb and the extraction row into the kernel as immediates (a
// Mosaic compile-time trick) and runs the horizontal correlations as banded
// MXU matmuls. Here the tables are small device arrays read through the
// read-only cache (every thread of a warp reads the same entry): ftab holds
// PhiX (Sx, wx), PhiY (Sy, wy), the nonzero comb values (CSR rows in packed
// lower order of the Gram) and the extraction row, in double; itab the
// moment indices (s, t), the basis indices (i, j) and the CSR offsets and
// columns.
//
// Arithmetic: double for either input type. The f32 normal equations lose
// ~cond(G)^2 eps to the Gram's formation, and a truncated 11x11 corner
// window (order 3) measured 1.3e-4 against f64 in f32, past the 5e-5 gate
// of tests/test_masked2d_fused.py; the H100 has native FP64, so the moments,
// the Gram and the solve run in double and only the output is rounded to
// the input's type.
//
// Design: a block stages w and x for its output tile and the (2ny, 2nx)
// halo in shared memory (zero outside the image, NaN-free: a sample counts
// only where its weight is > 0), builds the vertical profiles of the tile's
// rows in shared memory, and then each thread computes its pixel. Bound:
// FP64 arithmetic and the operand traffic of the workspace, ~1.5 k
// operations a pixel at 11 x 11, order 3 (profiles ~170, moments and rhs
// ~430, Gram ~150, the P = 10 solve ~700) against 8-16 B of device memory.
//
// Two instances, chosen by the configuration alone:
//   masked2d_fixed<T, P>, for P in {1, 3, 6, 10, 15} (orders 0-4) where its
//     shared memory fits: the solve's size is a compile-time constant, so its
//     loops unroll and no workspace lives in local memory. The block stages
//     the tables once (PhiX, PhiY, the comb table by moment, the extraction
//     row, the indices) and walks its tiles. Each moment is scattered into
//     the Gram through the comb table as it is formed, in moment order: each
//     Gram entry sums its terms in the order the by-row table gives, so the
//     Gram is the runtime instance's bit for bit. G lives in shared memory
//     laid out by thread (55 doubles a thread at P = 10, read by the factor
//     and the compensated residual); L and the vectors live in registers.
//     At P = 15 L (120 doubles) joins G in shared memory and the tile is 3
//     rows, so that the block still fits.
//   masked2d_kernel<T>, the runtime form for the rest (P = 21, 28, or a
//     window whose fixed instance passes shared memory): an 8 x 32 tile, the
//     workspace a local array of kLocalKmax elements' worth, the moments
//     held in the factor's storage until the Gram is gathered by row, tables
//     read through the read-only cache.
#include <type_traits>

#include "launch.cuh"
#include "plane_chol.cuh"

namespace {

using namespace sgtsolve;
using sgtlaunch::kSmemMax;
constexpr int kTR = 8, kTC = 32, kThreads = kTR * kTC;

using A = double;                              // the kernel's arithmetic

template <typename T>
struct Args {
  const T* x;
  const T* w;
  T* out;
  int Rp, Cp, R, C, nx, ny, m, tiles_r, tiles_c;
  long long total_tiles;
  int P, Sx, Sy, M, nnz;
  // ftab: PhiX (Sx, wx), PhiY (Sy, wy), comb values by Gram row (nnz), the
  // extraction row (P), comb values by moment (nnz); itab: moment indices
  // s, t (M each), basis indices i, j (P each), by-row offsets (Kp + 1) and
  // moment columns (nnz), by-moment offsets (M + 1) and Gram rows (nnz)
  const A* ftab;
  const int* itab;
  int kmin;
  T fill;
  int use_rcond;
  A sqrt_rcond;
};

// Tile `tile` of TR x kTC outputs: stages weights and values (SR x SC) into
// sw and sx, then the Sy weight profiles, m + 1 value profiles and the
// indicator profile of the TR rows (TR x SC each) into vw, vx and vi.
// Returns the image b and the tile's first output row and column.
template <int TR, typename T>
__device__ __forceinline__ void stage_tile(const Args<T>& a, long long tile,
                                           const A* phiy, A* sw, A* sx, A* vw,
                                           A* vx, A* vi, long long& b, int& r0,
                                           int& c0) {
  const int wy = 2 * a.ny + 1;
  const int SR = TR + 2 * a.ny, SC = kTC + 2 * a.nx, plane = TR * SC;
  b = tile / (static_cast<long long>(a.tiles_r) * a.tiles_c);
  const int rest = static_cast<int>(
      tile % (static_cast<long long>(a.tiles_r) * a.tiles_c));
  r0 = (rest / a.tiles_c) * TR;
  c0 = (rest % a.tiles_c) * kTC;
  const T* __restrict__ xb = a.x + b * a.Rp * a.Cp;
  const T* __restrict__ wb = a.w + b * a.Rp * a.Cp;
  for (int e = threadIdx.x; e < SR * SC; e += blockDim.x) {
    const int gr = r0 + e / SC, gc = c0 + e % SC;
    const long long src = static_cast<long long>(gr) * a.Cp + gc;
    const A wv = (gr < a.Rp && gc < a.Cp) ? static_cast<A>(wb[src]) : A(0);
    const bool valid = wv > A(0);
    sw[e] = valid ? wv : A(0);
    sx[e] = valid ? static_cast<A>(xb[src]) : A(0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < plane; e += blockDim.x) {
    const int r = e / SC, c = e % SC;
    for (int t = 0; t < a.Sy; ++t) {
      A acc = A(0);
      for (int y = 0; y < wy; ++y)
        acc = fma(phiy[t * wy + y], sw[(r + y) * SC + c], acc);
      vw[t * plane + e] = acc;
    }
    for (int j = 0; j <= a.m; ++j) {
      A acc = A(0);
      for (int y = 0; y < wy; ++y)
        acc = fma(phiy[j * wy + y], sx[(r + y) * SC + c], acc);
      vx[j * plane + e] = acc;
    }
    A cnt = A(0);
    for (int y = 0; y < wy; ++y) cnt += sw[(r + y) * SC + c] > A(0) ? A(1) : A(0);
    vi[e] = cnt;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) masked2d_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wx = 2 * a.nx + 1, wy = 2 * a.ny + 1;
  const int SR = kTR + 2 * a.ny, SC = kTC + 2 * a.nx, plane = kTR * SC;
  const int P = a.P, M = a.M, kp = packed(P);
  A* sw = reinterpret_cast<A*>(smem);          // SR x SC weights
  A* sx = sw + SR * SC;                        // SR x SC values
  A* vw = sx + SR * SC;                        // Sy profiles of w
  A* vx = vw + a.Sy * plane;                   // m + 1 profiles of x
  A* vi = vx + (a.m + 1) * plane;              // profile of the indicator

  const A* __restrict__ phix = a.ftab;
  const A* __restrict__ phiy = phix + a.Sx * wx;
  const int* __restrict__ mom_s = a.itab;
  const int* __restrict__ mom_t = mom_s + M;
  const int* __restrict__ bas_i = mom_t + M;
  const int* __restrict__ bas_j = bas_i + P;
  const int* __restrict__ coff = bas_j + P;
  const int* __restrict__ cidx = coff + kp + 1;
  const A* __restrict__ cval = phiy + a.Sy * wy;
  const A* __restrict__ extract = cval + a.nnz;

  A local[work_size(kLocalKmax)];
  const Work<A> wk = carve(Span<A>{local, 1}, P);
  const A quorum_at = a.kmin - 0.5;
  const int rr = threadIdx.x / kTC, cc = threadIdx.x % kTC;

  for (long long tile = blockIdx.x; tile < a.total_tiles; tile += gridDim.x) {
    long long b;
    int r0, c0;
    stage_tile<kTR>(a, tile, phiy, sw, sx, vw, vx, vi, b, r0, c0);
    const int orow = r0 + rr, ocol = c0 + cc;
    if (orow < a.R && ocol < a.C) {
      const int base = rr * SC + cc;
      A count = A(0);
      for (int xx = 0; xx < wx; ++xx) count += vi[base + xx];
      for (int mi = 0; mi < M; ++mi) {       // moments, held in wk.L
        const A* __restrict__ ph = phix + __ldg(mom_s + mi) * wx;
        const A* __restrict__ v = vw + __ldg(mom_t + mi) * plane + base;
        A acc = A(0);
        for (int xx = 0; xx < wx; ++xx) acc = fma(__ldg(ph + xx), v[xx], acc);
        wk.L[mi] = acc;
      }
      for (int p = 0; p < P; ++p) {
        const A* __restrict__ ph = phix + __ldg(bas_i + p) * wx;
        const A* __restrict__ v = vx + __ldg(bas_j + p) * plane + base;
        A acc = A(0);
        for (int xx = 0; xx < wx; ++xx) acc = fma(__ldg(ph + xx), v[xx], acc);
        wk.r[p] = acc;
      }
      for (int e = 0; e < kp; ++e) {
        A acc = A(0);
        for (int q = __ldg(coff + e); q < __ldg(coff + e + 1); ++q)
          acc = fma(__ldg(cval + q), wk.L[__ldg(cidx + q)], acc);
        wk.G[e] = acc;
      }
      const bool ok = chol_solve<0>(P, count >= quorum_at,
                                    a.use_rcond != 0, a.sqrt_rcond, wk);
      A y = A(0);
      for (int p = 0; p < P; ++p) y = fma(__ldg(extract + p), wk.c[p], y);
      a.out[(b * a.R + orow) * static_cast<long long>(a.C) + ocol] =
          ok ? static_cast<T>(y) : a.fill;
    }
    __syncthreads();
  }
}

// The fixed instance's layout at P: tile rows (threads = rows x 32) and
// whether L joins G in shared memory.
template <int P>
struct Fixed {
  static constexpr int rows = P <= 10 ? 4 : 3;
  static constexpr int threads = rows * kTC;
  static constexpr bool shared_l = P > 10;
};

// Doubles and ints of the fixed instance's shared memory: G (and L) by
// thread, the tables, the tile and its profiles.
template <int P>
__host__ __device__ constexpr long long fixed_doubles(long long wx,
                                                      long long wy, int m,
                                                      int Sx, int Sy,
                                                      int nnz) {
  using F = Fixed<P>;
  const long long SR = F::rows + wy - 1, SC = kTC + wx - 1;
  return (F::shared_l ? 2 : 1) * packed(P) * F::threads + Sx * wx + Sy * wy +
         nnz + P + 2 * SR * SC + (Sy + m + 2) * F::rows * SC;
}

template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

template <typename T, int P>
__global__ void __launch_bounds__(Fixed<P>::threads)
masked2d_fixed(const Args<T> a) {
  using F = Fixed<P>;
  constexpr int NT = F::threads, kp = packed(P);
  using Slots = Strided<A, NT>;
  using Workspace = FixedWork<A, P, Slots,
                              std::conditional_t<F::shared_l, Slots,
                                                 Regs<A, kp>>>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wx = 2 * a.nx + 1, wy = 2 * a.ny + 1;
  const int SR = F::rows + 2 * a.ny, SC = kTC + 2 * a.nx, plane = F::rows * SC;
  const int M = a.M, nnz = a.nnz;
  A* sG = reinterpret_cast<A*>(smem);           // kp (x 2) by thread
  A* phix = sG + (F::shared_l ? 2 : 1) * kp * NT;  // Sx x wx, then Sy x wy
  A* phiy = phix + a.Sx * wx;
  A* cval = phiy + a.Sy * wy;                   // comb values by moment
  A* ext = cval + nnz;                          // P
  A* sw = ext + P;
  A* sx = sw + SR * SC;
  A* vw = sx + SR * SC;
  A* vx = vw + a.Sy * plane;
  A* vi = vx + (a.m + 1) * plane;
  int* mom_s = reinterpret_cast<int*>(vi + plane);  // then mom_t, bas_i, bas_j
  int* mom_t = mom_s + M;
  int* bas_i = mom_t + M;
  int* bas_j = bas_i + P;
  int* moff = bas_j + P;                        // M + 1, then the Gram rows
  int* crow = moff + M + 1;

  const int tables = a.Sx * wx + a.Sy * wy;
  copy_in(phix, a.ftab, tables);
  copy_in(cval, a.ftab + tables + nnz + P, nnz);
  copy_in(ext, a.ftab + tables + nnz, P);
  copy_in(mom_s, a.itab, 2 * M + 2 * P);
  copy_in(moff, a.itab + 2 * M + 2 * P + kp + 1 + nnz, M + 1 + nnz);

  const A quorum_at = a.kmin - 0.5;
  const int rr = threadIdx.x / kTC, cc = threadIdx.x % kTC;
  Workspace wk;
  wk.G.p = sG + threadIdx.x;
  if constexpr (F::shared_l) wk.L.p = sG + kp * NT + threadIdx.x;

  for (long long tile = blockIdx.x; tile < a.total_tiles; tile += gridDim.x) {
    long long b;
    int r0, c0;
    stage_tile<F::rows>(a, tile, phiy, sw, sx, vw, vx, vi, b, r0, c0);
    const int orow = r0 + rr, ocol = c0 + cc;
    if (orow < a.R && ocol < a.C) {
      const int base = rr * SC + cc;
      A count = A(0);
      for (int xx = 0; xx < wx; ++xx) count += vi[base + xx];
#pragma unroll
      for (int e = 0; e < kp; ++e) wk.G[e] = A(0);
      for (int mi = 0; mi < M; ++mi) {
        const A* ph = phix + mom_s[mi] * wx;
        const A* v = vw + mom_t[mi] * plane + base;
        A acc = A(0);
        for (int xx = 0; xx < wx; ++xx) acc = fma(ph[xx], v[xx], acc);
        for (int q = moff[mi]; q < moff[mi + 1]; ++q)
          wk.G[crow[q]] = fma(cval[q], acc, wk.G[crow[q]]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const A* ph = phix + bas_i[p] * wx;
        const A* v = vx + bas_j[p] * plane + base;
        A acc = A(0);
        for (int xx = 0; xx < wx; ++xx) acc = fma(ph[xx], v[xx], acc);
        wk.r[p] = acc;
      }
      const bool ok = chol_solve<P>(P, count >= quorum_at, a.use_rcond != 0,
                                    a.sqrt_rcond, wk);
      A y = A(0);
#pragma unroll
      for (int p = 0; p < P; ++p) y = fma(ext[p], wk.c[p], y);
      a.out[(b * a.R + orow) * static_cast<long long>(a.C) + ocol] =
          ok ? static_cast<T>(y) : a.fill;
    }
    __syncthreads();
  }
}

// Shared memory of the fixed instance at P: the doubles of fixed_doubles
// and the ints of the indices and the by-moment table.
template <typename T, int P>
size_t fixed_smem(const Args<T>& a) {
  return sizeof(A) * fixed_doubles<P>(2 * a.nx + 1, 2 * a.ny + 1, a.m, a.Sx,
                                      a.Sy, a.nnz) +
         sizeof(int) * (3 * a.M + 2 * P + 1 + a.nnz);
}

// Shared memory of the fixed instance that serves this configuration, or 0
// where none does (P outside {1, 3, 6, 10, 15}, or a window whose fixed
// instance passes kSmemMax): the choice of instance, made before any launch.
template <typename T>
size_t fixed_fits(const Args<T>& a) {
  size_t smem = 0;
  switch (a.P) {
    case 1: smem = fixed_smem<T, 1>(a); break;
    case 3: smem = fixed_smem<T, 3>(a); break;
    case 6: smem = fixed_smem<T, 6>(a); break;
    case 10: smem = fixed_smem<T, 10>(a); break;
    case 15: smem = fixed_smem<T, 15>(a); break;
    default: break;
  }
  return smem <= kSmemMax ? smem : 0;
}

template <typename T, int P>
cudaError_t run_fixed(size_t smem, cudaStream_t s, Args<T> a) {
  using F = Fixed<P>;
  a.tiles_r = (a.R + F::rows - 1) / F::rows;
  a.total_tiles = a.total_tiles / ((a.R + kTR - 1) / kTR) * a.tiles_r;
  return sgtlaunch::launch(masked2d_fixed<T, P>, a.total_tiles, F::threads,
                           smem, true, s, a);
}

template <typename T>
int launch(const T* x, const T* w, T* out, long long B, long long Rp,
           long long Cp, int nx, int ny, int m, int P, int Sx, int Sy, int M,
           int nnz, const A* ftab, const int* itab, int kmin, T fill,
           int use_rcond, double sqrt_rcond, void* stream) {
  const long long R = Rp - 2LL * ny, C = Cp - 2LL * nx;
  if (nx < 1 || ny < 1 || m < 0 || B < 1 || R < 1 || C < 1 || P < 1 ||
      P > kLocalKmax || M > packed(P) || nnz < 0 || Rp * Cp > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int tiles_r = static_cast<int>((R + kTR - 1) / kTR);
  const int tiles_c = static_cast<int>((C + kTC - 1) / kTC);
  const Args<T> a{x, w, out, static_cast<int>(Rp), static_cast<int>(Cp),
                  static_cast<int>(R), static_cast<int>(C), nx, ny, m,
                  tiles_r, tiles_c, B * tiles_r * tiles_c, P, Sx, Sy, M, nnz,
                  ftab, itab, kmin, fill, use_rcond, sqrt_rcond};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (const size_t smem = fixed_fits(a)) {
    switch (P) {
      case 1: return run_fixed<T, 1>(smem, s, a);
      case 3: return run_fixed<T, 3>(smem, s, a);
      case 6: return run_fixed<T, 6>(smem, s, a);
      case 10: return run_fixed<T, 10>(smem, s, a);
      default: return run_fixed<T, 15>(smem, s, a);
    }
  }
  const long long SR = kTR + 2LL * ny, SC = kTC + 2LL * nx;
  const size_t smem = sizeof(A) * (2 * SR * SC + (Sy + m + 2) * kTR * SC);
  return sgtlaunch::launch(masked2d_kernel<T>, a.total_tiles, kThreads, smem,
                           false, s, a);
}

}  // namespace

extern "C" int masked2d_f32(const float* x, const float* w, float* out,
                            long long B, long long Rp, long long Cp, int nx,
                            int ny, int m, int P, int Sx, int Sy, int M,
                            int nnz, const double* ftab, const int* itab,
                            int kmin, float fill, int use_rcond,
                            double sqrt_rcond, void* stream) {
  return launch<float>(x, w, out, B, Rp, Cp, nx, ny, m, P, Sx, Sy, M, nnz,
                       ftab, itab, kmin, fill, use_rcond, sqrt_rcond, stream);
}

extern "C" int masked2d_f64(const double* x, const double* w, double* out,
                            long long B, long long Rp, long long Cp, int nx,
                            int ny, int m, int P, int Sx, int Sy, int M,
                            int nnz, const double* ftab, const int* itab,
                            int kmin, double fill, int use_rcond,
                            double sqrt_rcond, void* stream) {
  return launch<double>(x, w, out, B, Rp, Cp, nx, ny, m, P, Sx, Sy, M, nnz,
                        ftab, itab, kmin, fill, use_rcond, sqrt_rcond, stream);
}
