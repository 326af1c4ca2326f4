// K12: evaluate the nonuniform fit's plane stack at query positions.
//
//   planes (m+3, B, N): coefficients c_0..c_m of each window's polynomial in
//   its u/s basis, then s, then ok as 0/1 (K11p's output); ctr (Nq) the
//   window centre of each query; t (N) and tq (Nq) in one dtype TT.
//
//   u = (tq[q] - t[ctr[q]]) / s          (offset in TT, then the working dtype)
//   y[b, q] = (sum_{k>=d} c_k k!/(k-d)! u^(k-d)) / s / ... / s   (d divisions)
//   or fill where ok is 0
//
// Replaces the TPU kernel savgol_tpu/ops/pallas_resample.py::_call (body
// _kernel). On the TPU the gather is a one-hot matmul over two slabs of the
// plane stack, valid only when a block of queries spans at most two slabs
// (resample_block_fit, guarded by lax.cond). Here each thread reads its own
// query's centre, so any query order is valid, and the factorial factors
// are applied in the kernel instead of a derivative-adjusted copy of the
// planes. Bound: bytes, (K+2) plane values and t at each distinct centre
// plus ctr, tq and y, ~(K+3) * 4 + 12 B a float32 output with t and tq in
// float32 (K = m + 1 - d); a centre out of [0, N) gives NaN.
//
// One thread takes one query and a group of R consecutive rows (kFixedRows,
// kRuntimeRows): the grid is (query blocks, row groups), so no index is
// divided for an output, and the centre, tq, t[ctr] and the offset are read
// or formed once a query and the factors k!/(k-d)! once a thread, for all
// its rows. Threads run along the queries of a row, so each row's outputs
// are written coalesced; the reads follow the centres, which sorted queries
// keep close together. For m <= kFixedM (the windows whose planes K11p
// makes on its compile-time solve, k = m + 1 <= 8) m is a compile-time
// constant and a thread issues all its plane loads, (K + 2) a row, before
// the first product, so they are in flight together; past that a runtime-m
// loop issues a row group's loads of one coefficient at a time. The
// arithmetic and its order do not depend on the row grouping (the factors
// by one FP64 recurrence, the Horner step acc * u + c_k * f, then d
// divisions by s), so every grouping gives the same bits;
// probes/resample_bits.py holds two builds of this file to that.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;      // queries a block
constexpr int kFixedRows = 2;    // rows a thread, compile-time m
constexpr int kRuntimeRows = 4;  // rows a thread, runtime m
constexpr int kFixedM = 7;       // compile-time m up to this

template <typename T>
__device__ __forceinline__ T quiet_nan() {
  return static_cast<T>(__longlong_as_double(0x7ff8000000000000LL));
}

// m!/(m-d)!, the factor of c_m, in FP64, as the products j = m-d+1 .. m.
__device__ __forceinline__ double top_factor(int m, int d) {
  double f = 1.0;
  for (int j = m - d + 1; j <= m; ++j) f *= j;
  return f;
}

// Rows b0 .. b0 + R - 1 of a query whose centre lies outside [0, N).
template <int R, typename T>
__device__ __forceinline__ void store_nan(T* __restrict__ out, long long b0,
                                          long long B, long long Nq,
                                          long long q) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (b0 + r < B) out[(b0 + r) * Nq + q] = quiet_nan<T>();
}

// m = M at compile time.
template <typename T, typename TT, int M>
__global__ void __launch_bounds__(kBlock)
resample_fixed(const T* __restrict__ planes, const TT* __restrict__ t,
               const long long* __restrict__ ctr, const TT* __restrict__ tq,
               T* __restrict__ out, long long B, long long N, long long Nq,
               int d, T fill) {
  const long long q = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (q >= Nq) return;
  const long long ps = B * N;
  const long long groups = (B + kFixedRows - 1) / kFixedRows;
  const long long c = ctr[q];
  const bool inside = c >= 0 && c < N;
  const TT off = inside ? tq[q] - t[c] : TT(0);
  // k!/(k-d)! for d <= k <= M, by the recurrence from m!/(m-d)! down
  T fac[M + 1];
  double f = top_factor(M, d);
  fac[M] = static_cast<T>(f);
#pragma unroll
  for (int k = M - 1; k >= 0; --k) {
    if (k >= d) f = f * (k - d + 1) / (k + 1);
    fac[k] = static_cast<T>(f);
  }
  for (long long g = blockIdx.y; g < groups; g += gridDim.y) {
    const long long b0 = g * kFixedRows;
    if (!inside) {
      store_nan<kFixedRows>(out, b0, B, Nq, q);
      continue;
    }
    // every plane value of the thread's rows first: c_d .. c_M, s, ok
    T p[kFixedRows][M + 3];
#pragma unroll
    for (int r = 0; r < kFixedRows; ++r) {
      const T* __restrict__ at = planes + (b0 + r) * N + c;
#pragma unroll
      for (int k = 0; k < M + 3; ++k)
        p[r][k] = b0 + r < B && k >= d ? at[k * ps] : T(0);
    }
#pragma unroll
    for (int r = 0; r < kFixedRows; ++r) {
      if (b0 + r >= B) break;
      const T s = p[r][M + 1];
      const T u = static_cast<T>(off) / s;
      T acc = p[r][M] * fac[M];
#pragma unroll
      for (int k = M - 1; k >= 0; --k)
        if (k >= d) acc = acc * u + p[r][k] * fac[k];
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (j < d) acc = acc / s;
      out[(b0 + r) * Nq + q] = p[r][M + 2] > T(0.5) ? acc : fill;
    }
  }
}

// m > kFixedM: the coefficients one at a time, each step's loads for the
// thread's rows together.
template <typename T, typename TT>
__global__ void __launch_bounds__(kBlock)
resample_runtime(const T* __restrict__ planes, const TT* __restrict__ t,
                 const long long* __restrict__ ctr, const TT* __restrict__ tq,
                 T* __restrict__ out, long long B, long long N, long long Nq,
                 int m, int d, T fill) {
  const long long q = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (q >= Nq) return;
  const long long ps = B * N;
  const long long groups = (B + kRuntimeRows - 1) / kRuntimeRows;
  const long long c = ctr[q];
  const bool inside = c >= 0 && c < N;
  const TT off = inside ? tq[q] - t[c] : TT(0);
  const double top = top_factor(m, d);
  for (long long g = blockIdx.y; g < groups; g += gridDim.y) {
    const long long b0 = g * kRuntimeRows;
    if (!inside) {
      store_nan<kRuntimeRows>(out, b0, B, Nq, q);
      continue;
    }
    // the group's rows inside [0, B)
    const int rows = static_cast<int>(
        min(static_cast<long long>(kRuntimeRows), B - b0));
    const T* __restrict__ at[kRuntimeRows];
    T s[kRuntimeRows], u[kRuntimeRows], acc[kRuntimeRows];
    bool ok[kRuntimeRows];
#pragma unroll
    for (int r = 0; r < kRuntimeRows; ++r) {
      if (r >= rows) break;
      at[r] = planes + (b0 + r) * N + c;
      s[r] = at[r][(m + 1) * ps];
      ok[r] = at[r][(m + 2) * ps] > T(0.5);
      acc[r] = at[r][m * ps];
    }
    double f = top;
#pragma unroll
    for (int r = 0; r < kRuntimeRows; ++r) {
      if (r >= rows) break;
      u[r] = static_cast<T>(off) / s[r];
      acc[r] = acc[r] * static_cast<T>(f);
    }
    for (int k = m - 1; k >= d; --k) {
      f = f * (k - d + 1) / (k + 1);                  // k!/(k-d)!
      const T fk = static_cast<T>(f);
      T v[kRuntimeRows];
#pragma unroll
      for (int r = 0; r < kRuntimeRows; ++r)
        if (r < rows) v[r] = at[r][k * ps];
#pragma unroll
      for (int r = 0; r < kRuntimeRows; ++r)
        if (r < rows) acc[r] = acc[r] * u[r] + v[r] * fk;
    }
#pragma unroll
    for (int r = 0; r < kRuntimeRows; ++r) {
      if (r >= rows) break;
      for (int j = 0; j < d; ++j) acc[r] = acc[r] / s[r];
      out[(b0 + r) * Nq + q] = ok[r] ? acc[r] : fill;
    }
  }
}

template <typename T, typename TT>
int launch(const T* planes, const TT* t, const long long* ctr, const TT* tq,
           T* out, long long B, long long N, long long Nq, int m, int d,
           double fill, void* stream) {
  if (B < 1 || N < 1 || Nq < 1 || m < 0 || d < 0 || d > m)
    return cudaErrorInvalidValue;
  const long long qblocks = (Nq + kBlock - 1) / kBlock;
  if (qblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // (query blocks, row groups of R rows)
  const auto grid = [&](int R) {
    return dim3(static_cast<unsigned>(qblocks),
                static_cast<unsigned>(min((B + R - 1) / R, 65535LL)));
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T f = static_cast<T>(fill);
  static_assert(kFixedM == 7, "one case below for each compile-time m");
  switch (m) {
#define RESAMPLE_CASE(M)                                          \
  case M:                                                         \
    resample_fixed<T, TT, M><<<grid(kFixedRows), kBlock, 0, s>>>( \
        planes, t, ctr, tq, out, B, N, Nq, d, f);                 \
    break;
    RESAMPLE_CASE(0)
    RESAMPLE_CASE(1)
    RESAMPLE_CASE(2)
    RESAMPLE_CASE(3)
    RESAMPLE_CASE(4)
    RESAMPLE_CASE(5)
    RESAMPLE_CASE(6)
    RESAMPLE_CASE(7)
#undef RESAMPLE_CASE
    default:   // m > kFixedM
      resample_runtime<T, TT><<<grid(kRuntimeRows), kBlock, 0, s>>>(
          planes, t, ctr, tq, out, B, N, Nq, m, d, f);
  }
  return cudaGetLastError();
}

}  // namespace

#define SGT_RESAMPLE(NAME, T, TT)                                           \
  extern "C" int NAME(const T* planes, const TT* t, const long long* ctr,   \
                      const TT* tq, T* out, long long B, long long N,       \
                      long long Nq, int m, int d, double fill,              \
                      void* stream) {                                       \
    return launch<T, TT>(planes, t, ctr, tq, out, B, N, Nq, m, d, fill,     \
                         stream);                                           \
  }

SGT_RESAMPLE(resample_f32_t32, float, float)
SGT_RESAMPLE(resample_f32_t64, float, double)
SGT_RESAMPLE(resample_f64_t32, double, float)
SGT_RESAMPLE(resample_f64_t64, double, double)
