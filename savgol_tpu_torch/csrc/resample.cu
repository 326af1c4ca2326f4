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
// (resample_block_fit, guarded by lax.cond). Here one thread owns one
// (row, query) and reads its own centre, so any query order is valid, and
// the factorial factors are applied in the kernel instead of a
// derivative-adjusted copy of the planes. Threads run along the queries of a
// row, so the output is written coalesced; the reads follow the centres,
// which sorted queries keep close together. Bound: bytes, (K+2) plane values
// and t at each distinct centre plus ctr, tq and y, ~(K+3) * 4 + 12 B a
// float32 output with t and tq in float32 (K = m + 1 - d); a centre out of
// [0, N) gives NaN.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

template <typename T, typename TT>
__global__ void __launch_bounds__(kBlock)
resample_kernel(const T* __restrict__ planes, const TT* __restrict__ t,
                const long long* __restrict__ ctr, const TT* __restrict__ tq,
                T* __restrict__ out, long long B, long long N, long long Nq,
                int m, int d, T fill) {
  const long long ps = B * N;
  const long long total = B * Nq;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i / Nq;
    const long long q = i - b * Nq;
    const long long c = ctr[q];
    if (c < 0 || c >= N) {
      out[i] = static_cast<T>(__longlong_as_double(0x7ff8000000000000LL));
      continue;
    }
    const T* __restrict__ at = planes + b * N + c;
    const T s = at[(m + 1) * ps];
    const bool ok = at[(m + 2) * ps] > T(0.5);
    const T u = static_cast<T>(tq[q] - t[c]) / s;
    // Horner from c_m down to c_d, each with its factor k!/(k-d)!
    double f = 1.0;
    for (int j = m - d + 1; j <= m; ++j) f *= j;      // m!/(m-d)!
    T acc = at[m * ps] * static_cast<T>(f);
    for (int k = m - 1; k >= d; --k) {
      f = f * (k - d + 1) / (k + 1);                  // k!/(k-d)!, exact
      acc = acc * u + at[k * ps] * static_cast<T>(f);
    }
    for (int j = 0; j < d; ++j) acc = acc / s;
    out[i] = ok ? acc : fill;
  }
}

template <typename T, typename TT>
int launch(const T* planes, const TT* t, const long long* ctr, const TT* tq,
           T* out, long long B, long long N, long long Nq, int m, int d,
           double fill, void* stream) {
  if (B < 1 || N < 1 || Nq < 1 || m < 0 || d < 0 || d > m)
    return cudaErrorInvalidValue;
  long long blocks = (B * Nq + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  resample_kernel<T, TT><<<static_cast<unsigned>(blocks), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      planes, t, ctr, tq, out, B, N, Nq, m, d, static_cast<T>(fill));
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
