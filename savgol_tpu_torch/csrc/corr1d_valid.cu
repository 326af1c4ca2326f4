// K3: 1D VALID correlation, out[b, j] = sum_k w[k] * x[b, j + k] for
// 0 <= j < N - ws + 1.
//
// Replaces the TPU kernels savgol_tpu/ops/pallas_conv.py::_corr1d_mxu_kernel
// (banded-MXU, wide batches and row-folded thin batches via _fold_rows) and
// ::_corr1d_kernel (VPU tap loop, narrow batches). One function; the TPU
// split it by batch width because of its matrix unit. Thin batches need no
// row folding here: a row of 1M samples is already ~1024 blocks.
//
// Bound: device-memory bytes, as for K1 (sg1d_poly.cu): 4 B read and 4 B
// written per f32 sample for ws FMAs, a derived ceiling of ~419 Gsamples/s
// from the H100 SXM data sheet's 3.35 TB/s (not a measurement). The design
// reads x once per tile of 1024 outputs plus a halo of about ws samples and
// writes each output once (stencil_tile.cuh).
#include "stencil_tile.cuh"

namespace {

// MaxWs: the widest window of the instance (stencil_tile.cuh).
template <typename T, int MaxWs>
__global__ void __launch_bounds__(sgt::kThreads, sgt::kMinBlocks)
corr1d_valid_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, long long N, long long n_out,
                    long long tiles, int ws) {
  __shared__ sgt::TileSmem<T, MaxWs> s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * sgt::kTile;
  const T* __restrict__ xrow = x + b * N;   // 64-bit: B * N passes 2^31
  T* __restrict__ orow = out + b * n_out;

  sgt::tile_correlate<T, MaxWs>(xrow, N, t0, w, ws, s);

  for (int i = threadIdx.x; i < sgt::kTile; i += sgt::kThreads) {
    const long long j = t0 + i;
    if (j >= n_out) break;
    orow[j] = s.xs[i];
  }
}

template <typename T>
int launch(const T* x, const T* w, T* out, long long B, long long N, int ws,
           void* stream) {
  if (ws < 1 || ws > sgt::kMaxWs || N < ws) return cudaErrorInvalidValue;
  const long long n_out = N - ws + 1;
  dim3 grid;
  long long tiles;
  const cudaError_t err = sgt::grid_for(B, n_out, &grid, &tiles);
  if (err != cudaSuccess) return err;
  const auto kernel = ws <= sgt::kNarrowWs
                          ? corr1d_valid_kernel<T, sgt::kNarrowWs>
                          : corr1d_valid_kernel<T, sgt::kMaxWs>;
  kernel<<<grid, sgt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, N, n_out, tiles, ws);
  return cudaGetLastError();
}

}  // namespace

extern "C" int corr1d_valid_f32(const float* x, const float* w, float* out,
                                long long B, long long N, int ws,
                                void* stream) {
  return launch<float>(x, w, out, B, N, ws, stream);
}

extern "C" int corr1d_valid_f64(const double* x, const double* w,
                                double* out, long long B, long long N, int ws,
                                void* stream) {
  return launch<double>(x, w, out, B, N, ws, stream);
}
