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
//
// method="bf16" (corr1d_valid_bf16) is the same kernel with sgt::Bf16: it
// replaces _corr1d_mxu_call [:1098] on bf16 operands at single-pass precision
// (correlate_valid_pallas_mxu :1120, mxu_precision=DEFAULT): samples rounded
// to bf16 while staging, bf16 taps held in f32, f32 sums, outputs rounded to
// bf16, storage f32 or bf16 (2 B in and 2 B out a sample for bf16 callers).
#include "stencil_tile.cuh"

namespace {

// MaxWs: the widest window of the instance (stencil_tile.cuh). IO:
// sgt::AsStored (In = T) or sgt::Bf16 (In f32 or bf16, T = float).
template <typename IO, typename In, typename T, int MaxWs>
__global__ void __launch_bounds__(sgt::kThreads, sgt::kMinBlocks)
corr1d_valid_kernel(const In* __restrict__ x, const T* __restrict__ w,
                    In* __restrict__ out, long long N, long long n_out,
                    long long tiles, int ws) {
  __shared__ sgt::TileSmem<T, MaxWs> s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * sgt::kTile;
  const In* __restrict__ xrow = x + b * N;   // 64-bit: B * N passes 2^31
  In* __restrict__ orow = out + b * n_out;

  sgt::tile_correlate<IO>(xrow, N, t0, w, ws, s);

  for (int i = threadIdx.x; i < sgt::kTile; i += sgt::kThreads) {
    const long long j = t0 + i;
    if (j >= n_out) break;
    IO::put(&orow[j], s.xs[i]);
  }
}

template <typename IO, typename In, typename T>
int launch(const In* x, const T* w, In* out, long long B, long long N,
           int ws, void* stream) {
  if (ws < 1 || ws > sgt::kMaxWs || N < ws) return cudaErrorInvalidValue;
  const long long n_out = N - ws + 1;
  dim3 grid;
  long long tiles;
  const cudaError_t err = sgt::grid_for(B, n_out, &grid, &tiles);
  if (err != cudaSuccess) return err;
  const auto kernel = ws <= sgt::kNarrowWs
                          ? corr1d_valid_kernel<IO, In, T, sgt::kNarrowWs>
                          : corr1d_valid_kernel<IO, In, T, sgt::kMaxWs>;
  kernel<<<grid, sgt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, N, n_out, tiles, ws);
  return cudaGetLastError();
}

}  // namespace

extern "C" int corr1d_valid_f32(const float* x, const float* w, float* out,
                                long long B, long long N, int ws,
                                void* stream) {
  return launch<sgt::AsStored>(x, w, out, B, N, ws, stream);
}

extern "C" int corr1d_valid_f64(const double* x, const double* w,
                                double* out, long long B, long long N, int ws,
                                void* stream) {
  return launch<sgt::AsStored>(x, w, out, B, N, ws, stream);
}

// method="bf16": x and out in f32 (bf16_storage = 0) or bf16 (1) storage,
// w bf16 values held in f32.
extern "C" int corr1d_valid_bf16(const void* x, const float* w, void* out,
                                 long long B, long long N, int ws,
                                 int bf16_storage, void* stream) {
  if (bf16_storage)
    return launch<sgt::Bf16>(static_cast<const __nv_bfloat16*>(x), w,
                             static_cast<__nv_bfloat16*>(out), B, N, ws,
                             stream);
  return launch<sgt::Bf16>(static_cast<const float*>(x), w,
                           static_cast<float*>(out), B, N, ws, stream);
}
