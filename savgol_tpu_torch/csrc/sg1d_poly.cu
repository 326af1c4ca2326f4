// K1: same-length 1D Savitzky-Golay apply with POLYNOMIAL edges, one pass;
// K2: the same-length apply with a REFLECT / PERIODIC / CONSTANT boundary,
// one pass, from the same kernel.
//
// K1 replaces the TPU kernels savgol_tpu/ops/pallas_conv.py::
// _sg1d_poly_mxu_kernel (banded-MXU, wide batches), ::_sg1d_poly_kernel_v2
// and ::_sg1d_poly_kernel (VPU tap loops, narrow batches). They compute one
// function; the TPU split them by batch width because of its matrix unit.
// K2 replaces ::_sg1d_pad_mxu_kernel (savgol_padded_pallas_mxu), which
// splices two host-built (B, n) strips of virtual samples into its slab.
//
// For each row b and output j of a (B, N) input, with ws = 2n + 1:
//   K1, j <  n     : lead_sign * sum_k ew[j, k]     * x[ws - 1 - k]
//   K1, j >= N - n : sum_k ew[N - 1 - j, k]         * x[N - ws + k]
//   otherwise      : sum_k w[k]                     * xv[j - n + k]
// where xv is x extended past [0, N) by the pad mode (stencil_tile.cuh
// map_index: symmetric, wrap or edge for K2; zero for K1, whose edge outputs
// are then fitted from ew). The caller folds dt_inv into w and ew. f32
// accumulates in f32, f64 in f64.
//
// Bound: device-memory bytes. An f32 sample is read once (4 B) and written
// once (4 B) for 2n + 1 = 25 FMAs at n = 12, far below the card's FMA rate
// per byte, so the H100 SXM data sheet's 3.35 TB/s puts the ceiling at
// 3.35e12 / 8 = ~419 Gsamples/s. That is a derived bound, not a measurement.
// The design keeps to it by reading x once per tile of 1024 outputs plus a
// halo of about 2n samples (28 at n = 12, 2.7% extra) and writing each output
// once; the taps run out of shared memory and registers (stencil_tile.cuh).
// K2's virtual samples are mapped while the edge tiles stage their halo, so
// the TPU kernel's strips and the host pad copy before K3 both go: K2 moves
// the same bytes as K1. Tiles clear of both edges skip the edge logic.
//
// K1's edge outputs (2n per row) read their windows straight from device
// memory: the trailing window can start up to 2n samples before its output's
// tile and the leading window sits at x[0, ws) whatever the tile, so neither
// is reliably inside the staged span.
#include "stencil_tile.cuh"

namespace {

// mode: sgt::kZero for K1 (edge outputs fitted from ew), a pad mode for K2
// (ew unused). MaxWs: the widest window of the instance (stencil_tile.cuh).
template <typename T, int MaxWs>
__global__ void __launch_bounds__(sgt::kThreads, sgt::kMinBlocks)
sg1d_poly_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ ew, T* __restrict__ out, long long N,
                 long long tiles, int n, T lead_sign, int mode) {
  __shared__ sgt::TileSmem<T, MaxWs> s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * sgt::kTile;
  const int ws = 2 * n + 1;
  const T* __restrict__ xrow = x + b * N;   // 64-bit: B * N passes 2^31
  T* __restrict__ orow = out + b * N;

  sgt::tile_correlate<T, MaxWs>(xrow, N, t0 - n, w, ws, s, mode);

  if (t0 >= n && t0 + sgt::kTile <= N - n) {   // interior tile: no edges
    for (int i = threadIdx.x; i < sgt::kTile; i += sgt::kThreads)
      orow[t0 + i] = s.xs[i];
    return;
  }
  if (mode != sgt::kZero) {   // K2's edge tiles: their pad is staged
    for (int i = threadIdx.x; i < sgt::kTile && t0 + i < N;
         i += sgt::kThreads)
      orow[t0 + i] = s.xs[i];
    return;
  }
  for (int i = threadIdx.x; i < sgt::kTile; i += sgt::kThreads) {
    const long long j = t0 + i;
    if (j >= N) break;
    T v = s.xs[i];
    if (j < n) {
      const T* __restrict__ e = ew + j * ws;
      T a = T(0);
      for (int k = 0; k < ws; ++k) a = sgt::madd(e[k], xrow[ws - 1 - k], a);
      v = lead_sign * a;
    } else if (j >= N - n) {
      const T* __restrict__ e = ew + (N - 1 - j) * ws;
      const T* __restrict__ xt = xrow + (N - ws);
      T a = T(0);
      for (int k = 0; k < ws; ++k) a = sgt::madd(e[k], xt[k], a);
      v = a;
    }
    orow[j] = v;
  }
}

template <typename T>
int launch(const T* x, const T* w, const T* ew, T* out, long long B,
           long long N, int n, T lead_sign, int mode, void* stream) {
  const int ws = 2 * n + 1;
  if (n < 1 || ws > sgt::kMaxWs || N < ws || mode < sgt::kZero ||
      mode > sgt::kWrap)
    return cudaErrorInvalidValue;
  dim3 grid;
  long long tiles;
  const cudaError_t err = sgt::grid_for(B, N, &grid, &tiles);
  if (err != cudaSuccess) return err;
  const auto kernel = ws <= sgt::kNarrowWs
                          ? sg1d_poly_kernel<T, sgt::kNarrowWs>
                          : sg1d_poly_kernel<T, sgt::kMaxWs>;
  kernel<<<grid, sgt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, ew, out, N, tiles, n, lead_sign, mode);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sg1d_poly_f32(const float* x, const float* w, const float* ew,
                             float* out, long long B, long long N, int n,
                             float lead_sign, void* stream) {
  return launch<float>(x, w, ew, out, B, N, n, lead_sign, sgt::kZero, stream);
}

extern "C" int sg1d_poly_f64(const double* x, const double* w,
                             const double* ew, double* out, long long B,
                             long long N, int n, double lead_sign,
                             void* stream) {
  return launch<double>(x, w, ew, out, B, N, n, lead_sign, sgt::kZero,
                        stream);
}

// K2: mode is sgt::kEdge, kSymmetric or kWrap.
extern "C" int sg1d_pad_f32(const float* x, const float* w, float* out,
                            long long B, long long N, int n, int mode,
                            void* stream) {
  if (mode == sgt::kZero) return cudaErrorInvalidValue;
  return launch<float>(x, w, nullptr, out, B, N, n, 1.0f, mode, stream);
}

extern "C" int sg1d_pad_f64(const double* x, const double* w, double* out,
                            long long B, long long N, int n, int mode,
                            void* stream) {
  if (mode == sgt::kZero) return cudaErrorInvalidValue;
  return launch<double>(x, w, nullptr, out, B, N, n, 1.0, mode, stream);
}
