// K2D-sep: separable 2D VALID correlation with a stencil given by its rank
// factors, w = sum_{k < r} outer(u[k], v[k]) (u: r x H, v: r x W, factored
// by SVD on the host in f64),
//
//     out[b, i, j] = sum_k sum_y u[k, y] * sum_x v[k, x] * X[b, i + y, j + x],
//
// with X the input as it is (VALID) or in a pad mode, mapped while a tile
// is staged, as in corr2d_valid.cu. r * (H + W) taps a pixel instead of
// H * W: 33 x 33 at order 6 is 7 * 66 = 462 instead of 1089.
//
// Replaces the TPU kernels of savgol_tpu/ops/pallas_conv.py:
//   K7a _corr2d_sep_const_call :1814 (factors baked as constants, shifted
//       tap loops on the VPU),
//   K7b _corr2d_sep_mxu_kernel :1879 / _corr2d_sep_mxu_call :1917 (both
//       passes as banded MXU matmuls).
// One function; the TPU split it for its VPU/MXU split.
//
// Bound: arithmetic, as for K2D-dense (corr2d_valid.cu), at roughly
// r * (H + W + (H - 1) * W / 64) FMAs a pixel, the last term being the row
// pass over the tile's H - 1 halo rows. Per tile and rank the design runs
// the row pass over the staged rows into a shared buffer (each thread 4
// outputs from 16-byte loads, row_taps4), then the column pass into
// register accumulators (each thread 4 x 4 outputs, one 16-byte load of the
// row-pass buffer feeding up to 16 FMAs), summed over the ranks in
// registers, so neither pass touches device memory.
#include "stencil2d.cuh"

namespace {

using namespace sgt2d;

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr2d_sep_kernel(const T* __restrict__ x, const T* __restrict__ u,
                  const T* __restrict__ v, T* __restrict__ out, int R, int C,
                  int Ro, int Co, int rank, int H, int W, int mode,
                  int tiles_r, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SR = stage_rows(H), SW = stage_cols(W);
  const int HP = pad4(H), WP = pad4(W);
  T* xs = reinterpret_cast<T*>(smem);        // SR x SW staged samples
  T* rows = xs + SR * SW;                    // SR x kTC row-pass results
  T* us = rows + SR * kTC;                   // rank x HP
  T* vs = us + rank * HP;                    // rank x WP, zero-padded
  const Tile t = tile_of(tiles_r, tiles_c);
  const int oy = mode == kValid ? 0 : (H - 1) / 2;
  const int ox = mode == kValid ? 0 : (W - 1) / 2;
  stage_tile(x + t.b * R * C, R, C, t.r0 - oy, t.c0 - ox, SR, SW, mode, xs);
  for (int e = threadIdx.x; e < rank * HP; e += kThreads) {
    const int k = e / HP, y = e - k * HP;
    us[e] = y < H ? u[k * H + y] : T(0);
  }
  for (int e = threadIdx.x; e < rank * WP; e += kThreads) {
    const int k = e / WP, xx = e - k * WP;
    vs[e] = xx < W ? v[k * W + xx] : T(0);
  }
  __syncthreads();

  const int cb = (threadIdx.x % kColThreads) * 4;
  const int rb = (threadIdx.x / kColThreads) * kQR;
  T acc[kQR][4];
#pragma unroll
  for (int q = 0; q < kQR; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = T(0);

  for (int k = 0; k < rank; ++k) {
    // row pass: rows[i][c] = sum_x v[k, x] * xs[i][c + x]
    for (int e = threadIdx.x; e < SR * kColThreads; e += kThreads) {
      const int i = e / kColThreads, c = (e % kColThreads) * 4;
      T a[4] = {T(0), T(0), T(0), T(0)};
      row_taps4(xs + i * SW + c, vs + k * WP, W, a);
      Vec4<T>::store(rows + i * kTC + c, a);
    }
    __syncthreads();
    // column pass: acc[q][j] += sum_y u[k, y] * rows[rb + q + y][cb + j]
    const T* __restrict__ uk = us + k * HP;
    for (int i = 0; i < kQR + H - 1; ++i) {
      T c4[4];
      Vec4<T>::load(rows + (rb + i) * kTC + cb, c4);
#pragma unroll
      for (int q = 0; q < kQR; ++q) {
        const int y = i - q;
        if (y < 0 || y >= H) continue;
        const T uy = uk[y];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] = madd(uy, c4[j], acc[q][j]);
      }
    }
    __syncthreads();                         // rows is rewritten next rank
  }
  T* plane = out + t.b * static_cast<long long>(Ro) * Co;
  store_tile(plane, Ro, Co, t.r0 + rb, t.c0 + cb, acc);
}

template <typename T>
int launch(const T* x, const T* u, const T* v, T* out, long long B,
           long long R, long long C, long long rank, long long H,
           long long W, int mode, void* stream) {
  int Ro, Co, tiles_r, tiles_c;
  dim3 grid;
  if (rank < 1 || rank > kMaxTaps) return cudaErrorInvalidValue;
  cudaError_t err = grid_2d(B, R, C, H, W, mode, &Ro, &Co, &tiles_r,
                            &tiles_c, &grid);
  if (err != cudaSuccess) return err;
  const int h = static_cast<int>(H), wd = static_cast<int>(W);
  const int r = static_cast<int>(rank);
  const size_t smem = sizeof(T) * (stage_rows(h) * stage_cols(wd) +
                                   stage_rows(h) * kTC +
                                   r * (pad4(h) + pad4(wd)));
  err = allow_smem(corr2d_sep_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  corr2d_sep_kernel<T><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, u, v, out, static_cast<int>(R), static_cast<int>(C), Ro, Co, r, h,
      wd, mode, tiles_r, tiles_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int corr2d_sep_f32(const float* x, const float* u, const float* v,
                              float* out, long long B, long long R,
                              long long C, long long rank, long long H,
                              long long W, int mode, void* stream) {
  return launch<float>(x, u, v, out, B, R, C, rank, H, W, mode, stream);
}

extern "C" int corr2d_sep_f64(const double* x, const double* u,
                              const double* v, double* out, long long B,
                              long long R, long long C, long long rank,
                              long long H, long long W, int mode,
                              void* stream) {
  return launch<double>(x, u, v, out, B, R, C, rank, H, W, mode, stream);
}
