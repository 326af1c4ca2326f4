// K2D-dense: dense 2D VALID correlation of K stencils over one read of the
// input,
//
//     out[b, k, r, c] = sum_{y < H, x < W} w[k, y, x] * X[b, r + y, c + x],
//
// where X is the (B, R, C) input as it is (VALID) or extended by
// (H - 1) / 2 rows and (W - 1) / 2 columns in a pad mode (edge = CONSTANT,
// symmetric = REFLECT, wrap = PERIODIC), mapped while a tile is staged, so
// no padded copy of the image exists. H and W are odd, at most 33. f32
// accumulates in f32 and f64 in f64, by FMA, taps in (y, x) order.
//
// Replaces the TPU kernels of savgol_tpu/ops/pallas_conv.py:
//   K5a _corr2d_kernel :1183 / _corr2d_call :1216 (runtime SMEM taps),
//   K5b _corr2d_const_call :1288 (taps baked as compile-time constants),
//   K6a _corr2d_rowmxu_kernel :1501 / _corr2d_rowmxu_call :1530 (row-banded
//       MXU matmuls),
//   K6b _corr2d_rowmxu_stack_kernel :1670 / _corr2d_rowmxu_stack_call :1702
//       (K stencils per input read).
// They compute one function; the TPU split it four ways for its VPU/MXU
// split and Mosaic's compile-time constants. Here taps live in shared memory
// and the same code serves one stencil or a stack (the stack reads the image
// once, which is what K6b was for).
//
// Bound: at 11 x 11 an f32 pixel costs 121 FMAs for 8 bytes of device memory
// (one read, one write). The H100 SXM data sheet's 67 TFLOP/s f32 (33.5
// TFMA/s) gives ~277 Gpix/s, below the 3.35 TB/s / 8 B = ~419 Gpix/s of the
// bytes (both derived, not measured): the kernel is bound by arithmetic
// from about 7 x 7 up, and by bytes below. The design feeds the FMA pipes
// from registers: each thread owns 4 x 4 outputs (stencil2d.cuh), loads 4
// samples of a staged row with one 16-byte shared load and reuses them for
// the up to 4 output rows whose window covers that row, and loads 4 taps
// with one broadcast 16-byte load for 16 FMAs. The tap loop is written out
// here rather than shared (row_taps4, stencil_tile.cuh): a shared loop
// generalised to 4 output rows measured 9-28% slower in this kernel on an
// H100 (f32, 11 x 11 to 33 x 33, K = 1 and 3).
//
// method="bf16" (corr2d_valid_bf16) is the same kernel with sgt::Bf16Sum
// (stencil_tile.cuh): it replaces K6a/K6b on bf16 operands at single-pass
// MXU precision (correlate2d_valid_pallas_rowmxu :1580,
// savgol2d_same_pallas_rowmxu :1622, correlate2d_valid_pallas_rowmxu_stack
// :1749 with mxu_precision=DEFAULT). Samples are rounded to bf16 as they are
// staged, the taps are bf16 values held in f32, the sums f32; f32 storage
// gets the f32 sum unrounded, bf16 storage the sum rounded to bf16. On these
// CUDA cores the mode does the same FMAs as f32: at 11 x 11 it stays bound
// by them (0.242 ms at the 2D headline, derived), so it cannot beat the
// exact kernel here; the TPU's gain came from its matrix unit. A tensor-core
// (mma / wgmma bf16) form is later work.
#include "stencil2d.cuh"

namespace {

using namespace sgt2d;

// IO: sgt::AsStored (In = T: f32 or f64) or sgt::Bf16Sum (In f32 or bf16,
// T = float: method="bf16").
template <typename IO, typename In, typename T>
__global__ void __launch_bounds__(kThreads)
corr2d_valid_kernel(const In* __restrict__ x, const T* __restrict__ w,
                    In* __restrict__ out, int R, int C, int Ro, int Co, int K,
                    int H, int W, int mode, int tiles_r, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SR = stage_rows(H), SW = stage_cols(W), WP = pad4(W);
  T* xs = reinterpret_cast<T*>(smem);        // SR x SW staged samples
  T* ws = xs + SR * SW;                      // H x WP taps of one stencil
  const Tile t = tile_of(tiles_r, tiles_c);
  const int oy = mode == kValid ? 0 : (H - 1) / 2;
  const int ox = mode == kValid ? 0 : (W - 1) / 2;
  stage_tile<IO>(x + t.b * R * C, R, C, t.r0 - oy, t.c0 - ox, SR, SW, mode,
                 xs);

  const int cb = (threadIdx.x % kColThreads) * 4;
  const int rb = (threadIdx.x / kColThreads) * kQR;
  const int full = W & ~3, rem = W - full;   // rem is 1 or 3: W is odd
  for (int k = 0; k < K; ++k) {
    if (k > 0) __syncthreads();              // all done with stencil k - 1
    const T* __restrict__ wk = w + static_cast<long long>(k) * H * W;
    for (int e = threadIdx.x; e < H * WP; e += kThreads) {
      const int y = e / WP, xx = e - y * WP;
      ws[e] = xx < W ? wk[y * W + xx] : T(0);
    }
    __syncthreads();

    T acc[kQR][4];
#pragma unroll
    for (int q = 0; q < kQR; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = T(0);
    // Staged row rb + i feeds output row rb + q through stencil row i - q.
    for (int i = 0; i < kQR + H - 1; ++i) {
      const T* srow = xs + (rb + i) * SW + cb;
      for (int g = 0; g < full; g += 4) {
        T r[8];
        Vec4<T>::load(srow + g, r);
        Vec4<T>::load(srow + g + 4, r + 4);
#pragma unroll
        for (int q = 0; q < kQR; ++q) {
          const int y = i - q;
          if (y < 0 || y >= H) continue;
          T wv[4];
          Vec4<T>::load(ws + y * WP + g, wv);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[q][j] = madd(wv[kk], r[j + kk], acc[q][j]);
        }
      }
      // the last rem taps one at a time (see row_taps4)
      T r[8];
      Vec4<T>::load(srow + full, r);
      Vec4<T>::load(srow + full + 4, r + 4);
#pragma unroll
      for (int q = 0; q < kQR; ++q) {
        const int y = i - q;
        if (y < 0 || y >= H) continue;
        T wv[4];
        Vec4<T>::load(ws + y * WP + full, wv);
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          if (kk < rem) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[q][j] = madd(wv[kk], r[j + kk], acc[q][j]);
          }
        }
      }
    }
    In* plane = out + (t.b * K + k) * static_cast<long long>(Ro) * Co;
    store_tile<IO>(plane, Ro, Co, t.r0 + rb, t.c0 + cb, acc);
  }
}

template <typename IO, typename In, typename T>
int launch(const In* x, const T* w, In* out, long long B, long long R,
           long long C, long long K, long long H, long long W, int mode,
           void* stream) {
  int Ro, Co, tiles_r, tiles_c;
  dim3 grid;
  if (K < 1 || K > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = grid_2d(B, R, C, H, W, mode, &Ro, &Co, &tiles_r,
                            &tiles_c, &grid);
  if (err != cudaSuccess) return err;
  const int h = static_cast<int>(H), wd = static_cast<int>(W);
  const size_t smem =
      sizeof(T) * (stage_rows(h) * stage_cols(wd) + h * pad4(wd));
  err = allow_smem(corr2d_valid_kernel<IO, In, T>, smem);
  if (err != cudaSuccess) return err;
  corr2d_valid_kernel<IO, In, T><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      x, w, out, static_cast<int>(R), static_cast<int>(C), Ro, Co,
      static_cast<int>(K), h, wd, mode, tiles_r, tiles_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int corr2d_valid_f32(const float* x, const float* w, float* out,
                                long long B, long long R, long long C,
                                long long K, long long H, long long W,
                                int mode, void* stream) {
  return launch<sgt::AsStored>(x, w, out, B, R, C, K, H, W, mode, stream);
}

extern "C" int corr2d_valid_f64(const double* x, const double* w,
                                double* out, long long B, long long R,
                                long long C, long long K, long long H,
                                long long W, int mode, void* stream) {
  return launch<sgt::AsStored>(x, w, out, B, R, C, K, H, W, mode, stream);
}

// method="bf16": x and out in f32 (bf16_storage = 0) or bf16 (1) storage,
// w (K, H, W) bf16 values held in f32.
extern "C" int corr2d_valid_bf16(const void* x, const float* w, void* out,
                                 long long B, long long R, long long C,
                                 long long K, long long H, long long W,
                                 int mode, int bf16_storage, void* stream) {
  if (bf16_storage)
    return launch<sgt::Bf16Sum>(static_cast<const __nv_bfloat16*>(x), w,
                                static_cast<__nv_bfloat16*>(out), B, R, C, K,
                                H, W, mode, stream);
  return launch<sgt::Bf16Sum>(static_cast<const float*>(x), w,
                              static_cast<float*>(out), B, R, C, K, H, W,
                              mode, stream);
}
