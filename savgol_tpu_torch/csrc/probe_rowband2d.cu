// P2: an attribution probe of the bf16 dense 2D correlation (K2D-dense with
// sgt::Bf16Sum, corr2d_valid.cu). It replaces the TPU probe
// benchmarks/probe_rowmxu.py::_variant_kernel [pl.pallas_call :101], whose
// variants each remove one cost term of the TPU's row-banded kernel. Its
// terms were the matrix unit's output-side and input-side shifts, which CUDA
// cores do not have; each variant here keeps its purpose, removing one cost
// term of K2D-dense-bf16, not its layout:
//
//   A_lib       K2D-dense-bf16 itself (corr2d_valid_bf16): no code here.
//   B_alignctl  this file: K2D-dense-bf16's tiles, staging and FMAs, but
//               every stencil row reads the output's own staged row r
//               instead of row r + y:
//                 out[r, c] = sum_y sum_x w[y, x] * X[r, c + x]
//               Wrong values by design; the cost of walking H staged rows
//               (a thread's loads of kQR + H - 1 rows) is removed: the
//               kQR rows a thread reads are loaded once a column group.
//   C_inshift   A_lib on this card: K2D-dense already shifts on the input
//               side (it reads staged row r + y), so there is no kernel.
//   C_wh1       K2D-dense-bf16 on the stencil's first row alone (1 x W):
//               the same tiles with 1/H of the FMAs, the per-tile fixed
//               cost. No code here.
//
// X is the image as it is (VALID) or extended by the pad mode, as in
// K2D-dense; storage f32 or bf16, samples rounded to bf16 as they are staged.
#include "stencil2d.cuh"

namespace {

using namespace sgt2d;

template <typename In>
__global__ void __launch_bounds__(kThreads)
alignctl_kernel(const In* __restrict__ x, const float* __restrict__ w,
                In* __restrict__ out, int R, int C, int Ro, int Co, int H,
                int W, int mode, int tiles_r, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SR = stage_rows(H), SW = stage_cols(W), WP = pad4(W);
  float* xs = reinterpret_cast<float*>(smem);   // SR x SW staged samples
  float* ws = xs + SR * SW;                     // H x WP taps
  const Tile t = tile_of(tiles_r, tiles_c);
  const int oy = mode == kValid ? 0 : (H - 1) / 2;
  const int ox = mode == kValid ? 0 : (W - 1) / 2;
  stage_tile<sgt::Bf16Sum>(x + t.b * R * C, R, C, t.r0 - oy, t.c0 - ox, SR,
                           SW, mode, xs);
  for (int e = threadIdx.x; e < H * WP; e += kThreads) {
    const int y = e / WP, xx = e - y * WP;
    ws[e] = xx < W ? w[y * W + xx] : 0.0f;
  }
  __syncthreads();

  const int cb = (threadIdx.x % kColThreads) * 4;
  const int rb = (threadIdx.x / kColThreads) * kQR;
  const int full = W & ~3, rem = W - full;
  float acc[kQR][4];
#pragma unroll
  for (int q = 0; q < kQR; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = 0.0f;
  for (int g = 0; g <= full; g += 4) {
    const int taps = g < full ? 4 : rem;
    float r[kQR][8];
#pragma unroll
    for (int q = 0; q < kQR; ++q) {
      const float* srow = xs + (rb + q) * SW + cb + g;
      Vec4<float>::load(srow, r[q]);
      Vec4<float>::load(srow + 4, r[q] + 4);
    }
    for (int y = 0; y < H; ++y) {
      float wv[4];
      Vec4<float>::load(ws + y * WP + g, wv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= taps) break;
#pragma unroll
        for (int q = 0; q < kQR; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[q][j] = madd(wv[kk], r[q][j + kk], acc[q][j]);
      }
    }
  }
  store_tile<sgt::Bf16Sum>(out + t.b * static_cast<long long>(Ro) * Co, Ro,
                           Co, t.r0 + rb, t.c0 + cb, acc);
}

template <typename In>
int launch(const In* x, const float* w, In* out, long long B, long long R,
           long long C, long long H, long long W, int mode, void* stream) {
  int Ro, Co, tiles_r, tiles_c;
  dim3 grid;
  cudaError_t err = grid_2d(B, R, C, H, W, mode, &Ro, &Co, &tiles_r,
                            &tiles_c, &grid);
  if (err != cudaSuccess) return err;
  const int h = static_cast<int>(H), wd = static_cast<int>(W);
  const size_t smem =
      sizeof(float) * (stage_rows(h) * stage_cols(wd) + h * pad4(wd));
  err = allow_smem(alignctl_kernel<In>, smem);
  if (err != cudaSuccess) return err;
  alignctl_kernel<In><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w, out, static_cast<int>(R), static_cast<int>(C), Ro, Co, h, wd,
      mode, tiles_r, tiles_c);
  return cudaGetLastError();
}

}  // namespace

// B_alignctl: x and out in f32 (bf16_storage = 0) or bf16 (1) storage, w
// (H, W) bf16 values held in f32; out as K2D-dense's for one stencil.
extern "C" int probe_rowband2d(const void* x, const float* w, void* out,
                               long long B, long long R, long long C,
                               long long H, long long W, int mode,
                               int bf16_storage, void* stream) {
  if (bf16_storage)
    return launch(static_cast<const __nv_bfloat16*>(x), w,
                  static_cast<__nv_bfloat16*>(out), B, R, C, H, W, mode,
                  stream);
  return launch(static_cast<const float*>(x), w, static_cast<float*>(out), B,
                R, C, H, W, mode, stream);
}
