// Shared tile geometry and staging of the 2D kernels (corr2d_valid.cu,
// corr2d_sep.cu).
//
// One block of 256 threads computes a kTR x kTC = 64 x 64 tile of outputs of
// one image. Thread (ty, tx) owns kQR = 4 consecutive rows times 4
// consecutive columns of it, so every shared load of 4 samples (one 16-byte
// load) feeds up to 16 FMAs and the tap loops stay bound by arithmetic, not
// by shared-memory bandwidth.
//
// The block stages the (kTR + H - 1) x (kTC + W - 1) input samples the tile
// reads (rows padded to whole 16-byte loads) in shared memory. The source
// index of a staged sample is mapped by the pad mode, so a same-size apply
// needs no padded copy of the image: numpy's rules for any pad width, since
// a small image can be shorter than the pad.
#pragma once

#include "stencil_tile.cuh"

namespace sgt2d {

using sgt::kThreads;
using sgt::madd;
using sgt::row_taps4;
using sgt::Vec4;

constexpr int kQR = 4;                        // output rows per thread
constexpr int kColThreads = 16;               // threads across a tile row
constexpr int kTC = 4 * kColThreads;          // tile columns
constexpr int kTR = kQR * (kThreads / kColThreads);   // tile rows
constexpr int kMaxTaps = 33;                  // 2 * MAX_HALF_WINDOW_2D + 1

// The pad modes and their index map live in stencil_tile.cuh; kValid (no
// padding: samples outside the image feed only outputs past the ragged
// edge) is its kZero.
using sgt::kEdge;
using sgt::kSymmetric;
using sgt::kWrap;
using sgt::map_index;
constexpr int kValid = sgt::kZero;

// Staged rows and row stride for an H x W stencil. The stride holds the
// kTC + W - 1 samples a tile row reads plus the lanes that the last 16-byte
// loads of the tap loops fetch but never use, and is a multiple of 4.
__host__ __device__ inline int stage_rows(int H) { return kTR + H - 1; }
__host__ __device__ inline int stage_cols(int W) { return kTC + (W & ~3) + 4; }
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// The tile of block blockIdx.x: blocks cover (image, tile row, tile column)
// flattened into gridDim.x, so any batch size launches.
struct Tile {
  long long b;   // image
  int r0, c0;    // first output row and column
};

__device__ __forceinline__ Tile tile_of(int tiles_r, int tiles_c) {
  const long long id = blockIdx.x;
  const long long rest = id / tiles_c;
  return {rest / tiles_r, static_cast<int>(rest % tiles_r) * kTR,
          static_cast<int>(id % tiles_c) * kTC};
}

// Stages rows [row0, row0 + SR) x columns [col0, col0 + SW) of the padded
// image into xs (row stride SW): each warp copies whole rows, its lanes
// neighbouring columns.
template <typename T>
__device__ void stage_tile(const T* __restrict__ img, int R, int C, int row0,
                           int col0, int SR, int SW, int mode,
                           T* __restrict__ xs) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < SR; i += kThreads / 32) {
    const int gr = map_index(row0 + i, R, mode);
    T* __restrict__ dst = xs + i * SW;
    if (gr < 0) {
      for (int j = lane; j < SW; j += 32) dst[j] = T(0);
      continue;
    }
    const T* __restrict__ src = img + static_cast<long long>(gr) * C;
    for (int j = lane; j < SW; j += 32) {
      const int gc = map_index(col0 + j, C, mode);
      dst[j] = gc >= 0 ? src[gc] : T(0);
    }
  }
}

// Stores a thread's kQR x 4 outputs at (r, c) of an (Ro, Co) plane, masking
// the ragged edge. Scalar stores: Co need not keep rows 16-byte aligned.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ plane, int Ro,
                                           int Co, int r, int c,
                                           const T acc[kQR][4]) {
#pragma unroll
  for (int q = 0; q < kQR; ++q) {
    if (r + q >= Ro) break;
    T* __restrict__ orow = plane + static_cast<long long>(r + q) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < Co) orow[c + j] = acc[q][j];
  }
}

// Checks the launch geometry and fills the grid; returns cudaSuccess or
// cudaErrorInvalidValue / cudaErrorInvalidConfiguration.
inline cudaError_t grid_2d(long long B, long long R, long long C, long long H,
                           long long W, int mode, int* Ro, int* Co,
                           int* tiles_r, int* tiles_c, dim3* grid) {
  if (H < 1 || W < 1 || H > kMaxTaps || W > kMaxTaps || H % 2 == 0 ||
      W % 2 == 0 || mode < kValid || mode > kWrap || R < 1 || C < 1 ||
      R * C > 0x7fffffffLL || B < 1)
    return cudaErrorInvalidValue;
  const long long ro = mode == kValid ? R - H + 1 : R;
  const long long co = mode == kValid ? C - W + 1 : C;
  if (ro < 1 || co < 1) return cudaErrorInvalidValue;
  *Ro = static_cast<int>(ro);
  *Co = static_cast<int>(co);
  *tiles_r = static_cast<int>((ro + kTR - 1) / kTR);
  *tiles_c = static_cast<int>((co + kTC - 1) / kTC);
  const long long blocks = B * *tiles_r * *tiles_c;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

// Dynamic shared memory above the default 48 KB has to be asked for.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace sgt2d
