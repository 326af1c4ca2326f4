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
// a small image can be shorter than the pad. stage_tile loads a sample at a
// time (K7's tile instance); stage4 (K2D-dense, K7's sweep) 4 at a time
// from 16-byte loads, mapping only a group that leaves the image.
#pragma once

#include <stdint.h>

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

// 4 samples p[0, 4) of a row, from 16-byte loads at the aligned addresses
// around them, shifted into place.
__device__ __forceinline__ void load4(const float* p, float r[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int m = static_cast<int>((a >> 2) & 3);    // samples past alignment
  const float4* v = reinterpret_cast<const float4*>(a & ~uintptr_t(15));
  const float4 v0 = __ldg(v);
  const float4 v1 = m ? __ldg(v + 1) : v0;
  float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  if (m & 2) {
#pragma unroll
    for (int i = 0; i < 6; ++i) f[i] = f[i + 2];
  }
  if (m & 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = f[i + 1];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = f[i];
}

__device__ __forceinline__ void load4(const double* p, double r[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int m = static_cast<int>((a >> 3) & 1);
  const double2* v = reinterpret_cast<const double2*>(a & ~uintptr_t(15));
  const double2 v0 = __ldg(v), v1 = __ldg(v + 1);
  const double2 v2 = m ? __ldg(v + 2) : v1;
  const double f[6] = {v0.x, v0.y, v1.x, v1.y, v2.x, v2.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = m ? f[i + 1] : f[i];
}

// Stages rows [row0, row0 + SR) x columns [col0, col0 + SW) of the padded
// image into xs (row stride SW, a multiple of 4), 4 samples a thread of NT
// at a time: 16-byte loads at the aligned addresses (load4), only a group
// of 4 that leaves the image mapped one sample at a time.
template <int NT, typename T>
__device__ __forceinline__ void stage4(const T* __restrict__ img, int R,
                                       int C, int row0, int col0, int SR,
                                       int SW, int mode, T* __restrict__ xs) {
  const int groups = SW / 4;
  for (int e = threadIdx.x; e < SR * groups; e += NT) {
    const int i = e / groups, g = e - i * groups;
    const int gr = map_index(row0 + i, R, mode);
    const int gc = col0 + 4 * g;
    T v[4] = {T(0), T(0), T(0), T(0)};
    if (gr >= 0) {
      const T* __restrict__ src = img + static_cast<long long>(gr) * C;
      if (gc >= 0 && gc + 4 <= C) {
        load4(src + gc, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = map_index(gc + j, C, mode);
          if (c >= 0) v[j] = src[c];
        }
      }
    }
    Vec4<T>::store(xs + i * SW + 4 * g, v);
  }
}

// Stores a thread's kQR x 4 outputs at (r, c) of an (Ro, Co) plane,
// masking the ragged edge. Scalar stores: Co need not keep rows 16-byte
// aligned.
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
