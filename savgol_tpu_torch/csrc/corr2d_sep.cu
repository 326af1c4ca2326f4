// K2D-sep: separable 2D VALID correlation with a stencil given by its rank
// factors, w = sum_{k < r} outer(u[k], v[k]) (u: r x H, v: r x W, factored
// by SVD on the host in f64),
//
//     out[b, i, j] = sum_k sum_y u[k, y] * sum_x v[k, x] * X[b, i + y, j + x],
//
// with X the input as it is (VALID) or in a pad mode, mapped while a tile
// is staged, as in corr2d_valid.cu. r * (H + W) taps a pixel instead of
// H * W: 33 x 33 at order 6 is 7 * 66 = 462 instead of 1089. f32 sums in
// f32 and f64 in f64, by FMA on the CUDA cores (an exact path: no tensor
// cores, no TF32), every tap of both passes, so a NaN or inf reaches
// exactly the outputs whose window holds it.
//
// Replaces the TPU kernels of savgol_tpu/ops/pallas_conv.py:
//   K7a _corr2d_sep_const_call :1814 (factors baked as constants, shifted
//       tap loops on the VPU),
//   K7b _corr2d_sep_mxu_kernel :1879 / _corr2d_sep_mxu_call :1917 (both
//       passes as banded MXU matmuls).
// One function; the TPU split it for its VPU/MXU split.
//
// Bound: the larger of the bytes, 8 B an f32 pixel at 3.35 TB/s (0.160 ms
// at 16 x 2048^2), and r (H + W) FMAs a pixel at the data sheet's 33.5
// TFMA/s f32: at rank 2 and 11 x 11 the bytes (the FMAs take 0.088 ms), at
// rank 4 and 33 x 33 the FMAs (0.53 ms; both derived, not measured).
//
// The sweep: a block walks down a strip of 64 output columns, kChunks = 16
// chunks of 32 rows. For each chunk it stages the 32 new input rows
// (16-byte loads at the aligned addresses, stencil2d.cuh stage4; the next
// chunk's lines prefetched into L1 meanwhile, 12-20% at 11 x 11), runs the
// row pass of every rank over them into a ring in shared memory that keeps
// the last 32 + H - 1 row-pass rows of each rank, then the column pass of
// all ranks out of the ring into register accumulators and to device
// memory. So the row pass runs once over each input row of the strip (the
// 64-row tiles re-ran it on H - 1 halo rows per tile, half as much again
// at 33), a chunk costs two __syncthreads for all ranks, a thread's row
// pass keeps 8 columns of two ranks on one register window of the staged
// row, and its column pass 4 rows of two columns (one 8- or 16-byte shared
// load feeds up to 8 FMAs; paired stores). For the square widths 11 and
// 19-33 (the widths Savgol2D's auto route sends here and the 2D headline's
// "sep") the widths are template parameters, so both tap loops unroll
// whole: 14-22% less time than the runtime-width instance, which takes
// every other window (13-17 through "sep", rectangles such as 17 x 25
// through "auto") in 19-49% less time than the tiles (probes/variants.py
// sep, PERF.md). Only a stencil whose ring passes the 227 KB a block may
// hold (f32 past rank 12 at 33 x 33, f64 past rank 6) takes the 64 x 64
// tile instance below, which runs both passes for each tile; instance()
// is the rule.
#include "stencil2d.cuh"

namespace {

using namespace sgt2d;

// The tile instance: per 64 x 64 tile and rank, the row pass over the
// staged rows into a shared buffer (each thread 4 outputs from 16-byte
// loads, row_taps4), then the column pass into register accumulators (each
// thread 4 x 4 outputs, one 16-byte load of the row-pass buffer feeding up
// to 16 FMAs), summed over the ranks in registers.
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

// -- the sweep -----------------------------------------------------------

constexpr int kSC = 64;        // strip columns
constexpr int kCH = 32;        // rows a chunk
constexpr int kChunks = 16;    // chunks a block: 512 output rows
constexpr int kQC = 8;         // row-pass columns a thread
constexpr int kQRS = 4;        // column-pass rows a thread (of 2
                               // columns)
// The most shared memory a block may take (sm_90): a block whose ring needs
// more runs the tile instance. Past 113 KB an SM holds one block, and the
// sweep still wins (f64 27 x 27 rank 3 1.60 ms against the tiles' 2.86,
// 33 x 33 rank 4 2.22 against 6.84; probes/variants.py sep, PERF.md).
constexpr size_t kSweepSmemMax = 227 * 1024;

// Staged row stride: the kSC + W - 1 columns a strip row reads and the
// lanes the row pass's last 16-byte loads fetch, in 4-column groups, an odd
// number of them, so that 8 rows the row pass reads at one column hit 8
// bank groups (f32).
__host__ __device__ constexpr int sweep_cols(int W) {
  return (kSC / 4 + (W + 3) / 4) % 2 ? kSC + 4 * ((W + 3) / 4)
                                     : kSC + 4 * ((W + 3) / 4) + 4;
}
// Row-pass ring row stride: an odd number of 16-byte units.
template <typename T> __host__ __device__ constexpr int ring_cols() {
  return kSC + 16 / static_cast<int>(sizeof(T));
}

// Asks for the 128-byte lines of input rows [row0, row0 + n) x columns
// [col0, col0 + SW) of the padded image to be brought into L1 (no
// registers, no wait): the next chunk's staging then finds them there
// instead of waiting on device memory behind its __syncthreads.
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* __restrict__ img,
                                              int R, int C, int row0, int n,
                                              int col0, int SW, int mode) {
  constexpr int kLine = 128 / static_cast<int>(sizeof(T));
  const int lines = (SW + kLine - 1) / kLine + 1;
  for (int e = threadIdx.x; e < n * lines; e += kThreads) {
    const int i = e / lines, l = e - i * lines;
    const int gr = map_index(row0 + i, R, mode);
    if (gr < 0) continue;
    const int gc = min(max(col0 + l * kLine, 0), C - 1);
    asm volatile("prefetch.global.L1 [%0];\n"
                 :: "l"(img + static_cast<long long>(gr) * C + gc));
  }
}

template <typename T>
__host__ __device__ inline size_t sweep_smem(int H, int W, int rank) {
  return sizeof(T) * (static_cast<size_t>(kCH) * sweep_cols(W) +
                      static_cast<size_t>(rank) * (kCH + H - 1) *
                          ring_cols<T>() +
                      static_cast<size_t>(rank) * (pad4(H) + pad4(W)));
}

// acc[n][j] += sum_{x < W} v_n[x] * row[j + x] for the kQC outputs j of one
// staged row and NR ranks (v_n zero-padded to a multiple of 4): one
// register window of the row serves both ranks; 16-byte loads, the taps
// 4 at a time.
template <int W, int NR, typename T>
__device__ __forceinline__ void row_pass8(const T* __restrict__ row,
                                          const T* __restrict__ v0,
                                          const T* __restrict__ v1,
                                          T acc[2][kQC]) {
  T r[kQC + 4];
  Vec4<T>::load(row, r);
  Vec4<T>::load(row + 4, r + 4);
#pragma unroll
  for (int q = 0; q < (W + 3) / 4; ++q) {
    Vec4<T>::load(row + 4 * q + kQC, r + kQC);
    T t0[4], t1[4];
    Vec4<T>::load(v0 + 4 * q, t0);
    if (NR == 2) Vec4<T>::load(v1 + 4 * q, t1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (4 * q + kk < W) {
#pragma unroll
        for (int j = 0; j < kQC; ++j) {
          acc[0][j] = madd(t0[kk], r[j + kk], acc[0][j]);
          if (NR == 2) acc[1][j] = madd(t1[kk], r[j + kk], acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQC; ++j) r[j] = r[j + 4];
  }
}

// One tap of row_pass8_rt: acc[n][j] += t_n * r[j].
template <int NR, typename T>
__device__ __forceinline__ void tap8(T t0, T t1, const T* r, T acc[2][kQC]) {
#pragma unroll
  for (int j = 0; j < kQC; ++j) {
    acc[0][j] = madd(t0, r[j], acc[0][j]);
    if (NR == 2) acc[1][j] = madd(t1, r[j], acc[1][j]);
  }
}

// row_pass8 at a runtime width W: the groups of 4 taps that W fills run
// untested, the last one tap by tap; the same sums in the same order.
template <int NR, typename T>
__device__ __forceinline__ void row_pass8_rt(const T* __restrict__ row,
                                             const T* __restrict__ v0,
                                             const T* __restrict__ v1, int W,
                                             T acc[2][kQC]) {
  T r[kQC + 4];
  Vec4<T>::load(row, r);
  Vec4<T>::load(row + 4, r + 4);
#pragma unroll 2
  for (int q = 0; q < (W + 3) / 4; ++q) {
    Vec4<T>::load(row + 4 * q + kQC, r + kQC);
    T t0[4], t1[4];
    Vec4<T>::load(v0 + 4 * q, t0);
    if (NR == 2) Vec4<T>::load(v1 + 4 * q, t1);
    if (4 * q + 4 <= W) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tap8<NR>(t0[kk], t1[kk], r + kk, acc);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (4 * q + kk < W) tap8<NR>(t0[kk], t1[kk], r + kk, acc);
    }
#pragma unroll
    for (int j = 0; j < kQC; ++j) r[j] = r[j + 4];
  }
}

// Every rank's row pass of one staged row into its ring row, ranks two at
// a time, at the compile-time width WC, or where it is 0 the runtime w.
template <int WC, typename T>
__device__ __forceinline__ void row_passes(const T* __restrict__ row,
                                           const T* __restrict__ vs,
                                           T* __restrict__ ring, int rank,
                                           int plane, int w) {
  const int WP = pad4(WC > 0 ? WC : w);
  for (int k = 0; k < rank; k += 2) {
    T acc[2][kQC];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < kQC; ++j) acc[n][j] = T(0);
    T* __restrict__ dst = ring + static_cast<long long>(k) * plane;
    const T* __restrict__ vk = vs + k * WP;
    if (k + 1 < rank) {
      if constexpr (WC > 0)
        row_pass8<WC, 2>(row, vk, vk + WP, acc);
      else
        row_pass8_rt<2>(row, vk, vk + WP, w, acc);
      Vec4<T>::store(dst + plane, acc[1]);
      Vec4<T>::store(dst + plane + 4, acc[1] + 4);
    } else if constexpr (WC > 0) {
      row_pass8<WC, 1>(row, vk, vk, acc);
    } else {
      row_pass8_rt<1>(row, vk, vk, w, acc);
    }
    Vec4<T>::store(dst, acc[0]);
    Vec4<T>::store(dst + 4, acc[0] + 4);
  }
}

template <typename T> struct Pair;
template <> struct Pair<float> { using V = float2; };
template <> struct Pair<double> { using V = double2; };

// acc[q][j] += sum_{y < H} u[y] * ring[slot + q + y][j] for the kQRS x 2
// outputs of two neighbouring columns (u zero-padded to a multiple of 4),
// the ring's NRS rows taken modulo NRS: a thread reads kQRS + H - 1 <= NRS
// rows, so they wrap at most once, at i = NRS - slot.
template <int H, int NRS, typename T>
__device__ __forceinline__ void col_pass(const T* __restrict__ col, int slot,
                                         const T* __restrict__ u,
                                         T acc[kQRS][2]) {
  constexpr int RS = ring_cols<T>();
  T uy[(H + 3) & ~3];
#pragma unroll
  for (int y = 0; y < H; y += 4) Vec4<T>::load(u + y, uy + y);
  const T* lo = col + slot * RS;
  const T* hi = lo - NRS * RS;
  const int wrap = NRS - slot;
#pragma unroll
  for (int i = 0; i < kQRS + H - 1; ++i) {
    const typename Pair<T>::V c =
        *reinterpret_cast<const typename Pair<T>::V*>((i < wrap ? lo : hi) +
                                                      i * RS);
#pragma unroll
    for (int q = 0; q < kQRS; ++q) {
      const int y = i - q;
      if (y >= 0 && y < H) {
        acc[q][0] = madd(uy[y], c.x, acc[q][0]);
        acc[q][1] = madd(uy[y], c.y, acc[q][1]);
      }
    }
  }
}

// col_pass at a runtime height H (ring of kCH + H - 1 rows): a window of
// kQRS ring rows slides down the taps, one new row and one tap u[y] (a
// broadcast shared load) a step, so each step is 2 loads and 2 kQRS FMAs
// with no test; the same sums in the same order as col_pass.
template <typename T>
__device__ __forceinline__ void col_pass_rt(const T* __restrict__ col,
                                            int slot, const T* __restrict__ u,
                                            int H, T acc[kQRS][2]) {
  using V = typename Pair<T>::V;
  constexpr int RS = ring_cols<T>();
  const T* lo = col + slot * RS;
  const T* hi = lo - (kCH + H - 1) * RS;
  const int wrap = kCH + H - 1 - slot;
  V c[kQRS];
#pragma unroll
  for (int q = 1; q < kQRS; ++q)
    c[q] = *reinterpret_cast<const V*>((q - 1 < wrap ? lo : hi) +
                                       (q - 1) * RS);
#pragma unroll 4
  for (int y = 0; y < H; ++y) {
#pragma unroll
    for (int q = 0; q + 1 < kQRS; ++q) c[q] = c[q + 1];
    const int i = y + kQRS - 1;
    c[kQRS - 1] = *reinterpret_cast<const V*>((i < wrap ? lo : hi) + i * RS);
    const T uq = u[y];
#pragma unroll
    for (int q = 0; q < kQRS; ++q) {
      acc[q][0] = madd(uq, c[q].x, acc[q][0]);
      acc[q][1] = madd(uq, c[q].y, acc[q][1]);
    }
  }
}

// Blocks an SM that an instance's registers are capped for: f32 to 21 taps
// 4 (64 registers), wider 3 (in turns at 16 x 2048^2: 11 x 11 rank 2 and
// 21 x 21 rank 3 7% and 4% faster at 4 than at 3, 33 x 33 rank 4 13%
// slower, probes/variants.py); f64 2. The runtime-width instance (H = 0)
// takes f32's 4.
template <typename T, int H>
__host__ __device__ constexpr int sweep_blocks() {
  return sizeof(T) == 8 ? 2 : H <= 21 ? 4 : 3;
}

// The sweep of an H x W stencil: HC = H and WC = W at compile time, or
// HC = WC = 0 and the runtime h, w.
template <typename T, int HC, int WC>
__global__ void __launch_bounds__(kThreads, (sweep_blocks<T, HC>()))
corr2d_sep_sweep_kernel(const T* __restrict__ x, const T* __restrict__ u,
                        const T* __restrict__ v, T* __restrict__ out, int R,
                        int C, int Ro, int Co, int rank, int h, int w,
                        int mode, int strips, int bands, bool pairs) {
  const int H = HC > 0 ? HC : h, W = WC > 0 ? WC : w;
  const int SW = sweep_cols(W);
  constexpr int RS = ring_cols<T>();
  const int NRS = kCH + H - 1;               // ring rows
  const int HP = pad4(H), WP = pad4(W);
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);        // kCH x SW staged samples
  T* ring = xs + kCH * SW;                   // rank x NRS x RS row passes
  T* us = ring + rank * NRS * RS;            // rank x HP
  T* vs = us + rank * HP;                    // rank x WP, zero-padded
  const int plane = NRS * RS;
  const long long id = blockIdx.x;
  const int c0 = static_cast<int>(id % strips) * kSC;
  const long long rest = id / strips;
  const int r0 = static_cast<int>(rest % bands) * (kCH * kChunks);
  const long long b = rest / bands;
  const int oy = mode == kValid ? 0 : (H - 1) / 2;
  const int ox = mode == kValid ? 0 : (W - 1) / 2;
  const T* __restrict__ img = x + b * R * C;
  for (int e = threadIdx.x; e < rank * HP; e += kThreads) {
    const int k = e / HP, y = e - k * HP;
    us[e] = y < H ? u[k * H + y] : T(0);
  }
  for (int e = threadIdx.x; e < rank * WP; e += kThreads) {
    const int k = e / WP, xx = e - k * WP;
    vs[e] = xx < W ? v[k * W + xx] : T(0);
  }
  // row pass: staged row ri, columns rc ...; column pass: columns cj and
  // cj + 1, rows cq ... of a chunk
  const int ri = threadIdx.x % kCH, rc = threadIdx.x / kCH * kQC;
  const int cj = threadIdx.x % (kSC / 2) * 2;
  const int cq = threadIdx.x / (kSC / 2) * kQRS;

  // the first H - 1 input rows of the strip into ring rows 0 ... H - 2
  stage4<kThreads>(img, R, C, r0 - oy, c0 - ox, H - 1, SW, mode, xs);
  __syncthreads();
  prefetch_rows(img, R, C, r0 - oy + H - 1, kCH, c0 - ox, SW, mode);
  if (ri < H - 1)
    row_passes<WC>(xs + ri * SW + rc, vs, ring + ri * RS + rc, rank, plane,
                   W);
  __syncthreads();

  const int nch = min(kChunks, (Ro - r0 + kCH - 1) / kCH);
  int wslot = H - 1;   // ring row of the chunk's first row-pass row
  int cslot = 0;       // ring row of the chunk's first column-pass input
  for (int c = 0; c < nch; ++c) {
    stage4<kThreads>(img, R, C, r0 - oy + H - 1 + c * kCH, c0 - ox, kCH, SW,
                     mode, xs);
    __syncthreads();   // staged; every column pass of chunk c - 1 is done
    if (c + 1 < nch)
      prefetch_rows(img, R, C, r0 - oy + H - 1 + (c + 1) * kCH, kCH, c0 - ox,
                    SW, mode);
    int s = wslot + ri;
    if (s >= NRS) s -= NRS;
    row_passes<WC>(xs + ri * SW + rc, vs, ring + s * RS + rc, rank, plane, W);
    __syncthreads();   // the ring holds the chunk's rows; xs is free

    T acc[kQRS][2];
#pragma unroll
    for (int q = 0; q < kQRS; ++q) acc[q][0] = acc[q][1] = T(0);
    s = cslot + cq;
    if (s >= NRS) s -= NRS;
    for (int k = 0; k < rank; ++k)
      if constexpr (HC > 0)
        col_pass<HC, kCH + HC - 1>(ring + k * plane + cj, s, us + k * HP,
                                   acc);
      else
        col_pass_rt(ring + k * plane + cj, s, us + k * HP, H, acc);
    const int orow = r0 + c * kCH + cq, ocol = c0 + cj;
    if (ocol < Co) {
      T* __restrict__ o = out + (b * Ro + orow) * Co + ocol;
#pragma unroll
      for (int q = 0; q < kQRS; ++q) {
        if (orow + q >= Ro) break;
        T* __restrict__ p = o + static_cast<long long>(q) * Co;
        if (pairs) {
          *reinterpret_cast<typename Pair<T>::V*>(p) = {acc[q][0],
                                                        acc[q][1]};
        } else {
          p[0] = acc[q][0];
          if (ocol + 1 < Co) p[1] = acc[q][1];
        }
      }
    }
    wslot += kCH;
    if (wslot >= NRS) wslot -= NRS;
    cslot += kCH;
    if (cslot >= NRS) cslot -= NRS;
  }
}

template <typename T, int HC, int WC>
cudaError_t run_sweep(const T* x, const T* u, const T* v, T* out,
                      long long B, int R, int C, int Ro, int Co, int rank,
                      int H, int W, int mode, cudaStream_t stream) {
  const int strips = (Co + kSC - 1) / kSC;
  const int bands = (Ro + kCH * kChunks - 1) / (kCH * kChunks);
  const long long blocks = B * strips * bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = sweep_smem<T>(H, W, rank);
  // two outputs a store where every row keeps column pairs aligned
  const bool pairs = Co % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  const cudaError_t err = allow_smem(corr2d_sep_sweep_kernel<T, HC, WC>,
                                     smem);
  if (err != cudaSuccess) return err;
  corr2d_sep_sweep_kernel<T, HC, WC><<<dim3(static_cast<unsigned>(blocks)),
                                       kThreads, smem, stream>>>(
      x, u, v, out, R, C, Ro, Co, rank, H, W, mode, strips, bands, pairs);
  return cudaGetLastError();
}

// Which instance an H x W stencil of this rank runs: kTileInstance (the
// 64 x 64 tiles), kRuntimeSweep (the sweep at runtime widths) or the
// width of a compile-time square sweep. The one rule: launch follows it
// and corr2d_sep_instance reports it.
constexpr int kTileInstance = 0, kRuntimeSweep = 1;

template <typename T>
int instance(int H, int W, int rank) {
  if (sweep_smem<T>(H, W, rank) > kSweepSmemMax) return kTileInstance;
  if (H == W) {
    switch (H) {
      case 11: case 19: case 21: case 23: case 25: case 27: case 29:
      case 31: case 33:
        return H;
      default:
        break;
    }
  }
  return kRuntimeSweep;
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
  const int rr = static_cast<int>(R), cc = static_cast<int>(C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (instance<T>(h, wd, r)) {
#define SEP_SWEEP_CASE(N)                                                   \
  case N:                                                                   \
    return run_sweep<T, N, N>(x, u, v, out, B, rr, cc, Ro, Co, r, h, wd,    \
                              mode, s);
    SEP_SWEEP_CASE(11)
    SEP_SWEEP_CASE(19)
    SEP_SWEEP_CASE(21)
    SEP_SWEEP_CASE(23)
    SEP_SWEEP_CASE(25)
    SEP_SWEEP_CASE(27)
    SEP_SWEEP_CASE(29)
    SEP_SWEEP_CASE(31)
    SEP_SWEEP_CASE(33)
#undef SEP_SWEEP_CASE
    case kRuntimeSweep:
      return run_sweep<T, 0, 0>(x, u, v, out, B, rr, cc, Ro, Co, r, h, wd,
                                mode, s);
    default:
      break;
  }
  const size_t smem = sizeof(T) * (stage_rows(h) * stage_cols(wd) +
                                   stage_rows(h) * kTC +
                                   r * (pad4(h) + pad4(wd)));
  err = allow_smem(corr2d_sep_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  corr2d_sep_kernel<T><<<grid, kThreads, smem, s>>>(
      x, u, v, out, rr, cc, Ro, Co, r, h, wd, mode, tiles_r, tiles_c);
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

// The instance launch runs for these arguments (dtype_size 4 or 8): 0 the
// tiles, 1 the runtime-width sweep, else the width of a compile-time
// square sweep; -1 for arguments launch refuses.
extern "C" int corr2d_sep_instance(long long H, long long W, long long rank,
                                   int dtype_size) {
  if (H < 1 || W < 1 || H > kMaxTaps || W > kMaxTaps || rank < 1 ||
      rank > kMaxTaps || (dtype_size != 4 && dtype_size != 8))
    return -1;
  const int h = static_cast<int>(H), w = static_cast<int>(W);
  const int r = static_cast<int>(rank);
  return dtype_size == 4 ? instance<float>(h, w, r) : instance<double>(h, w, r);
}
