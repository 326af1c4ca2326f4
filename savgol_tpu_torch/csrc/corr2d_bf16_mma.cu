// K2D-dense in its bf16 mode (method="bf16", corr2d_valid_bf16): the dense
// 2D VALID correlation of K stencils over one read of the input,
//
//     out[b, k, r, c] = sum_{y < H, x < W} w[k, y, x] * X[b, r + y, c + x],
//
// on bf16 operands with f32 sums, on the tensor cores. X is the (B, R, C)
// input as it is (VALID) or extended by (H - 1) / 2 rows and (W - 1) / 2
// columns in a pad mode (edge = CONSTANT, symmetric = REFLECT, wrap =
// PERIODIC), mapped while a tile is staged. H and W are odd, at most 33.
// Samples are rounded to bf16 as they are staged, the taps are bf16 values
// held in f32 (ops/cuda_conv.py bf16_taps), every product is exact in f32;
// f32 storage gets the f32 sum unrounded, bf16 storage the sum rounded to
// bf16 (put1, put2).
//
// Replaces the TPU kernels of savgol_tpu/ops/pallas_conv.py on bf16
// operands at single-pass MXU precision (mxu_precision=DEFAULT):
//   K6a _corr2d_rowmxu_kernel :1501 / _corr2d_rowmxu_call :1530 (entries
//       correlate2d_valid_pallas_rowmxu :1580, savgol2d_same_pallas_rowmxu
//       :1622),
//   K6b _corr2d_rowmxu_stack_kernel :1670 / _corr2d_rowmxu_stack_call :1702
//       (entry correlate2d_valid_pallas_rowmxu_stack :1749).
//
// The product is the TPU kernel's row band, cut to 16 output columns. For a
// 16 x 16 block of outputs at (r, c):
//
//     acc += sum_{y < H} A_y . B_y,
//
// A_y the staged rows r + y ... r + y + 15 by input columns [c, c + S), B_y
// stencil row y's band, B_y[q, p] = w[y, q - p] for 0 <= q - p < W, else 0
// (_rowband_matrices :1487 cut to S rows and 16 columns; ops/cuda_conv2d.py
// row_bands states the layout). Its depth S = 16 ceil((15 + W) / 16) is 32
// for W <= 17 and 48 for W <= 33. Each product runs as mma.sync m16n8k16
// on bf16 with f32 accumulation; A and B come from shared memory through
// ldmatrix. ldmatrix takes one row address a lane, so the vertical shift by
// y is free: it is the TPU kernel's input-side shift (the comment at
// :1502-1506). The instance with OwnRows set, P2's B_alignctl
// (corr2d_bf16_alignctl below), reads every stencil row's A at the
// output's own rows, so its time against this kernel's is what that shift
// costs. wgmma reads shared memory through descriptors of 8-row core
// matrices and would need a restaged copy of the tile for each y.
//
// Bound: device-memory bytes. At 11 x 11 the band does 11 x 32 MACs a pixel
// (121 live), 47 GFLOP at 16 x 2048^2, 0.048 ms at 989 TFLOP/s dense bf16,
// below the 0.080 ms of its bytes at 3.35 TB/s (bf16 storage; derived, not
// measured); at 33 x 33 33 x 48 MACs, 0.21 ms. So the design cuts the cost
// of a tile:
//
// - A block of 8 warps computes 64 x 128 outputs, each warp 64 x 16 (four
//   16-row blocks, so one B fragment serves four products). The block
//   stages the (64 + H - 1) x (128 + S - 16) input samples once, as bf16,
//   rows padded to an odd number of 16-byte units so that ldmatrix is free
//   of bank conflicts.
// - Staging moves 8 samples at a time: 16-byte loads of the caller's f32 or
//   bf16 storage at their aligned addresses, shifted into place in
//   registers (funnel shifts), rounded and packed to bf16, one 16-byte
//   shared store. Only a group of 8 that leaves the image goes through the
//   pad mode's index map, one sample at a time.
// - A stack runs all K stencils over the one staged tile (K6b's purpose);
//   the block rebuilds the H bands in shared memory for each stencil from
//   its taps (H W values), their zeros written once.
// - Band blocks of zeros (16 input columns that no tap of 8 outputs
//   reaches, W <= 9 at depth 32) are skipped.
//
// A non-finite sample meets the band's zeros (0 * inf and 0 * NaN are NaN)
// and spreads to the outputs of every 16-column block whose S columns hold
// it, as the TPU kernel's band matmul does. So staging flags a tile whose
// samples are not all finite, and after the tensor-core products such a
// tile writes its outputs again on the CUDA cores, each from its own window
// only (window_tile): the plain version's NaN / inf pattern and values.
// The flag rides to the end of the kernel (one __syncthreads_or there):
// taking the branch before the products instead measured slower on finite
// tiles, this form as fast as no flag at all (probes/variants.py).
#include <stdint.h>

#include "bf16_mma.cuh"
#include "stencil2d.cuh"

namespace {

using sgmma::ldmatrix_x4;
using sgmma::load8;
using sgmma::mma_bf16;
using sgmma::nonfinite8;
using sgmma::pack_bf16;
using sgmma::smem_addr;
using sgt2d::map_index;

constexpr int kWarps = 8;
constexpr int kThreadsM = 32 * kWarps;
constexpr int kMT = 4;                  // 16-row blocks a warp
constexpr int kBR = 16 * kMT;           // tile rows
constexpr int kBC = 16 * kWarps;        // tile columns

// The band's depth for a stencil W wide: whole 16-column chunks holding
// 15 + W input columns.
__host__ __device__ inline int band_depth(int W) {
  return 16 * ((W + 30) / 16);
}
// A shared row stride in bf16 values: n rounded up to whole 16-byte units,
// an odd number of them, so 8 rows that ldmatrix reads hit 8 bank groups.
__host__ __device__ inline int odd_units(int n) {
  n = (n + 7) & ~7;
  return (n / 8) % 2 ? n : n + 8;
}

struct Layout {
  int S;    // band depth
  int SC;   // staged columns, kBC + S - 16
  int SR;   // staged rows, kBR + H - 1
  int SA;   // staged row stride
  int SB;   // band row stride
  __host__ __device__ Layout(int H, int W)
      : S(band_depth(W)), SC(kBC + band_depth(W) - 16), SR(kBR + H - 1),
        SA(odd_units(kBC + band_depth(W) - 16)),
        SB(odd_units(band_depth(W))) {}
  __host__ __device__ size_t smem(int H) const {
    return sizeof(__nv_bfloat16) *
           (static_cast<size_t>(SR) * SA + static_cast<size_t>(H) * 16 * SB);
  }
};

// Stages rows [row0, row0 + L.SR) x columns [col0, col0 + L.SC) of image b
// (padded by `mode`) into xs as bf16, 8 columns at a time. Returns whether
// any sample this thread staged is an inf or a NaN.
template <typename In>
__device__ __forceinline__ bool stage(const In* __restrict__ x, long long b,
                                      int R, int C, int row0, int col0,
                                      int mode, const Layout& L,
                                      __nv_bfloat16* __restrict__ xs) {
  const int groups = L.SC / 8;
  bool bad = false;
  for (int i = threadIdx.x; i < L.SR * groups; i += kThreadsM) {
    const int row = i / groups, g = i - row * groups;
    const int gr = map_index(row0 + row, R, mode);
    const int gc = col0 + 8 * g;
    uint4* dst = reinterpret_cast<uint4*>(xs + row * L.SA + 8 * g);
    if (gr < 0) {
      *dst = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const In* __restrict__ src = x + (b * R + gr) * C;
    uint4 v;
    if (gc >= 0 && gc + 8 <= C) {
      v = load8(src + gc);
    } else {
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = map_index(gc + j, C, mode);
        f[j] = c >= 0 ? sgt::Bf16::load(src[c]) : 0.0f;
      }
      v = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    }
    *dst = v;
    bad = bad || nonfinite8(v);
  }
  return bad;
}

__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The tile's outputs when its staged samples hold an inf or a NaN, on the
// CUDA cores: each output sums only its own window's products, in the
// plain version's (y, x) order (every product is exact in f32, so the sums
// are the plain version's), so a non-finite sample reaches exactly the
// outputs whose window holds it; no band zero meets a sample. A thread
// takes one column of the tile and every other row. Out of line, so that
// the tensor-core path's registers do not see it.
template <typename In>
__device__ __noinline__ void window_tile(const __nv_bfloat16* __restrict__ xs,
                            const float* __restrict__ w, In* __restrict__ out,
                            long long b, int r0, int c0, int Ro, int Co,
                            int K, int H, int W, const Layout& L) {
  const int c = threadIdx.x % kBC;
  if (c0 + c >= Co) return;
  for (int k = 0; k < K; ++k) {
    const float* __restrict__ wk = w + static_cast<long long>(k) * H * W;
    In* plane = out + (b * K + k) * static_cast<long long>(Ro) * Co;
    for (int r = threadIdx.x / kBC; r < kBR && r0 + r < Ro;
         r += kThreadsM / kBC) {
      float acc = 0.0f;
      for (int y = 0; y < H; ++y) {
        const __nv_bfloat16* row = xs + (r + y) * L.SA + c;
        for (int xx = 0; xx < W; ++xx)
          acc = fmaf(__ldg(wk + y * W + xx), __bfloat162float(row[xx]), acc);
      }
      put1(plane + static_cast<long long>(r0 + r) * Co + c0 + c, acc);
    }
  }
}

// Writes stencil k's bands into their places: bands[y][p][p + d] =
// w[k, y, d] for p < 16, d < W (the zeros around them are written once).
__device__ __forceinline__ void put_bands(const float* __restrict__ wk,
                                          int H, int W, const Layout& L,
                                          __nv_bfloat16* __restrict__ bands) {
  for (int e = threadIdx.x; e < H * W; e += kThreadsM) {
    const int y = e / W, d = e - y * W;
    const __nv_bfloat16 v = __float2bfloat16_rn(wk[e]);
    __nv_bfloat16* row = bands + y * 16 * L.SB + d;
#pragma unroll
    for (int p = 0; p < 16; ++p) row[p * L.SB + p] = v;
  }
}

// Two neighbouring outputs (r, c), (r, c + 1) of a plane, masked to the
// ragged edge; one store where the pair is aligned.
__device__ __forceinline__ void put2(float* plane, int Ro, int Co, int r,
                                     int c, float v0, float v1, bool pairs) {
  if (r >= Ro || c >= Co) return;
  float* p = plane + static_cast<long long>(r) * Co + c;
  if (pairs) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    return;
  }
  p[0] = v0;
  if (c + 1 < Co) p[1] = v1;
}

__device__ __forceinline__ void put2(__nv_bfloat16* plane, int Ro, int Co,
                                     int r, int c, float v0, float v1,
                                     bool pairs) {
  if (r >= Ro || c >= Co) return;
  __nv_bfloat16* p = plane + static_cast<long long>(r) * Co + c;
  if (pairs) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(v0, v1);
    return;
  }
  p[0] = __float2bfloat16_rn(v0);
  if (c + 1 < Co) p[1] = __float2bfloat16_rn(v1);
}

// In: float (f32 storage) or __nv_bfloat16 (bf16 storage); the output in
// the same storage. pairs: Co is even and out 2-element aligned. OwnRows
// (P2's B_alignctl only): stencil row y reads the staged rows of the
// outputs themselves, not the rows y below them,
//     out[b, k, r, c] = sum_{y, x} w[k, y, x] * X[b, r, c + x].
template <typename In, bool OwnRows = false>
__global__ void __launch_bounds__(kThreadsM, 3)
corr2d_bf16_mma_kernel(const In* __restrict__ x, const float* __restrict__ w,
                       In* __restrict__ out, int R, int C, int Ro, int Co,
                       int K, int H, int W, int mode, int tiles_r,
                       int tiles_c, bool pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(H, W);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bands = xs + L.SR * L.SA;
  const long long id = blockIdx.x;
  const long long rest = id / tiles_c;
  const long long b = rest / tiles_r;
  const int r0 = static_cast<int>(rest % tiles_r) * kBR;
  const int c0 = static_cast<int>(id % tiles_c) * kBC;
  const int oy = mode == sgt2d::kValid ? 0 : (H - 1) / 2;
  const int ox = mode == sgt2d::kValid ? 0 : (W - 1) / 2;
  const bool bad = stage(x, b, R, C, r0 - oy, c0 - ox, mode, L, xs);
  for (int i = threadIdx.x; i < H * 16 * L.SB / 8; i += kThreadsM)
    reinterpret_cast<uint4*>(bands)[i] = make_uint4(0u, 0u, 0u, 0u);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KC = L.S / 16;
  // ldmatrix row addresses: A's 16 rows by 2 halves of 16 columns; B's
  // transpose (bands[y][p][q]) as p 0-7 / 8-15 by q halves, so the four
  // registers are the b0b1, b2b3 fragments of output columns 0-7, then
  // 8-15
  const unsigned a_base =
      smem_addr(xs + (lane & 15) * L.SA + warp * 16 + (lane >> 4) * 8);
  const unsigned b_base = smem_addr(
      bands + ((lane >> 4) * 8 + (lane & 7)) * L.SB + ((lane >> 3) & 1) * 8);
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    __syncthreads();   // the zeros (k = 0) or every warp done with k - 1
    put_bands(w + static_cast<long long>(k) * H * W, H, W, L, bands);
    __syncthreads();   // also publishes the staged tile, first time

    float acc[kMT][2][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;
#pragma unroll 1
    for (int y = 0; y < H; ++y) {
      const int ay = OwnRows ? 0 : y;   // A's first staged row
#pragma unroll 1
      for (int kc = 0; kc < KC; ++kc) {
        // output columns 0-7 meet input columns 16 kc ... only if
        // 16 kc - 7 < W; columns 8-15 do for every chunk of the depth
        const bool left = 16 * kc - 7 < W;
        unsigned bf[4];
        ldmatrix_x4(bf, b_base + 2u * (y * 16 * L.SB + 16 * kc));
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          unsigned af[4];
          ldmatrix_x4(af, a_base + 2u * ((16 * m + ay) * L.SA + 16 * kc));
          if (left) mma_bf16(acc[m][0], af, bf[0], bf[1]);
          mma_bf16(acc[m][1], af, bf[2], bf[3]);
        }
      }
    }
    In* plane = out + (b * K + k) * static_cast<long long>(Ro) * Co;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r = r0 + 16 * m + g, c = c0 + warp * 16 + n * 8 + 2 * t;
        put2(plane, Ro, Co, r, c, acc[m][n][0], acc[m][n][1], pairs);
        put2(plane, Ro, Co, r + 8, c, acc[m][n][2], acc[m][n][3], pairs);
      }
  }
  // a tile holding an inf or a NaN: every warp's stores above are done, and
  // its outputs are written again from their windows
  if (__syncthreads_or(bad))
    window_tile(xs, w, out, b, r0, c0, Ro, Co, K, H, W, L);
}

template <bool OwnRows = false, typename In>
int launch(const In* x, const float* w, In* out, long long B, long long R,
           long long C, long long K, long long H, long long W, int mode,
           void* stream) {
  int Ro, Co, tiles_r, tiles_c;
  dim3 grid;
  if (K < 1 || K > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the checks and output size of the 2D kernels; this kernel's own tiles
  cudaError_t err = sgt2d::grid_2d(B, R, C, H, W, mode, &Ro, &Co, &tiles_r,
                                   &tiles_c, &grid);
  if (err != cudaSuccess) return err;
  tiles_r = (Ro + kBR - 1) / kBR;
  tiles_c = (Co + kBC - 1) / kBC;
  const long long blocks = B * tiles_r * tiles_c;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int h = static_cast<int>(H), wd = static_cast<int>(W);
  const size_t smem = Layout(h, wd).smem(h);
  const auto kernel = corr2d_bf16_mma_kernel<In, OwnRows>;
  err = sgt2d::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool pairs = Co % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(In)) == 0;
  kernel<<<dim3(static_cast<unsigned>(blocks)), kThreadsM, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, w, out, static_cast<int>(R), static_cast<int>(C), Ro, Co,
      static_cast<int>(K), h, wd, mode, tiles_r, tiles_c, pairs);
  return cudaGetLastError();
}

}  // namespace

// method="bf16": x and out in f32 (bf16_storage = 0) or bf16 (1) storage,
// w (K, H, W) bf16 values held in f32.
extern "C" int corr2d_valid_bf16(const void* x, const float* w, void* out,
                                 long long B, long long R, long long C,
                                 long long K, long long H, long long W,
                                 int mode, int bf16_storage, void* stream) {
  if (bf16_storage)
    return launch(static_cast<const __nv_bfloat16*>(x), w,
                  static_cast<__nv_bfloat16*>(out), B, R, C, K, H, W, mode,
                  stream);
  return launch(static_cast<const float*>(x), w, static_cast<float*>(out), B,
                R, C, K, H, W, mode, stream);
}

// P2's B_alignctl (probes/rowband2d.py): one (H, W) stencil on the
// OwnRows instance, out as corr2d_valid_bf16's for K = 1.
extern "C" int corr2d_bf16_alignctl(const void* x, const float* w, void* out,
                                    long long B, long long R, long long C,
                                    long long H, long long W, int mode,
                                    int bf16_storage, void* stream) {
  if (bf16_storage)
    return launch<true>(static_cast<const __nv_bfloat16*>(x), w,
                        static_cast<__nv_bfloat16*>(out), B, R, C, 1, H, W,
                        mode, stream);
  return launch<true>(static_cast<const float*>(x), w,
                      static_cast<float*>(out), B, R, C, 1, H, W, mode,
                      stream);
}
