// The 1D stencil tile of the bf16 mode on the tensor cores: K1-bf16 and
// K2-bf16 (sg1d_poly.cu's sg1d_poly_bf16 / sg1d_pad_bf16, staged from
// in0 = t0 - n) and K3-bf16 (corr1d_valid.cu's corr1d_valid_bf16, staged
// from in0 = t0 with zeros past N). Each kernel stages from its in0, runs
// the band products and stores its outputs with the pieces below. The
// attribution probe P3 (probe_bf16_1d.cu) runs K3-bf16's schedule on the
// same pieces with one cost term left out.
//
// A block computes kTile = 8192 consecutive outputs of one row,
//
//     acc[i] = sum_{k < ws} w[k] * xv[in0 + i + k],   0 <= i < kTile,
//
// on bf16 samples and taps with f32 sums, each output rounded to bf16. A
// block of 16 outputs at c is s[c, c + S) . B with B[q, p] = w[q - p] for
// 0 <= q - p < ws (else 0): the band of a 1 x ws stencil
// (ops/cuda_conv2d.py row_bands), S = 16 ceil((15 + ws) / 16) deep, KC = S /
// 16 chunks of 16. An m16n8k16 product takes 16 such blocks 16 samples
// apart as the rows of A, so a warp's 16 x 16 outputs cost 2 KC mma.sync
// (one a chunk and half of B's 16 columns; half 0 skips the chunks its
// outputs do not reach). ldmatrix takes one row address a lane, so the
// overlapping rows of A are read in place. Each thread builds its B
// fragments once from the taps, so B never goes through ldmatrix.
//
// Staging moves 8 samples at a time, 16 bytes of bf16 into shared memory:
// - f32 storage (one tile a block): 16-byte loads at the aligned addresses
//   around the 8 samples (sgmma::load8, any base and in0), shifted into
//   place in registers, rounded and packed to bf16, one 16-byte shared
//   store;
// - bf16 storage: each block walks over tiles with two staging
//   buffers, the next tile's 16-byte groups copied by cp.async while it
//   computes and stores this one. cp.async needs aligned source groups, so
//   a row's tiles start where its staged samples fall on 16-byte boundaries
//   (first_output) and the stores shift instead. In turns at the headline
//   this took K1-bf16 from 0.247 to 0.210 ms (probes/variants.py); the
//   register-staged form with the next tile in flight spilled and lost.
// Only a group of 8 that leaves [0, N) goes through map_index, one sample
// at a time. The 16 rows an ldmatrix matrix reads are 32 bytes apart, two
// on a bank group; keeping 8 unused samples after every 16 to spread them
// gained 3% on the register-staged path for bf16 storage and nothing for
// f32, and lost 12% beside cp.async (probes/variants.py): the staged row
// stays packed.
//
// The outputs go through shared memory as bf16 and leave as 16-byte stores
// at the addresses that hold whole 16-byte units of the row (two 16-byte
// shared loads shifted into place where the units do not meet the tile's),
// scalar ones at its ends (any base and N).
//
// A band's zeros meet every sample of its S columns, and 0 * inf and
// 0 * NaN are NaN: a non-finite sample would spread to whole 16-output
// blocks. So staging flags a tile whose staged samples are not all finite,
// and such a tile computes every output from its own window on the CUDA
// cores instead (window_tile), in the plain version's order: its NaN / inf
// pattern and, since every product is exact in f32, its values.
#pragma once

#include "bf16_mma.cuh"
#include "stencil_tile.cuh"

namespace sg1b {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 4;                        // 256-output blocks a warp
constexpr int kTile = 256 * kMT * kWarps;     // outputs a block

// KC: 16-sample chunks of the band for a window of ws taps.
__host__ __device__ constexpr int chunks(int ws) { return (ws + 30) / 16; }

template <int KC> struct Smem {
  static constexpr int kStaged = kTile + 16 * KC - 16;   // samples a tile
  __align__(16) bf16 xs[kStaged];
  __align__(16) bf16 ys[kTile + 8];     // the outputs, 8 more readable
  bf16 taps[16 * KC + 16];          // taps[16 + d] = w[d], zeros around
};

// Stages xv[in0, in0 + 8 units) of a row of N samples into xs as bf16,
// mapped by `mode` past [0, N) (zeros for kZero). Returns whether a sample
// this thread staged is an inf or a NaN.
template <typename In>
__device__ __forceinline__ bool stage(const In* __restrict__ xrow,
                                      long long N, long long in0, int units,
                                      int mode, bf16* __restrict__ xs) {
  bool bad = false;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const long long g = in0 + 8LL * u;
    uint4 v;
    if (g >= 0 && g + 8 <= N) {
      v = sgmma::load8(xrow + g);
    } else {
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long c = sgt::map_index<true>(g + j, N, mode);
        f[j] = c >= 0 ? sgt::Bf16::load(xrow[c]) : 0.0f;
      }
      v = make_uint4(sgmma::pack_bf16(f[0], f[1]),
                     sgmma::pack_bf16(f[2], f[3]),
                     sgmma::pack_bf16(f[4], f[5]),
                     sgmma::pack_bf16(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(xs + 8 * u) = v;
    bad = bad || sgmma::nonfinite8(v);
  }
  return bad;
}

// -- bf16 storage with the next tile in flight (cp.async) ----------------

// Shared memory of the cp.async instance: two staging buffers.
template <int KC> struct AsyncSmem {
  static constexpr int kStaged = Smem<KC>::kStaged;
  __align__(16) bf16 xs[2][kStaged];
  __align__(16) bf16 ys[kTile + 8];
  bf16 taps[16 * KC + 16];
};

// The first output of tile t of a row: t kTile - delta, delta in [0, 8)
// putting the tile's first staged sample, t0 - n, on a 16-byte boundary of
// the row's bf16 storage, as cp.async needs (n = 0 for the VALID
// correlation, whose tile stages from t0). A row has
// ceil((N + 7) / kTile) tiles (N its outputs).
__device__ __forceinline__ long long first_output(const bf16* xrow, int n,
                                                  long long t) {
  const int e = static_cast<int>((reinterpret_cast<uintptr_t>(xrow) >> 1) & 7);
  return t * kTile - (((e - n) % 8) + 8) % 8;
}

// Starts the copies of xv[in0, in0 + 8 units) into xs (in0 on a 16-byte
// boundary): cp.async for a group inside [0, N), a mapped group staged at
// once, one sample at a time.
__device__ __forceinline__ void start_copies(const bf16* __restrict__ xrow,
                                             long long N, long long in0,
                                             int units, int mode,
                                             bf16* __restrict__ xs) {
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const long long g = in0 + 8LL * u;
    bf16* dst = xs + 8 * u;
    if (g >= 0 && g + 8 <= N) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(sgmma::smem_addr(dst)), "l"(xrow + g));
      continue;
    }
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = sgt::map_index<true>(g + j, N, mode);
      f[j] = c >= 0 ? __bfloat162float(xrow[c]) : 0.0f;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        sgmma::pack_bf16(f[0], f[1]), sgmma::pack_bf16(f[2], f[3]),
        sgmma::pack_bf16(f[4], f[5]), sgmma::pack_bf16(f[6], f[7]));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The blocks of a kernel that walks over `total` tiles: as many as the
// card holds at once with `smem` bytes of dynamic shared memory (raised to
// that size first), at most one a tile.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int smem, long long total,
                                   long long* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  *blocks = min(total, static_cast<long long>(max(sms * per_sm, 1)));
  return err;
}

// Waits for this thread's copies of all but the latest tile started and
// returns whether a sample of its groups in xs is an inf or a NaN.
__device__ __forceinline__ bool landed(const bf16* __restrict__ xs,
                                       int units) {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  bool bad = false;
  for (int u = threadIdx.x; u < units; u += kThreads)
    bad = bad || sgmma::nonfinite8(
                     *reinterpret_cast<const uint4*>(xs + 8 * u));
  return bad;
}

// The taps as bf16 with 16 zeros before and zeros after, so that a band
// entry w[q - p] is taps[16 + q - p] with no test.
template <int KC>
__device__ __forceinline__ void stage_taps(const float* __restrict__ w,
                                           int ws, bf16* __restrict__ taps) {
  for (int i = threadIdx.x; i < 16 * KC + 16; i += kThreads) {
    const int d = i - 16;
    taps[i] = __float2bfloat16_rn(d >= 0 && d < ws ? w[d] : 0.0f);
  }
}

__device__ __forceinline__ unsigned pair(const bf16* p) {
  return static_cast<unsigned>(__bfloat16_as_ushort(p[0])) |
         static_cast<unsigned>(__bfloat16_as_ushort(p[1])) << 16;
}

// The tile's outputs from the band products, rounded to bf16 into ys.
template <int KC>
__device__ __forceinline__ void mma_tile(const bf16* __restrict__ xs,
                                         const bf16* __restrict__ taps,
                                         int ws, bf16* __restrict__ ys) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // B fragments of chunk kc and column half h: rows (q) 2t, 2t + 1 and
  // 2t + 8, 2t + 9, column (p) g
  unsigned bf[KC][2][2];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* p = taps + 16 + 16 * kc + 2 * t - 8 * h - g;
      bf[kc][h][0] = pair(p);
      bf[kc][h][1] = pair(p + 8);
    }
  // ldmatrix rows: lanes 0-15 rows 0-15 of k 0-7, lanes 16-31 of k 8-15;
  // row r is the block of outputs 16 r
  const int arow = 16 * (lane & 15) + 8 * (lane >> 4);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int o = 256 * (warp * kMT + mt);
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned a[4];
      sgmma::ldmatrix_x4(a, sgmma::smem_addr(xs + o + arow + 16 * kc));
      if (16 * kc - 7 < ws)   // outputs 0-7 of a block reach this chunk
        sgmma::mma_bf16(acc[0], a, bf[kc][0][0], bf[kc][0][1]);
      sgmma::mma_bf16(acc[1], a, bf[kc][1][0], bf[kc][1][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = o + 16 * g + 8 * h + 2 * t;
      *reinterpret_cast<unsigned*>(ys + i) =
          sgmma::pack_bf16(acc[h][0], acc[h][1]);
      *reinterpret_cast<unsigned*>(ys + i + 128) =
          sgmma::pack_bf16(acc[h][2], acc[h][3]);
    }
  }
}

// The tile's outputs on the CUDA cores, each from its own window in the
// plain version's order (a tile holding an inf or a NaN). Out of line, so
// that the tensor-core path's registers do not see it; static, so that each
// source that includes this header has its own copy.
static __device__ __noinline__ void window_tile(const bf16* __restrict__ xs,
                                         const float* __restrict__ w, int ws,
                                         bf16* __restrict__ ys) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < ws; ++k)
      acc = fmaf(__ldg(w + k), __bfloat162float(xs[i + k]), acc);
    ys[i] = __float2bfloat16_rn(acc);
  }
}

// K1's edge outputs of the tile at t0 (j < n or j >= N - n) into ys, from
// ew and the row's first or last window read from device memory, in the
// exact kernel's order.
template <typename In>
__device__ __forceinline__ void edge_rows(const In* __restrict__ xrow,
                                          const float* __restrict__ ew,
                                          long long N, int n, float lead_sign,
                                          long long t0, bf16* __restrict__ ys) {
  const int ws = 2 * n + 1;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long j = t0 + i;
    if (j >= N) break;
    if (j < 0 || (j >= n && j < N - n)) continue;
    const bool lead = j < n;
    const float* __restrict__ e = ew + (lead ? j : N - 1 - j) * ws;
    float a = 0.0f;
    if (lead) {
      for (int k = 0; k < ws; ++k)
        a = sgt::madd(e[k], sgt::Bf16::load(xrow[ws - 1 - k]), a);
      a = lead_sign * a;
    } else {
      const In* __restrict__ xt = xrow + (N - ws);
      for (int k = 0; k < ws; ++k)
        a = sgt::madd(e[k], sgt::Bf16::load(xt[k]), a);
    }
    ys[i] = __float2bfloat16_rn(a);
  }
}

__device__ __forceinline__ void put1(float* p, bf16 v) {
  *p = __bfloat162float(v);
}
__device__ __forceinline__ void put1(bf16* p, bf16 v) { *p = v; }

// ys[p, p + 8) from the two 16-byte words of ys around it, shifted into
// place (ys holds 8 readable values past its last output).
__device__ __forceinline__ uint4 gather8(const bf16* ys, int p) {
  const uint4* v = reinterpret_cast<const uint4*>(ys + (p & ~7));
  const int m = p & 7;
  const uint4 v0 = v[0];
  const uint4 v1 = m ? v[1] : v0;
  unsigned u[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  if (m & 4) {
#pragma unroll
    for (int i = 0; i < 6; ++i) u[i] = u[i + 2];
  }
  if (m & 2) {
#pragma unroll
    for (int i = 0; i < 7; ++i) u[i] = u[i + 1];
  }
  if (m & 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __funnelshift_r(u[i], u[i + 1], 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// 16 bytes of outputs from ys[p, p + 16 / sizeof(In)) at q, which is
// 16-byte aligned.
__device__ __forceinline__ void put16(float* q, const bf16* ys, int p) {
  const uint4 v = gather8(ys, p);
  *reinterpret_cast<float4*>(q) = make_float4(
      __uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
      __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void put16(bf16* q, const bf16* ys, int p) {
  *reinterpret_cast<uint4*>(q) = gather8(ys, p);
}

// Writes ys[off, off + kTile) to orow[t0, t0 + kTile), cut to [0, N):
// 16-byte stores at the 16-byte units of the row that lie whole inside,
// scalar stores at the ends. orow is aligned to its element, ys to 16
// bytes. The kernels store their outputs (off = 0); P3's shift_only
// (probe_bf16_1d.cu) stores staged samples n places on.
template <typename In>
__device__ __forceinline__ void store_tile(In* __restrict__ orow, long long N,
                                           long long t0,
                                           const bf16* __restrict__ ys,
                                           int off = 0) {
  constexpr int E = 16 / sizeof(In);         // outputs a 16-byte unit
  const long long lo = max(t0, 0LL), hi = min(t0 + kTile, N);
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(orow + lo) / sizeof(In)) % E);
  const long long a0 = min(lo + (mis ? E - mis : 0), hi);
  const long long units = (hi - a0) / E;
  const long long a1 = a0 + units * E;
  for (long long j = lo + threadIdx.x; j < a0; j += kThreads)
    put1(orow + j, ys[j - t0 + off]);
  for (long long j = a1 + threadIdx.x; j < hi; j += kThreads)
    put1(orow + j, ys[j - t0 + off]);
  const int p0 = static_cast<int>(a0 - t0) + off;
  for (int u = threadIdx.x; u < units; u += kThreads)
    put16(orow + a0 + static_cast<long long>(u) * E, ys, p0 + u * E);
}

}  // namespace sg1b
