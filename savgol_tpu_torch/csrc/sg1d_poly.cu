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
// map_index: symmetric, wrap, edge or reflect for K2; zero for K1, whose
// edge outputs are then fitted from ew). The caller folds dt_inv into w and
// ew. f32 accumulates in f32, f64 in f64.
//
// Bound: device-memory bytes at the headline's 25 taps. An f32 sample is
// read once (4 B) and written once (4 B) for 2n + 1 = 25 FMAs at n = 12, so
// the H100 SXM data sheet's 3.35 TB/s puts the ceiling at 3.35e12 / 8 =
// ~419 Gsamples/s; past about 60 taps the FMAs at 67 TFLOP/s bound it
// instead (0.405 ms at 101 taps and the headline's 128 x 2^20). Derived
// bounds, not measurements. The exact instances run the tile of
// sg1d_exact.cuh: each block walks over tiles of 3072 outputs (and a halo
// of about 2n samples) with the next tiles' samples in flight, an interior
// tile's by one bulk copy (cp.async.bulk on an mbarrier), a row's end
// tiles' by 16-byte cp.async; each thread slides a register window over 12
// consecutive outputs (one 16-byte shared load for 48 FMAs), and each warp
// stores its outputs as whole 16-byte units through a shared slot of its
// own. K2's virtual samples are mapped while a row's end tiles stage their
// span, so the TPU kernel's strips and the host pad copy before K3 both
// go: K2 moves the same bytes as K1. Its reflect (numpy's, the edge sample
// not repeated) is scipy_compat's mode="mirror", which no TPU kernel maps.
//
// K1's edge outputs (2n per row) read their windows straight from device
// memory: the trailing window can start up to 2n samples before its output's
// tile and the leading window sits at x[0, ws) whatever the tile, so neither
// is reliably inside the staged span.
//
// method="bf16" (sg1d_poly_bf16, sg1d_pad_bf16, sg1d_bf16_kernel below)
// replaces the TPU kernels above on bf16 operands at single-pass MXU
// precision (savgol_polynomial_pallas_mxu :689 and savgol_padded_pallas_mxu
// :872 with mxu_precision=DEFAULT), as they run: the products on the tensor
// cores, mma.sync on the band of the taps (sg1d_bf16.cuh). Each sample is
// rounded to bf16 as it is staged, the taps are bf16(bf16(w) * bf16(dt))
// (rounded on the host), every product is exact in f32, the sums are f32
// and each output is rounded to bf16; the kernel and its plain version
// differ only in the order of the f32 sums. With the casts fused, an f32
// caller moves 8 B a sample and a bf16 caller 4 B: at the 1D headline the
// bytes bound a bf16 caller at 0.160 ms (0.321 f32), over the 0.100 ms its
// 25 FMAs a sample would take on the CUDA cores at the f32 peak and the
// 0.03 ms of the band products at the tensor cores' (derived). Samples are
// staged by 16-byte loads.
#include "sg1d_bf16.cuh"
#include "sg1d_exact.cuh"
#include "stencil_tile.cuh"

namespace {

// K1 and K2 on the exact tile (sg1d_exact.cuh), f32 or f64: WS a
// compile-time window, or 0 for any window. mode: sgt::kZero for K1 (its 2n
// edge outputs a row fitted from ew), a pad mode for K2 (ew unused).
// An unrolled instance at scipy's 101 taps, where on an H100 the
// runtime-width loop took 5-11% longer (probes/variants.py exact:
// runtime_width); the loop takes every other window, the headline's 25
// included (an unrolled 25 was within 3% of it either way: unrolled_25).
template <typename T, int WS>
__global__ void __launch_bounds__(sgx::kThreads, sgx::kBlocks<T>)
sg1d_poly_kernel(const sgx::Args<T> a) {
  sgx::run<T, WS>(a);
}

template <typename T>
int launch(const T* x, const T* w, const T* ew, T* out, long long B,
           long long N, int n, T lead_sign, int mode, void* stream) {
  const int ws = 2 * n + 1;
  if (n < 1 || ws > sgt::kMaxWs || N < ws || mode < sgt::kZero ||
      mode > sgt::kReflect)
    return cudaErrorInvalidValue;
  const sgx::Args<T> a{x, w, ew, out, N, N, 0, 0, ws, -n,
                       mode == sgt::kZero ? n : 0, mode, lead_sign};
  const auto kernel =
      ws == 101 ? sg1d_poly_kernel<T, 101> : sg1d_poly_kernel<T, 0>;
  return sgx::launch(kernel, a, B, static_cast<cudaStream_t>(stream));
}

// method="bf16" on f32 storage (sg1d_bf16.cuh): a tile of sg1b::kTile
// outputs a block on the tensor cores, KC band chunks deep. A tile with a
// K1 edge output writes it from ew after the band products, as the exact
// kernel does. Registers capped for 5 blocks an SM (48): at the headline a
// cap for 4 (64) measured 1-4% slower (8-9% in bf16 storage, which ran this
// kernel before the cp.async one below), one for 6 spilled and gained
// nothing (probes/variants.py). KC = 9 keeps 4: its 36 registers of B
// fragments spilled 8 B under 48.
template <typename In, int KC>
__global__ void __launch_bounds__(sg1b::kThreads, KC < 9 ? 5 : 4)
sg1d_bf16_kernel(const In* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ ew, In* __restrict__ out,
                 long long N, long long tiles, int n, float lead_sign,
                 int mode) {
  __shared__ sg1b::Smem<KC> s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * sg1b::kTile;
  const int ws = 2 * n + 1;
  const In* __restrict__ xrow = x + b * N;
  In* __restrict__ orow = out + b * N;

  sg1b::stage_taps<KC>(w, ws, s.taps);
  const bool bad = sg1b::stage(xrow, N, t0 - n, sg1b::Smem<KC>::kStaged / 8,
                               mode, s.xs);
  if (__syncthreads_or(bad))
    sg1b::window_tile(s.xs, w, ws, s.ys);
  else
    sg1b::mma_tile<KC>(s.xs, s.taps, ws, s.ys);
  if (mode == sgt::kZero && !(t0 >= n && t0 + sg1b::kTile <= N - n)) {
    __syncthreads();   // the edge rows replace the band's outputs
    sg1b::edge_rows(xrow, ew, N, n, lead_sign, t0, s.ys);
  }
  __syncthreads();
  sg1b::store_tile(orow, N, t0, s.ys);
}

template <typename In, int KC>
cudaError_t run_bf16(const In* x, const float* w, const float* ew, In* out,
                     long long blocks, long long N, long long tiles, int n,
                     float lead_sign, int mode, cudaStream_t stream) {
  sg1d_bf16_kernel<In, KC><<<dim3(static_cast<unsigned>(blocks)),
                             sg1b::kThreads, 0, stream>>>(
      x, w, ew, out, N, tiles, n, lead_sign, mode);
  return cudaGetLastError();
}

// method="bf16" on bf16 storage: the same tiles, each block walking over
// them with the next tile's copies in flight (cp.async into the second
// staging buffer) while it computes and stores this one.
template <int KC>
__global__ void __launch_bounds__(sg1b::kThreads, 3)
sg1d_bf16_async_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ ew,
                       __nv_bfloat16* __restrict__ out, long long N,
                       long long tiles, long long total, int n,
                       float lead_sign, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<sg1b::AsyncSmem<KC>*>(smem);
  constexpr int kUnits = sg1b::AsyncSmem<KC>::kStaged / 8;
  const int ws = 2 * n + 1;
  sg1b::stage_taps<KC>(w, ws, s.taps);
  long long id = blockIdx.x;
  if (id < total) {
    const __nv_bfloat16* xrow = x + id / tiles * N;
    sg1b::start_copies(xrow, N,
                       sg1b::first_output(xrow, n, id % tiles) - n, kUnits,
                       mode, s.xs[0]);
  }
  for (int buf = 0; id < total; id += gridDim.x, buf ^= 1) {
    const long long next = id + gridDim.x;
    if (next < total) {   // buffer buf ^ 1 was last read before the last sync
      const __nv_bfloat16* nrow = x + next / tiles * N;
      sg1b::start_copies(nrow, N,
                         sg1b::first_output(nrow, n, next % tiles) - n,
                         kUnits, mode, s.xs[buf ^ 1]);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const bool bad = sg1b::landed(s.xs[buf], kUnits);
    const long long b = id / tiles;
    const __nv_bfloat16* __restrict__ xrow = x + b * N;
    __nv_bfloat16* __restrict__ orow = out + b * N;
    const long long t0 = sg1b::first_output(xrow, n, id % tiles);
    const bool any_bad = __syncthreads_or(bad);   // every copy landed
    if (t0 >= N) continue;   // a row's last tile, past its end (uniform)
    if (any_bad)
      sg1b::window_tile(s.xs[buf], w, ws, s.ys);
    else
      sg1b::mma_tile<KC>(s.xs[buf], s.taps, ws, s.ys);
    if (mode == sgt::kZero && !(t0 >= n && t0 + sg1b::kTile <= N - n)) {
      __syncthreads();   // the edge rows replace the band's outputs
      sg1b::edge_rows(xrow, ew, N, n, lead_sign, t0, s.ys);
    }
    __syncthreads();
    sg1b::store_tile(orow, N, t0, s.ys);
  }
}

template <int KC>
cudaError_t run_bf16_async(const __nv_bfloat16* x, const float* w,
                           const float* ew, __nv_bfloat16* out, long long B,
                           long long N, int n, float lead_sign, int mode,
                           cudaStream_t stream) {
  const auto kernel = sg1d_bf16_async_kernel<KC>;
  const int smem = static_cast<int>(sizeof(sg1b::AsyncSmem<KC>));
  const long long tiles = (N + 7 + sg1b::kTile - 1) / sg1b::kTile;
  const long long total = B * tiles;
  long long blocks = 0;
  const cudaError_t err = sg1b::resident_blocks(kernel, smem, total, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(blocks)), sg1b::kThreads, smem,
           stream>>>(x, w, ew, out, N, tiles, total, n, lead_sign, mode);
  return cudaGetLastError();
}

// method="bf16": In is float (f32 storage) or __nv_bfloat16; taps are bf16
// values held in f32. One instance for each band depth.
template <typename In>
int launch_bf16(const In* x, const float* w, const float* ew, In* out,
                long long B, long long N, int n, float lead_sign, int mode,
                void* stream) {
  const int ws = 2 * n + 1;
  if (n < 1 || ws > sgt::kMaxWs || N < ws || mode < sgt::kZero ||
      mode > sgt::kReflect)
    return cudaErrorInvalidValue;
  const long long tiles = (N + sg1b::kTile - 1) / sg1b::kTile;
  const long long blocks = B * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sg1b::chunks(ws)) {
#define SG1D_BF16_CASE(KC)                                                \
  case KC:                                                                \
    if constexpr (sizeof(In) == 2)                                        \
      return run_bf16_async<KC>(x, w, ew, out, B, N, n, lead_sign, mode,   \
                                s);                                       \
    else                                                                  \
      return run_bf16<In, KC>(x, w, ew, out, blocks, N, tiles, n,          \
                              lead_sign, mode, s);
    SG1D_BF16_CASE(2)
    SG1D_BF16_CASE(3)
    SG1D_BF16_CASE(4)
    SG1D_BF16_CASE(5)
    SG1D_BF16_CASE(6)
    SG1D_BF16_CASE(7)
    SG1D_BF16_CASE(8)
    SG1D_BF16_CASE(9)
#undef SG1D_BF16_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int launch_bf16(const void* x, const float* w, const float* ew, void* out,
                long long B, long long N, int n, float lead_sign, int mode,
                int bf16_storage, void* stream) {
  if (bf16_storage)
    return launch_bf16(static_cast<const __nv_bfloat16*>(x), w, ew,
                       static_cast<__nv_bfloat16*>(out), B, N, n, lead_sign,
                       mode, stream);
  return launch_bf16(static_cast<const float*>(x), w, ew,
                     static_cast<float*>(out), B, N, n, lead_sign, mode,
                     stream);
}

}  // namespace

extern "C" int sg1d_poly_f32(const float* x, const float* w, const float* ew,
                             float* out, long long B, long long N, int n,
                             float lead_sign, void* stream) {
  return launch(x, w, ew, out, B, N, n, lead_sign, sgt::kZero, stream);
}

extern "C" int sg1d_poly_f64(const double* x, const double* w,
                             const double* ew, double* out, long long B,
                             long long N, int n, double lead_sign,
                             void* stream) {
  return launch(x, w, ew, out, B, N, n, lead_sign, sgt::kZero, stream);
}

// K2: mode is sgt::kEdge, kSymmetric, kWrap or kReflect.
extern "C" int sg1d_pad_f32(const float* x, const float* w, float* out,
                            long long B, long long N, int n, int mode,
                            void* stream) {
  if (mode == sgt::kZero) return cudaErrorInvalidValue;
  return launch(x, w, static_cast<const float*>(nullptr), out, B, N, n, 1.0f,
                mode, stream);
}

extern "C" int sg1d_pad_f64(const double* x, const double* w, double* out,
                            long long B, long long N, int n, int mode,
                            void* stream) {
  if (mode == sgt::kZero) return cudaErrorInvalidValue;
  return launch(x, w, static_cast<const double*>(nullptr), out, B, N, n, 1.0,
                mode, stream);
}

// method="bf16" of K1 and K2 (the JAX package's _sg1d_poly_mxu_call and
// _sg1d_pad_mxu_call on bf16 operands at single-pass precision): x in f32
// (bf16_storage = 0) or bf16 (1) storage, out in the same; w and ew bf16
// values held in f32, dt_inv folded in by the caller.
extern "C" int sg1d_poly_bf16(const void* x, const float* w, const float* ew,
                              void* out, long long B, long long N, int n,
                              float lead_sign, int bf16_storage,
                              void* stream) {
  return launch_bf16(x, w, ew, out, B, N, n, lead_sign, sgt::kZero,
                     bf16_storage, stream);
}

extern "C" int sg1d_pad_bf16(const void* x, const float* w, void* out,
                             long long B, long long N, int n, int mode,
                             int bf16_storage, void* stream) {
  if (mode == sgt::kZero) return cudaErrorInvalidValue;
  return launch_bf16(x, w, nullptr, out, B, N, n, 1.0f, mode, bf16_storage,
                     stream);
}
