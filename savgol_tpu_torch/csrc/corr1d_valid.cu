// K3: 1D VALID correlation, out[b, j] = sum_k w[k] * x[b, j + k] for
// 0 <= j < N - ws + 1.
//
// Replaces the TPU kernels savgol_tpu/ops/pallas_conv.py::_corr1d_mxu_kernel
// (banded-MXU, wide batches and row-folded thin batches via _fold_rows) and
// ::_corr1d_kernel (VPU tap loop, narrow batches). One function; the TPU
// split it by batch width because of its matrix unit. Thin batches need no
// row folding here: a row of 1M samples is already ~1024 blocks.
//
// Bound: device-memory bytes at 25 taps, as for K1 (sg1d_poly.cu): 4 B read
// and 4 B written per f32 sample for ws FMAs, a derived ceiling of ~419
// Gsamples/s from the H100 SXM data sheet's 3.35 TB/s (not a measurement);
// the FMAs at 67 TFLOP/s past about 60 taps. The exact instances run K1's
// tile (sg1d_exact.cuh) staged from in0 = t0 with zeros past N: a block
// walks over tiles of 3072 outputs with the next tiles' samples in flight
// (one bulk copy on an mbarrier an interior tile, 16-byte cp.async for a
// row's end tiles), the taps slide over a register window of 12 outputs
// a thread, and each warp stores its outputs, cut to [0, n_out), as whole
// 16-byte units through a shared slot of its own.
//
// method="bf16" (corr1d_valid_bf16, corr1d_bf16_kernel below) replaces
// _corr1d_mxu_call [:1098] on bf16 operands at single-pass precision
// (correlate_valid_pallas_mxu :1120, mxu_precision=DEFAULT) on the tensor
// cores: the bf16 1D tile of K1-bf16 (sg1d_bf16.cuh), staged from in0 = t0
// with zeros past N, every window of 1 to 129 taps, odd or even. Samples are
// rounded to bf16 while staging, the taps are bf16 values held in f32,
// every product is exact in f32, the sums are f32 and each output is
// rounded to bf16; storage f32 or bf16 (2 B in and 2 B out a sample for
// bf16 callers). Tiles of 8192 outputs; f32 storage one tile a block,
// bf16 storage each block walking over tiles with the next one's cp.async
// copies in flight. A window of one tap runs on a band of one chunk.
#include "sg1d_bf16.cuh"
#include "sg1d_exact.cuh"
#include "stencil_tile.cuh"

namespace {

// K3 on the exact tile (sg1d_exact.cuh), f32 or f64: WS a compile-time
// window, or 0 for any window of 1 to kMaxWs taps; K1's instances, 101
// and 0 (sg1d_poly.cu).
template <typename T, int WS>
__global__ void __launch_bounds__(sgx::kThreads, sgx::kBlocks<T>)
corr1d_valid_kernel(const sgx::Args<T> a) {
  sgx::run<T, WS>(a);
}

template <typename T>
int launch(const T* x, const T* w, T* out, long long B, long long N, int ws,
           void* stream) {
  if (ws < 1 || ws > sgt::kMaxWs || N < ws) return cudaErrorInvalidValue;
  const sgx::Args<T> a{x, w, nullptr, out, N, N - ws + 1, 0, 0, ws, 0, 0,
                       sgt::kZero, T(1)};
  const auto kernel =
      ws == 101 ? corr1d_valid_kernel<T, 101> : corr1d_valid_kernel<T, 0>;
  return sgx::launch(kernel, a, B, static_cast<cudaStream_t>(stream));
}

// method="bf16" on f32 storage: tile t0 = t kTile of a row, its outputs
// [t0, t0 + kTile) cut to [0, n_out). K1-bf16's register caps (5 blocks an
// SM; KC = 9 keeps 4, sg1d_poly.cu).
template <int KC>
__global__ void __launch_bounds__(sg1b::kThreads, KC < 9 ? 5 : 4)
corr1d_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, long long N, long long n_out,
                   long long tiles, int ws) {
  __shared__ sg1b::Smem<KC> s;
  const long long b = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * sg1b::kTile;
  const float* __restrict__ xrow = x + b * N;
  float* __restrict__ orow = out + b * n_out;

  sg1b::stage_taps<KC>(w, ws, s.taps);
  const bool bad = sg1b::stage(xrow, N, t0, sg1b::Smem<KC>::kStaged / 8,
                               sgt::kZero, s.xs);
  if (__syncthreads_or(bad))
    sg1b::window_tile(s.xs, w, ws, s.ys);
  else
    sg1b::mma_tile<KC>(s.xs, s.taps, ws, s.ys);
  __syncthreads();
  sg1b::store_tile(orow, n_out, t0, s.ys);
}

// method="bf16" on bf16 storage: a row's tiles start at
// first_output(xrow, 0, t), up to 7 outputs before t kTile, so that the
// staged start in0 = t0 lies on a 16-byte boundary of the row; the first
// tile of a row starts at t0 <= 0 and a row has ceil((n_out + 7) / kTile)
// tiles, the last of which may start past n_out (nothing to store).
template <int KC>
__global__ void __launch_bounds__(sg1b::kThreads, 3)
corr1d_bf16_async_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, long long N,
                         long long n_out, long long tiles, long long total,
                         int ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<sg1b::AsyncSmem<KC>*>(smem);
  constexpr int kUnits = sg1b::AsyncSmem<KC>::kStaged / 8;
  sg1b::stage_taps<KC>(w, ws, s.taps);
  long long id = blockIdx.x;
  if (id < total) {
    const __nv_bfloat16* xrow = x + id / tiles * N;
    sg1b::start_copies(xrow, N, sg1b::first_output(xrow, 0, id % tiles),
                       kUnits, sgt::kZero, s.xs[0]);
  }
  for (int buf = 0; id < total; id += gridDim.x, buf ^= 1) {
    const long long next = id + gridDim.x;
    if (next < total) {   // buffer buf ^ 1 was last read before the last sync
      const __nv_bfloat16* nrow = x + next / tiles * N;
      sg1b::start_copies(nrow, N, sg1b::first_output(nrow, 0, next % tiles),
                         kUnits, sgt::kZero, s.xs[buf ^ 1]);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const bool bad = sg1b::landed(s.xs[buf], kUnits);
    const long long b = id / tiles;
    const __nv_bfloat16* __restrict__ xrow = x + b * N;
    __nv_bfloat16* __restrict__ orow = out + b * n_out;
    const long long t0 = sg1b::first_output(xrow, 0, id % tiles);
    const bool any_bad = __syncthreads_or(bad);   // every copy landed
    if (t0 >= n_out) continue;   // a row's last tile, past its end (uniform)
    if (any_bad)
      sg1b::window_tile(s.xs[buf], w, ws, s.ys);
    else
      sg1b::mma_tile<KC>(s.xs[buf], s.taps, ws, s.ys);
    __syncthreads();
    sg1b::store_tile(orow, n_out, t0, s.ys);
  }
}

template <int KC>
cudaError_t run_bf16(const float* x, const float* w, float* out, long long B,
                     long long N, int ws, cudaStream_t stream) {
  const long long n_out = N - ws + 1;
  const long long tiles = (n_out + sg1b::kTile - 1) / sg1b::kTile;
  if (B * tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  corr1d_bf16_kernel<KC><<<dim3(static_cast<unsigned>(B * tiles)),
                           sg1b::kThreads, 0, stream>>>(x, w, out, N, n_out,
                                                        tiles, ws);
  return cudaGetLastError();
}

template <int KC>
cudaError_t run_bf16(const __nv_bfloat16* x, const float* w,
                     __nv_bfloat16* out, long long B, long long N, int ws,
                     cudaStream_t stream) {
  const auto kernel = corr1d_bf16_async_kernel<KC>;
  const int smem = static_cast<int>(sizeof(sg1b::AsyncSmem<KC>));
  const long long n_out = N - ws + 1;
  const long long tiles = (n_out + 7 + sg1b::kTile - 1) / sg1b::kTile;
  long long blocks = 0;
  const cudaError_t err =
      sg1b::resident_blocks(kernel, smem, B * tiles, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(blocks)), sg1b::kThreads, smem,
           stream>>>(x, w, out, N, n_out, tiles, B * tiles, ws);
  return cudaGetLastError();
}

// One instance for each band depth KC = chunks(ws), 1 to 9.
template <typename In>
int launch_bf16(const In* x, const float* w, In* out, long long B,
                long long N, int ws, void* stream) {
  if (ws < 1 || ws > sgt::kMaxWs || N < ws) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sg1b::chunks(ws)) {
#define CORR1D_BF16_CASE(KC) \
  case KC:                   \
    return run_bf16<KC>(x, w, out, B, N, ws, s);
    CORR1D_BF16_CASE(1)
    CORR1D_BF16_CASE(2)
    CORR1D_BF16_CASE(3)
    CORR1D_BF16_CASE(4)
    CORR1D_BF16_CASE(5)
    CORR1D_BF16_CASE(6)
    CORR1D_BF16_CASE(7)
    CORR1D_BF16_CASE(8)
    CORR1D_BF16_CASE(9)
#undef CORR1D_BF16_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int corr1d_valid_f32(const float* x, const float* w, float* out,
                                long long B, long long N, int ws,
                                void* stream) {
  return launch(x, w, out, B, N, ws, stream);
}

extern "C" int corr1d_valid_f64(const double* x, const double* w,
                                double* out, long long B, long long N, int ws,
                                void* stream) {
  return launch(x, w, out, B, N, ws, stream);
}

// method="bf16": x and out in f32 (bf16_storage = 0) or bf16 (1) storage,
// w bf16 values held in f32.
extern "C" int corr1d_valid_bf16(const void* x, const float* w, void* out,
                                 long long B, long long N, int ws,
                                 int bf16_storage, void* stream) {
  if (bf16_storage)
    return launch_bf16(static_cast<const __nv_bfloat16*>(x), w,
                       static_cast<__nv_bfloat16*>(out), B, N, ws, stream);
  return launch_bf16(static_cast<const float*>(x), w,
                     static_cast<float*>(out), B, N, ws, stream);
}
