// K8: the per-position k x k SPD solve from Gram entry planes.
//
//   K8a  plane_solve_{f32,f64}: gram (Kp, pos), rhs (k, pos), quorum (pos)
//        -> coef (k, pos), ok (pos); pair_index (k x k, int32) maps (i, j)
//        to one of the Kp planes (k(k+1)/2 for a full Gram, 2k-1 for the
//        Hankel of the nonuniform path's moments). The dual factorization,
//        rcond rule and compensated refinement of lsq.py (plane_chol.cuh).
//   K8b  plane_solve_dd_{f32,f64}: the same from (hi, lo) gram and rhs plane
//        pairs in double-word arithmetic on FP64 pairs; coef = hi + lo in
//        the working precision.
//
// Replaces the TPU kernels savgol_tpu/ops/pallas_solve.py::_plane_solve_call
// (body _solve_kernel) and ::_plane_solve_call_dd (body _solve_kernel_dd).
// On the TPU they exist so that the unrolled factorization runs in VMEM
// instead of spilling every temporary plane to HBM; here one thread owns one
// position and keeps its whole system in its workspace (registers and local
// memory, or interleaved device scratch past k = 32).
//
// Bound: arithmetic and the workspace. A position reads Kp + k + 1 values
// and writes k + 1 (~90 B at k = 5 in f32) against ~k^3/3 multiply-adds
// twice over (factor, two substitutions, refinement), and at k = 10 the
// workspace (~150 values) lives in local memory, served by L1. Any position
// count launches: the grid strides over positions.
#include "plane_chol.cuh"

namespace {

using namespace sgtsolve;
constexpr int kBlock = 128;

template <typename T, int KMAX>
__global__ void __launch_bounds__(kBlock)
plane_solve_kernel(const T* __restrict__ gram, const T* __restrict__ rhs,
                   const unsigned char* __restrict__ quorum,
                   const int* __restrict__ pi, T* __restrict__ coef,
                   unsigned char* __restrict__ ok_out, int k, long long pos,
                   int use_rcond, T sqrt_rcond, T* scratch) {
  T local[KMAX > 0 ? work_size(KMAX) : 1];
  const Work<T> w = carve(thread_span(local, KMAX > 0 ? nullptr : scratch), k);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < pos; p += stride) {
    for (int i = 0; i < k; ++i) {
      for (int j = 0; j <= i; ++j)
        w.G[tri(i, j)] = gram[pi[i * k + j] * pos + p];
      w.r[i] = rhs[i * pos + p];
    }
    const bool ok = chol_solve(k, quorum[p] != 0, use_rcond != 0, sqrt_rcond,
                               w);
    for (int i = 0; i < k; ++i) coef[i * pos + p] = w.c[i];
    ok_out[p] = ok;
  }
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(kBlock)
plane_solve_dd_kernel(const T* __restrict__ ghi, const T* __restrict__ glo,
                      const T* __restrict__ rhi, const T* __restrict__ rlo,
                      const unsigned char* __restrict__ quorum,
                      const int* __restrict__ pi, T* __restrict__ coef,
                      unsigned char* __restrict__ ok_out, int k,
                      long long pos, int use_rcond, double sqrt_rcond,
                      double* scratch) {
  double local[KMAX > 0 ? dd_work_size(KMAX) : 1];
  const DdWork w =
      dd_carve(thread_span(local, KMAX > 0 ? nullptr : scratch), k);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < pos; p += stride) {
    for (int i = 0; i < k; ++i) {
      for (int j = 0; j <= i; ++j) {
        const long long src = pi[i * k + j] * pos + p;
        w.gh[tri(i, j)] = ghi[src];
        w.gl[tri(i, j)] = glo[src];
      }
      w.rh[i] = rhi[i * pos + p];
      w.rl[i] = rlo[i * pos + p];
    }
    const bool ok = dd_chol_solve(k, quorum[p] != 0, use_rcond != 0,
                                  sqrt_rcond, w);
    for (int i = 0; i < k; ++i) coef[i * pos + p] = static_cast<T>(w.ch[i] + w.cl[i]);
    ok_out[p] = ok;
  }
}

// Blocks for pos positions: one position a thread, or the scratch's thread
// count when the workspace lives in device scratch.
inline int blocks_for(long long pos, long long scratch_threads) {
  long long threads = scratch_threads > 0 ? scratch_threads : pos;
  long long b = (threads + kBlock - 1) / kBlock;
  if (b > 0x7fffffffLL) b = 0x7fffffffLL;
  return static_cast<int>(b < 1 ? 1 : b);
}

template <typename T>
int launch(const T* gram, const T* rhs, const unsigned char* quorum,
           const int* pi, T* coef, unsigned char* ok, int k, long long pos,
           int use_rcond, double sqrt_rcond, T* scratch,
           long long scratch_threads, void* stream) {
  if (k < 1 || pos < 1) return cudaErrorInvalidValue;
  const bool local = k <= kLocalKmax;
  if (!local && (scratch == nullptr || scratch_threads < 1 ||
                 scratch_threads % kBlock != 0))
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(pos, local ? 0 : scratch_threads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T sr = static_cast<T>(sqrt_rcond);
  if (k <= 8)
    plane_solve_kernel<T, 8><<<grid, kBlock, 0, s>>>(
        gram, rhs, quorum, pi, coef, ok, k, pos, use_rcond, sr, nullptr);
  else if (k <= 16)
    plane_solve_kernel<T, 16><<<grid, kBlock, 0, s>>>(
        gram, rhs, quorum, pi, coef, ok, k, pos, use_rcond, sr, nullptr);
  else if (local)
    plane_solve_kernel<T, kLocalKmax><<<grid, kBlock, 0, s>>>(
        gram, rhs, quorum, pi, coef, ok, k, pos, use_rcond, sr, nullptr);
  else
    plane_solve_kernel<T, 0><<<grid, kBlock, 0, s>>>(
        gram, rhs, quorum, pi, coef, ok, k, pos, use_rcond, sr, scratch);
  return cudaGetLastError();
}

template <typename T>
int launch_dd(const T* ghi, const T* glo, const T* rhi, const T* rlo,
              const unsigned char* quorum, const int* pi, T* coef,
              unsigned char* ok, int k, long long pos, int use_rcond,
              double sqrt_rcond, double* scratch, long long scratch_threads,
              void* stream) {
  if (k < 1 || pos < 1) return cudaErrorInvalidValue;
  const bool local = k <= kLocalKmax;
  if (!local && (scratch == nullptr || scratch_threads < 1 ||
                 scratch_threads % kBlock != 0))
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(pos, local ? 0 : scratch_threads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8)
    plane_solve_dd_kernel<T, 8><<<grid, kBlock, 0, s>>>(
        ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos, use_rcond,
        sqrt_rcond, nullptr);
  else if (k <= 16)
    plane_solve_dd_kernel<T, 16><<<grid, kBlock, 0, s>>>(
        ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos, use_rcond,
        sqrt_rcond, nullptr);
  else if (local)
    plane_solve_dd_kernel<T, kLocalKmax><<<grid, kBlock, 0, s>>>(
        ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos, use_rcond,
        sqrt_rcond, nullptr);
  else
    plane_solve_dd_kernel<T, 0><<<grid, kBlock, 0, s>>>(
        ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos, use_rcond,
        sqrt_rcond, scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" int plane_solve_f32(const float* gram, const float* rhs,
                               const unsigned char* quorum, const int* pi,
                               float* coef, unsigned char* ok, int k,
                               long long pos, int use_rcond,
                               double sqrt_rcond, float* scratch,
                               long long scratch_threads, void* stream) {
  return launch<float>(gram, rhs, quorum, pi, coef, ok, k, pos, use_rcond,
                       sqrt_rcond, scratch, scratch_threads, stream);
}

extern "C" int plane_solve_f64(const double* gram, const double* rhs,
                               const unsigned char* quorum, const int* pi,
                               double* coef, unsigned char* ok, int k,
                               long long pos, int use_rcond,
                               double sqrt_rcond, double* scratch,
                               long long scratch_threads, void* stream) {
  return launch<double>(gram, rhs, quorum, pi, coef, ok, k, pos, use_rcond,
                        sqrt_rcond, scratch, scratch_threads, stream);
}

extern "C" int plane_solve_dd_f32(const float* ghi, const float* glo,
                                  const float* rhi, const float* rlo,
                                  const unsigned char* quorum, const int* pi,
                                  float* coef, unsigned char* ok, int k,
                                  long long pos, int use_rcond,
                                  double sqrt_rcond, double* scratch,
                                  long long scratch_threads, void* stream) {
  return launch_dd<float>(ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos,
                          use_rcond, sqrt_rcond, scratch, scratch_threads,
                          stream);
}

extern "C" int plane_solve_dd_f64(const double* ghi, const double* glo,
                                  const double* rhi, const double* rlo,
                                  const unsigned char* quorum, const int* pi,
                                  double* coef, unsigned char* ok, int k,
                                  long long pos, int use_rcond,
                                  double sqrt_rcond, double* scratch,
                                  long long scratch_threads, void* stream) {
  return launch_dd<double>(ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos,
                           use_rcond, sqrt_rcond, scratch, scratch_threads,
                           stream);
}
