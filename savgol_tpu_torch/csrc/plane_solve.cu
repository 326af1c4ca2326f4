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
// position and keeps its whole system on chip.
//
// Bound: device-memory bytes. A position reads Kp + k + 1 values and writes
// k + 1 (302 B at k = 10 in f32, the masked 2D route's order-3 planes)
// against ~2.5 k operations of the solve, so at 1024^2 positions the bytes
// take 0.0945 ms and the operations less (derived, not measured), provided
// the solve's workspace stays out of device and local memory.
//
// K8a comes in two forms, chosen from k before any launch:
//
//   plane_solve_fixed<T, K>, for K = 10 and 15, the sizes of the staged
//     masked 2D route at orders 3 and 4 (K = (m + 1)(m + 2) / 2):
//     chol_solve<K>, so its loops unroll, every tri(i, j) is a constant,
//     and no workspace lives in local memory. G lives in shared memory laid
//     out by thread (Strided: a warp's lanes touch consecutive words, no
//     bank conflicts); L and the vectors live in registers, but for f64
//     at K = 15, whose L joins G in shared memory. Each instance's block is as large
//     as 64 KB of workspace allows (FixedK8::threads), so that several
//     blocks share an SM. The block stages the pair table's packed lower
//     triangle once and walks its positions with a stride of the grid
//     (persistent blocks). The arithmetic is the runtime form's, rounded
//     as lsq.py rounds (plane_chol.cuh), so it is bit-equal to lsq.py's.
//     K = 21 and 28 stay on the runtime form: with G, L and the vectors in
//     shared memory (the register file cannot hold them), a block of 32
//     threads measured 3.4 and 8.4 times slower than it on an H100
//     (probes/masked_ab.py; PERF.md).
//   plane_solve_kernel<T, KMAX>, the runtime form for every other k: the
//     workspace a local array of KMAX elements' worth or, past k = 32, a
//     slice of device scratch; its loops do not unroll.
//
// K8b likewise:
//
//   plane_solve_dd_fixed<T, K>, for K = 1..8 (the qr route's k = m + 1 and
//     the direct resample route's Hankel at m <= 7): dd_chol_solve<K>, the
//     (hi, lo) Gram entries read straight into L's slots (L overwrites G
//     in place), in registers (for f64 pairs at K = 8 in shared memory by
//     thread), the vectors in registers; the pair table's packed
//     lower triangle staged once a block; persistent blocks. No local
//     array: the runtime form's 1.7 KB a thread (k <= 8) took 0.51 of its
//     0.62 ms at k = 5 in its solve alone (probes/variants.py, PERF.md).
//   plane_solve_dd_kernel<T, KMAX>, the runtime form past k = 8, or at any
//     k when the caller forces it (force_runtime, for the check that the
//     two forms give the same bits).
#include <type_traits>

#include "launch.cuh"
#include "plane_chol.cuh"

namespace {

using namespace sgtsolve;
using sgtlaunch::kSmemMax;
constexpr int kBlock = 128;

template <typename T>
struct SolveArgs {
  const T* gram;
  const T* rhs;
  const unsigned char* quorum;
  const int* pi;
  T* coef;
  unsigned char* ok;
  long long pos;
  int use_rcond;
  T sqrt_rcond;
};

// The layout of K8a's compile-time instance at K: whether L joins G in
// shared memory (f64 at K = 15, whose L in registers spills; f32 at K = 15
// holds it in registers without a spill and measured a third faster than
// in shared memory, probes/variants.py), the words of it a thread takes,
// and the block.
template <typename T, int K>
struct FixedK8 {
  static constexpr bool shared_l = K > 10 && sizeof(T) == 8;
  static constexpr int words = packed(K) * (shared_l ? 2 : 1);
  static constexpr int threads =
      words * sizeof(T) * 128 <= 65536 ? 128
      : words * sizeof(T) * 64 <= 65536 ? 64 : 32;
  static constexpr size_t smem =
      sizeof(T) * words * threads + sizeof(int) * packed(K);
  static_assert(smem <= kSmemMax, "a block of the instance must fit");
};

template <typename T, int K>
__global__ void __launch_bounds__(FixedK8<T, K>::threads)
plane_solve_fixed(const SolveArgs<T> a) {
  using F = FixedK8<T, K>;
  constexpr int NT = F::threads, kp = packed(K);
  using Slots = Strided<T, NT>;
  using Workspace = FixedWork<T, K, Slots, std::conditional_t<
                                              F::shared_l, Slots, Regs<T, kp>>>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);       // words x NT, by thread
  int* plane_of = reinterpret_cast<int*>(slots + F::words * NT);
  for (int e = threadIdx.x; e < kp; e += NT) {  // packed (i, j) -> plane
    int i = 0;
    while (tri(i + 1, 0) <= e) ++i;
    plane_of[e] = a.pi[i * K + (e - tri(i, 0))];
  }
  __syncthreads();

  Workspace wk;
  T* mine = slots + threadIdx.x;
  wk.G.p = mine;
  if constexpr (F::shared_l) wk.L.p = mine + kp * NT;
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  for (long long p = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
       p < a.pos; p += stride) {
#pragma unroll
    for (int e = 0; e < kp; ++e) wk.G[e] = a.gram[plane_of[e] * a.pos + p];
#pragma unroll
    for (int i = 0; i < K; ++i) wk.r[i] = a.rhs[i * a.pos + p];
    const bool ok = chol_solve<K>(K, a.quorum[p] != 0, a.use_rcond != 0,
                                  a.sqrt_rcond, wk);
#pragma unroll
    for (int i = 0; i < K; ++i) a.coef[i * a.pos + p] = wk.c[i];
    a.ok[p] = ok;
  }
}

template <typename T, int K>
cudaError_t run_fixed(const SolveArgs<T>& a, cudaStream_t s) {
  using F = FixedK8<T, K>;
  const long long blocks = (a.pos + F::threads - 1) / F::threads;
  return sgtlaunch::launch(plane_solve_fixed<T, K>, blocks, F::threads,
                           F::smem, true, s, a);
}

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
    const bool ok = chol_solve<0>(k, quorum[p] != 0, use_rcond != 0, sqrt_rcond,
                               w);
    for (int i = 0; i < k; ++i) coef[i * pos + p] = w.c[i];
    ok_out[p] = ok;
  }
}

template <typename T>
struct DdSolveArgs {
  const T* ghi;
  const T* glo;
  const T* rhi;
  const T* rlo;
  const unsigned char* quorum;
  const int* pi;
  T* coef;
  unsigned char* ok;
  long long pos;
  int use_rcond;
  double sqrt_rcond;
};

// The largest K8b instance.
constexpr int kDdFixedKmax = 8;

// The layout of K8b's compile-time instance at K: L in registers, but for
// f64 pairs at K = 8 in shared memory by thread (in registers it spilled 76
// B at 255 registers, where f32 pairs take 246 and none; L in shared
// memory measured 1.27x (K = 5) and 1.66x (f32, K = 8) the registers' time,
// probes/variants.py), the doubles of it a thread keeps there, and the
// block (128 threads, or 64 where a block's L would pass 64 KB).
template <typename T, int K>
struct FixedK8b {
  static constexpr bool shared_l = sizeof(T) == 8 && K > 7;
  static constexpr int words = shared_l ? 2 * packed(K) : 0;
  static constexpr int threads = words * 8 * 128 <= 65536 ? 128 : 64;
  static constexpr size_t smem =
      sizeof(double) * words * threads + sizeof(int) * packed(K);
  static_assert(smem <= kSmemMax, "a block of the instance must fit");
};

template <typename T, int K>
__global__ void __launch_bounds__(FixedK8b<T, K>::threads)
plane_solve_dd_fixed(const DdSolveArgs<T> a) {
  using F = FixedK8b<T, K>;
  constexpr int NT = F::threads, kp = packed(K);
  using LS = std::conditional_t<F::shared_l, Strided<double, NT>,
                                Regs<double, kp>>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* slots = reinterpret_cast<double*>(smem);   // words x NT, by thread
  int* plane_of = reinterpret_cast<int*>(slots + F::words * NT);
  for (int e = threadIdx.x; e < kp; e += NT) {        // packed (i, j) -> plane
    int i = 0;
    while (tri(i + 1, 0) <= e) ++i;
    plane_of[e] = a.pi[i * K + (e - tri(i, 0))];
  }
  __syncthreads();

  DdFixedWork<K, LS, false> wk;
  if constexpr (F::shared_l) {
    wk.lh.p = slots + threadIdx.x;
    wk.ll.p = slots + kp * NT + threadIdx.x;
  }
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  for (long long p = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
       p < a.pos; p += stride) {
#pragma unroll
    for (int e = 0; e < kp; ++e) {
      const long long src = plane_of[e] * a.pos + p;
      wk.lh[e] = a.ghi[src];
      wk.ll[e] = a.glo[src];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      wk.vh[i] = a.rhi[i * a.pos + p];
      wk.vl[i] = a.rlo[i * a.pos + p];
    }
    const bool ok = dd_chol_solve<K>(K, a.quorum[p] != 0, a.use_rcond != 0,
                                     a.sqrt_rcond, wk);
#pragma unroll
    for (int i = 0; i < K; ++i)
      a.coef[i * a.pos + p] = static_cast<T>(wk.vh[i] + wk.vl[i]);
    a.ok[p] = ok;
  }
}

template <typename T, int K>
cudaError_t run_dd_fixed(const DdSolveArgs<T>& a, cudaStream_t s) {
  using F = FixedK8b<T, K>;
  const long long blocks = (a.pos + F::threads - 1) / F::threads;
  return sgtlaunch::launch(plane_solve_dd_fixed<T, K>, blocks, F::threads,
                           F::smem, true, s, a);
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
    const bool ok = dd_chol_solve<0>(k, quorum[p] != 0, use_rcond != 0,
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T sr = static_cast<T>(sqrt_rcond);
  // the instance is chosen from k before any launch
  const SolveArgs<T> a{gram, rhs, quorum, pi, coef, ok, pos, use_rcond, sr};
  if (k == 10) return run_fixed<T, 10>(a, s);
  if (k == 15) return run_fixed<T, 15>(a, s);
  const bool local = k <= kLocalKmax;
  if (!local && (scratch == nullptr || scratch_threads < 1 ||
                 scratch_threads % kBlock != 0))
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(pos, local ? 0 : scratch_threads));
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
              int force_runtime, void* stream) {
  if (k < 1 || pos < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance is chosen from k (and force_runtime) before any launch
  const DdSolveArgs<T> a{ghi, glo, rhi, rlo, quorum, pi, coef, ok, pos,
                         use_rcond, sqrt_rcond};
  switch (force_runtime || k > kDdFixedKmax ? 0 : k) {
    case 1: return run_dd_fixed<T, 1>(a, s);
    case 2: return run_dd_fixed<T, 2>(a, s);
    case 3: return run_dd_fixed<T, 3>(a, s);
    case 4: return run_dd_fixed<T, 4>(a, s);
    case 5: return run_dd_fixed<T, 5>(a, s);
    case 6: return run_dd_fixed<T, 6>(a, s);
    case 7: return run_dd_fixed<T, 7>(a, s);
    case 8: return run_dd_fixed<T, 8>(a, s);
    default: break;
  }
  const bool local = k <= kLocalKmax;
  if (!local && (scratch == nullptr || scratch_threads < 1 ||
                 scratch_threads % kBlock != 0))
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(pos, local ? 0 : scratch_threads));
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
                                  long long scratch_threads,
                                  int force_runtime, void* stream) {
  return launch_dd<float>(ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos,
                          use_rcond, sqrt_rcond, scratch, scratch_threads,
                          force_runtime, stream);
}

extern "C" int plane_solve_dd_f64(const double* ghi, const double* glo,
                                  const double* rhi, const double* rlo,
                                  const unsigned char* quorum, const int* pi,
                                  double* coef, unsigned char* ok, int k,
                                  long long pos, int use_rcond,
                                  double sqrt_rcond, double* scratch,
                                  long long scratch_threads,
                                  int force_runtime, void* stream) {
  return launch_dd<double>(ghi, glo, rhi, rlo, quorum, pi, coef, ok, k, pos,
                           use_rcond, sqrt_rcond, scratch, scratch_threads,
                           force_runtime, stream);
}
