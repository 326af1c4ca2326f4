// The per-position k x k SPD solve of the masked paths, for one position per
// thread: the device counterpart of savgol_tpu/ops/lsq.py
// (cholesky_solve_planes, cholesky_solve_planes_dd) and of
// savgol_tpu_torch/ops/lsq.py, their plain PyTorch versions. plane_solve.cu
// (K8a, K8b), masked1d.cu (K9) and masked2d.cu (K10) all call it, so the
// algebra has one home on the card.
//
// A thread's Gram G (packed lower triangle, G[tri(i, j)], i >= j), right-hand
// side, factor and vectors live in a workspace W whose members G, L, r, dinv,
// z, c, t, u each index like an array. factor / substitute / chol_solve are
// templated on K, the size of the system when it is known at compile time:
//
//   K > 0  every loop unrolls, every tri(i, j) is a constant, and a member
//          held as Regs<T, N> is a set of registers (never local memory); a
//          member held as Strided<T, S> is shared memory laid out by thread
//          (element e of thread t at e * S + t: a warp's lanes touch
//          consecutive words). K9 keeps its whole workspace in registers;
//          K10 and K8a keep G in shared memory (at K = 15 L too) and the
//          rest in registers.
//   K = 0  the runtime form: k is an argument and the workspace is a Span
//          (K8a, K9 and K10 past their compile-time sizes): a local array of
//          a compile-time size (kmax <= kLocalKmax) or, for larger k, a slice
//          of a scratch buffer in device memory, interleaved across threads
//          (Span's stride). Its loops do not unroll, so its code is the
//          runtime-k routine it always was.
//
// chol_solve follows lsq.py::cholesky_solve_planes step by step: positions
// under quorum are solved against the identity; the unshifted factor is kept
// wherever every 1/L_jj is finite, and only where it is not is the system
// factored again with the shift 2k(k+1) eps |tr G| on the diagonal (the JAX
// code computes both factors and selects, where(finite0, L0, L1): the same
// result, with one factor live instead of two); the optional rcond rule; a
// forward and a back substitution; one step of refinement with a residual
// compensated by TwoProd (an exact fma) and TwoSum. Every product and sum
// is rounded as the plain version rounds it (mul_rn and add_rn, which nvcc
// cannot contract into an fma), so from the same stored G and r the solve
// gives the plain version's coefficients bit for bit: on an ill-conditioned
// window a contracted factor measured 1.7e-4 against K9's 2e-5 gate at
// k = 9, where the refinement does not make up the difference. That holds
// for the products that feed a sum only later too (L = t / L_jj, the
// substitutions' z and c, the refined c + u): once a compile-time instance
// keeps them in registers, nvcc would contract them with the sum (K8a's
// first fixed instances differed from the plain version there).
//
// dd_chol_solve follows lsq.py::cholesky_solve_planes_dd in double-word
// arithmetic on FP64 pairs (eps ~ 2^-106). K8b feeds it float32 (hi, lo)
// pairs exactly, as doubles, and returns hi + lo rounded to float32: the
// H100 has native FP64, so the float32 double-word contract (eps ~ 2^-48)
// is met with room to spare. It is templated on K as chol_solve is: K > 0
// on a DdFixedWork (K8b and K11 at k <= 8: L in registers or shared memory
// by thread, G read from L's slots or, for K11's Hankel, from its moments,
// the vectors in registers), K = 0 on a DdWork (the runtime form, past k =
// 8 and wherever a caller forces it). Both run the same operations in the
// same order, and dd_mul's cross term is rounded explicitly, so from the
// same stored G and r the two forms give the same coefficients and ok bit
// for bit.
#pragma once

#include <cuda_runtime.h>

namespace sgtsolve {

// Largest k held in a thread's local array; larger k takes device scratch.
constexpr int kLocalKmax = 32;

__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;              // i >= j
}
__host__ __device__ constexpr int packed(int k) { return k * (k + 1) / 2; }

// Workspace elements of one thread: G and L (packed), then r, dinv, z, c,
// t, u (k each).
__host__ __device__ constexpr long long work_size(int k) {
  return 2LL * packed(k) + 6LL * k;
}
// Double-word workspace, in doubles: G, L (hi and lo, packed), then r,
// dinv, z, c (hi and lo, k each).
__host__ __device__ constexpr long long dd_work_size(int k) {
  return 4LL * packed(k) + 8LL * k;
}

template <typename T>
struct Span {
  T* p;
  long long s;
  __device__ __forceinline__ T& operator[](int i) const { return p[i * s]; }
  __device__ __forceinline__ Span at(long long off) const {
    return {p + off * s, s};
  }
};

template <typename T>
struct Work {
  Span<T> G, L, r, dinv, z, c, t, u;
};

template <typename T>
__device__ __forceinline__ Work<T> carve(Span<T> base, int k) {
  const long long kp = packed(k);
  return {base, base.at(kp), base.at(2 * kp), base.at(2 * kp + k),
          base.at(2 * kp + 2 * k), base.at(2 * kp + 3 * k),
          base.at(2 * kp + 4 * k), base.at(2 * kp + 5 * k)};
}

// Machine epsilon of the working type, as a double.
__host__ __device__ constexpr double eps_of(float) { return 1.1920928955078125e-07; }
__host__ __device__ constexpr double eps_of(double) { return 2.220446049250313e-16; }

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Every thread's workspace: a local array of kmax elements' worth, or the
// thread's interleaved slice of the scratch buffer.
template <typename T>
__device__ __forceinline__ Span<T> thread_span(T* local, T* scratch) {
  if (scratch == nullptr) return {local, 1};
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  return {scratch + tid, static_cast<long long>(gridDim.x) * blockDim.x};
}

// A workspace member held in registers: indexed only by constants once the
// loops over it unroll.
template <typename T, int N>
struct Regs {
  T v[N];
  __device__ __forceinline__ T& operator[](int i) { return v[i]; }
};

// A workspace member in shared memory laid out by thread: element i of this
// thread at p[i * S], p = base + threadIdx.x, S the block's thread count.
// Volatile, so that each read is a load where the algorithm reads: merged
// reads of one element (the residual reads each G entry twice) would hold
// the values in registers across the solve and spill them.
template <typename T, int S>
struct Strided {
  volatile T* p;
  __device__ __forceinline__ volatile T& operator[](int i) const {
    return p[i * S];
  }
};

// The workspace of a system of compile-time size K: G as GS and L as LS
// (registers or shared memory), the vectors in registers.
template <typename T, int K, typename GS = Regs<T, packed(K)>,
          typename LS = Regs<T, packed(K)>>
struct FixedWork {
  GS G;
  LS L;
  Regs<T, K> r, dinv, z, c, t, u;
};

// Factors G (+ shift on the diagonal) into L and 1/diag(L); returns whether
// every 1/L_jj is finite.
template <int K, typename T, typename W>
__device__ __forceinline__ bool factor(int kk, W& w, T shift) {
  const int k = K > 0 ? K : kk;
  bool finite = true;
#pragma unroll
  for (int j = 0; j < k; ++j) {
    T s = w.G[tri(j, j)] + shift;
#pragma unroll
    for (int p = 0; p < j; ++p)
      s = add_rn(s, -mul_rn(w.L[tri(j, p)], w.L[tri(j, p)]));
    const T d = sqrt(s);
    w.L[tri(j, j)] = d;
    const T di = T(1) / d;
    w.dinv[j] = di;
    finite = finite && isfinite(di);
#pragma unroll
    for (int i = j + 1; i < k; ++i) {
      T t = w.G[tri(i, j)];
#pragma unroll
      for (int p = 0; p < j; ++p)
        t = add_rn(t, -mul_rn(w.L[tri(i, p)], w.L[tri(j, p)]));
      w.L[tri(i, j)] = mul_rn(t, di);
    }
  }
  return finite;
}

// L z = r, then L^T c = z.
template <int K, typename W, typename R, typename C>
__device__ __forceinline__ void substitute(int kk, W& w, R& r, C& c) {
  const int k = K > 0 ? K : kk;
#pragma unroll
  for (int i = 0; i < k; ++i) {
    auto s = r[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s = add_rn(s, -mul_rn(w.L[tri(i, j)], w.z[j]));
    w.z[i] = mul_rn(s, w.dinv[i]);
  }
#pragma unroll
  for (int i = k - 1; i >= 0; --i) {
    auto s = w.z[i];
#pragma unroll
    for (int j = i + 1; j < k; ++j) s = add_rn(s, -mul_rn(w.L[tri(j, i)], c[j]));
    c[i] = mul_rn(s, w.dinv[i]);
  }
}

// Solves G c = r for the G and r the caller wrote into w (raw, not
// substituted); the solution is left in w.c. Returns ok: quorate and, with
// use_rcond, identifiable. K > 0 fixes k = K at compile time.
template <int K, typename T, typename W>
__device__ __forceinline__ bool chol_solve(int kk, bool quorum,
                                           bool use_rcond, T sqrt_rcond,
                                           W& w) {
  const int k = K > 0 ? K : kk;
  T tr = w.G[0];
#pragma unroll
  for (int j = 1; j < k; ++j) tr = tr + w.G[tri(j, j)];
  if (!quorum)
#pragma unroll
    for (int i = 0; i < k; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) w.G[tri(i, j)] = i == j ? T(1) : T(0);
  if (!factor<K>(k, w, T(0)) && quorum)
    factor<K>(k, w, mul_rn(T(2.0 * k * (k + 1) * eps_of(T(0))), T(fabs(tr))));

  bool ok = quorum;
  if (use_rcond) {
    bool finite = true;
    T dmin = w.L[0], dmax = fabs(w.L[0]);
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const T d = w.L[tri(j, j)];
      finite = finite && isfinite(d);
      dmin = fmin(dmin, d);
      dmax = fmax(dmax, fabs(d));
    }
    ok = quorum && finite && dmin > sqrt_rcond * fmax(dmax, T(1e-30));
    if (!ok) {
#pragma unroll
      for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int i = j + 1; i < k; ++i) w.L[tri(i, j)] = T(0);
        w.dinv[j] = T(1);
      }
    }
  }

  substitute<K>(k, w, w.r, w.c);
  // residual r - G c, each product split exactly by fma and summed with
  // TwoSum, the rounding errors gathered apart
#pragma unroll
  for (int i = 0; i < k; ++i) {
    T s = w.r[i], comp = T(0);
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const T g = i >= j ? w.G[tri(i, j)] : w.G[tri(j, i)];
      const T p = mul_rn(g, -w.c[j]);
      const T pe = fma(g, -w.c[j], -p);
      const T s2 = add_rn(s, p);
      const T bb = s2 - s;
      const T se = (s - (s2 - bb)) + (p - bb);
      s = s2;
      comp = add_rn(comp, add_rn(pe, se));
    }
    w.t[i] = add_rn(s, comp);
  }
  substitute<K>(k, w, w.t, w.u);
#pragma unroll
  for (int i = 0; i < k; ++i) w.c[i] = add_rn(w.c[i], w.u[i]);
  return ok;
}

// ---- double-word FP64 -------------------------------------------------------

struct dd {
  double hi, lo;
};

__device__ __forceinline__ dd two_sum(double a, double b) {
  const double s = a + b;
  const double bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}
__device__ __forceinline__ dd quick_two_sum(double a, double b) {
  const double s = a + b;
  return {s, b - (s - a)};
}
__device__ __forceinline__ dd two_prod(double a, double b) {
  const double p = __dmul_rn(a, b);
  return {p, fma(a, b, -p)};
}
__device__ __forceinline__ dd dd_add(dd x, dd y) {
  const dd s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, s.lo + (x.lo + y.lo));
}
__device__ __forceinline__ dd dd_sub(dd x, dd y) {
  return dd_add(x, {-y.hi, -y.lo});
}
// The cross term's rounding is written out (one fma over one rounded
// product), so that no form of the solve depends on which product nvcc
// would contract.
__device__ __forceinline__ dd dd_mul(dd x, dd y) {
  const dd p = two_prod(x.hi, y.hi);
  return quick_two_sum(p.hi,
                       add_rn(p.lo, fma(x.hi, y.lo, mul_rn(x.lo, y.hi))));
}
__device__ __forceinline__ dd dd_div(dd x, dd y) {
  const double q1 = x.hi / y.hi;
  dd r = dd_sub(x, dd_mul({q1, 0.0}, y));
  const double q2 = r.hi / y.hi;
  r = dd_sub(r, dd_mul({q2, 0.0}, y));
  const double q3 = r.hi / y.hi;
  const dd s = quick_two_sum(q1, q2);
  return quick_two_sum(s.hi, s.lo + q3);
}
__device__ __forceinline__ dd dd_sqrt(dd x) {
  const double t = sqrt(x.hi);
  const dd p = two_prod(t, t);
  const double d = (((x.hi - p.hi) - p.lo) + x.lo) / (2.0 * t);
  return quick_two_sum(t, d);
}

// The runtime form's workspace: G, L (hi and lo, packed), r, 1/diag(L), z
// and c (hi and lo, k each), each a Span (a local array or device scratch).
struct DdWork {
  Span<double> gh, gl, lh, ll, rh, rl, dh, dl, zh, zl, ch, cl;
  __device__ __forceinline__ dd G(int i, int j) const {
    return {gh[tri(i, j)], gl[tri(i, j)]};
  }
  __device__ __forceinline__ dd L(int e) const { return {lh[e], ll[e]}; }
  __device__ __forceinline__ void setL(int e, dd v) const { lh[e] = v.hi; ll[e] = v.lo; }
  __device__ __forceinline__ dd dinv(int i) const { return {dh[i], dl[i]}; }
  __device__ __forceinline__ void setdinv(int i, dd v) const { dh[i] = v.hi; dl[i] = v.lo; }
  __device__ __forceinline__ dd r(int i) const { return {rh[i], rl[i]}; }
  __device__ __forceinline__ dd z(int i) const { return {zh[i], zl[i]}; }
  __device__ __forceinline__ void setz(int i, dd v) const { zh[i] = v.hi; zl[i] = v.lo; }
  __device__ __forceinline__ dd c(int i) const { return {ch[i], cl[i]}; }
  __device__ __forceinline__ void setc(int i, dd v) const { ch[i] = v.hi; cl[i] = v.lo; }
};

__device__ __forceinline__ DdWork dd_carve(Span<double> b, int k) {
  const long long kp = packed(k);
  return {b,           b.at(kp),        b.at(2 * kp),     b.at(3 * kp),
          b.at(4 * kp), b.at(4 * kp + k), b.at(4 * kp + 2 * k),
          b.at(4 * kp + 3 * k), b.at(4 * kp + 4 * k), b.at(4 * kp + 5 * k),
          b.at(4 * kp + 6 * k), b.at(4 * kp + 7 * k)};
}

// The workspace of a double-word system of compile-time size K. L (hi and
// lo, packed) is LS: registers (Regs) or shared memory by thread (Strided).
// G is read from L's own slots, where the caller wrote it and where L
// overwrites it in place (the factor reads G(i, j) once, before it writes
// L(i, j), and nothing reads G after the factor), or, with kHankel, from
// 2K - 1 moments in registers, G(i, j) = S[i + j]. r, z and c are one
// vector in registers (each substitution reads an entry before it writes
// it), 1/diag(L) another.
template <int K, typename LS, bool kHankel>
struct DdFixedWork {
  LS lh, ll;
  Regs<double, kHankel ? 2 * K - 1 : 1> sh, sl;
  Regs<double, K> vh, vl, dh, dl;
  __device__ __forceinline__ dd G(int i, int j) {
    if constexpr (kHankel)
      return {sh[i + j], sl[i + j]};
    else
      return {lh[tri(i, j)], ll[tri(i, j)]};
  }
  __device__ __forceinline__ dd L(int e) { return {lh[e], ll[e]}; }
  __device__ __forceinline__ void setL(int e, dd v) { lh[e] = v.hi; ll[e] = v.lo; }
  __device__ __forceinline__ dd dinv(int i) { return {dh[i], dl[i]}; }
  __device__ __forceinline__ void setdinv(int i, dd v) { dh[i] = v.hi; dl[i] = v.lo; }
  __device__ __forceinline__ dd r(int i) { return {vh[i], vl[i]}; }
  __device__ __forceinline__ dd z(int i) { return {vh[i], vl[i]}; }
  __device__ __forceinline__ void setz(int i, dd v) { vh[i] = v.hi; vl[i] = v.lo; }
  __device__ __forceinline__ dd c(int i) { return {vh[i], vl[i]}; }
  __device__ __forceinline__ void setc(int i, dd v) { vh[i] = v.hi; vl[i] = v.lo; }
};

// Solves G c = r in double-word arithmetic for the (hi, lo) G and r the
// caller wrote into w; the solution is left in w.c. Positions under quorum
// are solved against the identity. Returns ok: quorate, every diagonal of
// L finite and, with use_rcond, min diag > sqrt_rcond * max |diag|; where
// not ok the substitutions run on the identity factor. K > 0 fixes k = K at
// compile time (every loop unrolls, every tri(i, j) is a constant); K = 0
// is the runtime form on a DdWork, the same operations in the same order.
template <int K, typename W>
__device__ __forceinline__ bool dd_chol_solve(int kk, bool quorum,
                                              bool use_rcond,
                                              double sqrt_rcond, W& w) {
  const int k = K > 0 ? K : kk;
  bool finite = true;
  double dmin = 0.0, dmax = 0.0;
#pragma unroll
  for (int j = 0; j < k; ++j) {
    dd s = quorum ? w.G(j, j) : dd{1.0, 0.0};
#pragma unroll
    for (int p = 0; p < j; ++p) s = dd_sub(s, dd_mul(w.L(tri(j, p)), w.L(tri(j, p))));
    const dd d = dd_sqrt(s);
    w.setL(tri(j, j), d);
    const dd di = dd_div({1.0, 0.0}, d);
    w.setdinv(j, di);
#pragma unroll
    for (int i = j + 1; i < k; ++i) {
      dd t = quorum ? w.G(i, j) : dd{0.0, 0.0};
#pragma unroll
      for (int p = 0; p < j; ++p) t = dd_sub(t, dd_mul(w.L(tri(i, p)), w.L(tri(j, p))));
      w.setL(tri(i, j), dd_mul(t, di));
    }
    finite = finite && isfinite(d.hi);
    dmin = j == 0 ? d.hi : fmin(dmin, d.hi);
    dmax = j == 0 ? fabs(d.hi) : fmax(dmax, fabs(d.hi));
  }
  bool ok = quorum && finite;
  if (use_rcond) ok = ok && dmin > sqrt_rcond * fmax(dmax, 1e-30);
  if (!ok) {
#pragma unroll
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int i = j + 1; i < k; ++i) w.setL(tri(i, j), {0.0, 0.0});
      w.setdinv(j, {1.0, 0.0});
    }
  }
#pragma unroll
  for (int i = 0; i < k; ++i) {
    dd s = w.r(i);
#pragma unroll
    for (int j = 0; j < i; ++j) s = dd_sub(s, dd_mul(w.L(tri(i, j)), w.z(j)));
    w.setz(i, dd_mul(s, w.dinv(i)));
  }
#pragma unroll
  for (int i = k - 1; i >= 0; --i) {
    dd s = w.z(i);
#pragma unroll
    for (int j = i + 1; j < k; ++j) s = dd_sub(s, dd_mul(w.L(tri(j, i)), w.c(j)));
    w.setc(i, dd_mul(s, w.dinv(i)));
  }
  return ok;
}

}  // namespace sgtsolve
