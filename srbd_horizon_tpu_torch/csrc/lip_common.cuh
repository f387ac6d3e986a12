// Device code shared by the LIP kernels — K10 (csrc/lip_linearize.cu), K11
// and lip_evaluate (csrc/lip_rollout.cu): the sizes they are compiled for,
// the problem's constants, the packed parameter row, the rows of the LIP
// double integrator ẋ and of the stacked stage residual
// ρ = [stage_residual; √w_c·stage_eq] and of the terminal residual, a
// node's squared residual on one thread (K11's and lip_evaluate's
// evaluation), and a given plan's node evaluated on one warp (K13's, in
// csrc/linear_trial.cu). All of them evaluate the dynamics and the
// residuals through this one copy.
//
// Layouts (srbd_horizon_tpu_torch/problems/lip.py, nc contacts):
//   x = [r(3), c(3nc), ṙ(3), ċ(3nc)]                        nx = 6 + 6nc
//   u = [z(3), c̈(3nc)]                                      nu = 3 + 3nc
//   ρ = [rz, rxy(2), ṙ(3), zmp(3), rel(4), r̈(3), c̈(3nc)
//        | relvel(2·legs·(cm−1)), cz(nc), ċxy(2nc)]
// with r̈ = η²(r − z) − g e_z on all three axes (the reference's quirk).
// rz, rxy, ṙ and rel are scaled by the tracking mask; zmp, r̈ and c̈ are
// not, so they are live at node 0. The terminal residual is
// [rz, rxy, ṙ, rel] with the mask 1.

#pragma once

#include "rigid_common.cuh"

namespace lip {

using rigid::abs_nan;
using rigid::nan_max;
using rigid::warp_nan_max;
using rigid::warp_sum;

// The sizes the LIP kernels are compiled for: build_lip_problem with the
// Kangaroo feet. kernels/lip_linearize.py::KERNEL_SHAPE holds the same
// numbers (a test reads them from here); on CUDA tensors of any other sizes
// the wrappers raise. The row counts are those of RiccatiRows.from_ocp
// (the rows K10 emits and K1 reads).
struct Shape {
  static constexpr int nc = 4, cm = 2, n_legs = 2, nx = 30, nu = 15,
                       n_rho = 44, nt = 10, n_rx = 18, n_ru = 15, n_gx = 32,
                       n_gu = 18;
};

// Offsets and counts that follow from a shape.
template <class S>
struct Layout {
  static constexpr int nc = S::nc, nx = S::nx, nu = S::nu;
  static constexpr int i_c = 3, i_rdot = 3 + 3 * nc, i_cdot = 6 + 3 * nc;
  static constexpr int n_res = 16 + 3 * nc;            // residual rows
  static constexpr int n_rv = 2 * S::n_legs * (S::cm - 1);
  static constexpr int pw = 4 + 2 * nc;                // packed parameter row
  static_assert(nx == 6 + 6 * nc && nu == 3 + 3 * nc, "not a LIP layout");
  static_assert(S::n_rho == n_res + n_rv + 3 * nc, "ρ rows");
  static_assert(S::nt == 10 && pw <= 32, "terminal rows, parameter row");
};

// host scalars, in this order: dt, η², w_r, w_rdot, w_zmp, w_rel, w_qddot,
// √w_c, com_z, d1x, d1y, d2x, d2y (problems/lip.py::LIPTerms.kernel_scalars)
constexpr int kScalars = 13;
// parameter tensors, each (B, ns+1, dim), in this order: mask_track (1),
// rdot_ref (3), c_ref (nc), cdot_switch (nc)
constexpr int kParams = 4;

template <typename T>
struct Consts {
  T dt, eta2, w_r, w_rdot, w_zmp, w_rel, w_qddot, wc;
  T com_z, d1x, d1y, d2x, d2y;
};

template <typename T>
inline Consts<T> make_consts(const double* s) {
  const auto c = [&](int i) { return static_cast<T>(s[i]); };
  return Consts<T>{c(0), c(1), c(2), c(3), c(4), c(5), c(6),
                   c(7), c(8), c(9), c(10), c(11), c(12)};
}

// The parameter rows of one member-node, packed:
// [mt, rdot_ref(3), c_ref(nc), cdot_switch(nc)].
constexpr int kP_mt = 0, kP_rdot = 1, kP_cref = 4;

template <class S>
struct Param {
  static constexpr int cs = kP_cref + S::nc;           // cdot_switch
};

template <typename T>
struct Params {
  const T* p[kParams];
};

template <typename T>
inline Params<T> make_params(const void* const* ptrs) {
  Params<T> P;
  for (int i = 0; i < kParams; ++i) P.p[i] = static_cast<const T*>(ptrs[i]);
  return P;
}

// Width of parameter tensor t and its offset in the packed row.
template <class S>
__host__ __device__ constexpr int param_dim(int t) {
  return t == 0 ? 1 : t == 1 ? 3 : S::nc;
}

template <class S>
__host__ __device__ constexpr int param_off(int t) {
  int o = 0;
  for (int i = 0; i < t; ++i) o += param_dim<S>(i);
  return o;
}

// Where entry e of the packed parameter row of member-node `row`
// (= b·(ns+1)+n) lives in device memory.
template <class S, typename T>
__device__ __forceinline__ const T* param_src(const Params<T>& P, size_t row,
                                              int e) {
  constexpr int nc = S::nc;
  if (e == kP_mt) return P.p[0] + row;
  if (e < kP_cref) return P.p[1] + row * 3 + (e - kP_rdot);
  if (e < kP_cref + nc) return P.p[2] + row * nc + (e - kP_cref);
  return P.p[3] + row * nc + (e - kP_cref - nc);
}

// V values of T, aligned as one access: a 16-byte store at V = 16 /
// sizeof(T) (K10's units, lip_evaluate's pinned plan), or one value.
template <typename T, int V>
struct alignas(sizeof(T) * V) Unit {
  T v[V];
};

// ---- the dynamics ----

// Row j of ẋ(x, u): ṙ, ċ, r̈ = η²(r − z) − g e_z, c̈ (models/lip.py).
template <class S, typename T>
__device__ __forceinline__ T xdot_row(int j, const T* x, const T* u,
                                      const Consts<T>& k) {
  using L = Layout<S>;
  if (j < 3) return x[L::i_rdot + j];
  if (j < L::i_rdot) return x[L::i_cdot + (j - 3)];
  if (j < L::i_cdot) {
    const int a = j - L::i_rdot;
    const T v = k.eta2 * (x[a] - u[a]);
    return a == 2 ? v - T(9.81) : v;
  }
  return u[3 + (j - L::i_cdot)];
}

// ---- residual rows ----

// Axis a of the contact centroid mean(c).
template <class S, typename T>
__device__ __forceinline__ T centroid(const T* x, int a) {
  T s = T(0);
#pragma unroll
  for (int q = 0; q < S::nc; ++q) s += x[Layout<S>::i_c + 3 * q + a];
  return s / T(S::nc);
}

// Foot-pair columns of rel row g ∈ [0, 4): the row is
// w_rel·((−c[a] + c[b]) − d), a and b offsets into c.
template <class S>
__host__ __device__ __forceinline__ void rel_cols(int g, int* a, int* b) {
  const int ax = (g % 2 == 0) ? 1 : 0;              // rows 0, 2: y
  *a = (g < 2 ? 0 : 3 * (S::cm - 1)) + ax;
  *b = (g < 2 ? 3 * S::cm : 3 * (S::nc - 1)) + ax;
}

// Row g < 6 of the tracking rows rz, rxy, ṙ, or rel row g − 6 for
// 6 ≤ g < 10, with tracking mask mt (the terminal residual when mt = 1).
template <class S, typename T>
__device__ T tracking_row(int g, const T* x, const T* p, T mt,
                          const Consts<T>& k) {
  using L = Layout<S>;
  if (g == 0) return (mt * k.w_r) * (x[2] - k.com_z);
  if (g < 3) return (mt * k.w_r) * (x[g - 1] - centroid<S>(x, g - 1));
  if (g < 6) return (mt * k.w_rdot) * (x[L::i_rdot + g - 3] - p[kP_rdot + g - 3]);
  int a, b;
  rel_cols<S>(g - 6, &a, &b);
  const T* c = x + L::i_c;
  const T dd = g == 6 ? k.d1y : g == 7 ? k.d1x : g == 8 ? k.d2y : k.d2x;
  return (mt * k.w_rel) * ((-c[a] + c[b]) - dd);
}

// Row q of √w_c · stage_eq at (x, p) (stage row n_res + q).
template <class S, typename T>
__device__ T eq_row(int q, const T* x, const T* p, const Consts<T>& k) {
  using L = Layout<S>;
  constexpr int nc = S::nc;
  constexpr int per = 2 * (S::cm - 1);
  const T* cdot = x + L::i_cdot;
  T h;
  if (q < L::n_rv) {
    const int base = (q / per) * S::cm, rem = q % per;
    const int i = rem / 2 + 1, ax = rem % 2;
    h = cdot[3 * base + ax] - cdot[3 * (base + i) + ax];
  } else if (q < L::n_rv + nc) {
    q -= L::n_rv;
    h = x[L::i_c + 3 * q + 2] - p[kP_cref + q];
  } else {
    q -= L::n_rv + nc;
    h = p[Param<S>::cs + q / 2] * cdot[3 * (q / 2) + q % 2];
  }
  return k.wc * h;
}

// Row g of the stacked stage residual ρ at (x, u, p).
template <class S, typename T>
__device__ T stage_rho_row(int g, const T* x, const T* u, const T* p,
                           const Consts<T>& k) {
  using L = Layout<S>;
  const T mt = p[kP_mt];
  if (g < 6) return tracking_row<S>(g, x, p, mt, k);
  if (g < 9) return k.w_zmp * (u[g - 6] - centroid<S>(x, g - 6));
  if (g < 13) return tracking_row<S>(g - 3, x, p, mt, k);
  if (g < 16) return k.w_qddot * xdot_row<S>(L::i_rdot + g - 13, x, u, k);
  if (g < L::n_res) return k.w_qddot * u[3 + g - 16];
  return eq_row<S>(g - L::n_res, x, p, k);
}

// This lane's share of ‖ρ(x, u, p)‖² over the stage rows: rows lane and
// lane + 32. Every lane may call it; the sum over the warp is the node's.
template <class S, typename T>
__device__ __forceinline__ T stage_sq_lane(int lane, const T* x, const T* u,
                                           const T* p, const Consts<T>& k) {
  static_assert(S::n_rho <= 64, "two rows a lane");
  T acc = T(0);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int g = lane + 32 * c;
    if (g < S::n_rho) {
      const T v = stage_rho_row<S>(g, x, u, p, k);
      acc += v * v;
    }
  }
  return acc;
}

// This lane's share of ‖ρ_N(x, p)‖² (lanes < nt).
template <class S, typename T>
__device__ __forceinline__ T terminal_sq_lane(int lane, const T* x,
                                              const T* p, const Consts<T>& k) {
  if (lane >= S::nt) return T(0);
  const T v = tracking_row<S>(lane, x, p, T(1), k);
  return v * v;
}

// ‖ρ(x, u, p)‖² over the stage rows on one thread, the rows added in
// order (K11 and lip_evaluate evaluate a node a thread).
template <class S, typename T>
__device__ __forceinline__ T stage_sq(const T* x, const T* u, const T* p,
                                      const Consts<T>& k) {
  T acc = T(0);
#pragma unroll
  for (int g = 0; g < S::n_rho; ++g) {
    const T v = stage_rho_row<S>(g, x, u, p, k);
    acc += v * v;
  }
  return acc;
}

// ‖ρ_N(x, p)‖² on one thread, the rows added in order.
template <class S, typename T>
__device__ __forceinline__ T terminal_sq(const T* x, const T* p,
                                         const Consts<T>& k) {
  T acc = T(0);
#pragma unroll
  for (int g = 0; g < S::nt; ++g) {
    const T v = tracking_row<S>(g, x, p, T(1), k);
    acc += v * v;
  }
  return acc;
}

// ---- a given plan's node, evaluated on one warp (K13) ----

// One warp evaluates stage node (x, u, p): this lane's share of Σ‖ρ‖²
// (returned) and, on lanes below nx, row `lane` of the Euler step
// x + dt·ẋ(x, u) into *step.
template <class S, typename T>
__device__ __forceinline__ T eval_stage(int lane, const T* x, const T* u,
                                        const T* p, const Consts<T>& k,
                                        T* step) {
  const T acc = stage_sq_lane<S>(lane, x, u, p, k);
  if (lane < S::nx) *step = x[lane] + k.dt * xdot_row<S>(lane, x, u, k);
  return acc;
}

// This lane's share of the terminal node's ‖ρ_N(x, p)‖².
template <class S, typename T>
__device__ __forceinline__ T eval_terminal(int lane, const T* x, const T* p,
                                           const Consts<T>& k) {
  return terminal_sq_lane<S>(lane, x, p, k);
}

}  // namespace lip
