// Device code shared by the LIP kernels — K10 (csrc/lip_linearize.cu), K11
// and lip_evaluate (csrc/lip_rollout.cu): the topologies and steps they are
// compiled for, the problem's constants, the packed parameter row, the
// rows of the LIP double integrator ẋ, the step x⁺ = step(x, u) of the
// OCP's integrator (Euler, RK2 or RK4) a row a thread, the rows of the
// stacked stage residual ρ = [stage_residual; √w_c·stage_eq] and of the
// terminal residual, a node's squared residual on one thread (K11's and
// lip_evaluate's evaluation), and a given plan's node evaluated on one
// warp (K13's, in csrc/linear_trial.cu). All of them evaluate the dynamics
// and the residuals through this one copy.
//
// Layouts (srbd_horizon_tpu_torch/problems/lip.py, nc contacts):
//   x = [r(3), c(3nc), ṙ(3), ċ(3nc)]                        nx = 6 + 6nc
//   u = [z(3), c̈(3nc)]                                      nu = 3 + 3nc
//   ρ = [rz, rxy(2), ṙ(3), zmp(3), rel(4), r̈(3), c̈(3nc)
//        | relvel(2·legs·(cm−1)), cz(nc), ċxy(2nc)]
// with r̈ = η²(r − z) − g e_z on all three axes (the reference's quirk).
// rz, rxy, ṙ and rel are scaled by the tracking mask; zmp, r̈ and c̈ are
// not, so they are live at node 0. The terminal residual is
// [rz, rxy, ṙ, rel] with the mask 1. State row i < nx/2 (a position) and
// row i + nx/2 (its velocity) form pair i, a linear system of its own
// driven by input u[i]: the step of a row reads only its pair.

#pragma once

#include "rigid_common.cuh"

namespace lip {

using rigid::abs_nan;
using rigid::Euler;
using rigid::full_stage;
using rigid::nan_max;
using rigid::Rk2;
using rigid::Rk4;
using rigid::warp_nan_max;
using rigid::warp_sum;

// The contact topologies the LIP kernels are compiled for, one struct a
// robot: build_lip_problem with the Kangaroo's line feet, the quadruped's
// point feet (models/quadruped.py), the point-feet biped
// (models/kangaroo.py::point_feet), the square-feet biped (four contact
// points a foot, contact_model=4: nx=54, more state rows than a warp has
// lanes) and the line-feet quadruped (two contact points a foot on four
// legs, contact_model=2: the square feet's nx and nu, fewer
// relative-velocity rows), each under the Euler step; `Stepped` gives the
// same topology under RK2 or RK4.
// kernels/lip_linearize.py::TOPOLOGIES holds the same numbers in the same
// order (a test reads them from here); on CUDA tensors of any other sizes
// the wrappers raise. The row counts are those of RiccatiRows.from_ocp
// (the rows K10 emits and K1 reads).
struct KangarooShape {
  static constexpr int nc = 4, cm = 2, n_legs = 2, nx = 30, nu = 15,
                       n_rho = 44, nt = 10, n_rx = 18, n_ru = 15, n_gx = 32,
                       n_gu = 18;
  using Step = Euler;
};

struct QuadShape {
  static constexpr int nc = 4, cm = 1, n_legs = 4, nx = 30, nu = 15,
                       n_rho = 40, nt = 10, n_rx = 18, n_ru = 15, n_gx = 28,
                       n_gu = 18;
  using Step = Euler;
};

struct PointFeetShape {
  static constexpr int nc = 2, cm = 1, n_legs = 2, nx = 18, nu = 9,
                       n_rho = 28, nt = 10, n_rx = 12, n_ru = 9, n_gx = 22,
                       n_gu = 12;
  using Step = Euler;
};

struct SquareFeetShape {
  static constexpr int nc = 8, cm = 4, n_legs = 2, nx = 54, nu = 27,
                       n_rho = 76, nt = 10, n_rx = 30, n_ru = 27, n_gx = 52,
                       n_gu = 30;
  using Step = Euler;
};

struct LineFeetQuadShape {
  static constexpr int nc = 8, cm = 2, n_legs = 4, nx = 54, nu = 27,
                       n_rho = 72, nt = 10, n_rx = 30, n_ru = 27, n_gx = 48,
                       n_gu = 30;
  using Step = Euler;
};

// A topology under another step: the RK stages carry u into the position
// rows through the velocities, so B has nx live rows (A − I keeps
// Euler's).
template <class Topo, class St>
struct Stepped : Topo {
  static constexpr int n_ru = Topo::nx;
  using Step = St;
};

// A launcher's answer for sizes no shape above has.
constexpr int kUnknownShape = -2;

// fn(S{}) for the (topology, step) instance at `index` in the order of
// kernels/lip_linearize.py::KERNEL_SHAPES — the first three topologies
// under Euler, then each under RK2 and RK4, then the square-feet biped and
// the line-feet quadruped, each under the three steps — or kUnknownShape.
template <class Fn>
inline int with_shape(int index, Fn fn) {
  switch (index) {
    case 0: return fn(KangarooShape{});
    case 1: return fn(QuadShape{});
    case 2: return fn(PointFeetShape{});
    case 3: return fn(Stepped<KangarooShape, Rk2>{});
    case 4: return fn(Stepped<KangarooShape, Rk4>{});
    case 5: return fn(Stepped<QuadShape, Rk2>{});
    case 6: return fn(Stepped<QuadShape, Rk4>{});
    case 7: return fn(Stepped<PointFeetShape, Rk2>{});
    case 8: return fn(Stepped<PointFeetShape, Rk4>{});
    case 9: return fn(SquareFeetShape{});
    case 10: return fn(Stepped<SquareFeetShape, Rk2>{});
    case 11: return fn(Stepped<SquareFeetShape, Rk4>{});
    case 12: return fn(LineFeetQuadShape{});
    case 13: return fn(Stepped<LineFeetQuadShape, Rk2>{});
    case 14: return fn(Stepped<LineFeetQuadShape, Rk4>{});
    default: return kUnknownShape;
  }
}

template <class Topo, class Fn>
inline int with_step(int step, Fn fn) {
  switch (step) {
    case Euler::id: return fn(Topo{});
    case Rk2::id: return fn(Stepped<Topo, Rk2>{});
    case Rk4::id: return fn(Stepped<Topo, Rk4>{});
    default: return kUnknownShape;
  }
}

template <class Topo>
inline bool is_topology(int nc, int cm, int n_legs) {
  return nc == Topo::nc && cm == Topo::cm && n_legs == Topo::n_legs;
}

// fn(S{}) for the instance of this contact topology (nc contacts of cm
// points on n_legs legs) and step (Euler::id, Rk2::id, Rk4::id), or
// kUnknownShape: the topology fixes nx, nu and n_rho, the step the rows of
// B, so the two pick the instance.
template <class Fn>
inline int with_topology(int nc, int cm, int n_legs, int step, Fn fn) {
  if (is_topology<KangarooShape>(nc, cm, n_legs))
    return with_step<KangarooShape>(step, fn);
  if (is_topology<QuadShape>(nc, cm, n_legs)) return with_step<QuadShape>(step, fn);
  if (is_topology<PointFeetShape>(nc, cm, n_legs))
    return with_step<PointFeetShape>(step, fn);
  if (is_topology<SquareFeetShape>(nc, cm, n_legs))
    return with_step<SquareFeetShape>(step, fn);
  if (is_topology<LineFeetQuadShape>(nc, cm, n_legs))
    return with_step<LineFeetQuadShape>(step, fn);
  return kUnknownShape;
}

// Offsets and counts that follow from a shape.
template <class S>
struct Layout {
  static constexpr int nc = S::nc, nx = S::nx, nu = S::nu;
  static constexpr int i_c = 3, i_rdot = 3 + 3 * nc, i_cdot = 6 + 3 * nc;
  static constexpr int half = nx / 2;                  // pair i: rows i, i + half
  static constexpr int n_res = 16 + 3 * nc;            // residual rows
  static constexpr int n_rv = 2 * S::n_legs * (S::cm - 1);
  static constexpr int pw = 4 + 2 * nc;                // packed parameter row
  static_assert(nx == 6 + 6 * nc && nu == 3 + 3 * nc && half == i_rdot,
                "not a LIP layout");
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

// ---- the step ----

// ẋ of pair i's velocity row at position p: r̈ᵢ = η²(p − zᵢ) − g e_z
// (i < 3), c̈ = u[i] on a contact coordinate (xdot_row's rows, by pair).
template <typename T>
__device__ __forceinline__ T pair_accel(int i, T p, const T* u,
                                        const Consts<T>& k) {
  if (i < 3) {
    const T v = k.eta2 * (p - u[i]);
    return i == 2 ? v - T(9.81) : v;
  }
  return u[i];
}

// Pair i's rows of x⁺ = step(x, u) under RK2 or RK4 on one thread: its
// position p and velocity v through the stages, each stage point
// x + c_s·dt·k_{s−1} and the k's summed as ocp/integrators.py forms and sums
// them (k_s = (v_s, accel(p_s)), the stage's dt/2 as ½·dt, RK4's dt/6 as
// dt / 6), into *pn and *vn.
template <class S, typename T>
__device__ __forceinline__ void step_pair(int i, const T* x, const T* u,
                                          const Consts<T>& k, T* pn, T* vn) {
  using St = typename S::Step;
  static_assert(St::stages > 1, "Euler's rows are step_row's");
  constexpr int h = Layout<S>::half;
  const T p = x[i], v = x[i + h];
  T kp = v, kv = pair_accel(i, p, u, k);
  T sp = kp, sv = kv;                              // RK4's sum of the k's
#pragma unroll
  for (int s = 1; s < St::stages; ++s) {
    const T cdt = full_stage<St>(s) ? k.dt : T(0.5) * k.dt;
    const T ps = p + cdt * kp, vs = v + cdt * kv;
    kp = vs;
    kv = pair_accel(i, ps, u, k);
    if constexpr (St::stages == 4) {
      sp = s == 3 ? sp + kp : sp + T(2) * kp;
      sv = s == 3 ? sv + kv : sv + T(2) * kv;
    }
  }
  if constexpr (St::stages == 4) {
    const T d6 = k.dt / T(6);
    *pn = p + d6 * sp;
    *vn = v + d6 * sv;
  } else {
    *pn = p + k.dt * kp;
    *vn = v + k.dt * kv;
  }
}

// Row j of x⁺ = step(x, u) on one thread: x + dt·ẋ under Euler; under RK2
// and RK4 row j of its pair's stages (`step_pair`).
template <class S, typename T>
__device__ __forceinline__ T step_row(int j, const T* x, const T* u,
                                      const Consts<T>& k) {
  if constexpr (S::Step::stages == 1) {
    return x[j] + k.dt * xdot_row<S>(j, x, u, k);
  } else {
    constexpr int h = Layout<S>::half;
    T pn, vn;
    step_pair<S>(j < h ? j : j - h, x, u, k, &pn, &vn);
    return j < h ? pn : vn;
  }
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

// Rows a lane takes when a warp sums a node's stage rows: two up to 64
// rows, three for the square-feet biped's 76 and the line-feet
// quadruped's 72.
template <class S>
constexpr int kRowsALane = (S::n_rho + 31) / 32 < 2 ? 2 : (S::n_rho + 31) / 32;

// This lane's share of ‖ρ(x, u, p)‖² over the stage rows: rows lane,
// lane + 32 (and lane + 64, past 64 rows). Every lane may call it; the sum
// over the warp is the node's.
template <class S, typename T>
__device__ __forceinline__ T stage_sq_lane(int lane, const T* x, const T* u,
                                           const T* p, const Consts<T>& k) {
  static_assert(S::n_rho <= 32 * kRowsALane<S>, "every row on a lane");
  T acc = T(0);
#pragma unroll
  for (int c = 0; c < kRowsALane<S>; ++c) {
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
// (returned) and, on lanes below nx, row `lane` of the step
// x⁺ = step(x, u) into *step.
template <class S, typename T>
__device__ __forceinline__ T eval_stage(int lane, const T* x, const T* u,
                                        const T* p, const Consts<T>& k,
                                        T* step) {
  const T acc = stage_sq_lane<S>(lane, x, u, p, k);
  if (lane < S::nx) *step = step_row<S>(lane, x, u, k);
  return acc;
}

// This lane's share of the terminal node's ‖ρ_N(x, p)‖².
template <class S, typename T>
__device__ __forceinline__ T eval_terminal(int lane, const T* x, const T* p,
                                           const Consts<T>& k) {
  return terminal_sq_lane<S>(lane, x, p, k);
}

}  // namespace lip
