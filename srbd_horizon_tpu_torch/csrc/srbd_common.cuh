// Device code shared by the SRBD kernels — K3 and srbd_evaluate
// (csrc/srbd_rollout.cu) and K4 (csrc/srbd_linearize.cu): the sizes and
// steps they are compiled for, the problem's constants, the rigid-body
// rates of ẋ (every lane of a warp holds them in registers), the step
// x⁺ = step(x, u) of the OCP's integrator (Euler, RK2 or RK4) on one warp,
// and the rows of its stacked stage residual
// ρ = [stage_residual; √w_c·stage_eq] and of its terminal residual, and a
// given plan's node evaluated (srbd_evaluate's body, which K13 in
// csrc/linear_trial.cu runs too). All of them evaluate the dynamics and
// the residuals through this one copy. The rotation, inertia and
// quaternion-rate helpers and the warp reductions come from
// csrc/rigid_common.cuh, which the isrbd kernels share.
//
// Layouts (srbd_horizon_tpu_torch/problems/srbd.py, nc contacts):
//   x = [r(3), o(4, xyzw), c(3nc), ṙ(3), ω(3), ċ(3nc)]        nx = 13 + 6nc
//   u = [c̈₀(3), f₀(3), …, c̈ₙ꜀₋₁(3), fₙ꜀₋₁(3)]                nu = 6nc
//   ρ = [rz, o(4), ṙ(3), ω(3), rel(4), r̈(3), ω̇(3), c̈(3nc), f(3nc),
//        fswitch(3nc) | relvel(2·legs·(cm−1)), cz(nc), ċxy(2nc)]
// The terminal residual is the first 15 rows with the tracking mask 1.

#pragma once

#include "rigid_common.cuh"

namespace srbd {

using namespace rigid;

// The steps Euler, Rk2 and Rk4 (kernels/linearize.py::STEPS, same order)
// and `full_stage` are rigid_common.cuh's.

// The contact topologies the SRBD kernels are compiled for, one struct a
// robot: build_srbd_problem with the Kangaroo's line feet, the quadruped's
// point feet (models/quadruped.py), the point-feet biped
// (models/kangaroo.py::point_feet), the square-feet biped (four contact
// points a foot, contact_model=4: nc=8, nu=48, more inputs than a warp has
// lanes) and the line-feet quadruped (two contact points a foot on four
// legs, contact_model=2: nc=8, the square feet's nx and nu, fewer
// relative-velocity rows), each under the Euler step; `Stepped` gives the
// same topology under RK2 or RK4.
// kernels/linearize.py::TOPOLOGIES holds the same numbers in the same order
// (a test reads them from here); on CUDA tensors of any other sizes the
// wrappers raise. The row counts are those of RiccatiRows.from_ocp (the
// rows K4 emits and K1 reads).
struct KangarooShape {
  static constexpr int nc = 4, cm = 2, n_legs = 2, nx = 37, nu = 24,
                       n_rho = 73, nt = 15, n_rx = 22, n_ru = 18, n_gx = 34,
                       n_gu = 42;
  using Step = Euler;
};

struct QuadShape {
  static constexpr int nc = 4, cm = 1, n_legs = 4, nx = 37, nu = 24,
                       n_rho = 69, nt = 15, n_rx = 22, n_ru = 18, n_gx = 30,
                       n_gu = 42;
  using Step = Euler;
};

struct PointFeetShape {
  static constexpr int nc = 2, cm = 1, n_legs = 2, nx = 25, nu = 12,
                       n_rho = 45, nt = 15, n_rx = 16, n_ru = 12, n_gx = 24,
                       n_gu = 24;
  using Step = Euler;
};

struct SquareFeetShape {
  static constexpr int nc = 8, cm = 4, n_legs = 2, nx = 61, nu = 48,
                       n_rho = 129, nt = 15, n_rx = 34, n_ru = 30, n_gx = 54,
                       n_gu = 78;
  using Step = Euler;
};

struct LineFeetQuadShape {
  static constexpr int nc = 8, cm = 2, n_legs = 4, nx = 61, nu = 48,
                       n_rho = 125, nt = 15, n_rx = 34, n_ru = 30, n_gx = 50,
                       n_gu = 78;
  using Step = Euler;
};

// A topology under another step: the RK stages carry u into every state
// row through ∂ẋ/∂x, so B has nx live rows (A − I keeps Euler's).
template <class Topo, class St>
struct Stepped : Topo {
  static constexpr int n_ru = Topo::nx;
  using Step = St;
};

// A launcher's answer for sizes no shape above has.
constexpr int kUnknownShape = -2;

// fn(S{}) for the (topology, step) instance at `index` in the order of
// kernels/linearize.py::KERNEL_SHAPES — the first three topologies under
// Euler, then each under RK2 and RK4, then the square-feet biped and the
// line-feet quadruped, each under the three steps — or kUnknownShape.
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
  static constexpr int i_c = 7, i_rdot = 7 + 3 * nc, i_w = 10 + 3 * nc,
                       i_cdot = 13 + 3 * nc;
  static constexpr int n_res = 21 + 9 * nc;            // residual rows
  static constexpr int n_rv = 2 * S::n_legs * (S::cm - 1);
  // the state rows ẋ depends on x through: r, o, c (integrated velocities)
  // and ω — the live rows of A − I under every step, in this order
  static constexpr int n_live = i_rdot + 3;
  static constexpr int pw = 12 + 2 * nc;               // packed parameter row
  static_assert(nx == 13 + 6 * nc && nu == 6 * nc, "not an SRBD layout");
  static_assert(S::n_rho == n_res + n_rv + 3 * nc, "ρ rows");
  static_assert(S::nt == 15 && pw <= 32, "terminal rows, parameter row");
  static_assert((nc & (nc - 1)) == 0 && nc <= 32,
                "the contact sums reduce over nc lanes with xor shuffles");
};

// host scalars, in this order: dt, m_scaled, inertia_scaled (9, row-major),
// w_r, w_rdot, w_w, w_rel, w_qddot, w_minf, w_fswitch, √w_c, com_z,
// d1x, d1y, d2x, d2y (problems/srbd.py::SRBDTerms.kernel_scalars)
constexpr int kScalars = 24;
// parameter tensors, each (B, ns+1, dim), in this order: mask_track (1),
// orientation_tracking_gain (1), oref (4), rdot_ref (3), w_ref (3),
// c_ref (nc), cdot_switch (nc)
constexpr int kParams = 7;

template <typename T>
struct Consts {
  T dt, m_scaled;
  T I[9];
  T w_r, w_rdot, w_w, w_rel, w_qddot, w_minf, w_fswitch, wc;
  T com_z, d1x, d1y, d2x, d2y;
};

template <typename T>
inline Consts<T> make_consts(const double* s) {
  Consts<T> k;
  k.dt = static_cast<T>(s[0]);
  k.m_scaled = static_cast<T>(s[1]);
  for (int i = 0; i < 9; ++i) k.I[i] = static_cast<T>(s[2 + i]);
  k.w_r = static_cast<T>(s[11]);
  k.w_rdot = static_cast<T>(s[12]);
  k.w_w = static_cast<T>(s[13]);
  k.w_rel = static_cast<T>(s[14]);
  k.w_qddot = static_cast<T>(s[15]);
  k.w_minf = static_cast<T>(s[16]);
  k.w_fswitch = static_cast<T>(s[17]);
  k.wc = static_cast<T>(s[18]);
  k.com_z = static_cast<T>(s[19]);
  k.d1x = static_cast<T>(s[20]);
  k.d1y = static_cast<T>(s[21]);
  k.d2x = static_cast<T>(s[22]);
  k.d2y = static_cast<T>(s[23]);
  return k;
}

// The parameter rows of one member-node, packed:
// [mt, otg, oref(4), rdot_ref(3), w_ref(3), c_ref(nc), cdot_switch(nc)].
constexpr int kP_mt = 0, kP_otg = 1, kP_oref = 2, kP_rdot = 6, kP_w = 9,
              kP_cref = 12;

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

// Where entry e of the packed parameter row of member-node `row`
// (= b·(ns+1)+n) lives in device memory.
template <class S, typename T>
__device__ __forceinline__ const T* param_src(const Params<T>& P, size_t row,
                                              int e) {
  constexpr int nc = S::nc;
  if (e == kP_mt) return P.p[0] + row;
  if (e == kP_otg) return P.p[1] + row;
  if (e < kP_rdot) return P.p[2] + row * 4 + (e - kP_oref);
  if (e < kP_w) return P.p[3] + row * 3 + (e - kP_rdot);
  if (e < kP_cref) return P.p[4] + row * 3 + (e - kP_w);
  if (e < kP_cref + nc) return P.p[5] + row * nc + (e - kP_cref);
  return P.p[6] + row * nc + (e - kP_cref - nc);
}

// Lanes of one warp copy the packed parameter row of member-node `row`.
template <class S, typename T>
__device__ void load_params(const Params<T>& P, size_t row, int lane, T* out) {
  if (lane < Layout<S>::pw) out[lane] = *param_src<S>(P, row, lane);
}

// ---- the rigid-body rates of ẋ ----
//
// Every lane of a warp computes the node's geometry in its own registers —
// R = quat_to_rot(o), R I, Iw = R I Rᵀ, the cofactors C of Iw
// (Iw⁻¹ = C / det, as math/quat.py::solve3x3 forms them), det and Iw ω —
// from an x every lane reads: a few dozen independent multiply-adds that
// need no exchange between lanes, so a node's chain waits on no shared
// memory round trip or warp barrier for them. The contact forces and
// torques are summed over nc lanes with xor shuffles (contact q on lane
// q mod nc), and every lane then holds r̈, ω̇ and ȯ (`Rigid`).
template <typename T>
struct Geometry {
  T R[9], RI[9], Iw[9], C[9], det, h[3];
};

template <class S, typename T>
__device__ __forceinline__ Geometry<T> geometry(const T* x,
                                                const Consts<T>& k) {
  Geometry<T> g;
  quat_to_rot(x + 3, g.R);
  world_inertia(g.R, k.I, g.RI, g.Iw);
  g.det = adjugate3(g.Iw, g.C);
  const T* w = x + Layout<S>::i_w;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g.h[i] = g.Iw[i * 3] * w[0] + g.Iw[i * 3 + 1] * w[1] + g.Iw[i * 3 + 2] * w[2];
  return g;
}

template <typename T>
struct Rigid {
  T rdd[3], wd[3], od[4];
};

// r̈ = Σf / m − g e_z, ω̇ = Iw⁻¹ (τ − ω × Iw ω), ȯ = ½ (ω,0)⊗o —
// models/srbd.py::srbd_xdot's rigid rows. Every lane must call it (the
// shuffles); every lane gets the result.
template <class S, typename T>
__device__ __forceinline__ Rigid<T> rigid_rates(const T* x, const T* u,
                                                const Consts<T>& k,
                                                const Geometry<T>& g,
                                                int lane) {
  using L = Layout<S>;
  const int q = lane % S::nc;
  const T* f = u + 6 * q + 3;
  const T* cq = x + L::i_c + 3 * q;
  const T p0 = cq[0] - x[0], p1 = cq[1] - x[1], p2 = cq[2] - x[2];
  T v0 = f[0], v1 = f[1], v2 = f[2];
  T t0 = p1 * f[2] - p2 * f[1];
  T t1 = p2 * f[0] - p0 * f[2];
  T t2 = p0 * f[1] - p1 * f[0];
#pragma unroll
  for (int off = 1; off < S::nc; off <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, off);
    v1 += __shfl_xor_sync(0xffffffffu, v1, off);
    v2 += __shfl_xor_sync(0xffffffffu, v2, off);
    t0 += __shfl_xor_sync(0xffffffffu, t0, off);
    t1 += __shfl_xor_sync(0xffffffffu, t1, off);
    t2 += __shfl_xor_sync(0xffffffffu, t2, off);
  }
  const T* w = x + L::i_w;
  Rigid<T> r;
  r.rdd[0] = v0 / k.m_scaled;
  r.rdd[1] = v1 / k.m_scaled;
  r.rdd[2] = v2 / k.m_scaled - T(9.81);
  const T b0 = t0 - (w[1] * g.h[2] - w[2] * g.h[1]);
  const T b1 = t1 - (w[2] * g.h[0] - w[0] * g.h[2]);
  const T b2 = t2 - (w[0] * g.h[1] - w[1] * g.h[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r.wd[i] = (g.C[i * 3] * b0 + g.C[i * 3 + 1] * b1 + g.C[i * 3 + 2] * b2) / g.det;
  quat_rate(x + 3, w, r.od);
  return r;
}

// The integrator rows of ẋ (ṙ, ċ, c̈) for index j, or false if j is a
// rigid-body row.
template <class S, typename T>
__device__ __forceinline__ bool integrator_row(int j, const T* x, const T* u,
                                               T* out) {
  using L = Layout<S>;
  if (j < 3) {
    *out = x[L::i_rdot + j];                     // ṙ
    return true;
  }
  if (j >= 7 && j < L::i_rdot) {
    *out = x[L::i_cdot + (j - 7)];               // ċ
    return true;
  }
  if (j >= L::i_cdot) {
    const int e = j - L::i_cdot;                 // c̈ from u
    *out = u[6 * (e / 3) + e % 3];
    return true;
  }
  return false;
}

// Entry e of (r̈, ω̇) — residual rows 15..20 — from the registers.
template <typename T>
__device__ __forceinline__ T accel_entry(const Rigid<T>& r, int e) {
  return e == 0 ? r.rdd[0] : e == 1 ? r.rdd[1] : e == 2 ? r.rdd[2]
       : e == 3 ? r.wd[0] : e == 4 ? r.wd[1] : r.wd[2];
}

// Row j of ẋ(x, u): an integrator row, or a rigid row from the registers.
template <class S, typename T>
__device__ __forceinline__ T xdot_row(int j, const T* x, const T* u,
                                      const Rigid<T>& r) {
  using L = Layout<S>;
  T v;
  if (integrator_row<S>(j, x, u, &v)) return v;
  if (j < 7) {
    const int e = j - 3;
    return e == 0 ? r.od[0] : e == 1 ? r.od[1] : e == 2 ? r.od[2] : r.od[3];
  }
  return accel_entry(r, j - L::i_rdot);           // r̈ then ω̇ (contiguous)
}

// ---- the step ----

// Rows j = lane and lane + 32 (nx ≤ 64) of x⁺ = step(x, u) into out[0..1]
// (0 past nx), from the rates r1 at x. Under RK2 and RK4 the lanes write
// each later stage point x + c_s·dt·k_{s−1} into the warp's scratch `xs`
// (nx values), form its geometry and rates on every lane as at x, and call
// stage(s, xs, g, rig) there (s = 1 … stages − 1; K4 forms its ∂ω̇ columns
// at the stage point); the k's are summed as ocp/integrators.py sums them.
// Every lane must call it (the shuffles, the warp barriers).
template <class S, typename T, class StageFn>
__device__ __forceinline__ void step_rows(const T* x, const T* u,
                                          const Rigid<T>& r1,
                                          const Consts<T>& k, int lane, T* xs,
                                          T* out, StageFn stage) {
  using St = typename S::Step;
  T kk[2], acc[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = lane + 32 * c;
    kk[c] = j < S::nx ? xdot_row<S>(j, x, u, r1) : T(0);
    acc[c] = kk[c];
  }
  if constexpr (St::stages > 1) {
#pragma unroll 1
    for (int s = 1; s < St::stages; ++s) {
      const T cdt = full_stage<St>(s) ? k.dt : T(0.5) * k.dt;
      __syncwarp();                                 // readers of xs are done
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < S::nx) xs[j] = x[j] + cdt * kk[c];
      }
      __syncwarp();
      const Geometry<T> g = geometry<S>(xs, k);
      const Rigid<T> rig = rigid_rates<S>(xs, u, k, g, lane);
      stage(s, xs, g, rig);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        kk[c] = j < S::nx ? xdot_row<S>(j, xs, u, rig) : T(0);
        if constexpr (St::stages == 4)
          acc[c] = s == 3 ? acc[c] + kk[c] : acc[c] + T(2) * kk[c];
      }
    }
    __syncwarp();                                   // xs free again
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = lane + 32 * c;
    if (j < S::nx) {
      if constexpr (St::stages == 4)
        out[c] = x[j] + (k.dt / T(6)) * acc[c];
      else
        out[c] = x[j] + k.dt * kk[c];
    } else {
      out[c] = T(0);
    }
  }
}

// The scratch a warp needs for step_rows' stage points: nx values under
// RK2 and RK4, none under Euler.
template <class S>
__host__ __device__ constexpr int stage_scratch() {
  return S::Step::stages > 1 ? S::nx : 0;
}

// step_rows with nothing to do at the stage points.
template <class S, typename T>
__device__ __forceinline__ void step_rows(const T* x, const T* u,
                                          const Rigid<T>& r1,
                                          const Consts<T>& k, int lane, T* xs,
                                          T* out) {
  step_rows<S>(x, u, r1, k, lane, xs, out,
               [](int, const T*, const Geometry<T>&, const Rigid<T>&) {});
}

// ---- residual rows ----

// Row j of o ⊗ oref (x, y, z, w), problems/srbd.py's orientation error.
template <typename T>
__device__ __forceinline__ T quat_err(int j, const T* o, const T* q) {
  switch (j) {
    case 0: return (o[3] * q[0] + q[3] * o[0]) + (o[1] * q[2] - o[2] * q[1]);
    case 1: return (o[3] * q[1] + q[3] * o[1]) + (o[2] * q[0] - o[0] * q[2]);
    case 2: return (o[3] * q[2] + q[3] * o[2]) + (o[0] * q[1] - o[1] * q[0]);
    default: return o[3] * q[3] - ((o[0] * q[0] + o[1] * q[1]) + o[2] * q[2]);
  }
}

// Foot-pair columns of tracking row g ∈ [11, 15): the row is
// w_rel·((−c[a] + c[b]) − d), a and b offsets into c — contacts 0 and cm
// (rows 11, 12), cm − 1 and nc − 1 (rows 13, 14), as
// srbd_horizon_tpu/problems/srbd.py:123-124, 163-166 pair them (on point
// feet: 0 with 1, and 0 with 3).
template <class S>
__device__ __forceinline__ void rel_cols(int g, int* a, int* b) {
  const int ax = (g % 2 == 1) ? 1 : 0;              // rows 11, 13: y
  *a = (g < 13 ? 0 : 3 * (S::cm - 1)) + ax;
  *b = (g < 13 ? 3 * S::cm : 3 * (S::nc - 1)) + ax;
}

// Row g < 15 of the tracking residual, with tracking mask mt (the terminal
// residual when mt = 1).
template <class S, typename T>
__device__ T tracking_row(int g, const T* x, const T* p, T mt,
                          const Consts<T>& k) {
  using L = Layout<S>;
  if (g == 0) return (mt * k.w_r) * (x[2] - k.com_z);
  if (g < 4) return (mt * p[kP_otg]) * quat_err(g - 1, x + 3, p + kP_oref);
  if (g == 4) return (mt * p[kP_otg]) * (quat_err(3, x + 3, p + kP_oref) - T(1));
  if (g < 8) return (mt * k.w_rdot) * (x[L::i_rdot + g - 5] - p[kP_rdot + g - 5]);
  if (g < 11) return (mt * k.w_w) * (x[L::i_w + g - 8] - p[kP_w + g - 8]);
  int a, b;
  rel_cols<S>(g, &a, &b);
  const T* c = x + L::i_c;
  const T dd = g == 11 ? k.d1y : g == 12 ? k.d1x : g == 13 ? k.d2y : k.d2x;
  return (mt * k.w_rel) * ((-c[a] + c[b]) - dd);
}

// Row q of √w_c · stage_eq at (x, p) (stage row n_res + q). Point feet
// (cm = 1) have no relative-velocity rows (n_rv = 0).
template <class S, typename T>
__device__ T eq_row(int q, const T* x, const T* p, const Consts<T>& k) {
  using L = Layout<S>;
  constexpr int nc = S::nc;
  const T* cdot = x + L::i_cdot;
  if constexpr (L::n_rv > 0) {
    constexpr int per = 2 * (S::cm - 1);
    if (q < L::n_rv) {
      const int base = (q / per) * S::cm, rem = q % per;
      const int i = rem / 2 + 1, ax = rem % 2;
      return k.wc * (cdot[3 * base + ax] - cdot[3 * (base + i) + ax]);
    }
  }
  q -= L::n_rv;
  T h;
  if (q < nc) {
    h = x[L::i_c + 3 * q + 2] - p[kP_cref + q];
  } else {
    q -= nc;
    h = p[kP_cref + nc + q / 2] * cdot[3 * (q / 2) + q % 2];
  }
  return k.wc * h;
}

// The squares of the input rows of column l of u (c̈ᵢ, or fᵢ and its
// switch row).
template <class S, typename T>
__device__ __forceinline__ T input_sq(int l, const T* u, const T* p,
                                      const Consts<T>& k) {
  const bool accel = l % 6 < 3;
  const T ul = u[l];
  const T v1 = (accel ? k.w_qddot : k.w_minf) * ul;
  const T v2 = accel ? T(0)
                     : (k.w_fswitch * (T(1) - p[kP_cref + S::nc + l / 6])) * ul;
  return v1 * v1 + v2 * v2;
}

// This lane's share of ‖ρ(x, u, p)‖² over the stage rows, in passes that
// keep the lanes of a warp on few paths. Up to 32 inputs (nu ≤ 32), two
// passes: lane l < nu takes the input rows of column l, the next lanes
// the first equality rows (up to 32 − nu of them; on the point-feet biped
// all six, and lanes 18..31 take none); then lanes 0..14 the tracking
// rows, lanes 15..20 the r̈ and ω̇ rows (from `r`), the next lanes the
// remaining equality rows. Past 32 inputs (the square-feet biped's 48),
// three: lane l takes the input rows of columns l and l + 32 (< nu); then
// lanes 0..14 the tracking rows, 15..20 r̈ and ω̇, 21..31 the first 11
// equality rows; then lane l the equality row 11 + l, while any are left.
// Every lane must call it; the sum over the warp is the node's cost.
template <class S, typename T>
__device__ __forceinline__ T stage_sq_lane(int lane, const T* x, const T* u,
                                           const Rigid<T>& r, const T* p,
                                           const Consts<T>& k) {
  using L = Layout<S>;
  constexpr int n_eq = S::n_rho - L::n_res;
  if constexpr (S::nu > 32) {
    constexpr int eq2 = n_eq < 32 - 21 ? n_eq : 32 - 21;    // pass two
    static_assert(S::nu <= 64 && n_eq - eq2 <= 32,
                  "the three row passes cover the stage rows");
    T acc = input_sq<S>(lane, u, p, k);
    if (lane + 32 < S::nu) acc += input_sq<S>(lane + 32, u, p, k);
    if (lane < 15) {
      const T v = tracking_row<S>(lane, x, p, p[kP_mt], k);
      acc += v * v;
    } else if (lane < 21) {
      const T v = k.w_qddot * accel_entry(r, lane - 15);
      acc += v * v;
    } else if (lane < 21 + eq2) {
      const T v = eq_row<S>(lane - 21, x, p, k);
      acc += v * v;
    }
    if (lane < n_eq - eq2) {
      const T v = eq_row<S>(eq2 + lane, x, p, k);
      acc += v * v;
    }
    return acc;
  } else {
    constexpr int eq1 = 32 - S::nu < n_eq ? 32 - S::nu : n_eq;   // pass one
    static_assert(eq1 >= 0 && n_eq - eq1 <= 32 - 21,
                  "the two row passes cover the stage rows");
    T acc;
    if (lane < S::nu) {
      acc = input_sq<S>(lane, u, p, k);
    } else if (S::nu + eq1 == 32 || lane < S::nu + eq1) {
      const T v = eq_row<S>(lane - S::nu, x, p, k);
      acc = v * v;
    } else {
      acc = T(0);
    }
    if (lane < 15) {
      const T v = tracking_row<S>(lane, x, p, p[kP_mt], k);
      acc += v * v;
    } else if (lane < 21) {
      const T v = k.w_qddot * accel_entry(r, lane - 15);
      acc += v * v;
    } else if (lane < 21 + n_eq - eq1) {
      const T v = eq_row<S>(eq1 + lane - 21, x, p, k);
      acc += v * v;
    }
    return acc;
  }
}

// Row g of the stacked stage residual ρ at (x, u, p); xd holds ẋ(x, u)
// (r̈ and ω̇ are read from it).
template <class S, typename T>
__device__ T stage_rho_row(int g, const T* x, const T* u, const T* xd,
                           const T* p, const Consts<T>& k) {
  using L = Layout<S>;
  constexpr int nc = S::nc;
  if (g < 15) return tracking_row<S>(g, x, p, p[kP_mt], k);
  if (g < 18) return k.w_qddot * xd[L::i_rdot + g - 15];
  if (g < 21) return k.w_qddot * xd[L::i_w + g - 18];
  if (g < 21 + 3 * nc) {
    const int q = g - 21;
    return k.w_qddot * u[6 * (q / 3) + q % 3];
  }
  if (g < 21 + 6 * nc) {
    const int q = g - 21 - 3 * nc;
    return k.w_minf * u[6 * (q / 3) + 3 + q % 3];
  }
  if (g < L::n_res) {
    const int q = g - 21 - 6 * nc;
    return (k.w_fswitch * (T(1) - p[kP_cref + nc + q / 3])) *
           u[6 * (q / 3) + 3 + q % 3];
  }
  return eq_row<S>(g - L::n_res, x, p, k);
}

// ---- a given plan's node, evaluated (srbd_evaluate, K13) ----

// Width of parameter tensor t (kParams of them, in the order of
// make_params) and its offset in the packed parameter row.
template <class S>
__host__ __device__ constexpr int param_dim(int t) {
  return t < 2 ? 1 : t == 2 ? 4 : t < 5 ? 3 : S::nc;
}

template <class S>
__host__ __device__ constexpr int param_off(int t) {
  int o = 0;
  for (int i = 0; i < t; ++i) o += param_dim<S>(i);
  return o;
}

template <class S>
constexpr bool packed_row_ok() {
  return param_off<S>(kParams) == Layout<S>::pw &&
         param_off<S>(3) == kP_rdot && param_off<S>(5) == kP_cref;
}
static_assert(packed_row_ok<KangarooShape>() && packed_row_ok<QuadShape>() &&
                  packed_row_ok<PointFeetShape>() &&
                  packed_row_ok<SquareFeetShape>() &&
                  packed_row_ok<LineFeetQuadShape>(),
              "packed parameter row");

// A stage node's rigid-body rates, from the prepass: r̈ (3), ω̇ (3), ȯ (4).
constexpr int kRates = 10;

// The prepass: one lane computes one stage node's rigid-body rates
// (geometry and the rows of rigid_rates, the contact sums in a loop) into
// `out` — r̈, ω̇, ȯ. One warp thus runs the geometry of 32 nodes in the
// instructions of one, where every node's warp ran it whole.
template <class S, typename T>
__device__ __forceinline__ void node_rates(const T* x, const T* u,
                                           const Consts<T>& k, T* out) {
  using L = Layout<S>;
  const Geometry<T> g = geometry<S>(x, k);
  T v0 = T(0), v1 = T(0), v2 = T(0), t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll
  for (int q = 0; q < S::nc; ++q) {
    const T* f = u + 6 * q + 3;
    const T* cq = x + L::i_c + 3 * q;
    const T p0 = cq[0] - x[0], p1 = cq[1] - x[1], p2 = cq[2] - x[2];
    v0 += f[0];
    v1 += f[1];
    v2 += f[2];
    t0 += p1 * f[2] - p2 * f[1];
    t1 += p2 * f[0] - p0 * f[2];
    t2 += p0 * f[1] - p1 * f[0];
  }
  const T* w = x + L::i_w;
  const T b0 = t0 - (w[1] * g.h[2] - w[2] * g.h[1]);
  const T b1 = t1 - (w[2] * g.h[0] - w[0] * g.h[2]);
  const T b2 = t2 - (w[0] * g.h[1] - w[1] * g.h[0]);
  out[0] = v0 / k.m_scaled;
  out[1] = v1 / k.m_scaled;
  out[2] = v2 / k.m_scaled - T(9.81);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[3 + i] = (g.C[i * 3] * b0 + g.C[i * 3 + 1] * b1 + g.C[i * 3 + 2] * b2) / g.det;
  quat_rate(x + 3, w, out + 6);
}

// One warp evaluates stage node (x, u, p) from its prepass `rates`: this
// lane's share of Σ‖ρ‖² (returned) and rows lane and lane + 32 of
// step(x, u) into step (0 past nx; `xs` the warp's stage point under RK2
// and RK4). Every lane must call it.
template <class S, typename T>
__device__ __forceinline__ T eval_stage(int lane, const T* x, const T* u,
                                        const T* p, const T* rates,
                                        const Consts<T>& k, T* xs,
                                        T (&step)[2]) {
  Rigid<T> rig;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rig.rdd[i] = rates[i];
    rig.wd[i] = rates[3 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) rig.od[i] = rates[6 + i];
  const T acc = stage_sq_lane<S>(lane, x, u, rig, p, k);
  step_rows<S>(x, u, rig, k, lane, xs, step);
  return acc;
}

// This lane's share of the terminal node's ‖ρ_N(x, p)‖².
template <class S, typename T>
__device__ __forceinline__ T eval_terminal(int lane, const T* x, const T* p,
                                           const Consts<T>& k) {
  if (lane >= S::nt) return T(0);
  const T v = tracking_row<S>(lane, x, p, T(1), k);
  return v * v;
}

}  // namespace srbd
