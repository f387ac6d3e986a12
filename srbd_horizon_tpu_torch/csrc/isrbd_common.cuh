// Device code shared by K5 (csrc/isrbd_linearize.cu), K6 and
// isrbd_evaluate (csrc/isrbd_rollout.cu): the sizes they are compiled for,
// the isrbd problem's constants, its double integrator stepped by RK2, and
// the rows of the AL inner problem's stage and terminal stacks
// (srbd_horizon_tpu_torch/problems/isrbd_al.py), evaluated in passes laid
// out so that the lanes of one pass take one path, and a given plan's
// node evaluated (isrbd_evaluate's body, which K13 in csrc/linear_trial.cu
// runs too). All of them evaluate the dynamics and the rows through this
// one copy; the rotation,
// inertia and quaternion-rate helpers come from csrc/rigid_common.cuh,
// which the SRBD kernels share.
//
// Layouts (srbd_horizon_tpu_torch/problems/isrbd.py, nc contacts):
//   x = [r(3), o(4, xyzw), c(3nc), ṙ(3), ω(3), ċ(3nc)]         nx = 13 + 6nc
//   u = [r̈(3), ω̇(3), c̈₀(3), f₀(3), …, c̈ₙ꜀₋₁(3), fₙ꜀₋₁(3)]       nu = 6 + 6nc
// Stage stack ρ (n_rho rows):
//   [rz, o(4), ṙ(3), ω(3), q̈(6+3nc), rel(4), f(3nc)            outer residual
//    | relvel, cz(nc), NE(6), LIP(3), lipzone(4)                AL equalities
//    | cone ub(5nc), cone lb(5nc) | x-box ub, lb (nx each) | u-box ub, lb]
// Terminal stack (n_term rows):
//   [rz, o(4), ṙ(3), ω(3), rel(4) | relvel, cz(nc), lipzone(4) | x-box ub, lb]
// An equality row j is √(ρw_j)·S_j·h_j + λ_j/√(ρw_j); a one-sided row is
// √ρ·[bound finite]·max(0, ±(v − bound) + μ/ρ), with the bound replaced by
// 0 before any arithmetic where it is ±inf.
//
// Kernels that share a warp's node keep x and u side by side in shared
// memory ("xu", nx + nu values) and the node's parameters as one packed
// row (`Layout::n_par` values, the 21 tensors of PARAM_KEYS back to back).

#pragma once

#include "rigid_common.cuh"

namespace isrbd {

using namespace rigid;

// The sizes K5, K6, isrbd_evaluate, K7 and K8 are compiled for, one struct
// a robot: the AL inner problem of build_isrbd_problem with the Kangaroo's
// line feet (nc=4 contacts, two a leg) and with the quadruped's point feet
// (nc=4, one a leg). kernels/isrbd_linearize.py::KERNEL_SHAPES holds the
// same numbers in the same order (a test reads them from here); on CUDA
// tensors of any other sizes the wrappers raise. The row counts are those
// of RiccatiRows.from_ocp of the inner OCP (the rows K5 emits and K1
// reads; K1's IsrbdAlShape and QuadAlShape).
struct KangarooAlShape {
  static constexpr int nc = 4, cm = 2, n_legs = 2, nx = 37, nu = 30, n_rho = 240, n_term = 101, n_eq = 21, n_eq_T = 12, n_in = 20, n_par = 357, n_rx = 19, n_ru = 37, n_gx = 60, n_gu = 103, n_b = 9, n_uc = 18;
};

struct QuadAlShape {
  static constexpr int nc = 4, cm = 1, n_legs = 4, nx = 37, nu = 30, n_rho = 236, n_term = 97, n_eq = 17, n_eq_T = 8, n_in = 20, n_par = 349, n_rx = 19, n_ru = 37, n_gx = 56, n_gu = 103, n_b = 9, n_uc = 18;
};

// A launcher's answer for sizes no shape above has.
constexpr int kUnknownShape = -2;

// fn(S{}) for the shape at `index` in the order above (the order of
// KERNEL_SHAPES), or kUnknownShape.
template <class Fn>
inline int with_shape(int index, Fn fn) {
  switch (index) {
    case 0: return fn(KangarooAlShape{});
    case 1: return fn(QuadAlShape{});
    default: return kUnknownShape;
  }
}

// fn(S{}) for the shape of this contact topology (nc contacts of cm
// points on n_legs legs), or kUnknownShape: the topology fixes nx, nu and
// every row count, so it picks the shape.
template <class Fn>
inline int with_topology(int nc, int cm, int n_legs, Fn fn) {
  if (nc == KangarooAlShape::nc && cm == KangarooAlShape::cm &&
      n_legs == KangarooAlShape::n_legs)
    return fn(KangarooAlShape{});
  if (nc == QuadAlShape::nc && cm == QuadAlShape::cm &&
      n_legs == QuadAlShape::n_legs)
    return fn(QuadAlShape{});
  return kUnknownShape;
}

// Offsets and counts that follow from a shape.
template <class S>
struct Layout {
  static constexpr int nc = S::nc, nx = S::nx, nu = S::nu;
  static constexpr int n_xu = nx + nu;
  static constexpr int i_c = 7, i_rdot = 7 + 3 * nc, i_w = 10 + 3 * nc,
                       i_cdot = 13 + 3 * nc;
  static constexpr int n_relvel = 2 * S::n_legs * (S::cm - 1);
  static constexpr int n_qddot = 6 + 3 * nc;           // r̈, ω̇, c̈ rows
  static constexpr int o_rel = 11 + n_qddot;           // foot-pair rows
  static constexpr int o_minf = o_rel + 4;             // force rows
  static constexpr int n_res = o_minf + 3 * nc;        // outer residual
  static constexpr int o_cone = n_res + S::n_eq, o_xbox = o_cone + 2 * S::n_in,
                       o_ubox = o_xbox + 2 * nx;
  static constexpr int n_box = 2 * nx + 2 * nu;        // x-box and u-box rows
  static constexpr int n_track = 15;                   // outer terminal rows
  static constexpr int o_tbox = n_track + S::n_eq_T;   // terminal x-box rows
  // equality segments: rel-vel, cz, Newton, Euler, LIP, LIP zone
  static constexpr int q_cz = n_relvel, q_newton = q_cz + nc,
                       q_euler = q_newton + 3, q_lip = q_euler + 3,
                       q_zone = q_lip + 3;
  // the packed parameter row (problems/isrbd_al.py::PARAM_KEYS)
  static constexpr int p_mt = 0, p_wo = 1, p_rdot = 2, p_wref = 5,
                       p_cref = 8, p_msrbd = p_cref + nc, p_mlip = p_msrbd + 1,
                       p_mzone = p_mlip + 1, p_rho = p_mzone + 1,
                       p_lam = p_rho + 1, p_lamT = p_lam + S::n_eq,
                       p_muub = p_lamT + S::n_eq_T, p_mulb = p_muub + S::n_in,
                       p_xlb = p_mulb + S::n_in, p_xub = p_xlb + nx,
                       p_muxub = p_xub + nx, p_muxlb = p_muxub + nx,
                       p_ulb = p_muxlb + nx, p_uub = p_ulb + nu,
                       p_muuub = p_uub + nu, p_muulb = p_muuub + nu,
                       n_par = p_muulb + nu;
  static_assert(nx == 13 + 6 * nc && nu == 6 + 6 * nc, "not an isrbd layout");
  static_assert(S::n_eq == q_zone + 4 && S::n_eq_T == n_relvel + nc + 4,
                "equality rows");
  static_assert(S::n_in == 5 * nc && S::n_rho == o_ubox + 2 * nu &&
                    S::n_term == o_tbox + 2 * nx && n_par == S::n_par,
                "stack rows and parameter row");
  static_assert(S::n_eq <= 32 && S::n_eq_T <= 32 && n_xu <= 96,
                "one equality row a lane; x and u in three passes");
};

// host scalars, in this order: dt, m, inertia (9, row-major), η², w_rz,
// w_rdot, w_w, w_rel, w_qddot, w_minf, com_z, d1x, d1y, d2x, d2y, the cone
// faces A_fc (15, row-major), the foot-pair indices (4); then the row
// scales S (n_eq), √w (n_eq), S_T (n_eq_T), √w_T (n_eq_T)
// (kernels/isrbd_linearize.py::kernel_scalars)
constexpr int kFixedScalars = 42;
// parameter tensors, each (B, ns+1, dim), in the order of
// problems/isrbd_al.py::PARAM_KEYS
constexpr int kParams = 21;
enum ParamIndex {
  P_MT = 0, P_WO, P_RDOT, P_WREF, P_CREF, P_MSRBD, P_MLIP, P_MZONE, P_RHO,
  P_LAM, P_LAMT, P_MUUB, P_MULB, P_XLB, P_XUB, P_MUXUB, P_MUXLB, P_ULB,
  P_UUB, P_MUUUB, P_MUULB
};

// Width of parameter tensor t at shape S; its entries start at
// param_off<S>(t) of the packed row.
template <class S>
__host__ __device__ constexpr int param_dim(int t) {
  return t == P_RDOT || t == P_WREF ? 3
         : t == P_CREF              ? S::nc
         : t == P_LAM               ? S::n_eq
         : t == P_LAMT              ? S::n_eq_T
         : t == P_MUUB || t == P_MULB ? S::n_in
         : t >= P_XLB && t <= P_MUXLB ? S::nx
         : t >= P_ULB               ? S::nu
                                    : 1;
}

template <class S>
__host__ __device__ constexpr int param_off(int t) {
  int o = 0;
  for (int i = 0; i < t; ++i) o += param_dim<S>(i);
  return o;
}

template <class S>
constexpr bool packed_row_matches() {
  using L = Layout<S>;
  return param_off<S>(kParams) == L::n_par && param_off<S>(P_RHO) == L::p_rho &&
         param_off<S>(P_XUB) == L::p_xub && param_off<S>(P_MUULB) == L::p_muulb;
}
static_assert(packed_row_matches<KangarooAlShape>() &&
                  packed_row_matches<QuadAlShape>(),
              "packed parameter row");

// (the template parameter is Sh: S names the row scales)
template <class Sh, typename T>
struct Consts {
  int fpi[4];
  T dt, m;
  T I[9];
  T eta2, w_rz, w_rdot, w_w, w_rel, w_qddot, w_minf, com_z;
  T d1x, d1y, d2x, d2y;
  T A_fc[15];
  T S[Sh::n_eq], sqw[Sh::n_eq], S_T[Sh::n_eq_T], sqw_T[Sh::n_eq_T];
};

template <class S, typename T>
inline Consts<S, T> make_consts(const double* s) {
  Consts<S, T> k;
  k.dt = static_cast<T>(s[0]);
  k.m = static_cast<T>(s[1]);
  for (int i = 0; i < 9; ++i) k.I[i] = static_cast<T>(s[2 + i]);
  k.eta2 = static_cast<T>(s[11]);
  k.w_rz = static_cast<T>(s[12]);
  k.w_rdot = static_cast<T>(s[13]);
  k.w_w = static_cast<T>(s[14]);
  k.w_rel = static_cast<T>(s[15]);
  k.w_qddot = static_cast<T>(s[16]);
  k.w_minf = static_cast<T>(s[17]);
  k.com_z = static_cast<T>(s[18]);
  k.d1x = static_cast<T>(s[19]);
  k.d1y = static_cast<T>(s[20]);
  k.d2x = static_cast<T>(s[21]);
  k.d2y = static_cast<T>(s[22]);
  for (int i = 0; i < 15; ++i) k.A_fc[i] = static_cast<T>(s[23 + i]);
  for (int i = 0; i < 4; ++i) k.fpi[i] = static_cast<int>(s[38 + i]);
  constexpr int ne = S::n_eq, nt = S::n_eq_T;
  const double* r = s + kFixedScalars;
  for (int i = 0; i < ne; ++i) {
    k.S[i] = static_cast<T>(r[i]);
    k.sqw[i] = static_cast<T>(r[ne + i]);
  }
  for (int i = 0; i < nt; ++i) {
    k.S_T[i] = static_cast<T>(r[2 * ne + i]);
    k.sqw_T[i] = static_cast<T>(r[2 * ne + nt + i]);
  }
  return k;
}

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

// Lanes of one warp load the packed parameter row of member-node `row`
// (= b·(ns+1)+n) into `out`, tensor after tensor; every width and offset
// is a constant, so the loops unroll into predicated loads.
template <class S, typename T>
__device__ __forceinline__ void load_params(const Params<T>& P, size_t row,
                                            int lane, T* out) {
#pragma unroll
  for (int t = 0; t < kParams; ++t) {
    const int dim = param_dim<S>(t);
    const T* src = P.p[t] + row * dim;
#pragma unroll
    for (int e = 0; e < dim; e += 32)
      if (e + lane < dim) out[param_off<S>(t) + e + lane] = src[e + lane];
  }
}

// Input column of contact q's acceleration (axis j) and force.
__host__ __device__ constexpr int col_cddot(int q, int j) { return 6 + 6 * q + j; }
__host__ __device__ constexpr int col_f(int q, int j) { return 9 + 6 * q + j; }

// max(0, v) that keeps a NaN (as torch.clamp and jnp.maximum do).
template <typename T>
__device__ __forceinline__ T relu_nan(T v) {
  return v > T(0) ? v : (v != v ? v : T(0));
}

// d max(0, a)/da: 1 above 0, 0 below and ½ at exactly 0, as jax.jacfwd
// takes jnp.maximum at a tie (a swing foot's force that is exactly zero
// under a zero multiplier sits on one).
template <typename T>
__device__ __forceinline__ T relu_slope(T a) {
  return a > T(0) ? T(1) : (a == T(0) ? T(0.5) : T(0));
}

// ---- the node's geometry and the RK2 step, in registers ----
//
// Every lane of a warp computes them from the x (and u) every lane reads:
// a few dozen independent multiply-adds that need no exchange between
// lanes, so no lane carries them alone and no shared-memory round trip
// sits in a node's chain for them.

// R = quat_to_rot(o), R I, Iw = R I Rᵀ and Iw ω (the Euler rows).
template <typename T>
struct Geometry {
  T R[9], RI[9], Iw[9], h[3];
};

template <class S, typename T>
__device__ __forceinline__ Geometry<T> geometry(const T* x,
                                                const Consts<S, T>& k) {
  using L = Layout<S>;
  Geometry<T> g;
  quat_to_rot(x + 3, g.R);
  world_inertia(g.R, k.I, g.RI, g.Iw);
  const T* w = x + L::i_w;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g.h[i] = g.Iw[i * 3] * w[0] + g.Iw[i * 3 + 1] * w[1] + g.Iw[i * 3 + 2] * w[2];
  return g;
}

// The quaternion rows of the RK2 step, once a node: ȯ = ½(ω,0)⊗o at x,
// the midpoint's o and ω (x_mid = x + dt/2·ẋ(x, u)) and ȯ at the midpoint.
template <typename T>
struct Rates {
  T od[4], om[4], wm[3], odm[4];
};

template <class S, typename T>
__device__ __forceinline__ Rates<T> rates(const T* xu, T hdt) {
  using L = Layout<S>;
  Rates<T> r;
  const T* u = xu + L::nx;
  quat_rate(xu + 3, xu + L::i_w, r.od);
#pragma unroll
  for (int i = 0; i < 4; ++i) r.om[i] = xu[3 + i] + hdt * r.od[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) r.wm[i] = xu[L::i_w + i] + hdt * u[3 + i];
  quat_rate(r.om, r.wm, r.odm);
  return r;
}

// Row j of rk2(x, u) = x + dt·ẋ(x_mid, u) of the double integrator with
// floating base, ẋ = [ṙ, ȯ, ċ, r̈, ω̇, c̈] (accelerations are inputs); the
// velocity rows of x_mid are x + dt/2·(their inputs).
template <class S, typename T>
__device__ __forceinline__ T step_row(int j, const T* xu, const Rates<T>& r,
                                      T hdt, T dt) {
  using L = Layout<S>;
  const T* u = xu + L::nx;
  T v;
  if (j < 3) {
    v = xu[L::i_rdot + j] + hdt * u[j];
  } else if (j < 7) {
    v = j == 3 ? r.odm[0] : j == 4 ? r.odm[1] : j == 5 ? r.odm[2] : r.odm[3];
  } else if (j < L::i_rdot) {
    const int e = j - 7;
    v = xu[L::i_cdot + e] + hdt * u[col_cddot(e / 3, e % 3)];
  } else if (j < L::i_cdot) {
    v = u[j - L::i_rdot];                              // r̈, ω̇
  } else {
    const int e = j - L::i_cdot;
    v = u[col_cddot(e / 3, e % 3)];
  }
  return xu[j] + dt * v;
}

// ---- the rows of the stacks, in passes ----

// One-sided row on v ≤ bound (up) or bound ≤ v: returns the pre-activation
// ±(v − bound) + μ/ρ and sets *scale = √ρ·[bound finite]; the row is
// scale·max(0, a) and its slope along v ±scale·relu_slope(a).
template <typename T>
__device__ __forceinline__ T one_sided(T v, T bound, T mu, T rho, T sr, bool up,
                                       T* scale) {
  const bool fin = isfinite(bound);
  const T b = fin ? bound : T(0);
  *scale = sr * (fin ? T(1) : T(0));
  return (up ? v - b : b - v) + mu / rho;
}

// Box row s (0 ≤ s < 2nx + 2nu; stage row o_xbox + s, and for s < 2nx
// terminal row o_tbox + s): the index of v in xu and the parameter offsets
// of its bound and multiplier, packed v | bound << 8 | mu << 17 | up << 26.
template <class S>
__host__ __device__ constexpr int box_desc(int s) {
  using L = Layout<S>;
  const bool xs = s < 2 * L::nx;
  const int i = xs ? s : s - 2 * L::nx;
  const int n = xs ? L::nx : L::nu;
  const bool up = i < n;
  const int d = up ? i : i - n;
  const int bound = xs ? (up ? L::p_xub : L::p_xlb) : (up ? L::p_uub : L::p_ulb);
  const int mu = xs ? (up ? L::p_muxub : L::p_muxlb)
                    : (up ? L::p_muuub : L::p_muulb);
  return (xs ? d : L::nx + d) | (bound + d) << 8 | (mu + d) << 17 |
         (up ? 1 : 0) << 26;
}

// Value and slope of box row `desc` at the node (xu, p).
template <typename T>
__device__ __forceinline__ T box_row(int desc, const T* xu, const T* p, T rho,
                                     T sr, T* slope) {
  const bool up = (desc >> 26) & 1;
  T scale;
  const T a = one_sided(xu[desc & 0xff], p[(desc >> 8) & 0x1ff],
                        p[(desc >> 17) & 0x1ff], rho, sr, up, &scale);
  const T s = scale * relu_slope(a);
  *slope = up ? s : -s;
  return scale * relu_nan(a);
}

// The four foot-pair rows (y, x of pair 1; y, x of pair 2), unweighted.
template <class S, typename T>
__device__ __forceinline__ T rel_row(int g, const T* x, const Consts<S, T>& k) {
  const T* c = x + Layout<S>::i_c;
  const int a = k.fpi[g < 2 ? 0 : 1], b = k.fpi[g < 2 ? 2 : 3];
  const int ax = (g % 2 == 0) ? 1 : 0;
  const T dd = g == 0 ? k.d1y : g == 1 ? k.d1x : g == 2 ? k.d2y : k.d2x;
  return (-c[3 * a + ax] + c[3 * b + ax]) - dd;
}

// Tracking row g < 15 with mask mt (1 on the terminal stack): rz, o, ṙ, ω
// as (mt·w)·(x_i − ref), then the foot-pair rows.
template <class S, typename T>
__device__ __forceinline__ T track_row(int g, const T* x, const T* p, T mt,
                                       const Consts<S, T>& k) {
  using L = Layout<S>;
  if (g >= 11) return k.w_rel * rel_row(g - 11, x, k);
  const T w = g == 0 ? k.w_rz : g < 5 ? p[L::p_wo] : g < 8 ? k.w_rdot : k.w_w;
  const int xi = g == 0 ? 2 : g < 5 ? 2 + g : g < 8 ? L::i_rdot + g - 5 : L::i_w + g - 8;
  const T pref = p[g < 5 ? L::p_rdot : g < 8 ? L::p_rdot + g - 5 : L::p_wref + g - 8];
  const T ref = g == 0 ? k.com_z : g < 4 ? T(0) : g == 4 ? T(1) : pref;
  return (mt * w) * (x[xi] - ref);
}

// The rel-vel pair q of ċ: (the leg's first contact, its q-th other) on
// axis ax. Only shapes with rel-vel rows (cm > 1) call it: point feet
// have none, and their callers drop the branch with `if constexpr`.
template <class S>
__host__ __device__ constexpr int relvel_col(int q, bool first) {
  static_assert(S::cm > 1, "point feet have no rel-vel rows");
  constexpr int per = 2 * (S::cm - 1);
  return Layout<S>::i_cdot +
         3 * ((q / per) * S::cm + (first ? 0 : (q % per) / 2 + 1)) +
         (q % per) % 2;
}

// Unscaled equality h_q of the stage stack (before S and the AL fold).
template <class S, typename T>
__device__ __forceinline__ T stage_eq_h(int q, const T* xu, const T* p,
                                        const Geometry<T>& g,
                                        const Consts<S, T>& k) {
  using L = Layout<S>;
  constexpr int nc = L::nc;
  const T* x = xu;
  const T* u = xu + L::nx;
  if constexpr (L::n_relvel > 0) {
    if (q < L::q_cz) return x[relvel_col<S>(q, true)] - x[relvel_col<S>(q, false)];
  }
  if (q < L::q_newton) return x[L::i_c + 3 * (q - L::q_cz) + 2] - p[L::p_cref + q - L::q_cz];
  if (q < L::q_euler) {                          // Newton: m(r̈ + g) − Σf
    const int a = q - L::q_newton;
    T f = T(0);
#pragma unroll
    for (int c = 0; c < nc; ++c) f += u[col_f(c, a)];
    const T acc = a == 2 ? u[a] + T(9.81) : u[a];
    return p[L::p_msrbd] * (k.m * acc - f);
  }
  const T* r = x;
  const T* w = x + L::i_w;
  if (q < L::q_lip) {                            // Euler: Iw ω̇ + ω×Iw ω − Σ(c−r)×f
    const int a = q - L::q_euler, a1 = (a + 1) % 3, a2 = (a + 2) % 3;
    const T* wd = u + 3;
    const T I0 = a == 0 ? g.Iw[0] : a == 1 ? g.Iw[3] : g.Iw[6];
    const T I1 = a == 0 ? g.Iw[1] : a == 1 ? g.Iw[4] : g.Iw[7];
    const T I2 = a == 0 ? g.Iw[2] : a == 1 ? g.Iw[5] : g.Iw[8];
    const T h1 = a1 == 0 ? g.h[0] : a1 == 1 ? g.h[1] : g.h[2];
    const T h2 = a2 == 0 ? g.h[0] : a2 == 1 ? g.h[1] : g.h[2];
    const T Iwd = I0 * wd[0] + I1 * wd[1] + I2 * wd[2];
    const T wxh = w[a1] * h2 - w[a2] * h1;
    T tau = T(0);
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const T* cc = x + L::i_c + 3 * c;
      tau += (cc[a1] - r[a1]) * u[col_f(c, a2)] - (cc[a2] - r[a2]) * u[col_f(c, a1)];
    }
    return p[L::p_msrbd] * ((Iwd + wxh) - tau);
  }
  if (q < L::q_zone) {                           // LIP: m(r̈ − [η²(r − zmp) − g])
    const int a = q - L::q_lip;
    T zmp = T(0);
    if (a < 2) {
#pragma unroll
      for (int c = 0; c < nc; ++c) zmp += x[L::i_c + 3 * c + a];
      zmp = zmp / T(nc);
    }
    T lip = k.eta2 * (r[a] - zmp);
    if (a == 2) lip = lip - T(9.81);
    return p[L::p_mlip] * (k.m * (u[a] - lip));
  }
  const int a = q - L::q_zone;                   // LIP zone: r_z, ω
  return p[L::p_mzone] * (a == 0 ? x[2] - k.com_z : w[a - 1]);
}

// Unscaled terminal equality h_q: rel-vel, cz, LIP zone.
template <class S, typename T>
__device__ __forceinline__ T terminal_eq_h(int q, const T* x, const T* p,
                                           const Consts<S, T>& k) {
  using L = Layout<S>;
  if constexpr (L::n_relvel > 0) {
    if (q < L::q_cz) return x[relvel_col<S>(q, true)] - x[relvel_col<S>(q, false)];
  }
  if (q < L::q_cz + L::nc)
    return x[L::i_c + 3 * (q - L::q_cz) + 2] - p[L::p_cref + q - L::q_cz];
  const int a = q - L::q_cz - L::nc;
  return p[L::p_mzone] * (a == 0 ? x[2] - k.com_z : x[L::i_w + a - 1]);
}

// Input index and weight of outer residual row 11 + l (l < 18, q̈) or
// o_minf + l − 18 (l < 30, forces): both are w·u_i.
template <class S>
__host__ __device__ constexpr int usel_col(int l) {
  using L = Layout<S>;
  return l < 6 ? l : l < L::n_qddot ? col_cddot((l - 6) / 3, (l - 6) % 3)
                                     : col_f((l - L::n_qddot) / 3, (l - L::n_qddot) % 3);
}
template <class S>
__host__ __device__ constexpr int usel_row(int l) {
  using L = Layout<S>;
  return l < L::n_qddot ? 11 + l : L::o_minf + l - L::n_qddot;
}

// Every row of the inner stage stack at the node (xu, p), in passes that
// keep the lanes of a pass on one path: the box rows (five passes, one
// path: `box_row`), the cones (lanes 0..19, each the ub and lb row of one
// cone value), the q̈ and force rows (lanes 0..29, w·u_i), the tracking
// and foot-pair rows (lanes 0..14), the equality rows (lanes 0..n_eq−1,
// one fold over a per-segment h). `row(r, v)` receives row r's value;
// with kSlopes, `slope(i, s)` receives the slope of one-sided row
// o_cone + i along its v (cone lb rows excluded: their bound is −inf, so
// the slope is 0). Every lane must call it.
template <bool kSlopes, class S, typename T, class Row, class Slope>
__device__ __forceinline__ void stage_rows(int lane, const T* xu, const T* p,
                                           const Geometry<T>& g,
                                           const Consts<S, T>& k, Row&& row,
                                           Slope&& slope) {
  using L = Layout<S>;
  constexpr int n_in = S::n_in;
  const T* u = xu + L::nx;
  const T rho = p[L::p_rho];
  const T sr = sqrt(rho);
#pragma unroll
  for (int c = 0; c < (L::n_box + 31) / 32; ++c) {
    const int s = lane + 32 * c;
    if (s < L::n_box) {
      T sl;
      row(L::o_xbox + s, box_row(box_desc<S>(s), xu, p, rho, sr, &sl));
      if (kSlopes) slope(2 * n_in + s, sl);
    }
  }
  if (lane < n_in) {                             // cones: g ≤ 0, no lower bound
    const int q = lane;
    const T* A = k.A_fc + 3 * (q % 5);
    const T* f = u + col_f(q / 5, 0);
    const T v = A[0] * f[0] + A[1] * f[1] + A[2] * f[2];
    T scale;
    const T a = one_sided(v, T(0), p[L::p_muub + q], rho, sr, true, &scale);
    row(L::o_cone + q, scale * relu_nan(a));
    if (kSlopes) slope(q, scale * relu_slope(a));
    row(L::o_cone + n_in + q,
        (sr * T(0)) * relu_nan((T(0) - v) + p[L::p_mulb + q] / rho));
  }
  if (lane < L::n_qddot + 3 * L::nc)
    row(usel_row<S>(lane),
        (lane < L::n_qddot ? k.w_qddot : k.w_minf) * u[usel_col<S>(lane)]);
  if (lane < L::n_track)
    row(lane < 11 ? lane : L::o_rel + lane - 11, track_row(lane, xu, p, p[L::p_mt], k));
  if (lane < S::n_eq) {
    const int q = lane;
    const T srw = sr * k.sqw[q];
    row(L::n_res + q, srw * (k.S[q] * stage_eq_h(q, xu, p, g, k)) + p[L::p_lam + q] / srw);
  }
}

// Every row of the inner terminal stack at (x, p), the parameters of node
// ns: the x-box rows (three passes), the tracking rows with mask 1 and the
// terminal equality rows (one pass). Every lane must call it.
template <class S, typename T, class Row>
__device__ __forceinline__ void terminal_rows(int lane, const T* x, const T* p,
                                              const Consts<S, T>& k, Row&& row) {
  using L = Layout<S>;
  const T rho = p[L::p_rho];
  const T sr = sqrt(rho);
#pragma unroll
  for (int c = 0; c < (2 * L::nx + 31) / 32; ++c) {
    const int s = lane + 32 * c;
    if (s < 2 * L::nx) {
      T sl;
      row(L::o_tbox + s, box_row(box_desc<S>(s), x, p, rho, sr, &sl));
    }
  }
  if (lane < L::n_track) {
    row(lane, track_row(lane, x, p, T(1), k));
  } else if (lane < L::o_tbox) {
    const int q = lane - L::n_track;
    const T srw = sr * k.sqw_T[q];
    row(lane, srw * (k.S_T[q] * terminal_eq_h(q, x, p, k)) + p[L::p_lamT + q] / srw);
  }
}

// ---- a given plan's node, evaluated (isrbd_evaluate, K13) ----

// A stage node's geometry and rates, from the prepass: Iw (9), Iw ω (3)
// and ȯ at the RK2 midpoint (4), what the rows and the step read of them.
constexpr int kGeo = 16;

// The prepass: one lane forms one stage node's geometry and RK2 rates
// (geometry, rates) into `out`, the parts the rows and the step read. One
// warp thus runs the geometry of 32 nodes in the instructions of one,
// where every node's warp ran it whole.
template <class S, typename T>
__device__ __forceinline__ void node_geometry(const T* xu,
                                              const Consts<S, T>& k, T* out) {
  const Geometry<T> g = geometry(xu, k);
  const Rates<T> r = rates<S>(xu, T(0.5) * k.dt);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = g.Iw[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[9 + i] = g.h[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) out[12 + i] = r.odm[i];
}

// One warp evaluates stage node (xu, p) — u right after x — from its
// prepass geometry `gs`: this lane's share of Σ‖ρ‖² over the stage rows
// (returned) and rows lane and lane + 32 of rk2(x, u) into step (0 past
// nx). Every lane must call it.
template <class S, typename T>
__device__ __forceinline__ T eval_stage(int lane, const T* xu, const T* p,
                                        const T* gs, const Consts<S, T>& k,
                                        T (&step)[2]) {
  T acc = T(0);
  auto square = [&acc](int, T v) { acc += v * v; };
  const T hdt = T(0.5) * k.dt;
  Geometry<T> geo{};                               // stage_rows reads Iw, h
  Rates<T> rt{};                                   // step_row reads ȯ_mid
#pragma unroll
  for (int i = 0; i < 9; ++i) geo.Iw[i] = gs[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) geo.h[i] = gs[9 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) rt.odm[i] = gs[12 + i];
  stage_rows<false>(lane, xu, p, geo, k, square, [](int, T) {});
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = lane + 32 * c;
    step[c] = j < S::nx ? step_row<S>(j, xu, rt, hdt, k.dt) : T(0);
  }
  return acc;
}

// This lane's share of the terminal node's ‖ρ_N(x, p)‖².
template <class S, typename T>
__device__ __forceinline__ T eval_terminal(int lane, const T* x, const T* p,
                                           const Consts<S, T>& k) {
  T acc = T(0);
  terminal_rows(lane, x, p, k, [&acc](int, T v) { acc += v * v; });
  return acc;
}

}  // namespace isrbd
