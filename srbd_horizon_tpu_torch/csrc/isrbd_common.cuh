// Device code shared by K5 (csrc/isrbd_linearize.cu) and K6
// (csrc/isrbd_rollout.cu): the isrbd problem's constants, its double
// integrator, and the rows of the AL inner problem's stage and terminal
// stacks (srbd_horizon_tpu_torch/problems/isrbd_al.py). Both kernels
// evaluate the dynamics and the residual rows through this one copy; the
// rotation, inertia and quaternion-rate helpers come from
// csrc/rigid_common.cuh, which the SRBD kernels share.
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

#pragma once

#include "rigid_common.cuh"

namespace isrbd {

using namespace rigid;

constexpr int kMaxEq = 32;     // equality rows the constant block holds
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

template <typename T>
struct Consts {
  int nc, cm, n_legs;
  int nx, nu, i_c, i_rdot, i_w, i_cdot;
  int n_relvel, n_qddot, n_res, n_eq, n_eq_T, n_in, n_rho, n_term;
  int o_cone, o_xbox, o_ubox;      // first cone / x-box / u-box stage row
  int fpi[4];
  int po[kParams + 1];             // offsets of the packed parameter row
  T dt, m;
  T I[9];
  T eta2, w_rz, w_rdot, w_w, w_rel, w_qddot, w_minf, com_z;
  T d1x, d1y, d2x, d2y;
  T A_fc[15];
  T S[kMaxEq], sqw[kMaxEq], S_T[kMaxEq], sqw_T[kMaxEq];
};

template <typename T>
inline Consts<T> make_consts(const double* s, int nc, int cm, int n_legs) {
  Consts<T> k;
  k.nc = nc;
  k.cm = cm;
  k.n_legs = n_legs;
  k.nx = 13 + 6 * nc;
  k.nu = 6 + 6 * nc;
  k.i_c = 7;
  k.i_rdot = 7 + 3 * nc;
  k.i_w = 10 + 3 * nc;
  k.i_cdot = 13 + 3 * nc;
  k.n_relvel = 2 * n_legs * (cm - 1);
  k.n_qddot = 6 + 3 * nc;
  k.n_res = 21 + 6 * nc;
  k.n_eq = k.n_relvel + nc + 13;
  k.n_eq_T = k.n_relvel + nc + 4;
  k.n_in = 5 * nc;
  k.o_cone = k.n_res + k.n_eq;
  k.o_xbox = k.o_cone + 2 * k.n_in;
  k.o_ubox = k.o_xbox + 2 * k.nx;
  k.n_rho = k.o_ubox + 2 * k.nu;
  k.n_term = 15 + k.n_eq_T + 2 * k.nx;
  const int dims[kParams] = {1, 1, 3, 3, nc, 1, 1, 1, 1, k.n_eq, k.n_eq_T,
                             k.n_in, k.n_in, k.nx, k.nx, k.nx, k.nx, k.nu,
                             k.nu, k.nu, k.nu};
  k.po[0] = 0;
  for (int i = 0; i < kParams; ++i) k.po[i + 1] = k.po[i] + dims[i];
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
  const double* r = s + kFixedScalars;
  for (int i = 0; i < kMaxEq; ++i) {
    k.S[i] = i < k.n_eq ? static_cast<T>(r[i]) : T(1);
    k.sqw[i] = i < k.n_eq ? static_cast<T>(r[k.n_eq + i]) : T(1);
    k.S_T[i] = i < k.n_eq_T ? static_cast<T>(r[2 * k.n_eq + i]) : T(1);
    k.sqw_T[i] =
        i < k.n_eq_T ? static_cast<T>(r[2 * k.n_eq + k.n_eq_T + i]) : T(1);
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

// Lanes of one warp copy the parameters of member-node `row` (= b·(ns+1)+n)
// into `out` (k.po[kParams] values), tensor after tensor.
template <typename T>
__device__ void load_params(const Params<T>& P, size_t row,
                            const Consts<T>& k, int lane, T* out) {
  for (int t = 0; t < kParams; ++t) {
    const int dim = k.po[t + 1] - k.po[t];
    const T* src = P.p[t] + row * dim;
    T* dst = out + k.po[t];
    for (int e = lane; e < dim; e += 32) dst[e] = src[e];
  }
}

// Input column of contact q's acceleration (axis j) and force.
__host__ __device__ inline int col_cddot(int q, int j) { return 6 + 6 * q + j; }
__host__ __device__ inline int col_f(int q, int j) { return 9 + 6 * q + j; }

// Row j of ẋ(x, u) of the double integrator with floating base:
// [ṙ, ȯ = ½(ω,0)⊗o, ċ, r̈, ω̇, c̈] (accelerations are inputs).
template <typename T>
__device__ T xdot_row(int j, const T* x, const T* u, const Consts<T>& k) {
  if (j < 3) return x[k.i_rdot + j];
  if (j < 7) {
    T od[4];
    quat_rate(x + 3, x + k.i_w, od);
    return od[j - 3];
  }
  if (j < k.i_rdot) return x[k.i_cdot + (j - 7)];
  if (j < k.i_cdot) return u[j - k.i_rdot];          // r̈, ω̇
  const int e = j - k.i_cdot;
  return u[col_cddot(e / 3, e % 3)];
}

// max(0, v) that keeps a NaN (as torch.clamp and jnp.maximum do).
template <typename T>
__device__ T relu_nan(T v) {
  return v > T(0) ? v : (v != v ? v : T(0));
}

// d max(0, a)/da: 1 above 0, 0 below and ½ at exactly 0, as jax.jacfwd
// takes jnp.maximum at a tie (a swing foot's force that is exactly zero
// under a zero multiplier sits on one).
template <typename T>
__device__ T relu_slope(T a) {
  return a > T(0) ? T(1) : (a == T(0) ? T(0.5) : T(0));
}

// One-sided AL rows for v ≤ ub and lb ≤ v, and their slopes ∂/∂v.
template <typename T>
__device__ T upper_row(T v, T ub, T mu, T rho, T sr) {
  const bool fin = isfinite(ub);
  return (sr * (fin ? T(1) : T(0))) * relu_nan(v - (fin ? ub : T(0)) + mu / rho);
}
template <typename T>
__device__ T lower_row(T v, T lb, T mu, T rho, T sr) {
  const bool fin = isfinite(lb);
  return (sr * (fin ? T(1) : T(0))) * relu_nan((fin ? lb : T(0)) - v + mu / rho);
}
template <typename T>
__device__ T upper_slope(T v, T ub, T mu, T rho, T sr) {
  const bool fin = isfinite(ub);
  const T a = v - (fin ? ub : T(0)) + mu / rho;
  return (sr * (fin ? T(1) : T(0))) * relu_slope(a);
}
template <typename T>
__device__ T lower_slope(T v, T lb, T mu, T rho, T sr) {
  const bool fin = isfinite(lb);
  const T a = (fin ? lb : T(0)) - v + mu / rho;
  return -((sr * (fin ? T(1) : T(0))) * relu_slope(a));
}

// Per-node geometry one lane prepares for the Newton–Euler rows:
// geo = [Iw (9), Iw ω (3), √ρ, ρ]; R and RI = R I go to `rot` (18) when
// the caller wants them (the linearization does).
constexpr int kGeo = 14;
constexpr int kG_h = 9, kG_sr = 12, kG_rho = 13;

template <typename T>
__device__ void node_geometry(const T* x, const T* p, const Consts<T>& k,
                              T* geo, T* rot) {
  T R[9], RI[9];
  quat_to_rot(x + 3, R);
  world_inertia(R, k.I, RI, geo);
  const T* w = x + k.i_w;
  for (int i = 0; i < 3; ++i)
    geo[kG_h + i] =
        geo[i * 3] * w[0] + geo[i * 3 + 1] * w[1] + geo[i * 3 + 2] * w[2];
  const T rho = p[k.po[P_RHO]];
  geo[kG_rho] = rho;
  geo[kG_sr] = sqrt(rho);
  if (rot != nullptr)
    for (int i = 0; i < 9; ++i) {
      rot[i] = R[i];
      rot[9 + i] = RI[i];
    }
}

// The four foot-pair rows (y, x of pair 1; y, x of pair 2), unweighted.
template <typename T>
__device__ T rel_row(int g, const T* x, const Consts<T>& k) {
  const T* c = x + k.i_c;
  const int a = k.fpi[g < 2 ? 0 : 1], b = k.fpi[g < 2 ? 2 : 3];
  const int ax = (g % 2 == 0) ? 1 : 0;
  const T dd = g == 0 ? k.d1y : g == 1 ? k.d1x : g == 2 ? k.d2y : k.d2x;
  return (-c[3 * a + ax] + c[3 * b + ax]) - dd;
}

// Rows of the state-only equality segments shared by the stage and the
// terminal stack: rel-vel pair q, contact height q.
template <typename T>
__device__ T relvel_h(int q, const T* x, const Consts<T>& k) {
  const int per = 2 * (k.cm - 1);
  const int base = (q / per) * k.cm, rem = q % per;
  const int i = rem / 2 + 1, ax = rem % 2;
  const T* cdot = x + k.i_cdot;
  return cdot[3 * base + ax] - cdot[3 * (base + i) + ax];
}

// Scaled stage equality h_q (before the AL fold).
template <typename T>
__device__ T stage_eq_h(int q, const T* x, const T* u, const T* geo,
                        const T* p, const Consts<T>& k) {
  const int nc = k.nc;
  if (q < k.n_relvel) return relvel_h(q, x, k);
  q -= k.n_relvel;
  if (q < nc) return x[k.i_c + 3 * q + 2] - p[k.po[P_CREF] + q];
  q -= nc;
  const T* r = x;
  const T* w = x + k.i_w;
  if (q < 3) {                                  // Newton: m(r̈ + g) − Σf
    T f = T(0);
    for (int c = 0; c < nc; ++c) f += u[col_f(c, q)];
    const T acc = q == 2 ? u[q] + T(9.81) : u[q];
    return p[k.po[P_MSRBD]] * (k.m * acc - f);
  }
  if (q < 6) {                                  // Euler: Iw ω̇ + ω×Iw ω − Σ(c−r)×f
    const int a = q - 3, a1 = (a + 1) % 3, a2 = (a + 2) % 3;
    const T* wd = u + 3;
    const T* h = geo + kG_h;
    const T Iwd = geo[a * 3] * wd[0] + geo[a * 3 + 1] * wd[1] + geo[a * 3 + 2] * wd[2];
    const T wxh = w[a1] * h[a2] - w[a2] * h[a1];
    T tau = T(0);
    for (int c = 0; c < nc; ++c) {
      const T* cc = x + k.i_c + 3 * c;
      tau += (cc[a1] - r[a1]) * u[col_f(c, a2)] - (cc[a2] - r[a2]) * u[col_f(c, a1)];
    }
    return p[k.po[P_MSRBD]] * ((Iwd + wxh) - tau);
  }
  q -= 6;
  if (q < 3) {                                  // LIP: m(r̈ − [η²(r − zmp) − g])
    T zmp = T(0);
    if (q < 2) {
      for (int c = 0; c < nc; ++c) zmp += x[k.i_c + 3 * c + q];
      zmp = zmp / T(nc);
    }
    T lip = k.eta2 * (r[q] - zmp);
    if (q == 2) lip = lip - T(9.81);
    return p[k.po[P_MLIP]] * (k.m * (u[q] - lip));
  }
  q -= 3;
  const T mz = p[k.po[P_MZONE]];
  if (q == 0) return mz * (x[2] - k.com_z);
  return mz * w[q - 1];
}

// Terminal equality h_q: rel-vel, cz, lipzone.
template <typename T>
__device__ T terminal_eq_h(int q, const T* x, const T* p, const Consts<T>& k) {
  if (q < k.n_relvel) return relvel_h(q, x, k);
  q -= k.n_relvel;
  if (q < k.nc) return x[k.i_c + 3 * q + 2] - p[k.po[P_CREF] + q];
  q -= k.nc;
  const T mz = p[k.po[P_MZONE]];
  if (q == 0) return mz * (x[2] - k.com_z);
  return mz * x[k.i_w + q - 1];
}

// Row g of the x-box pair at offset `o` (ub rows, then lb rows).
template <typename T>
__device__ T xbox_row(int g, const T* x, const T* p, T rho, T sr,
                      const Consts<T>& k) {
  if (g < k.nx)
    return upper_row(x[g], p[k.po[P_XUB] + g], p[k.po[P_MUXUB] + g], rho, sr);
  g -= k.nx;
  return lower_row(x[g], p[k.po[P_XLB] + g], p[k.po[P_MUXLB] + g], rho, sr);
}

// Cone value g_q = A_fc[q % 5] · f_{q / 5}.
template <typename T>
__device__ T cone_value(int q, const T* u, const Consts<T>& k) {
  const T* A = k.A_fc + 3 * (q % 5);
  const int c = q / 5;
  return A[0] * u[col_f(c, 0)] + A[1] * u[col_f(c, 1)] + A[2] * u[col_f(c, 2)];
}

// Row g of the inner stage stack at (x, u, p); geo from node_geometry.
template <typename T>
__device__ T stage_rho_row(int g, const T* x, const T* u, const T* geo,
                           const T* p, const Consts<T>& k) {
  const T mt = p[k.po[P_MT]];
  if (g == 0) return (mt * k.w_rz) * (x[2] - k.com_z);
  if (g < 5) return (mt * p[k.po[P_WO]]) * (g == 4 ? x[6] - T(1) : x[2 + g]);
  if (g < 8) return (mt * k.w_rdot) * (x[k.i_rdot + g - 5] - p[k.po[P_RDOT] + g - 5]);
  if (g < 11) return (mt * k.w_w) * (x[k.i_w + g - 8] - p[k.po[P_WREF] + g - 8]);
  if (g < 11 + k.n_qddot) {
    const int j = g - 11;
    return k.w_qddot * (j < 6 ? u[j] : u[col_cddot((j - 6) / 3, (j - 6) % 3)]);
  }
  if (g < 15 + k.n_qddot) return k.w_rel * rel_row(g - 11 - k.n_qddot, x, k);
  if (g < k.n_res) {
    const int q = g - 15 - k.n_qddot;
    return k.w_minf * u[col_f(q / 3, q % 3)];
  }
  const T rho = geo[kG_rho], sr = geo[kG_sr];
  if (g < k.o_cone) {
    const int q = g - k.n_res;
    const T srw = sr * k.sqw[q];
    return srw * (k.S[q] * stage_eq_h(q, x, u, geo, p, k)) + p[k.po[P_LAM] + q] / srw;
  }
  if (g < k.o_xbox) {                           // cones: g ≤ 0, no lower bound
    int q = g - k.o_cone;
    if (q < k.n_in)
      return upper_row(cone_value(q, u, k), T(0), p[k.po[P_MUUB] + q], rho, sr);
    q -= k.n_in;
    return (sr * T(0)) * relu_nan(T(0) - cone_value(q, u, k) + p[k.po[P_MULB] + q] / rho);
  }
  if (g < k.o_ubox) return xbox_row(g - k.o_xbox, x, p, rho, sr, k);
  int q = g - k.o_ubox;
  if (q < k.nu)
    return upper_row(u[q], p[k.po[P_UUB] + q], p[k.po[P_MUUUB] + q], rho, sr);
  q -= k.nu;
  return lower_row(u[q], p[k.po[P_ULB] + q], p[k.po[P_MUULB] + q], rho, sr);
}

// Row g of the inner terminal stack at (x, p): the parameters of node ns.
template <typename T>
__device__ T terminal_rho_row(int g, const T* x, const T* p,
                              const Consts<T>& k) {
  if (g == 0) return k.w_rz * (x[2] - k.com_z);
  if (g < 5) return p[k.po[P_WO]] * (g == 4 ? x[6] - T(1) : x[2 + g]);
  if (g < 8) return k.w_rdot * (x[k.i_rdot + g - 5] - p[k.po[P_RDOT] + g - 5]);
  if (g < 11) return k.w_w * (x[k.i_w + g - 8] - p[k.po[P_WREF] + g - 8]);
  if (g < 15) return k.w_rel * rel_row(g - 11, x, k);
  const T rho = p[k.po[P_RHO]];
  const T sr = sqrt(rho);
  if (g < 15 + k.n_eq_T) {
    const int q = g - 15;
    const T srw = sr * k.sqw_T[q];
    return srw * (k.S_T[q] * terminal_eq_h(q, x, p, k)) + p[k.po[P_LAMT] + q] / srw;
  }
  return xbox_row(g - 15 - k.n_eq_T, x, p, rho, sr, k);
}

}  // namespace isrbd
