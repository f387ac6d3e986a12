// Device code shared by K3 (csrc/srbd_rollout.cu) and K4
// (csrc/srbd_linearize.cu): the SRBD problem's constants, the rigid-body
// rates of its Euler step and the rows of its stacked stage residual
// ρ = [stage_residual; √w_c·stage_eq] and of its terminal residual. Both
// kernels evaluate the dynamics and the residuals through this one copy.
// The rotation, inertia and 3×3 helpers and the warp reduction come from
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

// host scalars, in this order: dt, m_scaled, inertia_scaled (9, row-major),
// w_r, w_rdot, w_w, w_rel, w_qddot, w_minf, w_fswitch, √w_c, com_z,
// d1x, d1y, d2x, d2y (kernels/linearize.py::kernel_scalars)
constexpr int kScalars = 24;
// parameter tensors, each (B, ns+1, dim), in this order: mask_track (1),
// orientation_tracking_gain (1), oref (4), rdot_ref (3), w_ref (3),
// c_ref (nc), cdot_switch (nc)
constexpr int kParams = 7;

template <typename T>
struct Consts {
  int nc, cm, n_legs;
  int nx, nu, i_c, i_rdot, i_w, i_cdot;
  int n_res, n_eq, n_rho;   // residual rows, equality rows, stacked rows
  T dt, m_scaled;
  T I[9];
  T w_r, w_rdot, w_w, w_rel, w_qddot, w_minf, w_fswitch, wc;
  T com_z, d1x, d1y, d2x, d2y;
};

template <typename T>
inline Consts<T> make_consts(const double* s, int nc, int cm, int n_legs) {
  Consts<T> k;
  k.nc = nc;
  k.cm = cm;
  k.n_legs = n_legs;
  k.nx = 13 + 6 * nc;
  k.nu = 6 * nc;
  k.i_c = 7;
  k.i_rdot = 7 + 3 * nc;
  k.i_w = 10 + 3 * nc;
  k.i_cdot = 13 + 3 * nc;
  k.n_res = 21 + 9 * nc;
  k.n_eq = 2 * n_legs * (cm - 1) + 3 * nc;
  k.n_rho = k.n_res + k.n_eq;
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
__host__ __device__ inline int param_width(int nc) { return 12 + 2 * nc; }

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
// into `out` (param_width(nc) values).
template <typename T>
__device__ void load_params(const Params<T>& P, size_t row, int nc, int lane,
                            T* out) {
  for (int e = lane; e < param_width(nc); e += 32) {
    T v;
    if (e == kP_mt) v = P.p[0][row];
    else if (e == kP_otg) v = P.p[1][row];
    else if (e < kP_rdot) v = P.p[2][row * 4 + (e - kP_oref)];
    else if (e < kP_w) v = P.p[3][row * 3 + (e - kP_rdot)];
    else if (e < kP_cref) v = P.p[4][row * 3 + (e - kP_w)];
    else if (e < kP_cref + nc) v = P.p[5][row * nc + (e - kP_cref)];
    else v = P.p[6][row * nc + (e - kP_cref - nc)];
    out[e] = v;
  }
}

// Rigid-body part of ẋ on one thread: writes ȯ (xd[3:7]), r̈ (xd[i_rdot:+3])
// and ω̇ (xd[i_w:+3]) — models/srbd.py::srbd_xdot's fSRBD accelerations
// (R I Rᵀ, the Cramer 3×3 solve) and ½ (ω,0)⊗o.
template <typename T>
__device__ void body_rates(const T* x, const T* u, const Consts<T>& k, T* xd) {
  const int nc = k.nc;
  const T* r = x;
  const T* o = x + 3;
  const T* w = x + k.i_w;
  T R[9], RI[9], A[9], c[9];
  quat_to_rot(o, R);
  world_inertia(R, k.I, RI, A);
  T f_tot[3] = {T(0), T(0), T(0)};
  T tau[3] = {T(0), T(0), T(0)};
  for (int q = 0; q < nc; ++q) {
    const T* f = u + 6 * q + 3;
    const T* cq = x + 7 + 3 * q;
    const T p0 = cq[0] - r[0], p1 = cq[1] - r[1], p2 = cq[2] - r[2];
    f_tot[0] += f[0];
    f_tot[1] += f[1];
    f_tot[2] += f[2];
    tau[0] += p1 * f[2] - p2 * f[1];
    tau[1] += p2 * f[0] - p0 * f[2];
    tau[2] += p0 * f[1] - p1 * f[0];
  }
  T* rdd = xd + k.i_rdot;
  rdd[0] = f_tot[0] / k.m_scaled;
  rdd[1] = f_tot[1] / k.m_scaled;
  rdd[2] = f_tot[2] / k.m_scaled - T(9.81);
  // ω̇ = Iw⁻¹ (τ − ω × Iw ω), Cramer
  T Iw[3];
  for (int i = 0; i < 3; ++i)
    Iw[i] = A[i * 3 + 0] * w[0] + A[i * 3 + 1] * w[1] + A[i * 3 + 2] * w[2];
  const T b0 = tau[0] - (w[1] * Iw[2] - w[2] * Iw[1]);
  const T b1 = tau[1] - (w[2] * Iw[0] - w[0] * Iw[2]);
  const T b2 = tau[2] - (w[0] * Iw[1] - w[1] * Iw[0]);
  const T det = adjugate3(A, c);
  T* wd = xd + k.i_w;
  wd[0] = (c[0] * b0 + c[1] * b1 + c[2] * b2) / det;
  wd[1] = (c[3] * b0 + c[4] * b1 + c[5] * b2) / det;
  wd[2] = (c[6] * b0 + c[7] * b1 + c[8] * b2) / det;
  // ȯ = ½ (ω,0) ⊗ o
  const T qx = o[0], qy = o[1], qz = o[2], qw = o[3];
  const T v0 = T(0) * qx + qw * w[0] + (w[1] * qz - w[2] * qy);
  const T v1 = T(0) * qy + qw * w[1] + (w[2] * qx - w[0] * qz);
  const T v2 = T(0) * qz + qw * w[2] + (w[0] * qy - w[1] * qx);
  const T s = T(0) * qw - (w[0] * qx + w[1] * qy + w[2] * qz);
  xd[3] = T(0.5) * v0;
  xd[4] = T(0.5) * v1;
  xd[5] = T(0.5) * v2;
  xd[6] = T(0.5) * s;
}

// The integrator rows of ẋ (ṙ, ċ, c̈) for index j, or false if j is a
// rigid-body row (filled by body_rates).
template <typename T>
__device__ bool integrator_row(int j, const T* x, const T* u,
                               const Consts<T>& k, T* out) {
  if (j < 3) {
    *out = x[k.i_rdot + j];                      // ṙ
    return true;
  }
  if (j >= 7 && j < k.i_rdot) {
    *out = x[k.i_cdot + (j - 7)];                // ċ
    return true;
  }
  if (j >= k.i_cdot) {
    const int e = j - k.i_cdot;                  // c̈ from u
    *out = u[6 * (e / 3) + e % 3];
    return true;
  }
  return false;
}

// Row j of o ⊗ oref (x, y, z, w), problems/srbd.py's orientation error.
template <typename T>
__device__ T quat_err(int j, const T* o, const T* q) {
  switch (j) {
    case 0: return (o[3] * q[0] + q[3] * o[0]) + (o[1] * q[2] - o[2] * q[1]);
    case 1: return (o[3] * q[1] + q[3] * o[1]) + (o[2] * q[0] - o[0] * q[2]);
    case 2: return (o[3] * q[2] + q[3] * o[2]) + (o[0] * q[1] - o[1] * q[0]);
    default: return o[3] * q[3] - ((o[0] * q[0] + o[1] * q[1]) + o[2] * q[2]);
  }
}

// Row g < 15 of the tracking residual (the terminal residual when
// p[kP_mt] = 1).
template <typename T>
__device__ T tracking_row(int g, const T* x, const T* p, const Consts<T>& k) {
  const T mt = p[kP_mt];
  const T* c = x + k.i_c;
  if (g == 0) return (mt * k.w_r) * (x[2] - k.com_z);
  if (g < 4) return (mt * p[kP_otg]) * quat_err(g - 1, x + 3, p + kP_oref);
  if (g == 4) return (mt * p[kP_otg]) * (quat_err(3, x + 3, p + kP_oref) - T(1));
  if (g < 8) return (mt * k.w_rdot) * (x[k.i_rdot + g - 5] - p[kP_rdot + g - 5]);
  if (g < 11) return (mt * k.w_w) * (x[k.i_w + g - 8] - p[kP_w + g - 8]);
  const T wrel = mt * k.w_rel;
  const int a = g < 13 ? 0 : 3 * (k.cm - 1);       // −c[a] + c[b]
  const int b = g < 13 ? 3 * k.cm : 3 * (k.nc - 1);
  const int ax = (g % 2 == 1) ? 1 : 0;              // rows 11, 13: y
  const T dd = g == 11 ? k.d1y : g == 12 ? k.d1x : g == 13 ? k.d2y : k.d2x;
  return wrel * ((-c[a + ax] + c[b + ax]) - dd);
}

// Row g of the stacked stage residual ρ at (x, u, p); xd holds ẋ(x, u)
// (r̈ and ω̇ are read from it).
template <typename T>
__device__ T stage_rho_row(int g, const T* x, const T* u, const T* xd,
                           const T* p, const Consts<T>& k) {
  const int nc = k.nc;
  if (g < 15) return tracking_row(g, x, p, k);
  if (g < 18) return k.w_qddot * xd[k.i_rdot + g - 15];
  if (g < 21) return k.w_qddot * xd[k.i_w + g - 18];
  if (g < 21 + 3 * nc) {
    const int q = g - 21;
    return k.w_qddot * u[6 * (q / 3) + q % 3];
  }
  if (g < 21 + 6 * nc) {
    const int q = g - 21 - 3 * nc;
    return k.w_minf * u[6 * (q / 3) + 3 + q % 3];
  }
  if (g < k.n_res) {
    const int q = g - 21 - 6 * nc;
    return (k.w_fswitch * (T(1) - p[kP_cref + nc + q / 3])) *
           u[6 * (q / 3) + 3 + q % 3];
  }
  // √w_c · stage_eq
  int q = g - k.n_res;
  const int per = 2 * (k.cm - 1);
  const int n_rv = k.n_legs * per;
  const T* cdot = x + k.i_cdot;
  T h;
  if (q < n_rv) {
    const int base = (q / per) * k.cm, rem = q % per;
    const int i = rem / 2 + 1, ax = rem % 2;
    h = cdot[3 * base + ax] - cdot[3 * (base + i) + ax];
  } else if (q < n_rv + nc) {
    q -= n_rv;
    h = x[k.i_c + 3 * q + 2] - p[kP_cref + q];
  } else {
    q -= n_rv + nc;
    h = p[kP_cref + nc + q / 2] * cdot[3 * (q / 2) + q % 2];
  }
  return k.wc * h;
}

}  // namespace srbd
