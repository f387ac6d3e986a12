// K5 — the sliced linearization of the batched MS-DDP solver on the isrbd
// AL inner problem, in closed form, every member-node and the terminal
// node in one launch.
//
// Replaces: `MSDDP._linearize_sliced` (srbd_horizon_tpu/solvers/msddp.py:
// 273-344) on the AL inner OCP (srbd_horizon_tpu/solvers/alddp.py:215-256):
// `jax.jacfwd` of the RK2 step and of the 240-row inner stage stack over
// the declared row slices under `vmap`, which XLA fused on the TPU (the
// JAX package wrote no Pallas kernel for it). Plain twin:
// `kernels/isrbd_linearize.py::isrbd_linearize_plain`. Per member-node:
//     Sx  = (A − I)[rx]          A = I + dt·F(x_mid)·(I + dt/2·F(x))
//     Bs  = B[ru][:, uc]         B = dt·(G + dt/2·F(x_mid)·G)
//     Jxp = (∂ρ/∂x)[gx]          Jup = (∂ρ/∂u)[gu]
//     ρ   = the inner stage stack        d = rk2(x, u) − X[n+1]
// and per member the terminal rt and Jt = ∂rt/∂x. F = ∂ẋ/∂x of the double
// integrator is nonzero only in the position rows (identity blocks for ṙ
// and ċ, ½Ω(ω) and ½Ξ(o) for ȯ), G = ∂ẋ/∂u is a constant selection, so
// only the quaternion rows of A − I and B carry products. The residual
// rows are weights and selections; an equality row's Jacobian is
// S_j√(ρw_j)·∂h_j, where the Newton–Euler rows need
//     ∂/∂o_j [Iw ω̇ + ω×Iw ω] = ∂Iw_j ω̇ + ω×(∂Iw_j ω),  ∂Iw_j = R_j I Rᵀ + R I R_jᵀ
// with R_j of the homogeneous quat_to_rot (csrc/rigid_common.cuh); a
// one-sided row's is ±√ρ·(its cone face or unit vector) where the row is
// active, and half that where its pre-activation is exactly 0 (the value
// jax.jacfwd gives jnp.maximum at a tie). The row sets rx, ru, gx, gu, uc arrive as the int32 table K1
// reads (kernels/riccati.py::RiccatiRows).
//
// What bounds it on an H100: bytes. A member-node writes 6,956 values (Sx
// 703, Bs 666, Jxp 2,220, Jup 3,090, ρ 240, d 37) and reads ~430 (x, u and
// the 358 parameter values, most of them multipliers and bounds); most
// outputs are structural zeros that K1 reads dense. At B=256, ns=20 that
// is ~143 MB of f32 out and ~9 MB in, ~0.045 ms at 3.35 TB/s, against a few
// thousand FLOP per member-node.
//
// Design: K4's. One warp per member-node, and one per member for the
// terminal pair, so a linearization is one launch. The warp copies x, u
// and the node's parameters to shared memory, forms the midpoint state,
// then a few lanes prepare the node's scalars (lane 0 R, R I, Iw, Iw ω and
// √ρ; lanes 0-3 the four ∂Iw_j columns of the Euler rows; lanes 0-27 the
// two quaternion blocks of A − I), the lanes evaluate the 240 residual
// rows through csrc/isrbd_common.cuh (the same device code as K6), and
// last all 32 lanes walk each output block in storage order, evaluating
// each entry from the shared scalars by its row's segment. Simple first:
// no vector stores, no skipping of the zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "isrbd_common.cuh"

namespace {

using isrbd::Consts;

constexpr int kWarps = 4;
constexpr int kTrack = 15;     // rows of the outer terminal residual

// Per-node scalars in shared memory, after x, u, x_mid and the parameters.
struct Scratch {
  int geo, rot, angO, soo, sow, fowm, rho, total;
  __host__ __device__ Scratch(int n_rho) {
    int o = 0;
    geo = o; o += isrbd::kGeo;
    rot = o; o += 18;          // R, R I
    angO = o; o += 12;         // ∂(Euler rows)/∂o, 3×4
    soo = o; o += 16;          // Foo(ω_mid) + dt/2·Foo(ω_mid) Foo(ω)
    sow = o; o += 12;          // Fow(o_mid) + dt/2·Foo(ω_mid) Fow(o)
    fowm = o; o += 12;         // Fow(o_mid)
    rho = o; o += n_rho;
    total = o;
  }
};

// Entry (a, c) of [v]ₓ.
template <typename T>
__device__ T skew_at(const T* v, int a, int c) {
  T m[3];
  rigid::skew_col(v, c, m);
  return m[a];
}

// (A − I)[row][col].
template <typename T>
__device__ T jac_step_x(int row, int col, const T* sc, const Scratch& L,
                        const Consts<T>& k) {
  if (row < 3) return col == k.i_rdot + row ? k.dt : T(0);
  if (row < 7) {
    const int q = row - 3;
    if (col >= 3 && col < 7) return k.dt * sc[L.soo + q * 4 + (col - 3)];
    if (col >= k.i_w && col < k.i_w + 3) return k.dt * sc[L.sow + q * 3 + (col - k.i_w)];
    return T(0);
  }
  if (row < k.i_rdot) return col == k.i_cdot + (row - 7) ? k.dt : T(0);
  return T(0);
}

// B[row][col].
template <typename T>
__device__ T jac_step_u(int row, int col, const T* sc, const Scratch& L,
                        const Consts<T>& k) {
  const T h2 = k.dt * (T(0.5) * k.dt);
  if (row < 3) return col == row ? h2 : T(0);
  if (row < 7)
    return (col >= 3 && col < 6) ? h2 * sc[L.fowm + (row - 3) * 3 + (col - 3)] : T(0);
  if (row < k.i_rdot) {
    const int e = row - 7;
    return col == isrbd::col_cddot(e / 3, e % 3) ? h2 : T(0);
  }
  if (row < k.i_cdot) return col == row - k.i_rdot ? k.dt : T(0);
  const int e = row - k.i_cdot;
  return col == isrbd::col_cddot(e / 3, e % 3) ? k.dt : T(0);
}

// ∂(rel-vel pair q)/∂x[col], ∂(cz q)/∂x[col], ∂(lipzone q)/∂x[col]: the
// state-only equality segments shared by the stage and terminal stacks.
template <typename T>
__device__ T relvel_dx(int q, int col, const Consts<T>& k) {
  const int per = 2 * (k.cm - 1);
  const int base = (q / per) * k.cm, rem = q % per;
  const int i = rem / 2 + 1, ax = rem % 2;
  if (col == k.i_cdot + 3 * base + ax) return T(1);
  if (col == k.i_cdot + 3 * (base + i) + ax) return T(-1);
  return T(0);
}

template <typename T>
__device__ T lipzone_dx(int q, int col, const Consts<T>& k) {
  return col == (q == 0 ? 2 : k.i_w + q - 1) ? T(1) : T(0);
}

// ∂/∂x[col] of the tracking rows g < 11 and the foot-pair rows (r = 0..3),
// with the tracking mask mt.
template <typename T>
__device__ T track_dx(int g, int col, T mt, const T* p, const Consts<T>& k) {
  if (g == 0) return col == 2 ? mt * k.w_rz : T(0);
  if (g < 5) return col == 2 + g ? mt * p[k.po[isrbd::P_WO]] : T(0);
  if (g < 8) return col == k.i_rdot + g - 5 ? mt * k.w_rdot : T(0);
  return col == k.i_w + g - 8 ? mt * k.w_w : T(0);
}

template <typename T>
__device__ T rel_dx(int r, int col, const Consts<T>& k) {
  const int a = k.fpi[r < 2 ? 0 : 1], b = k.fpi[r < 2 ? 2 : 3];
  const int ax = (r % 2 == 0) ? 1 : 0;
  T v = T(0);
  if (col == k.i_c + 3 * a + ax) v -= k.w_rel;
  if (col == k.i_c + 3 * b + ax) v += k.w_rel;
  return v;
}

// Slope of x-box row g (ub rows, then lb rows) along its own dim.
template <typename T>
__device__ T xbox_dx(int g, int col, const T* x, const T* p, T rho, T sr,
                     const Consts<T>& k) {
  using namespace isrbd;
  if (g < k.nx)
    return col == g ? upper_slope(x[g], p[k.po[P_XUB] + g], p[k.po[P_MUXUB] + g], rho, sr)
                    : T(0);
  g -= k.nx;
  return col == g ? lower_slope(x[g], p[k.po[P_XLB] + g], p[k.po[P_MUXLB] + g], rho, sr)
                  : T(0);
}

// (∂ρ/∂x)[g][col] of the inner stage stack.
template <typename T>
__device__ T jac_rho_x(int g, int col, const T* x, const T* u, const T* p,
                       const T* sc, const Scratch& L, const Consts<T>& k) {
  using namespace isrbd;
  if (g < 11) return track_dx(g, col, p[k.po[P_MT]], p, k);
  if (g < 11 + k.n_qddot) return T(0);
  if (g < 15 + k.n_qddot) return rel_dx(g - 11 - k.n_qddot, col, k);
  if (g < k.n_res) return T(0);
  const T* geo = sc + L.geo;
  const T rho = geo[kG_rho], sr = geo[kG_sr];
  if (g < k.o_cone) {
    int q = g - k.n_res;
    const T s = (sr * k.sqw[q]) * k.S[q];
    if (q < k.n_relvel) return s * relvel_dx(q, col, k);
    q -= k.n_relvel;
    if (q < k.nc) return col == k.i_c + 3 * q + 2 ? s : T(0);
    q -= k.nc;
    if (q < 3) return T(0);                      // Newton rows: u only
    if (q < 6) {                                 // Euler rows
      const int a = q - 3;
      const T sm = s * p[k.po[P_MSRBD]];
      if (col < 3) {
        T f[3] = {T(0), T(0), T(0)};
        for (int c = 0; c < k.nc; ++c)
          for (int i = 0; i < 3; ++i) f[i] += u[col_f(c, i)];
        return sm * (-skew_at(f, a, col));
      }
      if (col < 7) return sm * sc[L.angO + a * 4 + (col - 3)];
      if (col < k.i_rdot) {
        const int c = (col - 7) / 3, j = (col - 7) % 3;
        return sm * skew_at(u + col_f(c, 0), a, j);
      }
      if (col >= k.i_w && col < k.i_cdot) {      // [ω]ₓ Iw − [Iw ω]ₓ
        const int j = col - k.i_w;
        const T* w = x + k.i_w;
        T wI = T(0);
        for (int l = 0; l < 3; ++l) wI += skew_at(w, a, l) * geo[l * 3 + j];
        return sm * (wI - skew_at(geo + kG_h, a, j));
      }
      return T(0);
    }
    q -= 6;
    if (q < 3) {                                 // LIP rows
      const T sm = s * p[k.po[P_MLIP]];
      if (col < 3) return col == q ? sm * (-(k.m * k.eta2)) : T(0);
      if (q < 2 && col >= k.i_c && col < k.i_rdot && (col - k.i_c) % 3 == q)
        return sm * (k.m * k.eta2 / T(k.nc));
      return T(0);
    }
    q -= 3;
    return (s * p[k.po[P_MZONE]]) * lipzone_dx(q, col, k);
  }
  if (g < k.o_xbox) return T(0);                 // cones: u only
  if (g < k.o_ubox) return xbox_dx(g - k.o_xbox, col, x, p, rho, sr, k);
  return T(0);
}

// (∂ρ/∂u)[g][col].
template <typename T>
__device__ T jac_rho_u(int g, int col, const T* x, const T* u, const T* p,
                       const T* sc, const Scratch& L, const Consts<T>& k) {
  using namespace isrbd;
  if (g < 11) return T(0);
  if (g < 11 + k.n_qddot) {
    const int j = g - 11;
    const int t = j < 6 ? j : col_cddot((j - 6) / 3, (j - 6) % 3);
    return col == t ? k.w_qddot : T(0);
  }
  if (g < 15 + k.n_qddot) return T(0);
  if (g < k.n_res) {
    const int q = g - 15 - k.n_qddot;
    return col == col_f(q / 3, q % 3) ? k.w_minf : T(0);
  }
  const T* geo = sc + L.geo;
  const T rho = geo[kG_rho], sr = geo[kG_sr];
  const bool is_f = col >= 6 && (col - 6) % 6 >= 3;   // a force column
  const int fc = (col - 6) / 6, fj = (col - 6) % 6 - 3;
  if (g < k.o_cone) {
    int q = g - k.n_res;
    const T s = (sr * k.sqw[q]) * k.S[q];
    q -= k.n_relvel + k.nc;
    if (q < 0) return T(0);
    if (q < 3) {                                 // Newton: m r̈ − Σf
      const T sm = s * p[k.po[P_MSRBD]];
      if (col == q) return sm * k.m;
      return (is_f && fj == q) ? sm * T(-1) : T(0);
    }
    if (q < 6) {                                 // Euler: Iw ω̇ − Σ(c−r)×f
      const int a = q - 3;
      const T sm = s * p[k.po[P_MSRBD]];
      if (col >= 3 && col < 6) return sm * geo[a * 3 + (col - 3)];
      if (is_f) {
        const T* c = x + k.i_c + 3 * fc;
        const T cr[3] = {c[0] - x[0], c[1] - x[1], c[2] - x[2]};
        return sm * (-skew_at(cr, a, fj));
      }
      return T(0);
    }
    q -= 6;
    if (q < 3) return col == q ? (s * p[k.po[P_MLIP]]) * k.m : T(0);
    return T(0);
  }
  if (g < k.o_xbox) {                            // cones (no lower bound)
    const int q = g - k.o_cone;
    if (q >= k.n_in || !is_f || fc != q / 5) return T(0);
    const T slope = upper_slope(cone_value(q, u, k), T(0),
                                p[k.po[P_MUUB] + q], rho, sr);
    return slope * k.A_fc[3 * (q % 5) + fj];
  }
  if (g < k.o_ubox) return T(0);
  int q = g - k.o_ubox;
  if (q < k.nu)
    return col == q ? upper_slope(u[q], p[k.po[P_UUB] + q], p[k.po[P_MUUUB] + q], rho, sr)
                    : T(0);
  q -= k.nu;
  return col == q ? lower_slope(u[q], p[k.po[P_ULB] + q], p[k.po[P_MUULB] + q], rho, sr)
                  : T(0);
}

// (∂rt/∂x)[g][col] of the inner terminal stack.
template <typename T>
__device__ T jac_term_x(int g, int col, const T* x, const T* p,
                        const Consts<T>& k) {
  using namespace isrbd;
  if (g < 11) return track_dx(g, col, T(1), p, k);
  if (g < kTrack) return rel_dx(g - 11, col, k);
  const T rho = p[k.po[P_RHO]];
  const T sr = sqrt(rho);
  if (g < kTrack + k.n_eq_T) {
    int q = g - kTrack;
    const T s = (sr * k.sqw_T[q]) * k.S_T[q];
    if (q < k.n_relvel) return s * relvel_dx(q, col, k);
    q -= k.n_relvel;
    if (q < k.nc) return col == k.i_c + 3 * q + 2 ? s : T(0);
    q -= k.nc;
    return (s * p[k.po[P_MZONE]]) * lipzone_dx(q, col, k);
  }
  return xbox_dx(g - kTrack - k.n_eq_T, col, x, p, rho, sr, k);
}

__host__ __device__ inline int warp_floats(int nx, int nu, int n_par, int n_rho) {
  return 2 * nx + nu + n_par + Scratch(n_rho).total;   // x, x_mid, u, p, scalars
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
isrbd_linearize_kernel(const T* __restrict__ X, const T* __restrict__ U,
                       isrbd::Params<T> P, const int* __restrict__ table,
                       int B, int ns, int n_rx, int n_ru, int n_gx, int n_gu,
                       int n_b, int n_uc, Consts<T> k, T* __restrict__ Sx,
                       T* __restrict__ Bs, T* __restrict__ Jxp,
                       T* __restrict__ Jup, T* __restrict__ rho_out,
                       T* __restrict__ dfx, T* __restrict__ rt,
                       T* __restrict__ Jt) {
  using namespace isrbd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = k.nx, nu = k.nu, nr = k.n_rho, nt = k.n_term;
  const int n_par = k.po[kParams];
  const Scratch L(nr);
  const int per_warp = warp_floats(nx, nu, n_par, nr);
  const int n_tab = n_rx + n_ru + n_gx + n_gu + 2 * n_b + n_uc;
  int* tab = reinterpret_cast<int*>(
      reinterpret_cast<T*>(smem_raw) + kWarps * per_warp);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int* rx = tab;
  const int* ru = rx + n_rx;
  const int* gx = ru + n_ru;
  const int* gu = gx + n_gx;
  const int* uc = gu + n_gu + 2 * n_b;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (gw >= static_cast<long long>(B) * (ns + 1)) return;   // whole warp leaves
  const size_t b = gw / (ns + 1);
  const int n = static_cast<int>(gw % (ns + 1));

  T* x = reinterpret_cast<T*>(smem_raw) + warp * per_warp;
  T* xm = x + nx;
  T* u = xm + nx;
  T* p = u + nu;
  T* sc = p + n_par;

  const T* Xb = X + (b * (ns + 1) + n) * nx;
  for (int j = lane; j < nx; j += 32) x[j] = Xb[j];
  load_params(P, b * (ns + 1) + n, k, lane, p);
  __syncwarp();

  if (n == ns) {                     // the terminal pair rt, Jt
    for (int g = lane; g < nt; g += 32) rt[b * nt + g] = terminal_rho_row(g, x, p, k);
    T* Jo = Jt + b * nt * nx;
    for (int e = lane; e < nt * nx; e += 32) {
      const int g = e / nx;
      Jo[e] = jac_term_x(g, e - g * nx, x, p, k);
    }
    return;
  }

  const size_t bn = b * ns + n;
  for (int j = lane; j < nu; j += 32) u[j] = U[bn * nu + j];
  __syncwarp();
  // x_mid = x + dt/2·ẋ(x, u)
  for (int j = lane; j < nx; j += 32)
    xm[j] = x[j] + (T(0.5) * k.dt) * xdot_row(j, x, u, k);
  if (lane == 0) node_geometry(x, p, k, sc + L.geo, sc + L.rot);
  __syncwarp();
  if (lane < 4) {                    // ∂(Iw ω̇ + ω×Iw ω)/∂o_lane
    T dI[9], v1[3], v2[3];
    world_inertia_dq(lane, x + 3, sc + L.rot, sc + L.rot + 9, k.I, dI);
    const T* w = x + k.i_w;
    const T* wd = u + 3;
    for (int a = 0; a < 3; ++a) {
      v1[a] = dI[a * 3] * wd[0] + dI[a * 3 + 1] * wd[1] + dI[a * 3 + 2] * wd[2];
      v2[a] = dI[a * 3] * w[0] + dI[a * 3 + 1] * w[1] + dI[a * 3 + 2] * w[2];
    }
    sc[L.angO + 0 * 4 + lane] = v1[0] + (w[1] * v2[2] - w[2] * v2[1]);
    sc[L.angO + 1 * 4 + lane] = v1[1] + (w[2] * v2[0] - w[0] * v2[2]);
    sc[L.angO + 2 * 4 + lane] = v1[2] + (w[0] * v2[1] - w[1] * v2[0]);
  }
  {                                  // the quaternion blocks of A − I and B
    const T* w = x + k.i_w;
    const T* o = x + 3;
    const T* wmid = xm + k.i_w;
    const T* omid = xm + 3;
    const T hdt = T(0.5) * k.dt;
    if (lane < 16) {
      const int i = lane / 4, j = lane % 4;
      T s = T(0);
      for (int l = 0; l < 4; ++l)
        s += quat_rate_jac_o(i, l, wmid) * quat_rate_jac_o(l, j, w);
      sc[L.soo + lane] = quat_rate_jac_o(i, j, wmid) + hdt * s;
    } else if (lane < 28) {
      const int e = lane - 16, i = e / 3, j = e % 3;
      T s = T(0);
      for (int l = 0; l < 4; ++l)
        s += quat_rate_jac_o(i, l, wmid) * quat_rate_jac_w(l, j, o);
      const T fm = quat_rate_jac_w(i, j, omid);
      sc[L.fowm + e] = fm;
      sc[L.sow + e] = fm + hdt * s;
    }
  }
  for (int g = lane; g < nr; g += 32)
    sc[L.rho + g] = stage_rho_row(g, x, u, sc + L.geo, p, k);
  __syncwarp();

  T* So = Sx + bn * n_rx * nx;
  for (int e = lane; e < n_rx * nx; e += 32) {
    const int i = e / nx;
    So[e] = jac_step_x(rx[i], e - i * nx, sc, L, k);
  }
  T* Bo = Bs + bn * n_ru * n_uc;
  for (int e = lane; e < n_ru * n_uc; e += 32) {
    const int i = e / n_uc;
    Bo[e] = jac_step_u(ru[i], uc[e - i * n_uc], sc, L, k);
  }
  T* Jxo = Jxp + bn * n_gx * nx;
  for (int e = lane; e < n_gx * nx; e += 32) {
    const int i = e / nx;
    Jxo[e] = jac_rho_x(gx[i], e - i * nx, x, u, p, sc, L, k);
  }
  T* Juo = Jup + bn * n_gu * nu;
  for (int e = lane; e < n_gu * nu; e += 32) {
    const int i = e / nu;
    Juo[e] = jac_rho_u(gu[i], e - i * nu, x, u, p, sc, L, k);
  }
  for (int g = lane; g < nr; g += 32) rho_out[bn * nr + g] = sc[L.rho + g];
  // d = rk2(x, u) − X[n+1] = (x + dt·ẋ(x_mid, u)) − X[n+1]
  const T* Xnext = Xb + nx;
  for (int j = lane; j < nx; j += 32)
    dfx[bn * nx + j] = (x[j] + k.dt * xdot_row(j, xm, u, k)) - Xnext[j];
}

template <typename T>
int launch(const void* X, const void* U, const void* const* params,
           const void* table, int B, int ns, int nc, int cm, int n_legs,
           int n_rx, int n_ru, int n_gx, int n_gu, int n_b, int n_uc,
           const double* scalars, void* Sx, void* Bs, void* Jxp, void* Jup,
           void* rho, void* d, void* rt, void* Jt, void* stream) {
  const long long warps = static_cast<long long>(B) * (ns + 1);
  if (B == 0) return 0;
  const Consts<T> k = isrbd::make_consts<T>(scalars, nc, cm, n_legs);
  const size_t bytes =
      sizeof(T) * kWarps * warp_floats(k.nx, k.nu, k.po[isrbd::kParams], k.n_rho) +
      sizeof(int) * (n_rx + n_ru + n_gx + n_gu + 2 * n_b + n_uc);
  cudaError_t err = cudaFuncSetAttribute(
      isrbd_linearize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  isrbd_linearize_kernel<T><<<blocks, 32 * kWarps, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      isrbd::make_params<T>(params), static_cast<const int*>(table), B, ns,
      n_rx, n_ru, n_gx, n_gu, n_b, n_uc, k, static_cast<T*>(Sx),
      static_cast<T*>(Bs), static_cast<T*>(Jxp), static_cast<T*>(Jup),
      static_cast<T*>(rho), static_cast<T*>(d), static_cast<T*>(rt),
      static_cast<T*>(Jt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LINEARIZE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, const void* table, int B,    \
                      int ns, int nc, int cm, int n_legs, int n_rx, int n_ru, \
                      int n_gx, int n_gu, int n_b, int n_uc,                  \
                      const double* scalars, void* Sx, void* Bs, void* Jxp,   \
                      void* Jup, void* rho, void* d, void* rt, void* Jt,      \
                      void* stream) {                                         \
    return launch<T>(X, U, params, table, B, ns, nc, cm, n_legs, n_rx, n_ru,  \
                     n_gx, n_gu, n_b, n_uc, scalars, Sx, Bs, Jxp, Jup, rho,   \
                     d, rt, Jt, stream);                                      \
  }

LINEARIZE_ENTRY(isrbd_linearize_f32, float)
LINEARIZE_ENTRY(isrbd_linearize_f64, double)
