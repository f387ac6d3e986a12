// K4 — the sliced linearization of the batched MS-DDP solver on the SRBD
// problem, in closed form, every member-node and the terminal node in one
// launch.
//
// Replaces: `MSDDP._linearize_sliced` (srbd_horizon_tpu/solvers/msddp.py:
// 273-344), `jax.jacfwd` of the Euler step and of `_stage_rho` over the
// declared row slices under `vmap`, which XLA fused on the TPU (the JAX
// package wrote no Pallas kernel for it). This kernel evaluates the
// closed form of srbd_horizon_tpu/problems/srbd.py::stage_jacobians
// (:236-375) on those rows instead, and derives by hand the one block that
// function takes by AD, ∂ω̇/∂o. Plain twin:
// `kernels/linearize.py::srbd_linearize_plain`. Per member-node (b, n):
//     Sx  = dt·(∂ẋ/∂x)[rx]       (A − I on the live rows, A = I + dt ∂ẋ/∂x)
//     Bs  = dt·(∂ẋ/∂u)[ru]       (B on the live rows)
//     Jxp = (∂ρ/∂x)[gx]          Jup = (∂ρ/∂u)[gu]
//     ρ   = [stage_residual; √w_c·stage_eq]     d = x + dt·ẋ − X[n+1]
// and per member the terminal rt and Jt = ∂rt/∂x. The row sets rx, ru, gx,
// gu arrive as the int32 table K1 reads (kernels/riccati.py::RiccatiRows).
// The rigid-body rows come from
//     Iw ω̇ = b,  b = τ − ω × Iw ω,  τ = Σ (cₖ − r) × fₖ,  Iw = R(o) I Rᵀ
// so each column of ∂ω̇/∂(x, u) is Iw⁻¹ ∂b (Cramer: adj·∂b / det, as
// math/quat.py::solve3x3), with
//     ∂b/∂r = [Σf]ₓ   ∂b/∂cₖ = −[fₖ]ₓ   ∂b/∂fₖ = [cₖ − r]ₓ
//     ∂b/∂ω = [Iw ω]ₓ − [ω]ₓ Iw
//     ∂b/∂oⱼ = −∂Iwⱼ ω̇ − ω × (∂Iwⱼ ω),  ∂Iwⱼ = Rⱼ I Rᵀ + R I Rⱼᵀ
// where Rⱼ = ∂R/∂oⱼ of the homogeneous (not normalized) quat_to_rot, which
// is linear in o — so the derivative holds for non-unit quaternions too.
//
// What bounds it on an H100: bytes. A member-node writes 3,622 values
// (Sx 814, Bs 432, Jxp 1,258, Jup 1,008, ρ 73, d 37) and reads ~100; most
// outputs are structural zeros or constants that K1 reads dense. At B=512,
// ns=20 that is ~148 MB of f32 out and ~5 MB in, ~0.046 ms at 3.35 TB/s,
// against a few thousand FLOP per member-node (~0.001 ms at 67 TFLOP/s).
//
// Design: one warp per member-node, and one per member for the terminal
// pair, so a linearization is one launch. The warp first computes the
// node's scalars into shared memory: lane 0 the rigid-body rates ẋ (the
// same device code as K3), lane 1 R, R I, Iw, its adjugate and det, the
// other lanes the integrator rows; then one lane per column of (x, u)
// forms ∂b and the three entries of ∂ω̇ (the ∂Iwⱼ products on the four o
// columns), and the lanes evaluate the 73 residual rows. Last, all 32
// lanes walk each output block in storage order, so neighbouring lanes
// store neighbouring addresses, and evaluate each entry from the shared
// scalars by its row's region. Simple first: no vector stores, no
// skipping of the zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "srbd_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTrack = 15;     // terminal rows = the tracking rows
constexpr int kGeo = 40;       // R, RI, Iw, adj (9 each), det, Iw ω (3)

// ∂b/∂(x, u)[col] — the right-hand side of Iw ω̇ = b differentiated along
// column col of (x, u), Iw's own o-dependence included.
template <typename T>
__device__ void rhs_column(int col, const T* x, const T* u, const T* xd,
                           const T* geo, const srbd::Consts<T>& k, T* m) {
  const T* R = geo;
  const T* RI = geo + 9;
  const T* Iw = geo + 18;
  const T* h = geo + 37;
  const T* r = x;
  const T* w = x + k.i_w;
  m[0] = m[1] = m[2] = T(0);
  if (col < 3) {                                   // r
    T f[3] = {T(0), T(0), T(0)};
    for (int q = 0; q < k.nc; ++q)
      for (int i = 0; i < 3; ++i) f[i] += u[6 * q + 3 + i];
    rigid::skew_col(f, col, m);
  } else if (col < 7) {                            // o
    T D[9], P[9], dI[9];
    rigid::drot(col - 3, x + 3, D);
    for (int a = 0; a < 3; ++a)
      for (int l = 0; l < 3; ++l) {
        T s = T(0);
        for (int q = 0; q < 3; ++q) s += D[a * 3 + q] * k.I[q * 3 + l];
        P[a * 3 + l] = s;
      }
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c) {
        T s1 = T(0), s2 = T(0);
        for (int l = 0; l < 3; ++l) {
          s1 += P[a * 3 + l] * R[c * 3 + l];
          s2 += RI[a * 3 + l] * D[c * 3 + l];
        }
        dI[a * 3 + c] = s1 + s2;
      }
    const T* wd = xd + k.i_w;
    T v1[3], v2[3];
    for (int a = 0; a < 3; ++a) {
      v1[a] = dI[a * 3] * wd[0] + dI[a * 3 + 1] * wd[1] + dI[a * 3 + 2] * wd[2];
      v2[a] = dI[a * 3] * w[0] + dI[a * 3 + 1] * w[1] + dI[a * 3 + 2] * w[2];
    }
    m[0] = -v1[0] - (w[1] * v2[2] - w[2] * v2[1]);
    m[1] = -v1[1] - (w[2] * v2[0] - w[0] * v2[2]);
    m[2] = -v1[2] - (w[0] * v2[1] - w[1] * v2[0]);
  } else if (col < k.i_rdot) {                     // cₖ
    const int q = (col - 7) / 3, j = (col - 7) % 3;
    rigid::skew_col(u + 6 * q + 3, j, m);
    m[0] = -m[0];
    m[1] = -m[1];
    m[2] = -m[2];
  } else if (col >= k.i_w && col < k.i_cdot) {     // ω
    const int j = col - k.i_w;
    rigid::skew_col(h, j, m);
    const T v0 = Iw[j], v1 = Iw[3 + j], v2 = Iw[6 + j];
    m[0] -= w[1] * v2 - w[2] * v1;
    m[1] -= w[2] * v0 - w[0] * v2;
    m[2] -= w[0] * v1 - w[1] * v0;
  } else if (col >= k.nx && (col - k.nx) % 6 >= 3) {   // fₖ
    const int q = (col - k.nx) / 6, j = (col - k.nx) % 6 - 3;
    const T* c = x + 7 + 3 * q;
    const T cr[3] = {c[0] - r[0], c[1] - r[1], c[2] - r[2]};
    rigid::skew_col(cr, j, m);
  }
}

// (∂ẋ/∂x)[row][col]; W holds ∂ω̇/∂(x, u) column-major (3 per column).
template <typename T>
__device__ T jac_xdot_x(int row, int col, const T* x, const T* W,
                        const srbd::Consts<T>& k) {
  if (row < 3) return col == k.i_rdot + row ? T(1) : T(0);
  if (row < 7) {                                   // ȯ = ½ (ω,0)⊗o
    const int q = row - 3;
    const T* o = x + 3;
    const T* w = x + k.i_w;
    if (col >= 3 && col < 7) {                     // ½ [[ωₓ, ω], [−ωᵀ, 0]]
      const int j = col - 3;
      T v;
      if (q == 3) v = j == 3 ? T(0) : -w[j];
      else if (j == 3) v = w[q];
      else if (q == j) v = T(0);
      else v = (q == 0 ? (j == 1 ? -w[2] : w[1])
                : q == 1 ? (j == 0 ? w[2] : -w[0])
                         : (j == 0 ? -w[1] : w[0]));
      return T(0.5) * v;
    }
    if (col >= k.i_w && col < k.i_w + 3) {         // ½ [[o_w I − [o_v]ₓ], [−o_vᵀ]]
      const int j = col - k.i_w;
      T v;
      if (q == 3) v = -o[j];
      else if (q == j) v = o[3];
      else v = (q == 0 ? (j == 1 ? o[2] : -o[1])
                : q == 1 ? (j == 0 ? -o[2] : o[0])
                         : (j == 0 ? o[1] : -o[0]));
      return T(0.5) * v;
    }
    return T(0);
  }
  if (row < k.i_rdot) return col == k.i_cdot + (row - 7) ? T(1) : T(0);
  if (row >= k.i_w && row < k.i_cdot) return W[col * 3 + (row - k.i_w)];
  return T(0);
}

// (∂ẋ/∂u)[row][col].
template <typename T>
__device__ T jac_xdot_u(int row, int col, const T* W, const srbd::Consts<T>& k) {
  if (row < k.i_rdot) return T(0);
  if (row < k.i_w) return col % 6 == 3 + (row - k.i_rdot) ? T(1) / k.m_scaled : T(0);
  if (row < k.i_cdot) return W[(k.nx + col) * 3 + (row - k.i_w)];
  const int e = row - k.i_cdot;
  return col == 6 * (e / 3) + e % 3 ? T(1) : T(0);
}

// Row i, column j of ∂(o ⊗ q)/∂o = [[q_w I − [q_v]ₓ, q_v], [−q_vᵀ, q_w]].
template <typename T>
__device__ T quat_err_jac(int i, int j, const T* q) {
  if (i == 3) return j == 3 ? q[3] : -q[j];
  if (j == 3) return q[i];
  if (i == j) return q[3];
  const int third = 3 - i - j;
  return j == (i + 1) % 3 ? q[third] : -q[third];
}

// (∂ρ/∂x)[g][col] of the stacked stage residual (the terminal residual's
// for g < 15 with the tracking mask 1).
template <typename T>
__device__ T jac_rho_x(int g, int col, const T* p, const T* W,
                       const srbd::Consts<T>& k) {
  const T mt = p[srbd::kP_mt];
  if (g == 0) return col == 2 ? mt * k.w_r : T(0);
  if (g < 5)
    return (col >= 3 && col < 7)
               ? (mt * p[srbd::kP_otg]) * quat_err_jac(g - 1, col - 3, p + srbd::kP_oref)
               : T(0);
  if (g < 8) return col == k.i_rdot + g - 5 ? mt * k.w_rdot : T(0);
  if (g < 11) return col == k.i_w + g - 8 ? mt * k.w_w : T(0);
  if (g < 15) {
    const T wrel = mt * k.w_rel;
    const int a = g < 13 ? 0 : 3 * (k.cm - 1);
    const int b = g < 13 ? 3 * k.cm : 3 * (k.nc - 1);
    const int ax = (g % 2 == 1) ? 1 : 0;
    T v = T(0);
    if (col == k.i_c + a + ax) v -= wrel;
    if (col == k.i_c + b + ax) v += wrel;
    return v;
  }
  if (g < 18) return T(0);
  if (g < 21) return k.w_qddot * W[col * 3 + (g - 18)];
  if (g < k.n_res) return T(0);
  int q = g - k.n_res;                             // √w_c · ∂stage_eq/∂x
  const int per = 2 * (k.cm - 1);
  const int n_rv = k.n_legs * per;
  T h;
  if (q < n_rv) {
    const int base = (q / per) * k.cm, rem = q % per;
    const int i = rem / 2 + 1, ax = rem % 2;
    h = (col == k.i_cdot + 3 * base + ax ? T(1) : T(0)) -
        (col == k.i_cdot + 3 * (base + i) + ax ? T(1) : T(0));
  } else if (q < n_rv + k.nc) {
    q -= n_rv;
    h = col == k.i_c + 3 * q + 2 ? T(1) : T(0);
  } else {
    q -= n_rv + k.nc;
    h = col == k.i_cdot + 3 * (q / 2) + q % 2 ? p[srbd::kP_cref + k.nc + q / 2] : T(0);
  }
  return k.wc * h;
}

// (∂ρ/∂u)[g][col].
template <typename T>
__device__ T jac_rho_u(int g, int col, const T* p, const T* W,
                       const srbd::Consts<T>& k) {
  const int nc = k.nc;
  if (g < 15) return T(0);
  if (g < 18) return col % 6 == 3 + (g - 15) ? k.w_qddot * (T(1) / k.m_scaled) : T(0);
  if (g < 21) return k.w_qddot * W[(k.nx + col) * 3 + (g - 18)];
  if (g < 21 + 3 * nc) {
    const int q = g - 21;
    return col == 6 * (q / 3) + q % 3 ? k.w_qddot : T(0);
  }
  if (g < 21 + 6 * nc) {
    const int q = g - 21 - 3 * nc;
    return col == 6 * (q / 3) + 3 + q % 3 ? k.w_minf : T(0);
  }
  if (g < k.n_res) {
    const int q = g - 21 - 6 * nc;
    return col == 6 * (q / 3) + 3 + q % 3
               ? k.w_fswitch * (T(1) - p[srbd::kP_cref + nc + q / 3])
               : T(0);
  }
  return T(0);
}

__host__ __device__ inline int warp_floats(int nx, int nu, int nc, int n_rho) {
  // x, u, ẋ, params, geometry, ∂ω̇ columns, ρ
  return 2 * nx + nu + srbd::param_width(nc) + kGeo + 3 * (nx + nu) + n_rho;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
srbd_linearize_kernel(const T* __restrict__ X, const T* __restrict__ U,
                      srbd::Params<T> P, const int* __restrict__ table,
                      int B, int ns, int n_rx, int n_ru, int n_gx, int n_gu,
                      srbd::Consts<T> k, T* __restrict__ Sx,
                      T* __restrict__ Bs, T* __restrict__ Jxp,
                      T* __restrict__ Jup, T* __restrict__ rho,
                      T* __restrict__ dfx, T* __restrict__ rt,
                      T* __restrict__ Jt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = k.nx, nu = k.nu, nc = k.nc, nr = k.n_rho;
  const int per_warp = warp_floats(nx, nu, nc, nr);
  const int n_tab = n_rx + n_ru + n_gx + n_gu;
  int* tab = reinterpret_cast<int*>(
      reinterpret_cast<T*>(smem_raw) + kWarps * per_warp);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int* rx = tab;
  const int* ru = rx + n_rx;
  const int* gx = ru + n_ru;
  const int* gu = gx + n_gx;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (gw >= static_cast<long long>(B) * (ns + 1)) return;   // whole warp leaves
  const size_t b = gw / (ns + 1);
  const int n = static_cast<int>(gw % (ns + 1));

  T* x = reinterpret_cast<T*>(smem_raw) + warp * per_warp;
  T* u = x + nx;
  T* xd = u + nu;
  T* p = xd + nx;
  T* geo = p + srbd::param_width(nc);
  T* W = geo + kGeo;
  T* rh = W + 3 * (nx + nu);

  const T* Xb = X + (b * (ns + 1) + n) * nx;
  for (int j = lane; j < nx; j += 32) x[j] = Xb[j];
  srbd::load_params(P, b * (ns + 1) + n, nc, lane, p);

  if (n == ns) {                     // the terminal pair rt, Jt
    __syncwarp();
    if (lane == 0) p[srbd::kP_mt] = T(1);
    __syncwarp();
    if (lane < kTrack) rt[b * kTrack + lane] = srbd::tracking_row(lane, x, p, k);
    T* Jo = Jt + b * kTrack * nx;
    for (int e = lane; e < kTrack * nx; e += 32) {
      const int g = e / nx;
      Jo[e] = jac_rho_x(g, e - g * nx, p, W, k);   // rows < 15 never read W
    }
    return;
  }

  const size_t bn = b * ns + n;
  for (int j = lane; j < nu; j += 32) u[j] = U[bn * nu + j];
  __syncwarp();
  if (lane == 0) {
    srbd::body_rates(x, u, k, xd);
  } else if (lane == 1) {
    srbd::quat_to_rot(x + 3, geo);
    srbd::world_inertia(geo, k.I, geo + 9, geo + 18);
    geo[36] = srbd::adjugate3(geo + 18, geo + 27);
    const T* Iw = geo + 18;
    const T* w = x + k.i_w;
    for (int i = 0; i < 3; ++i)
      geo[37 + i] = Iw[i * 3] * w[0] + Iw[i * 3 + 1] * w[1] + Iw[i * 3 + 2] * w[2];
  }
  for (int j = lane; j < nx; j += 32) {
    T v;
    if (srbd::integrator_row(j, x, u, k, &v)) xd[j] = v;
  }
  __syncwarp();
  for (int col = lane; col < nx + nu; col += 32) {
    T m[3];
    rhs_column(col, x, u, xd, geo, k, m);
    const T* c = geo + 27;
    const T det = geo[36];
    for (int i = 0; i < 3; ++i)
      W[col * 3 + i] = (c[i * 3] * m[0] + c[i * 3 + 1] * m[1] + c[i * 3 + 2] * m[2]) / det;
  }
  for (int g = lane; g < nr; g += 32) rh[g] = srbd::stage_rho_row(g, x, u, xd, p, k);
  __syncwarp();

  T* So = Sx + bn * n_rx * nx;
  for (int e = lane; e < n_rx * nx; e += 32) {
    const int i = e / nx;
    So[e] = k.dt * jac_xdot_x(rx[i], e - i * nx, x, W, k);
  }
  T* Bo = Bs + bn * n_ru * nu;
  for (int e = lane; e < n_ru * nu; e += 32) {
    const int i = e / nu;
    Bo[e] = k.dt * jac_xdot_u(ru[i], e - i * nu, W, k);
  }
  T* Jxo = Jxp + bn * n_gx * nx;
  for (int e = lane; e < n_gx * nx; e += 32) {
    const int i = e / nx;
    Jxo[e] = jac_rho_x(gx[i], e - i * nx, p, W, k);
  }
  T* Juo = Jup + bn * n_gu * nu;
  for (int e = lane; e < n_gu * nu; e += 32) {
    const int i = e / nu;
    Juo[e] = jac_rho_u(gu[i], e - i * nu, p, W, k);
  }
  for (int g = lane; g < nr; g += 32) rho[bn * nr + g] = rh[g];
  const T* Xnext = Xb + nx;
  for (int j = lane; j < nx; j += 32) dfx[bn * nx + j] = (x[j] + k.dt * xd[j]) - Xnext[j];
}

template <typename T>
int launch(const void* X, const void* U, const void* const* params,
           const void* table, int B, int ns, int nc, int cm, int n_legs,
           int n_rx, int n_ru, int n_gx, int n_gu, const double* scalars,
           void* Sx, void* Bs, void* Jxp, void* Jup, void* rho, void* d,
           void* rt, void* Jt, void* stream) {
  const long long warps = static_cast<long long>(B) * (ns + 1);
  if (B == 0) return 0;
  const srbd::Consts<T> k = srbd::make_consts<T>(scalars, nc, cm, n_legs);
  const size_t bytes =
      sizeof(T) * kWarps * warp_floats(k.nx, k.nu, nc, k.n_rho) +
      sizeof(int) * (n_rx + n_ru + n_gx + n_gu);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  srbd_linearize_kernel<T><<<blocks, 32 * kWarps, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      srbd::make_params<T>(params), static_cast<const int*>(table), B, ns,
      n_rx, n_ru, n_gx, n_gu, k, static_cast<T*>(Sx), static_cast<T*>(Bs),
      static_cast<T*>(Jxp), static_cast<T*>(Jup), static_cast<T*>(rho),
      static_cast<T*>(d), static_cast<T*>(rt), static_cast<T*>(Jt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LINEARIZE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, const void* table, int B,    \
                      int ns, int nc, int cm, int n_legs, int n_rx, int n_ru, \
                      int n_gx, int n_gu, const double* scalars, void* Sx,    \
                      void* Bs, void* Jxp, void* Jup, void* rho, void* d,     \
                      void* rt, void* Jt, void* stream) {                     \
    return launch<T>(X, U, params, table, B, ns, nc, cm, n_legs, n_rx, n_ru,  \
                     n_gx, n_gu, scalars, Sx, Bs, Jxp, Jup, rho, d, rt, Jt,   \
                     stream);                                                 \
  }

LINEARIZE_ENTRY(srbd_linearize_f32, float)
LINEARIZE_ENTRY(srbd_linearize_f64, double)
