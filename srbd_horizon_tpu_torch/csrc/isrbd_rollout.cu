// K6 — the line-search trial of the batched MS-DDP solver on the isrbd AL
// inner problem: the rollout, its cost and the Armijo test for every step
// size α of one call, in one launch.
//
// Replaces: `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410),
// a `lax.scan` over the horizon, and the trial's `total_cost`/`_stage_rho`
// (:150-165) with the Armijo test (:843-853) on the AL inner OCP
// (srbd_horizon_tpu/solvers/alddp.py:215-256), all of which XLA fused on
// the TPU (the JAX package wrote no Pallas kernel for them). Plain twin:
// `kernels/isrbd_rollout.py::isrbd_trial_plain`. Per member and α, for
// n = 0 … ns−1:
//     uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
//     x̂ₙ₊₁ = rk2(x̂ₙ, uₙ) − (1 − α) dₙ        rk2: x + dt·ẋ(x + dt/2·ẋ(x,u), u)
// then
//     cost  = Σₙ ‖ρ(x̂ₙ, uₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²     (240 + 101 rows)
//     merit = cost + ν (1 − α)² D
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min
// where ẋ is the double integrator with input accelerations and ρ, ρ_N the
// inner stage and terminal stacks (csrc/isrbd_common.cuh holds both,
// shared with K5). A NaN `exp` stays NaN through the max (as torch.clamp
// and jnp.maximum keep it), so the comparison, and `ok`, is false. Built
// without --use_fast_math, so isfinite and NaN comparisons are exact.
//
// What bounds it on an H100: one (member, α) reads per node the gains
// (30×37), the plan, the defects and 358 parameter values, ~1.6k values
// (6.4 KB in f32), and does ~2.3k FLOP of gain application and ~1.5k of
// residual rows. At B=256, ns=20 and one α that is ~35 MB (0.010 ms at
// 3.35 TB/s) against ~20 MFLOP, so bytes bound it; in practice the
// 20-step dependent chain per member and the launch dominate at this size.
//
// Design (K3's before K3 was redesigned with a prefetch buffer, which K6
// has not had yet): one warp per (member, α); consecutive warps of a block are
// the α's of one member, so the member's gains are read once from device
// memory and reused from L1/L2 by its other α's. The 30 rows of K(x̂−X)
// spread over the lanes; the double integrator needs no coupled solve, so
// every lane forms its own rows of ẋ and of the midpoint; lane 0 prepares
// R I Rᵀ and Iw ω for the Euler rows. The state lives in per-warp shared
// memory across the node loop. At each node the lanes evaluate the 240
// stage rows (eight per lane) and keep their squares in a register; the
// 101 terminal rows follow the loop, and one warp reduction (shuffles)
// gives the cost. The sum is taken in another order than the plain
// twin's, so the two agree to rounding, not bit for bit. Simple first: no
// cross-node prefetch. The stage and terminal rows (isrbd_common.cuh) also
// serve isrbd_evaluate, below.
//
// isrbd_evaluate, the second entry of this file, evaluates a given plan
// with the same stage and terminal rows (csrc/isrbd_common.cuh) and the
// same RK2 step: it replaces `jax.vmap(MSDDP.total_cost)` and
// `jax.vmap(MSDDP._true_defects)` (msddp.py:1222, :1240, :1484-1490) on the
// AL inner OCP, the solve's starting cost and its final defect norm. Per
// member
//     cost       = Σₙ ‖ρ(Xₙ, Uₙ, pₙ)‖² + ‖ρ_N(X_N, p_N)‖²
//     defect_max = maxₙ,ᵢ |rk2(Xₙ, Uₙ) − Xₙ₊₁|ᵢ   (NaN if any is NaN)
// Plain twin: `kernels/isrbd_rollout.py::isrbd_evaluate_plain`. One block
// per member and one warp per node (ns+1 warps): the nodes do not depend
// on one another, so all of them load and compute at once. Each warp sums
// its node's squared rows (the 240 stage rows, or the 101 terminal rows)
// and takes the largest |defect| of its node (NaN kept); the node sums
// are added in node order, the terminal node last, as the twin adds the
// stage sum and the terminal sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "isrbd_common.cuh"

namespace {

constexpr int kWarps = 4;

__host__ __device__ inline int warp_floats(int nx, int nu, int n_par) {
  return 3 * nx + nu + n_par + isrbd::kGeo;      // x̂, x̂−X, x_mid, u, p, geo
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
isrbd_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                   const T* __restrict__ U, const T* __restrict__ ks,
                   const T* __restrict__ Ks, const T* __restrict__ d,
                   const T* __restrict__ alphas, isrbd::Params<T> P,
                   const T* __restrict__ merit0, const T* __restrict__ Dsq,
                   const T* __restrict__ dV1, const T* __restrict__ dV2,
                   int B, int ns, int nA, isrbd::Consts<T> k, T nu_w, T beta,
                   T alpha_min, T* __restrict__ Xn, T* __restrict__ Un,
                   T* __restrict__ cost_out, T* __restrict__ merit_out,
                   bool* __restrict__ ok_out) {
  using namespace isrbd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = k.nx, nu = k.nu;
  const int n_par = k.po[kParams];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(B) * nA) return;   // whole warp leaves
  const size_t b = g / nA;
  const size_t a = g % nA;

  T* xh = reinterpret_cast<T*>(smem_raw) + warp * warp_floats(nx, nu, n_par);
  T* dx = xh + nx;
  T* xm = dx + nx;
  T* u = xm + nx;
  T* p = u + nu;
  T* geo = p + n_par;
  const T alpha = alphas[a];
  const T om = T(1) - alpha;
  const T hdt = T(0.5) * k.dt;
  for (int j = lane; j < nx; j += 32) xh[j] = x0[b * nx + j];
  __syncwarp();

  T acc = T(0);   // this lane's share of Σ‖ρ‖²
  for (int n = 0; n < ns; ++n) {
    const T* Xb = X + (b * (ns + 1) + n) * nx;
    T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * nx;
    for (int j = lane; j < nx; j += 32) {
      dx[j] = xh[j] - Xb[j];
      Xo[j] = xh[j];
    }
    load_params(P, b * (ns + 1) + n, k, lane, p);
    __syncwarp();
    const size_t bn = b * ns + n;
    const T* Kb = Ks + bn * nu * nx;
    T* Uo = Un + ((a * B + b) * ns + n) * nu;
    for (int i = lane; i < nu; i += 32) {
      T s = T(0);
      for (int j = 0; j < nx; ++j) s += Kb[i * nx + j] * dx[j];
      const T ui = (U[bn * nu + i] + alpha * ks[bn * nu + i]) + s;
      u[i] = ui;
      Uo[i] = ui;
    }
    if (lane == 0) node_geometry(xh, p, k, geo, static_cast<T*>(nullptr));
    __syncwarp();
    for (int j = lane; j < nx; j += 32) xm[j] = xh[j] + hdt * xdot_row(j, xh, u, k);
    for (int r = lane; r < k.n_rho; r += 32) {
      const T v = stage_rho_row(r, xh, u, geo, p, k);
      acc += v * v;
    }
    __syncwarp();
    const T* db = d + bn * nx;
    T xn[2];                      // nx ≤ 64: at most two rows a lane
    int c = 0;
    for (int j = lane; j < nx; j += 32)
      xn[c++] = (xh[j] + k.dt * xdot_row(j, xm, u, k)) - om * db[j];
    __syncwarp();
    c = 0;
    for (int j = lane; j < nx; j += 32) xh[j] = xn[c++];
    __syncwarp();
  }
  T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * nx;
  for (int j = lane; j < nx; j += 32) Xo[j] = xh[j];
  load_params(P, b * (ns + 1) + ns, k, lane, p);
  __syncwarp();
  for (int r = lane; r < k.n_term; r += 32) {
    const T v = terminal_rho_row(r, xh, p, k);
    acc += v * v;
  }
  const T cost = warp_sum(acc);
  if (lane == 0) {
    const T D = Dsq[b];
    const T merit = cost + (nu_w * (om * om)) * D;
    const T expected = -(alpha * dV1[b] + (alpha * alpha) * dV2[b]) +
                       ((T(2) * alpha - alpha * alpha) * nu_w) * D;
    const T exp_min = expected < T(1e-16) ? T(1e-16) : expected;  // NaN stays
    const size_t o = a * B + b;
    cost_out[o] = cost;
    merit_out[o] = merit;
    ok_out[o] = (merit0[b] - merit >= beta * exp_min) && isfinite(merit) &&
                (alpha >= alpha_min);
  }
}

template <typename T>
int launch(const void* x0, const void* X, const void* U, const void* ks,
           const void* Ks, const void* d, const void* alphas,
           const void* const* params, const void* merit0, const void* D,
           const void* dV1, const void* dV2, int B, int ns, int nc, int cm,
           int n_legs, int nA, const double* scalars, double nu_w,
           double beta, double alpha_min, void* Xn, void* Un, void* cost,
           void* merit, void* ok, void* stream) {
  const long long pairs = static_cast<long long>(B) * nA;
  if (pairs == 0) return 0;
  const isrbd::Consts<T> k = isrbd::make_consts<T>(scalars, nc, cm, n_legs);
  if (k.nx > 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      sizeof(T) * kWarps * warp_floats(k.nx, k.nu, k.po[isrbd::kParams]);
  const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  isrbd_trial_kernel<T><<<blocks, 32 * kWarps, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), isrbd::make_params<T>(params),
      static_cast<const T*>(merit0), static_cast<const T*>(D),
      static_cast<const T*>(dV1), static_cast<const T*>(dV2), B, ns, nA, k,
      static_cast<T>(nu_w), static_cast<T>(beta), static_cast<T>(alpha_min),
      static_cast<T*>(Xn), static_cast<T*>(Un), static_cast<T*>(cost),
      static_cast<T*>(merit), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// isrbd_evaluate: one block per member, one warp per node.
template <typename T>
__global__ void __launch_bounds__(1024)
isrbd_evaluate_kernel(const T* __restrict__ X, const T* __restrict__ U,
                      isrbd::Params<T> P, int ns, isrbd::Consts<T> k,
                      T* __restrict__ cost_out, T* __restrict__ dmax_out) {
  using namespace isrbd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = k.nx, nu = k.nu;
  const int n_par = k.po[kParams];
  const int per_warp = 2 * nx + nu + n_par + kGeo;   // x, x_mid, u, p, geo
  const int n = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t b = blockIdx.x;
  T* x = reinterpret_cast<T*>(smem_raw) + n * per_warp;
  T* xm = x + nx;
  T* u = xm + nx;
  T* p = u + nu;
  T* geo = p + n_par;
  T* node_cost = reinterpret_cast<T*>(smem_raw) + (ns + 1) * per_warp;
  T* node_dmax = node_cost + (ns + 1);
  const size_t row = b * (ns + 1) + n;
  for (int j = lane; j < nx; j += 32) x[j] = X[row * nx + j];
  load_params(P, row, k, lane, p);
  T acc = T(0), dm = T(0);
  if (n < ns) {                                    // warp-uniform
    for (int j = lane; j < nu; j += 32) u[j] = U[(b * ns + n) * nu + j];
    __syncwarp();
    if (lane == 0) node_geometry(x, p, k, geo, static_cast<T*>(nullptr));
    const T hdt = T(0.5) * k.dt;
    for (int j = lane; j < nx; j += 32) xm[j] = x[j] + hdt * xdot_row(j, x, u, k);
    __syncwarp();
    for (int r = lane; r < k.n_rho; r += 32) {
      const T v = stage_rho_row(r, x, u, geo, p, k);
      acc += v * v;
    }
    const T* Xnext = X + (row + 1) * nx;
    for (int j = lane; j < nx; j += 32)
      dm = nan_max(dm, abs_nan((x[j] + k.dt * xdot_row(j, xm, u, k)) - Xnext[j]));
  } else {
    __syncwarp();
    for (int r = lane; r < k.n_term; r += 32) {
      const T v = terminal_rho_row(r, x, p, k);
      acc += v * v;
    }
  }
  acc = warp_sum(acc);
  dm = warp_nan_max(dm);
  if (lane == 0) {
    node_cost[n] = acc;
    node_dmax[n] = dm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T c = T(0), m = T(0);
    for (int i = 0; i < ns; ++i) {
      c += node_cost[i];
      m = nan_max(m, node_dmax[i]);
    }
    cost_out[b] = c + node_cost[ns];
    dmax_out[b] = m;
  }
}

template <typename T>
int launch_evaluate(const void* X, const void* U, const void* const* params,
                    int B, int ns, int nc, int cm, int n_legs,
                    const double* scalars, void* cost, void* dmax,
                    void* stream) {
  if (ns + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const isrbd::Consts<T> k = isrbd::make_consts<T>(scalars, nc, cm, n_legs);
  const int per_warp = 2 * k.nx + k.nu + k.po[isrbd::kParams] + isrbd::kGeo;
  const size_t bytes = sizeof(T) * ((ns + 1) * per_warp + 2 * (ns + 1));
  auto kernel = isrbd_evaluate_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, 32 * (ns + 1), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      isrbd::make_params<T>(params), ns, k, static_cast<T*>(cost),
      static_cast<T*>(dmax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TRIAL_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(                                                        \
      const void* x0, const void* X, const void* U, const void* ks,           \
      const void* Ks, const void* d, const void* alphas,                      \
      const void* const* params, const void* merit0, const void* D,           \
      const void* dV1, const void* dV2, int B, int ns, int nc, int cm,        \
      int n_legs, int nA, const double* scalars, double nu_w, double beta,    \
      double alpha_min, void* Xn, void* Un, void* cost, void* merit,          \
      void* ok, void* stream) {                                               \
    return launch<T>(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1,     \
                     dV2, B, ns, nc, cm, n_legs, nA, scalars, nu_w, beta,     \
                     alpha_min, Xn, Un, cost, merit, ok, stream);             \
  }

TRIAL_ENTRY(isrbd_trial_f32, float)
TRIAL_ENTRY(isrbd_trial_f64, double)

#define EVALUATE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, int B, int ns, int nc,       \
                      int cm, int n_legs, const double* scalars, void* cost,  \
                      void* dmax, void* stream) {                             \
    return launch_evaluate<T>(X, U, params, B, ns, nc, cm, n_legs, scalars,   \
                              cost, dmax, stream);                            \
  }

EVALUATE_ENTRY(isrbd_evaluate_f32, float)
EVALUATE_ENTRY(isrbd_evaluate_f64, double)
