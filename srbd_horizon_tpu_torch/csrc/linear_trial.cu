// K13 — the line-search trial of the linearized forward pass
// (`forward_pass="linear"`): the affine δx recursion, the true defects and
// the cost of the plan it gives, and the Armijo test, for every step size
// α of one call, in one launch.
//
// Replaces: `MSDDP._forward_linear` (srbd_horizon_tpu/solvers/msddp.py:
// 1454-1482, an associative scan of affine maps), `_true_defects` (:1484)
// and `total_cost` (:158) inside `_parallel_line_search`'s trial
// (:1507-1531), which XLA fused on the TPU (the JAX package wrote no Pallas
// kernel for them). Plain twin: `kernels/linear_trial.py::linear_trial_plain`.
// Per member and α, from δx₀ = x0 − X₀, for n = 0 … ns−1:
//     ûₙ    = Uₙ + α kₙ + Kₙ δxₙ
//     δxₙ₊₁ = (Aₙ + BₙKₙ) δxₙ + α (Bₙkₙ + dₙ)
// with x̂ₙ = Xₙ + δxₙ, then
//     D̂     = Σₙ ‖step(x̂ₙ, ûₙ) − x̂ₙ₊₁‖²               (the true defects)
//     cost  = Σₙ ‖ρ(x̂ₙ, ûₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²
//     merit = cost + ν D̂
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D      (D the iterate's defects)
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min.
// A = I + Sx on the rows rx and B = Bs on the rows ru and the inputs uc (the
// sliced linearization K1 reads): (A + BK)δx = δx + Sx δx + Bs (Kδx)[uc] and
// Bk = Bs k[uc], over the live rows only. The recursion runs in node order
// (JAX composes the maps in a scan tree and applies the prefix products to
// δx₀), so the two agree to rounding, not bit for bit.
//
// The problem's step and rows come from the header its other kernels use,
// evaluated as they evaluate them, at float64 (`FAMILIES`, a policy struct
// each): the SRBD problem at K3's nine (topology, step) instances
// (csrc/srbd_common.cuh, K3's step and rows: the Kangaroo, the point-feet
// quadruped and the point-feet biped, each under Euler, RK2 and RK4), the
// LIP (csrc/lip_common.cuh, K11's), and the isrbd AL inner problem at both
// AL shapes (csrc/isrbd_common.cuh, K6's RK2 step of the double integrator
// and its 240 / 236 stage and 101 / 97 terminal rows). D̂ is measured in
// the problem's own step, as JAX's `_true_defects` takes `ocp.step`: under
// RK2 / RK4 `srbd::step_rows` forms the stage points in the warp's scratch
// (nx values; none under Euler). The kernel carries
// float32 tensors in float64 too, as K1 and K12 do, so that a float32 call
// differs from the float64 twin by the rounding of its inputs and outputs
// only.
//
// What bounds it on an H100: one (member, α) reads the gains, the plan, the
// sliced A and B, the defects and the parameter rows, ~2.5k values a node
// (~10 KB in float32; ~3.2k on the AL inner problem), and does ~4k FLOP of
// recursion, rates and residual rows a node; bytes bound it at fleet sizes
// (chip_smoke.py computes the bound from its inputs), and each (member, α)
// is a chain of ns dependent nodes, so at small B the chain's latency sets
// the time.
//
// Design: one warp per (member, α), as K3; the recursion's matrix-vector
// products a lane a row (K, Sx and Bs read from device memory through L1),
// the step and residual rows of the family's lane helpers, the sums over
// the lanes by xor shuffles. A simple kernel first: no cp.async ring yet,
// and the AL rows on the same warp as the chain (K6 gives them a warp of
// their own).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

#include "isrbd_common.cuh"
#include "lip_common.cuh"
#include "srbd_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kUnknownShape = -2;     // a family FAMILIES does not have

// The SRBD problem at the (topology, step) instance S (srbd::KangarooShape,
// QuadShape, PointFeetShape, or one of them under `srbd::Stepped<…, Rk2 |
// Rk4>`): sizes, the sliced rows' counts (K1's shape: every input is a
// live column of B, n_ru = nx under RK), constants, parameters, the
// node's rows and the step.
template <class S>
struct SrbdFamily {
  static constexpr int nx = S::nx, nu = S::nu, nt = S::nt, n_rx = S::n_rx,
                       n_ru = S::n_ru, n_gx = S::n_gx, n_gu = S::n_gu,
                       n_b = 3, n_uc = S::nu, pw = srbd::Layout<S>::pw,
                       scratch = srbd::stage_scratch<S>();
  using Consts = srbd::Consts<double>;
  template <typename T>
  using Params = srbd::Params<T>;
  static Consts consts(const double* s) { return srbd::make_consts<double>(s); }
  template <typename T>
  static Params<T> params(const void* const* p) {
    return srbd::make_params<T>(p);
  }
  // the lanes load member-node `row`'s packed parameter row into p
  template <typename T>
  __device__ static void load(const Params<T>& P, size_t row, int lane,
                              double* p) {
    if (lane < pw)
      p[lane] = static_cast<double>(*srbd::param_src<S>(P, row, lane));
  }
  // this lane's share of the node's Σ‖ρ‖², and the step's rows lane and
  // lane + 32 into step, its stage points in the warp's scratch xs (every
  // lane must call it: the shuffles)
  __device__ static double stage(int lane, const double* x, const double* u,
                                 const double* p, const Consts& k,
                                 double (&step)[2], double* xs) {
    const srbd::Geometry<double> g = srbd::geometry<S>(x, k);
    const srbd::Rigid<double> rig = srbd::rigid_rates<S>(x, u, k, g, lane);
    srbd::step_rows<S>(x, u, rig, k, lane, xs, step);
    return srbd::stage_sq_lane<S>(lane, x, u, rig, p, k);
  }
  __device__ static double terminal(int lane, const double* x,
                                    const double* p, const Consts& k) {
    if (lane >= nt) return 0.0;
    const double v = srbd::tracking_row<S>(lane, x, p, 1.0, k);
    return v * v;
  }
};

// The LIP problem (lip::Shape; K1's LipShape).
struct LipFamily {
  using S = lip::Shape;
  static constexpr int nx = S::nx, nu = S::nu, nt = S::nt, n_rx = S::n_rx,
                       n_ru = S::n_ru, n_gx = S::n_gx, n_gu = S::n_gu,
                       n_b = 6, n_uc = 15, pw = lip::Layout<S>::pw,
                       scratch = 0;
  using Consts = lip::Consts<double>;
  template <typename T>
  using Params = lip::Params<T>;
  static Consts consts(const double* s) { return lip::make_consts<double>(s); }
  template <typename T>
  static Params<T> params(const void* const* p) {
    return lip::make_params<T>(p);
  }
  template <typename T>
  __device__ static void load(const Params<T>& P, size_t row, int lane,
                              double* p) {
    if (lane < pw)
      p[lane] = static_cast<double>(*lip::param_src<S>(P, row, lane));
  }
  __device__ static double stage(int lane, const double* x, const double* u,
                                 const double* p, const Consts& k,
                                 double (&step)[2], double*) {
    step[0] = lane < nx ? x[lane] + k.dt * lip::xdot_row<S>(lane, x, u, k)
                        : 0.0;
    step[1] = 0.0;
    return lip::stage_sq_lane<S>(lane, x, u, p, k);
  }
  __device__ static double terminal(int lane, const double* x,
                                    const double* p, const Consts& k) {
    return lip::terminal_sq_lane<S>(lane, x, p, k);
  }
};

// The isrbd AL inner problem at the shape S (isrbd::KangarooAlShape,
// isrbd::QuadAlShape; K1's IsrbdAlShape and QuadAlShape): the RK2 step of
// the double integrator and the inner stage and terminal stacks, with the
// node's 21 parameter tensors packed into one row (K6's layout). The
// stage reads x and u side by side: the warp's buffers keep u right after
// x̂ (WarpBuf).
template <class S>
struct IsrbdAlFamily {
  static constexpr int nx = S::nx, nu = S::nu, nt = S::n_term,
                       n_rx = S::n_rx, n_ru = S::n_ru, n_gx = S::n_gx,
                       n_gu = S::n_gu, n_b = S::n_b, n_uc = S::n_uc,
                       pw = S::n_par, scratch = 0;
  using Consts = isrbd::Consts<S, double>;
  template <typename T>
  using Params = isrbd::Params<T>;
  static Consts consts(const double* s) {
    return isrbd::make_consts<S, double>(s);
  }
  template <typename T>
  static Params<T> params(const void* const* p) {
    return isrbd::make_params<T>(p);
  }
  template <typename T>
  __device__ static void load(const Params<T>& P, size_t row, int lane,
                              double* p) {
#pragma unroll
    for (int t = 0; t < isrbd::kParams; ++t) {
      const int dim = isrbd::param_dim<S>(t), off = isrbd::param_off<S>(t);
      const T* src = P.p[t] + row * dim;
      for (int e = lane; e < dim; e += 32)
        p[off + e] = static_cast<double>(src[e]);
    }
  }
  __device__ static double stage(int lane, const double* x, const double* u,
                                 const double* p, const Consts& k,
                                 double (&step)[2], double*) {
    const double* xu = x;                          // u == x + nx
    const double hdt = 0.5 * k.dt;
    const isrbd::Rates<double> rt = isrbd::rates<S>(xu, hdt);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      step[c] = j < nx ? isrbd::step_row<S>(j, xu, rt, hdt, k.dt) : 0.0;
    }
    const isrbd::Geometry<double> geo = isrbd::geometry(xu, k);
    double acc = 0.0;
    isrbd::stage_rows<false>(lane, xu, p, geo, k,
                             [&acc](int, double v) { acc += v * v; },
                             [](int, double) {});
    return acc;
  }
  __device__ static double terminal(int lane, const double* x,
                                    const double* p, const Consts& k) {
    double acc = 0.0;
    isrbd::terminal_rows(lane, x, p, k,
                         [&acc](int, double v) { acc += v * v; });
    return acc;
  }
};

// A warp's float64 buffers: δx, x̂, û, Kδx, the node's parameter row and
// the step's stage-point scratch.
template <class F>
struct WarpBuf {
  static constexpr int dx = 0, xh = dx + F::nx, u = xh + F::nx, w = u + F::nu,
                       p = w + F::nu, xs = p + (F::pw + 31) / 32 * 32,
                       size = xs + F::scratch;
  static_assert(F::nx <= 64 && F::nu <= 32, "lane layout");
};

// The block's rows: each state row's position in rx and in ru (or −1), then
// the live inputs uc.
template <class F>
struct BlockRows {
  static constexpr int rpos = 0, qpos = F::nx, uc = 2 * F::nx,
                       count = uc + F::n_uc;
  static constexpr int table_uc =
      F::n_rx + F::n_ru + F::n_gx + F::n_gu + 2 * F::n_b;
};

template <class F, typename T>
__global__ void __launch_bounds__(32 * kWarps)
linear_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                    const T* __restrict__ U, const T* __restrict__ ks,
                    const T* __restrict__ Ks, const T* __restrict__ Sx,
                    const T* __restrict__ Bs, const T* __restrict__ d,
                    const int* __restrict__ table,
                    const T* __restrict__ alphas,
                    typename F::template Params<T> P,
                    const T* __restrict__ merit0, const T* __restrict__ Dsq,
                    const T* __restrict__ dV1, const T* __restrict__ dV2,
                    int B, int ns, int nA, typename F::Consts k, double nu_w,
                    double beta, double alpha_min, T* __restrict__ Xn,
                    T* __restrict__ Un, T* __restrict__ cost_out,
                    T* __restrict__ merit_out, bool* __restrict__ ok_out) {
  using W = WarpBuf<F>;
  using R = BlockRows<F>;
  constexpr int nx = F::nx, nu = F::nu, n_rx = F::n_rx, n_ru = F::n_ru,
                n_uc = F::n_uc;
  __shared__ int rows[R::count];
  __shared__ double bufs[kWarps * W::size];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < 2 * nx; e += 32 * kWarps) rows[e] = -1;
  __syncthreads();
  for (int e = threadIdx.x; e < n_rx; e += 32 * kWarps) rows[R::rpos + table[e]] = e;
  for (int e = threadIdx.x; e < n_ru; e += 32 * kWarps)
    rows[R::qpos + table[n_rx + e]] = e;
  for (int e = threadIdx.x; e < n_uc; e += 32 * kWarps)
    rows[R::uc + e] = table[R::table_uc + e];
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(B) * nA) return;   // whole warp leaves
  const size_t b = g / nA;
  const size_t a = g % nA;
  double* const sw = bufs + warp * W::size;
  double* const dx = sw + W::dx;
  double* const xh = sw + W::xh;
  double* const u = sw + W::u;
  double* const w = sw + W::w;
  double* const p = sw + W::p;
  const double alpha = static_cast<double>(alphas[a]);
  const size_t row0 = b * (ns + 1);
  for (int j = lane; j < nx; j += 32)
    dx[j] = static_cast<double>(x0[b * nx + j]) -
            static_cast<double>(X[row0 * nx + j]);
  __syncwarp();

  double acc = 0.0, dsq = 0.0;   // this lane's shares of Σ‖ρ‖² and Σ‖d‖²
  for (int n = 0; n < ns; ++n) {
    const size_t bn = b * ns + n;
    T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * nx;
    for (int j = lane; j < nx; j += 32) {
      const double v = static_cast<double>(X[(row0 + n) * nx + j]) + dx[j];
      xh[j] = v;
      Xo[j] = static_cast<T>(v);
    }
    F::load(P, row0 + n, lane, p);
    __syncwarp();
    if (lane < nu) {             // ûₙ = (Uₙ + α kₙ) + Kₙ δxₙ
      const T* Kr = Ks + (bn * nu + lane) * nx;
      double s = 0.0;
      for (int j = 0; j < nx; ++j) s += static_cast<double>(Kr[j]) * dx[j];
      w[lane] = s;
      const double v = (static_cast<double>(U[bn * nu + lane]) +
                        alpha * static_cast<double>(ks[bn * nu + lane])) + s;
      u[lane] = v;
      Un[((a * B + b) * ns + n) * nu + lane] = static_cast<T>(v);
    }
    __syncwarp();
    double step[2];
    acc += F::stage(lane, xh, u, p, k, step, sw + W::xs);
    double nxt[2] = {0.0, 0.0};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < nx) {
        // δxₙ₊₁ = (A + BK)δx + α(Bk + d), over the live rows of Sx and Bs
        double m = dx[j], bk = 0.0;
        const int rr = rows[R::rpos + j], q = rows[R::qpos + j];
        if (rr >= 0) {
          const T* sr = Sx + (bn * n_rx + rr) * nx;
          double s = 0.0;
          for (int y = 0; y < nx; ++y) s += static_cast<double>(sr[y]) * dx[y];
          m += s;
        }
        if (q >= 0) {
          const T* br = Bs + (bn * n_ru + q) * n_uc;
          double s = 0.0;
          for (int cc = 0; cc < n_uc; ++cc) {
            const int uu = rows[R::uc + cc];
            const double bv = static_cast<double>(br[cc]);
            s += bv * w[uu];
            bk += bv * static_cast<double>(ks[bn * nu + uu]);
          }
          m += s;
        }
        const double dn =
            m + alpha * (bk + static_cast<double>(d[bn * nx + j]));
        const double xnext =
            static_cast<double>(X[(row0 + n + 1) * nx + j]) + dn;
        const double def = step[c] - xnext;
        dsq += def * def;
        nxt[c] = dn;
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < nx) dx[j] = nxt[c];
    }
    __syncwarp();
  }
  T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * nx;
  for (int j = lane; j < nx; j += 32) {
    const double v = static_cast<double>(X[(row0 + ns) * nx + j]) + dx[j];
    xh[j] = v;
    Xo[j] = static_cast<T>(v);
  }
  F::load(P, row0 + ns, lane, p);
  __syncwarp();
  acc += F::terminal(lane, xh, p, k);
  const double cost = rigid::warp_sum(acc);
  const double Dn = rigid::warp_sum(dsq);
  if (lane == 0) {
    const double D = static_cast<double>(Dsq[b]);
    const double merit = cost + nu_w * Dn;
    const double expected =
        -(alpha * static_cast<double>(dV1[b]) +
          (alpha * alpha) * static_cast<double>(dV2[b])) +
        ((2.0 * alpha - alpha * alpha) * nu_w) * D;
    const double exp_min = expected < 1e-16 ? 1e-16 : expected;  // NaN stays
    const size_t o = a * B + b;
    cost_out[o] = static_cast<T>(cost);
    merit_out[o] = static_cast<T>(merit);
    ok_out[o] = (static_cast<double>(merit0[b]) - merit >= beta * exp_min) &&
                isfinite(merit) && (alpha >= alpha_min);
  }
}

template <class F, typename T>
int launch(const void* x0, const void* X, const void* U, const void* ks,
           const void* Ks, const void* Sx, const void* Bs, const void* d,
           const void* rows, const void* alphas, const void* const* params,
           const void* merit0, const void* D, const void* dV1,
           const void* dV2, int B, int ns, int nA, const double* scalars,
           double nu_w, double beta, double alpha_min, void* Xn, void* Un,
           void* cost, void* merit, void* ok, void* stream) {
  const long long pairs = static_cast<long long>(B) * nA;
  if (pairs == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  linear_trial_kernel<F, T><<<blocks, 32 * kWarps, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(Sx),
      static_cast<const T*>(Bs), static_cast<const T*>(d),
      static_cast<const int*>(rows), static_cast<const T*>(alphas),
      F::template params<T>(params), static_cast<const T*>(merit0),
      static_cast<const T*>(D), static_cast<const T*>(dV1),
      static_cast<const T*>(dV2), B, ns, nA, F::consts(scalars), nu_w, beta,
      alpha_min, static_cast<T*>(Xn), static_cast<T*>(Un),
      static_cast<T*>(cost), static_cast<T*>(merit), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// fn(F{}) for the family at `index` (kernels/linear_trial.py::FAMILIES)
template <class Fn>
int with_family(int index, Fn fn) {
  switch (index) {
    case 0: return fn(SrbdFamily<srbd::KangarooShape>{});
    case 1: return fn(LipFamily{});
    case 2: return fn(SrbdFamily<srbd::QuadShape>{});
    case 3: return fn(IsrbdAlFamily<isrbd::KangarooAlShape>{});
    case 4: return fn(IsrbdAlFamily<isrbd::QuadAlShape>{});
    case 5: return fn(SrbdFamily<srbd::PointFeetShape>{});
    case 6: return fn(SrbdFamily<srbd::Stepped<srbd::KangarooShape, srbd::Rk2>>{});
    case 7: return fn(SrbdFamily<srbd::Stepped<srbd::KangarooShape, srbd::Rk4>>{});
    case 8: return fn(SrbdFamily<srbd::Stepped<srbd::QuadShape, srbd::Rk2>>{});
    case 9: return fn(SrbdFamily<srbd::Stepped<srbd::QuadShape, srbd::Rk4>>{});
    case 10: return fn(SrbdFamily<srbd::Stepped<srbd::PointFeetShape, srbd::Rk2>>{});
    case 11: return fn(SrbdFamily<srbd::Stepped<srbd::PointFeetShape, srbd::Rk4>>{});
    default: return kUnknownShape;
  }
}

template <class Kernel>
int occupancy(Kernel kernel, int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, 32 * kWarps, 0);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace

// `family` indexes FAMILIES; the sizes are the family's (the wrapper checks
// them). `scalars` holds the family's host constants (kernel_scalars).
#define LINEAR_TRIAL_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                        \
      int family, const void* x0, const void* X, const void* U,               \
      const void* ks, const void* Ks, const void* Sx, const void* Bs,         \
      const void* d, const void* rows, const void* alphas,                    \
      const void* const* params, const void* merit0, const void* D,           \
      const void* dV1, const void* dV2, int B, int ns, int nA,                \
      const double* scalars, double nu_w, double beta, double alpha_min,      \
      void* Xn, void* Un, void* cost, void* merit, void* ok, void* stream) {  \
    return with_family(family, [&](auto f) {                                  \
      return launch<decltype(f), T>(x0, X, U, ks, Ks, Sx, Bs, d, rows,        \
                                    alphas, params, merit0, D, dV1, dV2, B,   \
                                    ns, nA, scalars, nu_w, beta, alpha_min,   \
                                    Xn, Un, cost, merit, ok, stream);         \
    });                                                                       \
  }

LINEAR_TRIAL_ENTRY(linear_trial_f32, float)
LINEAR_TRIAL_ENTRY(linear_trial_f64, double)

// K13's occupancy for the family at `family` and float32 (f64 = 0) or
// float64 tensors: out[0] blocks an SM, out[1] static shared memory bytes a
// block, out[2] registers a thread, out[3] local bytes a thread.
extern "C" int linear_trial_occupancy(int family, int f64, int* out) {
  return with_family(family, [&](auto f) {
    using F = decltype(f);
    return f64 ? occupancy(linear_trial_kernel<F, double>, out)
               : occupancy(linear_trial_kernel<F, float>, out);
  });
}
