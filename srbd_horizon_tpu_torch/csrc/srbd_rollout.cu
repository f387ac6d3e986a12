// K3 — the line-search trial of the batched MS-DDP solver on the SRBD
// problem: the rollout, its cost and the Armijo test for every step size
// α of one call, in one launch; and srbd_evaluate, the cost and the
// largest defect of a given plan, with no rollout.
//
// Replaces: `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410),
// a `lax.scan` over the horizon, and the trial's `total_cost`/`_stage_rho`
// (:150-165) with the Armijo test (:843-853), all of which XLA fused on the
// TPU (the JAX package wrote no Pallas kernel for them), with the SRBD
// Euler step (srbd_horizon_tpu/models/srbd.py::srbd_xdot) fused in. Plain
// twin: `kernels/rollout.py::srbd_trial_plain`. Per member and α, for
// n = 0 … ns−1:
//     uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
//     x̂ₙ₊₁ = x̂ₙ + dt·ẋ(x̂ₙ, uₙ) − (1 − α) dₙ
// then
//     cost  = Σₙ ‖ρ(x̂ₙ, uₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²
//     merit = cost + ν (1 − α)² D
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min
// where ẋ is the SRBD double integrator with fSRBD accelerations and ρ the
// stacked stage residual (csrc/srbd_common.cuh holds both, shared with K4).
// A NaN `exp` stays NaN through the max (as torch.clamp and jnp.maximum
// keep it), so the comparison, and `ok`, is false. Built without
// --use_fast_math, so isfinite and NaN comparisons are exact.
//
// srbd_evaluate replaces `jax.vmap(MSDDP.total_cost)` and
// `jax.vmap(MSDDP._true_defects)` (msddp.py:1222, :1240, :1484-1490), the
// solve's starting cost and its final defect norm: per member
//     cost       = Σₙ ‖ρ(Xₙ, Uₙ, pₙ)‖² + ‖ρ_N(X_N, p_N)‖²
//     defect_max = maxₙ,ᵢ |Xₙ + dt·ẋ(Xₙ, Uₙ) − Xₙ₊₁|ᵢ   (NaN if any is NaN)
// Plain twin: `kernels/rollout.py::srbd_evaluate_plain`.
//
// Both are compiled for the sizes of `srbd::Shape` only, so every loop over
// rows and columns has a constant trip count and every offset is a
// constant; the wrappers refuse other sizes.
//
// What bounds K3 on an H100: one (member, α) reads the gains, the plan, the
// defects and 20 parameter values per node, ~1.0k values per node (4 KB in
// f32), and does ~2.3k FLOP of rollout and ~0.4k of residual per node. At
// B=512, ns=20 and one α that is ~42 MB (0.013 ms at 3.35 TB/s), so bytes
// bound the work; but each member is a chain of 20 dependent nodes, and at
// B ≤ 528 the card holds at most four of those chains an SM, one a warp
// scheduler, so the chain's latency sets the time: K3 takes about as long
// at B=1 as at B=512 (`k3_size_probe` in chip_smoke.py prints both). The
// first design paid several device-memory round trips per node in that chain,
// walked the gain rows with stride 37 through L1, and ran the rigid-body
// rates on one lane; it took ~10× the byte bound. This one takes ~0.048 ms
// at B=512 and ~0.046 ms at B=1 with one α on an H100 at 700 W
// (`k3_size_probe`): ~2.3 µs a node of chain, 3.6× the byte bound, spent
// about equally in the rigid-body rates, the residual rows and the rest.
//
// Design: one warp per (member, α); consecutive warps of a block are the
// α's of one member. Nothing a later node reads depends on the state, so
// while node n computes, the warp's lanes copy node n+2's K, U, k, X, d and
// parameters into a per-warp ring of three node buffers in shared memory
// with cp.async (16-byte copies for K, U and k, which start 16-byte aligned
// for every node); the chain then waits on arithmetic, not on device
// memory. K(x̂−X) reads K from shared memory, where the row
// stride 37 is free of bank conflicts, with four partial sums a row to
// shorten the dependent chain. The rigid-body rates (csrc/srbd_common.cuh)
// run on every lane in registers — R I Rᵀ, its cofactors and Iw ω need x̂
// only and run beside K(x̂−X); the contact forces and torques are summed
// one contact a lane with xor shuffles — so no lane carries them alone and
// no shared-memory round trip or warp barrier sits in the chain for them.
// At each node the lanes evaluate the 73 residual rows in two passes laid
// out so that the lanes of a pass take few distinct paths
// (`stage_sq_lane`), and keep their squares in a register; the terminal
// rows follow the loop, and one warp reduction gives the cost. The sum is
// taken in another order than the plain twin's, so the two agree to
// rounding, not bit for bit.
//
// srbd_evaluate: one block per member and one warp per node (ns+1 warps).
// The nodes do not depend on one another, so all of them load and compute
// at once; each warp sums its node's squared rows and takes the largest
// |defect| of its node (NaN kept), and the node sums are added in node
// order, the terminal node last, as the twin adds the stage sum and the
// terminal sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "srbd_common.cuh"
#include "dmma.cuh"

namespace {

using S = srbd::Shape;
using L = srbd::Layout<S>;
constexpr int kWarps = 4;
constexpr int kStages = 3;           // node buffers a warp: the ring's depth
constexpr int kUnknownShape = -2;    // the sizes are not srbd::Shape's

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// One node's inputs in a warp's buffer. K, U and k start 16-byte aligned
// (nu·nx and nu are multiples of 4).
template <typename T>
struct NodeBuf {
  static constexpr int vec = 16 / static_cast<int>(sizeof(T));
  static constexpr int K = 0, U = S::nu * S::nx, k = U + S::nu,
                       X = k + S::nu, d = X + S::nx, p = d + S::nx;
  static constexpr int size = round_up(p + L::pw, vec);
  static_assert(U % vec == 0 && S::nu % vec == 0, "16-byte copies");
};

// A warp's shared memory: kStages node buffers, then x̂, x̂ − X and u.
template <typename T>
struct TrialWarp {
  using NB = NodeBuf<T>;
  static constexpr int xh = kStages * NB::size, dx = xh + S::nx,
                       u = dx + S::nx;
  static constexpr int size = round_up(u + S::nu, NB::vec);
};

// Lane e's entry of the packed parameter rows of one member: entry e of
// node n lives at base + n·stride (the same for every node, so the copies
// of a node take no branch on e).
template <typename T>
struct ParamLane {
  const T* base;
  int stride;
};

template <typename T>
__device__ ParamLane<T> param_lane(const srbd::Params<T>& P, size_t b, int ns,
                                   int lane) {
  const int e = lane < L::pw ? lane : 0;
  const T* first = srbd::param_src<S>(P, b * (ns + 1), e);
  return {first, static_cast<int>(srbd::param_src<S>(P, b * (ns + 1) + 1, e) - first)};
}

// The lanes of one warp start the copies of node n (n < ns) into `buf`, or
// of the terminal parameters (n == ns), and close them into one group; past
// the terminal node (n > ns) the group is empty.
template <typename T>
__device__ void issue_node(T* buf, const T* __restrict__ Ks,
                           const T* __restrict__ U, const T* __restrict__ ks,
                           const T* __restrict__ X, const T* __restrict__ d,
                           const ParamLane<T>& pl, size_t b, int n, int ns,
                           int lane) {
  using NB = NodeBuf<T>;
  constexpr int vec = NB::vec;
  const size_t row = b * (ns + 1) + n;
  if (lane < L::pw && n <= ns)
    cp_async<sizeof(T)>(buf + NB::p + lane,
                        pl.base + static_cast<size_t>(n) * pl.stride);
  if (n < ns) {
    const size_t bn = b * ns + n;
    const T* Kb = Ks + bn * (S::nu * S::nx);
    for (int c = lane; c < S::nu * S::nx / vec; c += 32)
      cp_async<16>(buf + NB::K + c * vec, Kb + c * vec);
    constexpr int half = S::nu / vec;              // U, then k, side by side
    for (int c = lane; c < 2 * half; c += 32) {
      const T* src = c < half ? U + bn * S::nu + c * vec
                              : ks + bn * S::nu + (c - half) * vec;
      cp_async<16>(buf + NB::U + c * vec, src);
    }
    for (int j = lane; j < S::nx; j += 32) {
      cp_async<sizeof(T)>(buf + NB::X + j, X + row * S::nx + j);
      cp_async<sizeof(T)>(buf + NB::d + j, d + bn * S::nx + j);
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
srbd_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                  const T* __restrict__ U, const T* __restrict__ ks,
                  const T* __restrict__ Ks, const T* __restrict__ d,
                  const T* __restrict__ alphas, srbd::Params<T> P,
                  const T* __restrict__ merit0, const T* __restrict__ Dsq,
                  const T* __restrict__ dV1, const T* __restrict__ dV2,
                  int B, int ns, int nA, srbd::Consts<T> k, T nu_w, T beta,
                  T alpha_min, T* __restrict__ Xn, T* __restrict__ Un,
                  T* __restrict__ cost_out, T* __restrict__ merit_out,
                  bool* __restrict__ ok_out) {
  using NB = NodeBuf<T>;
  using W = TrialWarp<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(B) * nA) return;   // whole warp leaves
  const size_t b = g / nA;
  const size_t a = g % nA;

  T* sw = reinterpret_cast<T*>(smem_raw) + warp * W::size;
  T* xh = sw + W::xh;
  T* dx = sw + W::dx;
  T* u = sw + W::u;
  const ParamLane<T> pl = param_lane(P, b, ns, lane);
  for (int n = 0; n < kStages - 1; ++n)
    issue_node(sw + n * NB::size, Ks, U, ks, X, d, pl, b, n, ns, lane);
  const T alpha = alphas[a];
  const T om = T(1) - alpha;
  for (int j = lane; j < S::nx; j += 32) xh[j] = x0[b * S::nx + j];

  T acc = T(0);   // this lane's share of Σ‖ρ‖²
  for (int n = 0; n < ns; ++n) {
    const T* buf = sw + (n % kStages) * NB::size;
    // node n + kStages − 1 (the terminal parameters after the last stage
    // node) streams into the ring while node n computes
    const int ahead = n + kStages - 1;
    issue_node(sw + (ahead % kStages) * NB::size, Ks, U, ks, X, d, pl, b,
               ahead, ns, lane);
    cp_async_wait_group<kStages - 1>();            // node n has arrived
    __syncwarp();
    T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * S::nx;
    for (int j = lane; j < S::nx; j += 32) {
      dx[j] = xh[j] - buf[NB::X + j];
      Xo[j] = xh[j];
    }
    __syncwarp();
    // the geometry needs x̂ only: it runs beside K(x̂ − X)
    const srbd::Geometry<T> geo = srbd::geometry<S>(xh, k);
    {   // uₙ: row i of K(x̂ − X) on lane i (the lanes past nu repeat the
        // last), four partial sums to shorten the chain
      const int i = lane < S::nu ? lane : S::nu - 1;
      const T* Kr = buf + NB::K + i * S::nx;
      T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
      for (int j = 0; j + 3 < S::nx; j += 4) {
        s0 += Kr[j] * dx[j];
        s1 += Kr[j + 1] * dx[j + 1];
        s2 += Kr[j + 2] * dx[j + 2];
        s3 += Kr[j + 3] * dx[j + 3];
      }
#pragma unroll
      for (int j = S::nx / 4 * 4; j < S::nx; ++j) s0 += Kr[j] * dx[j];
      const T ui = (buf[NB::U + i] + alpha * buf[NB::k + i]) + ((s0 + s1) + (s2 + s3));
      if (lane < S::nu) {
        u[i] = ui;
        Un[((a * B + b) * ns + n) * S::nu + i] = ui;
      }
    }
    __syncwarp();
    const srbd::Rigid<T> rig = srbd::rigid_rates<S>(xh, u, k, geo, lane);
    acc += srbd::stage_sq_lane<S>(lane, xh, u, rig, buf + NB::p, k);
    T xn[2];                                       // nx ≤ 64: two rows a lane
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < S::nx)
        xn[c] = (xh[j] + k.dt * srbd::xdot_row<S>(j, xh, u, rig)) -
                om * buf[NB::d + j];
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < S::nx) xh[j] = xn[c];
    }
    __syncwarp();
  }
  cp_async_wait_group<0>();
  __syncwarp();
  const T* pT = sw + (ns % kStages) * NB::size + NB::p;
  T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * S::nx;
  for (int j = lane; j < S::nx; j += 32) Xo[j] = xh[j];
  if (lane < S::nt) {
    const T v = srbd::tracking_row<S>(lane, xh, pT, T(1), k);
    acc += v * v;
  }
  const T cost = srbd::warp_sum(acc);
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

// srbd_evaluate: a warp's shared memory (x, u, params)
template <typename T>
struct EvalWarp {
  static constexpr int x = 0, u = S::nx, p = u + S::nu;
  static constexpr int size = round_up(p + L::pw, 2);
};

template <typename T>
__global__ void __launch_bounds__(1024)
srbd_evaluate_kernel(const T* __restrict__ X,
                                     const T* __restrict__ U,
                                     srbd::Params<T> P, int ns,
                                     srbd::Consts<T> k,
                                     T* __restrict__ cost_out,
                                     T* __restrict__ dmax_out) {
  using W = EvalWarp<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t b = blockIdx.x;
  T* sw = reinterpret_cast<T*>(smem_raw) + n * W::size;
  T* node_cost = reinterpret_cast<T*>(smem_raw) + (ns + 1) * W::size;
  T* node_dmax = node_cost + (ns + 1);
  T* x = sw + W::x;
  T* u = sw + W::u;
  T* p = sw + W::p;
  const size_t row = b * (ns + 1) + n;
  for (int j = lane; j < S::nx; j += 32) x[j] = X[row * S::nx + j];
  srbd::load_params<S>(P, row, lane, p);
  T acc = T(0), dm = T(0);
  if (n < ns) {                                    // warp-uniform
    if (lane < S::nu) u[lane] = U[(b * ns + n) * S::nu + lane];
    __syncwarp();
    const srbd::Geometry<T> geo = srbd::geometry<S>(x, k);
    const srbd::Rigid<T> rig = srbd::rigid_rates<S>(x, u, k, geo, lane);
    acc = srbd::stage_sq_lane<S>(lane, x, u, rig, p, k);
    const T* Xnext = X + (row + 1) * S::nx;
    for (int j = lane; j < S::nx; j += 32) {
      const T step = x[j] + k.dt * srbd::xdot_row<S>(j, x, u, rig);
      dm = srbd::nan_max(dm, srbd::abs_nan(step - Xnext[j]));
    }
  } else {
    __syncwarp();
    if (lane < S::nt) {
      const T v = srbd::tracking_row<S>(lane, x, p, T(1), k);
      acc = v * v;
    }
  }
  acc = srbd::warp_sum(acc);
  dm = srbd::warp_nan_max(dm);
  if (lane == 0) {
    node_cost[n] = acc;
    node_dmax[n] = dm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T c = T(0), m = T(0);
    for (int i = 0; i < ns; ++i) {
      c += node_cost[i];
      m = srbd::nan_max(m, node_dmax[i]);
    }
    cost_out[b] = c + node_cost[ns];
    dmax_out[b] = m;
  }
}

bool is_shape(int nc, int cm, int n_legs) {
  return nc == S::nc && cm == S::cm && n_legs == S::n_legs;
}

template <typename T>
int launch_trial(const void* x0, const void* X, const void* U, const void* ks,
                 const void* Ks, const void* d, const void* alphas,
                 const void* const* params, const void* merit0,
                 const void* D, const void* dV1, const void* dV2, int B,
                 int ns, int nc, int cm, int n_legs, int nA,
                 const double* scalars, double nu_w, double beta,
                 double alpha_min, void* Xn, void* Un, void* cost,
                 void* merit, void* ok, void* stream) {
  if (!is_shape(nc, cm, n_legs)) return kUnknownShape;
  const long long pairs = static_cast<long long>(B) * nA;
  if (pairs == 0) return 0;
  const size_t bytes = sizeof(T) * kWarps * TrialWarp<T>::size;
  auto kernel = srbd_trial_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  kernel<<<blocks, 32 * kWarps, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), srbd::make_params<T>(params),
      static_cast<const T*>(merit0), static_cast<const T*>(D),
      static_cast<const T*>(dV1), static_cast<const T*>(dV2), B, ns, nA,
      srbd::make_consts<T>(scalars), static_cast<T>(nu_w),
      static_cast<T>(beta), static_cast<T>(alpha_min), static_cast<T*>(Xn),
      static_cast<T*>(Un), static_cast<T*>(cost), static_cast<T*>(merit),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_evaluate(const void* X, const void* U, const void* const* params,
                    int B, int ns, int nc, int cm, int n_legs,
                    const double* scalars, void* cost, void* dmax,
                    void* stream) {
  if (!is_shape(nc, cm, n_legs)) return kUnknownShape;
  if (ns + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t bytes = sizeof(T) * (ns + 1) * (EvalWarp<T>::size + 2);
  srbd_evaluate_kernel<T><<<B, 32 * (ns + 1), bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      srbd::make_params<T>(params), ns, srbd::make_consts<T>(scalars),
      static_cast<T*>(cost), static_cast<T*>(dmax));
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
    return launch_trial<T>(x0, X, U, ks, Ks, d, alphas, params, merit0, D,    \
                           dV1, dV2, B, ns, nc, cm, n_legs, nA, scalars,      \
                           nu_w, beta, alpha_min, Xn, Un, cost, merit, ok,    \
                           stream);                                           \
  }

TRIAL_ENTRY(srbd_trial_f32, float)
TRIAL_ENTRY(srbd_trial_f64, double)

#define EVALUATE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, int B, int ns, int nc,       \
                      int cm, int n_legs, const double* scalars, void* cost,  \
                      void* dmax, void* stream) {                             \
    return launch_evaluate<T>(X, U, params, B, ns, nc, cm, n_legs, scalars,   \
                              cost, dmax, stream);                            \
  }

EVALUATE_ENTRY(srbd_evaluate_f32, float)
EVALUATE_ENTRY(srbd_evaluate_f64, double)
