// K11 — the line-search trial of the batched MS-DDP solver on the LIP
// problem: the rollout, its cost and the Armijo test for every step size
// α of one call, in one launch; and lip_evaluate, the cost and the largest
// defect of a given plan, with no rollout.
//
// Replaces: `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410),
// a `lax.scan` over the horizon, and the trial's `total_cost` (:158) with
// the Armijo test of the line search (:1494-1578), all of which XLA fused
// on the TPU (the JAX package wrote no Pallas kernel for them), with the
// LIP Euler step (srbd_horizon_tpu/models/lip.py::lip_xdot) fused in.
// Plain twin: `kernels/lip_rollout.py::lip_trial_plain`. Per member and α,
// for n = 0 … ns−1:
//     uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
//     x̂ₙ₊₁ = x̂ₙ + dt·ẋ(x̂ₙ, uₙ) − (1 − α) dₙ
// then
//     cost  = Σₙ ‖ρ(x̂ₙ, uₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²
//     merit = cost + ν (1 − α)² D
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min
// where ẋ is the LIP double integrator and ρ the stacked stage residual
// (csrc/lip_common.cuh holds both, shared with K10). A NaN `exp` stays NaN
// through the max (as torch.clamp and jnp.maximum keep it), so the
// comparison, and `ok`, is false. Built without --use_fast_math, so
// isfinite and NaN comparisons are exact.
//
// lip_evaluate replaces `jax.vmap(MSDDP.total_cost)` and
// `jax.vmap(MSDDP._true_defects)` (msddp.py:1221-1240, :1484), the solve's
// starting cost and its final defect norm: per member
//     cost       = Σₙ ‖ρ(Xₙ, Uₙ, pₙ)‖² + ‖ρ_N(X_N, p_N)‖²
//     defect_max = maxₙ,ᵢ |Xₙ + dt·ẋ(Xₙ, Uₙ) − Xₙ₊₁|ᵢ   (NaN if any is NaN)
// and, given x0, node 0 pinned to x0 and the pinned plan written (the
// solve's pin, msddp.py:1221; x0's rows may lie apart). Plain twin:
// `kernels/lip_rollout.py::lip_evaluate_plain`.
//
// Both are compiled for the sizes of `lip::Shape` only, so every loop over
// rows and columns has a constant trip count; the wrappers refuse other
// sizes.
//
// What bounds K11 on an H100: one (member, α) reads the gains, the plan,
// the defects and 12 parameter values per node, ~570 values per node
// (2.3 KB in f32), and does ~0.9k FLOP of rollout and ~0.3k of residual
// per node. At B=512, ns=20 and one α that is ~23 MB (7 µs at 3.35 TB/s),
// so bytes bound the work; but each (member, α) is a chain of 20 dependent
// nodes, so at small B the chain's latency sets the time (chip_smoke.py's
// `lip_kernel_times` prints B = 1, 512, 4096).
//
// Design: one warp per (member, α); consecutive warps of a block are the
// α's of one member. Nothing a later node reads depends on the state, so
// while node n computes, the warp's lanes copy node n+2's K, U, k, X, d
// and parameters into a per-warp ring of three node buffers in shared
// memory with cp.async (two-element copies for K: nu·nx = 450 puts every
// node's K on an 8-byte boundary in f32, a 16-byte one in f64); the chain
// then waits on arithmetic, not on device memory. K(x̂ − X) takes two lanes
// a row, 15 columns each, joined by one shuffle; one Euler step is a row a
// lane; the 44 residual rows are two rows a lane, their squares kept in a
// register, and one warp reduction after the terminal rows gives the cost.
// The sums are taken in another order than the plain twin's, so the two
// agree to rounding, not bit for bit.
//
// What bounds lip_evaluate: one member reads its plan and parameters,
// ~1.2k values (4.7 KB in f32), and does ~0.3k FLOP a node; at B=512 that
// is ~2.4 MB, 0.7 µs at 3.35 TB/s: the card's fill and one node's latency
// set its time. Design as srbd_evaluate's: one block of seven warps a
// member stages the member's x, u and parameter rows into a record a node
// in shared memory with cp.async (neighbouring threads on neighbouring
// elements, x and u first, node 0's x from x0 when it is given); warp w
// evaluates nodes w, w+7, w+14 (its rows two a lane, its defects a row a
// lane); one warp sums the stage nodes over its lanes, and the terminal
// node last, as the twin adds the stage sum and the terminal sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "lip_common.cuh"
#include "dmma.cuh"

namespace {

using S = lip::Shape;
using L = lip::Layout<S>;
constexpr int kWarps = 4;
constexpr int kStages = 3;           // node buffers a warp: the ring's depth
constexpr int kUnknownShape = -2;    // the sizes are not lip::Shape's
constexpr int nx = S::nx, nu = S::nu;
static_assert(nx <= 32 && 2 * nu <= 32, "a row a lane, two lanes a K row");

// One node's inputs in a warp's buffer. K starts on a two-element boundary
// (the buffer's size is even).
struct NodeBuf {
  static constexpr int K = 0, U = nu * nx, k = U + nu, X = k + nu,
                       d = X + nx, p = d + nx;
  static constexpr int size = (p + L::pw + 1) / 2 * 2;
  static_assert(U % 2 == 0, "two-element copies of K");
};

// A warp's shared memory: kStages node buffers, then x̂, x̂ − X and u.
struct TrialWarp {
  static constexpr int xh = kStages * NodeBuf::size, dx = xh + nx,
                       u = dx + nx;
  static constexpr int size = (u + nu + 1) / 2 * 2;
};

// Lane e's entry of the packed parameter rows of one member: entry e of
// node n lives at base + n·stride.
template <typename T>
struct ParamLane {
  const T* base;
  int stride;
};

template <typename T>
__device__ ParamLane<T> param_lane(const lip::Params<T>& P, size_t b, int ns,
                                   int lane) {
  const int e = lane < L::pw ? lane : 0;
  const T* first = lip::param_src<S>(P, b * (ns + 1), e);
  return {first,
          static_cast<int>(lip::param_src<S>(P, b * (ns + 1) + 1, e) - first)};
}

// The lanes of one warp start the copies of node n (n < ns) into `buf`, or
// of the terminal parameters (n == ns), and close them into one group; past
// the terminal node (n > ns) the group is empty.
template <typename T>
__device__ void start_node(T* buf, const T* __restrict__ Ks,
                           const T* __restrict__ U, const T* __restrict__ ks,
                           const T* __restrict__ X, const T* __restrict__ d,
                           const ParamLane<T>& pl, size_t b, int n, int ns,
                           int lane) {
  using NB = NodeBuf;
  const size_t row = b * (ns + 1) + n;
  if (lane < L::pw && n <= ns)
    cp_async<sizeof(T)>(buf + NB::p + lane,
                        pl.base + static_cast<size_t>(n) * pl.stride);
  if (n < ns) {
    const size_t bn = b * ns + n;
    const T* Kb = Ks + bn * (nu * nx);
    for (int c = lane; c < nu * nx / 2; c += 32)
      cp_async<2 * sizeof(T)>(buf + NB::K + 2 * c, Kb + 2 * c);
    if (lane < nu) {
      cp_async<sizeof(T)>(buf + NB::U + lane, U + bn * nu + lane);
      cp_async<sizeof(T)>(buf + NB::k + lane, ks + bn * nu + lane);
    }
    if (lane < nx) {
      cp_async<sizeof(T)>(buf + NB::X + lane, X + row * nx + lane);
      cp_async<sizeof(T)>(buf + NB::d + lane, d + bn * nx + lane);
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
lip_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                 const T* __restrict__ U, const T* __restrict__ ks,
                 const T* __restrict__ Ks, const T* __restrict__ d,
                 const T* __restrict__ alphas, lip::Params<T> P,
                 const T* __restrict__ merit0, const T* __restrict__ Dsq,
                 const T* __restrict__ dV1, const T* __restrict__ dV2, int B,
                 int ns, int nA, lip::Consts<T> k, T nu_w, T beta,
                 T alpha_min, T* __restrict__ Xn, T* __restrict__ Un,
                 T* __restrict__ cost_out, T* __restrict__ merit_out,
                 bool* __restrict__ ok_out) {
  using NB = NodeBuf;
  using W = TrialWarp;
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
    start_node(sw + n * NB::size, Ks, U, ks, X, d, pl, b, n, ns, lane);
  const T alpha = alphas[a];
  const T om = T(1) - alpha;
  if (lane < nx) xh[lane] = x0[b * nx + lane];
  // K(x̂ − X): row i on lanes i and i + 16, columns 15h … 15h + 14
  const int ki = lane % 16 < nu ? lane % 16 : nu - 1, kh = lane / 16;
  constexpr int kHalf = (nx + 1) / 2;

  T acc = T(0);   // this lane's share of Σ‖ρ‖²
  for (int n = 0; n < ns; ++n) {
    const T* buf = sw + (n % kStages) * NB::size;
    // node n + kStages − 1 (the terminal parameters after the last stage
    // node) streams into the ring while node n computes
    const int ahead = n + kStages - 1;
    start_node(sw + (ahead % kStages) * NB::size, Ks, U, ks, X, d, pl, b,
               ahead, ns, lane);
    cp_async_wait_group<kStages - 1>();            // node n has arrived
    __syncwarp();
    T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * nx;
    if (lane < nx) {
      dx[lane] = xh[lane] - buf[NB::X + lane];
      Xo[lane] = xh[lane];
    }
    __syncwarp();
    {
      const T* Kr = buf + NB::K + ki * nx + kh * kHalf;
      const T* dr = dx + kh * kHalf;
      T s0 = T(0), s1 = T(0);
#pragma unroll
      for (int j = 0; j + 1 < kHalf; j += 2) {
        s0 += Kr[j] * dr[j];
        s1 += Kr[j + 1] * dr[j + 1];
      }
      if (kHalf % 2 == 1 && kh * kHalf + kHalf - 1 < nx)
        s0 += Kr[kHalf - 1] * dr[kHalf - 1];
      T sk = s0 + s1;
      sk += __shfl_xor_sync(0xffffffffu, sk, 16);
      const T ui = (buf[NB::U + ki] + alpha * buf[NB::k + ki]) + sk;
      if (lane < nu) {
        u[lane] = ui;
        Un[((a * B + b) * ns + n) * nu + lane] = ui;
      }
    }
    __syncwarp();
    acc += lip::stage_sq_lane<S>(lane, xh, u, buf + NB::p, k);
    T xn = T(0);
    if (lane < nx)
      xn = (xh[lane] + k.dt * lip::xdot_row<S>(lane, xh, u, k)) -
           om * buf[NB::d + lane];
    __syncwarp();
    if (lane < nx) xh[lane] = xn;
    __syncwarp();
  }
  cp_async_wait_group<0>();
  __syncwarp();
  const T* pT = sw + (ns % kStages) * NB::size + NB::p;
  T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * nx;
  if (lane < nx) Xo[lane] = xh[lane];
  acc += lip::terminal_sq_lane<S>(lane, xh, pT, k);
  const T cost = lip::warp_sum(acc);
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

// ---- lip_evaluate ----

constexpr int kEvalWarps = 7;                 // ns = 20: nodes w, w+7, w+14
constexpr int kEvalThreads = 32 * kEvalWarps;

// One node's record in shared memory: x, u and the packed parameter row.
struct EvalNode {
  static constexpr int x = 0, u = nx, p = u + nu, size = p + L::pw;
};

// The records, then the node sums and maxima.
template <typename T>
size_t evaluate_smem_bytes(int ns) {
  return sizeof(T) * ((ns + 1) * (EvalNode::size + 2));
}

// The block stages parameter tensors t … of the member's ns1 nodes (`row0`
// is its first row, b·ns1).
template <int t, typename T>
__device__ __forceinline__ void stage_params(T* s, const lip::Params<T>& P,
                                             size_t row0, int ns1, int tid) {
  if constexpr (t < lip::kParams) {
    constexpr int dim = lip::param_dim<S>(t);
    cp_async_rows<T, dim, kEvalThreads>(s + EvalNode::p + lip::param_off<S>(t),
                                        EvalNode::size, P.p[t] + row0 * dim,
                                        0, ns1, tid);
    stage_params<t + 1>(s, P, row0, ns1, tid);
  }
}
static_assert(lip::param_off<S>(lip::kParams) == L::pw &&
                  lip::param_off<S>(1) == lip::kP_rdot &&
                  lip::param_off<S>(2) == lip::kP_cref,
              "packed parameter row");

template <typename T>
__global__ void __launch_bounds__(kEvalThreads)
lip_evaluate_kernel(const T* __restrict__ X, const T* __restrict__ U,
                    const T* __restrict__ x0, int x0_stride,
                    lip::Params<T> P, int ns, lip::Consts<T> k,
                    T* __restrict__ cost_out, T* __restrict__ dmax_out,
                    T* __restrict__ Xpin) {
  using EN = EvalNode;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ns1 = ns + 1;
  T* node_cost = s + ns1 * EN::size;
  T* node_dmax = node_cost + ns1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t b = blockIdx.x;
  const size_t row0 = b * ns1;
  int from = 0;
  if (x0 != nullptr) {
    cp_async_rows<T, nx, kEvalThreads>(s + EN::x, EN::size,
                                       x0 + b * x0_stride, 0, 1, tid);
    from = 1;
  }
  cp_async_rows<T, nx, kEvalThreads>(s + EN::x, EN::size, X + row0 * nx,
                                     from, ns1, tid);
  cp_async_rows<T, nu, kEvalThreads>(s + EN::u, EN::size, U + b * ns * nu, 0,
                                     ns, tid);
  cp_async_commit();
  stage_params<0>(s, P, row0, ns1, tid);
  cp_async_commit();
  cp_async_wait_group<1>();                        // x and u are in
  __syncthreads();
  if (Xpin != nullptr) {                           // the pinned plan, as staged
    T* out = Xpin + row0 * nx;
    for (int i = tid; i < ns1 * nx; i += kEvalThreads) {
      const int n = i / nx;
      out[i] = s[n * EN::size + EN::x + (i - n * nx)];
    }
  }
  cp_async_wait_group<0>();                        // the parameter rows too
  __syncthreads();
  for (int n = warp; n < ns1; n += kEvalWarps) {
    const T* rec = s + n * EN::size;
    const T* x = rec + EN::x;
    T acc, dm = T(0);
    if (n < ns) {                                  // warp-uniform
      T step;
      acc = lip::eval_stage<S>(lane, x, rec + EN::u, rec + EN::p, k, &step);
      if (lane < nx) dm = lip::abs_nan(step - s[(n + 1) * EN::size + EN::x + lane]);
    } else {
      acc = lip::eval_terminal<S>(lane, x, rec + EN::p, k);
    }
    acc = lip::warp_sum(acc);
    dm = lip::warp_nan_max(dm);
    if (lane == 0) {
      node_cost[n] = acc;
      node_dmax[n] = dm;
    }
  }
  __syncthreads();
  if (warp == 0) {   // the stage nodes over the lanes, then the terminal node
    T c = lane < ns ? node_cost[lane] : T(0);
    T m = lane < ns ? node_dmax[lane] : T(0);
    c = lip::warp_sum(c);
    m = lip::warp_nan_max(m);
    if (lane == 0) {
      cost_out[b] = c + node_cost[ns];
      dmax_out[b] = m;
    }
  }
}

bool is_shape(int nc, int cm, int n_legs) {
  return nc == S::nc && cm == S::cm && n_legs == S::n_legs;
}

// Let a kernel take `bytes` of dynamic shared memory (above 48 KB only
// after the attribute is raised).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
size_t trial_smem_bytes() {
  return sizeof(T) * kWarps * TrialWarp::size;
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
  const size_t bytes = trial_smem_bytes<T>();
  auto kernel = lip_trial_kernel<T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  kernel<<<blocks, 32 * kWarps, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), lip::make_params<T>(params),
      static_cast<const T*>(merit0), static_cast<const T*>(D),
      static_cast<const T*>(dV1), static_cast<const T*>(dV2), B, ns, nA,
      lip::make_consts<T>(scalars), static_cast<T>(nu_w),
      static_cast<T>(beta), static_cast<T>(alpha_min), static_cast<T*>(Xn),
      static_cast<T*>(Un), static_cast<T*>(cost), static_cast<T*>(merit),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_evaluate(const void* X, const void* U, const void* x0,
                    int x0_stride, const void* const* params, int B, int ns,
                    int nc, int cm, int n_legs, const double* scalars,
                    void* cost, void* dmax, void* Xpin, void* stream) {
  if (!is_shape(nc, cm, n_legs)) return kUnknownShape;
  if (ns + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t bytes = evaluate_smem_bytes<T>(ns);
  auto kernel = lip_evaluate_kernel<T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kEvalThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      static_cast<const T*>(x0), x0_stride, lip::make_params<T>(params), ns,
      lip::make_consts<T>(scalars), static_cast<T*>(cost),
      static_cast<T*>(dmax), static_cast<T*>(Xpin));
  return static_cast<int>(cudaGetLastError());
}

// lip_evaluate's occupancy at ns stage nodes, into out[0..4]: blocks
// resident on one SM, warps a block, shared memory bytes a block,
// registers a thread and local (spilled) bytes a thread.
template <typename T>
int evaluate_occupancy(int ns, int* out) {
  const size_t bytes = evaluate_smem_bytes<T>(ns);
  auto kernel = lip_evaluate_kernel<T>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                      kEvalThreads, bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = kEvalWarps;
  out[2] = static_cast<int>(bytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

// K11's occupancy into out[0..3]: blocks an SM, the ring's depth, warps a
// block, shared memory bytes a block.
template <typename T>
int trial_occupancy(int* out) {
  const size_t bytes = trial_smem_bytes<T>();
  auto kernel = lip_trial_kernel<T>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                      32 * kWarps, bytes);
  out[1] = kStages;
  out[2] = kWarps;
  out[3] = static_cast<int>(bytes);
  return static_cast<int>(e);
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

TRIAL_ENTRY(lip_trial_f32, float)
TRIAL_ENTRY(lip_trial_f64, double)

// x0 and Xpin are null, or x0 (B, nx, rows x0_stride elements apart)
// takes node 0's place and Xpin (B, ns+1, nx) receives the pinned plan.
#define EVALUATE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* X, const void* U, const void* x0,           \
                      int x0_stride, const void* const* params, int B,        \
                      int ns, int nc, int cm, int n_legs,                     \
                      const double* scalars, void* cost, void* dmax,          \
                      void* Xpin, void* stream) {                             \
    return launch_evaluate<T>(X, U, x0, x0_stride, params, B, ns, nc, cm,     \
                              n_legs, scalars, cost, dmax, Xpin, stream);     \
  }

EVALUATE_ENTRY(lip_evaluate_f32, float)
EVALUATE_ENTRY(lip_evaluate_f64, double)

// lip_evaluate's occupancy for float32 (f64 = 0) or float64 tensors at ns
// stage nodes (see evaluate_occupancy above).
extern "C" int lip_evaluate_occupancy(int f64, int ns, int* out) {
  return f64 ? evaluate_occupancy<double>(ns, out)
             : evaluate_occupancy<float>(ns, out);
}

// K11's occupancy for float32 (f64 = 0) or float64 tensors (see
// trial_occupancy above).
extern "C" int lip_trial_occupancy(int f64, int* out) {
  return f64 ? trial_occupancy<double>(out) : trial_occupancy<float>(out);
}
