// K6 — the line-search trial of the batched MS-DDP solver on the isrbd AL
// inner problem: the rollout, its cost and the Armijo test for every step
// size α of one call, in one launch; and isrbd_evaluate, the cost and the
// largest defect of a given plan, with no rollout.
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
// isrbd_evaluate replaces `jax.vmap(MSDDP.total_cost)` and
// `jax.vmap(MSDDP._true_defects)` (msddp.py:1222, :1240, :1484-1490) on the
// AL inner OCP, the solve's starting cost and its final defect norm: per
// member
//     cost       = Σₙ ‖ρ(Xₙ, Uₙ, pₙ)‖² + ‖ρ_N(X_N, p_N)‖²
//     defect_max = maxₙ,ᵢ |rk2(Xₙ, Uₙ) − Xₙ₊₁|ᵢ   (NaN if any is NaN)
// Plain twin: `kernels/isrbd_rollout.py::isrbd_evaluate_plain`.
//
// Both are compiled for the sizes of `isrbd::Shape` only, so every loop
// over rows, columns and parameters has a constant trip count and every
// offset is a constant; the wrappers refuse other sizes.
//
// What bounds K6 on an H100: one (member, α) reads per node the gains
// (30×37), the plan, the defects and the 357 parameter values, 1,601
// values (6.4 KB in f32), and does ~2.3k FLOP of gain application and
// ~2k of rows. At B=256, ns=20 and one α that is ~35 MB (~0.010 ms at
// 3.35 TB/s), so bytes bound the work; but each member is a chain of 20
// dependent nodes, and at B=256 the card holds every chain at once with a
// warp scheduler to itself, so the chain's latency sets the time
// (`k6_size_probe` in chip_smoke.py prints K6 from B=1 to B=4096). The
// first design (run-time sizes, a synchronous 21-tensor parameter loop and
// the gains read from device memory at stride 37 at every node, the
// geometry on lane 0, the 240 rows walked through one branch chain) took
// ~15 µs a node; K3's design on one warp ~4 µs.
//
// Design, K3's (csrc/srbd_rollout.cu) with the rows taken off the chain:
// two warps per (member, α), a chain warp and a rows warp, one pair a
// block. Nothing a later node reads depends on the state, so while node n
// computes, the chain warp's lanes copy node n+2's K, U, k, X, d and
// parameters into shared memory with cp.async; the chain then waits on
// arithmetic, not on device memory. K, U and k go in two-element copies
// (8 bytes in f32, 16 in f64): in f32 they start only 8-byte aligned at
// odd member-nodes (1,110 and 30 are 2 mod 4), in f64 always 16-byte
// aligned; the ring's buffers are 16-byte aligned and keep K, U and k at
// even offsets. Each lane copies the same ~12 entries of the packed
// parameter row at every node, from a source pointer and a width fixed
// once before the loop, so the copies take no per-node branch. The chain
// forms K(x̂−X) from shared memory (row stride 37, free of bank conflicts),
// one row a lane with four partial sums, then uₙ; it hands node n — x̂ₙ, uₙ
// and pₙ in slot n mod 4 — to the rows warp through an mbarrier (FULL) and
// steps on to x̂ₙ₊₁ by RK2, the quaternion rates once a node in registers.
// The rows warp forms the node's geometry (R I Rᵀ, Iw ω) in registers and
// its 240 stage rows in nine passes in which the lanes take one path
// (csrc/isrbd_common.cuh::stage_rows), keeps the squares in a register
// and releases the slot (EMPTY). The chain waits on EMPTY only before it
// copies into a slot, two nodes after the rows warp was handed it, so the
// rows run beside the chain. The rows warp
// ends with the terminal rows, one warp reduction (the cost), the merit
// and the Armijo flag. The sum is taken in another order than the plain
// twin's, so the two agree to rounding, not bit for bit. A pair takes
// 22,000 B in f32 (eight blocks an SM: B=256 at four α is one wave) and
// 43,936 B in f64; `isrbd_trial_occupancy` reports it. The handshake is
// an mbarrier in shared memory and not a named barrier: ptxas reserves all
// 16 named barriers of a block for ids known only at run time, which
// left four blocks an SM.
//
// isrbd_evaluate: one block per member and one warp per node (ns+1 warps).
// The nodes do not depend on one another, so all of them load and compute
// at once; each warp sums its node's squared rows (stage_rows or
// terminal_rows) and takes the largest |defect| of its node (NaN kept),
// and the node sums are added in node order, the terminal node last, as
// the twin adds the stage sum and the terminal sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "isrbd_common.cuh"
#include "dmma.cuh"

namespace {

using isrbd::L;
using isrbd::Shape;
constexpr int kPairs = 1;            // (member, α) pairs a block
constexpr int kThreads = 64 * kPairs;   // a chain warp and a rows warp a pair
constexpr int kStages = 3;           // the chain's ring of K, U, k, X, d
constexpr int kSlots = 4;            // node slots the chain hands the rows warp

constexpr int kUnknownShape = -2;    // the sizes are not isrbd::Shape's
constexpr int nx = Shape::nx, nu = Shape::nu;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// One node's inputs of the chain warp in its ring; every buffer starts
// 16-byte aligned and K, U, k at even offsets (two-element copies).
struct ChainBuf {
  static constexpr int K = 0, U = nu * nx, k = U + nu, X = k + nu, d = X + nx;
  static constexpr int size = round_up(d + nx, 4);
  static_assert(U % 2 == 0 && k % 2 == 0 && nu % 2 == 0, "two-element copies");
};

// A pair's shared memory: the chain warp's ring (from offset 0), the node
// slots it hands to the rows warp (the parameter rows, and x̂ₙ then uₙ: an
// xu each), x̂ − X.
struct PairMem {
  static constexpr int par_size = round_up(L::n_par, 4),
                       pub_size = round_up(L::n_xu, 4);
  static constexpr int par = kStages * ChainBuf::size,
                       pub = par + kSlots * par_size,
                       dx = pub + kSlots * pub_size;
  static constexpr int size = round_up(dx + nx, 4);
};

// the pairs' memory, then a pair's FULL and EMPTY mbarriers (kSlots each)
template <typename T>
constexpr size_t trial_smem_bytes() {
  return sizeof(T) * kPairs * PairMem::size +
         sizeof(unsigned long long) * kPairs * 2 * kSlots;
}

// The entries of the packed parameter row one lane copies at every node:
// entry lane + 32c of node n lives at src[c] + n·dim[c].
constexpr int kParamSlots = (L::n_par + 31) / 32;

template <typename T>
struct ParamLanes {
  const T* src[kParamSlots];
  int dim[kParamSlots];
};

template <typename T>
__device__ __forceinline__ ParamLanes<T> param_lanes(const isrbd::Params<T>& P,
                                                     size_t b, int ns, int lane) {
  ParamLanes<T> pl;
#pragma unroll
  for (int c = 0; c < kParamSlots; ++c) {
    const int e = lane + 32 * c;
    pl.src[c] = P.p[0];
    pl.dim[c] = 0;
#pragma unroll
    for (int t = 0; t < isrbd::kParams; ++t) {
      const int off = isrbd::param_off(t), dim = isrbd::param_dim(t);
      if (e >= off && e < off + dim) {
        pl.src[c] = P.p[t] + b * (ns + 1) * dim + (e - off);
        pl.dim[c] = dim;
      }
    }
  }
  return pl;
}

// The chain warp's lanes start the copies of node n's K, U, k, X and d
// (n < ns) into `buf` and close them into one group (empty past ns − 1).
template <typename T>
__device__ __forceinline__ void issue_chain(
    T* buf, const T* __restrict__ Ks, const T* __restrict__ U,
    const T* __restrict__ ks, const T* __restrict__ X, const T* __restrict__ d,
    size_t b, int n, int ns, int lane) {
  using CB = ChainBuf;
  constexpr int two = 2 * sizeof(T);
  if (n < ns) {
    const size_t bn = b * ns + n;
    const T* Kb = Ks + bn * (nu * nx);
    constexpr int pairs = nu * nx / 2;
#pragma unroll
    for (int i = 0; i < (pairs + 31) / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < pairs) cp_async<two>(buf + CB::K + 2 * c, Kb + 2 * c);
    }
    if (lane < nu) {                               // U on lanes 0..14, k on 15..29
      const bool isU = lane < nu / 2;
      const int c = isU ? lane : lane - nu / 2;
      cp_async<two>(buf + (isU ? CB::U : CB::k) + 2 * c,
                    (isU ? U : ks) + bn * nu + 2 * c);
    }
    const size_t row = b * (ns + 1) + n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      if (j < nx) {
        cp_async<sizeof(T)>(buf + CB::X + j, X + row * nx + j);
        cp_async<sizeof(T)>(buf + CB::d + j, d + bn * nx + j);
      }
    }
  }
  cp_async_commit();
}

// The lanes start the copies of node n's parameter row (n ≤ ns; the
// terminal node's at ns) into `buf`.
template <typename T>
__device__ __forceinline__ void issue_params(T* buf, const ParamLanes<T>& pl,
                                             int n, int ns, int lane) {
  if (n <= ns) {
#pragma unroll
    for (int c = 0; c < kParamSlots; ++c)
      if (lane + 32 * c < L::n_par)
        cp_async<sizeof(T)>(buf + lane + 32 * c,
                            pl.src[c] + static_cast<size_t>(n) * pl.dim[c]);
  }
}

// The handshake of a pair over node slot n mod kSlots: FULL — the chain
// has written node n there (its parameters, x̂ and u), EMPTY — the rows
// warp is done with node n. Each is an mbarrier that lane 0 of the
// handing warp arrives on once a node; node n is the (n / kSlots)-th use
// of its slot, so its phase has parity (n / kSlots) & 1.
struct Handshake {
  unsigned long long* bar;                        // kSlots FULL, kSlots EMPTY
  __device__ void full_arrive(int n) const { mbarrier_arrive(bar + n % kSlots); }
  __device__ void full_wait(int n) const {
    mbarrier_wait(bar + n % kSlots, (n / kSlots) & 1);
  }
  __device__ void empty_arrive(int n) const {
    mbarrier_arrive(bar + kSlots + n % kSlots);
  }
  __device__ void empty_wait(int n) const {
    mbarrier_wait(bar + kSlots + n % kSlots, (n / kSlots) & 1);
  }
};

// The chain warp: uₙ and x̂ₙ₊₁ node after node. Node n lives in slot
// n mod kSlots: x̂ₙ (written at node n − 1), uₙ and pₙ (copied two nodes
// ahead with K, U, k, X, d). FULL(n) hands the node to the rows warp once
// uₙ is in; before pₙ₊₂ and x̂ₙ₊₂ take a slot, EMPTY says the rows warp is
// done with the node that held it.
template <typename T>
__device__ __forceinline__ void chain_warp(
    T* pm, Handshake hs, const isrbd::Params<T>& P,
    const T* __restrict__ x0, const T* __restrict__ X, const T* __restrict__ U,
    const T* __restrict__ ks, const T* __restrict__ Ks, const T* __restrict__ d,
    int B, int ns, size_t b, size_t a, T alpha, const isrbd::Consts<T>& k,
    T* __restrict__ Xn, T* __restrict__ Un, int lane) {
  using CB = ChainBuf;
  T* dx = pm + PairMem::dx;
  T* par = pm + PairMem::par;
  auto slot = [pm](int n) { return pm + PairMem::pub + (n % kSlots) * PairMem::pub_size; };
  const ParamLanes<T> pl = param_lanes(P, b, ns, lane);
  for (int n = 0; n < kStages - 1; ++n) {
    issue_params(par + (n % kSlots) * PairMem::par_size, pl, n, ns, lane);
    issue_chain(pm + n * CB::size, Ks, U, ks, X, d, b, n, ns, lane);
  }
  const T om = T(1) - alpha;
  const T hdt = T(0.5) * k.dt;
  for (int j = lane; j < nx; j += 32) slot(0)[j] = x0[b * nx + j];
  __syncwarp();
  for (int n = 0; n < ns; ++n) {
    const T* buf = pm + (n % kStages) * CB::size;
    // node n + 2 streams in while node n computes; its slot's last node
    // must be done first
    const int ahead = n + kStages - 1;
    if (ahead <= ns && ahead >= kSlots) hs.empty_wait(ahead - kSlots);
    issue_params(par + (ahead % kSlots) * PairMem::par_size, pl, ahead, ns, lane);
    issue_chain(pm + (ahead % kStages) * CB::size, Ks, U, ks, X, d, b, ahead,
                ns, lane);
    cp_async_wait_group<kStages - 1>();            // node n has arrived
    __syncwarp();
    T* xu = slot(n);
    T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * nx;
    for (int j = lane; j < nx; j += 32) {
      dx[j] = xu[j] - buf[CB::X + j];
      Xo[j] = xu[j];
    }
    __syncwarp();
    {   // uₙ: row i of K(x̂ − X) on lane i (lanes past nu repeat the last),
        // four partial sums to shorten the chain
      const int i = lane < nu ? lane : nu - 1;
      const T* Kr = buf + CB::K + i * nx;
      T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
      for (int j = 0; j + 3 < nx; j += 4) {
        s0 += Kr[j] * dx[j];
        s1 += Kr[j + 1] * dx[j + 1];
        s2 += Kr[j + 2] * dx[j + 2];
        s3 += Kr[j + 3] * dx[j + 3];
      }
#pragma unroll
      for (int j = nx / 4 * 4; j < nx; ++j) s0 += Kr[j] * dx[j];
      const T ui = (buf[CB::U + i] + alpha * buf[CB::k + i]) + ((s0 + s1) + (s2 + s3));
      if (lane < nu) {
        xu[nx + i] = ui;
        Un[((a * B + b) * ns + n) * nu + i] = ui;
      }
    }
    __syncwarp();
    if (lane == 0) hs.full_arrive(n);              // x̂ₙ, uₙ, pₙ to the rows warp
    const isrbd::Rates<T> rt = isrbd::rates(xu, hdt);
    T* next = slot(n + 1);                         // freed before pₙ₊₁ came in
#pragma unroll
    for (int c = 0; c < 2; ++c) {                  // nx ≤ 64: two rows a lane
      const int j = lane + 32 * c;
      if (j < nx) next[j] = isrbd::step_row(j, xu, rt, hdt, k.dt) - om * buf[CB::d + j];
    }
    __syncwarp();
  }
  cp_async_wait_group<0>();
  __syncwarp();
  T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * nx;
  for (int j = lane; j < nx; j += 32) Xo[j] = slot(ns)[j];
  if (lane == 0) hs.full_arrive(ns);               // x̂_N, p_N
}

// The rows warp: Σ‖ρ‖² of every node the chain hands over, then the
// terminal rows, the merit and the Armijo flag.
template <typename T>
__device__ __forceinline__ void rows_warp(
    const T* pm, Handshake hs, const T* __restrict__ merit0,
    const T* __restrict__ Dsq, const T* __restrict__ dV1,
    const T* __restrict__ dV2, int B, int ns, size_t b, size_t a, T alpha,
    const isrbd::Consts<T>& k, T nu_w, T beta, T alpha_min,
    T* __restrict__ cost_out, T* __restrict__ merit_out,
    bool* __restrict__ ok_out, int lane) {
  const T* par = pm + PairMem::par;
  auto slot = [pm](int n) { return pm + PairMem::pub + (n % kSlots) * PairMem::pub_size; };
  T acc = T(0);   // this lane's share of Σ‖ρ‖²
  auto square = [&acc](int, T v) { acc += v * v; };
  for (int n = 0; n < ns; ++n) {
    hs.full_wait(n);                               // x̂ₙ, uₙ, pₙ are in
    const T* xu = slot(n);
    const isrbd::Geometry<T> geo = isrbd::geometry(xu, k);
    isrbd::stage_rows<false>(lane, xu, par + (n % kSlots) * PairMem::par_size,
                             geo, k, square, [](int, T) {});
    // the chain waits on this before the slot's next node, n + kSlots
    __syncwarp();
    if (lane == 0) hs.empty_arrive(n);
  }
  hs.full_wait(ns);
  isrbd::terminal_rows(lane, slot(ns), par + (ns % kSlots) * PairMem::par_size,
                       k, square);
  const T cost = isrbd::warp_sum(acc);
  if (lane == 0) {
    const T om = T(1) - alpha;
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
__global__ void __launch_bounds__(kThreads)
isrbd_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                   const T* __restrict__ U, const T* __restrict__ ks,
                   const T* __restrict__ Ks, const T* __restrict__ d,
                   const T* __restrict__ alphas, isrbd::Params<T> P,
                   const T* __restrict__ merit0, const T* __restrict__ Dsq,
                   const T* __restrict__ dV1, const T* __restrict__ dV2,
                   int B, int ns, int nA,
                   const __grid_constant__ isrbd::Consts<T> k, T nu_w, T beta,
                   T alpha_min, T* __restrict__ Xn, T* __restrict__ Un,
                   T* __restrict__ cost_out, T* __restrict__ merit_out,
                   bool* __restrict__ ok_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<T*>(smem_raw) + kPairs * PairMem::size);
  if (threadIdx.x < kPairs * 2 * kSlots) mbarrier_init(bars + threadIdx.x, 1);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp / 2;
  const long long g = static_cast<long long>(blockIdx.x) * kPairs + pair;
  if (g >= static_cast<long long>(B) * nA) return;   // the whole pair leaves
  const size_t b = g / nA;
  const size_t a = g % nA;
  T* pm = reinterpret_cast<T*>(smem_raw) + pair * PairMem::size;
  const Handshake hs{bars + pair * 2 * kSlots};
  const T alpha = alphas[a];
  if (warp % 2 == 0)
    chain_warp(pm, hs, P, x0, X, U, ks, Ks, d, B, ns, b, a, alpha, k, Xn, Un,
               lane);
  else
    rows_warp(pm, hs, merit0, Dsq, dV1, dV2, B, ns, b, a, alpha, k, nu_w, beta,
              alpha_min, cost_out, merit_out, ok_out, lane);
}

// isrbd_evaluate: a warp's shared memory (x and u side by side, params)
template <typename T>
struct EvalWarp {
  static constexpr int xu = 0, p = round_up(L::n_xu, 2);
  static constexpr int size = round_up(p + L::n_par, 2);
};

template <typename T>
__global__ void __launch_bounds__(1024)
isrbd_evaluate_kernel(const T* __restrict__ X, const T* __restrict__ U,
                      isrbd::Params<T> P, int ns,
                      const __grid_constant__ isrbd::Consts<T> k,
                      T* __restrict__ cost_out, T* __restrict__ dmax_out) {
  using W = EvalWarp<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t b = blockIdx.x;
  T* xu = reinterpret_cast<T*>(smem_raw) + n * W::size + W::xu;
  T* p = reinterpret_cast<T*>(smem_raw) + n * W::size + W::p;
  T* node_cost = reinterpret_cast<T*>(smem_raw) + (ns + 1) * W::size;
  T* node_dmax = node_cost + (ns + 1);
  const size_t row = b * (ns + 1) + n;
  for (int j = lane; j < nx; j += 32) xu[j] = X[row * nx + j];
  isrbd::load_params(P, row, lane, p);
  T acc = T(0), dm = T(0);
  auto square = [&acc](int, T v) { acc += v * v; };
  if (n < ns) {                                    // warp-uniform
    if (lane < nu) xu[nx + lane] = U[(b * ns + n) * nu + lane];
    __syncwarp();
    const T hdt = T(0.5) * k.dt;
    const isrbd::Geometry<T> geo = isrbd::geometry(xu, k);
    const isrbd::Rates<T> rt = isrbd::rates(xu, hdt);
    isrbd::stage_rows<false>(lane, xu, p, geo, k, square, [](int, T) {});
    const T* Xnext = X + (row + 1) * nx;
    for (int j = lane; j < nx; j += 32)
      dm = isrbd::nan_max(
          dm, isrbd::abs_nan(isrbd::step_row(j, xu, rt, hdt, k.dt) - Xnext[j]));
  } else {
    __syncwarp();
    isrbd::terminal_rows(lane, xu, p, k, square);
  }
  acc = isrbd::warp_sum(acc);
  dm = isrbd::warp_nan_max(dm);
  if (lane == 0) {
    node_cost[n] = acc;
    node_dmax[n] = dm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T c = T(0), m = T(0);
    for (int i = 0; i < ns; ++i) {
      c += node_cost[i];
      m = isrbd::nan_max(m, node_dmax[i]);
    }
    cost_out[b] = c + node_cost[ns];
    dmax_out[b] = m;
  }
}

bool is_shape(int nc, int cm, int n_legs) {
  return nc == Shape::nc && cm == Shape::cm && n_legs == Shape::n_legs;
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
  auto kernel = isrbd_trial_kernel<T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((pairs + kPairs - 1) / kPairs);
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), isrbd::make_params<T>(params),
      static_cast<const T*>(merit0), static_cast<const T*>(D),
      static_cast<const T*>(dV1), static_cast<const T*>(dV2), B, ns, nA,
      isrbd::make_consts<T>(scalars), static_cast<T>(nu_w),
      static_cast<T>(beta), static_cast<T>(alpha_min), static_cast<T*>(Xn),
      static_cast<T*>(Un), static_cast<T*>(cost), static_cast<T*>(merit),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// K6's blocks resident on one SM, ring depth, warps and shared memory a
// block, into out[0..3].
template <typename T>
int trial_occupancy(int* out) {
  const size_t bytes = trial_smem_bytes<T>();
  cudaError_t e = allow_smem(isrbd_trial_kernel<T>, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, isrbd_trial_kernel<T>, kThreads, bytes);
  out[1] = kStages;
  out[2] = kThreads / 32;
  out[3] = static_cast<int>(bytes);
  return static_cast<int>(e);
}

template <typename T>
int launch_evaluate(const void* X, const void* U, const void* const* params,
                    int B, int ns, int nc, int cm, int n_legs,
                    const double* scalars, void* cost, void* dmax,
                    void* stream) {
  if (!is_shape(nc, cm, n_legs)) return kUnknownShape;
  if (ns + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t bytes = sizeof(T) * ((ns + 1) * EvalWarp<T>::size + 2 * (ns + 1));
  auto kernel = isrbd_evaluate_kernel<T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, 32 * (ns + 1), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      isrbd::make_params<T>(params), ns, isrbd::make_consts<T>(scalars),
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

TRIAL_ENTRY(isrbd_trial_f32, float)
TRIAL_ENTRY(isrbd_trial_f64, double)

// K6's occupancy for float32 (f64 = 0) or float64 tensors: out[0] blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] the ring's
// depth, out[2] warps a block, out[3] shared memory bytes a block.
extern "C" int isrbd_trial_occupancy(int f64, int* out) {
  return f64 ? trial_occupancy<double>(out) : trial_occupancy<float>(out);
}

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
