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
// What bounds K11 on an H100: a member's gains, plan, defects and 12
// parameter values a node, ~550 values a node (2.2 KB in float32), are
// read once for all its α's; each α does ~0.9k FLOP of rollout and ~0.3k
// of residual rows a node. At B=512, ns=20 that is ~23 MB (7 µs at 3.35
// TB/s), so bytes bound the work at fleet sizes; but each (member, α) is a
// chain of 20 dependent nodes, so at small B the chain's latency sets the
// time (chip_smoke.py's `lip_kernel_times` prints B = 1, 512, 4096; one α
// takes 0.0095 ms at B=1, 0.0113 at B=512, 0.079 at B=4096 on an H100 at
// 700 W, chip_smoke.py --k12-versus … --parts k11).
//
// Design: a block a member, with up to four of its α's (more α's take
// more blocks of the member): a chain warp an α and one copier warp.
// Nothing a later node reads depends on the state, so the copier stages
// the member's operands once for all its α's, by bulk copies (cp.async.bulk
// of each run's 16-byte-aligned body onto an mbarrier, the few elements
// around it by cp.async): X, d, U and k whole at the start, K in pieces of
// two nodes through a ring of four slots, each refilled once every chain
// has released it (full and empty mbarriers a slot), and the parameter
// tensors, which it packs into rows while the chains run. No block barrier
// stands in the chain, and it reads no operand from device memory: a
// per-node barrier held the chains to the copies' issue, ~40-50 cycles a
// cp.async warp instruction an SM. The chain carries x̂ and u alone: lane
// j holds x̂ⱼ in a register; K(x̂ − X) takes two lanes a row, 15 columns
// each, the columns' x̂ − X shuffled from their lanes, joined by one
// shuffle; uᵢ then lives on lane i; the Euler step of row j reads x̂ and u
// of lane j ± nx/2 by one shuffle each. x̂ₙ and uₙ go to Xn / Un and to a
// record an (α, node) in shared memory. After the chains every thread
// evaluates an (α, node), its residual rows in order (`lip::stage_sq`,
// `lip::terminal_sq`; a warp an (α, node), as lip_evaluate does, took
// ~6× as long for 21 nodes); one thread an α adds the stage nodes in node
// order and the terminal node last, as the twin adds the stage sum and
// the terminal sum, and takes the Armijo test, so a call is
// deterministic. `regions` states every region. The sums are taken in
// another order than the plain twin's, so the two agree to rounding, not
// bit for bit.
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

#include <stdint.h>

#include "lip_common.cuh"
#include "dmma.cuh"

namespace {

using S = lip::Shape;
using L = lip::Layout<S>;
constexpr int kMaxAlphas = 4;        // α's of one member a block, a chain warp each
constexpr int kPieceNodes = 2;       // nodes of K a bulk copy carries
constexpr int kRing = 4;             // ring slots of K's pieces
constexpr int kMinBlocks = 5;        // blocks an SM the registers are held to:
                                     // float32 with four α fits five by its bytes
constexpr int kUnknownShape = -2;    // the sizes are not lip::Shape's
constexpr int kPw = L::pw;           // a node's packed parameter row
constexpr int nx = S::nx, nu = S::nu;
constexpr int kHalf = nx / 2;        // K's columns a lane; the Euler step's partner lane
static_assert(nx <= 32 && 2 * nu <= 32 && nx == 2 * kHalf && L::i_rdot == kHalf &&
                  L::i_cdot == L::i_rdot + 3,
              "a state row a lane, two lanes a K row, row j's ẋ on lane j ± nx/2");
static_assert(kPieceNodes * nu * nx * 4 % 16 == 0,
              "a piece of K keeps its member's offset within 16 bytes");

__host__ __device__ constexpr size_t round16(size_t v) {
  return (v + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

__host__ __device__ constexpr int alphas_a_block(int nA) {
  return nA < kMaxAlphas ? nA : kMaxAlphas;
}

// Pieces of K at ns stage nodes.
__host__ __device__ constexpr int pieces(int ns) {
  return (ns + kPieceNodes - 1) / kPieceNodes;
}

// The block's shared memory for one member at ns stage nodes with na α's,
// tensors of E bytes an element (kernels/lip_rollout.py::smem_bytes states
// the same), as byte offsets: the ring of K's pieces (kRing slots, each a
// piece and 16 bytes: a run lands at its source's offset within 16
// bytes), after the chain the node sums; the member's staged runs of X, d,
// U and k and of its four parameter tensors (each 16 bytes longer than the
// run); the packed parameter rows; the records (x̂ then u an (α, node));
// the barriers (full and empty a slot, one for the runs, one for the
// parameters); and the total.
struct Regions {
  size_t ring, slot, X, d, U, k, par, prm, rec, bar, total;
};

template <int E>
__host__ __device__ constexpr Regions regions(int ns, int na) {
  Regions r{};
  r.slot = round16(static_cast<size_t>(kPieceNodes) * nu * nx * E + 16);
  r.ring = 0;
  r.X = r.ring + cmax(kRing * r.slot, round16(static_cast<size_t>(na) * (ns + 1) * E));
  r.d = r.X + round16(static_cast<size_t>(ns + 1) * nx * E + 16);
  r.U = r.d + round16(static_cast<size_t>(ns) * nx * E + 16);
  r.k = r.U + round16(static_cast<size_t>(ns) * nu * E + 16);
  r.par = r.k + round16(static_cast<size_t>(ns) * nu * E + 16);
  r.prm = r.par;
  for (int q = 0; q < lip::kParams; ++q)
    r.prm += round16(static_cast<size_t>(ns + 1) * lip::param_dim<S>(q) * E + 16);
  r.rec = r.prm + round16(static_cast<size_t>(ns + 1) * kPw * E);
  r.bar = r.rec + round16(static_cast<size_t>(na) * (ns + 1) * (nx + nu) * E);
  r.total = r.bar + round16(static_cast<size_t>(8) * (2 * kRing + 2));
  return r;
}

// Where a run staged into the region at dst lands: at dst plus its
// source's offset within 16 bytes, so that its body's copy is aligned at
// both ends.
template <typename T, typename D>
__device__ __forceinline__ D* landed(D* dst, const T* src) {
  return dst + (reinterpret_cast<uintptr_t>(src) % 16) / sizeof(T);
}

// The bytes of the 16-byte-aligned body of a run of `count` elements at
// src.
template <typename T>
__device__ __forceinline__ unsigned body_bytes(const T* src, size_t count) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = (s + 15) / 16 * 16, hi = (s + count * sizeof(T)) / 16 * 16;
  return hi > lo ? static_cast<unsigned>(hi - lo) : 0u;
}

// One warp stages the run of `count` elements at src into the region at
// dst (`landed`): the 16-byte-aligned body by one bulk copy (lane 0) on
// `bar`, whose expected bytes the caller has set, the elements before and
// after it by cp.async, a lane each.
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, size_t count,
                                          unsigned long long* bar, int lane) {
  constexpr int E = sizeof(T);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const unsigned bytes = body_bytes(src, count);
  const int head = bytes ? static_cast<int>((16 - s % 16) % 16) / E
                         : static_cast<int>(count);
  const int tail = static_cast<int>(count - head - bytes / E);
  T* at = landed(dst, src);
  if (lane == 0 && bytes) tma_bulk(at + head, src + head, bytes, bar);
  if (lane < head) cp_async<E>(at + lane, src + lane);
  if (lane >= 16 && lane - 16 < tail) {
    const size_t i = count - tail + (lane - 16);
    cp_async<E>(at + i, src + i);
  }
}

// The nodes piece p carries.
__device__ __forceinline__ int piece_nodes(int p, int ns) {
  return ns - p * kPieceNodes < kPieceNodes ? ns - p * kPieceNodes : kPieceNodes;
}

// The copier warp fills a ring slot with piece p of the member's K (gK;
// Ks0 … Ks1 the whole tensor): one bulk copy (lane 0) of the 16-byte-aligned window
// around the piece onto the slot's `full` barrier, which lands it at its
// `landed` offset; a window past either end of the tensor (a member's K
// not on a 16-byte boundary, at the tensor's first or last piece) goes by
// cp.async, waited for, then one arrival on `full`.
template <typename T>
__device__ __forceinline__ void issue_piece(T* slot, const T* gK, int p,
                                            int ns, const T* Ks0,
                                            const T* Ks1,
                                            unsigned long long* full,
                                            int lane) {
  constexpr int E = sizeof(T);
  const T* src = gK + p * kPieceNodes * (nu * nx);
  const int count = piece_nodes(p, ns) * (nu * nx);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) / 16 * 16;
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(src + count) + 15) / 16 * 16;
  if (lo >= reinterpret_cast<uintptr_t>(Ks0) && hi <= reinterpret_cast<uintptr_t>(Ks1)) {
    if (lane == 0) {
      mbarrier_expect_tx(full, static_cast<unsigned>(hi - lo));
      tma_bulk(slot, reinterpret_cast<const T*>(lo), static_cast<unsigned>(hi - lo),
               full);
    }
    return;
  }
  T* at = landed(slot, src);
  for (int i = lane; i < count; i += 32) cp_async<E>(at + i, src + i);
  cp_async_wait_all();
  __syncwarp();
  if (lane == 0) mbarrier_arrive(full);
}

// One chain warp's node, its operands read from the staged runs at this
// lane's places (Kr: K's row i, columns 15h … 15h + 14, for lanes i and
// i + 16; Xj, dj: row j = lane; Ui, ki: row i): x̂ − X (lane j holds x̂ⱼ),
// uᵢ = (Uᵢ + α kᵢ) + Kᵢ(x̂ − X) (x̂ − X shuffled from the columns' lanes, the
// two halves joined by one shuffle), x̂ₙ₊₁ = x̂ + dt·ẋ(x̂, u) − (1 − α) dₙ into
// xh (row j's ẋ from lane j ± nx/2), and x̂ₙ, uₙ to Xn / Un and the record
// last. Shuffles only: no barrier inside a node.
template <typename T>
__device__ __forceinline__ void chain_node(const T* Kr, T Xj, T dj, T Ui,
                                           T ki, T& xh, T alpha, T om,
                                           const lip::Consts<T>& k,
                                           T* __restrict__ Xo,
                                           T* __restrict__ Uo, T* rec,
                                           int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const int kh = lane / 16;
  const T base = Ui + alpha * ki;
  T kr[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) kr[c] = Kr[c];
  const T dx = lane < nx ? xh - Xj : T(0);
  T s0 = T(0), s1 = T(0);
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const T v = __shfl_sync(kAll, dx, kh * kHalf + c);
    if (c % 2 == 0) {
      s0 += kr[c] * v;
    } else {
      s1 += kr[c] * v;
    }
  }
  T sk = s0 + s1;
  sk += __shfl_xor_sync(kAll, sk, 16);
  const T u = base + sk;
  // ẋ's row j (lip::xdot_row): ṙ, ċ = x̂ of lane j + nx/2; r̈ = η²(r − z)
  // − g e_z and c̈ = u, from lane j − nx/2
  const int partner = lane < kHalf ? lane + kHalf : lane - kHalf;
  const T xo = __shfl_sync(kAll, xh, partner);
  const T uo = __shfl_sync(kAll, u, partner);
  T xd;
  if (lane < L::i_rdot) {
    xd = xo;
  } else if (lane < L::i_cdot) {
    const T v = k.eta2 * (xo - uo);
    xd = lane - L::i_rdot == 2 ? v - T(9.81) : v;
  } else {
    xd = uo;
  }
  const T xn = (xh + k.dt * xd) - om * dj;
  if (lane < nx) {
    Xo[lane] = xh;
    rec[lane] = xh;
  }
  if (lane < nu) {
    Uo[lane] = u;
    rec[nx + lane] = u;
  }
  if (lane < nx) xh = xn;
}

// The packed parameter row entry e of node `row` from the member's staged
// parameter tensors (mt, rdot_ref, c_ref, cdot_switch).
template <typename T>
__device__ __forceinline__ T param_entry(const T* mt, const T* rd, const T* cr,
                                         const T* cs, int row, int e) {
  constexpr int nc = S::nc;
  if (e < lip::kP_rdot) return mt[row];
  if (e < lip::kP_cref) return rd[row * 3 + (e - lip::kP_rdot)];
  if (e < lip::kP_cref + nc) return cr[row * nc + (e - lip::kP_cref)];
  return cs[row * nc + (e - lip::kP_cref - nc)];
}

template <typename T, bool kEvaluate>
__global__ void __launch_bounds__(32 * (kMaxAlphas + 1), kMinBlocks)
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = (nA + kMaxAlphas - 1) / kMaxAlphas;
  const size_t b = blockIdx.x / groups;
  const int a0 = (blockIdx.x % groups) * kMaxAlphas;
  const int na = nA - a0 < kMaxAlphas ? nA - a0 : kMaxAlphas;
  const int ns1 = ns + 1, np = pieces(ns), nc = S::nc;
  const Regions r = regions<sizeof(T)>(ns, alphas_a_block(nA));
  auto* full = reinterpret_cast<unsigned long long*>(smem_raw + r.bar);
  unsigned long long* empty = full + kRing;
  unsigned long long* runs = full + 2 * kRing;     // X, d, U, k
  unsigned long long* pars = runs + 1;             // the parameter tensors
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthreads = blockDim.x;
  const int producer = nthreads / 32 - 1;          // the last warp copies
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbarrier_init(full + s, 1);
      mbarrier_init(empty + s, na);
    }
    mbarrier_init(runs, 2);     // the bodies' bytes, and the edges' arrival
    mbarrier_init(pars, 2);
    fence_mbarrier_init();
  }
  __syncthreads();
  // the member's runs in device memory, and where they land
  const T* gK = Ks + b * ns * (nu * nx);
  const T* gX = X + b * ns1 * nx;
  const T* gd = d + b * ns * nx;
  const T* gU = U + b * ns * nu;
  const T* gk = ks + b * ns * nu;
  const T* gmt = P.p[0] + b * ns1;
  const T* grd = P.p[1] + b * ns1 * 3;
  const T* gcr = P.p[2] + b * ns1 * nc;
  const T* gcs = P.p[3] + b * ns1 * nc;
  T* ring = reinterpret_cast<T*>(smem_raw + r.ring);
  T* sX = reinterpret_cast<T*>(smem_raw + r.X);
  T* sd = reinterpret_cast<T*>(smem_raw + r.d);
  T* sU = reinterpret_cast<T*>(smem_raw + r.U);
  T* sk = reinterpret_cast<T*>(smem_raw + r.k);
  T* smt = reinterpret_cast<T*>(smem_raw + r.par);
  T* srd = smt + round16(ns1 * sizeof(T) + 16) / sizeof(T);
  T* scr = srd + round16(static_cast<size_t>(ns1) * 3 * sizeof(T) + 16) / sizeof(T);
  T* scs = scr + round16(static_cast<size_t>(ns1) * nc * sizeof(T) + 16) / sizeof(T);
  const size_t slot = r.slot / sizeof(T);
  T* prm = reinterpret_cast<T*>(smem_raw + r.prm);
  T* recs = reinterpret_cast<T*>(smem_raw + r.rec);
  if (warp == producer) {
    // the member's runs by bulk copies and their edges by cp.async (an
    // arrival once the edges are in), the first kRing pieces of K; then
    // each slot refilled once its piece is read
    const T* Ks1 = Ks + static_cast<size_t>(B) * ns * (nu * nx);
    if (lane == 0) {
      mbarrier_expect_tx(runs, body_bytes(gX, ns1 * nx) + body_bytes(gd, ns * nx) +
                                   body_bytes(gU, ns * nu) + body_bytes(gk, ns * nu));
      mbarrier_expect_tx(pars, body_bytes(gmt, ns1) + body_bytes(grd, ns1 * 3) +
                                   body_bytes(gcr, ns1 * nc) + body_bytes(gcs, ns1 * nc));
    }
    __syncwarp();
    stage_run(sX, gX, ns1 * nx, runs, lane);
    stage_run(sd, gd, ns * nx, runs, lane);
    stage_run(sU, gU, ns * nu, runs, lane);
    stage_run(sk, gk, ns * nu, runs, lane);
    cp_async_commit();
    for (int p = 0; p < np && p < kRing; ++p)
      issue_piece(ring + p * slot, gK, p, ns, Ks, Ks1, full + p, lane);
    stage_run(smt, gmt, ns1, pars, lane);
    stage_run(srd, grd, ns1 * 3, pars, lane);
    stage_run(scr, gcr, ns1 * nc, pars, lane);
    stage_run(scs, gcs, ns1 * nc, pars, lane);
    cp_async_commit();
    cp_async_wait_group<1>();                      // the runs' edges
    __syncwarp();
    if (lane == 0) mbarrier_arrive(runs);
    for (int p = kRing; p < np; ++p) {
      const int s = p % kRing;
      if (lane == 0) mbarrier_wait(empty + s, (p / kRing - 1) & 1);
      __syncwarp();
      issue_piece(ring + s * slot, gK, p, ns, Ks, Ks1, full + s, lane);
    }
    // the packed parameter rows, while the chains run
    cp_async_wait_group<0>();
    __syncwarp();
    if (lane == 0) mbarrier_arrive(pars);
    mbarrier_wait(pars, 0);
    const T* lmt = landed(smt, gmt);
    const T* lrd = landed(srd, grd);
    const T* lcr = landed(scr, gcr);
    const T* lcs = landed(scs, gcs);
    for (int i = lane; i < ns1 * kPw; i += 32) {
      const int row = i / kPw;
      prm[i] = param_entry(lmt, lrd, lcr, lcs, row, i - row * kPw);
    }
  } else if (warp < na) {  // α a0 + warp's chain
    const size_t ma = static_cast<size_t>(a0 + warp) * B + b;
    // this lane's places in the staged runs, stepped node by node
    const int ki = lane % 16 < nu ? lane % 16 : nu - 1, j = lane < nx ? lane : 0;
    const T* Kl = landed(ring, gK) + ki * nx + (lane / 16) * kHalf;
    const T* Xl = landed(sX, gX) + j;
    const T* dl = landed(sd, gd) + j;
    const T* Ul = landed(sU, gU) + ki;
    const T* kl = landed(sk, gk) + ki;
    T* Xo = Xn + ma * ns1 * nx;
    T* Uo = Un + ma * ns * nu;
    T* rec = recs + static_cast<size_t>(warp) * ns1 * (nx + nu);
    const T alpha = alphas[a0 + warp];
    const T om = T(1) - alpha;
    T xh = lane < nx ? x0[b * nx + lane] : T(0);
    mbarrier_wait(runs, 0);                        // X, d, U, k are in
    int s = 0, m = 0, use = 0;                     // slot, node in piece, slot's use
    for (int n = 0; n < ns; ++n) {
      if (m == 0) mbarrier_wait(full + s, use & 1);
      chain_node(Kl + s * slot + m * (nu * nx), Xl[n * nx], dl[n * nx],
                 Ul[n * nu], kl[n * nu], xh, alpha, om, k, Xo, Uo, rec, lane);
      Xo += nx;
      Uo += nu;
      rec += nx + nu;
      if (++m == kPieceNodes || n == ns - 1) {
        // piece read: every lane's reads of the slot fed the node's last
        // shuffles, which lane 0 has passed
        if (lane == 0) mbarrier_arrive(empty + s);
        m = 0;
        if (++s == kRing) {
          s = 0;
          ++use;
        }
      }
    }
    if (lane < nx) {                               // x̂_N
      Xo[lane] = xh;
      rec[lane] = xh;
    }
  }
  if constexpr (kEvaluate) {
    __syncthreads();                               // the records are in
    T* node_cost = ring;                           // the ring is free
    // an (α, node) a thread, the rows in order (the producer packed the
    // parameter rows)
    for (int it = tid; it < na * ns1; it += nthreads) {
      const int n = it % ns1;
      const T* rc = recs + static_cast<size_t>(it) * (nx + nu);
      const T* p = prm + n * kPw;
      node_cost[it] = n < ns ? lip::stage_sq<S>(rc, rc + nx, p, k)
                             : lip::terminal_sq<S>(rc, p, k);
    }
    __syncthreads();
    if (tid < na) {        // the stage nodes in node order, the terminal last
      const T* c = node_cost + tid * ns1;
      T sum = T(0);
      for (int n = 0; n < ns; ++n) sum += c[n];
      const T cost = sum + c[ns];
      const T al = alphas[a0 + tid];
      const T oa = T(1) - al;
      const T D = Dsq[b];
      const T merit = cost + (nu_w * (oa * oa)) * D;
      const T expected = -(al * dV1[b] + (al * al) * dV2[b]) +
                         ((T(2) * al - al * al) * nu_w) * D;
      const T exp_min = expected < T(1e-16) ? T(1e-16) : expected;  // NaN stays
      const size_t o = static_cast<size_t>(a0 + tid) * B + b;
      cost_out[o] = cost;
      merit_out[o] = merit;
      ok_out[o] = (merit0[b] - merit >= beta * exp_min) && isfinite(merit) &&
                  (al >= alpha_min);
    }
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

constexpr size_t kMaxSmem = 232448;   // an H100 block's dynamic shared memory

template <typename T, bool kEvaluate>
int launch_trial(const void* x0, const void* X, const void* U, const void* ks,
                 const void* Ks, const void* d, const void* alphas,
                 const void* const* params, const void* merit0,
                 const void* D, const void* dV1, const void* dV2, int B,
                 int ns, int nc, int cm, int n_legs, int nA,
                 const double* scalars, double nu_w, double beta,
                 double alpha_min, void* Xn, void* Un, void* cost,
                 void* merit, void* ok, void* stream) {
  if (!is_shape(nc, cm, n_legs)) return kUnknownShape;
  if (static_cast<long long>(B) * nA == 0) return 0;
  const size_t bytes = regions<sizeof(T)>(ns, alphas_a_block(nA)).total;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lip_trial_kernel<T, kEvaluate>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(B) *
                          static_cast<unsigned>((nA + kMaxAlphas - 1) / kMaxAlphas);
  kernel<<<blocks, 32 * (alphas_a_block(nA) + 1), bytes,
           static_cast<cudaStream_t>(stream)>>>(
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

// K11's occupancy at ns stage nodes and nA step sizes a call (the
// evaluating kernel, the solver's), into out[0..4]: blocks resident on one
// SM, dynamic shared memory bytes a block, registers a thread, local
// (spilled) bytes a thread, warps a block.
template <typename T>
int trial_occupancy(int ns, int nA, int* out) {
  const size_t bytes = regions<sizeof(T)>(ns, alphas_a_block(nA)).total;
  auto kernel = lip_trial_kernel<T, true>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, 32 * (alphas_a_block(nA) + 1), bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = static_cast<int>(bytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = alphas_a_block(nA) + 1;
  return static_cast<int>(e);
}

}  // namespace

// lip_trial_* run the trial; lip_trial_chain_* the same kernel with the
// evaluation compiled out (Xn and Un; cost, merit and ok are not written):
// chip_smoke.py times the chain alone with it.
#define TRIAL_ENTRY(NAME, T, EVALUATE)                                        \
  extern "C" int NAME(                                                        \
      const void* x0, const void* X, const void* U, const void* ks,           \
      const void* Ks, const void* d, const void* alphas,                      \
      const void* const* params, const void* merit0, const void* D,           \
      const void* dV1, const void* dV2, int B, int ns, int nc, int cm,        \
      int n_legs, int nA, const double* scalars, double nu_w, double beta,    \
      double alpha_min, void* Xn, void* Un, void* cost, void* merit,          \
      void* ok, void* stream) {                                               \
    return launch_trial<T, EVALUATE>(x0, X, U, ks, Ks, d, alphas, params,     \
                                     merit0, D, dV1, dV2, B, ns, nc, cm,      \
                                     n_legs, nA, scalars, nu_w, beta,         \
                                     alpha_min, Xn, Un, cost, merit, ok,      \
                                     stream);                                 \
  }

TRIAL_ENTRY(lip_trial_f32, float, true)
TRIAL_ENTRY(lip_trial_f64, double, true)
TRIAL_ENTRY(lip_trial_chain_f32, float, false)
TRIAL_ENTRY(lip_trial_chain_f64, double, false)

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

// K11's occupancy for float32 (f64 = 0) or float64 tensors at ns stage
// nodes and nA step sizes a call (see trial_occupancy above).
extern "C" int lip_trial_occupancy(int f64, int ns, int nA, int* out) {
  return f64 ? trial_occupancy<double>(ns, nA, out)
             : trial_occupancy<float>(ns, nA, out);
}
