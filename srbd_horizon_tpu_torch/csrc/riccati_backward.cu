// K1 — the blocksparse backward Riccati sweep of the batched MS-DDP solver,
// with the block-Schur SPD inverse of Quu (K2) as a device routine inside.
//
// Replaces: the JAX package's Riccati sweep. Its one Pallas kernel,
// `backward_sweep_pallas` (srbd_horizon_tpu/solvers/pallas_backward.py:264,
// its pl.pallas_call at :284, retired in b514cfb), kept the value function
// in VMEM across the node loop; its live successor is the XLA-fused
// blocksparse branch of `MSDDP._backward_lanemajor`
// (srbd_horizon_tpu/solvers/msddp.py:431-777, `node_ops` :563-598, `chain`
// :501-518). This kernel computes exactly what that branch computes, per
// member; its plain twin is `kernels/riccati.py::riccati_backward_plain`.
//
// Where the dynamics consume only some inputs (`OCP.dynamics_u_cols`: the
// isrbd forces are dead B columns), Bs carries the n_uc live columns only
// and the three B-chain terms BsᵀVx_d[ru], BsᵀV[ru,ru]Bs, BsᵀVA[ru] land
// at the live positions of the dense Qu, Quu, Qux, as msddp.py:584-597
// scatters them; the residual Grams cover every input.
//
// What bounds it on an H100 SXM: the float64 arithmetic. An SRBD
// member-node (nx=37, nu=24, 22 live rows of A−I, 18 of B, 34/42 residual
// rows) needs ~0.48 MFLOP and reads ~14.5 KB of float32; at B=512, ns=20
// that is ~4.9 GFLOP against ~185 MB, so 0.0771 ms at the FP64 tensor-core
// rate (67 TFLOP/s) against 0.055 ms at 3.35 TB/s. The isrbd-AL inner
// problem (nu=30, 19 live rows of A−I, 18 of 30 live B columns, 60/103
// residual rows, a 101-row terminal stack) needs 4.45 GFLOP at B=256:
// 0.0664 ms (chip_smoke.py computes both bounds from its own inputs).
// The LIP (nx=30, nu=15, 18 live rows of A−I, 15 of B, 32/18 residual
// rows, 10 terminal rows) is a smaller instance of the same sweep: a block
// takes 31,380 B of shared memory for float32 tensors (39,676 B for
// float64). The point-feet quadruped's SRBD OCP differs from the
// Kangaroo's only in its 30 residual rows touching x (no relative-velocity
// rows), ~0.47 MFLOP a member-node; its AL inner OCP (QuadAlShape) from
// the Kangaroo's (IsrbdAlShape) in its 56 rows touching x, not 60, and its
// 97-row terminal stack, not 101.
//
// Design, one thread block of 4 warps per member, the node loop inside:
//  * Compile-time sizes. The kernel is a template on a shape struct (one
//    per OCP: SrbdShape, IsrbdAlShape, LipShape, QuadShape, QuadAlShape,
//    PointFeetShape, SrbdRkShape, QuadRkShape, PointFeetRkShape, in
//    riccati_common.cuh, which K12 shares); every loop bound, tile count
//    and shared-memory offset is a constant. The row sets stay a run-time
//    int32 table, copied into shared memory once. The wrapper picks the
//    instantiation from the sizes and refuses any other.
//  * FP64 tensor cores. Every dense product of a node runs on warps over
//    16×8 output tiles with mma.sync m16n8k4 f64 (dmma.cuh), which runs
//    at twice the rate of m8n8k4 on an H100 (tools/torch_dmma_probe.py);
//    a lane resolves the gathered rows and columns (rx, ru, bx/bu, the
//    live columns) when it loads its fragment and clamps, then zeroes,
//    what lies past an edge. Each product sums in order of depth in its
//    own accumulator (every f64 mma shape rounds as fused multiply-adds
//    in order of depth), and
//    the two of a Q term are added as the twin adds them:
//    Qxx = (2JxpᵀJxp + VA) + SxᵀVA[rx], Quu = (2JupᵀJup + BsᵀW) + μI,
//    Qux = 2Jup[bu]ᵀJxp[bx] + BsᵀVA[ru] (at Quu's conditioning the gains
//    feel the order of every sum). The matrix-vector terms run a thread
//    per output, in order of depth too.
//  * K2 on one warp: the block-Schur recursion of `lm_spd_inverse` (split
//    at n/2, closed forms at n ≤ 3 with a lane per entry, symmetrized at
//    each level), its products on the same DMMA tiles, `__syncwarp`
//    between steps and no block barrier inside. The recursion is over
//    template sizes, so it unrolls at compile time and needs no stack.
//  * Occupancy. The value function, Quu, Qux and the small vectors are
//    float64 and live through the node; everything else shares one
//    region: VA, W and the node's blocks (kept in their storage type,
//    float32 for float32 tensors, widened where they are read — exact)
//    until the Q terms are formed, then Quu⁻¹, K and the inverse's
//    workspace. The terminal Jt streams through the blocks' place. For
//    float32 tensors a block takes 53,544 B (SRBD, four blocks an SM,
//    B=512 in one wave) or 73,356 B (isrbd, three an SM, B=256 in one
//    wave); float64 tensors take 68,040 B and 100,868 B.
//  * Overlap. There is no room for a second copy of the node's blocks at
//    these occupancies, so the other resident blocks are the overlap;
//    while one warp inverts Quu, the other three ask L2 for the next
//    node's blocks.
//
// Precision: the arithmetic on chip is float64 for float32 and float64
// tensors alike; a float32 call reads and writes float32 in device memory
// only. The 1e6 constraint weight makes Quu ill-conditioned: carried in
// float32, the recursion loses ~1e-2 relative in the gains (the plain
// float32 twin does), while float32 inputs carried in float64 lose ~1e-7.
// Summed in the order the twin's batched products take on the card and
// with the closed-form leaves rounded as the twin rounds them, the float64
// gains part from the twin's by ~2e-11 relative at chip_smoke.py's isrbd
// point, where sums in another order read ~5e-10 (Quu's conditioning
// amplifies every rounding difference).
//
// The Tassa form. `MSDDP.solve` (one robot, B=1) runs the JAX package's
// unbatched sweep, `_backward` (msddp.py:365-417): the same Q terms, then
// [k K] = −Quu⁻¹[Qu Qux] by the block-Schur inverse or by a Cholesky solve,
// and the full value update with Quu kept,
//   Vx⁺ = Qx + (KᵀQuu)k + KᵀQu + Quxᵀk,
//   Vxx⁺ = sym(Qxx + (KᵀQuu)K + KᵀQux + QuxᵀK),
//   ΔV₁ += kᵀQu,  ΔV₂ += (½kᵀQuu)k,
// summed left to right as `riccati_backward_plain` (form="tassa") sums it.
// Two more compile-time parameters pick the value form (Form) and the gain
// solve (Solve); forty instantiations are built here (`with_instance`
// below) and twelve more, the square-feet biped's, in
// csrc/riccati_backward_square_feet.cu: the collapsed form with the
// inverse at every shape, the Tassa form with the inverse at every shape
// but the two AL ones (DDPOptions' default), and the Tassa form with
// Cholesky at every shape (the AL
// solver's inner solve at IsrbdAlShape and QuadAlShape; `MSDDP.solve`'s
// quu_solver="cholesky" elsewhere, as the JAX package's `_backward` takes
// it at any shape).
// The collapsed ones compile to the code they had. The SRBD problem under
// RK2 and RK4 (SrbdRkShape, QuadRkShape, PointFeetRkShape; the two steps
// share each) has every row of B live (n_ru = nx, as the isrbd-AL shapes
// have), so its B-chain products run over nx rows, not 18 (12). The LIP
// has a shape at each of its three topologies under Euler and under RK
// (LipShape, LipRkShape, LipQuadShape, LipQuadRkShape, LipPointFeetShape,
// LipPointFeetRkShape), each with all three forms.
//  * Cholesky on one warp, in float64, column by column: lane i ≥ j forms
//    A[i][j] − Σ_{k<j} L[i][k]L[j][k] in order of k, lane j's value is the
//    pivot, √ of it is L[j][j], and the lanes below divide by it. A pivot
//    that is not positive (or NaN) writes NaN over the whole factor, as
//    the twin's `cho_factor` does (the JAX package's `cho_factor` reads
//    NaN there too), so that node's gains, and every earlier node's, are
//    NaN and the line search rejects the step.
//  * The substitutions L y = b, Lᵀ x = y run over the 1 + nx right-hand
//    sides [Qu Qux], one thread a column holding it in registers, in order
//    of row.
//  * Tassa keeps Quu through the update and needs KᵀQuu (nx×nu) and ½kᵀQuu
//    (nu) in float64. They take the inverse's workspace once the gains are
//    formed, inside the region the node's blocks fill earlier in the node,
//    so every instantiation takes the bytes of its shape's collapsed one:
//    53,544 / 68,040 B (SRBD, float32 / float64 tensors) and 73,356 /
//    100,868 B (isrbd): 0 new bytes.
//  * At B=1 one block runs the whole sweep: its time is one member's
//    latency, not a throughput.
//
// The square-feet biped (contact_model=4: SquareFeetShape, SquareFeetRkShape,
// LipSquareFeetShape, LipSquareFeetRkShape in riccati_common.cuh, all three
// forms each, instances 40-51) is compiled by
// csrc/riccati_backward_square_feet.cu, which defines K1_SQUARE_FEET and
// includes this file, into a library of its own, so that nvcc builds the
// two in parallel. Its blocks are large: nx=61, nu=48 take 159,336 B
// (collapsed, float32 tensors) to 226,244 B (RK, float64) — one block an
// SM, so B=512 takes four waves of the 132 SMs — and the LIP's nx=54,
// nu=27 96,964 to 133,144 B. K2 splits nu=48 at 24 (24, 12, 6, 3) and
// nu=27 at 13 / 14; the Cholesky factor takes rows lane and lane + 32 past
// 32 inputs (cholesky_warp).
//
// The line-feet quadruped (contact_model=2 on four legs: LineFeetQuadShape,
// LineFeetQuadRkShape, LipLineFeetQuadShape, LipLineFeetQuadRkShape, all
// three forms each, instances 52-63) is compiled the same way by
// csrc/riccati_backward_line_feet.cu (K1_LINE_FEET), a third library that
// builds beside the other two. Its shapes are the square feet's but for
// four fewer rows of G; K2 runs inside K1 at nu = 48 and 27, whose
// standalone entry is the square-feet library's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

#include "dmma.cuh"
#include "riccati_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemExceeded = -1;   // kernels/riccati.py::SMEM_EXCEEDED
constexpr int kUnknownShape = -2;   // kernels/riccati.py::UNKNOWN_SHAPE

// The shape structs (SrbdShape … PointFeetRkShape) are in riccati_common.cuh,
// one definition for K1 and K12.

// the value update (kernels/riccati.py::FORMS) and the gain solve
// (QUU_SOLVERS)
enum class Form { kCollapsed, kTassa };
enum class Solve { kSchur, kCholesky };

// Shared-memory layout. Offsets of float64 buffers count doubles from the
// start; the node's blocks count elements of T from `blocks`.
template <class S, typename T>
struct Layout {
  static constexpr int nx = S::nx, nu = S::nu;
  // float64, live through the node or across nodes
  static constexpr int Vxx = 0, Vx = Vxx + nx * nx, Vxd = Vx + nx,
                       Qx = Vxd + nx, Qu = Qx + nx, k = Qu + nu,
                       Quu = k + nu, Qux = Quu + nu * nu, acc = Qux + nu * nx,
                       region = acc + 2;
  // the region until the Q terms are formed: VA, W, then the node's blocks
  static constexpr int VA = region, W = VA + nx * nx,
                       blocks = W + S::n_ru * S::n_uc;
  static constexpr int Sx = 0, Bs = Sx + S::n_rx * nx,
                       Jxp = Bs + S::n_ru * S::n_uc, Jup = Jxp + S::n_gx * nx,
                       rxp = Jup + S::n_gu * nu, rup = rxp + S::n_gx,
                       d = rup + S::n_gu, n_blocks = d + nx;
  static constexpr int Jt = 0, rt = S::nt * nx, n_terminal = rt + S::nt;
  // the same region from the inverse on: Quu⁻¹ (or the Cholesky factor),
  // K, the inverse's workspace; once the gains are formed the Tassa form's
  // KᵀQuu and ½kᵀQuu take the workspace's place
  static constexpr int iQ = region, K = iQ + nu * nu, work = K + nu * nx;
  static constexpr int P = work, w = P + nx * nu;
  static constexpr int elem = static_cast<int>(sizeof(T));
  static constexpr int region_bytes = cmax(
      (blocks - region) * 8 + (cmax(n_blocks, n_terminal) * elem + 7) / 8 * 8,
      (nu * nu + nu * nx + cmax(inv_work(nu), nx * nu + nu)) * 8);
  // the row table (rx | ru | gx | gu | bx | bu | uc), then each input's
  // position in uc (or −1)
  static constexpr int rows_byte = region * 8 + region_bytes;
  static constexpr int n_rows = S::n_rx + S::n_ru + S::n_gx + S::n_gu +
                                2 * S::n_b + S::n_uc;
  static constexpr int bytes = rows_byte + (n_rows + nu) * 4;
};

// The tiles `warp`, `warp` + kWarps, ... of a phase's Count tiles on the
// calling warp: acc(item, a) accumulates tile `item` into a, store(item,
// a) writes it.
template <int Count, class AccFn, class StoreFn>
__device__ __forceinline__ void warp_items(int warp, AccFn acc, StoreFn store) {
  for (int item = warp; item < Count; item += kWarps) {
    Acc a;
    acc(item, a);
    store(item, a);
  }
}

// Copy Count elements from global to shared memory, thread `tid` of the
// block taking every kThreads-th; the copies are in flight until
// cp_async_wait_all().
template <int Count, typename T>
__device__ __forceinline__ void copy_in(T* smem, const T* global, int tid) {
#pragma unroll
  for (int e = tid; e < Count; e += kThreads)
    cp_async<sizeof(T)>(smem + e, global + e);
}

// Ask L2 for `count` elements at p, `rank` of `ranks` threads taking part.
template <typename T>
__device__ __forceinline__ void prefetch(const T* p, int count, int rank,
                                         int ranks) {
  const char* c = reinterpret_cast<const char*>(p);
  const int bytes = count * static_cast<int>(sizeof(T));
  for (int off = rank * 128; off < bytes + 127; off += ranks * 128)
    prefetch_l2(c + (off < bytes ? off : bytes - 1));
}

template <class S, typename T, Form F, Solve G>
__global__ void __launch_bounds__(kThreads, S::min_blocks)
riccati_backward_kernel(const T* __restrict__ Sx, const T* __restrict__ Bs,
                        const T* __restrict__ Jxp, const T* __restrict__ Jup,
                        const T* __restrict__ rho, const T* __restrict__ d,
                        const T* __restrict__ Jt, const T* __restrict__ rt,
                        const int* __restrict__ rows, int ns, int nr,
                        double mu, T* __restrict__ ks, T* __restrict__ Ks,
                        T* __restrict__ dV1, T* __restrict__ dV2) {
  using L = Layout<S, T>;
  constexpr int nx = S::nx, nu = S::nu, nt = S::nt, n_rx = S::n_rx,
                n_ru = S::n_ru, n_gx = S::n_gx, n_gu = S::n_gu, n_b = S::n_b,
                n_uc = S::n_uc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sm = reinterpret_cast<double*>(smem_raw);
  double* const Vxx = sm + L::Vxx;
  double* const Vx = sm + L::Vx;
  double* const Vxd = sm + L::Vxd;
  double* const Qx = sm + L::Qx;
  double* const Qu = sm + L::Qu;
  double* const kn = sm + L::k;
  double* const Quu = sm + L::Quu;
  double* const Qux = sm + L::Qux;
  double* const acc = sm + L::acc;
  double* const VA = sm + L::VA;
  double* const W = sm + L::W;
  double* const iQ = sm + L::iQ;
  double* const Kn = sm + L::K;
  double* const work = sm + L::work;
  double* const Pm = sm + L::P;     // KᵀQuu (Tassa)
  double* const wv = sm + L::w;     // ½kᵀQuu (Tassa)
  T* const blk = reinterpret_cast<T*>(sm + L::blocks);
  T* const Sxs = blk + L::Sx;
  T* const Bss = blk + L::Bs;
  T* const Jxs = blk + L::Jxp;
  T* const Jus = blk + L::Jup;
  T* const rxp = blk + L::rxp;
  T* const rup = blk + L::rup;
  T* const ds = blk + L::d;
  int* const rx = reinterpret_cast<int*>(smem_raw + L::rows_byte);
  int* const ru = rx + n_rx;
  int* const gx = ru + n_ru;
  int* const gu = gx + n_gx;
  int* const bx = gu + n_gu;
  int* const bu = bx + n_b;
  int* const uc = bu + n_b;
  int* const upos = uc + n_uc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t b = blockIdx.x;

  for (int e = tid; e < L::n_rows; e += kThreads) rx[e] = rows[e];
  for (int i = tid; i < nu; i += kThreads) upos[i] = -1;
  copy_in<nt * nx>(blk + L::Jt, Jt + b * nt * nx, tid);
  copy_in<nt>(blk + L::rt, rt + b * nt, tid);
  cp_async_wait_all();
  if (tid == 0) {
    acc[0] = 0.0;
    acc[1] = 0.0;
  }
  __syncthreads();
  for (int e = tid; e < n_uc; e += kThreads) upos[uc[e]] = e;

  // terminal value function: Vxx = 2 JtᵀJt, Vx = 2 Jtᵀrt
  if (tid < nx)
    Vx[tid] = 2.0 * dot<nt>([&](int r) {
                return wide(blk[L::Jt + r * nx + tid]) * wide(blk[L::rt + r]);
              });
  __syncwarp();
  warp_items<Tiles<nx, nx>::count>(
      warp,
      [&](int item, Acc& a) {
        tile_acc<nx, nx>(item, a, [&](Acc& c, int ia0, int ia1, int jb) {
          mma_seg<nt>(
              c, [&](int ia, int k) { return wide(blk[L::Jt + k * nx + ia]); },
              ia0, ia1, [&](int k) { return wide(blk[L::Jt + k * nx + jb]); });
        });
      },
      [&](int item, const Acc& a) {
        tile_store<nx, nx>(item, a, [&](int i, int j, double v, double) {
          Vxx[i * nx + j] = 2.0 * v;
        });
      });
  __syncthreads();

  // the node's products: a(ia, k) reads A's row ia, fed for the rows ia0
  // and ia1 of this lane, b(k) the B column jb
  auto va_body = [&](Acc& c, int ia0, int ia1, int jb) {  // Vxx[:,rx] Sx
    mma_seg<n_rx>(c, [&](int ia, int k) { return Vxx[ia * nx + rx[k]]; },
                  ia0, ia1, [&](int k) { return wide(Sxs[k * nx + jb]); });
  };
  auto w_body = [&](Acc& c, int ia0, int ia1, int jb) {  // V[ru,ru] Bs
    mma_seg<n_ru>(c, [&](int ia, int k) { return Vxx[ru[ia] * nx + ru[k]]; },
                  ia0, ia1, [&](int k) { return wide(Bss[k * n_uc + jb]); });
  };
  // Bs read at input ia's live position, 0 where ia is a dead column
  auto bs_at = [&](int ia, int k) {
    const int pa = upos[ia];
    const double v = wide(Bss[k * n_uc + (pa < 0 ? 0 : pa)]);
    return pa < 0 ? 0.0 : v;
  };
  auto quu_body = [&](Acc& c, int ia0, int ia1, int jb) {  // 2JupᵀJup, BsᵀW
    mma_seg<n_gu>(
        c, [&](int ia, int k) { return 2.0 * wide(Jus[k * nu + ia]); }, ia0,
        ia1, [&](int k) { return wide(Jus[k * nu + jb]); });
    const int pb = upos[jb], qb = pb < 0 ? 0 : pb;
    mma_seg<n_ru, 1>(c, bs_at, ia0, ia1, [&](int k) {
      const double v = W[k * n_uc + qb];
      return pb < 0 ? 0.0 : v;
    });
  };
  auto qxx_body = [&](Acc& c, int ia0, int ia1, int jb) {  // SxᵀVA[rx], 2JxpᵀJxp
    mma_seg<n_rx>(c, [&](int ia, int k) { return wide(Sxs[k * nx + ia]); },
                  ia0, ia1, [&](int k) { return VA[rx[k] * nx + jb]; });
    mma_seg<n_gx, 1>(
        c, [&](int ia, int k) { return 2.0 * wide(Jxs[k * nx + ia]); }, ia0,
        ia1, [&](int k) { return wide(Jxs[k * nx + jb]); });
  };
  // 2Jup[bu]ᵀJxp[bx], BsᵀVA[ru]
  auto qux_body = [&](Acc& c, int ia0, int ia1, int jb) {
    mma_seg<n_b>(
        c, [&](int ia, int k) { return 2.0 * wide(Jus[bu[k] * nu + ia]); },
        ia0, ia1, [&](int k) { return wide(Jxs[bx[k] * nx + jb]); });
    mma_seg<n_ru, 1>(c, bs_at, ia0, ia1,
                     [&](int k) { return VA[ru[k] * nx + jb]; });
  };
  auto k_body = [&](Acc& c, int ia0, int ia1, int jb) {  // Quu⁻¹ Qux
    mma_seg<nu>(c, [&](int ia, int k) { return iQ[ia * nu + k]; }, ia0, ia1,
                [&](int k) { return Qux[k * nx + jb]; });
  };
  auto v_body = [&](Acc& c, int ia0, int ia1, int jb) {  // QuxᵀK
    mma_seg<nu>(c, [&](int ia, int k) { return Qux[k * nx + ia]; }, ia0, ia1,
                [&](int k) { return Kn[k * nx + jb]; });
  };
  auto p_body = [&](Acc& c, int ia0, int ia1, int jb) {  // KᵀQuu
    mma_seg<nu>(c, [&](int ia, int k) { return Kn[k * nx + ia]; }, ia0, ia1,
                [&](int k) { return Quu[k * nu + jb]; });
  };
  auto pk_body = [&](Acc& c, int ia0, int ia1, int jb) {  // (KᵀQuu)K
    mma_seg<nu>(c, [&](int ia, int k) { return Pm[ia * nu + k]; }, ia0, ia1,
                [&](int k) { return Kn[k * nx + jb]; });
  };
  auto kq_body = [&](Acc& c, int ia0, int ia1, int jb) {  // KᵀQux, QuxᵀK
    mma_seg<nu>(c, [&](int ia, int k) { return Kn[k * nx + ia]; }, ia0, ia1,
                [&](int k) { return Qux[k * nx + jb]; });
    mma_seg<nu, 1>(c, [&](int ia, int k) { return Qux[k * nx + ia]; }, ia0,
                   ia1, [&](int k) { return Kn[k * nx + jb]; });
  };
  constexpr int nVA = Tiles<nx, nx>::count, nW = Tiles<n_ru, n_uc>::count;
  constexpr int nQuu = Tiles<nu, nu>::count, nQxx = Tiles<nx, nx>::count,
                nQux = Tiles<nu, nx>::count;

  for (int n = ns - 1; n >= 0; --n) {
    const size_t bn = b * ns + n;
    // ---- stream this node's blocks in; meanwhile symmetrize the previous
    // node's Vxx⁺
    {
      const T* rho_g = rho + bn * nr;
      copy_in<n_rx * nx>(Sxs, Sx + bn * n_rx * nx, tid);
      copy_in<n_ru * n_uc>(Bss, Bs + bn * n_ru * n_uc, tid);
      copy_in<n_gx * nx>(Jxs, Jxp + bn * n_gx * nx, tid);
      copy_in<n_gu * nu>(Jus, Jup + bn * n_gu * nu, tid);
      copy_in<nx>(ds, d + bn * nx, tid);
      for (int e = tid; e < n_gx; e += kThreads)
        cp_async<sizeof(T)>(rxp + e, rho_g + gx[e]);
      for (int e = tid; e < n_gu; e += kThreads)
        cp_async<sizeof(T)>(rup + e, rho_g + gu[e]);
    }
    if (n < ns - 1) symmetrize<nx, nx, kThreads>(Vxx, tid);
    cp_async_wait_all();
    __syncthreads();

    // ---- Vx_d = Vx + Vxx d;  VA = Vxx + Vxx[:,rx] Sx;  W = V[ru,ru] Bs ----
    if (tid < nx)
      Vxd[tid] = Vx[tid] + dot<nx>([&](int j) {
                   return Vxx[tid * nx + j] * wide(ds[j]);
                 });
    __syncwarp();
    warp_items<nVA + nW>(
        warp,
        [&](int item, Acc& a) {
          if (item < nVA)
            tile_acc<nx, nx>(item, a, va_body);
          else
            tile_acc<n_ru, n_uc>(item - nVA, a, w_body);
        },
        [&](int item, const Acc& a) {
          if (item < nVA)
            tile_store<nx, nx>(item, a, [&](int i, int j, double v, double) {
              VA[i * nx + j] = Vxx[i * nx + j] + v;
            });
          else
            tile_store<n_ru, n_uc>(item - nVA, a,
                                   [&](int i, int j, double v, double) {
              W[i * n_uc + j] = v;
            });
        });
    __syncthreads();

    // ---- Q terms (Qxx overwrites Vxx, which is no longer read) ----
    if (tid < nx) {
      const int i = tid;
      const double lx = dot<n_gx>(
          [&](int q) { return wide(Jxs[q * nx + i]) * wide(rxp[q]); });
      const double s = dot<n_rx>(
          [&](int r) { return wide(Sxs[r * nx + i]) * Vxd[rx[r]]; });
      Qx[i] = 2.0 * lx + Vxd[i] + s;
    } else if (tid < nx + nu) {
      const int j = tid - nx, pj = upos[j];
      const double lu = dot<n_gu>(
          [&](int q) { return wide(Jus[q * nu + j]) * wide(rup[q]); });
      double s = 0.0;
      if (pj >= 0)
        s = dot<n_ru>(
            [&](int a) { return wide(Bss[a * n_uc + pj]) * Vxd[ru[a]]; });
      Qu[j] = 2.0 * lu + s;
    }
    __syncwarp();
    warp_items<nQuu + nQxx + nQux>(
        warp,
        [&](int item, Acc& a) {
          if (item < nQuu)
            tile_acc<nu, nu>(item, a, quu_body);
          else if (item < nQuu + nQxx)
            tile_acc<nx, nx>(item - nQuu, a, qxx_body);
          else
            tile_acc<nu, nx>(item - nQuu - nQxx, a, qux_body);
        },
        [&](int item, const Acc& a) {
          if (item < nQuu)
            tile_store<nu, nu>(item, a, [&](int i, int j, double luu,
                                            double chain) {
              Quu[i * nu + j] = (luu + chain) + (i == j ? mu : 0.0);
            });
          else if (item < nQuu + nQxx)
            tile_store<nx, nx>(item - nQuu, a, [&](int i, int j,
                                                   double chain, double lxx) {
              Vxx[i * nx + j] = (lxx + VA[i * nx + j]) + chain;
            });
          else
            tile_store<nu, nx>(item - nQuu - nQxx, a,
                               [&](int i, int j, double lux, double chain) {
                                 Qux[i * nx + j] = lux + chain;
                               });
        });
    __syncthreads();

    // ---- Quu⁻¹ (or its Cholesky factor, into iQ's place) on warp 0; the
    // others ask L2 for the next node's blocks ----
    if (warp == 0) {
      if constexpr (G == Solve::kSchur)
        spd_inverse_warp<nu, nu, nu>(Quu, iQ, work);
      else
        cholesky_warp<nu>(Quu, iQ);
    } else if (n > 0) {
      const size_t pn = bn - 1;
      const int r = tid - 32, rs = kThreads - 32;
      prefetch(Sx + pn * n_rx * nx, n_rx * nx, r, rs);
      prefetch(Bs + pn * n_ru * n_uc, n_ru * n_uc, r, rs);
      prefetch(Jxp + pn * n_gx * nx, n_gx * nx, r, rs);
      prefetch(Jup + pn * n_gu * nu, n_gu * nu, r, rs);
      prefetch(rho + pn * nr, nr, r, rs);
      prefetch(d + pn * nx, nx, r, rs);
    }
    __syncthreads();

    // ---- gains: k = −Quu⁻¹Qu, K = −Quu⁻¹Qux ----
    T* const ks_g = ks + bn * nu;
    T* const Ks_g = Ks + bn * nu * nx;
    if constexpr (G == Solve::kSchur) {
      if (tid < nu) {
        const double s =
            dot<nu>([&](int j) { return iQ[tid * nu + j] * Qu[j]; });
        kn[tid] = -s;
        ks_g[tid] = static_cast<T>(-s);
      }
      __syncwarp();
      warp_items<Tiles<nu, nx>::count>(
          warp, [&](int item, Acc& a) { tile_acc<nu, nx>(item, a, k_body); },
          [&](int item, const Acc& a) {
            tile_store<nu, nx>(item, a, [&](int i, int j, double v, double) {
              Kn[i * nx + j] = -v;
              Ks_g[i * nx + j] = static_cast<T>(-v);
            });
          });
    } else if (tid < 1 + nx) {
      // column tid of [Qu Qux] through the factor, a thread a column, in
      // place in k (column 0) or K
      const int ld = tid == 0 ? 1 : nx;
      double* const x = tid == 0 ? kn : Kn + (tid - 1);
      T* const x_g = tid == 0 ? ks_g : Ks_g + (tid - 1);
      for (int i = 0; i < nu; ++i)
        x[i * ld] = tid == 0 ? Qu[i] : Qux[i * nx + tid - 1];
      cholesky_solve<nu>(iQ, x, ld);
      for (int i = 0; i < nu; ++i) {
        const double v = -x[i * ld];
        x[i * ld] = v;
        x_g[i * ld] = static_cast<T>(v);
      }
    }
    __syncthreads();

    if constexpr (F == Form::kCollapsed) {
      // ---- Schur-form value update (symmetrized at the next node's start) ----
      if (tid < nx)
        Vx[tid] = Qx[tid] +
                  dot<nu>([&](int u) { return Qux[u * nx + tid] * kn[u]; });
      if (warp == kWarps - 1) {
        double p = 0.0;
        for (int u = lane; u < nu; u += 32) p += kn[u] * Qu[u];
        for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) {
          acc[0] = acc[0] + p;
          acc[1] = acc[1] - 0.5 * p;
        }
      }
      __syncwarp();
      warp_items<Tiles<nx, nx>::count>(
          warp, [&](int item, Acc& a) { tile_acc<nx, nx>(item, a, v_body); },
          [&](int item, const Acc& a) {
            tile_store<nx, nx>(item, a, [&](int i, int j, double v, double) {
              Vxx[i * nx + j] += v;
            });
          });
    } else {
      // ---- Tassa value update: KᵀQuu and ½kᵀQuu first ----
      if (tid < nu)
        wv[tid] = dot<nu>([&](int l) { return (0.5 * kn[l]) * Quu[l * nu + tid]; });
      __syncwarp();
      warp_items<Tiles<nx, nu>::count>(
          warp, [&](int item, Acc& a) { tile_acc<nx, nu>(item, a, p_body); },
          [&](int item, const Acc& a) {
            tile_store<nx, nu>(item, a, [&](int i, int j, double v, double) {
              Pm[i * nu + j] = v;
            });
          });
      __syncthreads();
      // Vx⁺ = ((Qx + (KᵀQuu)k) + KᵀQu) + Quxᵀk; Vxx ← Qxx + (KᵀQuu)K
      if (tid < nx) {
        const double a = dot<nu>([&](int j) { return Pm[tid * nu + j] * kn[j]; });
        const double bq = dot<nu>([&](int j) { return Kn[j * nx + tid] * Qu[j]; });
        const double c = dot<nu>([&](int j) { return Qux[j * nx + tid] * kn[j]; });
        Vx[tid] = ((Qx[tid] + a) + bq) + c;
      }
      if (warp == kWarps - 1) {
        double p = 0.0, q = 0.0;
        for (int u = lane; u < nu; u += 32) {
          p += kn[u] * Qu[u];
          q += wv[u] * kn[u];
        }
        for (int o = 16; o > 0; o >>= 1) {
          p += __shfl_xor_sync(0xffffffffu, p, o);
          q += __shfl_xor_sync(0xffffffffu, q, o);
        }
        if (lane == 0) {
          acc[0] = acc[0] + p;
          acc[1] = acc[1] + q;
        }
      }
      __syncwarp();
      warp_items<Tiles<nx, nx>::count>(
          warp, [&](int item, Acc& a) { tile_acc<nx, nx>(item, a, pk_body); },
          [&](int item, const Acc& a) {
            tile_store<nx, nx>(item, a, [&](int i, int j, double v, double) {
              Vxx[i * nx + j] += v;
            });
          });
      __syncthreads();
      // Vxx ← (Vxx + KᵀQux) + QuxᵀK (symmetrized at the next node's start)
      warp_items<Tiles<nx, nx>::count>(
          warp, [&](int item, Acc& a) { tile_acc<nx, nx>(item, a, kq_body); },
          [&](int item, const Acc& a) {
            tile_store<nx, nx>(item, a, [&](int i, int j, double v, double u) {
              Vxx[i * nx + j] = (Vxx[i * nx + j] + v) + u;
            });
          });
    }
    __syncthreads();
  }
  if (tid == 0) {
    dV1[b] = static_cast<T>(acc[0]);
    dV2[b] = static_cast<T>(acc[1]);
  }
}

// refuse, rather than let the launch fail, a block whose shared memory
// exceeds what the card lets a block opt in to
template <class Kernel>
int opt_in(Kernel kernel, int bytes) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > limit) return kSmemExceeded;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <class S, typename T, Form F, Solve G>
int launch(const void* Sx, const void* Bs, const void* Jxp, const void* Jup,
           const void* rho, const void* d, const void* Jt, const void* rt,
           const void* rows, int B, int ns, int nr, double mu, void* ks,
           void* Ks, void* dV1, void* dV2, void* stream) {
  if (B == 0) return 0;
  constexpr int bytes = Layout<S, T>::bytes;
  const int err = opt_in(riccati_backward_kernel<S, T, F, G>, bytes);
  if (err != 0) return err;
  riccati_backward_kernel<S, T, F, G><<<B, kThreads, bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Sx), static_cast<const T*>(Bs),
      static_cast<const T*>(Jxp), static_cast<const T*>(Jup),
      static_cast<const T*>(rho), static_cast<const T*>(d),
      static_cast<const T*>(Jt), static_cast<const T*>(rt),
      static_cast<const int*>(rows), ns, nr,
      static_cast<double>(static_cast<T>(mu)),   // μ as the plain twin rounds it
      static_cast<T*>(ks), static_cast<T*>(Ks), static_cast<T*>(dV1),
      static_cast<T*>(dV2));
  return static_cast<int>(cudaGetLastError());
}

template <class S>
bool matches(const int* dims) {
  const int want[9] = {S::nx,   S::nu,   S::nt,   S::n_rx, S::n_ru,
                       S::n_gx, S::n_gu, S::n_b,  S::n_uc};
  for (int i = 0; i < 9; ++i)
    if (dims[i] != want[i]) return false;
  return true;
}

// ---- K2 alone: one warp per matrix of an (M, N, N) stack ----

constexpr int kInvWarps = 4;

template <int N>
__host__ __device__ constexpr int inv_slot() {   // doubles a warp takes: A, A⁻¹, workspace
  return 2 * N * N + inv_work(N);
}

template <int N, typename T>
__global__ void __launch_bounds__(kInvWarps * 32)
spd_inverse_kernel(const T* __restrict__ A, T* __restrict__ out, int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t mat = static_cast<size_t>(blockIdx.x) * kInvWarps + warp;
  if (mat >= static_cast<size_t>(M)) return;
  double* a = reinterpret_cast<double*>(smem_raw) + warp * inv_slot<N>();
  double* o = a + N * N;
  const T* A_g = A + mat * N * N;
  for (int e = lane; e < N * N; e += 32) a[e] = wide(A_g[e]);
  __syncwarp();
  spd_inverse_warp<N, N, N>(a, o, o + N * N);
  T* out_g = out + mat * N * N;
  for (int e = lane; e < N * N; e += 32) out_g[e] = static_cast<T>(o[e]);
}

template <int N, typename T>
int launch_inverse(const void* A, void* out, int M, void* stream) {
  if (M == 0) return 0;
  constexpr int bytes = kInvWarps * inv_slot<N>() * 8;
  const int err = opt_in(spd_inverse_kernel<N, T>, bytes);
  if (err != 0) return err;
  spd_inverse_kernel<N, T><<<(M + kInvWarps - 1) / kInvWarps, kInvWarps * 32,
                             bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int inverse(const void* A, void* out, int M, int n, void* stream) {
#if defined(K1_LINE_FEET)
  (void)A, (void)out, (void)M, (void)n, (void)stream;
  return kUnknownShape;
#elif defined(K1_SQUARE_FEET)
  if (n == SquareFeetShape::nu)
    return launch_inverse<SquareFeetShape::nu, T>(A, out, M, stream);
  if (n == LipSquareFeetShape::nu)
    return launch_inverse<LipSquareFeetShape::nu, T>(A, out, M, stream);
  return kUnknownShape;
#else
  if (n == SrbdShape::nu)
    return launch_inverse<SrbdShape::nu, T>(A, out, M, stream);
  if (n == IsrbdAlShape::nu)
    return launch_inverse<IsrbdAlShape::nu, T>(A, out, M, stream);
  if (n == LipShape::nu)
    return launch_inverse<LipShape::nu, T>(A, out, M, stream);
  if (n == PointFeetShape::nu)
    return launch_inverse<PointFeetShape::nu, T>(A, out, M, stream);
  if (n == LipPointFeetShape::nu)
    return launch_inverse<LipPointFeetShape::nu, T>(A, out, M, stream);
  return kUnknownShape;
#endif
}

template <class S, typename T, Form F, Solve G>
int occupancy(int* blocks) {
  constexpr int bytes = Layout<S, T>::bytes;
  const int err = opt_in(riccati_backward_kernel<S, T, F, G>, bytes);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, riccati_backward_kernel<S, T, F, G>, kThreads, bytes));
}

template <class Shape, Form FF, Solve GG>
struct Inst {
  using S = Shape;
  static constexpr Form F = FF;
  static constexpr Solve G = GG;
};

// fn(Inst<...>{}) for instantiation `inst`, in the order of
// kernels/riccati.py::KERNEL_INSTANCES; UNKNOWN_SHAPE for another index
template <class Fn>
int with_instance(int inst, Fn fn) {
  switch (inst) {
#if !defined(K1_SQUARE_FEET) && !defined(K1_LINE_FEET)
    case 0: return fn(Inst<SrbdShape, Form::kCollapsed, Solve::kSchur>{});
    case 1: return fn(Inst<IsrbdAlShape, Form::kCollapsed, Solve::kSchur>{});
    case 2: return fn(Inst<SrbdShape, Form::kTassa, Solve::kSchur>{});
    case 3: return fn(Inst<IsrbdAlShape, Form::kTassa, Solve::kCholesky>{});
    case 4: return fn(Inst<SrbdShape, Form::kTassa, Solve::kCholesky>{});
    case 5: return fn(Inst<LipShape, Form::kCollapsed, Solve::kSchur>{});
    case 6: return fn(Inst<LipShape, Form::kTassa, Solve::kSchur>{});
    case 7: return fn(Inst<LipShape, Form::kTassa, Solve::kCholesky>{});
    case 8: return fn(Inst<QuadShape, Form::kCollapsed, Solve::kSchur>{});
    case 9: return fn(Inst<QuadShape, Form::kTassa, Solve::kSchur>{});
    case 10: return fn(Inst<QuadAlShape, Form::kCollapsed, Solve::kSchur>{});
    case 11: return fn(Inst<QuadAlShape, Form::kTassa, Solve::kCholesky>{});
    case 12: return fn(Inst<PointFeetShape, Form::kCollapsed, Solve::kSchur>{});
    case 13: return fn(Inst<PointFeetShape, Form::kTassa, Solve::kSchur>{});
    case 14: return fn(Inst<PointFeetShape, Form::kTassa, Solve::kCholesky>{});
    case 15: return fn(Inst<SrbdRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 16: return fn(Inst<SrbdRkShape, Form::kTassa, Solve::kSchur>{});
    case 17: return fn(Inst<SrbdRkShape, Form::kTassa, Solve::kCholesky>{});
    case 18: return fn(Inst<QuadRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 19: return fn(Inst<QuadRkShape, Form::kTassa, Solve::kSchur>{});
    case 20: return fn(Inst<PointFeetRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 21: return fn(Inst<PointFeetRkShape, Form::kTassa, Solve::kSchur>{});
    case 22: return fn(Inst<QuadShape, Form::kTassa, Solve::kCholesky>{});
    case 23: return fn(Inst<QuadRkShape, Form::kTassa, Solve::kCholesky>{});
    case 24: return fn(Inst<PointFeetRkShape, Form::kTassa, Solve::kCholesky>{});
    case 25: return fn(Inst<LipRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 26: return fn(Inst<LipRkShape, Form::kTassa, Solve::kSchur>{});
    case 27: return fn(Inst<LipRkShape, Form::kTassa, Solve::kCholesky>{});
    case 28: return fn(Inst<LipQuadShape, Form::kCollapsed, Solve::kSchur>{});
    case 29: return fn(Inst<LipQuadShape, Form::kTassa, Solve::kSchur>{});
    case 30: return fn(Inst<LipQuadShape, Form::kTassa, Solve::kCholesky>{});
    case 31: return fn(Inst<LipQuadRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 32: return fn(Inst<LipQuadRkShape, Form::kTassa, Solve::kSchur>{});
    case 33: return fn(Inst<LipQuadRkShape, Form::kTassa, Solve::kCholesky>{});
    case 34: return fn(Inst<LipPointFeetShape, Form::kCollapsed, Solve::kSchur>{});
    case 35: return fn(Inst<LipPointFeetShape, Form::kTassa, Solve::kSchur>{});
    case 36: return fn(Inst<LipPointFeetShape, Form::kTassa, Solve::kCholesky>{});
    case 37: return fn(Inst<LipPointFeetRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 38: return fn(Inst<LipPointFeetRkShape, Form::kTassa, Solve::kSchur>{});
    case 39: return fn(Inst<LipPointFeetRkShape, Form::kTassa, Solve::kCholesky>{});
#elif defined(K1_SQUARE_FEET)
    // csrc/riccati_backward_square_feet.cu: the square-feet biped's shapes
    case 40: return fn(Inst<SquareFeetShape, Form::kCollapsed, Solve::kSchur>{});
    case 41: return fn(Inst<SquareFeetShape, Form::kTassa, Solve::kSchur>{});
    case 42: return fn(Inst<SquareFeetShape, Form::kTassa, Solve::kCholesky>{});
    case 43: return fn(Inst<SquareFeetRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 44: return fn(Inst<SquareFeetRkShape, Form::kTassa, Solve::kSchur>{});
    case 45: return fn(Inst<SquareFeetRkShape, Form::kTassa, Solve::kCholesky>{});
    case 46: return fn(Inst<LipSquareFeetShape, Form::kCollapsed, Solve::kSchur>{});
    case 47: return fn(Inst<LipSquareFeetShape, Form::kTassa, Solve::kSchur>{});
    case 48: return fn(Inst<LipSquareFeetShape, Form::kTassa, Solve::kCholesky>{});
    case 49: return fn(Inst<LipSquareFeetRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 50: return fn(Inst<LipSquareFeetRkShape, Form::kTassa, Solve::kSchur>{});
    case 51: return fn(Inst<LipSquareFeetRkShape, Form::kTassa, Solve::kCholesky>{});
#else
    // csrc/riccati_backward_line_feet.cu: the line-feet quadruped's shapes
    case 52: return fn(Inst<LineFeetQuadShape, Form::kCollapsed, Solve::kSchur>{});
    case 53: return fn(Inst<LineFeetQuadShape, Form::kTassa, Solve::kSchur>{});
    case 54: return fn(Inst<LineFeetQuadShape, Form::kTassa, Solve::kCholesky>{});
    case 55: return fn(Inst<LineFeetQuadRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 56: return fn(Inst<LineFeetQuadRkShape, Form::kTassa, Solve::kSchur>{});
    case 57: return fn(Inst<LineFeetQuadRkShape, Form::kTassa, Solve::kCholesky>{});
    case 58: return fn(Inst<LipLineFeetQuadShape, Form::kCollapsed, Solve::kSchur>{});
    case 59: return fn(Inst<LipLineFeetQuadShape, Form::kTassa, Solve::kSchur>{});
    case 60: return fn(Inst<LipLineFeetQuadShape, Form::kTassa, Solve::kCholesky>{});
    case 61: return fn(Inst<LipLineFeetQuadRkShape, Form::kCollapsed, Solve::kSchur>{});
    case 62: return fn(Inst<LipLineFeetQuadRkShape, Form::kTassa, Solve::kSchur>{});
    case 63: return fn(Inst<LipLineFeetQuadRkShape, Form::kTassa, Solve::kCholesky>{});
#endif
    default: return kUnknownShape;
  }
}

}  // namespace

// `inst` indexes kernels/riccati.py::KERNEL_INSTANCES; the sizes must be
// that instantiation's shape's, or the call returns UNKNOWN_SHAPE and
// launches nothing.
#define RICCATI_ENTRY(NAME, T)                                                \
  extern "C" int NAME(int inst, const void* Sx, const void* Bs,               \
                      const void* Jxp, const void* Jup, const void* rho,      \
                      const void* d, const void* Jt, const void* rt,          \
                      const void* rows, int B, int ns, int nx, int nu,        \
                      int nr, int nt, int n_rx, int n_ru, int n_gx, int n_gu, \
                      int n_b, int n_uc, double mu, void* ks, void* Ks,       \
                      void* dV1, void* dV2, void* stream) {                   \
    const int dims[9] = {nx, nu, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc};      \
    return with_instance(inst, [&](auto in) {                                 \
      using I = decltype(in);                                                 \
      if (!matches<typename I::S>(dims)) return kUnknownShape;                \
      return launch<typename I::S, T, I::F, I::G>(                            \
          Sx, Bs, Jxp, Jup, rho, d, Jt, rt, rows, B, ns, nr, mu, ks, Ks, dV1, \
          dV2, stream);                                                       \
    });                                                                       \
  }

RICCATI_ENTRY(riccati_backward_f32, float)
RICCATI_ENTRY(riccati_backward_f64, double)

// Quu⁻¹ alone, on an (M, n, n) stack of SPD matrices, n = 9, 12, 15, 24 or
// 30 (27 or 48 in the square-feet library; none in the line-feet one): the
// device routine K1 runs, for timing and checking it by itself.
extern "C" int spd_inverse_f32(const void* A, void* out, int M, int n,
                               void* stream) {
  return inverse<float>(A, out, M, n, stream);
}
extern "C" int spd_inverse_f64(const void* A, void* out, int M, int n,
                               void* stream) {
  return inverse<double>(A, out, M, n, stream);
}

// Dynamic shared memory one K1 block of instantiation `inst` takes, in
// bytes, for tensors of float32 (f64 = 0) or float64 (f64 = 1).
extern "C" long long riccati_backward_smem_bytes(int inst, int f64) {
  return with_instance(inst, [&](auto in) {
    using I = decltype(in);
    return f64 ? Layout<typename I::S, double>::bytes
               : Layout<typename I::S, float>::bytes;
  });
}

// K1 blocks of instantiation `inst` resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks; returns 0
// or an error.
extern "C" int riccati_backward_blocks_per_sm(int inst, int f64, int* blocks) {
  return with_instance(inst, [&](auto in) {
    using I = decltype(in);
    return f64 ? occupancy<typename I::S, double, I::F, I::G>(blocks)
               : occupancy<typename I::S, float, I::F, I::G>(blocks);
  });
}
