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
// Compiled for fifteen instances (csrc/srbd_common.cuh): the Kangaroo's
// line feet (`srbd::KangarooShape`), the quadruped's point feet
// (`srbd::QuadShape`, no relative-velocity rows: 69 stage rows, 30 of them
// in Jxp), the point-feet biped (`srbd::PointFeetShape`: nx=25, nu=12,
// 45 stage rows), the square-feet biped (`srbd::SquareFeetShape`:
// nx=61, nu=48, 129 stage rows; its inputs take two rounds of a warp's
// lanes wherever a lane takes an input) and the line-feet quadruped
// (`srbd::LineFeetQuadShape`: the same nx and nu, 125 stage rows, 50 of
// them in Jxp), each under the Euler step and
// under RK2 and RK4 (`srbd::Stepped`). In each, the per-node output sizes, the smem layout
// and every loop bound are constants; the contact topology and the step
// pick the instantiation at launch, and the wrapper refuses other sizes.
// The row table stays a run-time input.
//
// RK2 and RK4. The residual rows and their Jacobians do not change (ρ
// reads ẋ(x, u), not the step); the dynamics blocks are those of the step,
//     k_s = ẋ(x_s, u),  x_s = x + c_s·dt·k_{s−1}  (c = ½ / ½, ½, 1),
//     dk_s = F_x(x_s)·(e + c_s·dt·dk_{s−1}) + F_u(x_s)·e_u
// for each column e of (x | u), and A − I = dt·dk₂ (RK2) or
// dt/6·(dk₁ + 2dk₂ + 2dk₃ + dk₄) (RK4), B likewise on the u columns,
// F_x = ∂ẋ/∂x and F_u = ∂ẋ/∂u at each stage point in the closed form
// above. F_x has few live rows (r, o, c from ṙ, ȯ and ċ; ω̇), so the
// warp keeps, at each stage point, only ∂ω̇'s columns and that point's o
// and ω (`wdot_columns`, `keep_ow`, formed inside `srbd::step_rows` while
// it evaluates the step), and a lane then carries one column of (x | u)
// through the stages in registers (`rk_column`): the n_live = 10 + 3nc
// rows r, o, c, ω of dk_s, the ṙ and ċ rows being F_u's constants. Sx is
// A − I on those rows (the ṙ and ċ rows are zero under every step), and
// Bs is B on every row: the live rows from the chain, the ṙ and ċ rows
// F_u's (dt/m at the force columns, dt at the c̈ columns), as under Euler.
// d is step(x, u) − X[n+1]. The stages cost what they add to the chain of
// a node's scalars, not bytes: 0.134 / 0.201 ms at B=512 under RK2 / RK4
// against 0.0748 under Euler (the Kangaroo, float32, an H100 at 700 W,
// chip_smoke.py phase 14), 4 blocks an SM.
//
// What bounds it on an H100: bytes. A member-node writes 3,622 values
// (Sx 814, Bs 432, Jxp 1,258, Jup 1,008, ρ 73, d 37; the quadruped 3,470:
// Jxp 1,110, ρ 69) and reads ~120; most
// outputs are structural zeros or constants that K1 reads dense. At B=512,
// ns=20 that is ~148 MB of f32 out and ~5 MB in, ~0.046 ms at 3.35 TB/s,
// against a few thousand FLOP per member-node (~0.001 ms at 67 TFLOP/s).
// The first design spent more instructions than bytes: every lane evaluated
// ~113 entries one by one, each with a run-time division, a walk through
// the region branches of a per-entry function and a 4-byte store, after a
// prologue in which lanes 0 and 1 worked while 30 waited; it ran at 3.3×
// the byte bound. This one runs at ~1.6× (~0.074 ms at B=512, ~2.1 TB/s, on
// an H100 at 700 W, `kernel_times` in chip_smoke.py): the stores of one
// block still wait on its nodes' scalars, and the next block's on its own.
//
// Design: a block takes 4 consecutive stage member-nodes, one warp each.
// In float32 a run of 4 member-nodes that begins at a flat index b·ns+n
// divisible by 4 starts 16-byte aligned in every stage output (the per-node
// sizes 814, 432, 1,258, 1,008, 73 and 37, the quadruped's 1,110 and 69,
// times 4 are multiples of 4), and
// the 4 nodes' blocks of one output are contiguous; the block composes
// them in shared memory and streams them out with 16-byte stores (double2
// in float64), the whole block on each output. It stages one Jacobian
// block at a time (Sx, Bs, Jxp, Jup in turn through one 20 KB buffer; the
// quadruped's Jxp 17.8 KB), so a block holds ~28 KB of shared memory in
// float32 (~26 KB, the quadruped) and seven blocks share
// an SM: while some compute their nodes' scalars, others stream (the
// square-feet biped's buffer holds 60 KB, four nodes' Jup of 78 × 48, and
// a block 74-92 KB in float32 from Euler to RK4: two or three blocks an
// SM; 145-181 KB in float64, one; the line-feet quadruped's Jup is the
// same). A staged
// block is filled with zeros (16-byte stores), then each warp writes its
// node's nonzeros by the row kinds the block resolved once from the row
// table (one entry, two entries, quaternion row, quaternion-error row,
// dense ∂ω̇ row, r̈ row, zero): the sparse rows one lane a row, the dense
// ∂ω̇ rows one row at a time with the lanes over the columns. No entry is
// found by division. The node's scalars come first: every lane holds the
// rigid-body rates and R I Rᵀ, its cofactors and Iw ω in registers
// (csrc/srbd_common.cuh, shared with K3); ∂ω̇ goes one column a lane,
// except the four o columns, whose ∂Iwⱼ rows go to twelve lanes (a column
// on three lanes, a row of ∂Iwⱼ each) that trade their rows by shuffles;
// then the 73 (69) residual rows and the defects, staged with the
// Jacobians.
// The terminal pairs rt, Jt run in blocks of their own after the stage
// blocks, one warp a member.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "srbd_common.cuh"

namespace {

using srbd::kUnknownShape;
constexpr int kWarps = 4;                // member-nodes (warps) a stage block

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Row kinds of the four Jacobian blocks (resolved once a block from the row
// table): info0 = kind | value << 8, info1 = a | b << 16.
enum Kind : int {
  kZero = 0,   // no entry
  kOne,        // `value` at column a
  kTwo,        // −value at column a, +value at column b
  kQuat,       // Sx: row a of ȯ = ½ (ω,0)⊗o (4 o and 3 ω columns)
  kQerr,       // Jxp: row a of o ⊗ oref (4 o columns)
  kDense,      // row a of ∂ω̇ (dense, written by the lanes over columns)
  kRdd,        // row a of r̈: 1/m at each force column of axis a
  kComposed    // RK2/RK4, Sx and Bs: live row a (Layout::n_live order) of the
               // composed step Jacobian, written by the lanes over columns
};
// values of kOne/kTwo entries: vCs + q is √w_c · cdot_switch[q], and
// K4<S>::vFsw + q (= vCs + nc + q) is w_fswitch · (1 − cdot_switch[q])
enum : int {
  vOne = 0, vMtWr, vMtWrdot, vMtWw, vWc, vWqddot, vWminf, vMtWrel, vCs
};

// K4's constants at shape S: the per-node sizes of the four Jacobian
// blocks (the block stages one of them at a time for its kWarps nodes,
// back to back, 16-byte aligned), then ρ and d of the kWarps nodes,
// composed during the prologue; a warp's scratch (x, X[n+1], u, ẋ,
// params, ∂ω̇ columns, 3 a column); the rows of the four blocks.
template <class S>
struct K4 {
  using L = srbd::Layout<S>;
  static constexpr int nx = S::nx, nu = S::nu, nr = S::n_rho;
  static constexpr int stages = S::Step::stages;
  static constexpr int nW = 3 * (nx + nu);       // ∂ω̇ columns of one point
  static constexpr int kSx = S::n_rx * nx, kBs = S::n_ru * nu,
                       kJxp = S::n_gx * nx, kJup = S::n_gu * nu;
  static constexpr int kStage = kWarps * cmax(cmax(kSx, kBs), cmax(kJxp, kJup));
  static constexpr int oRho = kStage, oD = oRho + kWarps * nr,
                       oEnd = oD + kWarps * nx;
  static_assert(kStage % 4 == 0 && oD % 4 == 0 && oEnd % 4 == 0 &&
                    (kWarps * kSx) % 4 == 0 && (kWarps * kBs) % 4 == 0 &&
                    (kWarps * kJxp) % 4 == 0 && (kWarps * kJup) % 4 == 0,
                "16-byte alignment of the staged outputs");
  // under RK2/RK4 the warp keeps ∂ω̇ at every stage point (wW, one block of
  // nW a stage), the stage point being formed (wXs) and each stage point's
  // o and ω (wOw, 7 a stage)
  static constexpr int wX = 0, wXn = wX + nx, wU = wXn + nx, wXd = wU + nu,
                       wP = wXd + nx, wW = wP + L::pw,
                       wXs = wW + stages * nW,
                       wOw = wXs + srbd::stage_scratch<S>(),
                       wSize = wOw + (stages > 1 ? 7 * stages : 0) + 1;
  static constexpr int kRows = S::n_rx + S::n_ru + S::n_gx + S::n_gu;
  static constexpr int vFsw = vCs + S::nc;   // the first fswitch value
  // the composed rows' slots (RK2/RK4): for Sx and Bs, the position of each
  // live row in the block, or −1
  static constexpr int kLiveSlots = stages > 1 ? 2 * L::n_live : 0;
};

// shared memory: staged outputs, warp scratch (both in T), then the row
// kinds (2 ints a row), the dense-row slots (3 per Jacobian block) and the
// composed rows' slots
template <class S, typename T>
constexpr size_t smem_bytes() {
  using C = K4<S>;
  return sizeof(T) * (C::oEnd + kWarps * C::wSize) +
         sizeof(int) * (2 * C::kRows + 12 + C::kLiveSlots);
}

// The position of state row r among the live rows (Layout::n_live: r, o, c,
// then ω), or −1.
template <class S>
__host__ __device__ constexpr int live_index(int r) {
  using L = srbd::Layout<S>;
  return r < L::i_rdot ? r
         : (r >= L::i_w && r < L::i_cdot) ? L::i_rdot + (r - L::i_w) : -1;
}

__device__ __forceinline__ int2 kind(int k, int value = 0, int a = 0,
                                     int b = 0) {
  return make_int2(k | (value << 8), a | (b << 16));
}

// Row r of block `blk` (0 Sx, 1 Bs, 2 Jxp, 3 Jup).
template <class S>
__device__ int2 resolve(int blk, int r) {
  using L = srbd::Layout<S>;
  constexpr int nc = S::nc;
  if constexpr (S::Step::stages > 1) {             // the composed RK blocks
    if (blk < 2 && live_index<S>(r) >= 0) return kind(kComposed, 0, live_index<S>(r));
    if (blk == 0) return kind(kZero);              // ṙ, ċ rows of A − I
  }
  if (blk == 0) {                                  // (∂ẋ/∂x)[r]
    if (r < 3) return kind(kOne, vOne, L::i_rdot + r);
    if (r < 7) return kind(kQuat, 0, r - 3);
    if (r < L::i_rdot) return kind(kOne, vOne, L::i_cdot + r - 7);
    if (r >= L::i_w && r < L::i_cdot) return kind(kDense, 0, r - L::i_w);
    return kind(kZero);
  }
  if (blk == 1) {                                  // (∂ẋ/∂u)[r]
    if (r < L::i_rdot) return kind(kZero);
    if (r < L::i_w) return kind(kRdd, 0, r - L::i_rdot);
    if (r < L::i_cdot) return kind(kDense, 0, r - L::i_w);
    const int e = r - L::i_cdot;
    return kind(kOne, vOne, 6 * (e / 3) + e % 3);
  }
  if (blk == 2) {                                  // (∂ρ/∂x)[r]
    if (r == 0) return kind(kOne, vMtWr, 2);
    if (r < 5) return kind(kQerr, 0, r - 1);
    if (r < 8) return kind(kOne, vMtWrdot, L::i_rdot + r - 5);
    if (r < 11) return kind(kOne, vMtWw, L::i_w + r - 8);
    if (r < 15) {
      int a, b;
      srbd::rel_cols<S>(r, &a, &b);
      return kind(kTwo, vMtWrel, L::i_c + a, L::i_c + b);
    }
    if (r >= 18 && r < 21) return kind(kDense, 0, r - 18);
    if (r < L::n_res) return kind(kZero);
    int q = r - L::n_res;                          // √w_c · ∂stage_eq/∂x
    if constexpr (L::n_rv > 0) {                   // none on point feet
      constexpr int per = 2 * (S::cm - 1);
      if (q < L::n_rv) {
        const int base = (q / per) * S::cm, rem = q % per;
        const int i = rem / 2 + 1, ax = rem % 2;
        return kind(kTwo, vWc, L::i_cdot + 3 * (base + i) + ax,
                    L::i_cdot + 3 * base + ax);
      }
    }
    q -= L::n_rv;
    if (q < nc) return kind(kOne, vWc, L::i_c + 3 * q + 2);
    q -= nc;
    return kind(kOne, vCs + q / 2, L::i_cdot + 3 * (q / 2) + q % 2);
  }
  // (∂ρ/∂u)[r]
  if (r < 15) return kind(kZero);
  if (r < 18) return kind(kRdd, 0, r - 15);
  if (r < 21) return kind(kDense, 0, r - 18);
  if (r < 21 + 3 * nc) {
    const int q = r - 21;
    return kind(kOne, vWqddot, 6 * (q / 3) + q % 3);
  }
  if (r < 21 + 6 * nc) {
    const int q = r - 21 - 3 * nc;
    return kind(kOne, vWminf, 6 * (q / 3) + 3 + q % 3);
  }
  if (r < L::n_res) {
    const int q = r - 21 - 6 * nc;
    return kind(kOne, K4<S>::vFsw + q / 3, 6 * (q / 3) + 3 + q % 3);
  }
  return kind(kZero);
}

template <class S, typename T>
__device__ __forceinline__ T entry_value(int v, const T* p,
                                         const srbd::Consts<T>& k) {
  const T mt = p[srbd::kP_mt];
  switch (v) {
    case vOne: return T(1);
    case vMtWr: return mt * k.w_r;
    case vMtWrdot: return mt * k.w_rdot;
    case vMtWw: return mt * k.w_w;
    case vWc: return k.wc;
    case vWqddot: return k.w_qddot;
    case vWminf: return k.w_minf;
    case vMtWrel: return mt * k.w_rel;
    default: break;
  }
  if (v < K4<S>::vFsw) return k.wc * p[srbd::kP_cref + S::nc + (v - vCs)];
  return k.w_fswitch * (T(1) - p[srbd::kP_cref + S::nc + (v - K4<S>::vFsw)]);
}

// Row i, column j of ∂(o ⊗ q)/∂o = [[q_w I − [q_v]ₓ, q_v], [−q_vᵀ, q_w]].
template <typename T>
__device__ __forceinline__ T quat_err_jac(int i, int j, const T* q) {
  if (i == 3) return j == 3 ? q[3] : -q[j];
  if (j == 3) return q[i];
  if (i == j) return q[3];
  const int third = 3 - i - j;
  return j == (i + 1) % 3 ? q[third] : -q[third];
}

// Lane `lane` writes the nonzeros of the sparse rows lane, lane+32, … of
// one node's block `dst` (rows of `width` entries, zero-filled before);
// `scale` multiplies every entry (dt for Sx and Bs, 1 for Jxp and Jup).
template <class S, typename T>
__device__ void emit_sparse(const int* info, int n_rows, int width, T scale,
                            T rdd, const T* x, const T* p,
                            const srbd::Consts<T>& k, int lane, T* dst) {
  using L = srbd::Layout<S>;
  for (int i = lane; i < n_rows; i += 32) {
    const int i0 = info[2 * i], i1 = info[2 * i + 1];
    const int kd = i0 & 0xff, v = i0 >> 8, a = i1 & 0xffff, b = i1 >> 16;
    T* row = dst + i * width;
    switch (kd) {
      case kOne:
        row[a] = scale * entry_value<S>(v, p, k);
        break;
      case kTwo: {
        const T e = entry_value<S>(v, p, k);
        row[a] = -e;
        row[b] = e;
        break;
      }
      case kQuat: {                                // dt·∂ȯ/∂o, dt·∂ȯ/∂ω
        const T* w = x + L::i_w;
        for (int j = 0; j < 4; ++j)
          row[3 + j] = scale * srbd::quat_rate_jac_o(a, j, w);
        for (int j = 0; j < 3; ++j)
          row[L::i_w + j] = scale * srbd::quat_rate_jac_w(a, j, x + 3);
        break;
      }
      case kQerr: {
        const T g = p[srbd::kP_mt] * p[srbd::kP_otg];
        for (int j = 0; j < 4; ++j)
          row[3 + j] = g * quat_err_jac(a, j, p + srbd::kP_oref);
        break;
      }
      case kRdd:
        for (int q = 0; q < S::nc; ++q) row[6 * q + 3 + a] = rdd;
        break;
      default:
        break;
    }
  }
}

// ∂b/∂(x, u)[col] for every column but the four o columns (col 3..6 are
// formed apart): the right-hand side of Iw ω̇ = b differentiated along
// column col of (x, u); zero where b does not depend on it.
template <class S, typename T>
__device__ void rhs_column(int col, const T* x, const T* u,
                           const srbd::Geometry<T>& g, T* m) {
  using L = srbd::Layout<S>;
  const T* w = x + L::i_w;
  m[0] = m[1] = m[2] = T(0);
  if (col < 3) {                                   // r
    T f[3] = {T(0), T(0), T(0)};
    for (int q = 0; q < S::nc; ++q)
      for (int i = 0; i < 3; ++i) f[i] += u[6 * q + 3 + i];
    rigid::skew_col(f, col, m);
  } else if (col >= 7 && col < L::i_rdot) {        // cₖ
    const int q = (col - 7) / 3, j = (col - 7) % 3;
    rigid::skew_col(u + 6 * q + 3, j, m);
    m[0] = -m[0];
    m[1] = -m[1];
    m[2] = -m[2];
  } else if (col >= L::i_w && col < L::i_cdot) {   // ω
    const int j = col - L::i_w;
    rigid::skew_col(g.h, j, m);
    const T v0 = j == 0 ? g.Iw[0] : j == 1 ? g.Iw[1] : g.Iw[2];
    const T v1 = j == 0 ? g.Iw[3] : j == 1 ? g.Iw[4] : g.Iw[5];
    const T v2 = j == 0 ? g.Iw[6] : j == 1 ? g.Iw[7] : g.Iw[8];
    m[0] -= w[1] * v2 - w[2] * v1;
    m[1] -= w[2] * v0 - w[0] * v2;
    m[2] -= w[0] * v1 - w[1] * v0;
  } else if (col >= S::nx && (col - S::nx) % 6 >= 3) {   // fₖ
    const int q = (col - S::nx) / 6, j = (col - S::nx) % 6 - 3;
    const T* c = x + L::i_c + 3 * q;
    const T cr[3] = {c[0] - x[0], c[1] - x[1], c[2] - x[2]};
    rigid::skew_col(cr, j, m);
  }
}

// ∂ω̇/∂(x, u) at the point (x, u) into W (column col at W[3·col], 3 rows),
// from its geometry g and rates rig: the four o columns on lanes 0..11 (a
// column on three lanes, a row of ∂Iwⱼ each, traded by shuffles), the
// others a column a lane. Every lane must call it.
template <class S, typename T>
__device__ void wdot_columns(const T* x, const T* u, const srbd::Geometry<T>& g,
                             const srbd::Rigid<T>& rig,
                             const srbd::Consts<T>& k, int lane, T* W) {
  using L = srbd::Layout<S>;
  constexpr int nx = S::nx, nu = S::nu;
  {   // the o columns: column 3 + j on lanes 3j .. 3j+2, row a of ∂Iwⱼ each
    const int j = lane / 3 < 4 ? lane / 3 : 3, a = lane % 3;
    const int base = 3 * (lane / 3);
    T D[9];
    rigid::drot(j, x + 3, D);
    const T Da0 = a == 0 ? D[0] : a == 1 ? D[3] : D[6];
    const T Da1 = a == 0 ? D[1] : a == 1 ? D[4] : D[7];
    const T Da2 = a == 0 ? D[2] : a == 1 ? D[5] : D[8];
    const T RIa0 = a == 0 ? g.RI[0] : a == 1 ? g.RI[3] : g.RI[6];
    const T RIa1 = a == 0 ? g.RI[1] : a == 1 ? g.RI[4] : g.RI[7];
    const T RIa2 = a == 0 ? g.RI[2] : a == 1 ? g.RI[5] : g.RI[8];
    T P[3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      T s = T(0);
      s += Da0 * k.I[l];
      s += Da1 * k.I[3 + l];
      s += Da2 * k.I[6 + l];
      P[l] = s;
    }
    T dI[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T s1 = T(0), s2 = T(0);
      s1 += P[0] * g.R[c * 3];
      s2 += RIa0 * D[c * 3];
      s1 += P[1] * g.R[c * 3 + 1];
      s2 += RIa1 * D[c * 3 + 1];
      s1 += P[2] * g.R[c * 3 + 2];
      s2 += RIa2 * D[c * 3 + 2];
      dI[c] = s1 + s2;
    }
    const T* wv = x + L::i_w;
    const T v1 = dI[0] * rig.wd[0] + dI[1] * rig.wd[1] + dI[2] * rig.wd[2];
    const T v2 = dI[0] * wv[0] + dI[1] * wv[1] + dI[2] * wv[2];
    const T q0 = __shfl_sync(0xffffffffu, v2, base);
    const T q1 = __shfl_sync(0xffffffffu, v2, base + 1);
    const T q2 = __shfl_sync(0xffffffffu, v2, base + 2);
    const T cr = a == 0 ? wv[1] * q2 - wv[2] * q1
                 : a == 1 ? wv[2] * q0 - wv[0] * q2
                          : wv[0] * q1 - wv[1] * q0;
    const T m = -v1 - cr;
    const T m0 = __shfl_sync(0xffffffffu, m, base);
    const T m1 = __shfl_sync(0xffffffffu, m, base + 1);
    const T m2 = __shfl_sync(0xffffffffu, m, base + 2);
    const T c0 = a == 0 ? g.C[0] : a == 1 ? g.C[3] : g.C[6];
    const T c1 = a == 0 ? g.C[1] : a == 1 ? g.C[4] : g.C[7];
    const T c2 = a == 0 ? g.C[2] : a == 1 ? g.C[5] : g.C[8];
    if (lane < 12) W[(3 + j) * 3 + a] = (c0 * m0 + c1 * m1 + c2 * m2) / g.det;
  }
  for (int col = lane; col < nx + nu; col += 32) {
    if (col >= 3 && col < 7) continue;
    T m[3];
    rhs_column<S>(col, x, u, g, m);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      W[col * 3 + i] =
          (g.C[i * 3] * m[0] + g.C[i * 3 + 1] * m[1] + g.C[i * 3 + 2] * m[2]) / g.det;
  }
}

// The o and ω of a stage point, for the quaternion-rate rows of ∂ẋ/∂x there.
template <class S, typename T>
__device__ __forceinline__ void keep_ow(const T* x, int lane, T* ow) {
  if (lane < 4) ow[lane] = x[3 + lane];
  else if (lane < 7) ow[lane] = x[srbd::Layout<S>::i_w + lane - 4];
}

// The scalars of one stage member-node, by its warp: ẋ (into xd), ∂ω̇ (into
// W; under RK2/RK4 also at each later stage point, with its o and ω), and
// its ρ and d = step(x, u) − X[n+1] into the block's staged outputs
// (slot w).
template <class S, typename T>
__device__ void stage_scalars(T* sw, T* out, int w, const srbd::Consts<T>& k,
                              int lane) {
  using C = K4<S>;
  constexpr int nx = C::nx, nr = C::nr;
  const T* x = sw + C::wX;
  const T* u = sw + C::wU;
  T* xd = sw + C::wXd;
  const T* p = sw + C::wP;
  T* W = sw + C::wW;
  const srbd::Geometry<T> g = srbd::geometry<S>(x, k);
  const srbd::Rigid<T> rig = srbd::rigid_rates<S>(x, u, k, g, lane);
  for (int j = lane; j < nx; j += 32) xd[j] = srbd::xdot_row<S>(j, x, u, rig);
  wdot_columns<S>(x, u, g, rig, k, lane, W);
  T* ow = sw + C::wOw;
  if constexpr (C::stages > 1) keep_ow<S>(x, lane, ow);
  T xp[2];                                          // step(x, u), rows lane, lane+32
  srbd::step_rows<S>(x, u, rig, k, lane, sw + C::wXs, xp,
                     [&](int s, const T* xs, const srbd::Geometry<T>& gs,
                         const srbd::Rigid<T>& rs) {
                       wdot_columns<S>(xs, u, gs, rs, k, lane, W + s * C::nW);
                       keep_ow<S>(xs, lane, ow + 7 * s);
                     });
  __syncwarp();                                     // xd for the rows
  T* rho = out + C::oRho + w * nr;
#pragma unroll
  for (int r = lane; r < nr; r += 32)
    rho[r] = srbd::stage_rho_row<S>(r, x, u, xd, p, k);
  const T* xnext = sw + C::wXn;
  T* dd = out + C::oD + w * nx;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = lane + 32 * c;
    if (j < nx) dd[j] = xp[c] - xnext[j];
  }
}

// Column `col` of (x | u) of the composed RK step Jacobian [A − I | B] on
// the live rows (Layout::n_live), into acc, unscaled: the chain rule over
// the stages, dk_s = F_x(x_s)·(e_col + c_s·dt·dk_{s−1}) + F_u(x_s)·e_col, at
// each stage point from its ∂ω̇ columns W_s and its o and ω, and
// acc = dk₂ (RK2) or dk₁ + 2dk₂ + 2dk₃ + dk₄ (RK4), which the caller
// scales by dt or dt/6. The rows of dk outside the live ones are those of
// F_u: 1/m at the force columns on the ṙ rows, 1 at the c̈ columns on the
// ċ rows, whatever the point.
template <class S, typename T>
__device__ void rk_column(int col, const T* W, const T* ow,
                          const srbd::Consts<T>& k, T* acc) {
  using L = srbd::Layout<S>;
  using St = typename S::Step;
  constexpr int nx = S::nx, nl = L::n_live, nW = K4<S>::nW;
  const bool ucol = col >= nx;
  const int ju = col - nx;
  const int lcol = ucol ? -1 : live_index<S>(col);
  const T inv_m = T(1) / k.m_scaled;
  T dk[nl];
#pragma unroll
  for (int li = 0; li < nl; ++li) dk[li] = T(0);
#pragma unroll 1
  for (int s = 0; s < St::stages; ++s) {
    const T cdt = s == 0 ? T(0) : srbd::full_stage<St>(s) ? k.dt : T(0.5) * k.dt;
    // v = e_col + c_s·dt·dk_{s−1} on the live rows (in place)
#pragma unroll
    for (int li = 0; li < nl; ++li)
      dk[li] = (li == lcol ? T(1) : T(0)) + cdt * dk[li];
    const T* Ws = W + s * nW;
    const T* o = ow + 7 * s;
    const T* w = o + 4;
    T no[4], nw[3];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      T v = T(0);
#pragma unroll
      for (int b = 0; b < 4; ++b) v += srbd::quat_rate_jac_o(a, b, w) * dk[3 + b];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        v += srbd::quat_rate_jac_w(a, i, o) * dk[L::i_rdot + i];
      no[a] = v;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T v = ucol ? Ws[col * 3 + i] : T(0);
#pragma unroll
      for (int li = 0; li < nl; ++li) {
        const int c = li < L::i_rdot ? li : L::i_w + (li - L::i_rdot);
        v += Ws[c * 3 + i] * dk[li];
      }
      nw[i] = v;
    }
    // ṙ and ċ rows of v: e_col there, and c_s·dt times F_u's rows
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dk[i] = (col == L::i_rdot + i ? T(1) : T(0)) +
              ((ucol && ju % 6 == 3 + i) ? cdt * inv_m : T(0));
#pragma unroll
    for (int q = 0; q < 3 * S::nc; ++q)
      dk[7 + q] = (col == L::i_cdot + q ? T(1) : T(0)) +
                  ((ucol && ju == 6 * (q / 3) + q % 3) ? cdt : T(0));
#pragma unroll
    for (int a = 0; a < 4; ++a) dk[3 + a] = no[a];
#pragma unroll
    for (int i = 0; i < 3; ++i) dk[L::i_rdot + i] = nw[i];
    if constexpr (St::stages == 4) {
#pragma unroll
      for (int li = 0; li < nl; ++li)
        acc[li] = s == 0 ? dk[li]
                  : s == 3 ? acc[li] + dk[li] : acc[li] + T(2) * dk[li];
    }
  }
  if constexpr (St::stages != 4) {
#pragma unroll
    for (int li = 0; li < nl; ++li) acc[li] = dk[li];
  }
}

// Jacobian block `blk` (0 Sx, 1 Bs, 2 Jxp, 3 Jup) of one member-node into
// `dst` (zero-filled): its sparse rows one lane a row, its dense ∂ω̇ rows
// one row at a time with the lanes over the columns.
template <class S, typename T>
__device__ void emit_block(int blk, const T* sw, const int* info,
                           const int* dslot, const int* lslot,
                           const srbd::Consts<T>& k, int lane, T* dst) {
  using C = K4<S>;
  const T* x = sw + C::wX;
  const T* p = sw + C::wP;
  const T* W = sw + C::wW;
  const T inv_m = T(1) / k.m_scaled;
  const int first = blk == 0 ? 0
                    : blk == 1 ? S::n_rx
                    : blk == 2 ? S::n_rx + S::n_ru : S::n_rx + S::n_ru + S::n_gx;
  const int rows = blk == 0 ? S::n_rx : blk == 1 ? S::n_ru
                   : blk == 2 ? S::n_gx : S::n_gu;
  const bool xcols = blk == 0 || blk == 2;        // Sx, Jxp: nx columns
  const int width = xcols ? C::nx : C::nu;
  const T scale = blk < 2 ? k.dt : T(1);
  const T rdd = blk == 1 ? k.dt * inv_m : k.w_qddot * inv_m;
  emit_sparse<S>(info + 2 * first, rows, width, scale, rdd, x, p, k, lane, dst);
  const T wscale = blk < 2 ? k.dt : k.w_qddot;    // dt·∂ω̇ or w_qddot·∂ω̇
  for (int s = 0; s < 3; ++s) {
    const int i = dslot[3 * blk + s];
    if (i < 0) continue;
    for (int c = lane; c < width; c += 32)
      dst[i * width + c] = wscale * W[(xcols ? c : C::nx + c) * 3 + s];
  }
  if constexpr (C::stages > 1) {                  // the composed RK rows
    using L = srbd::Layout<S>;
    if (blk < 2) {
      const int* ls = lslot + blk * L::n_live;
      const T rk = C::stages == 4 ? k.dt / T(6) : k.dt;
      for (int c = lane; c < width; c += 32) {
        T acc[L::n_live];
        rk_column<S>(blk == 1 ? C::nx + c : c, W, sw + C::wOw, k, acc);
#pragma unroll
        for (int li = 0; li < L::n_live; ++li) {
          const int i = ls[li];
          if (i >= 0) dst[i * width + c] = rk * acc[li];
        }
      }
    }
  }
}

// Row g < 15, column col of ∂rt/∂x (the tracking rows with mask 1).
template <class S, typename T>
__device__ T terminal_jac(int g, int col, const T* p, const srbd::Consts<T>& k) {
  using L = srbd::Layout<S>;
  if (g == 0) return col == 2 ? k.w_r : T(0);
  if (g < 5)
    return (col >= 3 && col < 7)
               ? (T(1) * p[srbd::kP_otg]) * quat_err_jac(g - 1, col - 3, p + srbd::kP_oref)
               : T(0);
  if (g < 8) return col == L::i_rdot + g - 5 ? k.w_rdot : T(0);
  if (g < 11) return col == L::i_w + g - 8 ? k.w_w : T(0);
  int a, b;
  srbd::rel_cols<S>(g, &a, &b);
  T v = T(0);
  if (col == L::i_c + a) v -= k.w_rel;
  if (col == L::i_c + b) v += k.w_rel;
  return v;
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

// The block fills `count` staged values with zeros, 16 bytes a thread at
// a time (count a multiple of 16 bytes).
template <typename T>
__device__ void zero_fill(T* dst, int count) {
  using V = typename Vec<T>::type;
  constexpr int per = sizeof(V) / sizeof(T);
  const V z{};
  V* o = reinterpret_cast<V*>(dst);
  for (int i = threadIdx.x; i < count / per; i += blockDim.x) o[i] = z;
}

// The block streams `count` staged values from shared memory to `dst`
// (16-byte aligned), 16 bytes a thread at a time.
template <typename T>
__device__ void stream_out(const T* src, T* __restrict__ dst, int count) {
  using V = typename Vec<T>::type;
  constexpr int per = sizeof(V) / sizeof(T);
  const int nvec = count / per;
  const V* s = reinterpret_cast<const V*>(src);
  V* o = reinterpret_cast<V*>(dst);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) o[i] = s[i];
  for (int i = nvec * per + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = src[i];
}

template <class S, typename T>
__global__ void __launch_bounds__(32 * kWarps)
srbd_linearize_kernel(const T* __restrict__ X, const T* __restrict__ U,
                      srbd::Params<T> P, const int* __restrict__ table,
                      int B, int ns, int n_stage, srbd::Consts<T> k,
                      T* __restrict__ Sx, T* __restrict__ Bs,
                      T* __restrict__ Jxp, T* __restrict__ Jup,
                      T* __restrict__ rho, T* __restrict__ dfx,
                      T* __restrict__ rt, T* __restrict__ Jt) {
  using C = K4<S>;
  constexpr int nx = C::nx, nu = C::nu, nr = C::nr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* out = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* sw = out + C::oEnd + warp * C::wSize;
  T* x = sw + C::wX;
  T* p = sw + C::wP;

  if (static_cast<int>(blockIdx.x) >= n_stage) {   // the terminal pairs
    const long long bm =
        static_cast<long long>(blockIdx.x - n_stage) * kWarps + warp;
    if (bm >= B) return;                           // whole warp leaves
    const size_t b = bm;
    const size_t row = b * (ns + 1) + ns;
    for (int j = lane; j < nx; j += 32) x[j] = X[row * nx + j];
    srbd::load_params<S>(P, row, lane, p);
    __syncwarp();
    if (lane < S::nt) rt[b * S::nt + lane] = srbd::tracking_row<S>(lane, x, p, T(1), k);
    T* Jo = Jt + b * S::nt * nx;
    for (int g = 0; g < S::nt; ++g)
      for (int c = lane; c < nx; c += 32) Jo[g * nx + c] = terminal_jac<S>(g, c, p, k);
    return;
  }

  int* info = reinterpret_cast<int*>(out + C::oEnd + kWarps * C::wSize);
  int* dslot = info + 2 * C::kRows;
  int* lslot = dslot + 12;
  const long long q0 = static_cast<long long>(blockIdx.x) * kWarps;
  const long long total = static_cast<long long>(B) * ns;
  const int n_valid = total - q0 < kWarps ? static_cast<int>(total - q0) : kWarps;
  const bool live = warp < n_valid;                 // warp-uniform
  if (threadIdx.x < 12) dslot[threadIdx.x] = -1;
  if (static_cast<int>(threadIdx.x) < C::kLiveSlots) lslot[threadIdx.x] = -1;
  zero_fill(out, kWarps * C::kSx);
  if (live) {
    const long long q = q0 + warp;
    const size_t b = q / ns;
    const int n = static_cast<int>(q - static_cast<long long>(b) * ns);
    const size_t row = b * (ns + 1) + n;
    for (int j = lane; j < nx; j += 32) {
      x[j] = X[row * nx + j];
      sw[C::wXn + j] = X[(row + 1) * nx + j];
    }
    for (int j = lane; j < nu; j += 32)             // nu = 48 takes two rounds
      sw[C::wU + j] = U[(b * ns + n) * nu + j];
    srbd::load_params<S>(P, row, lane, p);
  }
  __syncthreads();                                  // dslot cleared, loads
  for (int i = threadIdx.x; i < C::kRows; i += blockDim.x) {
    const int blk = i < S::n_rx ? 0
                    : i < S::n_rx + S::n_ru ? 1
                    : i < S::n_rx + S::n_ru + S::n_gx ? 2 : 3;
    const int first = blk == 0 ? 0
                      : blk == 1 ? S::n_rx
                      : blk == 2 ? S::n_rx + S::n_ru
                                 : S::n_rx + S::n_ru + S::n_gx;
    const int2 kd = resolve<S>(blk, table[i]);
    info[2 * i] = kd.x;
    info[2 * i + 1] = kd.y;
    if ((kd.x & 0xff) == kDense) dslot[3 * blk + (kd.y & 0xffff)] = i - first;
    if ((kd.x & 0xff) == kComposed)
      lslot[blk * srbd::Layout<S>::n_live + (kd.y & 0xffff)] = i - first;
  }
  if (live) stage_scalars<S>(sw, out, warp, k, lane);
  __syncthreads();                                  // kinds, the scalars
  T* const dsts[4] = {Sx, Bs, Jxp, Jup};
  const int per[4] = {C::kSx, C::kBs, C::kJxp, C::kJup};
#pragma unroll
  for (int blk = 0; blk < 4; ++blk) {
    if (blk > 0) {
      zero_fill(out, kWarps * per[blk]);
      __syncthreads();
    }
    if (live)
      emit_block<S>(blk, sw, info, dslot, lslot, k, lane, out + warp * per[blk]);
    __syncthreads();
    stream_out(out, dsts[blk] + q0 * per[blk], n_valid * per[blk]);
    __syncthreads();                                // before the next fill
  }
  stream_out(out + C::oRho, rho + q0 * nr, n_valid * nr);
  stream_out(out + C::oD, dfx + q0 * nx, n_valid * nx);
}

// Let the kernel at (S, T) take its dynamic shared memory (above 48 KB
// only after the attribute is raised).
template <class S, typename T>
cudaError_t allow_smem() {
  const size_t bytes = smem_bytes<S, T>();
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(srbd_linearize_kernel<S, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <class S, typename T>
int launch(const void* X, const void* U, const void* const* params,
           const void* table, int B, int ns, int n_rx, int n_ru, int n_gx,
           int n_gu, const double* scalars, void* Sx, void* Bs, void* Jxp,
           void* Jup, void* rho, void* d, void* rt, void* Jt, void* stream) {
  if (n_rx != S::n_rx || n_ru != S::n_ru || n_gx != S::n_gx || n_gu != S::n_gu)
    return kUnknownShape;
  if (B == 0) return 0;
  const long long stage_nodes = static_cast<long long>(B) * ns;
  const long long n_stage = (stage_nodes + kWarps - 1) / kWarps;
  const long long n_term = (B + kWarps - 1) / kWarps;
  const cudaError_t e = allow_smem<S, T>();
  if (e != cudaSuccess) return static_cast<int>(e);
  srbd_linearize_kernel<S, T><<<static_cast<unsigned>(n_stage + n_term),
                                32 * kWarps, smem_bytes<S, T>(),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      srbd::make_params<T>(params), static_cast<const int*>(table), B, ns,
      static_cast<int>(n_stage), srbd::make_consts<T>(scalars),
      static_cast<T*>(Sx), static_cast<T*>(Bs), static_cast<T*>(Jxp),
      static_cast<T*>(Jup), static_cast<T*>(rho), static_cast<T*>(d),
      static_cast<T*>(rt), static_cast<T*>(Jt));
  return static_cast<int>(cudaGetLastError());
}

// K4's occupancy at (S, T), into out[0..3]: blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), shared memory bytes a
// block, registers a thread and local (spilled) bytes a thread
// (cudaFuncGetAttributes).
template <class S, typename T>
int occupancy(int* out) {
  cudaError_t e = allow_smem<S, T>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, srbd_linearize_kernel<S, T>, 32 * kWarps, smem_bytes<S, T>());
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, srbd_linearize_kernel<S, T>);
  out[1] = static_cast<int>(smem_bytes<S, T>());
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace

// The contact topology (nc, cm, n_legs) and the step (srbd::Euler::id,
// Rk2::id, Rk4::id) pick the compiled instance; the row counts must be that
// instance's, or the call returns kUnknownShape and launches nothing.
#define LINEARIZE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, const void* table, int B,    \
                      int ns, int nc, int cm, int n_legs, int step, int n_rx, \
                      int n_ru, int n_gx, int n_gu, const double* scalars,    \
                      void* Sx, void* Bs, void* Jxp, void* Jup, void* rho,    \
                      void* d, void* rt, void* Jt, void* stream) {            \
    return srbd::with_topology(nc, cm, n_legs, step, [&](auto s) {            \
      return launch<decltype(s), T>(X, U, params, table, B, ns, n_rx, n_ru,   \
                                    n_gx, n_gu, scalars, Sx, Bs, Jxp, Jup,    \
                                    rho, d, rt, Jt, stream);                  \
    });                                                                       \
  }

LINEARIZE_ENTRY(srbd_linearize_f32, float)
LINEARIZE_ENTRY(srbd_linearize_f64, double)

// K4's occupancy for the shape at index `shape` (kernels/linearize.py::
// KERNEL_SHAPES order) and float32 (f64 = 0) or float64 tensors: out[0]
// blocks an SM, out[1] shared memory bytes a block, out[2] registers a
// thread, out[3] local bytes a thread.
extern "C" int srbd_linearize_occupancy(int shape, int f64, int* out) {
  return srbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? occupancy<S, double>(out) : occupancy<S, float>(out);
  });
}
