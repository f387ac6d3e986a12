// K1 — the blocksparse backward Riccati sweep of the batched MS-DDP solver,
// with the block-Schur SPD inverse of Quu (K2) as a device routine inside.
//
// Replaces: the JAX package's Riccati sweep. Its one Pallas kernel,
// `backward_sweep_pallas` (srbd_horizon_tpu/solvers/pallas_backward.py,
// retired in b514cfb), kept the value function in VMEM across the node
// loop; its live successor is the XLA-fused blocksparse branch of
// `MSDDP._backward_lanemajor` (srbd_horizon_tpu/solvers/msddp.py:431-777,
// `node_ops` :563-598, `chain` :501-518). This kernel computes exactly what
// that branch computes, per member; its plain twin is
// `kernels/riccati.py::riccati_backward_plain`.
//
// Where the dynamics consume only some inputs (`OCP.dynamics_u_cols`: the
// isrbd forces are dead B columns), Bs carries the n_uc live columns only
// and the three B-chain terms BsᵀVx_d[ru], BsᵀV[ru,ru]Bs, BsᵀVA[ru] are
// added at the live positions of the dense Qu, Quu, Qux, exactly as
// msddp.py:584-597 scatters them; the residual Grams cover every input.
// With every column live (SRBD) the arithmetic is what it was.
//
// What bounds it on an H100: for the SRBD fleet (nx=37, nu=24, 22 live
// rows of A−I, 18 of B, 34/42 residual rows touching x/u) one member-node
// reads ~3.6k values (14.5 KB in f32) and writes 912 (3.6 KB), and does
// ~0.48 MFLOP. At B=512, ns=20 that is ~185 MB and ~4.9 GFLOP per sweep:
// 0.055 ms at 3.35 TB/s against 0.073 ms at 67 TFLOP/s (f32, no tensor
// cores), so the floor is the arithmetic, ~0.07 ms; with the float64
// arithmetic below (34 TFLOP/s) this kernel's own floor is ~0.15 ms.
// For the isrbd AL inner problem (nx=37, nu=30, 19/37 live rows, 18 live
// columns, 60/103 residual rows, a 101-row terminal stack) a member-node
// reads ~6.7k values and does ~1.0 MFLOP; the block then holds ~137 KB of
// float64 shared memory, so one block runs per SM.
//
// Design: one thread block per member, the node loop inside the block.
// The value function (Vxx nx×nx, Vx) stays in shared memory across all
// nodes, as the retired kernel kept it in VMEM; only the node's sliced
// Jacobians stream in, and only the gains stream out. Every contraction
// is a block-cooperative loop over output elements with the sum in a
// register, over the declared row sets only (passed as an int32 table,
// not hard-coded, so another problem's row runs work unchanged). The
// Quu⁻¹ recursion mirrors `lm_spd_inverse` (split at n/2, closed forms at
// n ≤ 3, symmetrize each level) so that f64 results agree with the plain
// version to rounding. Simple first: no tensor cores, no TMA, no
// overlap of the next node's loads with this node's arithmetic.
//
// Precision: the arithmetic on chip is float64 for float32 and float64
// tensors alike; a float32 call reads and writes float32 in device memory
// only. The 1e6 constraint weight makes Quu ill-conditioned: carried in
// float32, the recursion loses ~1e-2 relative in the gains (the plain
// float32 twin does), while float32 inputs carried in float64 lose ~1e-7.
// Shared memory is then ~84 KB per block for either type. So for float32
// tensors this kernel and the float32 plain twin (the CPU path, and the
// JAX float32 sweep) differ by ~1e-2 in the gains: the kernel is the
// closer of them to the float64 sweep. A faster version has to keep the
// float64 arithmetic: on this card its tensor-core route is FP64 DMMA
// (mma.sync m8n8k4 f64), not the float32/TF32 tensor cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemExceeded = -1;   // kernels/riccati.py::SMEM_EXCEEDED

// ---- closed-form inverses (one thread) ----

template <typename T>
__device__ void inv_closed(int n, const T* A, int lda, T* out, int ldo) {
  if (n == 1) {
    out[0] = T(1) / A[0];
  } else if (n == 2) {
    const T a = A[0], b = A[1], c = A[lda], d = A[lda + 1];
    const T det = a * d - b * c;
    out[0] = d / det;
    out[1] = -b / det;
    out[ldo] = -c / det;
    out[ldo + 1] = a / det;
  } else {  // n == 3
    const T a00 = A[0], a01 = A[1], a02 = A[2];
    const T a10 = A[lda], a11 = A[lda + 1], a12 = A[lda + 2];
    const T a20 = A[2 * lda], a21 = A[2 * lda + 1], a22 = A[2 * lda + 2];
    const T c00 = a11 * a22 - a12 * a21;
    const T c01 = a02 * a21 - a01 * a22;
    const T c02 = a01 * a12 - a02 * a11;
    const T c10 = a12 * a20 - a10 * a22;
    const T c11 = a00 * a22 - a02 * a20;
    const T c12 = a02 * a10 - a00 * a12;
    const T c20 = a10 * a21 - a11 * a20;
    const T c21 = a01 * a20 - a00 * a21;
    const T c22 = a00 * a11 - a01 * a10;
    const T det = a00 * c00 + a01 * c10 + a02 * c20;
    out[0] = c00 / det;
    out[1] = c01 / det;
    out[2] = c02 / det;
    out[ldo] = c10 / det;
    out[ldo + 1] = c11 / det;
    out[ldo + 2] = c12 / det;
    out[2 * ldo] = c20 / det;
    out[2 * ldo + 1] = c21 / det;
    out[2 * ldo + 2] = c22 / det;
  }
}

// Shared-memory workspace the block-Schur inverse below needs for n×n
// (computed on the host only).
inline int inv_work(int n) {
  if (n <= 3) return 0;
  const int k = n / 2, m = n - k;
  const int a = inv_work(k), b = inv_work(m);
  return k * m + m * m + m * k + (a > b ? a : b);
}

// One pending level of the block-Schur recursion below.
template <typename T>
struct InvFrame {
  const T* A;
  T* out;
  T* work;
  int n, lda, ldo, stage;
};

constexpr int kMaxInvDepth = 8;   // n ≤ 3·2⁷ — far beyond any nu here

// out = A⁻¹ for SPD A (n×n, leading dims lda/ldo), all block threads
// together: the recursive block-Schur elimination of lm_spd_inverse,
//   iA11 = A11⁻¹,  S = A22 − A21 iA11 A12,  iS = S⁻¹,
//   B12 = −iA11 A12 iS,  B11 = iA11 − B12 A21 iA11,  B21 = B12ᵀ,
//   out = ½(B + Bᵀ),
// walked with an explicit stack (a device-side recursion would need a
// run-time stack that ptxas cannot size). Every thread keeps the same
// stack and takes the same path, so the barriers are uniform.
template <typename T>
__device__ void spd_inverse(int n, const T* A, int lda, T* out, int ldo,
                            T* work) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  InvFrame<T> st[kMaxInvDepth];
  int top = 0;
  st[0] = InvFrame<T>{A, out, work, n, lda, ldo, 0};
  while (top >= 0) {
    InvFrame<T>& f = st[top];
    if (f.n <= 3) {
      if (tid == 0) inv_closed(f.n, f.A, f.lda, f.out, f.ldo);
      __syncthreads();
      --top;
      continue;
    }
    const int k = f.n / 2, m = f.n - k;
    const int lda_ = f.lda, ldo_ = f.ldo;
    const T* A12 = f.A + k;
    const T* A21 = f.A + k * lda_;
    const T* A22 = f.A + k * lda_ + k;
    T* T1 = f.work;         // iA11 A12       k×m
    T* S = T1 + k * m;      // Schur complement m×m
    T* T2 = S + m * m;      // A21 iA11       m×k
    T* next = T2 + m * k;
    T* O11 = f.out;
    T* O12 = f.out + k;
    T* O21 = f.out + k * ldo_;
    T* O22 = f.out + k * ldo_ + k;
    if (f.stage == 0) {                 // iA11 -> O11
      f.stage = 1;
      st[++top] = InvFrame<T>{f.A, O11, next, k, lda_, ldo_, 0};
      continue;
    }
    if (f.stage == 1) {                 // T1, T2, S; then iS -> O22
      for (int e = tid; e < k * m; e += nthr) {
        const int i = e / m, j = e % m;
        T s = T(0);
        for (int l = 0; l < k; ++l) s += O11[i * ldo_ + l] * A12[l * lda_ + j];
        T1[e] = s;
      }
      for (int e = tid; e < m * k; e += nthr) {
        const int i = e / k, j = e % k;
        T s = T(0);
        for (int l = 0; l < k; ++l) s += A21[i * lda_ + l] * O11[l * ldo_ + j];
        T2[e] = s;
      }
      __syncthreads();
      for (int e = tid; e < m * m; e += nthr) {
        const int i = e / m, j = e % m;
        T s = T(0);
        for (int l = 0; l < k; ++l) s += A21[i * lda_ + l] * T1[l * m + j];
        S[e] = A22[i * lda_ + j] - s;
      }
      __syncthreads();
      f.stage = 2;
      st[++top] = InvFrame<T>{S, O22, next, m, m, ldo_, 0};
      continue;
    }
    for (int e = tid; e < k * m; e += nthr) {   // B12 = −T1 iS
      const int i = e / m, j = e % m;
      T s = T(0);
      for (int l = 0; l < m; ++l) s += T1[i * m + l] * O22[l * ldo_ + j];
      O12[i * ldo_ + j] = -s;
    }
    __syncthreads();
    for (int e = tid; e < k * k; e += nthr) {   // B11 = iA11 − B12 T2
      const int i = e / k, j = e % k;
      T s = T(0);
      for (int l = 0; l < m; ++l) s += O12[i * ldo_ + l] * T2[l * k + j];
      O11[i * ldo_ + j] = O11[i * ldo_ + j] - s;
    }
    for (int e = tid; e < m * k; e += nthr) {   // B21 = B12ᵀ
      const int i = e / k, j = e % k;
      O21[i * ldo_ + j] = O12[j * ldo_ + i];
    }
    __syncthreads();
    const int nn = f.n;
    for (int e = tid; e < nn * nn; e += nthr) {  // out = ½(out + outᵀ)
      const int i = e / nn, j = e % nn;
      if (i < j) {
        const T v = T(0.5) * (f.out[i * ldo_ + j] + f.out[j * ldo_ + i]);
        f.out[i * ldo_ + j] = v;
        f.out[j * ldo_ + i] = v;
      }
    }
    __syncthreads();
    --top;
  }
}

struct Dims {
  int B, ns, nx, nu, nr, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc;
};

// Shared-memory layout, in elements of T: the buffers, the int row table
// (rows slots of T), then the inverse's workspace, which runs to the end.
struct Layout {
  int Vxx, VA, Vx, Vxd, Qx, d, Sx, Bs, Jxp, Jup, rxp, rup, Quu, iQ, Qux, K,
      Qu, k, W, acc, rows, work;
  __host__ __device__ Layout(const Dims& g, int elem) {
    const int nxx = g.nx * g.nx;
    const int n_jx = g.n_gx > g.nt ? g.n_gx : g.nt;   // Jxp buffer holds Jt too
    int o = 0;
    Vxx = o; o += nxx;
    VA = o; o += nxx;
    Vx = o; o += g.nx;
    Vxd = o; o += g.nx;
    Qx = o; o += g.nx;
    d = o; o += g.nx;
    Sx = o; o += g.n_rx * g.nx;
    Bs = o; o += g.n_ru * g.n_uc;
    Jxp = o; o += n_jx * g.nx;
    Jup = o; o += g.n_gu * g.nu;
    rxp = o; o += n_jx;
    rup = o; o += g.n_gu;
    Quu = o; o += g.nu * g.nu;
    iQ = o; o += g.nu * g.nu;
    Qux = o; o += g.nu * g.nx;
    K = o; o += g.nu * g.nx;
    Qu = o; o += g.nu;
    k = o; o += g.nu;
    W = o; o += g.n_ru * g.n_uc;
    acc = o; o += 2;
    rows = o;
    // the row table (… | uc) and, after it, each input's position in uc
    const int n_rows =
        g.n_rx + g.n_ru + g.n_gx + g.n_gu + 2 * g.n_b + g.n_uc + g.nu;
    o += (n_rows * static_cast<int>(sizeof(int)) + elem - 1) / elem;
    work = o;
  }
};

inline size_t smem_bytes(const Dims& g, int elem) {
  const Layout L(g, elem);
  return static_cast<size_t>(L.work + inv_work(g.nu)) * elem;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
riccati_backward_kernel(const T* __restrict__ Sx, const T* __restrict__ Bs,
                        const T* __restrict__ Jxp, const T* __restrict__ Jup,
                        const T* __restrict__ rho, const T* __restrict__ d,
                        const T* __restrict__ Jt, const T* __restrict__ rt,
                        const int* __restrict__ rows, Dims g, double mu,
                        T* __restrict__ ks, T* __restrict__ Ks,
                        T* __restrict__ dV1, T* __restrict__ dV2) {
  using C = double;                 // on-chip arithmetic (see the note above)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const Layout L(g, static_cast<int>(sizeof(C)));
  const int nx = g.nx, nu = g.nu, ns = g.ns;
  const int n_rx = g.n_rx, n_ru = g.n_ru, n_gx = g.n_gx, n_gu = g.n_gu,
            n_b = g.n_b, n_uc = g.n_uc;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const size_t b = blockIdx.x;

  C* Vxx = sm + L.Vxx;
  C* VA = sm + L.VA;
  C* Vx = sm + L.Vx;
  C* Vxd = sm + L.Vxd;
  C* Qx = sm + L.Qx;
  C* dn = sm + L.d;
  C* Sxs = sm + L.Sx;
  C* Bss = sm + L.Bs;
  C* Jxs = sm + L.Jxp;
  C* Jus = sm + L.Jup;
  C* rxp = sm + L.rxp;
  C* rup = sm + L.rup;
  C* Quu = sm + L.Quu;
  C* iQ = sm + L.iQ;
  C* Qux = sm + L.Qux;
  C* Kn = sm + L.K;
  C* Qu = sm + L.Qu;
  C* kn = sm + L.k;
  C* W = sm + L.W;
  C* work = sm + L.work;
  C* acc = sm + L.acc;
  int* rx = reinterpret_cast<int*>(sm + L.rows);
  int* ru = rx + n_rx;
  int* gx = ru + n_ru;
  int* gu = gx + n_gx;
  int* bx = gu + n_gu;
  int* bu = bx + n_b;
  int* uc = bu + n_b;
  int* upos = uc + n_uc;            // position of input i in uc, or −1

  const int n_rows = n_rx + n_ru + n_gx + n_gu + 2 * n_b + n_uc;
  for (int e = tid; e < n_rows; e += nthr) rx[e] = rows[e];
  for (int i = tid; i < nu; i += nthr) upos[i] = -1;
  __syncthreads();
  for (int e = tid; e < n_uc; e += nthr) upos[uc[e]] = e;

  // terminal value function: Vxx = 2 JtᵀJt, Vx = 2 Jtᵀrt
  const int nt = g.nt;
  for (int e = tid; e < nt * nx; e += nthr) Jxs[e] = Jt[b * nt * nx + e];
  for (int e = tid; e < nt; e += nthr) rxp[e] = rt[b * nt + e];
  if (tid == 0) { acc[0] = C(0); acc[1] = C(0); }
  __syncthreads();
  for (int e = tid; e < nx * nx; e += nthr) {
    const int i = e / nx, j = e % nx;
    C s = C(0);
    for (int r = 0; r < nt; ++r) s += Jxs[r * nx + i] * Jxs[r * nx + j];
    Vxx[e] = C(2) * s;
  }
  for (int i = tid; i < nx; i += nthr) {
    C s = C(0);
    for (int r = 0; r < nt; ++r) s += Jxs[r * nx + i] * rxp[r];
    Vx[i] = C(2) * s;
  }
  __syncthreads();

  for (int n = ns - 1; n >= 0; --n) {
    const size_t bn = b * ns + n;
    // ---- stream this node's blocks in ----
    const T* Sx_g = Sx + bn * n_rx * nx;
    const T* Bs_g = Bs + bn * n_ru * n_uc;
    const T* Jx_g = Jxp + bn * n_gx * nx;
    const T* Ju_g = Jup + bn * n_gu * nu;
    const T* rho_g = rho + bn * g.nr;
    const T* d_g = d + bn * nx;
    for (int e = tid; e < n_rx * nx; e += nthr) Sxs[e] = Sx_g[e];
    for (int e = tid; e < n_ru * n_uc; e += nthr) Bss[e] = Bs_g[e];
    for (int e = tid; e < n_gx * nx; e += nthr) Jxs[e] = Jx_g[e];
    for (int e = tid; e < n_gu * nu; e += nthr) Jus[e] = Ju_g[e];
    for (int e = tid; e < n_gx; e += nthr) rxp[e] = rho_g[gx[e]];
    for (int e = tid; e < n_gu; e += nthr) rup[e] = rho_g[gu[e]];
    for (int e = tid; e < nx; e += nthr) dn[e] = d_g[e];
    __syncthreads();

    // ---- Vx_d = Vx + Vxx d;  VA = Vxx + Vxx[:,rx] Sx;  W = V[ru,ru] Bs ----
    for (int i = tid; i < nx; i += nthr) {
      C s = C(0);
      for (int j = 0; j < nx; ++j) s += Vxx[i * nx + j] * dn[j];
      Vxd[i] = Vx[i] + s;
    }
    for (int e = tid; e < nx * nx; e += nthr) {
      const int i = e / nx, j = e % nx;
      C s = C(0);
      for (int r = 0; r < n_rx; ++r) s += Vxx[i * nx + rx[r]] * Sxs[r * nx + j];
      VA[e] = Vxx[e] + s;
    }
    for (int e = tid; e < n_ru * n_uc; e += nthr) {
      const int a = e / n_uc, j = e % n_uc;
      C s = C(0);
      for (int c = 0; c < n_ru; ++c) s += Vxx[ru[a] * nx + ru[c]] * Bss[c * n_uc + j];
      W[e] = s;
    }
    __syncthreads();

    // ---- Q terms (Qxx overwrites Vxx, which is no longer read) ----
    for (int i = tid; i < nx; i += nthr) {
      C lx = C(0);
      for (int q = 0; q < n_gx; ++q) lx += Jxs[q * nx + i] * rxp[q];
      C s = C(0);
      for (int r = 0; r < n_rx; ++r) s += Sxs[r * nx + i] * Vxd[rx[r]];
      Qx[i] = C(2) * lx + Vxd[i] + s;
    }
    for (int j = tid; j < nu; j += nthr) {
      C lu = C(0);
      for (int q = 0; q < n_gu; ++q) lu += Jus[q * nu + j] * rup[q];
      C s = C(0);
      const int pj = upos[j];
      if (pj >= 0)
        for (int a = 0; a < n_ru; ++a) s += Bss[a * n_uc + pj] * Vxd[ru[a]];
      Qu[j] = C(2) * lu + s;
    }
    for (int e = tid; e < nu * nu; e += nthr) {
      const int i = e / nu, j = e % nu;
      C luu = C(0);
      for (int q = 0; q < n_gu; ++q) luu += Jus[q * nu + i] * Jus[q * nu + j];
      C s = C(0);
      const int pi = upos[i], pj = upos[j];
      if (pi >= 0 && pj >= 0)
        for (int a = 0; a < n_ru; ++a) s += Bss[a * n_uc + pi] * W[a * n_uc + pj];
      Quu[e] = C(2) * luu + s + (i == j ? mu : C(0));
    }
    for (int e = tid; e < nu * nx; e += nthr) {
      const int i = e / nx, j = e % nx;
      C lux = C(0);
      for (int q = 0; q < n_b; ++q) lux += Jus[bu[q] * nu + i] * Jxs[bx[q] * nx + j];
      C s = C(0);
      const int pi = upos[i];
      if (pi >= 0)
        for (int a = 0; a < n_ru; ++a) s += Bss[a * n_uc + pi] * VA[ru[a] * nx + j];
      Qux[e] = C(2) * lux + s;
    }
    for (int e = tid; e < nx * nx; e += nthr) {
      const int i = e / nx, j = e % nx;
      C lxx = C(0);
      for (int q = 0; q < n_gx; ++q) lxx += Jxs[q * nx + i] * Jxs[q * nx + j];
      C s = C(0);
      for (int r = 0; r < n_rx; ++r) s += Sxs[r * nx + i] * VA[rx[r] * nx + j];
      Vxx[e] = C(2) * lxx + VA[e] + s;
    }
    __syncthreads();

    // ---- gains: k = −Quu⁻¹Qu, K = −Quu⁻¹Qux ----
    spd_inverse(nu, Quu, nu, iQ, nu, work);
    T* ks_g = ks + bn * nu;
    T* Ks_g = Ks + bn * nu * nx;
    for (int i = tid; i < nu; i += nthr) {
      C s = C(0);
      for (int j = 0; j < nu; ++j) s += iQ[i * nu + j] * Qu[j];
      kn[i] = -s;
      ks_g[i] = static_cast<T>(-s);
    }
    for (int e = tid; e < nu * nx; e += nthr) {
      const int i = e / nx, j = e % nx;
      C s = C(0);
      for (int l = 0; l < nu; ++l) s += iQ[i * nu + l] * Qux[l * nx + j];
      Kn[e] = -s;
      Ks_g[e] = static_cast<T>(-s);
    }
    __syncthreads();

    // ---- Schur-form value update ----
    for (int i = tid; i < nx; i += nthr) {
      C s = C(0);
      for (int u = 0; u < nu; ++u) s += Qux[u * nx + i] * kn[u];
      Vx[i] = Qx[i] + s;
    }
    for (int e = tid; e < nx * nx; e += nthr) {
      const int i = e / nx, j = e % nx;
      C s = C(0);
      for (int u = 0; u < nu; ++u) s += Qux[u * nx + i] * Kn[u * nx + j];
      Vxx[e] = Vxx[e] + s;
    }
    if (tid == 0) {
      C kQu = C(0);
      for (int u = 0; u < nu; ++u) kQu += kn[u] * Qu[u];
      acc[0] = acc[0] + kQu;
      acc[1] = acc[1] - C(0.5) * kQu;
    }
    __syncthreads();
    for (int e = tid; e < nx * nx; e += nthr) {
      const int i = e / nx, j = e % nx;
      if (i < j) {
        const C v = C(0.5) * (Vxx[i * nx + j] + Vxx[j * nx + i]);
        Vxx[i * nx + j] = v;
        Vxx[j * nx + i] = v;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    dV1[b] = static_cast<T>(acc[0]);
    dV2[b] = static_cast<T>(acc[1]);
  }
}

template <typename T>
int launch(const void* Sx, const void* Bs, const void* Jxp, const void* Jup,
           const void* rho, const void* d, const void* Jt, const void* rt,
           const void* rows, const Dims& g, double mu, void* ks, void* Ks,
           void* dV1, void* dV2, void* stream) {
  if (g.B == 0) return 0;
  const size_t bytes = smem_bytes(g, static_cast<int>(sizeof(double)));
  // refuse, rather than let the launch fail, when a block's shared memory
  // exceeds what the card lets a block opt in to
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(limit)) return kSmemExceeded;
  err = cudaFuncSetAttribute(
      riccati_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  riccati_backward_kernel<T><<<g.B, kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Sx), static_cast<const T*>(Bs),
      static_cast<const T*>(Jxp), static_cast<const T*>(Jup),
      static_cast<const T*>(rho), static_cast<const T*>(d),
      static_cast<const T*>(Jt), static_cast<const T*>(rt),
      static_cast<const int*>(rows), g,
      static_cast<double>(static_cast<T>(mu)),   // μ as the plain twin rounds it
      static_cast<T*>(ks), static_cast<T*>(Ks), static_cast<T*>(dV1),
      static_cast<T*>(dV2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RICCATI_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* Sx, const void* Bs, const void* Jxp,        \
                      const void* Jup, const void* rho, const void* d,        \
                      const void* Jt, const void* rt, const void* rows,       \
                      int B, int ns, int nx, int nu, int nr, int nt,          \
                      int n_rx, int n_ru, int n_gx, int n_gu, int n_b,        \
                      int n_uc, double mu, void* ks, void* Ks, void* dV1,     \
                      void* dV2, void* stream) {                              \
    const Dims g{B, ns, nx, nu, nr, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc};  \
    return launch<T>(Sx, Bs, Jxp, Jup, rho, d, Jt, rt, rows, g, mu, ks, Ks,  \
                     dV1, dV2, stream);                                       \
  }

RICCATI_ENTRY(riccati_backward_f32, float)
RICCATI_ENTRY(riccati_backward_f64, double)

// Dynamic shared memory one block takes at these sizes, in bytes (float64
// on chip for either tensor type).
extern "C" long long riccati_backward_smem_bytes(int nx, int nu, int nt,
                                                 int n_rx, int n_ru, int n_gx,
                                                 int n_gu, int n_b, int n_uc) {
  const Dims g{1, 1, nx, nu, 0, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc};
  return static_cast<long long>(smem_bytes(g, static_cast<int>(sizeof(double))));
}
