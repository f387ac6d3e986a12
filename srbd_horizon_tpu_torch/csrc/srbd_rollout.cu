// K3 — the line-search rollout of the batched MS-DDP solver on the SRBD
// problem, every step size α of one call in one launch.
//
// Replaces: `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410),
// a `lax.scan` over the horizon that XLA fused on the TPU (the JAX package
// wrote no Pallas kernel for it), with the SRBD Euler step
// (srbd_horizon_tpu/models/srbd.py::srbd_xdot) fused in. Plain twin:
// `kernels/rollout.py::srbd_rollout_plain`. Per member and α, for
// n = 0 … ns−1:
//     uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
//     x̂ₙ₊₁ = x̂ₙ + dt·ẋ(x̂ₙ, uₙ) − (1 − α) dₙ
// where ẋ is the SRBD double integrator with fSRBD accelerations
// (R(o) I Rᵀ, the Cramer 3×3 solve, ȯ = ½ ω⊗o). The SRBD step reads no
// OCP parameter, only the scaled mass and inertia.
//
// What bounds it on an H100: one (member, α) reads the gains, the plan
// and the defects, ~1.0k values per node (4 KB in f32), and does ~2.3k
// FLOP per node. At B=512, ns=20 and one α that is ~41 MB (0.012 ms at
// 3.35 TB/s) against 24 MFLOP, so bytes bound it; in practice the
// 20-step dependent chain per member and the launch dominate at this size.
//
// Design: one warp per (member, α); consecutive warps of a block are the
// α's of one member, so the member's gains are read once from device
// memory and reused from L1/L2 by its other α's. The 24 rows of K(x̂−X)
// spread over the lanes; lane 0 evaluates the coupled rigid-body part of
// ẋ (a few hundred dependent flops) while the other lanes copy the
// integrator rows. The state lives in per-warp shared memory across the
// node loop. Simple first: no cross-node prefetch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;

// Rigid-body part of ẋ on one thread: writes ȯ (xd[3:7]), r̈
// (xd[7+3nc:10+3nc]) and ω̇ (xd[10+3nc:13+3nc]).
template <typename T>
__device__ void srbd_body_rates(const T* x, const T* u, int nc, T m_scaled,
                                const T* I, T* xd) {
  const T* r = x;
  const T* o = x + 3;
  const T* w = x + 10 + 3 * nc;
  // R = quat_to_rot(o), not normalized
  const T qx = o[0], qy = o[1], qz = o[2], qw = o[3];
  const T xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const T xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const T wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const T ww = qw * qw;
  T R[9];
  R[0] = ww + xx - yy - zz;
  R[1] = T(2) * (xy - wz);
  R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz);
  R[4] = ww - xx + yy - zz;
  R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy);
  R[7] = T(2) * (yz + wx);
  R[8] = ww - xx - yy + zz;
  // Iw = (R I) Rᵀ
  T RI[9], A[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
      for (int k = 0; k < 3; ++k) s += R[i * 3 + k] * I[k * 3 + j];
      RI[i * 3 + j] = s;
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
      for (int k = 0; k < 3; ++k) s += RI[i * 3 + k] * R[j * 3 + k];
      A[i * 3 + j] = s;
    }
  // forces, torques
  T f_tot[3] = {T(0), T(0), T(0)};
  T tau[3] = {T(0), T(0), T(0)};
  for (int q = 0; q < nc; ++q) {
    const T* f = u + 6 * q + 3;
    const T* c = x + 7 + 3 * q;
    const T p0 = c[0] - r[0], p1 = c[1] - r[1], p2 = c[2] - r[2];
    f_tot[0] += f[0];
    f_tot[1] += f[1];
    f_tot[2] += f[2];
    tau[0] += p1 * f[2] - p2 * f[1];
    tau[1] += p2 * f[0] - p0 * f[2];
    tau[2] += p0 * f[1] - p1 * f[0];
  }
  T* rdd = xd + 7 + 3 * nc;
  rdd[0] = f_tot[0] / m_scaled;
  rdd[1] = f_tot[1] / m_scaled;
  rdd[2] = f_tot[2] / m_scaled - T(9.81);
  // ω̇ = Iw⁻¹ (τ − ω × Iw ω), Cramer
  T Iw[3];
  for (int i = 0; i < 3; ++i)
    Iw[i] = A[i * 3 + 0] * w[0] + A[i * 3 + 1] * w[1] + A[i * 3 + 2] * w[2];
  const T b0 = tau[0] - (w[1] * Iw[2] - w[2] * Iw[1]);
  const T b1 = tau[1] - (w[2] * Iw[0] - w[0] * Iw[2]);
  const T b2 = tau[2] - (w[0] * Iw[1] - w[1] * Iw[0]);
  const T a00 = A[0], a01 = A[1], a02 = A[2];
  const T a10 = A[3], a11 = A[4], a12 = A[5];
  const T a20 = A[6], a21 = A[7], a22 = A[8];
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
  T* wd = xd + 10 + 3 * nc;
  wd[0] = (c00 * b0 + c01 * b1 + c02 * b2) / det;
  wd[1] = (c10 * b0 + c11 * b1 + c12 * b2) / det;
  wd[2] = (c20 * b0 + c21 * b1 + c22 * b2) / det;
  // ȯ = ½ (ω,0) ⊗ o
  const T v0 = T(0) * qx + qw * w[0] + (w[1] * qz - w[2] * qy);
  const T v1 = T(0) * qy + qw * w[1] + (w[2] * qx - w[0] * qz);
  const T v2 = T(0) * qz + qw * w[2] + (w[0] * qy - w[1] * qx);
  const T s = T(0) * qw - (w[0] * qx + w[1] * qy + w[2] * qz);
  xd[3] = T(0.5) * v0;
  xd[4] = T(0.5) * v1;
  xd[5] = T(0.5) * v2;
  xd[6] = T(0.5) * s;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
srbd_rollout_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                    const T* __restrict__ U, const T* __restrict__ ks,
                    const T* __restrict__ Ks, const T* __restrict__ d,
                    const T* __restrict__ alphas,
                    const T* __restrict__ inertia, int B, int ns, int nc,
                    int nA, T dt, T m_scaled, T* __restrict__ Xn,
                    T* __restrict__ Un) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = 13 + 6 * nc, nu = 6 * nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(B) * nA) return;   // whole warp leaves
  const size_t b = g / nA;
  const size_t a = g % nA;

  T* xh = reinterpret_cast<T*>(smem_raw) + warp * (3 * nx + nu + 9);
  T* dx = xh + nx;
  T* u = dx + nx;
  T* xd = u + nu;
  T* I = xd + nx;
  const T alpha = alphas[a];
  const T om = T(1) - alpha;
  for (int j = lane; j < nx; j += 32) xh[j] = x0[b * nx + j];
  for (int j = lane; j < 9; j += 32) I[j] = inertia[j];
  __syncwarp();

  const int i_rdot = 7 + 3 * nc, i_cdot = 13 + 3 * nc;
  for (int n = 0; n < ns; ++n) {
    const T* Xb = X + (b * (ns + 1) + n) * nx;
    T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * nx;
    for (int j = lane; j < nx; j += 32) {
      dx[j] = xh[j] - Xb[j];
      Xo[j] = xh[j];
    }
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
    __syncwarp();
    if (lane == 0) srbd_body_rates(xh, u, nc, m_scaled, I, xd);
    for (int j = lane; j < nx; j += 32) {   // integrator rows
      if (j < 3) {
        xd[j] = xh[i_rdot + j];                         // ṙ
      } else if (j >= 7 && j < 7 + 3 * nc) {
        xd[j] = xh[i_cdot + (j - 7)];                   // ċ
      } else if (j >= i_cdot) {
        const int e = j - i_cdot;                       // c̈ from u
        xd[j] = u[6 * (e / 3) + e % 3];
      }
    }
    __syncwarp();
    const T* db = d + bn * nx;
    for (int j = lane; j < nx; j += 32) xh[j] = (xh[j] + dt * xd[j]) - om * db[j];
    __syncwarp();
  }
  T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * nx;
  for (int j = lane; j < nx; j += 32) Xo[j] = xh[j];
}

template <typename T>
int launch(const void* x0, const void* X, const void* U, const void* ks,
           const void* Ks, const void* d, const void* alphas,
           const void* inertia, int B, int ns, int nc, int nA, double dt,
           double m_scaled, void* Xn, void* Un, void* stream) {
  const long long pairs = static_cast<long long>(B) * nA;
  if (pairs == 0) return 0;
  const int nx = 13 + 6 * nc, nu = 6 * nc;
  const size_t bytes = sizeof(T) * kWarps * (3 * nx + nu + 9);
  const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  srbd_rollout_kernel<T><<<blocks, 32 * kWarps, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), static_cast<const T*>(inertia), B, ns,
      nc, nA, static_cast<T>(dt), static_cast<T>(m_scaled),
      static_cast<T*>(Xn), static_cast<T*>(Un));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROLLOUT_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* x0, const void* X, const void* U,          \
                      const void* ks, const void* Ks, const void* d,         \
                      const void* alphas, const void* inertia, int B,        \
                      int ns, int nc, int nA, double dt, double m_scaled,    \
                      void* Xn, void* Un, void* stream) {                    \
    return launch<T>(x0, X, U, ks, Ks, d, alphas, inertia, B, ns, nc, nA,   \
                     dt, m_scaled, Xn, Un, stream);                          \
  }

ROLLOUT_ENTRY(srbd_rollout_f32, float)
ROLLOUT_ENTRY(srbd_rollout_f64, double)
