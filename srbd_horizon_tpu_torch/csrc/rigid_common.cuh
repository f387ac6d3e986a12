// Device helpers shared by the SRBD kernels (K3, K4, through
// csrc/srbd_common.cuh) and the isrbd kernels (K5, K6, through
// csrc/isrbd_common.cuh): the homogeneous quaternion rotation and its
// derivatives, the world inertia, the 3×3 adjugate, the quaternion rate
// ȯ = ½(ω,0)⊗o, cross-product matrix columns and the warp reductions; and
// the step tags the SRBD and the LIP kernels are compiled for. One copy, so
// the problem families cannot drift apart.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rigid {

// The steps (ocp/integrators.py; kernels/linearize.py::STEPS and
// kernels/lip_linearize.py::STEPS, same order): the stage points of each
// are x + c_s·dt·k_{s−1}, k_s = ẋ(stage point, u), and x⁺ = x + dt·k₁
// (Euler), x + dt·k₂ (RK2, the explicit midpoint) or
// x + dt/6·(k₁ + 2k₂ + 2k₃ + k₄) (RK4).
struct Euler {
  static constexpr int id = 0, stages = 1;
};
struct Rk2 {
  static constexpr int id = 1, stages = 2;
};
struct Rk4 {
  static constexpr int id = 2, stages = 4;
};

// c_s of stage s ≥ 1 (stage 0 is x itself): ½ for RK2's second stage and
// RK4's second and third, 1 for RK4's fourth.
template <class St>
__host__ __device__ constexpr bool full_stage(int s) {
  return St::stages == 4 && s == 3;
}

// R = quat_to_rot(o), the homogeneous (not normalized) form.
template <typename T>
__device__ void quat_to_rot(const T* o, T* R) {
  const T qx = o[0], qy = o[1], qz = o[2], qw = o[3];
  const T xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const T xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const T wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const T ww = qw * qw;
  R[0] = ww + xx - yy - zz;
  R[1] = T(2) * (xy - wz);
  R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz);
  R[4] = ww - xx + yy - zz;
  R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy);
  R[7] = T(2) * (yz + wx);
  R[8] = ww - xx - yy + zz;
}

// RI = R I and Iw = (R I) Rᵀ, the world inertia.
template <typename T>
__device__ void world_inertia(const T* R, const T* I, T* RI, T* Iw) {
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
      Iw[i * 3 + j] = s;
    }
}

// Cofactors c (row-major: A⁻¹ = c / det) and det of a 3×3 A, as
// math/quat.py::solve3x3 forms them.
template <typename T>
__device__ T adjugate3(const T* A, T* c) {
  const T a00 = A[0], a01 = A[1], a02 = A[2];
  const T a10 = A[3], a11 = A[4], a12 = A[5];
  const T a20 = A[6], a21 = A[7], a22 = A[8];
  c[0] = a11 * a22 - a12 * a21;
  c[1] = a02 * a21 - a01 * a22;
  c[2] = a01 * a12 - a02 * a11;
  c[3] = a12 * a20 - a10 * a22;
  c[4] = a00 * a22 - a02 * a20;
  c[5] = a02 * a10 - a00 * a12;
  c[6] = a10 * a21 - a11 * a20;
  c[7] = a01 * a20 - a00 * a21;
  c[8] = a00 * a11 - a01 * a10;
  return a00 * c[0] + a01 * c[3] + a02 * c[6];
}

// ∂R/∂oⱼ of quat_to_rot (row-major).
template <typename T>
__device__ void set9(T* D, T a, T b, T c, T d, T e, T f, T g, T h, T i) {
  D[0] = a; D[1] = b; D[2] = c; D[3] = d; D[4] = e; D[5] = f; D[6] = g;
  D[7] = h; D[8] = i;
}

template <typename T>
__device__ void drot(int j, const T* o, T* D) {
  const T x = T(2) * o[0], y = T(2) * o[1], z = T(2) * o[2], w = T(2) * o[3];
  switch (j) {
    case 0: set9(D, x, y, z, y, -x, -w, z, w, -x); break;
    case 1: set9(D, -y, x, w, x, y, z, -w, z, -y); break;
    case 2: set9(D, -z, -w, x, w, -z, y, x, y, z); break;
    default: set9(D, w, -z, y, z, w, -x, -y, x, w); break;
  }
}

// Column j of [v]ₓ.
template <typename T>
__device__ void skew_col(const T* v, int j, T* m) {
  m[0] = j == 0 ? T(0) : j == 1 ? -v[2] : v[1];
  m[1] = j == 0 ? v[2] : j == 1 ? T(0) : -v[0];
  m[2] = j == 0 ? -v[1] : j == 1 ? v[0] : T(0);
}

// ȯ = ½ (ω, 0) ⊗ o (x, y, z, w), with the zero scalar part of the rate
// quaternion multiplied through as math/quat.py::quat_product does.
template <typename T>
__device__ void quat_rate(const T* o, const T* w, T* od) {
  const T qx = o[0], qy = o[1], qz = o[2], qw = o[3];
  const T v0 = T(0) * qx + qw * w[0] + (w[1] * qz - w[2] * qy);
  const T v1 = T(0) * qy + qw * w[1] + (w[2] * qx - w[0] * qz);
  const T v2 = T(0) * qz + qw * w[2] + (w[0] * qy - w[1] * qx);
  const T s = T(0) * qw - (w[0] * qx + w[1] * qy + w[2] * qz);
  od[0] = T(0.5) * v0;
  od[1] = T(0.5) * v1;
  od[2] = T(0.5) * v2;
  od[3] = T(0.5) * s;
}

// Entry (q, j) of ∂ȯ/∂o = ½ [[ωₓ, ω], [−ωᵀ, 0]].
template <typename T>
__device__ T quat_rate_jac_o(int q, int j, const T* w) {
  T v;
  if (q == 3) v = j == 3 ? T(0) : -w[j];
  else if (j == 3) v = w[q];
  else if (q == j) v = T(0);
  else v = (q == 0 ? (j == 1 ? -w[2] : w[1])
            : q == 1 ? (j == 0 ? w[2] : -w[0])
                     : (j == 0 ? -w[1] : w[0]));
  return T(0.5) * v;
}

// Entry (q, j) of ∂ȯ/∂ω = ½ [[o_w I − [o_v]ₓ], [−o_vᵀ]].
template <typename T>
__device__ T quat_rate_jac_w(int q, int j, const T* o) {
  T v;
  if (q == 3) v = -o[j];
  else if (q == j) v = o[3];
  else v = (q == 0 ? (j == 1 ? o[2] : -o[1])
            : q == 1 ? (j == 0 ? -o[2] : o[0])
                     : (j == 0 ? o[1] : -o[0]));
  return T(0.5) * v;
}

// ∂Iwⱼ = Rⱼ I Rᵀ + R I Rⱼᵀ, the derivative of the world inertia along
// quaternion component j (R, RI = R I from world_inertia).
template <typename T>
__device__ void world_inertia_dq(int j, const T* o, const T* R, const T* RI,
                                 const T* I, T* dI) {
  T D[9], P[9];
  drot(j, o, D);
  for (int a = 0; a < 3; ++a)
    for (int l = 0; l < 3; ++l) {
      T s = T(0);
      for (int q = 0; q < 3; ++q) s += D[a * 3 + q] * I[q * 3 + l];
      P[a * 3 + l] = s;
    }
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) {
      T s1 = T(0), s2 = T(0);
      for (int l = 0; l < 3; ++l) {
        s1 += P[a * 3 + l] * R[c * 3 + l];
        s2 += RI[a * 3 + l] * D[c * 3 + l];
      }
      dI[a * 3 + c] = s1 + s2;
    }
}

// max(m, v) that keeps a NaN from either side, as torch.amax does (fmax
// would drop it).
template <typename T>
__device__ __forceinline__ T nan_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

// |v|, NaN kept.
template <typename T>
__device__ __forceinline__ T abs_nan(T v) {
  return v < T(0) ? -v : v;
}

// Warp-wide maximum by nan_max (every lane gets it).
template <typename T>
__device__ T warp_nan_max(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Warp-wide sum (every lane gets it).
template <typename T>
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rigid
