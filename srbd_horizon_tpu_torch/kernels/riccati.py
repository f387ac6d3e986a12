"""K1: the blocksparse backward Riccati sweep with the in-kernel SPD inverse.

`riccati_backward` is the wrapper the solver calls. A CPU tensor goes to
`riccati_backward_plain`, the line-for-line PyTorch transcription of the
JAX package's blocksparse `_backward_lanemajor` (`node_ops` and `chain`,
srbd_horizon_tpu/solvers/msddp.py:501-598); a CUDA tensor launches the
hand-written kernel in `csrc/riccati_backward.cu`, or raises.

Per member, the sweep runs over the nodes in reverse:

    lx = 2Jxpᵀρx   lu = 2Jupᵀρu   lxx = 2JxpᵀJxp   luu = 2JupᵀJup
    lux = 2 Jup[both]ᵀ Jxp[both]
    Vx_d = Vx + Vxx d
    Qx  = lx + Vx_d + Sxᵀ Vx_d[rx]           Qu  = lu + Bsᵀ Vx_d[ru]
    VA  = Vxx + Vxx[:, rx] Sx
    Qxx = lxx + VA + Sxᵀ VA[rx]              Quu = luu + Bsᵀ V[ru,ru] Bs + μI
    Qux = lux + Bsᵀ VA[ru]
    k = −Quu⁻¹ Qu    K = −Quu⁻¹ Qux          (block-Schur Quu⁻¹)
    Vx⁺ = Qx + Quxᵀk    Vxx⁺ = sym(Qxx + QuxᵀK)
    ΔV₁ += kᵀQu         ΔV₂ −= ½kᵀQu

from the terminal Vxx = 2JtᵀJt, Vx = 2Jtᵀrt. Sx = (A − I) on the live
dynamics rows rx, Bs = B on the live rows ru; Jxp/Jup are the residual
Jacobian rows that touch x (gx) and u (gu). Batch leads every tensor.

Where the dynamics consume only some inputs (`OCP.dynamics_u_cols`; the
isrbd forces are dead B columns), Bs carries just the live columns uc,
(B,ns,|ru|,|uc|), and the three B-chain terms BsᵀVx_d[ru], BsᵀV[ru,ru]Bs
and BsᵀVA[ru] are accumulated at uc into the dense Qu, Quu, Qux, as
srbd_horizon_tpu/solvers/msddp.py:584-597 scatters them; the residual
Grams stay dense over all nu inputs.

That is the collapsed form (`form="collapsed"`), which the batched
solves run. `form="tassa"` is the JAX package's unbatched `_backward`
(srbd_horizon_tpu/solvers/msddp.py:365-417), which `MSDDP.solve` runs: the
same Q terms, then the gains [k K] = −Quu⁻¹[Qu Qux] from the block-Schur
`spd_solve` (`quu_solver="schur"`) or a Cholesky solve ("cholesky"; a
Quu that is not positive definite gives NaN gains), and the full Tassa
value update, with Quu kept:

    Vx⁺  = Qx + KᵀQuu k + KᵀQu + Quxᵀk
    Vxx⁺ = sym(Qxx + KᵀQuu K + KᵀQux + QuxᵀK)
    ΔV₁ += kᵀQu         ΔV₂ += ½kᵀQuu k

summed left to right, KᵀQuu formed once. `quu_solver` is read only with
the Tassa form: the JAX package's AL solver asks its inner solver for a
Cholesky gain solve, but its batched lane-major sweep ignores that option
and always takes `lm_spd_inverse` (msddp.py:501-503), and so does the
collapsed form here, for every caller.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from srbd_horizon_tpu_torch.kernels.build import check_tensor, library
from srbd_horizon_tpu_torch.math.linalg import (
    cho_factor,
    cho_solve,
    lm_matmul,
    lm_matmul_tn,
    lm_matvec,
    lm_matvec_tn,
    lm_spd_inverse,
    lm_transpose,
    spd_solve,
)

# the TPU kernel K1 replaces: the pl.pallas_call of the retired
# backward_sweep_pallas (read it with `git show b514cfb^:<path>`); its live
# successor is the blocksparse branch at srbd_horizon_tpu/solvers/msddp.py:431
REPLACES = "srbd_horizon_tpu/solvers/pallas_backward.py:284"
# K2, the SPD inverse inside K1, replaces that kernel's `_spd_inv`
K2_REPLACES = "srbd_horizon_tpu/solvers/pallas_backward.py:135"
# the Tassa form's instantiations replace the unbatched sweep (a
# `lax.scan`, XLA-fused; the JAX package wrote no Pallas kernel for it)
TASSA_REPLACES = "srbd_horizon_tpu/solvers/msddp.py:365"
SOURCE = "srbd_horizon_tpu_torch/csrc/riccati_backward.cu"


@dataclasses.dataclass(frozen=True)
class RiccatiRows:
    """The row sets K1 contracts over, as sorted index tuples:
    rx/ru — live rows of (A − I)/B; gx/gu — residual rows touching x/u;
    bx/bu — positions, within gx/gu, of the rows touching both; uc — live
    columns of B (all of range(nu) when every input drives the dynamics)."""

    rx: Tuple[int, ...]
    ru: Tuple[int, ...]
    gx: Tuple[int, ...]
    gu: Tuple[int, ...]
    bx: Tuple[int, ...]
    bu: Tuple[int, ...]
    uc: Tuple[int, ...]
    _cache: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @staticmethod
    def from_ocp(ocp) -> "RiccatiRows":
        rx = tuple(sorted(int(r) for r in ocp.dynamics_x_rows))
        ru = tuple(sorted(int(r) for r in ocp.dynamics_u_rows))
        gx = tuple(sorted(int(r) for r in ocp.residual_x_rows))
        gu = tuple(sorted(int(r) for r in ocp.residual_u_rows))
        both = sorted(set(gx) & set(gu))
        uc = (range(ocp.nu) if ocp.dynamics_u_cols is None
              else sorted(set(int(c) for c in ocp.dynamics_u_cols)))
        return RiccatiRows(
            rx=rx, ru=ru, gx=gx, gu=gu,
            bx=tuple(gx.index(r) for r in both),
            bu=tuple(gu.index(r) for r in both),
            uc=tuple(uc),
        )

    def index(self, device) -> Dict[str, torch.Tensor]:
        """The seven sets as int64 index tensors on `device` (built once)."""
        key = ("index", str(device))
        if key not in self._cache:
            self._cache[key] = {
                name: torch.tensor(getattr(self, name), dtype=torch.int64,
                                   device=device)
                for name in ("rx", "ru", "gx", "gu", "bx", "bu", "uc")
            }
        return self._cache[key]

    def packed(self, device) -> torch.Tensor:
        """rx | ru | gx | gu | bx | bu | uc as one int32 tensor (the
        kernels' row table), built once per device."""
        key = ("packed", str(device))
        if key not in self._cache:
            flat = (self.rx + self.ru + self.gx + self.gu + self.bx + self.bu
                    + self.uc)
            self._cache[key] = torch.tensor(flat, dtype=torch.int32,
                                            device=device)
        return self._cache[key]


FORMS = ("collapsed", "tassa")
QUU_SOLVERS = ("schur", "cholesky")


def gain_solve(form: str, quu_solver: str) -> str:
    """The gain solve a sweep of `form` runs: `quu_solver` for the Tassa
    form, the block-Schur inverse for the collapsed one (which ignores the
    option); ValueError for an unknown form or solver."""
    if form not in FORMS:
        raise ValueError(f"form={form!r}: one of {FORMS}")
    if quu_solver not in QUU_SOLVERS:
        raise ValueError(f"quu_solver={quu_solver!r}: one of {QUU_SOLVERS}")
    return quu_solver if form == "tassa" else "schur"


def riccati_backward_plain(Sx, Bs, Jxp, Jup, rho, d, Jt, rt, mu: float,
                           rows: RiccatiRows, form: str = "collapsed",
                           quu_solver: str = "schur"):
    """Plain PyTorch sweep. Shapes: Sx (B,ns,|rx|,nx), Bs (B,ns,|ru|,|uc|),
    Jxp (B,ns,|gx|,nx), Jup (B,ns,|gu|,nu), rho (B,ns,nr), d (B,ns,nx),
    Jt (B,nt,nx), rt (B,nt). Returns ks (B,ns,nu), Ks (B,ns,nu,nx),
    dV1 (B,), dV2 (B,). `form` and `quu_solver` as in the module
    docstring."""
    solve = gain_solve(form, quu_solver)
    Bsz, ns, nx = d.shape
    nu = Jup.shape[-1]
    dtype, dev = d.dtype, d.device
    idx = rows.index(dev)
    rx, ru, gx, gu = idx["rx"], idx["ru"], idx["gx"], idx["gu"]
    both = len(rows.bx) > 0
    # Bs carries only the live B columns: scatter its chain terms back
    uc = idx["uc"] if len(rows.uc) < nu else None

    Vxx = 2.0 * lm_matmul_tn(Jt, Jt)
    Vx = 2.0 * lm_matvec_tn(Jt, rt)
    eye_mu = mu * torch.eye(nu, dtype=dtype, device=dev)
    dV1 = torch.zeros(Bsz, dtype=dtype, device=dev)
    dV2 = torch.zeros(Bsz, dtype=dtype, device=dev)
    ks = torch.empty((Bsz, ns, nu), dtype=dtype, device=dev)
    Ks = torch.empty((Bsz, ns, nu, nx), dtype=dtype, device=dev)

    for n in reversed(range(ns)):
        Sx_, Bs_, Jxp_, Jup_ = Sx[:, n], Bs[:, n], Jxp[:, n], Jup[:, n]
        rxp_ = rho[:, n].index_select(-1, gx)
        rup_ = rho[:, n].index_select(-1, gu)
        d_ = d[:, n]
        # node_ops: Gauss-Newton quadratics and the blocksparse chain
        lx = 2.0 * lm_matvec_tn(Jxp_, rxp_)
        lu = 2.0 * lm_matvec_tn(Jup_, rup_)
        lxx = 2.0 * lm_matmul_tn(Jxp_, Jxp_)
        luu = 2.0 * lm_matmul_tn(Jup_, Jup_)
        if both:
            lux = 2.0 * lm_matmul_tn(
                Jup_.index_select(-2, idx["bu"]),
                Jxp_.index_select(-2, idx["bx"]),
            )
        else:
            lux = torch.zeros((Bsz, nu, nx), dtype=dtype, device=dev)
        Vx_d = Vx + lm_matvec(Vxx, d_)
        Qx = lx + Vx_d + lm_matvec_tn(Sx_, Vx_d.index_select(-1, rx))
        Qu_c = lm_matvec_tn(Bs_, Vx_d.index_select(-1, ru))
        VA = Vxx + lm_matmul(Vxx.index_select(-1, rx), Sx_)
        Qxx = lxx + VA + lm_matmul_tn(Sx_, VA.index_select(-2, rx))
        V_uu = Vxx.index_select(-2, ru).index_select(-1, ru)
        Quu_c = lm_matmul_tn(Bs_, lm_matmul(V_uu, Bs_))
        Qux_c = lm_matmul_tn(Bs_, VA.index_select(-2, ru))
        if uc is not None:
            Qu_c = Qu_c.new_zeros((Bsz, nu)).index_copy(-1, uc, Qu_c)
            Quu_c = Quu_c.new_zeros((Bsz, nu, len(rows.uc))).index_copy(
                -2, uc, Quu_c)
            Quu_c = Quu_c.new_zeros((Bsz, nu, nu)).index_copy(-1, uc, Quu_c)
            Qux_c = Qux_c.new_zeros((Bsz, nu, nx)).index_copy(-2, uc, Qux_c)
        Qu = lu + Qu_c
        Quu = luu + Quu_c + eye_mu
        Qux = lux + Qux_c
        if form == "collapsed":
            # chain: gains and the Schur-form value update
            iQ = lm_spd_inverse(Quu)
            k = -lm_matvec(iQ, Qu)
            K = -lm_matmul(iQ, Qux)
            kQu = torch.sum(k * Qu, dim=-1)
            Vx = Qx + lm_matvec_tn(Qux, k)
            Vxx = Qxx + lm_matmul_tn(Qux, K)
            dV1 = dV1 + kQu
            dV2 = dV2 - 0.5 * kQu
        else:
            # `_backward`'s node: the gains, then the Tassa value update
            rhs = torch.cat([Qu[..., None], Qux], dim=-1)
            kK = -(spd_solve(Quu, rhs) if solve == "schur"
                   else cho_solve(cho_factor(Quu), rhs))
            k, K = kK[..., 0], kK[..., 1:]
            KtQuu = lm_matmul_tn(K, Quu)
            Vx = (Qx + lm_matvec(KtQuu, k) + lm_matvec_tn(K, Qu)
                  + lm_matvec_tn(Qux, k))
            Vxx = (Qxx + lm_matmul(KtQuu, K) + lm_matmul_tn(K, Qux)
                   + lm_matmul_tn(Qux, K))
            dV1 = dV1 + torch.sum(k * Qu, dim=-1)
            dV2 = dV2 + torch.sum(lm_matvec_tn(Quu, 0.5 * k) * k, dim=-1)
        Vxx = 0.5 * (Vxx + lm_transpose(Vxx))
        ks[:, n] = k
        Ks[:, n] = K
    return ks, Ks, dV1, dV2


_P = ctypes.c_void_p
_I = ctypes.c_int

# The kernel's compile-time shapes, in the order of csrc/riccati_common.cuh's
# shape structs (SrbdShape, IsrbdAlShape, LipShape, QuadShape, QuadAlShape,
# PointFeetShape, SrbdRkShape, QuadRkShape, PointFeetRkShape, LipRkShape,
# LipQuadShape, LipQuadRkShape, LipPointFeetShape, LipPointFeetRkShape,
# SquareFeetShape, SquareFeetRkShape, LipSquareFeetShape,
# LipSquareFeetRkShape, LineFeetQuadShape, LineFeetQuadRkShape,
# LipLineFeetQuadShape, LipLineFeetQuadRkShape): nx, nu, the terminal rows
# nt and the sizes of the row sets. The SRBD and
# the LIP problems under RK2 and under RK4 have every row of B live (n_ru =
# nx); the two steps share their shape. Another problem needs a shape of
# its own there and here.
KERNEL_SHAPES = {
    "srbd": dict(nx=37, nu=24, nt=15, n_rx=22, n_ru=18, n_gx=34, n_gu=42,
                 n_b=3, n_uc=24),
    "isrbd_al": dict(nx=37, nu=30, nt=101, n_rx=19, n_ru=37, n_gx=60,
                     n_gu=103, n_b=9, n_uc=18),
    "lip": dict(nx=30, nu=15, nt=10, n_rx=18, n_ru=15, n_gx=32, n_gu=18,
                n_b=6, n_uc=15),
    "quadruped": dict(nx=37, nu=24, nt=15, n_rx=22, n_ru=18, n_gx=30,
                      n_gu=42, n_b=3, n_uc=24),
    "isrbd_al_quadruped": dict(nx=37, nu=30, nt=97, n_rx=19, n_ru=37,
                               n_gx=56, n_gu=103, n_b=9, n_uc=18),
    "point_feet": dict(nx=25, nu=12, nt=15, n_rx=16, n_ru=12, n_gx=24,
                       n_gu=24, n_b=3, n_uc=12),
    "srbd_rk": dict(nx=37, nu=24, nt=15, n_rx=22, n_ru=37, n_gx=34, n_gu=42,
                    n_b=3, n_uc=24),
    "quadruped_rk": dict(nx=37, nu=24, nt=15, n_rx=22, n_ru=37, n_gx=30,
                         n_gu=42, n_b=3, n_uc=24),
    "point_feet_rk": dict(nx=25, nu=12, nt=15, n_rx=16, n_ru=25, n_gx=24,
                          n_gu=24, n_b=3, n_uc=12),
    "lip_rk": dict(nx=30, nu=15, nt=10, n_rx=18, n_ru=30, n_gx=32, n_gu=18,
                   n_b=6, n_uc=15),
    "lip_quadruped": dict(nx=30, nu=15, nt=10, n_rx=18, n_ru=15, n_gx=28,
                          n_gu=18, n_b=6, n_uc=15),
    "lip_quadruped_rk": dict(nx=30, nu=15, nt=10, n_rx=18, n_ru=30, n_gx=28,
                             n_gu=18, n_b=6, n_uc=15),
    "lip_point_feet": dict(nx=18, nu=9, nt=10, n_rx=12, n_ru=9, n_gx=22,
                           n_gu=12, n_b=6, n_uc=9),
    "lip_point_feet_rk": dict(nx=18, nu=9, nt=10, n_rx=12, n_ru=18, n_gx=22,
                              n_gu=12, n_b=6, n_uc=9),
    # the square-feet biped (contact_model=4, nc=8), both problems
    "square_feet": dict(nx=61, nu=48, nt=15, n_rx=34, n_ru=30, n_gx=54,
                        n_gu=78, n_b=3, n_uc=48),
    "square_feet_rk": dict(nx=61, nu=48, nt=15, n_rx=34, n_ru=61, n_gx=54,
                           n_gu=78, n_b=3, n_uc=48),
    "lip_square_feet": dict(nx=54, nu=27, nt=10, n_rx=30, n_ru=27, n_gx=52,
                            n_gu=30, n_b=6, n_uc=27),
    "lip_square_feet_rk": dict(nx=54, nu=27, nt=10, n_rx=30, n_ru=54,
                               n_gx=52, n_gu=30, n_b=6, n_uc=27),
    # the line-feet quadruped (contact_model=2 on four legs, nc=8), both
    # problems: the square feet's sizes but n_gx, which alone tells the two
    # apart
    "line_feet_quadruped": dict(nx=61, nu=48, nt=15, n_rx=34, n_ru=30,
                                n_gx=50, n_gu=78, n_b=3, n_uc=48),
    "line_feet_quadruped_rk": dict(nx=61, nu=48, nt=15, n_rx=34, n_ru=61,
                                   n_gx=50, n_gu=78, n_b=3, n_uc=48),
    "lip_line_feet_quadruped": dict(nx=54, nu=27, nt=10, n_rx=30, n_ru=27,
                                    n_gx=48, n_gu=30, n_b=6, n_uc=27),
    "lip_line_feet_quadruped_rk": dict(nx=54, nu=27, nt=10, n_rx=30,
                                       n_ru=54, n_gx=48, n_gu=30, n_b=6,
                                       n_uc=27),
}
# the shapes whose instantiations csrc/riccati_backward_square_feet.cu and
# csrc/riccati_backward_line_feet.cu build, each into a library of its own
SQUARE_FEET_SHAPES = ("square_feet", "square_feet_rk", "lip_square_feet",
                      "lip_square_feet_rk")
LINE_FEET_SHAPES = ("line_feet_quadruped", "line_feet_quadruped_rk",
                    "lip_line_feet_quadruped", "lip_line_feet_quadruped_rk")

# K1's instantiations, in the order of csrc/riccati_backward.cu's
# `with_instance`: (shape, value form, gain solve). The collapsed form with
# the block-Schur inverse serves the batched solves at every shape; the
# Tassa form serves `MSDDP.solve`: with the inverse at every shape but the
# two isrbd-AL ones (DDPOptions' default), with Cholesky at every shape
# (the AL solver's inner solve at the isrbd-AL shapes; quu_solver=
# "cholesky", which the JAX package's `_backward` takes at any shape,
# elsewhere). Indices are appended, never reordered. CUDA tensors at
# another (shape, form, solver) — the block-Schur Tassa form at the AL
# shapes — raise ValueError.
KERNEL_INSTANCES = (
    ("srbd", "collapsed", "schur"),
    ("isrbd_al", "collapsed", "schur"),
    ("srbd", "tassa", "schur"),
    ("isrbd_al", "tassa", "cholesky"),
    ("srbd", "tassa", "cholesky"),
    ("lip", "collapsed", "schur"),
    ("lip", "tassa", "schur"),
    ("lip", "tassa", "cholesky"),
    ("quadruped", "collapsed", "schur"),
    ("quadruped", "tassa", "schur"),
    ("isrbd_al_quadruped", "collapsed", "schur"),
    ("isrbd_al_quadruped", "tassa", "cholesky"),
    ("point_feet", "collapsed", "schur"),
    ("point_feet", "tassa", "schur"),
    ("point_feet", "tassa", "cholesky"),
    ("srbd_rk", "collapsed", "schur"),
    ("srbd_rk", "tassa", "schur"),
    ("srbd_rk", "tassa", "cholesky"),
    ("quadruped_rk", "collapsed", "schur"),
    ("quadruped_rk", "tassa", "schur"),
    ("point_feet_rk", "collapsed", "schur"),
    ("point_feet_rk", "tassa", "schur"),
    ("quadruped", "tassa", "cholesky"),
    ("quadruped_rk", "tassa", "cholesky"),
    ("point_feet_rk", "tassa", "cholesky"),
) + tuple((shape, form, solver)
          for shape in ("lip_rk", "lip_quadruped", "lip_quadruped_rk",
                        "lip_point_feet", "lip_point_feet_rk")
          + SQUARE_FEET_SHAPES + LINE_FEET_SHAPES
          for form, solver in (("collapsed", "schur"), ("tassa", "schur"),
                               ("tassa", "cholesky")))

# the launchers' own errors (no CUDA error has these values): the block's
# shared memory exceeds the card's opt-in limit; the sizes match no
# instantiation
SMEM_EXCEEDED = -1
UNKNOWN_SHAPE = -2


def kernel_sizes(nx: int, nu: int, nt: int, rows: RiccatiRows) -> Dict[str, int]:
    return dict(nx=nx, nu=nu, nt=nt, n_rx=len(rows.rx), n_ru=len(rows.ru),
                n_gx=len(rows.gx), n_gu=len(rows.gu), n_b=len(rows.bx),
                n_uc=len(rows.uc))


def kernel_shape(nx: int, nu: int, nt: int, rows: RiccatiRows) -> str:
    """The name of K1's instantiation for these sizes; ValueError, naming
    the sizes, if none was compiled for them."""
    sizes = kernel_sizes(nx, nu, nt, rows)
    for name, want in KERNEL_SHAPES.items():
        if sizes == want:
            return name
    known = "; ".join(f"{name} {want}" for name, want in KERNEL_SHAPES.items())
    raise ValueError(
        f"riccati_backward has no kernel for the sizes {sizes}; it is "
        f"compiled for {known} (csrc/riccati_backward.cu)")


def kernel_instance(shape: str, form: str = "collapsed",
                    quu_solver: str = "schur") -> int:
    """The index in `KERNEL_INSTANCES` of K1's instantiation for the shape
    `shape` (a `kernel_shape` name), the value form and the gain solve
    (`gain_solve`); ValueError, naming what was compiled, if there is
    none."""
    key = (shape, form, gain_solve(form, quu_solver))
    if key not in KERNEL_INSTANCES:
        raise ValueError(
            f"riccati_backward has no kernel for {key}; it is compiled for "
            f"{KERNEL_INSTANCES} (csrc/riccati_backward.cu)")
    return KERNEL_INSTANCES.index(key)


def library_name(inst: int) -> str:
    """The kernel library that holds instantiation `inst`: the square-feet
    biped's shapes are built by csrc/riccati_backward_square_feet.cu, the
    line-feet quadruped's by csrc/riccati_backward_line_feet.cu."""
    shape = KERNEL_INSTANCES[inst][0]
    if shape in SQUARE_FEET_SHAPES:
        return "riccati_backward_square_feet"
    if shape in LINE_FEET_SHAPES:
        return "riccati_backward_line_feet"
    return "riccati_backward"


def _inv_work(n: int) -> int:
    """riccati_common.cuh's `inv_work`: K2's float64 workspace at n×n."""
    if n <= 3:
        return 0
    k, m = n // 2, n - n // 2
    return k * m * 2 + m * m + max(_inv_work(k), _inv_work(m))


def layout_bytes(shape: str, dtype=torch.float32) -> int:
    """The dynamic shared memory one K1 block of the shape `shape` takes
    for tensors of `dtype`, as csrc/riccati_backward.cu's `Layout<S,
    T>::bytes` reckons it (the card's figure is `shared_memory_bytes`)."""
    z = KERNEL_SHAPES[shape]
    nx, nu, nt = z["nx"], z["nu"], z["nt"]
    elem = torch.finfo(dtype).bits // 8
    region = 3 * nx + nx * nx + 2 * nu + nu * nu + nu * nx + 2
    blocks = nx * nx + z["n_ru"] * z["n_uc"]
    node = (z["n_rx"] * nx + z["n_ru"] * z["n_uc"] + z["n_gx"] * nx
            + z["n_gu"] * nu + z["n_gx"] + z["n_gu"] + nx)
    terminal = nt * nx + nt
    region_bytes = max(
        blocks * 8 + (max(node, terminal) * elem + 7) // 8 * 8,
        (nu * nu + nu * nx + max(_inv_work(nu), nx * nu + nu)) * 8)
    rows = (z["n_rx"] + z["n_ru"] + z["n_gx"] + z["n_gu"] + 2 * z["n_b"]
            + z["n_uc"])
    return region * 8 + region_bytes + (rows + nu) * 4


def _kernel_fn(dtype, inst: int):
    lib = library(library_name(inst))
    fn = lib.riccati_backward_f32 if dtype == torch.float32 else lib.riccati_backward_f64
    if fn.argtypes is None:
        fn.argtypes = [_I] + [_P] * 9 + [_I] * 12 + [ctypes.c_double] + [_P] * 5
        fn.restype = _I
    return fn


def shared_memory_bytes(nx: int, nu: int, nt: int, rows: RiccatiRows,
                        dtype=torch.float32, form: str = "collapsed",
                        quu_solver: str = "schur") -> int:
    """Dynamic shared memory one K1 block takes at these sizes, for tensors
    of `dtype` (the node's blocks stay in it on chip), as the launcher
    reckons it."""
    inst = kernel_instance(kernel_shape(nx, nu, nt, rows), form, quu_solver)
    fn = library(library_name(inst)).riccati_backward_smem_bytes
    if fn.argtypes is None:
        fn.argtypes = [_I, _I]
        fn.restype = ctypes.c_longlong
    return int(fn(inst, int(dtype == torch.float64)))


def blocks_per_sm(nx: int, nu: int, nt: int, rows: RiccatiRows,
                  dtype=torch.float32, form: str = "collapsed",
                  quu_solver: str = "schur") -> int:
    """K1 blocks one SM of the current card holds at once at these sizes
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    inst = kernel_instance(kernel_shape(nx, nu, nt, rows), form, quu_solver)
    fn = library(library_name(inst)).riccati_backward_blocks_per_sm
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = _I
    blocks = ctypes.c_int(0)
    err = fn(inst, int(dtype == torch.float64), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"riccati_backward occupancy query failed: error {err}")
    return blocks.value


def riccati_backward(Sx, Bs, Jxp, Jup, rho, d, Jt, rt, mu: float,
                     rows: RiccatiRows, form: str = "collapsed",
                     quu_solver: str = "schur"):
    """K1. Same contract as `riccati_backward_plain`; launches the CUDA
    kernel for CUDA tensors (and counts the launch in
    `riccati_backward.launches`) at the sizes, form and gain solve of an
    instantiation in `KERNEL_INSTANCES`, and raises ValueError at any
    other. The kernel computes in float64 for float32 tensors too, so on
    float32 it is ~1e-2 closer in the gains to the float64 sweep than the
    plain twin is (see the note in the .cu)."""
    if d.device.type == "cpu":
        return riccati_backward_plain(Sx, Bs, Jxp, Jup, rho, d, Jt, rt, mu,
                                      rows, form, quu_solver)
    if d.device.type != "cuda":
        raise ValueError(f"riccati_backward runs on cpu or cuda, got {d.device}")
    dtype, dev = d.dtype, d.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"riccati_backward takes float32 or float64, got {dtype}")
    Bsz, ns, nx = d.shape
    nu = Jup.shape[-1]
    nr = rho.shape[-1]
    nt = Jt.shape[-2]
    n_rx, n_ru, n_gx, n_gu, n_b, n_uc = (
        len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu), len(rows.bx),
        len(rows.uc))
    if n_uc > nu or (n_uc and max(rows.uc) >= nu):
        raise ValueError(f"live B columns {rows.uc} out of range for nu={nu}")
    inst = kernel_instance(kernel_shape(nx, nu, nt, rows), form, quu_solver)
    check_tensor("Sx", Sx, (Bsz, ns, n_rx, nx), dtype, dev)
    check_tensor("Bs", Bs, (Bsz, ns, n_ru, n_uc), dtype, dev)
    check_tensor("Jxp", Jxp, (Bsz, ns, n_gx, nx), dtype, dev)
    check_tensor("Jup", Jup, (Bsz, ns, n_gu, nu), dtype, dev)
    check_tensor("rho", rho, (Bsz, ns, nr), dtype, dev)
    check_tensor("d", d, (Bsz, ns, nx), dtype, dev)
    check_tensor("Jt", Jt, (Bsz, nt, nx), dtype, dev)
    check_tensor("rt", rt, (Bsz, nt), dtype, dev)
    ks = torch.empty((Bsz, ns, nu), dtype=dtype, device=dev)
    Ks = torch.empty((Bsz, ns, nu, nx), dtype=dtype, device=dev)
    dV1 = torch.empty((Bsz,), dtype=dtype, device=dev)
    dV2 = torch.empty((Bsz,), dtype=dtype, device=dev)
    table = rows.packed(dev)
    fn = _kernel_fn(dtype, inst)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            inst,
            Sx.data_ptr(), Bs.data_ptr(), Jxp.data_ptr(), Jup.data_ptr(),
            rho.data_ptr(), d.data_ptr(), Jt.data_ptr(), rt.data_ptr(),
            table.data_ptr(),
            Bsz, ns, nx, nu, nr, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc,
            float(mu),
            ks.data_ptr(), Ks.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            stream,
        )
    if err == SMEM_EXCEEDED:
        raise RuntimeError(
            "riccati_backward needs "
            f"{shared_memory_bytes(nx, nu, nt, rows, dtype)} bytes of shared "
            "memory a block, more than this card allows")
    if err != 0:
        raise RuntimeError(f"riccati_backward kernel failed: error {err}")
    riccati_backward.launches += 1
    riccati_backward.instance_launches[inst] += 1
    return ks, Ks, dV1, dV2


riccati_backward.launches = 0
# the launches of each instantiation, indexed as KERNEL_INSTANCES
riccati_backward.instance_launches = [0] * len(KERNEL_INSTANCES)


def spd_inverse(A):
    """K2 alone: the block-Schur inverse K1 runs on Quu, over an (M, n, n)
    stack of SPD matrices, n one of K1's nu (9, 12, 15, 24, 27, 30, 48: 27
    and 48 from the square-feet library). Computes in float64
    for float32 tensors too. A CPU tensor goes to `lm_spd_inverse`; a CUDA
    tensor launches the kernel (counted in `spd_inverse.launches`) or
    raises. Nothing on the solver's path calls it: it is here to time and
    check the routine by itself."""
    if A.device.type == "cpu":
        return lm_spd_inverse(A)
    if A.device.type != "cuda":
        raise ValueError(f"spd_inverse runs on cpu or cuda, got {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spd_inverse takes float32 or float64, got {A.dtype}")
    sizes = sorted({s["nu"] for s in KERNEL_SHAPES.values()})
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.shape[1] not in sizes:
        raise ValueError(f"spd_inverse takes an (M, n, n) stack with n in "
                         f"{sizes}, got {tuple(A.shape)}")
    check_tensor("A", A, tuple(A.shape), A.dtype, A.device)
    M, n = A.shape[0], A.shape[1]
    out = torch.empty_like(A)
    square = n in {KERNEL_SHAPES[s]["nu"] for s in SQUARE_FEET_SHAPES}
    lib = library("riccati_backward_square_feet" if square
                  else "riccati_backward")
    fn = lib.spd_inverse_f32 if A.dtype == torch.float32 else lib.spd_inverse_f64
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _P]
        fn.restype = _I
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), out.data_ptr(), M, n,
                 torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spd_inverse kernel failed: error {err}")
    spd_inverse.launches += 1
    return out


spd_inverse.launches = 0
