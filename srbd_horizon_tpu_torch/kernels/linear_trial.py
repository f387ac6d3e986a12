"""K13: the line-search trial of the linearized forward pass
(`DDPOptions.forward_pass="linear"`) over a vector of step sizes.

`linear_trial` is the wrapper the solver calls. A CPU tensor goes to
`linear_trial_plain`: `forward_linear_plain`, the PyTorch transcription of
the JAX package's `MSDDP._forward_linear`
(srbd_horizon_tpu/solvers/msddp.py:1454-1482) for every α at once, then
the trial's `_true_defects` (:1484) and `total_cost` (:158) of the plan it
gives and its Armijo test (:1507-1531); a CUDA tensor launches the
hand-written kernel in `csrc/linear_trial.cu`, which does all of it in one
launch, or raises.

Per member and α:

    δx₀ = x0 − X₀,   δxₙ₊₁ = (Aₙ + BₙKₙ) δxₙ + α (Bₙkₙ + dₙ)
    Xn = X + δX,     Un = U + α k + K δX[:-1]
    D̂ = Σₙ ‖step(Xnₙ, Unₙ) − Xnₙ₊₁‖²,   cost = total_cost(Xn, Un)
    merit = cost + ν D̂,   expected = −(αΔV₁ + α²ΔV₂) + (2α − α²)νD
    ok = merit0 − merit ≥ β·max(expected, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min

The defect part of the merit is measured, not the (1 − α)²D of the
nonlinear trial; `expected` keeps the iterate's D. The twin composes the
affine maps by JAX's scan tree (`riccati_associative.odd_even_scan`) and
applies the prefix products to δx₀, as JAX does; the kernel runs the same
recursion in node order. A and B come from the sliced linearization
(A = I + Sx on the rows rx, B = Bs on the rows ru and the inputs uc).
Outputs are Xn (nα, B, ns+1, nx), Un (nα, B, ns, nu), cost, merit, ok
(nα, B) — what K3 and K11 return, so the solver's line search takes either.

The step in D̂ is the problem's own (`family_step`, as JAX's
`_true_defects` takes `ocp.step`): the SRBD and the LIP problems' step
(Euler, RK2 or RK4), the RK2 step of the double integrator on the isrbd
AL inner problem; the kernel takes the same step.

The kernel is compiled for twenty problems (`FAMILIES`): the SRBD problem
and the LIP problem each at their nine (topology, step) instances (the
Kangaroo, the point-feet quadruped and the point-feet biped under Euler,
RK2 and RK4), and the AL inner problem of both the Kangaroo's and the
quadruped's isrbd problems; CUDA tensors of other sizes or steps raise
ValueError, CPU tensors take the twin at any size.

A block of eight warps takes one member and up to four of its α's
(`ALPHAS_A_BLOCK`): each α's recursion runs on `chain_warps(nα)` warps
while the others stage every node's operands into a ring in shared
memory, then all eight evaluate the plans node-parallel. `phase_bytes`
states the block's shared memory (the .cu's `Smem`), `occupancy` reads
the card's blocks an SM, bytes, registers and spills, and
`linear_trial_chain` launches the chain alone, so that the two phases can
be timed apart.
"""

from __future__ import annotations

import ctypes

import torch

from srbd_horizon_tpu_torch.kernels import (
    isrbd_linearize,
    lip_linearize,
    linearize,
)
from srbd_horizon_tpu_torch.kernels.build import check_tensor, host_setup, library
from srbd_horizon_tpu_torch.kernels.riccati import KERNEL_SHAPES, RiccatiRows
from srbd_horizon_tpu_torch.kernels.riccati_associative import (
    dense_dynamics,
    odd_even_scan,
)
from srbd_horizon_tpu_torch.kernels.rollout import step_fn
from srbd_horizon_tpu_torch.models.srbd import srbd_xdot

# the JAX function K13 replaces, with the trial's `_true_defects` and
# `total_cost` (XLA-fused; the JAX package wrote no Pallas kernel for them)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1454"
SOURCE = "srbd_horizon_tpu_torch/csrc/linear_trial.cu"

# the problems the kernel is compiled for, in the order of the .cu's
# `with_family` (appended, never reordered): (terms.family, the
# linearization's shape name — K4's or K5's `KERNEL_SHAPES` —, K1's shape,
# and the family's name, as `occupancy` takes it). RK2 and RK4 share K1's
# shape, so K1's name does not pick a family: the linearization's shape
# name (K4's, K10's) does, and the family's name is K1's shape name where
# that shape has one family, K4's name under RK for the SRBD problem and
# "lip_" + K10's for the LIP.
FAMILIES = (("srbd", "kangaroo", "srbd", "srbd"),
            ("lip", "kangaroo", "lip", "lip"),
            ("srbd", "quadruped", "quadruped", "quadruped"),
            ("isrbd_al", "kangaroo", "isrbd_al", "isrbd_al"),
            ("isrbd_al", "quadruped", "isrbd_al_quadruped",
             "isrbd_al_quadruped"),
            ("srbd", "point_feet", "point_feet", "point_feet"),
            ("srbd", "kangaroo_rk2", "srbd_rk", "kangaroo_rk2"),
            ("srbd", "kangaroo_rk4", "srbd_rk", "kangaroo_rk4"),
            ("srbd", "quadruped_rk2", "quadruped_rk", "quadruped_rk2"),
            ("srbd", "quadruped_rk4", "quadruped_rk", "quadruped_rk4"),
            ("srbd", "point_feet_rk2", "point_feet_rk", "point_feet_rk2"),
            ("srbd", "point_feet_rk4", "point_feet_rk", "point_feet_rk4"),
            ("lip", "quadruped", "lip_quadruped", "lip_quadruped"),
            ("lip", "point_feet", "lip_point_feet", "lip_point_feet"),
            ("lip", "kangaroo_rk2", "lip_rk", "lip_kangaroo_rk2"),
            ("lip", "kangaroo_rk4", "lip_rk", "lip_kangaroo_rk4"),
            ("lip", "quadruped_rk2", "lip_quadruped_rk", "lip_quadruped_rk2"),
            ("lip", "quadruped_rk4", "lip_quadruped_rk", "lip_quadruped_rk4"),
            ("lip", "point_feet_rk2", "lip_point_feet_rk",
             "lip_point_feet_rk2"),
            ("lip", "point_feet_rk4", "lip_point_feet_rk",
             "lip_point_feet_rk4"))
FAMILY_NAMES = tuple(f[3] for f in FAMILIES)
# what the block's layout needs of each family beyond K1's shape: the packed
# parameter row's width, the prepass values of a stage node (the SRBD
# rates, the AL geometry; the LIP has no prepass), a warp's stage point
# (nx under RK2 / RK4 on the SRBD problem; the LIP's RK stages stay in
# registers), the blocks an SM the kernel's launch bound asks for
FAMILY_LAYOUT = {
    "srbd": dict(pw=20, rates=10, scratch=0, min_blocks=3),
    "quadruped": dict(pw=20, rates=10, scratch=0, min_blocks=3),
    "isrbd_al": dict(pw=357, rates=16, scratch=0, min_blocks=2),
    "isrbd_al_quadruped": dict(pw=349, rates=16, scratch=0, min_blocks=2),
    "point_feet": dict(pw=16, rates=10, scratch=0, min_blocks=2),
    "kangaroo_rk2": dict(pw=20, rates=10, scratch=37, min_blocks=2),
    "kangaroo_rk4": dict(pw=20, rates=10, scratch=37, min_blocks=2),
    "quadruped_rk2": dict(pw=20, rates=10, scratch=37, min_blocks=2),
    "quadruped_rk4": dict(pw=20, rates=10, scratch=37, min_blocks=2),
    "point_feet_rk2": dict(pw=16, rates=10, scratch=25, min_blocks=2),
    "point_feet_rk4": dict(pw=16, rates=10, scratch=25, min_blocks=2),
    # the LIP's packed row is 4 + 2nc (nc 4, the biped's point feet 2)
    **{name: dict(pw=8 if "point_feet" in name else 12, rates=0, scratch=0,
                  min_blocks=2)
       for fam, _, _, name in FAMILIES if fam == "lip"},
}
WARPS = 8                 # a block's warps (kWarps)
ALPHAS_A_BLOCK = 4        # chain warps a block: the α's of one member
STAGES = 3                # ring slots (kStages)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _family_shape(family: str) -> dict:
    return KERNEL_SHAPES[FAMILIES[FAMILY_NAMES.index(family)][2]]


def chain_warps(na: int) -> int:
    """The chain warps each α takes in a block of na α's (the .cu's
    `chain_warps`): four, two, then one; the block's other warps copy."""
    return 4 if na == 1 else 2 if na == 2 else 1


def chain_split(family: str, na: int) -> dict:
    """The .cu's `ChainSplit<F, W>` for a block of na α's (W =
    `chain_warps(na)`): how an α's W chain warps share a node out (W > 1:
    the rows of K and Sx cut into h1 parts of len1 columns, those of Bs
    into h3 parts of len3, none empty) and each α's scratch in doubles (δx, v, the
    parts); `block` is the na α's scratch."""
    z = _family_shape(family)
    nx, nu, n_rx, n_ru, n_uc = (z[k] for k in ("nx", "nu", "n_rx", "n_ru",
                                                "n_uc"))
    W = chain_warps(na)
    c = dict(rows1=nu + n_rx)
    c["h1"] = max(1, min(4, 32 * W // c["rows1"]))
    c["len1"] = -(-nx // c["h1"])
    parts3 = max(1, min(4, 32 * W // n_ru))
    c["len3"] = -(-n_uc // parts3)
    c["h3"] = -(-n_uc // c["len3"])
    c["dx"] = 0
    c["v"] = _round_up(nx, 2)
    c["p1"] = c["v"] + _round_up(n_uc, 2)
    c["p3"] = c["p1"] + _round_up(max(n_rx + n_ru, c["rows1"] * c["h1"]), 2)
    c["size"] = c["p3"] + _round_up(n_ru * c["h3"], 2)
    c["block"] = na * c["size"]
    return c


def layout(family: str, dtype=torch.float32) -> dict:
    """The .cu's `Smem<F, E>` for the family named `family` and tensors of
    `dtype`: a ring slot's offsets and size (elements of the tensors' type,
    Bs's rows at the odd stride bs_ld), the ring's bytes and those of the
    ring and the chain's scratch (the largest `chain_split` block), an
    evaluating warp's scratch (doubles), a node's packed parameter row
    (elements), an (α, node) record (doubles), the row table (ints) and
    the misc region's bytes (the table and the block's α's)."""
    z, f = _family_shape(family), FAMILY_LAYOUT[family]
    E = torch.finfo(dtype).bits // 8
    vec = 16 // E
    nx, nu, n_rx, n_ru, n_uc = (z[k] for k in ("nx", "nu", "n_rx", "n_ru",
                                                "n_uc"))
    m = dict(vec=vec, bs_ld=n_uc | 1, K=0)
    m["Sx"] = m["K"] + _round_up(nu * nx, vec)
    m["Bs"] = m["Sx"] + _round_up(n_rx * nx, vec)
    m["k"] = m["Bs"] + _round_up(n_ru * m["bs_ld"], vec)
    m["U"] = m["k"] + _round_up(nu, vec)
    m["d"] = m["U"] + _round_up(nu, vec)
    m["X"] = m["d"] + _round_up(nx, vec)
    m["slot"] = m["X"] + _round_up(nx, vec)
    m["ring_bytes"] = STAGES * m["slot"] * E
    m["chain_bytes"] = m["ring_bytes"] + 8 * max(
        chain_split(family, na)["block"] for na in range(1, ALPHAS_A_BLOCK + 1))
    m["e_warp"] = _round_up(f["pw"], 2) + _round_up(f["scratch"], 2)
    m["prow"] = _round_up(f["pw"], vec)
    m["rec"] = _round_up(nx + nu, 2)
    m["rows"] = _round_up(2 * nx + nu, 4)
    m["misc_bytes"] = 4 * m["rows"] + 8 * ALPHAS_A_BLOCK
    return m


def phase_bytes(family: str, dtype=torch.float32, ns: int = 20,
                nA: int = ALPHAS_A_BLOCK) -> dict:
    """The shared memory one K13 block takes at the family named `family`,
    ns stage nodes and nA step sizes a call (a block holds min(nA, 4)),
    region by region: the ring and the chain warps' scratch, the
    evaluation's scratch (which takes their place), the phase region (the
    larger of the two), the member's parameter rows, the records, the row
    table with the block's α's, and the block's total (its dynamic shared
    memory)."""
    m, f = layout(family, dtype), FAMILY_LAYOUT[family]
    E = torch.finfo(dtype).bits // 8
    na = min(nA, ALPHAS_A_BLOCK)
    r16 = lambda v: _round_up(v, 16)
    out = dict(ring=m["ring_bytes"], chain=m["chain_bytes"],
               evaluation=8 * (na * ns * f["rates"] + 2 * na * (ns + 1)
                               + WARPS * m["e_warp"]))
    out["phase"] = r16(max(out["chain"], out["evaluation"]))
    out["params"] = r16((ns + 1) * m["prow"] * E)
    out["records"] = 8 * na * (ns + 1) * m["rec"]
    out["misc"] = m["misc_bytes"]
    out["total"] = (out["phase"] + out["params"] + out["records"]
                    + out["misc"])
    return out
# each family's module of shape checks and parameter tensors
_LINEARIZE = {"srbd": linearize, "lip": lip_linearize,
              "isrbd_al": isrbd_linearize}


def family_xdot(terms):
    """ẋ(x, u) of the problem behind `terms` (`SRBDTerms`, `LIPTerms`, or
    the AL inner problem's `ALTerms`: its double integrator)."""
    if terms.family == "lip":
        return terms.xdot
    if terms.family == "isrbd_al":
        return terms.outer.xdot
    consts = dict(m_scaled=terms.m_scaled, inertia_scaled=terms.inertia_scaled)
    return lambda x, u: srbd_xdot(x, u, consts)


def family_step(terms, dt: float):
    """step(x, u) of the problem behind `terms`, its OCP's integrator: the
    SRBD and the LIP problems' own step (`SRBDTerms.step`,
    `LIPTerms.step`), the RK2 (midpoint) step on the isrbd AL inner
    problem (srbd_horizon_tpu/ocp/integrators.py)."""
    xdot = family_xdot(terms)
    if terms.family == "isrbd_al":
        return lambda x, u: x + dt * xdot(x + 0.5 * dt * xdot(x, u), u)
    return step_fn(xdot, dt, getattr(terms, "step", "EULER"))


def forward_linear_plain(x0, X, U, ks, Ks, A, Bd, d, alphas):
    """`_forward_linear` for every α of `alphas` (nα,): the affine maps
    (Mₙ, vₙ) = (Aₙ + BₙKₙ, α(Bₙkₙ + dₙ)) composed by JAX's prefix scan
    (`combine(f, g)` = g∘f), then δX and Un. A (B,ns,nx,nx), Bd
    (B,ns,nx,nu) dense. Returns Xn (nα,B,ns+1,nx), Un (nα,B,ns,nu)."""
    ns = d.shape[1]
    M = A + torch.einsum("bnxu,bnuy->bnxy", Bd, Ks)
    v = alphas[:, None, None, None] * (
        torch.einsum("bnxu,bnu->bnx", Bd, ks) + d)             # (nα,B,ns,nx)

    def combine(f, g):
        Mf, vf = f
        Mg, vg = g
        return Mg @ Mf, (Mg @ vf[..., None])[..., 0] + vg

    scanned = odd_even_scan(combine, [(M[:, n], v[:, :, n]) for n in range(ns)])
    dx0 = x0 - X[:, 0]
    tail = [(Mc @ dx0[..., None])[..., 0] + vc for Mc, vc in scanned]
    dX = torch.stack([dx0.expand_as(tail[0])] + tail, dim=2)
    Un = (U + alphas[:, None, None, None] * ks
          + torch.einsum("bnuy,kbny->kbnu", Ks, dX[:, :, :-1]))
    return X + dX, Un


def linear_trial_plain(x0, X, U, ks, Ks, Sx, Bs, d, alphas, params, merit0,
                       D, dV1, dV2, terms, rows: RiccatiRows, dt: float,
                       wc: float, nu_w: float, beta: float, alpha_min: float):
    """Plain PyTorch K13: `forward_linear_plain`, the true defects under
    the problem's step and the cost of each plan (`terms` is the problem's
    `SRBDTerms`, `LIPTerms` or `ALTerms`; wc = √w_c, which the AL inner
    problem does not read) and the Armijo test with the measured defects.
    Sx (B,ns,|rx|,nx), Bs (B,ns,|ru|,|uc|); params leaves (B,ns+1,dim);
    merit0, D, dV1, dV2 (B,)."""
    nu = U.shape[-1]
    A, Bd = dense_dynamics(Sx, Bs, rows, nu)
    Xn, Un = forward_linear_plain(x0, X, U, ks, Ks, A, Bd, d, alphas)
    ns = U.shape[-2]
    dn = family_step(terms, dt)(Xn[..., :ns, :], Un) - Xn[..., 1:, :]
    D_new = torch.sum(dn * dn, dim=(-2, -1))
    new_cost = terms.total_cost(Xn, Un, params,
                                *terms.family_args(wc))     # (nα, B)
    a = alphas[:, None]
    new_merit = new_cost + nu_w * D_new
    expected = -(a * dV1 + a ** 2 * dV2) + (2.0 * a - a ** 2) * nu_w * D
    ok = (
        ((merit0 - new_merit) >= beta * torch.clamp(expected, min=1e-16))
        & torch.isfinite(new_merit)
        & (a >= alpha_min)
    )
    return Xn, Un, new_cost, new_merit, ok


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def family_index(terms, nx: int, nu: int, rows: RiccatiRows) -> int:
    """The index in `FAMILIES` of the kernel for this problem; ValueError,
    naming the sizes, for a problem it was not compiled for."""
    fam = getattr(terms, "family", None)
    have = dict(nx=nx, n_rx=len(rows.rx), n_ru=len(rows.ru),
                n_gx=len(rows.gx), n_gu=len(rows.gu), n_b=len(rows.bx),
                n_uc=len(rows.uc))
    if fam in _LINEARIZE:
        shape = _LINEARIZE[fam].check_kernel_shape("linear_trial", terms, nx,
                                                   nu)
        for i, (name, lin_shape, k1_shape, _) in enumerate(FAMILIES):
            want = KERNEL_SHAPES[k1_shape]
            if (name, lin_shape) == (fam, shape) and \
                    have == {k: want[k] for k in have}:
                return i
    raise ValueError(
        f"linear_trial has no kernel for the {fam!r} problem of nx={nx}, "
        f"nu={nu}; it is compiled for {FAMILIES} (csrc/linear_trial.cu)")


def _kernel_fn(dtype):
    lib = library("linear_trial")
    fn = lib.linear_trial_f32 if dtype == torch.float32 else lib.linear_trial_f64
    if fn.argtypes is None:
        fn.argtypes = ([_I] + [_P] * 15 + [_I] * 3 + [_P] + [_D] * 3 + [_I]
                       + [_P] * 6)
        fn.restype = _I
    return fn


def occupancy(family: str = "srbd", dtype=torch.float32, ns: int = 20,
              nA: int = ALPHAS_A_BLOCK) -> dict:
    """K13's blocks resident on one SM, dynamic shared memory bytes a block
    (`phase_bytes(...)["total"]`), registers and local (spilled) bytes a
    thread on the current card, for the family named `family`
    (`FAMILY_NAMES`), ns stage nodes and nA step sizes a call."""
    fn = library("linear_trial").linear_trial_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = _I
    out = (ctypes.c_int * 4)()
    idx = FAMILY_NAMES.index(family)
    err = fn(idx, int(dtype == torch.float64), ns, nA, out)
    if err != 0:
        raise RuntimeError(f"linear_trial occupancy failed: error {err}")
    return dict(zip(("blocks_per_sm", "shared_memory_bytes",
                     "registers_per_thread", "local_bytes_per_thread"), out))


def linear_trial(x0, X, U, ks, Ks, Sx, Bs, d, alphas, params, merit0, D,
                 dV1, dV2, terms, rows: RiccatiRows, dt: float, wc: float,
                 nu_w: float, beta: float, alpha_min: float):
    """K13. Same contract as `linear_trial_plain`; launches the CUDA kernel
    for CUDA tensors of a problem in `FAMILIES` (and counts the launch in
    `linear_trial.launches` and in its family's entry of
    `linear_trial.family_launches`), raises ValueError for others. It
    computes in float64 for float32 tensors too."""
    if d.device.type == "cpu":
        return linear_trial_plain(x0, X, U, ks, Ks, Sx, Bs, d, alphas, params,
                                  merit0, D, dV1, dV2, terms, rows, dt, wc,
                                  nu_w, beta, alpha_min)
    out, fam = _launch(1, x0, X, U, ks, Ks, Sx, Bs, d, alphas, params,
                       merit0, D, dV1, dV2, terms, rows, dt, wc, nu_w, beta,
                       alpha_min)
    linear_trial.launches += 1
    linear_trial.family_launches[fam] += 1
    return out


def linear_trial_chain(x0, X, U, ks, Ks, Sx, Bs, d, alphas, params, merit0,
                       D, dV1, dV2, terms, rows: RiccatiRows, dt: float,
                       wc: float, nu_w: float, beta: float,
                       alpha_min: float):
    """K13's chain phase alone on CUDA tensors (`linear_trial`'s arguments):
    Xn and Un, with cost, merit and ok left unwritten. For timing the two
    phases apart; the solver never calls it, and it counts no launch."""
    if d.device.type != "cuda":
        raise ValueError(f"linear_trial_chain runs on cuda, got {d.device}")
    return _launch(0, x0, X, U, ks, Ks, Sx, Bs, d, alphas, params, merit0, D,
                   dV1, dV2, terms, rows, dt, wc, nu_w, beta, alpha_min)[0]


def _setup(terms, nx: int, nu: int, rows: RiccatiRows, dt: float, wc: float):
    """What K13 checks and builds once for (terms, sizes, dt, √w_c): the
    family's index, and its scalars as a ctypes array."""
    fam = family_index(terms, nx, nu, rows)
    sc = (isrbd_linearize.kernel_scalars(terms, dt)
          if terms.family == "isrbd_al" else terms.kernel_scalars(dt, wc))
    return fam, (_D * len(sc))(*sc)


def _launch(evaluate, x0, X, U, ks, Ks, Sx, Bs, d, alphas, params, merit0, D,
            dV1, dV2, terms, rows, dt, wc, nu_w, beta, alpha_min):
    if d.device.type != "cuda":
        raise ValueError(f"linear_trial runs on cpu or cuda, got {d.device}")
    dtype, dev = d.dtype, d.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"linear_trial takes float32 or float64, got {dtype}")
    Bsz, ns, nx = d.shape
    nu = U.shape[-1]
    sizes = tuple(len(r) for r in (rows.rx, rows.ru, rows.gx, rows.gu,
                                   rows.bx, rows.uc))
    fam, scalars = host_setup(
        terms, ("linear_trial", nx, nu, sizes, dt, wc),
        lambda: _setup(terms, nx, nu, rows, dt, wc))
    nA = alphas.shape[0]
    check_tensor("x0", x0, (Bsz, nx), dtype, dev)
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    check_tensor("ks", ks, (Bsz, ns, nu), dtype, dev)
    check_tensor("Ks", Ks, (Bsz, ns, nu, nx), dtype, dev)
    check_tensor("Sx", Sx, (Bsz, ns, len(rows.rx), nx), dtype, dev)
    check_tensor("Bs", Bs, (Bsz, ns, len(rows.ru), len(rows.uc)), dtype, dev)
    check_tensor("d", d, (Bsz, ns, nx), dtype, dev)
    check_tensor("alphas", alphas, (nA,), dtype, dev)
    for name, t in (("merit0", merit0), ("D", D), ("dV1", dV1), ("dV2", dV2)):
        check_tensor(name, t, (Bsz,), dtype, dev)
    if terms.family == "isrbd_al":
        pt = isrbd_linearize.kernel_params(params, Bsz, ns, terms, dtype, dev)
    else:
        pt = _LINEARIZE[terms.family].kernel_params(params, Bsz, ns, terms.nc,
                                                    dtype, dev)
    Xn = torch.empty((nA, Bsz, ns + 1, nx), dtype=dtype, device=dev)
    Un = torch.empty((nA, Bsz, ns, nu), dtype=dtype, device=dev)
    cost = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    merit = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    ok = torch.empty((nA, Bsz), dtype=torch.bool, device=dev)
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            fam, x0.data_ptr(), X.data_ptr(), U.data_ptr(), ks.data_ptr(),
            Ks.data_ptr(), Sx.data_ptr(), Bs.data_ptr(), d.data_ptr(),
            rows.packed(dev).data_ptr(), alphas.data_ptr(), ptrs,
            merit0.data_ptr(), D.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            Bsz, ns, nA, scalars, float(nu_w), float(beta), float(alpha_min),
            evaluate, Xn.data_ptr(), Un.data_ptr(), cost.data_ptr(),
            merit.data_ptr(), ok.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"linear_trial kernel failed: CUDA error {err}")
    return (Xn, Un, cost, merit, ok), fam


linear_trial.launches = 0
# the launches of each family, indexed as FAMILIES
linear_trial.family_launches = [0] * len(FAMILIES)
