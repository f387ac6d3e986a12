"""PyTorch port, K13's block layout and its node-order recursion, on the CPU.

The card runs K13 (`csrc/linear_trial.cu`); here no CUDA compiler exists.
These tests hold what the wrapper states about the kernel against the
source itself: at each of the twenty families and for float32 and float64
tensors, the shared memory a block takes (`phase_bytes`, ns = 20, four α)
against the `Smem` layout struct evaluated from the .cu's text, within the
232,448 B a block may take, and — float32, four α — the blocks an SM the
family's launch bound asks for (three at the nx = 37 Euler SRBD families,
two elsewhere) within the 233,472 B of an SM (1 KB a block reserved); the
wrapper's per-family layout figures (parameter row, prepass values, stage
point, launch bound) against the headers' constants and the families'
structs; how a block of 1-4 α's shares the chain out (`chain_split`, the
.cu's `ChainSplit` at the chain warps it gives each α), every row part
covered once. Then `node_order_trial`, a torch model of the kernel's recursion
in node order — δx in float64, Kδx, the live rows of Sx against δx and of
Bs against (Kδx + αk)[uc], δxₙ₊₁ = δx + Sxδx + Bs v + αd — at every
family's sizes (ns = 20, four α, drawn iterates linearized by the plain
linearizers, the gains of K12's twin): its plans agree with
`forward_linear_plain`'s scan tree to 1e-12 relative, and, on trials whose
merit0 is drawn MARGIN (relative) off the Armijo threshold on either side,
its flags equal the twin's. No JAX, no compile.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
from srbd_horizon_tpu_torch.kernels.riccati import KERNEL_SHAPES
from srbd_horizon_tpu_torch.kernels.riccati_associative import dense_dynamics
from srbd_horizon_tpu_torch.models.kangaroo import (kangaroo_line_feet,
                                                    point_feet)
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP
from srbd_horizon_tpu_torch.solvers.options import al_serving_options

torch.set_num_threads(1)

CPU = torch.device("cpu")

CSRC = Path(k13.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "linear_trial.cu").read_text()
SMEM_PER_BLOCK = 232_448  # an H100's shared memory a block may take
SMEM_PER_SM = 233_472     # and an SM's (each block also holds 1 KB of it)
NS = 20                   # the horizon of every configuration
ALPHAS = (1.0, 0.5, 0.25, 0.125)
B = 3                     # members a draw
SCAN_TOL = 1e-12          # the model's plans against the twin's, relative
MARGIN = 1e-6             # merit0's distance from the Armijo threshold,
                          # relative to max(1, |merit|)
DTYPES = (torch.float32, torch.float64)
CASES = [(f, d) for f in k13.FAMILY_NAMES for d in DTYPES]


def _struct_fields(name):
    """The `static constexpr int` declarations of struct `name` in the .cu,
    in order, as (field, C++ expression)."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", SOURCE, re.S).group(1)
    out = []
    for decl in re.findall(r"static constexpr int ([^;]*);", body):
        decl = " ".join(decl.split())
        depth, cur = 0, ""
        for ch in decl + ",":
            depth += ch in "(<"
            depth -= ch in ")>"
            if ch == "," and depth == 0:
                field, expr = cur.split("=", 1)
                out.append((field.strip(), expr.strip()))
                cur = ""
            else:
                cur += ch
    return out


def _consts():
    """The .cu's namespace-scope `constexpr int k…` constants."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", SOURCE,
                                 re.M):
        env[name] = int(eval(expr.split("//")[0], {}, env))
    return env


def _eval_struct(name, env):
    """Struct `name`'s fields evaluated from the .cu's text in `env`."""
    env = dict(env)
    for field, expr in _struct_fields(name):
        py = re.sub(r"(?<!/)/(?!/)", "//", expr.replace("F::", "F_"))
        py = py.replace("chain_doubles<F>()", "chain_doubles")
        env[field] = int(eval(py, {"round_up": k13._round_up, "cmin": min,
                                   "cmax": max}, env))
    return env


def _source_layout(family, dtype):
    """`Smem<F, E>` evaluated from the .cu's text for the family's sizes,
    `chain_doubles` from `ChainSplit<F, NA>` at NA = 1 … 4."""
    z = KERNEL_SHAPES[k13.FAMILIES[k13.FAMILY_NAMES.index(family)][2]]
    f = k13.FAMILY_LAYOUT[family]
    env = dict(_consts(), E=torch.finfo(dtype).bits // 8,
               **{f"F_{k}": v for k, v in z.items()}, F_pw=f["pw"],
               F_scratch=f["scratch"], F_rates=f["rates"])
    env["chain_doubles"] = max(
        na * _eval_struct("ChainSplit", dict(env, W=k13.chain_warps(na)))
        ["size"] for na in range(1, 5))
    return _eval_struct("Smem", env)


@pytest.mark.parametrize("family", k13.FAMILY_NAMES)
@pytest.mark.parametrize("na", (1, 2, 3, 4))
def test_chain_split_matches_the_cuda_source(family, na):
    """The wrapper's `chain_split` is the .cu's `ChainSplit<F, W>` at the
    chain warps the .cu gives na α's, those warps leave the copiers at least
    half the block, and with W > 1 each step's items fit the α's 32W
    threads (one a thread) and each row's parts cover its columns."""
    z = KERNEL_SHAPES[k13.FAMILIES[k13.FAMILY_NAMES.index(family)][2]]
    W = k13.chain_warps(na)
    assert W == {1: 4, 2: 2}.get(na, 1)
    assert re.search(r"return na == 1 \? 4 : na == 2 \? 2 : 1;", SOURCE)
    assert na * W <= k13.WARPS // 2
    env = dict(_consts(), **{f"F_{k}": v for k, v in z.items()}, W=W)
    src = _eval_struct("ChainSplit", env)
    c = k13.chain_split(family, na)
    assert {k: src[k] for k in c if k != "block"} == \
        {k: v for k, v in c.items() if k != "block"}
    if W > 1:
        assert c["rows1"] * c["h1"] <= 32 * W
        assert z["n_ru"] * c["h3"] <= 32 * W
        assert c["len1"] * c["h1"] >= z["nx"] > c["len1"] * (c["h1"] - 1)
        assert c["len3"] * c["h3"] >= z["n_uc"] > c["len3"] * (c["h3"] - 1)


def _source_bytes(family, dtype, ns=NS, nA=4):
    """The block's bytes as the .cu's `phase_region` and `smem_bytes`
    compose them from `Smem`."""
    m = _source_layout(family, dtype)
    r16 = lambda v: -(-v // 16) * 16
    evaluation = 8 * (nA * ns * m["F_rates"] + 2 * nA * (ns + 1)
                      + m["kWarps"] * m["e_warp"])
    return (r16(max(m["chain_bytes"], evaluation))
            + r16((ns + 1) * m["prow"] * m["E"])
            + 8 * nA * (ns + 1) * m["rec"] + m["misc_bytes"])


@pytest.mark.parametrize("family,dtype", CASES,
                         ids=[f"{f}-{str(d)[6:]}" for f, d in CASES])
def test_phase_bytes_match_the_cuda_layout(family, dtype):
    """The wrapper's bytes are the .cu's `Smem` composed, fit a block, and
    in float32 with four α leave the family its launch bound's blocks an
    SM."""
    stated = k13.phase_bytes(family, dtype)
    assert stated["total"] == _source_bytes(family, dtype)
    assert stated["total"] <= SMEM_PER_BLOCK
    layout = _source_layout(family, dtype)
    assert {k: layout[k] for k in k13.layout(family, dtype)} == \
        k13.layout(family, dtype)
    if dtype == torch.float32:
        blocks = SMEM_PER_SM // (stated["total"] + 1024)
        assert blocks >= k13.FAMILY_LAYOUT[family]["min_blocks"]


def test_block_constants_match_the_cuda_source():
    """The wrapper's warps, α's a block and ring depth are the .cu's."""
    consts = _consts()
    assert (consts["kWarps"], consts["kMaxAlphas"], consts["kStages"]) == \
        (k13.WARPS, k13.ALPHAS_A_BLOCK, k13.STAGES)


@pytest.mark.parametrize("family", k13.FAMILY_NAMES)
def test_family_layout_matches_the_headers(family):
    """FAMILY_LAYOUT's parameter row, prepass values, stage point and launch
    bound are what the headers and the .cu's family structs give: the SRBD
    packed row 12 + 2nc and srbd::kRates, the LIP's 4 + 2nc and no prepass,
    the AL shapes' n_par and isrbd::kGeo; a stage point of nx under RK2 and
    RK4; three blocks an SM at the nx = 37 Euler SRBD families, two
    elsewhere."""
    srbd_h = (CSRC / "srbd_common.cuh").read_text()
    isrbd_h = (CSRC / "isrbd_common.cuh").read_text()
    f = k13.FAMILY_LAYOUT[family]
    z = KERNEL_SHAPES[k13.FAMILIES[k13.FAMILY_NAMES.index(family)][2]]
    kind = k13.FAMILIES[k13.FAMILY_NAMES.index(family)][0]
    rk = family.endswith(("rk2", "rk4"))
    nc = 2 if "point_feet" in family else 4
    if kind == "srbd":
        rates = int(re.search(r"constexpr int kRates = (\d+);", srbd_h)[1])
        want = dict(pw=12 + 2 * nc, rates=rates, scratch=z["nx"] if rk else 0,
                    min_blocks=3 if z["nx"] == 37 and not rk else 2)
    elif kind == "lip":
        want = dict(pw=4 + 2 * nc, rates=0, scratch=0, min_blocks=2)
    else:
        shape = "KangarooAlShape" if family == "isrbd_al" else "QuadAlShape"
        n_par = int(re.search(r"struct " + shape + r" \{[^}]*n_par = (\d+)",
                              isrbd_h)[1])
        geo = int(re.search(r"constexpr int kGeo = (\d+);", isrbd_h)[1])
        want = dict(pw=n_par, rates=geo, scratch=0, min_blocks=2)
    assert f == want
    assert "min_blocks = S::nx == 37 && S::Step::stages == 1 ? 3 : 2" in \
        " ".join(SOURCE.split())


# ---- the recursion ----

def _problem(family, dtype=torch.float64):
    """(solver, problem, ALDDP or None) of K13's family on the CPU: the
    SRBD or the LIP problem at its (topology, step), or the AL inner problem
    of an isrbd problem (its serving options)."""
    feet, quad = kangaroo_line_feet(), quadruped_point_feet()
    if family in ("isrbd_al", "isrbd_al_quadruped"):
        if family == "isrbd_al":
            prob = build_isrbd_problem(SRBDConfig(dtype=dtype), feet, device=CPU)
        else:
            prob = build_isrbd_problem(
                SRBDConfig(dtype=dtype, lip_height=float(quad.com[2]),
                           contact_model=1, number_of_legs=4), quad,
                device=CPU)
        al = ALDDP(prob.ocp, *al_serving_options(1))
        return al.inner, prob, al
    lip = family == "lip" or family.startswith("lip_")
    topo, _, step = family.removeprefix("lip_").partition("_rk")
    step = "RK" + step if step else "EULER"
    topo = {"srbd": "kangaroo", "lip": "kangaroo"}.get(topo, topo)
    cfg, robot = {
        "kangaroo": (SRBDConfig(dtype=dtype), feet),
        "quadruped": (SRBDConfig(dtype=dtype, contact_model=1,
                                 number_of_legs=4), quad),
        "point_feet": (SRBDConfig(dtype=dtype, contact_model=1,
                                  number_of_legs=2), point_feet())}[topo]
    build = build_lip_problem if lip else build_srbd_problem
    prob = build(cfg, robot, device=CPU, integrator=step)
    return MSDDP(prob.ocp, DDPOptions()), prob, None


def _draw(family, seed):
    """A drawn trial at the family's sizes: the iterate (X ± 0.05·N around
    the initial state, U 0.1·N), x0 near X₀, the sliced linearization (the
    plain linearizers) and the gains of K12's twin, the merit's D."""
    s, prob, al = _problem(family)
    ocp = prob.ocp
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    g = np.random.RandomState(seed)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    if al is None:
        X = t64(prob.initial_state.numpy()[None, None]
                + 0.05 * g.randn(B, ns + 1, nx))
        U = t64(0.1 * g.randn(B, ns, nu))
        plain = (k10.lip_linearize_plain if s.terms.family == "lip"
                 else k4.srbd_linearize_plain)
        lin = plain(X, U, params, s.terms, s.rows, ocp.dt,
                    s._wc(torch.float64))
    else:
        # a stance with active cones, random multipliers and penalties (the
        # AL inner problem reads them from its parameters)
        X = np.zeros((B, ns + 1, nx))
        X[..., 0:3] = [0.0, 0.0, float(prob.initial_state[2])] + \
            0.05 * g.randn(B, ns + 1, 3)
        X[..., 3:7] = [0.1, -0.2, 0.05, 0.97] + 0.02 * g.randn(B, ns + 1, 4)
        X[..., 7:] = g.uniform(-0.3, 0.3, (B, ns + 1, nx - 7))
        U = 0.5 * g.randn(B, ns, nu)
        for q in range((nu - 6) // 6):
            U[..., 9 + 6 * q:12 + 6 * q] = ([0.0, 0.0, 90.0] + [50.0, 50.0, 5.0]
                                            * g.randn(B, ns, 3))
        X, U = t64(X), t64(U)
        n_eq, n_eq_T, n_in = al._sizes
        pos = lambda *shape: t64(np.abs(g.randn(*shape)))
        st = al.init(X[:, 0])._replace(
            lam_eq=t64(g.randn(B, ns, n_eq)), lam_eq_T=t64(g.randn(B, n_eq_T)),
            mu_ub=5.0 * pos(B, ns, n_in), mu_lb=pos(B, ns, n_in),
            mu_x_ub=pos(B, ns + 1, nx), mu_x_lb=pos(B, ns + 1, nx),
            mu_u_ub=pos(B, ns, nu), mu_u_lb=pos(B, ns, nu),
            rho=t64(10.0 ** g.uniform(3, 5, B)))
        params = {k: v.contiguous() for k, v in
                  al._params_with_multipliers(params, st).items()}
        lin = k5.isrbd_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt)
    sv = "cholesky" if s.terms.family == "isrbd_al" else "schur"
    ks, Ks, dV1, dV2 = k12.riccati_associative_plain(
        *(lin[k] for k in ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")),
        s.opts.mu0, s.rows, sv)
    x0 = X[:, 0] + t64(0.005 * g.randn(B, nx))
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    return dict(s=s, ocp=ocp, X=X, U=U, x0=x0, params=params, lin=lin,
                ks=ks, Ks=Ks, dV1=dV1, dV2=dV2, D=D)


def node_order_trial(x0, X, U, ks, Ks, Sx, Bs, d, alphas, rows):
    """The kernel's recursion, node after node, for every α: x̂ₙ = Xₙ + δx,
    w = Kₙδx, ûₙ = (Uₙ + αkₙ) + w, v = (w + αk)[uc], δxₙ₊₁ = δx + (Sx δx
    on rx) + (Bs v on ru) + αdₙ. Returns Xn (nα, B, ns+1, nx), Un."""
    rx, ru, uc = list(rows.rx), list(rows.ru), list(rows.uc)
    ns = d.shape[1]
    Xs, Us = [], []
    for a in alphas.tolist():
        dx = x0 - X[:, 0]
        xa, ua = [], []
        for n in range(ns):
            xa.append(X[:, n] + dx)
            w = torch.einsum("bij,bj->bi", Ks[:, n], dx)
            ak = a * ks[:, n]
            ua.append((U[:, n] + ak) + w)
            v = (w + ak)[:, uc]
            nxt = dx.clone()
            nxt[:, rx] += torch.einsum("brj,bj->br", Sx[:, n], dx)
            nxt[:, ru] += torch.einsum("brc,bc->br", Bs[:, n], v)
            dx = nxt + a * d[:, n]
        xa.append(X[:, ns] + dx)
        Xs.append(torch.stack(xa, dim=1))
        Us.append(torch.stack(ua, dim=1))
    return torch.stack(Xs), torch.stack(Us)


def _trial_args(p, alphas, merit0):
    s = p["s"]
    return (p["x0"], p["X"], p["U"], p["ks"], p["Ks"], p["lin"]["Sx"],
            p["lin"]["Bs"], p["lin"]["d"], alphas, p["params"], merit0,
            p["D"], p["dV1"], p["dV2"], s.terms, s.rows, p["ocp"].dt,
            s._wc(torch.float64), s.opts.defect_weight, s.opts.beta,
            s.opts.alpha_converge_threshold)


@pytest.fixture(scope="module", params=k13.FAMILY_NAMES)
def draw(request):
    return request.param, _draw(request.param, 18 + k13.FAMILY_NAMES.index(
        request.param))


def test_node_order_recursion_matches_the_scan_tree(draw):
    """The kernel's node-order recursion gives the twin's plans (JAX's
    scan tree of affine maps) to SCAN_TOL relative, output by output."""
    family, p = draw
    alphas = torch.tensor(ALPHAS, dtype=torch.float64)
    rows = p["s"].rows
    nu = p["U"].shape[-1]
    A, Bd = dense_dynamics(p["lin"]["Sx"], p["lin"]["Bs"], rows, nu)
    Xt, Ut = k13.forward_linear_plain(p["x0"], p["X"], p["U"], p["ks"],
                                      p["Ks"], A, Bd, p["lin"]["d"], alphas)
    Xm, Um = node_order_trial(p["x0"], p["X"], p["U"], p["ks"], p["Ks"],
                              p["lin"]["Sx"], p["lin"]["Bs"], p["lin"]["d"],
                              alphas, rows)
    for got, want in ((Xm, Xt), (Um, Ut)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= SCAN_TOL, (family, err)


def test_node_order_flags_match_the_twin_off_the_threshold(draw):
    """On trials whose merit0 sits MARGIN (relative to max(1, |merit|)) off
    the Armijo threshold merit + β·max(expected, 1e-16), on either side by
    member and α, the node-order plans' flags equal the twin's, and both
    take both values."""
    family, p = draw
    s = p["s"]
    alphas = torch.tensor(ALPHAS, dtype=torch.float64)
    args = _trial_args(p, alphas, torch.zeros(B, dtype=torch.float64))
    _, _, _, merit, _ = k13.linear_trial_plain(*args)
    a = alphas[:, None]
    expected = (-(a * p["dV1"] + a ** 2 * p["dV2"])
                + (2.0 * a - a ** 2) * s.opts.defect_weight * p["D"])
    threshold = merit + s.opts.beta * torch.clamp(expected, min=1e-16)
    side = torch.as_tensor(np.where(
        np.random.RandomState(7).rand(*merit.shape) < 0.5, 1.0, -1.0))
    # one merit0 a member: the first α's threshold, shifted; the other α's
    # flags follow from their own merits
    shift = side[0] * MARGIN * torch.clamp(merit[0].abs(), min=1.0)
    merit0 = threshold[0] + shift
    args = _trial_args(p, alphas, merit0)
    Xt, Ut, cost_t, merit_t, ok_t = k13.linear_trial_plain(*args)
    Xm, Um = node_order_trial(*args[:9], s.rows)
    orig = k13.forward_linear_plain
    try:
        k13.forward_linear_plain = lambda *_: (Xm, Um)
        _, _, cost_m, merit_m, ok_m = k13.linear_trial_plain(*args)
    finally:
        k13.forward_linear_plain = orig
    gap = (merit0 - merit_t) - s.opts.beta * torch.clamp(expected, min=1e-16)
    assert bool((gap.abs() >= 0.5 * MARGIN *
                 torch.clamp(merit_t.abs(), min=1.0))[0].all())
    assert torch.equal(ok_m, ok_t)
    assert bool(ok_t[0].any()) and not bool(ok_t[0].all())
