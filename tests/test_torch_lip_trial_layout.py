"""PyTorch port, K11's block layout and its order of work, on the CPU.

The card runs K11 (`lip_trial_kernel` in `csrc/lip_rollout.cu`); here no
CUDA compiler exists. These tests hold what the wrapper states about the
kernel against the source itself: at each (topology, step) instance of
`lip_linearize.KERNEL_SHAPES`, for float32 and float64 tensors and 1-4
step sizes a call, the shared memory a block takes (`smem_bytes`, ns = 20,
region by region) against the .cu's `regions` evaluated from its text,
within the 232,448 B a block may take, and, in float32, the blocks an SM
the kernel's launch bound asks for within the 233,472 B of an SM (1 KB a
block reserved); the wrapper's block constants (α's a block, nodes a piece
of K, ring slots, the block limit) against the source. Then
`kernel_order_trial`, a torch model of the kernel's order of work — the
chain node after node for every α, x̂ₙ₊₁ = step(x̂, u) − (1 − α)dₙ
with u = (U + αk) + K(x̂ − X), the step's stages row by row from the
partner row (row j ± nx/2) as the chain's lanes take them, then each
node's ‖ρ‖² on its own, the stage nodes added in node order and the
terminal node last, then the merit and the Armijo test — at each
instance's sizes (ns = 20, four α, drawn plans,
references, switches and masks linearized by the plain linearizer, the
gains of K1's twin): its outputs agree with `lip_trial_plain` to 1e-12
relative, and, on trials whose merit0 is drawn MARGIN (relative) off the
Armijo threshold on either side, its flags equal the twin's. No JAX, no
compile.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _line_feet_quadruped import LINE_FEET_TOPOLOGY, line_feet_quadruped
from _square_feet import SQUARE_TOPOLOGY, square_feet
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels.rollout import armijo_plain
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet, point_feet
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
CSRC = Path(k11.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "lip_rollout.cu").read_text()
HEADER = (CSRC / "lip_common.cuh").read_text()
SMEM_PER_BLOCK = 232_448  # an H100's shared memory a block may take
SMEM_PER_SM = 233_472     # and an SM's (each block also holds 1 KB of it)
NS = 20                   # the horizon of every configuration
ALPHAS = (1.0, 0.5, 0.25, 0.125)
B = 3                     # members a draw
ORDER_TOL = 1e-12         # the model's outputs against the twin's, relative
MARGIN = 1e-6             # merit0's distance from the Armijo threshold,
                          # relative to max(1, |merit|)
ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
DTYPES = (torch.float32, torch.float64)
SHAPES = tuple(k10.KERNEL_SHAPES)
CASES = [(d, nA, sh) for sh in SHAPES for d in DTYPES for nA in (1, 2, 3, 4)]
# each topology's SRBDConfig fields and robot
LIP_TOPOLOGIES = {
    "kangaroo": (dict(), kangaroo_line_feet),
    "quadruped": (dict(contact_model=1, number_of_legs=4), quadruped_point_feet),
    "point_feet": (dict(contact_model=1, number_of_legs=2), point_feet),
    "square_feet": (SQUARE_TOPOLOGY, square_feet),
    "line_feet_quadruped": (LINE_FEET_TOPOLOGY, line_feet_quadruped),
}


def lip_problem(shape):
    """The LIP problem of the instance `shape` on the CPU in float64."""
    topology, _, rk = shape.partition("_rk")
    kw, robot = LIP_TOPOLOGIES[topology]
    return build_lip_problem(SRBDConfig(dtype=F64, **kw), robot(),
                             integrator="RK" + rk if rk else "EULER",
                             device=CPU)


def _env(shape="kangaroo"):
    """The .cu's namespace-scope `constexpr int` constants, evaluated with
    the instance's sizes (`KERNEL_SHAPES`) and the header's packed row
    width."""
    z = k10.KERNEL_SHAPES[shape]
    pw = re.search(r"static constexpr int pw = ([^;]+);", HEADER)[1]
    env = dict(nx=z["nx"], nu=z["nu"], nc=z["nc"])
    env["kPw"] = int(eval(pw.split("//")[0], {}, env))
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", SOURCE,
                                 re.M):
        if "S::" in expr:               # a template of the shape
            continue
        py = re.sub(r"(?<!/)/(?!/)", "//", expr.replace("L::pw", "L_pw"))
        env[name] = int(eval(py, {}, env))
    return env


def _source_regions(dtype, ns, nA, shape="kangaroo"):
    """The .cu's `regions<S, E>(ns, na)` run from its text (its statements
    read as Python, the shape's sizes given): each region's bytes (the
    next offset less its own) and the total."""
    body = re.search(r"constexpr Regions regions\(int ns, int na\) \{\n(.*?)\n\}",
                     SOURCE, re.S)[1]
    z = k10.KERNEL_SHAPES[shape]
    body = body.replace("for (int q = 0; q < lip::kParams; ++q)", "for q in range(4):")
    py = []
    for line in body.split(";"):
        line = " ".join(line.split())
        if not line or line.startswith(("Regions r", "return",
                                         "constexpr int nx = S::nx")):
            continue
        line = re.sub(r"static_cast<size_t>\(([^()]*)\)", r"(\1)", line)
        line = re.sub(r"r\.(\w+)", r"r['\1']", line)
        py.append(line.replace("lip::param_dim<S>(q)", "pdim[q]"))
    env = dict(_env(shape), ns=ns, na=min(nA, 4), E=torch.finfo(dtype).bits // 8,
               pdim=(1, 3, z["nc"], z["nc"]), r={},
               round16=lambda v: -(-v // 16) * 16, cmax=max)
    exec("\n".join(py), env)
    r = env["r"]
    order = ("ring", "X", "d", "U", "k", "par", "prm", "rec", "bar", "total")
    sizes = {f: r[nxt] - r[f] for f, nxt in zip(order, order[1:])}
    sizes["total"] = r["total"]
    return sizes


@pytest.mark.parametrize("dtype,nA,shape", CASES,
                         ids=[f"{sh}-{str(d)[6:]}-{n}a" for d, n, sh in CASES])
def test_smem_bytes_match_the_cuda_layout(dtype, nA, shape):
    """The wrapper's bytes are the .cu's `regions`, region by region, and
    fit a block; in float32 the block leaves the blocks an SM the launch
    bound asks for."""
    stated = k11.smem_bytes(dtype, NS, nA, shape)
    assert stated == _source_regions(dtype, NS, nA, shape)
    assert sum(v for k, v in stated.items() if k != "total") == stated["total"]
    assert stated["total"] <= SMEM_PER_BLOCK == k11.MAX_SMEM
    if dtype == torch.float32:
        # the eight-contact robots' chains, a pair a lane, are bound to two
        want = (2 if k10.KERNEL_SHAPES[shape]["nc"] == 8
                else _env()["kMinBlocks"])
        assert SMEM_PER_SM // (stated["total"] + 1024) >= want


def test_runs_leave_room_for_their_shift():
    """Each staged run's region holds the run and 16 bytes more (it lands
    at its source's offset within 16 bytes), a ring slot a piece of K and
    16 bytes; a piece is a 16-byte multiple long in both types, so every
    piece of a member keeps the first one's offset; after the chain the
    ring holds the node sums; at every instance."""
    for shape in SHAPES:
        _room_for_shift(shape)


def _room_for_shift(shape):
    z = k10.KERNEL_SHAPES[shape]
    for dtype in DTYPES:
        E = torch.finfo(dtype).bits // 8
        for nA in (1, 4):
            r = k11.smem_bytes(dtype, NS, nA, shape)
            assert r["ring"] >= k11.RING * (k11.PIECE_NODES * z["nu"] * z["nx"] * E + 16)
            assert r["ring"] >= min(nA, 4) * (NS + 1) * E
            assert r["prm"] >= (NS + 1) * (4 + 2 * z["nc"]) * E
            assert r["X"] >= (NS + 1) * z["nx"] * E + 16
            assert r["U"] == r["k"] >= NS * z["nu"] * E + 16
            assert r["par"] >= (NS + 1) * (4 + 2 * z["nc"]) * E + 4 * 16
        assert k11.PIECE_NODES * z["nu"] * z["nx"] * E % 16 == 0


def test_block_constants_match_the_cuda_source():
    """The wrapper's α's a block, nodes a piece of K, ring slots and block
    limit are the .cu's; a block is a warp an α and the copier warp."""
    env = _env()
    assert (env["kMaxAlphas"], env["kPieceNodes"], env["kRing"]) == \
        (k11.MAX_ALPHAS, k11.PIECE_NODES, k11.RING)
    assert re.search(r"constexpr size_t kMaxSmem = (\d+);", SOURCE)[1] == \
        str(k11.MAX_SMEM)
    assert "kernel<<<blocks, 32 * (alphas_a_block(nA) + 1), bytes," in SOURCE
    assert ("__launch_bounds__(32 * (kMaxAlphas + 1), kTrialMinBlocks<S>)"
            in SOURCE)
    # the Euler chains take kMinBlocks, the RK chains 4, a pair a lane (the
    # square feet's nx = 54) 2
    assert re.search(r"kTrialMinBlocks = kPairs<S> \? 2\s+: S::Step::stages "
                     r"> 1 \? 4 : kMinBlocks;", SOURCE)
    assert re.search(r"constexpr bool kPairs = \(S::nx > 32\);", SOURCE)


@pytest.mark.parametrize("nA", (1, 2, 3, 4, 5, 8))
def test_alphas_a_block_match_the_cuda_source(nA):
    """α's a block are the .cu's rule; more α's take more blocks of the
    member."""
    assert "return nA < kMaxAlphas ? nA : kMaxAlphas;" in " ".join(SOURCE.split())
    assert k11.alphas_a_block(nA) == min(nA, 4)
    groups = -(-nA // k11.MAX_ALPHAS)
    assert (groups - 1) * k11.MAX_ALPHAS < nA <= groups * k11.MAX_ALPHAS


# ---- the order of work ----

def _draw(seed, shape):
    """A drawn trial at the instance's sizes: X, U near the initial state
    and static input, random references, 0/1 switches and masks, x0 near
    X₀, the plain linearization, the gains of K1's twin, the merit's D."""
    prob = lip_problem(shape)
    s, ocp = MSDDP(prob.ocp, DDPOptions()), prob.ocp
    ns, nx, nu, nc = ocp.ns, ocp.nx, ocp.nu, prob.nc
    assert ns == NS
    g = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    X = t(prob.initial_state.numpy()[None, None] + 0.03 * g.randn(B, ns + 1, nx))
    U = t(prob.static_input.numpy()[None, None] + 0.1 * g.randn(B, ns, nu))
    params = dict(rdot_ref=t(0.3 * g.randn(B, ns + 1, 3)),
                  c_ref=t(0.05 * np.abs(g.randn(B, ns + 1, nc))),
                  cdot_switch=t(g.randint(0, 2, (B, ns + 1, nc))),
                  mask_track=t(g.randint(0, 2, (B, ns + 1, 1))))
    lin = k10.lip_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt,
                                  s._wc(F64))
    ks, Ks, dV1, dV2 = k1.riccati_backward_plain(
        *(lin[k] for k in ORDER), s.opts.mu0, s.rows)
    x0 = X[:, 0] + t(0.005 * g.randn(B, nx))
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    return dict(s=s, ocp=ocp, X=X, U=U, x0=x0, params=params, d=lin["d"],
                ks=ks, Ks=Ks, dV1=dV1, dV2=dV2, D=D)


def _args(p, merit0):
    s = p["s"]
    return (p["x0"], p["X"], p["U"], p["ks"], p["Ks"], p["d"],
            torch.tensor(ALPHAS, dtype=F64), p["params"], merit0, p["D"],
            p["dV1"], p["dV2"], s.terms, p["ocp"].dt, s._wc(F64),
            s.opts.defect_weight, s.opts.beta,
            s.opts.alpha_converge_threshold)


def chain_step(terms, dt, xh, u):
    """The step as the chain's lanes take it: lane j's ẋ at each stage
    point from its partner lane j ± nx/2 (the pair's other row; u of lane
    j − nx/2), the stage point x̂ + c_s·dt·k_{s−1} on every lane, the k's
    summed as ocp/integrators.py sums them."""
    nx = xh.shape[-1]
    h = nx // 2
    partner = torch.cat([torch.arange(h, nx), torch.arange(0, h)])
    up = u[..., torch.arange(nx) % h]

    def rate(xs):
        xo = xs[..., partner]
        acc = terms.eta2 * (xo - up)
        acc = torch.where(torch.arange(nx) == h + 2, acc - 9.81, acc)
        return torch.where(torch.arange(nx) < h, xo,
                           torch.where(torch.arange(nx) < h + 3, acc, up))
    k = rate(xh)
    if terms.step == "EULER":
        return xh + dt * k
    acc = k
    cs = (0.5,) if terms.step == "RK2" else (0.5, 0.5, 1.0)
    for s, c in enumerate(cs, start=1):
        k = rate(xh + (c * dt) * k)
        if terms.step == "RK4":
            acc = acc + k if s == 3 else acc + 2.0 * k
    if terms.step == "RK2":
        return xh + dt * k
    return xh + (dt / 6.0) * acc


def kernel_order_trial(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1,
                       dV2, terms, dt, wc, nu_w, beta, alpha_min):
    """K11's order of work: for every α the chain node after node (the
    step as `chain_step`), then each node's ‖ρ‖² alone, the stage nodes
    added in node order, the terminal node last, then the merit and the
    Armijo test. The twin's arguments and outputs."""
    ns = d.shape[1]
    Xs, Us, costs = [], [], []
    for a in alphas.tolist():
        xh, xa, ua = x0, [], []
        for n in range(ns):
            u = (U[:, n] + a * ks[:, n]) + torch.einsum(
                "bij,bj->bi", Ks[:, n], xh - X[:, n])
            xa.append(xh)
            ua.append(u)
            xh = chain_step(terms, dt, xh, u) - (1.0 - a) * d[:, n]
        xa.append(xh)
        Xa, Ua = torch.stack(xa, dim=1), torch.stack(ua, dim=1)
        p_stage = {k: v[:, :ns] for k, v in params.items()}
        rho = terms.stage_rho(Xa[:, :ns], Ua, p_stage, wc)
        node = torch.sum(rho * rho, dim=-1)                  # (B, ns)
        rt = terms.terminal_residual(Xa[:, ns],
                                     {k: v[:, ns] for k, v in params.items()})
        cost = torch.zeros_like(node[:, 0])
        for n in range(ns):
            cost = cost + node[:, n]
        costs.append(cost + torch.sum(rt * rt, dim=-1))
        Xs.append(Xa)
        Us.append(Ua)
    cost = torch.stack(costs)
    merit, ok = armijo_plain(cost, alphas, merit0, D, dV1, dV2, nu_w, beta,
                             alpha_min)
    return torch.stack(Xs), torch.stack(Us), cost, merit, ok


@pytest.fixture(scope="module", params=SHAPES)
def draw(request):
    return _draw(19, request.param)


def test_kernel_order_matches_the_twin(draw):
    """The kernel's order of work gives the twin's plans, costs and merits
    to ORDER_TOL relative, output by output, at ns = 20 with four α."""
    args = _args(draw, torch.zeros(B, dtype=F64))
    want = k11.lip_trial_plain(*args)
    got = kernel_order_trial(*args)
    for g, w in zip(got[:4], want[:4]):
        assert bool(torch.isfinite(w).all())
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= ORDER_TOL, err


def test_kernel_order_flags_match_the_twin_off_the_threshold(draw):
    """On trials whose merit0 sits MARGIN (relative to max(1, |merit|))
    off the Armijo threshold merit + β·max(expected, 1e-16), on either side
    by member, the kernel order's flags equal the twin's, and both take
    both values."""
    p, s = draw, draw["s"]
    _, _, _, merit, _ = k11.lip_trial_plain(*_args(p, torch.zeros(B, dtype=F64)))
    a = torch.tensor(ALPHAS, dtype=F64)[:, None]
    expected = (-(a * p["dV1"] + a ** 2 * p["dV2"])
                + (2.0 * a - a ** 2) * s.opts.defect_weight * p["D"])
    threshold = merit + s.opts.beta * torch.clamp(expected, min=1e-16)
    side = torch.as_tensor(np.where(
        np.random.RandomState(7).rand(B) < 0.5, 1.0, -1.0))
    side[0], side[1] = 1.0, -1.0
    # one merit0 a member: the first α's threshold, shifted; the other α's
    # flags follow from their own merits
    merit0 = threshold[0] + side * MARGIN * torch.clamp(merit[0].abs(),
                                                        min=1.0)
    args = _args(p, merit0)
    _, _, _, merit_t, ok_t = k11.lip_trial_plain(*args)
    _, _, _, merit_m, ok_m = kernel_order_trial(*args)
    gap = (merit0 - merit_t) - s.opts.beta * torch.clamp(expected, min=1e-16)
    assert bool((gap[0].abs() >= 0.5 * MARGIN *
                 torch.clamp(merit_t[0].abs(), min=1.0)).all())
    assert torch.equal(ok_m, ok_t)
    assert bool(ok_t[0].any()) and not bool(ok_t[0].all())
