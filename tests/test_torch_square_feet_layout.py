"""PyTorch port, the square-feet biped's lane maps and block sizes, on the
CPU with no JAX.

The square-feet biped (contact_model=4, nc=8) is the first topology whose
sizes pass a warp's 32 lanes: the SRBD has nu=48 inputs and 129 stage rows,
the LIP nx=54 state rows and 76 stage rows. These tests model in torch each
new lane map's order of work, read the maps' constants from the CUDA
sources, and hold them against the plain twins:

  - the SRBD `stage_sq_lane` (K3, srbd_evaluate) past 32 inputs: three
    passes that sum each of the 129 ρ rows on exactly one lane;
  - K3's K(x̂ − X) on rows lane and lane + 32 (four partial sums a row) and
    K4's staging of U: every one of the 48 inputs once;
  - K11's chain a state pair a lane (nx = 54, nu = 27): every state row and
    input row once, each pair's step in its lane's registers equal to the
    problem's step under Euler, RK2 and RK4;
  - the LIP warp map's three rows a lane (K13's `stage_sq_lane`; K11 and
    lip_evaluate take a node a thread) over the 76 rows;
  - K10's Jxp scale field (5 bits) holds the square feet's scales, and
    its fleet groups take one node there;
  - the new `KERNEL_SHAPES` entries of K4/K3, K10/K11 and K1 are
    `RiccatiRows.from_ocp` of each new OCP;
  - K1's and K3's blocks as their sources reckon them fit the card's
    232,448 B in float32 and float64;
  - the execution modes at contact_model=4 are refused for both problems.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _square_feet import SQUARE_TOPOLOGY, square_feet
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

F64 = torch.float64
CSRC = Path(k4.__file__).resolve().parents[1] / "csrc"
SRBD_H = (CSRC / "srbd_common.cuh").read_text()
LIP_H = (CSRC / "lip_common.cuh").read_text()
K3_SRC = (CSRC / "srbd_rollout.cu").read_text()
K4_SRC = (CSRC / "srbd_linearize.cu").read_text()
K11_SRC = (CSRC / "lip_rollout.cu").read_text()
K10_SRC = (CSRC / "lip_linearize.cu").read_text()
STEPS = ("EULER", "RK2", "RK4")
SMEM_PER_BLOCK = 232_448       # an H100 block's opt-in shared memory


def _flat(src):
    return " ".join(src.split())


def _problem(build, step="EULER", ns=4):
    prob = build(SRBDConfig(dtype=F64, ns=ns, **SQUARE_TOPOLOGY),
                 square_feet(), integrator=step, device="cpu")
    return prob, MSDDP(prob.ocp, DDPOptions())


@pytest.fixture(scope="module")
def srbd():
    return _problem(build_srbd_problem)


def _srbd_point(prob, seed, lead=(5,)):
    """Drawn (x, u, p) of the SRBD problem: states around the nominal one,
    inputs around the static input, random references, 0/1 switches and
    tracking masks."""
    g = np.random.RandomState(seed)
    nx, nu, nc = prob.ocp.nx, prob.ocp.nu, prob.nc
    x = prob.initial_state.numpy() + 0.05 * g.randn(*lead, nx)
    u = prob.static_input.numpy() + 0.3 * g.randn(*lead, nu)
    p = {k: v[0].numpy() + 0.1 * np.abs(g.randn(*lead, v.shape[-1]))
         for k, v in prob.ocp.params.items()}
    p["cdot_switch"] = g.randint(0, 2, lead + (nc,)).astype(np.float64)
    p["mask_track"] = g.randint(0, 2, lead + (1,)).astype(np.float64)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    return t(x), t(u), {k: t(v) for k, v in p.items()}


# ---------------- the SRBD stage rows past 32 inputs ----------------

def srbd_lane_rows(lane, nc, nu, n_rho):
    """The ρ rows lane `lane` of a warp sums in `srbd::stage_sq_lane` past
    32 inputs (csrc/srbd_common.cuh), in its order: the input rows of
    columns lane and lane + 32 (c̈: one row; a force: its magnitude row and
    its switch row), then a tracking row (lanes 0-14), an r̈ / ω̇ row
    (15-20) or one of the first eq2 = 11 equality rows (21-31), then
    equality row eq2 + lane while any are left."""
    n_res = 21 + 9 * nc
    n_eq = n_rho - n_res
    eq2 = min(n_eq, 32 - 21)

    def inputs(col):
        q, a = col // 6, col % 6
        if a < 3:
            return [21 + 3 * q + a]
        return [21 + 3 * nc + 3 * q + a - 3, 21 + 6 * nc + 3 * q + a - 3]

    rows = inputs(lane) + (inputs(lane + 32) if lane + 32 < nu else [])
    if lane < 21:
        rows.append(lane)                      # tracking rows, then r̈ and ω̇
    elif lane < 21 + eq2:
        rows.append(n_res + lane - 21)
    if lane < n_eq - eq2:
        rows.append(n_res + eq2 + lane)
    return rows


def test_srbd_stage_rows_map_matches_the_source():
    """The three passes as the header writes them: both input columns of a
    lane, 11 equality rows on lanes 21-31, then one a lane."""
    src = _flat(SRBD_H)
    for text in ("if constexpr (S::nu > 32) {",
                 "constexpr int eq2 = n_eq < 32 - 21 ? n_eq : 32 - 21;",
                 "T acc = input_sq<S>(lane, u, p, k);",
                 "if (lane + 32 < S::nu) acc += input_sq<S>(lane + 32, u, p, k);",
                 "} else if (lane < 21 + eq2) { const T v = eq_row<S>(lane - 21, x, p, k);",
                 "if (lane < n_eq - eq2) { const T v = eq_row<S>(eq2 + lane, x, p, k);"):
        assert text in src, text


def test_srbd_stage_rows_each_once(srbd):
    """Over the warp's 32 lanes every one of the 129 stage rows is summed
    exactly once, and the lanes' sums add to ‖ρ‖² of the twin's stacked
    residual at drawn points."""
    prob, s = srbd
    nc, nu, n_rho = prob.nc, prob.ocp.nu, s.terms.n_rho
    assert (nu, n_rho) == (48, 129)
    seen = sorted(r for lane in range(32)
                  for r in srbd_lane_rows(lane, nc, nu, n_rho))
    assert seen == list(range(n_rho))
    x, u, p = _srbd_point(prob, seed=3)
    rho = s._stage_rho(x, u, p)
    lanes = torch.stack([
        (rho[..., srbd_lane_rows(lane, nc, nu, n_rho)] ** 2).sum(-1)
        for lane in range(32)], dim=-1)
    want = (rho * rho).sum(-1)
    assert torch.allclose(lanes.sum(-1), want, rtol=1e-13, atol=0)


# ---------------- K3's and K4's inputs past 32 ----------------

def test_inputs_take_two_rounds_of_lanes():
    """K3 takes rows lane and lane + 32 of K(x̂ − X) (`kInputRounds` rounds)
    and K4 stages U with a loop stepping by 32: each of the 48 inputs is
    one lane's, once."""
    assert "constexpr int kInputRounds = (S::nu + 31) / 32;" in K3_SRC
    assert "for (int c = 0; c < kInputRounds<S>; ++c) {" in K3_SRC
    assert ("for (int j = lane; j < nu; j += 32) // nu = 48 takes two rounds "
            "sw[C::wU + j] = U[(b * ns + n) * nu + j];") in _flat(K4_SRC)
    nu = k4.KERNEL_SHAPES["square_feet"]["nu"]
    rounds = (nu + 31) // 32
    got = sorted(lane + 32 * c for lane in range(32) for c in range(rounds)
                 if lane + 32 * c < nu)
    assert got == list(range(nu))
    staged = sorted(j for lane in range(32) for j in range(lane, nu, 32))
    assert staged == list(range(nu))


def test_trial_rows_of_u_match_the_twin(srbd):
    """uₙ = (Uₙ + α kₙ) + K(x̂ − X) with each row formed as K3 forms it
    (four partial sums over the nx columns, the rows of lanes 0-31 then
    32-47) equals the twin's to rounding."""
    prob, _ = srbd
    nx, nu = prob.ocp.nx, prob.ocp.nu
    g = np.random.RandomState(9)
    t = lambda *shape: torch.as_tensor(g.randn(*shape), dtype=F64)
    K, dx, U, kk, alpha = t(nu, nx), t(nx), t(nu), t(nu), 0.5
    rows = []
    for c in range((nu + 31) // 32):
        for lane in range(32):
            i = lane + 32 * c
            if i >= nu:
                continue
            s4 = [torch.zeros((), dtype=F64) for _ in range(4)]
            for j in range(nx // 4 * 4):
                s4[j % 4] = s4[j % 4] + K[i, j] * dx[j]
            for j in range(nx // 4 * 4, nx):
                s4[0] = s4[0] + K[i, j] * dx[j]
            rows.append((i, (U[i] + alpha * kk[i])
                         + ((s4[0] + s4[1]) + (s4[2] + s4[3]))))
    assert [i for i, _ in rows] == list(range(nu))
    got = torch.stack([v for _, v in rows])
    want = U + alpha * kk + K @ dx
    assert torch.allclose(got, want, rtol=1e-13, atol=1e-13)


# ---------------- K11's chain: a state pair a lane ----------------

@pytest.fixture(scope="module", params=STEPS)
def lip(request):
    return _problem(build_lip_problem, request.param)


def test_chain_pairs_match_the_source():
    src = _flat(K11_SRC)
    assert "constexpr bool kPairs = (S::nx > 32);" in src
    assert ("(kPairs<S> ? kHalf <= 32 && nu == kHalf : nx <= 32 && 2 * nu "
            "<= 32)") in src
    assert "const int i = lane < kHalf ? lane : kHalf - 1;" in src


def chain_pairs_step(x, u, terms, dt, step):
    """The step of K11's pair-a-lane chain (`chain_node_pairs`), pair i on
    lane i: the position's rate is the velocity, the velocity's
    η²(r − z) − g e_z (i < 3) or c̈ = u; the stages as that function forms
    them; (x⁺ without the defect term)."""
    h = x.shape[-1] // 2
    p, v = x[..., :h], x[..., h:]
    i = torch.arange(h)

    def accel(ps):
        a = terms.eta2 * (ps - u)
        a = torch.where(i == 2, a - 9.81, a)
        return torch.where(i < 3, a, u)

    kp, kv = v, accel(p)
    if step == "EULER":
        return torch.cat([p + dt * kp, v + dt * kv], dim=-1)
    stages = 2 if step == "RK2" else 4
    sp, sv = kp, kv
    for s in range(1, stages):
        cdt = dt if (stages == 4 and s == 3) else 0.5 * dt
        ps, vs = p + cdt * kp, v + cdt * kv
        kp, kv = vs, accel(ps)
        if stages == 4:
            sp = sp + kp if s == 3 else sp + 2 * kp
            sv = sv + kv if s == 3 else sv + 2 * kv
    if stages == 4:
        return torch.cat([p + (dt / 6) * sp, v + (dt / 6) * sv], dim=-1)
    return torch.cat([p + dt * kp, v + dt * kv], dim=-1)


def test_chain_pairs_cover_rows_and_step_in_lane(lip):
    """Lane i < 27 holds state rows i and i + 27 and input row i: every
    state and input row once; the pair's step in the lane's registers is
    the problem's step (`ocp.step`) under each step to rounding."""
    prob, s = lip
    nx, nu = prob.ocp.nx, prob.ocp.nu
    h = nx // 2
    assert (nx, nu, h) == (54, 27, 27)
    state = sorted(r for lane in range(h) for r in (lane, lane + h))
    assert state == list(range(nx))
    assert sorted(range(h)) == list(range(nu))
    g = np.random.RandomState(11)
    x = prob.initial_state + torch.as_tensor(0.1 * g.randn(6, nx), dtype=F64)
    u = prob.static_input + torch.as_tensor(0.3 * g.randn(6, nu), dtype=F64)
    p = {k: v[0].expand(6, -1) for k, v in prob.ocp.params.items()}
    want = prob.ocp.step(x, u, p, prob.ocp.dt)
    got = chain_pairs_step(x, u, s.terms, prob.ocp.dt, s.terms.step)
    assert torch.allclose(got, want, rtol=1e-13, atol=1e-13)


# ---------------- the LIP warp map and K10's Jxp scales ----------------

def test_lip_warp_rows_cover_76_rows():
    """K13's warp map (`lip::stage_sq_lane`) takes rows lane + 32c for c <
    kRowsALane: three at the square feet's 76 rows, each row once (K11 and
    lip_evaluate evaluate a node a thread, `lip::stage_sq`)."""
    assert ("constexpr int kRowsALane = (S::n_rho + 31) / 32 < 2 ? 2 : "
            "(S::n_rho + 31) / 32;") in _flat(LIP_H)
    n_rho = k10.KERNEL_SHAPES["square_feet"]["n_rho"]
    per = max(2, (n_rho + 31) // 32)
    assert (n_rho, per) == (76, 3)
    got = sorted(lane + 32 * c for lane in range(32) for c in range(per)
                 if lane + 32 * c < n_rho)
    assert got == list(range(n_rho))


def test_k10_jxp_scales_fit_their_field():
    """K10 packs each Jxp value's scale in 5 bits and its node in the group
    in 3: the square feet's scales (1 + the packed row's switch entries, up
    to 20) and groups (4 nodes) fit."""
    src = _flat(K10_SRC)
    assert "jxp_scale<S>(gx[r]) | (w << 5)" in src
    assert "const int sid = bits & 31, w = (bits >> 5) & 7;" in src
    assert 'static_assert(G % V == 0 && G <= 8,' in src
    z = k10.KERNEL_SHAPES["square_feet"]
    nc = z["nc"]
    cs = 4 + nc                        # lip::Param<S>::cs
    assert 1 + cs + nc - 1 < 32        # the largest scale
    assert k10.vec_nodes(torch.float32) * k10.GROUP_UNITS <= 8


def test_k10_square_feet_groups():
    """A fleet's K10 groups at the square feet: one node (the .cu's
    `kVecGroup`: its 16-byte groups spilled at the 128 registers a
    512-thread block leaves), where the other shapes take four in float32
    and two in float64; the launch and the occupancy query take the same
    group, and the launch bound is one block an SM past 32 state rows."""
    src = _flat(K10_SRC)
    assert "constexpr int kVecGroup = S::nx > 32 ? 1 : kGroupNodes<T>;" in src
    assert "return launch_groups<S, T, kVecGroup<S, T>>(" in src
    assert "occupancy<S, float, kVecGroup<S, float>>(out)" in src
    assert "constexpr int kBoundBlocks = S::nx > 32 ? 1 : kMinBlocks;" in src
    assert "__launch_bounds__(kSlotThreads, kBoundBlocks<S>)" in src
    f32, big = torch.float32, 512
    assert k10.schedule(big, 20, f32, 132, "square_feet")[0] == 1
    assert k10.schedule(big, 20, F64, 132, "square_feet_rk2")[0] == 1
    assert k10.schedule(big, 20, f32, 132, "kangaroo")[0] == 4
    assert k10.schedule(big, 20, F64, 132, "kangaroo")[0] == 2
    assert k10.schedule(1, 20, F64, 132, "square_feet")[0] == 1


# ---------------- the compiled sizes ----------------

@pytest.mark.parametrize("step", STEPS)
def test_kernel_shapes_are_the_problems_rows(step):
    """The new instances of K4/K3 and K10/K11 and K1's new shapes are
    `RiccatiRows.from_ocp` of the square feet's OCPs under each step."""
    for build, table, k1_shape in ((build_srbd_problem, k4, "square_feet"),
                                   (build_lip_problem, k10, "lip_square_feet")):
        prob, s = _problem(build, step)
        ocp = prob.ocp
        rows = RiccatiRows.from_ocp(ocp)
        assert rows == s.rows
        name = "square_feet" + ("" if step == "EULER" else "_" + step.lower())
        want = table.KERNEL_SHAPES[name]
        assert table.check_kernel_shape("t", s.terms, ocp.nx, ocp.nu,
                                        rows) == name
        assert (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu)) == (
            want["n_rx"], want["n_ru"], want["n_gx"], want["n_gu"])
        nt = want["nt"]
        shape = k1_shape + ("" if step == "EULER" else "_rk")
        assert k1.kernel_shape(ocp.nx, ocp.nu, nt, rows) == shape
        assert k1.kernel_sizes(ocp.nx, ocp.nu, nt, rows) == \
            k1.KERNEL_SHAPES[shape]


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_blocks_fit_the_card(dtype):
    """K1's block (csrc/riccati_backward.cu's `Layout`, `layout_bytes`) at
    the square feet's four shapes and K3's (`trial_layout`: four warps in
    float32, two in float64) fit 232,448 B; the figures the sources'
    comments and PERF.md record (the Kangaroo's 53,544 / 68,040 B for K1,
    51,136 B for K3 in float32) stand."""
    want = {torch.float32: dict(square_feet=159_336, square_feet_rk=177_316,
                                lip_square_feet=96_964,
                                lip_square_feet_rk=105_816, srbd=53_544),
            F64: dict(square_feet=202_312, square_feet_rk=226_244,
                      lip_square_feet=121_372, lip_square_feet_rk=133_144,
                      srbd=68_040)}[dtype]
    for shape, n in want.items():
        assert k1.layout_bytes(shape, dtype) == n <= SMEM_PER_BLOCK, shape
    for inst in ("square_feet", "square_feet_rk2", "square_feet_rk4"):
        lay = k3.trial_layout(dtype, inst)
        assert lay["bytes"] <= SMEM_PER_BLOCK
        assert lay["warps"] == (4 if dtype == torch.float32 else 2)
        assert lay["bytes"] == lay["warps"] * lay["warp_values"] * (
            torch.finfo(dtype).bits // 8)
    assert k3.trial_layout(torch.float32, "kangaroo")["bytes"] == 51_136
    src = _flat(K3_SRC)
    assert ("return 4 * warp_bytes <= kMaxSmem ? 4 : 2 * warp_bytes <= "
            "kMaxSmem ? 2 : 1;") in src
    assert "constexpr size_t kMaxSmem = 232448;" in src


# ---------------- the execution modes stay refused ----------------

@pytest.mark.parametrize("build", [build_srbd_problem, build_lip_problem],
                         ids=["srbd", "lip"])
@pytest.mark.parametrize("mode", [dict(riccati_mode="associative"),
                                  dict(forward_pass="linear")],
                         ids=["associative", "linear"])
def test_modes_refused_at_contact_model_4(build, mode):
    """K12 and K13 have no kernel at the square feet: MSDDP refuses both
    problems on every device, naming both and ROADMAP.md."""
    prob = build(SRBDConfig(dtype=F64, ns=4, **SQUARE_TOPOLOGY),
                 square_feet(), device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"the SRBD and the LIP at contact_model 3 or 4"
                             r".*ROADMAP\.md"):
        MSDDP(prob.ocp, DDPOptions(**mode))
