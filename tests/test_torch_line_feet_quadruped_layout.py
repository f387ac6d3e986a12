"""PyTorch port, the line-feet quadruped's compiled sizes, row maps and
block sizes, on the CPU with no JAX.

The line-feet quadruped (contact_model=2 on four legs: two contact points
a foot, nc=8) has the square-feet biped's nx and nu (the SRBD 61 and 48,
the LIP 54 and 27), so it runs on the lane maps that biped brought, but
its rows differ: 8 relative-velocity rows over four legs, not 12 over two,
so 125 / 72 stage rows and four fewer rows of G, and its tracking rows
pair other feet. These tests hold, against the CUDA sources and the plain
twins:

  - the shape structs (`srbd::`, `lip::LineFeetQuadShape` and K1's four
    structs) against the Python tables and the sizes the row formulas
    give, and the tables against `RiccatiRows.from_ocp` under each step;
  - the foot pairs of the tracking rows (`rel_cols`: c0 with c2, c1 with
    c7) and the relative-velocity rows (`eq_row`: each leg's front point
    less its back point), modelled from the sources, against the twins'
    residual rows at drawn points;
  - the SRBD `stage_sq_lane`'s three passes and the LIP's three rows a
    lane, each of the 125 / 72 rows once;
  - K10's Jxp scale field holds this robot's scales and its fleet groups
    take one node;
  - K1's, K3's and lip_evaluate's blocks fit the card's 232,448 B in
    float32 and float64;
  - the execution modes (ROADMAP Queue 2 row 12) and the isrbd path (row
    13) refuse this robot, naming nc=8, before any launch.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _line_feet_quadruped import (LINE_FEET_TOPOLOGY, line_feet_quadruped,
                                  line_feet_trot_mask)
from test_torch_square_feet_layout import SMEM_PER_BLOCK, srbd_lane_rows
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows
from srbd_horizon_tpu_torch.models.quadruped import trot_group_mask
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

F64 = torch.float64
CSRC = Path(k4.__file__).resolve().parents[1] / "csrc"
SRBD_H = (CSRC / "srbd_common.cuh").read_text()
LIP_H = (CSRC / "lip_common.cuh").read_text()
K1_H = (CSRC / "riccati_common.cuh").read_text()
K10_SRC = (CSRC / "lip_linearize.cu").read_text()
STEPS = ("EULER", "RK2", "RK4")
TOPOLOGY = "line_feet_quadruped"
# the sizes the row formulas give (problems/srbd.py, problems/lip.py), K1's
# (nt, n_rx, n_ru, n_gx, n_gu) under Euler / RK
SIZES = {"srbd": dict(nx=61, nu=48, n_rv=8, n_rho=125, k1=(15, 34, 30, 50, 78),
                      k1_rk=(15, 34, 61, 50, 78)),
         "lip": dict(nx=54, nu=27, n_rv=8, n_rho=72, k1=(10, 30, 27, 48, 30),
                     k1_rk=(10, 30, 54, 48, 30))}
BUILDS = {"srbd": build_srbd_problem, "lip": build_lip_problem}


def _flat(src):
    return " ".join(src.split())


def _struct(src, name):
    """The sizes of `struct <name> { static constexpr int …; }` in src."""
    body = src[src.index(f"struct {name} {{"):]
    body = body[body.index("static constexpr int") + 20:body.index(";")]
    return {k.strip(): int(v) for k, v in (kv.split("=") for kv in
                                          body.split(","))}


def _problem(problem, step="EULER", ns=4):
    prob = BUILDS[problem](SRBDConfig(dtype=F64, ns=ns, **LINE_FEET_TOPOLOGY),
                           line_feet_quadruped(), integrator=step,
                           device="cpu")
    return prob, MSDDP(prob.ocp, DDPOptions())


def _point(prob, seed, lead=(5,)):
    """Drawn (x, u, p): states around the nominal one, inputs around the
    static input, random references, 0/1 switches and tracking masks."""
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


# ---------------- the compiled sizes ----------------

def test_robot_and_trot_mask():
    """Two contacts 5 cm either side of each point foot along x, in the
    point feet's order (lf, rf, lh, rh), and each foot's two points in its
    leg's trot group."""
    r = line_feet_quadruped()
    pts = np.asarray(r.foot_positions)
    assert pts.shape == (8, 3) and r.foot_frames == tuple(
        f"c{i}" for i in range(8))
    np.testing.assert_allclose(pts[0::2] - pts[1::2], [[0.1, 0.0, 0.0]] * 4,
                               atol=1e-15)
    assert line_feet_trot_mask() == (True, True, False, False, False, False,
                                     True, True)
    assert line_feet_trot_mask()[::2] == trot_group_mask()


@pytest.mark.parametrize("problem", ["srbd", "lip"])
def test_shape_structs_are_the_tables_and_the_row_formulas(problem):
    """`srbd::` / `lip::LineFeetQuadShape` are the tables' entries, which
    are the sizes the row formulas give; K1's four structs are its
    `KERNEL_SHAPES` and differ from the square feet's in n_gx alone."""
    header, table = (SRBD_H, k4) if problem == "srbd" else (LIP_H, k10)
    z = SIZES[problem]
    got = _struct(header, "LineFeetQuadShape")
    assert got == table.TOPOLOGIES[TOPOLOGY]
    assert (got["nc"], got["cm"], got["n_legs"]) == (8, 2, 4)
    assert (got["nx"], got["nu"], got["n_rho"]) == (z["nx"], z["nu"],
                                                     z["n_rho"])
    n_res = 21 + 9 * 8 if problem == "srbd" else 16 + 3 * 8
    assert 2 * 4 * (2 - 1) == z["n_rv"] == got["n_rho"] - n_res - 3 * 8
    prefix = "" if problem == "srbd" else "Lip"
    for rk in ("", "Rk"):
        name = ("lip_" if problem == "lip" else "") + TOPOLOGY + (
            "_rk" if rk else "")
        k1_struct = _struct(K1_H, f"{prefix}LineFeetQuad{rk}Shape")
        want = k1.KERNEL_SHAPES[name]
        assert {k: want[k] for k in k1_struct} == k1_struct
        nt, n_rx, n_ru, n_gx, n_gu = z["k1_rk" if rk else "k1"]
        assert (want["nt"], want["n_rx"], want["n_ru"], want["n_gx"],
                want["n_gu"]) == (nt, n_rx, n_ru, n_gx, n_gu)
        assert (want["nx"], want["nu"]) == (z["nx"], z["nu"])
        square = k1.KERNEL_SHAPES[name.replace(TOPOLOGY, "square_feet")]
        assert {k for k in want if want[k] != square[k]} == {"n_gx"}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("problem", ["srbd", "lip"])
def test_kernel_shapes_are_the_problems_rows(problem, step):
    """Under each step the instance of K4/K3 or K10/K11 and K1's shape are
    `RiccatiRows.from_ocp` of the line-feet quadruped's OCP, and K1 picks
    its own shape and library, not the square feet's."""
    table = k4 if problem == "srbd" else k10
    prob, s = _problem(problem, step)
    ocp = prob.ocp
    rows = RiccatiRows.from_ocp(ocp)
    assert rows == s.rows
    name = TOPOLOGY + ("" if step == "EULER" else "_" + step.lower())
    want = table.KERNEL_SHAPES[name]
    assert table.check_kernel_shape("t", s.terms, ocp.nx, ocp.nu, rows) == name
    assert (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu)) == (
        want["n_rx"], want["n_ru"], want["n_gx"], want["n_gu"])
    shape = (("lip_" if problem == "lip" else "") + TOPOLOGY
             + ("" if step == "EULER" else "_rk"))
    assert k1.kernel_shape(ocp.nx, ocp.nu, want["nt"], rows) == shape
    assert k1.kernel_sizes(ocp.nx, ocp.nu, want["nt"], rows) == \
        k1.KERNEL_SHAPES[shape]
    for form, solver in (("collapsed", "schur"), ("tassa", "schur"),
                         ("tassa", "cholesky")):
        inst = k1.kernel_instance(shape, form, solver)
        assert k1.library_name(inst) == "riccati_backward_line_feet"


def test_with_shape_and_with_topology_take_the_new_instances():
    """Both headers' `with_shape` append the three steps as 12-14 and
    their `with_topology` picks the struct by (nc, cm, n_legs)."""
    for src, table in ((SRBD_H, k4), (LIP_H, k10)):
        flat = _flat(src)
        for i, inst in ((12, "LineFeetQuadShape{}"),
                        (13, "Stepped<LineFeetQuadShape, Rk2>{}"),
                        (14, "Stepped<LineFeetQuadShape, Rk4>{}")):
            assert f"case {i}: return fn({inst});" in flat
        assert ("if (is_topology<LineFeetQuadShape>(nc, cm, n_legs)) return "
                "with_step<LineFeetQuadShape>(step, fn);") in flat
        assert [table.shape_index(TOPOLOGY + s) for s in ("", "_rk2", "_rk4")] \
            == [12, 13, 14]


# ---------------- the rows this robot adds ----------------

def _rel_cols(g, cm, nc):
    """`srbd::rel_cols` of tracking row g ∈ [11, 15) (csrc/srbd_common.cuh):
    the offsets a, b into c of the row w_rel·((−c[a] + c[b]) − d)."""
    ax = 1 if g % 2 == 1 else 0
    return ((0 if g < 13 else 3 * (cm - 1)) + ax,
            (3 * cm if g < 13 else 3 * (nc - 1)) + ax)


def test_foot_pairs_match_the_sources():
    src = _flat(SRBD_H)
    assert ("const int ax = (g % 2 == 1) ? 1 : 0; // rows 11, 13: y *a = (g < "
            "13 ? 0 : 3 * (S::cm - 1)) + ax; *b = (g < 13 ? 3 * S::cm : 3 * "
            "(S::nc - 1)) + ax;") in src
    src = _flat(LIP_H)
    assert ("const int ax = (g % 2 == 0) ? 1 : 0; // rows 0, 2: y *a = (g < 2 "
            "? 0 : 3 * (S::cm - 1)) + ax; *b = (g < 2 ? 3 * S::cm : 3 * "
            "(S::nc - 1)) + ax;") in src
    # on this robot: c0 with c2 (the front points of lf and rf), c1 with c7
    # (lf's back point with rh's)
    pairs = [tuple(v // 3 for v in _rel_cols(g, 2, 8)) for g in range(11, 15)]
    assert pairs == [(0, 2), (0, 2), (1, 7), (1, 7)]


@pytest.mark.parametrize("problem", ["srbd", "lip"])
def test_tracking_rows_pair_the_sources_feet(problem):
    """The twins' four foot-pair rows (SRBD ρ rows 11-14, LIP rows 9-12)
    are w_rel·mt·((−c[a] + c[b]) − d) with the sources' pairs, at drawn
    points, to rounding."""
    prob, s = _problem(problem)
    x, u, p = _point(prob, seed=5)
    rho = s._stage_rho(x, u, p)
    t = s.terms
    c = x[..., 7:7 + 24] if problem == "srbd" else x[..., 3:3 + 24]
    mt = p["mask_track"][..., 0]
    d = (t.d1[1], t.d1[0], t.d2[1], t.d2[0])
    first = 11 if problem == "srbd" else 9
    for k in range(4):
        # the LIP's rows 0, 2 are y, as the SRBD's 11, 13
        a, b = _rel_cols(11 + k, 2, 8)
        want = (mt * t.w_rel) * ((-c[..., a] + c[..., b]) - d[k])
        assert torch.allclose(rho[..., first + k], want, rtol=1e-14,
                              atol=1e-14), k


@pytest.mark.parametrize("problem", ["srbd", "lip"])
def test_relative_velocity_rows_are_the_sources(problem):
    """`eq_row`'s relative-velocity rows (per = 2(cm − 1) = 2 a leg, base
    (q / per)·cm, the pair base + 1): each leg's front point's ẋ and ẏ
    less its back point's, over four legs — the first 8 equality rows of
    the twins' `stage_eq`."""
    for src in (SRBD_H, LIP_H):
        flat = _flat(src)
        assert "const int base = (q / per) * S::cm, rem = q % per;" in flat
        assert "const int i = rem / 2 + 1, ax = rem % 2;" in flat
    prob, _ = _problem(problem)
    x, u, p = _point(prob, seed=6)
    eq = prob.ocp.stage_eq(x, u, p)
    i_cdot = 13 + 3 * 8 if problem == "srbd" else 6 + 3 * 8
    cdot = x[..., i_cdot:i_cdot + 24]
    rows = []
    for q in range(8):
        base, rem = (q // 2) * 2, q % 2
        rows.append(cdot[..., 3 * base + rem] - cdot[..., 3 * (base + 1) + rem])
    want = torch.stack(rows, dim=-1)
    assert torch.allclose(eq[..., :8], want, rtol=1e-15, atol=1e-15)
    assert eq.shape[-1] == 8 + 3 * 8


def test_srbd_stage_rows_each_once():
    """`srbd::stage_sq_lane`'s three passes past 32 inputs (32 equality rows:
    11 on lanes 21-31, then 21 one a lane) sum each of the 125 stage rows
    on exactly one lane, and the lanes' sums add to ‖ρ‖² at drawn
    points."""
    prob, s = _problem("srbd")
    nc, nu, n_rho = prob.nc, prob.ocp.nu, s.terms.n_rho
    assert (nu, n_rho) == (48, 125)
    seen = sorted(r for lane in range(32)
                  for r in srbd_lane_rows(lane, nc, nu, n_rho))
    assert seen == list(range(n_rho))
    x, u, p = _point(prob, seed=3)
    rho = s._stage_rho(x, u, p)
    lanes = torch.stack([
        (rho[..., srbd_lane_rows(lane, nc, nu, n_rho)] ** 2).sum(-1)
        for lane in range(32)], dim=-1)
    assert torch.allclose(lanes.sum(-1), (rho * rho).sum(-1), rtol=1e-13,
                          atol=0)


def test_lip_warp_rows_cover_72_rows():
    """The LIP warp map (`lip::kRowsALane`) takes three rows a lane at 72
    rows, each once."""
    n_rho = k10.KERNEL_SHAPES[TOPOLOGY]["n_rho"]
    per = max(2, (n_rho + 31) // 32)
    assert (n_rho, per) == (72, 3)
    got = sorted(lane + 32 * c for lane in range(32) for c in range(per)
                 if lane + 32 * c < n_rho)
    assert got == list(range(n_rho))


def _jxp_scale(r, nc, n_rv):
    """K10's `jxp_scale` (csrc/lip_linearize.cu) of Jxp row r."""
    n_res = 16 + 3 * nc
    if r < 6 or 9 <= r < 13:
        return 1                                     # 1 + kP_mt
    q = r - n_res - n_rv - nc
    return 0 if q < 0 else 1 + (4 + nc) + q // 2     # ċxy rows


def test_k10_jxp_scales_fit_their_field():
    """K10 packs each Jxp value's scale in 5 bits and its node in the
    group in 3: this robot's scales over its 48 Jxp rows reach 20, and a
    fleet group takes one node (nx = 54 > 32)."""
    src = _flat(K10_SRC)
    assert ("if (r < 6 || (r >= 9 && r < 13)) return 1 + lip::kP_mt; // "
            "tracking rows int q = r - L::n_res - L::n_rv - S::nc; return q "
            "< 0 ? 0 : 1 + lip::Param<S>::cs + q / 2; // ċxy rows") in src
    assert "const int sid = bits & 31, w = (bits >> 5) & 7;" in src
    _, s = _problem("lip")
    scales = [_jxp_scale(r, 8, 8) for r in s.rows.gx]
    assert len(scales) == 48 and max(scales) == 20 < 32
    for dtype in (torch.float32, F64):
        for Bsz in (1, 512, 4096):
            assert k10.schedule(Bsz, 20, dtype, 132, TOPOLOGY)[0] == 1


# ---------------- the blocks ----------------

@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_blocks_fit_the_card(dtype):
    """K1's block at the four shapes (`layout_bytes`), K3's (`trial_layout`:
    four warps in float32, two in float64, as the square feet's) and
    lip_evaluate's at ns = 20 fit 232,448 B."""
    want = {torch.float32: (158_328, 176_308, 96_068, 104_920),
            F64: (200_312, 224_244, 119_596, 131_368)}[dtype]
    for shape, n in zip(k1.LINE_FEET_SHAPES, want):
        assert k1.layout_bytes(shape, dtype) == n <= SMEM_PER_BLOCK, shape
    for inst in (TOPOLOGY, TOPOLOGY + "_rk2", TOPOLOGY + "_rk4"):
        lay = k3.trial_layout(dtype, inst)
        assert lay["bytes"] <= SMEM_PER_BLOCK
        assert lay["warps"] == (4 if dtype == torch.float32 else 2)
        assert lay == k3.trial_layout(dtype, inst.replace(TOPOLOGY,
                                                          "square_feet"))
        m = k11.eval_members(4096, 132, dtype, 20, inst)
        assert k11.evaluate_smem_bytes(dtype, 20, m, inst)["total"] <= \
            SMEM_PER_BLOCK


# ---------------- the refusals ----------------

@pytest.mark.parametrize("problem", ["srbd", "lip"])
@pytest.mark.parametrize("mode", [dict(riccati_mode="associative"),
                                  dict(forward_pass="linear")],
                         ids=["associative", "linear"])
def test_modes_refused_before_any_launch(problem, mode):
    """K12 and K13 have no kernel at nc=8: `MSDDP` refuses the line-feet
    quadruped under either mode on every device, naming both eight-contact
    robots and ROADMAP.md Queue 2 row 12, and launches nothing."""
    prob = BUILDS[problem](SRBDConfig(dtype=F64, ns=4, **LINE_FEET_TOPOLOGY),
                           line_feet_quadruped(), device="cpu")
    before = (k12.riccati_associative.launches, k13.linear_trial.launches)
    with pytest.raises(NotImplementedError,
                       match=r"nc=8 \(the square-feet biped.*line-feet "
                             r"quadruped.*ROADMAP\.md Queue 2 row 12"):
        MSDDP(prob.ocp, DDPOptions(**mode))
    assert (k12.riccati_associative.launches,
            k13.linear_trial.launches) == before


def test_isrbd_path_refused_naming_row_13():
    """The isrbd kernels (K5, K6, isrbd_evaluate) have no shape at this
    robot: their shape check names nc=8 and ROADMAP.md Queue 2 row 13."""
    q = line_feet_quadruped()
    cfg = SRBDConfig(dtype=F64, lip_height=float(q.com[2]), ns=4,
                     **LINE_FEET_TOPOLOGY)
    prob = build_isrbd_problem(cfg, q, cz_rho_weight=None, device="cpu")
    al = ALDDP(prob.ocp, DDPOptions(max_iters=1))
    ocp, rows = prob.ocp, al.inner.rows
    for name in ("isrbd_linearize", "isrbd_trial", "isrbd_evaluate"):
        with pytest.raises(ValueError, match=r"'nc': 8.*ROADMAP\.md Queue 2 "
                                             r"row 13"):
            k5.check_kernel_shape(name, al.terms, ocp.nx, ocp.nu, rows)
