"""PyTorch port, K12's plain twin (`riccati_associative_plain`, the
associative-scan Riccati sweep of `riccati_mode="associative"`) in float64
on the CPU: against the JAX package's `MSDDP._backward_associative` on
JAX's dense linearization of the same drawn iterate, at each of K12's
instantiations — the Kangaroo SRBD problem, the LIP and the point-feet
quadruped's SRBD problem with both gain solves, entry by entry to 1e-9 of
max(1, |JAX|) (read: ≤ 3e-10); the AL inner problem of the Kangaroo's and
of the quadruped's isrbd problems with the Cholesky gain solve, at two
members of a drawn AL state (active cones and boxes, penalties ρ up to
1.7e4), to 1e-9 norm-wise (read: ≤ 7e-11) and to 1e-8 entry by entry
(read: ≤ 2.3e-9: the ρ-weighted rows make R̃ and the scan's (I + C₁J₂)
systems worse conditioned, so the rounding of JAX's XLA Cholesky and LU
against LAPACK's is amplified; the twin is within 2e-12 of the port's
sequential sweep there); against the port's sequential Tassa-form twin at
the JAX package's own `TestBackwardEquivalence` tolerances; and its scan,
which must make the 34 combines of JAX's `lax.associative_scan` tree for
21 elements on the same operands in the same order, as must the kernel's
table (`scan_plan`). The kernel itself runs on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    al_solvers,
    isrbd_problems,
    jax_al_state,
    jit,
    max_rel_err,
    np_of,
    problems,
    quadruped_isrbd_problems,
    quadruped_problems,
    random_al_state,
    solvers,
    tight_box_params,
    to_jax,
    to_torch,
    torch_al_state,
)
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build_lip
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu_torch.config import DDPOptions
from srbd_horizon_tpu_torch.config import SRBDConfig
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
from srbd_horizon_tpu_torch.kernels.isrbd_linearize import isrbd_linearize_plain
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

MU = 1e-6
OUT = ("ks", "Ks", "dV1", "dV2")
SOLVERS = ["schur", "cholesky"]
# the instantiations at the Kangaroo SRBD, LIP, quadruped and AL shapes;
# those at the point-feet biped's and the RK shapes are held to JAX in
# tests/test_torch_modes_{point_feet,kangaroo_rk,quadruped_rk,point_feet_rk}.py
INSTANCES = [(f, s) for f, s in k12.KERNEL_INSTANCES
             if f in ("srbd", "lip", "quadruped", "isrbd_al",
                      "isrbd_al_quadruped")]
INSTANCE_IDS = [f"{f}-{s}" for f, s in INSTANCES]
AL_SHAPES = ("isrbd_al", "isrbd_al_quadruped")
ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")


def _pair(family, quu_solver):
    """(jax solver, torch solver, jax problem) on an SRBD or LIP shape's
    problem."""
    if family in ("srbd", "quadruped"):
        jp, tp = problems() if family == "srbd" else quadruped_problems()
        js, ts = solvers(jp, tp, quu_solver=quu_solver)
        return js, ts, jp
    jp = j_build_lip(JSRBDConfig(dtype=jnp.float64), j_feet())
    tp = build_lip_problem(SRBDConfig(dtype=torch.float64), kangaroo_line_feet(),
                           device="cpu")
    return (JMSDDP(jp.ocp, JDDPOptions(quu_solver=quu_solver)),
            MSDDP(tp.ocp, DDPOptions(quu_solver=quu_solver)), jp)


def _al_sweeps(shape):
    """JAX's associative sweep (Cholesky, the AL inner solver's) on its
    dense linearization of two members of a drawn AL state, the twin and
    the port's sequential Tassa twin on the sliced one."""
    jp, tp = (isrbd_problems() if shape == "isrbd_al"
              else quadruped_isrbd_problems())
    js, ts = al_solvers(jp, tp)
    st = random_al_state(jp.ocp, 2, 21, *ts._sizes)
    params = tight_box_params(jp, 2, 22)
    jpin = jax.vmap(js._params_with_multipliers)(to_jax(params),
                                                 jax_al_state(st))
    tpin = ts._params_with_multipliers(to_torch(params), torch_al_state(st))
    X, U = st["sol"]["X"], st["sol"]["U"]
    jin = js._inner
    jlin = jit(jax.vmap(jin._linearize))(jnp.asarray(X), jnp.asarray(U),
                                         jpin)
    jres = jit(jax.vmap(jin._backward_associative, in_axes=(0, None)))(
        jlin, jnp.asarray(MU))
    lin = isrbd_linearize_plain(to_torch(X), to_torch(U), tpin, ts.terms,
                                ts.inner.rows, tp.ocp.dt)
    twin = k12.riccati_associative_plain(*(lin[k] for k in ORDER), MU,
                                         ts.inner.rows, "cholesky")
    return dict(jax=jres, twin=twin, seq=ts.inner._backward(lin, MU))


@pytest.fixture(scope="module")
def sweeps():
    """Per instantiation (K1's shape, gain solve): JAX's associative sweep
    on its dense lin, the port's twin and sequential Tassa twin on the
    sliced lin of the same iterate (X ± 0.05·N around the initial state,
    U 0.1·N, as tests/test_parallel_riccati.py draws it; a drawn AL state
    at the AL shapes)."""
    out = {}
    for family in dict.fromkeys(f for f, _ in INSTANCES):
        if family in AL_SHAPES:
            out[family, "cholesky"] = _al_sweeps(family)
            continue
        jlin = lin = None
        for solver in SOLVERS:
            js, ts, jp = _pair(family, solver)
            if jlin is None:
                rng = np.random.RandomState(0)
                ns, nx, nu = jp.ocp.ns, jp.ocp.nx, jp.ocp.nu
                X = (np.asarray(jp.initial_state)[None]
                     + 0.05 * rng.randn(ns + 1, nx))
                U = 0.1 * rng.randn(ns, nu)
                params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
                jlin = jit(js._linearize)(to_jax(X), to_jax(U),
                                          to_jax(params))
                lin = ts._linearize_sliced(
                    to_torch(X)[None], to_torch(U)[None],
                    {k: v[None] for k, v in to_torch(params).items()})
            jres = jit(js._backward_associative)(jlin, jnp.asarray(MU))
            args = tuple(lin[k] for k in ORDER)
            twin = k12.riccati_associative_plain(*args, MU, ts.rows, solver)
            seq = ts._backward(lin, MU)
            out[family, solver] = dict(jax=tuple(w[None] for w in jres),
                                       twin=twin, seq=seq)
    return out


@pytest.mark.parametrize("family,solver", INSTANCES, ids=INSTANCE_IDS)
def test_twin_matches_jax_associative(sweeps, family, solver):
    r = sweeps[family, solver]
    entry_tol = 1e-8 if family in AL_SHAPES else 1e-9
    for name, got, want in zip(OUT, r["twin"], r["jax"]):
        got, want = np_of(got), np.asarray(want)
        assert got.shape == want.shape, name
        err = np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))
        assert err <= entry_tol, (name, err)
        assert max_rel_err(got, want) <= 1e-9, name


@pytest.mark.parametrize("family,solver", INSTANCES, ids=INSTANCE_IDS)
def test_twin_matches_sequential_sweep(sweeps, family, solver):
    """The associative sweep reproduces the port's Tassa-form sweep (K1's
    twin) at tests/test_parallel_riccati.py::TestBackwardEquivalence's
    tolerances."""
    r = sweeps[family, solver]
    ks_a, Ks_a, d1_a, d2_a = (np_of(t) for t in r["twin"])
    ks_s, Ks_s, d1_s, d2_s = (np_of(t) for t in r["seq"])
    np.testing.assert_allclose(ks_a, ks_s, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(Ks_a, Ks_s, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(d1_a, d1_s, rtol=1e-8)
    np.testing.assert_allclose(d2_a, d2_s, rtol=1e-8)


def _intervals(n):
    return [(i, i) for i in range(n)]


def test_scan_makes_jax_combines_in_jax_order():
    """`reverse_scan` (the twin's tree) and `lax.associative_scan(...,
    reverse=True)` combine the same intervals in the same order: JAX calls
    its operator once a tree level on the level's slices, eagerly here, so
    each call's operands list that level's combines in order."""
    n = 21
    jax_calls = []

    def jfn(a, b):                       # JAX's (later, earlier) operands
        lo_a, hi_a = a
        lo_b, hi_b = b
        for i in range(lo_a.shape[0]):
            jax_calls.append(((int(lo_b[i]), int(hi_b[i])),
                              (int(lo_a[i]), int(hi_a[i]))))
        return (jnp.minimum(lo_a, lo_b), jnp.maximum(hi_a, hi_b))

    idx = jnp.arange(n)
    lo, hi = jax.lax.associative_scan(jfn, (idx, idx), reverse=True)
    port_calls = []

    def combine(e1, e2):                 # (earlier, later)
        port_calls.append((e1, e2))
        return (min(e1[0], e2[0]), max(e1[1], e2[1]))

    suffix = k12.reverse_scan(combine, _intervals(n))
    assert len(port_calls) == len(jax_calls) == 34
    assert port_calls == jax_calls
    assert suffix == [(int(a), int(b)) for a, b in zip(lo, hi)]
    assert suffix == [(i, n - 1) for i in range(n)]


def test_kernel_plan_is_the_twins_tree():
    """`scan_plan(20)`: JAX's 34 combines in its order within each stage,
    every operand made in an earlier stage, 6 stages (10, 6, 4, 5, 6, 3),
    and each node's suffix slot covering that node to the terminal one."""
    stages, suffix = k12.scan_plan(20)
    assert [len(s) for s in stages] == [10, 6, 4, 5, 6, 3]
    cover = {i: (i, i) for i in range(21)}
    made_at = {i: 0 for i in range(21)}
    order = []
    for s, stage in enumerate(stages, start=1):
        for out, earlier, later in stage:
            assert made_at[earlier] < s and made_at[later] < s
            assert cover[earlier][1] + 1 == cover[later][0]
            cover[out] = (cover[earlier][0], cover[later][1])
            made_at[out] = s
            order.append(out)
    assert sorted(order) == list(range(21, 55))
    # within a stage the combines keep JAX's order (the slots ascend)
    assert all(list(st) == sorted(st) for st in stages)
    assert [cover[slot] for slot in suffix] == [(i, 20) for i in range(21)]
    assert k12.launches_per_sweep(20) == 8


def test_plain_wrapper_takes_the_twin_on_cpu():
    """The wrapper on CPU tensors is the twin, bit for bit, and counts no
    launch."""
    js, ts, jp = _pair("lip", "schur")
    rng = np.random.RandomState(3)
    ns, nx, nu = jp.ocp.ns, jp.ocp.nx, jp.ocp.nu
    X = to_torch(np.asarray(jp.initial_state)[None, None]
                 + 0.05 * rng.randn(2, ns + 1, nx))
    U = to_torch(0.1 * rng.randn(2, ns, nu))
    params = {k: v.expand((2,) + tuple(v.shape)).contiguous()
              for k, v in ts.ocp.params.items()}
    lin = ts._linearize_sliced(X, U, params)
    args = tuple(lin[k] for k in ORDER)
    before = k12.riccati_associative.launches
    a = k12.riccati_associative(*args, MU, ts.rows, "schur")
    b = k12.riccati_associative_plain(*args, MU, ts.rows, "schur")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert k12.riccati_associative.launches == before
    assert max_rel_err(a[0][1], b[0][1]) == 0.0
    with pytest.raises(ValueError):
        k12.riccati_associative_plain(*args, MU, ts.rows, "lu")


def test_kernel_shapes_and_instances_match_the_cuda_source():
    """K12 defines no shape struct of its own: it takes K1's from
    csrc/riccati_common.cuh (twenty-two; K12 is built at fourteen of them,
    not at the eight-contact robots' eight), whose
    sizes are `riccati.KERNEL_SHAPES`; its `with_instance` switch is
    `KERNEL_INSTANCES`, in order."""
    csrc = Path(k12.__file__).resolve().parents[1] / "csrc"
    src = (csrc / "riccati_associative.cu").read_text()
    assert not re.findall(r"struct \w+Shape \{", src)
    assert '#include "riccati_common.cuh"' in src
    structs = re.findall(r"struct (\w+Shape) \{[^}]*?static constexpr int "
                         r"([^;]*);", (csrc / "riccati_common.cuh").read_text())
    names = {"SrbdShape": "srbd", "IsrbdAlShape": "isrbd_al",
             "LipShape": "lip", "QuadShape": "quadruped",
             "QuadAlShape": "isrbd_al_quadruped",
             "PointFeetShape": "point_feet", "SrbdRkShape": "srbd_rk",
             "QuadRkShape": "quadruped_rk", "PointFeetRkShape": "point_feet_rk",
             "LipRkShape": "lip_rk", "LipQuadShape": "lip_quadruped",
             "LipQuadRkShape": "lip_quadruped_rk",
             "LipPointFeetShape": "lip_point_feet",
             "LipPointFeetRkShape": "lip_point_feet_rk",
             "SquareFeetShape": "square_feet",
             "SquareFeetRkShape": "square_feet_rk",
             "LipSquareFeetShape": "lip_square_feet",
             "LipSquareFeetRkShape": "lip_square_feet_rk",
             "LineFeetQuadShape": "line_feet_quadruped",
             "LineFeetQuadRkShape": "line_feet_quadruped_rk",
             "LipLineFeetQuadShape": "lip_line_feet_quadruped",
             "LipLineFeetQuadRkShape": "lip_line_feet_quadruped_rk"}
    assert [s for s, _ in structs] == list(names)
    for s, body in structs:
        sizes = {k.strip(): int(v) for k, v in
                 (kv.split("=") for kv in body.split(","))}
        assert sizes == k1.KERNEL_SHAPES[names[s]]
    cases = re.findall(r"case (\d+): return fn\(Inst<(\w+), Solve::k(\w+)>",
                       src)
    assert [int(i) for i, *_ in cases] == list(range(len(cases)))
    assert tuple((names[s], g.lower()) for _, s, g in cases) == \
        k12.KERNEL_INSTANCES
