"""PyTorch port, K10's schedule, templates, host setups and output buffer,
on the CPU.

The card runs K10 (`lip_linearize_kernel` in `csrc/lip_linearize.cu`);
here no CUDA compiler exists. These tests hold what the wrapper
(`kernels/lip_linearize.py`) states about the kernel against the source
and the twin, with no JAX:

- the block constants (threads, launch bound, a fleet's group) and the
  template table's layout parsed from the .cu equal the wrapper's;
- at every (topology, step) instance of `KERNEL_SHAPES`:
- the schedule (`schedule`, the .cu's `launch_groups` and grid-stride
  loops, its unit and record slots modelled from the source's constants):
  for B ∈ {1, 2, 3, 7, 512, 4096} and ns ∈ {1, 8, 20, 31} in both types,
  every group is walked by exactly one block, the groups tile the stage
  member-nodes and the members' terminal pairs, each field's units tile
  a group once, every store of a whole unit is 16 bytes at a 16-byte
  aligned offset (or one value, at V = 1), and every record value is
  loaded once from its place;
- the templates formed on the host (`template_entries`, the .cu's entry
  formulas in the working type) are the twin's Jacobians at mask 1 and
  switch 1 bit for bit in float64, within one unit in the last place in
  float32, and the template × scale rule gives the twin's Jxp bit for bit;
  the step's blocks (`step_blocks`) are the chain rule of the step's own
  Jacobian (`torch.func.jacfwd` of `ocp.step`) to 1e-14;
- each (B, dtype, ns, rows) builds its own setup, and the wrapper's call
  matches the entry's argument types;
- the outputs cut from one buffer are disjoint, 16-byte aligned and hold
  the twin's outputs, and the solver's LIP paths give the same results on
  them, bit for bit, without writing into them.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _line_feet_quadruped import LINE_FEET_TOPOLOGY, line_feet_quadruped
from _square_feet import SQUARE_TOPOLOGY, square_feet
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import build
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet, point_feet
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.solvers import msddp
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64, F32 = torch.float64, torch.float32
DTYPES = (F32, F64)
SOURCE = (Path(k10.__file__).resolve().parents[1] / "csrc"
          / "lip_linearize.cu").read_text()
SMS = 132                      # an H100's SMs
SIZES_B = (1, 2, 3, 7, 512, 4096)
SIZES_NS = (1, 8, 20, 31)
SHAPES = tuple(k10.KERNEL_SHAPES)
# each topology's SRBDConfig fields and robot
LIP_TOPOLOGIES = {
    "kangaroo": (dict(), kangaroo_line_feet),
    "quadruped": (dict(contact_model=1, number_of_legs=4), quadruped_point_feet),
    "point_feet": (dict(contact_model=1, number_of_legs=2), point_feet),
    "square_feet": (SQUARE_TOPOLOGY, square_feet),
    "line_feet_quadruped": (LINE_FEET_TOPOLOGY, line_feet_quadruped),
}


def lip_problem(shape, dtype=F64):
    """The LIP problem of the instance `shape` (a `KERNEL_SHAPES` name) on
    the CPU."""
    topology, _, rk = shape.partition("_rk")
    kw, robot = LIP_TOPOLOGIES[topology]
    return build_lip_problem(SRBDConfig(dtype=dtype, **kw), robot(),
                             integrator="RK" + rk if rk else "EULER",
                             device="cpu")


def _const(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, SOURCE)[1])


@pytest.fixture(scope="module")
def lip():
    prob = build_lip_problem(SRBDConfig(dtype=F64), kangaroo_line_feet(),
                             device="cpu")
    return prob, MSDDP(prob.ocp, DDPOptions())


@pytest.fixture(scope="module", params=SHAPES)
def each_lip(request):
    """The problem and solver of each (topology, step) instance."""
    prob = lip_problem(request.param)
    s = MSDDP(prob.ocp, DDPOptions())
    assert k10.check_kernel_shape("t", s.terms, prob.ocp.nx, prob.ocp.nu,
                                  s.rows) == request.param
    return prob, s


def test_block_constants_match_the_cuda_source():
    """Threads, launch bound and a fleet's group are the .cu's; the
    template table holds Sx, Bs, Jxp, Jup, Jt in that order."""
    assert _const("kSlotThreads") == k10.THREADS
    assert _const("kMinBlocks") == k10.MIN_BLOCKS
    assert _const("kGroupUnits") == k10.GROUP_UNITS
    order = re.search(r"static constexpr int oSx = 0, oBs = oSx \+ kSx, "
                      r"oJxp = oBs \+ kBs,\s+oJup = oJxp \+ kJxp, "
                      r"oJt = oJup \+ kJup,", SOURCE)
    assert order is not None
    assert k10.TEMPLATES == ("Sx", "Bs", "Jxp", "Jup", "Jt")
    assert k10.FIELDS == ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "rt", "Jt")


# ---------------- the schedule ----------------

def _per(shape="kangaroo"):
    """Values a node of each field (the .cu's K10<S>)."""
    z = k10.KERNEL_SHAPES[shape]
    nx, nu = z["nx"], z["nu"]
    return dict(Sx=z["n_rx"] * nx, Bs=z["n_ru"] * nu, Jxp=z["n_gx"] * nx,
                Jup=z["n_gu"] * nu, rho=z["n_rho"], d=nx, rt=z["nt"],
                Jt=z["nt"] * nx)


def _rotations(per):
    """The first thread of each template field's units (the .cu's kRot*)."""
    T = k10.THREADS
    return dict(Sx=0, Bs=per["Sx"] % T, Jxp=(per["Sx"] + per["Bs"]) % T,
                Jup=(per["Sx"] + per["Bs"] + per["Jxp"]) % T, Jt=0)


def _units_of(units, rot):
    """Every (thread, slot) unit of a field (the .cu's `unit_of`)."""
    T = k10.THREADS
    tid = np.arange(T)
    slots = -(-units // T)
    u = ((tid + T - rot) % T)[:, None] + T * np.arange(slots)[None, :]
    return u[u < units]


def test_units_tile_a_group_once():
    """Each template field's units over the block's threads and slots are
    0 … units−1, each once, and a unit's values [u·V, u·V + V) tile the
    group's field block; the row-major values of ρ, d and rt are each
    (row, node) once."""
    for shape in SHAPES:
        _units_tile(_per(shape), _rotations(_per(shape)))


def _units_tile(per, rot):
    for dtype in DTYPES:
        for G in (1, k10.GROUP_UNITS * k10.vec_nodes(dtype)):
            V = 1 if G == 1 else k10.vec_nodes(dtype)
            for f in ("Sx", "Bs", "Jxp", "Jup", "Jt"):
                units = per[f] * G // V
                u = np.sort(_units_of(units, rot[f]))
                np.testing.assert_array_equal(u, np.arange(units))
                vals = (u[:, None] * V + np.arange(V)[None, :]).ravel()
                np.testing.assert_array_equal(np.sort(vals),
                                              np.arange(G * per[f]))
            for rows, n in ((per["rho"], None), (per["d"], None),
                            (per["rt"], None)):
                i = np.arange(G * rows)
                g_, w = i // G, i % G
                assert len(set(zip(g_.tolist(), w.tolist()))) == G * rows
                assert g_.max() == rows - 1 and w.max() == G - 1


def _walk(n_stage, n_groups, grid):
    """The groups each block walks: its stage groups, then (continuing the
    same stride) its terminal groups."""
    out = []
    for b in range(grid):
        out.extend(range(b, n_groups, grid))
    return np.array(out)


CASES = [(B, ns, d) for B in SIZES_B for ns in SIZES_NS for d in DTYPES]


@pytest.mark.parametrize("Bsz,ns,dtype", CASES,
                         ids=[f"B{b}-ns{n}-{str(d)[6:]}" for b, n, d in CASES])
def test_schedule_writes_every_node_once(Bsz, ns, dtype):
    """Every stage member-node and every member's terminal pair is written
    once: each group walked by one block, the stage groups tiling the B·ns
    member-nodes and the terminal groups the B members, the group's field
    block holding its nodes' values; every whole unit a 16-byte store at
    a 16-byte aligned offset of its field (or one value at V = 1)."""
    G, n_stage, n_groups, grid = k10.schedule(Bsz, ns, dtype, SMS)
    V = 1 if G == 1 else k10.vec_nodes(dtype)
    E = torch.finfo(dtype).bits // 8
    assert grid == min(n_groups, SMS * k10.MIN_BLOCKS) and grid >= 1
    if Bsz * ns < SMS:
        assert G == 1 and grid == Bsz * ns + Bsz      # B=1: 21 blocks at ns=20
    walked = np.sort(_walk(n_stage, n_groups, grid))
    np.testing.assert_array_equal(walked, np.arange(n_groups))
    per = _per()
    for lo, hi, count, fields in ((0, n_stage, Bsz * ns,
                                   ("Sx", "Bs", "Jxp", "Jup", "rho", "d")),
                                  (n_stage, n_groups, Bsz, ("rt", "Jt"))):
        g = np.arange(lo, hi) - lo
        q0 = g * G
        nv = np.minimum(G, count - q0)
        assert (nv >= 1).all() and nv.sum() == count
        assert (q0[1:] == q0[:-1] + nv[:-1]).all() and q0[0] == 0
        for f in fields:
            start = q0 * per[f]                       # the group's block
            assert (start[1:] == start[:-1] + nv[:-1] * per[f]).all()
            assert start[-1] + nv[-1] * per[f] == count * per[f]
            if V > 1 and f not in ("rho", "d", "rt"):
                assert (start * E % 16 == 0).all()
                assert V * E == 16
    assert G == 1 or n_stage >= SMS


def _rec_slot(i, G, shape):
    """The .cu's `rec_slot`: (node in the group, source, element) of record
    slot i, source 15 past the group's records."""
    z = k10.KERNEL_SHAPES[shape]
    nx, nu = z["nx"], z["nu"]
    rec = 2 * nx + nu + 4 + 2 * z["nc"]
    if i >= G * rec:
        return None
    w, e = divmod(i, rec)
    if e < nx:
        return w, "x", e
    if e < 2 * nx:
        return w, "xn", e - nx
    if e < 2 * nx + nu:
        return w, "u", e - 2 * nx
    p = e - 2 * nx - nu
    dims = (1, 3, z["nc"], z["nc"])
    off = np.cumsum((0,) + dims)
    t = int(np.searchsorted(off, p, side="right") - 1)
    return w, f"p{t}", p - off[t]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_record_slots_load_each_value_once(dtype):
    """The record slots of a group (G nodes, `kRecSlots` a thread) load
    each node's x, X[n+1], u and 12 parameter values once; the source's
    record layout is x, X[n+1], u, the packed parameter row."""
    assert re.search(r"rX = 0, rXn = nx, rU = 2 \* nx, rP = 2 \* nx \+ nu,\s+"
                     r"kRec = rP \+ L::pw;", SOURCE)
    for shape in SHAPES:
        _record_slots_once(dtype, shape)


def _record_slots_once(dtype, shape):
    z = k10.KERNEL_SHAPES[shape]
    for G in (1, k10.GROUP_UNITS * k10.vec_nodes(dtype)):
        rec = 2 * z["nx"] + z["nu"] + 4 + 2 * z["nc"]
        T = k10.THREADS
        slots = [_rec_slot(t + s * T, G, shape) for t in range(T)
                 for s in range(-(-G * rec // T))]
        live = [x for x in slots if x is not None]
        assert len(live) == len(set(live)) == G * rec
        dims = dict(x=z["nx"], xn=z["nx"], u=z["nu"], p0=1, p1=3,
                    p2=z["nc"], p3=z["nc"])
        for w in range(G):
            for src, n in dims.items():
                assert sorted(o for ww, s_, o in live
                              if ww == w and s_ == src) == list(range(n))


# ---------------- the templates ----------------

def _twin_at_unit_scales(prob, s, dtype):
    """The twin's Jacobians of one member-node at mask 1 and switch 1."""
    ocp = prob.ocp
    g = np.random.RandomState(3)
    X = torch.tensor(g.randn(1, 2, ocp.nx), dtype=dtype)
    U = torch.tensor(g.randn(1, 1, ocp.nu), dtype=dtype)
    nc = prob.nc
    params = dict(mask_track=torch.ones(1, 2, 1, dtype=dtype),
                  rdot_ref=torch.zeros(1, 2, 3, dtype=dtype),
                  c_ref=torch.zeros(1, 2, nc, dtype=dtype),
                  cdot_switch=torch.ones(1, 2, nc, dtype=dtype))
    return k10.lip_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt,
                                   s._wc(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_templates_are_the_twins_jacobians(each_lip, dtype):
    """The host templates are the twin's Jacobians at unit scales: bit for
    bit in float64, within one unit in the last place in float32 (the twin
    rounds some products in double first); the table repeats each
    template `vec_nodes` times in `TEMPLATES` order."""
    prob, s = each_lip
    ocp = prob.ocp
    ent = k10.template_entries(s.terms, s.rows, ocp.dt, s._wc(dtype), dtype)
    twin = _twin_at_unit_scales(prob, s, dtype)
    for f in k10.TEMPLATES:
        want = twin[f][0, 0] if f != "Jt" else twin[f][0]
        got = torch.from_numpy(ent[f])
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == F64:
            assert torch.equal(got, want), f
        else:
            ulp = torch.finfo(F32).eps * want.abs().clamp_min(1e-30)
            assert ((got - want).abs() <= ulp).all(), f
            assert torch.equal(got == 0, want == 0), f
    table = k10.templates(s.terms, s.rows, ocp.dt, s._wc(dtype), dtype)
    V = k10.vec_nodes(dtype)
    parts = np.split(table, np.cumsum([ent[f].size * V
                                       for f in k10.TEMPLATES])[:-1])
    for f, part in zip(k10.TEMPLATES, parts):
        np.testing.assert_array_equal(part, np.tile(ent[f].ravel(), V))


def test_step_blocks_are_the_steps_jacobian(each_lip):
    """Sx and Bs of the template table are (A − I)[rx] and B[ru] of the
    problem's own step, A and B by `torch.func.jacfwd` of `ocp.step` at a
    drawn point, to 1e-14 of their largest entry; the rows outside rx and
    ru are zero there."""
    prob, s = each_lip
    ocp = prob.ocp
    g = np.random.RandomState(11)
    x = torch.tensor(g.randn(ocp.nx))
    u = torch.tensor(g.randn(ocp.nu))
    step = lambda a, b: ocp.step(a, b, None, ocp.dt)
    A = torch.func.jacfwd(step, 0)(x, u) - torch.eye(ocp.nx, dtype=F64)
    Bm = torch.func.jacfwd(step, 1)(x, u)
    ent = k10.dynamics_entries(s.terms, s.rows, ocp.dt, F64)
    for got, full, rows in ((ent["Sx"], A, s.rows.rx), (ent["Bs"], Bm, s.rows.ru)):
        want = full[list(rows)]
        assert float((torch.from_numpy(got) - want).abs().max()) <= \
            1e-14 * float(want.abs().max())
        dead = [r for r in range(ocp.nx) if r not in rows]
        assert bool((full[dead] == 0).all())


def test_scaled_templates_give_the_twins_jxp(each_lip):
    """Template × scale (the tracking mask or the node's switch; a zero
    entry kept zero) on drawn masks and switches gives the twin's Jxp bit
    for bit in float64, with the scales the .cu's `jxp_scale` reads from
    the row table."""
    prob, s = each_lip
    ocp, nc = prob.ocp, prob.nc
    ent = k10.template_entries(s.terms, s.rows, ocp.dt, s._wc(F64), F64)
    g = np.random.RandomState(5)
    Bsz, ns = 3, 4
    X = torch.tensor(g.randn(Bsz, ns + 1, ocp.nx))
    U = torch.tensor(g.randn(Bsz, ns, ocp.nu))
    params = dict(mask_track=torch.tensor(g.randint(0, 2, (Bsz, ns + 1, 1)),
                                          dtype=F64),
                  rdot_ref=torch.tensor(g.randn(Bsz, ns + 1, 3)),
                  c_ref=torch.tensor(g.randn(Bsz, ns + 1, nc)),
                  cdot_switch=torch.tensor(g.randint(0, 2, (Bsz, ns + 1, nc)),
                                           dtype=F64))
    twin = k10.lip_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt,
                                   s._wc(F64))["Jxp"]
    n_res, n_rv = s.terms.n_res, 2 * s.terms.number_of_legs * (
        s.terms.contact_model - 1)
    t = torch.from_numpy(ent["Jxp"])
    for b in range(Bsz):
        for n in range(ns):
            mt = params["mask_track"][b, n, 0]
            cs = params["cdot_switch"][b, n]
            got = t.clone()
            for i, r in enumerate(s.rows.gx):
                if r < 6 or 9 <= r < 13:
                    f = mt
                elif r - n_res - n_rv - nc >= 0:
                    f = cs[(r - n_res - n_rv - nc) // 2]
                else:
                    continue
                got[i] = torch.where(t[i] == 0, t[i], t[i] * f)
            assert torch.equal(got, twin[b, n])


# ---------------- the host setups ----------------

@pytest.fixture
def no_library(monkeypatch):
    """The setups with their C entry stood in for (no library here), and
    no setup left behind."""
    monkeypatch.setattr(k10, "_kernel_fn", lambda dtype: object())
    build.clear_host_setups()
    yield
    build.clear_host_setups()


def test_each_size_builds_its_own_setup(lip, no_library):
    """Another B, dtype, ns or row table builds its own setup; the same
    sizes take the one made."""
    prob, s = lip
    ocp, terms, rows = prob.ocp, s.terms, s.rows
    wc = s._wc(F64)

    def make(dtype=F64, Bsz=3, ns=8, rows=rows, dt=ocp.dt):
        return k10.setup(terms, rows, CPU, dtype, Bsz, ns, ocp.nx, ocp.nu, dt,
                         wc)
    first = make()
    assert make() is first
    others = [make(Bsz=5), make(dtype=F32), make(ns=20),
              make(rows=dataclasses.replace(rows)), make(dt=ocp.dt / 2)]
    assert len({id(x) for x in others + [first]}) == len(others) + 1
    assert make(Bsz=5) is others[0]
    assert first.shapes[0] == (3, 9, ocp.nx) and others[0].shapes[1][0] == 5
    assert first.args[2:4] == (3, 8)
    assert first.tmpl.dtype == F64 and others[1].tmpl.dtype == F32


def test_the_call_matches_the_entrys_argument_types(each_lip, monkeypatch):
    """The launch passes exactly the entry's arguments (its argtypes and the
    stream): the topology and the step's id that pick the instance, the
    row counts, the outputs at their layout's offsets."""
    prob, s = each_lip
    ocp, t = prob.ocp, s.terms
    seen = {}

    class Entry:
        argtypes = None

        def __call__(self, *args):
            seen["args"] = args
            return 0

    class Lib:
        lip_linearize_f32 = lip_linearize_f64 = Entry()
    monkeypatch.setattr(k10, "library", lambda name: Lib)
    monkeypatch.setattr(k10, "launch",
                        lambda name, fn, dev, *args: fn(*args, None))
    k10._kernel_fns.clear()
    build.clear_host_setups()
    try:
        Bsz, ns = 2, ocp.ns
        X = torch.zeros(Bsz, ns + 1, ocp.nx)
        U = torch.zeros(Bsz, ns, ocp.nu)
        params = {k: torch.zeros(Bsz, ns + 1, v.shape[-1])
                  for k, v in ocp.params.items()}
        out = k10._launched(X, U, params, s.terms, s.rows, ocp.dt, s._wc(F32))
        assert len(seen["args"]) == len(Lib.lip_linearize_f32.argtypes)
        assert seen["args"][5:15] == (
            Bsz, ns, t.nc, t.contact_model, t.number_of_legs,
            k10.STEPS.index(t.step), len(s.rows.rx), len(s.rows.ru),
            len(s.rows.gx), len(s.rows.gu))
        outs = seen["args"][-2]
        assert [outs[i] for i in range(8)] == [out[f].data_ptr()
                                               for f in k10.FIELDS]
    finally:
        k10._kernel_fns.clear()
        build.clear_host_setups()


# ---------------- the one output buffer ----------------

def _one_buffer(lin, Bsz, ns, dtype, shape="kangaroo"):
    """The twin's outputs moved into views of one buffer as the CUDA wrapper
    lays them out: (the buffer, the dict of views)."""
    layout, total = build.layout_of(
        k10.output_shapes(Bsz, ns, k10.KERNEL_SHAPES[shape]), dtype)
    buf, views = build.output_views(layout, total, dtype, CPU)
    for v, f in zip(views, k10.FIELDS):
        v.copy_(lin[f])
    return buf, dict(zip(k10.FIELDS, views))


@pytest.mark.parametrize("dtype,Bsz", [(d, b) for d in DTYPES for b in (1, 3)],
                         ids=["f32-B1", "f32-B3", "f64-B1", "f64-B3"])
def test_output_views_hold_the_twins_outputs(each_lip, dtype, Bsz):
    """The eight outputs as views of one buffer: disjoint, contiguous,
    16-byte aligned, of the twin's shapes, holding the twin's outputs once
    all are copied in."""
    prob, s = each_lip
    ocp = prob.ocp
    shape = k10.check_kernel_shape("t", s.terms, ocp.nx, ocp.nu, s.rows)
    g = np.random.RandomState(Bsz)
    X = torch.tensor(g.randn(Bsz, ocp.ns + 1, ocp.nx), dtype=dtype)
    U = torch.tensor(g.randn(Bsz, ocp.ns, ocp.nu), dtype=dtype)
    params = {k: v.expand((Bsz,) + tuple(v.shape)).to(dtype).contiguous()
              for k, v in ocp.params.items()}
    want = k10.lip_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt,
                                   s._wc(dtype))
    buf, views = _one_buffer(want, Bsz, ocp.ns, dtype, shape)
    spans = []
    for f in k10.FIELDS:
        v = views[f]
        assert v.is_contiguous() and v.shape == want[f].shape
        off = v.data_ptr() - buf.data_ptr()
        assert off % build.OUT_ALIGN == 0
        spans.append((off, off + v.numel() * v.element_size()))
        assert torch.equal(v, want[f])
    spans.sort()
    assert all(a[1] <= c[0] for a, c in zip(spans, spans[1:]))
    assert spans[-1][1] <= buf.numel() * buf.element_size()


def _lip_runs(prob, s):
    """A batched solve and two dlip-style single solves: every tensor."""
    ocp = prob.ocp
    Bsz = 3
    x0 = prob.initial_state.expand(Bsz, -1).contiguous()
    params = {k: v.expand((Bsz,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    out = s.solve_batch(s.init(x0), x0, params)
    got = [t.clone() for t in out if isinstance(t, torch.Tensor)]
    sol = s.solve(s.init(prob.initial_state), prob.initial_state, ocp.params)
    got += [getattr(sol, f).clone() for f in ("X", "U")]
    return got


@pytest.mark.parametrize("shape", ["kangaroo", "point_feet_rk4"])
def test_solver_paths_agree_on_one_buffer_outputs(shape, monkeypatch):
    """`MSDDP.solve_batch` and `MSDDP.solve` on K10's outputs laid out as
    views of one buffer give what they give on separate tensors, bit for
    bit, and leave every buffer as K10 wrote it: no consumer (K1, the
    compaction's index_select / index_copy, the line search) writes
    through them or across fields."""
    prob = lip_problem(shape)
    s = MSDDP(prob.ocp, DDPOptions(max_iters=4, active_compact_levels=2,
                                   line_search_compact=2))
    want = _lip_runs(prob, s)
    written = []

    def one_buffer_linearize(X, U, params, terms, rows, dt, wc):
        lin = k10.lip_linearize_plain(X, U, params, terms, rows, dt, wc)
        buf, views = _one_buffer(lin, X.shape[0], X.shape[1] - 1, X.dtype,
                                 shape)
        written.append((buf, buf.clone()))
        return views
    table = msddp._KERNELS
    monkeypatch.setitem(table, "lip", (one_buffer_linearize,) + table["lip"][1:])
    got = _lip_runs(prob, s)
    assert len(written) > 0 and len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(b, c) for b, c in written)
