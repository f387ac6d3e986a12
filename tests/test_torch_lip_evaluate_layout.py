"""PyTorch port, lip_evaluate's block, order of sums, host setups and
output buffer, on the CPU.

The card runs lip_evaluate (`lip_evaluate_kernel` in
`csrc/lip_rollout.cu`); here no CUDA compiler exists. These tests hold what
the wrapper (`kernels/lip_rollout.py`) states about the kernel against the
source and the twin, with no JAX:

- the members a block and the warps a block (`EVAL_MEMBERS`,
  `EVAL_WARPS`, `eval_members`) are the .cu's, and every SM gets a block;
- the shared memory a block takes (`evaluate_smem_bytes`, region by
  region) is the .cu's `eval_regions` run from its text, at every (topology,
  step) instance of `lip_linearize.KERNEL_SHAPES`, for float32 and
  float64, ns ∈ {1, 8, 20, 31} and 1-8 members, within a block's limit;
- `kernel_order_evaluate`, a torch model of the kernel's order of work (a
  node's rows added in order, the stage nodes in node order and the
  terminal node last; a node's largest |defect| under the problem's step
  with NaN kept, then the stage nodes' largest), at every instance,
  agrees with `lip_evaluate_plain` to 1e-12 of
  max(1, |twin|) in float64 and to 1e-5 in float32, with node 0 pinned and
  without, a member with a NaN in its plan NaN in both outputs;
- each (B, dtype, ns, pin) builds its own setup, and the wrapper's call
  matches the entry's argument types;
- the outputs cut from one buffer are disjoint, 16-byte aligned and hold
  the twin's outputs, and the solver's LIP paths give the same results on
  them, bit for bit, without writing into them.
"""

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
from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
from srbd_horizon_tpu_torch.kernels.rollout import step_fn
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet, point_feet
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.solvers import msddp
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64, F32 = torch.float64, torch.float32
DTYPES = (F32, F64)
SOURCE = (Path(k11.__file__).resolve().parents[1] / "csrc"
          / "lip_rollout.cu").read_text()
SMEM_PER_BLOCK = 232_448  # an H100's shared memory a block may take
SMEM_PER_SM = 233_472     # and an SM's (each block also holds 1 KB of it)
TOL = {F64: 1e-12, F32: 1e-5}
NAN_MEMBER = 2
SHAPES = tuple(k10.KERNEL_SHAPES)
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
    return prob, MSDDP(prob.ocp, DDPOptions())


def test_block_constants_match_the_cuda_source():
    """Members and warps a block are the .cu's, and so is the members'
    rule: the most, halving from EVAL_MEMBERS, that still gives every SM a
    block."""
    assert _const("kEvalMembers") == k11.EVAL_MEMBERS
    assert ("while (m > 1 && eval_regions<S, E>(ns, m).total > kMaxSmem) "
            "m /= 2;") in SOURCE
    assert _const("kEvalWarps") == k11.EVAL_WARPS
    rule = re.search(r"int m = kEvalMembers;\s+while \(m > 1 && \(B \+ m - 1\) "
                     r"/ m < sms\) m /= 2;\s+return m;", SOURCE)
    assert rule is not None
    for sms in (132, 114, 1):
        for Bsz in (1, 2, 7, 131, 132, 263, 264, 512, 1056, 4096):
            m = k11.eval_members(Bsz, sms)
            assert m in (1, 2, 4, 8)
            assert m == 1 or -(-Bsz // m) >= sms
            assert m == k11.EVAL_MEMBERS or -(-Bsz // (2 * m)) < sms
    assert k11.eval_members(4096, 132) == 8 and k11.eval_members(1, 132) == 1


def _source_regions(dtype, ns, members, shape):
    """The .cu's `eval_regions<S, E>(ns, mb)` run from its text (its
    statements read as Python, the shape's sizes given): each region's
    bytes and the total."""
    body = re.search(r"constexpr EvalRegions eval_regions\(int ns, int mb\) "
                     r"\{\n(.*?)\n\}", SOURCE, re.S)[1]
    z = k10.KERNEL_SHAPES[shape]
    py = []
    for line in body.split(";"):
        line = " ".join(line.split())
        if not line or line.startswith(("EvalRegions r", "return",
                                         "constexpr int nx = S::nx")):
            continue
        if line.startswith("const size_t m = static_cast<size_t>(mb), ns1 ="):
            py += ["m = mb", "ns1 = ns + 1"]
            continue
        line = re.sub(r"r\.(\w+)", r"r['\1']", line)
        py.append(re.sub(r"lip::param_dim<S>\((\d)\)", r"pdim[\1]", line))
    env = dict(ns=ns, mb=members, E=torch.finfo(dtype).bits // 8,
               nx=z["nx"], nu=z["nu"], kPw=4 + 2 * z["nc"],
               pdim=(1, 3, z["nc"], z["nc"]), r={},
               round16=lambda v: -(-v // 16) * 16)
    exec("\n".join(py), env)
    r = env["r"]
    order = ("X", "U", "mt", "rd", "cr", "cs", "x0", "prm", "bar", "total")
    sizes = {f: r[nxt] - r[f] for f, nxt in zip(order, order[1:])}
    sizes["total"] = r["total"]
    return sizes


REGION_CASES = [(d, ns, m) for d in DTYPES for ns in (1, 8, 20, 31)
                for m in (1, 2, 4, 8)]


@pytest.mark.parametrize("dtype,ns,members", REGION_CASES,
                         ids=[f"{str(d)[6:]}-ns{n}-m{m}"
                              for d, n, m in REGION_CASES])
@pytest.mark.parametrize("shape", SHAPES)
def test_smem_bytes_match_the_cuda_layout(dtype, ns, members, shape):
    """The wrapper's bytes are the .cu's `eval_regions`, region by region,
    and fit a block; each staged run's region holds the members' run and
    16 bytes more; in float32 eight members leave four blocks an SM (two
    at the eight-contact robots' nx = 54, nu = 27)."""
    stated = k11.evaluate_smem_bytes(dtype, ns, members, shape)
    assert stated == _source_regions(dtype, ns, members, shape)
    assert sum(v for k, v in stated.items() if k != "total") == stated["total"]
    if stated["total"] > SMEM_PER_BLOCK:
        # the launcher halves the members until the block fits: only the
        # eight-contact robots' float64 blocks past ns = 24 hold fewer
        # than eight
        assert k10.KERNEL_SHAPES[shape]["nc"] == 8 and dtype == F64 and ns > 24
        fit = k11.eval_members(4096, 132, dtype, ns, shape)
        assert fit < members
        assert k11.evaluate_smem_bytes(dtype, ns, fit, shape)["total"] <= \
            SMEM_PER_BLOCK
    else:
        assert k11.eval_members(4096, 132, dtype, ns, shape) >= min(members, 8)
    z = k10.KERNEL_SHAPES[shape]
    E, m = torch.finfo(dtype).bits // 8, members
    assert stated["X"] >= m * (ns + 1) * z["nx"] * E + 16
    assert stated["U"] >= m * ns * z["nu"] * E + 16
    assert stated["x0"] >= m * z["nx"] * E
    if dtype == F32 and members == 8 and ns == 20:
        want = 2 if k10.KERNEL_SHAPES[shape]["nc"] == 8 else 4
        assert SMEM_PER_SM // (stated["total"] + 1024) >= want


# ---------------- the order of sums ----------------

def kernel_order_evaluate(X, U, params, terms, dt, wc, x0=None):
    """The kernel's order of work in torch: node 0 pinned to x0 when given;
    each node's residual rows squared and added in row order (a thread a
    node), the stage nodes added in node order and the terminal node last;
    each stage node's largest |step(x, u) − X[n+1]| by the NaN rule, then
    the stage nodes' largest. Returns (cost, defect_max[, the pinned
    plan])."""
    if x0 is not None:
        X = X.clone()
        X[:, 0] = x0
    ns = U.shape[1]
    p = {k: v[:, :ns] for k, v in params.items()}
    rho = terms.stage_rho(X[:, :ns], U, p, wc)                 # (B, ns, nr)
    node = torch.zeros_like(rho[..., 0])
    for g in range(rho.shape[-1]):
        node = node + rho[..., g] * rho[..., g]
    rt = terms.terminal_residual(X[:, ns], {k: v[:, ns] for k, v in
                                            params.items()})
    term = torch.zeros_like(rt[..., 0])
    for g in range(rt.shape[-1]):
        term = term + rt[..., g] * rt[..., g]
    cost = torch.zeros_like(term)
    for n in range(ns):
        cost = cost + node[:, n]
    cost = cost + term
    step = step_fn(terms.xdot, dt, terms.step)(X[:, :ns], U)
    dev = (step - X[:, 1:]).abs()
    nan = torch.isnan(dev).any(dim=-1).any(dim=-1)
    dmax = dev.amax(dim=(-1, -2)).masked_fill(nan, float("nan"))
    return (cost, dmax) if x0 is None else (cost, dmax, X)


def _draw(prob, s, dtype, Bsz=5, seed=0):
    ocp, nc = prob.ocp, prob.nc
    g = np.random.RandomState(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    X = t(prob.initial_state.numpy()[None, None]
          + 0.03 * g.randn(Bsz, ocp.ns + 1, ocp.nx))
    U = t(prob.static_input.numpy()[None, None]
          + 0.1 * g.randn(Bsz, ocp.ns, ocp.nu))
    params = dict(rdot_ref=t(0.3 * g.randn(Bsz, ocp.ns + 1, 3)),
                  c_ref=t(0.05 * np.abs(g.randn(Bsz, ocp.ns + 1, nc))),
                  cdot_switch=t(g.randint(0, 2, (Bsz, ocp.ns + 1, nc))),
                  mask_track=t(g.randint(0, 2, (Bsz, ocp.ns + 1, 1))))
    x0 = X[:, 0] + t(0.005 * g.randn(Bsz, ocp.nx))
    X[NAN_MEMBER, 5, 4] = float("nan")
    return X, U, params, x0


def _err(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    return float(((got - want).abs() / want.abs().clamp_min(1.0))[fin].max())


@pytest.mark.parametrize("dtype,pinned",
                         [(d, p) for d in DTYPES for p in (False, True)],
                         ids=["f32", "f32-pinned", "f64", "f64-pinned"])
def test_kernel_order_matches_the_twin(each_lip, dtype, pinned):
    prob, s = each_lip
    X, U, params, x0 = _draw(prob, s, dtype)
    terms, dt, wc = s.terms, prob.ocp.dt, s._wc(dtype)
    kw = dict(x0=x0) if pinned else {}
    got = kernel_order_evaluate(X, U, params, terms, dt, wc, **kw)
    want = k11.lip_evaluate_plain(X, U, params, terms, dt, wc, **kw)
    for g, w in zip(got[:2], want[:2]):
        assert torch.isnan(g[NAN_MEMBER]) and torch.isnan(w[NAN_MEMBER])
        assert _err(g, w) <= TOL[dtype]
    if pinned:
        assert torch.equal(got[2].view(torch.int64 if dtype == F64
                                       else torch.int32),
                           want[2].view(torch.int64 if dtype == F64
                                        else torch.int32))


# ---------------- the host setups ----------------

@pytest.fixture
def no_library(monkeypatch):
    """The setups with their C entry stood in for (no library here), and
    no setup left behind."""
    monkeypatch.setattr(k11, "_fn", lambda entry, dtype, argtypes: object())
    build.clear_host_setups()
    yield
    build.clear_host_setups()


def test_each_size_builds_its_own_setup(lip, no_library):
    """Another B, dtype, ns or pin builds its own setup; the same sizes
    take the one made; a horizon past 31 stage nodes is refused."""
    prob, s = lip
    ocp, terms = prob.ocp, s.terms
    wc = s._wc(F64)

    def make(dtype=F64, Bsz=3, ns=8, pinned=True):
        key = (k11.EVALUATE, CPU, dtype, Bsz, ns, ocp.dt, wc, pinned)
        return build.host_setup(terms, key, lambda: k11._EvalSetup(
            terms, dtype, Bsz, ns, ocp.nx, ocp.nu, ocp.dt, wc, pinned))
    first = make()
    assert make() is first
    others = [make(Bsz=5), make(dtype=F32), make(ns=20), make(pinned=False)]
    assert len({id(x) for x in others + [first]}) == len(others) + 1
    assert first.shapes[0] == (3, 9, ocp.nx) and first.x0_shape == (3, ocp.nx)
    assert len(first.layout) == 3 and len(others[3].layout) == 2
    with pytest.raises(ValueError, match="at most 31 stage nodes"):
        k11._EvalSetup(terms, F64, 3, 32, ocp.nx, ocp.nu, ocp.dt, wc, False)


def test_the_call_matches_the_entrys_argument_types(each_lip, monkeypatch):
    """The launch passes exactly the entry's arguments (its argtypes and the
    stream): x0 and its row stride, the topology and the step's id that
    pick the instance, the outputs at their layout's offsets, no plan
    pointer unpinned."""
    prob, s = each_lip
    ocp, t = prob.ocp, s.terms
    seen = {}

    class Entry:
        argtypes = None

        def __call__(self, *args):
            seen["args"] = args
            return 0

    entry = Entry()

    class Lib:
        lip_evaluate_f32 = lip_evaluate_f64 = entry
    monkeypatch.setattr(k11, "library", lambda name: Lib)
    monkeypatch.setattr(k11, "launch",
                        lambda name, fn, dev, *args: fn(*args, None))
    k11._fns.clear()
    build.clear_host_setups()
    try:
        Bsz, ns = 2, ocp.ns
        X = torch.zeros(Bsz, ns + 1, ocp.nx)
        U = torch.zeros(Bsz, ns, ocp.nu)
        params = {k: torch.zeros(Bsz, ns + 1, v.shape[-1])
                  for k, v in ocp.params.items()}
        stride = max(40, 3 + ocp.nx)             # rows 40 apart (57, nx 54)
        rows = torch.zeros(Bsz, stride)
        x0 = rows[:, 3:3 + ocp.nx]
        for pin in (None, x0):
            out, shape = k11._evaluate_launched(X, U, params, s.terms,
                                                ocp.dt, s._wc(F32), pin)
            assert shape == k10.check_kernel_shape("t", t, ocp.nx, ocp.nu)
            args = seen["args"]
            assert len(args) == len(entry.argtypes)
            assert args[3] == (stride if pin is not None else 0)
            assert args[5:11] == (Bsz, ns, t.nc, t.contact_model,
                                  t.number_of_legs, k10.STEPS.index(t.step))
            assert list(args[-4:-1]) == [o.data_ptr() for o in out] + (
                [None] if pin is None else [])
    finally:
        k11._fns.clear()
        build.clear_host_setups()


# ---------------- the one output buffer ----------------

def _one_buffer(out, Bsz, ns, nx):
    """The twin's outputs moved into views of one buffer as the CUDA wrapper
    lays them out: (the buffer, the views)."""
    dtype = out[0].dtype
    layout, total = build.layout_of(
        k11.evaluate_shapes(Bsz, ns, nx, len(out) == 3), dtype)
    buf, views = build.output_views(layout, total, dtype, CPU)
    for v, t in zip(views, out):
        v.copy_(t)
    return buf, tuple(views)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_output_views_hold_the_twins_outputs(lip, dtype):
    """The cost, the largest defect and the pinned plan as views of one
    buffer: disjoint, contiguous, 16-byte aligned, holding the twin's
    outputs."""
    prob, s = lip
    X, U, params, x0 = _draw(prob, s, dtype, Bsz=3, seed=1)
    want = k11.lip_evaluate_plain(X, U, params, s.terms, prob.ocp.dt,
                                  s._wc(dtype), x0=x0)
    buf, views = _one_buffer(want, 3, prob.ocp.ns, prob.ocp.nx)
    spans = []
    for v, w in zip(views, want):
        assert v.is_contiguous() and v.shape == w.shape
        off = v.data_ptr() - buf.data_ptr()
        assert off % build.OUT_ALIGN == 0
        spans.append((off, off + v.numel() * v.element_size()))
        assert torch.equal(v.nan_to_num(7.0), w.nan_to_num(7.0))
    spans.sort()
    assert all(a[1] <= c[0] for a, c in zip(spans, spans[1:]))


def _lip_runs(prob, s):
    """A batched solve and a single solve: every tensor."""
    ocp = prob.ocp
    Bsz = 3
    x0 = prob.initial_state.expand(Bsz, -1).contiguous()
    params = {k: v.expand((Bsz,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    out = s.solve_batch(s.init(x0), x0, params)
    got = [t.clone() for t in out if isinstance(t, torch.Tensor)]
    sol = s.solve(s.init(prob.initial_state), prob.initial_state, ocp.params)
    return got + [getattr(sol, f).clone() for f in ("X", "U")]


def test_solver_paths_agree_on_one_buffer_outputs(lip, monkeypatch):
    """`MSDDP.solve_batch` and `MSDDP.solve` on lip_evaluate's outputs
    (the starting cost, the pinned plan the solve starts from, the final
    defects) laid out as views of one buffer give what they give on
    separate tensors, bit for bit, and leave every buffer as written."""
    prob, _ = lip
    s = MSDDP(prob.ocp, DDPOptions(max_iters=4))
    want = _lip_runs(prob, s)
    written = []

    def one_buffer_evaluate(X, U, params, terms, dt, wc, x0=None):
        out = k11.lip_evaluate_plain(X, U, params, terms, dt, wc, x0)
        buf, views = _one_buffer(out, X.shape[0], X.shape[1] - 1, X.shape[2])
        written.append((buf, buf.clone()))
        return views
    table = msddp._KERNELS
    monkeypatch.setitem(table, "lip", table["lip"][:2] + (one_buffer_evaluate,))
    got = _lip_runs(prob, s)
    assert len(written) > 0 and len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(b.nan_to_num(7.0), c.nan_to_num(7.0))
               for b, c in written)
