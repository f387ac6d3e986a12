"""PyTorch port, K8a and K8b's order of loads and stores, and K8a-c's host
setups and one output buffer, on the CPU.

The card runs K8a (`isrbd_al_shift_kernel`) and K8b
(`isrbd_al_params_kernel`) of `csrc/isrbd_al.cu`; here no CUDA compiler
exists. These tests hold what the kernels do against the source itself
and the twins:

- `thread_order_shift` and `thread_order_params`, models of each thread's
  loads and stores in the kernels (its constants — the block, the slots a
  thread holds, the runs' order, node widths, nodes and pads — read from
  the .cu's text, its index rules held to the .cu's statements), run on
  inputs whose every element is its own number: every output element is
  written exactly once, from the element (or pad, or table entry) the twin
  puts there, and in each thread's order no load follows a store (one
  round at the serving horizon). Both AL shapes, ns = 8 and 20, both
  dtypes, no, the tail and the full prior at periods 4 and 10 (int32 and
  int64 phases), the u-box overrides or not;
- the host setups (`shift_setup`, `params_setup`, `prior_setup`): one a
  size, a second call with another B, dtype, prior kind, period or
  overrides building its own;
- the one output buffer of each entry (`shift_layout`, `params_layout`,
  `prior_layout`): views that do not overlap, 16-byte aligned, holding
  the twin's outputs; and the solver's paths (the serving tick with each
  prior, the offline solve) on outputs that are views of one buffer a
  call agree bit for bit with those on separate tensors, and write none of
  them in place.

No JAX, no compile.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.config import SRBDConfig
from srbd_horizon_tpu_torch.kernels import build
from srbd_horizon_tpu_torch.kernels import isrbd_al as k78
from srbd_horizon_tpu_torch.kernels.isrbd_linearize import KERNEL_SHAPES
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
from srbd_horizon_tpu_torch.solvers.options import al_serving_options

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
SOURCE = (Path(k78.__file__).resolve().parents[1] / "csrc" /
          "isrbd_al.cu").read_text()
SHAPES = ("kangaroo", "quadruped")
DTYPES = (torch.float32, torch.float64)
B = 2                     # members a model run


# ---------------- the .cu's text ----------------

def _const(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, SOURCE)[1])


def _enum(name):
    body = re.search(r"enum %s \{(.*?)\};" % name, SOURCE, re.S)[1]
    return [t.strip() for t in body.split(",") if t.strip()]


SHIFT_THREADS, SHIFT_SLOTS = _const("kShiftThreads"), _const("kShiftSlots")
PARAMS_THREADS, PARAMS_SLOTS = _const("kParamsThreads"), _const("kParamsSlots")
SHIFT_IN = _enum("ShiftIn")
PARAMS_IN = _enum("ParamsIn")


def _switch(fn, r, shape):
    """The .cu's `fn<S>(r)` (a switch over run names returning S:: sizes)."""
    body = re.search(r"constexpr int %s\(int r\) \{(.*?)\n\}" % fn, SOURCE,
                     re.S)[1]
    z = KERNEL_SHAPES[shape]
    names = SHIFT_IN if fn == "shift_dim" else PARAMS_IN

    def value(expr):
        m = re.fullmatch(r"S::(\w+)", expr.strip())
        return z[m[1]] if m else int(expr)
    for cases, expr in re.findall(r"((?:case \w+: )+)return ([^;]+);", body):
        if names[r] in re.findall(r"case (\w+):", cases):
            return value(expr)
    return value(re.search(r"default: return ([^;]+);", body)[1])


def _terminal_runs():
    expr = re.search(r"constexpr bool shift_terminal\(int r\) \{\s*return "
                     r"(.*?);", SOURCE, re.S)[1]
    return {SHIFT_IN.index(n) for n in re.findall(r"r == (\w+)", expr)}


def _widest(shape):
    assert "constexpr int a = S::nx > S::nu ? S::nx : S::nu;" in SOURCE
    assert "constexpr int c = S::n_eq > S::n_in ? S::n_eq : S::n_in;" in SOURCE
    z = KERNEL_SHAPES[shape]
    return max(z["nx"], z["nu"], z["n_eq"], z["n_in"])


def _body(kernel):
    return re.search(r"%s\(.*?\n\}" % kernel, SOURCE, re.S)[0]


# each statement of a round in the kernel, loads before the marker
# "// then the stores", stores after it
SHIFT_LOADS = (
    "const long long raw = kPrior == kNone ? 0 : phase_value(phase, phase_bytes, b);",
    "const int count = (shift_terminal(r) ? ns1 : ns) * dim;",
    "if (i < count) v[r][s] = in[rolled(i, count, dim)];",
    "const int sph = kPrior == kTail ? phase_mod(raw, -1, period) : ph;",
    "seed = P.seen[srow];",
    "seed_T = P.seen_T[row];",
    "const int last = (ns - 1) * n_eq;",
    "const T* st = P.in[S_TAB] + srow * (kPrior == kFull ? ns * n_eq : n_eq);",
    "if (kPrior == kFull ? i < ns * n_eq : i >= last && i < ns * n_eq)",
    "tab[s] = st[kPrior == kFull ? i : i - last];",
    "lamT = P.in[S_LAMT][b * n_eq_T + tid];",
    "tabT = P.in[S_TABT][row * n_eq_T + tid];",
)
SHIFT_STORES = (
    "if (r == S_LAM && kPrior == kFull && seed) x = tab[s];",
    "if (r == S_LAM && kPrior == kTail && seed && i >= (ns - 1) * n_eq) x = tab[s];",
    "out[i] = x;",
    "P.out[S_LAMT][b * n_eq_T + tid] = seed_T ? tabT : lamT;",
)
PARAMS_LOADS = (
    "const T rho = P.in[A_RHO][b];",
    "if (i < ns1 * n_eq_T) v[r][s] = in[b * n_eq_T + i % n_eq_T];",
    "v[r][s] = in[b * ns * dim + i];",
)
PARAMS_STORES = (
    "if (i >= ns1 * dim) continue;",
    "out[i] = r == A_RHO ? rho\n                 : r == A_LAMT || i < ns * dim ? v[r][s] : params_pad<T>(r);",
)
def _round(kind):
    """A round's statements in K8a ("Shift") or K8b ("Params"): element i
    of a slot, a round of slots·threads elements of each run."""
    return (f"const int i = base + s * k{kind}Threads + tid;",
            "for (int base = 0; base < ns1 * widest<S>(); "
            f"base += k{kind}Slots * k{kind}Threads) {{",
            f"for (int s = 0; s < k{kind}Slots; ++s) {{",
            f"__launch_bounds__(k{kind}Threads, k{kind}MinBlocks<T>)")


@pytest.mark.parametrize("kernel,kind,loads,stores", [
    ("isrbd_al_shift_kernel", "Shift", SHIFT_LOADS, SHIFT_STORES),
    ("isrbd_al_params_kernel", "Params", PARAMS_LOADS, PARAMS_STORES)],
    ids=["k8a", "k8b"])
def test_models_read_the_cuda_source(kernel, kind, loads, stores):
    """The models' statements are the kernel's, every load before the
    stores' marker and every store after it; a round is slots·threads
    elements of each run, the launch the kernel's threads; the pads and
    the rolled index rule are the models'."""
    body = _body(kernel)
    marker = body.index("// then the stores")
    for text in _round(kind)[:3]:
        assert text in body, text
    assert _round(kind)[3] + "\n" + kernel in SOURCE
    assert re.search(r"%s(<[^>]*>)*<<<B, k%sThreads, 0, " % (kernel, kind),
                     SOURCE)
    for text in loads:
        assert body.count(text) == 1 and body.index(text) < marker, text
    for text in stores:
        assert body.count(text) == 1 and body.index(text) > marker, text
    assert "return i < count - dim ? i + dim : i;" in SOURCE
    assert ("return r == A_ULB ? -T(INFINITY) : r == A_UUB ? T(INFINITY) : "
            "T(0);") in SOURCE
    assert SHIFT_IN[:10] == ["S_X", "S_U"] + [
        "S_" + {"lam_eq": "LAM", "mu_ub": "MUUB", "mu_lb": "MULB",
                "mu_x_ub": "MUXUB", "mu_x_lb": "MUXLB", "mu_u_ub": "MUUUB",
                "mu_u_lb": "MUULB"}[f] for f in k78.ROLLED] + ["S_LAMT"]
    assert PARAMS_IN[:9] == ["A_" + {"lam_eq": "LAM", "lam_eq_T": "LAMT",
                                     "mu_ub": "MUUB", "mu_lb": "MULB",
                                     "rho": "RHO", "mu_u_ub": "MUUUB",
                                     "mu_u_lb": "MUULB"}[f]
                             for f in k78.PARAMS_STATE] + ["A_ULB", "A_UUB"]


# ---------------- the models ----------------

def _rolled(i, count, dim):
    return i + dim if i < count - dim else i


class Block:
    """One member's block of `threads` in the kernel's program order, its
    threads at once (numpy over tid): each load or store an event at the
    next position, taken by the threads `active` selects at the element
    `index` gives each; per thread the position of its last load and of
    its first store."""

    def __init__(self, threads):
        self.n = threads
        self.pos = 0
        self.last_load = np.full(threads, -1)
        self.first_store = np.full(threads, np.iinfo(int).max)

    def load(self, name, arrays, index, active=True):
        active = np.broadcast_to(active, (self.n,))
        index = np.broadcast_to(index, (self.n,))
        self.last_load[active] = self.pos
        self.pos += 1
        vals = np.zeros(self.n, arrays[name].dtype)
        vals[active] = arrays[name].reshape(-1)[index[active]]
        return vals

    def store(self, name, outs, writes, index, value, active=True):
        active = np.broadcast_to(active, (self.n,))
        self.first_store[active] = np.minimum(self.first_store[active],
                                              self.pos)
        self.pos += 1
        outs[name].reshape(-1)[index[active]] = np.broadcast_to(
            value, (self.n,))[active]
        np.add.at(writes[name].reshape(-1), index[active], 1)

    def loads_before_stores(self):
        return bool((self.last_load < self.first_store).all())


def thread_order_shift(shape, ns, kind, period, ins, flags, phase):
    """K8a's loads and stores in each member's block, over the members of
    `ins` (name: array by ShiftIn name; S_TAB, S_TABT the prior's tables),
    the seen flags (S_SEEN, S_SEEN_T) and the phase. Returns the outputs,
    their write counts and the blocks."""
    term = _terminal_runs()
    widest, n_eq, n_eq_T = (_widest(shape), KERNEL_SHAPES[shape]["n_eq"],
                            KERNEL_SHAPES[shape]["n_eq_T"])
    ns1, Bm = ns + 1, phase.shape[0]
    n_runs = SHIFT_IN.index("S_LAMT")
    outs = {n: np.full_like(ins[n], np.nan) for n in SHIFT_IN[:10]}
    writes = {n: np.zeros(ins[n].shape, int) for n in SHIFT_IN[:10]}
    blocks, TID = [], np.arange(SHIFT_THREADS)
    for b in range(Bm):
        k = Block(SHIFT_THREADS)
        blocks.append(k)
        raw = int(k.load("phase", {"phase": phase}, b)[0]) if kind else 0
        for base in range(0, ns1 * widest, SHIFT_SLOTS * SHIFT_THREADS):
            held, tab = {}, {}
            lamT = tabT = 0
            seed = seed_T = False
            for r in range(n_runs):
                dim = _switch("shift_dim", r, shape)
                count = (ns1 if r in term else ns) * dim
                for s in range(SHIFT_SLOTS):
                    i = base + s * SHIFT_THREADS + TID
                    src = np.where(i < count - dim, i + dim, i)
                    held[r, s] = k.load(SHIFT_IN[r], ins, b * count + src,
                                        i < count)
            if kind:
                ph = raw % period
                sph = (raw - 1) % period if kind == 1 else ph
                row, srow = b * period + ph, b * period + sph
                seed = bool(k.load("S_SEEN", flags, srow)[0])
                seed_T = bool(k.load("S_SEEN_T", flags, row)[0])
                last = (ns - 1) * n_eq
                st = srow * (ns * n_eq if kind == 2 else n_eq)
                for s in range(SHIFT_SLOTS):
                    i = base + s * SHIFT_THREADS + TID
                    take = (i < ns * n_eq) & ((kind == 2) | (i >= last))
                    tab[s] = k.load("S_TAB", ins,
                                    st + (i if kind == 2 else i - last), take)
                first = (base == 0) & (TID < n_eq_T)
                lamT = k.load("S_LAMT", ins, b * n_eq_T + TID, first)
                tabT = k.load("S_TABT", ins, row * n_eq_T + TID, first)
            for r in range(n_runs):
                count = (ns1 if r in term else ns) * _switch("shift_dim", r,
                                                              shape)
                for s in range(SHIFT_SLOTS):
                    i = base + s * SHIFT_THREADS + TID
                    x = held[r, s]
                    if SHIFT_IN[r] == "S_LAM" and kind == 2 and seed:
                        x = tab[s]
                    if SHIFT_IN[r] == "S_LAM" and kind == 1 and seed:
                        x = np.where(i >= (ns - 1) * n_eq, tab[s], x)
                    k.store(SHIFT_IN[r], outs, writes, b * count + i, x,
                            i < count)
            if kind:
                k.store("S_LAMT", outs, writes, b * n_eq_T + TID,
                        tabT if seed_T else lamT, (base == 0) & (TID < n_eq_T))
    return outs, writes, blocks


def thread_order_params(shape, ns, ins):
    """K8b's loads and stores in each member's block, over the members of
    `ins` (name: array by ParamsIn name; A_ULB, A_UUB absent where not
    overridden). Returns the outputs, their write counts and the blocks."""
    widest, n_eq_T = _widest(shape), KERNEL_SHAPES[shape]["n_eq_T"]
    ns1, Bm = ns + 1, ins["A_RHO"].shape[0]
    names = [n for n in PARAMS_IN[:9] if n in ins]
    dim = {n: _switch("params_dim", PARAMS_IN.index(n), shape) for n in names}
    outs = {n: np.full((Bm, ns1 * dim[n]), np.nan) for n in names}
    writes = {n: np.zeros((Bm, ns1 * dim[n]), int) for n in names}
    pads = {"A_ULB": -np.inf, "A_UUB": np.inf}
    blocks, TID = [], np.arange(PARAMS_THREADS)
    for b in range(Bm):
        k = Block(PARAMS_THREADS)
        blocks.append(k)
        rho = k.load("A_RHO", ins, b)
        for base in range(0, ns1 * widest, PARAMS_SLOTS * PARAMS_THREADS):
            held = {}
            for n in names:
                for s in range(PARAMS_SLOTS):
                    i = base + s * PARAMS_THREADS + TID
                    if n == "A_LAMT":
                        held[n, s] = k.load(n, ins, b * n_eq_T + i % n_eq_T,
                                            i < ns1 * n_eq_T)
                    elif n != "A_RHO":
                        held[n, s] = k.load(n, ins, b * ns * dim[n] + i,
                                            i < ns * dim[n])
            for n in names:
                for s in range(PARAMS_SLOTS):
                    i = base + s * PARAMS_THREADS + TID
                    x = (rho if n == "A_RHO" else held[n, s] if n == "A_LAMT"
                         else np.where(i < ns * dim[n], held[n, s],
                                       pads.get(n, 0.0)))
                    k.store(n, outs, writes, b * ns1 * dim[n] + i, x,
                            i < ns1 * dim[n])
    return outs, writes, blocks


# ---------------- the solvers and numbered inputs ----------------

_SOLVERS = {}


def _solver(shape, ns):
    key = (shape, ns)
    if key not in _SOLVERS:
        if shape == "kangaroo":
            prob = build_isrbd_problem(SRBDConfig(dtype=F64, ns=ns),
                                       kangaroo_line_feet(), device=CPU,
                                       cz_rho_weight=3200.0)
        else:
            q = quadruped_point_feet()
            prob = build_isrbd_problem(
                SRBDConfig(dtype=F64, ns=ns, lip_height=float(q.com[2]),
                           contact_model=1, number_of_legs=4), q, device=CPU)
        _SOLVERS[key] = (prob, ALDDP(prob.ocp, *al_serving_options(1)))
    return _SOLVERS[key]


def _numbered_state(al, Bm, dtype, start=1):
    """An ALState whose every element, across fields, is its own number."""
    sh = k78.state_shapes(Bm, al.ocp.ns, al.terms, al.ocp.nx, al.ocp.nu)
    fields, n = {}, start
    for f, shape in sh.items():
        size = int(np.prod(shape))
        fields[f] = torch.arange(n, n + size, dtype=dtype).reshape(shape)
        n += size
    st = al.init(fields["X"][:, 0])
    st = st._replace(sol=st.sol._replace(X=fields.pop("X"), U=fields.pop("U")),
                     **fields)
    return st, n


def _numbered_prior(al, kind, period, Bm, dtype, start, g):
    ns = al.ocp.ns
    make = al.init_full_phase_prior if kind == 2 else al.init_phase_prior
    prior = make(period, Bm)
    tables, flags = k78.prior_shapes(kind, Bm, period, ns, al.terms)
    vals = {}
    for f, shape in tables:
        size = int(np.prod(shape))
        vals[f] = torch.arange(start, start + size, dtype=dtype).reshape(shape)
        start += size
    for f, shape in flags:
        vals[f] = torch.as_tensor(g.rand(*shape) < 0.5)
    return prior._replace(**vals)


SHIFT_CASES = [(s, ns, d, kind, period, pdt) for s in SHAPES for ns in (8, 20)
               for d in DTYPES for kind in (0, 1, 2)
               for period, pdt in (((4, torch.int32), (10, torch.int64))
                                   if kind else ((0, None),))]


@pytest.mark.parametrize("shape,ns,dtype,kind,period,pdt", SHIFT_CASES,
                         ids=[f"{s}-ns{n}-{str(d)[6:]}-{k78.PRIORS[k]}-P{p}"
                              for s, n, d, k, p, _ in SHIFT_CASES])
def test_shift_thread_order_matches_twin(shape, ns, dtype, kind, period, pdt):
    """K8a's model on numbered inputs: each output element written once,
    equal to the twin's (the rolled element, the table entry where the
    phase's row was seen), no load after a store in a thread; one round."""
    _, al = _solver(shape, ns)
    g = np.random.RandomState(ns + kind + period)
    st, n = _numbered_state(al, B, dtype)
    prior = phase = None
    if kind:
        prior = _numbered_prior(al, kind, period, B, dtype, n, g)
        # member 0 at phase 0: the tail's row wraps to P − 1
        phase = torch.as_tensor([0, period - 1], dtype=pdt)
    want = k78.isrbd_al_shift_plain(al, st, prior, phase)
    ins = {"S_X": st.sol.X, "S_U": st.sol.U, "S_LAMT": st.lam_eq_T}
    ins.update({n: getattr(st, f) for n, f in zip(SHIFT_IN[2:9], k78.ROLLED)})
    flags = {}
    if kind:
        tab, tabT = (getattr(prior, f) for f, _ in k78.prior_shapes(
            kind, B, period, ns, al.terms)[0])
        ins.update(S_TAB=tab, S_TABT=tabT)
        seen = [getattr(prior, f) for f, _ in k78.prior_shapes(
            kind, B, period, ns, al.terms)[1]]
        flags = {"S_SEEN": seen[0].numpy(), "S_SEEN_T": seen[-1].numpy()}
    ins = {k: v.numpy() for k, v in ins.items()}
    outs, writes, blocks = thread_order_shift(
        shape, ns, kind, period, ins, flags,
        phase.numpy() if kind else np.zeros(B, int))
    got = dict(S_X=want.sol.X, S_U=want.sol.U)
    got.update({n: getattr(want, f) for n, f in zip(SHIFT_IN[2:9], k78.ROLLED)})
    if kind:
        got["S_LAMT"] = want.lam_eq_T
    for name, w in got.items():
        assert (writes[name] == 1).all(), name
        np.testing.assert_array_equal(outs[name], w.numpy(), err_msg=name)
    if not kind:
        assert (writes["S_LAMT"] == 0).all()
    assert (ns + 1) * _widest(shape) <= SHIFT_SLOTS * SHIFT_THREADS  # one round
    assert all(k.loads_before_stores() for k in blocks)


PARAMS_CASES = [(s, ns, d, over) for s in SHAPES for ns in (8, 20)
                for d in DTYPES for over in ((False, False), (True, False),
                                             (False, True), (True, True))]


@pytest.mark.parametrize("shape,ns,dtype,over", PARAMS_CASES,
                         ids=[f"{s}-ns{n}-{str(d)[6:]}-u_lb{int(o[0])}"
                              f"-u_ub{int(o[1])}" for s, n, d, o in PARAMS_CASES])
def test_params_thread_order_matches_twin(shape, ns, dtype, over):
    """K8b's model on numbered inputs: each padded output element written
    once, equal to the twin's (the stage element, its pad on the last
    node, λ_T tiled, ρ broadcast), no load after a store in a thread; one
    round."""
    prob, al = _solver(shape, ns)
    st, n = _numbered_state(al, B, dtype)
    params = {k: v.expand((B,) + tuple(v.shape)).to(dtype).contiguous()
              for k, v in prob.ocp.params.items()}
    for k, o in zip(("u_lb", "u_ub"), over):
        if o:
            size = B * ns * al.ocp.nu
            params[k] = torch.arange(n, n + size, dtype=dtype).reshape(
                B, ns, al.ocp.nu)
            n += size
    want = k78.isrbd_al_params_plain(al, params, st)
    ins = {f"A_{n}": getattr(st, f).numpy() for n, f in zip(
        ("LAM", "LAMT", "MUUB", "MULB", "RHO", "MUUUB", "MUULB"),
        k78.PARAMS_STATE)}
    for k, o in zip(("ULB", "UUB"), over):
        if o:
            ins[f"A_{k}"] = params[f"u_{k[1:].lower()}"].numpy()
    outs, writes, blocks = thread_order_params(shape, ns, ins)
    for slot, key in k78.params_fields(over):
        name = PARAMS_IN[slot]
        assert (writes[name] == 1).all(), name
        np.testing.assert_array_equal(outs[name], want[key].reshape(B, -1)
                                      .numpy(), err_msg=key)
    assert (ns + 1) * _widest(shape) <= PARAMS_SLOTS * PARAMS_THREADS
    assert all(k.loads_before_stores() for k in blocks)


# ---------------- the host setups ----------------

@pytest.fixture
def no_library(monkeypatch):
    """The setups with their C entries stood in for (no library here), and
    no setup left behind."""
    monkeypatch.setattr(k78, "_fn", lambda entry, dtype, argtypes: object())
    build.clear_host_setups()
    yield
    build.clear_host_setups()


def test_each_size_builds_its_own_setup(no_library):
    _, al = _solver("kangaroo", 8)
    nx, nu, ns = al.ocp.nx, al.ocp.nu, 8
    base = dict(dtype=torch.float32, kind=2, period=4, Bsz=3)

    def shift(dtype, kind, period, Bsz):
        return k78.shift_setup(al, CPU, dtype, kind, period, Bsz, ns, nx, nu)

    def prior(dtype, kind, period, Bsz):
        return k78.prior_setup(al, CPU, dtype, max(kind, 1), period, Bsz, ns)

    for make in (shift, prior):
        first = make(**base)
        assert make(**base) is first
        for change in (dict(Bsz=5), dict(dtype=F64), dict(kind=1),
                       dict(period=10)):
            other = make(**dict(base, **change))
            assert other is not first and make(**dict(base, **change)) is other
        assert make(**dict(base, Bsz=5)).state[0][1][0] == 5
        assert make(**dict(base, period=10)).tables[0][1][1] == 10
    s0 = k78.shift_setup(al, CPU, F64, 0, 0, 3, ns, nx, nu)
    assert s0.tables == () and len(s0.layout) == 9           # no λ_T out
    p = k78.params_setup(al, CPU, F64, (False, False), 3, ns, nu)
    assert k78.params_setup(al, CPU, F64, (False, False), 3, ns, nu) is p
    for change in ((True, False), (False, True)):
        q = k78.params_setup(al, CPU, F64, change, 3, ns, nu)
        assert q is not p and len(q.layout) == 8
    assert k78.params_setup(al, CPU, torch.float32, (False, False), 3, ns,
                            nu) is not p
    assert p.bounds["al_u_ub"] is al._static_padded_bounds(3, F64, CPU)[3]


# ---------------- the one output buffer ----------------

def _disjoint_aligned(buf, views, dtype):
    spans = []
    for v in views:
        assert v.is_contiguous()
        assert v.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        off = v.data_ptr() - buf.data_ptr()
        assert off % k78.OUT_ALIGN == 0
        spans.append((off, off + v.numel() * v.element_size()))
    spans.sort()
    assert spans[0][0] >= 0
    assert spans[-1][1] <= buf.numel() * buf.element_size()
    assert all(a[1] <= c[0] for a, c in zip(spans, spans[1:]))


def _same(a, b):
    """The same dtype, shape and bits (a NaN equal to itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in ints:
        return torch.equal(a.contiguous().view(ints[a.dtype]),
                           b.contiguous().view(ints[b.dtype]))
    return torch.equal(a, b)


def _fill_and_compare(views, want):
    for v, w in zip(views, want):
        assert v.shape == w.shape and v.dtype == w.dtype
        v.copy_(w)
    for v, w in zip(views, want):           # no copy overwrote another
        assert _same(v, w)


VIEW_CASES = [(s, d, Bw) for s in SHAPES for d in DTYPES for Bw in (1, 3)]


@pytest.mark.parametrize("shape,dtype,Bw", VIEW_CASES,
                         ids=[f"{s}-{str(d)[6:]}-B{b}" for s, d, b in VIEW_CASES])
def test_output_views_hold_the_twins_outputs(shape, dtype, Bw):
    """Each entry's outputs as views of one buffer: disjoint, 16-byte
    aligned, of the twin's shapes and dtypes, and holding the twin's
    outputs once all are copied in."""
    prob, al = _solver(shape, 8)
    ns, nx, nu, terms = 8, al.ocp.nx, al.ocp.nu, al.terms
    g = np.random.RandomState(Bw)
    st, n = _numbered_state(al, Bw, dtype)
    for kind, period in ((0, 0), (1, 4), (2, 10)):
        prior = (_numbered_prior(al, kind, period, Bw, dtype, n, g)
                 if kind else None)
        phase = torch.arange(Bw, dtype=torch.int32) if kind else None
        out = k78.isrbd_al_shift_plain(al, st, prior, phase)
        layout, total = k78.shift_layout(kind, Bw, ns, terms, nx, nu, dtype)
        buf, views = k78.output_views(layout, total, dtype, CPU)
        _disjoint_aligned(buf, views, dtype)
        want = [out.sol.X, out.sol.U] + [getattr(out, f) for f in k78.SHIFTED]
        _fill_and_compare(views, want[:len(views)])
        if kind:
            new = k78.isrbd_al_prior_update_plain(al, prior, st, phase, 0.5)
            tab_l, flag_l, total = k78.prior_layout(kind, Bw, period, ns, terms,
                                                    dtype)
            buf, tabs, flags = k78.prior_views(tab_l, flag_l, total, dtype, CPU)
            _disjoint_aligned(buf, tabs + flags, dtype)
            assert [f.dtype for f in flags] == [torch.bool] * (3 - kind)
            _fill_and_compare(tabs + flags, list(new))
    params = {k: v.expand((Bw,) + tuple(v.shape)).to(dtype).contiguous()
              for k, v in prob.ocp.params.items()}
    for over in ((False, False), (True, True), (True, False)):
        pp = dict(params)
        for k, o in zip(("u_lb", "u_ub"), over):
            if o:
                pp[k] = torch.full((Bw, ns, nu), float(len(k)), dtype=dtype)
        want = k78.isrbd_al_params_plain(al, pp, st)
        layout, total = k78.params_layout(over, Bw, ns, terms, nu, dtype)
        buf, views = k78.output_views(layout, total, dtype, CPU)
        _disjoint_aligned(buf, views, dtype)
        _fill_and_compare(views, [want[k] for _, k in k78.params_fields(over)])


# ---------------- the solver on outputs of one buffer ----------------

class OneBuffer:
    """The AL entries (on the CPU: their twins) with each call's outputs
    moved into views of one buffer as the CUDA wrappers lay them out, and
    a copy of each buffer as written, to show no consumer writes it."""

    def __init__(self, monkeypatch):
        self.written = []
        for name in ("isrbd_al_constraints", "isrbd_al_shift",
                     "isrbd_al_params", "isrbd_al_prior_update"):
            monkeypatch.setattr(k78, name, getattr(self, name))

    def _keep(self, buf):
        self.written.append((buf, buf.clone()))

    def _moved(self, layout, total, tensors):
        buf, views = k78.output_views(layout, total, tensors[0].dtype, CPU)
        for v, t in zip(views, tensors):
            v.copy_(t)
        self._keep(buf)
        return views

    def isrbd_al_constraints(self, al, X, U, params, st=None, offline=False):
        out = k78.isrbd_al_constraints_plain(al, X, U, params, st, offline)
        mode = 0 if st is None else 2 if offline else 1
        layout, total = k78.output_layout(mode, X.shape[0], X.shape[1] - 1,
                                          al.terms, X.shape[2], U.shape[2],
                                          X.dtype)
        return tuple(self._moved(layout, total, list(out)))

    def isrbd_al_shift(self, al, st, prior=None, phase=None):
        out = k78.isrbd_al_shift_plain(al, st, prior, phase)
        kind, _ = k78.prior_kind(prior)
        X, U = out.sol.X, out.sol.U
        layout, total = k78.shift_layout(kind, X.shape[0], X.shape[1] - 1,
                                         al.terms, X.shape[2], U.shape[2],
                                         X.dtype)
        fields = [getattr(out, f) for f in k78.SHIFTED][:len(layout) - 2]
        views = self._moved(layout, total, [X, U] + fields)
        return out._replace(sol=out.sol._replace(X=views[0], U=views[1]),
                            **dict(zip(k78.SHIFTED, views[2:])))

    def isrbd_al_params(self, al, params, st):
        p = k78.isrbd_al_params_plain(al, params, st)
        over = ("u_lb" in params, "u_ub" in params)
        keys = [k for _, k in k78.params_fields(over)]
        layout, total = k78.params_layout(over, st.lam_eq.shape[0], al.ocp.ns,
                                          al.terms, al.ocp.nu, st.lam_eq.dtype)
        p.update(zip(keys, self._moved(layout, total, [p[k] for k in keys])))
        return p

    def isrbd_al_prior_update(self, al, prior, st, phase, ema):
        new = k78.isrbd_al_prior_update_plain(al, prior, st, phase, ema)
        kind, period = k78.prior_kind(prior)
        tab_l, flag_l, total = k78.prior_layout(
            kind, st.lam_eq.shape[0], period, al.ocp.ns, al.terms,
            st.lam_eq.dtype)
        buf, tabs, flags = k78.prior_views(tab_l, flag_l, total,
                                           st.lam_eq.dtype, CPU)
        for v, t in zip(tabs + flags, new):
            v.copy_(t)
        self._keep(buf)
        return type(new)(*tabs, *flags)


def _serve(al, prob, kind):
    """Two serving ticks with the prior `kind`, then an offline solve:
    every tensor they return."""
    Bm, ns = 2, al.ocp.ns
    x0 = prob.initial_state.expand(Bm, -1).contiguous()
    params = {k: v.expand((Bm,) + tuple(v.shape)).contiguous()
              for k, v in prob.ocp.params.items()}
    st = al.init(x0)
    prior = (None if kind == 0 else al.init_phase_prior(4, Bm) if kind == 1
             else al.init_full_phase_prior(4, Bm))
    got = []
    for tick in range(2):
        phase = torch.tensor([tick, (tick + 3) % 4])
        out = al.serving_tick_batch(st, x0, params, outers=2, prior=prior,
                                    phase=phase)
        st, prior = (out, None) if kind == 0 else out
        got += [t.clone() for t in st.sol] + [t.clone() for t in st[1:]]
        if prior is not None:
            got += [t.clone() for t in prior]
    st = al.solve_batch(al.init(x0), x0, params)
    return got + [t.clone() for t in st.sol] + [t.clone() for t in st[1:]]


@pytest.mark.parametrize("kind", (0, 1, 2), ids=k78.PRIORS)
def test_solver_paths_agree_on_one_buffer_outputs(kind, monkeypatch):
    """The serving tick (each prior) and the offline solve on the AL
    entries' outputs laid out as views of one buffer a call give what they
    give on separate tensors, bit for bit, and leave every buffer as the
    entry wrote it."""
    prob, al = _solver("kangaroo", 8)
    ddp, opts = al_serving_options(1)
    al = ALDDP(prob.ocp, ddp, dataclasses.replace(opts, outer_iters=2))
    want = _serve(al, prob, kind)
    one = OneBuffer(monkeypatch)
    got = _serve(al, prob, kind)
    assert len(one.written) > 0 and len(got) == len(want)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert all(_same(buf, copy) for buf, copy in one.written)
