"""PyTorch port, K7's staged record, its order of work and its one output
buffer, on the CPU.

The card runs K7 (`isrbd_al_constraints_kernel` in `csrc/isrbd_al.cu`);
here no CUDA compiler exists. These tests hold what the wrapper states
about the kernel against the source itself and the twin:

- the shared memory a block takes (`constraints_smem_bytes`) against the
  .cu's `reads`, `run_count`, `region_bytes` and `constraints_smem_bytes`
  evaluated from its text, for every mode, type and AL shape at ns = 7,
  20 and 33, within the 232,448 B a block may take at ns = 20;
- the staging plan of `stage_run` (its statements read from the .cu):
  the 16-byte cp.async pieces of the 16-byte-aligned window around each
  input's member run, dealt over one warp's lanes, cover it once, read no
  16-byte block the run does not touch and land the run inside its region
  where the kernel reads it, at odd ns and at members whose runs start
  off 16 bytes;
- `kernel_order`, a torch model of the kernel's order of work (the
  Euler rows from a lane's row of R I, Iw and Iw ω with the other two
  entries of Iw ω taken from its neighbours; every other equality row
  from the x, u, c_ref and mask runs apart; the cones, the boxes and
  their multipliers element by element; the violation's maximum; the ρ
  schedule), fed the host scalars the entry takes (`al_scalars`):
  against `isrbd_al_constraints_plain` in float64 to 1e-12 of max(1,
  |twin|) with the static bounds and the per-member overrides, infinite
  bounds (the zeros of an unbounded side), a NaN member, and a first and
  a later outer;
- the one output buffer (`output_layout`, `output_views`): contiguous
  views that do not overlap, each 16-byte aligned in it, of the shapes the
  twin returns (those `ALState` takes).

No JAX, no compile.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.config import SRBDConfig
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
SMEM_PER_BLOCK = 232_448  # an H100's shared memory a block may take
ORDER_TOL = 1e-12         # the model's outputs against the twin's
B = 3                     # members a draw; member NAN holds the NaNs
NAN = 1
SHAPES = ("kangaroo", "quadruped")
DTYPES = (torch.float32, torch.float64)
MODES = (0, 1, 2)
SIZES = [(s, d, m, ns) for s in SHAPES for d in DTYPES for m in MODES
         for ns in (7, 20, 33)]


# ---------------- the .cu's text ----------------

def _enum(name):
    body = re.search(r"enum %s \{(.*?)\};" % name, SOURCE, re.S)[1]
    return [t.strip() for t in body.split(",") if t.strip()]


IN = _enum("In")
ENV = {n: i for i, n in enumerate(IN)}
ENV.update({n: i for i, n in enumerate(("kEval", "kOnline", "kOffline"))})


def _c_to_py(expr):
    """A C++ expression of the .cu as Python (integer division, && and ||,
    casts to size_t dropped)."""
    expr = re.sub(r"static_cast<\w+>", "", expr).replace("size_t(", "(")
    expr = re.sub(r"(?<![/*])/(?![/*])", "//", expr)
    return expr.replace("&&", " and ").replace("||", " or ")


def _source_reads(i, mode):
    expr = re.search(r"constexpr bool reads\(int i, int mode\) \{\s*return "
                     r"(.*?);", SOURCE, re.S)[1]
    return bool(eval(_c_to_py(expr), {}, dict(ENV, i=i, mode=mode)))


def _source_run_count(i, ns, shape):
    body = re.search(r"constexpr size_t run_count\(int i, int ns\) \{(.*?)\n\}",
                     SOURCE, re.S)[1]
    z = KERNEL_SHAPES[shape]
    env = dict(ns=ns, **{f"S::{k}": v for k, v in z.items()})
    for cases, expr in re.findall(r"((?:case \w+: )+)return ([^;]+);", body):
        if IN[i] in re.findall(r"case (\w+):", cases):
            for k in sorted(env, key=len, reverse=True):
                expr = expr.replace(k, str(env[k]))
            return eval(_c_to_py(expr))
    return int(re.search(r"default: return (\d+);", body)[1])


def _source_smem_bytes(mode, dtype, ns, shape):
    """The .cu's `constraints_smem_bytes<S, T>(mode, ns)` from its text."""
    region = re.search(r"constexpr size_t region_bytes\(int i, int ns\) "
                       r"\{\s*return (.*?);\n\}", SOURCE, re.S)[1]
    total = re.search(r"constexpr size_t constraints_smem_bytes\(int mode, "
                      r"int ns\) \{.*?return (.*?);\n\}", SOURCE, re.S)[1]
    e = torch.finfo(dtype).bits // 8
    threads = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE)[1])
    env = dict(round16=lambda v: -(-v // 16) * 16, E=e,
               kWarps=threads // 32)
    py = lambda x: _c_to_py(x.replace("sizeof(T)", "E"))
    regions = sum(
        eval(py(region.replace("run_count<S>(i, ns)",
                               str(_source_run_count(i, ns, shape)))), env)
        for i in range(IN.index("kIns")) if _source_reads(i, mode))
    return eval(py(total.replace("bytes", str(regions))), env)


def test_inputs_and_reads_match_the_cuda_source():
    """The wrapper's input order, what each mode reads and each run's
    elements are the .cu's; its block and its limit are the .cu's."""
    assert IN.index("kIns") == len(k78.INPUTS)
    threads = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE)[1])
    assert k78.WARPS == threads // 32
    assert k78.MAX_SMEM == int(re.search(r"kMaxSmem = (\d+);", SOURCE)[1])
    for shape in SHAPES:
        al = _solver(shape, F64)
        for i in range(len(k78.INPUTS)):
            assert [k78.reads(i, m) for m in MODES] == \
                [_source_reads(i, m) for m in MODES], k78.INPUTS[i]
            for ns in (7, 20, 33):
                assert k78.run_count(i, ns, al.terms, 37, 30) == \
                    _source_run_count(i, ns, shape), (k78.INPUTS[i], ns)


@pytest.mark.parametrize("shape,dtype,mode,ns", SIZES,
                         ids=[f"{s}-{str(d)[6:]}-{k78.MODES[m]}-ns{n}"
                              for s, d, m, n in SIZES])
def test_smem_bytes_match_the_cuda_source(shape, dtype, mode, ns):
    al = _solver(shape, F64)
    stated = k78.constraints_smem_bytes(mode, dtype, ns, al.terms, 37, 30)
    assert stated == _source_smem_bytes(mode, dtype, ns, shape)
    if ns == 20:
        assert stated <= SMEM_PER_BLOCK


# ---------------- the staging plan ----------------

# stage_run's statements, each with its Python reading
STAGE_STEPS = (
    ("const uintptr_t lo = s / 16 * 16, hi = (s + count * sizeof(T) + 15) / 16 * 16;",
     lambda s, count, E: dict(lo=s // 16 * 16, hi=(s + count * E + 15) // 16 * 16)),
    ("const int pieces = static_cast<int>((hi - lo) / 16);",
     lambda lo, hi: dict(pieces=(hi - lo) // 16)),
)


def _stage_plan(s, count, E):
    """stage_run's window around the run of `count` elements of E bytes at
    address s, and its 16-byte pieces by lane of the warp that stages it."""
    env = dict(s=s, count=count, E=E)
    for _, step in STAGE_STEPS:
        env.update(step(**{k: env[k] for k in step.__code__.co_varnames}))
    env["by_lane"] = {t: list(range(t, env["pieces"], 32)) for t in range(32)}
    return env


def test_stage_steps_are_the_cuda_source():
    body = re.search(r"void stage_run\(.*?\n\}", SOURCE, re.S)[0]
    for text, _ in STAGE_STEPS:
        assert text in body, text
    for text in ("for (int c = lane; c < pieces; c += 32) "
                 "cp_async<16>(d + 16 * c, g + 16 * c);",):
        assert text in body, text
    assert "return dst + (reinterpret_cast<uintptr_t>(src) % 16) / sizeof(T);" \
        in SOURCE
    # the kernel stages each run the mode reads by the warp the launcher
    # gives it, at the region make_runs places it (the regions' order and
    # sizes of constraints_smem_bytes)
    kernel = re.search(r"isrbd_al_constraints_kernel\(.*?\n\}", SOURCE, re.S)[0]
    assert "if (reads(i, kMode) && warp == R.warp[i])" in kernel
    runs = re.search(r"Runs make_runs\(int mode, int ns, .*?\n\}", SOURCE, re.S)[0]
    assert "R.region[i] = static_cast<int>(off);" in runs
    assert "off += region_bytes<S, T>(i, ns);" in runs


PLAN_CASES = [(s, d, m, ns) for s in SHAPES for d in DTYPES for m in MODES
              for ns in (7, 20)]


@pytest.mark.parametrize("shape,dtype,mode,ns", PLAN_CASES,
                         ids=[f"{s}-{str(d)[6:]}-{k78.MODES[m]}-ns{n}"
                              for s, d, m, n in PLAN_CASES])
def test_staging_covers_each_run_once(shape, dtype, mode, ns):
    """Every member's run of every input the mode reads: the 16-byte
    pieces of the 16-byte-aligned window around it, each copied by one
    lane of its warp, cover the run and read no 16-byte block the run does
    not touch; landed at its source's offset within 16 bytes (`landed`),
    the run lies where the kernel reads it, inside its region; the
    regions lie inside the block's bytes. Tensors start 0-3 elements past
    a 256-byte boundary; the bounds are static tables (member stride 0) or
    per-member; B = 5 members."""
    al = _solver(shape, F64)
    E = torch.finfo(dtype).bits // 8
    smem = k78.constraints_smem_bytes(mode, dtype, ns, al.terms, 37, 30)
    for shift in range(4):
        for per_member in (False, True):
            for b in range(5):
                region = 0
                for i, name in enumerate(k78.INPUTS):
                    if not k78.reads(i, mode):
                        continue
                    count = k78.run_count(i, ns, al.terms, 37, 30)
                    size = -(-(count * E + 16) // 16) * 16
                    stride = (0 if (name in k78.BOUNDS and not per_member)
                              else count)
                    s = 4096 * (i + 1) * 256 + shift * E + b * stride * E
                    plan = _stage_plan(s, count, E)
                    lo, pieces = plan["lo"], plan["pieces"]
                    assert lo % 16 == 0 and pieces > 0
                    assert lo == s // 16 * 16 and \
                        lo + 16 * pieces == -(-(s + count * E) // 16) * 16
                    copied = sorted(c for cs in plan["by_lane"].values()
                                    for c in cs)
                    assert copied == list(range(pieces)), name
                    assert 16 * pieces <= size               # fits its region
                    landed = region + (s % 16) // E * E      # byte offset
                    # the window lands at the region's start: element e of
                    # the run at landed + e·E
                    assert landed == region + (s - lo)
                    assert region % 16 == 0
                    assert landed + count * E <= region + size
                    region += size
                assert region + -(-k78.WARPS * E // 16) * 16 == smem


# ---------------- the kernel's order of work ----------------

_SOLVERS = {}


def _solver(shape, dtype, ns=20):
    key = (shape, dtype, ns)
    if key not in _SOLVERS:
        if shape == "kangaroo":
            prob = build_isrbd_problem(SRBDConfig(dtype=dtype, ns=ns),
                                       kangaroo_line_feet(), device=CPU,
                                       cz_rho_weight=3200.0)
        else:
            q = quadruped_point_feet()
            prob = build_isrbd_problem(
                SRBDConfig(dtype=dtype, ns=ns, lip_height=float(q.com[2]),
                           contact_model=1, number_of_legs=4), q, device=CPU)
        _SOLVERS[key] = (prob, ALDDP(prob.ocp, *al_serving_options(1)))
    return _SOLVERS[key][1]


def _draw(shape, ns, seed):
    """A plan, state and box overrides at the AL shape: a stance with a
    non-unit quaternion, forces whose cones and boxes are active on either
    side, member NAN's r̈ₓ at node 3 and one of its λ NaN; the u boxes'
    infinite sides stay infinite."""
    al = _solver(shape, F64, ns)
    ocp, t = al.ocp, al.terms
    nx, nu, nc = ocp.nx, ocp.nu, t.outer.nc
    n_eq, n_eq_T, n_in = al._sizes
    g = np.random.RandomState(seed)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    X = np.zeros((B, ns + 1, nx))
    X[..., 0:3] = [0.0, 0.0, 0.88] + 0.05 * g.randn(B, ns + 1, 3)
    X[..., 3:7] = [0.1, -0.2, 0.05, 0.97] + 0.02 * g.randn(B, ns + 1, 4)
    X[..., 7:] = g.uniform(-0.3, 0.3, (B, ns + 1, nx - 7))
    U = 0.5 * g.randn(B, ns, nu)
    for q in range(nc):
        U[..., 9 + 6 * q:12 + 6 * q] = [0.0, 0.0, 98.0] + [60.0, 60.0, 5.0] * \
            g.randn(B, ns, 3)
    U[NAN, 3, 0] = np.nan
    pos = lambda *shape: T(np.abs(g.randn(*shape)))
    lam = g.randn(B, ns, n_eq)
    lam[NAN, 2, 4] = np.nan
    st = al.init(T(X[:, 0]))._replace(
        lam_eq=T(lam), lam_eq_T=T(g.randn(B, n_eq_T)),
        mu_ub=5.0 * pos(B, ns, n_in), mu_lb=pos(B, ns, n_in),
        mu_x_ub=pos(B, ns + 1, nx), mu_x_lb=pos(B, ns + 1, nx),
        mu_u_ub=pos(B, ns, nu), mu_u_lb=pos(B, ns, nu),
        rho=T(10.0 ** g.uniform(3, 5, B)))
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    for k in ("mask_srbd", "mask_lip", "mask_lipzone"):
        params[k] = T(g.randint(0, 2, tuple(params[k].shape)))
    params["c_ref"] = 0.05 * pos(B, ns + 1, nc)
    boxes = dict(params)
    for name, lo, hi in (("x", -0.1, 0.1), ("u", 60.0, 130.0)):
        lb = getattr(ocp, f"{name}_lb").expand(B, -1, -1).clone()
        ub = getattr(ocp, f"{name}_ub").expand(B, -1, -1).clone()
        fin = torch.isfinite(ub)
        lb[fin], ub[fin] = lo, hi
        boxes[f"{name}_lb"], boxes[f"{name}_ub"] = lb, ub
    viol_later = T(10.0 ** g.uniform(-3, 3, B))
    return al, T(X), T(U), st, {"static": params, "boxes": boxes}, viol_later


def _dot3(a, b):
    """a₀b₀ + a₁b₁ + a₂b₂ over the last axis, in the kernel's order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _quat_to_rot(o):
    qx, qy, qz, qw = o.unbind(-1)
    xx, yy, zz, ww = qx * qx, qy * qy, qz * qz, qw * qw
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
                        2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
                        2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz],
                       -1).reshape(o.shape[:-1] + (3, 3))


def _relu(v):
    return torch.where(v > 0, v, torch.where(torch.isnan(v), v,
                                             torch.zeros_like(v)))


def _vmax(*parts):
    """The kernel's nan_max over every part's entries of a member, from 0."""
    flat = torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1)
    m = torch.clamp(flat.nan_to_num(nan=-1.0).amax(dim=1), min=0.0)
    return torch.where(torch.isnan(flat).any(dim=1),
                       torch.full_like(m, float("nan")), m)


def kernel_order(al, X, U, params, st=None, offline=False):
    """K7's order of work (csrc/isrbd_al.cu) on the host doubles the entry
    takes (`al_scalars`), in torch."""
    t, ocp = al.terms, al.ocp
    nc, nx, ns = t.outer.nc, ocp.nx, ocp.ns
    n_eq, n_eq_T = t.n_eq, t.n_eq_T
    cm, legs = t.outer.contact_model, t.outer.number_of_legs
    sc = list(k78.al_scalars(al, ocp.dt))
    m, I, eta2, com_z = sc[1], torch.tensor(sc[2:11], dtype=F64).reshape(3, 3), \
        sc[11], sc[18]
    A_fc = torch.tensor(sc[23:38], dtype=F64).reshape(5, 3)
    r = sc[42:]
    vec = lambda v: torch.tensor(v, dtype=F64)
    S, S_T = vec(r[:n_eq]), vec(r[2 * n_eq:2 * n_eq + n_eq_T])
    r = r[2 * n_eq + 2 * n_eq_T:]
    w, w_T = vec(r[:n_eq]), vec(r[n_eq:n_eq + n_eq_T])
    viol_dec, tol, growth, rho_max = r[n_eq + n_eq_T:]
    i_c, i_w, i_cdot = 7, 10 + 3 * nc, 13 + 3 * nc
    n_rel = 2 * legs * (cm - 1)
    x, u = X[:, :ns], U
    cref, ms = params["c_ref"], params["mask_srbd"][..., 0]
    ml, mz = params["mask_lip"][..., 0], params["mask_lipzone"][..., 0]
    f = u[..., 6:].reshape(u.shape[:2] + (nc, 6))[..., 3:]       # (B, ns, nc, 3)
    c = X[..., i_c:i_c + 3 * nc].reshape(X.shape[:2] + (nc, 3))

    def relvel(Xn):
        per = 2 * (cm - 1)
        cols = [(i_cdot + 3 * ((q // per) * cm) + (q % per) % 2,
                 i_cdot + 3 * ((q // per) * cm + (q % per) // 2 + 1) + (q % per) % 2)
                for q in range(n_rel)]
        return [Xn[..., a] - Xn[..., b] for a, b in cols]

    rows = relvel(x)
    rows += [x[..., i_c + 3 * q + 2] - cref[:, :ns, q] for q in range(nc)]
    for a in range(3):                                             # Newton
        fs = torch.zeros_like(u[..., 0])
        for q in range(nc):
            fs = fs + f[..., q, a]
        acc = u[..., a] + 9.81 if a == 2 else u[..., a]
        rows.append(ms[:, :ns] * (m * acc - fs))
    # Euler: lane a's rows of R I and Iw, (Iw ω)_a; the others' from lanes
    R = _quat_to_rot(x[..., 3:7])
    RI = torch.stack([_dot3(R, I[:, j]) for j in range(3)], -1)
    Iw = torch.stack([_dot3(RI, R[..., j, None, :]) for j in range(3)], -1)
    wv = x[..., i_w:i_w + 3]
    h = _dot3(Iw, wv[..., None, :])
    for a in range(3):
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        Iwd = _dot3(Iw[..., a, :], u[..., 3:6])
        wxh = wv[..., a1] * h[..., a2] - wv[..., a2] * h[..., a1]
        tau = torch.zeros_like(Iwd)
        for q in range(nc):
            tau = tau + ((c[:, :ns, q, a1] - x[..., a1]) * f[..., q, a2]
                         - (c[:, :ns, q, a2] - x[..., a2]) * f[..., q, a1])
        rows.append(ms[:, :ns] * ((Iwd + wxh) - tau))
    for a in range(3):                                             # LIP
        zmp = sum(c[:, :ns, q, a] for q in range(nc)) / nc if a < 2 else 0.0
        lip = eta2 * (x[..., a] - zmp) - (9.81 if a == 2 else 0.0)
        rows.append(ml[:, :ns] * (m * (u[..., a] - lip)))
    rows.append(mz[:, :ns] * (x[..., 2] - com_z))
    rows += [mz[:, :ns] * x[..., i_w + a] for a in range(3)]
    hh = S * torch.stack(rows, -1)
    xN = X[:, ns]
    rT = relvel(xN) + [xN[..., i_c + 3 * q + 2] - cref[:, ns, q] for q in range(nc)]
    rT += [mz[:, ns] * (xN[..., 2] - com_z)]
    rT += [mz[:, ns] * xN[..., i_w + a] for a in range(3)]
    hT = S_T * torch.stack(rT, -1)
    g = torch.stack([_dot3(f[..., q, :], A_fc[j]) for q in range(nc)
                     for j in range(5)], -1)
    x_lb, x_ub, u_lb, u_ub = (b.expand(X.shape[0], -1, -1) if b.dim() == 2
                              else b for b in al._bounds_from(params))

    def box(v, lb, ub):
        over = torch.where(torch.isfinite(ub), _relu(v - ub), torch.zeros_like(v))
        under = torch.where(torch.isfinite(lb), _relu(lb - v), torch.zeros_like(v))
        return torch.where((under > over) | torch.isnan(under), under, over)

    viol = _vmax(hh.abs(), hT.abs(), _relu(g), box(X, x_lb, x_ub),
                 box(U, u_lb, u_ub))
    if st is None:
        return hh, hT, g, viol
    rho = st.rho
    lam = st.lam_eq + (rho[:, None, None] * w) * hh
    lamT = st.lam_eq_T + (rho[:, None] * w_T) * hT
    if not offline:
        return lam, lamT, viol

    def side(mu, gap, bnd):
        return torch.where(torch.isfinite(bnd), _relu(mu + rho.reshape(
            (-1,) + (1,) * (mu.dim() - 1)) * gap), torch.zeros_like(mu))
    mu_ub = _relu(st.mu_ub + rho[:, None, None] * g)
    mults = (lam, lamT, mu_ub, torch.zeros_like(st.mu_lb),
             side(st.mu_x_ub, X - x_ub, x_ub), side(st.mu_x_lb, x_lb - X, x_lb),
             side(st.mu_u_ub, U - u_ub, u_ub), side(st.mu_u_lb, u_lb - U, u_lb))
    grown = torch.where(rho * growth > rho_max, torch.full_like(rho, rho_max),
                        rho * growth)
    grow = (viol > viol_dec * st.viol) & (viol > tol)
    return mults + (torch.where(grow, grown, rho), viol)


def _err(got, want):
    """max |got − want| / max(1, |want|) where want is finite; inf where
    the NaNs or the non-finite entries differ."""
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isfinite(got), torch.isfinite(want))):
        return float("inf")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return float(((got - want).abs()[fin] / want.abs()[fin].clamp_min(1.0)).max())


ORDER_CASES = [(s, mode, bnd) for s in SHAPES
               for mode in ("eval", "online", "offline_first", "offline_later")
               for bnd in ("static", "boxes")]


@pytest.mark.parametrize("shape,mode,bounds", ORDER_CASES,
                         ids=[f"{s}-{m}-{b}" for s, m, b in ORDER_CASES])
def test_kernel_order_matches_twin(shape, mode, bounds):
    al, X, U, st, params, viol_later = _draw(shape, 20, seed=11)
    pp = params[bounds]
    if mode == "offline_later":
        st = st._replace(viol=viol_later)
    kw = {} if mode == "eval" else dict(st=st, offline=mode.startswith("offline"))
    want = k78.isrbd_al_constraints_plain(al, X, U, pp, **kw)
    got = kernel_order(al, X, U, pp, **kw)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        assert _err(a, b) <= ORDER_TOL, (i, _err(a, b))
    viol = got[-1]
    assert bool(torch.isnan(viol[NAN])) and not bool(torch.isnan(viol[0]))
    if bounds == "static":
        assert not bool(torch.isfinite(al._bounds[3]).all())   # ±inf sides


# ---------------- the one output buffer ----------------

BUF_CASES = [(s, d, m, Bw) for s in SHAPES for d in DTYPES for m in MODES
             for Bw in (1, 3, 256)]


@pytest.mark.parametrize("shape,dtype,mode,Bw", BUF_CASES,
                         ids=[f"{s}-{str(d)[6:]}-{k78.MODES[m]}-B{b}"
                              for s, d, m, b in BUF_CASES])
def test_output_views_are_the_twins_outputs(shape, dtype, mode, Bw):
    """The call's outputs are contiguous views of one buffer that do not
    overlap, each starting 16-byte aligned, of the shapes and in the order
    of the twin's outputs (the ALState fields the solver takes)."""
    al = _solver(shape, F64, 7)
    ns, nx, nu = 7, 37, 30
    layout, total = k78.output_layout(mode, Bw, ns, al.terms, nx, nu, dtype)
    buf, views = k78.output_views(layout, total, dtype, CPU)
    e = torch.finfo(dtype).bits // 8
    spans = []
    for v in views:
        assert v.is_contiguous() and v.dtype == dtype
        assert v.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        start = (v.data_ptr() - buf.data_ptr()) // e
        assert (v.data_ptr() - buf.data_ptr()) % k78.OUT_ALIGN == 0
        spans.append((start, start + v.numel()))
    spans.sort()
    assert spans[0][0] >= 0 and spans[-1][1] <= total
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    slots = [slot for slot, *_ in layout]
    assert len(set(slots)) == len(slots) and 12 in slots     # viol, once
    # the twin's outputs at the same sizes
    al_small = _solver(shape, F64, ns)
    g = np.random.RandomState(0)
    Xs = torch.as_tensor(g.randn(Bw, ns + 1, nx))
    Us = torch.as_tensor(g.randn(Bw, ns, nu))
    params = {k: v.expand((Bw,) + tuple(v.shape)).contiguous()
              for k, v in al_small.ocp.params.items()}
    st = al_small.init(Xs[:, 0])
    kw = {} if mode == 0 else dict(st=st, offline=mode == 2)
    twin = k78.isrbd_al_constraints_plain(al_small, Xs, Us, params, **kw)
    assert [tuple(v.shape) for v in views] == [tuple(o.shape) for o in twin]
    if mode == 2:
        fields = k78.MULTIPLIERS + ("rho", "viol")
        assert [tuple(v.shape) for v in views] == \
            [tuple(getattr(st, f).shape) for f in fields]
