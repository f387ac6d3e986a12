"""PyTorch port, K12's layout and its combine's elimination, on the CPU.

The card runs K12 (`csrc/riccati_associative.cu`); here no CUDA compiler
exists. These tests hold what the wrapper states about the kernel against
the source itself: the shared memory a block of each phase takes
(`phase_bytes`) against the layout structs `ElemSmem`, `CombineSmem` and
`GainSmem` evaluated from the .cu's text at each of the 26
instantiations, each within the 232,448 B a block may take, the combine at
nx = 37 within the 76,800 B that let three blocks share an SM and the
element block of the isrbd-AL shapes within the 115,712 B of two, the
element and gain blocks at the nx = 37 SRBD shapes within the room of
four; the panel width, substitution block and launch bound against the
.cu's constants. Then `blocked_lu_solve`, a numpy model of the combine's
blocked pivoted elimination at the kernel's panel width, on drawn combines
at nx = 18, 25, 30 and 37 in float64 (nx = 18: three panels and a last
substitution block of two rows): it picks LAPACK's pivots (getrf through
`torch.linalg.lu_factor`), takes the first of equal largest entries, and a
combine built on it agrees with the twin's `combine_plain` to 1e-12
relative, output by output, on draws whose I + C₁J₂ has a condition number
of at most 1e4.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
from srbd_horizon_tpu_torch.kernels.riccati import KERNEL_SHAPES

torch.set_num_threads(1)

SOURCE = (Path(k12.__file__).resolve().parents[1] / "csrc"
          / "riccati_associative.cu").read_text()
PANEL = 6                 # the kernel's panel width (kPanel)
BLOCK = 8                 # and its substitution's block of rows (kBlock)
SMEM_PER_BLOCK = 232_448  # an H100's shared memory a block may take
SMEM_PER_SM = 233_472     # and an SM's (each block also holds 1 KB of it)
COND_MAX = 1e4            # the draws' largest condition number of I + C₁J₂
COMBINE_TOL = 1e-12       # the model's combine against the twin's, relative
NX = (18, 25, 30, 37)


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


def _evaluate(name, env):
    """Struct `name`'s fields evaluated from the .cu's text in `env` (the
    shape's sizes, G, earlier structs' fields as `Rows_<field>`)."""
    env = dict(env)
    for field, expr in _struct_fields(name):
        py = (expr.replace("Rows<S>::", "Rows_").replace("S::", "")
              .replace("Solve::kSchur", "0").replace("Solve::kCholesky", "1"))
        py = re.sub(r"(?<!/)/(?!/)", "//", py)
        env[field] = int(eval(py, {"lead": k12.lead, "cmax": max,
                                    "inv_work": k12.inv_work}, env))
    return env


def _source_bytes(shape, quu_solver):
    z = KERNEL_SHAPES[shape]
    env = dict(z, G=0 if quu_solver == "schur" else 1)
    rows = _evaluate("Rows", env)
    env.update({f"Rows_{k}": v for k, v in rows.items() if k not in z})
    return dict(element=_evaluate("ElemSmem", env)["bytes"],
                combine=_evaluate("CombineSmem", {"nx": z["nx"]})["bytes"],
                gain=_evaluate("GainSmem", env)["bytes"])


@pytest.mark.parametrize("shape,quu_solver", k12.KERNEL_INSTANCES,
                         ids=[f"{s}-{g}" for s, g in k12.KERNEL_INSTANCES])
def test_phase_bytes_match_the_cuda_layout(shape, quu_solver):
    """The wrapper's per-phase bytes are the .cu's layout structs', and
    each fits a block."""
    stated = k12.phase_bytes(shape, quu_solver)
    assert stated == _source_bytes(shape, quu_solver)
    assert max(stated.values()) <= SMEM_PER_BLOCK


def blocked_lu_solve(G, R, panel=PANEL, block=BLOCK):
    """The combine's elimination in numpy (float64): G X = R by a blocked
    right-looking LU with partial pivoting in panels of `panel` columns —
    the first largest |entry| of the updated column, multipliers by the
    pivot's reciprocal, the swaps and the unit-triangular solve deferred to
    the columns right of the panel, the trailing rows updated a panel at a
    time — then a back substitution in blocks of `block` rows from the
    bottom (each diagonal block solved against the pivots' reciprocals, the
    rows above updated). Returns (X, the pivot rows)."""
    n = G.shape[0]
    a = np.concatenate([np.asarray(G, float), np.asarray(R, float)], axis=1)
    piv = np.zeros(n, dtype=int)
    rdiag = np.zeros(n)
    for k0 in range(0, n, panel):
        kb = min(panel, n - k0)
        for j in range(k0, k0 + kb):
            col = np.abs(a[j:, j])
            p = j + int(np.argmax(np.where(np.isnan(col), 0.0, col)))
            piv[j] = p
            a[[j, p], k0:k0 + kb] = a[[p, j], k0:k0 + kb]
            rdiag[j] = 1.0 / a[j, j]
            a[j + 1:, j] *= rdiag[j]
            a[j + 1:, j + 1:k0 + kb] -= np.outer(a[j + 1:, j],
                                                 a[j, j + 1:k0 + kb])
        right = slice(k0 + kb, None)
        for j in range(k0, k0 + kb):
            a[[j, piv[j]], right] = a[[piv[j], j], right]
        for i in range(1, kb):
            a[k0 + i, right] -= a[k0 + i, k0:k0 + i] @ a[k0:k0 + i, right]
        a[k0 + kb:, right] -= a[k0 + kb:, k0:k0 + kb] @ a[k0:k0 + kb, right]
    X = a[:, n:]
    for r0 in range((n - 1) // block * block, -1, -block):
        kb = min(block, n - r0)
        for i in range(kb - 1, -1, -1):
            r = r0 + i
            X[r] = (X[r] - a[r, r + 1:r0 + kb] @ X[r + 1:r0 + kb]) * rdiag[r]
        X[:r0] -= a[:r0, r0:r0 + kb] @ X[r0:r0 + kb]
    return X, piv


def _blocks_an_sm(nbytes):
    return SMEM_PER_SM // (nbytes + 1024)


def test_combine_fits_three_blocks_an_sm():
    """The combine at nx = 37 (six shapes share it) takes ≤ 76,800 B, so
    three blocks share an SM, as its launch bound asks; the smaller nx fit
    at least as many (K12 is built at K1's first fourteen shapes; the
    square feet's are K1's alone)."""
    for shape in dict.fromkeys(s for s, _ in k12.KERNEL_INSTANCES):
        got = k12.phase_bytes(shape, "cholesky")["combine"]
        assert _blocks_an_sm(got) >= k12.COMBINE_BLOCKS_PER_SM, shape
    assert k12.phase_bytes("srbd", "schur")["combine"] == 74_740 <= 76_800


def test_isrbd_al_element_fits_two_blocks_an_sm():
    """The element block of the AL shapes takes ≤ 115,712 B: two blocks an
    SM."""
    for shape in ("isrbd_al", "isrbd_al_quadruped"):
        got = k12.phase_bytes(shape, "cholesky")["element"]
        assert got <= 115_712 and _blocks_an_sm(got) == 2, (shape, got)


@pytest.mark.parametrize("shape", ["srbd", "quadruped", "srbd_rk",
                                   "quadruped_rk"])
def test_element_and_gain_fit_four_blocks_an_sm(shape):
    """At the nx = 37 SRBD shapes the element and gain blocks, whose
    inverse and solution take the place of the consumed residual rows and
    products, fit four blocks an SM with either gain solve."""
    for sv in ("schur", "cholesky"):
        got = k12.phase_bytes(shape, sv)
        assert _blocks_an_sm(got["element"]) >= 4, (shape, sv, got)
        assert _blocks_an_sm(got["gain"]) >= 4, (shape, sv, got)


def test_constants_match_the_cuda_source():
    """The panel width, the substitution's block and the combine's blocks
    an SM are the .cu's `kPanel`, `kBlock` and `kCombineBlocks`, its
    launch bound names the latter, and `lead` is the .cu's stride (4 mod
    8, no shorter than asked)."""
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
    assert int(const["kPanel"]) == PANEL and int(const["kBlock"]) == BLOCK
    assert int(const["kCombineBlocks"]) == k12.COMBINE_BLOCKS_PER_SM
    assert "__launch_bounds__(kCombineThreads, kCombineBlocks)" in SOURCE
    body = re.search(r"constexpr int lead\(int n\) \{ return ([^;]+); \}",
                     SOURCE).group(1)
    for n in range(1, 200):
        assert eval(body, {"n": n}) == k12.lead(n)
        assert k12.lead(n) >= n and k12.lead(n) % 8 == 4


def _draw_element(rng, nx, scale):
    A = np.eye(nx) + 0.3 * rng.randn(nx, nx) / np.sqrt(nx)
    Bc = rng.randn(nx, nx // 2) * np.sqrt(scale / nx)
    Bj = rng.randn(nx, nx) * np.sqrt(scale / nx)
    return dict(A=A, C=Bc @ Bc.T, J=Bj @ Bj.T, b=rng.randn(nx),
                eta=rng.randn(nx))


def _draws(nx, seed, count=4):
    """Pairs of drawn elements (earlier, later) whose I + C₁J₂ has a
    condition number of at most COND_MAX, scales 0.1 … 100."""
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < count:
        e1, e2 = (_draw_element(rng, nx, 10.0 ** rng.uniform(-1, 2))
                  for _ in range(2))
        if np.linalg.cond(np.eye(nx) + e1["C"] @ e2["J"]) <= COND_MAX:
            out.append((e1, e2))
    return out


def _combine_model(e1, e2):
    """`combine_plain`'s formulas in numpy on `blocked_lu_solve`, with the
    kernel's products: J = (A₁ᵀJ₂)MA₁ + J₁."""
    nx = e1["A"].shape[0]
    G = np.eye(nx) + e1["C"] @ e2["J"]
    R = np.concatenate([e1["A"], e1["C"],
                        (e1["b"] - e1["C"] @ e2["eta"])[:, None]], axis=1)
    M, piv = blocked_lu_solve(G, R)
    MA, MC, Mb = M[:, :nx], M[:, nx:2 * nx], M[:, 2 * nx]
    w = e2["eta"] + e2["J"] @ e1["b"]
    return dict(A=e2["A"] @ MA, b=e2["A"] @ Mb + e2["b"],
                C=(e2["A"] @ MC) @ e2["A"].T + e2["C"],
                eta=MA.T @ w + e1["eta"],
                J=(e1["A"].T @ e2["J"]) @ MA + e1["J"]), piv


def _lapack_pivots(G):
    return torch.linalg.lu_factor(torch.from_numpy(G))[1].numpy() - 1


@pytest.mark.parametrize("nx", NX)
@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_elimination_picks_lapack_pivots(nx, seed):
    """On drawn combines' I + C₁J₂ (and on a general matrix, where rows
    move often) the model's pivot rows are LAPACK's getrf's, and its
    solution is the solve's."""
    mats = [np.eye(nx) + e1["C"] @ e2["J"] for e1, e2 in _draws(nx, seed)]
    mats.append(np.random.RandomState(seed + 10).randn(nx, nx))
    rng = np.random.RandomState(seed + 20)
    for G in mats:
        R = rng.randn(nx, 2 * nx + 1)
        X, piv = blocked_lu_solve(G, R)
        assert np.array_equal(piv, _lapack_pivots(G))
        want = np.linalg.solve(G, R)
        assert np.abs(X - want).max() <= 1e-10 * np.abs(want).max()


def test_pivot_ties_take_the_first_row():
    """Equal largest |entries| in a column: the first row wins (LAPACK's
    idamax), whatever their signs."""
    rng = np.random.RandomState(5)
    G = rng.uniform(-1.0, 1.0, (11, 11))
    G[:, 0] = 0.5
    G[3, 0], G[7, 0] = -4.0, 4.0
    G[9, 1] = 1e3            # column 1's largest after the first step
    _, piv = blocked_lu_solve(G, np.eye(11))
    assert piv[0] == 3
    assert np.array_equal(piv, _lapack_pivots(G))


@pytest.mark.parametrize("nx", NX)
def test_blocked_combine_matches_the_twin(nx):
    """A combine on the blocked elimination agrees with `combine_plain`
    (LAPACK's solve) to 1e-12 relative on every output, on draws with
    cond(I + C₁J₂) ≤ 1e4."""
    for e1, e2 in _draws(nx, 100 + nx):
        got, _ = _combine_model(e1, e2)
        want = k12.combine_plain({k: torch.from_numpy(v) for k, v in e1.items()},
                                 {k: torch.from_numpy(v) for k, v in e2.items()})
        for k, w in want.items():
            w = w.numpy()
            assert np.abs(got[k] - w).max() <= COMBINE_TOL * np.abs(w).max(), k
