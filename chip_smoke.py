#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`srbd_horizon_tpu_torch/csrc/` (nvcc, sm_90a, one process per source, in
parallel, into build/kernels/), then:

  1. device: the card's name and power limit; TF32 off for matmuls and
     convolutions;
  2. kernels against their plain PyTorch versions at the fleet width
     (B=512, ns=20, nx=37, nu=24) on inputs from a real linearization of
     perturbed SRBD states: in float64 to 1e-9 relative; in float32
     against the float64 plain result — K1 to 1e-6 relative (it computes
     in float64 on chip, so only float32 storage rounding remains), K3
     (the fused trial, at 1 and 4 step sizes) within 2× the float32
     plain version's own error plus 1e-6, K4 (the linearization) within
     that and below 1e-5; plus each kernel's time from CUDA events, the
     plain version's, and the bound;
  3. the main path: the warm-started closed-loop SRBD fleet tick
     `MPCLoop.tick_batch` at B=512 in float32 (3 warm-up ticks, 20 timed
     ticks of the walk command), with the kernels' launch counts read
     over exactly that run — K4 launches equal K1 launches, K3 launches
     equal the solver's trials, and no `torch.func` transform runs; then
     per-phase times inside 5 more ticks (CUDA events and host clock at
     each phase boundary), 2 profiled ticks (device busy, kernel launches
     per tick), and 3 ticks at B=4096;
  4. the card path against the CPU path at B=8 in float64: 3 warm ticks
     from the same carry, and one cold-start tick at pushes of 0.2 in
     which the backtracking fan runs; iterations and convergence equal,
     plans to 1e-9. The float32 card path against the float64 CPU path
     is printed without a limit.

Each result is printed on a line of its own; a failed phase exits non-zero
without a result. The next-to-last line is the kernel table as JSON; the
last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
B_MAIN = 512
B_LARGE = 4096
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
# K1 carries float32 tensors in float64 on chip, so against the float64
# plain result only the float32 rounding of its inputs and outputs is
# left (unit roundoff 6e-8); 1e-6 of each output's largest value is ~16
# units. The float32 plain twin errs ~1e-2 (Quu is ill-conditioned under
# the 1e6 constraint weight), so a rule scaled by it would test nothing.
K1_F32_TOL = 1e-6
# K4 computes in float32; besides the 2× rule, each output stays below
# this share of its largest value
K4_F32_CAP = 1e-5
TORCH_FUNC_TRANSFORMS = ("vmap", "jacfwd", "jacrev", "jvp", "vjp", "grad",
                         "grad_and_value", "hessian", "functional_call",
                         "linearize")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(tag, **fields):
    print(f"{tag}: " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `reps` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_err(got, want):
    """max |got − want| / max |want| over the entries where `want` is
    finite, in float64; inf if the non-finite entries differ."""
    import torch

    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    g, w = got[fin], want[fin]
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))


def abs_err(got, want):
    import torch

    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, n_flop):
    """(least ms, what bounds it) on the H100's HBM rate and f32 rate."""
    tb, tf = n_bytes / H100_BYTES_PER_S, n_flop / H100_F32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def inv_flops(n):
    """Multiply-adds of the block-Schur n×n inverse (closed forms at
    n ≤ 3 counted as ~n³ operations)."""
    if n <= 3:
        return n ** 3
    k = n // 2
    m = n - k
    return (inv_flops(k) + inv_flops(m)
            + 2 * (k * k * m + m * k * k + m * k * m + k * m * m + k * m * k))


def riccati_flops(Bsz, ns, nx, nu, nt, n_rx, n_ru, n_gx, n_gu, n_b):
    """FLOPs one K1 sweep needs (products as 2 FLOPs per multiply-add)."""
    node = 2 * (
        nx * nx                                  # Vxx d
        + nx * nx * n_rx                         # VA
        + n_ru * n_ru * nu                       # V[ru,ru] Bs
        + n_gx * nx + n_rx * nx                  # Qx
        + n_gu * nu + n_ru * nu                  # Qu
        + n_gu * nu * nu + n_ru * nu * nu        # Quu
        + n_b * nu * nx + n_ru * nu * nx         # Qux
        + n_gx * nx * nx + n_rx * nx * nx        # Qxx
        + nu * nu + nu * nu * nx                 # k, K
        + nu * nx + nu * nx * nx                 # Vx, Vxx update
        + inv_flops(nu)                          # Quu⁻¹ (K2)
    )
    return Bsz * (ns * node + 2 * (nt * nx * nx + nt * nx))


def body_flops(nc):
    """The SRBD rigid-body rates on one node: R, R I Rᵀ, torques, the
    Cramer solve, ȯ."""
    return 30 + 2 * 27 * 2 + 15 * nc + 18 + 50 + 30 + 20


def trial_flops(Bsz, ns, nx, nu, nc, n_rho, nA):
    """FLOPs one K3 call needs: gain application, the SRBD rates and the
    Euler update per node, then ~5 per residual row (value, square, sum)
    and the merit and Armijo test."""
    node = nx + 2 * nu * nx + 3 * nu + body_flops(nc) + 4 * nx + 5 * n_rho
    return nA * Bsz * (ns * node + 5 * 15 + 20)


def linearize_flops(Bsz, ns, nx, nu, nc, n_rho, n_rx, n_ru):
    """FLOPs one K4 call needs, counted from the kernel's arithmetic: the
    rates, R I Rᵀ and its adjugate, ∂b for every column (the four o
    columns ~200 each, the others ~8) and its Cramer solve (18 each), the
    residual rows (~4 each), the dt scaling of Sx and Bs, the defects;
    the terminal rows per member."""
    cols = (nx + nu) * 18 + 4 * 200 + (nx + nu - 4) * 8
    node = (body_flops(nc) + 183 + cols + 4 * n_rho
            + n_rx * nx + n_ru * nu + 2 * nx)
    return Bsz * (ns * node + 15 * 3)


class PhaseClock:
    """`MSDDP.on_phase` callback: a CUDA event and a host time at every
    phase boundary of a tick; each interval is charged to the phase that
    began it, so the phases add up to the span of the tick."""

    def __init__(self):
        self.marks = []

    def __call__(self, name):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def charge(self, dev_ms, host_ms, entries):
        for (n, e0, h0), (_, e1, h1) in zip(self.marks, self.marks[1:]):
            dev_ms[n] += e0.elapsed_time(e1)
            host_ms[n] += (h1 - h0) * 1e3
            entries[n] += 1
        self.marks = []


def tick_spans(loop, carry, inp, ticks):
    """Per-phase device-timeline and host times inside `ticks` real ticks
    (means per tick), and the tick wall time they add up to."""
    import torch

    clock = PhaseClock()
    loop.solver.on_phase = clock
    dev_ms, host_ms, entries = defaultdict(float), defaultdict(float), defaultdict(int)
    walls = []
    try:
        for _ in range(ticks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clock("glue")
            carry, _ = loop.tick_batch(carry, inp)
            clock("end")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            clock.charge(dev_ms, host_ms, entries)
    finally:
        loop.solver.on_phase = None
    per = lambda d: {k: v / ticks for k, v in sorted(d.items())}
    return carry, dict(
        ticks=ticks, tick_wall_ms=statistics.fmean(walls),
        device_span_ms=per(dev_ms),
        device_span_total_ms=sum(dev_ms.values()) / ticks,
        host_ms=per(host_ms), host_total_ms=sum(host_ms.values()) / ticks,
        phase_entries_per_tick=per(entries),
    )


def profile_ticks(loop, carry, inp, tick_ms, ticks=2):
    """Device busy time, kernel launches and the heaviest kernels per tick
    under torch.profiler. The profiler slows the host, so the idle share
    is taken against `tick_ms`, the unprofiled tick time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = loop.solver
    syncs0 = s.host_syncs
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c = carry
        for _ in range(ticks):
            c, _ = loop.tick_batch(c, inp)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / ticks
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    copies = [e for e in kernels if e.key.startswith(("Memcpy", "Memset"))]
    launched = [e for e in kernels if e not in copies]
    elementwise = sum(e.count for e in launched if "elementwise" in e.key.lower())
    return dict(
        profiled_tick_ms=wall, device_busy_ms_per_tick=busy,
        tick_p50_ms=tick_ms, device_idle_share=1.0 - busy / tick_ms,
        syncs_per_tick=(s.host_syncs - syncs0) / ticks,
        kernel_launches_per_tick=sum(e.count for e in launched) / ticks,
        memcpy_memset_per_tick=sum(e.count for e in copies) / ticks,
        elementwise_launches_per_tick=elementwise / ticks,
        top_kernels=[(e.key[:60], e.self_device_time_total / 1e3 / ticks,
                      e.count / ticks) for e in top],
    )


def count_torch_func():
    """Wrap every torch.func transform with a call counter; returns the
    counter and a function that restores the originals."""
    import torch
    import torch.func

    calls = {"n": 0}
    saved = []
    for owner, names in ((torch.func, TORCH_FUNC_TRANSFORMS), (torch, ("vmap",))):
        for name in names:
            if not hasattr(owner, name):
                continue
            orig = getattr(owner, name)

            def wrapped(*a, _orig=orig, **k):
                calls["n"] += 1
                return _orig(*a, **k)

            saved.append((owner, name, orig))
            setattr(owner, name, wrapped)

    def restore():
        for owner, name, orig in saved:
            setattr(owner, name, orig)

    return calls, restore


def main():
    if not (HERE / "srbd_horizon_tpu_torch" / "__init__.py").exists():
        fail("srbd_horizon_tpu_torch/ not found next to chip_smoke.py; run "
             "from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import build
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3
    from srbd_horizon_tpu_torch.math.linalg import lm_spd_inverse
    from srbd_horizon_tpu_torch.runtime.loop import build_srbd_loop, walk_command

    # ---------------- phase 1: device ----------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.build_all(force=True)
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         libraries=[str(build.library_path(n).relative_to(HERE))
                    for n in build.KERNEL_SOURCES])
    for name in build.KERNEL_SOURCES:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # ---------------- phase 2: kernels against plain ----------------
    rng = np.random.RandomState(SEED)
    cfg64 = SRBDConfig(dtype=torch.float64)
    loop64, prob64 = build_srbd_loop(cfg64, DDPOptions(max_iters=5),
                                     device=dev)
    loop32, _ = build_srbd_loop(SRBDConfig(), DDPOptions(max_iters=5),
                                device=dev)
    solver64, solver32 = loop64.solver, loop32.solver
    ocp = prob64.ocp
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    nc = (nx - 13) // 6
    dt = ocp.dt
    opts = solver64.opts
    B = B_MAIN
    x_nom = prob64.initial_state.cpu().numpy()
    u_nom = prob64.static_input.cpu().numpy()
    X = torch.as_tensor(x_nom[None, None] + 0.02 * rng.randn(B, ns + 1, nx),
                        device=dev)
    U = torch.as_tensor(u_nom[None, None] + 0.05 * rng.randn(B, ns, nu),
                        device=dev)
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    rows = solver64.rows
    mu = opts.mu0
    order = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")

    def cast(t, dtype):
        return t.to(dtype).contiguous()

    def k4_args(dtype):
        s = solver64 if dtype == torch.float64 else solver32
        return (cast(X, dtype), cast(U, dtype),
                {k: cast(v, dtype) for k, v in params.items()}, s.terms,
                s.rows, dt, s._wc(dtype))

    # K4: the linearization
    lin64 = k4.srbd_linearize_plain(*k4_args(torch.float64))
    lin_got64 = k4.srbd_linearize(*k4_args(torch.float64))
    lin_p32 = k4.srbd_linearize_plain(*k4_args(torch.float32))
    lin_g32 = k4.srbd_linearize(*k4_args(torch.float32))
    torch.cuda.synchronize()
    k4_e64 = {k: rel_err(lin_got64[k], lin64[k]) for k in order}
    k4_e32 = {k: rel_err(lin_g32[k], lin64[k]) for k in order}
    k4_p32 = {k: rel_err(lin_p32[k], lin64[k]) for k in order}
    k4_abs32 = max(abs_err(lin_g32[k], lin64[k]) for k in order)
    k4_ok32 = all(k4_e32[k] <= 2 * k4_p32[k] + 1e-6 and k4_e32[k] <= K4_F32_CAP
                  for k in order)
    emit("k4_check", f64_rel_err=k4_e64, f64_tol=1e-9, f32_rel_err=k4_e32,
         f32_plain_rel_err=k4_p32,
         f32_rule=f"kernel <= 2*plain + 1e-6 and <= {K4_F32_CAP}",
         f32_max_abs_err=k4_abs32)
    if not (max(k4_e64.values()) <= 1e-9 and k4_ok32):
        fail("K4 (srbd_linearize) disagrees with its plain version")
    lin32 = {k: v.float().contiguous() for k, v in lin64.items()}

    # K1: the Riccati sweep, on the float64 plain linearization
    def k1_args(lin):
        return tuple(lin[k] for k in order) + (mu, rows)

    ref64 = k1.riccati_backward_plain(*k1_args(lin64))
    got64 = k1.riccati_backward(*k1_args(lin64))
    plain32 = k1.riccati_backward_plain(*k1_args(lin32))
    got32 = k1.riccati_backward(*k1_args(lin32))
    torch.cuda.synchronize()
    names = ("ks", "Ks", "dV1", "dV2")
    k1_e64 = max(rel_err(g, r) for g, r in zip(got64, ref64))
    k1_e32 = {n: rel_err(g, r) for n, g, r in zip(names, got32, ref64)}
    k1_p32 = {n: rel_err(g, r) for n, g, r in zip(names, plain32, ref64)}
    k1_abs32 = max(abs_err(g, r) for g, r in zip(got32, ref64))
    k1_ok32 = all(k1_e32[n] <= K1_F32_TOL for n in names)
    emit("k1_check", f64_rel_err=k1_e64, f64_tol=1e-9,
         f32_rel_err=k1_e32, f32_tol=K1_F32_TOL, f32_plain_rel_err=k1_p32,
         f32_max_abs_err=k1_abs32)
    if not (k1_e64 <= 1e-9 and k1_ok32):
        fail("K1 (riccati_backward) disagrees with its plain version")

    # K3: the fused trial; member 7 starts from a NaN state, so its cost
    # and merit are NaN and its flags must be False
    x0 = X[:, 0] + torch.as_tensor(0.005 * rng.randn(B, nx), device=dev)
    x0[7] = float("nan")
    ks64, Ks64, dV1_64, dV2_64 = ref64
    D64 = torch.sum(lin64["d"] ** 2, dim=(1, 2))
    merit0_64 = solver64.total_cost(X, U, params) + opts.defect_weight * D64
    alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=torch.float64,
                           device=dev)

    def k3_args(dtype, alphas):
        s = solver64 if dtype == torch.float64 else solver32
        c = lambda t: cast(t, dtype)
        return (c(x0), c(X), c(U), c(ks64), c(Ks64), c(lin64["d"]),
                c(alphas), {k: c(v) for k, v in params.items()},
                c(merit0_64), c(D64), c(dV1_64), c(dV2_64), s.terms, dt,
                s._wc(dtype), opts.defect_weight, opts.beta,
                opts.alpha_converge_threshold)

    out_names = ("Xn", "Un", "cost", "merit")
    k3_e64, k3_e32, k3_p32, k3_abs32, k3_flags = {}, {}, {}, 0.0, {}
    k3_fine = True
    for nA in (1, 4):
        al = alphas4[:nA]
        ref = k3.srbd_trial_plain(*k3_args(torch.float64, al))
        got = k3.srbd_trial(*k3_args(torch.float64, al))
        p32 = k3.srbd_trial_plain(*k3_args(torch.float32, al))
        g32 = k3.srbd_trial(*k3_args(torch.float32, al))
        torch.cuda.synchronize()
        e64 = {n: rel_err(g, r) for n, g, r in zip(out_names, got, ref)}
        e32 = {n: rel_err(g, r) for n, g, r in zip(out_names, g32, ref)}
        ep32 = {n: rel_err(g, r) for n, g, r in zip(out_names, p32, ref)}
        k3_abs32 = max(k3_abs32, max(abs_err(g, r) for g, r in zip(g32, ref)))
        # float32 flags against the float64 ones, except where the
        # float64 Armijo margin is within rounding of zero
        a = al[:, None]
        margin = (merit0_64 - ref[3]) - opts.beta * torch.clamp(
            -(a * dV1_64 + a * a * dV2_64)
            + (2 * a - a * a) * opts.defect_weight * D64, min=1e-16)
        near = margin.abs() <= 1e-4 * merit0_64.abs().clamp_min(1.0)
        flips32 = int(((g32[4] != ref[4]) & ~near).sum())
        k3_flags[nA] = dict(
            f64_flags_equal=bool(torch.equal(got[4], ref[4])),
            f32_flips_off_margin=flips32, near_margin=int(near.sum()),
            accepted=int(ref[4].sum()), nan_member_rejected=not bool(got[4][:, 7].any()))
        k3_e64[nA], k3_e32[nA], k3_p32[nA] = e64, e32, ep32
        k3_fine &= (max(e64.values()) <= 1e-9
                    and all(e32[n] <= 2 * ep32[n] + 1e-6 for n in out_names)
                    and k3_flags[nA]["f64_flags_equal"] and flips32 == 0
                    and k3_flags[nA]["nan_member_rejected"])
    emit("k3_check", f64_rel_err=k3_e64, f64_tol=1e-9, f32_rel_err=k3_e32,
         f32_plain_rel_err=k3_p32, f32_rule="kernel <= 2*plain + 1e-6",
         flags=k3_flags, f32_max_abs_err=k3_abs32)
    if not k3_fine:
        fail("K3 (srbd_trial) disagrees with its plain version")

    # timing at the main path's shapes and type (float32, B=512)
    l32 = k4_args(torch.float32)
    k4_ms = cuda_ms(lambda: k4.srbd_linearize(*l32), reps=20)
    k4_plain_ms = cuda_ms(lambda: k4.srbd_linearize_plain(*l32), reps=3,
                          warmup=1)
    k4_bytes = nbytes(l32[0], l32[1], *k4.kernel_params(
        l32[2], B, ns, nc, torch.float32, dev), rows.packed(dev),
        *lin_g32.values())
    n_rho = solver32.terms.n_rho
    k4_flop = linearize_flops(B, ns, nx, nu, nc, n_rho, len(rows.rx),
                              len(rows.ru))
    k4_bound, k4_by = bound(k4_bytes, k4_flop)

    a32 = k1_args(lin32)
    k1_ms = cuda_ms(lambda: k1.riccati_backward(*a32), reps=20)
    k1_plain_ms = cuda_ms(lambda: k1.riccati_backward_plain(*a32), reps=3,
                          warmup=1)
    k1_bytes = nbytes(*(lin32[k] for k in order), rows.packed(dev), *got32)
    k1_flop = riccati_flops(B, ns, nx, nu, lin32["Jt"].shape[1],
                            len(rows.rx), len(rows.ru), len(rows.gx),
                            len(rows.gu), len(rows.bx))
    k1_bound, k1_by = bound(k1_bytes, k1_flop)

    x0[7] = x0[6]
    r32 = k3_args(torch.float32, alphas4[:1])
    k3_ms = cuda_ms(lambda: k3.srbd_trial(*r32), reps=50)
    k3_plain_ms = cuda_ms(lambda: k3.srbd_trial_plain(*r32), reps=3,
                          warmup=1)
    k3_out = k3.srbd_trial(*r32)
    k3_in = [t for t in r32[:12] if isinstance(t, torch.Tensor)]
    k3_bytes = nbytes(*k3_in, *k4.kernel_params(r32[7], B, ns, nc,
                                                torch.float32, dev), *k3_out)
    k3_flop = trial_flops(B, ns, nx, nu, nc, n_rho, 1)
    k3_bound, k3_by = bound(k3_bytes, k3_flop)
    r32_fan = k3_args(torch.float32, alphas4)
    k3_fan_ms = cuda_ms(lambda: k3.srbd_trial(*r32_fan), reps=50)

    # K2 yardstick: the (B·ns, nu, nu) Quu-like SPD stack 2JupᵀJup + μI,
    # inverted by one library call and by the plain block-Schur twin; the
    # bound is that of the stack alone (read once, written once)
    Jup = lin32["Jup"].reshape(B * ns, -1, nu)
    Q = 2.0 * Jup.transpose(-1, -2) @ Jup + mu * torch.eye(
        nu, device=dev, dtype=torch.float32)
    inv_lib_ms = cuda_ms(lambda: torch.linalg.inv(Q), reps=20)
    inv_plain_ms = cuda_ms(lambda: lm_spd_inverse(Q), reps=20)
    k2_bound, k2_by = bound(2 * nbytes(Q), 2 * inv_flops(nu) * B * ns)
    emit("k2_yardstick", stack=list(Q.shape), dtype="float32",
         torch_linalg_inv_ms=inv_lib_ms, lm_spd_inverse_plain_ms=inv_plain_ms,
         bound_ms=k2_bound, bound_by=k2_by, bytes=2 * nbytes(Q),
         flop=2 * inv_flops(nu) * B * ns)
    emit("kernel_times", card=card,
         srbd_linearize_ms=k4_ms, srbd_linearize_plain_ms=k4_plain_ms,
         srbd_linearize_bound_ms=k4_bound, srbd_linearize_bytes=k4_bytes,
         srbd_linearize_flop=k4_flop,
         riccati_backward_ms=k1_ms, riccati_backward_plain_ms=k1_plain_ms,
         riccati_bound_ms=k1_bound, riccati_bytes=k1_bytes,
         riccati_flop=k1_flop,
         srbd_trial_ms=k3_ms, srbd_trial_plain_ms=k3_plain_ms,
         srbd_trial_bound_ms=k3_bound, srbd_trial_bytes=k3_bytes,
         srbd_trial_flop=k3_flop, srbd_trial_4alpha_ms=k3_fan_ms)
    del lin64, lin32, lin_got64, lin_p32, lin_g32, ref64, got64, plain32, got32

    # ---------------- phase 3: the main path ----------------
    def run_main(Bsz, warm, timed):
        loop, prob = build_srbd_loop(SRBDConfig(), DDPOptions(max_iters=5),
                                     shift_warmstart=True, device=dev)
        trials = {"n": 0}
        trial = loop.solver._trial

        def counted_trial(*a):
            trials["n"] += 1
            return trial(*a)

        loop.solver._trial = counted_trial
        g = np.random.RandomState(SEED)
        xn = prob.initial_state.cpu().numpy()
        x0 = torch.as_tensor(xn[None] + 0.005 * g.randn(Bsz, nx),
                             dtype=torch.float32, device=dev)
        carry = loop.init(x0)
        inp = walk_command(Bsz, vx=0.2, device=dev)
        for _ in range(warm):
            carry, out = loop.tick_batch(carry, inp)
        torch.cuda.synchronize()
        syncs0 = loop.solver.host_syncs
        times, iters, outs = [], [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            carry, out = loop.tick_batch(carry, inp)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            iters.append(float(out.iterations.float().mean()))
            outs.append(out)
        finite = all(
            bool(torch.isfinite(t).all())
            for o in outs for t in (o.x, o.u0, o.cost, o.srbd_residual)
        ) and bool(torch.isfinite(carry.sol.X).all())
        loop.solver._trial = trial
        runs.append((loop, carry, inp))
        return dict(
            B=Bsz, dtype="float32", warmup_ticks=warm, ticks=timed,
            tick_p50_ms=statistics.median(times), tick_max_ms=max(times),
            tick_mean_ms=statistics.fmean(times),
            members_per_s=Bsz / statistics.median(times) * 1e3,
            iters_mean=statistics.fmean(iters),
            syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
            trials=trials["n"], finite=finite,
            defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
            srbd_residual_max=max(float(o.srbd_residual.abs().max())
                                  for o in outs),
            card=card,
        )

    runs = []
    func_calls, restore_func = count_torch_func()
    k1.riccati_backward.launches = 0
    k3.srbd_trial.launches = 0
    k4.srbd_linearize.launches = 0
    main = run_main(B_MAIN, warm=3, timed=20)
    launches = {"riccati_backward": k1.riccati_backward.launches,
                "srbd_trial": k3.srbd_trial.launches,
                "srbd_linearize": k4.srbd_linearize.launches}
    restore_func()
    main["launches"] = launches
    main["torch_func_calls"] = func_calls["n"]
    emit("main_path", **main)
    if not main["finite"]:
        fail("main path produced non-finite values")
    if max(main["defect_norm_max"], main["srbd_residual_max"]) > 1e-4:
        fail("main path plans are not dynamically consistent (defect or "
             "Newton-Euler residual above 1e-4)")
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    if launches["srbd_linearize"] != launches["riccati_backward"]:
        fail(f"K4 launches differ from K1 launches: {launches}")
    if launches["srbd_trial"] != main["trials"]:
        fail(f"K3 launches {launches['srbd_trial']} do not cover the "
             f"{main['trials']} trials")
    if func_calls["n"]:
        fail(f"the main path ran {func_calls['n']} torch.func transforms")

    loop, carry, inp = runs[0]
    carry, spans = tick_spans(loop, carry, inp, ticks=5)
    emit("tick_spans", B=B_MAIN, card=card, **spans)
    emit("tick_profile", B=B_MAIN, card=card,
         **profile_ticks(loop, carry, inp, main["tick_p50_ms"]))

    large = run_main(B_LARGE, warm=1, timed=2)
    emit("main_path_large", **large)
    if not large["finite"]:
        fail("B=4096 ticks produced non-finite values")

    # ---------------- phase 4: card path against CPU path ----------------
    def ticks_b8(device, dtype, n_ticks, scale):
        loop, prob = build_srbd_loop(SRBDConfig(dtype=dtype),
                                     DDPOptions(max_iters=5),
                                     shift_warmstart=True, device=device)
        fans = {"n": 0}
        run_fan = loop.solver._run_fan

        def counted_fan(*a):
            fans["n"] += 1
            return run_fan(*a)

        loop.solver._run_fan = counted_fan
        g = np.random.RandomState(SEED + 1)
        xn = prob.initial_state.cpu().numpy()
        x0 = torch.as_tensor(xn[None] + scale * g.randn(8, nx), dtype=dtype,
                             device=device)
        carry = loop.init(x0)
        inp = walk_command(8, vx=0.2, dtype=dtype, device=device)
        outs = []
        for _ in range(n_ticks):
            carry, out = loop.tick_batch(carry, inp)
            outs.append(out)
        return carry, outs, fans["n"]

    def compare(tag, gpu, cpu, tol):
        (c_gpu, o_gpu, fans_gpu), (c_cpu, o_cpu, fans_cpu) = gpu, cpu
        it_diff = [int((a.iterations.cpu().long() - b.iterations.long()).abs().sum())
                   for a, b in zip(o_gpu, o_cpu)]
        same_conv = all(torch.equal(a.converged.cpu(), b.converged)
                        for a, b in zip(o_gpu, o_cpu))
        eX = rel_err(c_gpu.sol.X.cpu(), c_cpu.sol.X)
        eU = rel_err(c_gpu.sol.U.cpu(), c_cpu.sol.U)
        ex = max(rel_err(a.x.cpu(), b.x) for a, b in zip(o_gpu, o_cpu))
        res = dict(B=8, ticks=len(o_cpu), iteration_abs_diff=it_diff,
                   iterations_equal=not any(it_diff), converged_equal=same_conv,
                   X_rel_err=eX, U_rel_err=eU, x_rel_err=ex,
                   fan_runs_card=fans_gpu, fan_runs_cpu=fans_cpu, tol=tol)
        emit(tag, **res)
        return res

    f64 = torch.float64
    cpu3 = ticks_b8("cpu", f64, 3, 0.005)
    warm = compare("card_vs_cpu", ticks_b8(dev, f64, 3, 0.005), cpu3, 1e-9)
    fan = compare("card_vs_cpu_fan", ticks_b8(dev, f64, 1, 0.2),
                  ticks_b8("cpu", f64, 1, 0.2), 1e-9)
    compare("card_f32_vs_cpu_f64", ticks_b8(dev, torch.float32, 3, 0.005),
            cpu3, None)
    for res, what in ((warm, "warm ticks"), (fan, "the fan tick")):
        if not (res["iterations_equal"] and res["converged_equal"]
                and max(res["X_rel_err"], res["U_rel_err"], res["x_rel_err"]) <= 1e-9):
            fail(f"card path and CPU path disagree ({what})")
    if fan["fan_runs_card"] == 0:
        fail("the backtracking fan did not run in the fan tick")

    kernels = [
        dict(name="srbd_linearize", route="cuda", source=k4.SOURCE,
             replaces=k4.REPLACES, launches=launches["srbd_linearize"],
             max_abs_err=k4_abs32, ms=k4_ms, plain_ms=k4_plain_ms,
             bound_ms=k4_bound, bound_by=k4_by, library_ms=None,
             max_rel_err_f64=max(k4_e64.values()), tol_f64=1e-9,
             max_rel_err_f32=max(k4_e32.values()),
             tol_f32=f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}",
             plain_rel_err_f32=max(k4_p32.values())),
        dict(name="riccati_backward", route="cuda", source=k1.SOURCE,
             replaces=k1.REPLACES, launches=launches["riccati_backward"],
             max_abs_err=k1_abs32, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=k1_bound, bound_by=k1_by, library_ms=None,
             max_rel_err_f64=k1_e64, tol_f64=1e-9,
             max_rel_err_f32=max(k1_e32.values()), tol_f32=K1_F32_TOL,
             plain_rel_err_f32=max(k1_p32.values())),
        dict(name="srbd_trial", route="cuda", source=k3.SOURCE,
             replaces=k3.REPLACES, launches=launches["srbd_trial"],
             max_abs_err=k3_abs32, ms=k3_ms, plain_ms=k3_plain_ms,
             bound_ms=k3_bound, bound_by=k3_by, library_ms=None,
             max_rel_err_f64=max(max(e.values()) for e in k3_e64.values()),
             tol_f64=1e-9,
             max_rel_err_f32=max(max(e.values()) for e in k3_e32.values()),
             tol_f32="2*plain_rel_err_f32 + 1e-6",
             plain_rel_err_f32=max(max(e.values()) for e in k3_p32.values())),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
