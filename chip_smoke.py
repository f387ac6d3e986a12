#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`srbd_horizon_tpu_torch/csrc/` (nvcc, sm_90a, into build/kernels/), then:

  1. device: the card's name and power limit; TF32 off for matmuls and
     convolutions;
  2. kernels against their plain PyTorch versions at the fleet width
     (B=512, ns=20, nx=37, nu=24) on inputs from a real linearization of
     perturbed SRBD states: in float64 to 1e-9 relative; in float32
     against the float64 plain result, K1 to 1e-6 relative (it computes
     in float64 on chip, so only float32 storage rounding remains) and K3
     within 2× the float32 plain version's own error plus 1e-6 relative;
     plus each kernel's time from CUDA events, the plain version's, and
     the bound;
  3. the main path: the warm-started closed-loop SRBD fleet tick
     `MPCLoop.tick_batch` at B=512 in float32 (3 warm-up ticks, 20 timed
     ticks of the walk command), with the kernels' launch counts read
     over exactly that run; then 3 ticks at B=4096;
  4. the card path against the CPU path: 3 ticks at B=8 in float64 from
     the same carry, iterations and convergence equal, plans to 1e-9.

Each result is printed on a line of its own; a failed phase exits non-zero
without a result. The next-to-last line is the kernel table as JSON; the
last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time
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
    """max |got − want| / max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def abs_err(got, want):
    return float((got.double() - want.double()).abs().max())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def inv_flops(n):
    """Multiply-add FLOPs of the block-Schur n×n inverse (closed forms at
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
    ) + inv_flops(nu)
    return Bsz * (ns * node + 2 * (nt * nx * nx + nt * nx))


def rollout_flops(Bsz, ns, nx, nu, nc, nA):
    """FLOPs one K3 call needs: gain application, the SRBD rates
    (R, R I Rᵀ, torques, Cramer solve, ȯ) and the Euler update."""
    body = 30 + 2 * 27 * 2 + 15 * nc + 18 + 50 + 30 + 20
    node = nx + 2 * nu * nx + 3 * nu + body + 4 * nx
    return nA * Bsz * ns * node


def host_ms(fn, reps=3):
    """Mean wall time of fn() in ms, each run ended by a device sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def breakdown(loop, carry, inp, card, tick_ms):
    """Where a warm tick's time goes: each solver phase timed alone on the
    warm plan, then two ticks under torch.profiler for the device's busy
    time and its heaviest kernels. The profiler slows the host, so the
    idle share is taken against `tick_ms`, the unprofiled tick time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = loop.solver
    X, U, params, x = carry.sol.X, carry.sol.U, carry.params, carry.x
    lin = s._linearize_sliced(X, U, params)
    ks, Ks, dV1, dV2 = s._backward_lanemajor(lin, s.opts.mu0)
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    merit0 = carry.sol.cost + s.opts.defect_weight * D
    alpha0 = torch.ones(1, dtype=X.dtype, device=X.device)
    out = dict(
        B=X.shape[0],
        linearize_ms=host_ms(lambda: s._linearize_sliced(X, U, params)),
        riccati_kernel_ms=cuda_ms(
            lambda: s._backward_lanemajor(lin, s.opts.mu0), reps=10),
        alpha0_trial_ms=host_ms(lambda: s._trial(
            alpha0, x, X, U, ks, Ks, lin["d"], params, merit0, D, dV1, dV2)),
        rollout_kernel_ms=cuda_ms(
            lambda: s._rollout(x, X, U, ks, Ks, lin["d"], alpha0), reps=20),
        total_cost_ms=host_ms(lambda: s.total_cost(X, U, params)),
    )
    ticks = 2
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out.update(
        profiled_tick_ms=wall, device_busy_ms_per_tick=busy,
        tick_p50_ms=tick_ms, device_idle_share=1.0 - busy / tick_ms,
        syncs_per_tick=(s.host_syncs - syncs0) / ticks,
        top_kernels=[(e.key[:60], e.self_device_time_total / 1e3 / ticks,
                      e.count // ticks) for e in top],
        card=card,
    )
    return out


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
    solver64 = loop64.solver
    ocp = prob64.ocp
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    B = B_MAIN
    x_nom = prob64.initial_state.cpu().numpy()
    u_nom = prob64.static_input.cpu().numpy()
    X = torch.as_tensor(x_nom[None, None] + 0.02 * rng.randn(B, ns + 1, nx),
                        device=dev)
    U = torch.as_tensor(u_nom[None, None] + 0.05 * rng.randn(B, ns, nu),
                        device=dev)
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    lin64 = solver64._linearize_sliced(X, U, params)
    lin32 = {k: v.float().contiguous() for k, v in lin64.items()}
    rows = solver64.rows
    mu = solver64.opts.mu0
    order = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")

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

    x0 = X[:, 0] + torch.as_tensor(0.005 * rng.randn(B, nx), device=dev)
    ks64, Ks64 = ref64[0], ref64[1]
    alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=torch.float64,
                           device=dev)
    consts = ocp.constants
    dt = ocp.dt

    def k3_args(dtype, alphas):
        c = lambda t: t.to(dtype).contiguous()
        return (c(x0), c(X), c(U), c(ks64), c(Ks64), c(lin64["d"]),
                c(alphas), dt, consts["m_scaled"], c(consts["inertia_scaled"]))

    r_ref = k3.srbd_rollout_plain(*k3_args(torch.float64, alphas4))
    r_got = k3.srbd_rollout(*k3_args(torch.float64, alphas4))
    r_p32 = k3.srbd_rollout_plain(*k3_args(torch.float32, alphas4))
    r_g32 = k3.srbd_rollout(*k3_args(torch.float32, alphas4))
    torch.cuda.synchronize()
    k3_e64 = max(rel_err(g, r) for g, r in zip(r_got, r_ref))
    k3_e32 = {n: rel_err(g, r) for n, g, r in zip(("Xn", "Un"), r_g32, r_ref)}
    k3_p32 = {n: rel_err(g, r) for n, g, r in zip(("Xn", "Un"), r_p32, r_ref)}
    k3_abs32 = max(abs_err(g, r) for g, r in zip(r_g32, r_ref))
    k3_ok32 = all(k3_e32[n] <= 2 * k3_p32[n] + 1e-6 for n in k3_e32)
    emit("k3_check", f64_rel_err=k3_e64, f64_tol=1e-9,
         f32_rel_err=k3_e32, f32_plain_rel_err=k3_p32,
         f32_rule="kernel <= 2*plain + 1e-6", f32_max_abs_err=k3_abs32)
    if not (k3_e64 <= 1e-9 and k3_ok32):
        fail("K3 (srbd_rollout) disagrees with its plain version")

    # timing at the main path's shapes and type (float32, B=512)
    a32 = k1_args(lin32)
    k1_ms = cuda_ms(lambda: k1.riccati_backward(*a32), reps=20)
    k1_plain_ms = cuda_ms(lambda: k1.riccati_backward_plain(*a32), reps=3,
                          warmup=1)
    k1_bytes = nbytes(*(lin32[k] for k in order), rows.packed(dev),
                      *got32)
    k1_flop = riccati_flops(B, ns, nx, nu, lin32["Jt"].shape[1],
                            len(rows.rx), len(rows.ru), len(rows.gx),
                            len(rows.gu), len(rows.bx))
    k1_bound = max(k1_bytes / H100_BYTES_PER_S, k1_flop / H100_F32_FLOP_PER_S)
    k1_by = ("bytes" if k1_bytes / H100_BYTES_PER_S
             >= k1_flop / H100_F32_FLOP_PER_S else "operations")

    alpha0 = alphas4[:1]
    r32 = k3_args(torch.float32, alpha0)
    k3_ms = cuda_ms(lambda: k3.srbd_rollout(*r32), reps=50)
    k3_plain_ms = cuda_ms(lambda: k3.srbd_rollout_plain(*r32), reps=3,
                          warmup=1)
    k3_out = k3.srbd_rollout(*r32)
    k3_bytes = nbytes(*(t for t in r32 if isinstance(t, torch.Tensor)),
                      *k3_out)
    k3_flop = rollout_flops(B, ns, nx, nu, (nx - 13) // 6, 1)
    k3_bound = max(k3_bytes / H100_BYTES_PER_S, k3_flop / H100_F32_FLOP_PER_S)
    k3_by = ("bytes" if k3_bytes / H100_BYTES_PER_S
             >= k3_flop / H100_F32_FLOP_PER_S else "operations")
    r32_fan = k3_args(torch.float32, alphas4)
    k3_fan_ms = cuda_ms(lambda: k3.srbd_rollout(*r32_fan), reps=50)

    # K2 yardstick: the (B·ns, nu, nu) Quu-like SPD stack 2JupᵀJup + μI,
    # inverted by one library call and by the plain block-Schur twin
    Jup = lin32["Jup"].reshape(B * ns, -1, nu)
    Q = 2.0 * Jup.transpose(-1, -2) @ Jup + mu * torch.eye(
        nu, device=dev, dtype=torch.float32)
    inv_lib_ms = cuda_ms(lambda: torch.linalg.inv(Q), reps=20)
    inv_plain_ms = cuda_ms(lambda: lm_spd_inverse(Q), reps=20)
    emit("k2_yardstick", stack=list(Q.shape), dtype="float32",
         torch_linalg_inv_ms=inv_lib_ms, lm_spd_inverse_plain_ms=inv_plain_ms)
    emit("kernel_times", card=card, riccati_backward_ms=k1_ms,
         riccati_backward_plain_ms=k1_plain_ms, riccati_bound_ms=k1_bound * 1e3,
         riccati_bytes=k1_bytes, riccati_flop=k1_flop,
         srbd_rollout_ms=k3_ms, srbd_rollout_plain_ms=k3_plain_ms,
         srbd_rollout_bound_ms=k3_bound * 1e3, srbd_rollout_bytes=k3_bytes,
         srbd_rollout_flop=k3_flop, srbd_rollout_4alpha_ms=k3_fan_ms)
    del lin64, lin32, ref64, got64, plain32, got32, r_ref, r_got, r_p32, r_g32

    # ---------------- phase 3: the main path ----------------
    def run_main(Bsz, warm, timed):
        loop, prob = build_srbd_loop(SRBDConfig(), DDPOptions(max_iters=5),
                                     shift_warmstart=True, device=dev)
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
        runs.append((loop, carry, inp))
        return dict(
            B=Bsz, dtype="float32", warmup_ticks=warm, ticks=timed,
            tick_p50_ms=statistics.median(times), tick_max_ms=max(times),
            tick_mean_ms=statistics.fmean(times),
            iters_mean=statistics.fmean(iters),
            syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
            finite=finite,
            defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
            srbd_residual_max=max(float(o.srbd_residual.abs().max())
                                  for o in outs),
            card=card,
        )

    runs = []
    k1.riccati_backward.launches = 0
    k3.srbd_rollout.launches = 0
    main = run_main(B_MAIN, warm=3, timed=20)
    launches = {"riccati_backward": k1.riccati_backward.launches,
                "srbd_rollout": k3.srbd_rollout.launches}
    main["launches"] = launches
    emit("main_path", **main)
    if not main["finite"]:
        fail("main path produced non-finite values")
    if max(main["defect_norm_max"], main["srbd_residual_max"]) > 1e-4:
        fail("main path plans are not dynamically consistent (defect or "
             "Newton-Euler residual above 1e-4)")
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    emit("tick_breakdown", **breakdown(*runs[0], card, main["tick_p50_ms"]))

    large = run_main(B_LARGE, warm=1, timed=2)
    emit("main_path_large", **large)
    if not large["finite"]:
        fail("B=4096 ticks produced non-finite values")

    # ---------------- phase 4: card path against CPU path ----------------
    def three_ticks(device):
        loop, prob = build_srbd_loop(cfg64, DDPOptions(max_iters=5),
                                     shift_warmstart=True, device=device)
        g = np.random.RandomState(SEED + 1)
        xn = prob.initial_state.cpu().numpy()
        x0 = torch.as_tensor(xn[None] + 0.005 * g.randn(8, nx),
                             dtype=torch.float64, device=device)
        carry = loop.init(x0)
        inp = walk_command(8, vx=0.2, dtype=torch.float64, device=device)
        outs = []
        for _ in range(3):
            carry, out = loop.tick_batch(carry, inp)
            outs.append(out)
        return carry, outs

    c_gpu, o_gpu = three_ticks(dev)
    c_cpu, o_cpu = three_ticks("cpu")
    same_iters = all(torch.equal(a.iterations.cpu(), b.iterations)
                     for a, b in zip(o_gpu, o_cpu))
    same_conv = all(torch.equal(a.converged.cpu(), b.converged)
                    for a, b in zip(o_gpu, o_cpu))
    eX = rel_err(c_gpu.sol.X.cpu(), c_cpu.sol.X)
    eU = rel_err(c_gpu.sol.U.cpu(), c_cpu.sol.U)
    ex = max(rel_err(a.x.cpu(), b.x) for a, b in zip(o_gpu, o_cpu))
    emit("card_vs_cpu", B=8, dtype="float64", ticks=3,
         iterations_equal=same_iters, converged_equal=same_conv,
         X_rel_err=eX, U_rel_err=eU, x_rel_err=ex, tol=1e-9)
    if not (same_iters and same_conv and max(eX, eU, ex) <= 1e-9):
        fail("card path and CPU path disagree")

    kernels = [
        dict(name="riccati_backward", route="cuda", source=k1.SOURCE,
             replaces=k1.REPLACES, launches=launches["riccati_backward"],
             max_abs_err=k1_abs32, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=k1_bound * 1e3, bound_by=k1_by, library_ms=None,
             max_rel_err_f64=k1_e64, tol_f64=1e-9,
             max_rel_err_f32=max(k1_e32.values()), tol_f32=K1_F32_TOL,
             plain_rel_err_f32=max(k1_p32.values())),
        dict(name="srbd_rollout", route="cuda", source=k3.SOURCE,
             replaces=k3.REPLACES, launches=launches["srbd_rollout"],
             max_abs_err=k3_abs32, ms=k3_ms, plain_ms=k3_plain_ms,
             bound_ms=k3_bound * 1e3, bound_by=k3_by, library_ms=None,
             max_rel_err_f64=k3_e64, tol_f64=1e-9,
             max_rel_err_f32=max(k3_e32.values()),
             tol_f32="2*plain_rel_err_f32 + 1e-6",
             plain_rel_err_f32=max(k3_p32.values())),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
