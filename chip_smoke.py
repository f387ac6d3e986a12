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
     that and below 1e-5, srbd_evaluate (the cost and largest defect of
     the drawn plans, one of them holding a NaN that must come out NaN)
     by K3's rule, without and with node 0 pinned to x0 (the pinned plan
     it writes equal to the twin's bit for bit); K2 (the SPD inverse K1 runs on Quu) alone,
     through its own entry, on the stack 2JupᵀJup + μI (B·ns = 10240,
     nu=24): float64 to 1e-9, float32 to 1e-6 of the float64 inverse of
     the same float32 stack; plus each kernel's time from CUDA events, the
     plain version's, the bound (K1 and K2 at the FP64 tensor-core rate),
     K2's beside `torch.linalg.inv` in float32 and float64, K1's shared
     memory and blocks per SM, K4's achieved bytes per second, K3's
     time at B = 1, 132, 512, 528 and 4096 (`k3_size_probe`), and for
     srbd_evaluate its blocks per SM, registers, shared memory and waves
     at B=512 in both types (`evaluate_occupancy`), its time pinned at
     B = 1, 132, 512 and 4096 (`evaluate_size_probe`) and the host µs a
     call of its wrapper with and without its cached host setup
     (`evaluate_host_us`); K1's Tassa form (`MSDDP.solve`'s sweep,
     `k1_tassa_check`) with the block-Schur and with the Cholesky gain
     solve against its Tassa twin on the same point, member 7's last
     defect NaN: float64 to 1e-9, float32 to 1e-6 of the float64 twin,
     NaN exactly where the twin has NaN, and with Cholesky μ = −1e12 (Quu
     indefinite) giving NaN gains in both; its times at B=1 (the single
     robot's launch) and B=512 beside the collapsed K1's
     (`k1_tassa_times`);
  3. the main path: the warm-started closed-loop SRBD fleet tick
     `MPCLoop.tick_batch` at B=512 in float32 (3 warm-up ticks, 20 timed
     ticks of the walk command), with the kernels' launch counts read
     over exactly that run — K4 launches equal K1 launches, K3 launches
     equal the solver's trials, srbd_evaluate launches are two per solve,
     no `torch.func` transform runs and no plain `total_cost` or
     `_true_defects` is called; then per-phase times inside 5 more ticks
     (CUDA events and host clock at each phase boundary), 2 profiled ticks
     (device busy, kernel launches per tick), srbd_evaluate against its
     twin on the plans and x0 the solver hands it in one more tick (its
     first call pins node 0, its last does not), and 3 ticks at B=4096;
  4. the card path against the CPU path at B=8 in float64: 3 warm ticks
     from the same carry, and one cold-start tick at pushes of 0.2 in
     which the backtracking fan runs; iterations and convergence equal,
     plans to 1e-9. The float32 card path against the float64 CPU path
     is printed without a limit;
  5. the constrained path's kernels at B=256 (ns=20, nx=37, nu=30, the
     240-row AL inner stack) on a linearization point with active cones
     and boxes: K5 (the isrbd linearization), K1 at the isrbd sizes (18 of
     30 live B columns; its shared memory and blocks per SM are printed),
     K2 alone at nu=30 (5120 matrices) and K6 (the isrbd trial, at 1 and
     4 step sizes) and isrbd_evaluate, by the same rules as K4, K1, K2, K3
     and srbd_evaluate; K1's time at fleet sizes around whole waves of
     blocks is printed for both problems, and K6's at B = 1, 132, 256,
     528 and 4096 (`k6_size_probe`), with K5's achieved bytes per second
     and both kernels' blocks per SM (K6's ring depth too), and
     isrbd_evaluate's `evaluate_occupancy`, `evaluate_size_probe` (B = 1,
     132, 256, 4096) and `evaluate_host_us` (no limit); then the AL
     layer's entries (`al_check`, csrc/isrbd_al.cu): K7 (the constraint
     pass, in its eval, online and offline modes, static bounds and box
     overrides, a first and a later outer), K8a (the shift with no, the
     tail and the full prior), K8b (the padded `al_*` tensors, with and
     without overrides) and K8c (both priors' update at EMA 0.5 and 1),
     each in float64 and float32 with member 7 holding a NaN: K7 in
     float64 to 1e-12 of max(1, |twin|) entry by entry and in float32 by
     K3's rule, K8 bit-equal in both types, NaN where the twin has NaN;
     their times at B = 1, 256 and 4096 and their wrappers' host µs a call
     (`al_kernel_times`, with K7's, K8a's and K8b's occupancy), and one
     launch that does nothing timed the same way (`launch_floor`); K1's
     Tassa form with Cholesky at the isrbd sizes
     by the rules of 2, its times at B=1 and B=256;
  6. the constrained path: the fleet is seeded by the batched offline AL
     solve, then `ALDDP.serving_tick_batch` runs through
     `runtime.serving.constrained_tick` at B=256 in float32 (1 outer × 1
     inner iteration, full gait-phase prior, cz stiffness 3200, shifted
     warm start): one tick, 60 warm-up ticks, 20 timed ticks with a sync
     each. K5 launches = K1 launches = α₀ trials = solver iterations over
     the timed ticks, isrbd_evaluate launches are two per solve, no
     `torch.func` transform runs, no plain `total_cost` or
     `_true_defects` is called, K7, K8a, K8b and K8c launch once a timed
     tick each, no plain twin of the AL layer runs on the card over the
     seed, the warm-up and the timed ticks (`count_al_twins`), and the
     largest constraint violation over the timed ticks stays below 1e-2;
     then the phases inside 5 more ticks, 2 profiled ticks (with the
     launches and memcpy/memset a tick by phase, `launches_by_span`), K5,
     K1, K6, isrbd_evaluate, K7 and K8 against their twins by the rules of
     5 (K1 in float64 to 1e-8) on the inputs the solver hands them in one
     further tick of that fleet, K7 (offline) and K8b also on those of the
     offline seed's first and last outer, the kernel launches a tick on
     both paths (`launches_per_tick`), and B=4096 both in chunks of 256 and
     whole (printed, no limit);
  7. the constrained card path against the CPU path at B=8 in float64: 3
     serving ticks from one CPU-made seed, iterations equal, X, U and λ
     to 1e-9;
  8. the single-robot SRBD path (`single_path`): the dsrbd example's
     loop, `MPCLoop.tick` on `MSDDP.solve` with `ddp_example_options()`
     (max_iters=100), float32, 40 ticks of `walking_schedule` (vx 0.3
     from tick 10), then 10 ticks (walking from tick 3) with the
     Cholesky gain solve: tick p50 and max, iterations, host reads and kernel launches
     a tick and an iteration, largest `defect_norm` and Newton–Euler
     residual (each ≤ 1e-4), K4 = K1 launches = iterations, K3 = trials,
     two `srbd_evaluate` a solve, and no plain twin (Riccati, trial,
     evaluation, linearization), plain cost or `torch.func` call on the
     card; the phases of 5 ticks and a profile of 2; then the card against
     the CPU in float64 over 10 ticks (walking from tick 3: iterations and
     convergence equal, X, U and x to 1e-9), and `run` over 10 ticks
     against 10 `tick`s on the card;
  9. the single-robot constrained path (`single_constrained_path`): the
     isrbd example's sequence in float32, `ALDDP.solve` (6 outers from ρ
     1e3, ρ ≤ 1e5, max_iters=15) and 20 `solve_online` ticks (WPG advance,
     rdot_ref on nodes 1..ns, x0 the plan's node 1, walking from tick 10):
     the violation, the ms a solve, K5 = K1 (Tassa, Cholesky) launches,
     two `isrbd_evaluate` a solve, K7 and K8b once an outer, no plain twin
     on the card; then the card against the CPU in float64 (the offline
     solve and 3 online ticks, iterations equal, X, U and λ to 1e-9).

 10. the LIP paths (`lip_section`), on `build_lip_problem(SRBDConfig(),
     kangaroo_line_feet())` (nx=30, nu=15, ns=20, nc=4): `lip_check`, K10
     (`lip_linearize`), K11 (`lip_trial`, 1 and 4 α), `lip_evaluate`
     (without and with x0) and K1's three LIP instantiations (collapsed,
     Tassa with block-Schur and with Cholesky gains) against their twins
     at B=512 on random plans, references, 0/1 switches and tracking
     masks, by the rules of 2, member 7 NaN; and K10, K11 and lip_evaluate
     in float64 at B=8 to 1e-12 of max(1, |twin|) entry by entry, K10's
     Jacobians and the pinned plan bit for bit (`lip_check_f64_B8`);
     `lip_kernel_times`: every LIP kernel at B = 1, 512, 4096 in float32
     (ms, plain ms, bytes, FLOPs, bound), K11 also with four α and its
     chain alone (`lip_trial_chain`) with one and four α, blocks per SM
     (K10 with groups of one member-node and of 16 bytes, K11 in both
     types with one and four α, lip_evaluate in both types; K11's and
     lip_evaluate's shared memory held to `lip_rollout.smem_bytes` and
     `evaluate_smem_bytes`, none of the three spilling: `lip_layout_gate`),
     wrapper host µs;
     `lip_path`: the dlip example (`build_lip_loop`'s defaults: max_iters
     100, alpha_converge_threshold 1e-12, beta 1e-3, the WPG at the feet's
     height, no SRBD telemetry, no shift), 40 ticks of
     `walking_schedule(vx 0.3, start 10)` in float32, then 10 ticks with
     the Cholesky gain solve: tick p50 and max, iterations, host reads an
     iteration, hand-written launches an iteration and a tick, K10 = K1 =
     iterations, K11 = trials, two lip_evaluate a solve, no plain twin or
     plain cost on the card, finite, defect ≤ 1e-4, CoM height within
     0.08 of 0.88, the phases of 5 ticks and a profile of 2; card = CPU in
     float64 over 10 ticks (`lip_card_vs_cpu`: with max_iters=1 all to
     1e-9; with the dlip options iterations and convergence equal, the
     cost to 1e-9, x, u0 and the plans to LIP_FLOOR_TOL, the floor step);
     `lip_fleet_path`: `tick_batch` at B=512 float32 with the SRBD fleet
     point's settings (max_iters=5, shifted warm start, walk command,
     0.005·N(0,1) pushes, seed 0), 3 warm-up and 20 timed ticks, the same
     gates (K10 = K1 collapsed launches), phases and profile, B=4096 as a
     probe, card = CPU at B=8 in float64 (`lip_fleet_card_vs_cpu`, the
     same two rules).
 11. the quadruped trot (`quadruped_section`), on
     `build_quadruped_loop` (the point-feet quadruped, contact_model=1,
     number_of_legs=4: nx=37, nu=24, ns=20, 69 stage rows; K3, K4 and
     srbd_evaluate at `srbd::QuadShape`, K1 at `QuadShape`): `quad_check`,
     K4, K1 collapsed and Tassa (block-Schur gains), K3 (1 and 4 α) and
     srbd_evaluate (without and with x0) against their twins at B=512 on
     plans around the nominal state with the trot's contact plan, member 7
     NaN, by the rules of 2; `quad_kernel_times`: each at B = 1, 512,
     4096 in float32 (ms, plain ms at B ≤ 512, bytes, FLOPs, bound), blocks
     per SM and shared memory; `quad_path`: the quadruped example
     (`build_quadruped_loop`'s defaults: max_iters 5,
     alpha_converge_threshold 1e-12, beta 1e-3, the trot WPG at the feet's
     height, the Newton–Euler telemetry, no shift), 40 ticks of
     `walking_schedule(vx 0.25, start 10)` in float32: tick p50 and max,
     iterations, host reads and hand-written launches an iteration, the
     phases of 5 ticks and a profile of 2; gates: finite, defect and
     Newton–Euler residual ≤ 1e-4, the CoM height within 0.05 of its
     start, forward progress, K4 = K1 (Tassa) = iterations, K3 = trials,
     two srbd_evaluate a solve, no plain twin, plain cost or `torch.func`
     on the card; `quad_card_vs_cpu`: card = CPU in float64 at B=1 (10
     ticks, walking from tick 3) and B=8 (3 fleet ticks), iterations and
     convergence equal, x, u0, the cost and the plans to 1e-9;
     `quad_fleet_path`: `tick_batch` at B=512 float32 with the SRBD fleet
     point's settings (max_iters=5, shifted warm start, walk command vx
     0.2, 0.005·N(0,1) pushes, seed 0), 3 warm-up and 20 timed ticks, the
     same gates (K4 = K1 collapsed), phases, profile (launches by span),
     B=4096 as a probe; the section's seconds.
12. the constrained quadruped trot (`quadruped_constrained_section`), on
    `build_isrbd_problem(SRBDConfig(contact_model=1, number_of_legs=4,
    lip_height=com_z), quadruped_point_feet())` (nx=37, nu=30, ns=20, the
    AL inner stacks of 236 and 97 rows; K5, K6, isrbd_evaluate, K7 and K8
    at `isrbd::QuadAlShape`, K1 at `isrbd_al_quadruped`): `qc_check`, K5,
    K1 collapsed and Tassa with Cholesky gains, K6 (1 and 4 α),
    isrbd_evaluate (without and with x0), K7 (eval, online, offline on a
    first and a later outer, static bounds and overrides), K8a (no, tail,
    full prior), K8b and K8c against their twins at B=256 on a drawn
    point, member 7 NaN, by the rules of 5; `qc_kernel_times`: each at
    B = 1, 256, 4096 in float32 (ms, plain ms at B ≤ 256, bytes, FLOPs,
    bound), blocks per SM and the wrappers' host µs; `qc_path`: the
    constrained example's single robot in float32 (the offline
    `ALDDP.solve` with `al_serving_options(15)`, then 40 ticks of the trot
    WPG, rdot_ref (0.15, 0, 0) and solve_online(solve_online(
    shift_warmstart)) at max_iters=1): offline ms and violation, tick p50
    and max, iterations, host reads and launches a tick, a profile of 2
    ticks; gates: finite, the offline violation < 1e-3, the largest over
    ticks 20-39 < 1e-2, the CoM advanced > 0.15 m, the cone rows < 2 N and
    F_z > −2 N on every foot, K5 = K1 (Tassa, Cholesky) = iterations, K6 =
    trials, two isrbd_evaluate a solve, K7 and K8b once an outer, K8a
    once a tick, no plain twin, AL twin, plain cost or `torch.func` on the
    card; `qc_card_vs_cpu`: the offline solve and 3 ticks in float64,
    iterations equal, X, U and λ to 1e-9; `qc_fleet_path`: the
    constrained tick at B=256 float32 (outers=2, inner max_iters=1,
    FullPhasePrior at EMA 1, the trot WPG, standing then vx 0.15 from tick
    10), seeded by the batched offline solve (0.01·N(0,1), seed 11), 1 +
    60 warm-up and 20 timed ticks: p50, max, solves/s, busy ms, idle
    share, launches by span, the same gates (K7 and K8b once an outer, K8a
    and K8c once a tick, `window_viol_max` < 1e-2), B=4096 whole (printed,
    no limit); the section's seconds.
13. the execution modes (`modes_section`): `modes_check`, K12
    (`riccati_associative`, the SRBD and LIP shapes × block-Schur and
    Cholesky gains) and K13 (`linear_trial`, both problems, 1 and 4 α)
    against their twins at B = 1, 8, 512 on iterates drawn as
    tests/test_parallel_riccati.py draws them (X ± 0.05·N, U 0.1·N),
    linearized by K4 / K10: float64 to 1e-9 (`rel_err`, K1's rule; the
    entry-by-entry figure printed), float32 to 1e-6 of the float64 twin on
    the same float32 inputs (both compute in float64), K13's flags equal;
    `modes_times`: both at B = 1, 8, 512, 4096 in float32 (ms, bytes,
    FLOPs counted from the code, bound at the FP64 tensor-core rate, plain
    ms at B = 1 and 512; of each K12 phase its device ms from the
    profiler at B = 1 and 512, its shared memory a block — failing unless
    it is what `riccati_associative.phase_bytes` states, or unless the
    combine runs three blocks an SM — its blocks, registers and spilled
    bytes; K12's rows carry them),
    K1's Tassa form at the same B in the same call (`k12_vs_k1_tassa`),
    `torch.linalg.solve` on the scan's stack of (I + C₁J₂) systems at
    B=512; `modes_single_path`: the dsrbd example's 40-tick walk under
    associative/nonlinear, 40 more under associative/linear, 10 with
    Cholesky gains; `modes_lip_path`: the dlip example's 40 ticks under
    associative/linear, 10 with Cholesky; `modes_fleet_path`:
    tools/bench_modes.py's configuration (max_iters=5, width 4, rdot_ref
    (0.2, 0, 0), no shift, every member at the nominal state) on
    `tick_batch` at B=512 under associative/linear, 3 warm-up and 20
    timed ticks, B=4096 a probe; each path: tick p50 and max, iterations,
    host reads, hand-written kernel launches a tick (a K12 sweep is 8),
    phases, a profile (busy, idle share, launches), gates: finite, defect
    ≤ 1e-4, K4/K10 = K12 = iterations, K1 never, K13 = the linear trials,
    evaluation two a solve, no plain twin, plain cost or `torch.func` call
    on the card; `modes_card_vs_cpu`: float64, the single SRBD under
    associative/linear (5 ticks) and the fleet at B=8 with 0.005·N(0,1)
    pushes (3 ticks): iterations equal, plans, x, u0 and cost to 1e-9.
    Then the same kernels at the other shapes (`modes_shapes_section`):
    `modes_check` for K12 at the quadruped's SRBD shape (both gain solves)
    and at the two isrbd-AL shapes (Cholesky) and K13's quadruped and
    isrbd-AL families (RK2 defects) at B = 1, 8 and 512 / 256, on iterates
    drawn as above (K4) and on drawn AL points with active cones and boxes
    (`draw_isrbd_point`, K5), by the same rules; `modes_times` and
    `k12_vs_k1_tassa` at those B (the AL shapes against K1-Tassa-Cholesky);
    the paths under associative/linear: the quadruped trot (B=1, 40 ticks,
    10 with Cholesky gains; phase 11's height and progress gates), its fleet
    (B=512, 3 + 20 ticks), the isrbd example's single constrained robot
    (offline solve and 20 `solve_online` ticks, again under
    associative/nonlinear so that K6 follows a K12 sweep), the constrained
    fleet at the round-5 serving point (B=256, 1 + 60 + 20 ticks) in
    float64 with `window_viol_max` < 1e-2 and in float32 reported (the
    JAX package's own float32 fleet leaves the constraints under these
    modes, tests/modes_fleet_reference.py), the constrained quadruped trot
    (B=1, offline solve and 40 ticks, phase 12's gates) and its fleet
    (B=256, 1 + 60 + 20 ticks, `window_viol_max` < 1e-2), each gated as
    above with K7/K8 once an outer, K8a once a shift, K8c once a prior
    update; `modes_card_vs_cpu` for the single constrained robot (offline
    solve and 3 ticks) and the AL fleet at B=8 (seed and 3 ticks): float64,
    iterations equal, plans, multipliers, ρ and cost to 1e-9.
 14. the SRBD problem at every topology and step the JAX package's
     `build_srbd_problem` takes (`family_section`): the point-feet biped
     under Euler and the
     Kangaroo, the quadruped and the point-feet biped under RK2 and RK4.
     `family_check`: K4, K3 (1 and 4 α, a NaN member), `srbd_evaluate`
     (plain and pinned, a NaN plan) and K1 in every form compiled at the
     instance's shape against their twins at B = 1, 64 and 512 — K4, K3
     and `srbd_evaluate` in float64 within 1e-12 of max(1, |twin|) and in
     float32 by their rules above, K1 in float64 to 1e-9 and float32 to
     1e-6 of the float64 twin; `family_times`: each at B = 1, 512 and 4096
     in float32 beside the Euler counterparts, with the bounds, achieved
     rates, blocks an SM and registers; K2 at nu=12 beside
     `torch.linalg.inv`. The paths (float32, ns=20): the point-feet
     biped's dsrbd walk (40 ticks, vx 0.3 from tick 10, then 10 Cholesky
     ticks; CoM height within 0.08 of 0.88, forward progress above 0.03 m)
     and its fleet (B=512, max_iters=5, warm start shifted, 0.005·N(0,1)
     pushes, 3 + 20 ticks, with phases, profile and idle share); the
     Kangaroo's fleets under RK2 and RK4 and its RK4 walk (as the
     biped's); the quadruped's RK4 trot (phase 11's gates); short fleets
     (10 ticks) of the quadruped under RK2 and the biped under RK2 and
     RK4, and 10 ticks of the biped's RK4 walk; every path fails on a
     plain twin on the card, on a launch of any other SRBD instance (no
     Euler instance on an RK path), on a defect or Newton–Euler residual
     above 1e-4, or on launch counts that do not cover the trials and
     solves. `family_card_vs_cpu`: the point-feet walk (3 ticks) and the
     Kangaroo's RK4 fleet at B=8 (3 ticks) in float64, iterations equal,
     plans, x, u0 and cost to 1e-9;
 15. the execution modes and the Cholesky gain solve at the shapes phase
     14 added (`modes_family_section`): K12 at the point-feet biped's and
     the three RK shapes with each gain solve, K13 at the seven (topology,
     step) families (its true defects in the problem's own step), K1's
     Tassa-Cholesky form at the quadruped's Euler and RK shapes and the
     biped's RK shape, each against its twin at B = 1, 64 and 512 (K12 in
     float64 to 1e-8, K13 and K1 to 1e-9, float32 to 1e-6 of the float64
     twin; K13's flags equal; K1 also with a NaN member and an indefinite
     Quu), timed at B = 1, 512 and 4096, K12 beside K1-Tassa with the same
     gain solve in the same call; the paths (float32, ns=20), each counted
     from a reset just before to a read just after and failing on a
     plain twin, on a launch of another instance, or on K4, K12 (K1),
     K13 (K3) and srbd_evaluate launches that do not match the
     iterations, trials and solves: the point-feet biped's dsrbd walk
     under associative/linear (40 ticks, phase 14's height and progress
     gates) and 10 ticks with Cholesky gains, the Kangaroo's RK2 fleet
     (B=512, 3 ticks) and RK4 walk with Cholesky gains under the modes,
     the quadruped's RK2 trot and RK4 trot (Cholesky gains) under the
     modes, each followed by 5 ticks with Cholesky gains under the default
     modes, its Euler trot with Cholesky gains, the biped's RK2 and RK4
     walks under the modes and 5 RK2 ticks with Cholesky gains;
     `mf_card_vs_cpu`: the point-feet walk and the Kangaroo's RK2 fleet at
     B=8 under associative/linear in float64, 3 ticks each, iterations
     equal, plans, x, u0 and cost to 1e-9;
 16. the LIP at every topology and step the JAX package's
     `build_lip_problem` takes (`lip_family_section`): the point-feet
     quadruped and biped under Euler and each topology under RK2 and RK4,
     on K10, K11, lip_evaluate and K1 (K2 inside). `lip_family_check`:
     each new instance against its twin at B = 1, 64 and 512 on random
     plans, references, 0/1 switches and tracking masks with a NaN member
     — K10 (its float64 Jacobians bit for bit), K11 at 1 and 4 α and
     lip_evaluate plain and pinned (the pinned plan bit for bit) in
     float64 within 1e-12 of max(1, |twin|) and in float32 by phase 10's
     rules, K1 in every form at the instance's shape in float64 to 1e-9
     and float32 to 1e-6 of the float64 twin; `lip_family_times`: each at
     B = 1, 512 and 4096 in float32 beside the Kangaroo's Euler instance,
     with bounds, blocks an SM, registers and spills (none allowed), the
     shared memory held to `smem_bytes` / `evaluate_smem_bytes`; K2 at
     nu=9 beside `torch.linalg.inv` (the execution modes at these shapes
     are phase 17's). The paths (float32,
     ns=20): the point-feet biped's dlip walk (40 ticks, vx 0.3 from tick
     10, then 10 Cholesky ticks; CoM height within 0.08 of 0.88, forward
     progress above 0.03 m), the quadruped's LIP trot (the trot WPG, 40 +
     10 ticks, forward progress), the Kangaroo's LIP fleets under RK2 and
     RK4 (B=512, max_iters=5, warm start shifted, 0.005·N(0,1) pushes, 3 +
     20 ticks, with phases, profile and idle share), 10-tick walks of the
     Kangaroo, the quadruped and the biped under RK4 and 10-tick fleets of
     the biped and the quadruped under Euler and RK2; every path fails on
     a plain twin on the card, on a launch of another LIP instance (no
     Euler instance on an RK path), on a defect above 1e-4, or on K10 and
     K1 launches that do not match the iterations, K11's the trials and
     lip_evaluate's two a solve. `lip_family_card_vs_cpu`: the point-feet
     walk and the Kangaroo's RK4 LIP fleet at B=8 (3 ticks each) in
     float64, with max_iters=1 everything to 1e-9, with the paths'
     options iterations equal, the cost to 1e-9, x, u0 and the plans to
     LIP_FLOOR_TOL;
 17. the execution modes at the LIP shapes phase 16 added
     (`lip_modes_section`): K12 at K1's five new LIP shapes (nx = 30 and
     the point-feet biped's nx = 18) with each gain solve, K13 at the
     eight new (topology, step) families (the true defects in the
     problem's own step), each against its twin at B = 1, 64 and 512
     (float64 entry by entry to 1e-12 of max(1, |twin|) — K12 to 4× the
     two float64 twins' own distance where that is larger —, K13's flags
     equal at 1 and 4 step sizes; float32 to 1e-6 of the float64 twin)
     and with a NaN member at B = 64 and 512 (its outputs non-finite and
     rejected, every other member's bit for bit those without it); timed
     at B = 1, 512 and 4096 in float32, K12 beside K1-Tassa and K13 beside
     K11 (which on the LIP makes the same plans: held to 1e-9 on the card
     in float64) in the same call; the paths (float32, ns=20), gated as
     phase 15's: the point-feet biped's dlip walk under associative/linear
     (40 ticks, the CoM height and progress gates) and 10 Cholesky ticks,
     the quadruped's LIP trot under the modes (20 ticks) and 5 Cholesky
     ticks, the Kangaroo's LIP fleet under RK2 (B=512, 3 ticks, phases,
     profile and idle share), 10-tick runs of the Kangaroo's RK4 walk, the
     quadruped's RK2 and RK4 trots and the biped's RK2 and RK4 walks (a
     Cholesky run at each K12 shape), and 5 ticks each of
     associative/nonlinear on the biped and sequential/linear on the
     quadruped's RK4 fleet; no spill in any new K12 or K13 kernel
     (ptxas); `lmf_card_vs_cpu`: every instance's fleet at B=8 under
     associative/linear in float64, 3 ticks, with max_iters=1 everything
     to 1e-9, with max_iters=5 by F8's rule (iterations equal, the cost at
     tick 0 to 1e-9, the rest to LIP_FLOOR_TOL);
 18. the square-feet biped (`square_feet_section`; contact_model=4, four
     points a foot, nc=8: the SRBD at nx=61, nu=48, the LIP at nx=54,
     nu=27; JAX's `TestNc8` robot, `square_feet_robot`) under Euler, RK2
     and RK4: K4, K3 (1 and 4 α), srbd_evaluate, K10, K11, lip_evaluate
     and K1's twelve new instantiations (csrc/riccati_backward_square_
     feet.cu) against their twins at B = 1, 64 and 512 by phases 14's and
     16's rules (`family_check`, `lip_family_check`: float64 to 1e-12 of
     max(1, |twin|), K1 to 1e-9, the NaN members), timed at B = 1, 512
     and 4096 beside their bounds with their occupancy (K3's and K1's
     shared memory held to `rollout.trial_layout` and
     `riccati.layout_bytes`), K2 alone at nu = 48 and 27 beside
     `torch.linalg.inv`, JAX's TestNc8 bar on the card (a 30-iteration
     standing solve: defects below 1e-6, each contact's F_z within 0.05
     of m·g/8), the paths in float32 at ns=20 (the SRBD and LIP fleets at
     B=512 under Euler with phases, profile and idle share, 10 ticks of
     each fleet under RK2, a 40-tick walk of each problem under Euler and
     10 ticks under RK4, each followed by 10 Cholesky ticks), gated as
     phases 14 and 16 gate theirs; card = CPU in float64 at B=8 (3 ticks
     of each fleet; the LIP with max_iters=1 to 1e-9 and with max_iters=5
     by F8's rule) and the execution modes' refusal at contact_model=4.
 19. the line-feet quadruped (`line_feet_section`; contact_model=2 on four
     legs, two points a foot, nc=8: the square feet's nx and nu, four
     fewer rows of G; JAX's `TestLineFeetQuadruped` robot,
     `line_feet_robot`) under Euler, RK2 and RK4, as phase 18 runs its
     robot (`nc8_section`): the same kernel checks, times and occupancy at
     its six instances and K1's twelve new instantiations
     (csrc/riccati_backward_line_feet.cu), JAX's TestLineFeetQuadruped bar
     on the card (a 20-iteration standing solve with
     alpha_converge_threshold=1e-12 and beta=1e-3: converged, defects below
     1e-6, Σ F_z within 1% of m·g), the trots with the 8-entry mask
     (`line_feet_mask`; the quadruped example's options and vx 0.25 on the
     SRBD, the dlip example's on the LIP; the SRBD trot's CoM within z0 ±
     0.05 m, every trot's progress above 0), card = CPU in float64 at B=8,
     and the refusals of the execution modes and of the isrbd path, each
     naming nc=8 and ROADMAP.md.

Each result is printed on a line of its own; a failed phase exits non-zero
without a result. The next-to-last line is the kernel table as JSON,
219 rows (K4, K1, K3, K5, K1 at the isrbd sizes, K6,
srbd_evaluate, isrbd_evaluate, K7, K8a, K8b, K8c, K2, K1's three Tassa
instantiations, whose launches come from phases 8 and 9, the LIP rows of
phase 10: K10, K1 at the LIP sizes, K11, lip_evaluate and K1's two LIP
Tassa instantiations, the quadruped rows of phase 11: K4, K3,
srbd_evaluate and K1's collapsed and Tassa instantiations at the
quadruped's shape, and the constrained quadruped rows of phase 12: K5,
K1 collapsed and Tassa-Cholesky, K6, isrbd_evaluate, K7, K8a, K8b and K8c
at its AL shape, and the rows of phase 13: K12 at the SRBD and LIP shapes
with each gain solve, K13 for the SRBD problem and the LIP, K12 at the
quadruped's shape with each gain solve and at the two AL shapes with
Cholesky, K13 for the quadruped and both AL inner problems), and the
thirty-two rows of phase 14 (K4, K3 and `srbd_evaluate` at its seven
instances, K1's ten instantiations of PR 15, K2 at nu=12), and the
eighteen rows of phase 15 (K12 at four shapes × two gain solves, K13 at
seven families, K1's three Tassa-Cholesky instantiations), and the forty
rows of phase 16 (K10, K11 and lip_evaluate at its eight instances, K1's
fifteen instantiations at the five new LIP shapes, K2 at nu=9), and the
eighteen rows of phase 17 (K12 at five LIP shapes × two gain solves, K13
at eight LIP families), and the thirty-two rows of phase 18 (K4, K3,
srbd_evaluate, K10, K11 and lip_evaluate at the square feet's three
steps, K1's twelve square-feet instantiations, K2 at nu = 48 and 27), and
the thirty rows of phase 19 (the same six kernels at the line-feet
quadruped's three steps, K1's twelve line-feet instantiations); the last
line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --k12-versus OTHER_TREE [--parts k12,k13,k11,k7]

is a development run instead: it builds K12, K13 (with the sources
that share K13's node evaluation: the evaluate kernels, K3, K6, K11),
K11 (with K10's source) and K7 (with K8a-c, its source's) of the parts named
from this checkout and from OTHER_TREE (an unpacked archive of another
commit) and prints no result line. K12: each of its 16 instantiations
held against the twin in float64 at B = 8 and 512 from both, both timed
in float32 at B = 1, 512 and 4096 in turns (other, this, this, other)
with each phase's device ms; one `k12_versus` line an instantiation. K13:
each of its twelve families held against the twin in float64 (the flags
equal) from both, both timed at B = 1, 512 and 4096 with one and four α
in turns, this tree's chain alone; one `k13_versus` line a family; the
evaluate kernels and the trials of both trees compared bit for bit and
timed (`evaluate_versus`; the LIP's, K11's and lip_evaluate's, held to
their twins instead, their designs free to differ between the trees). K11: both trees held against `lip_trial_plain` in
float64 at B = 8 and 512 with one and four α (member 7 from a NaN x0),
timed in float32 at B = 1, 512 and 4096 with one and four α in turns,
this tree's chain alone, both trees' occupancy; one `k11_versus` line;
then K10, K11 and K13's LIP family of both trees, which share
csrc/lip_common.cuh, bit for bit in both types, and lip_evaluate of both
trees (with and without x0) held to its twin in float64 at B = 8 (1e-12
of max(1, |twin|), a NaN member NaN, the pinned plan bit for bit), K10
and lip_evaluate timed in float32 at B = 1, 512 and 4096 in turns beside
their bounds and a fill of K10's output bytes, both trees' wrapper host
µs in turns, this tree's occupancy and launch shapes against the card's
(`k11_shared_versus`). K7:
both trees at its two AL shapes and three modes, held to its twin by
`al_check` and to each other bit for bit in float32 and float64 (static
bounds and the overrides, a NaN member, a first and a later outer),
timed in float32 at B = 1, 256 and 4096 in turns, with both trees'
blocks an SM and wrapper host µs (this one's by part); one `k7_versus`
line a shape; then K8a-c of both trees bit for bit (to each other and to
their twins, float32 and float64, K8a under no, the tail and the full
prior, K8b with the static bounds and the overrides, K8c with both
priors, the NaN member), timed in turns at B = 1, 256 and 4096 (K8a with
each prior, K8b with both bound cases, K8c with the full prior) beside
their bounds, with both trees' wrapper host µs and this tree's K8a and
K8b occupancy (`k7_shared_versus`). Then ptxas' figures of both. Imports
nothing of JAX.
"""

import dataclasses
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
B_CONSTRAINED = 256                 # the constrained path's serving batch
CONSTRAINED_CHUNK = 256
CZ_RHO_WEIGHT = 3200.0              # cz stiffness of the serving configuration
VIOL_LIMIT = 1e-2                   # healthy runs read ~2e-3, diverging ones 1e-1
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
H100_FP64_TC_FLOP_PER_S = 67e12     # float64 on the tensor cores (DMMA): K1, K2
# K1 carries float32 tensors in float64 on chip, so against the float64
# plain result only the float32 rounding of its inputs and outputs is
# left (unit roundoff 6e-8); 1e-6 of each output's largest value is ~16
# units. The float32 plain twin errs ~1e-2 (Quu is ill-conditioned under
# the 1e6 constraint weight), so a rule scaled by it would test nothing.
K1_F32_TOL = 1e-6
K1_LIVE_F64_TOL = 1e-8              # K1 on the serving path's own inputs
# K2 alone (the SPD inverse K1 runs on Quu): float64 against the plain
# twin to 1e-9; float32 inputs, carried in float64 on chip, to 1e-6 of the
# float64 plain inverse of the same float32 stack. Against the inverse of
# the unrounded float64 stack the float32 rounding of the input alone
# costs up to ~0.4 at nu=30 (Quu's conditioning), for any method: that
# figure is printed with no limit.
K2_F64_TOL = 1e-9
K2_F32_TOL = 1e-6
# K4 computes in float32; besides the 2× rule, each output stays below
# this share of its largest value
K4_F32_CAP = 1e-5
# K7 and K8 (the AL layer) in float64: |kernel − twin| ≤ 1e-12·max(1, |twin|)
# entry by entry; K7 rounds as its twin's torch ops do (built without FMA
# contraction), so only the order of the twin's own sums on the card is
# left. K8 moves values: bit-equal in both types.
AL_F64_TOL = 1e-12
AL_ENTRIES = ("isrbd_al_constraints", "isrbd_al_shift", "isrbd_al_params",
              "isrbd_al_prior_update")
TORCH_FUNC_TRANSFORMS = ("vmap", "jacfwd", "jacrev", "jvp", "vjp", "grad",
                         "grad_and_value", "hessian", "functional_call",
                         "linearize")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(tag, **fields):
    print(f"{tag}: " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `reps` runs.

    The runs are queued behind a spin kernel (`torch.cuda._sleep`) that
    lasts longer than the host takes to enqueue them all, so the events
    time the device's work alone: a kernel that runs shorter than its
    wrapper's host work (checks, allocations, the ctypes call: ~0.1 ms)
    would otherwise be timed at the host's enqueue rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call_s = time.perf_counter() - t0     # host and device, one call
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # 2 GHz is above the card's clock, so the spin lasts at least twice the
    # time the host needed for one call, reps times over
    torch.cuda._sleep(int(2 * reps * per_call_s * 2e9))
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


def bound(n_bytes, n_flop, flop_per_s=H100_F32_FLOP_PER_S):
    """(least ms, what bounds it) on the H100's HBM rate and the rate of
    the kernel's arithmetic: float32 outside the tensor cores by default,
    H100_FP64_TC_FLOP_PER_S for K1 and K2, which compute in float64."""
    tb, tf = n_bytes / H100_BYTES_PER_S, n_flop / flop_per_s
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


def riccati_flops(Bsz, ns, nx, nu, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc):
    """FLOPs one K1 sweep needs (products as 2 FLOPs per multiply-add); the
    B-chain products run over the n_uc live columns of B only."""
    node = 2 * (
        nx * nx                                  # Vxx d
        + nx * nx * n_rx                         # VA
        + n_ru * n_ru * n_uc                     # V[ru,ru] Bs
        + n_gx * nx + n_rx * nx                  # Qx
        + n_gu * nu + n_ru * n_uc                # Qu
        + n_gu * nu * nu + n_ru * n_uc * n_uc    # Quu
        + n_b * nu * nx + n_ru * n_uc * nx       # Qux
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


def evaluate_flops(Bsz, ns, nx, nc, n_rho):
    """FLOPs one srbd_evaluate call needs: the SRBD rates, ~5 per residual
    row (value, square, sum), the Euler step and |defect| per node, the
    terminal rows and the node sums."""
    node = body_flops(nc) + 5 * n_rho + 4 * nx
    return Bsz * (ns * node + 5 * 15 + 2 * ns)


def isrbd_evaluate_flops(Bsz, ns, nx, nc, n_rho, n_term):
    """FLOPs one isrbd_evaluate call needs: two evaluations of ẋ and the
    RK2 step, R I Rᵀ for the Euler rows, ~8 per stage row and terminal row,
    |defect| per node and the node sums."""
    node = 2 * 40 + 6 * nx + 180 + 8 * n_rho + 60 * nc
    return Bsz * (ns * node + 8 * n_term + 2 * ns)


def isrbd_linearize_flops(Bsz, ns, nx, nu, nc, n_rho, n_term, n_rx, n_ru,
                          n_uc):
    """FLOPs one K5 call needs, counted from the kernel's arithmetic: two
    evaluations of ẋ (~40 each, the quaternion rate), R I Rᵀ and Iw ω
    (~180), the four ∂Iw_j columns (~200 each), the two quaternion blocks
    of A − I (28 entries of a 4-term product), the residual rows (~6 each,
    the six Newton–Euler rows ~10·nc more), one multiply per structurally
    nonzero Jacobian entry (~400), the dt scaling of Sx and Bs, the
    defects; the terminal rows per member."""
    node = (2 * 40 + 180 + 4 * 200 + 28 * 10 + 6 * n_rho + 60 * nc + 400
            + n_rx * nx + n_ru * n_uc + 3 * nx)
    return Bsz * (ns * node + 6 * n_term + 100)


def isrbd_trial_flops(Bsz, ns, nx, nu, nc, n_rho, n_term, nA):
    """FLOPs one K6 call needs: gain application, two evaluations of ẋ,
    the RK2 update, R I Rᵀ for the Euler rows, then ~8 per stage row
    (value, square, sum) and the terminal rows, merit and Armijo test."""
    node = (nx + 2 * nu * nx + 3 * nu + 2 * 40 + 6 * nx + 180 + 8 * n_rho
            + 60 * nc)
    return nA * Bsz * (ns * node + 8 * n_term + 20)


ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
TRIAL_OUT = ("Xn", "Un", "cost", "merit")
SWEEP_OUT = ("ks", "Ks", "dV1", "dV2")


def linearize_check(tag, plain, kernel, args, **extra):
    """A linearization kernel (K4, K5) against its plain twin: float64 to
    1e-9; float32 against the float64 plain result within 2× the float32
    twin's own error + 1e-6 and below K4_F32_CAP. `args(dtype)` gives the
    call's arguments. Returns the float64 plain and float32 kernel
    outputs and the error figures; fails the run on disagreement."""
    import torch

    f64, f32 = torch.float64, torch.float32
    ref, got, p32, g32 = (plain(*args(f64)), kernel(*args(f64)),
                          plain(*args(f32)), kernel(*args(f32)))
    torch.cuda.synchronize()
    e64 = {k: rel_err(got[k], ref[k]) for k in ORDER}
    e32 = {k: rel_err(g32[k], ref[k]) for k in ORDER}
    ep32 = {k: rel_err(p32[k], ref[k]) for k in ORDER}
    abs32 = max(abs_err(g32[k], ref[k]) for k in ORDER)
    emit(tag, f64_rel_err=e64, f64_tol=1e-9, f32_rel_err=e32,
         f32_plain_rel_err=ep32,
         f32_rule=f"kernel <= 2*plain + 1e-6 and <= {K4_F32_CAP}",
         f32_max_abs_err=abs32, **extra)
    ok32 = all(e32[k] <= 2 * ep32[k] + 1e-6 and e32[k] <= K4_F32_CAP
               for k in ORDER)
    if not (max(e64.values()) <= 1e-9 and ok32):
        fail(f"{tag}: the linearization kernel disagrees with its plain "
             "version")
    return ref, g32, dict(e64=e64, e32=e32, p32=ep32, abs32=abs32)


def tassa_flops(Bsz, ns, nx, nu, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc,
                quu_solver):
    """FLOPs one Tassa-form K1 sweep needs: the collapsed sweep's
    (`riccati_flops`) plus KᵀQuu, (KᵀQuu)K, KᵀQux beside QuxᵀK, the two more
    matrix-vector terms of Vx and ½kᵀQuu; with Cholesky, the factor (n³/3
    multiply-adds) and the two substitutions over 1 + nx columns in place
    of the inverse and the gains' products."""
    node = nx * nu * nu + nx * nu * nx + nu * nx * nx + 2 * nu * nx + nu * nu
    if quu_solver == "cholesky":
        node += (nu ** 3 // 3 + nu * nu * (1 + nx)
                 - inv_flops(nu) - nu * nu - nu * nu * nx)
    return (riccati_flops(Bsz, ns, nx, nu, nt, n_rx, n_ru, n_gx, n_gu, n_b,
                          n_uc) + 2 * Bsz * ns * node)


def riccati_check(tag, k1, lin64, mu, rows, f64_tol=1e-9, **extra):
    """K1 against its plain twin on the float64 linearization `lin64`:
    float64 to `f64_tol`, float32 to K1_F32_TOL against the float64 plain
    result. Returns the float64 plain and float32 kernel outputs and the
    error figures; fails the run on disagreement."""
    import torch

    lin32 = {k: v.float().contiguous() for k, v in lin64.items()}
    a64 = tuple(lin64[k] for k in ORDER) + (mu, rows)
    a32 = tuple(lin32[k] for k in ORDER) + (mu, rows)
    ref, got = k1.riccati_backward_plain(*a64), k1.riccati_backward(*a64)
    p32, g32 = k1.riccati_backward_plain(*a32), k1.riccati_backward(*a32)
    torch.cuda.synchronize()
    e64 = max(rel_err(g, r) for g, r in zip(got, ref))
    e32 = {n: rel_err(g, r) for n, g, r in zip(SWEEP_OUT, g32, ref)}
    ep32 = {n: rel_err(g, r) for n, g, r in zip(SWEEP_OUT, p32, ref)}
    abs32 = max(abs_err(g, r) for g, r in zip(g32, ref))
    emit(tag, f64_rel_err=e64, f64_tol=f64_tol, f32_rel_err=e32,
         f32_tol=K1_F32_TOL, f32_plain_rel_err=ep32, f32_max_abs_err=abs32,
         **extra)
    if not (e64 <= f64_tol and all(e32[n] <= K1_F32_TOL for n in SWEEP_OUT)):
        fail(f"{tag}: K1 (riccati_backward) disagrees with its plain version")
    return ref, g32, lin32, dict(e64=e64, e32=e32, p32=ep32, abs32=abs32)


def tassa_check(tag, k1, lin64, mu, rows, solver, nan_member, **extra):
    """K1's Tassa instantiation with the gain solve `solver` against its
    twin on the float64 linearization `lin64`, member `nan_member`'s last
    defect NaN: float64 to 1e-9, float32 to K1_F32_TOL of the float64 twin,
    NaN exactly where the twin has NaN (that member's k and ΔV; its K stays
    finite). With Cholesky, μ = −1e12 (every Quu indefinite) on eight
    members must give NaN gains and ΔV in the kernel, as in the twin.
    Returns the error figures; fails the run on disagreement."""
    import torch

    kw = dict(form="tassa", quu_solver=solver)
    lin = dict(lin64, d=lin64["d"].clone())
    lin["d"][nan_member, -1, 0] = float("nan")
    a64 = tuple(lin[k] for k in ORDER)
    a32 = tuple(v.float().contiguous() for v in a64)
    ref = k1.riccati_backward_plain(*a64, mu, rows, **kw)
    got = k1.riccati_backward(*a64, mu, rows, **kw)
    p32 = k1.riccati_backward_plain(*a32, mu, rows, **kw)
    g32 = k1.riccati_backward(*a32, mu, rows, **kw)
    torch.cuda.synchronize()
    nan_twin = (bool(torch.isnan(ref[0][nan_member]).all())
                and bool(torch.isnan(ref[2][nan_member]))
                and bool(torch.isfinite(ref[1]).all()))
    e64 = max(rel_err(g, r) for g, r in zip(got, ref))
    e32 = {n: rel_err(g, r) for n, g, r in zip(SWEEP_OUT, g32, ref)}
    ep32 = {n: rel_err(g, r) for n, g, r in zip(SWEEP_OUT, p32, ref)}
    abs32 = max(abs_err(g, r) for g, r in zip(g32, ref))
    res = dict(quu_solver=solver, f64_rel_err=e64, f64_tol=1e-9,
               f32_rel_err=e32, f32_tol=K1_F32_TOL, f32_plain_rel_err=ep32,
               f32_max_abs_err=abs32, nan_member_nan_in_twin=nan_twin)
    fine = (nan_twin and e64 <= 1e-9
            and all(e32[n] <= K1_F32_TOL for n in SWEEP_OUT))
    if solver == "cholesky":
        sub = lambda t: t[:8].contiguous()
        ind = {}
        for name, args in (("f64", a64), ("f32", a32)):
            r_i = k1.riccati_backward_plain(*map(sub, args), -1e12, rows, **kw)
            g_i = k1.riccati_backward(*map(sub, args), -1e12, rows, **kw)
            torch.cuda.synchronize()
            ind[name] = all(bool(torch.isnan(t).all()) for t in (*r_i, *g_i))
        res["indefinite_quu_all_nan"] = ind
        fine &= all(ind.values())
    emit(tag, **res, **extra)
    if not fine:
        fail(f"{tag}: K1's Tassa form ({solver}) disagrees with its plain "
             "version")
    return dict(e64=e64, e32=e32, p32=ep32, abs32=abs32)


def tassa_times(k1, lin32, mu, rows, solvers):
    """K1's Tassa instantiations of one shape beside the collapsed one, in
    float32: ms at B=1 (member 0 alone: one block's latency, the single
    robot's launch) and at the fleet's B, the twin's ms at B=1, and the
    bytes, FLOPs and bound of the B=1 call."""
    import torch

    one = {k: v[:1].contiguous() for k, v in lin32.items()}
    a1 = tuple(one[k] for k in ORDER) + (mu, rows)
    aB = tuple(lin32[k] for k in ORDER) + (mu, rows)
    ns, nx = one["d"].shape[1:]
    nu, nt = one["Jup"].shape[-1], one["Jt"].shape[1]
    sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
             len(rows.bx), len(rows.uc))
    out = {"B": lin32["d"].shape[0], "collapsed": dict(
        ms_B1=cuda_ms(lambda: k1.riccati_backward(*a1), reps=20),
        ms_B=cuda_ms(lambda: k1.riccati_backward(*aB), reps=20))}
    for solver in solvers:
        kw = dict(form="tassa", quu_solver=solver)
        res = k1.riccati_backward(*a1, **kw)
        n_bytes = nbytes(*a1[:8], rows.packed(one["d"].device), *res)
        flop = tassa_flops(1, ns, nx, nu, nt, *sizes, solver)
        b_ms, b_by = bound(n_bytes, flop, H100_FP64_TC_FLOP_PER_S)
        out[solver] = dict(
            ms_B1=cuda_ms(lambda: k1.riccati_backward(*a1, **kw), reps=20),
            ms_B=cuda_ms(lambda: k1.riccati_backward(*aB, **kw), reps=20),
            plain_ms_B1=cuda_ms(lambda: k1.riccati_backward_plain(*a1, **kw),
                                reps=3, warmup=1),
            bytes_B1=n_bytes, flop_B1=flop, bound_ms_B1=b_ms, bound_by=b_by,
            shared_memory_bytes=k1.shared_memory_bytes(nx, nu, nt, rows,
                                                       torch.float32, **kw),
            blocks_per_sm=k1.blocks_per_sm(nx, nu, nt, rows, torch.float32,
                                           **kw))
    return out


def k2_check(tag, k1, Jup64, mu, **extra):
    """K2 alone, through `riccati.spd_inverse`, on the Quu-like stack
    2JupᵀJup + μI made from the float64 Jacobian rows `Jup64`: float64
    against `lm_spd_inverse` to K2_F64_TOL, float32 to K2_F32_TOL (see
    there); its time beside one `torch.linalg.inv` call on the same
    stack, float32 and float64, and the plain twin's. Returns the
    figures; fails the run on disagreement."""
    import torch
    from srbd_horizon_tpu_torch.math.linalg import lm_spd_inverse

    nu = Jup64.shape[-1]
    J = Jup64.reshape(-1, Jup64.shape[-2], nu)
    Q64 = (2.0 * J.transpose(-1, -2) @ J + mu * torch.eye(
        nu, dtype=torch.float64, device=J.device)).contiguous()
    Q32 = Q64.float()
    ref = lm_spd_inverse(Q64)
    ref32 = lm_spd_inverse(Q32.double())
    got64, got32 = k1.spd_inverse(Q64), k1.spd_inverse(Q32)
    torch.cuda.synchronize()
    res = dict(
        stack=list(Q64.shape), f64_rel_err=rel_err(got64, ref),
        f64_tol=K2_F64_TOL, f32_rel_err=rel_err(got32, ref32),
        f32_tol=K2_F32_TOL, f32_max_abs_err=abs_err(got32, ref32),
        f32_plain_rel_err=rel_err(lm_spd_inverse(Q32), ref32),
        f32_rel_err_vs_f64_stack=rel_err(got32, ref),
        ms_f32=cuda_ms(lambda: k1.spd_inverse(Q32), reps=20),
        ms_f64=cuda_ms(lambda: k1.spd_inverse(Q64), reps=20),
        # one matrix on one warp of an idle card: the routine's latency,
        # launch included, as K1's chain pays it once a node
        ms_one_matrix_f64=cuda_ms(lambda: k1.spd_inverse(Q64[:1]), reps=20),
        torch_linalg_inv_ms_f32=cuda_ms(lambda: torch.linalg.inv(Q32), reps=20),
        torch_linalg_inv_ms_f64=cuda_ms(lambda: torch.linalg.inv(Q64), reps=20),
        plain_ms_f32=cuda_ms(lambda: lm_spd_inverse(Q32), reps=5, warmup=1),
        bytes_f32=2 * nbytes(Q32), flop=2 * inv_flops(nu) * Q64.shape[0])
    res["bound_ms"], res["bound_by"] = bound(res["bytes_f32"], res["flop"],
                                             H100_FP64_TC_FLOP_PER_S)
    emit(tag, **res, **extra)
    if not (res["f64_rel_err"] <= K2_F64_TOL and res["f32_rel_err"] <= K2_F32_TOL):
        fail(f"{tag}: K2 (spd_inverse) disagrees with lm_spd_inverse")
    return res


def trial_check(tag, plain, kernel, args, alphas4, merit0, D, dV1, dV2, opts,
                nan_member, **extra):
    """A trial kernel (K3, K6) against its plain twin at 1 and 4 step
    sizes: float64 to 1e-9 with equal flags; float32 against the float64
    plain result within 2× the float32 twin's own error + 1e-6, flags
    equal except where the float64 Armijo margin is within rounding of
    zero; member `nan_member` starts from a NaN state and must be
    rejected. `args(dtype, alphas)` gives the call's arguments."""
    import torch

    f64, f32 = torch.float64, torch.float32
    e64s, e32s, p32s, abs32, flags, fine = {}, {}, {}, 0.0, {}, True
    for nA in (1, 4):
        al = alphas4[:nA]
        ref, got = plain(*args(f64, al)), kernel(*args(f64, al))
        p32, g32 = plain(*args(f32, al)), kernel(*args(f32, al))
        torch.cuda.synchronize()
        e64 = {n: rel_err(g, r) for n, g, r in zip(TRIAL_OUT, got, ref)}
        e32 = {n: rel_err(g, r) for n, g, r in zip(TRIAL_OUT, g32, ref)}
        ep32 = {n: rel_err(g, r) for n, g, r in zip(TRIAL_OUT, p32, ref)}
        abs32 = max(abs32, max(abs_err(g, r) for g, r in zip(g32, ref)))
        a = al[:, None]
        margin = (merit0 - ref[3]) - opts.beta * torch.clamp(
            -(a * dV1 + a * a * dV2)
            + (2 * a - a * a) * opts.defect_weight * D, min=1e-16)
        near = margin.abs() <= 1e-4 * merit0.abs().clamp_min(1.0)
        flips32 = int(((g32[4] != ref[4]) & ~near).sum())
        flags[nA] = dict(
            f64_flags_equal=bool(torch.equal(got[4], ref[4])),
            f32_flips_off_margin=flips32, near_margin=int(near.sum()),
            accepted=int(ref[4].sum()),
            nan_member_rejected=not bool(got[4][:, nan_member].any()))
        e64s[nA], e32s[nA], p32s[nA] = e64, e32, ep32
        fine &= (max(e64.values()) <= 1e-9
                 and all(e32[n] <= 2 * ep32[n] + 1e-6 for n in TRIAL_OUT)
                 and flags[nA]["f64_flags_equal"] and flips32 == 0
                 and flags[nA]["nan_member_rejected"])
    emit(tag, f64_rel_err=e64s, f64_tol=1e-9, f32_rel_err=e32s,
         f32_plain_rel_err=p32s, f32_rule="kernel <= 2*plain + 1e-6",
         flags=flags, f32_max_abs_err=abs32, **extra)
    if not fine:
        fail(f"{tag}: the trial kernel disagrees with its plain version")
    worst = lambda d: max(max(e.values()) for e in d.values())
    return dict(e64=worst(e64s), e32=worst(e32s), p32=worst(p32s), abs32=abs32)


def bits(t):
    """The bit patterns of a float tensor, for equality that sees NaNs."""
    import torch

    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def evaluate_check(tag, plain, kernel, args, nan_member, x0, **extra):
    """An evaluation entry (srbd_evaluate, isrbd_evaluate) against its
    plain twin, on its two outputs (the cost and the largest defect of each
    plan), without and with node 0 pinned to `x0` (float64, cast to each
    type): float64 to 1e-9; float32 against the float64 plain result within
    2× the float32 twin's own error + 1e-6; member `nan_member` holds a NaN
    in its plan and must come out NaN in both outputs of both types (rel_err
    also fails on any other difference of the non-finite entries); with x0
    the pinned plan must equal the twin's bit for bit in both types.
    `args(dtype)` gives the call's arguments. Returns the error figures of
    the call without x0; fails the run on disagreement."""
    import torch

    f64, f32 = torch.float64, torch.float32
    names = ("cost", "defect_max")
    res, fine, errs = {}, True, None
    for pinned in (False, True):
        kw = lambda dtype: dict(x0=x0.to(dtype).contiguous()) if pinned else {}
        ref, got = plain(*args(f64), **kw(f64)), kernel(*args(f64), **kw(f64))
        p32, g32 = plain(*args(f32), **kw(f32)), kernel(*args(f32), **kw(f32))
        torch.cuda.synchronize()
        e64 = {n: rel_err(g, r) for n, g, r in zip(names, got, ref)}
        e32 = {n: rel_err(g, r) for n, g, r in zip(names, g32, ref)}
        ep32 = {n: rel_err(g, r) for n, g, r in zip(names, p32, ref)}
        abs32 = max(abs_err(g, r) for g, r in zip(g32[:2], ref[:2]))
        nan_kept = all(bool(torch.isnan(o[nan_member])) for out in (got, g32)
                       for o in out[:2])
        r = dict(f64_rel_err=e64, f32_rel_err=e32, f32_plain_rel_err=ep32,
                 f32_max_abs_err=abs32, nan_member_nan=nan_kept)
        fine &= (max(e64.values()) <= 1e-9 and nan_kept
                 and all(e32[n] <= 2 * ep32[n] + 1e-6 for n in names))
        if pinned:
            r["pinned_X_bit_equal"] = (
                len(got) == len(g32) == 3
                and bool(torch.equal(bits(got[2]), bits(ref[2])))
                and bool(torch.equal(bits(g32[2]), bits(p32[2]))))
            fine &= r["pinned_X_bit_equal"]
        else:
            errs = dict(e64=e64, e32=e32, p32=ep32, abs32=abs32)
        res["pinned" if pinned else "plain_plan"] = r
    emit(tag, f64_tol=1e-9, f32_rule="kernel <= 2*plain + 1e-6",
         pinned_rule="pinned X equal to the twin's bit for bit",
         B=int(x0.shape[0]), **res, **extra)
    if not fine:
        fail(f"{tag}: the evaluation kernel disagrees with its plain version")
    return errs


def evaluate_size_probe(kernel, args32, x0, sizes):
    """An evaluation entry's time at fleet sizes around whole waves
    (members repeated), float32, with node 0 pinned as the solve's cost0
    call does: {B: ms}. B=1 reads one member's latency."""
    out = {}
    for Bw in sizes:
        a = repeat_members(args32 + (x0,), Bw)
        out[Bw] = cuda_ms(lambda: kernel(*a[:-1], x0=a[-1]), reps=20)
    return out


def host_us(fn, calls=200, reset=None):
    """Host µs a call of `fn` over `calls` calls on the host clock (the
    device keeps up: the kernels take a fraction of a call's host time),
    with `reset()` before each call when given."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        if reset is not None:
            reset()
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_us_turns(fns, batches=8, calls=50):
    """Host µs a call of each of `fns` ({name: fn}), `batches` batches of
    `calls` calls each, the functions in turns within a batch (in order,
    then in reverse): the median batch of each, which a garbage collection
    inside one batch does not move."""
    import torch

    names = list(fns)
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    per = {n: [] for n in names}
    for _ in range(batches):
        for n in names + names[::-1]:
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[n]()
            per[n].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {n: statistics.median(v) for n, v in per.items()}


def evaluate_host_us(kernel, args32, x0, clear):
    """Host µs a call of an evaluation wrapper, with its cached host setup
    (`build.host_setup`) and with it cleared before every call (the work
    each call did before the cache), without x0 and with it."""
    out = {}
    for name, kw in (("no_x0", {}), ("x0", dict(x0=x0))):
        call = lambda: kernel(*args32, **kw)
        out[name] = dict(cached=host_us(call), uncached=host_us(call, reset=clear))
    return out


def evaluate_occupancy(mod, ns, serving_B, sms):
    """An evaluation entry's occupancy in both types, and the waves of
    blocks at the serving fleet size."""
    import torch

    out = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        occ = mod.evaluate_occupancy(ns, dtype)
        occ["waves_at_serving_B"] = -(-serving_B // max(1, occ["blocks_per_sm"] * sms))
        out[name] = occ
    return out


def repeat_members(args, Bsz, skip=()):
    """`args` with every tensor (and every tensor of a dict) of a leading
    member axis repeated to Bsz members; positions in `skip` stay."""
    import torch

    def rep(t):
        n = t.shape[0]
        return torch.cat([t] * -(-Bsz // n))[:Bsz].contiguous()

    out = []
    for i, a in enumerate(args):
        if i in skip:
            out.append(a)
        elif isinstance(a, dict):
            out.append({k: rep(v) for k, v in a.items()})
        elif isinstance(a, torch.Tensor):
            out.append(rep(a))
        else:
            out.append(a)
    return tuple(out)


def trial_size_probe(trial, args1, sizes):
    """A trial kernel's (K3's, K6's) time with one α at fleet sizes on
    either side of whole waves (members repeated): {B: ms}, float32. At
    B up to a wave every warp has a scheduler to itself, so B=1 reads the
    chain's own latency; where the time stays flat up to there the chain,
    not the bytes, sets it."""
    out = {}
    for Bw in sizes:
        a = repeat_members(args1, Bw, skip=(6,))
        out[Bw] = cuda_ms(lambda: trial(*a), reps=20)
    return out


def kernel_row(name, mod, launches, ms, plain_ms, bound_ms, bound_by, err,
               tol_f32, **extra):
    """One entry of the `kernels` line from a check's error figures."""
    worst = lambda v: max(v.values()) if isinstance(v, dict) else v
    return dict(name=name, route="cuda", source=mod.SOURCE,
                replaces=mod.REPLACES, launches=launches,
                max_abs_err=err["abs32"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                max_rel_err_f64=worst(err["e64"]), tol_f64=1e-9,
                max_rel_err_f32=worst(err["e32"]), tol_f32=tol_f32,
                plain_rel_err_f32=worst(err["p32"]), **extra)


def k1_wave_probe(k1, lin32, order, mu, rows, sizes):
    """K1's time at fleet sizes on either side of whole waves of blocks
    (one block per member): {B: ms}, float32, members repeated to size."""
    import torch

    n = next(iter(lin32.values())).shape[0]
    reps = -(-max(sizes) // n)
    big = {k: torch.cat([lin32[k]] * reps) for k in order}
    out = {}
    for Bw in sizes:
        args = tuple(big[k][:Bw].contiguous() for k in order) + (mu, rows)
        out[Bw] = cuda_ms(lambda: k1.riccati_backward(*args), reps=10)
    return out


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


def tick_spans(solver, step, carry, ticks):
    """Per-phase device-timeline and host times inside `ticks` real ticks
    (means per tick), and the tick wall time they add up to. `solver` is
    the `MSDDP` whose `on_phase` hook marks the phases, `step(carry)` runs
    one tick and returns the next carry."""
    import torch

    clock = PhaseClock()
    solver.on_phase = clock
    dev_ms, host_ms, entries = defaultdict(float), defaultdict(float), defaultdict(int)
    walls = []
    try:
        for _ in range(ticks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clock("glue")
            carry = step(carry)
            clock("end")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            clock.charge(dev_ms, host_ms, entries)
    finally:
        solver.on_phase = None
    per = lambda d: {k: v / ticks for k, v in sorted(d.items())}
    return carry, dict(
        ticks=ticks, tick_wall_ms=statistics.fmean(walls),
        device_span_ms=per(dev_ms),
        device_span_total_ms=sum(dev_ms.values()) / ticks,
        host_ms=per(host_ms), host_total_ms=sum(host_ms.values()) / ticks,
        phase_entries_per_tick=per(entries),
    )


class SpanRanges:
    """`MSDDP.on_phase` callback under the profiler: a `record_function`
    range named "span:<phase>" from each phase boundary to the next, so
    that the launches the host makes can be charged to the phase that
    made them (`span_launches`)."""

    def __init__(self):
        self.open = None

    def __call__(self, name):
        from torch.autograd.profiler import record_function

        self.close()
        self.open = record_function(f"span:{name}")
        self.open.__enter__()

    def close(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


# the host-side runtime calls the profiler records for a launch and for a
# copy or fill (name prefixes)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
COPY_CALLS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def span_launches(prof, ticks):
    """Kernel launches and memcpy/memset calls a tick, by the span
    (`SpanRanges`) whose range holds the host call that made them."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end, e.name[5:])
                   for e in evs if e.name.startswith("span:"))
    out = defaultdict(lambda: {"kernels": 0.0, "memcpy_memset": 0.0})
    for e in evs:
        kind = ("kernels" if e.name.startswith(LAUNCH_CALLS) else
                "memcpy_memset" if e.name.startswith(COPY_CALLS) else None)
        if kind is None:
            continue
        t = e.time_range.start
        name = next((n for a, b, n in spans if a <= t <= b), "outside")
        out[name][kind] += 1.0 / ticks
    return {k: dict(v) for k, v in sorted(out.items())}


def profile_ticks(solver, step, carry, tick_ms, ticks=2):
    """Device busy time, kernel launches and the heaviest kernels per tick
    under torch.profiler (`solver` and `step` as in `tick_spans`), and the
    launches and memcpy/memset calls a tick by phase (`span_launches`). The
    profiler slows the host, so the idle share is taken against `tick_ms`,
    the unprofiled tick time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = solver
    syncs0 = s.host_syncs
    ranges = SpanRanges()
    s.on_phase = ranges
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            c = carry
            for _ in range(ticks):
                ranges("glue")
                c = step(c)
                ranges.close()
            torch.cuda.synchronize()
    finally:
        ranges.close()
        s.on_phase = None
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
        launches_by_span=span_launches(prof, ticks),
        top_kernels=[(e.key[:60], e.self_device_time_total / 1e3 / ticks,
                      e.count / ticks) for e in top],
    )


def count_calls(targets):
    """Wrap each attribute `name` of `owner` in `targets` ((owner, names)
    pairs) with one call counter; returns the counter and a function that
    restores the originals."""
    calls = {"n": 0}
    saved = []
    for owner, names in targets:
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


def count_torch_func():
    """Count every torch.func transform call (count_calls)."""
    import torch
    import torch.func

    return count_calls(((torch.func, TORCH_FUNC_TRANSFORMS), (torch, ("vmap",))))


def count_plain_cost():
    """Count every call of the plain cost and defect functions a solve could
    reach instead of its evaluation kernel: each problem family's
    `total_cost` (SRBD, AL inner, LIP) and `MSDDP.total_cost` /
    `MSDDP._true_defects` (count_calls)."""
    from srbd_horizon_tpu_torch.problems.isrbd_al import ALTerms
    from srbd_horizon_tpu_torch.problems.lip import LIPTerms
    from srbd_horizon_tpu_torch.problems.srbd import SRBDTerms
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

    return count_calls(((SRBDTerms, ("total_cost",)), (ALTerms, ("total_cost",)),
                        (LIPTerms, ("total_cost",)),
                        (MSDDP, ("total_cost", "_true_defects"))))


def recorded(obj, name, store):
    """Replace the method `name` of `obj` by one that appends a clone of its
    tensor arguments (dicts and NamedTuples of tensors included), and of
    its keyword arguments as a dict last, to `store`; returns a function
    that restores it."""
    import torch

    orig = getattr(obj, name)

    def clone(a):
        if isinstance(a, dict):
            return {k: clone(v) for k, v in a.items()}
        if isinstance(a, tuple) and hasattr(a, "_fields"):   # ALState, priors
            return type(a)(*(clone(v) for v in a))
        return a.clone() if isinstance(a, torch.Tensor) else a

    def wrapped(*a, **kw):
        store.append(tuple(clone(v) for v in a) + (clone(kw),))
        return orig(*a, **kw)

    # a kernel wrapper counts its launches on the name it is called by
    counted = hasattr(orig, "launches")
    if counted:
        wrapped.launches = orig.launches
    setattr(obj, name, wrapped)

    def restore():
        if counted:
            orig.launches = wrapped.launches
        setattr(obj, name, orig)

    return restore


def count_al_twins():
    """Count every call of the AL layer's plain twins and their pieces
    (`kernels/isrbd_al.py::PLAIN_TWINS`; count_calls)."""
    from srbd_horizon_tpu_torch.kernels import isrbd_al

    return count_calls(((isrbd_al, isrbd_al.PLAIN_TWINS),))


def count_solver_calls(*solvers):
    """Count the MSDDP solvers' iterations (`_iteration`, one a single or
    `vmap(solve)` iteration, and `_iteration_batch`), trials (`_trial`,
    also by kind: with the linearization, the linear pass, or without it,
    the rollout) and solves (either entry) in `n`; returns `n` and a
    function that restores the solvers."""
    n = {"iterations": 0, "trials": 0, "linear_trials": 0,
         "rollout_trials": 0, "solves": 0}
    saved = []

    def wrap(fn, key):
        def counted(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        return counted

    def trial(fn):
        def counted(*a):
            n["trials"] += 1
            linear = len(a) > 12 and a[12] is not None
            n["linear_trials" if linear else "rollout_trials"] += 1
            return fn(*a)
        return counted

    for s in solvers:
        saved.append((s, s._iteration, s._iteration_batch, s._trial, s.solve,
                      s.solve_batch))
        s._iteration = wrap(s._iteration, "iterations")
        s._iteration_batch = wrap(s._iteration_batch, "iterations")
        s._trial = trial(s._trial)
        s.solve = wrap(s.solve, "solves")
        s.solve_batch = wrap(s.solve_batch, "solves")

    def restore():
        for s, it, itb, tr, so, sb in saved:
            s._iteration, s._iteration_batch, s._trial = it, itb, tr
            s.solve, s.solve_batch = so, sb

    return n, restore


def guard_plain(twins, al=False):
    """Count the kernels' plain twins (`twins`, as `count_calls` takes
    them), the plain cost and defect functions, torch.func transforms and,
    with `al`, the AL layer's twins; returns the counters by name and a
    function that restores every original."""
    counters, restores = {}, []
    for name, (c, r) in (("torch_func_calls", count_torch_func()),
                         ("plain_cost_or_defect_calls", count_plain_cost()),
                         ("plain_twin_calls", count_calls(twins))) + (
            (("al_twin_calls", count_al_twins()),) if al else ()):
        counters[name] = c
        restores.append(r)

    def restore():
        for r in restores:
            r()

    return counters, restore


def outputs(res, prefix=""):
    """The tensors of an entry's result as (name, tensor) pairs: tuples by
    position, NamedTuples (ALState, its DDPSolution, the priors) and dicts
    by name."""
    import torch

    if isinstance(res, dict):
        items = sorted(res.items())
    elif hasattr(res, "_fields"):
        items = zip(res._fields, res)
    else:
        items = ((str(i), v) for i, v in enumerate(res))
    out = []
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, torch.Tensor):
            out.append((name, v))
        else:
            out.extend(outputs(v, name))
    return out


def al_rel_err(got, want):
    """max |got − want| / max(1, |want|) over the entries where `want` is
    finite, in float64; inf if the NaN or the non-finite entries differ."""
    import torch

    got, want = got.double(), want.double()
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isfinite(got), torch.isfinite(want))):
        return float("inf")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    g, w = got[fin], want[fin]
    return float(((g - w).abs() / w.abs().clamp_min(1.0)).max())


def same_bits(a, b):
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return bool(torch.equal(bits(a), bits(b)) if a.is_floating_point()
                else torch.equal(a, b))


def al_check(tag, kernel, plain, args, exact, nan_member, **extra):
    """An AL entry (K7, K8a-c) against its plain twin on the card.
    `args(dtype)` gives (arguments, keyword arguments) in that type. With
    `exact` (K8: copies and the prior's blend) every output equals the
    twin's bit for bit in both types; else (K7) float64 within AL_F64_TOL
    of max(1, |twin|) entry by entry and float32 against the float64 twin
    within 2× the float32 twin's own error + 1e-6 (K3's rule). In both, NaN
    where the twin has NaN, and the twin's outputs for member `nan_member`
    hold a NaN. Returns the error figures; fails the run on disagreement."""
    import torch

    f64, f32 = torch.float64, torch.float32
    (a64, k64), (a32, k32) = args(f64), args(f32)
    ref, got = outputs(plain(*a64, **k64)), outputs(kernel(*a64, **k64))
    p32, g32 = outputs(plain(*a32, **k32)), outputs(kernel(*a32, **k32))
    torch.cuda.synchronize()
    names = [n for n, _ in ref]
    fine = (names == [n for n, _ in got] == [n for n, _ in p32]
            == [n for n, _ in g32])
    flt = [i for i, (_, t) in enumerate(ref) if t.is_floating_point()]
    bsz = ref[flt[0]][1].shape[0]
    nan_twin = any(bool(torch.isnan(ref[i][1][nan_member]).any())
                   for i in flt if ref[i][1].dim() and ref[i][1].shape[0] == bsz)
    ep32 = {names[i]: rel_err(p32[i][1], ref[i][1]) for i in flt}
    e32 = {names[i]: rel_err(g32[i][1], ref[i][1]) for i in flt}
    aerr = lambda a, b: (abs_err(a, b) if bool(torch.isfinite(b).any())
                         else 0.0)
    abs32 = max(aerr(g32[i][1], ref[i][1]) for i in flt)
    res = dict(outputs=len(names), nan_member_nan_in_twin=nan_twin)
    if exact:
        eq64 = all(same_bits(g, r) for (_, g), (_, r) in zip(got, ref))
        eq32 = all(same_bits(g, p) for (_, g), (_, p) in zip(g32, p32))
        res.update(bit_equal_f64=eq64, bit_equal_f32=eq32)
        fine &= eq64 and eq32
        e64 = {n: 0.0 if eq64 else float("inf") for n in e32}
        abs32 = max(aerr(g32[i][1], p32[i][1]) for i in flt)
    else:
        e64 = {names[i]: al_rel_err(got[i][1], ref[i][1]) for i in flt}
        nan32 = all(torch.equal(torch.isnan(g32[i][1]), torch.isnan(p32[i][1]))
                    for i in flt)
        res.update(f64_err=e64, f64_tol=AL_F64_TOL, f32_rel_err=e32,
                   f32_plain_rel_err=ep32, f32_rule="kernel <= 2*plain + 1e-6",
                   f32_nan_where_twin_nan=nan32, f32_max_abs_err=abs32)
        fine &= (max(e64.values()) <= AL_F64_TOL and nan32
                 and all(e32[n] <= 2 * ep32[n] + 1e-6 for n in e32))
    fine &= nan_twin
    emit(tag, **extra, **res)
    if not fine:
        fail(f"{tag} ({extra}): the AL kernel disagrees with its plain version")
    return dict(e64=max(e64.values()), e32=max(e32.values()),
                p32=max(ep32.values()), abs32=abs32)


def cast_tree(tree, dtype):
    """A tensor, an ALState, a prior or a dict of tensors with every
    floating tensor in `dtype` (contiguous); anything else as it is."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dtype).contiguous() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_tree(v, dtype) for v in tree))
    return tree


def resize_members(tree, Bsz, Bw):
    """`tree` (a tensor, a NamedTuple, a dict or a tuple of them) with every
    tensor of Bsz leading members repeated or cut to Bw; the rest as it
    is."""
    import torch

    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0 or tree.shape[0] != Bsz:
            return tree
        return torch.cat([tree] * -(-Bw // Bsz))[:Bw].contiguous()
    if isinstance(tree, dict):
        return {k: resize_members(v, Bsz, Bw) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [resize_members(v, Bsz, Bw) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def al_bytes(inputs, result):
    """Bytes an AL entry must move: each input tensor read once, each
    output written once (its `outputs`, less the inputs it passes through
    unchanged)."""
    ins = [t for t in inputs if t is not None]
    seen = {t.data_ptr() for t in ins}
    outs = [t for _, t in outputs(result) if t.data_ptr() not in seen]
    return nbytes(*ins, *outs)


def al_constraints_flops(Bsz, ns, nx, nu, n_eq, n_eq_T, n_in):
    """FLOPs one K7 call needs: the world inertia and Iw ω a node (~120),
    ~30 per equality row (the Newton–Euler rows more, the selections less)
    and its update (3), ~6 a cone row, ~4 a box row and its update (3)."""
    node = 120 + n_eq * 33 + n_in * 9 + (nx + nu) * 2 * 7
    return Bsz * (ns * node + n_eq_T * 33 + nx * 2 * 7)


def draw_isrbd_point(al, Bsz, g, dev, com_z, fz, fxy, u_box):
    """A linearization point of the isrbd AL inner problem of `al` (an
    ALDDP in float64 on `dev`) at Bsz members, drawn from the numpy
    RandomState `g`: plans around a stance at CoM height com_z with a
    non-unit quaternion, forces of fz ± fxy·N(0,1) horizontally (active
    cones), random multipliers, penalties and 0/1 node masks, and box
    overrides drawn inside the data (x within ±0.1, the finite u boxes
    u_box; active on either side). Returns X, U, the ALState, the params
    with the overrides and the inner params (`_params_with_multipliers`)."""
    import numpy as np
    import torch

    ocp = al.ocp
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    nc = (nu - 6) // 6
    n_eq, n_eq_T, n_in = al._sizes
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = np.zeros((Bsz, ns + 1, nx))
    X[..., 0:3] = [0.0, 0.0, com_z] + 0.05 * g.randn(Bsz, ns + 1, 3)
    X[..., 3:7] = [0.1, -0.2, 0.05, 0.97] + 0.02 * g.randn(Bsz, ns + 1, 4)
    X[..., 7:] = g.uniform(-0.3, 0.3, (Bsz, ns + 1, nx - 7))
    U = 0.5 * g.randn(Bsz, ns, nu)
    for q in range(nc):
        U[..., 9 + 6 * q:12 + 6 * q] = ([0.0, 0.0, fz]
                                        + [fxy, fxy, 5.0] * g.randn(Bsz, ns, 3))
    pos = lambda *shape: t64(np.abs(g.randn(*shape)))
    st = al.init(t64(X[:, 0]))._replace(
        lam_eq=t64(g.randn(Bsz, ns, n_eq)), lam_eq_T=t64(g.randn(Bsz, n_eq_T)),
        mu_ub=5.0 * pos(Bsz, ns, n_in), mu_lb=pos(Bsz, ns, n_in),
        mu_x_ub=pos(Bsz, ns + 1, nx), mu_x_lb=pos(Bsz, ns + 1, nx),
        mu_u_ub=pos(Bsz, ns, nu), mu_u_lb=pos(Bsz, ns, nu),
        rho=t64(10.0 ** g.uniform(3, 5, Bsz)))
    params = {k: v.expand((Bsz,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    for k in ("mask_track", "mask_srbd", "mask_lip", "mask_lipzone"):
        params[k] = t64(g.randint(0, 2, tuple(params[k].shape)))
    params["Wo"] = pos(Bsz, ns + 1, 1)
    params["rdot_ref"] = t64(0.1 * g.randn(Bsz, ns + 1, 3))
    params["c_ref"] = 0.05 * pos(Bsz, ns + 1, nc)
    for name, lo, hi in (("x", -0.1, 0.1), ("u",) + tuple(u_box)):
        lb = getattr(ocp, f"{name}_lb").expand(Bsz, -1, -1).clone()
        ub = getattr(ocp, f"{name}_ub").expand(Bsz, -1, -1).clone()
        fin = torch.isfinite(ub)
        lb[fin], ub[fin] = lo, hi
        params[f"{name}_lb"], params[f"{name}_ub"] = lb, ub
    pin = {k: v.contiguous()
           for k, v in al._params_with_multipliers(params, st).items()}
    return t64(X), t64(U), st, params, pin


def static_bounds(params):
    """`params` without the box overrides: the static bounds."""
    return {k: v for k, v in params.items()
            if k not in ("x_lb", "x_ub", "u_lb", "u_ub")}


def al_entry_checks(tag, AL, X, U_nan, st, params, viol_later, priors, phase,
                    nan_member):
    """K7 and K8 against their twins (`al_check`) on one drawn point:
    K7 in eval mode and in the online and offline modes on a first outer
    (st's viol) and a later one (`viol_later`), with the static bounds and
    with `params`' overrides; K8a with each of `priors` (None: no prior);
    K8b with the static bounds, the overrides and x_lb / u_ub alone; K8c
    with the tail and the full prior at EMA 0.5 and 1. `AL(dtype)` is the
    solver of that type, `U_nan` the plan's inputs with a NaN in member
    `nan_member`. Returns the worst error figures of k7, k8a, k8b, k8c."""
    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78

    cast = lambda a, d: a.to(d).contiguous()
    pcast = lambda pp, d: {k: cast(v, d) for k, v in pp.items()}
    Bsz = X.shape[0]
    partial = {k: v for k, v in params.items() if k not in ("x_ub", "u_lb")}
    bounds = (("static", static_bounds(params)), ("boxes", params))
    err = {}
    for bname, pp in bounds:
        err[f"k7_eval_{bname}"] = al_check(
            tag, k78.isrbd_al_constraints, k78.isrbd_al_constraints_plain,
            lambda d: ((AL(d), cast(X, d), cast(U_nan, d), pcast(pp, d)), {}),
            exact=False, nan_member=nan_member, entry="isrbd_al_constraints",
            mode="eval", bounds=bname, B=Bsz)
        for mode in ("online", "offline"):
            for outer, vp in (("first", st.viol), ("later", viol_later)):
                st_m = st._replace(viol=vp)
                err[f"k7_{mode}_{bname}_{outer}"] = al_check(
                    tag, k78.isrbd_al_constraints,
                    k78.isrbd_al_constraints_plain,
                    lambda d: ((AL(d), cast(X, d), cast(U_nan, d), pcast(pp, d)),
                               dict(st=cast_tree(st_m, d),
                                    offline=mode == "offline")),
                    exact=False, nan_member=nan_member,
                    entry="isrbd_al_constraints", mode=mode, bounds=bname,
                    outer=outer, B=Bsz)
    for pkind, pr in priors.items():
        err[f"k8a_{pkind}"] = al_check(
            tag, k78.isrbd_al_shift, k78.isrbd_al_shift_plain,
            lambda d: ((AL(d), cast_tree(st, d),
                        None if pr is None else cast_tree(pr, d),
                        None if pr is None else phase), {}),
            exact=True, nan_member=nan_member, entry="isrbd_al_shift",
            prior=pkind, B=Bsz)
    for bname, pp in bounds + (("x_lb_u_ub", partial),):
        err[f"k8b_{bname}"] = al_check(
            tag, k78.isrbd_al_params, k78.isrbd_al_params_plain,
            lambda d: ((AL(d), pcast(pp, d), cast_tree(st, d)), {}),
            exact=True, nan_member=nan_member, entry="isrbd_al_params",
            bounds=bname, B=Bsz)
    for pkind in ("tail", "full"):
        for ema in (0.5, 1.0):
            err[f"k8c_{pkind}_{ema}"] = al_check(
                tag, k78.isrbd_al_prior_update,
                k78.isrbd_al_prior_update_plain,
                lambda d: ((AL(d), cast_tree(priors[pkind], d),
                            cast_tree(st, d), phase, ema), {}),
                exact=True, nan_member=nan_member,
                entry="isrbd_al_prior_update", prior=pkind, ema=ema, B=Bsz)
    worst = lambda prefix, key: max(v[key] for k, v in err.items()
                                    if k.startswith(prefix))
    return {e: {key: worst(e, key) for key in ("e64", "e32", "p32", "abs32")}
            for e in ("k7", "k8a", "k8b", "k8c")}


def al_call_work(al32, name, args, kw, res):
    """Bytes and FLOPs of one float32 call of the AL entry `name` (K7's
    offline and eval modes as `isrbd_al_constraints_offline` and
    `isrbd_al_constraints_eval`) with these arguments
    and result: each input read once and each output written once (K8a
    also one table row and flag a member, K8c the whole tables anew)."""
    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78

    ocp = al32.ocp
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    n_eq, n_eq_T, n_in = al32._sizes
    st = next((v for v in args if type(v).__name__ == "ALState"), kw.get("st"))
    if name.startswith("isrbd_al_constraints"):
        Bsz = args[1].shape[0]
        ins = [args[1], args[2], *(args[3][k] for k in (
            "c_ref", "mask_srbd", "mask_lip", "mask_lipzone")),
               *al32._bounds_from(args[3])]
        if st is not None:             # the eval mode reads no state
            ins += [st.lam_eq, st.lam_eq_T, st.rho]
        if kw.get("offline"):
            ins += [st.viol] + [getattr(st, f) for f in k78.MULTIPLIERS[2:]]
        return (al_bytes(ins, res),
                al_constraints_flops(Bsz, ns, nx, nu, n_eq, n_eq_T, n_in))
    Bsz = st.rho.shape[0]
    if name == "isrbd_al_shift":
        prior, phase = args[2], args[3]
        rolled = [st.sol.X, st.sol.U, *(getattr(st, f) for f in k78.ROLLED)]
        if prior is None:
            return al_bytes(rolled, res), 0
        # a table row and the flags of each member's phase
        kind, _ = k78.prior_kind(prior)
        row = (ns * n_eq if kind == 2 else n_eq) + n_eq_T
        e = st.lam_eq.element_size()
        return (al_bytes(rolled + [st.lam_eq_T], res) + Bsz * row * e
                + Bsz * (3 - kind) + nbytes(phase)), 0
    if name == "isrbd_al_params":
        # and the u-box overrides, padded
        over = [k for k in ("u_lb", "u_ub") if k in args[1]]
        written = {k: v for k, v in res.items()
                   if k in ("al_lam_eq", "al_lam_eq_T", "al_mu_ub", "al_mu_lb",
                            "al_rho", "al_mu_u_ub", "al_mu_u_lb")
                   or k in (f"al_{o}" for o in over)}
        return al_bytes([st.lam_eq, st.lam_eq_T, st.mu_ub, st.mu_lb, st.rho,
                         st.mu_u_ub, st.mu_u_lb, *(args[1][o] for o in over)],
                        written), 0
    prior, phase = args[1], args[3]
    return (al_bytes([st.lam_eq, st.lam_eq_T, phase, *prior], res),
            3 * Bsz * (ns * n_eq + n_eq_T))


# ---------------- the LIP paths (phase 10) ----------------

# K10, K11 and lip_evaluate in float64 at B=8: |kernel − twin| ≤
# 1e-12·max(1, |twin|) entry by entry (K10's Jacobians bit for bit)
LIP_F64_TOL = 1e-12
# card = CPU on the LIP paths with the solver's own options: each solve's
# last iteration runs on the merit's rounding floor (the LIP is
# linear-quadratic: its first Gauss-Newton step is exact), where whether a
# rounding-noise step through the ill-conditioned Quu passes the Armijo
# test flips with the order of the sums; that step moves u0 and the plans
# by up to ~1e-7 of their largest entry (4.7e-8 on the float64 CPU walk of
# tests/test_torch_lip_loop.py), the cost by ~1e-15. Those are held to
# LIP_FLOOR_TOL, the cost to 1e-9; the same ticks with max_iters=1 (the
# exact step alone, no floor) hold everything to 1e-9.
LIP_FLOOR_TOL = 1e-6
LIP_HEIGHT = 0.88                   # the dlip walk's CoM height gate (±0.08)


def err1(got, want):
    """max |got − want| / max(1, |want|) over the entries where `want` is
    finite; inf if the non-finite entries differ."""
    import torch

    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float(((got - want).abs() / want.abs().clamp_min(1.0))[fin].max())


def lip_linearize_flops(Bsz, ns, nx, n_rho, n_gx):
    """FLOPs one K10 call needs: ~5 per residual row, the Euler defects,
    one multiply per scaled Jacobian entry, the terminal rows."""
    return Bsz * (ns * (5 * n_rho + 3 * nx + n_gx * nx) + 5 * 10)


def lip_trial_flops(Bsz, ns, nx, nu, n_rho, nA):
    """FLOPs one K11 call needs: gain application and the Euler update per
    node, ~5 per residual row, the terminal rows, merit and Armijo test."""
    node = nx + 2 * nu * nx + 3 * nu + 4 * nx + 5 * n_rho
    return nA * Bsz * (ns * node + 5 * 10 + 20)


def lip_evaluate_flops(Bsz, ns, nx, n_rho):
    """FLOPs one lip_evaluate call needs: ~5 per residual row, the Euler
    step and |defect| per node, the terminal rows and the node sums."""
    return Bsz * (ns * (5 * n_rho + 4 * nx) + 5 * 10 + 2 * ns)


def lip_layout_gate(k11, occ, ns):
    """Fail unless the card's shared memory a K11 block (the .cu's own
    count, `trial_occupancy`) is what `smem_bytes` states, for float32 and
    float64 with one and four α, and a lip_evaluate block's what
    `evaluate_smem_bytes` states at its most members; and unless K10, K11
    and lip_evaluate spill nothing and fit an SM."""
    import torch

    for key, dtype, nA in (("lip_trial", torch.float32, 1),
                           ("lip_trial_4alpha", torch.float32, 4),
                           ("lip_trial_f64", torch.float64, 1),
                           ("lip_trial_f64_4alpha", torch.float64, 4)):
        want = k11.smem_bytes(dtype, ns, nA)["total"]
        if occ[key]["shared_memory_bytes"] != want:
            fail(f"K11 ({key}) takes {occ[key]['shared_memory_bytes']} B a "
                 f"block on the card; lip_rollout.smem_bytes states {want}")
    for key, dtype in (("lip_evaluate", torch.float32),
                       ("lip_evaluate_f64", torch.float64)):
        want = k11.evaluate_smem_bytes(dtype, ns)["total"]
        if occ[key]["shared_memory_bytes"] != want:
            fail(f"lip_evaluate ({key}) takes "
                 f"{occ[key]['shared_memory_bytes']} B a block on the card; "
                 f"lip_rollout.evaluate_smem_bytes states {want}")
    for key, o in occ.items():
        if key.startswith("lip_") and (o.get("local_bytes_per_thread")
                                       or o["blocks_per_sm"] < 1):
            fail(f"{key} spills or does not fit: {o}")


def lip_section(card, dev, sms):
    """Phase 10: the LIP kernels against their twins (`lip_check`), their
    times (`lip_kernel_times`), the dlip closed loop on `MPCLoop.tick`
    (`lip_path`) and the LIP fleet tick (`lip_fleet_path`), each with card =
    CPU in float64. Returns the kernel rows of the `kernels` line."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.runtime.loop import (
        TickInput,
        build_lip_loop,
        walk_command,
        walking_schedule,
    )

    f64, f32 = torch.float64, torch.float32
    rng = np.random.RandomState(SEED + 10)
    loop64, prob = build_lip_loop(SRBDConfig(dtype=f64), device=dev)
    loop32, _ = build_lip_loop(SRBDConfig(), device=dev)
    s64, s32 = loop64.solver, loop32.solver
    ocp = prob.ocp
    ns, nx, nu, nc, dt = ocp.ns, ocp.nx, ocp.nu, prob.nc, ocp.dt
    opts, rows, mu = s64.opts, s64.rows, s64.opts.mu0
    B = B_MAIN
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = t(prob.initial_state.cpu().numpy()[None, None]
          + 0.03 * rng.randn(B, ns + 1, nx))
    U = t(prob.static_input.cpu().numpy()[None, None]
          + 0.1 * rng.randn(B, ns, nu))
    params = dict(rdot_ref=t(0.3 * rng.randn(B, ns + 1, 3)),
                  c_ref=t(0.05 * np.abs(rng.randn(B, ns + 1, nc))),
                  cdot_switch=t(rng.randint(0, 2, (B, ns + 1, nc))),
                  mask_track=t(rng.randint(0, 2, (B, ns + 1, 1))))
    x0 = X[:, 0] + t(0.005 * rng.randn(B, nx))
    X_nan = X.clone()
    X_nan[7, 5, 4] = float("nan")
    cast = lambda a, dtype: a.to(dtype).contiguous()
    solver_of = lambda dtype: s64 if dtype == f64 else s32

    def k10_args(Xs):
        def args(dtype):
            s = solver_of(dtype)
            return (cast(Xs, dtype), cast(U, dtype),
                    {k: cast(v, dtype) for k, v in params.items()}, s.terms,
                    s.rows, dt, s._wc(dtype))
        return args

    # ---- lip_check: every kernel against its twin ----
    _, k10_g32, k10_err = linearize_check(
        "lip_linearize_check", k10.lip_linearize_plain, k10.lip_linearize,
        k10_args(X_nan), B=B, nan_member=7)
    lin64 = k10.lip_linearize_plain(*k10_args(X)(f64))
    ref64, k1_g32, lin32, k1_err = riccati_check(
        "k1_lip_check", k1, lin64, mu, rows, sizes="lip", B=B)
    tassa_err = {sv: tassa_check("k1_lip_tassa_check", k1, lin64, mu, rows,
                                 sv, nan_member=7, sizes="lip", B=B)
                 for sv in ("schur", "cholesky")}
    ks64, Ks64, dV1_64, dV2_64 = ref64
    D64 = torch.sum(lin64["d"] ** 2, dim=(1, 2))
    merit0_64 = s64.total_cost(X, U, params) + opts.defect_weight * D64
    alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=f64, device=dev)
    x0_nan = x0.clone()
    x0_nan[7] = float("nan")

    def k11_args(x0s):
        def args(dtype, alphas):
            s = solver_of(dtype)
            c = lambda a: cast(a, dtype)
            return (c(x0s), c(X), c(U), c(ks64), c(Ks64), c(lin64["d"]),
                    c(alphas), {k: c(v) for k, v in params.items()},
                    c(merit0_64), c(D64), c(dV1_64), c(dV2_64), s.terms, dt,
                    s._wc(dtype), opts.defect_weight, opts.beta,
                    opts.alpha_converge_threshold)
        return args

    k11_err = trial_check("lip_trial_check", k11.lip_trial_plain,
                          k11.lip_trial, k11_args(x0_nan), alphas4, merit0_64,
                          D64, dV1_64, dV2_64, opts, nan_member=7)

    def ev_args(Xs):
        def args(dtype):
            s = solver_of(dtype)
            return (cast(Xs, dtype), cast(U, dtype),
                    {k: cast(v, dtype) for k, v in params.items()}, s.terms,
                    dt, s._wc(dtype))
        return args

    ev_err = evaluate_check("lip_evaluate_check", k11.lip_evaluate_plain,
                            k11.lip_evaluate, ev_args(X_nan), nan_member=7,
                            x0=x0_nan)
    # float64 at B=8 to LIP_F64_TOL of max(1, |twin|), entry by entry
    b8 = lambda a: a[:8].contiguous()
    e8, fine = {}, True
    la = tuple(repeat_members(k10_args(X_nan)(f64), 8))
    ref, got = k10.lip_linearize_plain(*la), k10.lip_linearize(*la)
    torch.cuda.synchronize()
    e8["lip_linearize"] = {k: err1(got[k], ref[k]) for k in ORDER}
    e8["lip_linearize_jacobians_bit_equal"] = all(
        torch.equal(got[k], ref[k]) for k in ("Sx", "Bs", "Jxp", "Jup", "Jt"))
    fine &= e8["lip_linearize_jacobians_bit_equal"]
    for nA in (1, 4):
        ta = repeat_members(k11_args(x0_nan)(f64, alphas4[:nA]), 8, skip=(6,))
        ref, got = k11.lip_trial_plain(*ta), k11.lip_trial(*ta)
        torch.cuda.synchronize()
        e8[f"lip_trial_{nA}alpha"] = {n: err1(g, r) for n, g, r
                                      in zip(TRIAL_OUT, got, ref)}
        e8[f"lip_trial_{nA}alpha_flags_equal"] = bool(torch.equal(got[4], ref[4]))
        fine &= e8[f"lip_trial_{nA}alpha_flags_equal"]
    for pin in (False, True):
        ea = repeat_members(ev_args(X_nan)(f64), 8)
        kw = dict(x0=b8(x0_nan)) if pin else {}
        ref, got = k11.lip_evaluate_plain(*ea, **kw), k11.lip_evaluate(*ea, **kw)
        torch.cuda.synchronize()
        name = "lip_evaluate_pinned" if pin else "lip_evaluate"
        e8[name] = {n: err1(g, r) for n, g, r
                    in zip(("cost", "defect_max"), got, ref)}
        if pin:
            e8["lip_evaluate_pinned_X_bit_equal"] = bool(
                torch.equal(bits(got[2]), bits(ref[2])))
            fine &= e8["lip_evaluate_pinned_X_bit_equal"]
    worst8 = max(v for d in e8.values() if isinstance(d, dict)
                 for v in d.values())
    emit("lip_check_f64_B8", card=card, tol=LIP_F64_TOL,
         tol_rule="|kernel - twin| <= tol * max(1, |twin|) entry by entry",
         worst=worst8, **e8)
    if not (fine and worst8 <= LIP_F64_TOL):
        fail("lip_check: a LIP kernel disagrees with its twin in float64 at B=8")

    # ---- lip_kernel_times: B = 1, 512, 4096, float32 ----
    n_rho = s32.terms.n_rho
    a10 = k10_args(X)(f32)
    a11 = k11_args(x0)(f32, alphas4[:1])
    aev = ev_args(X)(f32)
    x032 = cast(x0, f32)
    k1_args32 = tuple(lin32[k] for k in ORDER)
    sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
             len(rows.bx), len(rows.uc))
    nt = lin32["Jt"].shape[1]
    times = defaultdict(dict)
    for Bw in (1, B, B_LARGE):
        la = repeat_members(a10, Bw)
        out = k10.lip_linearize(*la)
        nb = nbytes(la[0], la[1], *la[2].values(), rows.packed(dev),
                    *out.values())
        times["lip_linearize"][Bw] = dict(
            ms=cuda_ms(lambda: k10.lip_linearize(*la), reps=20),
            plain_ms=cuda_ms(lambda: k10.lip_linearize_plain(*la), reps=3,
                             warmup=1),
            bytes=nb, flop=lip_linearize_flops(Bw, ns, nx, n_rho, len(rows.gx)))
        ta = repeat_members(a11, Bw, skip=(6,))
        out = k11.lip_trial(*ta)
        nb = nbytes(*[v for v in ta[:12] if isinstance(v, torch.Tensor)],
                    *ta[7].values(), *out)
        times["lip_trial"][Bw] = dict(
            ms=cuda_ms(lambda: k11.lip_trial(*ta), reps=20),
            plain_ms=cuda_ms(lambda: k11.lip_trial_plain(*ta), reps=3,
                             warmup=1),
            bytes=nb, flop=lip_trial_flops(Bw, ns, nx, nu, n_rho, 1))
        ta4 = repeat_members(k11_args(x0)(f32, alphas4), Bw, skip=(6,))
        times["lip_trial"][Bw]["ms_4alpha"] = cuda_ms(
            lambda: k11.lip_trial(*ta4), reps=20)
        # the same kernel with the evaluation compiled out
        times["lip_trial"][Bw]["chain_ms"] = cuda_ms(
            lambda: k11.lip_trial_chain(*ta), reps=20)
        times["lip_trial"][Bw]["chain_ms_4alpha"] = cuda_ms(
            lambda: k11.lip_trial_chain(*ta4), reps=20)
        ea = repeat_members(aev + (x032,), Bw)
        out = k11.lip_evaluate(*ea[:-1], x0=ea[-1])
        nb = nbytes(ea[0], ea[1], *ea[2].values(), ea[-1], *out)
        times["lip_evaluate"][Bw] = dict(
            ms=cuda_ms(lambda: k11.lip_evaluate(*ea[:-1], x0=ea[-1]), reps=20),
            plain_ms=cuda_ms(lambda: k11.lip_evaluate_plain(*ea[:-1], x0=ea[-1]),
                             reps=3, warmup=1),
            bytes=nb, flop=lip_evaluate_flops(Bw, ns, nx, n_rho))
        ka = repeat_members(k1_args32, Bw)
        for form, sv, name in (("collapsed", "schur", "riccati_backward_lip"),
                               ("tassa", "schur", "riccati_backward_lip_tassa"),
                               ("tassa", "cholesky",
                                "riccati_backward_lip_tassa_cholesky")):
            kw = dict(form=form, quu_solver=sv)
            out = k1.riccati_backward(*ka, mu, rows, **kw)
            flop = (riccati_flops(Bw, ns, nx, nu, nt, *sizes) if form == "collapsed"
                    else tassa_flops(Bw, ns, nx, nu, nt, *sizes, sv))
            times[name][Bw] = dict(
                ms=cuda_ms(lambda: k1.riccati_backward(*ka, mu, rows, **kw),
                           reps=10),
                plain_ms=cuda_ms(
                    lambda: k1.riccati_backward_plain(*ka, mu, rows, **kw),
                    reps=2, warmup=1),
                bytes=nbytes(*ka, rows.packed(dev), *out), flop=flop,
                fp64_tensor_cores=True)
    for name, by_B in times.items():
        for v in by_B.values():
            rate = (H100_FP64_TC_FLOP_PER_S if v.pop("fp64_tensor_cores", False)
                    else H100_F32_FLOP_PER_S)
            v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flop"], rate)
    occ = dict(
        lip_linearize=k10.occupancy(f32),
        lip_linearize_node=k10.occupancy(f32, vec=False),
        lip_linearize_f64=k10.occupancy(f64),
        lip_trial=k11.trial_occupancy(f32, ns, 1),
        lip_trial_4alpha=k11.trial_occupancy(f32, ns, 4),
        lip_trial_f64=k11.trial_occupancy(f64, ns, 1),
        lip_trial_f64_4alpha=k11.trial_occupancy(f64, ns, 4),
        lip_evaluate=k11.evaluate_occupancy(ns, f32),
        lip_evaluate_f64=k11.evaluate_occupancy(ns, f64),
        **{name: dict(blocks_per_sm=k1.blocks_per_sm(nx, nu, nt, rows, f32,
                                                     form, sv),
                      shared_memory_bytes=k1.shared_memory_bytes(
                          nx, nu, nt, rows, f32, form, sv))
           for form, sv, name in (("collapsed", "schur", "riccati_backward_lip"),
                                  ("tassa", "schur", "riccati_backward_lip_tassa"),
                                  ("tassa", "cholesky",
                                   "riccati_backward_lip_tassa_cholesky"))})
    la = a10
    host = dict(
        lip_linearize=host_us(lambda: k10.lip_linearize(*la)),
        lip_trial=host_us(lambda: k11.lip_trial(*a11)),
        lip_evaluate=host_us(lambda: k11.lip_evaluate(*aev, x0=x032)),
        riccati_backward_lip=host_us(
            lambda: k1.riccati_backward(*k1_args32, mu, rows)))
    emit("lip_kernel_times", card=card, dtype="float32", sms=sms,
         times={k: {str(b): v for b, v in d.items()} for k, d in times.items()},
         occupancy=occ, wrapper_host_us=host)
    lip_layout_gate(k11, occ, ns)
    del lin64, lin32, k10_g32, k1_g32, ref64

    # ---- lip_path: the dlip example on MPCLoop.tick ----
    LIP_TWINS = ((k1, ("riccati_backward_plain",)),
                 (k11, ("lip_trial_plain", "lip_evaluate_plain")),
                 (k10, ("lip_linearize_plain",)))
    inst = {key: k1.KERNEL_INSTANCES.index(key) for key in k1.KERNEL_INSTANCES}
    i_coll = inst["lip", "collapsed", "schur"]
    i_schur, i_chol = inst["lip", "tassa", "schur"], inst["lip", "tassa", "cholesky"]

    def reset_counts():
        k1.riccati_backward.launches = 0
        k1.riccati_backward.instance_launches[:] = [0] * len(k1.KERNEL_INSTANCES)
        k10.lip_linearize.launches = 0
        k11.lip_trial.launches = 0
        k11.lip_evaluate.launches = 0

    def read_counts():
        il = k1.riccati_backward.instance_launches
        return {"lip_linearize": k10.lip_linearize.launches,
                "riccati_backward": k1.riccati_backward.launches,
                "riccati_backward_lip": il[i_coll],
                "riccati_backward_lip_tassa": il[i_schur],
                "riccati_backward_lip_tassa_cholesky": il[i_chol],
                "lip_trial": k11.lip_trial.launches,
                "lip_evaluate": k11.lip_evaluate.launches}

    def lip_loop(dtype, device, **kw):
        """The dlip example's loop (`build_lip_loop`'s defaults), with
        option overrides."""
        o = DDPOptions(**dict(dict(max_iters=100, alpha_converge_threshold=1e-12,
                                   beta=1e-3), **kw))
        return build_lip_loop(SRBDConfig(dtype=dtype), o, device=device)

    def drive(loop, prob_, sched):
        """Ticks over `sched` from the cold carry at the nominal state: the
        carry, outputs, tick ms (a device sync each), host reads, trials."""
        trials = {"n": 0}
        trial = loop.solver._trial

        def counted_trial(*a):
            trials["n"] += 1
            return trial(*a)

        loop.solver._trial = counted_trial
        carry = loop.init(prob_.initial_state)
        syncs0 = loop.solver.host_syncs
        outs, tms = [], []
        for i in range(sched.action.shape[0]):
            inp = TickInput(*(a[i] for a in sched))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, out = loop.tick(carry, inp)
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        loop.solver._trial = trial
        return carry, outs, tms, loop.solver.host_syncs - syncs0, trials["n"]

    func_calls, restore_func = count_torch_func()
    plain_calls, restore_plain = count_plain_cost()
    twin_calls, restore_twins = count_calls(LIP_TWINS)
    reset_counts()
    ploop, pprob = lip_loop(f32, dev)
    sched = walking_schedule(40, vx=0.3, start=10, device=dev)
    pcarry, pouts, ptimes, psyncs, ptrials = drive(ploop, pprob, sched)
    cloop, cprob = lip_loop(f32, dev, quu_solver="cholesky")
    _, couts, ctimes, csyncs, ctrials = drive(
        cloop, cprob, walking_schedule(10, vx=0.3, start=3, device=dev))
    path_launches = read_counts()
    for restore in (restore_func, restore_plain, restore_twins):
        restore()
    allo = pouts + couts
    iters = [int(o.iterations) for o in allo]
    n_iter_p = sum(iters[:len(pouts)])
    hand = lambda L: (L["lip_linearize"] + L["riccati_backward"]
                      + L["lip_trial"] + L["lip_evaluate"])
    com_z = [float(o.x[2]) for o in allo]
    lp = dict(
        B=1, dtype="float32", ticks=len(pouts), cholesky_ticks=len(couts),
        options="dlip: max_iters=100, alpha_converge_threshold=1e-12, "
                "beta=1e-3, no warm-start shift", walk="vx 0.3 from tick 10",
        tick_p50_ms=statistics.median(ptimes), tick_max_ms=max(ptimes),
        tick_mean_ms=statistics.fmean(ptimes),
        cholesky_tick_p50_ms=statistics.median(ctimes),
        cholesky_tick_max_ms=max(ctimes),
        iterations_per_tick=iters[:len(pouts)],
        iterations_mean=statistics.fmean(iters[:len(pouts)]),
        syncs_per_tick=psyncs / len(pouts),
        syncs_per_iteration=psyncs / n_iter_p,
        cholesky_syncs_per_tick=csyncs / len(couts),
        launches=path_launches,
        hand_written_launches_per_tick=hand(path_launches) / len(allo),
        hand_written_launches_per_iteration=(
            path_launches["lip_linearize"] + path_launches["riccati_backward"]
            + path_launches["lip_trial"]) / sum(iters),
        trials=ptrials + ctrials,
        defect_norm_max=max(float(o.defect_norm) for o in allo),
        com_z_min=min(com_z), com_z_max=max(com_z),
        finite=all(bool(torch.isfinite(v).all()) for o in allo
                   for v in (o.x, o.u0, o.cost)),
        converged_ticks=sum(bool(o.converged) for o in allo),
        plain_twin_calls=twin_calls["n"], torch_func_calls=func_calls["n"],
        plain_cost_or_defect_calls=plain_calls["n"],
        final_com=pcarry.x[:3].tolist(), card=card)
    pstep = lambda c: ploop.tick(c, TickInput(*(a[-1] for a in sched)))[0]
    pcarry, lp["spans"] = tick_spans(ploop.solver, pstep, pcarry, ticks=5)
    lp["profile"] = profile_ticks(ploop.solver, pstep, pcarry,
                                  lp["tick_p50_ms"])
    emit("lip_path", **lp)
    if not lp["finite"]:
        fail("the LIP path produced non-finite values")
    if lp["defect_norm_max"] > 1e-4:
        fail("LIP plans are not dynamically consistent (defect above 1e-4)")
    if max(abs(z - LIP_HEIGHT) for z in com_z) >= 0.08:
        fail(f"the LIP walk's CoM height left 0.88 ± 0.08: {min(com_z)}, "
             f"{max(com_z)}")
    want = {k: v for k, v in path_launches.items() if k != "riccati_backward_lip"}
    if min(want.values()) == 0:
        fail(f"a kernel was not launched on the LIP path: {path_launches}")
    if not (path_launches["lip_linearize"] == path_launches["riccati_backward"]
            == sum(iters)):
        fail(f"K10 and K1 launches differ from the iterations: {path_launches}")
    if path_launches["lip_trial"] != lp["trials"]:
        fail(f"K11 launches do not cover the trials: {path_launches}")
    if path_launches["lip_evaluate"] != 2 * len(allo):
        fail(f"lip_evaluate launches are not two a solve: {path_launches}")
    if twin_calls["n"] or func_calls["n"] or plain_calls["n"]:
        fail(f"the LIP path ran plain twins on the card: {twin_calls['n']} "
             f"kernel twins, {plain_calls['n']} plain cost or defect calls, "
             f"{func_calls['n']} torch.func transforms")

    def single_ticks(device, n, **kw):
        loop, p = lip_loop(f64, device, **kw)
        sch = walking_schedule(n, vx=0.3, start=3, dtype=f64, device=device)
        carry = loop.init(p.initial_state)
        outs = []
        for i in range(n):
            carry, out = loop.tick(carry, TickInput(*(a[i] for a in sch)))
            outs.append(out)
        return carry, outs

    def versus(card_run, cpu_run, per_tick, floor):
        (cc, oc), (cp, op) = card_run, cpu_run
        it = lambda o: o.iterations.reshape(-1).tolist()
        # each output over all ticks at once: rel_err takes the largest
        # entry of the run as its scale (a standing tick's cost is ~0)
        both = lambda f: (torch.stack([getattr(a, f).cpu() for a in oc]),
                          torch.stack([getattr(b, f) for b in op]))
        res = dict(
            iterations_equal=all(it(a) == it(b) for a, b in zip(oc, op)),
            converged_equal=all(torch.equal(a.converged.cpu(), b.converged)
                                for a, b in zip(oc, op)),
            cost_rel_err=rel_err(*both("cost")),
            x_rel_err=rel_err(*both("x")),
            u0_rel_err=rel_err(*both("u0")),
            X_rel_err=rel_err(cc.sol.X.cpu(), cp.sol.X),
            U_rel_err=rel_err(cc.sol.U.cpu(), cp.sol.U),
            iterations_card=[it(a) for a in oc][:per_tick])
        plan = max(res["x_rel_err"], res["u0_rel_err"], res["X_rel_err"],
                   res["U_rel_err"])
        res["ok"] = (res["iterations_equal"] and res["converged_equal"]
                     and res["cost_rel_err"] <= 1e-9
                     and plan <= (LIP_FLOOR_TOL if floor else 1e-9))
        return res

    lvc = dict(B=1, ticks=10, walk="vx 0.3 from tick 3",
               exact_step=versus(single_ticks(dev, 10, max_iters=1),
                                 single_ticks("cpu", 10, max_iters=1), 10,
                                 floor=False),
               dlip_options=versus(single_ticks(dev, 10),
                                   single_ticks("cpu", 10), 10, floor=True),
               tol="exact_step (max_iters=1): all to 1e-9; dlip_options: "
                   "cost to 1e-9, x, u0, X, U to LIP_FLOOR_TOL",
               floor_tol=LIP_FLOOR_TOL)
    emit("lip_card_vs_cpu", **lvc)
    if not (lvc["exact_step"]["ok"] and lvc["dlip_options"]["ok"]):
        fail("the LIP card path and CPU path disagree")

    # ---- lip_fleet_path: MPCLoop.tick_batch, the SRBD fleet point's
    # settings on the LIP ----
    def fleet(Bsz, dtype, device, max_iters=5):
        loop, p = build_lip_loop(SRBDConfig(dtype=dtype),
                                 DDPOptions(max_iters=max_iters),
                                 shift_warmstart=True, device=device)
        g = np.random.RandomState(SEED)
        xn = p.initial_state.cpu().numpy()
        x0 = torch.as_tensor(xn[None] + 0.005 * g.randn(Bsz, nx), dtype=dtype,
                             device=device)
        return loop, loop.init(x0), walk_command(Bsz, vx=0.2, dtype=dtype,
                                                 device=device)

    def run_fleet(Bsz, warm, timed):
        loop, carry, inp = fleet(Bsz, f32, dev)
        counts = {"trials": 0, "solves": 0}
        trial, solve = loop.solver._trial, loop.solver.solve_batch

        def counted_trial(*a):
            counts["trials"] += 1
            return trial(*a)

        def counted_solve(*a):
            counts["solves"] += 1
            return solve(*a)

        loop.solver._trial, loop.solver.solve_batch = counted_trial, counted_solve
        for _ in range(warm):
            carry, _ = loop.tick_batch(carry, inp)
        torch.cuda.synchronize()
        counts.update(trials=0, solves=0)
        reset_counts()
        syncs0 = loop.solver.host_syncs
        tms, iters, outs = [], [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            carry, out = loop.tick_batch(carry, inp)
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
            iters.append(float(out.iterations.float().mean()))
            outs.append(out)
        launches = read_counts()
        loop.solver._trial, loop.solver.solve_batch = trial, solve
        res = dict(
            B=Bsz, dtype="float32", options="max_iters=5, shifted warm start, "
            "walk command vx 0.2", warmup_ticks=warm, ticks=timed,
            tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
            tick_mean_ms=statistics.fmean(tms),
            members_per_s=Bsz / statistics.median(tms) * 1e3,
            iters_mean=statistics.fmean(iters),
            syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
            trials=counts["trials"], solves=counts["solves"],
            launches=launches,
            hand_written_launches_per_tick=hand(launches) / timed,
            finite=all(bool(torch.isfinite(v).all()) for o in outs
                       for v in (o.x, o.u0, o.cost))
            and bool(torch.isfinite(carry.sol.X).all()),
            defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
            card=card)
        return res, loop, carry, inp

    func_calls, restore_func = count_torch_func()
    plain_calls, restore_plain = count_plain_cost()
    twin_calls, restore_twins = count_calls(LIP_TWINS)
    fp, floop, fcarry, finp = run_fleet(B, warm=3, timed=20)
    for restore in (restore_func, restore_plain, restore_twins):
        restore()
    fp.update(plain_twin_calls=twin_calls["n"], torch_func_calls=func_calls["n"],
              plain_cost_or_defect_calls=plain_calls["n"])
    fstep = lambda c: floop.tick_batch(c, finp)[0]
    fcarry, fp["spans"] = tick_spans(floop.solver, fstep, fcarry, ticks=5)
    fp["profile"] = profile_ticks(floop.solver, fstep, fcarry, fp["tick_p50_ms"])
    emit("lip_fleet_path", **fp)
    fl = fp["launches"]
    if not fp["finite"]:
        fail("the LIP fleet path produced non-finite values")
    if fp["defect_norm_max"] > 1e-4:
        fail("LIP fleet plans are not dynamically consistent (defect above 1e-4)")
    if min(fl[k] for k in ("lip_linearize", "riccati_backward_lip",
                           "lip_trial", "lip_evaluate")) == 0:
        fail(f"a kernel was not launched on the LIP fleet path: {fl}")
    if fl["lip_linearize"] != fl["riccati_backward_lip"]:
        fail(f"K10 launches differ from K1 launches: {fl}")
    if fl["lip_trial"] != fp["trials"]:
        fail(f"K11 launches do not cover the trials: {fl}")
    if fl["lip_evaluate"] != 2 * fp["solves"]:
        fail(f"lip_evaluate launches are not two a solve: {fl}")
    if twin_calls["n"] or func_calls["n"] or plain_calls["n"]:
        fail(f"the LIP fleet path ran plain twins on the card: "
             f"{twin_calls['n']} kernel twins, {plain_calls['n']} plain cost "
             f"or defect calls, {func_calls['n']} torch.func transforms")
    large, *_ = run_fleet(B_LARGE, warm=1, timed=2)
    emit("lip_fleet_path_large", **large)
    if not large["finite"]:
        fail("B=4096 LIP ticks produced non-finite values")

    def fleet_ticks(device, max_iters):
        loop, carry, inp = fleet(8, f64, device, max_iters)
        outs = []
        for _ in range(3):
            carry, out = loop.tick_batch(carry, inp)
            outs.append(out)
        return carry, outs

    fvc = dict(B=8, ticks=3,
               exact_step=versus(fleet_ticks(dev, 1), fleet_ticks("cpu", 1), 3,
                                 floor=False),
               fleet_options=versus(fleet_ticks(dev, 5), fleet_ticks("cpu", 5),
                                    3, floor=True),
               tol="exact_step (max_iters=1): all to 1e-9; fleet_options "
                   "(max_iters=5): cost to 1e-9, x, u0, X, U to LIP_FLOOR_TOL",
               floor_tol=LIP_FLOOR_TOL)
    emit("lip_fleet_card_vs_cpu", **fvc)
    if not (fvc["exact_step"]["ok"] and fvc["fleet_options"]["ok"]):
        fail("the LIP fleet card path and CPU path disagree")

    # ---- the kernel rows ----
    both = lambda k: path_launches[k] + fl[k]
    row = lambda name, mod, launches, t, err, tol32, **extra: kernel_row(
        name, mod, launches, t["ms"], t["plain_ms"], t["bound_ms"],
        t["bound_by"], err, tol32, **extra)
    by_B = lambda name: {str(b): v["ms"] for b, v in times[name].items()}
    lin_tol = f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}"
    trial_tol = "2*plain_rel_err_f32 + 1e-6"
    b8 = dict(tol_f64_B8=LIP_F64_TOL)
    rows_out = [
        row("lip_linearize", k10, both("lip_linearize"), times["lip_linearize"][B],
            k10_err, lin_tol, B=B, ms_by_B=by_B("lip_linearize"),
            launches_lip_path=path_launches["lip_linearize"],
            launches_lip_fleet_path=fl["lip_linearize"],
            max_err_f64_B8=max(e8["lip_linearize"].values()),
            blocks_per_sm=occ["lip_linearize"]["blocks_per_sm"],
            shared_memory_bytes=occ["lip_linearize"]["shared_memory_bytes"], **b8),
        row("riccati_backward_lip", k1, fl["riccati_backward_lip"],
            times["riccati_backward_lip"][B], k1_err, K1_F32_TOL, B=B,
            ms_by_B=by_B("riccati_backward_lip"),
            launches_of="lip_fleet_path (the collapsed sweep of solve_batch)",
            **occ["riccati_backward_lip"]),
        row("lip_trial", k11, both("lip_trial"), times["lip_trial"][B], k11_err,
            trial_tol, B=B, ms_by_B=by_B("lip_trial"),
            ms_4alpha=times["lip_trial"][B]["ms_4alpha"],
            ms_4alpha_by_B={str(b): v["ms_4alpha"]
                            for b, v in times["lip_trial"].items()},
            chain_ms_by_B={str(b): v["chain_ms"]
                           for b, v in times["lip_trial"].items()},
            chain_ms_4alpha_by_B={str(b): v["chain_ms_4alpha"]
                                  for b, v in times["lip_trial"].items()},
            launches_lip_path=path_launches["lip_trial"],
            launches_lip_fleet_path=fl["lip_trial"],
            max_err_f64_B8=max(max(e8["lip_trial_1alpha"].values()),
                               max(e8["lip_trial_4alpha"].values())),
            blocks_per_sm=occ["lip_trial"]["blocks_per_sm"],
            blocks_per_sm_4alpha=occ["lip_trial_4alpha"]["blocks_per_sm"],
            registers=occ["lip_trial"]["registers_per_thread"],
            local_bytes=occ["lip_trial"]["local_bytes_per_thread"],
            wrapper_host_us=host["lip_trial"], **b8),
        dict(row("lip_evaluate", k11, both("lip_evaluate"),
                 times["lip_evaluate"][B], ev_err, trial_tol, B=B,
                 pinned=True, ms_by_B=by_B("lip_evaluate"),
                 launches_lip_path=path_launches["lip_evaluate"],
                 launches_lip_fleet_path=fl["lip_evaluate"],
                 max_err_f64_B8=max(max(e8["lip_evaluate"].values()),
                                    max(e8["lip_evaluate_pinned"].values())),
                 blocks_per_sm=occ["lip_evaluate"]["blocks_per_sm"], **b8),
             replaces=k11.EVALUATE_REPLACES),
    ]
    for sv, name in (("schur", "riccati_backward_lip_tassa"),
                     ("cholesky", "riccati_backward_lip_tassa_cholesky")):
        rows_out.append(dict(
            row(name, k1, path_launches[name], times[name][1], tassa_err[sv],
                K1_F32_TOL, B=1, quu_solver=sv, ms_by_B=by_B(name),
                launches_of="lip_path (MSDDP.solve's Tassa sweep)",
                **occ[name]),
            replaces=k1.TASSA_REPLACES))
    return rows_out


# ---------------- the quadruped trot (phase 11) ----------------

QUAD_TOPOLOGY = dict(contact_model=1, number_of_legs=4)
QUAD_HEIGHT_BAND = 0.05        # the trot's CoM band, tests/test_quadruped.py:133


def quadruped_section(card, dev, sms):
    """Phase 11: the SRBD kernels at the point-feet quadruped's shape
    (`srbd::QuadShape`, K1's `QuadShape`) against their twins
    (`quad_check`), their times (`quad_kernel_times`), the quadruped
    example's trot on `MPCLoop.tick` (`quad_path`), card = CPU in float64
    (`quad_card_vs_cpu`) and the quadruped fleet tick (`quad_fleet_path`).
    Returns the kernel rows of the `kernels` line."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3
    from srbd_horizon_tpu_torch.runtime.loop import (
        TickInput,
        build_quadruped_loop,
        walk_command,
        walking_schedule,
    )

    t_section = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    cfg = lambda dtype: SRBDConfig(dtype=dtype, **QUAD_TOPOLOGY)
    loop64, prob = build_quadruped_loop(cfg(f64), device=dev)
    loop32, _ = build_quadruped_loop(cfg(f32), device=dev)
    s64, s32 = loop64.solver, loop32.solver
    ocp = prob.ocp
    ns, nx, nu, nc, dt = ocp.ns, ocp.nx, ocp.nu, prob.nc, ocp.dt
    opts, rows, mu = s64.opts, s64.rows, s64.opts.mu0
    n_rho = s64.terms.n_rho
    B = B_MAIN
    # a linearization point of the trot: plans around the nominal state
    # (0.02 / 0.05·N(0,1)), the contact plan of 7 ticks of the trot WPG
    rng = np.random.RandomState(SEED + 11)
    params1, wst = dict(ocp.params), loop64.wpg.init_state()
    for _ in range(7):
        params1, wst = loop64.wpg.advance(
            params1, wst, torch.tensor(1, dtype=torch.int32, device=dev))
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in params1.items()}
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = t(prob.initial_state.cpu().numpy()[None, None]
          + 0.02 * rng.randn(B, ns + 1, nx))
    U = t(prob.static_input.cpu().numpy()[None, None]
          + 0.05 * rng.randn(B, ns, nu))
    x0 = X[:, 0] + t(0.005 * rng.randn(B, nx))
    X_nan = X.clone()
    X_nan[7, 5, 4] = float("nan")
    x0_nan = x0.clone()
    x0_nan[7] = float("nan")
    cast = lambda a, dtype: a.to(dtype).contiguous()
    solver_of = lambda dtype: s64 if dtype == f64 else s32
    cparams = lambda dtype: {k: cast(v, dtype) for k, v in params.items()}

    def k4_args(dtype):
        s = solver_of(dtype)
        return (cast(X, dtype), cast(U, dtype), cparams(dtype), s.terms,
                s.rows, dt, s._wc(dtype))

    # ---- quad_check: K4, K1 (collapsed and Tassa), K3, srbd_evaluate ----
    lin64, lin_g32, k4_err = linearize_check(
        "quad_k4_check", k4.srbd_linearize_plain, k4.srbd_linearize, k4_args,
        sizes="quadruped", B=B)
    ref64, k1_g32, lin32, k1_err = riccati_check(
        "quad_k1_check", k1, lin64, mu, rows, sizes="quadruped", B=B)
    tassa_err = tassa_check("quad_k1_tassa_check", k1, lin64, mu, rows,
                            "schur", nan_member=7, sizes="quadruped", B=B)
    ks64, Ks64, dV1_64, dV2_64 = ref64
    D64 = torch.sum(lin64["d"] ** 2, dim=(1, 2))
    merit0_64 = s64.total_cost(X, U, params) + opts.defect_weight * D64
    alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=f64, device=dev)

    def k3_args(x0s):
        def args(dtype, alphas):
            s = solver_of(dtype)
            c = lambda a: cast(a, dtype)
            return (c(x0s), c(X), c(U), c(ks64), c(Ks64), c(lin64["d"]),
                    c(alphas), cparams(dtype), c(merit0_64), c(D64),
                    c(dV1_64), c(dV2_64), s.terms, dt, s._wc(dtype),
                    opts.defect_weight, opts.beta,
                    opts.alpha_converge_threshold)
        return args

    k3_err = trial_check("quad_k3_check", k3.srbd_trial_plain, k3.srbd_trial,
                         k3_args(x0_nan), alphas4, merit0_64, D64, dV1_64,
                         dV2_64, opts, nan_member=7, sizes="quadruped")

    def ev_args(Xs):
        def args(dtype):
            s = solver_of(dtype)
            return (cast(Xs, dtype), cast(U, dtype), cparams(dtype), s.terms,
                    dt, s._wc(dtype))
        return args

    ev_err = evaluate_check("quad_srbd_evaluate_check", k3.srbd_evaluate_plain,
                            k3.srbd_evaluate, ev_args(X_nan), nan_member=7,
                            x0=x0_nan, sizes="quadruped")

    # ---- quad_kernel_times: B = 1, 512, 4096, float32 ----
    a4 = k4_args(f32)
    a3 = k3_args(x0)(f32, alphas4[:1])
    aev = ev_args(X)(f32)
    x032 = cast(x0, f32)
    k1_args32 = tuple(lin32[k] for k in ORDER)
    sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
             len(rows.bx), len(rows.uc))
    nt = lin32["Jt"].shape[1]
    K1_FORMS = (("collapsed", "riccati_backward_quadruped"),
                ("tassa", "riccati_backward_quadruped_tassa"))
    times = defaultdict(dict)
    for Bw in (1, B, B_LARGE):
        plain_too = Bw <= B        # the twins at the path's sizes only
        pl = lambda fn, reps: (cuda_ms(fn, reps=reps, warmup=1) if plain_too
                               else None)
        la = repeat_members(a4, Bw)
        out = k4.srbd_linearize(*la)
        times["srbd_linearize_quadruped"][Bw] = dict(
            ms=cuda_ms(lambda: k4.srbd_linearize(*la), reps=20),
            plain_ms=pl(lambda: k4.srbd_linearize_plain(*la), 3),
            bytes=nbytes(la[0], la[1], *k4.kernel_params(
                la[2], Bw, ns, nc, f32, dev), rows.packed(dev), *out.values()),
            flop=linearize_flops(Bw, ns, nx, nu, nc, n_rho, len(rows.rx),
                                 len(rows.ru)))
        ta = repeat_members(a3, Bw, skip=(6,))
        out = k3.srbd_trial(*ta)
        times["srbd_trial_quadruped"][Bw] = dict(
            ms=cuda_ms(lambda: k3.srbd_trial(*ta), reps=20),
            plain_ms=pl(lambda: k3.srbd_trial_plain(*ta), 3),
            bytes=nbytes(*[v for v in ta[:12] if isinstance(v, torch.Tensor)],
                         *ta[7].values(), *out),
            flop=trial_flops(Bw, ns, nx, nu, nc, n_rho, 1))
        ta4 = repeat_members(k3_args(x0)(f32, alphas4), Bw, skip=(6,))
        times["srbd_trial_quadruped"][Bw]["ms_4alpha"] = cuda_ms(
            lambda: k3.srbd_trial(*ta4), reps=20)
        ea = repeat_members(aev + (x032,), Bw)
        out = k3.srbd_evaluate(*ea[:-1], x0=ea[-1])
        times["srbd_evaluate_quadruped"][Bw] = dict(
            ms=cuda_ms(lambda: k3.srbd_evaluate(*ea[:-1], x0=ea[-1]), reps=20),
            plain_ms=pl(lambda: k3.srbd_evaluate_plain(*ea[:-1], x0=ea[-1]), 3),
            bytes=nbytes(ea[0], ea[1], *ea[2].values(), ea[-1], *out),
            flop=evaluate_flops(Bw, ns, nx, nc, n_rho))
        ka = repeat_members(k1_args32, Bw)
        for form, name in K1_FORMS:
            kw = dict(form=form)
            out = k1.riccati_backward(*ka, mu, rows, **kw)
            flop = (riccati_flops(Bw, ns, nx, nu, nt, *sizes) if form == "collapsed"
                    else tassa_flops(Bw, ns, nx, nu, nt, *sizes, "schur"))
            times[name][Bw] = dict(
                ms=cuda_ms(lambda: k1.riccati_backward(*ka, mu, rows, **kw),
                           reps=10),
                plain_ms=pl(lambda: k1.riccati_backward_plain(*ka, mu, rows,
                                                              **kw), 2),
                bytes=nbytes(*ka, rows.packed(dev), *out), flop=flop,
                fp64_tensor_cores=True)
    for by_B in times.values():
        for v in by_B.values():
            rate = (H100_FP64_TC_FLOP_PER_S if v.pop("fp64_tensor_cores", False)
                    else H100_F32_FLOP_PER_S)
            v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flop"], rate)
    pick = lambda occ: {k: occ[k] for k in ("blocks_per_sm",
                                            "shared_memory_bytes",
                                            "registers_per_thread",
                                            "local_bytes_per_thread")}
    occ = dict(
        srbd_linearize_quadruped=pick(k4.occupancy(f32, "quadruped")),
        srbd_trial_quadruped=pick(k3.trial_occupancy(f32, "quadruped")),
        srbd_evaluate_quadruped=pick(k3.evaluate_occupancy(ns, f32, "quadruped")),
        **{name: dict(blocks_per_sm=k1.blocks_per_sm(nx, nu, nt, rows, f32, form),
                      shared_memory_bytes=k1.shared_memory_bytes(
                          nx, nu, nt, rows, f32, form))
           for form, name in K1_FORMS})
    emit("quad_kernel_times", card=card, dtype="float32", sms=sms,
         times={k: {str(b): v for b, v in d.items()} for k, d in times.items()},
         occupancy=occ)
    del lin64, lin32, lin_g32, k1_g32, ref64

    # ---- quad_path: the quadruped example's trot on MPCLoop.tick ----
    QUAD_TWINS = ((k1, ("riccati_backward_plain",)),
                  (k3, ("srbd_trial_plain", "srbd_evaluate_plain")),
                  (k4, ("srbd_linearize_plain",)))
    i_coll = k1.KERNEL_INSTANCES.index(("quadruped", "collapsed", "schur"))
    i_tassa = k1.KERNEL_INSTANCES.index(("quadruped", "tassa", "schur"))

    def reset_counts():
        k1.riccati_backward.launches = 0
        k1.riccati_backward.instance_launches[:] = [0] * len(k1.KERNEL_INSTANCES)
        k4.srbd_linearize.launches = 0
        k3.srbd_trial.launches = 0
        k3.srbd_evaluate.launches = 0

    def read_counts():
        il = k1.riccati_backward.instance_launches
        return {"srbd_linearize": k4.srbd_linearize.launches,
                "riccati_backward": k1.riccati_backward.launches,
                "riccati_backward_quadruped": il[i_coll],
                "riccati_backward_quadruped_tassa": il[i_tassa],
                "srbd_trial": k3.srbd_trial.launches,
                "srbd_evaluate": k3.srbd_evaluate.launches}

    hand = lambda L: (L["srbd_linearize"] + L["riccati_backward"]
                      + L["srbd_trial"] + L["srbd_evaluate"])
    ploop, pprob = build_quadruped_loop(cfg(f32), device=dev)
    sched = walking_schedule(40, vx=0.25, start=10, device=dev)
    z0 = float(pprob.initial_state[2])
    guards, restore_guards = guard_plain(QUAD_TWINS)
    n, restore_count = count_solver_calls(ploop.solver)
    carry = ploop.init(pprob.initial_state)
    syncs0 = ploop.solver.host_syncs
    outs, tms = [], []
    reset_counts()
    for i in range(sched.action.shape[0]):
        inp = TickInput(*(a[i] for a in sched))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, out = ploop.tick(carry, inp)
        torch.cuda.synchronize()
        tms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    path_launches = read_counts()
    restore_count()
    restore_guards()
    syncs = ploop.solver.host_syncs - syncs0
    iters = [int(o.iterations) for o in outs]
    com = torch.stack([o.x[:3] for o in outs]).cpu()
    qp = dict(
        B=1, dtype="float32", ticks=len(outs),
        options="the quadruped example: max_iters=5, alpha_converge_threshold="
                "1e-12, beta=1e-3, trot WPG at the feet's height, no shift",
        walk="vx 0.25 from tick 10",
        tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
        tick_mean_ms=statistics.fmean(tms),
        iterations_per_tick=iters, iterations_mean=statistics.fmean(iters),
        syncs_per_tick=syncs / len(outs), syncs_per_iteration=syncs / sum(iters),
        launches=path_launches, trials=n["trials"], solves=n["solves"],
        hand_written_launches_per_tick=hand(path_launches) / len(outs),
        hand_written_launches_per_iteration=(
            path_launches["srbd_linearize"] + path_launches["riccati_backward"]
            + path_launches["srbd_trial"]) / sum(iters),
        defect_norm_max=max(float(o.defect_norm) for o in outs),
        srbd_residual_max=max(float(o.srbd_residual.abs().max()) for o in outs),
        com_z_min=float(com[:, 2].min()), com_z_max=float(com[:, 2].max()),
        z0=z0, forward_progress_m=float(com[-1, 0] - com[0, 0]),
        finite=all(bool(torch.isfinite(v).all()) for o in outs
                   for v in (o.x, o.u0, o.cost, o.srbd_residual)),
        converged_ticks=sum(bool(o.converged) for o in outs),
        **{k: v["n"] for k, v in guards.items()},
        final_com=carry.x[:3].tolist(), card=card)
    pstep = lambda c: ploop.tick(c, TickInput(*(a[-1] for a in sched)))[0]
    carry, qp["spans"] = tick_spans(ploop.solver, pstep, carry, ticks=5)
    qp["profile"] = profile_ticks(ploop.solver, pstep, carry, qp["tick_p50_ms"])
    emit("quad_path", **qp)
    if not qp["finite"]:
        fail("the quadruped trot produced non-finite values")
    if max(qp["defect_norm_max"], qp["srbd_residual_max"]) > 1e-4:
        fail("quadruped plans are not dynamically consistent (defect or "
             "Newton-Euler residual above 1e-4)")
    if max(abs(qp["com_z_min"] - z0), abs(qp["com_z_max"] - z0)) >= QUAD_HEIGHT_BAND:
        fail(f"the trot's CoM height left z0 ± {QUAD_HEIGHT_BAND}: "
             f"{qp['com_z_min']}, {qp['com_z_max']} (z0 {z0})")
    if not qp["forward_progress_m"] > 0:
        fail(f"the trot made no forward progress: {qp['forward_progress_m']}")
    if min(path_launches[k] for k in ("srbd_linearize", "srbd_trial",
                                      "srbd_evaluate",
                                      "riccati_backward_quadruped_tassa")) == 0:
        fail(f"a kernel was not launched on the quadruped path: {path_launches}")
    if not (path_launches["srbd_linearize"] == path_launches["riccati_backward"]
            == path_launches["riccati_backward_quadruped_tassa"] == sum(iters)):
        fail(f"K4 and K1 launches differ from the iterations: {path_launches}")
    if path_launches["srbd_trial"] != qp["trials"]:
        fail(f"K3 launches do not cover the trials: {path_launches}")
    if path_launches["srbd_evaluate"] != 2 * qp["solves"]:
        fail(f"srbd_evaluate launches are not two a solve: {path_launches}")
    if qp["plain_twin_calls"] or qp["torch_func_calls"] or qp["plain_cost_or_defect_calls"]:
        fail(f"the quadruped path ran plain twins on the card: {qp}")

    # ---- quad_card_vs_cpu: card = CPU in float64, B=1 and B=8 ----
    def single_ticks(device, n_ticks):
        loop, p = build_quadruped_loop(cfg(f64), device=device)
        sch = walking_schedule(n_ticks, vx=0.25, start=3, dtype=f64,
                               device=device)
        c = loop.init(p.initial_state)
        res = []
        for i in range(n_ticks):
            c, o = loop.tick(c, TickInput(*(a[i] for a in sch)))
            res.append(o)
        return c, res

    def fleet(Bsz, dtype, device, max_iters=5):
        """The SRBD fleet point's settings on the quadruped: max_iters=5,
        shifted warm start, the walk command, pushes of 0.005·N(0,1)."""
        loop, p = build_quadruped_loop(cfg(dtype), DDPOptions(max_iters=max_iters),
                                       shift_warmstart=True, device=device)
        g = np.random.RandomState(SEED)
        xn = p.initial_state.cpu().numpy()
        xs = torch.as_tensor(xn[None] + 0.005 * g.randn(Bsz, nx), dtype=dtype,
                             device=device)
        return loop, loop.init(xs), walk_command(Bsz, vx=0.2, dtype=dtype,
                                                 device=device)

    def fleet_ticks(device, n_ticks):
        loop, c, inp = fleet(8, f64, device)
        res = []
        for _ in range(n_ticks):
            c, o = loop.tick_batch(c, inp)
            res.append(o)
        return c, res

    def versus(card_run, cpu_run):
        (cc, oc), (cp, op) = card_run, cpu_run
        it = lambda o: o.iterations.reshape(-1).tolist()
        both = lambda f: (torch.stack([getattr(a, f).cpu() for a in oc]),
                          torch.stack([getattr(b, f) for b in op]))
        r = dict(
            iterations_equal=all(it(a) == it(b) for a, b in zip(oc, op)),
            converged_equal=all(torch.equal(a.converged.cpu(), b.converged)
                                for a, b in zip(oc, op)),
            iterations_card=[it(a) for a in oc],
            cost_rel_err=rel_err(*both("cost")), x_rel_err=rel_err(*both("x")),
            u0_rel_err=rel_err(*both("u0")),
            X_rel_err=rel_err(cc.sol.X.cpu(), cp.sol.X),
            U_rel_err=rel_err(cc.sol.U.cpu(), cp.sol.U))
        r["ok"] = (r["iterations_equal"] and r["converged_equal"]
                   and max(r[k] for k in ("cost_rel_err", "x_rel_err",
                                          "u0_rel_err", "X_rel_err",
                                          "U_rel_err")) <= 1e-9)
        return r

    qvc = dict(tol=1e-9, single_B1=dict(ticks=10, walk="vx 0.25 from tick 3",
                                        **versus(single_ticks(dev, 10),
                                                 single_ticks("cpu", 10))),
               fleet_B8=dict(ticks=3, **versus(fleet_ticks(dev, 3),
                                               fleet_ticks("cpu", 3))))
    emit("quad_card_vs_cpu", **qvc)
    if not (qvc["single_B1"]["ok"] and qvc["fleet_B8"]["ok"]):
        fail("the quadruped card path and CPU path disagree")

    # ---- quad_fleet_path: MPCLoop.tick_batch at B=512, float32 ----
    def run_fleet(Bsz, warm, timed):
        loop, c, inp = fleet(Bsz, f32, dev)
        cnt, restore = count_solver_calls(loop.solver)
        for _ in range(warm):
            c, _ = loop.tick_batch(c, inp)
        torch.cuda.synchronize()
        cnt.update(trials=0, solves=0)
        reset_counts()
        syncs0 = loop.solver.host_syncs
        tms_, iters_, outs_ = [], [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            c, o = loop.tick_batch(c, inp)
            torch.cuda.synchronize()
            tms_.append((time.perf_counter() - t0) * 1e3)
            iters_.append(float(o.iterations.float().mean()))
            outs_.append(o)
        launches = read_counts()
        restore()
        res = dict(
            B=Bsz, dtype="float32", options="max_iters=5, shifted warm start, "
            "walk command vx 0.2, trot WPG", warmup_ticks=warm, ticks=timed,
            tick_p50_ms=statistics.median(tms_), tick_max_ms=max(tms_),
            tick_mean_ms=statistics.fmean(tms_),
            members_per_s=Bsz / statistics.median(tms_) * 1e3,
            iters_mean=statistics.fmean(iters_),
            syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
            trials=cnt["trials"], solves=cnt["solves"], launches=launches,
            hand_written_launches_per_tick=hand(launches) / timed,
            finite=all(bool(torch.isfinite(v).all()) for o in outs_
                       for v in (o.x, o.u0, o.cost))
            and bool(torch.isfinite(c.sol.X).all()),
            defect_norm_max=max(float(o.defect_norm.max()) for o in outs_),
            srbd_residual_max=max(float(o.srbd_residual.abs().max())
                                  for o in outs_),
            card=card)
        return res, loop, c, inp

    guards, restore_guards = guard_plain(QUAD_TWINS)
    fp, floop, fcarry, finp = run_fleet(B, warm=3, timed=20)
    restore_guards()
    fp.update({k: v["n"] for k, v in guards.items()})
    fstep = lambda c: floop.tick_batch(c, finp)[0]
    fcarry, fp["spans"] = tick_spans(floop.solver, fstep, fcarry, ticks=5)
    fp["profile"] = profile_ticks(floop.solver, fstep, fcarry, fp["tick_p50_ms"])
    emit("quad_fleet_path", **fp)
    fl = fp["launches"]
    if not fp["finite"]:
        fail("the quadruped fleet path produced non-finite values")
    if max(fp["defect_norm_max"], fp["srbd_residual_max"]) > 1e-4:
        fail("quadruped fleet plans are not dynamically consistent")
    if min(fl[k] for k in ("srbd_linearize", "riccati_backward_quadruped",
                           "srbd_trial", "srbd_evaluate")) == 0:
        fail(f"a kernel was not launched on the quadruped fleet path: {fl}")
    if not (fl["srbd_linearize"] == fl["riccati_backward_quadruped"]
            == fl["riccati_backward"]):
        fail(f"K4 launches differ from K1 launches: {fl}")
    if fl["srbd_trial"] != fp["trials"]:
        fail(f"K3 launches do not cover the trials: {fl}")
    if fl["srbd_evaluate"] != 2 * fp["solves"]:
        fail(f"srbd_evaluate launches are not two a solve: {fl}")
    if fp["plain_twin_calls"] or fp["torch_func_calls"] or fp["plain_cost_or_defect_calls"]:
        fail(f"the quadruped fleet path ran plain twins on the card: {fp}")
    large, *_ = run_fleet(B_LARGE, warm=1, timed=2)
    emit("quad_fleet_path_large", **large)
    if not large["finite"]:
        fail("B=4096 quadruped ticks produced non-finite values")

    # ---- the kernel rows ----
    both = lambda k: path_launches[k] + fl[k]
    by_B = lambda name: {str(b): v["ms"] for b, v in times[name].items()}
    lin_tol = f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}"
    trial_tol = "2*plain_rel_err_f32 + 1e-6"

    def row(name, mod, launches, err, tol32, Bt=B, **extra):
        tt = times[name][Bt]
        return kernel_row(name, mod, launches, tt["ms"], tt["plain_ms"],
                          tt["bound_ms"], tt["bound_by"], err, tol32, B=Bt,
                          shape="quadruped", ms_by_B=by_B(name),
                          **occ[name], **extra)

    rows_out = [
        row("srbd_linearize_quadruped", k4, both("srbd_linearize"), k4_err,
            lin_tol, launches_quad_path=path_launches["srbd_linearize"],
            launches_quad_fleet_path=fl["srbd_linearize"]),
        row("srbd_trial_quadruped", k3, both("srbd_trial"), k3_err, trial_tol,
            ms_4alpha=times["srbd_trial_quadruped"][B]["ms_4alpha"],
            launches_quad_path=path_launches["srbd_trial"],
            launches_quad_fleet_path=fl["srbd_trial"]),
        dict(row("srbd_evaluate_quadruped", k3, both("srbd_evaluate"), ev_err,
                 trial_tol, pinned=True,
                 launches_quad_path=path_launches["srbd_evaluate"],
                 launches_quad_fleet_path=fl["srbd_evaluate"]),
             replaces=k3.EVALUATE_REPLACES),
        row("riccati_backward_quadruped", k1, fl["riccati_backward_quadruped"],
            k1_err, K1_F32_TOL,
            launches_of="quad_fleet_path (the collapsed sweep of solve_batch)"),
        dict(row("riccati_backward_quadruped_tassa", k1,
                 path_launches["riccati_backward_quadruped_tassa"], tassa_err,
                 K1_F32_TOL, Bt=1, quu_solver="schur",
                 launches_of="quad_path (MSDDP.solve's Tassa sweep)"),
             replaces=k1.TASSA_REPLACES),
    ]
    emit("quadruped_section", seconds=time.perf_counter() - t_section,
         card=card)
    return rows_out


# ---------------- the constrained quadruped trot (phase 12) ----------------

QC_VX = 0.15                   # the trot's command, tests/test_quadruped.py:238
QC_TICKS = 40                  # single-robot ticks; ticks 20-39 are gated
QC_CONE_N = 2.0                # cone rows and F_z floor, tests/test_quadruped.py:261-263


def quadruped_constrained_section(card, dev, sms):
    """Phase 12: the isrbd kernels (K5, K6, isrbd_evaluate, K7, K8a-c) at
    the constrained quadruped's AL shape (`isrbd::QuadAlShape`) and K1 at
    its `isrbd_al_quadruped` shape (collapsed; Tassa with Cholesky gains)
    against their twins (`qc_check`), their times (`qc_kernel_times`), the
    constrained example's single robot on `ALDDP.solve` / `solve_online`
    (`qc_path`), card = CPU in float64 (`qc_card_vs_cpu`) and the fleet's
    constrained tick (`qc_fleet_path`). Returns the kernel rows of the
    `kernels` line."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import SRBDConfig
    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78
    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
    from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.models.quadruped import (
        quadruped_point_feet,
        trot_group_mask,
    )
    from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
    from srbd_horizon_tpu_torch.problems.srbd import linearized_friction_cone_rows
    from srbd_horizon_tpu_torch.runtime.serving import constrained_tick
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
    from srbd_horizon_tpu_torch.solvers.options import al_serving_options
    from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator

    t_section = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    robot = quadruped_point_feet()
    cfg = lambda dtype: SRBDConfig(dtype=dtype, lip_height=float(robot.com[2]),
                                   **QUAD_TOPOLOGY)

    def solvers(dtype, device, max_iters):
        prob = build_isrbd_problem(cfg(dtype), robot, device=device)
        return prob, ALDDP(prob.ocp, *al_serving_options(max_iters))

    prob64, al64 = solvers(f64, dev, 1)
    _, al32 = solvers(f32, dev, 1)
    AL = lambda dtype: al64 if dtype == f64 else al32
    ocp = prob64.ocp
    ns, nx, nu, nc, dt = ocp.ns, ocp.nx, ocp.nu, prob64.nc, ocp.dt
    rows = al64.inner.rows
    shape = k5.check_kernel_shape("isrbd_linearize", al64.terms, nx, nu, rows)
    if shape != "quadruped":
        fail(f"the constrained quadruped has the isrbd shape {shape}")
    n_eq, n_eq_T, n_in = al64._sizes
    n_rho, n_term = al64.terms.n_rho, al64.terms.n_term
    Bc = B_CONSTRAINED
    mu = 1e-6
    cast = lambda a, dtype: a.to(dtype).contiguous()
    # ---- qc_check: a drawn point of the AL inner problem ----
    # (draw_isrbd_point) around the quadruped's stance, its forces scaled
    # to its weight
    g = np.random.RandomState(SEED + 12)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    Xi, Ui, ist, iparams, pin64 = draw_isrbd_point(
        al64, Bc, g, dev, com_z=float(prob64.initial_state[2]), fz=78.0,
        fxy=50.0, u_box=(50.0, 110.0))

    def k5_args(dtype):
        return (cast(Xi, dtype), cast(Ui, dtype),
                {k: cast(v, dtype) for k, v in pin64.items()}, AL(dtype).terms,
                rows, dt)

    lin64, lin_g32, k5_err = linearize_check(
        "qc_k5_check", k5.isrbd_linearize_plain, k5.isrbd_linearize, k5_args,
        B=Bc, shape=shape)
    o_cone, o_xbox, o_ubox = 62, 102, 176
    active = {name: float((lin64["rho"][..., a:b] > 0).double().mean())
              for name, a, b in (("cones", o_cone, o_cone + n_in),
                                 ("x_box", o_xbox, o_ubox),
                                 ("u_box", o_ubox, n_rho))}
    emit("qc_k5_active_row_share", **active)
    if not all(0.02 < v < 0.98 for v in active.values()):
        fail(f"the quadruped K5 check point has no mix of active and idle rows: "
             f"{active}")
    ref64, k1_g32, lin32, k1_err = riccati_check(
        "qc_k1_check", k1, lin64, mu, rows, B=Bc, shape="isrbd_al_quadruped",
        live_b_columns=len(rows.uc))
    tassa_err = tassa_check("qc_k1_tassa_check", k1, lin64, mu, rows,
                            "cholesky", nan_member=7, shape="isrbd_al_quadruped",
                            B=Bc)
    iopts = al64.inner.opts
    ix0 = Xi[:, 0] + t64(0.005 * g.randn(Bc, nx))
    ix0_nan = ix0.clone()
    ix0_nan[7] = float("nan")
    iks, iKs, idV1, idV2 = ref64
    iD = torch.sum(lin64["d"] ** 2, dim=(1, 2))
    imerit0 = al64.inner.total_cost(Xi, Ui, pin64) + iopts.defect_weight * iD
    alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=f64, device=dev)

    def k6_args(x0s):
        def args(dtype, alphas):
            c = lambda v: cast(v, dtype)
            return (c(x0s), c(Xi), c(Ui), c(iks), c(iKs), c(lin64["d"]),
                    c(alphas), {k: c(v) for k, v in pin64.items()},
                    c(imerit0), c(iD), c(idV1), c(idV2), AL(dtype).terms, dt,
                    iopts.defect_weight, iopts.beta,
                    iopts.alpha_converge_threshold)
        return args

    k6_err = trial_check("qc_k6_check", k6.isrbd_trial_plain, k6.isrbd_trial,
                         k6_args(ix0_nan), alphas4, imerit0, iD, idV1, idV2,
                         iopts, nan_member=7, B=Bc)
    Ui_nan = Ui.clone()
    Ui_nan[7, 3, 0] = float("nan")

    def ev_args(Ue):
        def args(dtype):
            return (cast(Xi, dtype), cast(Ue, dtype),
                    {k: cast(v, dtype) for k, v in pin64.items()},
                    AL(dtype).terms, dt)
        return args

    ev_err = evaluate_check("qc_isrbd_evaluate_check", k6.isrbd_evaluate_plain,
                            k6.isrbd_evaluate, ev_args(Ui_nan), nan_member=7,
                            x0=ix0_nan)
    # K7 and K8: member 7's r̈ₓ at node 3 and one of its multipliers NaN;
    # static bounds and the drawn overrides; a first and a later outer;
    # phase tables of P=20 with a NaN in member 7's rows, phases that wrap
    ast = ist._replace(sol=ist.sol._replace(X=Xi, U=Ui_nan),
                       lam_eq=ist.lam_eq.clone())
    ast.lam_eq[7, 2, 4] = float("nan")
    viol_later = t64(10.0 ** g.uniform(-3, 3, Bc))
    P_al = 20
    phase = torch.as_tensor(g.randint(0, P_al, Bc), dtype=torch.int32, device=dev)
    phase[:3] = torch.tensor([0, 1, P_al - 1], dtype=torch.int32)
    full_prior = al64.init_full_phase_prior(P_al, Bc)._replace(
        lam_eq=t64(g.randn(Bc, P_al, ns, n_eq)),
        lam_eq_T=t64(g.randn(Bc, P_al, n_eq_T)),
        seen=torch.as_tensor(g.rand(Bc, P_al) < 0.5, device=dev))
    tail_prior = al64.init_phase_prior(P_al, Bc)._replace(
        lam_tail=t64(g.randn(Bc, P_al, n_eq)), lam_T=t64(g.randn(Bc, P_al, n_eq_T)),
        seen_tail=torch.as_tensor(g.rand(Bc, P_al) < 0.5, device=dev),
        seen_T=torch.as_tensor(g.rand(Bc, P_al) < 0.5, device=dev))
    full_prior.lam_eq[7, :, 1, 1] = float("nan")
    tail_prior.lam_tail[7, :, 3] = float("nan")
    priors = {"none": None, "tail": tail_prior, "full": full_prior}
    al_errs = al_entry_checks("qc_al_check", AL, Xi, Ui_nan, ast, iparams,
                              viol_later, priors, phase, nan_member=7)

    # ---- qc_kernel_times: B = 1, 256, 4096, float32 ----
    a5 = k5_args(f32)
    a6 = k6_args(ix0)(f32, alphas4[:1])
    a6_4 = k6_args(ix0)(f32, alphas4)
    aev = ev_args(Ui)(f32) + (cast(ix0, f32),)
    k1_args32 = tuple(lin32[k] for k in ORDER)
    sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
             len(rows.bx), len(rows.uc))
    K1_FORMS = (("riccati_backward_isrbd_al_quadruped", "collapsed", "schur"),
                ("riccati_backward_isrbd_al_quadruped_tassa_cholesky", "tassa",
                 "cholesky"))
    ast32 = cast_tree(ast._replace(sol=ast.sol._replace(U=Ui)), f32)
    ast32.lam_eq[7, 2, 4] = 0.0
    ap32 = {k: cast(v, f32) for k, v in static_bounds(iparams).items()}
    full32 = cast_tree(full_prior, f32)
    full32.lam_eq[7] = 0.0
    Xi32, Ui32 = cast(Xi, f32), cast(Ui, f32)
    al_calls = {
        "isrbd_al_constraints": ((al32, Xi32, Ui32, ap32), dict(st=ast32)),
        "isrbd_al_constraints_offline": ((al32, Xi32, Ui32, ap32),
                                         dict(st=ast32, offline=True)),
        "isrbd_al_constraints_eval": ((al32, Xi32, Ui32, ap32), {}),
        "isrbd_al_shift": ((al32, ast32, full32, phase), {}),
        "isrbd_al_params": ((al32, ap32, ast32), {}),
        "isrbd_al_prior_update": ((al32, full32, ast32, phase, 1.0), {}),
    }

    times = defaultdict(dict)
    for Bw in (1, Bc, B_LARGE):
        plain_too = Bw <= Bc         # the twins at the path's sizes only
        pl = lambda fn, reps: (cuda_ms(fn, reps=reps, warmup=1) if plain_too
                               else None)
        la = repeat_members(a5, Bw)
        out = k5.isrbd_linearize(*la)
        times["isrbd_linearize_quadruped"][Bw] = dict(
            ms=cuda_ms(lambda: k5.isrbd_linearize(*la), reps=20),
            plain_ms=pl(lambda: k5.isrbd_linearize_plain(*la), 3),
            bytes=nbytes(la[0], la[1], *k5.kernel_params(
                la[2], Bw, ns, al32.terms, f32, dev), rows.packed(dev),
                *out.values()),
            flop=isrbd_linearize_flops(Bw, ns, nx, nu, nc, n_rho, n_term,
                                       len(rows.rx), len(rows.ru), len(rows.uc)))
        ka = repeat_members(k1_args32, Bw)
        for name, form, solver in K1_FORMS:
            kw = dict(form=form, quu_solver=solver)
            out = k1.riccati_backward(*ka, mu, rows, **kw)
            flop = (riccati_flops(Bw, ns, nx, nu, n_term, *sizes)
                    if form == "collapsed"
                    else tassa_flops(Bw, ns, nx, nu, n_term, *sizes, solver))
            times[name][Bw] = dict(
                ms=cuda_ms(lambda: k1.riccati_backward(*ka, mu, rows, **kw),
                           reps=10),
                plain_ms=pl(lambda: k1.riccati_backward_plain(*ka, mu, rows,
                                                              **kw), 2),
                bytes=nbytes(*ka, rows.packed(dev), *out), flop=flop,
                fp64_tensor_cores=True)
        ta = repeat_members(a6, Bw, skip=(6,))
        out = k6.isrbd_trial(*ta)
        times["isrbd_trial_quadruped"][Bw] = dict(
            ms=cuda_ms(lambda: k6.isrbd_trial(*ta), reps=20),
            plain_ms=pl(lambda: k6.isrbd_trial_plain(*ta), 3),
            bytes=nbytes(*[v for v in ta[:12] if isinstance(v, torch.Tensor)],
                         *k5.kernel_params(ta[7], Bw, ns, al32.terms, f32, dev),
                         *out),
            flop=isrbd_trial_flops(Bw, ns, nx, nu, nc, n_rho, n_term, 1))
        ta4 = repeat_members(a6_4, Bw, skip=(6,))
        times["isrbd_trial_quadruped"][Bw]["ms_4alpha"] = cuda_ms(
            lambda: k6.isrbd_trial(*ta4), reps=20)
        ea = repeat_members(aev, Bw)
        out = k6.isrbd_evaluate(*ea[:-1], x0=ea[-1])
        times["isrbd_evaluate_quadruped"][Bw] = dict(
            ms=cuda_ms(lambda: k6.isrbd_evaluate(*ea[:-1], x0=ea[-1]), reps=20),
            plain_ms=pl(lambda: k6.isrbd_evaluate_plain(*ea[:-1], x0=ea[-1]), 3),
            bytes=nbytes(ea[0], ea[1], *k5.kernel_params(
                ea[2], Bw, ns, al32.terms, f32, dev), ea[-1], *out),
            flop=isrbd_evaluate_flops(Bw, ns, nx, nc, n_rho, n_term))
        for name, (a, kw) in al_calls.items():
            entry = name.replace("_offline", "").replace("_eval", "")
            kern, twin = getattr(k78, entry), getattr(k78, entry + "_plain")
            aw, kww = resize_members((a, kw), Bc, Bw)
            res = kern(*aw, **kww)
            n_bytes, flop = al_call_work(al32, name, aw, kww, res)
            times[name + "_quadruped"][Bw] = dict(
                ms=cuda_ms(lambda: kern(*aw, **kww), reps=20),
                plain_ms=pl(lambda: twin(*aw, **kww), 3),
                bytes=n_bytes, flop=flop)
    for by_B in times.values():
        for v in by_B.values():
            rate = (H100_FP64_TC_FLOP_PER_S if v.pop("fp64_tensor_cores", False)
                    else H100_F32_FLOP_PER_S)
            v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flop"], rate)
    # the wrappers' host µs a call at the serving B (the path's calls)
    la, ka = repeat_members(a5, Bc), repeat_members(k1_args32, Bc)
    ta, ea = repeat_members(a6, Bc, skip=(6,)), repeat_members(aev, Bc)
    host = {
        "isrbd_linearize_quadruped": host_us(lambda: k5.isrbd_linearize(*la)),
        "isrbd_trial_quadruped": host_us(lambda: k6.isrbd_trial(*ta)),
        "isrbd_evaluate_quadruped": host_us(
            lambda: k6.isrbd_evaluate(*ea[:-1], x0=ea[-1])),
        **{name: host_us(lambda: k1.riccati_backward(
            *ka, mu, rows, form=form, quu_solver=solver))
           for name, form, solver in K1_FORMS},
        **{name + "_quadruped": host_us(
            lambda: getattr(k78, name.replace("_offline", "").replace(
                "_eval", ""))(*a, **kw))
           for name, (a, kw) in al_calls.items()},
    }
    nt = n_term
    occ = dict(
        isrbd_linearize_quadruped=k5.occupancy(f32, "quadruped"),
        isrbd_trial_quadruped=k6.trial_occupancy(f32, "quadruped"),
        isrbd_evaluate_quadruped=k6.evaluate_occupancy(ns, f32, "quadruped"),
        **{name: dict(blocks_per_sm=k1.blocks_per_sm(nx, nu, nt, rows, f32,
                                                     form, solver),
                      shared_memory_bytes=k1.shared_memory_bytes(
                          nx, nu, nt, rows, f32, form, solver))
           for name, form, solver in K1_FORMS})
    # K7's wrapper by part, and its occupancy a mode
    for name, (a, kw) in al_calls.items():
        if name.startswith("isrbd_al_constraints"):
            mode = 0 if not kw else 2 if kw.get("offline") else 1
            host[name + "_quadruped_by_part"] = k7_host_split(k78, a, kw)
            occ[name + "_quadruped"] = k78.constraints_occupancy(
                mode, f32, ns, "quadruped")
    emit("qc_kernel_times", card=card, dtype="float32", sms=sms,
         times={k: {str(b): v for b, v in d.items()} for k, d in times.items()},
         host_us=host, occupancy=occ)
    del lin64, lin32, lin_g32, k1_g32, ref64, pin64, iparams, ist, ast
    del full_prior, tail_prior, priors, al_calls, ast32, full32

    # ---- qc_path: the constrained example's single robot, float32 ----
    ISRBD_TWINS = ((k1, ("riccati_backward_plain",)),
                   (k6, ("isrbd_trial_plain", "isrbd_evaluate_plain")),
                   (k5, ("isrbd_linearize_plain",)))
    i_coll = k1.KERNEL_INSTANCES.index(("isrbd_al_quadruped", "collapsed", "schur"))
    i_chol = k1.KERNEL_INSTANCES.index(("isrbd_al_quadruped", "tassa", "cholesky"))
    COUNTED = ((k5, "isrbd_linearize"), (k6, "isrbd_trial"),
               (k6, "isrbd_evaluate"), (k78, "isrbd_al_constraints"),
               (k78, "isrbd_al_shift"), (k78, "isrbd_al_params"),
               (k78, "isrbd_al_prior_update"), (k1, "riccati_backward"))

    def reset_counts():
        for mod, entry in COUNTED:
            getattr(mod, entry).launches = 0
        k1.riccati_backward.instance_launches[:] = [0] * len(k1.KERNEL_INSTANCES)

    def read_counts():
        out = {entry: getattr(mod, entry).launches for mod, entry in COUNTED}
        il = k1.riccati_backward.instance_launches
        out["riccati_backward_isrbd_al_quadruped"] = il[i_coll]
        out["riccati_backward_isrbd_al_quadruped_tassa_cholesky"] = il[i_chol]
        return out

    def trot_wpg(dtype, device):
        return WalkingPatternGenerator.build(
            0.0, ns, dtype=dtype, device=device, group_mask=trot_group_mask(),
            **QUAD_TOPOLOGY)

    def single_robot(dtype, device, ticks, timed=False, counted=None):
        """The constrained example's sequence: the offline `ALDDP.solve`
        from the static input tiled, then `ticks` ticks of the trot WPG's
        advance, rdot_ref[1:] = (QC_VX, 0, 0), x0 = the plan's node 1 and
        solve_online(solve_online(shift_warmstart(st))) at max_iters=1.
        Returns the solvers, the states (offline, then each tick's), the
        offline ms, the tick ms and the host reads and counts a tick."""
        prob, off = solvers(dtype, device, 15)
        _, on = solvers(dtype, device, 1)
        wpg = trot_wpg(dtype, device)
        sync = torch.cuda.synchronize if timed else (lambda: None)
        n, restore = count_solver_calls(off.inner, on.inner)
        x0 = prob.initial_state
        U0 = prob.static_input[None].expand(ns, -1).contiguous()
        sync()
        t0 = time.perf_counter()
        st = off.solve(off.init(x0, U0), x0, prob.ocp.params)
        sync()
        off_ms = (time.perf_counter() - t0) * 1e3
        states, tick_ms, per_tick = [st], [], []
        params, ws = dict(prob.ocp.params), wpg.init_state()
        ref = torch.tensor([QC_VX, 0.0, 0.0], dtype=dtype, device=device)
        walk = torch.tensor(1, dtype=torch.int32, device=device)

        def tick(st, params, ws):
            params, ws = wpg.advance(params, ws, walk)
            params["rdot_ref"] = torch.cat(
                [params["rdot_ref"][:1], ref.expand(ns, 3)], dim=0)
            x0 = st.sol.X[1]
            st = on.solve_online(on.solve_online(on.shift_warmstart(st), x0,
                                                 params), x0, params)
            return st, params, ws

        for _ in range(ticks):
            before = (dict(n), on.inner.host_syncs,
                      read_counts() if counted else None)
            sync()
            t0 = time.perf_counter()
            st, params, ws = tick(st, params, ws)
            sync()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            states.append(st)
            per_tick.append(dict(
                iterations=n["iterations"] - before[0]["iterations"],
                host_reads=on.inner.host_syncs - before[1],
                **({k: v - before[2][k] for k, v in read_counts().items()}
                   if counted else {})))
        restore()
        step = lambda c: tick(*c)
        return (dict(off=off, on=on, prob=prob, n=n, step=step,
                     carry=(st, params, ws)), states, off_ms, tick_ms, per_tick)

    guards, restore_guards = guard_plain(ISRBD_TWINS, al=True)
    reset_counts()
    run, states, off_ms, tick_ms, per_tick = single_robot(
        f32, dev, QC_TICKS, timed=True, counted=True)
    path_launches = read_counts()
    restore_guards()
    n = run["n"]
    viols = [float(s.viol) for s in states[1:]]
    last = states[-1]
    A_fc = torch.as_tensor(linearized_friction_cone_rows(
        cfg(f32).friction_cone_coefficient), dtype=f32, device=dev)
    d = run["on"].solution_dict(last)
    cone_max = max(float((d[f"f{i}"] @ A_fc.T).max()) for i in range(nc))
    fz_min = min(float(d[f"f{i}"][:, 2].min()) for i in range(nc))
    hand = lambda L: sum(L[e] for e in ("isrbd_linearize", "riccati_backward",
                                        "isrbd_trial", "isrbd_evaluate",
                                        "isrbd_al_constraints", "isrbd_al_shift",
                                        "isrbd_al_params"))
    outers = 6 + 2 * QC_TICKS                    # offline outers, two a tick
    qp = dict(
        B=1, dtype="float32", ticks=QC_TICKS,
        options="al_serving_options: offline max_iters=15 (6 outers), online "
                "max_iters=1, two solve_online a tick after shift_warmstart",
        walk=f"trot WPG, vx {QC_VX} from tick 0",
        offline_ms=off_ms, offline_viol=float(states[0].viol),
        offline_iterations_last_inner=int(states[0].sol.iterations),
        tick_p50_ms=statistics.median(tick_ms), tick_max_ms=max(tick_ms),
        tick_mean_ms=statistics.fmean(tick_ms),
        viol_max_ticks_20_39=max(viols[20:]), viol_final=viols[-1],
        iterations=n["iterations"], solves=n["solves"], trials=n["trials"],
        iterations_per_tick=statistics.fmean(t["iterations"] for t in per_tick),
        host_reads_per_tick=statistics.fmean(t["host_reads"] for t in per_tick),
        hand_written_launches_per_tick=statistics.fmean(hand(t) for t in per_tick),
        launches=path_launches,
        forward_progress_m=float(last.sol.X[0, 0] - run["prob"].initial_state[0]),
        cone_row_max_N=cone_max, fz_min_N=fz_min,
        finite=all(bool(torch.isfinite(t).all()) for s in states
                   for t in (s.sol.X, s.sol.U, s.lam_eq, s.lam_eq_T, s.viol)),
        **{k: v["n"] for k, v in guards.items()}, card=card)
    qp["profile"] = profile_ticks(run["on"].inner, run["step"], run["carry"],
                                  qp["tick_p50_ms"])
    emit("qc_path", **qp)
    L = path_launches
    if not qp["finite"]:
        fail("the constrained quadruped trot produced non-finite values")
    if min(L[k] for k in ("isrbd_linearize", "isrbd_trial", "isrbd_evaluate",
                          "isrbd_al_constraints", "isrbd_al_shift",
                          "isrbd_al_params",
                          "riccati_backward_isrbd_al_quadruped_tassa_cholesky")) == 0:
        fail(f"a kernel was not launched on the constrained quadruped path: {L}")
    if not (L["isrbd_linearize"] == L["riccati_backward"]
            == L["riccati_backward_isrbd_al_quadruped_tassa_cholesky"]
            == n["iterations"]):
        fail(f"K5 and K1 (Tassa, Cholesky) launches differ from the "
             f"{n['iterations']} iterations: {L}")
    if L["isrbd_trial"] != n["trials"]:
        fail(f"K6 launches do not cover the {n['trials']} trials: {L}")
    if not (L["isrbd_evaluate"] == 2 * n["solves"] and n["solves"] == outers):
        fail(f"isrbd_evaluate launches are not two for each of the "
             f"{outers} solves: {L}, {n}")
    if not (L["isrbd_al_constraints"] == L["isrbd_al_params"] == outers):
        fail(f"K7 and K8b launches are not one an outer ({outers}): {L}")
    if L["isrbd_al_shift"] != QC_TICKS:
        fail(f"K8a (the shift) did not launch once a tick: {L}")
    if (qp["plain_twin_calls"] or qp["al_twin_calls"] or qp["torch_func_calls"]
            or qp["plain_cost_or_defect_calls"]):
        fail(f"the constrained quadruped path ran plain twins on the card: {qp}")
    if not qp["offline_viol"] < 1e-3:
        fail(f"the offline solve's violation {qp['offline_viol']} is not below 1e-3")
    if not qp["viol_max_ticks_20_39"] < VIOL_LIMIT:
        fail(f"the trot's violation over ticks 20-39 "
             f"{qp['viol_max_ticks_20_39']} is not below {VIOL_LIMIT}")
    if not qp["forward_progress_m"] > QC_VX:
        fail(f"the constrained trot advanced {qp['forward_progress_m']} m, not "
             f"more than {QC_VX}")
    if not (cone_max < QC_CONE_N and fz_min > -QC_CONE_N):
        fail(f"the plan leaves the friction cones: F·A_fcᵀ max {cone_max}, "
             f"F_z min {fz_min}")

    # ---- qc_card_vs_cpu: the offline solve and 3 ticks in float64 ----
    _, st_card, _, _, _ = single_robot(f64, dev, 3)
    _, st_cpu, _, _, _ = single_robot(f64, "cpu", 3)
    both = lambda f: max(rel_err(f(a).cpu(), f(b)) for a, b in zip(st_card, st_cpu))
    qvc = dict(
        B=1, steps=len(st_cpu), tol=1e-9,
        iterations_equal=all(int(a.sol.iterations) == int(b.sol.iterations)
                             for a, b in zip(st_card, st_cpu)),
        converged_equal=all(bool(a.sol.converged) == bool(b.sol.converged)
                            for a, b in zip(st_card, st_cpu)),
        X_rel_err=both(lambda s: s.sol.X), U_rel_err=both(lambda s: s.sol.U),
        lam_rel_err=both(lambda s: s.lam_eq), lam_T_rel_err=both(lambda s: s.lam_eq_T),
        viol_cpu=[float(b.viol) for b in st_cpu])
    emit("qc_card_vs_cpu", **qvc)
    if not (qvc["iterations_equal"] and qvc["converged_equal"]
            and max(qvc["X_rel_err"], qvc["U_rel_err"], qvc["lam_rel_err"],
                    qvc["lam_T_rel_err"]) <= 1e-9):
        fail("the constrained quadruped card path and CPU path disagree")

    # ---- qc_fleet_path: the constrained tick at B=256, float32 ----
    def fleet(Bsz, warm, timed):
        """The fleet's serving tick (`constrained_tick`, outers=2, inner
        max_iters=1, FullPhasePrior at EMA 1, the trot WPG), seeded by the
        batched offline solve from x0 = nominal + 0.01·N(0,1) (seed 11);
        standing, then walking at QC_VX from tick 10. 1 + `warm` ticks,
        then `timed` ticks."""
        prob, off = solvers(f32, dev, 15)
        _, on = solvers(f32, dev, 1)
        wpg = trot_wpg(f32, dev)
        gg = np.random.RandomState(11)
        x0 = prob.initial_state[None] + torch.as_tensor(
            0.01 * gg.randn(Bsz, nx), dtype=f32, device=dev)
        U0 = prob.static_input[None].expand(ns, -1)
        params = {k: v.expand((Bsz,) + tuple(v.shape)).contiguous()
                  for k, v in prob.ocp.params.items()}
        period = 2 * wpg.step_nodes
        stand = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        walk = torch.ones(Bsz, dtype=torch.int32, device=dev)
        still = torch.zeros(Bsz, 3, dtype=f32, device=dev)
        go = torch.tensor([[QC_VX, 0.0, 0.0]], dtype=f32, device=dev).expand(
            Bsz, -1).contiguous()
        n, restore = count_solver_calls(on.inner, off.inner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = off.solve_batch(off.init(x0, U0), x0, params)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
        seed_viol = float(st.viol.max())
        state = [st, params, wpg.init_state((Bsz,)),
                 on.init_full_phase_prior(period, Bsz), 0]

        def step(s):
            st, params, ws, pr, k = s
            st, params, ws, pr = constrained_tick(
                on, wpg, st, params, ws, walk if k >= 10 else stand,
                go if k >= 10 else still, prior=pr, outers=2, prior_ema=1.0)
            return [st, params, ws, pr, k + 1]

        for _ in range(1 + warm):
            state = step(state)
        torch.cuda.synchronize()
        before = dict(n, syncs=on.inner.host_syncs, **read_counts())
        tms, viols = [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            state = step(state)
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
            viols.append(float(state[0].viol.max()))
        after = dict(n, syncs=on.inner.host_syncs, **read_counts())
        restore()
        st = state[0]
        window = {k: after[k] - before[k] for k in after}
        res = dict(
            B=Bsz, dtype="float32", warmup_ticks=1 + warm, ticks=timed,
            online_iters=1, outers=2, phase_prior="full", prior_ema=1.0,
            walk=f"standing, then vx {QC_VX} from tick 10",
            seed_seconds=seed_s, seed_viol_max=seed_viol,
            window_viol_max=max(viols), final_viol_max=viols[-1],
            tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
            tick_mean_ms=statistics.fmean(tms),
            solves_per_s=Bsz / statistics.median(tms) * 1e3,
            syncs_per_tick=window["syncs"] / timed, timed_window=window,
            finite=all(bool(torch.isfinite(t).all()) for t in
                       (st.sol.X, st.sol.U, st.lam_eq, st.lam_eq_T, st.viol,
                        st.sol.cost)),
            card=card)
        return res, on, step, state

    guards, restore_guards = guard_plain(ISRBD_TWINS, al=True)
    reset_counts()
    fp, fon, fstep, fstate = fleet(Bc, warm=60, timed=20)
    fleet_launches = read_counts()
    restore_guards()
    fp.update({k: v["n"] for k, v in guards.items()})
    fp["launches"] = fleet_launches
    fstate, fp["spans"] = tick_spans(fon.inner, fstep, fstate, ticks=5)
    fp["profile"] = profile_ticks(fon.inner, fstep, fstate, fp["tick_p50_ms"])
    fp["device_busy_ms_per_tick"] = fp["profile"]["device_busy_ms_per_tick"]
    fp["device_idle_share"] = fp["profile"]["device_idle_share"]
    fp["launches_by_span"] = fp["profile"]["launches_by_span"]
    emit("qc_fleet_path", **fp)
    w, ticks = fp["timed_window"], fp["ticks"]
    if not fp["finite"]:
        fail("the constrained quadruped fleet produced non-finite values")
    if min(fleet_launches[k] for k in (
            "isrbd_linearize", "riccati_backward_isrbd_al_quadruped",
            "isrbd_trial", "isrbd_evaluate", "isrbd_al_constraints",
            "isrbd_al_shift", "isrbd_al_params", "isrbd_al_prior_update")) == 0:
        fail(f"a kernel was not launched on the constrained quadruped fleet: "
             f"{fleet_launches}")
    if not (w["isrbd_linearize"] == w["riccati_backward"]
            == w["riccati_backward_isrbd_al_quadruped"] == w["iterations"] > 0):
        fail(f"K5, K1 and the iterations differ over the timed ticks: {w}")
    if w["isrbd_trial"] != w["trials"]:
        fail(f"K6 launches do not cover the trials over the timed ticks: {w}")
    if not (w["isrbd_evaluate"] == 2 * w["solves"] == 2 * 2 * ticks):
        fail(f"isrbd_evaluate launches are not two a solve (two solves a "
             f"tick): {w}")
    if not (w["isrbd_al_constraints"] == w["isrbd_al_params"] == 2 * ticks
            and w["isrbd_al_shift"] == w["isrbd_al_prior_update"] == ticks):
        fail(f"K7/K8b are not once an outer, or K8a/K8c once a tick, over the "
             f"{ticks} timed ticks: {w}")
    if (fp["plain_twin_calls"] or fp["al_twin_calls"] or fp["torch_func_calls"]
            or fp["plain_cost_or_defect_calls"]):
        fail(f"the constrained quadruped fleet ran plain twins on the card: {fp}")
    if not fp["window_viol_max"] < VIOL_LIMIT:
        fail(f"the quadruped fleet's violation {fp['window_viol_max']} over the "
             f"timed ticks is not below {VIOL_LIMIT}")
    del fstate, fstep, fon
    large, *_ = fleet(B_LARGE, warm=2, timed=2)
    emit("qc_fleet_path_large", **large)

    # ---- the kernel rows ----
    both = lambda k: path_launches[k] + fleet_launches[k]
    lin_tol = f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}"
    trial_tol = "2*plain_rel_err_f32 + 1e-6"

    def row(name, mod, launches, err, tol32, Bt=Bc, **extra):
        tt = times[name][Bt]
        return kernel_row(name, mod, launches, tt["ms"], tt["plain_ms"],
                          tt["bound_ms"], tt["bound_by"], err, tol32, B=Bt,
                          shape="isrbd quadruped (QuadAlShape)",
                          ms_by_B={str(b): v["ms"] for b, v in times[name].items()},
                          host_us=host[name], **occ.get(name, {}), **extra)

    per_path = lambda k: dict(launches_qc_path=path_launches[k],
                              launches_qc_fleet_path=fleet_launches[k])
    rows_out = [
        row("isrbd_linearize_quadruped", k5, both("isrbd_linearize"), k5_err,
            lin_tol, **per_path("isrbd_linearize")),
        row("riccati_backward_isrbd_al_quadruped", k1,
            fleet_launches["riccati_backward_isrbd_al_quadruped"], k1_err,
            K1_F32_TOL, live_b_columns=len(rows.uc),
            launches_of="qc_fleet_path (the collapsed sweep of solve_batch)"),
        dict(row("riccati_backward_isrbd_al_quadruped_tassa_cholesky", k1,
                 path_launches["riccati_backward_isrbd_al_quadruped_tassa_cholesky"],
                 tassa_err, K1_F32_TOL, Bt=1, quu_solver="cholesky",
                 launches_of="qc_path (ALDDP.solve / solve_online's Tassa sweep)"),
             replaces=k1.TASSA_REPLACES),
        row("isrbd_trial_quadruped", k6, both("isrbd_trial"), k6_err, trial_tol,
            ms_4alpha=times["isrbd_trial_quadruped"][Bc]["ms_4alpha"],
            **per_path("isrbd_trial")),
        dict(row("isrbd_evaluate_quadruped", k6, both("isrbd_evaluate"), ev_err,
                 trial_tol, pinned=True, **per_path("isrbd_evaluate")),
             replaces=k6.EVALUATE_REPLACES),
    ]
    for e, key, replaces, tol32 in (
            ("isrbd_al_constraints", "k7", k78.REPLACES, trial_tol),
            ("isrbd_al_shift", "k8a", k78.SHIFT_REPLACES, "bit-equal"),
            ("isrbd_al_params", "k8b", k78.PARAMS_REPLACES, "bit-equal"),
            ("isrbd_al_prior_update", "k8c", k78.PRIOR_REPLACES, "bit-equal")):
        extra = {}
        if e == "isrbd_al_constraints":
            off = times["isrbd_al_constraints_offline_quadruped"][Bc]
            extra = dict(mode="online (the serving tick)", ms_offline=off["ms"],
                         plain_ms_offline=off["plain_ms"],
                         bound_ms_offline=off["bound_ms"])
        rows_out.append(dict(
            row(e + "_quadruped", k78, both(e), al_errs[key], tol32,
                **per_path(e), **extra),
            replaces=replaces,
            tol_f64=AL_F64_TOL if key == "k7" else "bit-equal"))
    emit("quadruped_constrained_section",
         seconds=time.perf_counter() - t_section, card=card)
    return rows_out


# ---------------- the execution modes (phase 13) ----------------

MODES_SIZES = (1, 8, 512)       # K12 and K13 checked and timed here
# K12 in float64, `rel_err` over each output: the element phase solves
# R̃ = luu + μI alone (μ = 1e-6; K1 solves the better conditioned Quu), by
# K2's explicit inverse with the block-Schur gains, and the 34 pivoted
# (I + C₁J₂) solves follow, so rounding is amplified: 7e-12 at B ≤ 8 and
# 1.3e-9 (ΔV₂) over the 512 drawn members on an H100 (PERF.md §6). K13
# and the Cholesky gains read ≤ 5.4e-14.
K12_F64_TOL = 1e-8
# float32 tensors, carried in float64 by both: each entry within 1e-6 of
# max(1, |twin|) against the float64 twin on the same float32 inputs (K1's)
MODES_F32_TOL = 1e-6


def k12_flops(Bsz, ns, nx, nu, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc,
              quu_solver, combines):
    """FLOPs one K12 sweep needs, counted from csrc/riccati_associative.cu
    (products 2 FLOPs a multiply-add): per node the Gauss–Newton
    quadratics, R̃'s solve against the 1 + 2nx right-hand sides (K2's
    inverse and a product, or the Cholesky factor and its substitutions),
    the element's products over the live rows of B; the terminal element;
    per combine C₁J₂ and C₁η₂, the elimination of nx rows across 3nx + 1
    columns, 2nx + 1 back substitutions and the five products; per node
    the gains (V A, V B, the Q terms, the gain solve against 1 + nx
    right-hand sides) and the ΔV terms."""
    W, Wa = 1 + 2 * nx, 3 * nx + 1

    def solve(rhs):
        if quu_solver == "schur":
            return 2 * inv_flops(nu) + 2 * nu * nu * rhs
        return 2 * nu ** 3 // 3 + 2 * nu * nu * rhs

    element = (2 * (n_gx * nx + n_gu * nu + n_gx * nx * nx + n_gu * nu * nu
                    + n_b * nu * nx)
               + solve(W)
               + 2 * (2 * n_ru * n_uc * nx + nu * nx * nx + n_ru * n_uc
                      + nu * nx))
    lu = sum(2 * (nx - 1 - k) * (Wa - 1 - k) for k in range(nx))
    combine = (2 * nx ** 3 + 2 * nx * nx + lu + (2 * nx + 1) * nx * nx
               + 5 * 2 * nx ** 3 + 3 * 2 * nx * nx)
    gain = (2 * (nx * nx + n_rx * nx * nx + n_ru * n_uc * nx
                 + n_ru * n_uc * (1 + nx + nu))
            + solve(1 + nx) + 2 * nu * nu + 4 * nu)
    return Bsz * (ns * (element + gain) + 2 * nt * nx * (nx + 1)
                  + combines * combine)


def k13_flops(fam_flops, Bsz, ns, nx, n_rx, n_ru, n_uc, nA):
    """FLOPs one K13 call needs: the family's trial (gain application, the
    Euler step, the residual rows, merit and Armijo test: `trial_flops`
    or `lip_trial_flops`) plus, per node, the recursion's live rows of Sx
    and Bs (Bs twice: K δx and k) and the defect's difference, square and
    sum."""
    return fam_flops + nA * Bsz * ns * (
        2 * n_rx * nx + 4 * n_ru * n_uc + 2 * nx + 3 * nx)


def k12_phase_ms(call, reps=5):
    """Device ms a K12 sweep spends in each of its phases (the element,
    combine and gain kernels) and the sweep's span, from torch.profiler
    over `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    out = dict(profiled_wall_ms=wall)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for phase in ("element_kernel", "combine_kernel", "gain_kernel"):
            if phase in e.key:
                out[phase] = out.get(phase, 0.0) + \
                    e.self_device_time_total / 1e3 / reps
                out[phase + "_launches"] = out.get(phase + "_launches", 0) + \
                    e.count / reps
    return out


def modes_sub(t, Bw):
    """The first Bw members of `t` (of each tensor, for a dict), or its
    members repeated up to Bw."""
    import torch

    if isinstance(t, dict):
        return {k: modes_sub(v, Bw) for k, v in t.items()}
    n = t.shape[0]
    return (t[:Bw] if Bw <= n
            else torch.cat([t] * -(-Bw // n))[:Bw]).contiguous()


def modes_k12_args(p, Bw, dtype):
    """K12's sliced linearization of the drawn point `p` (a `pts` entry of
    the modes sections) at Bw members in `dtype`."""
    return tuple(modes_sub(p["lin"][k], Bw).to(dtype) for k in ORDER)


def modes_k13_args(p, Bw, dtype, nA, cast=None):
    """K13's arguments at Bw members in `dtype` (then cast to `cast`), with
    √w_c of float64 throughout; the float32 twin takes the float32
    problem's terms."""
    import torch

    s = p["s32"] if dtype == torch.float32 and cast is None else p["s"]
    t = lambda a: modes_sub(a, Bw).to(dtype)
    al = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=dtype,
                      device=p["X"].device)
    out = (t(p["x0"]), t(p["X"]), t(p["U"]), t(p["gains"][0]),
           t(p["gains"][1]), t(p["lin"]["Sx"]), t(p["lin"]["Bs"]),
           t(p["lin"]["d"]), al, {k: t(v) for k, v in p["params"].items()},
           t(p["merit0"]), t(p["D"]), t(p["gains"][2]), t(p["gains"][3]))
    if cast is not None:
        out = tuple({k: v.to(cast) for k, v in a.items()}
                    if isinstance(a, dict) else a.to(cast) for a in out)
    return out + (s.terms, s.rows, p["ocp"].dt, p["s"]._wc(torch.float64),
                  s.opts.defect_weight, s.opts.beta,
                  s.opts.alpha_converge_threshold)


def modes_k12_check(p, sv, sizes, card):
    """`modes_check` of K12 at the point `p` with the gain solve `sv`:
    float64 against the float64 twin (`rel_err` ≤ K12_F64_TOL; the entry by
    entry figure printed), float32 against the float64 twin on the same
    float32 inputs (`err1` ≤ MODES_F32_TOL); fails beyond either."""
    import torch

    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    f64, f32 = torch.float64, torch.float32
    mu, rows = p["s"].opts.mu0, p["s"].rows
    e = dict(e64={}, e64_entrywise={}, e32={}, p32={}, abs32=0.0,
             f32_rule="err1: |kernel - twin| / max(1, |twin|)")
    for Bw in sizes:
        a64 = modes_k12_args(p, Bw, f64)
        ref = k12.riccati_associative_plain(*a64, mu, rows, sv)
        got = k12.riccati_associative(*a64, mu, rows, sv)
        a32 = modes_k12_args(p, Bw, f32)
        got32 = k12.riccati_associative(*a32, mu, rows, sv)
        ref32 = k12.riccati_associative_plain(*(a.double() for a in a32), mu,
                                              rows, sv)
        plain32 = k12.riccati_associative_plain(*a32, mu, rows, sv)
        torch.cuda.synchronize()
        for name, g64, r64, g32, r32, q32 in zip(SWEEP_OUT, got, ref, got32,
                                                 ref32, plain32):
            key = f"{name}_B{Bw}"
            e["e64"][key] = rel_err(g64, r64)
            e["e64_entrywise"][key] = err1(g64, r64)
            e["e32"][key] = err1(g32, r32)
            e["p32"][key] = err1(q32, r32)
            e["abs32"] = max(e["abs32"], abs_err(g32, r32))
    emit("modes_check", kernel="riccati_associative", shape=p["fam"],
         quu_solver=sv, sizes=sizes, tol_f64=K12_F64_TOL,
         tol_f32=MODES_F32_TOL, card=card, **e)
    if max(e["e64"].values()) > K12_F64_TOL:
        fail(f"K12 ({p['fam']}, {sv}) disagrees with its twin in float64: "
             f"{e['e64']}")
    if max(e["e32"].values()) > MODES_F32_TOL:
        fail(f"K12 ({p['fam']}, {sv}) disagrees with its twin in float32: "
             f"{e['e32']}")
    return e


def modes_k13_check(p, sizes, card, alphas=(1, 4)):
    """`modes_check` of K13 at the point `p` with each count of step sizes
    in `alphas`: float64 to 1e-9 with the flags equal, float32 by K12's
    rule; fails beyond either."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13

    f64, f32 = torch.float64, torch.float32
    e = dict(e64={}, e32={}, p32={}, abs32=0.0, flags_equal=True,
             f32_rule="err1: |kernel - twin| / max(1, |twin|)")
    for nA in alphas:
        for Bw in sizes:
            ref = k13.linear_trial_plain(*modes_k13_args(p, Bw, f64, nA))
            got = k13.linear_trial(*modes_k13_args(p, Bw, f64, nA))
            got32 = k13.linear_trial(*modes_k13_args(p, Bw, f32, nA))
            ref32 = k13.linear_trial_plain(*modes_k13_args(p, Bw, f32, nA,
                                                           f64))
            plain32 = k13.linear_trial_plain(*modes_k13_args(p, Bw, f32, nA))
            torch.cuda.synchronize()
            e["flags_equal"] &= bool(torch.equal(got[4], ref[4]))
            for name, g64, r64, g32, r32, q32 in zip(TRIAL_OUT, got, ref,
                                                     got32, ref32, plain32):
                key = f"{name}_B{Bw}_{nA}alpha"
                e["e64"][key] = rel_err(g64, r64)
                e["e32"][key] = err1(g32, r32)
                e["p32"][key] = err1(q32, r32)
                e["abs32"] = max(e["abs32"], abs_err(g32, r32))
    emit("modes_check", kernel="linear_trial", family=p["fam"], sizes=sizes,
         alphas=alphas, tol_f64=1e-9, tol_f32=MODES_F32_TOL, card=card, **e)
    if max(e["e64"].values()) > 1e-9 or not e["flags_equal"]:
        fail(f"K13 ({p['fam']}) disagrees with its twin in float64: "
             f"{e['e64']}, flags equal {e['flags_equal']}")
    if max(e["e32"].values()) > MODES_F32_TOL:
        fail(f"K13 ({p['fam']}) disagrees with its twin in float32: "
             f"{e['e32']}")
    return e


def modes_k12_times(p, sv, sizes, serving_B, k1_solver):
    """K12's float32 times at `sizes` (B_LARGE and beyond: 3 reps) beside
    K1's Tassa form with the gain solve `k1_solver` in the same call, with
    bytes, FLOPs and the bound at the FP64 tensor-core rate; the plain
    twin at B=1 and `serving_B`; `torch.linalg.solve` on the scan's stack
    of (I + C₁J₂) systems and the phases (profiler) at those two B; the
    shared memory and blocks an SM of each phase."""
    import torch

    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    f64, f32 = torch.float64, torch.float32
    ocp, rows, mu, nt = p["ocp"], p["s"].rows, p["s"].opts.mu0, p["nt"]
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    n_comb = sum(len(st) for st in k12.scan_plan(ns)[0])
    row_sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
                 len(rows.bx), len(rows.uc))
    t = dict(launches_per_sweep=k12.launches_per_sweep(ns), combines=n_comb,
             k1_tassa_quu_solver=k1_solver,
             occupancy_f32=k12.occupancy(nx, nu, nt, rows, sv, f32),
             occupancy_f64=k12.occupancy(nx, nu, nt, rows, sv, f64), by_B={})
    k12_layout_gate(k1.kernel_shape(nx, nu, nt, rows), sv, t)
    for Bw in sizes:
        a32 = modes_k12_args(p, Bw, f32)
        reps = 10 if Bw < B_LARGE else 3
        ms12 = cuda_ms(lambda: k12.riccati_associative(*a32, mu, rows, sv),
                       reps=reps)
        ms1 = cuda_ms(lambda: k1.riccati_backward(
            *a32, mu, rows, form="tassa", quu_solver=k1_solver), reps=reps)
        out = k12.riccati_associative(*a32, mu, rows, sv)
        nb = nbytes(*a32, rows.packed(a32[0].device), *out)
        fl = k12_flops(Bw, ns, nx, nu, nt, *row_sizes, sv, n_comb)
        bms, by = bound(nb, fl, H100_FP64_TC_FLOP_PER_S)
        t["by_B"][Bw] = dict(ms=ms12, k1_tassa_ms=ms1, bytes=nb, flop=fl,
                             bound_ms=bms, bound_by=by)
    for Bw in (1, serving_B):
        a32 = modes_k12_args(p, Bw, f32)
        t["by_B"][Bw]["plain_ms"] = cuda_ms(
            lambda: k12.riccati_associative_plain(*a32, mu, rows, sv),
            reps=2, warmup=1)
    systems = []
    solve_fn = torch.linalg.solve
    torch.linalg.solve = lambda A, b: systems.append((A, b)) or solve_fn(A, b)
    try:
        k12.riccati_associative_plain(*modes_k12_args(p, serving_B, f64), mu,
                                      rows, sv)
    finally:
        torch.linalg.solve = solve_fn
    A = torch.cat([a for a, _ in systems]).contiguous()
    b = torch.cat([r for _, r in systems]).contiguous()
    del systems
    t["linalg_solve_stack"] = list(A.shape) + [b.shape[-1]]
    t["linalg_solve_ms_f64"] = cuda_ms(lambda: torch.linalg.solve(A, b),
                                       reps=5)
    del A, b
    t["phases"] = {str(Bw): k12_phase_ms(
        lambda: k12.riccati_associative(*modes_k12_args(p, Bw, f32), mu,
                                        rows, sv)) for Bw in (1, serving_B)}
    return t


def k12_layout_gate(shape, sv, t):
    """Fails unless the card's shared memory a block of each K12 phase is
    what `riccati_associative.phase_bytes` states for `shape` and the gain
    solve `sv`, and the combine runs COMBINE_BLOCKS_PER_SM blocks an SM (at
    every nx: the launch bound asks it of nx = 37). Records the stated
    bytes in `t`."""
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    t["phase_bytes"] = k12.phase_bytes(shape, sv)
    for occ in (t["occupancy_f32"], t["occupancy_f64"]):
        got = {p: occ[f"{p}_shared_memory_bytes"] for p in t["phase_bytes"]}
        if got != t["phase_bytes"]:
            fail(f"K12 at ({shape}, {sv}): shared memory a block {got} on "
                 f"the card, {t['phase_bytes']} stated by the wrapper")
        if occ["combine_blocks_per_sm"] < k12.COMBINE_BLOCKS_PER_SM:
            fail(f"K12's combine at ({shape}, {sv}) runs "
                 f"{occ['combine_blocks_per_sm']} blocks an SM, not "
                 f"{k12.COMBINE_BLOCKS_PER_SM}: {occ}")


def modes_k13_times(p, nA, sizes, serving_B):
    """K13's float32 times at `sizes` with `nA` step sizes, bytes (the
    family's parameter tensors included), FLOPs (the family's trial plus
    the recursion) and the bound; the plain twin at B=1 and `serving_B`;
    the kernel's occupancy."""
    import torch

    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10

    from srbd_horizon_tpu_torch.kernels import build

    f32 = torch.float32
    ocp, s, rows, fam = p["ocp"], p["s"], p["s"].rows, p["fam"]
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    t = dict(occupancy_f32=k13.occupancy(fam, f32, ns, nA),
             phase_bytes=k13.phase_bytes(fam, f32, ns, nA),
             ptxas=k13_ptxas(build.log_path("linear_trial").read_text())
             .get(fam), by_B={})
    k13_layout_gate(fam, t)
    for Bw in sizes:
        a32 = modes_k13_args(p, Bw, f32, nA)
        ms13 = cuda_ms(lambda: k13.linear_trial(*a32), reps=20)
        out = k13.linear_trial(*a32)
        ins = [x for x in a32[:14] if isinstance(x, torch.Tensor)]
        dev = a32[0].device
        if s.terms.family == "srbd":
            # every stage of the step evaluates the rates at its point
            stages = {"EULER": 1, "RK2": 2, "RK4": 4}[s.terms.step]
            pt = k4.kernel_params(a32[9], Bw, ns, s.terms.nc, f32, dev)
            fam_fl = stages * trial_flops(Bw, ns, nx, nu, s.terms.nc,
                                          s.terms.n_rho, nA)
        elif s.terms.family == "lip":
            # the RK stages, ~4 FLOPs a row a later stage
            stages = {"EULER": 1, "RK2": 2, "RK4": 4}[s.terms.step]
            pt = k10.kernel_params(a32[9], Bw, ns, s.terms.nc, f32, dev)
            fam_fl = (lip_trial_flops(Bw, ns, nx, nu, s.terms.n_rho, nA)
                      + (stages - 1) * 4 * nx * ns * Bw * nA)
        else:
            pt = k5.kernel_params(a32[9], Bw, ns, s.terms, f32, dev)
            fam_fl = isrbd_trial_flops(Bw, ns, nx, nu, s.terms.outer.nc,
                                       s.terms.n_rho, s.terms.n_term, nA)
        nb = nbytes(*ins, *pt, rows.packed(dev), *out)
        fl = k13_flops(fam_fl, Bw, ns, nx, len(rows.rx), len(rows.ru),
                       len(rows.uc), nA)
        bms, by = bound(nb, fl, H100_FP64_TC_FLOP_PER_S)
        t["by_B"][Bw] = dict(ms=ms13, bytes=nb, flop=fl, bound_ms=bms,
                             bound_by=by)
    for Bw in (1, serving_B):
        a32 = modes_k13_args(p, Bw, f32, nA)
        t["by_B"][Bw]["plain_ms"] = cuda_ms(
            lambda: k13.linear_trial_plain(*a32), reps=2, warmup=1)
        # the chain alone, and the evaluation as the rest of the call
        t["by_B"][Bw]["chain_ms"] = cuda_ms(
            lambda: k13.linear_trial_chain(*a32), reps=20)
        t["by_B"][Bw]["evaluation_ms"] = \
            t["by_B"][Bw]["ms"] - t["by_B"][Bw]["chain_ms"]
    a32 = modes_k13_args(p, 1, f32, nA)
    t["host_us"] = host_us(lambda: k13.linear_trial(*a32))
    return t


def k13_layout_gate(fam, t):
    """Fails unless the card's shared memory a K13 block takes is what
    `linear_trial.phase_bytes` states for the family (the .cu's `Smem`)."""
    if t["occupancy_f32"]["shared_memory_bytes"] != t["phase_bytes"]["total"]:
        fail(f"K13 at {fam}: {t['occupancy_f32']['shared_memory_bytes']} B "
             f"of shared memory a block on the card, "
             f"{t['phase_bytes']['total']} stated by the wrapper")


def modes_k12_row(name, t, err, launches, serving_B, **extra):
    """A K12 row of the `kernels` line: B=1 times, the serving B's bound,
    plain and `torch.linalg.solve` figures, K1-Tassa's times beside."""
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    b1, bs = t["by_B"][1], t["by_B"][serving_B]
    return dict(kernel_row(
        name, k12, launches, b1["ms"], b1["plain_ms"], b1["bound_ms"],
        b1["bound_by"], err, MODES_F32_TOL, B=1,
        kernel_launches_per_sweep=t["launches_per_sweep"],
        ms_by_B={str(b): v["ms"] for b, v in t["by_B"].items()},
        k1_tassa_ms_by_B={str(b): v["k1_tassa_ms"]
                          for b, v in t["by_B"].items()},
        k1_tassa_quu_solver=t["k1_tassa_quu_solver"],
        bound_ms_serving_B=bs["bound_ms"], plain_ms_serving_B=bs["plain_ms"],
        torch_linalg_solve_ms_f64_serving_B=t["linalg_solve_ms_f64"],
        torch_linalg_solve_stack=t["linalg_solve_stack"],
        phase_ms_by_B=t["phases"], phase_bytes=t["phase_bytes"],
        **t["occupancy_f32"], **extra), tol_f64=K12_F64_TOL)


def modes_k13_row(name, t1, t4, err, launches, serving_B, **extra):
    """A K13 row of the `kernels` line: one α at B=1, four α beside."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13

    b1, bs = t1["by_B"][1], t1["by_B"][serving_B]
    return kernel_row(
        name, k13, launches, b1["ms"], b1["plain_ms"], b1["bound_ms"],
        b1["bound_by"], err, MODES_F32_TOL, B=1, alphas=1,
        ms_by_B={str(b): v["ms"] for b, v in t1["by_B"].items()},
        ms_4alpha_by_B={str(b): v["ms"] for b, v in t4["by_B"].items()},
        bound_ms_serving_B=bs["bound_ms"], plain_ms_serving_B=bs["plain_ms"],
        chain_ms_by_B={str(b): t1["by_B"][b]["chain_ms"]
                       for b in (1, serving_B)},
        evaluation_ms_by_B={str(b): t1["by_B"][b]["evaluation_ms"]
                            for b in (1, serving_B)},
        host_us=t1["host_us"], ptxas=t1["ptxas"],
        phase_bytes_4alpha=t4["phase_bytes"],
        blocks_per_sm_4alpha=t4["occupancy_f32"]["blocks_per_sm"],
        **t1["occupancy_f32"], **extra)


def modes_section(card, dev, sms):
    """Phase 13: the JAX package's other execution modes on the port —
    `riccati_mode="associative"` (K12, csrc/riccati_associative.cu) and
    `forward_pass="linear"` (K13, csrc/linear_trial.cu). `modes_check`: K12
    (SRBD and LIP shapes × block-Schur and Cholesky gain solves) and K13
    (SRBD and LIP, 1 and 4 α) against their twins at B = 1, 8, 512 in
    float64 and float32 on iterates drawn as tests/test_parallel_riccati.py
    draws them (X ± 0.05·N, U 0.1·N) and linearized by K4 / K10;
    `modes_times`: their times at B = 1, 8, 512 and 4096 (a probe), K1's
    Tassa form at the same B in the same call (the A/B of ROADMAP item
    19a), torch.linalg.solve on the scan's stack of (I + C₁J₂) systems,
    bounds, shared memory, blocks an SM; the paths: `modes_single_path`
    (the dsrbd example, 40 ticks under associative/nonlinear, 40 under
    associative/linear, 10 more with Cholesky gains), `modes_lip_path` (the
    dlip example, 40 ticks under associative/linear, 10 with Cholesky) and
    `modes_fleet_path` (tools/bench_modes.py's configuration at B=512
    under associative/linear, B=4096 a probe), each with its launches,
    host reads, profile and the plain-twin spy (0 on the card); and
    `modes_card_vs_cpu` (single SRBD 5 ticks, fleet B=8 3 ticks, float64:
    iterations equal, plans to 1e-9). Returns the kernel rows."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
    from srbd_horizon_tpu_torch.kernels import rollout as k3
    from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
    from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.runtime.loop import (
        MPCLoop,
        TickInput,
        build_lip_loop,
        walk_command,
        walking_schedule,
    )
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP
    from srbd_horizon_tpu_torch.solvers.options import ddp_example_options
    from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator

    t_section = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    feet = kangaroo_line_feet()
    fams = ("srbd", "lip")
    solvers = ("schur", "cholesky")
    builders = {"srbd": build_srbd_problem, "lip": build_lip_problem}
    linearizers = {"srbd": (k4.srbd_linearize, k4.srbd_linearize_plain),
                   "lip": (k10.lip_linearize, k10.lip_linearize_plain)}

    # ---- the drawn points: K4 / K10 on the card, float64 ----
    pts = {}
    for i, fam in enumerate(fams):
        prob = builders[fam](SRBDConfig(dtype=f64), feet, device=dev)
        s64 = MSDDP(prob.ocp, DDPOptions())
        s32 = MSDDP(builders[fam](SRBDConfig(), feet, device=dev).ocp,
                    DDPOptions())
        ocp = prob.ocp
        ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
        Bm = max(MODES_SIZES)
        g = np.random.RandomState(SEED + 13 + i)
        X = torch.as_tensor(prob.initial_state.cpu().numpy()[None, None]
                            + 0.05 * g.randn(Bm, ns + 1, nx), device=dev)
        U = torch.as_tensor(0.1 * g.randn(Bm, ns, nu), device=dev)
        params = {k: v.expand((Bm,) + tuple(v.shape)).contiguous()
                  for k, v in ocp.params.items()}
        lin = linearizers[fam][0](X, U, params, s64.terms, s64.rows, ocp.dt,
                                  s64._wc(f64))
        ks, Ks, dV1, dV2 = k12.riccati_associative_plain(
            *(lin[k] for k in ORDER), s64.opts.mu0, s64.rows)
        x0 = X[:, 0] + torch.as_tensor(0.005 * g.randn(Bm, nx), device=dev)
        D = torch.sum(lin["d"] ** 2, dim=(1, 2))
        merit0 = s64.total_cost(X, U, params) + s64.opts.defect_weight * D
        pts[fam] = dict(s=s64, s32=s32, ocp=ocp, lin=lin, X=X, U=U, x0=x0,
                        params=params, gains=(ks, Ks, dV1, dV2), D=D,
                        merit0=merit0, nt=lin["Jt"].shape[1], fam=fam)

    # ---- modes_check: K12 and K13 against their twins ----
    errs = {}
    for fam in fams:
        for sv in solvers:
            errs["k12", fam, sv] = modes_k12_check(pts[fam], sv, MODES_SIZES,
                                                   card)
        errs["k13", fam] = modes_k13_check(pts[fam], MODES_SIZES, card)

    # ---- modes_times: K12 beside K1's Tassa form, K13; float32 ----
    times = {}
    probe = tuple(MODES_SIZES) + (B_LARGE,)
    Bs = max(MODES_SIZES)
    for fam in fams:
        for sv in solvers:
            times["k12", fam, sv] = modes_k12_times(pts[fam], sv, probe, Bs, sv)
        for nA in (1, 4):
            times["k13", fam, nA] = modes_k13_times(pts[fam], nA, probe, Bs)
    emit("modes_times", card=card, dtype="float32",
         rate="FP64 tensor cores, 67 TFLOP/s (both compute in float64)",
         **{"_".join(map(str, k)): v for k, v in times.items()})
    emit("k12_vs_k1_tassa", card=card, dtype="float32",
         **{f"{fam}_{sv}": {str(Bw): dict(
             riccati_associative_ms=times["k12", fam, sv]["by_B"][Bw]["ms"],
             riccati_backward_tassa_ms=times["k12", fam, sv]["by_B"][Bw][
                 "k1_tassa_ms"]) for Bw in probe}
            for fam in fams for sv in solvers})

    # ---- the paths ----
    TWINS = ((k12, ("riccati_associative_plain",)),
             (k13, ("linear_trial_plain",)),
             (k1, ("riccati_backward_plain",)),
             (k3, ("srbd_trial_plain", "srbd_evaluate_plain")),
             (k4, ("srbd_linearize_plain",)),
             (k11, ("lip_trial_plain", "lip_evaluate_plain")),
             (k10, ("lip_linearize_plain",)))
    k12_inst = {key: i for i, key in enumerate(k12.KERNEL_INSTANCES)}

    def reset_counts():
        k12.riccati_associative.launches = 0
        k12.riccati_associative.instance_launches[:] = [0] * len(k12.KERNEL_INSTANCES)
        k13.linear_trial.launches = 0
        k1.riccati_backward.launches = 0
        for fn in (k3.srbd_trial, k3.srbd_evaluate, k4.srbd_linearize,
                   k11.lip_trial, k11.lip_evaluate, k10.lip_linearize):
            fn.launches = 0

    def read_counts(fam):
        lin_fn, trial_fn, ev_fn = ((k4.srbd_linearize, k3.srbd_trial,
                                    k3.srbd_evaluate) if fam == "srbd" else
                                   (k10.lip_linearize, k11.lip_trial,
                                    k11.lip_evaluate))
        il = k12.riccati_associative.instance_launches
        return {"linearize": lin_fn.launches,
                "riccati_associative": il[k12_inst[fam, "schur"]],
                "riccati_associative_cholesky": il[k12_inst[fam, "cholesky"]],
                "riccati_backward": k1.riccati_backward.launches,
                "linear_trial": k13.linear_trial.launches,
                "rollout_trial": trial_fn.launches,
                "evaluate": ev_fn.launches}

    def hand(L, ns_):
        """Hand-written kernel launches: K12 sweeps count their kernels."""
        return (L["linearize"] + L["riccati_backward"] + L["linear_trial"]
                + L["rollout_trial"] + L["evaluate"]
                + k12.launches_per_sweep(ns_) * (
                    L["riccati_associative"] + L["riccati_associative_cholesky"]))

    def modes_opts(base, forward, solver="schur", **kw):
        return dataclasses.replace(base, riccati_mode="associative",
                                   forward_pass=forward, quu_solver=solver, **kw)

    def srbd_single_loop(dtype, device, forward, solver="schur"):
        """The dsrbd example's loop (`MPCLoop.tick` on `MSDDP.solve`,
        ddp_example_options, the WPG at the feet's height, no shift) under
        the associative sweep."""
        prob = build_srbd_problem(SRBDConfig(dtype=dtype), feet, dtype=dtype,
                                  device=device)
        wpg = WalkingPatternGenerator.build(
            c_init_z=float(prob.initial_foot_position[0, 2]),
            nodes=prob.ocp.ns, dtype=dtype, device=device)
        return MPCLoop(solver=MSDDP(prob.ocp, modes_opts(
            ddp_example_options(), forward, solver)), wpg=wpg,
            srbd_constants=prob.ocp.constants), prob

    def lip_single_loop(dtype, device, forward, solver="schur"):
        return build_lip_loop(SRBDConfig(dtype=dtype), modes_opts(
            DDPOptions(max_iters=100, alpha_converge_threshold=1e-12,
                       beta=1e-3), forward, solver), device=device)

    def drive(loop, prob, sched):
        """Ticks over `sched` from the cold carry at the nominal state:
        the carry, the outputs, tick ms (a device sync each), host reads,
        trials."""
        trials = {"n": 0}
        trial = loop.solver._trial

        def counted_trial(*a):
            trials["n"] += 1
            return trial(*a)

        loop.solver._trial = counted_trial
        carry = loop.init(prob.initial_state)
        syncs0 = loop.solver.host_syncs
        outs, tms = [], []
        for i in range(sched.action.shape[0]):
            inp = TickInput(*(a[i] for a in sched))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, out = loop.tick(carry, inp)
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        loop.solver._trial = trial
        return carry, outs, tms, loop.solver.host_syncs - syncs0, trials["n"]

    def single_path(fam, runs, tag, gates):
        """Each run (name, loop builder args, schedule) in turn, with the
        counts reset before the first and read after the last; a profile
        of 2 ticks of each run's loop."""
        func_calls, restore_func = count_torch_func()
        plain_calls, restore_plain = count_plain_cost()
        twin_calls, restore_twins = count_calls(TWINS)
        reset_counts()
        res, loops = {}, {}
        all_outs, all_trials, iters_total = [], 0, 0
        try:
            for name, build, sched in runs:
                loop, prob = build()
                carry, outs, tms, syncs, trials = drive(loop, prob, sched)
                iters = [int(o.iterations) for o in outs]
                all_outs += outs
                all_trials += trials
                iters_total += sum(iters)
                loops[name] = (loop, carry, sched)
                res[name] = dict(
                    ticks=len(outs), tick_p50_ms=statistics.median(tms),
                    tick_max_ms=max(tms), tick_mean_ms=statistics.fmean(tms),
                    iterations_per_tick=iters,
                    iterations_mean=statistics.fmean(iters),
                    syncs_per_tick=syncs / len(outs),
                    syncs_per_iteration=syncs / max(1, sum(iters)),
                    trials=trials,
                    defect_norm_max=max(float(o.defect_norm) for o in outs),
                    converged_ticks=sum(bool(o.converged) for o in outs))
                if fam == "srbd":
                    res[name]["srbd_residual_max"] = max(
                        float(o.srbd_residual.abs().max()) for o in outs)
            launches = read_counts(fam)
        finally:
            for restore in (restore_func, restore_plain, restore_twins):
                restore()
        ns_ = next(iter(loops.values()))[0].solver.ocp.ns
        n_ticks = len(all_outs)
        com_z = [float(o.x[2]) for o in all_outs]
        out = dict(
            B=1, dtype="float32", runs=res, launches=launches,
            hand_written_kernel_launches_per_tick=hand(launches, ns_) / n_ticks,
            k12_kernel_launches_per_sweep=k12.launches_per_sweep(ns_),
            iterations=iters_total, trials=all_trials,
            defect_norm_max=max(float(o.defect_norm) for o in all_outs),
            finite=all(bool(torch.isfinite(v).all()) for o in all_outs
                       for v in (o.x, o.u0, o.cost)),
            plain_twin_calls=twin_calls["n"], torch_func_calls=func_calls["n"],
            plain_cost_or_defect_calls=plain_calls["n"],
            com_z_min=min(com_z), com_z_max=max(com_z), card=card)
        for name, (loop, carry, sched) in loops.items():
            step = lambda c, _l=loop, _s=sched: _l.tick(
                c, TickInput(*(a[-1] for a in _s)))[0]
            carry, spans = tick_spans(loop.solver, step, carry, ticks=5)
            res[name]["spans"] = spans
            res[name]["profile"] = profile_ticks(loop.solver, step, carry,
                                                 res[name]["tick_p50_ms"])
        emit(tag, **out)
        gates(out, all_outs)
        return out

    def common_gates(tag, out, all_outs, linear_trials):
        L = out["launches"]
        if not out["finite"]:
            fail(f"{tag} produced non-finite values")
        if out["defect_norm_max"] > 1e-4:
            fail(f"{tag}: plans are not dynamically consistent (defect above "
                 "1e-4)")
        if out["plain_twin_calls"] or out["torch_func_calls"] \
                or out["plain_cost_or_defect_calls"]:
            fail(f"{tag} ran plain twins on the card: {out['plain_twin_calls']} "
                 f"kernel twins, {out['plain_cost_or_defect_calls']} plain cost "
                 f"or defect calls, {out['torch_func_calls']} torch.func")
        if not (L["linearize"] == out["iterations"]
                == L["riccati_associative"] + L["riccati_associative_cholesky"]):
            fail(f"{tag}: K4/K10 and K12 launches differ from the iterations: "
                 f"{L}, {out['iterations']} iterations")
        if L["riccati_backward"]:
            fail(f"{tag}: K1 ran under riccati_mode='associative': {L}")
        if L["linear_trial"] != linear_trials or \
                L["linear_trial"] + L["rollout_trial"] != out["trials"]:
            fail(f"{tag}: K13/K3 launches do not cover the trials: {L}, "
                 f"{out['trials']} trials")
        if min(L["linearize"], L["riccati_associative"],
               L["riccati_associative_cholesky"], L["linear_trial"],
               L["evaluate"]) == 0:
            fail(f"{tag}: a kernel of the path was not launched: {L}")

    # modes_single_path: the dsrbd example's walk under associative/nonlinear
    # and associative/linear (40 ticks each), then 10 Cholesky ticks
    walk40 = walking_schedule(40, vx=0.3, start=10, device=dev)
    walk10 = walking_schedule(10, vx=0.3, start=3, device=dev)
    srbd_runs = [
        ("associative_nonlinear",
         lambda: srbd_single_loop(f32, dev, "nonlinear"), walk40),
        ("associative_linear", lambda: srbd_single_loop(f32, dev, "linear"),
         walk40),
        ("associative_linear_cholesky",
         lambda: srbd_single_loop(f32, dev, "linear", "cholesky"), walk10)]

    def srbd_gates(out, outs):
        lin_trials = sum(r["trials"] for n, r in out["runs"].items()
                         if "linear" in n and "nonlinear" not in n)
        common_gates("modes_single_path", out, outs, lin_trials)
        if max(r["srbd_residual_max"] for r in out["runs"].values()) > 1e-4:
            fail("modes_single_path: Newton-Euler residual above 1e-4")
        if out["launches"]["evaluate"] != 2 * len(outs):
            fail(f"modes_single_path: srbd_evaluate launches are not two a "
                 f"solve: {out['launches']}")

    sp = single_path("srbd", srbd_runs, "modes_single_path", srbd_gates)

    # modes_lip_path: the dlip example under associative/linear, 40 ticks,
    # then 10 with Cholesky gains
    lip_runs = [
        ("associative_linear", lambda: lip_single_loop(f32, dev, "linear"),
         walk40),
        ("associative_linear_cholesky",
         lambda: lip_single_loop(f32, dev, "linear", "cholesky"), walk10)]

    def lip_gates(out, outs):
        common_gates("modes_lip_path", out, outs, out["trials"])
        if max(abs(out["com_z_min"] - LIP_HEIGHT),
               abs(out["com_z_max"] - LIP_HEIGHT)) >= 0.08:
            fail(f"modes_lip_path: the CoM height left 0.88 ± 0.08: "
                 f"{out['com_z_min']}, {out['com_z_max']}")
        if out["launches"]["evaluate"] != 2 * len(outs):
            fail(f"modes_lip_path: lip_evaluate launches are not two a solve: "
                 f"{out['launches']}")

    lp = single_path("lip", lip_runs, "modes_lip_path", lip_gates)

    # modes_fleet_path: tools/bench_modes.py's configuration on tick_batch
    def fleet_loop(Bsz, dtype, device, push=0.0, seed=SEED):
        prob = build_srbd_problem(SRBDConfig(dtype=dtype), feet, dtype=dtype,
                                  device=device)
        opts = DDPOptions(max_iters=5, alpha_converge_threshold=1e-12,
                          beta=1e-3, riccati_mode="associative",
                          forward_pass="linear", parallel_line_search_width=4)
        wpg = WalkingPatternGenerator.build(0.0, prob.ocp.ns, dtype=dtype,
                                            device=device)
        loop = MPCLoop(solver=MSDDP(prob.ocp, opts), wpg=wpg,
                       srbd_constants=prob.ocp.constants)
        g = np.random.RandomState(seed)
        xn = prob.initial_state.cpu().numpy()
        x0 = torch.as_tensor(xn[None] + push * g.randn(Bsz, xn.shape[0]),
                             dtype=dtype, device=device)
        return loop, loop.init(x0), walk_command(Bsz, vx=0.2, dtype=dtype,
                                                 device=device)

    def run_fleet(Bsz, warm, timed):
        loop, carry, inp = fleet_loop(Bsz, f32, dev)
        counts = {"trials": 0, "solves": 0}
        trial, solve = loop.solver._trial, loop.solver.solve_batch

        def counted_trial(*a):
            counts["trials"] += 1
            return trial(*a)

        def counted_solve(*a):
            counts["solves"] += 1
            return solve(*a)

        loop.solver._trial, loop.solver.solve_batch = counted_trial, counted_solve
        for _ in range(warm):
            carry, _ = loop.tick_batch(carry, inp)
        torch.cuda.synchronize()
        counts.update(trials=0, solves=0)
        func_calls, restore_func = count_torch_func()
        plain_calls, restore_plain = count_plain_cost()
        twin_calls, restore_twins = count_calls(TWINS)
        reset_counts()
        syncs0 = loop.solver.host_syncs
        tms, iters, outs = [], [], []
        try:
            for _ in range(timed):
                t0 = time.perf_counter()
                carry, out = loop.tick_batch(carry, inp)
                torch.cuda.synchronize()
                tms.append((time.perf_counter() - t0) * 1e3)
                iters.append(int(out.iterations.sum()))
                outs.append(out)
            L = read_counts("srbd")
        finally:
            for restore in (restore_func, restore_plain, restore_twins):
                restore()
            loop.solver._trial, loop.solver.solve_batch = trial, solve
        res = dict(
            B=Bsz, dtype="float32",
            options="tools/bench_modes.py: max_iters=5, "
                    "parallel_line_search_width=4, alpha_converge_threshold="
                    "1e-12, beta=1e-3, associative/linear, rdot_ref (0.2, 0, "
                    "0), no shift",
            warmup_ticks=warm, ticks=timed,
            tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
            tick_mean_ms=statistics.fmean(tms),
            members_per_s=Bsz / statistics.median(tms) * 1e3,
            iters_mean=statistics.fmean(i / Bsz for i in iters),
            syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
            trials=counts["trials"], solves=counts["solves"], launches=L,
            hand_written_kernel_launches_per_tick=hand(
                L, loop.solver.ocp.ns) / timed,
            finite=all(bool(torch.isfinite(v).all()) for o in outs
                       for v in (o.x, o.u0, o.cost))
            and bool(torch.isfinite(carry.sol.X).all()),
            defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
            srbd_residual_max=max(float(o.srbd_residual.abs().max())
                                  for o in outs),
            plain_twin_calls=twin_calls["n"], torch_func_calls=func_calls["n"],
            plain_cost_or_defect_calls=plain_calls["n"], card=card)
        return res, loop, carry, inp

    fp, floop, fcarry, finp = run_fleet(B_MAIN, warm=3, timed=20)
    fstep = lambda c: floop.tick_batch(c, finp)[0]
    fcarry, fp["spans"] = tick_spans(floop.solver, fstep, fcarry, ticks=5)
    fp["profile"] = profile_ticks(floop.solver, fstep, fcarry, fp["tick_p50_ms"])
    emit("modes_fleet_path", **fp)
    FL = fp["launches"]
    if not fp["finite"]:
        fail("modes_fleet_path produced non-finite values")
    if max(fp["defect_norm_max"], fp["srbd_residual_max"]) > 1e-4:
        fail("modes_fleet_path: plans are not dynamically consistent")
    if fp["plain_twin_calls"] or fp["torch_func_calls"] \
            or fp["plain_cost_or_defect_calls"]:
        fail(f"modes_fleet_path ran plain twins on the card: "
             f"{fp['plain_twin_calls']} kernel twins, "
             f"{fp['plain_cost_or_defect_calls']} plain cost or defect calls, "
             f"{fp['torch_func_calls']} torch.func transforms")
    if min(FL["linearize"], FL["riccati_associative"], FL["linear_trial"],
           FL["evaluate"]) == 0 or FL["riccati_backward"] or FL["rollout_trial"]:
        fail(f"modes_fleet_path: the kernels launched are not the modes': {FL}")
    if not (FL["linearize"] == FL["riccati_associative"]) \
            or FL["linear_trial"] != fp["trials"] \
            or FL["evaluate"] != 2 * fp["solves"]:
        fail(f"modes_fleet_path: launches do not match the iterations, trials "
             f"and solves: {FL}, {fp['trials']} trials, {fp['solves']} solves")
    large, *_ = run_fleet(B_LARGE, warm=1, timed=2)
    emit("modes_fleet_path_large", **large)
    if not large["finite"]:
        fail("modes_fleet_path at B=4096 produced non-finite values")

    # ---- modes_card_vs_cpu: float64, single SRBD 5 ticks, fleet B=8 3 ticks ----
    def single_ticks(device, n):
        loop, prob = srbd_single_loop(f64, device, "linear")
        sch = walking_schedule(n, vx=0.3, start=3, dtype=f64, device=device)
        carry = loop.init(prob.initial_state)
        outs = []
        for i in range(n):
            carry, out = loop.tick(carry, TickInput(*(a[i] for a in sch)))
            outs.append(out)
        return carry, outs

    def fleet_ticks(device):
        loop, carry, inp = fleet_loop(8, f64, device, push=0.005)
        outs = []
        for _ in range(3):
            carry, out = loop.tick_batch(carry, inp)
            outs.append(out)
        return carry, outs

    def versus(card_run, cpu_run):
        (cc, oc), (cp, op) = card_run, cpu_run
        it = lambda o: o.iterations.reshape(-1).tolist()
        both = lambda f: (torch.stack([getattr(a, f).cpu() for a in oc]),
                          torch.stack([getattr(b, f) for b in op]))
        res = dict(
            iterations_equal=all(it(a) == it(b) for a, b in zip(oc, op)),
            converged_equal=all(torch.equal(a.converged.cpu(), b.converged)
                                for a, b in zip(oc, op)),
            iterations_card=[it(a) for a in oc],
            cost_rel_err=rel_err(*both("cost")), x_rel_err=rel_err(*both("x")),
            u0_rel_err=rel_err(*both("u0")),
            X_rel_err=rel_err(cc.sol.X.cpu(), cp.sol.X),
            U_rel_err=rel_err(cc.sol.U.cpu(), cp.sol.U))
        res["ok"] = (res["iterations_equal"] and res["converged_equal"]
                     and max(res["cost_rel_err"], res["x_rel_err"],
                             res["u0_rel_err"], res["X_rel_err"],
                             res["U_rel_err"]) <= 1e-9)
        return res

    cvc = dict(tol=1e-9, modes="associative/linear",
               single=dict(B=1, ticks=5, walk="vx 0.3 from tick 3",
                           **versus(single_ticks(dev, 5), single_ticks("cpu", 5))),
               fleet=dict(B=8, ticks=3, push="0.005·N(0,1), seed 0",
                          **versus(fleet_ticks(dev), fleet_ticks("cpu"))))
    emit("modes_card_vs_cpu", **cvc)
    if not (cvc["single"]["ok"] and cvc["fleet"]["ok"]):
        fail("the modes' card path and CPU path disagree")

    # ---- the kernel rows ----
    L1, L2 = sp["launches"], lp["launches"]
    rows_out = []
    for fam, sv, name in (("srbd", "schur", "riccati_associative"),
                          ("srbd", "cholesky", "riccati_associative_cholesky"),
                          ("lip", "schur", "riccati_associative_lip"),
                          ("lip", "cholesky",
                           "riccati_associative_lip_cholesky")):
        key = "riccati_associative" + ("_cholesky" if sv == "cholesky" else "")
        path_l = (L1 if fam == "srbd" else L2)[key]
        fleet_l = FL[key] if fam == "srbd" else 0
        rows_out.append(modes_k12_row(
            name, times["k12", fam, sv], errs["k12", fam, sv],
            path_l + fleet_l, Bs, quu_solver=sv, shape=fam,
            launches_single_path=path_l, launches_fleet_path=fleet_l))
    for fam, name in (("srbd", "linear_trial"), ("lip", "linear_trial_lip")):
        path_l = (L1 if fam == "srbd" else L2)["linear_trial"]
        fleet_l = FL["linear_trial"] if fam == "srbd" else 0
        rows_out.append(modes_k13_row(
            name, times["k13", fam, 1], times["k13", fam, 4],
            errs["k13", fam], path_l + fleet_l, Bs, family=fam,
            launches_single_path=path_l, launches_fleet_path=fleet_l))
    emit("modes_section", seconds=time.perf_counter() - t_section, card=card)
    return rows_out



# ---------------- the execution modes at the other shapes (phase 13) ----------

# K12's instantiations and K13's families past the SRBD and LIP ones, and the
# sizes they are checked and timed at (B = 1, 8 and the path's serving B)
MODES_NEW_K12 = (("quadruped", "schur"), ("quadruped", "cholesky"),
                 ("isrbd_al", "cholesky"), ("isrbd_al_quadruped", "cholesky"))
MODES_NEW_K13 = ("quadruped", "isrbd_al", "isrbd_al_quadruped")
MODES_SHAPE_SIZES = {"quadruped": (1, 8, B_MAIN),
                     "isrbd_al": (1, 8, B_CONSTRAINED),
                     "isrbd_al_quadruped": (1, 8, B_CONSTRAINED)}
MODES_QUAD_VX = 0.25            # the quadruped example's trot command
MODES_AL_TICKS = 20             # the isrbd example's online ticks


def modes_shapes_section(card, dev, sms):
    """Phase 13, continued: K12 and K13 at the point-feet quadruped's SRBD
    shape and at the two isrbd-AL shapes (the AL solver's inner problem),
    and the paths that reach them under the modes. `modes_check`: K12
    (quadruped × both gain solves; the AL shapes × Cholesky) and K13 (the
    three families, 1 and 4 α) against their twins
    at B = 1, 8 and the serving B (512; 256 at the AL shapes) on iterates
    drawn as in phase 13 (quadruped, K4) and on drawn AL points with active
    cones and boxes and per-member penalties (`draw_isrbd_point`, K5):
    float64 K12 to K12_F64_TOL, K13 to 1e-9, float32 to 1e-6 of the float64
    twin, K13's flags equal; `modes_times`: the same B in float32 beside
    K1-Tassa in the same call (`k12_vs_k1_tassa`), bounds, phases,
    occupancy, `torch.linalg.solve` on the scan's (I + C₁J₂) systems;
    the paths, at full width and ns=20: the quadruped trot (B=1, 40 ticks
    under associative/linear, 10 with Cholesky gains), the quadruped fleet
    (B=512, 3 + 20 ticks), the isrbd example's single constrained robot
    (offline `ALDDP.solve` and 20 `solve_online` ticks, under
    associative/linear and then associative/nonlinear, where K6 follows a
    K12 sweep), the constrained fleet at the round-5 serving point (B=256,
    1 + 60 + 20 ticks, `window_viol_max` < 1e-2) in float64, and in
    float32 with the violation reported (the JAX package's float32 fleet
    leaves the constraints under these modes), the constrained quadruped
    trot (B=1, offline solve and 40 ticks) and its fleet (B=256, 1 + 60 +
    20 ticks, `window_viol_max` < 1e-2); each gated as phase 13's paths
    (the quadruped trot also by phase 11's height band and progress);
    `modes_card_vs_cpu`:
    float64, the constrained single robot (offline
    solve and 3 ticks) and the AL fleet at B=8 (seed and 3 ticks),
    iterations equal, plans, multipliers and cost to 1e-9. Returns the
    seven kernel rows."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78
    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
    from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
    from srbd_horizon_tpu_torch.kernels import rollout as k3
    from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
    from srbd_horizon_tpu_torch.models.quadruped import (
        quadruped_point_feet,
        trot_group_mask,
    )
    from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.runtime.loop import (
        TickInput,
        build_quadruped_loop,
        walk_command,
        walking_schedule,
    )
    from srbd_horizon_tpu_torch.runtime.serving import constrained_tick
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP, ALOptions
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP
    from srbd_horizon_tpu_torch.solvers.options import al_serving_options
    from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator

    t_section = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    feet, quad = kangaroo_line_feet(), quadruped_point_feet()
    LINEAR = dict(riccati_mode="associative", forward_pass="linear")
    NONLINEAR = dict(riccati_mode="associative", forward_pass="nonlinear")
    quad_cfg = lambda dtype: SRBDConfig(dtype=dtype, **QUAD_TOPOLOGY)
    qal_cfg = lambda dtype: SRBDConfig(dtype=dtype,
                                       lip_height=float(quad.com[2]),
                                       **QUAD_TOPOLOGY)

    def al_solver(shape, dtype, device, ddp, al_opts, **kw):
        """The AL solver on the Kangaroo's isrbd problem or on the
        quadruped's (`kw`: build_isrbd_problem's options)."""
        if shape == "isrbd_al":
            prob = build_isrbd_problem(SRBDConfig(dtype=dtype), feet,
                                       device=device, **kw)
        else:
            prob = build_isrbd_problem(qal_cfg(dtype), quad, device=device,
                                       **kw)
        return prob, ALDDP(prob.ocp, ddp, al_opts)

    def serving(shape, dtype, device, max_iters, modes):
        """`al_serving_options(max_iters)` under `modes`, on the serving
        configurations: the Kangaroo's with cz stiffness 3200 (phase 6),
        the quadruped's as its example builds it (phase 12)."""
        d, a = al_serving_options(max_iters)
        kw = dict(cz_rho_weight=CZ_RHO_WEIGHT) if shape == "isrbd_al" else {}
        return al_solver(shape, dtype, device,
                         dataclasses.replace(d, **modes), a, **kw)

    # ---- the drawn points, float64 on the card ----
    pts = {}
    for i, shape in enumerate(MODES_NEW_K13):
        Bm = max(MODES_SHAPE_SIZES[shape])
        g = np.random.RandomState(SEED + 130 + i)
        if shape == "quadruped":
            prob = build_srbd_problem(quad_cfg(f64), quad, device=dev)
            s = MSDDP(prob.ocp, DDPOptions())
            s32 = MSDDP(build_srbd_problem(quad_cfg(f32), quad,
                                           device=dev).ocp, DDPOptions())
            ocp = prob.ocp
            ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
            X = torch.as_tensor(prob.initial_state.cpu().numpy()[None, None]
                                + 0.05 * g.randn(Bm, ns + 1, nx), device=dev)
            U = torch.as_tensor(0.1 * g.randn(Bm, ns, nu), device=dev)
            params = {k: v.expand((Bm,) + tuple(v.shape)).contiguous()
                      for k, v in ocp.params.items()}
            lin = k4.srbd_linearize(X, U, params, s.terms, s.rows, ocp.dt,
                                    s._wc(f64))
        else:
            prob, al = serving(shape, f64, dev, 1, {})
            s, s32 = al.inner, serving(shape, f32, dev, 1, {})[1].inner
            ocp = prob.ocp
            com_z, fz, fxy, ubox = ((0.88, 98.0, 60.0, (60.0, 130.0))
                                    if shape == "isrbd_al" else
                                    (float(prob.initial_state[2]), 78.0, 50.0,
                                     (50.0, 110.0)))
            X, U, _, _, params = draw_isrbd_point(al, Bm, g, dev, com_z=com_z,
                                                  fz=fz, fxy=fxy, u_box=ubox)
            lin = k5.isrbd_linearize(X, U, params, s.terms, s.rows, ocp.dt)
        ns, nx = ocp.ns, ocp.nx
        ks, Ks, dV1, dV2 = k12.riccati_associative_plain(
            *(lin[k] for k in ORDER), s.opts.mu0, s.rows, "cholesky")
        x0 = X[:, 0] + torch.as_tensor(0.005 * g.randn(Bm, nx), device=dev)
        D = torch.sum(lin["d"] ** 2, dim=(1, 2))
        merit0 = s.total_cost(X, U, params) + s.opts.defect_weight * D
        pts[shape] = dict(s=s, s32=s32, ocp=ocp, lin=lin, X=X, U=U, x0=x0,
                          params=params, gains=(ks, Ks, dV1, dV2), D=D,
                          merit0=merit0, nt=lin["Jt"].shape[1], fam=shape)

    # ---- modes_check: K12 and K13 against their twins ----
    errs = {}
    for shape, sv in MODES_NEW_K12:
        errs["k12", shape, sv] = modes_k12_check(
            pts[shape], sv, MODES_SHAPE_SIZES[shape], card)
    for shape in MODES_NEW_K13:
        errs["k13", shape] = modes_k13_check(pts[shape],
                                             MODES_SHAPE_SIZES[shape], card)

    # ---- modes_times: K12 beside K1's Tassa form, K13; float32 ----
    times = {}
    for shape, sv in MODES_NEW_K12:
        # K1-Tassa with the same gain solve where it is compiled (the
        # quadruped's SRBD shape has only the block-Schur one)
        k1_solver = (sv if (shape, "tassa", sv) in k1.KERNEL_INSTANCES
                     else "schur")
        times["k12", shape, sv] = modes_k12_times(
            pts[shape], sv, MODES_SHAPE_SIZES[shape],
            max(MODES_SHAPE_SIZES[shape]), k1_solver)
    for shape in MODES_NEW_K13:
        for nA in (1, 4):
            times["k13", shape, nA] = modes_k13_times(
                pts[shape], nA, MODES_SHAPE_SIZES[shape],
                max(MODES_SHAPE_SIZES[shape]))
    emit("modes_times", shapes=list(MODES_SHAPE_SIZES), card=card,
         dtype="float32",
         rate="FP64 tensor cores, 67 TFLOP/s (both compute in float64)",
         **{"_".join(map(str, k)): v for k, v in times.items()})
    emit("k12_vs_k1_tassa", shapes=list(MODES_SHAPE_SIZES), card=card,
         dtype="float32",
         **{f"{shape}_{sv}": {str(Bw): dict(
             riccati_associative_ms=v["ms"], riccati_backward_tassa_ms=v[
                 "k1_tassa_ms"], k1_quu_solver=times["k12", shape, sv][
                 "k1_tassa_quu_solver"])
             for Bw, v in times["k12", shape, sv]["by_B"].items()}
            for shape, sv in MODES_NEW_K12})
    del pts

    # ---- the paths ----
    TWINS = ((k12, ("riccati_associative_plain",)),
             (k13, ("linear_trial_plain",)),
             (k1, ("riccati_backward_plain",)),
             (k3, ("srbd_trial_plain", "srbd_evaluate_plain")),
             (k4, ("srbd_linearize_plain",)),
             (k6, ("isrbd_trial_plain", "isrbd_evaluate_plain")),
             (k5, ("isrbd_linearize_plain",)))
    COUNTED = ((k4, "srbd_linearize"), (k3, "srbd_trial"),
               (k3, "srbd_evaluate"), (k5, "isrbd_linearize"),
               (k6, "isrbd_trial"), (k6, "isrbd_evaluate"),
               (k1, "riccati_backward"), (k12, "riccati_associative"),
               (k13, "linear_trial")) + tuple((k78, e) for e in AL_ENTRIES)
    k12_inst = {key: i for i, key in enumerate(k12.KERNEL_INSTANCES)}
    k13_fam = {name: i for i, name in enumerate(k13.FAMILY_NAMES)}

    def reset_counts():
        for mod, entry in COUNTED:
            getattr(mod, entry).launches = 0
        k12.riccati_associative.instance_launches[:] = [0] * len(k12_inst)
        k13.linear_trial.family_launches[:] = [0] * len(k13.FAMILIES)

    def read_counts(shape):
        """The launches of every counted kernel, and of K12 and K13 at
        `shape` (K1's name) by gain solve and family."""
        out = {entry: getattr(mod, entry).launches for mod, entry in COUNTED}
        il = k12.riccati_associative.instance_launches
        for sv in ("schur", "cholesky"):
            if (shape, sv) in k12_inst:
                out[f"k12_{shape}_{sv}"] = il[k12_inst[shape, sv]]
        out[f"k13_{shape}"] = k13.linear_trial.family_launches[k13_fam[shape]]
        return out

    def run_path(tag, shape, drive, al):
        """Run `drive()` with the counts reset just before and read just
        after, the plain twins guarded; `drive` returns (result dict,
        solvers to count, n), having counted through `counting`."""
        guards, restore_guards = guard_plain(TWINS, al=al)
        reset_counts()
        try:
            res, n = drive()
            launches = read_counts(shape)
        finally:
            restore_guards()
        res.update({k: v["n"] for k, v in guards.items()},
                   launches=launches, counted=n, card=card)
        return res

    def gates(tag, res, shape, al, solves_expected=None):
        """Phase 13's gates: finite; defects ≤ 1e-4; K12 sweeps (the
        shape's, both gain solves) = linearizations = iterations; K1 never;
        K13 at the shape = the linear trials and the rollout kernel = the
        rollout trials; the evaluation two a solve; no plain twin, AL twin,
        plain cost or torch.func call; every kernel of the path launched."""
        L, n = res["launches"], res["counted"]
        lin_l, trial_l, ev_l = (("isrbd_linearize", "isrbd_trial",
                                 "isrbd_evaluate") if al else
                                ("srbd_linearize", "srbd_trial",
                                 "srbd_evaluate"))
        k12_l = sum(v for k, v in L.items() if k.startswith(f"k12_{shape}_"))
        if not res["finite"]:
            fail(f"{tag} produced non-finite values")
        if res["defect_norm_max"] > 1e-4:
            fail(f"{tag}: plans are not dynamically consistent (defect "
                 f"{res['defect_norm_max']} above 1e-4)")
        if (res["plain_twin_calls"] or res["torch_func_calls"]
                or res["plain_cost_or_defect_calls"]
                or res.get("al_twin_calls", 0)):
            fail(f"{tag} ran plain twins on the card: {res}")
        if not (L[lin_l] == k12_l == L["riccati_associative"]
                == n["iterations"] > 0):
            fail(f"{tag}: linearizations, K12 sweeps and iterations differ: "
                 f"{L}, {n}")
        if L["riccati_backward"]:
            fail(f"{tag}: K1 ran under riccati_mode='associative': {L}")
        if not (L[f"k13_{shape}"] == L["linear_trial"] == n["linear_trials"]
                and L[trial_l] == n["rollout_trials"]):
            fail(f"{tag}: K13 and the rollout kernel do not cover the trials: "
                 f"{L}, {n}")
        if L[ev_l] != 2 * n["solves"] or (solves_expected is not None
                                          and n["solves"] != solves_expected):
            fail(f"{tag}: the evaluation launches are not two a solve: {L}, "
                 f"{n}, {solves_expected} solves expected")
        if min(L[lin_l], k12_l, L[ev_l]) == 0 or \
                L[f"k13_{shape}"] + L[trial_l] == 0:
            fail(f"{tag}: a kernel of the path was not launched: {L}")

    def hand(L, ns_, al):
        """Hand-written kernel launches (a K12 sweep is 8 kernels)."""
        names = (("isrbd_linearize", "isrbd_trial", "isrbd_evaluate")
                 + AL_ENTRIES if al else
                 ("srbd_linearize", "srbd_trial", "srbd_evaluate"))
        return (sum(L[k] for k in names) + L["linear_trial"]
                + L["riccati_backward"]
                + k12.launches_per_sweep(ns_) * L["riccati_associative"])

    def timed_ticks(step, carry, ticks, solver, n):
        """`ticks` ticks of `step`, a device sync each: the carry, tick ms,
        iterations a tick, host reads."""
        tms, its, syncs0 = [], [], solver.host_syncs
        for _ in range(ticks):
            it0 = n["iterations"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = step(carry)
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
            its.append(n["iterations"] - it0)
        return carry, tms, its, solver.host_syncs - syncs0

    def tick_stats(tms, its, syncs):
        return dict(ticks=len(tms), tick_p50_ms=statistics.median(tms),
                    tick_max_ms=max(tms), tick_mean_ms=statistics.fmean(tms),
                    iterations_per_tick=statistics.fmean(its),
                    host_reads_per_tick=syncs / len(tms))

    def observe(res, solver, step, carry):
        """The phases of 5 more ticks and a profile of 2 (busy, idle)."""
        carry, res["spans"] = tick_spans(solver, step, carry, ticks=5)
        res["profile"] = profile_ticks(solver, step, carry,
                                       res["tick_p50_ms"])
        res["device_busy_ms_per_tick"] = res["profile"][
            "device_busy_ms_per_tick"]
        res["device_idle_share"] = res["profile"]["device_idle_share"]

    # -- the quadruped trot, B=1: 40 ticks, then 10 with Cholesky gains --
    def quad_trot():
        runs, outs, obs = {}, [], []
        base = DDPOptions(max_iters=5, alpha_converge_threshold=1e-12,
                          beta=1e-3, **LINEAR)
        n, restores = None, []
        for name, solver_name, sched in (
                ("associative_linear", "schur",
                 walking_schedule(40, vx=MODES_QUAD_VX, start=10, device=dev)),
                ("associative_linear_cholesky", "cholesky",
                 walking_schedule(10, vx=MODES_QUAD_VX, start=3, device=dev))):
            loop, prob = build_quadruped_loop(
                quad_cfg(f32), dataclasses.replace(base, quu_solver=solver_name),
                device=dev)
            n2, restore = count_solver_calls(loop.solver)
            restores.append(restore)
            carry = loop.init(prob.initial_state)
            step_outs = []

            def step(c, _loop=loop, _sched=sched, _outs=step_outs):
                c, o = _loop.tick(c, TickInput(*(a[len(_outs)] for a in _sched)))
                _outs.append(o)
                return c

            carry, tms, its, syncs = timed_ticks(step, carry,
                                                 sched.action.shape[0],
                                                 loop.solver, n2)
            com = torch.stack([o.x[:3] for o in step_outs]).cpu()
            z0 = float(prob.initial_state[2])
            runs[name] = dict(
                tick_stats(tms, its, syncs), **{k: n2[k] for k in n2},
                forward_progress_m=float(com[-1, 0] - com[0, 0]),
                com_z_min=float(com[:, 2].min()),
                com_z_max=float(com[:, 2].max()), z0=z0)
            outs += step_outs
            last = lambda c, _l=loop, _s=sched: _l.tick(
                c, TickInput(*(a[-1] for a in _s)))[0]
            obs.append((name, loop.solver, last, carry, prob))
            n = n2 if n is None else {k: n[k] + n2[k] for k in n}
        for restore in restores:
            restore()
        res = dict(
            B=1, dtype="float32", runs=runs,
            options="the quadruped example: max_iters=5, "
                    "alpha_converge_threshold=1e-12, beta=1e-3, the trot WPG, "
                    f"vx {MODES_QUAD_VX} from tick 10 (3 in the Cholesky run)",
            finite=all(bool(torch.isfinite(v).all()) for o in outs
                       for v in (o.x, o.u0, o.cost)),
            defect_norm_max=max(float(o.defect_norm) for o in outs),
            srbd_residual_max=max(float(o.srbd_residual.abs().max())
                                  for o in outs))
        res["_observe"] = obs
        return res, n

    qt = run_path("modes_quadruped_trot", "quadruped",
                  quad_trot, al=False)
    for name, solver, last, carry, prob in qt.pop("_observe"):
        r = qt["runs"][name]
        observe(r, solver, last, carry)
    qt["hand_written_kernel_launches_per_tick"] = hand(
        qt["launches"], 20, False) / sum(r["ticks"] for r in qt["runs"].values())
    emit("modes_quadruped_trot", **qt)
    gates("modes_quadruped_trot", qt, "quadruped", al=False)
    if qt["srbd_residual_max"] > 1e-4:
        fail("modes_quadruped_trot: Newton-Euler residual above 1e-4")
    for name, r in qt["runs"].items():          # phase 11's gates of the walk
        if max(abs(r["com_z_min"] - r["z0"]),
               abs(r["com_z_max"] - r["z0"])) >= QUAD_HEIGHT_BAND:
            fail(f"modes_quadruped_trot ({name}): the CoM height left z0 ± "
                 f"{QUAD_HEIGHT_BAND}: {r['com_z_min']}, {r['com_z_max']}")
        if not r["forward_progress_m"] > 0:
            fail(f"modes_quadruped_trot ({name}): no forward progress: "
                 f"{r['forward_progress_m']}")
    if min(qt["launches"]["k12_quadruped_schur"],
           qt["launches"]["k12_quadruped_cholesky"]) == 0:
        fail(f"modes_quadruped_trot: a K12 gain solve was not launched: "
             f"{qt['launches']}")

    # -- the quadruped fleet, B=512, shifted warm start, walk command --
    def quad_fleet():
        loop, prob = build_quadruped_loop(
            quad_cfg(f32), DDPOptions(max_iters=5,
                                      alpha_converge_threshold=1e-12,
                                      beta=1e-3, **LINEAR),
            shift_warmstart=True, device=dev)
        g = np.random.RandomState(SEED)
        xn = prob.initial_state.cpu().numpy()
        x0 = torch.as_tensor(xn[None] + 0.005 * g.randn(B_MAIN, xn.shape[0]),
                             dtype=f32, device=dev)
        inp = walk_command(B_MAIN, vx=0.2, dtype=f32, device=dev)
        carry = loop.init(x0)
        for _ in range(3):
            carry, _ = loop.tick_batch(carry, inp)
        torch.cuda.synchronize()
        reset_counts()
        n, restore = count_solver_calls(loop.solver)
        outs = []

        def step(c):
            c, o = loop.tick_batch(c, inp)
            outs.append(o)
            return c

        try:
            carry, tms, its, syncs = timed_ticks(step, carry, 20, loop.solver, n)
        finally:
            restore()
        res = dict(
            B=B_MAIN, dtype="float32", warmup_ticks=3,
            options="quad_fleet_path's: max_iters=5, shifted warm start, walk "
                    "command vx 0.2, 0.005·N(0,1) pushes (seed 0), "
                    "associative/linear",
            **tick_stats(tms, its, syncs),
            members_per_s=B_MAIN / statistics.median(tms) * 1e3,
            finite=all(bool(torch.isfinite(v).all()) for o in outs
                       for v in (o.x, o.u0, o.cost)),
            defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
            srbd_residual_max=max(float(o.srbd_residual.abs().max())
                                  for o in outs))
        res["_observe"] = (loop.solver, lambda c: loop.tick_batch(c, inp)[0],
                           carry)
        return res, n

    qf = run_path("modes_quadruped_fleet", "quadruped", quad_fleet, al=False)
    observe(qf, *qf.pop("_observe"))
    qf["hand_written_kernel_launches_per_tick"] = hand(
        qf["launches"], 20, False) / qf["ticks"]
    emit("modes_quadruped_fleet", **qf)
    gates("modes_quadruped_fleet", qf, "quadruped", al=False)
    if qf["srbd_residual_max"] > 1e-4:
        fail("modes_quadruped_fleet: Newton-Euler residual above 1e-4")

    # -- the isrbd example's single constrained robot --
    def kangaroo_single(dtype, device, modes, ticks, timed, counted=True):
        """The isrbd example's sequence (phase 9's): the offline
        `ALDDP.solve` (max_iters=15, 6 outers from ρ 1e3, ρ ≤ 1e5) from
        the static input, then `ticks` ticks of the WPG advance, rdot_ref
        (0.3, 0, 0) on nodes 1..ns, x0 = the plan's node 1 and
        `solve_online` (walking from tick 10)."""
        prob, al = al_solver("isrbd_al", dtype, device, DDPOptions(
            max_iters=15, alpha_converge_threshold=1e-12, beta=1e-3, **modes),
            ALOptions(outer_iters=6, rho0=1e3, rho_max=1e5))
        ns = prob.ocp.ns
        n, restore = (count_solver_calls(al.inner) if counted
                      else (None, lambda: None))
        sync = torch.cuda.synchronize if timed else (lambda: None)
        x0 = prob.initial_state
        U0 = prob.static_input[None].expand(ns, -1).contiguous()
        sync()
        t0 = time.perf_counter()
        st = al.solve(al.init(x0, U0), x0, prob.ocp.params)
        sync()
        solve_ms = (time.perf_counter() - t0) * 1e3
        wpg = WalkingPatternGenerator.build(c_init_z=0.0, nodes=ns,
                                            dtype=dtype, device=device)
        ref = torch.tensor([0.3, 0.0, 0.0], dtype=dtype, device=device)
        states = [st]

        def step(c):
            st, params, ws, t = c
            action = torch.tensor(int(t >= 10), dtype=torch.int32,
                                  device=device)
            params, ws = wpg.advance(params, ws, action)
            params["rdot_ref"] = torch.cat(
                [params["rdot_ref"][:1], ref.expand(ns, 3)], dim=0)
            st = al.solve_online(st, st.sol.X[1], params)
            states.append(st)
            return st, params, ws, t + 1

        carry = (st, dict(prob.ocp.params), wpg.init_state(), 0)
        if timed:
            carry, tms, its, syncs = timed_ticks(step, carry, ticks, al.inner,
                                                 n)
        else:
            for _ in range(ticks):
                carry = step(carry)
            tms = None
        restore()
        return dict(al=al, states=states, solve_ms=solve_ms, tms=tms,
                    its=its if timed else None,
                    syncs=syncs if timed else None, n=n, step=step,
                    carry=carry)

    def al_result(r, outers, **extra):
        states = r["states"]
        viols = [float(s.viol) for s in states]
        return dict(
            B=1, dtype="float32", offline_ms=r["solve_ms"],
            offline_viol=viols[0], online_viol_max=max(viols[1:]),
            **tick_stats(r["tms"], r["its"], r["syncs"]),
            finite=all(bool(torch.isfinite(t).all()) for s in states
                       for t in (s.sol.X, s.sol.U, s.lam_eq, s.lam_eq_T,
                                 s.viol)),
            defect_norm_max=max(float(s.sol.defect_norm) for s in states),
            outers=outers, **extra)

    def al_outer_gates(tag, res, outers, shifts, priors=0):
        """K7 and K8b once an outer, K8a once a shift, K8c once a prior
        update (phases 9 and 12)."""
        L = res["launches"]
        if not (L["isrbd_al_constraints"] == L["isrbd_al_params"] == outers
                and L["isrbd_al_shift"] == shifts
                and L["isrbd_al_prior_update"] == priors):
            fail(f"{tag}: K7/K8b are not once an outer ({outers}), or K8a "
                 f"({shifts}) / K8c ({priors}) not as the path calls them: {L}")

    single = {}
    for label, modes in (("associative_linear", LINEAR),
                         ("associative_nonlinear", NONLINEAR)):
        box = {}

        def drive(_modes=modes, _box=box):
            r = kangaroo_single(f32, dev, _modes, MODES_AL_TICKS, timed=True)
            _box["r"] = r
            return al_result(r, 6 + MODES_AL_TICKS,
                             modes=f"{_modes['riccati_mode']}/"
                                   f"{_modes['forward_pass']}"), r["n"]

        res = run_path(f"modes_single_constrained_{label}", "isrbd_al",
                       drive, al=True)
        r = box["r"]
        observe(res, r["al"].inner, r["step"], r["carry"])
        res["hand_written_kernel_launches_per_tick"] = hand(
            res["launches"], 20, True) / MODES_AL_TICKS
        tag = f"modes_single_constrained_{label}"
        emit(tag, **res)
        gates(tag, res, "isrbd_al", al=True,
              solves_expected=6 + MODES_AL_TICKS)
        al_outer_gates(tag, res, 6 + MODES_AL_TICKS, 0)
        if not res["offline_viol"] < 1e-3:
            fail(f"{tag}: the offline violation {res['offline_viol']} is not "
                 f"below 1e-3")
        single[label] = res
    if single["associative_nonlinear"]["launches"]["isrbd_trial"] == 0:
        fail("K6 did not run after a K12 sweep under associative/nonlinear")

    # -- the constrained fleet at the round-5 serving point, B=256 --
    def al_fleet(shape, dtype, Bsz, warm, outers, vx, walk_from):
        """`constrained_tick` (inner max_iters=1, `outers` outers,
        FullPhasePrior at EMA 1) under associative/linear, seeded by the
        batched offline solve (`al_serving_options(15)`, same modes) from
        x0 = nominal + 0.01·N(0,1) (seed 11); the Kangaroo's WPG walking
        throughout, the quadruped's trot WPG standing until `walk_from`."""
        prob, off = serving(shape, dtype, dev, 15, LINEAR)
        _, on = serving(shape, dtype, dev, 1, LINEAR)
        ns, nx = prob.ocp.ns, prob.ocp.nx
        wpg = (WalkingPatternGenerator.build(0.0, ns, dtype=dtype, device=dev)
               if shape == "isrbd_al" else
               WalkingPatternGenerator.build(
                   0.0, ns, dtype=dtype, device=dev,
                   group_mask=trot_group_mask(), **QUAD_TOPOLOGY))
        gg = np.random.RandomState(11)
        x0 = prob.initial_state[None] + torch.as_tensor(
            0.01 * gg.randn(Bsz, nx), dtype=dtype, device=dev)
        U0 = prob.static_input[None].expand(ns, -1)
        params = {k: v.expand((Bsz,) + tuple(v.shape)).contiguous()
                  for k, v in prob.ocp.params.items()}
        period = 2 * wpg.step_nodes
        stand = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        walk = torch.ones(Bsz, dtype=torch.int32, device=dev)
        still = torch.zeros(Bsz, 3, dtype=dtype, device=dev)
        go = torch.tensor([[vx, 0.0, 0.0]], dtype=dtype, device=dev).expand(
            Bsz, -1).contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = off.solve_batch(off.init(x0, U0), x0, params)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
        seed_viol = float(st.viol.max())
        viols = []

        def step(s):
            st, params, ws, pr, k = s
            st, params, ws, pr = constrained_tick(
                on, wpg, st, params, ws, walk if k >= walk_from else stand,
                go if k >= walk_from else still, prior=pr, outers=outers,
                prior_ema=1.0)
            viols.append(float(st.viol.max()))
            return [st, params, ws, pr, k + 1]

        state = [st, params, wpg.init_state((Bsz,)),
                 on.init_full_phase_prior(period, Bsz), 0]
        for _ in range(1 + warm):
            state = step(state)
        return on, step, state, viols, dict(seed_seconds=seed_s,
                                            seed_viol_max=seed_viol)

    def fleet_drive(shape, dtype, Bsz, warm, timed, outers, vx, walk_from,
                    box):
        def drive():
            on, step, state, viols, seed = al_fleet(shape, dtype, Bsz, warm,
                                                    outers, vx, walk_from)
            reset_counts()
            n, restore = count_solver_calls(on.inner)
            del viols[:]
            try:
                state, tms, its, syncs = timed_ticks(step, state, timed,
                                                     on.inner, n)
            finally:
                restore()
            st = state[0]
            box.update(on=on, step=step, state=state)
            return dict(
                B=Bsz, dtype=str(dtype).replace("torch.", ""),
                warmup_ticks=1 + warm, outers=outers,
                online_iters=1, phase_prior="full", prior_ema=1.0, **seed,
                **tick_stats(tms, its, syncs),
                solves_per_s=Bsz / statistics.median(tms) * 1e3,
                window_viol_max=max(viols), final_viol_max=viols[-1],
                finite=all(bool(torch.isfinite(t).all()) for t in
                           (st.sol.X, st.sol.U, st.lam_eq, st.lam_eq_T,
                            st.viol, st.sol.cost)),
                defect_norm_max=float(st.sol.defect_norm.max())), n
        return drive

    # The round-5 serving point is gated in float64: under these modes the
    # JAX package's own float32 fleet leaves the constraints there, a
    # violation of several units every gait cycle (tests/
    # modes_fleet_reference.py, PERF.md §6), and so does the port's. The
    # float32 run is measured and reported beside it.
    fleets = {}
    for tag, shape, dtype, timed, outers, vx, walk_from, viol_gate in (
            ("modes_constrained_fleet", "isrbd_al", f64, 20, 1, 0.1, 0, True),
            ("modes_constrained_fleet_f32", "isrbd_al", f32, 20, 1, 0.1, 0,
             False),
            ("modes_constrained_quadruped_fleet", "isrbd_al_quadruped", f32,
             20, 2, QC_VX, 10, True)):
        box = {}
        res = run_path(tag, shape, fleet_drive(
            shape, dtype, B_CONSTRAINED, 60, timed, outers, vx, walk_from,
            box), al=True)
        res["walk"] = (f"walk command vx {vx}" if walk_from == 0 else
                       f"standing, then vx {vx} from tick {walk_from}")
        res["cz_rho_weight"] = CZ_RHO_WEIGHT if shape == "isrbd_al" else None
        observe(res, box["on"].inner, box["step"], box["state"])
        res["launches_by_span"] = res["profile"]["launches_by_span"]
        res["hand_written_kernel_launches_per_tick"] = hand(
            res["launches"], 20, True) / timed
        emit(tag, **res)
        gates(tag, res, shape, al=True, solves_expected=outers * timed)
        al_outer_gates(tag, res, outers * timed, timed, timed)
        res["viol_gated"] = viol_gate
        if viol_gate and not res["window_viol_max"] < VIOL_LIMIT:
            fail(f"{tag}: window_viol_max {res['window_viol_max']} is not "
                 f"below {VIOL_LIMIT}")
        fleets[tag] = res

    # -- the constrained quadruped trot, B=1 (phase 12's sequence) --
    def qc_single(dtype, device, ticks, timed, counted=True):
        prob, off = serving("isrbd_al_quadruped", dtype, device, 15, LINEAR)
        _, on = serving("isrbd_al_quadruped", dtype, device, 1, LINEAR)
        ns = prob.ocp.ns
        wpg = WalkingPatternGenerator.build(
            0.0, ns, dtype=dtype, device=device, group_mask=trot_group_mask(),
            **QUAD_TOPOLOGY)
        n, restore = (count_solver_calls(off.inner, on.inner) if counted
                      else (None, lambda: None))
        sync = torch.cuda.synchronize if timed else (lambda: None)
        x0 = prob.initial_state
        U0 = prob.static_input[None].expand(ns, -1).contiguous()
        sync()
        t0 = time.perf_counter()
        st = off.solve(off.init(x0, U0), x0, prob.ocp.params)
        sync()
        solve_ms = (time.perf_counter() - t0) * 1e3
        ref = torch.tensor([QC_VX, 0.0, 0.0], dtype=dtype, device=device)
        walk = torch.tensor(1, dtype=torch.int32, device=device)
        states = [st]

        def step(c):
            st, params, ws = c
            params, ws = wpg.advance(params, ws, walk)
            params["rdot_ref"] = torch.cat(
                [params["rdot_ref"][:1], ref.expand(ns, 3)], dim=0)
            x1 = st.sol.X[1]
            st = on.solve_online(on.solve_online(on.shift_warmstart(st), x1,
                                                 params), x1, params)
            states.append(st)
            return st, params, ws

        carry = (st, dict(prob.ocp.params), wpg.init_state())
        tms = its = syncs = None
        if timed:
            carry, tms, its, syncs = timed_ticks(step, carry, ticks, on.inner,
                                                 n)
        else:
            for _ in range(ticks):
                carry = step(carry)
        restore()
        return dict(al=on, prob=prob, states=states, solve_ms=solve_ms, tms=tms,
                    its=its, syncs=syncs, n=n, step=step, carry=carry)

    box = {}

    def qc_drive():
        r = qc_single(f32, dev, QC_TICKS, timed=True)
        box["r"] = r
        res = al_result(r, 6 + 2 * QC_TICKS,
                        options="al_serving_options: offline max_iters=15 (6 "
                                "outers), online max_iters=1, two solve_online "
                                "a tick after shift_warmstart",
                        walk=f"trot WPG, vx {QC_VX} from tick 0")
        viols = [float(s.viol) for s in r["states"][1:]]
        res["viol_max_ticks_20_39"] = max(viols[20:])
        res["forward_progress_m"] = float(r["states"][-1].sol.X[0, 0]
                                          - r["prob"].initial_state[0])
        return res, r["n"]

    qs = run_path("modes_constrained_quadruped_trot", "isrbd_al_quadruped",
                  qc_drive, al=True)
    observe(qs, box["r"]["al"].inner, box["r"]["step"], box["r"]["carry"])
    qs["hand_written_kernel_launches_per_tick"] = hand(
        qs["launches"], 20, True) / QC_TICKS
    emit("modes_constrained_quadruped_trot", **qs)
    gates("modes_constrained_quadruped_trot", qs, "isrbd_al_quadruped",
          al=True, solves_expected=6 + 2 * QC_TICKS)
    al_outer_gates("modes_constrained_quadruped_trot", qs, 6 + 2 * QC_TICKS,
                   QC_TICKS)
    if not (qs["offline_viol"] < 1e-3 and qs["viol_max_ticks_20_39"] < VIOL_LIMIT
            and qs["forward_progress_m"] > QC_VX):
        fail(f"modes_constrained_quadruped_trot: offline violation "
             f"{qs['offline_viol']}, violation over ticks 20-39 "
             f"{qs['viol_max_ticks_20_39']}, progress "
             f"{qs['forward_progress_m']} m")

    # ---- modes_card_vs_cpu: float64 ----
    def al_versus(card_states, cpu_states):
        both = lambda f: max(rel_err(f(a).cpu(), f(b))
                             for a, b in zip(card_states, cpu_states))
        res = dict(
            steps=len(cpu_states),
            iterations_equal=all(
                torch.equal(a.sol.iterations.cpu(), b.sol.iterations)
                for a, b in zip(card_states, cpu_states)),
            converged_equal=all(
                torch.equal(a.sol.converged.cpu(), b.sol.converged)
                for a, b in zip(card_states, cpu_states)),
            X_rel_err=both(lambda s: s.sol.X), U_rel_err=both(lambda s: s.sol.U),
            cost_rel_err=both(lambda s: s.sol.cost),
            lam_rel_err=both(lambda s: s.lam_eq),
            lam_T_rel_err=both(lambda s: s.lam_eq_T),
            mu_rel_err=both(lambda s: s.mu_ub), rho_rel_err=both(lambda s: s.rho))
        res["ok"] = (res["iterations_equal"] and res["converged_equal"]
                     and max(v for k, v in res.items()
                             if k.endswith("rel_err")) <= 1e-9)
        return res

    def fleet_states(device):
        """The AL fleet at B=8 in float64: the seed, then 3 serving ticks
        (1 outer × 1 inner iteration, full prior, walking), on the
        Kangaroo's serving problem under associative/linear."""
        prob, off = serving("isrbd_al", f64, device, 15, LINEAR)
        _, on = serving("isrbd_al", f64, device, 1, LINEAR)
        ns, nx = prob.ocp.ns, prob.ocp.nx
        wpg = WalkingPatternGenerator.build(0.0, ns, dtype=f64, device=device)
        gg = np.random.RandomState(11)
        x0 = prob.initial_state[None] + torch.as_tensor(
            0.01 * gg.randn(8, nx), dtype=f64, device=device)
        params = {k: v.expand((8,) + tuple(v.shape)).contiguous()
                  for k, v in prob.ocp.params.items()}
        st = off.solve_batch(off.init(x0, prob.static_input[None].expand(
            ns, -1)), x0, params)
        states, ws = [st], wpg.init_state((8,))
        pr = on.init_full_phase_prior(2 * wpg.step_nodes, 8)
        action = torch.ones(8, dtype=torch.int32, device=device)
        rdot = torch.tensor([[0.1, 0.0, 0.0]], dtype=f64,
                            device=device).expand(8, -1).contiguous()
        for _ in range(3):
            st, params, ws, pr = constrained_tick(on, wpg, st, params, ws,
                                                  action, rdot, prior=pr,
                                                  outers=1, prior_ema=1.0)
            states.append(st)
        return states

    cvc = dict(
        tol=1e-9, modes="associative/linear",
        single=dict(B=1, what="the isrbd example: offline solve and 3 ticks",
                    **al_versus(
                        kangaroo_single(f64, dev, LINEAR, 3, False,
                                        counted=False)["states"],
                        kangaroo_single(f64, "cpu", LINEAR, 3, False,
                                        counted=False)["states"])),
        fleet=dict(B=8, what="the seed and 3 serving ticks",
                   **al_versus(fleet_states(dev), fleet_states("cpu"))))
    emit("modes_card_vs_cpu", shapes="isrbd_al", **cvc)
    if not (cvc["single"]["ok"] and cvc["fleet"]["ok"]):
        fail("the modes' constrained card path and CPU path disagree")

    # ---- the kernel rows ----
    paths = {"quadruped": (("modes_quadruped_trot", qt),
                           ("modes_quadruped_fleet", qf)),
             "isrbd_al": tuple((f"modes_single_constrained_{k}", v)
                               for k, v in single.items())
             + tuple((k, fleets[k]) for k in ("modes_constrained_fleet",
                                               "modes_constrained_fleet_f32")),
             "isrbd_al_quadruped": (
                 ("modes_constrained_quadruped_trot", qs),
                 ("modes_constrained_quadruped_fleet",
                  fleets["modes_constrained_quadruped_fleet"]))}
    rows_out = []
    for shape, sv in MODES_NEW_K12:
        by_path = {tag: r["launches"][f"k12_{shape}_{sv}"]
                   for tag, r in paths[shape]}
        rows_out.append(modes_k12_row(
            f"riccati_associative_{shape}"
            + ("_cholesky" if sv == "cholesky" else ""),
            times["k12", shape, sv], errs["k12", shape, sv],
            sum(by_path.values()), max(MODES_SHAPE_SIZES[shape]),
            quu_solver=sv, shape=shape, launches_by_path=by_path))
    for shape in MODES_NEW_K13:
        by_path = {tag: r["launches"][f"k13_{shape}"]
                   for tag, r in paths[shape]}
        rows_out.append(modes_k13_row(
            f"linear_trial_{shape}", times["k13", shape, 1],
            times["k13", shape, 4], errs["k13", shape], sum(by_path.values()),
            max(MODES_SHAPE_SIZES[shape]), family=shape,
            launches_by_path=by_path))
    for r in rows_out:
        if r["launches"] == 0:
            fail(f"{r['name']} was not launched on its paths")
    emit("modes_shapes_section", seconds=time.perf_counter() - t_section,
         card=card)
    return rows_out


# ---------------- the SRBD family at every topology and step (phase 14) -----

# the (topology, step) instances phase 14 adds, in linearize.KERNEL_SHAPES
# names: the point-feet biped under Euler, each topology under RK2 and RK4
FAMILY_INSTANCES = ("point_feet", "kangaroo_rk2", "kangaroo_rk4",
                    "quadruped_rk2", "quadruped_rk4", "point_feet_rk2",
                    "point_feet_rk4")
FAMILY_CHECK_B = (1, 64, B_MAIN)
FAMILY_TIME_B = (1, B_MAIN, B_LARGE)
FAMILY_NAN = 7                  # the member with a NaN state / plan
# K4, K3 and srbd_evaluate in float64: |kernel − twin| ≤ 1e-12·max(1, |twin|)
FAMILY_F64_TOL = 1e-12
FAMILY_HEIGHT = 0.88            # the bipeds' CoM height gate (± 0.08)
FAMILY_HEIGHT_BAND = 0.08
FAMILY_PROGRESS = 0.03          # forward progress at tick 39 (m)
FAMILY_FLEET_WARM, FAMILY_FLEET_TIMED, FAMILY_SHORT_TICKS = 3, 20, 10
FAMILY_SINGLE_TICKS, FAMILY_CHOLESKY_TICKS = 40, 10


def family_split(inst):
    """(topology, step) of a KERNEL_SHAPES name."""
    for step in ("rk2", "rk4"):
        if inst.endswith("_" + step):
            return inst[: -len(step) - 1], step.upper()
    return inst, "EULER"


def family_loop(topology, step, dtype, device, opts=None, shift=False):
    """The MPC loop of one topology under one step: the quadruped example's
    (`build_quadruped_loop`: max_iters=5, the trot WPG; on the line-feet
    quadruped `build_srbd_loop` with its robot, the same options and the
    trot's 8-entry mask), or the biped's (`build_srbd_loop`; the point-feet
    biped with `point_feet()`) with the dsrbd example's options unless
    `opts` says otherwise."""
    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.models.kangaroo import (kangaroo_line_feet,
                                                        point_feet)
    from srbd_horizon_tpu_torch.runtime.loop import (build_quadruped_loop,
                                                     build_srbd_loop)
    from srbd_horizon_tpu_torch.solvers.options import ddp_example_options

    if topology == "quadruped":
        return build_quadruped_loop(SRBDConfig(dtype=dtype, **QUAD_TOPOLOGY),
                                    opts, shift_warmstart=shift,
                                    device=device, integrator=step)
    if topology == "line_feet_quadruped":
        # the quadruped example's options and trot, on the line feet
        return build_srbd_loop(
            SRBDConfig(dtype=dtype, **LINE_FEET_TOPOLOGY),
            opts or DDPOptions(max_iters=5, alpha_converge_threshold=1e-12,
                               beta=1e-3),
            robot=line_feet_robot(), shift_warmstart=shift, device=device,
            group_mask=line_feet_mask(), integrator=step)
    robot, topo = {
        "point_feet": (point_feet, dict(contact_model=1, number_of_legs=2)),
        "square_feet": (square_feet_robot, SQUARE_TOPOLOGY),
    }.get(topology, (kangaroo_line_feet, {}))
    return build_srbd_loop(SRBDConfig(dtype=dtype, **topo),
                           opts or ddp_example_options(), robot=robot(),
                           shift_warmstart=shift, device=device,
                           integrator=step)


def family_counts_reset():
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    for fn in (k4.srbd_linearize, k3.srbd_trial, k3.srbd_evaluate):
        fn.launches = 0
        fn.shape_launches.update(dict.fromkeys(fn.shape_launches, 0))
    k1.riccati_backward.launches = 0
    k1.riccati_backward.instance_launches[:] = [0] * len(k1.KERNEL_INSTANCES)


def family_counts():
    """The launches of every SRBD instance of K4, K3, srbd_evaluate and K1
    since the last reset, by kernel and instance (zeros left out)."""
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    out = {}
    for name, fn in (("srbd_linearize", k4.srbd_linearize),
                     ("srbd_trial", k3.srbd_trial),
                     ("srbd_evaluate", k3.srbd_evaluate)):
        for inst, n in fn.shape_launches.items():
            if n:
                out[f"{name}_{inst}"] = n
    for (shape, form, solver), n in zip(k1.KERNEL_INSTANCES,
                                        k1.riccati_backward.instance_launches):
        if n:
            out[k1_row_name(shape, form, solver)] = n
    return out


def k1_row_name(shape, form, solver):
    return ("riccati_backward_" + shape
            + ("" if form == "collapsed" else "_tassa")
            + ("_cholesky" if solver == "cholesky" else ""))


def family_point(loop64, prob, B, dev, seed):
    """A linearization point of one instance at B members: plans around the
    nominal state (0.02 / 0.05·N(0,1)), the contact plan of 7 ticks of the
    loop's WPG, x0 near node 0; member FAMILY_NAN with a NaN in x0 and in
    a copy of the plan."""
    import numpy as np
    import torch

    ocp = prob.ocp
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    rng = np.random.RandomState(seed)
    params1, wst = dict(ocp.params), loop64.wpg.init_state()
    for _ in range(7):
        params1, wst = loop64.wpg.advance(
            params1, wst, torch.tensor(1, dtype=torch.int32, device=dev))
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in params1.items()}
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = t(prob.initial_state.cpu().numpy()[None, None]
          + 0.02 * rng.randn(B, ns + 1, nx))
    U = t(prob.static_input.cpu().numpy()[None, None]
          + 0.05 * rng.randn(B, ns, nu))
    x0 = X[:, 0] + t(0.005 * rng.randn(B, nx))
    X_nan, x0_nan = X.clone(), x0.clone()
    X_nan[FAMILY_NAN, 5, 4] = float("nan")
    x0_nan[FAMILY_NAN] = float("nan")
    return dict(X=X, U=U, params=params, x0=x0, X_nan=X_nan, x0_nan=x0_nan)


def family_sub(tree, Bw):
    """The first Bw members of every tensor of a point."""
    if isinstance(tree, dict):
        return {k: family_sub(v, Bw) for k, v in tree.items()}
    return tree[:Bw].contiguous()


def family_check(inst, dev):
    """K4, K1 (collapsed and every Tassa instantiation at this shape), K3
    (1 and 4 α) and srbd_evaluate (plain and pinned) of one instance
    against their twins at B = 1, 64 and 512: K4, K3 and srbd_evaluate in
    float64 to FAMILY_F64_TOL of max(1, |twin|), in float32 within 2× the
    float32 twin's error + 1e-6 (K4 also below K4_F32_CAP); K1 in float64
    to 1e-9, in float32 to K1_F32_TOL of the float64 twin; K3's flags
    equal in float64 and off the Armijo margin in float32; the NaN member
    (B > 1) rejected by K3 and NaN in srbd_evaluate; the pinned plan bit
    for bit. Returns the worst figures, the K1 shape, the float64 twins'
    linearization and collapsed sweep at B=512 and the point; fails the
    run on disagreement."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    f64, f32 = torch.float64, torch.float32
    topology, step = family_split(inst)
    loop64, prob = family_loop(topology, step, f64, dev)
    loop32, _ = family_loop(topology, step, f32, dev)
    s64, s32 = loop64.solver, loop32.solver
    ocp = prob.ocp
    dt, rows, opts, mu = ocp.dt, s64.rows, s64.opts, s64.opts.mu0
    assert k4.check_kernel_shape("check", s64.terms, ocp.nx, ocp.nu,
                                 rows) == inst
    pt = family_point(loop64, prob, B_MAIN, dev, SEED + 14)
    solver_of = lambda dtype: s64 if dtype == f64 else s32
    cast = lambda a, dtype: a.to(dtype).contiguous()
    worst = defaultdict(float)
    bad = []

    def note(key, e64, e32, p32, abs32, rule32):
        worst[key + "_e64"] = max(worst[key + "_e64"], e64)
        worst[key + "_e32"] = max(worst[key + "_e32"], e32)
        worst[key + "_p32"] = max(worst[key + "_p32"], p32)
        worst[key + "_abs32"] = max(worst[key + "_abs32"], abs32)
        if not rule32:
            bad.append(f"{key} float32")

    nt = None
    for Bw in FAMILY_CHECK_B:
        p = family_sub(pt, Bw)
        cp = lambda dtype: {k: cast(v, dtype) for k, v in p["params"].items()}
        # K4
        lin = {}
        for dtype in (f64, f32):
            s = solver_of(dtype)
            a = (cast(p["X"], dtype), cast(p["U"], dtype), cp(dtype), s.terms,
                 s.rows, dt, s._wc(dtype))
            lin[dtype] = (k4.srbd_linearize_plain(*a), k4.srbd_linearize(*a))
        ref = lin[f64][0]
        e64 = max(err1(lin[f64][1][k], ref[k]) for k in ORDER)
        e32 = {k: rel_err(lin[f32][1][k], ref[k]) for k in ORDER}
        p32 = {k: rel_err(lin[f32][0][k], ref[k]) for k in ORDER}
        if e64 > FAMILY_F64_TOL:
            bad.append(f"K4 float64 at B={Bw}: {e64}")
        note("k4", e64, max(e32.values()), max(p32.values()),
             max(abs_err(lin[f32][1][k], ref[k]) for k in ORDER),
             all(e32[k] <= 2 * p32[k] + 1e-6 and e32[k] <= K4_F32_CAP
                 for k in ORDER))
        nt = ref["Jt"].shape[1]
        k1_shape = k1.kernel_shape(ocp.nx, ocp.nu, nt, rows)
        # K1, every instantiation at this shape
        a64 = tuple(ref[k] for k in ORDER)
        a32 = tuple(v.float().contiguous() for v in a64)
        sweeps = {}
        for shape, form, solver in k1.KERNEL_INSTANCES:
            if shape != k1_shape:
                continue
            kw = dict(form=form, quu_solver=solver)
            r = k1.riccati_backward_plain(*a64, mu, rows, **kw)
            g = k1.riccati_backward(*a64, mu, rows, **kw)
            g32 = k1.riccati_backward(*a32, mu, rows, **kw)
            p32_ = k1.riccati_backward_plain(*a32, mu, rows, **kw)
            name = k1_row_name(shape, form, solver)
            e64 = max(rel_err(x, y) for x, y in zip(g, r))
            e32 = max(rel_err(x, y) for x, y in zip(g32, r))
            if e64 > 1e-9:
                bad.append(f"{name} float64 at B={Bw}: {e64}")
            note(name, e64, e32, max(rel_err(x, y) for x, y in zip(p32_, r)),
                 max(abs_err(x, y) for x, y in zip(g32, r)), e32 <= K1_F32_TOL)
            sweeps[(form, solver)] = r
        ks, Ks, dV1, dV2 = sweeps[("collapsed", "schur")]
        d = ref["d"]
        D = torch.sum(d * d, dim=(1, 2))
        merit0 = s64.total_cost(p["X"], p["U"], p["params"]) + \
            opts.defect_weight * D
        # K3, 1 and 4 α; the NaN member starts from a NaN state
        x0s = p["x0_nan"] if Bw > FAMILY_NAN else p["x0"]
        alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=f64, device=dev)
        for nA in (1, 4):
            outs = {}
            for dtype in (f64, f32):
                s = solver_of(dtype)
                c = lambda a: cast(a, dtype)
                a = (c(x0s), c(p["X"]), c(p["U"]), c(ks), c(Ks), c(d),
                     c(alphas4[:nA]), cp(dtype), c(merit0), c(D), c(dV1),
                     c(dV2), s.terms, dt, s._wc(dtype), opts.defect_weight,
                     opts.beta, opts.alpha_converge_threshold)
                outs[dtype] = (k3.srbd_trial_plain(*a), k3.srbd_trial(*a))
            ref3 = outs[f64][0]
            e64 = max(err1(g, r) for g, r in zip(outs[f64][1][:4], ref3[:4]))
            e32 = {n: rel_err(g, r) for n, g, r in zip(TRIAL_OUT, outs[f32][1], ref3)}
            p32 = {n: rel_err(g, r) for n, g, r in zip(TRIAL_OUT, outs[f32][0], ref3)}
            al = alphas4[:nA, None]
            margin = (merit0 - ref3[3]) - opts.beta * torch.clamp(
                -(al * dV1 + al * al * dV2)
                + (2 * al - al * al) * opts.defect_weight * D, min=1e-16)
            near = margin.abs() <= 1e-4 * merit0.abs().clamp_min(1.0)
            flips = int(((outs[f32][1][4] != ref3[4]) & ~near).sum())
            if e64 > FAMILY_F64_TOL or not torch.equal(outs[f64][1][4], ref3[4]):
                bad.append(f"K3 float64 at B={Bw}, {nA} α: {e64}")
            if flips or (Bw > FAMILY_NAN
                         and bool(outs[f64][1][4][:, FAMILY_NAN].any())):
                bad.append(f"K3 flags at B={Bw}, {nA} α")
            note("k3", e64, max(e32.values()), max(p32.values()),
                 max(abs_err(g, r) for g, r in zip(outs[f32][1][:4], ref3[:4])),
                 all(e32[n] <= 2 * p32[n] + 1e-6 for n in TRIAL_OUT))
        # srbd_evaluate, plain and pinned; the NaN member's plan holds a NaN
        Xe = p["X_nan"] if Bw > FAMILY_NAN else p["X"]
        for pinned in (False, True):
            outs = {}
            for dtype in (f64, f32):
                s = solver_of(dtype)
                kw = dict(x0=cast(p["x0"], dtype)) if pinned else {}
                a = (cast(Xe, dtype), cast(p["U"], dtype), cp(dtype), s.terms,
                     dt, s._wc(dtype))
                outs[dtype] = (k3.srbd_evaluate_plain(*a, **kw),
                               k3.srbd_evaluate(*a, **kw))
            refe = outs[f64][0]
            e64 = max(err1(g, r) for g, r in zip(outs[f64][1][:2], refe[:2]))
            e32 = [rel_err(g, r) for g, r in zip(outs[f32][1][:2], refe[:2])]
            p32 = [rel_err(g, r) for g, r in zip(outs[f32][0][:2], refe[:2])]
            if e64 > FAMILY_F64_TOL:
                bad.append(f"srbd_evaluate float64 at B={Bw}: {e64}")
            if Bw > FAMILY_NAN and not all(
                    bool(torch.isnan(o[FAMILY_NAN])) for out in
                    (outs[f64][1], outs[f32][1]) for o in out[:2]):
                bad.append(f"srbd_evaluate NaN member at B={Bw}")
            if pinned and not (
                    bool(torch.equal(bits(outs[f64][1][2]), bits(refe[2])))
                    and bool(torch.equal(bits(outs[f32][1][2]),
                                         bits(outs[f32][0][2])))):
                bad.append(f"srbd_evaluate pinned plan at B={Bw}")
            note("evaluate", e64, max(e32), max(p32),
                 max(abs_err(g, r) for g, r in zip(outs[f32][1][:2], refe[:2])),
                 all(a <= 2 * b + 1e-6 for a, b in zip(e32, p32)))
    torch.cuda.synchronize()
    res = dict(worst)
    emit("family_check", instance=inst, k1_shape=k1_shape, B=FAMILY_CHECK_B,
         f64_tol=FAMILY_F64_TOL, k1_f64_tol=1e-9, k1_f32_tol=K1_F32_TOL,
         f32_rule="kernel <= 2*plain + 1e-6 (K4 also <= 1e-5)",
         failures=bad, **res)
    if bad:
        fail(f"family_check {inst}: {bad}")
    return res, k1_shape, ref, (ks, Ks, dV1, dV2), pt


def family_times(inst, dev, lin64, sweep64, pt):
    """One instance's kernels in float32 at B = 1, 512 and 4096 (members
    repeated), the twins' at B ≤ 512: ms, the bytes and FLOPs the call
    needs and its bound; K4/K3/srbd_evaluate occupancy and K1's blocks an
    SM and shared memory. {row name: {B: figures}}, {row name: occupancy}."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    f32 = torch.float32
    topology, step = family_split(inst)
    loop32, prob = family_loop(topology, step, f32, dev)
    s = loop32.solver
    ocp = prob.ocp
    ns, nx, nu, nc, dt = ocp.ns, ocp.nx, ocp.nu, prob.nc, ocp.dt
    rows, opts, mu = s.rows, s.opts, s.opts.mu0
    n_rho = s.terms.n_rho
    c = lambda a: a.float().contiguous()
    params = {k: c(v) for k, v in pt["params"].items()}
    a4 = (c(pt["X"]), c(pt["U"]), params, s.terms, rows, dt, s._wc(f32))
    ks, Ks, dV1, dV2 = (c(v) for v in sweep64)
    d = c(lin64["d"])
    D = torch.sum(d * d, dim=(1, 2))
    merit0 = s.total_cost(a4[0], a4[1], params) + opts.defect_weight * D
    alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=f32, device=dev)
    a3 = lambda nA: (c(pt["x0"]), a4[0], a4[1], ks, Ks, d, alphas4[:nA],
                     params, merit0, D, dV1, dV2, s.terms, dt, s._wc(f32),
                     opts.defect_weight, opts.beta,
                     opts.alpha_converge_threshold)
    aev = (a4[0], a4[1], params, s.terms, dt, s._wc(f32), c(pt["x0"]))
    lin32 = {k: c(v) for k, v in lin64.items()}
    k1a = tuple(lin32[k] for k in ORDER)
    nt = lin32["Jt"].shape[1]
    k1_shape = k1.kernel_shape(nx, nu, nt, rows)
    sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
             len(rows.bx), len(rows.uc))
    stages = {"EULER": 1, "RK2": 2, "RK4": 4}[step]
    times = defaultdict(dict)
    for Bw in FAMILY_TIME_B:
        plain_too = Bw <= B_MAIN
        pl = lambda fn, reps: (cuda_ms(fn, reps=reps, warmup=1) if plain_too
                               else None)
        la = repeat_members(a4, Bw)
        out = k4.srbd_linearize(*la)
        # every stage adds the rates and ∂ω̇ of its point and the chain
        # over the nx + nu columns
        times[f"srbd_linearize_{inst}"][Bw] = dict(
            ms=cuda_ms(lambda: k4.srbd_linearize(*la), reps=20),
            plain_ms=pl(lambda: k4.srbd_linearize_plain(*la), 3),
            bytes=nbytes(la[0], la[1], *k4.kernel_params(
                la[2], Bw, ns, nc, f32, dev), rows.packed(dev), *out.values()),
            flop=stages * linearize_flops(Bw, ns, nx, nu, nc, n_rho,
                                          len(rows.rx), len(rows.ru)))
        ta = repeat_members(a3(1), Bw, skip=(6,))
        out = k3.srbd_trial(*ta)
        times[f"srbd_trial_{inst}"][Bw] = dict(
            ms=cuda_ms(lambda: k3.srbd_trial(*ta), reps=20),
            plain_ms=pl(lambda: k3.srbd_trial_plain(*ta), 3),
            bytes=nbytes(*[v for v in ta[:12] if isinstance(v, torch.Tensor)],
                         *ta[7].values(), *out),
            flop=stages * trial_flops(Bw, ns, nx, nu, nc, n_rho, 1))
        ta4 = repeat_members(a3(4), Bw, skip=(6,))
        times[f"srbd_trial_{inst}"][Bw]["ms_4alpha"] = cuda_ms(
            lambda: k3.srbd_trial(*ta4), reps=20)
        ea = repeat_members(aev, Bw)
        out = k3.srbd_evaluate(*ea[:-1], x0=ea[-1])
        times[f"srbd_evaluate_{inst}"][Bw] = dict(
            ms=cuda_ms(lambda: k3.srbd_evaluate(*ea[:-1], x0=ea[-1]), reps=20),
            plain_ms=pl(lambda: k3.srbd_evaluate_plain(*ea[:-1], x0=ea[-1]), 3),
            bytes=nbytes(ea[0], ea[1], *ea[2].values(), ea[-1], *out),
            flop=stages * evaluate_flops(Bw, ns, nx, nc, n_rho))
        ka = repeat_members(k1a, Bw)
        for shape, form, solver in k1.KERNEL_INSTANCES:
            if shape != k1_shape:
                continue
            kw = dict(form=form, quu_solver=solver)
            out = k1.riccati_backward(*ka, mu, rows, **kw)
            flop = (riccati_flops(Bw, ns, nx, nu, nt, *sizes)
                    if form == "collapsed"
                    else tassa_flops(Bw, ns, nx, nu, nt, *sizes, solver))
            times[k1_row_name(shape, form, solver)][Bw] = dict(
                ms=cuda_ms(lambda: k1.riccati_backward(*ka, mu, rows, **kw),
                           reps=10),
                plain_ms=pl(lambda: k1.riccati_backward_plain(
                    *ka, mu, rows, **kw), 2),
                bytes=nbytes(*ka, rows.packed(dev), *out), flop=flop,
                fp64_tensor_cores=True)
    for by_B in times.values():
        for v in by_B.values():
            rate = (H100_FP64_TC_FLOP_PER_S if v.pop("fp64_tensor_cores", False)
                    else H100_F32_FLOP_PER_S)
            v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flop"], rate)
            v["achieved_GB_per_s"] = v["bytes"] / v["ms"] / 1e6
            v["achieved_GFLOP_per_s"] = v["flop"] / v["ms"] / 1e6
    pick = lambda occ: {k: occ[k] for k in OCCUPANCY_KEYS}
    occ = {f"srbd_linearize_{inst}": pick(k4.occupancy(f32, inst)),
           f"srbd_trial_{inst}": pick(k3.trial_occupancy(f32, inst)),
           f"srbd_evaluate_{inst}": pick(k3.evaluate_occupancy(ns, f32, inst))}
    for shape, form, solver in k1.KERNEL_INSTANCES:
        if shape == k1_shape:
            kw = dict(form=form, quu_solver=solver)
            occ[k1_row_name(shape, form, solver)] = dict(
                blocks_per_sm=k1.blocks_per_sm(nx, nu, nt, rows, f32, **kw),
                shared_memory_bytes=k1.shared_memory_bytes(nx, nu, nt, rows,
                                                           f32, **kw))
    return times, occ


OCCUPANCY_KEYS = ("blocks_per_sm", "shared_memory_bytes",
                  "registers_per_thread", "local_bytes_per_thread")


def family_gates(tag, res, launches, inst, k1_names, twins):
    """The gates every phase-14 path shares: finite outputs, defects and
    the Newton–Euler residual ≤ 1e-4, every kernel of the path's instance
    launched (K1 at the names `k1_names`) and no other SRBD instance, no
    twin, no torch.func transform, no plain cost or defect."""
    if not res["finite"]:
        fail(f"{tag}: non-finite values")
    if max(res["defect_norm_max"], res["srbd_residual_max"]) > 1e-4:
        fail(f"{tag}: plans are not dynamically consistent (defect or "
             f"Newton-Euler residual above 1e-4): {res['defect_norm_max']}, "
             f"{res['srbd_residual_max']}")
    want = {f"{k}_{inst}" for k in ("srbd_linearize", "srbd_trial",
                                    "srbd_evaluate")} | set(k1_names)
    if set(launches) != want:
        fail(f"{tag}: the path launched {sorted(launches)}, not the kernels "
             f"of its instance {sorted(want)}")
    if any(twins[k]["n"] for k in twins):
        fail(f"{tag}: the path ran plain twins on the card: "
             f"{ {k: v['n'] for k, v in twins.items()} }")


def family_twins():
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    return ((k1, ("riccati_backward_plain",)),
            (k3, ("srbd_trial_plain", "srbd_evaluate_plain", "rollout_plain",
                  "evaluate_plain")),
            (k4, ("srbd_linearize_plain", "step_jacobians")))


def family_single_path(inst, dev, card, ticks=40, cholesky_ticks=10,
                       quadruped_walk=False):
    """One robot of one instance on `MPCLoop.tick` in float32: the dsrbd
    example's walk (vx 0.3 from tick 10; the quadruped example's trot at
    vx 0.25 from tick 10), then `cholesky_ticks` more with the Cholesky
    gain solve. Returns the figures and the launches."""
    import torch

    from srbd_horizon_tpu_torch.runtime.loop import TickInput, walking_schedule

    topology, step = family_split(inst)
    loop, prob = family_loop(topology, step, torch.float32, dev)
    vx = 0.25 if quadruped_walk else 0.3
    sched = walking_schedule(ticks, vx=vx, start=10, device=dev)
    opts = dataclasses.replace(loop.solver.opts, quu_solver="cholesky")
    cloop = dataclasses.replace(loop, solver=dataclasses.replace(
        loop.solver, opts=opts))
    guards, restore_guards = guard_plain(family_twins())
    n, restore_count = count_solver_calls(loop.solver, cloop.solver)
    carry = loop.init(prob.initial_state)
    z0 = float(prob.initial_state[2])
    outs, tms = [], []
    family_counts_reset()
    syncs0 = loop.solver.host_syncs
    for i in range(ticks):
        inp = TickInput(*(a[i] for a in sched))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, out = loop.tick(carry, inp)
        torch.cuda.synchronize()
        tms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    syncs = loop.solver.host_syncs - syncs0
    chol = []
    for _ in range(cholesky_ticks):
        carry, out = cloop.tick(carry, TickInput(*(a[-1] for a in sched)))
        chol.append(out)
    torch.cuda.synchronize()
    launches = family_counts()
    restore_count()
    restore_guards()
    iters = [int(o.iterations) for o in outs]
    com = torch.stack([o.x[:3] for o in outs]).cpu()
    every = outs + chol
    res = dict(
        instance=inst, B=1, dtype="float32", ticks=ticks,
        cholesky_ticks=cholesky_ticks,
        walk=f"vx {vx} from tick 10",
        options=("the quadruped example: max_iters=5"
                 if topology in ("quadruped", "line_feet_quadruped")
                 else "the dsrbd example: max_iters=100") +
        ", alpha_converge_threshold=1e-12, beta=1e-3",
        tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
        tick_mean_ms=statistics.fmean(tms), iterations_mean=statistics.fmean(iters),
        iterations_per_tick=iters, syncs_per_tick=syncs / ticks,
        launches=launches, trials=n["trials"], solves=n["solves"],
        defect_norm_max=max(float(o.defect_norm) for o in every),
        srbd_residual_max=max(float(o.srbd_residual.abs().max()) for o in every),
        com_z_min=float(com[:, 2].min()), com_z_max=float(com[:, 2].max()),
        z0=z0, forward_progress_m=float(com[-1, 0] - com[0, 0]),
        final_com=carry.x[:3].tolist(),
        finite=all(bool(torch.isfinite(v).all()) for o in every
                   for v in (o.x, o.u0, o.cost, o.srbd_residual)),
        **{k: v["n"] for k, v in guards.items()}, card=card)
    return res, launches, guards, loop, carry, sched


def family_fleet(inst, Bsz, dtype, device, max_iters=5, seed=SEED):
    """The SRBD fleet point on one instance: max_iters=5, the warm start
    shifted, the walk command vx 0.2, pushes of 0.005·N(0,1)."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions
    from srbd_horizon_tpu_torch.runtime.loop import walk_command

    topology, step = family_split(inst)
    loop, p = family_loop(topology, step, dtype, device,
                          opts=DDPOptions(max_iters=max_iters), shift=True)
    g = np.random.RandomState(seed)
    xn = p.initial_state.cpu().numpy()
    xs = torch.as_tensor(xn[None] + 0.005 * g.randn(Bsz, xn.shape[0]),
                         dtype=dtype, device=device)
    return loop, loop.init(xs), walk_command(Bsz, vx=0.2, dtype=dtype,
                                             device=device)


def family_fleet_path(inst, dev, card, warm, timed, profile=True):
    """`MPCLoop.tick_batch` at B=512 in float32 on one instance: `warm`
    ticks, then `timed` ticks with the launches counted; then the phases
    inside 5 ticks and 2 profiled ticks (idle share, launches a tick by
    span)."""
    import torch

    loop, c, inp = family_fleet(inst, B_MAIN, torch.float32, dev)
    guards, restore_guards = guard_plain(family_twins())
    cnt, restore = count_solver_calls(loop.solver)
    for _ in range(warm):
        c, _ = loop.tick_batch(c, inp)
    torch.cuda.synchronize()
    cnt.update(trials=0, solves=0, iterations=0)
    family_counts_reset()
    syncs0 = loop.solver.host_syncs
    tms, iters, outs = [], [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        c, o = loop.tick_batch(c, inp)
        torch.cuda.synchronize()
        tms.append((time.perf_counter() - t0) * 1e3)
        iters.append(float(o.iterations.float().mean()))
        outs.append(o)
    launches = family_counts()
    restore()
    restore_guards()
    srt = sorted(tms)
    res = dict(
        instance=inst, B=B_MAIN, dtype="float32",
        options="max_iters=5, shifted warm start, walk command vx 0.2, "
                "0.005·N(0,1) pushes (seed 0)",
        warmup_ticks=warm, ticks=timed,
        tick_p50_ms=statistics.median(tms),
        tick_p99_ms=srt[min(len(srt) - 1, int(0.99 * len(srt)))],
        tick_max_ms=max(tms), tick_mean_ms=statistics.fmean(tms),
        members_per_s=B_MAIN / statistics.median(tms) * 1e3,
        iters_mean=statistics.fmean(iters),
        syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
        trials=cnt["trials"], solves=cnt["solves"], launches=launches,
        finite=all(bool(torch.isfinite(v).all()) for o in outs
                   for v in (o.x, o.u0, o.cost)) and bool(
                       torch.isfinite(c.sol.X).all()),
        defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
        srbd_residual_max=max(float(o.srbd_residual.abs().max()) for o in outs),
        **{k: v["n"] for k, v in guards.items()}, card=card)
    if profile:
        step = lambda cc: loop.tick_batch(cc, inp)[0]
        c, res["spans"] = tick_spans(loop.solver, step, c, ticks=5)
        res["profile"] = profile_ticks(loop.solver, step, c, res["tick_p50_ms"])
        res["device_idle_share"] = res["profile"]["device_idle_share"]
        res["launches_by_span"] = res["profile"]["launches_by_span"]
    return res, launches, guards


def family_versus(card_run, cpu_run):
    """Card = CPU: iterations and convergence equal, plans, x, u0 and cost
    to 1e-9."""
    import torch

    (cc, oc), (cp, op) = card_run, cpu_run
    it = lambda o: o.iterations.reshape(-1).tolist()
    both = lambda f: (torch.stack([getattr(a, f).cpu() for a in oc]),
                      torch.stack([getattr(b, f) for b in op]))
    r = dict(
        iterations_equal=all(it(a) == it(b) for a, b in zip(oc, op)),
        converged_equal=all(torch.equal(a.converged.cpu(), b.converged)
                            for a, b in zip(oc, op)),
        iterations_card=[it(a) for a in oc],
        cost_rel_err=rel_err(*both("cost")), x_rel_err=rel_err(*both("x")),
        u0_rel_err=rel_err(*both("u0")),
        X_rel_err=rel_err(cc.sol.X.cpu(), cp.sol.X),
        U_rel_err=rel_err(cc.sol.U.cpu(), cp.sol.U))
    r["ok"] = (r["iterations_equal"] and r["converged_equal"]
               and max(r[k] for k in ("cost_rel_err", "x_rel_err",
                                      "u0_rel_err", "X_rel_err",
                                      "U_rel_err")) <= 1e-9)
    return r


def family_section(card, dev, sms):
    """Phase 14: the SRBD problem at every topology and step the JAX
    package's `build_srbd_problem` takes — the point-feet biped, and each
    topology under RK2 and RK4 — on K4, K3, srbd_evaluate and K1 (with K2
    inside). The kernel
    checks (`family_check`) and times beside the Euler counterparts
    (`family_times`), K2 at nu=12 (`family_k2_check`), the paths
    (`family_pf_single`, `family_pf_fleet`, `family_fleet` for the Kangaroo
    under RK2 and RK4, `family_kangaroo_rk4_single`,
    `family_quadruped_rk4_single`, `family_short_fleet` for the rest,
    `family_pf_rk4_single`) and card = CPU in float64
    (`family_card_vs_cpu`). Returns the kernel rows of the `kernels`
    line."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3
    from srbd_horizon_tpu_torch.runtime.loop import TickInput, walking_schedule

    t_section = time.perf_counter()
    f64 = torch.float64
    errs, k1_shapes, times, occ = {}, {}, {}, {}
    pf_Jup = None
    for inst in FAMILY_INSTANCES:
        res, k1_shape, lin64, sweep64, pt = family_check(inst, dev)
        errs[inst], k1_shapes[inst] = res, k1_shape
        t, o = family_times(inst, dev, lin64, sweep64, pt)
        times.update(t)
        occ.update(o)
        if inst == "point_feet":
            pf_Jup = lin64["Jup"]
    # the Euler counterparts, timed in the same call
    for inst in ("kangaroo", "quadruped"):
        topology, step = family_split(inst)
        loop64, prob = family_loop(topology, step, f64, dev)
        pt = family_point(loop64, prob, B_MAIN, dev, SEED + 14)
        s = loop64.solver
        lin64 = k4.srbd_linearize_plain(pt["X"], pt["U"], pt["params"],
                                        s.terms, s.rows, prob.ocp.dt,
                                        s._wc(f64))
        sweep = k1.riccati_backward_plain(*(lin64[k] for k in ORDER),
                                          s.opts.mu0, s.rows)
        t, o = family_times(inst, dev, lin64, sweep, pt)
        times.update(t)
        occ.update(o)
    emit("family_times", card=card, dtype="float32", sms=sms,
         times={k: {str(b): v for b, v in d.items()} for k, d in times.items()},
         occupancy=occ)
    k2 = k2_check("family_k2_check", k1, pf_Jup, 1e-6, nu=12)

    # ---- the paths ----
    path_launches = defaultdict(int)

    def add(launches):
        for k, v in launches.items():
            path_launches[k] += v

    def k1_names(inst, forms):
        return [k1_row_name(k1_shapes[inst], f, s) for f, s in forms]

    tassa_both = (("tassa", "schur"), ("tassa", "cholesky"))
    collapsed = (("collapsed", "schur"),)

    def biped_gates(tag, res):
        if max(abs(res["com_z_min"] - FAMILY_HEIGHT),
               abs(res["com_z_max"] - FAMILY_HEIGHT)) > FAMILY_HEIGHT_BAND:
            fail(f"{tag}: the CoM height left {FAMILY_HEIGHT} ± "
                 f"{FAMILY_HEIGHT_BAND}: {res['com_z_min']}, {res['com_z_max']}")
        if not res["forward_progress_m"] > FAMILY_PROGRESS:
            fail(f"{tag}: forward progress {res['forward_progress_m']} m at "
                 f"tick 39, not above {FAMILY_PROGRESS}")

    T = FAMILY_SINGLE_TICKS
    singles = (("family_pf_single", "point_feet", T),
               ("family_kangaroo_rk4_single", "kangaroo_rk4", T),
               ("family_quadruped_rk4_single", "quadruped_rk4", T),
               ("family_pf_rk4_single", "point_feet_rk4", FAMILY_SHORT_TICKS))
    for tag, inst, ticks in singles:
        quad = inst.startswith("quadruped")
        res, launches, guards, *_ = family_single_path(
            inst, dev, card, ticks=ticks,
            cholesky_ticks=FAMILY_CHOLESKY_TICKS, quadruped_walk=quad)
        emit(tag, **res)
        family_gates(tag, res, launches, inst, k1_names(inst, tassa_both),
                     guards)
        if ticks == FAMILY_SINGLE_TICKS and quad:
            if max(abs(res["com_z_min"] - res["z0"]),
                   abs(res["com_z_max"] - res["z0"])) >= QUAD_HEIGHT_BAND:
                fail(f"{tag}: the trot's CoM height left z0 ± "
                     f"{QUAD_HEIGHT_BAND}: {res['com_z_min']}, "
                     f"{res['com_z_max']}")
            if not res["forward_progress_m"] > 0:
                fail(f"{tag}: the trot made no forward progress")
        elif ticks == FAMILY_SINGLE_TICKS:
            biped_gates(tag, res)
        if launches.get(f"srbd_evaluate_{inst}", 0) != 2 * res["solves"]:
            fail(f"{tag}: srbd_evaluate launches are not two a solve")
        if launches.get(f"srbd_trial_{inst}", 0) != res["trials"]:
            fail(f"{tag}: K3 launches do not cover the trials")
        add(launches)

    fleets = (("family_pf_fleet", "point_feet", FAMILY_FLEET_TIMED, True),
              ("family_kangaroo_rk2_fleet", "kangaroo_rk2", FAMILY_FLEET_TIMED, True),
              ("family_kangaroo_rk4_fleet", "kangaroo_rk4", FAMILY_FLEET_TIMED, True),
              ("family_short_fleet_quadruped_rk2", "quadruped_rk2",
               FAMILY_SHORT_TICKS, False),
              ("family_short_fleet_point_feet_rk2", "point_feet_rk2",
               FAMILY_SHORT_TICKS, False),
              ("family_short_fleet_point_feet_rk4", "point_feet_rk4",
               FAMILY_SHORT_TICKS, False))
    for tag, inst, timed, prof in fleets:
        res, launches, guards = family_fleet_path(
            inst, dev, card, FAMILY_FLEET_WARM if prof else 0, timed, prof)
        emit(tag, **res)
        family_gates(tag, res, launches, inst, k1_names(inst, collapsed),
                     guards)
        if launches.get(f"srbd_evaluate_{inst}", 0) != 2 * res["solves"]:
            fail(f"{tag}: srbd_evaluate launches are not two a solve")
        if launches.get(f"srbd_trial_{inst}", 0) != res["trials"]:
            fail(f"{tag}: K3 launches do not cover the trials")
        add(launches)

    # ---- family_card_vs_cpu: float64, the point-feet robot and the
    # Kangaroo RK4 fleet at B=8, 3 ticks each ----
    def single_ticks(device, n_ticks):
        loop, p = family_loop("point_feet", "EULER", f64, device)
        sch = walking_schedule(n_ticks, vx=0.3, start=1, dtype=f64,
                               device=device)
        c = loop.init(p.initial_state)
        res = []
        for i in range(n_ticks):
            c, o = loop.tick(c, TickInput(*(a[i] for a in sch)))
            res.append(o)
        return c, res

    def fleet_ticks(device, n_ticks):
        loop, c, inp = family_fleet("kangaroo_rk4", 8, f64, device)
        res = []
        for _ in range(n_ticks):
            c, o = loop.tick_batch(c, inp)
            res.append(o)
        return c, res

    fvc = dict(tol=1e-9,
               point_feet_single=dict(ticks=3, walk="vx 0.3 from tick 1",
                                      **family_versus(single_ticks(dev, 3),
                                                      single_ticks("cpu", 3))),
               kangaroo_rk4_fleet_B8=dict(ticks=3, **family_versus(
                   fleet_ticks(dev, 3), fleet_ticks("cpu", 3))))
    emit("family_card_vs_cpu", **fvc)
    if not (fvc["point_feet_single"]["ok"] and fvc["kangaroo_rk4_fleet_B8"]["ok"]):
        fail("the phase-14 card path and CPU path disagree")

    # ---- the kernel rows: launches from this phase's paths ----
    trial_tol = "2*plain_rel_err_f32 + 1e-6"
    specs = []                 # (row name, module, error key, source instance)
    for inst in FAMILY_INSTANCES:
        specs += [(f"srbd_linearize_{inst}", k4, "k4", inst),
                  (f"srbd_trial_{inst}", k3, "k3", inst),
                  (f"srbd_evaluate_{inst}", k3, "evaluate", inst)]
    new_shapes = {k1_shapes[i]: i for i in reversed(FAMILY_INSTANCES)}
    for shape, form, solver in k1.KERNEL_INSTANCES:
        if shape in new_shapes:
            name = k1_row_name(shape, form, solver)
            specs.append((name, k1, name, new_shapes[shape]))
    rows_out = []
    for name, mod, key, inst in specs:
        t, e = times[name], errs[inst]
        tassa_row = "_tassa" in name
        Bt = 1 if tassa_row else B_MAIN
        tt = t[Bt]
        err = dict(e64=e[key + "_e64"], e32=e[key + "_e32"],
                   p32=e[key + "_p32"], abs32=e[key + "_abs32"])
        tol32 = (K1_F32_TOL if mod is k1
                 else f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}"
                 if key == "k4" else trial_tol)
        row = kernel_row(name, mod, path_launches.get(name, 0), tt["ms"],
                         tt["plain_ms"], tt["bound_ms"], tt["bound_by"], err,
                         tol32, B=Bt, instance=inst,
                         ms_by_B={str(b): v["ms"] for b, v in t.items()},
                         plain_ms_by_B={str(b): v["plain_ms"]
                                        for b, v in t.items()},
                         bound_ms_by_B={str(b): v["bound_ms"]
                                        for b, v in t.items()},
                         achieved_GB_per_s=tt["achieved_GB_per_s"],
                         launches_of="phase 14's paths", **occ.get(name, {}))
        row["tol_f64"] = 1e-9 if mod is k1 else FAMILY_F64_TOL
        if key == "evaluate":
            row["replaces"] = k3.EVALUATE_REPLACES
        elif tassa_row:
            row["replaces"] = k1.TASSA_REPLACES
        if key == "k3":
            row["ms_4alpha"] = tt["ms_4alpha"]
        rows_out.append(row)
    pf_shapes = {k1_shapes[i] for i in FAMILY_INSTANCES
                 if i.startswith("point_feet")}
    k2_launches = sum(
        n for (shape, form, solver), n in zip(
            k1.KERNEL_INSTANCES, [path_launches.get(k1_row_name(*ki), 0)
                                  for ki in k1.KERNEL_INSTANCES])
        if shape in pf_shapes and solver == "schur")
    rows_out.append(dict(kernel_row(
        "spd_inverse_nu12", k1, k2_launches, k2["ms_f32"], k2["plain_ms_f32"],
        k2["bound_ms"], k2["bound_by"],
        dict(e64=k2["f64_rel_err"], e32=k2["f32_rel_err"],
             p32=k2["f32_plain_rel_err"], abs32=k2["f32_max_abs_err"]),
        K2_F32_TOL, launches_of="K1 with the block-Schur inverse at the "
        "point-feet shapes on phase 14's paths (K2 runs inside K1)",
        stack=k2["stack"], ms_f64=k2["ms_f64"],
        library_ms_f32=k2["torch_linalg_inv_ms_f32"]),
        replaces=k1.K2_REPLACES, library_ms=k2["torch_linalg_inv_ms_f64"]))
    missing = [r["name"] for r in rows_out if r["launches"] == 0]
    if missing:
        fail(f"phase 14: kernels not launched on its paths: {missing}")
    emit("family_section", seconds=time.perf_counter() - t_section, card=card,
         rows=len(rows_out), path_launches=dict(path_launches))
    return rows_out


# ---------------- the execution modes at every SRBD topology and step (phase 15) ----

# K12's shapes this phase adds, each checked and timed on the point of one
# (topology, step) instance (RK2 and RK4 share K1's shape); K13's families
# are the instances of FAMILY_INSTANCES themselves. Of K1's three
# Tassa-Cholesky instantiations, this phase checks the Euler quadruped's;
# phase 14 checks and times the RK shapes' with every K1 instantiation at
# its shapes, and its rows count their launches over phase 14's and this
# phase's paths.
MF_K12 = (("point_feet", "point_feet"), ("srbd_rk", "kangaroo_rk2"),
          ("quadruped_rk", "quadruped_rk2"),
          ("point_feet_rk", "point_feet_rk2"))
MF_CHECK_B = (1, 64, B_MAIN)
MF_TIME_B = (1, B_MAIN, B_LARGE)
MF_TICKS, MF_SHORT_TICKS, MF_CHOLESKY_TICKS = 20, 10, 5
MF_LINEAR = dict(riccati_mode="associative", forward_pass="linear")
# A solve under forward_pass="linear" ends on the linearized pass's plan,
# whose true defects close only as the iterations converge: the JAX
# package's own point-feet walk under associative/linear reads a largest
# defect norm of 6.47e-4 (float64; the port's CPU twins the same, equal
# iterations) and 8.34e-4 (float32) at ticks 19 / 21 (`JAX_PLATFORMS=cpu
# python tests/modes_walk_reference.py point_feet EULER f64 associative
# linear 40`). That instance's linear-pass paths are held to 1e-3; every
# other path, and every instance whose reference reads below 1e-4, to 1e-4.
MF_LINEAR_DEFECT = {"point_feet": 1e-3}


def mf_k1_shape(inst):
    """K1's shape name of a (topology, step) instance (RK2 and RK4 share
    one)."""
    topology, step = family_split(inst)
    base = {"kangaroo": "srbd", "quadruped": "quadruped",
            "point_feet": "point_feet"}[topology]
    return base if step == "EULER" else base + "_rk"


def mf_row_k12(shape, solver):
    return ("riccati_associative_" + shape
            + ("_cholesky" if solver == "cholesky" else ""))


def mf_counts_reset(base=None):
    """Zero every SRBD instance's and K1's counts (`family_counts_reset`, or
    `base`'s), K12's and K13's."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    (base or family_counts_reset)()
    k12.riccati_associative.launches = 0
    k12.riccati_associative.instance_launches[:] = [0] * len(
        k12.KERNEL_INSTANCES)
    k13.linear_trial.launches = 0
    k13.linear_trial.family_launches[:] = [0] * len(k13.FAMILIES)


def mf_counts(base=None):
    """`family_counts` (or `base`'s) with K12's sweeps by instantiation and
    K13's launches by family, under their row names (zeros left out)."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    out = (base or family_counts)()
    for (shape, sv), n in zip(k12.KERNEL_INSTANCES,
                              k12.riccati_associative.instance_launches):
        if n:
            out[mf_row_k12(shape, sv)] = n
    for name, n in zip(k13.FAMILY_NAMES, k13.linear_trial.family_launches):
        if n:
            out["linear_trial_" + name] = n
    return out


def mf_point(inst, dev, seed):
    """One (topology, step) instance's drawn point at B=512 in float64 on
    the card (`family_point`'s plans and contact plan, linearized by K4)
    with the gains of K12's block-Schur twin, D and merit0: the `p` the
    modes' check and time helpers take (`fam`: K13's family name)."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    f64 = torch.float64
    topology, step = family_split(inst)
    loop64, prob = family_loop(topology, step, f64, dev)
    loop32, _ = family_loop(topology, step, torch.float32, dev)
    s, ocp = loop64.solver, prob.ocp
    pt = family_point(loop64, prob, B_MAIN, dev, seed)
    lin = k4.srbd_linearize(pt["X"], pt["U"], pt["params"], s.terms, s.rows,
                            ocp.dt, s._wc(f64))
    assert k1.kernel_shape(ocp.nx, ocp.nu, lin["Jt"].shape[1], s.rows) \
        == mf_k1_shape(inst)
    gains = k12.riccati_associative_plain(*(lin[k] for k in ORDER),
                                          s.opts.mu0, s.rows)
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    merit0 = s.total_cost(pt["X"], pt["U"], pt["params"]) + \
        s.opts.defect_weight * D
    return dict(s=s, s32=loop32.solver, ocp=ocp, lin=lin, X=pt["X"],
                U=pt["U"], x0=pt["x0"], params=pt["params"], gains=gains,
                D=D, merit0=merit0, nt=lin["Jt"].shape[1], fam=inst)


def mf_k1_check(shape, p, card):
    """K1's Tassa form with the Cholesky gains at `shape` (the Euler
    quadruped's; phase 14 checks the RK shapes') against its twin
    at B = 1, 64 and 512: float64 to 1e-9, float32 to K1_F32_TOL of the
    float64 twin; then `tassa_check` at B=512 (a NaN member, an indefinite
    Quu). Returns the error figures; fails the run on disagreement."""
    import torch

    from srbd_horizon_tpu_torch.kernels import riccati as k1

    s = p["s"]
    mu, rows = s.opts.mu0, s.rows
    kw = dict(form="tassa", quu_solver="cholesky")
    e = dict(e64={}, e32={}, p32={}, abs32=0.0)
    for Bw in MF_CHECK_B:
        a64 = tuple(p["lin"][k][:Bw].contiguous() for k in ORDER)
        a32 = tuple(v.float().contiguous() for v in a64)
        ref = k1.riccati_backward_plain(*a64, mu, rows, **kw)
        got = k1.riccati_backward(*a64, mu, rows, **kw)
        g32 = k1.riccati_backward(*a32, mu, rows, **kw)
        p32 = k1.riccati_backward_plain(*a32, mu, rows, **kw)
        torch.cuda.synchronize()
        for name, g, r, gg, pp in zip(SWEEP_OUT, got, ref, g32, p32):
            key = f"{name}_B{Bw}"
            e["e64"][key], e["e32"][key] = rel_err(g, r), rel_err(gg, r)
            e["p32"][key] = rel_err(pp, r)
            e["abs32"] = max(e["abs32"], abs_err(gg, r))
    emit("mf_k1_check", shape=shape, form="tassa", quu_solver="cholesky",
         sizes=MF_CHECK_B, tol_f64=1e-9, tol_f32=K1_F32_TOL, card=card, **e)
    if max(e["e64"].values()) > 1e-9 or max(e["e32"].values()) > K1_F32_TOL:
        fail(f"K1 Tassa-Cholesky at {shape} disagrees with its twin: {e}")
    tassa_check("mf_k1_tassa_check", k1, p["lin"], mu, rows, "cholesky",
                FAMILY_NAN, shape=shape, B=B_MAIN, card=card)
    return e


def mf_k1_times(shape, p):
    """K1's Tassa-Cholesky form at `shape` in float32 at B = 1, 512 and
    4096 (members repeated), the twin at B = 1 and 512, the bytes, FLOPs
    and bound of each call, its shared memory and blocks an SM."""
    import torch

    from srbd_horizon_tpu_torch.kernels import riccati as k1

    f32 = torch.float32
    s, ocp = p["s"], p["ocp"]
    mu, rows = s.opts.mu0, s.rows
    kw = dict(form="tassa", quu_solver="cholesky")
    lin32 = tuple(p["lin"][k].float().contiguous() for k in ORDER)
    sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
             len(rows.bx), len(rows.uc))
    ns, nx, nu, nt = ocp.ns, ocp.nx, ocp.nu, p["nt"]
    t = dict(shared_memory_bytes=k1.shared_memory_bytes(nx, nu, nt, rows, f32,
                                                        **kw),
             blocks_per_sm=k1.blocks_per_sm(nx, nu, nt, rows, f32, **kw),
             by_B={})
    for Bw in MF_TIME_B:
        a = repeat_members(lin32, Bw)
        out = k1.riccati_backward(*a, mu, rows, **kw)
        nb = nbytes(*a, rows.packed(a[0].device), *out)
        fl = tassa_flops(Bw, ns, nx, nu, nt, *sizes, "cholesky")
        bms, by = bound(nb, fl, H100_FP64_TC_FLOP_PER_S)
        t["by_B"][Bw] = dict(
            ms=cuda_ms(lambda: k1.riccati_backward(*a, mu, rows, **kw),
                       reps=10 if Bw < B_LARGE else 3),
            plain_ms=(cuda_ms(lambda: k1.riccati_backward_plain(
                *a, mu, rows, **kw), reps=2, warmup=1) if Bw <= B_MAIN
                else None),
            bytes=nb, flop=fl, bound_ms=bms, bound_by=by)
    return t


def mf_segment(inst, dev, card, opts, ticks, fleet=False, vx=0.3, start=5):
    """One run of an instance's loop in float32 with DDPOptions `opts`
    (with the dsrbd example's, or the quadruped example's on the
    quadruped, under them): a robot on `MPCLoop.tick` for `ticks` ticks of
    `walking_schedule(vx, start)` (the quadruped at vx 0.25), or the fleet
    (B=512, shifted warm start, walk command vx 0.2, 0.005·N(0,1) pushes)
    on `tick_batch`, one warm tick, then `ticks` timed; counted from a
    reset just before to a read just after, the plain twins guarded.
    Returns the figures with the launches by row name."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
    from srbd_horizon_tpu_torch.runtime.loop import (TickInput, walk_command,
                                                     walking_schedule)

    topology, step = family_split(inst)
    loop, prob = family_loop(topology, step, torch.float32, dev, opts=opts,
                             shift=fleet)
    if fleet:
        g = np.random.RandomState(SEED)
        xn = prob.initial_state.cpu().numpy()
        carry = loop.init(torch.as_tensor(
            xn[None] + 0.005 * g.randn(B_MAIN, xn.shape[0]),
            dtype=torch.float32, device=dev))
        inp = walk_command(B_MAIN, vx=0.2, device=dev)
        carry, _ = loop.tick_batch(carry, inp)
        tick = lambda c, i: loop.tick_batch(c, inp)
    else:
        carry = loop.init(prob.initial_state)
        sched = walking_schedule(ticks, vx=0.25 if topology == "quadruped"
                                 else vx, start=start, device=dev)
        tick = lambda c, i: loop.tick(c, TickInput(*(a[i] for a in sched)))
    torch.cuda.synchronize()
    guards, restore_guards = guard_plain(family_twins() + (
        (k12, ("riccati_associative_plain",)), (k13, ("linear_trial_plain",))))
    n, restore = count_solver_calls(loop.solver)
    mf_counts_reset()
    syncs0, outs, tms = loop.solver.host_syncs, [], []
    try:
        for i in range(ticks):
            t0 = time.perf_counter()
            carry, o = tick(carry, i)
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
            outs.append(o)
        launches = mf_counts()
    finally:
        restore()
        restore_guards()
    com = torch.stack([o.x[..., :3] for o in outs]).cpu()
    so = loop.solver.opts
    res = dict(
        instance=inst, B=B_MAIN if fleet else 1, dtype="float32", ticks=ticks,
        riccati_mode=so.riccati_mode, forward_pass=so.forward_pass,
        quu_solver=so.quu_solver, max_iters=so.max_iters,
        tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
        tick_mean_ms=statistics.fmean(tms),
        syncs_per_tick=(loop.solver.host_syncs - syncs0) / ticks,
        launches=launches, counted=dict(n),
        finite=all(bool(torch.isfinite(v).all()) for o in outs
                   for v in (o.x, o.u0, o.cost, o.srbd_residual)),
        defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
        srbd_residual_max=max(float(o.srbd_residual.abs().max())
                              for o in outs),
        **{k: v["n"] for k, v in guards.items()}, card=card)
    if not fleet:
        res.update(z0=float(prob.initial_state[2]),
                   com_z_min=float(com[:, 2].min()),
                   com_z_max=float(com[:, 2].max()),
                   forward_progress_m=float(com[-1, 0] - com[0, 0]))
    return res


def mf_gates(tag, res, inst):
    """Finite outputs; defects ≤ 1e-4 (MF_LINEAR_DEFECT's limit for its
    instances under the linear forward pass) and the Newton–Euler
    residual ≤ 1e-4; no
    plain twin, torch.func transform or plain cost on the card; the
    instance's K4 and srbd_evaluate launched (the evaluation two a solve)
    and no other instance's; under the associative sweep one K12 sweep at
    the shape's instantiation with the run's gain solve an iteration and
    no K1, under the sequential one K1's sweep (the Tassa form with the
    gain solve on one robot, the collapsed form on the fleet) an
    iteration and no K12; K13 at the instance's family on the linear
    trials and K3 on the rollout trials."""
    L, n, k1_shape = res["launches"], res["counted"], mf_k1_shape(inst)
    if not res["finite"]:
        fail(f"{tag}: non-finite values")
    limit = (MF_LINEAR_DEFECT.get(inst, 1e-4)
             if res["forward_pass"] == "linear" else 1e-4)
    if res["defect_norm_max"] > limit or res["srbd_residual_max"] > 1e-4:
        fail(f"{tag}: plans are not dynamically consistent (defect above "
             f"{limit} or Newton-Euler residual above 1e-4): "
             f"{res['defect_norm_max']}, {res['srbd_residual_max']}")
    if (res["plain_twin_calls"] or res["torch_func_calls"]
            or res["plain_cost_or_defect_calls"]):
        fail(f"{tag} ran plain twins on the card: {res}")
    assoc = res["riccati_mode"] == "associative"
    sweep = (mf_row_k12(k1_shape, res["quu_solver"]) if assoc else
             k1_row_name(k1_shape, "collapsed", "schur") if res["B"] > 1 else
             k1_row_name(k1_shape, "tassa", res["quu_solver"]))
    want = {f"srbd_linearize_{inst}": n["iterations"],
            f"srbd_evaluate_{inst}": 2 * n["solves"], sweep: n["iterations"]}
    if n["linear_trials"]:
        want["linear_trial_" + inst] = n["linear_trials"]
    if n["rollout_trials"]:
        want[f"srbd_trial_{inst}"] = n["rollout_trials"]
    if L != want or min(want.values()) == 0:
        fail(f"{tag}: the path launched {L}, not {want} (counted {n})")
    if res["forward_pass"] == "linear" and not n["linear_trials"]:
        fail(f"{tag}: no linear trial ran under forward_pass='linear'")


def modes_family_section(card, dev, sms, family_rows):
    """Phase 15: the JAX package's execution modes and the Cholesky gain
    solve at every SRBD shape phase 14 added — K12 at the point-feet
    biped's and the three RK shapes with both gain solves, K13 at the seven
    (topology, step) families (the true defects in the problem's own
    step), K1's Tassa-Cholesky form at `quadruped` (phase 14 checks it at
    `quadruped_rk` and `point_feet_rk`; their rows add this phase's
    launches). Each against its twin at B = 1, 64 and 512 in float64 and
    float32 (K12 to K12_F64_TOL, K13 to 1e-9 with the flags equal at 1
    and 4 step sizes, K1 to 1e-9; float32 to 1e-6 of the float64 twin);
    `mf_times`: float32 at B = 1, 512 and 4096, K12 beside K1-Tassa with
    the same gain solve in the same call (`mf_k12_vs_k1_tassa`); the
    paths at full width and ns=20 (`mf_segment`: the point-feet biped's
    dsrbd walk under associative/linear and 10 ticks with Cholesky gains,
    the Kangaroo's RK2 fleet at B=512 under the modes, its RK4 walk under
    the modes with Cholesky gains, the quadruped's RK2 / RK4 trots under
    the modes and a few ticks each with Cholesky gains under the default
    ones, its Euler trot with Cholesky gains, the point-feet biped's RK2 /
    RK4 walks under the modes and with Cholesky gains), each gated by
    `mf_gates`; card = CPU in float64 (`mf_card_vs_cpu`: the point-feet
    walk and the Kangaroo's RK2 fleet at B=8 under the modes). Returns the
    sixteen kernel rows."""
    import dataclasses

    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
    from srbd_horizon_tpu_torch.runtime.loop import TickInput, walking_schedule
    from srbd_horizon_tpu_torch.solvers.options import ddp_example_options

    t_section = time.perf_counter()
    f64 = torch.float64
    # ---- the points and their checks: K13 at every family, K12 and K1 at
    # the shapes whose point each names ----
    pts, errs, times = {}, {}, {}
    k12_at = {inst: shape for shape, inst in MF_K12}
    for i, inst in enumerate(("quadruped",) + FAMILY_INSTANCES):
        p = mf_point(inst, dev, SEED + 150 + i)
        if inst == "quadruped":
            errs["k1"] = mf_k1_check(inst, p, card)
            times["k1"] = mf_k1_times(inst, p)
        else:
            errs["k13", inst] = modes_k13_check(p, MF_CHECK_B, card)
            for nA in (1, 4):
                times["k13", inst, nA] = modes_k13_times(p, nA, MF_TIME_B,
                                                         B_MAIN)
        if inst in k12_at:
            shape = k12_at[inst]
            q = dict(p, fam=shape)
            for sv in ("schur", "cholesky"):
                errs["k12", shape, sv] = modes_k12_check(q, sv, MF_CHECK_B,
                                                         card)
                times["k12", shape, sv] = modes_k12_times(
                    q, sv, MF_TIME_B, B_MAIN, sv)
        del p
    torch.cuda.empty_cache()
    emit("mf_times", card=card, dtype="float32", sms=sms,
         rate="FP64 tensor cores, 67 TFLOP/s (K1, K12, K13 compute in "
              "float64)",
         **{"_".join(map(str, k)): v for k, v in times.items()})
    emit("mf_k12_vs_k1_tassa", card=card, dtype="float32",
         **{f"{shape}_{sv}": {str(Bw): dict(
             riccati_associative_ms=v["ms"],
             riccati_backward_tassa_ms=v["k1_tassa_ms"])
             for Bw, v in times["k12", shape, sv]["by_B"].items()}
            for shape, _ in MF_K12 for sv in ("schur", "cholesky")})

    # ---- the paths ----
    biped = lambda **kw: dataclasses.replace(ddp_example_options(), **kw)
    quad = lambda **kw: DDPOptions(max_iters=5, alpha_converge_threshold=1e-12,
                                   beta=1e-3, **kw)
    chol = dict(quu_solver="cholesky")
    T, S, C = MF_TICKS, MF_SHORT_TICKS, MF_CHOLESKY_TICKS
    segments = (
        ("mf_pf_walk", "point_feet", biped(**MF_LINEAR), FAMILY_SINGLE_TICKS,
         False),
        ("mf_pf_walk_cholesky", "point_feet", biped(**MF_LINEAR, **chol), S,
         False),
        ("mf_kangaroo_rk2_fleet", "kangaroo_rk2",
         DDPOptions(max_iters=5, **MF_LINEAR), 3, True),
        ("mf_kangaroo_rk4_walk_cholesky", "kangaroo_rk4",
         biped(**MF_LINEAR, **chol), T, False),
        ("mf_quadruped_rk2_trot", "quadruped_rk2", quad(**MF_LINEAR), T,
         False),
        ("mf_quadruped_rk2_trot_tassa_cholesky", "quadruped_rk2",
         quad(**chol), C, False),
        ("mf_quadruped_rk4_trot_cholesky", "quadruped_rk4",
         quad(**MF_LINEAR, **chol), T, False),
        ("mf_quadruped_rk4_trot_tassa_cholesky", "quadruped_rk4",
         quad(**chol), C, False),
        ("mf_quadruped_trot_tassa_cholesky", "quadruped", quad(**chol), S,
         False),
        ("mf_pf_rk2_walk", "point_feet_rk2", biped(**MF_LINEAR), S, False),
        ("mf_pf_rk4_walk_cholesky", "point_feet_rk4",
         biped(**MF_LINEAR, **chol), S, False),
        ("mf_pf_rk2_walk_tassa_cholesky", "point_feet_rk2", biped(**chol), C,
         False))
    path_launches, by_path = defaultdict(int), defaultdict(dict)
    for tag, inst, opts, ticks, fleet in segments:
        res = mf_segment(inst, dev, card, opts, ticks, fleet=fleet)
        emit(tag, **res)
        mf_gates(tag, res, inst)
        if tag == "mf_pf_walk":
            if max(abs(res["com_z_min"] - FAMILY_HEIGHT),
                   abs(res["com_z_max"] - FAMILY_HEIGHT)) > FAMILY_HEIGHT_BAND:
                fail(f"{tag}: the CoM height left {FAMILY_HEIGHT} ± "
                     f"{FAMILY_HEIGHT_BAND}: {res['com_z_min']}, "
                     f"{res['com_z_max']}")
            if not res["forward_progress_m"] > FAMILY_PROGRESS:
                fail(f"{tag}: forward progress {res['forward_progress_m']} m "
                     f"at tick 39, not above {FAMILY_PROGRESS}")
        for k, v in res["launches"].items():
            path_launches[k] += v
            by_path[k][tag] = v

    # ---- mf_card_vs_cpu: float64, 3 ticks each ----
    def single_ticks(device, n_ticks):
        loop, p = family_loop("point_feet", "EULER", f64, device,
                              opts=biped(**MF_LINEAR))
        sch = walking_schedule(n_ticks, vx=0.3, start=1, dtype=f64,
                               device=device)
        c, res = loop.init(p.initial_state), []
        for i in range(n_ticks):
            c, o = loop.tick(c, TickInput(*(a[i] for a in sch)))
            res.append(o)
        return c, res

    def fleet_ticks(device, n_ticks):
        from srbd_horizon_tpu_torch.runtime.loop import walk_command

        loop, p = family_loop("kangaroo", "RK2", f64, device,
                              opts=DDPOptions(max_iters=5, **MF_LINEAR),
                              shift=True)
        g = np.random.RandomState(SEED)
        xn = p.initial_state.cpu().numpy()
        c = loop.init(torch.as_tensor(xn[None] + 0.005 * g.randn(8, xn.shape[0]),
                                      dtype=f64, device=device))
        inp, res = walk_command(8, vx=0.2, dtype=f64, device=device), []
        for _ in range(n_ticks):
            c, o = loop.tick_batch(c, inp)
            res.append(o)
        return c, res

    cvc = dict(tol=1e-9, modes="associative/linear",
               point_feet_single=dict(ticks=3, walk="vx 0.3 from tick 1",
                                      **family_versus(single_ticks(dev, 3),
                                                      single_ticks("cpu", 3))),
               kangaroo_rk2_fleet_B8=dict(ticks=3, **family_versus(
                   fleet_ticks(dev, 3), fleet_ticks("cpu", 3))))
    emit("mf_card_vs_cpu", **cvc)
    if not (cvc["point_feet_single"]["ok"]
            and cvc["kangaroo_rk2_fleet_B8"]["ok"]):
        fail("the phase-15 card path and CPU path disagree")

    # ---- the kernel rows: launches from this phase's paths ----
    rows_out = []
    for shape, _ in MF_K12:
        for sv in ("schur", "cholesky"):
            name = mf_row_k12(shape, sv)
            rows_out.append(modes_k12_row(
                name, times["k12", shape, sv], errs["k12", shape, sv],
                path_launches.get(name, 0), B_MAIN, quu_solver=sv,
                shape=shape, launches_by_path=by_path.get(name, {}),
                launches_of="phase 15's paths"))
    for inst in FAMILY_INSTANCES:
        name = "linear_trial_" + inst
        rows_out.append(modes_k13_row(
            name, times["k13", inst, 1], times["k13", inst, 4],
            errs["k13", inst], path_launches.get(name, 0), B_MAIN,
            family=inst, launches_by_path=by_path.get(name, {}),
            launches_of="phase 15's paths"))
    name = k1_row_name("quadruped", "tassa", "cholesky")
    t, e = times["k1"], errs["k1"]
    b1 = t["by_B"][1]
    rows_out.append(dict(kernel_row(
        name, k1, path_launches.get(name, 0), b1["ms"], b1["plain_ms"],
        b1["bound_ms"], b1["bound_by"], e, K1_F32_TOL, B=1,
        quu_solver="cholesky",
        ms_by_B={str(b): v["ms"] for b, v in t["by_B"].items()},
        plain_ms_by_B={str(b): v["plain_ms"] for b, v in t["by_B"].items()},
        bound_ms_by_B={str(b): v["bound_ms"] for b, v in t["by_B"].items()},
        shared_memory_bytes=t["shared_memory_bytes"],
        blocks_per_sm=t["blocks_per_sm"],
        launches_by_path=by_path.get(name, {}),
        launches_of="phase 15's paths"), replaces=k1.TASSA_REPLACES))
    # phase 14's rows of K1's Tassa-Cholesky form at the RK shapes count
    # this phase's launches too
    for r in family_rows:
        if r["name"].endswith("_tassa_cholesky") and r["name"] in by_path:
            r["launches_by_path"] = {"phase 14's paths": r["launches"],
                                     **by_path[r["name"]]}
            r["launches"] += path_launches[r["name"]]
            r["launches_of"] = "phase 14's and phase 15's paths"
    missing = [r["name"] for r in rows_out if r["launches"] == 0]
    if missing:
        fail(f"phase 15: kernels not launched on its paths: {missing}")
    emit("modes_family_section", seconds=time.perf_counter() - t_section,
         card=card, rows=len(rows_out), path_launches=dict(path_launches))
    return rows_out


# ---------------- the LIP at every topology and step (phase 16) -----------

# the (topology, step) instances phase 16 adds, in lip_linearize.KERNEL_SHAPES
# names: the point-feet quadruped and biped under Euler, each topology
# under RK2 and RK4
LIP_FAMILY_INSTANCES = ("quadruped", "point_feet", "kangaroo_rk2",
                        "kangaroo_rk4", "quadruped_rk2", "quadruped_rk4",
                        "point_feet_rk2", "point_feet_rk4")
LIP_FAMILY_NAN = 7              # the member with a NaN state / plan


def lip_family_loop(inst, dtype, device, opts=None, shift=False):
    """The LIP loop of one instance (`build_lip_loop`: the dlip example's
    options unless `opts` says otherwise; the point-feet biped with
    `point_feet()`, the quadruped with its robot and the trot WPG, the
    line-feet quadruped with its robot and the trot's 8-entry mask)."""
    from srbd_horizon_tpu_torch.config import SRBDConfig
    from srbd_horizon_tpu_torch.models.kangaroo import (kangaroo_line_feet,
                                                        point_feet)
    from srbd_horizon_tpu_torch.models.quadruped import (quadruped_point_feet,
                                                         trot_group_mask)
    from srbd_horizon_tpu_torch.runtime.loop import build_lip_loop

    topology, step = family_split(inst)
    topo, robot, mask = {
        "kangaroo": ({}, kangaroo_line_feet, None),
        "quadruped": (QUAD_TOPOLOGY, quadruped_point_feet, trot_group_mask()),
        "point_feet": (dict(contact_model=1, number_of_legs=2), point_feet,
                       None),
        "square_feet": (SQUARE_TOPOLOGY, square_feet_robot, None),
        "line_feet_quadruped": (LINE_FEET_TOPOLOGY, line_feet_robot,
                                line_feet_mask())}[topology]
    return build_lip_loop(SRBDConfig(dtype=dtype, **topo), opts,
                          robot=robot(),
                          shift_warmstart=shift, dtype=dtype, device=device,
                          group_mask=mask, integrator=step)


def lip_family_counts_reset():
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1

    for fn in (k10.lip_linearize, k11.lip_trial, k11.lip_evaluate):
        fn.launches = 0
        fn.shape_launches.update(dict.fromkeys(fn.shape_launches, 0))
    k1.riccati_backward.launches = 0
    k1.riccati_backward.instance_launches[:] = [0] * len(k1.KERNEL_INSTANCES)


def lip_family_counts():
    """The launches of every LIP instance of K10, K11, lip_evaluate and of
    every K1 instantiation since the last reset (zeros left out)."""
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1

    out = {}
    for name, fn in (("lip_linearize", k10.lip_linearize),
                     ("lip_trial", k11.lip_trial),
                     ("lip_evaluate", k11.lip_evaluate)):
        for inst, n in fn.shape_launches.items():
            if n:
                out[f"{name}_{inst}"] = n
    for (shape, form, solver), n in zip(k1.KERNEL_INSTANCES,
                                        k1.riccati_backward.instance_launches):
        if n:
            out[k1_row_name(shape, form, solver)] = n
    return out


def lip_family_twins():
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    return ((k1, ("riccati_backward_plain",)),
            (k11, ("lip_trial_plain", "lip_evaluate_plain")),
            (k3, ("rollout_plain", "evaluate_plain")),
            (k10, ("lip_linearize_plain",)))


def lip_family_point(prob, B, dev, seed):
    """A linearization point of one LIP instance at B members: plans around
    the nominal state (0.03 / 0.1·N(0,1)), random references, 0/1
    switches and tracking masks, x0 near node 0; member LIP_FAMILY_NAN
    with a NaN in x0 and in a copy of the plan."""
    import numpy as np
    import torch

    ocp = prob.ocp
    ns, nx, nu, nc = ocp.ns, ocp.nx, ocp.nu, prob.nc
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = t(prob.initial_state.cpu().numpy()[None, None]
          + 0.03 * rng.randn(B, ns + 1, nx))
    U = t(prob.static_input.cpu().numpy()[None, None]
          + 0.1 * rng.randn(B, ns, nu))
    params = dict(rdot_ref=t(0.3 * rng.randn(B, ns + 1, 3)),
                  c_ref=t(0.05 * np.abs(rng.randn(B, ns + 1, nc))),
                  cdot_switch=t(rng.randint(0, 2, (B, ns + 1, nc))),
                  mask_track=t(rng.randint(0, 2, (B, ns + 1, 1))))
    x0 = X[:, 0] + t(0.005 * rng.randn(B, nx))
    X_nan, x0_nan = X.clone(), x0.clone()
    X_nan[LIP_FAMILY_NAN, 5, 4] = float("nan")
    x0_nan[LIP_FAMILY_NAN] = float("nan")
    return dict(X=X, U=U, params=params, x0=x0, X_nan=X_nan, x0_nan=x0_nan)


def lip_family_check(inst, dev):
    """K10, K1 (every instantiation at the instance's K1 shape), K11 (1 and
    4 α) and lip_evaluate (plain and pinned) of one instance against their
    twins at B = 1, 64 and 512: K10, K11 and lip_evaluate in float64 to
    LIP_F64_TOL of max(1, |twin|), K10's Jacobians and the pinned plan bit
    for bit, in float32 by phase 10's rules (within 2× the float32 twin's
    error + 1e-6; K10 also below K4_F32_CAP); K1 in float64 to 1e-9, in
    float32 to K1_F32_TOL of the float64 twin; K11's flags equal in
    float64 and off the Armijo margin in float32; the NaN member (B > 1)
    rejected by K11 and NaN in lip_evaluate. Returns the worst figures,
    the K1 shape, the float64 twins' linearization and collapsed sweep at
    B=512 and the point; fails the run on disagreement."""
    import torch

    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1

    f64, f32 = torch.float64, torch.float32
    loop64, prob = lip_family_loop(inst, f64, dev)
    loop32, _ = lip_family_loop(inst, f32, dev)
    s64, s32 = loop64.solver, loop32.solver
    ocp = prob.ocp
    dt, rows, opts, mu = ocp.dt, s64.rows, s64.opts, s64.opts.mu0
    if k10.check_kernel_shape("check", s64.terms, ocp.nx, ocp.nu,
                              rows) != inst:
        fail(f"lip_family_check: {inst}'s problem picks another instance")
    pt = lip_family_point(prob, B_MAIN, dev, SEED + 16)
    solver_of = lambda dtype: s64 if dtype == f64 else s32
    cast = lambda a, dtype: a.to(dtype).contiguous()
    worst = defaultdict(float)
    bad = []
    jac = ("Sx", "Bs", "Jxp", "Jup", "Jt")

    def note(key, e64, e32, p32, abs32, rule32):
        worst[key + "_e64"] = max(worst[key + "_e64"], e64)
        worst[key + "_e32"] = max(worst[key + "_e32"], e32)
        worst[key + "_p32"] = max(worst[key + "_p32"], p32)
        worst[key + "_abs32"] = max(worst[key + "_abs32"], abs32)
        if not rule32:
            bad.append(f"{key} float32")

    for Bw in FAMILY_CHECK_B:
        p = family_sub(pt, Bw)
        cp = lambda dtype: {k: cast(v, dtype) for k, v in p["params"].items()}
        Xn = p["X_nan"] if Bw > LIP_FAMILY_NAN else p["X"]
        # K10, with the NaN member's plan
        lin = {}
        for dtype in (f64, f32):
            s = solver_of(dtype)
            a = (cast(Xn, dtype), cast(p["U"], dtype), cp(dtype), s.terms,
                 s.rows, dt, s._wc(dtype))
            lin[dtype] = (k10.lip_linearize_plain(*a), k10.lip_linearize(*a))
        ref = lin[f64][0]
        e64 = max(err1(lin[f64][1][k], ref[k]) for k in ORDER)
        e32 = {k: rel_err(lin[f32][1][k], ref[k]) for k in ORDER}
        p32 = {k: rel_err(lin[f32][0][k], ref[k]) for k in ORDER}
        if e64 > LIP_F64_TOL:
            bad.append(f"K10 float64 at B={Bw}: {e64}")
        if not all(torch.equal(lin[f64][1][k], ref[k]) for k in jac):
            bad.append(f"K10 float64 Jacobians at B={Bw} not bit for bit the "
                       "twin's")
        note("k10", e64, max(e32.values()), max(p32.values()),
             max(abs_err(lin[f32][1][k], ref[k]) for k in ORDER),
             all(e32[k] <= 2 * p32[k] + 1e-6 and e32[k] <= K4_F32_CAP
                 for k in ORDER))
        # the sweep's inputs: the finite plan's linearization
        a64 = k10.lip_linearize_plain(p["X"], p["U"], p["params"], s64.terms,
                                      rows, dt, s64._wc(f64))
        nt = a64["Jt"].shape[1]
        k1_shape = k1.kernel_shape(ocp.nx, ocp.nu, nt, rows)
        a64t = tuple(a64[k] for k in ORDER)
        a32t = tuple(v.float().contiguous() for v in a64t)
        sweeps = {}
        for shape, form, solver in k1.KERNEL_INSTANCES:
            if shape != k1_shape:
                continue
            kw = dict(form=form, quu_solver=solver)
            r = k1.riccati_backward_plain(*a64t, mu, rows, **kw)
            g = k1.riccati_backward(*a64t, mu, rows, **kw)
            g32 = k1.riccati_backward(*a32t, mu, rows, **kw)
            p32_ = k1.riccati_backward_plain(*a32t, mu, rows, **kw)
            name = k1_row_name(shape, form, solver)
            e64 = max(rel_err(x, y) for x, y in zip(g, r))
            e32 = max(rel_err(x, y) for x, y in zip(g32, r))
            if e64 > 1e-9:
                bad.append(f"{name} float64 at B={Bw}: {e64}")
            note(name, e64, e32, max(rel_err(x, y) for x, y in zip(p32_, r)),
                 max(abs_err(x, y) for x, y in zip(g32, r)), e32 <= K1_F32_TOL)
            sweeps[(form, solver)] = r
        ks, Ks, dV1, dV2 = sweeps[("collapsed", "schur")]
        d = a64["d"]
        D = torch.sum(d * d, dim=(1, 2))
        merit0 = s64.total_cost(p["X"], p["U"], p["params"]) + \
            opts.defect_weight * D
        # K11, 1 and 4 α; the NaN member starts from a NaN state
        x0s = p["x0_nan"] if Bw > LIP_FAMILY_NAN else p["x0"]
        alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=f64, device=dev)
        for nA in (1, 4):
            outs = {}
            for dtype in (f64, f32):
                s = solver_of(dtype)
                c = lambda a: cast(a, dtype)
                a = (c(x0s), c(p["X"]), c(p["U"]), c(ks), c(Ks), c(d),
                     c(alphas4[:nA]), cp(dtype), c(merit0), c(D), c(dV1),
                     c(dV2), s.terms, dt, s._wc(dtype), opts.defect_weight,
                     opts.beta, opts.alpha_converge_threshold)
                outs[dtype] = (k11.lip_trial_plain(*a), k11.lip_trial(*a))
            ref3 = outs[f64][0]
            e64 = max(err1(g, r) for g, r in zip(outs[f64][1][:4], ref3[:4]))
            e32 = {n: rel_err(g, r) for n, g, r in zip(TRIAL_OUT, outs[f32][1], ref3)}
            p32 = {n: rel_err(g, r) for n, g, r in zip(TRIAL_OUT, outs[f32][0], ref3)}
            al = alphas4[:nA, None]
            margin = (merit0 - ref3[3]) - opts.beta * torch.clamp(
                -(al * dV1 + al * al * dV2)
                + (2 * al - al * al) * opts.defect_weight * D, min=1e-16)
            near = margin.abs() <= 1e-4 * merit0.abs().clamp_min(1.0)
            flips = int(((outs[f32][1][4] != ref3[4]) & ~near).sum())
            if e64 > LIP_F64_TOL or not torch.equal(outs[f64][1][4], ref3[4]):
                bad.append(f"K11 float64 at B={Bw}, {nA} α: {e64}")
            if flips or (Bw > LIP_FAMILY_NAN
                         and bool(outs[f64][1][4][:, LIP_FAMILY_NAN].any())):
                bad.append(f"K11 flags at B={Bw}, {nA} α")
            note("k11", e64, max(e32.values()), max(p32.values()),
                 max(abs_err(g, r) for g, r in zip(outs[f32][1][:4], ref3[:4])),
                 all(e32[n] <= 2 * p32[n] + 1e-6 for n in TRIAL_OUT))
        # lip_evaluate, plain and pinned; the NaN member's plan holds a NaN
        for pinned in (False, True):
            outs = {}
            for dtype in (f64, f32):
                s = solver_of(dtype)
                kw = dict(x0=cast(p["x0"], dtype)) if pinned else {}
                a = (cast(Xn, dtype), cast(p["U"], dtype), cp(dtype), s.terms,
                     dt, s._wc(dtype))
                outs[dtype] = (k11.lip_evaluate_plain(*a, **kw),
                               k11.lip_evaluate(*a, **kw))
            refe = outs[f64][0]
            e64 = max(err1(g, r) for g, r in zip(outs[f64][1][:2], refe[:2]))
            e32 = [rel_err(g, r) for g, r in zip(outs[f32][1][:2], refe[:2])]
            p32 = [rel_err(g, r) for g, r in zip(outs[f32][0][:2], refe[:2])]
            if e64 > LIP_F64_TOL:
                bad.append(f"lip_evaluate float64 at B={Bw}: {e64}")
            if Bw > LIP_FAMILY_NAN and not all(
                    bool(torch.isnan(o[LIP_FAMILY_NAN])) for out in
                    (outs[f64][1], outs[f32][1]) for o in out[:2]):
                bad.append(f"lip_evaluate NaN member at B={Bw}")
            if pinned and not (
                    bool(torch.equal(bits(outs[f64][1][2]), bits(refe[2])))
                    and bool(torch.equal(bits(outs[f32][1][2]),
                                         bits(outs[f32][0][2])))):
                bad.append(f"lip_evaluate pinned plan at B={Bw}")
            note("evaluate", e64, max(e32), max(p32),
                 max(abs_err(g, r) for g, r in zip(outs[f32][1][:2], refe[:2])),
                 all(a <= 2 * b + 1e-6 for a, b in zip(e32, p32)))
    torch.cuda.synchronize()
    res = dict(worst)
    emit("lip_family_check", instance=inst, k1_shape=k1_shape,
         B=FAMILY_CHECK_B, f64_tol=LIP_F64_TOL, k1_f64_tol=1e-9,
         k1_f32_tol=K1_F32_TOL,
         f32_rule="kernel <= 2*plain + 1e-6 (K10 also <= 1e-5)",
         failures=bad, **res)
    if bad:
        fail(f"lip_family_check {inst}: {bad}")
    return res, k1_shape, a64, (ks, Ks, dV1, dV2), pt


def lip_family_times(inst, dev, lin64, sweep64, pt):
    """One instance's kernels in float32 at B = 1, 512 and 4096 (members
    repeated), the twins' at B ≤ 512: ms, the bytes and FLOPs the call
    needs and its bound; K10's, K11's and lip_evaluate's occupancy
    (blocks an SM, shared memory, registers, spills) with K11's and
    lip_evaluate's shared memory held to `smem_bytes` and
    `evaluate_smem_bytes` at the instance; K1's blocks an SM and shared
    memory. {row name: {B: figures}}, {row name: occupancy}."""
    import torch

    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1

    f32, f64 = torch.float32, torch.float64
    loop32, prob = lip_family_loop(inst, f32, dev)
    s = loop32.solver
    ocp = prob.ocp
    ns, nx, nu, dt = ocp.ns, ocp.nx, ocp.nu, ocp.dt
    rows, opts, mu = s.rows, s.opts, s.opts.mu0
    n_rho = s.terms.n_rho
    step = family_split(inst)[1]
    stages = {"EULER": 1, "RK2": 2, "RK4": 4}[step]
    c = lambda a: a.float().contiguous()
    params = {k: c(v) for k, v in pt["params"].items()}
    a10 = (c(pt["X"]), c(pt["U"]), params, s.terms, rows, dt, s._wc(f32))
    ks, Ks, dV1, dV2 = (c(v) for v in sweep64)
    d = c(lin64["d"])
    D = torch.sum(d * d, dim=(1, 2))
    merit0 = s.total_cost(a10[0], a10[1], params) + opts.defect_weight * D
    alphas4 = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=f32, device=dev)
    a11 = lambda nA: (c(pt["x0"]), a10[0], a10[1], ks, Ks, d, alphas4[:nA],
                      params, merit0, D, dV1, dV2, s.terms, dt, s._wc(f32),
                      opts.defect_weight, opts.beta,
                      opts.alpha_converge_threshold)
    aev = (a10[0], a10[1], params, s.terms, dt, s._wc(f32), c(pt["x0"]))
    lin32 = {k: c(v) for k, v in lin64.items()}
    k1a = tuple(lin32[k] for k in ORDER)
    nt = lin32["Jt"].shape[1]
    k1_shape = k1.kernel_shape(nx, nu, nt, rows)
    sizes = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
             len(rows.bx), len(rows.uc))
    times = defaultdict(dict)
    for Bw in FAMILY_TIME_B:
        plain_too = Bw <= B_MAIN
        pl = lambda fn, reps: (cuda_ms(fn, reps=reps, warmup=1) if plain_too
                               else None)
        la = repeat_members(a10, Bw)
        out = k10.lip_linearize(*la)
        times[f"lip_linearize_{inst}"][Bw] = dict(
            ms=cuda_ms(lambda: k10.lip_linearize(*la), reps=20),
            plain_ms=pl(lambda: k10.lip_linearize_plain(*la), 3),
            bytes=nbytes(la[0], la[1], *la[2].values(), rows.packed(dev),
                         *out.values()),
            flop=lip_linearize_flops(Bw, ns, stages * nx, n_rho, len(rows.gx)))
        ta = repeat_members(a11(1), Bw, skip=(6,))
        out = k11.lip_trial(*ta)
        times[f"lip_trial_{inst}"][Bw] = dict(
            ms=cuda_ms(lambda: k11.lip_trial(*ta), reps=20),
            plain_ms=pl(lambda: k11.lip_trial_plain(*ta), 3),
            bytes=nbytes(*[v for v in ta[:12] if isinstance(v, torch.Tensor)],
                         *ta[7].values(), *out),
            flop=lip_trial_flops(Bw, ns, nx, nu, n_rho, 1)
            + (stages - 1) * 4 * nx * ns * Bw)
        ta4 = repeat_members(a11(4), Bw, skip=(6,))
        times[f"lip_trial_{inst}"][Bw]["ms_4alpha"] = cuda_ms(
            lambda: k11.lip_trial(*ta4), reps=20)
        times[f"lip_trial_{inst}"][Bw]["chain_ms"] = cuda_ms(
            lambda: k11.lip_trial_chain(*ta), reps=20)
        ea = repeat_members(aev, Bw)
        out = k11.lip_evaluate(*ea[:-1], x0=ea[-1])
        times[f"lip_evaluate_{inst}"][Bw] = dict(
            ms=cuda_ms(lambda: k11.lip_evaluate(*ea[:-1], x0=ea[-1]), reps=20),
            plain_ms=pl(lambda: k11.lip_evaluate_plain(*ea[:-1], x0=ea[-1]), 3),
            bytes=nbytes(ea[0], ea[1], *ea[2].values(), ea[-1], *out),
            flop=lip_evaluate_flops(Bw, ns, stages * nx, n_rho))
        ka = repeat_members(k1a, Bw)
        for shape, form, solver in k1.KERNEL_INSTANCES:
            if shape != k1_shape:
                continue
            kw = dict(form=form, quu_solver=solver)
            out = k1.riccati_backward(*ka, mu, rows, **kw)
            flop = (riccati_flops(Bw, ns, nx, nu, nt, *sizes)
                    if form == "collapsed"
                    else tassa_flops(Bw, ns, nx, nu, nt, *sizes, solver))
            times[k1_row_name(shape, form, solver)][Bw] = dict(
                ms=cuda_ms(lambda: k1.riccati_backward(*ka, mu, rows, **kw),
                           reps=10),
                plain_ms=pl(lambda: k1.riccati_backward_plain(
                    *ka, mu, rows, **kw), 2),
                bytes=nbytes(*ka, rows.packed(dev), *out), flop=flop,
                fp64_tensor_cores=True)
    for by_B in times.values():
        for v in by_B.values():
            rate = (H100_FP64_TC_FLOP_PER_S if v.pop("fp64_tensor_cores", False)
                    else H100_F32_FLOP_PER_S)
            v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flop"], rate)
            v["achieved_GB_per_s"] = v["bytes"] / v["ms"] / 1e6
    k10o = k10.occupancy(f32, True, inst)
    occ = {f"lip_linearize_{inst}": dict(
               k10o, node_groups=k10.occupancy(f32, False, inst),
               f64=k10.occupancy(f64, True, inst)),
           f"lip_trial_{inst}": dict(
               k11.trial_occupancy(f32, ns, 1, inst),
               four_alpha=k11.trial_occupancy(f32, ns, 4, inst),
               f64=k11.trial_occupancy(f64, ns, 1, inst),
               f64_four_alpha=k11.trial_occupancy(f64, ns, 4, inst)),
           f"lip_evaluate_{inst}": dict(
               k11.evaluate_occupancy(ns, f32, inst),
               f64=k11.evaluate_occupancy(ns, f64, inst))}
    # the card's shared memory a block against the wrappers' statement
    t, e = occ[f"lip_trial_{inst}"], occ[f"lip_evaluate_{inst}"]
    for o, want in ((t, k11.smem_bytes(f32, ns, 1, inst)["total"]),
                    (t["four_alpha"], k11.smem_bytes(f32, ns, 4, inst)["total"]),
                    (t["f64"], k11.smem_bytes(f64, ns, 1, inst)["total"]),
                    (t["f64_four_alpha"],
                     k11.smem_bytes(f64, ns, 4, inst)["total"]),
                    (e, k11.evaluate_smem_bytes(f32, ns, shape=inst)["total"]),
                    (e["f64"],
                     k11.evaluate_smem_bytes(f64, ns, shape=inst)["total"])):
        if o["shared_memory_bytes"] != want:
            fail(f"lip_family_times {inst}: a block takes "
                 f"{o['shared_memory_bytes']} B on the card; the wrapper "
                 f"states {want}")
    for key in (f"lip_linearize_{inst}", f"lip_trial_{inst}",
                f"lip_evaluate_{inst}"):
        o = occ[key]
        subs = [o] + [v for v in o.values() if isinstance(v, dict)]
        if any(v.get("local_bytes_per_thread") or v["blocks_per_sm"] < 1
               for v in subs):
            fail(f"lip_family_times: {key} spills or does not fit: {o}")
    for shape, form, solver in k1.KERNEL_INSTANCES:
        if shape == k1_shape:
            kw = dict(form=form, quu_solver=solver)
            occ[k1_row_name(shape, form, solver)] = dict(
                blocks_per_sm=k1.blocks_per_sm(nx, nu, nt, rows, f32, **kw),
                shared_memory_bytes=k1.shared_memory_bytes(nx, nu, nt, rows,
                                                           f32, **kw))
    return times, occ


def lip_family_single(inst, dev, card, ticks, cholesky_ticks, vx=0.3):
    """One robot of one LIP instance on `MPCLoop.tick` in float32 with the
    dlip example's options: a walk (vx from tick 10), then `cholesky_ticks`
    more with the Cholesky gain solve. Returns the figures, the launches
    and the guards."""
    import torch

    from srbd_horizon_tpu_torch.runtime.loop import TickInput, walking_schedule

    loop, prob = lip_family_loop(inst, torch.float32, dev)
    sched = walking_schedule(ticks, vx=vx, start=10, device=dev)
    opts = dataclasses.replace(loop.solver.opts, quu_solver="cholesky")
    cloop = dataclasses.replace(loop, solver=dataclasses.replace(
        loop.solver, opts=opts))
    guards, restore_guards = guard_plain(lip_family_twins())
    n, restore_count = count_solver_calls(loop.solver, cloop.solver)
    carry = loop.init(prob.initial_state)
    z0 = float(prob.initial_state[2])
    outs, tms = [], []
    lip_family_counts_reset()
    syncs0 = loop.solver.host_syncs
    for i in range(ticks):
        inp = TickInput(*(a[i] for a in sched))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, out = loop.tick(carry, inp)
        torch.cuda.synchronize()
        tms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    syncs = loop.solver.host_syncs - syncs0
    chol = []
    for _ in range(cholesky_ticks):
        carry, out = cloop.tick(carry, TickInput(*(a[-1] for a in sched)))
        chol.append(out)
    torch.cuda.synchronize()
    launches = lip_family_counts()
    restore_count()
    restore_guards()
    every = outs + chol
    com = torch.stack([o.x[:3] for o in outs]).cpu()
    res = dict(
        instance=inst, B=1, dtype="float32", ticks=ticks,
        cholesky_ticks=cholesky_ticks, walk=f"vx {vx} from tick 10",
        options="the dlip example: max_iters=100, "
                "alpha_converge_threshold=1e-12, beta=1e-3",
        tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
        tick_mean_ms=statistics.fmean(tms),
        iterations_per_tick=[int(o.iterations) for o in every],
        syncs_per_tick=syncs / ticks, launches=launches,
        iterations=n["iterations"], trials=n["trials"], solves=n["solves"],
        defect_norm_max=max(float(o.defect_norm) for o in every),
        com_z_min=float(com[:, 2].min()), com_z_max=float(com[:, 2].max()),
        z0=z0, forward_progress_m=float(com[-1, 0] - com[0, 0]),
        final_com=carry.x[:3].tolist(),
        finite=all(bool(torch.isfinite(v).all()) for o in every
                   for v in (o.x, o.u0, o.cost)),
        **{k: v["n"] for k, v in guards.items()}, card=card)
    return res, launches, guards


def lip_family_fleet(inst, Bsz, dtype, device, max_iters=5, seed=SEED):
    """The LIP fleet point on one instance: max_iters=5, the warm start
    shifted, the walk command vx 0.2, pushes of 0.005·N(0,1)."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions
    from srbd_horizon_tpu_torch.runtime.loop import walk_command

    loop, p = lip_family_loop(inst, dtype, device,
                              opts=DDPOptions(max_iters=max_iters), shift=True)
    g = np.random.RandomState(seed)
    xn = p.initial_state.cpu().numpy()
    xs = torch.as_tensor(xn[None] + 0.005 * g.randn(Bsz, xn.shape[0]),
                         dtype=dtype, device=device)
    return loop, loop.init(xs), walk_command(Bsz, vx=0.2, dtype=dtype,
                                             device=device)


def lip_family_fleet_path(inst, dev, card, warm, timed, profile=True):
    """`MPCLoop.tick_batch` at B=512 in float32 on one LIP instance: `warm`
    ticks, then `timed` ticks with the launches counted; with `profile`,
    the phases inside 5 ticks and 2 profiled ticks (idle share, launches a
    tick by span)."""
    import torch

    loop, c, inp = lip_family_fleet(inst, B_MAIN, torch.float32, dev)
    guards, restore_guards = guard_plain(lip_family_twins())
    cnt, restore = count_solver_calls(loop.solver)
    for _ in range(warm):
        c, _ = loop.tick_batch(c, inp)
    torch.cuda.synchronize()
    cnt.update(trials=0, solves=0, iterations=0)
    lip_family_counts_reset()
    syncs0 = loop.solver.host_syncs
    tms, iters, outs = [], [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        c, o = loop.tick_batch(c, inp)
        torch.cuda.synchronize()
        tms.append((time.perf_counter() - t0) * 1e3)
        iters.append(float(o.iterations.float().mean()))
        outs.append(o)
    launches = lip_family_counts()
    restore()
    restore_guards()
    res = dict(
        instance=inst, B=B_MAIN, dtype="float32",
        options="max_iters=5, shifted warm start, walk command vx 0.2, "
                "0.005·N(0,1) pushes (seed 0)",
        warmup_ticks=warm, ticks=timed,
        tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
        tick_mean_ms=statistics.fmean(tms),
        members_per_s=B_MAIN / statistics.median(tms) * 1e3,
        iters_mean=statistics.fmean(iters),
        syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
        iterations=cnt["iterations"], trials=cnt["trials"],
        solves=cnt["solves"], launches=launches,
        finite=all(bool(torch.isfinite(v).all()) for o in outs
                   for v in (o.x, o.u0, o.cost)) and bool(
                       torch.isfinite(c.sol.X).all()),
        defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
        **{k: v["n"] for k, v in guards.items()}, card=card)
    if profile:
        step = lambda cc: loop.tick_batch(cc, inp)[0]
        c, res["spans"] = tick_spans(loop.solver, step, c, ticks=5)
        res["profile"] = profile_ticks(loop.solver, step, c, res["tick_p50_ms"])
        res["device_idle_share"] = res["profile"]["device_idle_share"]
        res["launches_by_span"] = res["profile"]["launches_by_span"]
    return res, launches, guards


def lip_family_gates(tag, res, launches, inst, k1_names, guards):
    """The gates every phase-16 path shares: finite outputs, defects ≤ 1e-4;
    the instance's K10, K11, lip_evaluate and the K1 forms `k1_names`
    launched and nothing else of the LIP (no Euler instance on an RK
    path); K10 and K1 one launch an iteration, K11 one a trial,
    lip_evaluate two a solve; no plain twin, torch.func transform or
    plain cost or defect on the card."""
    if not res["finite"]:
        fail(f"{tag}: non-finite values")
    if res["defect_norm_max"] > 1e-4:
        fail(f"{tag}: plans are not dynamically consistent (defect above "
             f"1e-4): {res['defect_norm_max']}")
    want = {f"{k}_{inst}" for k in ("lip_linearize", "lip_trial",
                                    "lip_evaluate")} | set(k1_names)
    if set(launches) != want:
        fail(f"{tag}: the path launched {sorted(launches)}, not the kernels "
             f"of its instance {sorted(want)}")
    k1_total = sum(launches[k] for k in k1_names)
    if not (launches[f"lip_linearize_{inst}"] == k1_total
            == res["iterations"]):
        fail(f"{tag}: K10 and K1 launches do not match the iterations: "
             f"{launches}, {res['iterations']} iterations")
    if launches[f"lip_trial_{inst}"] != res["trials"]:
        fail(f"{tag}: K11 launches do not match the trials: {launches}, "
             f"{res['trials']} trials")
    if launches[f"lip_evaluate_{inst}"] != 2 * res["solves"]:
        fail(f"{tag}: lip_evaluate launches are not two a solve: "
             f"{launches}, {res['solves']} solves")
    if any(guards[k]["n"] for k in guards):
        fail(f"{tag}: the path ran plain twins on the card: "
             f"{ {k: v['n'] for k, v in guards.items()} }")


def lip_family_versus(card_run, cpu_run, floor):
    """Card = CPU: iterations and convergence equal, the cost to 1e-9, x,
    u0 and the plans to 1e-9 or, with `floor`, to LIP_FLOOR_TOL (F8)."""
    r = family_versus(card_run, cpu_run)
    plan = max(r[k] for k in ("x_rel_err", "u0_rel_err", "X_rel_err",
                              "U_rel_err"))
    r["ok"] = (r["iterations_equal"] and r["converged_equal"]
               and r["cost_rel_err"] <= 1e-9
               and plan <= (LIP_FLOOR_TOL if floor else 1e-9))
    return r


def lip_family_section(card, dev, sms):
    """Phase 16: the LIP problem at every topology and step the JAX
    package's `build_lip_problem` takes — the point-feet quadruped and
    biped under Euler, and each topology under RK2 and RK4 — on K10, K11,
    lip_evaluate and K1 (with K2 inside). The kernel checks
    (`lip_family_check`) and times beside the Kangaroo's Euler instance
    (`lip_family_times`), K2 at nu=9, the paths (the point-feet biped's
    dlip walk, the quadruped's LIP trot, the
    Kangaroo's LIP fleets under RK2 and RK4, short runs for the rest) and
    card = CPU in float64 (`lip_family_card_vs_cpu`). Returns the kernel
    rows of the `kernels` line."""
    import torch

    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.runtime.loop import TickInput, walking_schedule

    t_section = time.perf_counter()
    f64 = torch.float64
    errs, k1_shapes, times, occ = {}, {}, {}, {}
    pf_Jup = None
    for inst in LIP_FAMILY_INSTANCES:
        res, k1_shape, lin64, sweep64, pt = lip_family_check(inst, dev)
        errs[inst], k1_shapes[inst] = res, k1_shape
        t, o = lip_family_times(inst, dev, lin64, sweep64, pt)
        times.update(t)
        occ.update(o)
        if inst == "point_feet":
            pf_Jup = lin64["Jup"]
        del lin64, sweep64, pt
    # the Kangaroo's Euler instance, timed in the same call
    loop64, prob = lip_family_loop("kangaroo", f64, dev)
    pt = lip_family_point(prob, B_MAIN, dev, SEED + 16)
    s = loop64.solver
    lin64 = k10.lip_linearize_plain(pt["X"], pt["U"], pt["params"], s.terms,
                                    s.rows, prob.ocp.dt, s._wc(f64))
    sweep = k1.riccati_backward_plain(*(lin64[k] for k in ORDER),
                                      s.opts.mu0, s.rows)
    t, o = lip_family_times("kangaroo", dev, lin64, sweep, pt)
    times.update(t)
    occ.update(o)
    del lin64, sweep, pt
    emit("lip_family_times", card=card, dtype="float32", sms=sms,
         times={k: {str(b): v for b, v in d.items()} for k, d in times.items()},
         occupancy=occ)
    k2 = k2_check("lip_family_k2_check", k1, pf_Jup, 1e-6, nu=9)
    torch.cuda.empty_cache()

    # ---- the paths ----
    path_launches = defaultdict(int)

    def add(launches):
        for k, v in launches.items():
            path_launches[k] += v

    def k1_names(inst, forms):
        return [k1_row_name(k1_shapes[inst], f, sv) for f, sv in forms]

    tassa_both = (("tassa", "schur"), ("tassa", "cholesky"))
    collapsed = (("collapsed", "schur"),)
    singles = (("lip_family_pf_walk", "point_feet", FAMILY_SINGLE_TICKS, 0.3),
               ("lip_family_quadruped_trot", "quadruped", FAMILY_SINGLE_TICKS,
                0.25),
               ("lip_family_kangaroo_rk4_walk", "kangaroo_rk4",
                FAMILY_SHORT_TICKS, 0.3),
               ("lip_family_quadruped_rk4_trot", "quadruped_rk4",
                FAMILY_SHORT_TICKS, 0.25),
               ("lip_family_pf_rk4_walk", "point_feet_rk4", FAMILY_SHORT_TICKS,
                0.3))
    for tag, inst, ticks, vx in singles:
        res, launches, guards = lip_family_single(
            inst, dev, card, ticks, FAMILY_CHOLESKY_TICKS, vx)
        emit(tag, **res)
        lip_family_gates(tag, res, launches, inst, k1_names(inst, tassa_both),
                         guards)
        if ticks == FAMILY_SINGLE_TICKS:
            # the biped's walk holds the dlip CoM band; the quadruped's LIP
            # (η² of the 0.88 m pendulum, as the JAX package's
            # `build_lip_problem` takes the config) lifts its CoM from the
            # feet's 0.40 m: its height is
            # reported, its progress gated
            quad = inst.startswith("quadruped")
            z, band = LIP_HEIGHT, FAMILY_HEIGHT_BAND
            if not quad and max(abs(res["com_z_min"] - z),
                                abs(res["com_z_max"] - z)) > band:
                fail(f"{tag}: the CoM height left {z} ± {band}: "
                     f"{res['com_z_min']}, {res['com_z_max']}")
            if not res["forward_progress_m"] > (0 if quad else FAMILY_PROGRESS):
                fail(f"{tag}: forward progress {res['forward_progress_m']} m")
        add(launches)

    fleets = (("lip_family_kangaroo_rk2_fleet", "kangaroo_rk2",
               FAMILY_FLEET_TIMED, True),
              ("lip_family_kangaroo_rk4_fleet", "kangaroo_rk4",
               FAMILY_FLEET_TIMED, True),
              ("lip_family_short_fleet_point_feet", "point_feet",
               FAMILY_SHORT_TICKS, False),
              ("lip_family_short_fleet_quadruped", "quadruped",
               FAMILY_SHORT_TICKS, False),
              ("lip_family_short_fleet_quadruped_rk2", "quadruped_rk2",
               FAMILY_SHORT_TICKS, False),
              ("lip_family_short_fleet_point_feet_rk2", "point_feet_rk2",
               FAMILY_SHORT_TICKS, False))
    for tag, inst, timed, prof in fleets:
        res, launches, guards = lip_family_fleet_path(
            inst, dev, card, FAMILY_FLEET_WARM if prof else 0, timed, prof)
        emit(tag, **res)
        lip_family_gates(tag, res, launches, inst, k1_names(inst, collapsed),
                         guards)
        add(launches)
    torch.cuda.empty_cache()

    # ---- lip_family_card_vs_cpu: float64, the point-feet walk and the
    # Kangaroo's RK4 LIP fleet at B=8, 3 ticks each, with max_iters=1 (the
    # exact step, no floor step) and with the paths' options ----
    def single_ticks(device, n_ticks, **kw):
        from srbd_horizon_tpu_torch.config import DDPOptions

        o = dict(dict(max_iters=100, alpha_converge_threshold=1e-12,
                      beta=1e-3), **kw)           # the dlip example's
        loop, p = lip_family_loop("point_feet", f64, device,
                                  opts=DDPOptions(**o))
        sch = walking_schedule(n_ticks, vx=0.3, start=1, dtype=f64,
                               device=device)
        c = loop.init(p.initial_state)
        res = []
        for i in range(n_ticks):
            c, o = loop.tick(c, TickInput(*(a[i] for a in sch)))
            res.append(o)
        return c, res

    def fleet_ticks(device, n_ticks, max_iters):
        loop, c, inp = lip_family_fleet("kangaroo_rk4", 8, f64, device,
                                        max_iters=max_iters)
        res = []
        for _ in range(n_ticks):
            c, o = loop.tick_batch(c, inp)
            res.append(o)
        return c, res

    fvc = dict(
        tol="exact_step (max_iters=1): all to 1e-9; options: iterations "
            "equal, cost to 1e-9, x, u0, X, U to LIP_FLOOR_TOL",
        floor_tol=LIP_FLOOR_TOL,
        point_feet_walk=dict(
            ticks=3, walk="vx 0.3 from tick 1",
            exact_step=lip_family_versus(single_ticks(dev, 3, max_iters=1),
                                         single_ticks("cpu", 3, max_iters=1),
                                         floor=False),
            options=lip_family_versus(single_ticks(dev, 3),
                                      single_ticks("cpu", 3), floor=True)),
        kangaroo_rk4_fleet_B8=dict(
            ticks=3,
            exact_step=lip_family_versus(fleet_ticks(dev, 3, 1),
                                         fleet_ticks("cpu", 3, 1),
                                         floor=False),
            options=lip_family_versus(fleet_ticks(dev, 3, 5),
                                      fleet_ticks("cpu", 3, 5), floor=True)))
    emit("lip_family_card_vs_cpu", **fvc)
    if not all(fvc[k][m]["ok"] for k in ("point_feet_walk",
                                         "kangaroo_rk4_fleet_B8")
               for m in ("exact_step", "options")):
        fail("the phase-16 card path and CPU path disagree")

    # ---- the kernel rows: launches from this phase's paths ----
    trial_tol = "2*plain_rel_err_f32 + 1e-6"
    specs = []                 # (row name, module, error key, source instance)
    for inst in LIP_FAMILY_INSTANCES:
        specs += [(f"lip_linearize_{inst}", k10, "k10", inst),
                  (f"lip_trial_{inst}", k11, "k11", inst),
                  (f"lip_evaluate_{inst}", k11, "evaluate", inst)]
    new_shapes = {k1_shapes[i]: i for i in reversed(LIP_FAMILY_INSTANCES)}
    for shape, form, solver in k1.KERNEL_INSTANCES:
        if shape in new_shapes:
            name = k1_row_name(shape, form, solver)
            specs.append((name, k1, name, new_shapes[shape]))
    rows_out = []
    for name, mod, key, inst in specs:
        t, e = times[name], errs[inst]
        tassa_row = "_tassa" in name
        Bt = 1 if tassa_row else B_MAIN
        tt = t[Bt]
        err = dict(e64=e[key + "_e64"], e32=e[key + "_e32"],
                   p32=e[key + "_p32"], abs32=e[key + "_abs32"])
        tol32 = (K1_F32_TOL if mod is k1
                 else f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}"
                 if key == "k10" else trial_tol)
        base = (name.replace("_" + inst, "_kangaroo")
                if mod is not k1 else None)
        row = kernel_row(name, mod, path_launches.get(name, 0), tt["ms"],
                         tt["plain_ms"], tt["bound_ms"], tt["bound_by"], err,
                         tol32, B=Bt, instance=inst,
                         ms_by_B={str(b): v["ms"] for b, v in t.items()},
                         plain_ms_by_B={str(b): v["plain_ms"]
                                        for b, v in t.items()},
                         bound_ms_by_B={str(b): v["bound_ms"]
                                        for b, v in t.items()},
                         achieved_GB_per_s=tt["achieved_GB_per_s"],
                         kangaroo_euler_ms_by_B=(
                             {str(b): v["ms"] for b, v in times[base].items()}
                             if base else None),
                         launches_of="phase 16's paths", **occ.get(name, {}))
        row["tol_f64"] = 1e-9 if mod is k1 else LIP_F64_TOL
        if key == "evaluate":
            row["replaces"] = k11.EVALUATE_REPLACES
            row["pinned"] = True
        elif tassa_row:
            row["replaces"] = k1.TASSA_REPLACES
        if key == "k11":
            row["ms_4alpha"] = tt["ms_4alpha"]
            row["chain_ms"] = tt["chain_ms"]
        rows_out.append(row)
    pf_shapes = {k1_shapes[i] for i in LIP_FAMILY_INSTANCES
                 if i.startswith("point_feet")}
    k2_launches = sum(path_launches.get(k1_row_name(*ki), 0)
                      for ki in k1.KERNEL_INSTANCES
                      if ki[0] in pf_shapes and ki[2] == "schur")
    rows_out.append(dict(kernel_row(
        "spd_inverse_nu9", k1, k2_launches, k2["ms_f32"], k2["plain_ms_f32"],
        k2["bound_ms"], k2["bound_by"],
        dict(e64=k2["f64_rel_err"], e32=k2["f32_rel_err"],
             p32=k2["f32_plain_rel_err"], abs32=k2["f32_max_abs_err"]),
        K2_F32_TOL, launches_of="K1 with the block-Schur inverse at the "
        "point-feet LIP shapes on phase 16's paths (K2 runs inside K1)",
        stack=k2["stack"], ms_f64=k2["ms_f64"],
        library_ms_f32=k2["torch_linalg_inv_ms_f32"]),
        replaces=k1.K2_REPLACES, library_ms=k2["torch_linalg_inv_ms_f64"]))
    missing = [r["name"] for r in rows_out if r["launches"] == 0]
    if missing:
        fail(f"phase 16: kernels not launched on its paths: {missing}")
    emit("lip_family_section", seconds=time.perf_counter() - t_section,
         card=card, rows=len(rows_out), path_launches=dict(path_launches))
    return rows_out


# ---------------- the execution modes at every LIP shape (phase 17) -------

# K1's LIP shapes phase 16 added, each with the instance whose drawn point
# holds K12 there (RK2 and RK4 share a shape)
LMF_K12 = (("lip_quadruped", "quadruped"), ("lip_point_feet", "point_feet"),
           ("lip_rk", "kangaroo_rk2"), ("lip_quadruped_rk", "quadruped_rk2"),
           ("lip_point_feet_rk", "point_feet_rk2"))
LMF_NAN_B = (64, B_MAIN)        # the NaN-member checks' sizes
# K12 and K13 in float64 at the LIP shapes: |kernel − twin| ≤ 1e-12 of
# max(1, |twin|) entry by entry. K12 only where the value recursion's
# conditioning leaves its float64 twin and K1's Tassa twin (the same
# recursion summed sequentially) within 1e-12 of each other at the point:
# elsewhere within LMF_FLOOR_FACTOR × their distance (`lmf_twin_floor`; an
# NVIDIA H100 80GB HBM3 at 700.00 W read the kernel at 0.6-1.8× it, 2e-12
# to 2e-9 at the random masks and switches of `lip_family_point`).
LMF_F64_TOL = 1e-12
LMF_FLOOR_FACTOR = 4.0


def lmf_family(inst):
    """K13's family name of a phase-16 LIP instance (lip_linearize.
    KERNEL_SHAPES name)."""
    return "lip_" + inst


def lmf_k1_shape(inst):
    """K1's shape name of a LIP instance (RK2 and RK4 share one)."""
    topology, step = family_split(inst)
    base = {"kangaroo": "lip", "quadruped": "lip_quadruped",
            "point_feet": "lip_point_feet"}[topology]
    return base if step == "EULER" else base + "_rk"


def lmf_twins():
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    return lip_family_twins() + ((k12, ("riccati_associative_plain",)),
                                 (k13, ("linear_trial_plain",)))


def lmf_point(inst, dev, seed):
    """One LIP instance's drawn point at B=512 in float64 on the card
    (`lip_family_point`: plans, references, switches and masks, linearized
    by K10) with the gains of K12's block-Schur twin, D and merit0: the `p`
    the modes' check and time helpers take (`fam`: K13's family name)."""
    import torch

    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    f64 = torch.float64
    loop64, prob = lip_family_loop(inst, f64, dev)
    loop32, _ = lip_family_loop(inst, torch.float32, dev)
    s, ocp = loop64.solver, prob.ocp
    pt = lip_family_point(prob, B_MAIN, dev, seed)
    lin = k10.lip_linearize(pt["X"], pt["U"], pt["params"], s.terms, s.rows,
                            ocp.dt, s._wc(f64))
    if k1.kernel_shape(ocp.nx, ocp.nu, lin["Jt"].shape[1], s.rows) \
            != lmf_k1_shape(inst):
        fail(f"lmf_point: {inst}'s problem picks another K1 shape")
    gains = k12.riccati_associative_plain(*(lin[k] for k in ORDER),
                                          s.opts.mu0, s.rows)
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    merit0 = s.total_cost(pt["X"], pt["U"], pt["params"]) + \
        s.opts.defect_weight * D
    return dict(s=s, s32=loop32.solver, ocp=ocp, lin=lin, X=pt["X"],
                U=pt["U"], x0=pt["x0"], params=pt["params"], gains=gains,
                D=D, merit0=merit0, nt=lin["Jt"].shape[1],
                fam=lmf_family(inst), inst=inst)


def lmf_entrywise(e, key, tol, what):
    """Fails unless every entry-by-entry float64 figure `e[key]` is ≤ tol."""
    worst = max(e[key].values())
    if worst > tol:
        fail(f"{what} in float64: {worst} of max(1, |twin|) above {tol}: "
             f"{e[key]}")


def lmf_twin_floor(p, sv):
    """The float64 twins' own disagreement at the point `p` (B=512): K12's
    twin against K1's Tassa twin with the same gain solve, the same value
    recursion summed another way (an associative scan of pivoted solves
    against the sequential sweep), entry by entry, of max(1, |twin|)."""
    import torch

    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    mu, rows = p["s"].opts.mu0, p["s"].rows
    a = modes_k12_args(p, B_MAIN, torch.float64)
    r12 = k12.riccati_associative_plain(*a, mu, rows, sv)
    r1 = k1.riccati_backward_plain(*a, mu, rows, form="tassa", quu_solver=sv)
    return {name: err1(x, y) for name, x, y in zip(SWEEP_OUT, r12, r1)}


def lmf_k13_check(p, card):
    """`modes_k13_check` (float64 to 1e-9 with the flags equal, float32 to
    MODES_F32_TOL) with the float64 figures entry by entry held to
    LMF_F64_TOL of max(1, |twin|)."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13

    e = modes_k13_check(p, MF_CHECK_B, card)
    e["e64_entrywise"] = {}
    for nA in (1, 4):
        for Bw in MF_CHECK_B:
            a = modes_k13_args(p, Bw, torch.float64, nA)
            got, ref = k13.linear_trial(*a), k13.linear_trial_plain(*a)
            for name, g, r in zip(TRIAL_OUT[:4], got, ref):
                e["e64_entrywise"][f"{name}_B{Bw}_{nA}alpha"] = err1(g, r)
    lmf_entrywise(e, "e64_entrywise", LMF_F64_TOL, f"K13 ({p['fam']})")
    return e


def lmf_nan_check(p, sv, card):
    """K12 (gain solve `sv`) and K13 (1 and 4 α) at B = 64 and 512 in both
    types with member LIP_FAMILY_NAN's input NaN (K12: one entry of its
    defects; K13: its x0): that member's ΔV₁ / merits non-finite and its
    flags false, every other member's outputs bit for bit those of the
    same call without the NaN. Returns what was seen; fails otherwise."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    mu, rows, m = p["s"].opts.mu0, p["s"].rows, LIP_FAMILY_NAN
    seen, bad = {}, []
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype)[6:]
        for Bw in LMF_NAN_B:
            keep = torch.arange(Bw, device=p["X"].device) != m
            a = modes_k12_args(p, Bw, dtype)
            an = list(a)
            an[5] = a[5].clone()
            an[5][m, 5, 4] = float("nan")
            g = k12.riccati_associative(*a, mu, rows, sv)
            gn = k12.riccati_associative(*an, mu, rows, sv)
            same = all(bits_equal(x[keep], y[keep]) for x, y in zip(g, gn))
            nan_out = not bool(torch.isfinite(gn[2][m]))
            seen[f"k12_{dn}_B{Bw}"] = dict(others_bit_equal=same,
                                           member_dV1_nonfinite=nan_out)
            if not (same and nan_out):
                bad.append(f"K12 {dn} B={Bw}")
            for nA in (1, 4):
                a = list(modes_k13_args(p, Bw, dtype, nA))
                out = k13.linear_trial(*a)
                a[0] = a[0].clone()
                a[0][m] = float("nan")
                outn = k13.linear_trial(*a)
                same = all(bits_equal(x[:, keep], y[:, keep])
                           for x, y in zip(out, outn))
                rejected = (not bool(torch.isfinite(outn[3][:, m]).any())
                            and not bool(outn[4][:, m].any()))
                seen[f"k13_{dn}_B{Bw}_{nA}alpha"] = dict(
                    others_bit_equal=same, member_rejected=rejected)
                if not (same and rejected):
                    bad.append(f"K13 {dn} B={Bw} {nA} α")
    torch.cuda.synchronize()
    emit("lmf_nan_check", family=p["fam"], quu_solver=sv, member=m,
         card=card, failures=bad, **seen)
    if bad:
        fail(f"phase 17: the NaN member at {p['fam']}: {bad}")
    return seen


def lmf_k11_beside(p, nA, sizes):
    """K11 (the rollout trial) on K13's float32 inputs at `sizes` with `nA`
    step sizes, timed in the same call as K13 (`modes_k13_times`): on the
    LIP both give the same plans, so K11 is the other design of the same
    work. Also K13's plans, costs and merits against K11's on the card in
    float64 at B=512 (their twins agree to rounding; the CPU tests hold
    them to 1e-9)."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11

    def k11_args(a):
        return a[:5] + (a[7], a[8], a[9], a[10], a[11], a[12], a[13],
                        a[14], a[16], a[17], a[18], a[19], a[20])

    out = dict(ms_by_B={})
    for Bw in sizes:
        a = k11_args(modes_k13_args(p, Bw, torch.float32, nA))
        out["ms_by_B"][Bw] = cuda_ms(lambda: k11.lip_trial(*a), reps=20)
    a = modes_k13_args(p, B_MAIN, torch.float64, nA)
    g13, g11 = k13.linear_trial(*a), k11.lip_trial(*k11_args(a))
    out["k13_vs_k11_rel_err_f64_B512"] = {
        n: rel_err(x, y) for n, x, y in zip(TRIAL_OUT[:4], g13, g11)}
    out["flags_equal_f64_B512"] = bool(torch.equal(g13[4], g11[4]))
    return out


# K1's LIP shape names phase 17 adds and their structs (riccati_common.cuh)
LMF_K12_STRUCTS = {"lip_rk": "LipRkShape", "lip_quadruped": "LipQuadShape",
                   "lip_quadruped_rk": "LipQuadRkShape",
                   "lip_point_feet": "LipPointFeetShape",
                   "lip_point_feet_rk": "LipPointFeetRkShape"}


def lmf_occupancy_gate(times, card):
    """No new K12 instantiation or K13 family spills: ptxas reports no
    spill store or load for any of their kernels (K12's element and gain
    kernels at each new shape and gain solve, the nx = 18 combine; K13's
    family in float32 and float64), each phase fits at least one block an
    SM, and K13 in float32 with four α runs the blocks an SM its launch
    bound asks (`FAMILY_LAYOUT`). A stack frame without spills (a local
    array) is reported, not gated. Prints the figures; fails otherwise."""
    import re

    import torch

    from srbd_horizon_tpu_torch.kernels import build
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati as k1

    k12_log = build.log_path("riccati_associative").read_text()
    out, bad = {}, []
    for key, t in times.items():
        if key[0] == "k13":
            _, fam, nA = key
            occ = dict(f32=t["occupancy_f32"],
                       f64=k13.occupancy(fam, torch.float64, 20, nA))
            want = k13.FAMILY_LAYOUT[fam]["min_blocks"] if nA == 4 else 1
            for dt, o in occ.items():
                if o["blocks_per_sm"] < 1 or (dt == "f32"
                                              and o["blocks_per_sm"] < want):
                    bad.append(f"K13 {fam} {nA} α {dt}: {o}")
            spills = {dt: r for dt, r in (t["ptxas"] or {}).items()
                      if isinstance(r, dict) and (r.get("spill_stores")
                                                  or r.get("spill_loads"))}
            if not t["ptxas"] or spills:
                bad.append(f"K13 {fam}: ptxas {t['ptxas']}")
            out[f"linear_trial_{fam}_{nA}alpha"] = dict(occ, ptxas=t["ptxas"])
        else:
            _, shape, sv = key
            token = f"{len(LMF_K12_STRUCTS[shape])}{LMF_K12_STRUCTS[shape]}"
            solve = "E0EE" if sv == "schur" else "E1EE"
            px = {n: r for phase in ("element_kernel", "gain_kernel")
                  for n, r in ptxas_entries(k12_log, phase,
                                            demangle=False).items()
                  if token + "E" in n and solve in n}
            nx = k1.KERNEL_SHAPES[shape]["nx"]
            px.update({n: r for n, r in ptxas_entries(
                k12_log, "combine_kernel", demangle=False).items()
                if f"ILi{nx}E" in n})
            occ = dict(f32=t["occupancy_f32"], f64=t["occupancy_f64"])
            for dt, o in occ.items():
                if min(v for k, v in o.items()
                       if k.endswith("_blocks_per_sm")) < 1:
                    bad.append(f"K12 {shape} {sv} {dt}: {o}")
            if len(px) != 5 or any(r["spill_stores"] or r["spill_loads"]
                                   for r in px.values()):
                bad.append(f"K12 {shape} {sv}: ptxas {px}")
            out[mf_row_k12(shape, sv)] = dict(
                occ, ptxas={re.sub(r"^.*?(element|gain|combine)_kernel",
                                   r"\1", n)[:60]: r for n, r in px.items()})
    emit("lmf_occupancy", card=card, failures=bad, **out)
    if bad:
        fail(f"phase 17: a new K12 instantiation or K13 family spills or "
             f"does not fit: {bad}")


def lmf_segment(inst, dev, card, opts, ticks, fleet=False, profile=False,
                vx=0.3, start=2):
    """One run of a LIP instance's loop in float32 with DDPOptions `opts`:
    a robot on `MPCLoop.tick` for `ticks` ticks of `walking_schedule(vx,
    start)` (the quadruped at vx 0.25), or the fleet (B=512, shifted warm
    start, walk command vx 0.2, 0.005·N(0,1) pushes) on `tick_batch`, one
    warm tick, then `ticks` timed, with `profile` the phases inside 5 ticks
    and 2 profiled ticks (idle share, launches a tick by span); counted
    from a reset just before to a read just after, the plain twins
    guarded. Returns the figures with the launches by row name."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.runtime.loop import (TickInput, walk_command,
                                                     walking_schedule)

    topology, step = family_split(inst)
    loop, prob = lip_family_loop(inst, torch.float32, dev, opts=opts,
                                 shift=fleet)
    if fleet:
        g = np.random.RandomState(SEED)
        xn = prob.initial_state.cpu().numpy()
        carry = loop.init(torch.as_tensor(
            xn[None] + 0.005 * g.randn(B_MAIN, xn.shape[0]),
            dtype=torch.float32, device=dev))
        inp = walk_command(B_MAIN, vx=0.2, device=dev)
        carry, _ = loop.tick_batch(carry, inp)
        tick = lambda c, i: loop.tick_batch(c, inp)
    else:
        carry = loop.init(prob.initial_state)
        sched = walking_schedule(ticks, vx=0.25 if topology == "quadruped"
                                 else vx, start=start, device=dev)
        tick = lambda c, i: loop.tick(c, TickInput(*(a[i] for a in sched)))
    torch.cuda.synchronize()
    guards, restore_guards = guard_plain(lmf_twins())
    n, restore = count_solver_calls(loop.solver)
    mf_counts_reset(lip_family_counts_reset)
    syncs0, outs, tms = loop.solver.host_syncs, [], []
    try:
        for i in range(ticks):
            t0 = time.perf_counter()
            carry, o = tick(carry, i)
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
            outs.append(o)
        launches = mf_counts(lip_family_counts)
    finally:
        restore()
        restore_guards()
    so = loop.solver.opts
    res = dict(
        instance=inst, B=B_MAIN if fleet else 1, dtype="float32", ticks=ticks,
        riccati_mode=so.riccati_mode, forward_pass=so.forward_pass,
        quu_solver=so.quu_solver, max_iters=so.max_iters,
        tick_p50_ms=statistics.median(tms), tick_max_ms=max(tms),
        tick_mean_ms=statistics.fmean(tms),
        syncs_per_tick=(loop.solver.host_syncs - syncs0) / ticks,
        iterations_per_tick=n["iterations"] / ticks,
        launches=launches, counted=dict(n),
        finite=all(bool(torch.isfinite(v).all()) for o in outs
                   for v in (o.x, o.u0, o.cost)),
        defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
        **{k: v["n"] for k, v in guards.items()}, card=card)
    if fleet:
        res["members_per_s"] = B_MAIN / res["tick_p50_ms"] * 1e3
    else:
        com = torch.stack([o.x[..., :3] for o in outs]).cpu()
        res.update(z0=float(prob.initial_state[2]),
                   com_z_min=float(com[:, 2].min()),
                   com_z_max=float(com[:, 2].max()),
                   forward_progress_m=float(com[-1, 0] - com[0, 0]))
    if profile:
        step_fn = lambda cc: tick(cc, 0)[0]
        carry, res["spans"] = tick_spans(loop.solver, step_fn, carry, ticks=5)
        res["profile"] = profile_ticks(loop.solver, step_fn, carry,
                                       res["tick_p50_ms"])
        res["device_idle_share"] = res["profile"]["device_idle_share"]
        res["launches_by_span"] = res["profile"]["launches_by_span"]
    return res


def lmf_gates(tag, res, inst):
    """Finite outputs, defects ≤ 1e-4; no plain twin, torch.func transform
    or plain cost on the card; the instance's K10 and lip_evaluate launched
    (the evaluation two a solve) and no other instance's; under the
    associative sweep one K12 sweep at the shape's instantiation with the
    run's gain solve an iteration and no K1, under the sequential one K1's
    sweep (the Tassa form with the gain solve, on one robot and on the
    fleet's `vmap(solve)` alike) an iteration and no K12; K13 at the
    instance's family on the linear trials and K11 on the rollout
    trials."""
    L, n, k1_shape = res["launches"], res["counted"], lmf_k1_shape(inst)
    if not res["finite"]:
        fail(f"{tag}: non-finite values")
    if res["defect_norm_max"] > 1e-4:
        fail(f"{tag}: plans are not dynamically consistent (defect above "
             f"1e-4): {res['defect_norm_max']}")
    if (res["plain_twin_calls"] or res["torch_func_calls"]
            or res["plain_cost_or_defect_calls"]):
        fail(f"{tag} ran plain twins on the card: {res}")
    # every run here takes a non-default mode, under which a fleet's solve
    # is `vmap(solve)`: K1 in the Tassa form with the gain solve
    assoc = res["riccati_mode"] == "associative"
    sweep = (mf_row_k12(k1_shape, res["quu_solver"]) if assoc else
             k1_row_name(k1_shape, "tassa", res["quu_solver"]))
    want = {f"lip_linearize_{inst}": n["iterations"],
            f"lip_evaluate_{inst}": 2 * n["solves"], sweep: n["iterations"]}
    if n["linear_trials"]:
        want["linear_trial_" + lmf_family(inst)] = n["linear_trials"]
    if n["rollout_trials"]:
        want[f"lip_trial_{inst}"] = n["rollout_trials"]
    if L != want or min(want.values()) == 0:
        fail(f"{tag}: the path launched {L}, not {want} (counted {n})")
    if res["forward_pass"] == "linear" and not n["linear_trials"]:
        fail(f"{tag}: no linear trial ran under forward_pass='linear'")


def lmf_versus(card_run, cpu_run, floor):
    """Card = CPU: with max_iters=1 (`floor` false) iterations and
    convergence equal, everything to 1e-9; with the fleets' options by F8's
    rule: iterations and convergence equal, the cost at tick 0 to 1e-9,
    the later ticks' costs, x, u0 and the plans to LIP_FLOOR_TOL (a floor
    step moves u0, the self-simulation carries it into x and the next
    ticks' starts)."""
    r = family_versus(card_run, cpu_run)
    r["cost_tick0_rel_err"] = rel_err(card_run[1][0].cost.cpu(),
                                      cpu_run[1][0].cost)
    rest = max(r[k] for k in ("cost_rel_err", "x_rel_err", "u0_rel_err",
                              "X_rel_err", "U_rel_err"))
    r["ok"] = (r["iterations_equal"] and r["converged_equal"]
               and r["cost_tick0_rel_err"] <= 1e-9
               and rest <= (LIP_FLOOR_TOL if floor else 1e-9))
    return r


def lmf_fleet_ticks(inst, device, n_ticks, max_iters, sv):
    """`tick_batch` of one LIP instance's loop at B=8 in float64 under
    associative/linear with the gain solve `sv` and max_iters (the warm
    start shifted, walk command vx 0.2, 0.005·N(0,1) pushes): (carry,
    outputs) after `n_ticks` ticks."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions
    from srbd_horizon_tpu_torch.runtime.loop import walk_command

    f64 = torch.float64
    loop, p = lip_family_loop(inst, f64, device, opts=DDPOptions(
        max_iters=max_iters, quu_solver=sv, **MF_LINEAR), shift=True)
    g = np.random.RandomState(SEED)
    xn = p.initial_state.cpu().numpy()
    c = loop.init(torch.as_tensor(xn[None] + 0.005 * g.randn(8, xn.shape[0]),
                                  dtype=f64, device=device))
    inp, res = walk_command(8, vx=0.2, dtype=f64, device=device), []
    for _ in range(n_ticks):
        c, o = loop.tick_batch(c, inp)
        res.append(o)
    return c, res


def lip_modes_section(card, dev, sms):
    """Phase 17: the JAX package's execution modes at every LIP shape phase
    16 added — K12 at K1's five new LIP shapes (nx = 30 and, at the
    point-feet biped's, nx = 18) with both gain solves, K13 at the eight
    new (topology, step) families (the true defects in the problem's own
    step). `lmf_k13_check` / `modes_k12_check`: each against its twin at
    B = 1, 64 and 512 (K13 at 1 and 4 step sizes, its flags equal),
    float64 entry by entry to LMF_F64_TOL of max(1, |twin|) (K12: or
    LMF_FLOOR_FACTOR × the float64 twins' own distance, `lmf_twin_floor`,
    where the recursion's conditioning puts it higher; and to K12_F64_TOL
    norm-wise, as phases 13 and 15), float32 to MODES_F32_TOL of the
    float64 twin; `lmf_nan_check`: a NaN member at B = 64 and 512. Times at B = 1, 512 and 4096 in float32: K12 beside
    K1-Tassa with the same gain solve, K13 beside K11 (`lmf_k11_beside`),
    each with its phases, blocks an SM, registers and spills. The paths at
    full width (ns=20, float32; `lmf_segment`, gated by `lmf_gates`): the
    point-feet biped's dlip walk under associative/linear (40 ticks, the
    CoM height and progress gates) and 10 ticks with Cholesky gains; the
    quadruped's LIP trot under the modes (20 ticks) and with Cholesky
    gains; the Kangaroo's LIP fleet under RK2 at B=512 under
    associative/linear, profiled; short runs of the Kangaroo's RK4 walk,
    the quadruped's RK2 and RK4 trots and the biped's RK2 and RK4 walks,
    a Cholesky run at each K12 shape; the two single modes once each.
    Card = CPU in float64 at each instance (`lmf_fleet_ticks`, B=8, 3
    ticks): with max_iters=1 iterations equal and everything to 1e-9, with
    the fleets' options by F8's rule. Returns the eighteen kernel rows."""
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions

    t_section = time.perf_counter()
    # ---- the points and their checks and times ----
    errs, times, nans, k11s = {}, {}, {}, {}
    k12_at = {inst: shape for shape, inst in LMF_K12}
    for i, inst in enumerate(LIP_FAMILY_INSTANCES):
        p = lmf_point(inst, dev, SEED + 170 + i)
        fam = p["fam"]
        errs["k13", fam] = lmf_k13_check(p, card)
        for nA in (1, 4):
            times["k13", fam, nA] = modes_k13_times(p, nA, MF_TIME_B, B_MAIN)
            k11s[fam, nA] = lmf_k11_beside(p, nA, MF_TIME_B)
        if inst in k12_at:
            shape = k12_at[inst]
            q = dict(p, fam=shape)
            for sv in ("schur", "cholesky"):
                e = modes_k12_check(q, sv, MF_CHECK_B, card)
                e["twin_floor_entrywise"] = lmf_twin_floor(q, sv)
                e["tol_f64_entrywise"] = max(
                    LMF_F64_TOL, LMF_FLOOR_FACTOR
                    * max(e["twin_floor_entrywise"].values()))
                emit("lmf_k12_floor", shape=shape, quu_solver=sv,
                     kernel_entrywise=e["e64_entrywise"],
                     twin_floor_entrywise=e["twin_floor_entrywise"],
                     tol_f64_entrywise=e["tol_f64_entrywise"])
                lmf_entrywise(e, "e64_entrywise", e["tol_f64_entrywise"],
                              f"K12 ({shape}, {sv})")
                errs["k12", shape, sv] = e
                times["k12", shape, sv] = modes_k12_times(
                    q, sv, MF_TIME_B, B_MAIN, sv)
                nans[shape, sv] = lmf_nan_check(q, sv, card)
        del p
    torch.cuda.empty_cache()
    emit("lmf_times", card=card, dtype="float32", sms=sms,
         rate="FP64 tensor cores, 67 TFLOP/s (K1, K12, K13 compute in "
              "float64)",
         **{"_".join(map(str, k)): v for k, v in times.items()},
         k11_beside={f"{f}_{nA}": v for (f, nA), v in k11s.items()})
    emit("lmf_k12_vs_k1_tassa", card=card, dtype="float32",
         **{f"{shape}_{sv}": {str(Bw): dict(
             riccati_associative_ms=v["ms"],
             riccati_backward_tassa_ms=v["k1_tassa_ms"])
             for Bw, v in times["k12", shape, sv]["by_B"].items()}
            for shape, _ in LMF_K12 for sv in ("schur", "cholesky")})
    emit("lmf_k13_vs_k11", card=card, dtype="float32",
         **{f"{f}_{nA}alpha": {str(Bw): dict(
             linear_trial_ms=times["k13", f, nA]["by_B"][Bw]["ms"],
             lip_trial_ms=v["ms_by_B"][Bw]) for Bw in MF_TIME_B}
            for (f, nA), v in k11s.items()})
    lmf_occupancy_gate(times, card)
    for (f, nA), v in k11s.items():
        if max(v["k13_vs_k11_rel_err_f64_B512"].values()) > 1e-9:
            fail(f"phase 17: K13 and K11 at {f} ({nA} α) make different "
                 f"plans on the card: {v}")

    # ---- the paths ----
    dlip = lambda **kw: DDPOptions(max_iters=100,
                                   alpha_converge_threshold=1e-12, beta=1e-3,
                                   **kw)
    fleet = lambda **kw: DDPOptions(max_iters=5, **kw)
    chol = dict(quu_solver="cholesky")
    T, S, C = MF_TICKS, MF_SHORT_TICKS, MF_CHOLESKY_TICKS
    single = lambda mode: dict(riccati_mode=mode[0], forward_pass=mode[1])
    segments = (
        ("lmf_pf_walk", "point_feet", dlip(**MF_LINEAR), FAMILY_SINGLE_TICKS,
         False),
        ("lmf_pf_walk_cholesky", "point_feet", dlip(**MF_LINEAR, **chol), S,
         False),
        ("lmf_quadruped_trot", "quadruped", dlip(**MF_LINEAR), T, False),
        ("lmf_quadruped_trot_cholesky", "quadruped",
         dlip(**MF_LINEAR, **chol), C, False),
        ("lmf_kangaroo_rk2_fleet", "kangaroo_rk2", fleet(**MF_LINEAR), 3,
         True),
        ("lmf_kangaroo_rk4_walk_cholesky", "kangaroo_rk4",
         dlip(**MF_LINEAR, **chol), S, False),
        ("lmf_quadruped_rk2_trot", "quadruped_rk2", dlip(**MF_LINEAR), S,
         False),
        ("lmf_quadruped_rk4_trot_cholesky", "quadruped_rk4",
         dlip(**MF_LINEAR, **chol), S, False),
        ("lmf_pf_rk2_walk", "point_feet_rk2", dlip(**MF_LINEAR), S, False),
        ("lmf_pf_rk4_walk_cholesky", "point_feet_rk4",
         dlip(**MF_LINEAR, **chol), S, False),
        ("lmf_pf_walk_associative_nonlinear", "point_feet",
         dlip(**single(("associative", "nonlinear"))), C, False),
        ("lmf_quadruped_rk4_fleet_sequential_linear", "quadruped_rk4",
         fleet(**single(("sequential", "linear"))), C, True))
    path_launches, by_path = defaultdict(int), defaultdict(dict)
    for tag, inst, opts, ticks, is_fleet in segments:
        res = lmf_segment(inst, dev, card, opts, ticks, fleet=is_fleet,
                          profile=tag == "lmf_kangaroo_rk2_fleet",
                          start=10 if ticks == FAMILY_SINGLE_TICKS else 2)
        emit(tag, **res)
        lmf_gates(tag, res, inst)
        if tag == "lmf_pf_walk":
            if max(abs(res["com_z_min"] - LIP_HEIGHT),
                   abs(res["com_z_max"] - LIP_HEIGHT)) > FAMILY_HEIGHT_BAND:
                fail(f"{tag}: the CoM height left {LIP_HEIGHT} ± "
                     f"{FAMILY_HEIGHT_BAND}: {res['com_z_min']}, "
                     f"{res['com_z_max']}")
            if not res["forward_progress_m"] > FAMILY_PROGRESS:
                fail(f"{tag}: forward progress {res['forward_progress_m']} m")
        for k, v in res["launches"].items():
            path_launches[k] += v
            by_path[k][tag] = v
    torch.cuda.empty_cache()

    # ---- lmf_card_vs_cpu: float64 at every instance ----
    cvc, bad = dict(tol="exact_step (max_iters=1): all to 1e-9; options "
                        "(max_iters=5), F8's rule: iterations equal, the "
                        "cost at tick 0 to 1e-9, the rest to "
                        "LIP_FLOOR_TOL", floor_tol=LIP_FLOOR_TOL,
                    modes="associative/linear", B=8, ticks=3), []
    for i, inst in enumerate(LIP_FAMILY_INSTANCES):
        sv = ("schur", "cholesky")[i % 2]
        r = dict(quu_solver=sv)
        for key, iters, floor in (("exact_step", 1, False),
                                  ("options", 5, True)):
            r[key] = lmf_versus(
                lmf_fleet_ticks(inst, dev, 3, iters, sv),
                lmf_fleet_ticks(inst, "cpu", 3, iters, sv), floor=floor)
            if not r[key]["ok"]:
                bad.append(f"{inst} {key}")
        cvc[inst] = r
    emit("lmf_card_vs_cpu", failures=bad, **cvc)
    if bad:
        fail(f"the phase-17 card path and CPU path disagree: {bad}")

    # ---- the kernel rows: launches from this phase's paths ----
    rows_out = []
    for shape, _ in LMF_K12:
        for sv in ("schur", "cholesky"):
            name = mf_row_k12(shape, sv)
            row = modes_k12_row(
                name, times["k12", shape, sv], errs["k12", shape, sv],
                path_launches.get(name, 0), B_MAIN, quu_solver=sv,
                shape=shape, launches_by_path=by_path.get(name, {}),
                launches_of="phase 17's paths",
                nan_member=nans[shape, sv])
            row["tol_f64"] = (
                f"{errs['k12', shape, sv]['tol_f64_entrywise']} of max(1, "
                f"|twin|): {LMF_F64_TOL}, or {LMF_FLOOR_FACTOR}x the twins' "
                "own distance", K12_F64_TOL)
            row["twin_floor_entrywise"] = errs["k12", shape, sv][
                "twin_floor_entrywise"]
            rows_out.append(row)
    for inst in LIP_FAMILY_INSTANCES:
        fam = lmf_family(inst)
        name = "linear_trial_" + fam
        row = modes_k13_row(
            name, times["k13", fam, 1], times["k13", fam, 4],
            errs["k13", fam], path_launches.get(name, 0), B_MAIN,
            family=fam, launches_by_path=by_path.get(name, {}),
            launches_of="phase 17's paths",
            lip_trial_ms_by_B={str(b): v for b, v in
                               k11s[fam, 1]["ms_by_B"].items()},
            lip_trial_ms_4alpha_by_B={str(b): v for b, v in
                                      k11s[fam, 4]["ms_by_B"].items()},
            k13_vs_k11_rel_err_f64_B512=k11s[fam, 1][
                "k13_vs_k11_rel_err_f64_B512"])
        row["tol_f64"] = f"{LMF_F64_TOL} of max(1, |twin|)"
        rows_out.append(row)
    missing = [r["name"] for r in rows_out if r["launches"] == 0]
    if missing:
        fail(f"phase 17: kernels not launched on its paths: {missing}")
    emit("lip_modes_section", seconds=time.perf_counter() - t_section,
         card=card, rows=len(rows_out), path_launches=dict(path_launches))
    return rows_out


# ---------------- the eight-contact robots (phases 18 and 19) ----------------

# JAX's `TestNc8` robot (tests/test_configs.py): four contact points a foot
# (contact_model=4, nc=8), the rows of `foot_positions` in the reference's
# contact order, mass and inertia as the JAX package's test builds them
SQUARE_TOPOLOGY = dict(contact_model=4, number_of_legs=2)
SQUARE_FEET_POINTS = ((0.08, 0.03), (0.08, -0.03), (-0.08, 0.03),
                      (-0.08, -0.03))
SQUARE_LEGS_Y = (0.0, -0.18)
# the (topology, step) instances of K4 / K3 / srbd_evaluate and of K10 /
# K11 / lip_evaluate this phase adds (the two tables use the same names)
SQUARE_INSTANCES = ("square_feet", "square_feet_rk2", "square_feet_rk4")
# JAX's bar in TestNc8: each contact's F_z within this of m·g / (fs·8)
# after a 30-iteration standing solve, the defects below SQUARE_STAND_DEFECT
SQUARE_FZ_TOL = 0.05
SQUARE_STAND_DEFECT = 1e-6
# K1's and K2's instantiations at the square feet's shapes are built apart
K1_SQUARE_SOURCE = "srbd_horizon_tpu_torch/csrc/riccati_backward_square_feet.cu"

# JAX's `TestLineFeetQuadruped` robot (tests/test_configs.py): the point-feet
# quadruped with two contacts LINE_FEET_HALF either side of each foot along
# x (contact_model=2 on four legs, nc=8), trotting with each foot's two
# points in its leg's group
LINE_FEET_TOPOLOGY = dict(contact_model=2, number_of_legs=4)
LINE_FEET_HALF = 0.05
LINE_FEET_INSTANCES = ("line_feet_quadruped", "line_feet_quadruped_rk2",
                       "line_feet_quadruped_rk4")
# JAX's bar in TestLineFeetQuadruped: a standing solve (max_iters=20,
# alpha_converge_threshold=1e-12, beta=1e-3, from the nominal state)
# converges, its defects below LINE_FEET_STAND_DEFECT, Σ F_z (each
# contact's mean over the nodes) within LINE_FEET_FZ_RTOL of m·g / fs
LINE_FEET_STAND_DEFECT = 1e-6
LINE_FEET_FZ_RTOL = 0.01
K1_LINE_FEET_SOURCE = "srbd_horizon_tpu_torch/csrc/riccati_backward_line_feet.cu"


def square_feet_robot():
    """The square-feet biped as JAX's `_four_contact_feet()` builds it:
    mass 40 kg, inertia diag(2.1, 1.8, 0.62), CoM (0, −0.09, 0.88), four
    points a foot at (±0.08, ±0.03) around each leg's y (0 and −0.18)."""
    import numpy as np

    from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants

    pts = [[dx, y + dy, 0.0] for y in SQUARE_LEGS_Y
           for dx, dy in SQUARE_FEET_POINTS]
    return RobotConstants(mass=40.0, inertia=np.diag([2.1, 1.8, 0.62]),
                          com=np.array([0.0, -0.09, 0.88]),
                          foot_positions=np.asarray(pts),
                          foot_frames=tuple(f"c{i}" for i in range(8)))


def line_feet_robot():
    """The line-feet quadruped as JAX's `TestLineFeetQuadruped` builds it:
    the port's `quadruped_point_feet()` with each foot's point replaced by
    two at ±LINE_FEET_HALF along x (c0, c1 lf's front and back, then rf,
    lh, rh), frames c0…c7."""
    import numpy as np

    from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet

    q = quadruped_point_feet()
    pts = [p + s * np.array([LINE_FEET_HALF, 0.0, 0.0])
           for p in np.asarray(q.foot_positions) for s in (1.0, -1.0)]
    return dataclasses.replace(q, foot_positions=np.asarray(pts),
                               foot_frames=tuple(f"c{i}" for i in range(8)))


def line_feet_mask():
    """The trot's group mask over the eight contacts: each foot's two
    points take their leg's entry of `trot_group_mask()`."""
    from srbd_horizon_tpu_torch.models.quadruped import trot_group_mask

    return tuple(g for g in trot_group_mask() for _ in range(2))


def square_standing(dev, dtype):
    """JAX's `TestNc8::test_srbd_nc8_solve` on the card: the square-feet
    SRBD problem solved standing (max_iters=30 from the nominal state and
    the static input) by `MSDDP.solve`; the defect norm, each contact's
    F_z against m·g / (fs·8), the iterations and the launches."""
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

    prob = build_srbd_problem(SRBDConfig(dtype=dtype, **SQUARE_TOPOLOGY),
                              square_feet_robot(), device=dev)
    s = MSDDP(prob.ocp, DDPOptions(max_iters=30))
    x0 = prob.initial_state
    U0 = prob.static_input[None].expand(prob.ocp.ns, -1).contiguous()
    family_counts_reset()
    sol = s.solve(s.init(x0, U0=U0), x0, prob.ocp.params)
    torch.cuda.synchronize()
    launches = family_counts()
    fz = sol.U[:, 5::6].double().cpu()                 # (ns, 8): f_z a contact
    want = prob.mass * 9.81 / prob.force_scaling / 8
    return dict(dtype=str(dtype)[6:], iterations=int(sol.iterations),
                converged=bool(sol.converged),
                defect_norm=float(sol.defect_norm), fz_expected=want,
                fz_max_dev=float((fz - want).abs().max()),
                fz_tol=SQUARE_FZ_TOL, cost=float(sol.cost),
                finite=bool(torch.isfinite(sol.X).all()
                            and torch.isfinite(sol.U).all())), launches


def square_standing_ok(st):
    return (st["finite"] and st["defect_norm"] < SQUARE_STAND_DEFECT
            and st["fz_max_dev"] <= SQUARE_FZ_TOL)


def line_feet_standing(dev, dtype):
    """JAX's `TestLineFeetQuadruped::test_srbd_cm2_legs4_solve` on the
    card: the line-feet quadruped's SRBD problem solved standing
    (max_iters=20, alpha_converge_threshold=1e-12, beta=1e-3, from the
    nominal state) by `MSDDP.solve`; convergence, the defect norm, Σ F_z
    of the contacts' node means against m·g / fs, the iterations and the
    launches."""
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

    prob = build_srbd_problem(SRBDConfig(dtype=dtype, **LINE_FEET_TOPOLOGY),
                              line_feet_robot(), device=dev)
    s = MSDDP(prob.ocp, DDPOptions(max_iters=20, alpha_converge_threshold=1e-12,
                                   beta=1e-3))
    x0 = prob.initial_state
    family_counts_reset()
    sol = s.solve(s.init(x0), x0, prob.ocp.params)
    torch.cuda.synchronize()
    launches = family_counts()
    fz = float(sol.U[:, 5::6].double().cpu().mean(dim=0).sum())
    want = prob.mass * 9.81 / prob.force_scaling
    return dict(dtype=str(dtype)[6:], iterations=int(sol.iterations),
                converged=bool(sol.converged),
                defect_norm=float(sol.defect_norm), fz_sum=fz,
                fz_expected=want, fz_rel_dev=abs(fz - want) / want,
                fz_rtol=LINE_FEET_FZ_RTOL, cost=float(sol.cost),
                finite=bool(torch.isfinite(sol.X).all()
                            and torch.isfinite(sol.U).all())), launches


def line_feet_standing_ok(st):
    return (st["finite"] and st["converged"]
            and st["defect_norm"] < LINE_FEET_STAND_DEFECT
            and st["fz_rel_dev"] <= LINE_FEET_FZ_RTOL)


def nc8_refusals(topology, robot, isrbd):
    """The execution modes at an eight-contact robot: `MSDDP` refuses K12
    and K13 for both problems (NotImplementedError naming both problems,
    nc=8 and ROADMAP.md) before any launch; with `isrbd`, the isrbd
    kernels' shape check refuses the robot's AL inner problem too (naming
    nc=8 and ROADMAP.md). Returns the messages; fails the run if any
    builds or anything launches."""
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
    from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
    from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

    cfg = SRBDConfig(dtype=torch.float64, ns=4, **topology)
    out = {}
    before = (k12.riccati_associative.launches, k13.linear_trial.launches)
    for name, build in (("srbd", build_srbd_problem),
                        ("lip", build_lip_problem)):
        prob = build(cfg, robot(), device="cpu")
        for mode in (dict(riccati_mode="associative"),
                     dict(forward_pass="linear")):
            key = f"{name}_{'_'.join(mode.values())}"
            try:
                MSDDP(prob.ocp, DDPOptions(**mode))
            except NotImplementedError as err:
                msg = str(err)
                if not ("ROADMAP.md" in msg and "the SRBD and the LIP" in msg
                        and "nc=8" in msg):
                    fail(f"nc8_refusals: {key}: the refusal does not name "
                         f"both problems, nc=8 and ROADMAP.md: {msg}")
                out[key] = msg[:240]
                continue
            fail(f"nc8_refusals: the {name} problem at {topology} built "
                 f"under {mode}")
    if isrbd:
        r = robot()
        prob = build_isrbd_problem(
            dataclasses.replace(cfg, lip_height=float(r.com[2])), r,
            cz_rho_weight=None, device="cpu")
        al = ALDDP(prob.ocp, DDPOptions(max_iters=1))
        try:
            k5.check_kernel_shape("isrbd_linearize", al.terms, prob.ocp.nx,
                                  prob.ocp.nu, al.inner.rows)
            fail(f"nc8_refusals: the isrbd kernels take {topology}")
        except ValueError as err:
            msg = str(err)
            if not ("'nc': 8" in msg and "ROADMAP.md Queue 2 row 13" in msg):
                fail(f"nc8_refusals: the isrbd refusal does not name nc=8 "
                     f"and ROADMAP.md Queue 2 row 13: {msg}")
            out["isrbd"] = msg[-240:]
    if (k12.riccati_associative.launches,
            k13.linear_trial.launches) != before:
        fail("nc8_refusals: a refused mode launched K12 or K13")
    return out


# One eight-contact robot's phase: its number, its name in the tags and
# rows, the tags' prefix, the instances, K1's source, the standing check
# and its gate, the single walks' vx and gates (a biped's band, or a
# trot's z0 ± QUAD_HEIGHT_BAND with progress above 0), whether it has
# rows of K2 alone (the square feet's library holds K2's standalone entry
# at nu = 48 and 27), its refusals, and the rule its LIP fleet's card =
# CPU takes under the fleet's options: phase 18's holds every tick's cost
# to 1e-9 (`lip_family_versus`), phase 19's F8's rule as phase 17 and the
# CPU tests (`check_lip_ticks`) take it (`lmf_versus`: the cost at tick 0
# to 1e-9; the line-feet quadruped's floor steps, u0 ~1e-7, move the
# self-simulated x by ~2e-8 and the later ticks' costs past 1e-9).
NC8_PHASES = {
    "square_feet": dict(
        phase=18, prefix="square", instances=SQUARE_INSTANCES,
        k1_source=K1_SQUARE_SOURCE, standing=square_standing,
        standing_ok=square_standing_ok, bar="JAX's TestNc8 bar", vx=0.3,
        trot=False, k2_rows=True,
        refusals=lambda: nc8_refusals(SQUARE_TOPOLOGY, square_feet_robot,
                                      isrbd=False),
        lip_versus=lip_family_versus),
    "line_feet_quadruped": dict(
        phase=19, prefix="line_feet", instances=LINE_FEET_INSTANCES,
        k1_source=K1_LINE_FEET_SOURCE, standing=line_feet_standing,
        standing_ok=line_feet_standing_ok,
        bar="JAX's TestLineFeetQuadruped bar", vx=0.25, trot=True,
        k2_rows=False,
        refusals=lambda: nc8_refusals(LINE_FEET_TOPOLOGY, line_feet_robot,
                                      isrbd=True),
        lip_versus=lmf_versus),
}


def square_feet_section(card, dev, sms):
    """Phase 18: the square-feet biped (contact_model=4, nc=8: the SRBD at
    nx=61, nu=48, the LIP at nx=54, nu=27) under Euler, RK2 and RK4 on K4,
    K3, srbd_evaluate, K10, K11, lip_evaluate and K1 (its twelve new
    instantiations, K2 inside), as `nc8_section` runs it, with K2 alone at
    nu = 48 and 27 and JAX's TestNc8 standing bar (`square_standing`)."""
    return nc8_section("square_feet", card, dev, sms)


def line_feet_section(card, dev, sms):
    """Phase 19: the line-feet quadruped (contact_model=2 on four legs,
    nc=8: the square feet's nx and nu, four fewer rows of G) under Euler,
    RK2 and RK4 on K4, K3, srbd_evaluate, K10, K11, lip_evaluate and K1
    (its twelve new instantiations, csrc/riccati_backward_line_feet.cu),
    as `nc8_section` runs it: the trots with the 8-entry mask, JAX's
    TestLineFeetQuadruped standing bar (`line_feet_standing`) and the
    refusals of the modes and of the isrbd path."""
    return nc8_section("line_feet_quadruped", card, dev, sms)


def nc8_section(robot, card, dev, sms):
    """One eight-contact robot's phase (`NC8_PHASES[robot]`) under Euler,
    RK2 and RK4 on K4, K3, srbd_evaluate, K10, K11, lip_evaluate and K1.
    The kernel checks and times of phases 14 and 16 at the six (problem,
    step) instances (`family_check`, `family_times`, `lip_family_check`,
    `lip_family_times`), the occupancy against the wrappers' reckoning,
    K2 alone at nu = 48 and 27 where the phase has its rows, the standing
    bar, the paths (the SRBD and LIP fleets at B=512 under Euler, an RK2
    fleet of each, a single-robot walk or trot of each problem under Euler
    and under RK4, each with Cholesky ticks after it), card = CPU in
    float64 at B=8 and the refusals. Returns the kernel rows of the
    `kernels` line."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    spec = NC8_PHASES[robot]
    instances, pre, phase = spec["instances"], spec["prefix"], spec["phase"]
    t_section = time.perf_counter()
    parts = {}                    # seconds into the section at each part's end

    def mark(part):
        parts[part] = round(time.perf_counter() - t_section, 1)

    f64 = torch.float64
    errs, k1_shapes, times, occ = {}, {}, {}, {}
    jup = {}
    for inst in instances:
        res, k1_shape, lin64, sweep64, pt = family_check(inst, dev)
        errs["srbd", inst], k1_shapes["srbd", inst] = res, k1_shape
        t, o = family_times(inst, dev, lin64, sweep64, pt)
        times.update(t)
        occ.update(o)
        if inst == robot:
            jup[48] = lin64["Jup"]
        del lin64, sweep64, pt
        torch.cuda.empty_cache()
    mark("srbd_checks_and_times")
    for inst in instances:
        res, k1_shape, lin64, sweep64, pt = lip_family_check(inst, dev)
        errs["lip", inst], k1_shapes["lip", inst] = res, k1_shape
        t, o = lip_family_times(inst, dev, lin64, sweep64, pt)
        times.update(t)
        occ.update(o)
        if inst == robot:
            jup[27] = lin64["Jup"]
        del lin64, sweep64, pt
        torch.cuda.empty_cache()
    mark("lip_checks_and_times")
    # K3's block: the card's shared memory is the wrapper's reckoning
    for inst in instances:
        for dtype in (torch.float32, f64):
            want = k3.trial_layout(dtype, inst)
            got = k3.trial_occupancy(dtype, inst)
            if (got["shared_memory_bytes"] != want["bytes"]
                    or got["blocks_per_sm"] < 1):
                fail(f"{robot}_section: K3 {inst} {dtype}: the card "
                     f"holds {got}, the wrapper reckons {want}")
            occ[f"srbd_trial_{inst}"][f"layout_{str(dtype)[6:]}"] = dict(
                want, occupancy=got)
    # K1: the card's shared memory is `layout_bytes`, and it fits
    for shape in sorted(set(k1_shapes.values()), key=list(k1.KERNEL_SHAPES).index):
        z = k1.KERNEL_SHAPES[shape]
        # row sets of the shape's sizes (the queries read their lengths)
        rows = k1.RiccatiRows(**{f: tuple(range(z[n])) for f, n in (
            ("rx", "n_rx"), ("ru", "n_ru"), ("gx", "n_gx"), ("gu", "n_gu"),
            ("bx", "n_b"), ("bu", "n_b"), ("uc", "n_uc"))})
        for dtype in (torch.float32, f64):
            for _, form, solver in (ki for ki in k1.KERNEL_INSTANCES
                                    if ki[0] == shape):
                kw = dict(form=form, quu_solver=solver)
                smem = k1.shared_memory_bytes(z["nx"], z["nu"], z["nt"], rows,
                                              dtype, **kw)
                blocks = k1.blocks_per_sm(z["nx"], z["nu"], z["nt"], rows,
                                          dtype, **kw)
                if smem != k1.layout_bytes(shape, dtype) or blocks < 1:
                    fail(f"{robot}_section: K1 {shape} {form} {solver} "
                         f"{dtype}: {smem} B, {blocks} blocks an SM")
                name = k1_row_name(shape, form, solver)
                occ.setdefault(name, {})[str(dtype)[6:]] = dict(
                    shared_memory_bytes=smem, blocks_per_sm=blocks)
    emit(f"{robot}_times", card=card, dtype="float32", sms=sms,
         times={k: {str(b): v for b, v in d.items()} for k, d in times.items()},
         occupancy=occ)
    k2 = ({nu: k2_check(f"{robot}_k2_check_nu{nu}", k1, jup[nu], 1e-6, nu=nu)
           for nu in (48, 27)} if spec["k2_rows"] else {})
    del jup
    torch.cuda.empty_cache()
    mark("occupancy_and_k2")

    # ---- the standing bar on the card ----
    path_launches = defaultdict(int)

    def add(launches):
        for k, v in launches.items():
            path_launches[k] += v

    stand = {}
    for dtype in (f64, torch.float32):
        stand[str(dtype)[6:]], launches = spec["standing"](dev, dtype)
        add(launches)
    emit(f"{robot}_standing", card=card, **stand)
    mark("standing")
    st = stand["float64"]
    if not spec["standing_ok"](st):
        fail(f"{robot}_standing: {spec['bar']} not met: {st}")

    # ---- the paths ----
    def k1_names(problem, inst, forms):
        return [k1_row_name(k1_shapes[problem, inst], f, sv) for f, sv in forms]

    tassa_both = (("tassa", "schur"), ("tassa", "cholesky"))
    collapsed = (("collapsed", "schur"),)

    def walk_gates(tag, res, lip):
        if spec["trot"]:
            # the SRBD trot holds z0 ± QUAD_HEIGHT_BAND (the point-feet
            # quadruped's gate); the LIP lifts the CoM from the feet's 0.40 m
            # to its 0.88 m pendulum, so its height is reported
            z0, band = res["z0"], QUAD_HEIGHT_BAND
            if not lip and max(abs(res["com_z_min"] - z0),
                               abs(res["com_z_max"] - z0)) >= band:
                fail(f"{tag}: the trot's CoM height left z0 ± {band}: "
                     f"{res['com_z_min']}, {res['com_z_max']}")
            if not res["forward_progress_m"] > 0:
                fail(f"{tag}: the trot made no forward progress")
            return
        z, band = (LIP_HEIGHT if lip else FAMILY_HEIGHT), FAMILY_HEIGHT_BAND
        if max(abs(res["com_z_min"] - z), abs(res["com_z_max"] - z)) > band:
            fail(f"{tag}: the CoM height left {z} ± {band}: "
                 f"{res['com_z_min']}, {res['com_z_max']}")
        if not res["forward_progress_m"] > FAMILY_PROGRESS:
            fail(f"{tag}: forward progress {res['forward_progress_m']} m, not "
                 f"above {FAMILY_PROGRESS}")

    euler, rk2, rk4 = instances
    summary = {}
    for tag, inst, ticks in ((f"{pre}_srbd_walk", euler, FAMILY_SINGLE_TICKS),
                             (f"{pre}_srbd_rk4_walk", rk4, FAMILY_SHORT_TICKS)):
        res, launches, guards, *_ = family_single_path(
            inst, dev, card, ticks=ticks,
            cholesky_ticks=FAMILY_CHOLESKY_TICKS, quadruped_walk=spec["trot"])
        emit(tag, **res)
        family_gates(tag, res, launches, inst,
                     k1_names("srbd", inst, tassa_both), guards)
        if ticks == FAMILY_SINGLE_TICKS:
            walk_gates(tag, res, lip=False)
        if launches.get(f"srbd_evaluate_{inst}", 0) != 2 * res["solves"]:
            fail(f"{tag}: srbd_evaluate launches are not two a solve")
        if launches.get(f"srbd_trial_{inst}", 0) != res["trials"]:
            fail(f"{tag}: K3 launches do not cover the trials")
        summary[tag] = res["tick_p50_ms"]
        add(launches)
    for tag, inst, timed, prof in (
            (f"{pre}_srbd_fleet", euler, FAMILY_FLEET_TIMED, True),
            (f"{pre}_srbd_rk2_fleet", rk2, FAMILY_SHORT_TICKS, False)):
        res, launches, guards = family_fleet_path(
            inst, dev, card, FAMILY_FLEET_WARM if prof else 0, timed, prof)
        emit(tag, **res)
        family_gates(tag, res, launches, inst,
                     k1_names("srbd", inst, collapsed), guards)
        if launches.get(f"srbd_evaluate_{inst}", 0) != 2 * res["solves"]:
            fail(f"{tag}: srbd_evaluate launches are not two a solve")
        if launches.get(f"srbd_trial_{inst}", 0) != res["trials"]:
            fail(f"{tag}: K3 launches do not cover the trials")
        summary[tag] = (res["tick_p50_ms"], res.get("device_idle_share"))
        add(launches)
    torch.cuda.empty_cache()
    for tag, inst, ticks in ((f"{pre}_lip_walk", euler, FAMILY_SINGLE_TICKS),
                             (f"{pre}_lip_rk4_walk", rk4, FAMILY_SHORT_TICKS)):
        res, launches, guards = lip_family_single(
            inst, dev, card, ticks, FAMILY_CHOLESKY_TICKS, spec["vx"])
        res = dict(res, problem="lip")
        emit(tag, **res)
        lip_family_gates(tag, res, launches, inst,
                         k1_names("lip", inst, tassa_both), guards)
        if ticks == FAMILY_SINGLE_TICKS:
            walk_gates(tag, res, lip=True)
        summary[tag] = res["tick_p50_ms"]
        add(launches)
    for tag, inst, timed, prof in (
            (f"{pre}_lip_fleet", euler, FAMILY_FLEET_TIMED, True),
            (f"{pre}_lip_rk2_fleet", rk2, FAMILY_SHORT_TICKS, False)):
        res, launches, guards = lip_family_fleet_path(
            inst, dev, card, FAMILY_FLEET_WARM if prof else 0, timed, prof)
        emit(tag, **res)
        lip_family_gates(tag, res, launches, inst,
                         k1_names("lip", inst, collapsed), guards)
        summary[tag] = (res["tick_p50_ms"], res.get("device_idle_share"))
        add(launches)
    torch.cuda.empty_cache()
    mark("paths")

    # ---- card = CPU: float64, both fleets at B=8, 3 ticks; the LIP with
    # max_iters=1 (the exact step) and with max_iters=5 by F8's floor
    # rule ----
    def fleet_ticks(lip, device, n_ticks, max_iters=5):
        make = lip_family_fleet if lip else family_fleet
        loop, c, inp = make(euler, 8, f64, device, max_iters=max_iters)
        res = []
        for _ in range(n_ticks):
            c, o = loop.tick_batch(c, inp)
            res.append(o)
        return c, res

    fvc = dict(
        tol=1e-9, floor_tol=LIP_FLOOR_TOL,
        srbd_fleet_B8=dict(ticks=3, **family_versus(
            fleet_ticks(False, dev, 3), fleet_ticks(False, "cpu", 3))),
        lip_fleet_B8=dict(
            ticks=3,
            exact_step=spec["lip_versus"](fleet_ticks(True, dev, 3, 1),
                                          fleet_ticks(True, "cpu", 3, 1),
                                          floor=False),
            options=spec["lip_versus"](fleet_ticks(True, dev, 3),
                                       fleet_ticks(True, "cpu", 3),
                                       floor=True)))
    emit(f"{robot}_card_vs_cpu", **fvc)
    if not (fvc["srbd_fleet_B8"]["ok"] and fvc["lip_fleet_B8"]["exact_step"]["ok"]
            and fvc["lip_fleet_B8"]["options"]["ok"]):
        fail(f"the phase-{phase} card path and CPU path disagree")
    refusals = spec["refusals"]()
    emit(f"{robot}_refusals", **refusals)
    mark("card_vs_cpu_and_refusals")

    # ---- the kernel rows: launches from this phase's paths ----
    trial_tol = "2*plain_rel_err_f32 + 1e-6"
    specs = []        # (row name, module, error key, (problem, instance))
    for inst in instances:
        specs += [(f"srbd_linearize_{inst}", k4, "k4", ("srbd", inst)),
                  (f"srbd_trial_{inst}", k3, "k3", ("srbd", inst)),
                  (f"srbd_evaluate_{inst}", k3, "evaluate", ("srbd", inst)),
                  (f"lip_linearize_{inst}", k10, "k10", ("lip", inst)),
                  (f"lip_trial_{inst}", k11, "k11", ("lip", inst)),
                  (f"lip_evaluate_{inst}", k11, "evaluate", ("lip", inst))]
    new_shapes = {k1_shapes[key]: key for key in reversed(list(k1_shapes))}
    for shape, form, solver in k1.KERNEL_INSTANCES:
        if shape in new_shapes:
            name = k1_row_name(shape, form, solver)
            specs.append((name, k1, name, new_shapes[shape]))
    rows_out = []
    for name, mod, key, src in specs:
        t, e = times[name], errs[src]
        tassa_row = "_tassa" in name
        Bt = 1 if tassa_row else B_MAIN
        tt = t[Bt]
        err = dict(e64=e[key + "_e64"], e32=e[key + "_e32"],
                   p32=e[key + "_p32"], abs32=e[key + "_abs32"])
        tol32 = (K1_F32_TOL if mod is k1
                 else f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}"
                 if key in ("k4", "k10") else trial_tol)
        row = kernel_row(name, mod, path_launches.get(name, 0), tt["ms"],
                         tt["plain_ms"],
                         tt["bound_ms"], tt["bound_by"], err, tol32, B=Bt,
                         instance=src[1], problem=src[0],
                         ms_by_B={str(b): v["ms"] for b, v in t.items()},
                         plain_ms_by_B={str(b): v["plain_ms"]
                                        for b, v in t.items()},
                         bound_ms_by_B={str(b): v["bound_ms"]
                                        for b, v in t.items()},
                         achieved_GB_per_s=tt["achieved_GB_per_s"],
                         launches_of=f"phase {phase}'s paths",
                         **occ.get(name, {}))
        row["tol_f64"] = (1e-9 if mod is k1 else LIP_F64_TOL if src[0] == "lip"
                          else FAMILY_F64_TOL)
        if mod is k1:
            row["source"] = spec["k1_source"]
        if key == "evaluate":
            row["replaces"] = mod.EVALUATE_REPLACES
        elif tassa_row:
            row["replaces"] = k1.TASSA_REPLACES
        if key in ("k3", "k11"):
            row["ms_4alpha"] = tt["ms_4alpha"]
        if key == "k11":
            row["chain_ms"] = tt["chain_ms"]
        rows_out.append(row)
    for nu, problem in ((48, "srbd"), (27, "lip")) if k2 else ():
        shapes = {k1_shapes[problem, i] for i in instances}
        k2_launches = sum(path_launches.get(k1_row_name(*ki), 0)
                          for ki in k1.KERNEL_INSTANCES
                          if ki[0] in shapes and ki[2] == "schur")
        r = k2[nu]
        rows_out.append(dict(kernel_row(
            f"spd_inverse_nu{nu}", k1, k2_launches, r["ms_f32"],
            r["plain_ms_f32"], r["bound_ms"], r["bound_by"],
            dict(e64=r["f64_rel_err"], e32=r["f32_rel_err"],
                 p32=r["f32_plain_rel_err"], abs32=r["f32_max_abs_err"]),
            K2_F32_TOL, launches_of="K1 with the block-Schur inverse at the "
            f"square-feet {problem.upper()} shapes on phase {phase}'s paths "
            "(K2 runs inside K1)", stack=r["stack"], ms_f64=r["ms_f64"],
            library_ms_f32=r["torch_linalg_inv_ms_f32"]),
            replaces=k1.K2_REPLACES, source=spec["k1_source"],
            library_ms=r["torch_linalg_inv_ms_f64"]))
    missing = [r["name"] for r in rows_out if r["launches"] == 0]
    if missing:
        fail(f"phase {phase}: kernels not launched on its paths: {missing}")
    emit(f"{robot}_section", seconds=time.perf_counter() - t_section,
         card=card, rows=len(rows_out), path_launches=dict(path_launches),
         tick_p50_ms=summary, seconds_at_end_of=parts)
    return rows_out


# ---------------- K12 against another tree's (--k12-versus) ----------------

K12_VERSUS_B = (1, B_MAIN, B_LARGE)
K12_PHASES = ("element_kernel", "combine_kernel", "gain_kernel")


def k12_shape_point(shape, dev, seed, Bm=B_MAIN):
    """A float64 linearization point on the card at one of K1's nine
    shapes (`riccati.KERNEL_SHAPES` name), Bm members, made by the plain
    linearizers (no kernel library): the SRBD and LIP problems at iterates
    drawn as phase 13 draws them (X ± 0.05·N, U 0.1·N), the two AL inner
    problems at `draw_isrbd_point`'s active cones and boxes. Returns (lin,
    rows, μ, nt)."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.models.kangaroo import (kangaroo_line_feet,
                                                        point_feet)
    from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
    from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
    from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP
    from srbd_horizon_tpu_torch.solvers.options import al_serving_options

    f64 = torch.float64
    g = np.random.RandomState(seed)
    feet, quad = kangaroo_line_feet(), quadruped_point_feet()
    if shape in ("isrbd_al", "isrbd_al_quadruped"):
        d, a = al_serving_options(1)
        if shape == "isrbd_al":
            prob = build_isrbd_problem(SRBDConfig(dtype=f64), feet, device=dev,
                                       cz_rho_weight=CZ_RHO_WEIGHT)
            draw = dict(com_z=0.88, fz=98.0, fxy=60.0, u_box=(60.0, 130.0))
        else:
            prob = build_isrbd_problem(
                SRBDConfig(dtype=f64, lip_height=float(quad.com[2]),
                           **QUAD_TOPOLOGY), quad, device=dev)
            draw = dict(com_z=float(prob.initial_state[2]), fz=78.0, fxy=50.0,
                        u_box=(50.0, 110.0))
        al = ALDDP(prob.ocp, d, a)
        s, ocp = al.inner, prob.ocp
        X, U, _, _, params = draw_isrbd_point(al, Bm, g, dev, **draw)
        lin = k5.isrbd_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt)
    else:
        base = shape[:-3] if shape.endswith("_rk") else shape
        step = "RK2" if shape.endswith("_rk") else "EULER"
        if base == "lip":
            prob = build_lip_problem(SRBDConfig(dtype=f64), feet, device=dev)
        else:
            cfg, robot = {
                "srbd": (SRBDConfig(dtype=f64), feet),
                "quadruped": (SRBDConfig(dtype=f64, **QUAD_TOPOLOGY), quad),
                "point_feet": (SRBDConfig(dtype=f64, contact_model=1,
                                          number_of_legs=2), point_feet())}[base]
            prob = build_srbd_problem(cfg, robot, device=dev, integrator=step)
        s, ocp = MSDDP(prob.ocp, DDPOptions()), prob.ocp
        X = torch.as_tensor(prob.initial_state.cpu().numpy()[None, None]
                            + 0.05 * g.randn(Bm, ocp.ns + 1, ocp.nx),
                            device=dev)
        U = torch.as_tensor(0.1 * g.randn(Bm, ocp.ns, ocp.nu), device=dev)
        params = {k: v.expand((Bm,) + tuple(v.shape)).contiguous()
                  for k, v in ocp.params.items()}
        plain = k10.lip_linearize_plain if base == "lip" else \
            k4.srbd_linearize_plain
        lin = plain(X, U, params, s.terms, s.rows, ocp.dt, s._wc(f64))
    return lin, s.rows, s.opts.mu0, lin["Jt"].shape[1]


def k13_point(fam, dev, seed, Bm=B_MAIN):
    """The `p` the modes' K13 helpers take (`modes_k13_args`) at K13's
    family `fam` (`linear_trial.FAMILY_NAMES`), Bm members in float64 on
    the card, made without a kernel library: the SRBD problem at its
    (topology, step) and the LIP at iterates drawn as phase 13 draws them
    (X ± 0.05·N, U 0.1·N), the AL inner problems at `draw_isrbd_point`'s
    active cones and boxes; linearized by the plain linearizers, the gains
    from K12's twin (Cholesky at the AL shapes, as phase 13)."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
    from srbd_horizon_tpu_torch.models.kangaroo import (kangaroo_line_feet,
                                                        point_feet)
    from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
    from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
    from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP
    from srbd_horizon_tpu_torch.solvers.options import al_serving_options

    f64 = torch.float64
    g = np.random.RandomState(seed)
    feet, quad = kangaroo_line_feet(), quadruped_point_feet()
    sv = "schur"
    if fam in ("isrbd_al", "isrbd_al_quadruped"):
        d, a = al_serving_options(1)

        def problem(dtype):
            if fam == "isrbd_al":
                return build_isrbd_problem(SRBDConfig(dtype=dtype), feet,
                                           device=dev,
                                           cz_rho_weight=CZ_RHO_WEIGHT)
            return build_isrbd_problem(
                SRBDConfig(dtype=dtype, lip_height=float(quad.com[2]),
                           **QUAD_TOPOLOGY), quad, device=dev)
        prob = problem(f64)
        al = ALDDP(prob.ocp, d, a)
        s, s32, ocp = al.inner, ALDDP(problem(torch.float32).ocp, d,
                                      a).inner, prob.ocp
        draw = (dict(com_z=0.88, fz=98.0, fxy=60.0, u_box=(60.0, 130.0))
                if fam == "isrbd_al" else
                dict(com_z=float(prob.initial_state[2]), fz=78.0, fxy=50.0,
                     u_box=(50.0, 110.0)))
        X, U, _, _, params = draw_isrbd_point(al, Bm, g, dev, **draw)
        lin = k5.isrbd_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt)
        sv = "cholesky"
    else:
        topology, step = family_split(fam)
        topology = "kangaroo" if topology == "srbd" else topology

        def problem(dtype):
            if topology == "lip":
                return build_lip_problem(SRBDConfig(dtype=dtype), feet,
                                         device=dev)
            cfg, robot = {
                "kangaroo": (SRBDConfig(dtype=dtype), feet),
                "quadruped": (SRBDConfig(dtype=dtype, **QUAD_TOPOLOGY), quad),
                "point_feet": (SRBDConfig(dtype=dtype, contact_model=1,
                                          number_of_legs=2), point_feet())
            }[topology]
            return build_srbd_problem(cfg, robot, device=dev, integrator=step)
        prob = problem(f64)
        s, ocp = MSDDP(prob.ocp, DDPOptions()), prob.ocp
        s32 = MSDDP(problem(torch.float32).ocp, DDPOptions())
        X = torch.as_tensor(prob.initial_state.cpu().numpy()[None, None]
                            + 0.05 * g.randn(Bm, ocp.ns + 1, ocp.nx),
                            device=dev)
        U = torch.as_tensor(0.1 * g.randn(Bm, ocp.ns, ocp.nu), device=dev)
        params = {k: v.expand((Bm,) + tuple(v.shape)).contiguous()
                  for k, v in ocp.params.items()}
        plain = k10.lip_linearize_plain if topology == "lip" else \
            k4.srbd_linearize_plain
        lin = plain(X, U, params, s.terms, s.rows, ocp.dt, s._wc(f64))
    gains = k12.riccati_associative_plain(*(lin[k] for k in ORDER),
                                          s.opts.mu0, s.rows, sv)
    x0 = X[:, 0] + torch.as_tensor(0.005 * g.randn(Bm, ocp.nx), device=dev)
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    merit0 = s.total_cost(X, U, params) + s.opts.defect_weight * D
    return dict(s=s, s32=s32, ocp=ocp, lin=lin, X=X, U=U, x0=x0,
                params=params, gains=gains, D=D, merit0=merit0,
                nt=lin["Jt"].shape[1], fam=fam)


K7_SHAPES = ("kangaroo", "quadruped")   # K7's AL shapes (KERNEL_SHAPES)
K7_NAN = 7                  # the member whose plan and λ hold a NaN


def k7_point(shape, dev, seed, Bm=B_CONSTRAINED):
    """K7's inputs at one of its AL shapes, Bm members in float64 on the
    card: the serving configuration's AL solvers in both types (the
    Kangaroo's with the serving cz stiffness), a plan, state and box
    overrides drawn by `draw_isrbd_point` (active cones and boxes), member
    K7_NAN's r̈ₓ at node 3 and one of its λ NaN, a viol_prev drawn on
    either side of the contraction test. Returns dict(al={dtype: ALDDP},
    X, U, st, boxes (params with the overrides), static (without),
    viol_later)."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import SRBDConfig
    from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
    from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
    from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
    from srbd_horizon_tpu_torch.solvers.options import al_serving_options

    quad = quadruped_point_feet()

    def problem(dtype):
        if shape == "kangaroo":
            return build_isrbd_problem(SRBDConfig(dtype=dtype),
                                       kangaroo_line_feet(), device=dev,
                                       cz_rho_weight=CZ_RHO_WEIGHT)
        return build_isrbd_problem(
            SRBDConfig(dtype=dtype, lip_height=float(quad.com[2]),
                       **QUAD_TOPOLOGY), quad, device=dev)
    prob = problem(torch.float64)
    al = {torch.float64: ALDDP(prob.ocp, *al_serving_options(1)),
          torch.float32: ALDDP(problem(torch.float32).ocp,
                               *al_serving_options(1))}
    draw = (dict(com_z=0.88, fz=98.0, fxy=60.0, u_box=(60.0, 130.0))
            if shape == "kangaroo" else
            dict(com_z=float(prob.initial_state[2]), fz=78.0, fxy=50.0,
                 u_box=(50.0, 110.0)))
    g = np.random.RandomState(seed)
    X, U, st, params, _ = draw_isrbd_point(al[torch.float64], Bm, g, dev,
                                           **draw)
    U[K7_NAN, 3, 0] = float("nan")
    st = st._replace(sol=st.sol._replace(X=X, U=U), lam_eq=st.lam_eq.clone())
    st.lam_eq[K7_NAN, 2, 4] = float("nan")
    viol_later = torch.as_tensor(10.0 ** g.uniform(-3, 3, Bm), device=dev)
    return dict(al=al, X=X, U=U, st=st, boxes=params,
                static=static_bounds(params), viol_later=viol_later)


def k7_args(p, dtype, mode, bounds="static", Bw=None, later=False,
            nan=True):
    """(args, kwargs) of a K7 call at `k7_point`'s `p` in `dtype` and mode
    ("eval", "online", "offline"), with the static bounds or the drawn
    overrides ("boxes"), its members cut or repeated to Bw, viol_prev
    drawn (`later`) or the state's (inf: a first outer), without member
    K7_NAN's NaNs where `nan` is false."""
    st = p["st"]._replace(viol=p["viol_later"]) if later else p["st"]
    if not nan:
        U = p["U"].clone()
        U[K7_NAN, 3, 0] = 0.0
        lam = st.lam_eq.clone()
        lam[K7_NAN, 2, 4] = 0.0
        st = st._replace(sol=st.sol._replace(U=U), lam_eq=lam)
    Bsz = p["X"].shape[0]
    tree = (st, p[bounds])
    if Bw is not None:
        tree = resize_members(tree, Bsz, Bw)
    st, params = (cast_tree(t, dtype) for t in tree)
    kw = {} if mode == "eval" else dict(st=st, offline=mode == "offline")
    return (p["al"][dtype], st.sol.X, st.sol.U, params), kw


def build_other(tree, names):
    """Start one nvcc a source on the kernel sources `names` of another
    tree (its `srbd_horizon_tpu_torch/csrc/`) into build/kernels/versus/,
    each report beside its library; returns a function that waits for
    them and loads the libraries ({name: CDLL})."""
    import ctypes

    from srbd_horizon_tpu_torch.kernels import build

    out = build.BUILD_DIR / "versus"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = Path(tree) / "srbd_horizon_tpu_torch" / "csrc" / f"{name}.cu"
        log = open(out / f"{name}.log", "w")
        procs[name] = (log, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS,
             *build.SOURCE_FLAGS.get(name, ()), "-o",
             str(out / f"lib{name}.so"), str(src)],
            stdout=log, stderr=subprocess.STDOUT))

    def done():
        libs = {}
        for name, (log, proc) in procs.items():
            proc.wait()
            log.close()
            if proc.returncode != 0:
                fail(f"nvcc failed on {tree}'s {name}.cu: "
                     f"{(out / f'{name}.log').read_text()}")
            libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
        return libs
    return done


# the other tree's kernel modules a wrapper imports whose interface may
# differ from this tree's (the LIP kernels' shape table, the occupancy
# helpers): loaded from that tree first, in this order, and seen by its
# wrappers' imports
VERSUS_DEPS = ("build", "lip_linearize")
_versus_deps = {}


def other_wrapper(tree, module, libs):
    """Another tree's kernel wrapper `kernels/<module>.py`, loaded as a
    module of its own whose `library` returns that tree's libraries
    (`libs`) and whose `host_setup` keeps its own setups, for a wrapper
    whose C interface changed between the trees. Its imports of the
    modules in VERSUS_DEPS get that tree's copies."""
    import importlib.util

    import srbd_horizon_tpu_torch.kernels as pkg

    def load(name):
        path = Path(tree) / "srbd_horizon_tpu_torch" / "kernels" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"versus_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.library = lambda n: libs[n]
        # its own host setups: a setup holds its tree's entry functions
        setups = {}

        def host_setup(terms, key, make):
            k = (id(terms),) + key
            if k not in setups:
                setups[k] = (terms, make())
            return setups[k][1]
        mod.host_setup = host_setup
        return mod

    deps = _versus_deps.setdefault(str(tree), {})
    saved = {}
    try:
        for name in VERSUS_DEPS + (module,):
            if name not in deps:
                deps[name] = load(name)
            full = f"srbd_horizon_tpu_torch.kernels.{name}"
            if name not in saved:
                saved[name] = (sys.modules.get(full), getattr(pkg, name, None))
            sys.modules[full] = deps[name]
            setattr(pkg, name, deps[name])
        return deps[module]
    finally:
        for name, (m, attr) in saved.items():
            full = f"srbd_horizon_tpu_torch.kernels.{name}"
            if m is None:
                sys.modules.pop(full, None)
            else:
                sys.modules[full] = m
            if attr is None:
                delattr(pkg, name)
            else:
                setattr(pkg, name, attr)


def ptxas_report(log_text):
    """{kernel phase: {registers, spill_stores, spill_loads}} of each of
    K12's kernels (their largest over the instantiations) from nvcc's
    `-Xptxas -v` report."""
    out = {}
    for phase in K12_PHASES:
        for r in ptxas_entries(log_text, phase, demangle=False).values():
            o = out.setdefault(phase, dict.fromkeys(r, 0))
            for k, v in r.items():
                o[k] = max(o[k], v)
    return out


def ptxas_entries(log_text, kernel, demangle=True):
    """{entry: {registers, spill_stores, spill_loads}} of each compiled
    entry function whose mangled name holds `kernel`, from nvcc's
    `-Xptxas -v` report, the names demangled where asked and c++filt is
    found."""
    import re
    import shutil

    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn is not None:
                out.setdefault(fn, dict(registers=0, spill_stores=0,
                                        spill_loads=0))
            continue
        if fn is None:
            continue
        r = out[fn]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            r["spill_stores"] = max(r["spill_stores"], int(m.group(1)))
            r["spill_loads"] = max(r["spill_loads"], int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r["registers"] = max(r["registers"], int(m.group(1)))
    if demangle and shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True).stdout
        out = dict(zip(names.splitlines(), out.values()))
    return out


def k13_ptxas(log_text):
    """K13's ptxas figures a family: {family: {"float32" | "float64":
    {registers, spill_stores, spill_loads}}}, read from the demangled
    names of `linear_trial_kernel`'s instantiations (with_family's
    structs); the mangled entries as they are where c++filt is missing."""
    import re

    shapes = {"kangaroo": "KangarooShape", "quadruped": "QuadShape",
              "point_feet": "PointFeetShape"}
    k1_lip = {"kangaroo": "Lip", "quadruped": "LipQuad",
              "point_feet": "LipPointFeet"}
    structs = {"srbd": "SrbdFamily<KangarooShape>",
               "quadruped": "SrbdFamily<QuadShape>",
               "point_feet": "SrbdFamily<PointFeetShape>",
               "isrbd_al": "IsrbdAlFamily<KangarooAlShape>",
               "isrbd_al_quadruped": "IsrbdAlFamily<QuadAlShape>"}
    for topo, shape in shapes.items():
        lip = "lip" if topo == "kangaroo" else "lip_" + topo
        structs[lip] = f"LipFamily<{shape},{k1_lip[topo]}Shape>"
        for step in ("Rk2", "Rk4"):
            structs[f"{topo}_{step.lower()}"] = \
                f"SrbdFamily<Stepped<{shape},{step}>>"
            structs[f"lip_{topo}_{step.lower()}"] = \
                f"LipFamily<Stepped<{shape},{step}>,{k1_lip[topo]}RkShape>"
    want = {v: k for k, v in structs.items()}
    entries = ptxas_entries(log_text, "linear_trial_kernel")
    out = {}
    for name, r in entries.items():
        m = re.search(r"linear_trial_kernel<(.*),\s*(float|double)>", name)
        arg = m and re.sub(r"\(anonymousnamespace\)::|\b(?:srbd|lip|isrbd|rigid)::",
                           "", m.group(1).replace(" ", ""))
        if arg in want:
            dt = "float64" if m.group(2) == "double" else "float32"
            out.setdefault(want[arg], {})[dt] = r
    return out or entries


def k12_occupancy_raw(lib, inst, f64):
    """The first six values of a K12 library's occupancy entry (shared
    memory bytes and blocks an SM of each phase), for a library of either
    tree."""
    import ctypes

    fn = lib.riccati_associative_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 16)()
    if fn(inst, int(f64), out) != 0:
        fail(f"riccati_associative_occupancy({inst}) failed")
    names = ("element", "combine", "gain")
    return ({f"{p}_shared_memory_bytes": out[i] for i, p in enumerate(names)}
            | {f"{p}_blocks_per_sm": out[3 + i] for i, p in enumerate(names)})


VERSUS_PARTS = ("k12", "k13", "k11", "k7")
# the sources the versus run builds from both trees: K12's, K13's, and the
# evaluate kernels' (whose node evaluation K13 shares) with K3, K6, K11;
# K11's with the kernels that share csrc/lip_common.cuh (lip_evaluate, K10,
# K13's LIP family); K7's source, which holds K8a-c too
VERSUS_SOURCES = {"k12": ("riccati_associative",),
                  "k13": ("linear_trial", "srbd_rollout", "isrbd_rollout",
                          "lip_rollout"),
                  "k11": ("lip_rollout", "lip_linearize", "linear_trial"),
                  "k7": ("isrbd_al",)}
K13_VERSUS_B = (1, B_MAIN, B_LARGE)
K11_VERSUS_B = (1, B_MAIN, B_LARGE)
K11_NAN = 7                     # the member whose x0 is NaN in K11's check


def k12_versus(other_tree, card, parts=VERSUS_PARTS):
    """K12 and K13 of this tree against those of `other_tree` (an
    unpacked archive of another commit) on the same card in one process:
    every library both need built from both trees at once, then
    `k12_versus_part` and `k13_versus_part` (the parts named in
    `parts`). Prints their lines, then ptxas' figures of both trees."""
    import torch

    from srbd_horizon_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    names = list(dict.fromkeys(n for part in parts
                               for n in VERSUS_SOURCES[part]))
    other_done = build_other(other_tree, names)
    build.build_all(names, force=True)
    libs = {"this": {n: build.library(n) for n in names},
            "other": other_done()}
    emit("k12_versus_build", seconds=time.perf_counter() - t0, sources=names)
    logs = {"this": lambda n: build.log_path(n).read_text(),
            "other": lambda n: (build.BUILD_DIR / "versus" /
                                f"{n}.log").read_text()}

    def use(which, name):
        build._loaded[name] = libs[which][name]

    ptxas = {}
    if "k12" in parts:
        k12_versus_part(dev, card, use)
        ptxas["k12"] = {w: ptxas_report(logs[w]("riccati_associative"))
                        for w in logs}
    if "k13" in parts:
        k13_versus_part(other_tree, dev, card, use, libs["other"])
        ptxas["k13"] = {w: k13_ptxas(logs[w]("linear_trial")) for w in logs}
    failed = []
    if "k11" in parts:
        failed += k11_versus_part(other_tree, dev, card, use, libs["other"])
        ptxas["k11"] = {w: ptxas_entries(logs[w]("lip_rollout"),
                                         "lip_trial_kernel") for w in logs}
    if "k7" in parts:
        failed += k7_versus_part(other_tree, dev, card, use, libs["other"])
        ptxas["k7"] = {w: ptxas_entries(logs[w]("isrbd_al"), "isrbd_al")
                       for w in logs}
    for n in names:
        use("this", n)
    emit("k12_versus_done", seconds=time.perf_counter() - t0, parts=parts,
         ptxas=ptxas)
    if failed:
        fail("; ".join(failed))


def k12_versus_part(dev, card, use):
    """K12's 16 instantiations of both trees: each checked against the
    twin in float64 at B = 8 and 512 and timed in float32 at B = 1, 512
    and 4096 in turns (other, this, this, other), with each phase's device
    ms from the profiler and the blocks an SM of each phase; one
    `k12_versus` line an instantiation."""
    import torch

    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    point = {}
    for i, (shape, sv) in enumerate(k12.KERNEL_INSTANCES):
        if shape not in point:      # one shape's point at a time
            point = {shape: k12_shape_point(shape, dev, SEED + 170 + i)}
        lin, rows, mu, nt = point[shape]
        a64 = tuple(lin[k] for k in ORDER)
        r = dict(instance=i, shape=shape, quu_solver=sv, card=card,
                 e64={}, ms={}, phases={}, occupancy={})
        for Bw in (8, B_MAIN):
            a = tuple(modes_sub(t, Bw) for t in a64)
            ref = k12.riccati_associative_plain(*a, mu, rows, sv)
            for which in ("other", "this"):
                use(which, "riccati_associative")
                got = k12.riccati_associative(*a, mu, rows, sv)
                torch.cuda.synchronize()
                r["e64"][f"{which}_B{Bw}"] = max(
                    rel_err(g_, w_) for g_, w_ in zip(got, ref))
        for which in ("other", "this"):
            use(which, "riccati_associative")
            r["occupancy"][which] = k12_occupancy_raw(
                k12.library("riccati_associative"), i, False)
        for Bw in K12_VERSUS_B:
            a32 = tuple(modes_sub(t, Bw).float() for t in a64)
            reps = 10 if Bw < B_LARGE else 3
            for which in ("other", "this", "this", "other"):
                use(which, "riccati_associative")
                r["ms"].setdefault(which, {}).setdefault(str(Bw), []).append(
                    cuda_ms(lambda: k12.riccati_associative(*a32, mu, rows,
                                                            sv), reps=reps))
            for which in ("other", "this"):
                use(which, "riccati_associative")
                r["phases"].setdefault(which, {})[str(Bw)] = k12_phase_ms(
                    lambda: k12.riccati_associative(*a32, mu, rows, sv))
            del a32
        use("this", "riccati_associative")
        emit("k12_versus", **r)
        torch.cuda.empty_cache()


def k13_versus_part(other_tree, dev, card, use, other_libs):
    """K13 of both trees at its twelve families (the other tree through
    its own wrapper, whose C interface differs): each checked against the
    twin in float64 at B = 8 and 512 with one and four α (`rel_err` a
    output, the flags equal), timed in float32 at B = 1, 512 and 4096 with
    one and four α in turns (other, this, this, other), this tree's chain
    alone at B = 1 and 512 with one and four α (`linear_trial_chain`),
    both trees' occupancy;
    one `k13_versus` line a family. Then the kernels whose node evaluation
    K13 shares and the trials in the same sources (srbd_evaluate at nine
    SRBD instances, isrbd_evaluate at two AL shapes, lip_evaluate; K3, K6,
    K11): both trees' outputs at B = 512 (with and without x0; four α),
    bit-equal or not, and their float32 times at B = 1 and 512 in turns;
    one `evaluate_versus` line a kernel and instance."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.solvers.msddp import _KERNELS

    from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
    from srbd_horizon_tpu_torch.kernels import rollout as k3

    f64, f32 = torch.float64, torch.float32
    old = other_wrapper(other_tree, "linear_trial", other_libs)
    k13s = {"this": k13, "other": old}
    # the evaluate and trial wrappers of both trees (each caches its entry
    # functions, so the other tree's are modules of their own)
    rollouts = {"this": {"srbd": k3, "isrbd_al": k6, "lip": k11},
                "other": {fam: other_wrapper(other_tree, mod, other_libs)
                          for fam, mod in (("srbd", "rollout"),
                                           ("isrbd_al", "isrbd_rollout"),
                                           ("lip", "lip_rollout"))}}
    use("this", "linear_trial")
    for i, fam in enumerate(k13.FAMILY_NAMES):
        p = k13_point(fam, dev, SEED + 180 + i)
        r = dict(family=fam, card=card, e64={}, flags_equal={}, ms={},
                 chain_ms={}, occupancy={}, evaluate={})
        for nA in (1, 4):
            for Bw in (8, B_MAIN):
                a = modes_k13_args(p, Bw, f64, nA)
                ref = k13.linear_trial_plain(*a)
                for which, mod in k13s.items():
                    got = mod.linear_trial(*a)
                    torch.cuda.synchronize()
                    key = f"{which}_B{Bw}_{nA}a"
                    r["e64"][key] = max(rel_err(g_, w_) for g_, w_ in
                                        zip(got[:4], ref[:4]))
                    r["flags_equal"][key] = bool(torch.equal(got[4], ref[4]))
            for Bw in K13_VERSUS_B:
                a32 = modes_k13_args(p, Bw, f32, nA)
                reps = 20 if Bw < B_LARGE else 5
                for which in ("other", "this", "this", "other"):
                    r["ms"].setdefault(which, {}).setdefault(
                        f"B{Bw}_{nA}a", []).append(cuda_ms(
                            lambda: k13s[which].linear_trial(*a32),
                            reps=reps))
        for nA in (1, 4):
            for Bw in (1, B_MAIN):
                a32 = modes_k13_args(p, Bw, f32, nA)
                r["chain_ms"][f"B{Bw}_{nA}a"] = cuda_ms(
                    lambda: k13.linear_trial_chain(*a32), reps=20)
        r["occupancy"]["this"] = k13.occupancy(fam, f32)
        r["occupancy"]["other"] = old.occupancy(fam, f32)
        r["phase_bytes"] = k13.phase_bytes(fam, f32)
        emit("k13_versus", **r)
        evaluate_versus(p, fam, card, rollouts)
        del p
        torch.cuda.empty_cache()


def k11_versus_part(other_tree, dev, card, use, other_libs):
    """K11 of both trees (the other through its own wrapper) at the LIP's
    drawn point (`k13_point`): each held against `lip_trial_plain` in
    float64 at B = 8 and 512 with one and four α, member K11_NAN from a NaN
    x0 (`err1` an output, 1e-12 of max(1, |twin|) for this tree; the flags
    equal; the NaN member rejected); both timed in float32 at B = 1, 512
    and 4096 with one and four α in turns (other, this, this, other), this
    tree's chain alone (`lip_trial_chain`), the bound of each case, both
    trees' occupancy: one `k11_versus` line. Then K10, K11 and K13's LIP
    family of both trees, which share csrc/lip_common.cuh, bit for bit at B
    = 512 in both types; lip_evaluate of both trees (with and without x0)
    against its twin in float64 at B = 8 with a NaN member (1e-12 of
    max(1, |twin|), the NaN member NaN, the pinned plan bit for bit), this
    tree's in float32 at B = 512 against the float64 twin; K10 and
    lip_evaluate timed in float32 at B = 1, 512 and 4096 in turns (other,
    this, this, other) beside their bounds, K11 and K13 at B = 1 and 512;
    both trees' wrapper host µs in turns at B = 1 (`host_us_turns`); this
    tree's occupancy and launch shapes: one `k11_shared_versus` line.
    Returns what failed, for the caller to report."""
    import torch

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
    from srbd_horizon_tpu_torch.kernels import lip_rollout as k11

    f64, f32 = torch.float64, torch.float32
    use("this", "lip_rollout")
    use("this", "lip_linearize")
    use("this", "linear_trial")
    old = {"lip_rollout": other_wrapper(other_tree, "lip_rollout", other_libs),
           "lip_linearize": other_wrapper(other_tree, "lip_linearize",
                                          other_libs),
           "linear_trial": other_wrapper(other_tree, "linear_trial",
                                         other_libs)}
    k11s = {"this": k11, "other": old["lip_rollout"]}
    p = k13_point("lip", dev, SEED + 190)
    s = p["s"]
    terms, dt, ns = s.terms, p["ocp"].dt, p["ocp"].ns
    x0_nan = p["x0"].clone()
    x0_nan[K11_NAN] = float("nan")

    def args(Bw, dtype, nA, nan=False):
        a = modes_k13_args(p, Bw, dtype, nA)
        x0 = modes_sub(x0_nan, Bw).to(dtype) if nan else a[0]
        return (x0, *a[1:5], a[7], *a[8:14], terms, dt,
                *s._family_args(dtype), s.opts.defect_weight, s.opts.beta,
                s.opts.alpha_converge_threshold)

    r = dict(card=card, tol_f64=LIP_F64_TOL, e64={}, flags_equal={},
             nan_member_rejected={}, accepted={}, ms={}, chain_ms={},
             bound_ms={}, occupancy={}, smem_bytes={})
    failed = []
    for nA in (1, 4):
        for Bw in (8, B_MAIN):
            a = args(Bw, f64, nA, nan=True)
            ref = k11.lip_trial_plain(*a)
            for which, mod in k11s.items():
                got = mod.lip_trial(*a)
                torch.cuda.synchronize()
                key = f"{which}_B{Bw}_{nA}a"
                r["e64"][key] = {n: err1(g, w) for n, g, w in
                                 zip(TRIAL_OUT, got, ref)}
                r["flags_equal"][key] = bool(torch.equal(got[4], ref[4]))
                r["nan_member_rejected"][key] = not bool(
                    got[4][:, K11_NAN].any())
                r["accepted"][key] = int(got[4].sum())
                if which == "this" and not (
                        max(r["e64"][key].values()) <= LIP_F64_TOL
                        and r["flags_equal"][key]
                        and r["nan_member_rejected"][key]):
                    failed.append(f"K11 disagrees with its twin ({key})")
    for nA in (1, 4):
        for Bw in K11_VERSUS_B:
            a32 = args(Bw, f32, nA)
            reps = 50 if Bw < B_LARGE else 20
            key = f"B{Bw}_{nA}a"
            for which in ("other", "this", "this", "other"):
                r["ms"].setdefault(which, {}).setdefault(key, []).append(
                    cuda_ms(lambda: k11s[which].lip_trial(*a32), reps=reps))
            r["chain_ms"][key] = cuda_ms(lambda: k11.lip_trial_chain(*a32),
                                         reps=reps)
            out = k11.lip_trial(*a32)
            nb = nbytes(*[v for v in a32[:12] if isinstance(v, torch.Tensor)],
                        *a32[7].values(), *out)
            r["bound_ms"][key], _ = bound(nb, lip_trial_flops(
                Bw, ns, p["ocp"].nx, p["ocp"].nu, terms.n_rho, nA))
            del a32, out
    for dtype, name in ((f32, "float32"), (f64, "float64")):
        for nA in (1, 4):
            r["occupancy"][f"this_{name}_{nA}a"] = k11.trial_occupancy(
                dtype, ns, nA)
            r["smem_bytes"][f"{name}_{nA}a"] = k11.smem_bytes(dtype, ns, nA)
        r["occupancy"][f"other_{name}"] = k11s["other"].trial_occupancy(dtype)
    emit("k11_versus", **r)

    # the kernels that share csrc/lip_common.cuh: K10, K11 and K13's LIP
    # family bit for bit; lip_evaluate (its design free to differ) to its
    # twin; all timed
    rows = s.rows
    sh = dict(card=card, tol_f64=LIP_F64_TOL, bit_equal={}, evaluate={},
              ms={}, bound_ms={}, host_us={}, occupancy={})

    def ev_inputs(Bw, dtype, nan=False):
        X = modes_sub(p["X"], Bw).to(dtype)
        if nan:
            X[K11_NAN, 5, 4] = float("nan")
        return (X, modes_sub(p["U"], Bw).to(dtype),
                {k: modes_sub(v, Bw).to(dtype) for k, v in p["params"].items()},
                modes_sub(p["x0"], Bw).to(dtype))

    def shared_calls(Bw, dtype):
        X, U, prm, x0 = ev_inputs(Bw, dtype)
        w = s._wc(dtype)
        a13 = modes_k13_args(p, Bw, dtype, 4)
        a11 = args(Bw, dtype, 4)
        return {
            "lip_linearize": lambda m: tuple(m["lip_linearize"].lip_linearize(
                X, U, prm, terms, rows, dt, w).values()),
            "lip_evaluate": lambda m: m["lip_rollout"].lip_evaluate(
                X, U, prm, terms, dt, w),
            "lip_evaluate_pinned": lambda m: m["lip_rollout"].lip_evaluate(
                X, U, prm, terms, dt, w, x0=x0),
            "lip_trial": lambda m: m["lip_rollout"].lip_trial(*a11),
            "linear_trial_lip": lambda m: m["linear_trial"].linear_trial(
                *a13),
        }
    mods = {"this": {"lip_rollout": k11, "lip_linearize": k10,
                     "linear_trial": k13}, "other": old}
    for dtype, name in ((f64, "float64"), (f32, "float32")):
        for kname, fn in shared_calls(B_MAIN, dtype).items():
            if kname.startswith("lip_evaluate"):
                continue
            outs = {w: fn(m) for w, m in mods.items()}
            torch.cuda.synchronize()
            eq = all(bits_equal(a_, b_) for a_, b_ in
                     zip(outs["other"], outs["this"]))
            sh["bit_equal"][f"{kname}_{name}"] = eq
            if not eq:
                failed.append(f"{kname} ({name}) differs from the other "
                              "tree's")
    # lip_evaluate against its twin: float64 at B=8 with a NaN member,
    # float32 at B=512 against the float64 twin
    for pin in (False, True):
        kname = "lip_evaluate_pinned" if pin else "lip_evaluate"
        X, U, prm, x0 = ev_inputs(8, f64, nan=True)
        kw = dict(x0=x0) if pin else {}
        ref = k11.lip_evaluate_plain(X, U, prm, terms, dt, s._wc(f64), **kw)
        r = {}
        for which, m in mods.items():
            got = m["lip_rollout"].lip_evaluate(X, U, prm, terms, dt,
                                                s._wc(f64), **kw)
            torch.cuda.synchronize()
            r[f"{which}_f64_B8"] = {n: err1(g, w) for n, g, w in
                                    zip(("cost", "defect_max"), got, ref)}
            r[f"{which}_nan_member_nan"] = bool(
                torch.isnan(got[0][K11_NAN]) and torch.isnan(got[1][K11_NAN]))
            if pin:
                r[f"{which}_pinned_X_bit_equal"] = bits_equal(got[2], ref[2])
        X, U, prm, x0 = ev_inputs(B_MAIN, f64)
        kw = dict(x0=x0) if pin else {}
        ref = k11.lip_evaluate_plain(X, U, prm, terms, dt, s._wc(f64), **kw)
        kw32 = dict(x0=x0.float()) if pin else {}
        got = k11.lip_evaluate(X.float(), U.float(),
                               {k: v.float() for k, v in prm.items()}, terms,
                               dt, s._wc(f32), **kw32)
        torch.cuda.synchronize()
        r["this_f32_B512_vs_f64_twin"] = {
            n: err1(g, w) for n, g, w in zip(("cost", "defect_max"), got, ref)}
        sh["evaluate"][kname] = r
        if not (max(r["this_f64_B8"].values()) <= LIP_F64_TOL
                and r["this_nan_member_nan"]
                and r.get("this_pinned_X_bit_equal", True)):
            failed.append(f"{kname} disagrees with its twin")
    for Bw in K11_VERSUS_B:
        calls = shared_calls(Bw, f32)
        for kname, fn in calls.items():
            if Bw == B_LARGE and kname in ("lip_trial", "linear_trial_lip"):
                continue
            for w in ("other", "this", "this", "other"):
                sh["ms"].setdefault(kname, {}).setdefault(w, {}).setdefault(
                    str(Bw), []).append(cuda_ms(lambda: fn(mods[w]),
                                                reps=50 if Bw < B_LARGE else 20))
        X, U, prm, x0 = ev_inputs(Bw, f32)
        lin = calls["lip_linearize"](mods["this"])
        # the card's write rate on K10's output bytes: one fill of as many
        fill = torch.empty(sum(t.numel() for t in lin), dtype=f32, device=dev)
        sh.setdefault("fill_ms", {})[str(Bw)] = cuda_ms(
            lambda: fill.fill_(1.0), reps=50 if Bw < B_LARGE else 20)
        del fill
        sh["bound_ms"].setdefault("lip_linearize", {})[str(Bw)] = bound(
            nbytes(X, U, *prm.values(), rows.packed(dev), *lin),
            lip_linearize_flops(Bw, ns, p["ocp"].nx, terms.n_rho,
                                len(rows.gx)))[0]
        ev = calls["lip_evaluate_pinned"](mods["this"])
        sh["bound_ms"].setdefault("lip_evaluate_pinned", {})[str(Bw)] = bound(
            nbytes(X, U, *prm.values(), x0, *ev),
            lip_evaluate_flops(Bw, ns, p["ocp"].nx, terms.n_rho))[0]
        del calls, lin, ev
    one = shared_calls(1, f32)
    sh["host_us"] = host_us_turns({
        f"{w}_{kname}": (lambda f=one[kname], m=mods[w]: f(m))
        for kname in ("lip_linearize", "lip_evaluate", "lip_evaluate_pinned")
        for w in ("other", "this")})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype, name in ((f32, "float32"), (f64, "float64")):
        for vec in (True, False):
            sh["occupancy"][f"lip_linearize_{name}_{'vec' if vec else 'node'}"] = \
                k10.occupancy(dtype, vec)
        occ = k11.evaluate_occupancy(ns, dtype)
        occ["waves_at_B4096"] = -(-(-(-B_LARGE // k11.EVAL_MEMBERS))
                                  // max(1, occ["blocks_per_sm"] * sms))
        sh["occupancy"][f"lip_evaluate_{name}"] = occ
    # the launch shapes the wrappers state against the card's own choice
    import ctypes
    g_nodes = k10.library("lip_linearize").lip_linearize_group_nodes
    g_nodes.argtypes, g_nodes.restype = [ctypes.c_int, ctypes.c_longlong], ctypes.c_int
    members = k11.library("lip_rollout").lip_evaluate_members
    members.argtypes, members.restype = [ctypes.c_int], ctypes.c_int
    sh["schedule"] = {}
    for Bw in K11_VERSUS_B:
        r = dict(lip_linearize=k10.schedule(Bw, ns, f32, sms),
                 lip_linearize_f64=k10.schedule(Bw, ns, f64, sms),
                 lip_evaluate_members=k11.eval_members(Bw, sms))
        card_side = (g_nodes(0, Bw * ns), g_nodes(1, Bw * ns), members(Bw))
        r["card_agrees"] = card_side == (r["lip_linearize"][0],
                                         r["lip_linearize_f64"][0],
                                         r["lip_evaluate_members"])
        if not r["card_agrees"]:
            failed.append(f"the wrappers' launch shapes at B={Bw} are not "
                          f"the card's {card_side}")
        sh["schedule"][str(Bw)] = r
    emit("k11_shared_versus", **sh)
    torch.cuda.empty_cache()
    emit("lip_ticks_versus", **lip_ticks_versus(dev, card, mods))
    return failed


def lip_ticks_versus(dev, card, mods, rounds=2):
    """The dlip example's tick (B=1, 20 ticks of a walk) and the LIP fleet's
    (B=512, 3 warm and 10 timed ticks), each tree's K10, K11 and
    lip_evaluate in the solver's kernel table in turns (other, this, this,
    other; `rounds` times), K1 the same: tick p50 ms a turn."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
    from srbd_horizon_tpu_torch.runtime.loop import (
        TickInput,
        build_lip_loop,
        walk_command,
        walking_schedule,
    )
    from srbd_horizon_tpu_torch.solvers import msddp

    f32 = torch.float32
    saved = msddp._KERNELS["lip"]

    def use(which):
        m = mods[which]
        msddp._KERNELS["lip"] = (m["lip_linearize"].lip_linearize,
                                 m["lip_rollout"].lip_trial,
                                 m["lip_rollout"].lip_evaluate)

    dl, dprob = build_lip_loop(SRBDConfig(), DDPOptions(
        max_iters=100, alpha_converge_threshold=1e-12, beta=1e-3), device=dev)
    sched = walking_schedule(20, vx=0.3, start=5, device=dev)
    fl, fprob = build_lip_loop(SRBDConfig(), DDPOptions(max_iters=5),
                               shift_warmstart=True, device=dev)
    g = np.random.RandomState(SEED)
    x0 = torch.as_tensor(fprob.initial_state.cpu().numpy()[None]
                         + 0.005 * g.randn(B_MAIN, fprob.ocp.nx), dtype=f32,
                         device=dev)
    inp = walk_command(B_MAIN, vx=0.2, dtype=f32, device=dev)

    def dlip():
        carry, tms = dl.init(dprob.initial_state), []
        for i in range(sched.action.shape[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, _ = dl.tick(carry, TickInput(*(a[i] for a in sched)))
            torch.cuda.synchronize()
            tms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(tms)

    def fleet():
        carry, tms = fl.init(x0), []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, _ = fl.tick_batch(carry, inp)
            torch.cuda.synchronize()
            if i >= 3:
                tms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(tms)
    out = dict(card=card, dlip_tick_p50_ms={}, fleet_tick_p50_ms={},
               order="other, this, this, other, a round")
    try:
        for which in ("other", "this"):           # warm both trees' paths
            use(which)
            dlip(), fleet()
        for _ in range(rounds):
            for which in ("other", "this", "this", "other"):
                use(which)
                out["dlip_tick_p50_ms"].setdefault(which, []).append(dlip())
                out["fleet_tick_p50_ms"].setdefault(which, []).append(fleet())
    finally:
        msddp._KERNELS["lip"] = saved
    return out


K7_MODES = ("eval", "online", "offline")
K7_VERSUS_B = (1, B_CONSTRAINED, B_LARGE)


def occupancy_estimate(registers, smem_bytes, threads=256):
    """Blocks resident on one H100 SM for a kernel of `registers` a thread
    (allocated 8 at a time), `smem_bytes` of shared memory a block (1 KB a
    block reserved, 233,472 B an SM) and `threads` a block."""
    regs = -(-max(registers, 1) // 8) * 8 * threads
    return min(32, 2048 // threads, 65536 // regs,
               233_472 // (smem_bytes + 1024))


def k7_parent_smem(dtype, ns=20, nx=37, nu=30, nc=4):
    """Shared memory a block of the first K7 design (`al_constraints_smem`
    of its .cu): a record a node of x, u and the parameter slots up to the
    LIP-zone mask, the stage nodes' Iw and Iw ω, the warps' maxima."""
    import torch

    rec = nx + nu + (8 + nc + 2) + 1
    return torch.finfo(dtype).bits // 8 * ((ns + 1) * rec + ns * 12 + 8)


def k7_host_split(k78, a, kw):
    """Host µs of this tree's K7 wrapper by part: the checks and the setup
    lookup (`_constraints_checked`), the one output buffer and its views
    (`output_views`), the pointer arrays and the launch
    (`_constraints_launch`), and the whole call."""
    al, X, U, params = a
    st, off = kw.get("st"), kw.get("offline", False)
    s, mode, ins, strides = k78._constraints_checked(al, X, U, params, st, off)
    buf, _ = k78.output_views(s.layout, s.total, X.dtype, X.device)
    base, Bsz, ns = buf.data_ptr(), X.shape[0], X.shape[1] - 1
    return dict(
        checks=host_us(lambda: k78._constraints_checked(al, X, U, params, st,
                                                        off)),
        outputs=host_us(lambda: k78.output_views(s.layout, s.total, X.dtype,
                                                 X.device)),
        launch=host_us(lambda: k78._constraints_launch(
            s, mode, ins, strides, base, Bsz, ns, X.device)),
        call=host_us(lambda: k78.isrbd_al_constraints(*a, **kw)))


def k7_versus_part(other_tree, dev, card, use, other_libs):
    """K7 of both trees (the other through its own wrapper) at its two AL
    shapes (`k7_point`), all three modes: each tree's outputs held to
    `isrbd_al_constraints_plain` by `al_check` (float64 within AL_F64_TOL
    of max(1, |twin|), float32 by K3's rule, NaN where the twin's, member
    K7_NAN's NaNs) with the static bounds and the drawn overrides, offline
    on a first and a later outer; both trees' outputs compared bit for bit
    in float32 and float64; float32 times at B = 1, 256 and 4096 in turns
    (other, this, this, other), with the bound of each case; both trees'
    blocks an SM (this tree's from the card, the other's estimated from its
    ptxas registers and shared memory); both wrappers' host µs, this one's
    by part. One `k7_versus` line a shape. Then K8a-c, which share
    csrc/isrbd_al.cu: both trees' outputs bit for bit (each also to its
    twin) in both types, float32 times at B = 1, 256 and 4096 in turns;
    one `k7_shared_versus` line a shape. Returns what failed."""
    import torch

    from srbd_horizon_tpu_torch.kernels import build
    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78

    f64, f32 = torch.float64, torch.float32
    use("this", "isrbd_al")
    old = other_wrapper(other_tree, "isrbd_al", other_libs)
    mods = {"this": k78, "other": old}
    other_regs = ptxas_entries(
        (build.BUILD_DIR / "versus" / "isrbd_al.log").read_text(),
        "isrbd_al_constraints_kernel")
    failed = []
    for si, shape in enumerate(K7_SHAPES):
        p = k7_point(shape, dev, SEED + 200 + si)
        ns = p["X"].shape[1] - 1
        r = dict(shape=shape, card=card, bit_equal={}, twin={}, ms={},
                 bound_ms={}, occupancy={}, host_us={})
        for mode in K7_MODES:
            for bounds in ("static", "boxes"):
                for later in ((False, True) if mode == "offline" else (False,)):
                    key = f"{mode}_{bounds}" + ("_later" if later else "")
                    for dtype in (f64, f32):
                        a, kw = k7_args(p, dtype, mode, bounds, later=later)
                        outs = {w: outputs(m.isrbd_al_constraints(*a, **kw))
                                for w, m in mods.items()}
                        torch.cuda.synchronize()
                        eq = all(bits_equal(x, y) for (_, x), (_, y) in
                                 zip(outs["other"], outs["this"]))
                        r["bit_equal"][f"{key}_{str(dtype)[6:]}"] = eq
                        if not eq:
                            failed.append(f"K7 {shape} {key} ({dtype}) differs "
                                          "from the other tree's")
                    for w, m in mods.items():
                        r["twin"][f"{w}_{key}"] = al_check(
                            "k7_versus_check", m.isrbd_al_constraints,
                            k78.isrbd_al_constraints_plain,
                            lambda d: k7_args(p, d, mode, bounds, later=later),
                            exact=False, nan_member=K7_NAN, tree=w,
                            shape=shape, mode=mode, bounds=bounds,
                            later=later)
        for mode in K7_MODES:
            name = "isrbd_al_constraints" + ("" if mode == "online"
                                             else f"_{mode}")
            for Bw in K7_VERSUS_B:
                a, kw = k7_args(p, f32, mode, Bw=Bw, nan=False)
                reps = 50 if Bw < B_LARGE else 20
                key = f"{mode}_B{Bw}"
                for w in ("other", "this", "this", "other"):
                    r["ms"].setdefault(w, {}).setdefault(key, []).append(
                        cuda_ms(lambda: mods[w].isrbd_al_constraints(*a, **kw),
                                reps=reps))
                res = k78.isrbd_al_constraints(*a, **kw)
                r["bound_ms"][key], _ = bound(*al_call_work(a[0], name, a, kw,
                                                            res))
                del a, kw, res
            a, kw = k7_args(p, f32, mode, Bw=B_CONSTRAINED, nan=False)
            r["host_us"][mode] = dict(
                other=host_us(lambda: old.isrbd_al_constraints(*a, **kw)),
                this=host_us(lambda: k78.isrbd_al_constraints(*a, **kw)),
                this_by_part=k7_host_split(k78, a, kw))
            m = K7_MODES.index(mode)
            for dtype in (f32, f64):
                dn = str(dtype)[6:]
                r["occupancy"][f"this_{mode}_{dn}"] = k78.constraints_occupancy(
                    m, dtype, ns, shape)
        # the other tree's blocks an SM from its ptxas registers (its
        # shared memory does not depend on the mode)
        r["occupancy"]["other"] = {
            name: dict(registers=v["registers"],
                       blocks_per_sm_f32=occupancy_estimate(
                           v["registers"], k7_parent_smem(f32, ns)),
                       blocks_per_sm_f64=occupancy_estimate(
                           v["registers"], k7_parent_smem(f64, ns)))
            for name, v in other_regs.items()}
        emit("k7_versus", **r)
        failed += k8_versus(p, mods, card, shape)
        del p
        torch.cuda.empty_cache()
    return failed


def k8_versus(p, mods, card, shape):
    """K8a-c of both trees at K7's point `p`: outputs bit for bit between
    the trees and to their twins in float64 and float32 (K8a with each
    prior, K8b with the static bounds and the overrides, K8c with the tail
    and the full prior), float32 times at B = 1, 256 and 4096 in turns
    (other, this, this, other) of K8a with each prior, K8b with both
    bound cases and K8c with the full prior, each beside its bound; both
    trees' wrapper host µs a call of each (B = 256, in turns,
    `host_us_turns`); this tree's occupancy of K8a (each prior) and K8b,
    in both types. One
    `k7_shared_versus` line; returns what failed."""
    import numpy as np
    import torch

    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78

    dev = p["X"].device
    al64 = p["al"][torch.float64]
    Bsz, ns = p["X"].shape[0], p["X"].shape[1] - 1
    n_eq, n_eq_T, _ = al64._sizes
    g = np.random.RandomState(SEED + 210)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    P_al = 20
    phase = torch.as_tensor(g.randint(0, P_al, Bsz), dtype=torch.int32,
                            device=dev)
    phase[:3] = torch.tensor([0, 1, P_al - 1], dtype=torch.int32)
    full = al64.init_full_phase_prior(P_al, Bsz)._replace(
        lam_eq=t64(g.randn(Bsz, P_al, ns, n_eq)),
        lam_eq_T=t64(g.randn(Bsz, P_al, n_eq_T)),
        seen=torch.as_tensor(g.rand(Bsz, P_al) < 0.5, device=dev))
    tail = al64.init_phase_prior(P_al, Bsz)._replace(
        lam_tail=t64(g.randn(Bsz, P_al, n_eq)),
        lam_T=t64(g.randn(Bsz, P_al, n_eq_T)),
        seen_tail=torch.as_tensor(g.rand(Bsz, P_al) < 0.5, device=dev),
        seen_T=torch.as_tensor(g.rand(Bsz, P_al) < 0.5, device=dev))
    full.lam_eq[K7_NAN, :, 1, 1] = float("nan")
    tail.lam_tail[K7_NAN, :, 3] = float("nan")

    def calls(dtype, Bw=None):
        tree = (p["st"], full, tail, p["static"], p["boxes"], phase)
        if Bw is not None:
            tree = resize_members(tree, Bsz, Bw)
        st, fu, ta, static, boxes, ph = (cast_tree(t, dtype) for t in tree)
        al = p["al"][dtype]
        pr = {"none": None, "tail": ta, "full": fu}
        out = {}
        for k, v in pr.items():
            out[f"k8a_{k}"] = ("isrbd_al_shift",
                               (al, st, v, None if v is None else ph))
        for k, v in (("static", static), ("boxes", boxes)):
            out[f"k8b_{k}"] = ("isrbd_al_params", (al, v, st))
        for k in ("tail", "full"):
            out[f"k8c_{k}"] = ("isrbd_al_prior_update",
                               (al, pr[k], st, ph, 0.5))
        return out
    r = dict(shape=shape, card=card, bit_equal={}, twin_bit_equal={}, ms={},
             bound_ms={}, host_us={}, occupancy={})
    failed = []
    for dtype in (torch.float64, torch.float32):
        for key, (entry, a) in calls(dtype).items():
            outs = {w: outputs(getattr(m, entry)(*a)) for w, m in mods.items()}
            ref = outputs(getattr(k78, entry + "_plain")(*a))
            torch.cuda.synchronize()
            k = f"{key}_{str(dtype)[6:]}"
            r["bit_equal"][k] = all(bits_equal(x, y) for (_, x), (_, y) in
                                    zip(outs["other"], outs["this"]))
            r["twin_bit_equal"][k] = all(bits_equal(x, y) for (_, x), (_, y)
                                         in zip(outs["this"], ref))
            if not (r["bit_equal"][k] and r["twin_bit_equal"][k]):
                failed.append(f"{entry} ({shape}, {k}) differs from the other "
                              "tree's or its twin")
    timed = ("k8a_none", "k8a_tail", "k8a_full", "k8b_static", "k8b_boxes",
             "k8c_full")
    for Bw in K7_VERSUS_B:
        for key, (entry, a) in calls(torch.float32, Bw).items():
            if key not in timed:
                continue
            for w in ("other", "this", "this", "other"):
                fn = getattr(mods[w], entry)
                r["ms"].setdefault(key, {}).setdefault(w, {}).setdefault(
                    str(Bw), []).append(cuda_ms(lambda: fn(*a), reps=20))
            res = getattr(k78, entry)(*a)
            r["bound_ms"].setdefault(key, {})[str(Bw)], _ = bound(
                *al_call_work(a[0], entry, a, {}, res))
            if Bw == B_CONSTRAINED:
                r["host_us"][key] = host_us_turns(
                    {w: (lambda m=mods[w]: getattr(m, entry)(*a))
                     for w in ("other", "this")})
            del res
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype)[6:]
        for kind, name in enumerate(k78.PRIORS):
            r["occupancy"][f"k8a_{name}_{dn}"] = k78.shift_occupancy(
                kind, dtype, shape)
        r["occupancy"][f"k8b_{dn}"] = k78.params_occupancy(dtype, shape)
    emit("k7_shared_versus", **r)
    return failed


def bits_equal(a, b):
    """Whether two tensors hold the same bits (a NaN equal to itself)."""
    import torch

    if a.dtype.is_floating_point and a.dtype == b.dtype:
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        return torch.equal(a.contiguous().view(ints[a.dtype]),
                           b.contiguous().view(ints[b.dtype]))
    return torch.equal(a, b)


def evaluate_versus(p, fam, card, rollouts):
    """At K13's family `fam` (its drawn point `p`): the evaluate kernel and
    the trial of the problem's family from both trees (`rollouts`: each
    tree's wrapper modules by terms.family), outputs compared bit for bit
    at B = 512 (evaluate with and without x0; the trial with four α) —
    but the LIP's, K11 and lip_evaluate, redesigned since the parent,
    whose float64 outputs are held to their twins (LIP_F64_TOL of max(1,
    |twin|); the flags equal, the pinned plan bit for bit) —,
    float32 times at B = 1 and 512 in turns (other, this, this, other),
    the trial's also with one α (this tree); one `evaluate_versus` line
    each."""
    import functools

    import torch

    s = p["s"]
    terms, dt = s.terms, p["ocp"].dt
    fam_name = terms.family
    prefix = {"srbd": "srbd", "isrbd_al": "isrbd", "lip": "lip"}[fam_name]
    for kind in ("evaluate", "trial"):
        r = dict(kernel=f"{prefix}_{kind}", family=fam, card=card,
                 bit_equal=True, ms={})

        def call(which, Bw, dtype, with_x0=True, nA=4):
            fn = getattr(rollouts[which][fam_name], f"{prefix}_{kind}")
            fa = s._family_args(dtype)
            if kind == "evaluate":
                X, U = modes_sub(p["X"], Bw).to(dtype), \
                    modes_sub(p["U"], Bw).to(dtype)
                prm = {k: modes_sub(v, Bw).to(dtype)
                       for k, v in p["params"].items()}
                x0 = modes_sub(p["x0"], Bw).to(dtype) if with_x0 else None
                return functools.partial(fn, X, U, prm, terms, dt, *fa, x0=x0)
            a = modes_k13_args(p, Bw, dtype, nA)
            return functools.partial(fn, *a[:5], a[7], *a[8:14], terms, dt,
                                     *fa, s.opts.defect_weight, s.opts.beta,
                                     s.opts.alpha_converge_threshold)
        to_twin = fam_name == "lip"
        if to_twin:
            del r["bit_equal"]
            r.update(twin_err_f64={}, flags_equal={}, tol_f64=LIP_F64_TOL)
            r["within_twin_tol"] = True
        for variant in ((True, False) if kind == "evaluate" else (True,)):
            calls = {w: call(w, B_MAIN, torch.float64, variant)
                     for w in ("other", "this")}
            outs = {w: f() for w, f in calls.items()}
            torch.cuda.synchronize()
            if to_twin:
                c = calls["this"]
                plain = getattr(rollouts["this"]["lip"], f"lip_{kind}_plain")
                ref = plain(*c.args, **c.keywords)
                for w, got in outs.items():
                    key = f"{w}_x0" if kind == "evaluate" and variant else w
                    n = 4 if kind == "trial" else 2
                    r["twin_err_f64"][key] = max(err1(g_, w_) for g_, w_ in
                                                 zip(got[:n], ref[:n]))
                    # the flags of a trial, the pinned plan of an evaluation
                    r["flags_equal"][key] = (
                        bool(torch.equal(got[4], ref[4])) if kind == "trial"
                        else len(got) < 3 or bits_equal(got[2], ref[2]))
                r["within_twin_tol"] &= all(
                    r["twin_err_f64"][k] <= LIP_F64_TOL and r["flags_equal"][k]
                    for k in r["twin_err_f64"] if k.startswith("this"))
                continue
            r["bit_equal"] &= all(bits_equal(a_, b_) for a_, b_ in
                                  zip(outs["other"], outs["this"]))
        for Bw in (1, B_MAIN):
            fns = {w: call(w, Bw, torch.float32) for w in ("other", "this")}
            for w in ("other", "this", "this", "other"):
                r["ms"].setdefault(w, {}).setdefault(str(Bw), []).append(
                    cuda_ms(fns[w], reps=20))
            if kind == "trial":                    # and with one α
                fn1 = call("this", Bw, torch.float32, nA=1)
                r.setdefault("this_1alpha_ms", {})[str(Bw)] = cuda_ms(fn1,
                                                                     reps=20)
        emit("evaluate_versus", **r)


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
    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78
    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
    from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
    from srbd_horizon_tpu_torch.kernels import linearize as k4
    from srbd_horizon_tpu_torch.kernels import riccati as k1
    from srbd_horizon_tpu_torch.kernels import rollout as k3
    from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
    from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    from srbd_horizon_tpu_torch.runtime.chunked import chunk_map
    from srbd_horizon_tpu_torch.runtime.loop import (
        MPCLoop,
        TickInput,
        build_srbd_loop,
        walk_command,
        walking_schedule,
    )
    from srbd_horizon_tpu_torch.runtime.serving import constrained_tick
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP, ALOptions
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP
    from srbd_horizon_tpu_torch.solvers.options import (
        al_serving_options,
        ddp_example_options,
    )
    from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator

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
    if "--k12-versus" in sys.argv:
        # a development run: K12 and K13 of this tree against another's,
        # and no result line
        parts = VERSUS_PARTS
        if "--parts" in sys.argv:
            parts = tuple(sys.argv[sys.argv.index("--parts") + 1].split(","))
        k12_versus(sys.argv[sys.argv.index("--k12-versus") + 1], card, parts)
        return

    t0 = time.perf_counter()
    build.build_all(force=True)
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         libraries=[str(build.library_path(n).relative_to(HERE))
                    for n in build.KERNEL_SOURCES],
         seconds_by_library={n: round(v, 1)
                             for n, v in build.build_seconds.items()})
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
    order = ORDER

    def cast(t, dtype):
        return t.to(dtype).contiguous()

    def k4_args(dtype):
        s = solver64 if dtype == torch.float64 else solver32
        return (cast(X, dtype), cast(U, dtype),
                {k: cast(v, dtype) for k, v in params.items()}, s.terms,
                s.rows, dt, s._wc(dtype))

    # K4: the linearization
    lin64, lin_g32, k4_err = linearize_check(
        "k4_check", k4.srbd_linearize_plain, k4.srbd_linearize, k4_args)

    # K1: the Riccati sweep, on the float64 plain linearization
    def k1_args(lin):
        return tuple(lin[k] for k in order) + (mu, rows)

    ref64, got32, lin32, k1_err = riccati_check("k1_check", k1, lin64, mu, rows)

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

    k3_err = trial_check("k3_check", k3.srbd_trial_plain, k3.srbd_trial,
                         k3_args, alphas4, merit0_64, D64, dV1_64, dV2_64,
                         opts, nan_member=7)

    # srbd_evaluate: the cost and the largest defect of the drawn plans;
    # member 7's plan holds a NaN, so both of its outputs are NaN
    X_nan = X.clone()
    X_nan[7, 5, 4] = float("nan")

    def ev_args(Xe):
        def args(dtype):
            s = solver64 if dtype == torch.float64 else solver32
            return (cast(Xe, dtype), cast(U, dtype),
                    {k: cast(v, dtype) for k, v in params.items()}, s.terms,
                    dt, s._wc(dtype))
        return args

    ev_err = evaluate_check("srbd_evaluate_check", k3.srbd_evaluate_plain,
                            k3.srbd_evaluate, ev_args(X_nan), nan_member=7,
                            x0=x0)

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
                            len(rows.gu), len(rows.bx), len(rows.uc))
    k1_bound, k1_by = bound(k1_bytes, k1_flop, H100_FP64_TC_FLOP_PER_S)

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
    # K3 alone at fleet sizes around the card's waves: B=1 is the chain's
    # own latency, K3's floor
    emit("k3_size_probe", card=card, alphas=1,
         ms_by_B=trial_size_probe(k3.srbd_trial, r32, (1, 132, 512, 528, 4096)),
         ms_B512_4alpha=k3_fan_ms)

    e32 = ev_args(X)(torch.float32)
    ev_ms = cuda_ms(lambda: k3.srbd_evaluate(*e32), reps=50)
    ev_plain_ms = cuda_ms(lambda: k3.srbd_evaluate_plain(*e32), reps=5,
                          warmup=1)
    ev_bytes = nbytes(e32[0], e32[1], *k4.kernel_params(
        e32[2], B, ns, nc, torch.float32, dev), *k3.srbd_evaluate(*e32))
    ev_flop = evaluate_flops(B, ns, nx, nc, n_rho)
    ev_bound, ev_by = bound(ev_bytes, ev_flop)
    # pinned as the solve's cost0 call runs it: x0 read, the plan written
    ex0 = cast(x0, torch.float32)
    ev_pin_ms = cuda_ms(lambda: k3.srbd_evaluate(*e32, x0=ex0), reps=50)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ev_occ = evaluate_occupancy(k3, ns, B, sms)
    emit("evaluate_occupancy", entry="srbd_evaluate", card=card, ns=ns,
         serving_B=B, sms=sms, **ev_occ)
    emit("evaluate_size_probe", entry="srbd_evaluate", card=card,
         dtype="float32", pinned=True,
         ms_by_B=evaluate_size_probe(k3.srbd_evaluate, e32, ex0,
                                     (1, 132, B, B_LARGE)))
    emit("evaluate_host_us", entry="srbd_evaluate", card=card, B=B,
         **evaluate_host_us(k3.srbd_evaluate, e32, ex0,
                            build.clear_host_setups))

    # K2 alone, through its own entry, on the (B·ns, nu, nu) Quu-like
    # stack 2JupᵀJup + μI in float64 and float32, beside torch.linalg.inv
    k2 = k2_check("k2_check", k1, lin64["Jup"], mu, sizes="srbd", card=card)
    nt_s = lin32["Jt"].shape[1]
    k1_smem = k1.shared_memory_bytes(nx, nu, nt_s, rows)
    k1_blocks = k1.blocks_per_sm(nx, nu, nt_s, rows)
    emit("kernel_times", card=card,
         srbd_linearize_ms=k4_ms, srbd_linearize_plain_ms=k4_plain_ms,
         srbd_linearize_bound_ms=k4_bound, srbd_linearize_bytes=k4_bytes,
         srbd_linearize_flop=k4_flop,
         riccati_backward_ms=k1_ms, riccati_backward_plain_ms=k1_plain_ms,
         riccati_bound_ms=k1_bound, riccati_bytes=k1_bytes,
         riccati_flop=k1_flop, riccati_rate="FP64 tensor cores, 67 TFLOP/s",
         riccati_shared_memory_bytes=k1_smem, riccati_blocks_per_sm=k1_blocks,
         srbd_trial_ms=k3_ms, srbd_trial_plain_ms=k3_plain_ms,
         srbd_trial_bound_ms=k3_bound, srbd_trial_bytes=k3_bytes,
         srbd_trial_flop=k3_flop, srbd_trial_4alpha_ms=k3_fan_ms,
         srbd_linearize_gb_per_s=k4_bytes / k4_ms * 1e-6,
         srbd_linearize_bound_share=k4_bound / k4_ms,
         srbd_evaluate_ms=ev_ms, srbd_evaluate_plain_ms=ev_plain_ms,
         srbd_evaluate_bound_ms=ev_bound, srbd_evaluate_bytes=ev_bytes,
         srbd_evaluate_flop=ev_flop, srbd_evaluate_pinned_ms=ev_pin_ms)
    # SRBD sizes: four blocks an SM, 528 members a wave on 132 SMs
    emit("k1_wave_probe", sizes="srbd", card=card,
         shared_memory_bytes=k1_smem, blocks_per_sm=k1_blocks,
         sms=torch.cuda.get_device_properties(0).multi_processor_count,
         ms_by_B=k1_wave_probe(k1, lin32, order, mu, rows,
                               (1, 132, 264, 396, 512, 528, 529, 1056, 1057)))
    # K1's Tassa form (MSDDP.solve's sweep) at the SRBD sizes: both gain
    # solves against the twin on the same point, member 7 NaN; its times
    # at B=1 (the single robot's launch) and B=512 beside the collapsed K1
    tassa_err = {("srbd", sv): tassa_check(
        "k1_tassa_check", k1, lin64, mu, rows, sv, nan_member=7,
        sizes="srbd", B=B) for sv in ("schur", "cholesky")}
    tassa_t = {"srbd": tassa_times(k1, lin32, mu, rows, ("schur", "cholesky"))}
    emit("k1_tassa_times", sizes="srbd", card=card, **tassa_t["srbd"])
    del lin64, lin32, lin_g32, ref64, got32

    # ---------------- phase 3: the main path ----------------
    def run_main(Bsz, warm, timed):
        loop, prob = build_srbd_loop(SRBDConfig(), DDPOptions(max_iters=5),
                                     shift_warmstart=True, device=dev)
        trials = {"n": 0, "solves": 0}
        trial, solve = loop.solver._trial, loop.solver.solve_batch

        def counted_trial(*a):
            trials["n"] += 1
            return trial(*a)

        def counted_solve(*a):
            trials["solves"] += 1
            return solve(*a)

        loop.solver._trial, loop.solver.solve_batch = counted_trial, counted_solve
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
        loop.solver._trial, loop.solver.solve_batch = trial, solve
        runs.append((loop, carry, inp))
        return dict(
            B=Bsz, dtype="float32", warmup_ticks=warm, ticks=timed,
            tick_p50_ms=statistics.median(times), tick_max_ms=max(times),
            tick_mean_ms=statistics.fmean(times),
            members_per_s=Bsz / statistics.median(times) * 1e3,
            iters_mean=statistics.fmean(iters),
            syncs_per_tick=(loop.solver.host_syncs - syncs0) / timed,
            trials=trials["n"], solves=trials["solves"], finite=finite,
            defect_norm_max=max(float(o.defect_norm.max()) for o in outs),
            srbd_residual_max=max(float(o.srbd_residual.abs().max())
                                  for o in outs),
            card=card,
        )

    runs = []
    func_calls, restore_func = count_torch_func()
    plain_calls, restore_plain = count_plain_cost()
    k1.riccati_backward.launches = 0
    k3.srbd_trial.launches = 0
    k3.srbd_evaluate.launches = 0
    k4.srbd_linearize.launches = 0
    main = run_main(B_MAIN, warm=3, timed=20)
    launches = {"riccati_backward": k1.riccati_backward.launches,
                "srbd_trial": k3.srbd_trial.launches,
                "srbd_linearize": k4.srbd_linearize.launches,
                "srbd_evaluate": k3.srbd_evaluate.launches}
    restore_func()
    restore_plain()
    main["launches"] = launches
    main["torch_func_calls"] = func_calls["n"]
    main["plain_cost_or_defect_calls"] = plain_calls["n"]
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
    if launches["srbd_evaluate"] != 2 * main["solves"]:
        fail(f"srbd_evaluate launches {launches['srbd_evaluate']} are not two "
             f"for each of the {main['solves']} solves")
    if plain_calls["n"]:
        fail(f"the main path called the plain total_cost or _true_defects "
             f"{plain_calls['n']} times")

    loop, carry, inp = runs[0]
    srbd_step = lambda c: loop.tick_batch(c, inp)[0]
    carry, spans = tick_spans(loop.solver, srbd_step, carry, ticks=5)
    emit("tick_spans", B=B_MAIN, card=card, **spans)
    srbd_profile = profile_ticks(loop.solver, srbd_step, carry,
                                 main["tick_p50_ms"])
    emit("tick_profile", B=B_MAIN, card=card, **srbd_profile)
    # srbd_evaluate against its twin on the plans the solver hands it in one
    # more tick (its first call, the starting cost); member 7's plan gets a
    # NaN
    live_ev = []
    restore_ev = recorded(loop.solver, "_evaluate", live_ev)
    carry = srbd_step(carry)
    restore_ev()
    torch.cuda.synchronize()
    lvX, lvU, lvp, lvkw = live_ev[0]
    if "x0" not in lvkw or "x0" in live_ev[-1][3]:
        fail("the solve's first evaluation does not pin node 0, or its "
             "last one does")
    lvX = lvX.clone()
    lvX[7, 3, 4] = float("nan")

    def ev_live_args(dtype):
        s = solver64 if dtype == torch.float64 else solver32
        return (cast(lvX, dtype), cast(lvU, dtype),
                {k: cast(v, dtype) for k, v in lvp.items()}, s.terms, dt,
                s._wc(dtype))

    evaluate_check("srbd_evaluate_live_check", k3.srbd_evaluate_plain,
                   k3.srbd_evaluate, ev_live_args, nan_member=7,
                   x0=lvkw["x0"], calls_in_tick=len(live_ev))
    del live_ev, lvX, lvU, lvp

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

    # ---------------- phase 5: the constrained path's kernels ----------------
    feet = kangaroo_line_feet()

    def constrained_solvers(dtype, device, max_iters):
        prob = build_isrbd_problem(SRBDConfig(dtype=dtype), feet,
                                   cz_rho_weight=CZ_RHO_WEIGHT, device=device)
        return prob, ALDDP(prob.ocp, *al_serving_options(max_iters))

    iprob64, al64 = constrained_solvers(torch.float64, dev, 1)
    _, al32 = constrained_solvers(torch.float32, dev, 1)
    iocp = iprob64.ocp
    inx, inu = iocp.nx, iocp.nu
    irows = al64.inner.rows
    Bc = B_CONSTRAINED
    n_eq, n_eq_T, n_in = al64._sizes
    g = np.random.RandomState(SEED + 2)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    # a linearization point around the walk (draw_isrbd_point)
    Xi, Ui, ist, iparams, pin64 = draw_isrbd_point(
        al64, Bc, g, dev, com_z=0.88, fz=98.0, fxy=60.0, u_box=(60.0, 130.0))

    def k5_args(dtype):
        a = al64 if dtype == torch.float64 else al32
        return (cast(Xi, dtype), cast(Ui, dtype),
                {k: cast(v, dtype) for k, v in pin64.items()}, a.terms,
                a.inner.rows, iocp.dt)

    ilin64, ilin_g32, k5_err = linearize_check(
        "k5_check", k5.isrbd_linearize_plain, k5.isrbd_linearize, k5_args,
        B=Bc)
    active = {name: float((ilin64["rho"][..., a:b] > 0).double().mean())
              for name, a, b in (("cones", 66, 86), ("x_box", 106, 180),
                                 ("u_box", 180, 240))}
    emit("k5_active_row_share", **active)
    if not all(0.02 < v < 0.98 for v in active.values()):
        fail(f"the K5 check point has no mix of active and idle rows: {active}")

    # K1 at the isrbd sizes (18 of 30 live B columns)
    def k1i_args(lin):
        return tuple(lin[k] for k in order) + (mu, irows)

    nt_i = ilin64["Jt"].shape[1]
    k1i_smem = k1.shared_memory_bytes(inx, inu, nt_i, irows)
    k1i_blocks = k1.blocks_per_sm(inx, inu, nt_i, irows)
    iref64, igot32, ilin32, k1i_err = riccati_check(
        "k1_isrbd_check", k1, ilin64, mu, irows, B=Bc,
        live_b_columns=len(irows.uc), nu=inu, shared_memory_bytes=k1i_smem,
        blocks_per_sm=k1i_blocks,
        shared_memory_bytes_f64=k1.shared_memory_bytes(
            inx, inu, nt_i, irows, torch.float64),
        shared_memory_bytes_srbd=k1_smem)
    k2i = k2_check("k2_check_isrbd", k1, ilin64["Jup"], mu, sizes="isrbd",
                   card=card)
    # K1's Tassa form with the Cholesky gain solve at the isrbd-AL sizes
    # (ALDDP.solve's inner sweep), member 7 NaN; times at B=1 and B=256
    tassa_err["isrbd_al", "cholesky"] = tassa_check(
        "k1_tassa_check", k1, ilin64, mu, irows, "cholesky", nan_member=7,
        sizes="isrbd", B=Bc)
    tassa_t["isrbd_al"] = tassa_times(k1, ilin32, mu, irows, ("cholesky",))
    emit("k1_tassa_times", sizes="isrbd", card=card, **tassa_t["isrbd_al"])

    # K6: the isrbd trial; member 7 starts from a NaN state
    iopts = al64.inner.opts
    ix0 = Xi[:, 0] + t64(0.005 * g.randn(Bc, inx))
    ix0[7] = float("nan")
    iks, iKs, idV1, idV2 = iref64
    iD = torch.sum(ilin64["d"] ** 2, dim=(1, 2))
    imerit0 = al64.inner.total_cost(Xi, Ui, pin64) + iopts.defect_weight * iD

    def k6_args(dtype, alphas):
        a = al64 if dtype == torch.float64 else al32
        c = lambda t: cast(t, dtype)
        return (c(ix0), c(Xi), c(Ui), c(iks), c(iKs), c(ilin64["d"]),
                c(alphas), {k: c(v) for k, v in pin64.items()}, c(imerit0),
                c(iD), c(idV1), c(idV2), a.terms, iocp.dt,
                iopts.defect_weight, iopts.beta, iopts.alpha_converge_threshold)

    k6_err = trial_check("k6_check", k6.isrbd_trial_plain, k6.isrbd_trial,
                         k6_args, alphas4, imerit0, iD, idV1, idV2, iopts,
                         nan_member=7, B=Bc)

    # isrbd_evaluate on the drawn plans; member 7's r̈ₓ at node 3 is NaN
    # (the RK2 step reads it), so its cost and largest defect are NaN
    Ui_nan = Ui.clone()
    Ui_nan[7, 3, 0] = float("nan")

    def iev_args(Ue):
        def args(dtype):
            a = al64 if dtype == torch.float64 else al32
            return (cast(Xi, dtype), cast(Ue, dtype),
                    {k: cast(v, dtype) for k, v in pin64.items()}, a.terms,
                    iocp.dt)
        return args

    iev_err = evaluate_check("isrbd_evaluate_check", k6.isrbd_evaluate_plain,
                             k6.isrbd_evaluate, iev_args(Ui_nan), nan_member=7,
                             x0=ix0)

    # K7 and K8, the AL layer, on the drawn point: the plan with member 7's
    # r̈ₓ at node 3 NaN (its Newton and LIP x rows, their multipliers and
    # its violation come out NaN) and one of its stage multipliers NaN;
    # static bounds and the drawn box overrides; a first outer (viol_prev
    # inf) and a later one (viol_prev drawn on either side of the
    # contraction test); phase tables of P=20 with a NaN in member 7's
    # rows and phases that wrap the tail's phase − 1
    AL = lambda dtype: al64 if dtype == torch.float64 else al32
    ast = ist._replace(sol=ist.sol._replace(X=Xi, U=Ui_nan),
                       lam_eq=ist.lam_eq.clone())
    ast.lam_eq[7, 2, 4] = float("nan")
    al_viol_later = t64(10.0 ** g.uniform(-3, 3, Bc))
    P_al = 20
    al_phase = torch.as_tensor(g.randint(0, P_al, Bc), dtype=torch.int32,
                               device=dev)
    al_phase[:3] = torch.tensor([0, 1, P_al - 1], dtype=torch.int32)
    full_prior = al64.init_full_phase_prior(P_al, Bc)._replace(
        lam_eq=t64(g.randn(Bc, P_al, ns, n_eq)),
        lam_eq_T=t64(g.randn(Bc, P_al, n_eq_T)),
        seen=torch.as_tensor(g.rand(Bc, P_al) < 0.5, device=dev))
    tail_prior = al64.init_phase_prior(P_al, Bc)._replace(
        lam_tail=t64(g.randn(Bc, P_al, n_eq)), lam_T=t64(g.randn(Bc, P_al, n_eq_T)),
        seen_tail=torch.as_tensor(g.rand(Bc, P_al) < 0.5, device=dev),
        seen_T=torch.as_tensor(g.rand(Bc, P_al) < 0.5, device=dev))
    full_prior.lam_eq[7, :, 1, 1] = float("nan")
    tail_prior.lam_tail[7, :, 3] = float("nan")
    priors = {"none": None, "tail": tail_prior, "full": full_prior}
    al_errs = al_entry_checks("al_check", AL, Xi, Ui_nan, ast, iparams,
                              al_viol_later, priors, al_phase, nan_member=7)

    # their times at the serving path's shapes, modes and type (float32,
    # B=256, static bounds, the full prior; no NaN)
    ast32 = cast_tree(ast._replace(sol=ast.sol._replace(U=Ui)), torch.float32)
    ast32.lam_eq[7, 2, 4] = 0.0
    ap32 = {k: cast(v, torch.float32) for k, v in static_bounds(iparams).items()}
    full32 = cast_tree(full_prior, torch.float32)
    full32.lam_eq[7] = 0.0
    Xi32, Ui32 = cast(Xi, torch.float32), cast(Ui, torch.float32)
    al_calls = {
        "isrbd_al_constraints": ((al32, Xi32, Ui32, ap32), dict(st=ast32)),
        "isrbd_al_constraints_offline": ((al32, Xi32, Ui32, ap32),
                                         dict(st=ast32, offline=True)),
        "isrbd_al_constraints_eval": ((al32, Xi32, Ui32, ap32), {}),
        "isrbd_al_shift": ((al32, ast32, full32, al_phase), {}),
        "isrbd_al_params": ((al32, ap32, ast32), {}),
        "isrbd_al_prior_update": ((al32, full32, ast32, al_phase, 1.0), {}),
    }
    al_times = {}
    for name, (a, kw) in al_calls.items():
        entry = name.replace("_offline", "").replace("_eval", "")
        kern, twin = getattr(k78, entry), getattr(k78, entry + "_plain")
        res = kern(*a, **kw)
        n_bytes, flop = al_call_work(al32, name, a, kw, res)
        b_ms, b_by = bound(n_bytes, flop)
        # one member (its latency) and a large fleet, members repeated
        by_B = {}
        for Bw in (1, B_LARGE):
            aw, kww = resize_members((a, kw), Bc, Bw)
            by_B[Bw] = cuda_ms(lambda: kern(*aw, **kww), reps=20)
        al_times[name] = dict(
            ms=cuda_ms(lambda: kern(*a, **kw), reps=50),
            plain_ms=cuda_ms(lambda: twin(*a, **kw), reps=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, flop=flop,
            ms_by_B=by_B, host_us=host_us(lambda: kern(*a, **kw)))
        if entry == "isrbd_al_constraints":
            mode = 0 if not kw else 2 if kw.get("offline") else 1
            al_times[name].update(
                occupancy=k78.constraints_occupancy(mode, torch.float32,
                                                    iocp.ns, "kangaroo"),
                host_us_by_part=k7_host_split(k78, a, kw))
        elif entry == "isrbd_al_shift":
            al_times[name]["occupancy"] = k78.shift_occupancy(2)
        elif entry == "isrbd_al_params":
            al_times[name]["occupancy"] = k78.params_occupancy()
    emit("al_kernel_times", card=card, B=Bc, dtype="float32", **al_times)
    # one launch that does nothing, timed as the kernels are: the floor
    # under every time above
    emit("launch_floor", card=card,
         ms=cuda_ms(lambda: torch.cuda._sleep(0), reps=20))

    # timing at the constrained path's shapes and type (float32, B=256)
    i32 = k5_args(torch.float32)
    k5_ms = cuda_ms(lambda: k5.isrbd_linearize(*i32), reps=20)
    k5_plain_ms = cuda_ms(lambda: k5.isrbd_linearize_plain(*i32), reps=3,
                          warmup=1)
    k5_bytes = nbytes(i32[0], i32[1], *k5.kernel_params(
        i32[2], Bc, ns, al32.terms, torch.float32, dev), irows.packed(dev),
        *ilin_g32.values())
    k5_flop = isrbd_linearize_flops(
        Bc, ns, inx, inu, nc, al32.terms.n_rho, al32.terms.n_term,
        len(irows.rx), len(irows.ru), len(irows.uc))
    k5_bound, k5_by = bound(k5_bytes, k5_flop)

    ia32 = k1i_args(ilin32)
    k1i_ms = cuda_ms(lambda: k1.riccati_backward(*ia32), reps=20)
    k1i_plain_ms = cuda_ms(lambda: k1.riccati_backward_plain(*ia32), reps=3,
                           warmup=1)
    k1i_bytes = nbytes(*(ilin32[k] for k in order), irows.packed(dev), *igot32)
    k1i_flop = riccati_flops(Bc, ns, inx, inu, nt_i, len(irows.rx),
                             len(irows.ru), len(irows.gx), len(irows.gu),
                             len(irows.bx), len(irows.uc))
    k1i_bound, k1i_by = bound(k1i_bytes, k1i_flop, H100_FP64_TC_FLOP_PER_S)

    ix0[7] = ix0[6]
    t32 = k6_args(torch.float32, alphas4[:1])
    k6_ms = cuda_ms(lambda: k6.isrbd_trial(*t32), reps=50)
    k6_plain_ms = cuda_ms(lambda: k6.isrbd_trial_plain(*t32), reps=3, warmup=1)
    k6_out = k6.isrbd_trial(*t32)
    k6_in = [t for t in t32[:12] if isinstance(t, torch.Tensor)]
    k6_bytes = nbytes(*k6_in, *k5.kernel_params(
        t32[7], Bc, ns, al32.terms, torch.float32, dev), *k6_out)
    k6_flop = isrbd_trial_flops(Bc, ns, inx, inu, nc, al32.terms.n_rho,
                                al32.terms.n_term, 1)
    k6_bound, k6_by = bound(k6_bytes, k6_flop)
    t32_fan = k6_args(torch.float32, alphas4)
    k6_fan_ms = cuda_ms(lambda: k6.isrbd_trial(*t32_fan), reps=50)
    ie32 = iev_args(Ui)(torch.float32)
    iev_ms = cuda_ms(lambda: k6.isrbd_evaluate(*ie32), reps=50)
    iev_plain_ms = cuda_ms(lambda: k6.isrbd_evaluate_plain(*ie32), reps=5,
                           warmup=1)
    iev_bytes = nbytes(ie32[0], ie32[1], *k5.kernel_params(
        ie32[2], Bc, ns, al32.terms, torch.float32, dev),
        *k6.isrbd_evaluate(*ie32))
    iev_flop = isrbd_evaluate_flops(Bc, ns, inx, nc, al32.terms.n_rho,
                                    al32.terms.n_term)
    iev_bound, iev_by = bound(iev_bytes, iev_flop)
    iex0 = cast(ix0, torch.float32)
    iev_pin_ms = cuda_ms(lambda: k6.isrbd_evaluate(*ie32, x0=iex0), reps=50)
    iev_occ = evaluate_occupancy(k6, ns, Bc, sms)
    emit("evaluate_occupancy", entry="isrbd_evaluate", card=card, ns=ns,
         serving_B=Bc, sms=sms, **iev_occ)
    emit("evaluate_size_probe", entry="isrbd_evaluate", card=card,
         dtype="float32", pinned=True,
         ms_by_B=evaluate_size_probe(k6.isrbd_evaluate, ie32, iex0,
                                     (1, 132, Bc, B_LARGE)))
    emit("evaluate_host_us", entry="isrbd_evaluate", card=card, B=Bc,
         **evaluate_host_us(k6.isrbd_evaluate, ie32, iex0,
                            build.clear_host_setups))
    k5_occ, k6_occ = k5.occupancy(), k6.trial_occupancy()
    emit("kernel_times_constrained", card=card, B=Bc,
         isrbd_linearize_ms=k5_ms, isrbd_linearize_plain_ms=k5_plain_ms,
         isrbd_linearize_bound_ms=k5_bound, isrbd_linearize_bytes=k5_bytes,
         isrbd_linearize_flop=k5_flop,
         isrbd_linearize_gb_per_s=k5_bytes / k5_ms * 1e-6,
         isrbd_linearize_bound_share=k5_bound / k5_ms,
         isrbd_linearize_occupancy=k5_occ,
         isrbd_linearize_occupancy_f64=k5.occupancy(torch.float64),
         isrbd_trial_occupancy=k6_occ,
         isrbd_trial_occupancy_f64=k6.trial_occupancy(torch.float64),
         riccati_backward_ms=k1i_ms, riccati_backward_plain_ms=k1i_plain_ms,
         riccati_bound_ms=k1i_bound, riccati_bytes=k1i_bytes,
         riccati_flop=k1i_flop, riccati_rate="FP64 tensor cores, 67 TFLOP/s",
         riccati_shared_memory_bytes=k1i_smem, riccati_blocks_per_sm=k1i_blocks,
         isrbd_trial_ms=k6_ms, isrbd_trial_plain_ms=k6_plain_ms,
         isrbd_trial_bound_ms=k6_bound, isrbd_trial_bytes=k6_bytes,
         isrbd_trial_flop=k6_flop, isrbd_trial_4alpha_ms=k6_fan_ms,
         isrbd_evaluate_ms=iev_ms, isrbd_evaluate_plain_ms=iev_plain_ms,
         isrbd_evaluate_bound_ms=iev_bound, isrbd_evaluate_bytes=iev_bytes,
         isrbd_evaluate_flop=iev_flop, isrbd_evaluate_pinned_ms=iev_pin_ms,
         **{f"{k}_{f}": v[f] for k, v in al_times.items()
            for f in ("ms", "plain_ms", "bound_ms", "bytes", "ms_by_B")})
    # K6 alone from one member to past a wave: B=1 is the chain's own
    # latency, K6's floor
    emit("k6_size_probe", card=card, alphas=1,
         ms_by_B=trial_size_probe(k6.isrbd_trial, t32, (1, 132, 256, 528, 4096)),
         ms_B256_4alpha=k6_fan_ms, ring_depth=k6_occ["ring_depth"],
         blocks_per_sm=k6_occ["blocks_per_sm"])
    # isrbd sizes: three blocks an SM, 396 members a wave on 132 SMs
    emit("k1_wave_probe", sizes="isrbd", card=card,
         shared_memory_bytes=k1i_smem, blocks_per_sm=k1i_blocks,
         sms=torch.cuda.get_device_properties(0).multi_processor_count,
         ms_by_B=k1_wave_probe(k1, ilin32, order, mu, irows,
                               (1, 132, 256, 396, 397, 792, 793)))
    del ilin64, ilin32, ilin_g32, iref64, igot32, pin64, iparams, ist, ast
    del full_prior, tail_prior, priors, al_calls, ast32, full32

    # ---------------- phase 6: the constrained path ----------------
    def make_fleet(Bsz, dtype, device):
        """The seeded fleet as the serving programs start it: offline and
        online solvers, WPG, and the inputs of the first tick."""
        prob, offline = constrained_solvers(dtype, device, 15)
        _, online = constrained_solvers(dtype, device, 1)
        wpg = WalkingPatternGenerator.build(0.0, ns, dtype=dtype, device=device)
        gg = np.random.RandomState(11)
        x0 = prob.initial_state[None] + torch.as_tensor(
            0.01 * gg.randn(Bsz, inx), dtype=dtype, device=device)
        U0 = prob.static_input[None].expand(ns, -1)
        params = {k: v.expand((Bsz,) + tuple(v.shape)).contiguous()
                  for k, v in prob.ocp.params.items()}
        period = 2 * wpg.step_nodes
        state = (None, params, wpg.init_state((Bsz,)),
                 torch.ones(Bsz, dtype=torch.int32, device=device),
                 torch.tensor([[0.1, 0.0, 0.0]], dtype=dtype,
                              device=device).expand(Bsz, -1).contiguous(),
                 online.init_full_phase_prior(period, Bsz))
        seed = lambda: offline.solve_batch(offline.init(x0, U0), x0, params)
        return offline, online, wpg, period, state, seed

    def run_constrained(Bsz, warm, timed, chunk=0):
        offline, online, wpg, period, state, seed = make_fleet(
            Bsz, torch.float32, dev)
        counts = {"iterations": 0, "alpha0_trials": 0, "trials": 0,
                  "solves": 0}
        inner = online.inner
        iterate, trial, solve = (inner._iteration_batch, inner._trial,
                                 inner.solve_batch)

        def counted_solve(*a):
            counts["solves"] += 1
            return solve(*a)

        def counted_iteration(*a, **kw):
            counts["iterations"] += 1
            return iterate(*a, **kw)

        def counted_trial(al, *a):
            counts["trials"] += 1
            counts["alpha0_trials"] += int(al.numel() == 1)
            return trial(al, *a)

        inner._iteration_batch, inner._trial = counted_iteration, counted_trial
        inner.solve_batch = counted_solve
        t0 = time.perf_counter()
        st = seed()
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
        seed_viol = float(st.viol.max())

        def tick(st, params, ws, action, rdot, pr):
            return constrained_tick(online, wpg, st, params, ws, action, rdot,
                                    prior=pr, outers=1, prior_ema=1.0)

        one = chunk_map(tick, chunk) if chunk else tick

        def step(state):
            st, params, ws, pr = one(*state)
            return (st, params, ws, state[3], state[4], pr)

        state = (st,) + state[1:]
        for _ in range(1 + warm):
            state = step(state)
        torch.cuda.synchronize()
        before = dict(counts, k5=k5.isrbd_linearize.launches,
                      k1=k1.riccati_backward.launches,
                      k6=k6.isrbd_trial.launches,
                      evaluate=k6.isrbd_evaluate.launches,
                      plain_cost=plain_cost_calls["n"], syncs=inner.host_syncs,
                      al_twins=al_twin_calls["n"],
                      **{e: getattr(k78, e).launches for e in AL_ENTRIES})
        times, viols = [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            state = step(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            viols.append(float(state[0].viol.max()))
        after = dict(counts, k5=k5.isrbd_linearize.launches,
                     k1=k1.riccati_backward.launches,
                     k6=k6.isrbd_trial.launches,
                     evaluate=k6.isrbd_evaluate.launches,
                     plain_cost=plain_cost_calls["n"], syncs=inner.host_syncs,
                     al_twins=al_twin_calls["n"],
                     **{e: getattr(k78, e).launches for e in AL_ENTRIES})
        inner._iteration_batch, inner._trial = iterate, trial
        inner.solve_batch = solve
        st = state[0]
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (st.sol.X, st.sol.U, st.lam_eq, st.lam_eq_T, st.viol,
                      st.sol.cost))
        window = {k: after[k] - before[k] for k in after}
        cruns.append((online, step, state))
        return dict(
            B=Bsz, dtype="float32", chunk=chunk, warmup_ticks=1 + warm,
            ticks=timed, online_iters=1, outers=1, phase_prior="full",
            cz_rho_weight=CZ_RHO_WEIGHT, shift_warmstart=True,
            seed_seconds=seed_s, seed_viol_max=seed_viol,
            window_viol_max=max(viols), final_viol_max=viols[-1],
            tick_p50_ms=statistics.median(times), tick_max_ms=max(times),
            tick_mean_ms=statistics.fmean(times),
            solves_per_s=Bsz / statistics.median(times) * 1e3,
            iterations_mean=float(st.sol.iterations.float().mean()),
            syncs_per_tick=window["syncs"] / timed, timed_window=window,
            finite=finite, card=card)

    cruns = []
    func_calls, restore_func = count_torch_func()
    plain_cost_calls, restore_plain = count_plain_cost()
    al_twin_calls, restore_al = count_al_twins()
    k1.riccati_backward.launches = 0
    k5.isrbd_linearize.launches = 0
    k6.isrbd_trial.launches = 0
    k6.isrbd_evaluate.launches = 0
    for e in AL_ENTRIES:
        getattr(k78, e).launches = 0
    cmain = run_constrained(B_CONSTRAINED, warm=60, timed=20)
    claunches = {"riccati_backward": k1.riccati_backward.launches,
                 "isrbd_linearize": k5.isrbd_linearize.launches,
                 "isrbd_trial": k6.isrbd_trial.launches,
                 "isrbd_evaluate": k6.isrbd_evaluate.launches,
                 **{e: getattr(k78, e).launches for e in AL_ENTRIES}}
    restore_func()
    restore_plain()
    restore_al()
    cmain["launches"] = claunches
    cmain["torch_func_calls"] = func_calls["n"]
    cmain["plain_cost_or_defect_calls"] = plain_cost_calls["n"]
    cmain["al_twin_calls"] = al_twin_calls["n"]
    emit("constrained_path", **cmain)
    w = cmain["timed_window"]
    if not cmain["finite"]:
        fail("the constrained path produced non-finite values")
    if min(claunches.values()) == 0:
        fail(f"a kernel was not launched on the constrained path: {claunches}")
    if not (w["k5"] == w["k1"] == w["alpha0_trials"] == w["iterations"] > 0):
        fail(f"K5, K1, α₀ trials and solver iterations differ over the timed "
             f"ticks: {w}")
    if w["k6"] != w["trials"]:
        fail(f"K6 launches {w['k6']} do not cover the {w['trials']} trials")
    if not (w["evaluate"] == 2 * w["solves"] > 0):
        fail(f"isrbd_evaluate launches {w['evaluate']} are not two for each "
             f"of the {w['solves']} solves over the timed ticks")
    if w["plain_cost"] or plain_cost_calls["n"]:
        fail(f"the constrained path called the plain total_cost or "
             f"_true_defects {plain_cost_calls['n']} times")
    if func_calls["n"]:
        fail(f"the constrained path ran {func_calls['n']} torch.func transforms")
    # the AL layer: K7 (online) and K8a-c once a tick, no twin on the card
    # over the seed, the warm-up and the timed ticks
    if al_twin_calls["n"]:
        fail(f"the constrained path ran the AL layer's plain twins "
             f"{al_twin_calls['n']} times on the card")
    if not all(w[e] == cmain["ticks"] for e in AL_ENTRIES):
        fail(f"K7/K8 launches over the {cmain['ticks']} timed ticks are not one "
             f"a tick each: {[w[e] for e in AL_ENTRIES]}")
    if not cmain["window_viol_max"] < VIOL_LIMIT:
        fail(f"constraint violation {cmain['window_viol_max']} over the timed "
             f"ticks is not below {VIOL_LIMIT}")

    online, cstep, cstate = cruns[0]
    cstate, cspans = tick_spans(online.inner, cstep, cstate, ticks=5)
    emit("tick_spans_constrained", B=B_CONSTRAINED, card=card, **cspans)
    c_profile = profile_ticks(online.inner, cstep, cstate, cmain["tick_p50_ms"])
    emit("tick_profile_constrained", B=B_CONSTRAINED, card=card, **c_profile)
    # kernel launches a tick on both paths (torch.profiler), and the
    # evaluation launches among them (two a solve: cost0 with the node-0
    # pin, the final defects)
    emit("launches_per_tick", card=card,
         srbd=srbd_profile["kernel_launches_per_tick"],
         constrained=c_profile["kernel_launches_per_tick"],
         srbd_evaluate_per_tick=launches["srbd_evaluate"] / (
             main["warmup_ticks"] + main["ticks"]),
         isrbd_evaluate_per_tick=w["evaluate"] / cmain["ticks"],
         isrbd_al_per_tick={e: w[e] / cmain["ticks"] for e in AL_ENTRIES},
         memcpy_memset_per_tick=dict(
             srbd=srbd_profile["memcpy_memset_per_tick"],
             constrained=c_profile["memcpy_memset_per_tick"]))

    # the kernels against their twins once more, on the inputs the serving
    # path itself hands them: one further tick of the warm fleet with the
    # solver's linearization and trial calls recorded (multipliers from 90
    # ticks, and ½-slope ties wherever a force has underflowed to exactly
    # 0: their count is printed)
    inner = online.inner
    live = {}
    lin_call, trial_call = inner._linearize_sliced, inner._trial

    def recorded_linearize(X, U, params):
        live["lin"] = (X.clone(), U.clone(),
                       {k: v.clone() for k, v in params.items()})
        return lin_call(X, U, params)

    def recorded_trial(al, x0, X, U, ks, Ks, d, params, *scalars):
        live["trial"] = tuple(t.clone() for t in (x0, X, U, ks, Ks, d)) + (
            {k: v.clone() for k, v in params.items()},) + tuple(
            t.clone() for t in scalars)
        return trial_call(al, x0, X, U, ks, Ks, d, params, *scalars)

    inner._linearize_sliced, inner._trial = recorded_linearize, recorded_trial
    live_ev = []
    restore_ev = recorded(inner, "_evaluate", live_ev)
    live_al = {e: [] for e in AL_ENTRIES}
    restore_al_rec = [recorded(k78, e, live_al[e]) for e in AL_ENTRIES]
    cstate = cstep(cstate)
    for r in restore_al_rec:
        r()
    restore_ev()
    inner._linearize_sliced, inner._trial = lin_call, trial_call
    torch.cuda.synchronize()
    up = lambda t, dtype: (cast(t, dtype) if t.is_floating_point() else t)
    lX, lU, lp = live["lin"]

    def k5_live_args(dtype):
        a = al64 if dtype == torch.float64 else al32
        return (up(lX, dtype), up(lU, dtype),
                {k: up(v, dtype) for k, v in lp.items()}, a.terms,
                a.inner.rows, iocp.dt)

    llin64, _, _ = linearize_check(
        "k5_live_check", k5.isrbd_linearize_plain, k5.isrbd_linearize,
        k5_live_args, B=Bc,
        contact_forces_exactly_zero=int(
            (lU[..., 6:].reshape(Bc, ns, nc, 6)[..., 3:] == 0).all(-1).sum()))
    # at the warm fleet's multipliers and penalties Quu is worse
    # conditioned than at the drawn point: two float64 sweeps that sum in
    # different orders part at 1.3e-9 to 1.7e-9 there (4.9e-10 at the
    # drawn point)
    riccati_check("k1_live_check", k1, llin64, mu, irows,
                  f64_tol=K1_LIVE_F64_TOL, B=Bc)
    tx0, tX, tU, tks, tKs, td, tp, tm0, tD, tdV1, tdV2 = live["trial"]
    tx0 = tx0.clone()
    tx0[7] = float("nan")

    def k6_live_args(dtype, alphas):
        a = al64 if dtype == torch.float64 else al32
        c = lambda t: up(t, dtype)
        return (c(tx0), c(tX), c(tU), c(tks), c(tKs), c(td), c(alphas),
                {k: c(v) for k, v in tp.items()}, c(tm0), c(tD), c(tdV1),
                c(tdV2), a.terms, iocp.dt, iopts.defect_weight, iopts.beta,
                iopts.alpha_converge_threshold)

    trial_check("k6_live_check", k6.isrbd_trial_plain, k6.isrbd_trial,
                k6_live_args, alphas4, tm0.double(), tD.double(),
                tdV1.double(), tdV2.double(), iopts, nan_member=7, B=Bc)
    # isrbd_evaluate on the plans of the tick's first call (the starting
    # cost); member 7's r̈ₓ at node 3 is NaN
    eX, eU, ep, ekw = live_ev[0]
    if "x0" not in ekw or "x0" in live_ev[-1][3]:
        fail("the solve's first evaluation does not pin node 0, or its "
             "last one does")
    eU = eU.clone()
    eU[7, 3, 0] = float("nan")

    def iev_live_args(dtype):
        a = al64 if dtype == torch.float64 else al32
        return (up(eX, dtype), up(eU, dtype),
                {k: up(v, dtype) for k, v in ep.items()}, a.terms, iocp.dt)

    evaluate_check("isrbd_evaluate_live_check", k6.isrbd_evaluate_plain,
                   k6.isrbd_evaluate, iev_live_args, nan_member=7,
                   x0=ekw["x0"], calls_in_tick=len(live_ev))

    # K7 and K8 on the inputs the serving tick handed them in that tick,
    # and K7 (offline) and K8b on those of the offline seed's first and
    # last outer (a fresh seed of the B=256 fleet), each with a NaN put
    # into member 7's plan (K7, K8a) or multipliers (K8b, K8c)
    def al_live_args(rec):
        return lambda d: ([AL(d)] + [cast_tree(v, d) for v in rec[1:-1]],
                          cast_tree(rec[-1], d))

    def al_live_check(entry, rec, **extra):
        st_i = next((i for i, v in enumerate(rec)
                     if type(v).__name__ == "ALState"), None)
        if entry in ("isrbd_al_constraints",):
            rec[2][7, 3, 0] = float("nan")                     # U
        elif entry == "isrbd_al_shift":
            rec[st_i].sol.U[7, 3, 0] = float("nan")
        else:
            st_rec = rec[st_i] if st_i is not None else rec[-1]["st"]
            st_rec.lam_eq[7, 2, 4] = float("nan")
        al_check("al_live_check", getattr(k78, entry),
                 getattr(k78, entry + "_plain"), al_live_args(rec),
                 exact=entry != "isrbd_al_constraints", nan_member=7,
                 entry=entry, B=Bc, **extra)

    for e in AL_ENTRIES:
        if len(live_al[e]) != 1:
            fail(f"{e} ran {len(live_al[e])} times in one serving tick")
        al_live_check(e, list(live_al[e][0]), call="serving tick")
    seed_rec = {e: [] for e in ("isrbd_al_constraints", "isrbd_al_params")}
    restores = [recorded(k78, e, seed_rec[e]) for e in seed_rec]
    make_fleet(Bc, torch.float32, dev)[-1]()
    for r in restores:
        r()
    torch.cuda.synchronize()
    for which, i in (("first", 0), ("last", -1)):
        for e, recs in seed_rec.items():
            al_live_check(e, list(recs[i]), call=f"offline seed, {which} outer",
                          outers=len(recs))
    del live, llin64, live_ev, live_al, seed_rec
    del cruns[:]
    for chunk in (CONSTRAINED_CHUNK, 0):
        probe = run_constrained(B_LARGE, warm=20, timed=3, chunk=chunk)
        emit("constrained_path_large", **probe)
        del cruns[:]

    # ---------------- phase 7: constrained card path against CPU path --------
    def ticks_c8(device, seed_state):
        _, online, wpg, _, state, _ = make_fleet(8, torch.float64, device)
        move = lambda t: t.to(device)
        st = type(seed_state)(
            sol=type(seed_state.sol)(*(move(t) for t in seed_state.sol)),
            **{k: move(getattr(seed_state, k))
               for k in seed_state._fields if k != "sol"})
        state = (st,) + state[1:]
        its = []
        for _ in range(3):
            st, params, ws, pr = constrained_tick(
                online, wpg, *state, outers=1, prior_ema=1.0)
            state = (st, params, ws, state[3], state[4], pr)
            its.append(st.sol.iterations.cpu())
        return state[0], its

    _, _, _, _, _, seed_cpu = make_fleet(8, torch.float64, "cpu")
    _, _, _, _, _, seed_card = make_fleet(8, torch.float64, dev)
    st_seed = seed_cpu()
    st_seed_card = seed_card()
    emit("constrained_seed_card_vs_cpu", B=8,
         X_rel_err=rel_err(st_seed_card.sol.X.cpu(), st_seed.sol.X),
         lam_rel_err=rel_err(st_seed_card.lam_eq.cpu(), st_seed.lam_eq),
         iterations_equal=bool(torch.equal(st_seed_card.sol.iterations.cpu(),
                                           st_seed.sol.iterations)),
         viol_cpu=float(st_seed.viol.max()))
    c_cpu, it_cpu = ticks_c8("cpu", st_seed)
    c_card, it_card = ticks_c8(dev, st_seed)
    cvc = dict(
        B=8, ticks=3, tol=1e-9,
        iterations_equal=all(torch.equal(a, b) for a, b in zip(it_card, it_cpu)),
        converged_equal=bool(torch.equal(c_card.sol.converged.cpu(),
                                         c_cpu.sol.converged)),
        X_rel_err=rel_err(c_card.sol.X.cpu(), c_cpu.sol.X),
        U_rel_err=rel_err(c_card.sol.U.cpu(), c_cpu.sol.U),
        lam_rel_err=rel_err(c_card.lam_eq.cpu(), c_cpu.lam_eq),
        lam_T_rel_err=rel_err(c_card.lam_eq_T.cpu(), c_cpu.lam_eq_T),
        viol_rel_err=rel_err(c_card.viol.cpu(), c_cpu.viol))
    emit("constrained_card_vs_cpu", **cvc)
    if not (cvc["iterations_equal"] and cvc["converged_equal"]
            and max(cvc["X_rel_err"], cvc["U_rel_err"], cvc["lam_rel_err"],
                    cvc["lam_T_rel_err"]) <= 1e-9):
        fail("constrained card path and CPU path disagree")

    # ---------------- phase 8: the single-robot SRBD loop ----------------
    def single_loop(dtype, device, quu_solver="schur"):
        """The dsrbd example's loop: MPCLoop.tick on MSDDP.solve with its
        options, the WPG at the feet's height, no warm-start shift."""
        prob = build_srbd_problem(SRBDConfig(dtype=dtype), feet, dtype=dtype,
                                  device=device)
        opts = dataclasses.replace(ddp_example_options(), quu_solver=quu_solver)
        wpg = WalkingPatternGenerator.build(
            c_init_z=float(prob.initial_foot_position[0, 2]), nodes=ns,
            dtype=dtype, device=device)
        return MPCLoop(solver=MSDDP(prob.ocp, opts), wpg=wpg,
                       srbd_constants=prob.ocp.constants), prob

    def drive_single(loop, prob, sched):
        """Ticks over `sched` from the cold carry at the nominal state:
        the carry, the outputs, the tick times (ms, a device sync each),
        the host reads and the trials."""
        trials = {"n": 0}
        trial = loop.solver._trial

        def counted_trial(*a):
            trials["n"] += 1
            return trial(*a)

        loop.solver._trial = counted_trial
        carry = loop.init(prob.initial_state)
        syncs0 = loop.solver.host_syncs
        outs, times = [], []
        for t in range(sched.action.shape[0]):
            inp = TickInput(*(a[t] for a in sched))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, out = loop.tick(carry, inp)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        loop.solver._trial = trial
        return (carry, outs, times, loop.solver.host_syncs - syncs0,
                trials["n"])

    SRBD_TWINS = ((k1, ("riccati_backward_plain",)),
                  (k3, ("srbd_trial_plain", "srbd_evaluate_plain")),
                  (k4, ("srbd_linearize_plain",)))
    inst = {key: k1.KERNEL_INSTANCES.index(key) for key in k1.KERNEL_INSTANCES}
    i_schur, i_chol = inst["srbd", "tassa", "schur"], inst["srbd", "tassa", "cholesky"]
    func_calls, restore_func = count_torch_func()
    plain_calls, restore_plain = count_plain_cost()
    twin_calls, restore_twins = count_calls(SRBD_TWINS)
    k1.riccati_backward.launches = 0
    k1.riccati_backward.instance_launches[:] = [0] * len(k1.KERNEL_INSTANCES)
    k3.srbd_trial.launches = 0
    k3.srbd_evaluate.launches = 0
    k4.srbd_linearize.launches = 0
    # the example's walk: 40 ticks, standing for 10, then vx 0.3 (the
    # default gain solve); then 10 ticks, walking from tick 3, with Cholesky
    sloop, sprob = single_loop(torch.float32, dev)
    sched = walking_schedule(40, vx=0.3, start=10, device=dev)
    scarry, souts, stimes, ssyncs, strials = drive_single(sloop, sprob, sched)
    chol_loop, chol_prob = single_loop(torch.float32, dev, "cholesky")
    _, couts, ctimes, csyncs, ctrials = drive_single(
        chol_loop, chol_prob, walking_schedule(10, vx=0.3, start=3, device=dev))
    single_launches = {
        "riccati_backward_tassa": k1.riccati_backward.instance_launches[i_schur],
        "riccati_backward_tassa_cholesky":
            k1.riccati_backward.instance_launches[i_chol],
        "riccati_backward": k1.riccati_backward.launches,
        "srbd_linearize": k4.srbd_linearize.launches,
        "srbd_trial": k3.srbd_trial.launches,
        "srbd_evaluate": k3.srbd_evaluate.launches}
    for restore in (restore_func, restore_plain, restore_twins):
        restore()
    n_ticks = len(souts) + len(couts)
    iters = [int(o.iterations) for o in souts + couts]
    single = dict(
        B=1, dtype="float32", ticks=len(souts), cholesky_ticks=len(couts),
        options="ddp_example_options (max_iters=100, alpha_converge_threshold="
                "1e-12, beta=1e-3)", walk="vx 0.3 from tick 10",
        tick_p50_ms=statistics.median(stimes), tick_max_ms=max(stimes),
        tick_mean_ms=statistics.fmean(stimes),
        cholesky_tick_p50_ms=statistics.median(ctimes),
        cholesky_tick_max_ms=max(ctimes),
        iterations_per_tick=iters[:len(souts)],
        cholesky_iterations_per_tick=iters[len(souts):],
        iterations_mean=statistics.fmean(iters[:len(souts)]),
        syncs_per_tick=ssyncs / len(souts),
        syncs_per_iteration=ssyncs / sum(iters[:len(souts)]),
        cholesky_syncs_per_tick=csyncs / len(couts),
        launches=single_launches,
        kernel_launches_per_tick=sum(
            single_launches[k] for k in ("riccati_backward", "srbd_linearize",
                                         "srbd_trial", "srbd_evaluate"))
        / n_ticks,
        kernel_launches_per_iteration=(single_launches["riccati_backward"]
                                       + single_launches["srbd_linearize"]
                                       + single_launches["srbd_trial"])
        / sum(iters),
        trials=strials + ctrials,
        defect_norm_max=max(float(o.defect_norm) for o in souts + couts),
        srbd_residual_max=max(float(o.srbd_residual.abs().max())
                              for o in souts + couts),
        finite=all(bool(torch.isfinite(t).all()) for o in souts + couts
                   for t in (o.x, o.u0, o.cost, o.srbd_residual)),
        converged_ticks=sum(bool(o.converged) for o in souts + couts),
        plain_twin_calls=twin_calls["n"], torch_func_calls=func_calls["n"],
        plain_cost_or_defect_calls=plain_calls["n"],
        final_com=scarry.x[:3].tolist(), card=card)
    sstep = lambda c: sloop.tick(c, TickInput(*(a[-1] for a in sched)))[0]
    scarry, sspans = tick_spans(sloop.solver, sstep, scarry, ticks=5)
    single["spans"] = sspans
    single["profile"] = profile_ticks(sloop.solver, sstep, scarry,
                                      single["tick_p50_ms"])
    emit("single_path", **single)
    if not single["finite"]:
        fail("the single-robot path produced non-finite values")
    if max(single["defect_norm_max"], single["srbd_residual_max"]) > 1e-4:
        fail("single-robot plans are not dynamically consistent (defect or "
             "Newton-Euler residual above 1e-4)")
    if min(single_launches.values()) == 0:
        fail(f"a kernel was not launched on the single path: {single_launches}")
    if not (single_launches["srbd_linearize"]
            == single_launches["riccati_backward"] == sum(iters)):
        fail(f"K4 and K1 launches differ from the iterations: {single_launches}, "
             f"{sum(iters)} iterations")
    if single_launches["srbd_trial"] != single["trials"]:
        fail(f"K3 launches do not cover the trials: {single_launches}")
    if single_launches["srbd_evaluate"] != 2 * n_ticks:
        fail(f"srbd_evaluate launches are not two a solve: {single_launches}")
    if twin_calls["n"] or func_calls["n"] or plain_calls["n"]:
        fail(f"the single path ran plain twins on the card: "
             f"{twin_calls['n']} kernel twins, {plain_calls['n']} plain cost "
             f"or defect calls, {func_calls['n']} torch.func transforms")

    # card against CPU in float64 over 10 ticks (walking from tick 3), and
    # `run` against `tick` on the card in float32
    def single_ticks(dtype, device, n):
        loop, prob = single_loop(dtype, device)
        sch = walking_schedule(n, vx=0.3, start=3, dtype=dtype, device=device)
        carry = loop.init(prob.initial_state)
        outs = []
        for t in range(n):
            carry, out = loop.tick(carry, TickInput(*(a[t] for a in sch)))
            outs.append(out)
        return loop, prob, sch, carry, outs

    _, _, _, c_card, o_card = single_ticks(f64, dev, 10)
    _, _, _, c_cpu, o_cpu = single_ticks(f64, "cpu", 10)
    svc = dict(
        B=1, ticks=10, tol=1e-9,
        iterations_card=[int(o.iterations) for o in o_card],
        iterations_equal=all(int(a.iterations) == int(b.iterations)
                             for a, b in zip(o_card, o_cpu)),
        converged_equal=all(bool(a.converged) == bool(b.converged)
                            for a, b in zip(o_card, o_cpu)),
        X_rel_err=rel_err(c_card.sol.X.cpu(), c_cpu.sol.X),
        U_rel_err=rel_err(c_card.sol.U.cpu(), c_cpu.sol.U),
        x_rel_err=max(rel_err(a.x.cpu(), b.x) for a, b in zip(o_card, o_cpu)))
    loop32, prob32, sch32, c_ticks, o_ticks = single_ticks(torch.float32, dev, 10)
    c_run, o_run = loop32.run(loop32.init(prob32.initial_state), sch32)
    svc["run_vs_ticks"] = dict(
        iterations_equal=[int(o.iterations) for o in o_ticks]
        == o_run.iterations.tolist(),
        bit_equal=bool(torch.equal(c_run.sol.X, c_ticks.sol.X)
                       and torch.equal(c_run.sol.U, c_ticks.sol.U)
                       and torch.equal(o_run.x, torch.stack([o.x for o in o_ticks]))),
        X_rel_err=rel_err(c_run.sol.X, c_ticks.sol.X))
    emit("single_card_vs_cpu", **svc)
    if not (svc["iterations_equal"] and svc["converged_equal"]
            and max(svc["X_rel_err"], svc["U_rel_err"], svc["x_rel_err"]) <= 1e-9):
        fail("single-robot card path and CPU path disagree")
    if not (svc["run_vs_ticks"]["iterations_equal"]
            and svc["run_vs_ticks"]["X_rel_err"] <= 1e-9):
        fail("MPCLoop.run over 10 ticks differs from 10 ticks")

    # ---------------- phase 9: the single-robot constrained path ----------
    def single_al(dtype, device):
        """The isrbd example's solver: ALDDP with max_iters=15, six outers
        from ρ 1e3, ρ capped at 1e5."""
        prob = build_isrbd_problem(SRBDConfig(dtype=dtype), feet, device=device)
        return prob, ALDDP(prob.ocp, DDPOptions(
            max_iters=15, alpha_converge_threshold=1e-12, beta=1e-3),
            ALOptions(outer_iters=6, rho0=1e3, rho_max=1e5))

    def drive_al(dtype, device, n_online, timed=False):
        """The example's sequence: the offline `ALDDP.solve` from the static
        input, then `n_online` ticks of the WPG advance, rdot_ref on nodes
        1..ns, x0 = the plan's node 1 and `solve_online` (walking from tick
        10). Returns the states, the solve times and the violations."""
        prob, al = single_al(dtype, device)
        x0 = prob.initial_state
        U0 = prob.static_input[None].expand(ns, -1).contiguous()
        sync = torch.cuda.synchronize if timed else (lambda: None)
        sync()
        t0 = time.perf_counter()
        st = al.solve(al.init(x0, U0), x0, prob.ocp.params)
        sync()
        solve_ms = (time.perf_counter() - t0) * 1e3
        states, online_ms, viols = [st], [], []
        wpg = WalkingPatternGenerator.build(c_init_z=0.0, nodes=ns,
                                            dtype=dtype, device=device)
        params, ws = dict(prob.ocp.params), wpg.init_state()
        ref = torch.tensor([0.3, 0.0, 0.0], dtype=dtype, device=device)
        for t in range(n_online):
            action = torch.tensor(int(t >= 10), dtype=torch.int32, device=device)
            params, ws = wpg.advance(params, ws, action)
            params["rdot_ref"] = torch.cat(
                [params["rdot_ref"][:1], ref.expand(ns, 3)], dim=0)
            sync()
            t0 = time.perf_counter()
            st = al.solve_online(st, st.sol.X[1], params)
            sync()
            online_ms.append((time.perf_counter() - t0) * 1e3)
            states.append(st)
            viols.append(float(st.viol))
        return al, states, solve_ms, online_ms, viols

    ISRBD_TWINS = ((k1, ("riccati_backward_plain",)),
                   (k6, ("isrbd_trial_plain", "isrbd_evaluate_plain")),
                   (k5, ("isrbd_linearize_plain",)))
    i_ichol = inst["isrbd_al", "tassa", "cholesky"]
    func_calls, restore_func = count_torch_func()
    plain_calls, restore_plain = count_plain_cost()
    twin_calls, restore_twins = count_calls(ISRBD_TWINS)
    al_twin_calls, restore_al = count_al_twins()
    k1.riccati_backward.launches = 0
    k1.riccati_backward.instance_launches[:] = [0] * len(k1.KERNEL_INSTANCES)
    for mod, entry in ((k5, "isrbd_linearize"), (k6, "isrbd_trial"),
                       (k6, "isrbd_evaluate"), (k78, "isrbd_al_constraints"),
                       (k78, "isrbd_al_params")):
        getattr(mod, entry).launches = 0
    al_s, al_states, al_solve_ms, al_online_ms, al_viols = drive_al(
        torch.float32, dev, 20, timed=True)
    c_launches = {
        "riccati_backward_isrbd_tassa_cholesky":
            k1.riccati_backward.instance_launches[i_ichol],
        "riccati_backward": k1.riccati_backward.launches,
        "isrbd_linearize": k5.isrbd_linearize.launches,
        "isrbd_trial": k6.isrbd_trial.launches,
        "isrbd_evaluate": k6.isrbd_evaluate.launches,
        "isrbd_al_constraints": k78.isrbd_al_constraints.launches,
        "isrbd_al_params": k78.isrbd_al_params.launches}
    for restore in (restore_func, restore_plain, restore_twins, restore_al):
        restore()
    solves = 6 + len(al_online_ms)
    al_iters = [int(s.sol.iterations) for s in al_states]
    csingle = dict(
        B=1, dtype="float32", outer_iters=6, max_iters=15, rho0=1e3,
        rho_max=1e5, online_ticks=len(al_online_ms), walk="vx 0.3 from tick 10",
        solve_ms=al_solve_ms, online_p50_ms=statistics.median(al_online_ms),
        online_max_ms=max(al_online_ms),
        ms_per_inner_solve=(al_solve_ms + sum(al_online_ms)) / solves,
        offline_viol=float(al_states[0].viol), online_viol_max=max(al_viols),
        online_viol_final=al_viols[-1], rho=float(al_states[-1].rho),
        iterations_last_inner=al_iters, launches=c_launches,
        finite=all(bool(torch.isfinite(t).all()) for s in al_states
                   for t in (s.sol.X, s.sol.U, s.lam_eq, s.lam_eq_T, s.viol)),
        plain_twin_calls=twin_calls["n"], al_twin_calls=al_twin_calls["n"],
        torch_func_calls=func_calls["n"],
        plain_cost_or_defect_calls=plain_calls["n"], card=card)
    emit("single_constrained_path", **csingle)
    if not csingle["finite"]:
        fail("the single-robot constrained path produced non-finite values")
    if min(c_launches.values()) == 0:
        fail(f"a kernel was not launched on the single constrained path: "
             f"{c_launches}")
    if not (c_launches["isrbd_linearize"] == c_launches["riccati_backward"]
            == c_launches["riccati_backward_isrbd_tassa_cholesky"]):
        fail(f"K5 and K1 (Tassa, Cholesky) launches differ: {c_launches}")
    if c_launches["isrbd_evaluate"] != 2 * solves:
        fail(f"isrbd_evaluate launches are not two a solve: {c_launches}")
    if not (c_launches["isrbd_al_constraints"] == c_launches["isrbd_al_params"]
            == solves):
        fail(f"K7 and K8b launches are not one an outer: {c_launches}")
    if (twin_calls["n"] or al_twin_calls["n"] or func_calls["n"]
            or plain_calls["n"]):
        fail("the single constrained path ran plain twins on the card: "
             f"{twin_calls['n']} kernel twins, {al_twin_calls['n']} AL twins, "
             f"{plain_calls['n']} plain cost or defect calls, "
             f"{func_calls['n']} torch.func transforms")

    # card against CPU in float64: the offline solve and 3 online ticks
    _, st_card, _, _, _ = drive_al(f64, dev, 3)
    _, st_cpu, _, _, _ = drive_al(f64, "cpu", 3)
    cvs = dict(
        B=1, steps=len(st_cpu), tol=1e-9,
        iterations_equal=all(int(a.sol.iterations) == int(b.sol.iterations)
                             for a, b in zip(st_card, st_cpu)),
        converged_equal=all(bool(a.sol.converged) == bool(b.sol.converged)
                            for a, b in zip(st_card, st_cpu)),
        X_rel_err=max(rel_err(a.sol.X.cpu(), b.sol.X)
                      for a, b in zip(st_card, st_cpu)),
        U_rel_err=max(rel_err(a.sol.U.cpu(), b.sol.U)
                      for a, b in zip(st_card, st_cpu)),
        lam_rel_err=max(rel_err(a.lam_eq.cpu(), b.lam_eq)
                        for a, b in zip(st_card, st_cpu)),
        viol_cpu=[float(b.viol) for b in st_cpu])
    emit("single_constrained_card_vs_cpu", **cvs)
    if not (cvs["iterations_equal"] and cvs["converged_equal"]
            and max(cvs["X_rel_err"], cvs["U_rel_err"], cvs["lam_rel_err"])
            <= 1e-9):
        fail("single-robot constrained card path and CPU path disagree")

    # ---------------- phase 10: the LIP paths ----------------
    lip_rows = lip_section(card, dev, sms)

    # ---------------- phase 11: the quadruped trot ----------------
    quad_rows = quadruped_section(card, dev, sms)

    # ---------------- phase 12: the constrained quadruped trot ----------
    qc_rows = quadruped_constrained_section(card, dev, sms)

    # ---------------- phase 13: the execution modes (K12, K13) ----------
    modes_rows = modes_section(card, dev, sms)
    modes_rows += modes_shapes_section(card, dev, sms)

    # ---------------- phase 14: the SRBD family at every topology and step --
    family_rows = family_section(card, dev, sms)

    # ---------------- phase 15: the execution modes at every SRBD shape ----
    family_rows += modes_family_section(card, dev, sms, family_rows)

    # ---------------- phase 16: the LIP at every topology and step ----------
    family_rows += lip_family_section(card, dev, sms)

    # ---------------- phase 17: the execution modes at every LIP shape ------
    family_rows += lip_modes_section(card, dev, sms)

    # ---------------- phase 18: the square-feet biped (contact_model=4) ----
    family_rows += square_feet_section(card, dev, sms)

    # ---------------- phase 19: the line-feet quadruped (contact_model=2,
    # four legs) ----
    family_rows += line_feet_section(card, dev, sms)

    lin_tol = f"2*plain_rel_err_f32 + 1e-6, and <= {K4_F32_CAP}"
    trial_tol = "2*plain_rel_err_f32 + 1e-6"
    kernels = [
        kernel_row("srbd_linearize", k4, launches["srbd_linearize"], k4_ms,
                   k4_plain_ms, k4_bound, k4_by, k4_err, lin_tol),
        kernel_row("riccati_backward", k1, launches["riccati_backward"], k1_ms,
                   k1_plain_ms, k1_bound, k1_by, k1_err, K1_F32_TOL,
                   shared_memory_bytes=k1_smem, blocks_per_sm=k1_blocks),
        kernel_row("srbd_trial", k3, launches["srbd_trial"], k3_ms,
                   k3_plain_ms, k3_bound, k3_by, k3_err, trial_tol),
        kernel_row("isrbd_linearize", k5, claunches["isrbd_linearize"], k5_ms,
                   k5_plain_ms, k5_bound, k5_by, k5_err, lin_tol,
                   gb_per_s=k5_bytes / k5_ms * 1e-6,
                   shared_memory_bytes=k5_occ["shared_memory_bytes"],
                   blocks_per_sm=k5_occ["blocks_per_sm"]),
        kernel_row("riccati_backward_isrbd", k1, claunches["riccati_backward"],
                   k1i_ms, k1i_plain_ms, k1i_bound, k1i_by, k1i_err,
                   K1_F32_TOL, shared_memory_bytes=k1i_smem,
                   blocks_per_sm=k1i_blocks),
        kernel_row("isrbd_trial", k6, claunches["isrbd_trial"], k6_ms,
                   k6_plain_ms, k6_bound, k6_by, k6_err, trial_tol,
                   ms_4alpha=k6_fan_ms, ring_depth=k6_occ["ring_depth"],
                   shared_memory_bytes=k6_occ["shared_memory_bytes"],
                   blocks_per_sm=k6_occ["blocks_per_sm"]),
        dict(kernel_row("srbd_evaluate", k3, launches["srbd_evaluate"], ev_ms,
                        ev_plain_ms, ev_bound, ev_by, ev_err, trial_tol,
                        ms_pinned=ev_pin_ms,
                        blocks_per_sm=ev_occ["f32"]["blocks_per_sm"],
                        waves_at_serving_B=ev_occ["f32"]["waves_at_serving_B"]),
             replaces=k3.EVALUATE_REPLACES),
        dict(kernel_row("isrbd_evaluate", k6, claunches["isrbd_evaluate"],
                        iev_ms, iev_plain_ms, iev_bound, iev_by, iev_err,
                        trial_tol, ms_pinned=iev_pin_ms,
                        blocks_per_sm=iev_occ["f32"]["blocks_per_sm"],
                        waves_at_serving_B=iev_occ["f32"]["waves_at_serving_B"]),
             replaces=k6.EVALUATE_REPLACES),
    ]
    for e, key, replaces, tol32 in (
            ("isrbd_al_constraints", "k7", k78.REPLACES, trial_tol),
            ("isrbd_al_shift", "k8a", k78.SHIFT_REPLACES, "bit-equal"),
            ("isrbd_al_params", "k8b", k78.PARAMS_REPLACES, "bit-equal"),
            ("isrbd_al_prior_update", "k8c", k78.PRIOR_REPLACES, "bit-equal")):
        t = al_times[e]
        extra = {}
        if e == "isrbd_al_constraints":
            off = al_times["isrbd_al_constraints_offline"]
            extra = dict(mode="online (the serving tick)", ms_offline=off["ms"],
                         plain_ms_offline=off["plain_ms"],
                         bound_ms_offline=off["bound_ms"])
        kernels.append(dict(
            kernel_row(e, k78, claunches[e], t["ms"], t["plain_ms"],
                       t["bound_ms"], t["bound_by"], al_errs[key], tol32,
                       ms_B1=t["ms_by_B"][1], launches_per_tick=1,
                       host_us=t["host_us"], **extra),
            replaces=replaces,
            tol_f64=AL_F64_TOL if key == "k7" else "bit-equal"))
    kernels += [
        # K2 runs inside K1: its launches are K1's on the main path; its
        # times are the standalone entry's on the SRBD stack (float32)
        dict(kernel_row(
            "spd_inverse", k1, launches["riccati_backward"], k2["ms_f32"],
            k2["plain_ms_f32"], k2["bound_ms"], k2["bound_by"],
            dict(e64=k2["f64_rel_err"], e32=k2["f32_rel_err"],
                 p32=k2["f32_plain_rel_err"], abs32=k2["f32_max_abs_err"]),
            K2_F32_TOL, launches_of="riccati_backward (K2 runs inside K1)",
            stack=k2["stack"], ms_f64=k2["ms_f64"],
            library_ms_f32=k2["torch_linalg_inv_ms_f32"],
            isrbd_stack=k2i["stack"], isrbd_ms_f32=k2i["ms_f32"],
            isrbd_ms_f64=k2i["ms_f64"],
            isrbd_library_ms_f64=k2i["torch_linalg_inv_ms_f64"],
            isrbd_library_ms_f32=k2i["torch_linalg_inv_ms_f32"]),
             replaces=k1.K2_REPLACES,
             library_ms=k2["torch_linalg_inv_ms_f64"]),
    ]
    # K1's Tassa instantiations: launches from the single-robot paths, times
    # at B=1 (their shape there) with the serving B beside them
    for key, name, n_launched in (
            (("srbd", "schur"), "riccati_backward_tassa",
             single_launches["riccati_backward_tassa"]),
            (("srbd", "cholesky"), "riccati_backward_tassa_cholesky",
             single_launches["riccati_backward_tassa_cholesky"]),
            (("isrbd_al", "cholesky"), "riccati_backward_isrbd_tassa_cholesky",
             c_launches["riccati_backward_isrbd_tassa_cholesky"])):
        tt = tassa_t[key[0]]
        t = tt[key[1]]
        kernels.append(dict(
            kernel_row(name, k1, n_launched, t["ms_B1"], t["plain_ms_B1"],
                       t["bound_ms_B1"], t["bound_by"], tassa_err[key],
                       K1_F32_TOL, B=1, quu_solver=key[1],
                       ms_serving_B=t["ms_B"], serving_B=tt["B"],
                       collapsed_ms_B1=tt["collapsed"]["ms_B1"],
                       collapsed_ms_serving_B=tt["collapsed"]["ms_B"],
                       shared_memory_bytes=t["shared_memory_bytes"],
                       blocks_per_sm=t["blocks_per_sm"]),
            replaces=k1.TASSA_REPLACES))
    kernels += lip_rows + quad_rows + qc_rows + modes_rows + family_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
