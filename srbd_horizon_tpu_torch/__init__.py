"""srbd_horizon_tpu_torch — the PyTorch/CUDA port of `srbd_horizon_tpu`.

The port runs on an NVIDIA H100: the warm-started closed-loop SRBD fleet
MPC tick (`MPCLoop.tick_batch`), the constrained serving tick
(augmented-Lagrangian DDP on the hybrid SRBD/LIP isrbd problem), and the
single-robot API the JAX package's examples call (`MPCLoop.tick` / `run`
over a `walking_schedule`, `MSDDP.solve`, `ALDDP.solve` /
`solve_online`), on the SRBD problem and on the LIP (`build_lip_loop`, the
JAX package's dlip example), and on the point-feet quadruped's trot
(`build_quadruped_loop`, its quadruped example). Plain tensor code is PyTorch; each solver
iteration runs three hand-written CUDA kernels — a closed-form
linearization (`csrc/srbd_linearize.cu`, `csrc/isrbd_linearize.cu`,
`csrc/lip_linearize.cu`), the Riccati sweep
(`csrc/riccati_backward.cu`: the collapsed form for fleets, the Tassa form
with a block-Schur or Cholesky gain solve for one robot) and the
line-search trial with its cost (`csrc/srbd_rollout.cu`,
`csrc/isrbd_rollout.cu`, `csrc/lip_rollout.cu`) — with plain PyTorch
twins that the CPU tests hold against the JAX package.

Layout (mirrors the JAX package):
    config        SRBDConfig / DDPOptions (torch dtypes)
    math/         quaternion helpers, batch-first small-matrix algebra
    models/       Kangaroo (line and point feet) and quadruped constants,
                  the URDF loaders, SRBD dynamics, the LIP model
    assets/       copies of the JAX package's URDF assets
    ocp/          variable layouts, Euler, RK2 and RK4 steps, the OCP
                  container
    problems/     build_srbd_problem, build_isrbd_problem, the AL inner
                  problem, build_lip_problem
    wpg           walking-pattern generator
    solvers/      MSDDP (`solve_batch`, `solve`), ALDDP (`solve_batch`,
                  `solve`, `solve_online`, the serving tick), the option
                  presets
    kernels/      CUDA kernel wrappers, their plain twins, the nvcc build
    runtime/      MPCLoop (`tick_batch`, `run_batch`, `tick`, `run`), the
                  schedules, constrained_tick, chunk_map
    convert       numpy state from the JAX side -> tensors on a device

Entry points take `device=` and default to "cuda"; they raise when CUDA
is absent and no device was given. Nothing here imports JAX.
"""

__version__ = "0.1.0"

from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.runtime.loop import (
    LoopCarry,
    MPCLoop,
    TickInput,
    TickOutput,
    build_lip_loop,
    build_quadruped_loop,
    build_srbd_loop,
    standing_schedule,
    walking_schedule,
)
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP, ALOptions, ALState
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP, DDPSolution

__all__ = [
    "ALDDP", "ALOptions", "ALState", "DDPOptions", "DDPSolution",
    "LoopCarry", "MPCLoop", "MSDDP", "SRBDConfig", "TickInput", "TickOutput",
    "build_lip_loop", "build_quadruped_loop", "build_srbd_loop",
    "standing_schedule",
    "walking_schedule",
]
