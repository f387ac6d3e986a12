"""srbd_horizon_tpu_torch — the PyTorch/CUDA port of `srbd_horizon_tpu`.

The port runs two paths on an NVIDIA H100: the warm-started closed-loop
SRBD fleet MPC tick, and the constrained serving tick (augmented-
Lagrangian DDP on the hybrid SRBD/LIP isrbd problem). Plain tensor code
is PyTorch; each solver iteration runs three hand-written CUDA kernels —
a closed-form linearization (`csrc/srbd_linearize.cu`,
`csrc/isrbd_linearize.cu`), the Riccati sweep
(`csrc/riccati_backward.cu`) and the line-search trial with its cost
(`csrc/srbd_rollout.cu`, `csrc/isrbd_rollout.cu`) — with plain PyTorch
twins that the CPU tests hold against the JAX package.

Layout (mirrors the JAX package):
    config        SRBDConfig / DDPOptions (torch dtypes)
    math/         quaternion helpers, batch-first small-matrix algebra
    models/       Kangaroo constants, SRBD dynamics, the LIP model
    ocp/          variable layouts, Euler and RK2 steps, the OCP container
    problems/     build_srbd_problem, build_isrbd_problem, the AL inner
                  problem
    wpg           walking-pattern generator
    solvers/      MSDDP (the batched production path), ALDDP (batched),
                  the option presets
    kernels/      CUDA kernel wrappers, their plain twins, the nvcc build
    runtime/      MPCLoop.tick_batch, constrained_tick, chunk_map
    convert       numpy state from the JAX side -> tensors on a device

Entry points take `device=` and default to "cuda"; they raise when CUDA
is absent and no device was given. Nothing here imports JAX.
"""

__version__ = "0.1.0"
