"""The line-feet quadruped's trots in the JAX package, on the CPU: the
CoM height band and the forward progress `chip_smoke.py`'s phase 19 gates
its single-robot trots on. Not collected by pytest (a 40-tick JAX run
compiles for a minute or more); run by hand:

    JAX_PLATFORMS=cpu python tests/line_feet_walk_reference.py f64 40

For the SRBD problem (the quadruped example's options: max_iters=5,
alpha_converge_threshold=1e-12, beta=1e-3; the WPG at the feet's height)
and the LIP (the dlip example's: max_iters=100, the same thresholds), each
under the Euler step with the trot's 8-entry group mask, `MPCLoop.run`
over `walking_schedule(ticks, vx=0.25, start=10)` from the nominal state.
Prints, for each, the initial CoM height z0, the lowest and highest CoM
height over the ticks, the forward progress of the CoM from the first
tick to the last, and the largest final defect norm of a tick.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if sys.argv[1] == "f64":
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _line_feet_quadruped import LINE_FEET_TOPOLOGY, line_feet_trot_mask  # noqa: E402
from _torch_parity import j_line_feet_quadruped  # noqa: E402
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions  # noqa: E402
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig  # noqa: E402
from srbd_horizon_tpu.problems.lip import build_lip_problem  # noqa: E402
from srbd_horizon_tpu.problems.srbd import build_srbd_problem  # noqa: E402
from srbd_horizon_tpu.runtime.loop import MPCLoop as JMPCLoop  # noqa: E402
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking  # noqa: E402
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP  # noqa: E402
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG  # noqa: E402


def main(dt, ticks, vx=0.25, start=10):
    dtype = jnp.float32 if dt == "f32" else jnp.float64
    cfg = JSRBDConfig(dtype=dtype, **LINE_FEET_TOPOLOGY)
    for name, build, iters in (("srbd", build_srbd_problem, 5),
                               ("lip", build_lip_problem, 100)):
        p = build(cfg, j_line_feet_quadruped())
        opts = JDDPOptions(max_iters=iters, alpha_converge_threshold=1e-12,
                           beta=1e-3)
        wpg = JWPG.build(float(p.initial_foot_position[0, 2]), p.ocp.ns,
                         dtype=dtype, group_mask=line_feet_trot_mask(),
                         contact_model=cfg.contact_model,
                         number_of_legs=cfg.number_of_legs)
        kw = dict(srbd_constants=p.ocp.constants) if name == "srbd" else {}
        loop = JMPCLoop(solver=JMSDDP(p.ocp, opts), wpg=wpg, **kw)
        _, o = jax.jit(loop.run)(loop.init(p.initial_state),
                                 j_walking(ticks, vx=vx, start=start,
                                           dtype=dtype))
        com = np.asarray(o.x)[:, :3]
        z0 = float(p.initial_state[2])
        print(f"{name}: z0 {z0!r}; CoM z min {float(com[:, 2].min())!r} max "
              f"{float(com[:, 2].max())!r} (largest |z - z0| "
              f"{float(np.abs(com[:, 2] - z0).max())!r}); progress "
              f"{float(com[-1, 0] - com[0, 0])!r} m; defect_norm max "
              f"{float(np.asarray(o.defect_norm).max())!r}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
