"""One robot's walk under an execution mode, in the JAX package and in the
port (its plain twins), on the CPU: the defect trace the port's
`chip_smoke.py` walks under the modes (phase 15) are read against. Not
collected by pytest (a 40-tick JAX run compiles for a minute); run by
hand:

    JAX_PLATFORMS=cpu python tests/modes_walk_reference.py \\
        point_feet EULER f64 associative linear 40

`topology` kangaroo (line feet), quadruped (point feet, the trot WPG) or
point_feet (the biped); `step` EULER, RK2 or RK4. The dsrbd example's
options (max_iters=100; the quadruped example's max_iters=5 on the
quadruped) under the mode, `MPCLoop.run` over `walking_schedule(ticks,
vx=0.3 (0.25 on the quadruped), start=5)` from the nominal state. Prints,
for each package, the largest final defect norm of a tick and its tick,
and the iterations of every tick.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if sys.argv[3] == "f64":
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import TOPOLOGIES  # noqa: E402
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions  # noqa: E402
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig  # noqa: E402
from srbd_horizon_tpu.problems.srbd import build_srbd_problem  # noqa: E402
from srbd_horizon_tpu.runtime.loop import MPCLoop as JMPCLoop  # noqa: E402
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking  # noqa: E402
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP  # noqa: E402
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG  # noqa: E402
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig  # noqa: E402
from srbd_horizon_tpu_torch.runtime.loop import (  # noqa: E402
    build_quadruped_loop,
    build_srbd_loop,
    walking_schedule,
)


def main(topology, step, dt, riccati_mode, forward_pass, ticks):
    kw, jrobot, trobot, mask = TOPOLOGIES[topology]
    quad = topology == "quadruped"
    opts = dict(max_iters=5 if quad else 100, alpha_converge_threshold=1e-12,
                beta=1e-3, riccati_mode=riccati_mode,
                forward_pass=forward_pass)
    vx = 0.25 if quad else 0.3
    jdtype = jnp.float32 if dt == "f32" else jnp.float64
    tdtype = torch.float32 if dt == "f32" else torch.float64
    # the JAX package: the port's build_srbd_loop / build_quadruped_loop
    # recipe, spelled out
    jp = build_srbd_problem(JSRBDConfig(dtype=jdtype, **kw), jrobot(),
                            integrator=step)
    wpg = JWPG.build(float(jp.initial_foot_position[0, 2]), jp.ocp.ns,
                     dtype=jdtype,
                     group_mask=mask,
                     contact_model=kw.get("contact_model", 2),
                     number_of_legs=kw.get("number_of_legs", 2))
    jloop = JMPCLoop(solver=JMSDDP(jp.ocp, JDDPOptions(**opts)), wpg=wpg,
                     srbd_constants=jp.ocp.constants)
    _, jo = jax.jit(jloop.run)(jloop.init(jp.initial_state),
                              j_walking(ticks, vx=vx, start=5, dtype=jdtype))
    # the port, its plain twins on the CPU
    cfg = SRBDConfig(dtype=tdtype, **kw)
    if quad:
        tloop, tp = build_quadruped_loop(cfg, DDPOptions(**opts),
                                         device="cpu", integrator=step)
    else:
        tloop, tp = build_srbd_loop(cfg, DDPOptions(**opts), robot=trobot(),
                                    shift_warmstart=False, device="cpu",
                                    integrator=step)
    _, to = tloop.run(tloop.init(tp.initial_state),
                      walking_schedule(ticks, vx=vx, start=5, dtype=tdtype,
                                       device="cpu"))
    for name, o in (("jax", jo), ("port", to)):
        d = np.asarray(o.defect_norm if name == "jax"
                       else o.defect_norm.numpy())
        its = np.asarray(o.iterations if name == "jax"
                         else o.iterations.numpy())
        print(f"{name}: defect_norm max {float(d.max())!r} at tick "
              f"{int(d.argmax())}; iterations {its.tolist()}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5],
         int(sys.argv[6]))
