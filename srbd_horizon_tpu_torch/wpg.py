"""Walking pattern generator — the port of srbd_horizon_tpu/wpg.py.

The contact plan lives in the OCP parameter dict as (..., ns+1, ·)
tensors; one tick is `advance(params, wpg_state, action)`, which shifts
every scheduled parameter back one node and writes the terminal node
from precomputed gait cycle tables. Everything is batched over leading
axes: a fleet passes (B, ns+1, ·) params, a (B,) step counter and a (B,)
action, and each member follows its own action (STANCE 0, STEP 1,
JUMP 2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from srbd_horizon_tpu_torch.config import resolve_device

STANCE, STEP, JUMP = 0, 1, 2


class WPGState(NamedTuple):
    """Scheduler state: the gait phase counter (int32, (B,) for a fleet)."""

    step_counter: torch.Tensor


def _build_cycles(c_init_z: float, step_nodes: int, ss_share: float,
                  ds_share: float,
                  swing_profile: str = "reference") -> Tuple[np.ndarray, ...]:
    """Left/right step cycles: [ds, swing(ss), ds, stance(ss), pad] and the
    mirror. "reference" takes the swing apex 0.1·sin from a 50-sample
    linspace indexed at k+1; "smooth" spreads the same apex over the ss
    nodes actually used."""
    ss = int(ss_share * step_nodes)
    ds = int(ds_share * step_nodes)
    if swing_profile == "smooth":
        sin = 0.1 * np.sin(np.pi * np.arange(50) / (ss + 1))
    elif swing_profile == "reference":
        sin = 0.1 * np.sin(np.linspace(0, np.pi, 50))
    else:
        raise ValueError(f"unknown swing_profile {swing_profile!r}")

    def cycle(swing_first: bool):
        z, sw = [], []
        for phase in range(2):
            swinging = swing_first if phase == 0 else not swing_first
            z += [c_init_z] * ds
            sw += [1.0] * ds
            if swinging:
                z += [c_init_z + sin[k + 1] for k in range(ss)]
                sw += [0.0] * ss
            else:
                z += [c_init_z] * ss
                sw += [1.0] * ss
        z.append(c_init_z)
        sw.append(1.0)
        return np.array(z), np.array(sw)

    l_cycle, l_switch = cycle(swing_first=True)
    r_cycle, r_switch = cycle(swing_first=False)
    return l_cycle, l_switch, r_cycle, r_switch


_LEFT_MASKS: Dict[tuple, torch.Tensor] = {}


def _left_mask(group_mask: Optional[Tuple[bool, ...]], nc: int, cm: int,
               device) -> torch.Tensor:
    """The (nc,) bool mask of the contacts that follow the A-cycle, made
    once a device: `group_mask`, or the biped split (the first cm
    contacts). A host-to-device copy on each advance would stall the
    stream."""
    key = (group_mask if group_mask is not None else ("split", nc, cm),
           str(device))
    t = _LEFT_MASKS.get(key)
    if t is None:
        t = _LEFT_MASKS[key] = (
            torch.tensor(group_mask, device=device) if group_mask is not None
            else torch.arange(nc, device=device) < cm)
    return t


def _shift_nodes(a: torch.Tensor) -> torch.Tensor:
    """Node j moves to j−1 (node axis −2); the terminal node keeps its
    value."""
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


@dataclasses.dataclass(frozen=True)
class WalkingPatternGenerator:
    """Gait tables (on the device) and the per-tick advance."""

    nodes: int
    contact_model: int
    number_of_legs: int
    l_cycle: torch.Tensor
    l_switch: torch.Tensor
    r_cycle: torch.Tensor
    r_switch: torch.Tensor
    step_nodes: int
    stance_otg: float = 1e2
    # which contacts follow the A-cycle (l_cycle, which swings first); the
    # rest follow the B-cycle. None: the biped split, the first
    # `contact_model` contacts (the left foot). A (nc,) tuple of bools
    # gives another morphology the same two-phase alternation, e.g. the
    # quadruped's diagonal-pair trot (models/quadruped.py::trot_group_mask).
    group_mask: Optional[Tuple[bool, ...]] = None

    @staticmethod
    def build(
        c_init_z: float,
        nodes: int,
        contact_model: int = 2,
        number_of_legs: int = 2,
        step_duration: float = 0.5,
        dt: float = 0.05,
        ss_share: float = 0.8,
        ds_share: float = 0.2,
        dtype=torch.float32,
        group_mask=None,
        swing_profile: str = "reference",
        device="cuda",
    ) -> "WalkingPatternGenerator":
        dev = resolve_device(device)
        step_nodes = int(step_duration / dt)
        l_c, l_s, r_c, r_s = _build_cycles(
            c_init_z, step_nodes, ss_share, ds_share,
            swing_profile=swing_profile,
        )

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        return WalkingPatternGenerator(
            nodes=nodes,
            contact_model=contact_model,
            number_of_legs=number_of_legs,
            l_cycle=t(l_c),
            l_switch=t(l_s),
            r_cycle=t(r_c),
            r_switch=t(r_s),
            step_nodes=step_nodes,
            group_mask=(tuple(bool(g) for g in group_mask)
                        if group_mask is not None else None),
        )

    def init_state(self, batch=()) -> WPGState:
        return WPGState(step_counter=torch.zeros(
            batch, dtype=torch.int32, device=self.l_cycle.device))

    def advance(
        self,
        params: Dict[str, torch.Tensor],
        state: WPGState,
        action: torch.Tensor,
        terrain_z=0.0,
    ) -> Tuple[Dict[str, torch.Tensor], WPGState]:
        """One `steps_phase.set(action)` tick for every member: shift
        c_ref/cdot_switch one node back, then write the terminal node
        (c_ref, cdot_switch, w_ref ← 0, orientation_tracking_gain).

        `terrain_z` (a Python scalar, or a tensor of one value a member on
        the WPG's device) offsets the written contact-height references, as
        the JAX package's `advance` does (srbd_horizon_tpu/wpg.py:197-220):
        added to the step action's terminal c_ref, written in place of 0 in
        stance; the jump action keeps the shifted c_ref."""
        nc = self.contact_model * self.number_of_legs
        ns = self.nodes
        cm = self.contact_model
        ref_id = (state.step_counter % (2 * self.step_nodes)).long()

        p = dict(params)
        p["c_ref"] = _shift_nodes(p["c_ref"])
        p["cdot_switch"] = _shift_nodes(p["cdot_switch"])
        dtype = p["c_ref"].dtype
        dev = p["c_ref"].device
        is_left = _left_mask(self.group_mask, nc, cm, dev)
        act = action.to(torch.int64)[..., None]              # (..., 1)
        # a scalar stays on the host; a tensor is already on the WPG's device
        tz = (terrain_z.to(dtype)[..., None] if torch.is_tensor(terrain_z)
              else terrain_z)

        step_c = torch.where(
            is_left, self.l_cycle[ref_id][..., None], self.r_cycle[ref_id][..., None]
        ).to(dtype) + tz
        step_s = torch.where(
            is_left, self.l_switch[ref_id][..., None], self.r_switch[ref_id][..., None]
        ).to(dtype)
        jump_c = p["c_ref"][..., ns, :]
        stance_c = torch.zeros_like(step_c) + tz

        c_ref_T = torch.where(act == STEP, step_c,
                              torch.where(act == JUMP, jump_c, stance_c))
        switch_T = torch.where(act == JUMP, torch.zeros_like(step_s),
                               torch.where(act == STEP, step_s,
                                           torch.ones_like(step_s)))
        otg_T = torch.where(
            act == JUMP,
            torch.zeros((), dtype=dtype, device=dev),
            torch.full((), self.stance_otg, dtype=dtype, device=dev),
        )

        p["c_ref"] = _set_terminal(p["c_ref"], c_ref_T)
        p["cdot_switch"] = _set_terminal(p["cdot_switch"], switch_T)
        if "w_ref" in p:
            p["w_ref"] = _set_terminal(
                p["w_ref"], torch.zeros_like(p["w_ref"][..., ns, :]))
        if "orientation_tracking_gain" in p:
            p["orientation_tracking_gain"] = _set_terminal(
                p["orientation_tracking_gain"],
                otg_T.expand_as(p["orientation_tracking_gain"][..., ns, :]),
            )
        return p, WPGState(step_counter=state.step_counter + 1)


def _set_terminal(a: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """`a` with its last node replaced by `row` (out of place)."""
    return torch.cat([a[..., :-1, :], row[..., None, :].to(a.dtype)], dim=-2)


def shift_reference_params(params: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    """Receding-horizon shift of the teleop reference params: node j moves
    to j−1, the terminal node keeps its value (the caller overwrites it)."""
    out = dict(params)
    for name in names:
        if name in out:
            out[name] = _shift_nodes(out[name])
    return out
