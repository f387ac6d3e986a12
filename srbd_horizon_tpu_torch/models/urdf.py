"""URDF → reduced-model constants: the port's own copy of the JAX
package's srbd_horizon_tpu/models/urdf.py (numpy and `xml.etree` only).

Total mass, CoM, composite rotational inertia about the CoM, and
contact-frame forward kinematics at a nominal configuration, optionally
re-based so that a chosen link is the world frame — the quantities the
reference reads from casadi_kin_dyn/Pinocchio at startup. The native
extractor `tools/urdf_constants` (C++) computes the same; `run_native_tool`
calls it and parses its JSON.
"""

from __future__ import annotations

import json
import subprocess
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants


def _rpy_matrix(r, p, y):
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _axis_angle(a, th):
    a = np.asarray(a, float)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _origin(el) -> np.ndarray:
    T = np.eye(4)
    if el is None:
        return T
    xyz = np.fromstring(el.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(el.get("rpy", "0 0 0"), sep=" ")
    T[:3, :3] = _rpy_matrix(*rpy)
    T[:3, 3] = xyz
    return T


class URDFModel:
    def __init__(self, urdf_text: str):
        robot = ET.fromstring(urdf_text)
        self.links: Dict[str, dict] = {}
        self.joints: List[dict] = []
        children = set()
        for el in robot:
            if el.tag == "link":
                link = dict(name=el.get("name"), mass=0.0,
                            inertia=np.zeros((3, 3)), origin=np.eye(4))
                inertial = el.find("inertial")
                if inertial is not None:
                    link["origin"] = _origin(inertial.find("origin"))
                    m = inertial.find("mass")
                    if m is not None:
                        link["mass"] = float(m.get("value", 0))
                    I = inertial.find("inertia")
                    if I is not None:
                        g = lambda k: float(I.get(k, 0))
                        link["inertia"] = np.array(
                            [
                                [g("ixx"), g("ixy"), g("ixz")],
                                [g("ixy"), g("iyy"), g("iyz")],
                                [g("ixz"), g("iyz"), g("izz")],
                            ]
                        )
                self.links[link["name"]] = link
            elif el.tag == "joint":
                a = el.find("axis")
                self.joints.append(
                    dict(
                        name=el.get("name"),
                        type=el.get("type"),
                        parent=el.find("parent").get("link"),
                        child=el.find("child").get("link"),
                        origin=_origin(el.find("origin")),
                        axis=np.fromstring(
                            a.get("xyz", "1 0 0") if a is not None else "1 0 0",
                            sep=" ",
                        ),
                    )
                )
                children.add(el.find("child").get("link"))
        roots = [n for n in self.links if n not in children]
        self.root = roots[0]

    def fk(self, q: Sequence[float]) -> Dict[str, np.ndarray]:
        """World transform per link; q holds values for non-fixed joints in
        document order (matching the C++ tool)."""
        q = list(q)
        qi = {}
        k = 0
        for j in self.joints:
            if j["type"] != "fixed":
                qi[j["name"]] = k
                k += 1
        T = {self.root: np.eye(4)}
        remaining = list(self.joints)
        while remaining:
            progressed = []
            for j in remaining:
                if j["parent"] not in T:
                    continue
                Tj = T[j["parent"]] @ j["origin"]
                v = q[qi[j["name"]]] if j["name"] in qi and qi[j["name"]] < len(q) else 0.0
                if j["type"] in ("revolute", "continuous"):
                    R = np.eye(4)
                    R[:3, :3] = _axis_angle(j["axis"], v)
                    Tj = Tj @ R
                elif j["type"] == "prismatic":
                    P = np.eye(4)
                    P[:3, 3] = j["axis"] * v
                    Tj = Tj @ P
                T[j["child"]] = Tj
                progressed.append(j)
            if not progressed:
                break
            for j in progressed:
                remaining.remove(j)
        return T

    def constants(self, q: Sequence[float], frames: Sequence[str],
                  world_frame: Optional[str] = None) -> dict:
        T = self.fk(q)
        if world_frame:
            W = np.linalg.inv(T[world_frame])
            T = {k: W @ t for k, t in T.items()}
        mass, com = 0.0, np.zeros(3)
        for name, link in self.links.items():
            if link["mass"] <= 0 or name not in T:
                continue
            Ti = T[name] @ link["origin"]
            mass += link["mass"]
            com += link["mass"] * Ti[:3, 3]
        com = com / mass if mass > 0 else com
        I = np.zeros((3, 3))
        for name, link in self.links.items():
            if link["mass"] <= 0 or name not in T:
                continue
            Ti = T[name] @ link["origin"]
            R = Ti[:3, :3]
            r = Ti[:3, 3] - com
            I += R @ link["inertia"] @ R.T + link["mass"] * (
                np.dot(r, r) * np.eye(3) - np.outer(r, r)
            )
        return dict(
            mass=mass,
            com=com,
            inertia=I,
            frames={f: T[f][:3, 3] for f in frames if f in T},
        )


def load_robot_constants(urdf_path: str, joints: Sequence[float],
                         foot_frames: Sequence[str],
                         world_frame: Optional[str] = None) -> RobotConstants:
    """Build RobotConstants from a URDF file (pure-Python path)."""
    model = URDFModel(Path(urdf_path).read_text())
    c = model.constants(joints, foot_frames, world_frame)
    return RobotConstants(
        mass=float(c["mass"]),
        inertia=np.asarray(c["inertia"]),
        com=np.asarray(c["com"]),
        foot_positions=np.stack([c["frames"][f] for f in foot_frames]),
        foot_frames=tuple(foot_frames),
    )


def run_native_tool(urdf_path: str, joints: Sequence[float],
                    frames: Sequence[str],
                    world_frame: Optional[str] = None,
                    tool_path: Optional[str] = None) -> dict:
    """Invoke the C++ extractor `tools/urdf_constants` of this repository
    (or `tool_path`) and parse its JSON."""
    tool = tool_path or str(
        Path(__file__).resolve().parents[2]
        / "tools" / "urdf_constants" / "urdf_constants"
    )
    cmd = [tool, str(urdf_path)]
    if joints:
        cmd += ["--joints", ",".join(str(v) for v in joints)]
    if frames:
        cmd += ["--frames", ",".join(frames)]
    if world_frame:
        cmd += ["--world-frame", world_frame]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return json.loads(out.stdout)
