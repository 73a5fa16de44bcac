"""URDF → static kinematic-chain arrays (the port's own copy of
``sigsvgd_tpu/models/robot/urdf.py``, numpy only).

The URDF is parsed ONCE on the host into flat numpy arrays (per-joint fixed
transforms, axes, types, parent indices in topological order); batched FK is
then a compose over those constants (see ``kinematics.py``).

Only the kinematic fields are read (joints, origins, axes, limits); meshes are
referenced by path for the host-side collision verifier.
"""
from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2

_TYPE_MAP = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
}


def rpy_to_matrix(r: float, p: float, y: float) -> np.ndarray:
    """URDF fixed-axis RPY convention: ``R = Rz(y) @ Ry(p) @ Rx(r)``."""
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _origin_transform(elem: Optional[ET.Element]) -> np.ndarray:
    t = np.eye(4)
    if elem is None:
        return t
    xyz = [float(v) for v in elem.get("xyz", "0 0 0").split()]
    rpy = [float(v) for v in elem.get("rpy", "0 0 0").split()]
    t[:3, :3] = rpy_to_matrix(*rpy)
    t[:3, 3] = xyz
    return t


@dataclasses.dataclass(frozen=True, eq=False)
class KinematicChain:
    """Flat, topologically-ordered joint arrays for one URDF robot.

    Joint ``j`` moves ``child_link[j]``; its parent link's pose is found via
    ``parent_joint[j]`` (−1 ⇒ the base link). ``q_index[j]`` maps actuated
    joints to columns of the configuration vector (−1 for fixed joints).
    """

    name: str
    base_link: str
    joint_names: Tuple[str, ...]
    child_links: Tuple[str, ...]  # link moved by each joint, in topo order
    parent_joint: np.ndarray  # [J] int, index of parent joint or -1
    origins: np.ndarray  # [J, 4, 4] fixed parent→joint transforms
    axes: np.ndarray  # [J, 3]
    joint_types: np.ndarray  # [J] int
    q_index: np.ndarray  # [J] int
    actuated_names: Tuple[str, ...]
    lower: np.ndarray  # [dof]
    upper: np.ndarray  # [dof]
    velocity: np.ndarray  # [dof] joint speed limits (inf if unspecified)
    collision_meshes: Tuple[Tuple[str, str], ...]  # (link_name, mesh_path)

    @property
    def dof(self) -> int:
        return len(self.actuated_names)

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    def link_index(self, link_name: str) -> int:
        return self.child_links.index(link_name)


def parse_urdf(
    path: str | Path,
    base_transform: Optional[np.ndarray] = None,
) -> KinematicChain:
    """Parse a URDF file into a :class:`KinematicChain`.

    ``base_transform`` optionally reroots the robot (the reference sets start
    position/orientation on the base body, ``robot_simulator.py:46-51``).
    """
    path = Path(path)
    root = ET.fromstring(path.read_text())
    robot_name = root.get("name", path.stem)

    joints_raw = []
    child_of: Dict[str, str] = {}
    for j in root.findall("joint"):
        jtype = j.get("type", "fixed")
        if jtype not in _TYPE_MAP:
            jtype = "fixed"  # planar/floating unsupported; treat as fixed
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        axis_elem = j.find("axis")
        axis = (
            np.array([float(v) for v in axis_elem.get("xyz").split()])
            if axis_elem is not None
            else np.array([1.0, 0.0, 0.0])
        )
        limit = j.find("limit")
        lo = float(limit.get("lower", "-inf")) if limit is not None else -np.inf
        hi = float(limit.get("upper", "inf")) if limit is not None else np.inf
        vel = float(limit.get("velocity", "inf")) if limit is not None else np.inf
        joints_raw.append(
            dict(
                name=j.get("name"),
                type=_TYPE_MAP[jtype],
                parent=parent,
                child=child,
                origin=_origin_transform(j.find("origin")),
                axis=axis,
                lower=lo,
                upper=hi,
                velocity=vel,
            )
        )
        child_of[child] = j.get("name")

    # base link: a link that is never a child
    all_links = {l.get("name") for l in root.findall("link")}
    children = set(child_of.keys())
    bases = all_links - children
    base_link = sorted(bases)[0] if bases else next(iter(all_links))

    # topological order: BFS from the base
    by_parent: Dict[str, List[dict]] = {}
    for jr in joints_raw:
        by_parent.setdefault(jr["parent"], []).append(jr)
    ordered: List[dict] = []
    frontier = [base_link]
    while frontier:
        link = frontier.pop(0)
        for jr in by_parent.get(link, []):
            ordered.append(jr)
            frontier.append(jr["child"])

    name_to_idx = {jr["name"]: i for i, jr in enumerate(ordered)}
    link_to_joint = {jr["child"]: name_to_idx[jr["name"]] for jr in ordered}

    q_index = np.full(len(ordered), -1, dtype=np.int32)
    actuated, lowers, uppers, vels = [], [], [], []
    for i, jr in enumerate(ordered):
        if jr["type"] != JOINT_FIXED:
            q_index[i] = len(actuated)
            actuated.append(jr["name"])
            lowers.append(jr["lower"])
            uppers.append(jr["upper"])
            vels.append(jr["velocity"])

    origins = np.stack([jr["origin"] for jr in ordered])
    if base_transform is not None:
        # reroot: premultiply the base-adjacent joints
        for i, jr in enumerate(ordered):
            if jr["parent"] == base_link:
                origins[i] = base_transform @ origins[i]

    parent_joint = np.array(
        [link_to_joint.get(jr["parent"], -1) for jr in ordered], dtype=np.int32
    )

    meshes = []
    for link in root.findall("link"):
        for col in link.findall("collision"):
            geom = col.find("geometry")
            mesh = geom.find("mesh") if geom is not None else None
            if mesh is not None:
                meshes.append((link.get("name"), mesh.get("filename")))

    return KinematicChain(
        name=robot_name,
        base_link=base_link,
        joint_names=tuple(jr["name"] for jr in ordered),
        child_links=tuple(jr["child"] for jr in ordered),
        parent_joint=parent_joint,
        origins=origins,
        axes=np.stack([jr["axis"] for jr in ordered]),
        joint_types=np.array([jr["type"] for jr in ordered], dtype=np.int32),
        q_index=q_index,
        actuated_names=tuple(actuated),
        lower=np.array(lowers),
        upper=np.array(uppers),
        velocity=np.array(vels),
        collision_meshes=tuple(meshes),
    )
