"""Importer of MoveIt-format robot data (port of
``sigsvgd_tpu/models/robot/robodata.py``): planning-scene YAML files into a
:class:`Scene`, MotionPlanRequest files into a :class:`PathRequest` and
RobotTrajectory files into joint positions.

Conventions translated:
  * MoveIt quaternions are ``[x, y, z, w]``; a primitive's pose composes
    the object's base pose with its own, ``world = base ∘ local``.
  * ``box`` dimensions are full extents (here too); ``cylinder`` dimensions
    are ``[height, radius]`` (here ``(radius, half_height)``); ``sphere``
    dimensions are ``[radius]``.
  * embedded meshes (vertex and triangle lists) are written as STL files
    beside the scene file (or into ``mesh_dir``) and become posed
    :class:`MeshObstacle` entries.

PyYAML is imported when a file is read.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..._device import resolve_device
from .mesh_scene import MeshObstacle, write_stl
from .scene import PathRequest, Primitive, Scene


def _load_yaml(path: Path):
    import yaml

    return yaml.safe_load(Path(path).read_text())


def _quat_to_rot(q) -> np.ndarray:
    """MoveIt ``[x, y, z, w]`` quaternion → row-major 3×3 rotation."""
    x, y, z, w = (float(v) for v in q)
    n = (x * x + y * y + z * z + w * w) ** 0.5
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _pose(obj_pose) -> Tuple[np.ndarray, np.ndarray]:
    pos = np.asarray([float(v) for v in obj_pose["position"]], np.float64)
    return pos, _quat_to_rot(obj_pose["orientation"])


def _compose(base: Tuple[np.ndarray, np.ndarray], local: Tuple[np.ndarray, np.ndarray]):
    bp, br = base
    lp, lr = local
    return bp + br @ lp, br @ lr


def _floats(v) -> Tuple[float, ...]:
    return tuple(float(x) for x in np.asarray(v).reshape(-1))


def load_moveit_scene(path: str | Path, name: Optional[str] = None,
                      workspace_low: Tuple[float, float, float] = (-1.0, -1.0, 0.0),
                      workspace_high: Tuple[float, float, float] = (1.0, 1.0, 1.5),
                      mesh_dir: Optional[str | Path] = None, device=None) -> Scene:
    """A MoveIt planning-scene YAML as a :class:`Scene` on ``device`` (the
    card unless the CPU is asked for)."""
    path = Path(path)
    d = _load_yaml(path)
    prims: List[Primitive] = []
    meshes: List[MeshObstacle] = []
    mesh_dir = Path(mesh_dir) if mesh_dir is not None else path.parent
    for obj in d["world"]["collision_objects"]:
        base = _pose(obj["pose"]) if "pose" in obj else (np.zeros(3), np.eye(3))
        if "primitives" in obj:
            for prim, ppose in zip(obj["primitives"], obj["primitive_poses"]):
                pos, rot = _compose(base, _pose(ppose))
                kind = prim["type"]
                dim = [float(v) for v in prim["dimensions"]]
                if kind == "box":
                    size: Tuple[float, ...] = tuple(dim)  # full extents
                elif kind == "cylinder":
                    size = (dim[1], dim[0] / 2.0)  # [h, r] -> (r, half_h)
                elif kind == "sphere":
                    size = (dim[0],)
                else:
                    raise NotImplementedError(f"primitive type {kind!r}")
                prims.append(Primitive(kind, _floats(pos), size, _floats(rot)))
        elif "meshes" in obj:
            for i, (mesh, mpose) in enumerate(zip(obj["meshes"], obj["mesh_poses"])):
                pos, rot = _compose(base, _pose(mpose))
                verts = np.asarray(mesh["vertices"], np.float64)
                tris = np.asarray(mesh["triangles"], np.int64)
                stl = mesh_dir / f"{path.stem}-{obj.get('id', 'mesh')}-{i}.stl"
                write_stl(stl, verts[tris.reshape(-1, 3)].reshape(-1, 3, 3))
                meshes.append(MeshObstacle(path=str(stl), position=_floats(pos),
                                           rot=_floats(rot)))
        else:
            raise NotImplementedError(
                f"collision object without primitives/meshes: {obj.keys()}")
    return Scene(name=name or path.stem, primitives=tuple(prims),
                 workspace_low=workspace_low, workspace_high=workspace_high,
                 device=resolve_device(device), meshes=tuple(meshes))


def load_moveit_request(path: str | Path,
                        joint_names: Optional[List[str]] = None) -> PathRequest:
    """A MoveIt MotionPlanRequest YAML as a :class:`PathRequest`.
    ``joint_names`` selects and orders the joints (by default the goal
    constraints' order)."""
    d = _load_yaml(path)
    js = d["start_state"]["joint_state"]
    start = dict(zip(js["name"], (float(v) for v in js["position"])))
    goal = {j["joint_name"]: float(j["position"])
            for j in d["goal_constraints"][0]["joint_constraints"]}
    names = joint_names if joint_names is not None else list(goal.keys())
    return PathRequest(start=tuple(start[nm] for nm in names),
                       target=tuple(goal[nm] for nm in names))


def load_moveit_trajectory(path: str | Path,
                           joint_names: Optional[List[str]] = None) -> np.ndarray:
    """A MoveIt RobotTrajectory YAML as ``[T, dof]`` joint positions."""
    jt = _load_yaml(path)["joint_trajectory"]
    names = jt["joint_names"]
    pts = np.asarray([[float(v) for v in p["positions"]] for p in jt["points"]], np.float32)
    if joint_names is not None:
        pts = pts[:, [names.index(nm) for nm in joint_names]]
    return pts
