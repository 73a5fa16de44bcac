"""Mesh-level trajectory verification (port of
``sigsvgd_tpu/experiments/verify_mesh.py``).

Audits configurations against the robot's own STL collision meshes: the
least mesh-to-mesh distance over the SRDF-enabled link pairs (the C++ BVH
engine, ``native/collision.py``) and the least scene SDF over points
sampled on the links' surfaces. FK runs on the robot's device for every
waypoint at once and the poses are fetched once; the mesh distances come
from the host.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.robot.kinematics import fk_poses
from ..models.robot.panda import PandaRobot
from ..models.robot.scene import Scene, scene_sdf
from ..native.collision import MeshCollisionEngine, TriMesh

# SRDF-enabled link pairs (the complement of panda.srdf's disable_collisions)
SRDF_CHECK_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("panda_link0", "panda_link5"),
    ("panda_link0", "panda_link6"),
    ("panda_link0", "panda_link7"),
    ("panda_link0", "panda_hand"),
    ("panda_link1", "panda_link5"),
    ("panda_link1", "panda_link6"),
    ("panda_link1", "panda_link7"),
    ("panda_link1", "panda_hand"),
    ("panda_link2", "panda_link5"),
    ("panda_link2", "panda_link7"),
    ("panda_link2", "panda_hand"),
    ("panda_link5", "panda_link7"),
    ("panda_link5", "panda_hand"),
)

_REPO_ROOT = Path(__file__).resolve().parents[2]

Pose = Tuple[np.ndarray, np.ndarray]


def _resolve_mesh_path(urdf_mesh_path: str) -> Optional[Path]:
    """A URDF mesh path (``package://`` paths from the repository root)."""
    if urdf_mesh_path.startswith("package://"):
        cand = _REPO_ROOT / urdf_mesh_path[len("package://"):]
        return cand if cand.exists() else None
    p = Path(urdf_mesh_path)
    return p if p.exists() else None


class PandaMeshVerifier:
    """Loads the Panda's collision meshes once; audits configurations."""

    def __init__(self, robot: PandaRobot, surface_samples: int = 300):
        self.robot = robot
        self.mesh_paths: Dict[str, str] = {}
        for link, mpath in robot.chain.collision_meshes:
            resolved = _resolve_mesh_path(mpath)
            if resolved is not None:
                self.mesh_paths[link] = str(resolved)
        self.engine = MeshCollisionEngine(self.mesh_paths)
        # each link's surface points in its own frame, for the scene checks
        self.surface_pts = {link: TriMesh(p).surface_points(surface_samples)
                            for link, p in self.mesh_paths.items()}
        self.check_pairs = [(a, b) for a, b in SRDF_CHECK_PAIRS
                            if a in self.mesh_paths and b in self.mesh_paths]

    def _link_poses(self, qs: np.ndarray) -> List[Dict[str, Pose]]:
        """Every link's pose at each configuration of ``qs [T, dof]``: one FK
        on the robot's device, one fetch."""
        q = torch.as_tensor(np.asarray(qs, np.float32), device=self.robot.device)
        pos, rot = fk_poses(self.robot.chain, self.robot._pad_q(q))
        pos, rot = pos.cpu().numpy(), rot.cpu().numpy()
        base = (np.zeros(3), np.eye(3))
        return [{"panda_link0": base,
                 **{link: (pos[t, j], rot[t, j])
                    for j, link in enumerate(self.robot.chain.child_links)}}
                for t in range(len(q))]

    def _min_self(self, poses: Dict[str, Pose], margin: float) -> float:
        min_self = np.inf
        for a, b in self.check_pairs:
            d = self.engine.pairwise_distance(a, poses[a], b, poses[b], stop_below=margin)
            min_self = min(min_self, d)
            if min_self <= margin:
                break
        return float(min_self)

    def _min_env(self, poses: List[Dict[str, Pose]], scene: Optional[Scene]) -> np.ndarray:
        """Least scene SDF over the links' surface points at each pose, in
        one lookup on the scene's device (infinite without primitives, as
        in the JAX package)."""
        if scene is None or not scene.primitives:
            return np.full(len(poses), np.inf)
        world = np.stack([
            np.concatenate([pts @ p[link][1].T + p[link][0]
                            for link, pts in self.surface_pts.items()])
            for p in poses])
        sdf = scene_sdf(scene, torch.as_tensor(world, device=scene.device))
        return sdf.amin(dim=-1).cpu().numpy().astype(np.float64)

    def _row(self, poses, min_env: float, scene, margin: float) -> Dict[str, float]:
        min_self = self._min_self(poses, margin)
        # distances are unsigned: interpenetrating surfaces report ~0, never
        # negative, so a collision is contact within the margin (1 mm)
        return {"min_self_distance": min_self, "min_env_sdf": float(min_env),
                "self_collision": bool(min_self <= margin),
                "env_collision": bool(min_env <= margin) if scene else False}

    def audit_config(self, q: np.ndarray, scene: Optional[Scene] = None,
                     margin: float = 1e-3) -> Dict[str, float]:
        """One configuration: the least self-collision distance over the
        SRDF pairs and the least scene SDF over the links' surface points."""
        poses = self._link_poses(np.asarray(q)[None])
        return self._row(poses[0], self._min_env(poses, scene)[0], scene, margin)

    def audit_trajectory(self, qs: np.ndarray, scene: Optional[Scene] = None,
                         margin: float = 1e-3) -> Dict[str, np.ndarray]:
        """Each waypoint of a joint trajectory ``[T, dof]``: its collision
        flags, the share of colliding waypoints and whether none collides."""
        poses = self._link_poses(np.asarray(qs))
        min_env = self._min_env(poses, scene)
        rows = [self._row(p, e, scene, margin) for p, e in zip(poses, min_env)]
        env = np.array([r["env_collision"] for r in rows])
        self_c = np.array([r["self_collision"] for r in rows])
        return {"env_collision": env, "self_collision": self_c,
                "fraction_colliding": float((env | self_c).mean()),
                "collision_free": bool(not (env | self_c).any())}
