"""Franka Panda binding (port of ``sigsvgd_tpu/models/robot/panda.py``):
7 actuated joints, 9 tracked links. Reads the repository's vendored
``robot_resources/panda/urdf/panda.urdf`` unless given another path.

The end-effector Jacobian is exact, from autograd: three reverse passes
through the batched FK, one a coordinate (the JAX package takes
``vmap(jacfwd)``; the batch rows are independent, so either gives the same
matrix). The damped-least-squares IK is a Python loop where JAX scans."""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..._device import resolve_device
from ...utils.math import clip
from .kinematics import fk_poses, fk_positions
from .urdf import KinematicChain, parse_urdf

_VENDORED_URDF = (
    Path(__file__).resolve().parents[3] / "robot_resources/panda/urdf/panda.urdf"
)

TARGET_LINKS = (
    "panda_link1",
    "panda_link2",
    "panda_link3",
    "panda_link4",
    "panda_link5",
    "panda_link6",
    "panda_link7",
    "panda_link8",
    "panda_hand",
)
TARGET_JOINTS = tuple(f"panda_joint{i}" for i in range(1, 8))


def _find_urdf(urdf_path: Optional[str]) -> Path:
    path = Path(urdf_path) if urdf_path else _VENDORED_URDF
    if not path.exists():
        raise FileNotFoundError(f"Panda URDF not found at {path}")
    return path


@dataclasses.dataclass(frozen=True, eq=False)
class PandaRobot:
    """Static Panda description + batched FK helpers on ``device``."""

    chain: KinematicChain
    target_link_indices: Tuple[int, ...]
    device: torch.device

    @staticmethod
    def create(urdf_path: Optional[str] = None, device=None) -> "PandaRobot":
        chain = parse_urdf(_find_urdf(urdf_path))
        if chain.actuated_names[:7] != TARGET_JOINTS:
            raise ValueError(f"unexpected Panda joints {chain.actuated_names}")
        idx = tuple(chain.link_index(l) for l in TARGET_LINKS)
        return PandaRobot(chain=chain, target_link_indices=idx,
                          device=resolve_device(device))

    @property
    def dof(self) -> int:
        return 7

    def joint_limits(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.tensor(self.chain.lower[:7], dtype=torch.float32,
                         device=self.device),
            torch.tensor(self.chain.upper[:7], dtype=torch.float32,
                         device=self.device),
        )

    def velocity_limits(self) -> torch.Tensor:
        """Per-joint speed limits from the URDF (the published MoveIt
        ``joint_limits.yaml`` plus the URDF's 10% margin)."""
        return torch.tensor(self.chain.velocity[:7], dtype=torch.float32,
                            device=self.device)

    def _pad_q(self, qs: torch.Tensor) -> torch.Tensor:
        """Pad a 7-dof configuration with zeros for the finger joints."""
        extra = self.chain.dof - qs.shape[-1]
        if extra > 0:
            pad = torch.zeros(qs.shape[:-1] + (extra,), dtype=qs.dtype,
                              device=qs.device)
            qs = torch.cat([qs, pad], dim=-1)
        return qs

    def qs_to_joints_xs(self, qs: torch.Tensor) -> torch.Tensor:
        """``[..., 7] → [..., 9, 3]`` positions of the target links."""
        return fk_positions(self.chain, self._pad_q(qs), self.target_link_indices)

    def ee_position(self, qs: torch.Tensor) -> torch.Tensor:
        return self.qs_to_joints_xs(qs)[..., -1, :]

    def ee_pose(self, qs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """End-effector position ``[..., 3]`` and rotation ``[..., 3, 3]``."""
        pos, rot = fk_poses(self.chain, self._pad_q(qs))
        i = self.target_link_indices[-1]
        return pos[..., i, :], rot[..., i, :, :]

    def jacobian(self, q: torch.Tensor) -> torch.Tensor:
        """Positional Jacobian of the end effector, ``[..., 3, 7]`` (exact)."""
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            ee = self.ee_position(qq)
            rows = [torch.autograd.grad(ee[..., i].sum(), qq, retain_graph=i < 2)[0]
                    for i in range(3)]
        return torch.stack(rows, dim=-2)

    def ee_xs_to_qs(self, xs: torch.Tensor, q_init: Optional[torch.Tensor] = None,
                    iters: int = 100, lr: float = 0.5) -> torch.Tensor:
        """Batched damped-least-squares IK: ``[..., 3]`` targets → ``[..., 7]``
        configurations. Each iteration solves ``(J Jᵀ + 1e-4 I) y = err``,
        steps ``q += lr·Jᵀy`` and clips ``q`` to the joint limits; the start
        is the middle of the limits unless ``q_init`` is given."""
        xs = torch.atleast_2d(xs)
        lower, upper = (t.to(xs.device) for t in self.joint_limits())
        shape = xs.shape[:-1] + (7,)
        q = (0.5 * (lower + upper) if q_init is None else q_init).expand(shape)
        eye = 1e-4 * torch.eye(3, dtype=xs.dtype, device=xs.device)
        for _ in range(iters):
            err = xs - self.ee_position(q)
            jac = self.jacobian(q)
            jjt = jac @ jac.transpose(-1, -2) + eye
            y = torch.linalg.solve(jjt, err[..., None])[..., 0]
            dq = torch.einsum("...ij,...i->...j", jac, y)
            q = clip(q + lr * dq, lower, upper).detach()
        return q
