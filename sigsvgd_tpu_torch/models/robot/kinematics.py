"""Batched differentiable forward kinematics (port of
``sigsvgd_tpu/models/robot/kinematics.py``).

Rotations are carried in structure-of-arrays form: nine component tensors
instead of one ``[..., 3, 3]`` tensor. URDF origins and joint axes are
Python floats, so zero and one terms fold away when the chain is walked.
Gradients come from autograd.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .urdf import JOINT_PRISMATIC, JOINT_REVOLUTE, KinematicChain

# Rotations are 3x3 nested lists, positions length-3 lists; entries are
# Python floats (constants that fold) or batch-shaped tensors.


def _mul(a, b):
    if isinstance(a, float):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if isinstance(b, float):
            return a * b
    if isinstance(b, float):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def _add(a, b):
    if isinstance(a, float) and a == 0.0:
        return b
    if isinstance(b, float) and b == 0.0:
        return a
    return a + b


def _rot_mul(A, B):
    """C = A @ B on component lists."""
    return [
        [
            _add(
                _add(_mul(A[i][0], B[0][j]), _mul(A[i][1], B[1][j])),
                _mul(A[i][2], B[2][j]),
            )
            for j in range(3)
        ]
        for i in range(3)
    ]


def _rot_vec(A, v):
    return [
        _add(_add(_mul(A[i][0], v[0]), _mul(A[i][1], v[1])), _mul(A[i][2], v[2]))
        for i in range(3)
    ]


def _axis_rotation_components(axis: np.ndarray, q: torch.Tensor):
    """Rodrigues rotation about a constant unit axis, component form."""
    kx, ky, kz = (float(a) for a in axis)
    c = torch.cos(q)
    s = torch.sin(q)
    omc = 1.0 - c
    K = [[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]]
    k = [kx, ky, kz]
    out = []
    for i in range(3):
        row = []
        for j in range(3):
            e = _mul(omc, k[i] * k[j])
            if i == j:
                e = _add(e, c)
            e = _add(e, _mul(s, K[i][j]))
            row.append(e)
        out.append(row)
    return out


def _fk_components(chain: KinematicChain, q: torch.Tensor):
    """Walk the chain once; component-form ``(positions, rotations)`` of all
    joints in topological order."""
    rots = []
    poss = []
    for j in range(chain.n_joints):
        origin = np.asarray(chain.origins[j], np.float64)
        o_rot = [[float(origin[r, c]) for c in range(3)] for r in range(3)]
        o_pos = [float(origin[r, 3]) for r in range(3)]
        p = chain.parent_joint[j]
        if p < 0:
            parent_rot = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
            parent_pos = [0.0, 0.0, 0.0]
        else:
            parent_rot, parent_pos = rots[p], poss[p]

        rot = _rot_mul(parent_rot, o_rot)
        off = _rot_vec(parent_rot, o_pos)
        pos = [_add(parent_pos[i], off[i]) for i in range(3)]

        jtype = int(chain.joint_types[j])
        if jtype == JOINT_REVOLUTE:
            qj = q[..., chain.q_index[j]]
            rot = _rot_mul(rot, _axis_rotation_components(chain.axes[j], qj))
        elif jtype == JOINT_PRISMATIC:
            qj = q[..., chain.q_index[j]]
            axis = [float(a) for a in chain.axes[j]]
            slide = _rot_vec(rot, axis)
            pos = [_add(pos[i], _mul(qj, slide[i])) for i in range(3)]
        rots.append(rot)
        poss.append(pos)
    return poss, rots


def _as_tensor(e, q: torch.Tensor) -> torch.Tensor:
    batch = q.shape[:-1]
    if isinstance(e, float):
        return torch.full(batch, e, dtype=q.dtype, device=q.device)
    return e.to(q.dtype).expand(batch)


def fk_poses(chain: KinematicChain,
             q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-joint poses ``(positions [..., J, 3], rotations [..., J, 3, 3])``
    for ``q [..., dof]``, in topological order."""
    poss, rots = _fk_components(chain, q)
    positions = torch.stack(
        [torch.stack([_as_tensor(p[i], q) for i in range(3)], dim=-1)
         for p in poss],
        dim=-2,
    )
    rotations = torch.stack(
        [
            torch.stack(
                [torch.stack([_as_tensor(r[i][j], q) for j in range(3)], dim=-1)
                 for i in range(3)],
                dim=-2,
            )
            for r in rots
        ],
        dim=-3,
    )
    return positions, rotations


def fk_positions(chain: KinematicChain, q: torch.Tensor,
                 link_indices: Tuple[int, ...]) -> torch.Tensor:
    """Positions of selected links: ``q [..., dof] → [..., n_links, 3]``."""
    poss, _ = _fk_components(chain, q)
    return torch.stack(
        [torch.stack([_as_tensor(poss[k][i], q) for i in range(3)], dim=-1)
         for k in link_indices],
        dim=-2,
    )
