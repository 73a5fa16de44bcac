"""Capsule-based exact self-collision oracle for the Panda arm (port of
``sigsvgd_tpu/models/robot/self_collision.py``).

The arm is a small set of capsules anchored between FK frames, trimmed so
that kinematically adjacent capsules do not overlap, plus an oriented hand
capsule along the gripper's local y axis; the checked pairs are the SRDF's
enabled collision matrix collapsed onto the capsule groups. The margins are
differentiable, so the oracle labels the learned predictor's data, verifies
trajectories and can serve as an analytic cost.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ...utils.math import clip, safe_norm
from .kinematics import fk_poses
from .panda import PandaRobot


class Capsule(NamedTuple):
    """Segment between FK frames ``a → b`` trimmed to ``[ta, tb]`` with radius
    ``r``. Frame indices address ``[base, link1..link8, hand]`` positions."""

    a: int
    b: int
    ta: float
    tb: float
    r: float


# frames: 0 = base, 1..8 = panda_link1..8, 9 = hand
PANDA_CAPSULES = (
    Capsule(0, 1, 0.0, 1.0, 0.10),  # 0: base column
    Capsule(2, 3, 0.0, 1.0, 0.08),  # 1: upper arm
    Capsule(3, 4, 0.0, 1.0, 0.075),  # 2: elbow
    Capsule(4, 5, 0.15, 0.85, 0.07),  # 3: forearm (trimmed off the joints)
    Capsule(6, 7, 0.25, 1.0, 0.06),  # 4: wrist
    Capsule(7, 8, 0.35, 1.0, 0.055),  # 5: flange
)
# hand: oriented capsule along the gripper's local y axis
HAND_HALF_WIDTH = 0.09
HAND_RADIUS = 0.05

# checked pairs (capsule indices; 6 = hand)
PANDA_CHECK_PAIRS = (
    (0, 3), (0, 4), (0, 5), (0, 6),
    (1, 4), (1, 5), (1, 6),
    (2, 5), (2, 6),
    (3, 6),
)


def segment_distance(p0: torch.Tensor, p1: torch.Tensor, q0: torch.Tensor,
                     q1: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Minimum distance between segments ``[p0, p1]`` and ``[q0, q1]``
    (batched over leading dims; the clamped closest-point form)."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    f = torch.sum(d2 * r, -1)
    c = torch.sum(d1 * r, -1)
    b = torch.sum(d1 * d2, -1)
    denom = a * e - b * b
    s = torch.where(denom > eps, (b * f - c * e) / torch.clamp(denom, min=eps),
                    torch.zeros_like(denom))
    s = clip(s, 0.0, 1.0)
    t = (b * s + f) / torch.clamp(e, min=eps)
    t_cl = clip(t, 0.0, 1.0)
    # re-project s for the clamped t
    s = clip((b * t_cl - c) / torch.clamp(a, min=eps), 0.0, 1.0)
    closest1 = p0 + s[..., None] * d1
    closest2 = q0 + t_cl[..., None] * d2
    return safe_norm(closest1 - closest2)


def _capsule_endpoints(robot: PandaRobot, q: torch.Tensor):
    """Every capsule's endpoints and radius: ``(p0 [..., C, 3], p1, radii [C])``."""
    xs = robot.qs_to_joints_xs(q)  # [..., 9, 3]
    pts = torch.cat([torch.zeros_like(xs[..., :1, :]), xs], dim=-2)  # [..., 10, 3]

    p0s, p1s, radii = [], [], []
    for cap in PANDA_CAPSULES:
        a = pts[..., cap.a, :]
        b = pts[..., cap.b, :]
        p0s.append(a + cap.ta * (b - a))
        p1s.append(a + cap.tb * (b - a))
        radii.append(cap.r)

    # the oriented hand capsule from the hand frame's rotation
    pos, rot = fk_poses(robot.chain, robot._pad_q(q))
    hand_idx = robot.target_link_indices[-1]
    hand_pos = pos[..., hand_idx, :]
    hand_y = rot[..., hand_idx, :, 1]
    p0s.append(hand_pos - HAND_HALF_WIDTH * hand_y)
    p1s.append(hand_pos + HAND_HALF_WIDTH * hand_y)
    radii.append(HAND_RADIUS)

    return (torch.stack(p0s, -2), torch.stack(p1s, -2),
            torch.tensor(radii, dtype=q.dtype, device=q.device))


def self_collision_margins(robot: PandaRobot, q: torch.Tensor,
                           pairs: Sequence[Tuple[int, int]] = PANDA_CHECK_PAIRS
                           ) -> torch.Tensor:
    """Per-pair clearance margins ``dist - (r_i + r_j)``: ``[..., n_pairs]``.
    Negative means collision."""
    p0, p1, rr = _capsule_endpoints(robot, q)
    margins = [segment_distance(p0[..., i, :], p1[..., i, :], p0[..., j, :], p1[..., j, :])
               - (rr[i] + rr[j]) for i, j in pairs]
    return torch.stack(margins, dim=-1)


def self_collision(robot: PandaRobot, q: torch.Tensor) -> torch.Tensor:
    """{0, 1} self-collision label per configuration ``[...]`` (float32)."""
    m = self_collision_margins(robot, q)
    return (torch.amin(m, dim=-1) <= 0.0).to(torch.float32)


def sample_self_collision_dataset(robot: PandaRobot, n: int,
                                  generator: Optional[torch.Generator] = None,
                                  qs: Optional[torch.Tensor] = None):
    """Configurations uniform within the joint limits, drawn with
    ``generator`` on the robot's device (or the given ``qs``), and their
    exact capsule labels, as numpy arrays ``([n, 7], [n])``."""
    lower, upper = robot.joint_limits()
    if qs is None:
        if generator is None:
            raise ValueError("sample_self_collision_dataset draws: pass a generator or qs")
        u = torch.rand((n, 7), generator=generator, device=robot.device)
        qs = lower + (upper - lower) * u
    qs = torch.as_tensor(qs, dtype=torch.float32, device=robot.device)
    with torch.no_grad():
        labels = self_collision(robot, qs)
    return qs.cpu().numpy(), labels.cpu().numpy()
