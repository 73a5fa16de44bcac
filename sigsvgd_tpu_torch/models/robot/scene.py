"""Primitive obstacle scenes with exact signed-distance fields (port of
``sigsvgd_tpu/models/robot/scene.py``; mesh obstacles wait for ROADMAP
queue 1, M13).

The SDF keeps JAX's gradients at ties (``utils.math.clip/relu/jabs``,
``torch.amin`` over primitives) and the ``+1e-12`` inside every square root,
which keeps gradients finite on a surface. The hard occupancy labels the
learned occupancy model's data and audits trajectories; scenes and path
requests round-trip through dicts and YAML files (PyYAML is imported when a
file is read or written).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..._device import resolve_device
from ...utils.math import clip, jabs, relu
from .kinematics import _add, _mul


@dataclasses.dataclass(frozen=True)
class Primitive:
    """A posed primitive. ``kind`` ∈ {box, sphere, cylinder, capsule}.

    ``size``: box → (sx, sy, sz) full extents; sphere → (r,); cylinder/capsule
    → (r, half_height). ``rot`` is a row-major 3×3 world-from-local rotation.
    """

    kind: str
    position: Tuple[float, float, float]
    size: Tuple[float, ...]
    rot: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    primitives: Tuple[Primitive, ...]
    workspace_low: Tuple[float, float, float] = (-1.0, -1.0, 0.0)
    workspace_high: Tuple[float, float, float] = (1.0, 1.0, 1.5)
    device: torch.device = torch.device("cpu")  # where its queries run


def _safe_sqrt(s):
    return torch.sqrt(s + 1e-12)


def _min0(x):
    return torch.minimum(x, torch.zeros_like(x))


def _primitive_sdf_xyz(p: Primitive, px, py, pz) -> torch.Tensor:
    """Signed distance of points given as component tensors ``px/py/pz``."""
    R = np.asarray(p.rot, np.float64).reshape(3, 3)
    c = [float(v) for v in p.position]
    d = [comp if ci == 0.0 else comp - ci for comp, ci in zip((px, py, pz), c)]
    local = []
    for i in range(3):
        e = 0.0
        for j in range(3):
            e = _add(e, _mul(float(R[j, i]), d[j]))
        local.append(e)
    lx, ly, lz = local

    if p.kind == "box":
        hx, hy, hz = (float(s) / 2.0 for s in p.size)
        qx = jabs(lx) - hx
        qy = jabs(ly) - hy
        qz = jabs(lz) - hz
        ox, oy, oz = relu(qx), relu(qy), relu(qz)
        outside = _safe_sqrt(ox * ox + oy * oy + oz * oz)
        inside = _min0(torch.maximum(qx, torch.maximum(qy, qz)))
        return outside + inside
    if p.kind == "sphere":
        return _safe_sqrt(lx * lx + ly * ly + lz * lz) - float(p.size[0])
    if p.kind == "cylinder":
        r, hh = float(p.size[0]), float(p.size[1])
        d_r = _safe_sqrt(lx * lx + ly * ly) - r
        d_z = jabs(lz) - hh
        o_r, o_z = relu(d_r), relu(d_z)
        outside = _safe_sqrt(o_r * o_r + o_z * o_z)
        inside = _min0(torch.maximum(d_r, d_z))
        return outside + inside
    if p.kind == "capsule":
        r, hh = float(p.size[0]), float(p.size[1])
        dz = lz - clip(lz, -hh, hh)
        return _safe_sqrt(lx * lx + ly * ly + dz * dz) - r
    raise ValueError(f"Unknown primitive kind: {p.kind}")


def _primitive_sdf(p: Primitive, x: torch.Tensor) -> torch.Tensor:
    return _primitive_sdf_xyz(p, x[..., 0], x[..., 1], x[..., 2])


def scene_sdf(scene: Scene, x: torch.Tensor) -> torch.Tensor:
    """Scene SDF, the minimum over primitives: ``x [..., 3] → [...]``."""
    if not scene.primitives:
        return torch.full(x.shape[:-1], float("inf"), dtype=x.dtype,
                          device=x.device)
    ds = [_primitive_sdf(p, x) for p in scene.primitives]
    return torch.amin(torch.stack(ds, dim=0), dim=0)


def scene_occupancy(scene: Scene, x: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Hard {0, 1} occupancy at points ``x [..., 3]``: ``sdf <= margin``."""
    return (scene_sdf(scene, x) <= margin).to(torch.float32)


def sample_occupancy_dataset(scene: Scene, n: int, margin: float = 0.0,
                             generator: Optional[torch.Generator] = None,
                             pts: Optional[torch.Tensor] = None):
    """Points uniform in the scene's workspace, drawn with ``generator`` on
    the scene's device (or the given ``pts``), and their exact occupancy
    labels, as numpy arrays ``([n, 3], [n])``."""
    if pts is None:
        if generator is None:
            raise ValueError("sample_occupancy_dataset draws: pass a generator or pts")
        low = torch.tensor(scene.workspace_low, dtype=torch.float32, device=scene.device)
        high = torch.tensor(scene.workspace_high, dtype=torch.float32, device=scene.device)
        u = torch.rand((n, 3), generator=generator, device=scene.device)
        pts = low + (high - low) * u
    pts = torch.as_tensor(pts, dtype=torch.float32, device=scene.device)
    labels = scene_occupancy(scene, pts, margin)
    return pts.cpu().numpy(), labels.cpu().numpy()


# ---------------------------------------------------------------------------
# Dict and YAML round trips (the JAX package's layout; ``meshes`` is always
# empty here, and a dict that lists mesh obstacles raises).
# ---------------------------------------------------------------------------


def _yaml():
    import yaml

    return yaml


def scene_to_dict(scene: Scene) -> dict:
    return {
        "name": scene.name,
        "workspace": {"low": list(scene.workspace_low),
                      "high": list(scene.workspace_high)},
        "primitives": [
            {"kind": p.kind, "position": list(p.position), "size": list(p.size),
             "rot": list(p.rot)}
            for p in scene.primitives
        ],
        "meshes": [],
    }


def scene_from_dict(d: dict, device=None) -> Scene:
    if d.get("meshes"):
        raise NotImplementedError(
            "mesh obstacles are not ported yet (ROADMAP.md queue 1, M13: mesh_scene.py)")
    ws = d.get("workspace", {})
    return Scene(
        name=d.get("name", "scene"),
        primitives=tuple(
            Primitive(kind=p["kind"], position=tuple(p["position"]),
                      size=tuple(p["size"]),
                      rot=tuple(p.get("rot", (1, 0, 0, 0, 1, 0, 0, 0, 1))))
            for p in d.get("primitives", [])
        ),
        workspace_low=tuple(ws.get("low", (-1, -1, 0))),
        workspace_high=tuple(ws.get("high", (1, 1, 1.5))),
        device=resolve_device(device),
    )


def save_scene(scene: Scene, path) -> None:
    Path(path).write_text(_yaml().safe_dump(scene_to_dict(scene)))


def load_scene(path, device=None) -> Scene:
    return scene_from_dict(_yaml().safe_load(Path(path).read_text()), device=device)


@dataclasses.dataclass(frozen=True)
class PathRequest:
    """Start and goal joint configurations."""

    start: Tuple[float, ...]
    target: Tuple[float, ...]

    @staticmethod
    def from_yaml(path) -> "PathRequest":
        d = _yaml().safe_load(Path(path).read_text())
        return PathRequest(start=tuple(d["start"]), target=tuple(d["target"]))

    def to_yaml(self, path) -> None:
        Path(path).write_text(_yaml().safe_dump({"start": list(self.start),
                                                 "target": list(self.target)}))


# ---------------------------------------------------------------------------
# Built-in scene library (the same tables as the JAX package).
# ---------------------------------------------------------------------------


def _shelf(x: float = 0.55):
    boards = [Primitive("box", (x, 0.0, z), (0.3, 0.8, 0.03))
              for z in (0.2, 0.5, 0.8, 1.1)]
    boards.append(Primitive("box", (x, -0.4, 0.65), (0.3, 0.03, 0.93)))
    boards.append(Primitive("box", (x, 0.4, 0.65), (0.3, 0.03, 0.93)))
    return tuple(boards)


def _table_cluster():
    return (
        Primitive("box", (0.5, 0.0, 0.2), (0.7, 1.0, 0.04)),
        Primitive("cylinder", (0.45, 0.25, 0.35), (0.06, 0.13)),
        Primitive("cylinder", (0.55, -0.2, 0.33), (0.05, 0.11)),
        Primitive("box", (0.35, -0.05, 0.3), (0.12, 0.12, 0.16)),
    )


def _cage():
    bars = [Primitive("box", (0.5 + sx * 0.4, sy, 0.6), (0.04, 0.04, 1.2))
            for sx in (-0.35, 0.35) for sy in (-0.35, 0.35)]
    bars.append(Primitive("box", (0.5, 0.0, 1.2), (0.5, 0.8, 0.04)))
    return tuple(bars)


def _window():
    return (
        Primitive("box", (0.55, 0.0, 0.25), (0.04, 1.2, 0.5)),
        Primitive("box", (0.55, 0.0, 1.05), (0.04, 1.2, 0.5)),
        Primitive("box", (0.55, -0.45, 0.65), (0.04, 0.3, 0.3)),
        Primitive("box", (0.55, 0.45, 0.65), (0.04, 0.3, 0.3)),
    )


def _bookshelf_thin():
    boards = [Primitive("box", (0.55, 0.0, z), (0.26, 0.5, 0.025))
              for z in (0.15, 0.38, 0.61, 0.84, 1.07, 1.3)]
    boards.append(Primitive("box", (0.55, -0.25, 0.72), (0.26, 0.025, 1.17)))
    boards.append(Primitive("box", (0.55, 0.25, 0.72), (0.26, 0.025, 1.17)))
    boards.append(Primitive("box", (0.68, 0.0, 0.72), (0.025, 0.5, 1.17)))
    return tuple(boards)


def _box():
    return (
        Primitive("box", (0.55, 0.0, 0.1), (0.4, 0.4, 0.03)),
        Primitive("box", (0.35, 0.0, 0.3), (0.03, 0.4, 0.4)),
        Primitive("box", (0.75, 0.0, 0.3), (0.03, 0.4, 0.4)),
        Primitive("box", (0.55, -0.2, 0.3), (0.4, 0.03, 0.4)),
        Primitive("box", (0.55, 0.2, 0.3), (0.4, 0.03, 0.4)),
    )


def _kitchen():
    return (
        Primitive("box", (0.55, 0.0, 0.35), (0.6, 1.2, 0.04)),
        Primitive("box", (0.6, 0.0, 1.15), (0.5, 1.2, 0.3)),
        Primitive("box", (0.55, -0.55, 0.75), (0.6, 0.04, 0.85)),
        Primitive("box", (0.82, 0.15, 0.47), (0.08, 0.08, 0.2)),
        Primitive("cylinder", (0.45, 0.35, 0.45), (0.05, 0.17)),
    )


def _table_bars():
    prims = [Primitive("box", (0.55, 0.0, 0.25), (0.7, 1.0, 0.04))]
    for y in (-0.3, 0.0, 0.3):
        prims.append(Primitive("box", (0.55, y, 0.65), (0.04, 0.04, 0.76)))
    prims.append(Primitive("box", (0.55, 0.0, 1.05), (0.7, 1.0, 0.04)))
    return tuple(prims)


def _pillars(name: str, n: int):
    # seeded from the tag's str hash exactly as the JAX package does, so the
    # layout matches it within one interpreter (PYTHONHASHSEED applies)
    rng = np.random.default_rng(hash(name) % (2**31))
    prims = []
    for _ in range(n):
        x = float(rng.uniform(0.3, 0.7))
        y = float(rng.uniform(-0.45, 0.45))
        r = float(rng.uniform(0.03, 0.07))
        prims.append(Primitive("cylinder", (x, y, 0.6), (r, 0.6)))
    return tuple(prims)


_TABLES = {
    "bookshelf_small": lambda: _shelf(0.5),
    "bookshelf_tall": lambda: _shelf(0.6),
    "bookshelf_thin": _bookshelf_thin,
    "box": _box,
    "cage": _cage,
    "kitchen": _kitchen,
    "table_bars": _table_bars,
    "table_pick": _table_cluster,
    "table_under_pick": lambda: _table_cluster() + (
        Primitive("box", (0.5, 0.0, 0.55), (0.5, 0.6, 0.03)),
    ),
    "window": _window,
    "pillars_4": lambda: _pillars("pillars_4", 4),
    "pillars_6": lambda: _pillars("pillars_6", 6),
    "empty": lambda: (),
}
SCENE_TAGS = tuple(_TABLES)


def get_scene(tag: str, device=None) -> Scene:
    if tag not in _TABLES:
        raise ValueError(f"Unknown scene tag {tag}; available: {SCENE_TAGS}")
    return Scene(tag, _TABLES[tag](), device=resolve_device(device))
