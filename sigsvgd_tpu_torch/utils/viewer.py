"""Interactive 3-D scene/arm/trajectory viewer as a standalone HTML file
(port of ``sigsvgd_tpu/utils/viewer.py``).

The viewer is a self-contained HTML document: scene geometry and
trajectories are embedded as JSON and rendered by a dependency-free canvas
renderer with orbit/zoom controls and a frame slider + play button for arm
animations. Open the file in any browser; no server, no network.

Geometry is converted host-side (numpy) into polyline segments:
box/cylinder/sphere/capsule primitives become wireframes in their posed
frames; arms and EE paths become colored polylines; point clouds become
scatter dots.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["export_interactive_html", "scene_wireframe"]


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _posed(pts: np.ndarray, rot, pos) -> np.ndarray:
    R = np.asarray(rot, np.float64).reshape(3, 3)
    return pts @ R.T + np.asarray(pos, np.float64)


def _circle(radius: float, z: float, n: int = 24) -> np.ndarray:
    t = np.linspace(0.0, 2 * np.pi, n + 1)
    return np.stack([radius * np.cos(t), radius * np.sin(t), np.full_like(t, z)], -1)


def _box_wire(size) -> list:
    hx, hy, hz = (s / 2.0 for s in size)
    c = np.array(
        [[sx, sy, sz] for sx in (-hx, hx) for sy in (-hy, hy) for sz in (-hz, hz)]
    )
    edges = [
        (0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    return [c[[i, j]] for i, j in edges]


def _cylinder_wire(radius: float, half_h: float, cap_spheres: bool = False) -> list:
    segs = [_circle(radius, -half_h), _circle(radius, half_h)]
    for ang in (0.0, np.pi / 2, np.pi, 3 * np.pi / 2):
        x, y = radius * np.cos(ang), radius * np.sin(ang)
        segs.append(np.array([[x, y, -half_h], [x, y, half_h]]))
    if cap_spheres:  # capsule: arcs over the caps
        t = np.linspace(0.0, np.pi, 13)
        for sgn in (-1.0, 1.0):
            arc = np.stack(
                [radius * np.cos(t), np.zeros_like(t),
                 sgn * (half_h + radius * np.sin(t))], -1)
            segs.append(arc)
    return segs


def _sphere_wire(radius: float) -> list:
    eq = _circle(radius, 0.0)
    mer1 = eq[:, [2, 0, 1]]  # rotate axes for two meridians
    mer2 = eq[:, [0, 2, 1]]
    return [eq, mer1, mer2]


def scene_wireframe(scene) -> list:
    """Scene primitives (and posed mesh bounding boxes) as world-frame
    polyline segments ``[ [ [x,y,z], ... ], ... ]``."""
    segs: list = []
    for p in scene.primitives:
        if p.kind == "box":
            local = _box_wire(p.size)
        elif p.kind == "sphere":
            local = _sphere_wire(p.size[0])
        elif p.kind in ("cylinder", "capsule"):
            local = _cylinder_wire(p.size[0], p.size[1], cap_spheres=p.kind == "capsule")
        else:  # pragma: no cover - unknown kinds are skipped, not fatal
            continue
        segs.extend(_posed(np.asarray(s), p.rot, p.position) for s in local)
    for m in getattr(scene, "meshes", ()) or ():
        # meshes are drawn as their posed bounding box (exact tri rendering
        # would embed the whole STL; the SDF grid already covers collision)
        try:
            from ..native.collision import TriMesh  # the native engine, built on use

            tris = TriMesh(m.path).triangles().reshape(-1, 3)
            lo, hi = tris.min(0), tris.max(0)
        except Exception:
            continue
        ctr, size = (lo + hi) / 2.0, hi - lo
        for s in _box_wire(size):
            segs.extend([_posed(np.asarray(s) + ctr, m.rot, m.position)])
    return [np.asarray(s, np.float64).tolist() for s in segs]


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:10px;user-select:none}
#bar{position:fixed;bottom:10px;left:10px;right:10px;display:__BAR__;gap:8px;align-items:center}
input[type=range]{flex:1} button{background:#333;color:#ddd;border:1px solid #555;padding:2px 10px}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud">__TITLE__ &mdash; drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
<div id="bar"><button id="play">&#9654;</button><input type="range" id="frame" min="0" value="0"><span id="fl"></span></div>
<script>
const D = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let yaw = 0.7, pitch = 0.5, dist = 3.5, panX = 0, panY = 0, frame = 0, playing = false;
const ctr = D.center;
function resize(){ cv.width = innerWidth; cv.height = innerHeight; draw(); }
addEventListener('resize', resize);
function proj(p){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  const x1 = cy*x + sy*y, y1 = -sy*x + cy*y;
  const y2 = cp*y1 + sp*z, z2 = -sp*y1 + cp*z;
  const d = dist*D.radius, f = cv.height*1.1/(1+(y2+d)/(2*D.radius));
  return [cv.width/2 + f*x1/ D.radius + panX, cv.height/2 - f*z2/D.radius + panY, y2];
}
function line(pts, color, w){
  ctx.strokeStyle = color; ctx.lineWidth = w; ctx.beginPath();
  for(let i=0;i<pts.length;i++){const q=proj(pts[i]); if(i)ctx.lineTo(q[0],q[1]); else ctx.moveTo(q[0],q[1]);}
  ctx.stroke();
}
function draw(){
  ctx.clearRect(0,0,cv.width,cv.height);
  const ax=[[0,0,0],[D.radius*0.3,0,0]], ay=[[0,0,0],[0,D.radius*0.3,0]], az=[[0,0,0],[0,0,D.radius*0.3]];
  line(ax,'#b33',1); line(ay,'#3b3',1); line(az,'#36b',1);
  for(const s of D.scene) line(s, '#888', 1);
  if(D.points.length){ ctx.fillStyle='#aaa';
    for(const p of D.points){const q=proj(p); ctx.fillRect(q[0]-1,q[1]-1,2,2);} }
  D.ee.forEach((t,i)=>line(t, 'hsl('+(i*360/Math.max(D.ee.length,1))+',70%,60%)', 1));
  if(D.frames.length){
    const arm = D.frames[frame];
    line(arm, '#fff', 3);
    ctx.fillStyle = '#ff0';
    for(const p of arm){const q=proj(p); ctx.beginPath(); ctx.arc(q[0],q[1],3,0,7); ctx.fill();}
    document.getElementById('fl').textContent = 'frame '+frame+'/'+(D.frames.length-1);
  }
  D.arms.forEach((a,i)=>line(a, i? 'hsl('+(i*47%360)+',60%,65%)' : '#fff', 2));
}
let drag=null;
cv.onmousedown = e=>drag=[e.clientX,e.clientY,e.shiftKey];
addEventListener('mouseup', ()=>drag=null);
addEventListener('mousemove', e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){ panX+=dx; panY+=dy; } else { yaw+=dx*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008)); }
  drag=[e.clientX,e.clientY,drag[2]]; draw(); });
cv.onwheel = e=>{ dist=Math.max(0.5,Math.min(20,dist*Math.exp(e.deltaY*0.001))); draw(); e.preventDefault(); };
const slider = document.getElementById('frame');
slider.max = Math.max(D.frames.length-1, 0);
slider.oninput = ()=>{ frame = +slider.value; draw(); };
document.getElementById('play').onclick = ()=>{ playing=!playing; };
setInterval(()=>{ if(playing && D.frames.length){ frame=(frame+1)%D.frames.length; slider.value=frame; draw(); } }, 80);
resize();
</script></body></html>
"""


def export_interactive_html(
    path,
    scene=None,
    arm_frames: Optional[np.ndarray] = None,
    arms: Optional[np.ndarray] = None,
    ee_trajectories: Optional[np.ndarray] = None,
    points: Optional[np.ndarray] = None,
    title: str = "sigsvgd_tpu viewer",
) -> Path:
    """Write a standalone interactive 3-D HTML viewer.

    Args:
      path: output ``.html`` file.
      scene: optional ``Scene`` — primitives drawn as wireframes.
      arm_frames: ``[n_frames, n_links, 3]`` link positions to animate with
        the slider/play control (the reference's ``RobotScene.play``).
      arms: ``[n_arms, n_links, 3]`` static arm poses (first drawn bold).
      ee_trajectories: ``[batch, T, 3]`` candidate end-effector paths.
      points: ``[n, 3]`` scatter markers (e.g. occupancy samples).
    """
    data = {
        "scene": scene_wireframe(scene) if scene is not None else [],
        "frames": _np64(arm_frames).tolist()
        if arm_frames is not None else [],
        "arms": _np64(arms).tolist() if arms is not None else [],
        "ee": _np64(ee_trajectories).tolist()
        if ee_trajectories is not None else [],
        "points": _np64(points).tolist()
        if points is not None else [],
    }
    all_pts = [np.asarray(s).reshape(-1, 3) for s in data["scene"]]
    for k in ("frames", "arms", "ee", "points"):
        if data[k]:
            all_pts.append(np.asarray(data[k], np.float64).reshape(-1, 3))
    pts = np.concatenate(all_pts, 0) if all_pts else np.zeros((1, 3))
    center = pts.mean(0)
    radius = float(max(np.linalg.norm(pts - center, axis=1).max(), 1e-3))
    data["center"] = center.tolist()
    data["radius"] = radius

    html = (
        _TEMPLATE.replace("__TITLE__", title)
        .replace("__BAR__", "flex" if data["frames"] else "none")
        .replace("__DATA__", json.dumps(data))
    )
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(html)
    return out
