"""Plot library: result curves, particle frames and movies, maze renders
(port of ``sigsvgd_tpu/utils/plots.py``).

Matplotlib, imported inside the functions (Agg backend unless one is set)
because the card's machine may lack it; every function takes numpy arrays
or tensors and returns the figure or writes files.
"""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models.particle import ParticleModel
from . import obstacle_map as om


def _mpl():
    """``(pyplot, cm)``, with the Agg backend unless one was chosen."""
    import matplotlib

    if "matplotlib.pyplot" not in __import__("sys").modules:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    return plt, cm


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_mean_std_curves(
    runs: Dict[str, np.ndarray],
    ax=None,
    xlabel: str = "step",
    ylabel: str = "cost",
):
    """Mean ± std curves over seeds per method (reference ``plots.py:73-166``).

    ``runs[method]`` is ``[n_seeds, n_steps]``.
    """
    plt, _ = _mpl()
    ax = ax or plt.gca()
    for name, data in runs.items():
        data = _np(data)
        mean = data.mean(0)
        std = data.std(0)
        x = np.arange(mean.shape[0])
        ax.plot(x, mean, label=name)
        ax.fill_between(x, mean - std, mean + std, alpha=0.25)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()
    return ax


def render_maze(
    model: ParticleModel,
    trajectory: Optional[np.ndarray] = None,
    rollouts: Optional[np.ndarray] = None,
    ax=None,
    path: Optional[Path] = None,
):
    """Render the occupancy grid, start/goal, executed trajectory and policy
    rollouts (reference ``particle.py:206-270``)."""
    plt, cm = _mpl()
    assert model.obstacle_map is not None
    omap = model.obstacle_map
    grid = _np(omap.grid)
    ax = ax or plt.gca()
    ax.imshow(grid.T, cmap="Oranges", origin="lower")

    def to_map(xy):
        xy = torch.as_tensor(np.asarray(xy, np.float32), device=omap.grid.device)
        return _np(om.to_map_coord(omap, xy))

    start = to_map(_np(model.init_state)[:2])
    goal = to_map(_np(model.target_state)[:2])
    ax.scatter(*start, marker="o", color="r", s=20)
    ax.scatter(*goal, marker="*", color="r", s=100)

    if trajectory is not None:
        pts = to_map(_np(trajectory)[:, :2])
        ax.plot(pts[:, 0], pts[:, 1], "b-", linewidth=1.5)

    if rollouts is not None:
        # rollouts: [..., n_pol, T, state]
        r = _np(rollouts)[..., :2]
        r = r.reshape(-1, r.shape[-3], r.shape[-2], 2) if r.ndim > 3 else r[None]
        n_pol = r.shape[-3]
        colors = cm.rainbow(np.linspace(0, 1, n_pol))
        for p in range(n_pol):
            m = to_map(r[0, p])
            ax.plot(m[:, 0], m[:, 1], alpha=0.3, color=colors[p], linewidth=1)

    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        plt.savefig(path, dpi=100)
    return ax


def plot_particles_2d(
    trace: np.ndarray,
    logp_fn=None,
    out_dir: Optional[Path] = None,
    every: int = 10,
    extent: float = 3.0,
):
    """Particle-evolution frames for a 2-D SVGD run (reference
    ``plots.py:395-446``): one PNG per sampled step, optional density contour.
    """
    plt, _ = _mpl()
    trace = _np(trace)
    frames = []
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
    xs = np.linspace(-extent, extent, 120)
    grid = None
    if logp_fn is not None:
        xx, yy = np.meshgrid(xs, xs)
        pts = torch.from_numpy(np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32))
        grid = _np(logp_fn(pts)).reshape(xx.shape)
    for t in range(0, trace.shape[0], every):
        fig, ax = plt.subplots(figsize=(5, 5))
        if grid is not None:
            ax.contourf(xs, xs, np.exp(grid - grid.max()), levels=20, cmap="viridis")
        ax.scatter(trace[t, :, 0], trace[t, :, 1], s=8, c="w", edgecolors="k")
        ax.set_xlim(-extent, extent)
        ax.set_ylim(-extent, extent)
        ax.set_title(f"step {t}")
        if out_dir is not None:
            fname = out_dir / f"frame_{t:05d}.png"
            fig.savefig(fname, dpi=80)
            frames.append(fname)
        plt.close(fig)
    return frames


def create_video_from_plots(
    frame_dir: Path, out_path: Path, fps: int = 10
) -> Optional[Path]:
    """Assemble frame PNGs into an mp4 with ffmpeg if available (reference
    ``plots.py:447-458``); returns None when ffmpeg is absent."""
    if shutil.which("ffmpeg") is None:
        return None
    out = Path(out_path) / "movie.mp4" if Path(out_path).is_dir() else Path(out_path)
    cmd = [
        "ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
        "-pattern_type", "glob", "-i", str(Path(frame_dir) / "frame_*.png"),
        "-c:v", "libx264", "-pix_fmt", "yuv420p", str(out),
    ]
    subprocess.run(cmd, check=True)
    return out


def plot_particle_ridgeline(
    particles_over_time: np.ndarray,
    every: int = 10,
    bins: int = 40,
    ax=None,
    true_value: Optional[float] = None,
):
    """Ridgeline of a 1-D particle distribution's evolution (the reference's
    MPF dynamics-posterior plots, ``plots.py:167-394``).

    ``particles_over_time``: ``[T, n_particles]`` (or ``[T, n, 1]``).
    """
    plt, cm = _mpl()
    p = _np(particles_over_time)
    if p.ndim == 3:
        p = p[..., 0]
    ax = ax or plt.gca()
    lo, hi = p.min(), p.max()
    xs = np.linspace(lo, hi, bins)
    rows = list(range(0, p.shape[0], every))
    for rank, t in enumerate(rows):
        hist, edges = np.histogram(p[t], bins=bins, range=(lo, hi), density=True)
        centers = 0.5 * (edges[:-1] + edges[1:])
        base = rank * 1.0
        ax.fill_between(
            centers, base, base + hist / max(hist.max(), 1e-9) * 0.9,
            alpha=0.6, color=cm.viridis(rank / max(len(rows) - 1, 1)),
        )
    if true_value is not None:
        ax.axvline(true_value, color="r", linestyle="--", linewidth=1)
    ax.set_yticks([r for r in range(len(rows))])
    ax.set_yticklabels([f"t={t}" for t in rows])
    ax.set_xlabel("parameter value")
    return ax


def plot_arm_trajectories(
    link_positions: np.ndarray,
    ee_trajectories: Optional[np.ndarray] = None,
    scene_points: Optional[np.ndarray] = None,
    path: Optional[Path] = None,
):
    """3-D arm/end-effector visualization (matplotlib 3-D; counterpart of the
    reference's plotly ``robot_visualizer.py``).

    ``link_positions``: ``[n_links, 3]`` one arm pose or ``[n_arms, L, 3]``
    several (plotted as polylines); ``ee_trajectories``: ``[batch, T, 3]``
    candidate EE paths.
    """
    plt, cm = _mpl()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    lp = _np(link_positions)
    arms = lp[None] if lp.ndim == 2 else lp
    for i, arm in enumerate(arms):
        ax.plot(
            arm[:, 0], arm[:, 1], arm[:, 2], "o-",
            color="k" if i == 0 else cm.tab10(i % 10),
            linewidth=3, markersize=5,
        )
    if ee_trajectories is not None:
        ee = _np(ee_trajectories)
        colors = cm.rainbow(np.linspace(0, 1, ee.shape[0]))
        for i in range(ee.shape[0]):
            ax.plot(ee[i, :, 0], ee[i, :, 1], ee[i, :, 2], color=colors[i], alpha=0.6)
    if scene_points is not None:
        sp = _np(scene_points)
        ax.scatter(sp[:, 0], sp[:, 1], sp[:, 2], s=2, c="gray", alpha=0.3)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig
