"""Live-updating figure for monitoring running optimizations (port of
``sigsvgd_tpu/utils/live_plot.py``).

Named line series on subplot panels, appended one value at a time. With an
interactive matplotlib backend the figure redraws in place; otherwise each
(throttled) redraw atomically rewrites a PNG. Values may be tensors or
numpy scalars: they become host floats when appended, so no device memory
is held. matplotlib is imported when a figure is made (the card's machine
may lack it).
"""
from __future__ import annotations

import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LiveFigure"]


class LiveFigure:
    """Streaming line plots: ``append(label, value)`` grows a named series.

    Parameters
    ----------
    nrows, ncols: subplot grid; series address panels by flat ``panel`` index.
    out_path: PNG to (re)write on redraw when the backend is non-interactive
        (default ``live_plot.png`` in the CWD).
    redraw_every: redraw once per this many appends (throttle; 0 = only on
        explicit :meth:`redraw`).
    """

    def __init__(
        self,
        nrows: int = 1,
        ncols: int = 1,
        out_path: Optional[str] = None,
        redraw_every: int = 1,
        figsize: Tuple[float, float] = (10.0, 8.0),
    ):
        import matplotlib

        if "matplotlib.pyplot" not in __import__("sys").modules and not matplotlib.is_interactive():
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self._interactive = matplotlib.is_interactive() or (
            matplotlib.get_backend().lower()
            not in ("agg", "pdf", "svg", "ps", "cairo", "template")
        )
        if self._interactive:  # pragma: no cover - no GUI in CI
            plt.ion()
        self.fig, axs = plt.subplots(
            nrows, ncols, figsize=figsize, sharex=True, squeeze=False
        )
        self.axs = list(axs.ravel())
        self.out_path = out_path or "live_plot.png"
        self.redraw_every = redraw_every
        self._series: Dict[Tuple[int, str], List[float]] = defaultdict(list)
        self._lines: Dict[Tuple[int, str], object] = {}
        self._appends_since_redraw = 0
        self.n_redraws = 0

    # -- data ---------------------------------------------------------------
    def append(self, label: str, value, panel: int = 0) -> None:
        """Append one host-converted scalar to the named series."""
        self._series[(panel, label)].append(float(np.asarray(
            value.detach().cpu() if hasattr(value, "detach") else value)))
        self._touch(panel, label)
        self._maybe_redraw()

    def set_series(
        self, label: str, y: Sequence[float], x: Optional[Sequence[float]] = None,
        panel: int = 0,
    ) -> None:
        """Replace a named series wholesale (e.g. a whole loss trace)."""
        y = y.detach().cpu().numpy() if hasattr(y, "detach") else np.asarray(y)
        self._series[(panel, label)] = [float(v) for v in y.ravel()]
        self._touch(panel, label, x=x)
        self._maybe_redraw()

    def _touch(self, panel, label, x=None):
        key = (panel, label)
        ys = self._series[key]
        xs = np.arange(len(ys)) if x is None else np.asarray(x)
        line = self._lines.get(key)
        if line is None:
            (line,) = self.axs[panel].plot(xs, ys, label=label)
            self._lines[key] = line
            self.axs[panel].legend(loc="best", fontsize=8)
        else:
            line.set_data(xs, ys)
        ax = self.axs[panel]
        ax.relim()
        ax.autoscale_view()

    # -- redraw -------------------------------------------------------------
    def _maybe_redraw(self):
        self._appends_since_redraw += 1
        if self.redraw_every and self._appends_since_redraw >= self.redraw_every:
            self.redraw()

    def redraw(self) -> None:
        self._appends_since_redraw = 0
        self.n_redraws += 1
        if self._interactive:  # pragma: no cover
            self.fig.canvas.draw()
            self.fig.canvas.flush_events()
        else:
            # atomic replace so a concurrent viewer never sees a torn file
            d = os.path.dirname(os.path.abspath(self.out_path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".png", dir=d)
            os.close(fd)
            try:
                self.fig.savefig(tmp, dpi=80)
                os.replace(tmp, self.out_path)
            finally:
                if os.path.exists(tmp):  # pragma: no cover
                    os.unlink(tmp)

    def clear(self) -> None:
        for ax in self.axs:
            ax.clear()
        self._series.clear()
        self._lines.clear()

    def close(self) -> None:
        self._plt.close(self.fig)
