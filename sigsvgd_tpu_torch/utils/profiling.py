"""Tracing and timing helpers (port of ``sigsvgd_tpu/utils/profiling.py``).

:func:`device_trace` records a ``torch.profiler`` trace (CPU and, on the
card, CUDA activity) and writes it as a Chrome/Perfetto trace;
:class:`SectionTimer` accumulates wall time by section, synchronising the
card before it reads the clock; :func:`scan_time` and :func:`slope_time`
time one application of a function: on the card with CUDA events around
``reps`` applications chained by a data dependency, each call on an input
other than the warm-up's, on the CPU with the host clock.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(out_dir: str | Path) -> Iterator[object]:
    """Profile the block with ``torch.profiler`` (CUDA activity too when a
    card is present) and write ``out_dir/trace.json`` for Perfetto or
    ``chrome://tracing``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def _sync(obj) -> None:
    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        torch.cuda.synchronize(obj.device)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _sync(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            _sync(o)


class SectionTimer:
    """Accumulating wall-clock timer; ``sync`` (tensors) is waited for on
    the card before the section's clock stops."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: Optional[object] = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": round(total, 4), "calls": self.counts[name],
                   "mean_ms": round(1e3 * total / self.counts[name], 3)}
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }


def _first_leaf(out) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        return _first_leaf(next(iter(out.values())))
    return _first_leaf(out[0])


def _run(fn, x: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps`` applications, each input depending on the last output."""
    z = x
    for _ in range(reps):
        leaf = _first_leaf(fn(z))
        z = z + 1e-30 * torch.mean(leaf).to(z.dtype)
    return z


@torch.no_grad()
def scan_time(fn, x: torch.Tensor, reps: int = 8) -> float:
    """Seconds per application of ``fn`` on ``x``: ``reps`` applications
    chained by a data dependency, timed between two CUDA events on the card
    (the host clock on the CPU), after a warm-up on a different input (no
    cache serves the timed calls)."""
    _run(fn, x + 1.0, reps).sum().item()
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _run(fn, x, reps)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    _run(fn, x, reps).sum().item()
    return (time.perf_counter() - t0) / reps


def slope_time(fn, x: torch.Tensor, reps_lo: int = 2, reps_hi: int = 10) -> float:
    """Seconds per application from two run lengths, ``(t_hi − t_lo) /
    (reps_hi − reps_lo)``: the fixed launch and fetch costs cancel."""
    t_lo = scan_time(fn, x, reps=reps_lo) * reps_lo
    t_hi = scan_time(fn, x, reps=reps_hi) * reps_hi
    return (t_hi - t_lo) / (reps_hi - reps_lo)
