"""Bounded box spaces (port of ``sigsvgd_tpu/utils/spaces.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .math import clip


@dataclasses.dataclass(frozen=True)
class Box:
    """A ``dim``-dimensional box; bounds are hashable float tuples."""

    dim: int
    low_t: Tuple[float, ...]
    high_t: Tuple[float, ...]

    @staticmethod
    def create(dim: int, low=None, high=None) -> "Box":
        if dim <= 0:
            raise ValueError("Box dimension must be a positive integer.")

        def _expand(v, default):
            if v is None:
                return (default,) * dim
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            arr = np.asarray(v, dtype=np.float64).reshape(-1)
            if arr.size == 1:
                return (float(arr[0]),) * dim
            if arr.size != dim:
                raise ValueError(f"Bounds must be scalar or length-{dim}.")
            return tuple(float(a) for a in arr)

        return Box(dim, _expand(low, -np.inf), _expand(high, np.inf))

    @property
    def low(self) -> torch.Tensor:
        return torch.tensor(self.low_t, dtype=torch.float32)

    @property
    def high(self) -> torch.Tensor:
        return torch.tensor(self.high_t, dtype=torch.float32)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dim,)

    @property
    def bounded(self) -> bool:
        return all(np.isfinite(self.low_t)) and all(np.isfinite(self.high_t))

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        return clip(x, self.low, self.high)

    def sample(self, batch_shape: Tuple[int, ...] = (),
               generator: Optional[torch.Generator] = None, *,
               draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Uniform samples in the box; unbounded dims fall back to a standard
        normal. ``draws`` (standard uniforms, or standard normals when
        unbounded) replace the draws from ``generator``; with neither it
        raises ``ValueError``."""
        shape = tuple(batch_shape) + (self.dim,)
        if draws is None:
            if generator is None:
                raise ValueError("Box.sample needs a torch.Generator or the draws given")
            draw = torch.rand if self.bounded else torch.randn
            draws = draw(shape, generator=generator, device=generator.device)
        elif tuple(draws.shape) != shape:
            raise ValueError(f"given draws have shape {tuple(draws.shape)}, "
                             f"expected {shape}")
        if not self.bounded:
            return draws.to(torch.float32)
        low, high = self.low.to(draws.device), self.high.to(draws.device)
        return torch.maximum(low, draws.to(torch.float32) * (high - low) + low)
