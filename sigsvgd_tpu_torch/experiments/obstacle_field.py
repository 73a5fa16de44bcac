"""2-D spline planning through a Gaussian-mixture obstacle field (port of
``sigsvgd_tpu/experiments/obstacle_field.py``).

Knot particles expand to 2-D spline paths; the cost is the obstacle density
summed along the path (centres from a Halton sequence) plus the path
length; the methods are ``pathsig`` (the order-3 signature kernel on the
knots, K2 on the card), ``svgd`` (an RBF kernel on the flattened knots) and
``sgd``.

Run: ``python -m sigsvgd_tpu_torch.experiments.obstacle_field --method pathsig``
(on the card; ``--device cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..inference.score import pathsig_score, sgd_score, svgd_score
from ..inference.svgd import SVGD
from ..kernels.rbf import GaussianKernel
from ..kernels.sigkernel import SignatureKernel
from ..utils import schedulers
from ..utils.math import safe_norm
from ..utils.splines import spline_trajectory


def halton(n: int, base: int) -> np.ndarray:
    """The first ``n`` points of the Halton low-discrepancy sequence."""
    out = np.zeros(n)
    for i in range(n):
        f, r = 1.0, 0.0
        idx = i + 1
        while idx > 0:
            f /= base
            r += f * (idx % base)
            idx //= base
        out[i] = r
    return out


@dataclasses.dataclass(frozen=True)
class ObstacleField:
    centers: Tuple[Tuple[float, float], ...]
    sigma: float = 0.35

    @staticmethod
    def create(n_obstacles: int = 12, extent: float = 8.0) -> "ObstacleField":
        xs = halton(n_obstacles, 2) * extent - extent / 2
        ys = halton(n_obstacles, 3) * extent - extent / 2
        return ObstacleField(tuple(zip(map(float, xs), map(float, ys))))

    def density(self, xy: torch.Tensor) -> torch.Tensor:
        c = torch.tensor(self.centers, dtype=xy.dtype, device=xy.device)  # [k, 2]
        d2 = torch.sum((xy[..., None, :] - c) ** 2, dim=-1)
        return torch.exp(-0.5 * d2 / self.sigma ** 2).sum(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class FieldProblem:
    field: ObstacleField
    start: Tuple[float, float] = (-4.0, -4.0)
    goal: Tuple[float, float] = (4.0, 4.0)
    timesteps: int = 100
    w_obstacle: float = 5.0
    w_length: float = 1.0

    def batch_cost(self, x: torch.Tensor):
        """Cost of knot particles ``x [batch, n_free, 2]`` and its parts."""
        batch = x.shape[0]

        def end(p):
            return torch.tensor(p, dtype=x.dtype, device=x.device).expand(batch, 1, 2)

        knots = torch.cat([end(self.start), x, end(self.goal)], dim=1)
        path = spline_trajectory(knots, self.timesteps)  # [batch, T, 2]
        obst = self.field.density(path).sum(-1)
        length = safe_norm(path[:, 1:] - path[:, :-1]).sum(-1)
        cost = self.w_obstacle * obst + self.w_length * length
        return cost, {"obstacle": obst, "length": length, "paths": path}


def run(method: str = "pathsig", n_iter: int = 300, batch: int = 16,
        n_free_knots: int = 4, lr: float = 0.02, seed: int = 0, device=None,
        x0: Optional[torch.Tensor] = None) -> Dict:
    """``n_iter`` raw-lr Stein steps with the cosine repulsion schedule. The
    knots start uniform in ``[-4, 4]²`` from a generator seeded by ``seed``
    on the device, unless ``x0`` is given."""
    device = resolve_device(device)
    problem = FieldProblem(ObstacleField.create())
    gen = torch.Generator(device=device).manual_seed(seed)
    if x0 is None:
        x0 = -4.0 + 8.0 * torch.rand((batch, n_free_knots, 2), generator=gen,
                                     device=device)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)

    if method == "svgd":
        score = svgd_score(problem.batch_cost, GaussianKernel())
    elif method == "sgd":
        score = sgd_score(problem.batch_cost)
    else:
        score = pathsig_score(problem.batch_cost,
                              SignatureKernel(dyadic_order=3, bandwidth=3.0))
    svgd = SVGD(optimizer=None, lr=lr,
                repulsion_schedule=schedulers.cosine(1.0, 0.0, 3 * n_iter // 4,
                                                     n_iter // 4))
    x_final, _, _ = svgd.run(x0, score, n_iter, generator=gen)
    with torch.no_grad():
        costs, aux = problem.batch_cost(x_final)
    return {
        "final_costs": costs.cpu().numpy(),
        "best_cost": costs.min().item(),
        "mean_cost": costs.mean().item(),
        "paths": aux["paths"].cpu().numpy(),
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--method", default="pathsig", choices=["pathsig", "svgd", "sgd"])
    parser.add_argument("--n-iter", type=int, default=300)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    res = run(method=args.method, n_iter=args.n_iter, device=args.device)
    print(json.dumps({"method": args.method, "best_cost": round(res["best_cost"], 3),
                      "mean_cost": round(res["mean_cost"], 3)}))


if __name__ == "__main__":
    main()
