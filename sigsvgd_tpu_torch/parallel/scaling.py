"""Communication accounting and the scaling curve of the sharded solvers
(port of ``sigsvgd_tpu/parallel/scaling.py``).

The JAX package reads the collectives out of the compiled HLO; a PyTorch
program has no such text, so :func:`collective_stats` records each
collective the ``parallel`` helpers issue while a sharded step runs (kind,
count and payload bytes, ``parallel.comm``). :func:`measure_scaling` times
solves at several world sizes inside one process group.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .comm import record_collectives


def collective_stats(fn: Callable, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """Run ``fn(*args, **kwargs)`` and return ``{kind: {"count": n, "bytes":
    payload}}`` of the collectives it issued on this rank (kinds as the JAX
    package names them: "all-gather", "all-reduce", "collective-permute")."""
    with record_collectives() as stats:
        fn(*args, **kwargs)
    return stats


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()


def measure_scaling(make_step: Callable[[DeviceMesh], Callable[[], object]],
                    device_counts: Sequence[int] = (1, 2, 4, 8), n_iters: int = 5,
                    device_type: str = "cuda") -> List[Dict[str, float]]:
    """Steady-state solves/s of a sharded step at several world sizes.

    Runs on every rank of an initialised group. For each count ``nd`` up to
    the group's size the first ``nd`` ranks form a 1-D 'dp' mesh, and
    ``make_step(mesh)`` returns a zero-argument callable that runs one solve
    there; it is called once to warm up, then timed over ``n_iters`` calls.
    The others wait. Rows carry rank 0's time on every rank."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    rows = []
    for nd in device_counts:
        if nd > world:
            continue
        group = dist.new_group(list(range(nd)))
        dt = torch.zeros(1, dtype=torch.float64)
        if rank < nd:
            mesh = DeviceMesh.from_group(group, device_type, mesh_dim_names=("dp",))
            step = make_step(mesh)
            step()
            _sync(device_type)
            t0 = time.perf_counter()
            for _ in range(n_iters):
                step()
            _sync(device_type)
            dt[0] = (time.perf_counter() - t0) / n_iters
        dist.broadcast(dt, src=0)
        rows.append({"devices": nd, "solves_per_s": 1.0 / float(dt[0]),
                     "s_per_solve": float(dt[0])})
    base = rows[0]["solves_per_s"] if rows else 1.0
    for r in rows:
        r["efficiency_vs_1dev"] = r["solves_per_s"] / (base * r["devices"])
    return rows
