"""Sharded MPF: the Stein particle filter's observe-update over a mesh (port
of ``sigsvgd_tpu/parallel/mpf.py``).

The dynamics-parameter particles shard over ``axis`` ('dp'). Each Stein
step, every rank scores its particles locally (the likelihood's model step
and the GMM prior's gradient are per particle), gathers the particle and
score rows and forms its ``[n_local, N]`` RBF Gram rows: the velocity
``(K s − ∇K)/N`` is the row-block product of ``parallel.svgd``. The kernel
and prior bandwidth (Silverman or fixed) comes once from all the pre-update
particles, as :meth:`MPF.observe` takes it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..inference.mpf import MPF, MPFState
from . import comm
from .mesh import axis_group, axis_size


@torch.no_grad()
def sharded_mpf_observe(mpf: MPF, state: MPFState, action: torch.Tensor,
                        new_obs: torch.Tensor, mesh: DeviceMesh, axis: str = "dp",
                        n_steps: int = 20, bw: Optional[float] = None
                        ) -> Tuple[MPFState, torch.Tensor]:
    """Sharded counterpart of :meth:`MPF.observe`. ``state.particles`` are
    this rank's rows, ``state.prior_means`` all the prior's means. Returns
    the new state (this rank's moved rows as ``particles``, all the moved
    particles as ``prior_means``) and the per-step global norms of φ."""
    dp = axis_group(mesh, axis)
    cond = mpf.likelihood.condition(action, new_obs, prev=state.cond)
    state = state._replace(cond=cond)
    x = state.particles
    n_local = x.shape[0]
    x_all = comm.all_gather(x.reshape(n_local, -1), dp)
    n_total = x_all.shape[0]
    if n_total != n_local * axis_size(mesh, axis):
        raise ValueError("ranks hold different particle counts")
    kern_bw = (torch.tensor(bw * mpf.bw_scale, dtype=x.dtype, device=x.device)
               if bw is not None else mpf._bandwidth(x_all.reshape((n_total,) + x.shape[1:])))
    norms = []
    for t in range(n_steps):
        if t:
            x_all = comm.all_gather(x.reshape(n_local, -1), dp)
        score = mpf._score(x, state)
        s_all = comm.all_gather(score.reshape(n_local, -1), dp)
        k_rows, grad_k = mpf.kernel(x.reshape(n_local, -1), x_all, h=kern_bw)
        phi = ((k_rows @ s_all - grad_k) / n_total).reshape(x.shape)
        norms.append(torch.sqrt(comm.all_reduce(torch.sum(phi * phi), "sum", dp)))
        x = x + mpf.lr * phi
    means = comm.all_gather(x.reshape(n_local, -1), dp).reshape((n_total,) + x.shape[1:])
    return (MPFState(particles=x, prior_means=means, prior_bw=kern_bw, cond=cond),
            torch.stack(norms))
